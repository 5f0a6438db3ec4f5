"""The port's checkpoints (--checkpoint) on the CPU: an interrupted funnel
resumed from its checkpoint gives the uninterrupted run's bytes, a resume
under another configuration is refused, and the npz crosses between the
packages (the JAX runner's keys and dtypes; a JAX-written counting
checkpoint resumes in the port to the golden .trkmc.ar).  Mirrors
tests/test_checkpoint.py, the ladder resume of tests/test_retry_expand.py
and tests/test_okam_retry_checkpoint.py."""

import os
import shutil

import numpy as np
import pytest
import torch

from danbing_tk_tpu_torch.apps import cli
from danbing_tk_tpu_torch.engine import align_runner as ar
from danbing_tk_tpu_torch.engine.align_runner import DeviceAlignRunner
from danbing_tk_tpu_torch.engine.host_align import AlignConfig, RPGG
from danbing_tk_tpu_torch.io.rowsink import RowSink

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
READS = os.path.join(GOLDEN, "reads.fa")
PAN = os.path.join(GOLDEN, "pan")
KW = dict(ksize=21, cth=20, n_filter=4, nm_filter=1, okam=False)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _gold(name):
    with open(os.path.join(GOLDEN, name), "rb") as f:
        return f.read()


def _port(cfg=None, **kw):
    return DeviceAlignRunner(RPGG(PAN), cfg or AlignConfig(**KW),
                             max_read_len=192, device="cpu", **kw)


class Stop(Exception):
    pass


def test_prefilter_checkpoint_resume(tmp_path):
    """The production configuration: the survivor repack buffer is saved
    with the cursor, so a run stopped mid-file resumes to the golden
    counts and nmapread."""
    ck = str(tmp_path / "pf.npz")
    r1 = _port(batch_pairs=256)
    n = {"c": 0}
    orig = r1.step

    def bomb(*a, **kw):
        if n["c"] >= 6:
            raise Stop()
        n["c"] += 1
        return orig(*a, **kw)

    r1.step = bomb
    with pytest.raises(Stop):
        r1.run_file_native(READS, prefilter=True, checkpoint=ck,
                           checkpoint_every=512)
    assert os.path.exists(ck)
    z = np.load(ck)
    assert 0 < int(z["cursor"]) < 4595

    r2 = _port(batch_pairs=256)
    r2.run_file_native(READS, prefilter=True, checkpoint=ck,
                       checkpoint_every=512)
    r2.write_trkmc_ar(tmp_path / "o.trkmc.ar")
    r2.write_summary(tmp_path / "o.tr.summary.txt")
    assert (tmp_path / "o.trkmc.ar").read_bytes() == _gold("out.trkmc.ar")
    assert (tmp_path / "o.tr.summary.txt").read_bytes() == \
        _gold("out.tr.summary.txt")


def test_retry_ladder_checkpoint_resume(tmp_path):
    """Stopped with pairs pending in both retry tiers' buffers (saved
    with the checkpoint; the file's first 768 pairs overflow nothing, so
    the stop comes after five dispatches); the resumed run finishes with
    the golden counts."""
    ck = str(tmp_path / "ladder.npz")
    kw = dict(batch_pairs=64, expand_cap=48, retry_expand=[96, 512])
    r1 = _port(**kw)
    ar.stop_after_prefilter(r1, 5)
    with pytest.raises(ar.Stopped):
        r1.run_file_native(READS, checkpoint=ck, checkpoint_every=64,
                           prefilter=True)
    z = np.load(ck)
    assert int(z["x_nret"]) > 0 and int(z["x_nret1"]) > 0, \
        "no pairs pending in a tier"
    r2 = _port(**kw)
    r2.run_file_native(READS, checkpoint=ck, checkpoint_every=64,
                       prefilter=True)
    r2.write_trkmc_ar(tmp_path / "o.trkmc.ar")
    assert (tmp_path / "o.trkmc.ar").read_bytes() == _gold("out.trkmc.ar")
    assert r2.n_retried > 0


def test_checkpoint_config_mismatch_refused(tmp_path, monkeypatch):
    """A resume under another configuration than the checkpointing run's
    refuses: the saved buffers and the cursor's granularity mean
    something only under that one."""
    ck = str(tmp_path / "mm.npz")
    r1 = _port(batch_pairs=256)
    r1.run_file_native(READS, prefilter=True, checkpoint=ck,
                       checkpoint_every=512)
    # same configuration, file complete: the resume is a no-op
    r_ok = _port(batch_pairs=256)
    r_ok.run_file_native(READS, prefilter=True, checkpoint=ck,
                         checkpoint_every=512)
    np.testing.assert_array_equal(r_ok.flat_counts(), r1.flat_counts())
    with pytest.raises(ValueError, match="prefilter"):
        _port(batch_pairs=256).run_file_native(READS, prefilter=False,
                                               checkpoint=ck)
    with pytest.raises(ValueError, match="batch_pairs"):
        _port(batch_pairs=512).run_file_native(READS, prefilter=True,
                                               checkpoint=ck)
    with pytest.raises(ValueError, match="retry_expand"):
        _port(batch_pairs=256, retry_expand=1024).run_file_native(
            READS, prefilter=True, checkpoint=ck)
    monkeypatch.setattr(ar, "PREFILTER_MULT", 2)
    with pytest.raises(ValueError, match="dispatch size"):
        _port(batch_pairs=256).run_file_native(READS, prefilter=True,
                                               checkpoint=ck)


def _okam_cfg(**kw):
    return AlignConfig(ksize=21, cth=20, n_filter=4, nm_filter=1,
                       output_bubbles=True, **kw)


@pytest.mark.parametrize("retry", [0, [512]])
def test_okam_bub_checkpoint_resume(tmp_path, retry):
    """Crash-resume of a .kam + -bu run: the first (mid-run) checkpoint
    is kept, the longer streamed .kam stands for the crash-time file, and
    a fresh runner resumes from the checkpoint (truncating the .kam back
    to its high-water mark): every output equals the goldens.  The small
    reads_per_batch also moves the bubble-flush boundaries on resume."""
    ck = str(tmp_path / "ok.npz")
    kam1 = str(tmp_path / "a.kam")
    kw = dict(batch_pairs=128, expand_cap=64, retry_expand=retry)
    r1 = _port(_okam_cfg(reads_per_batch=512), **kw)
    r1.kam_rows = RowSink(kam1)
    mid = {}
    orig_write = r1._ckpt_write

    def hook(path, cursor, snap, hsnap, extra):
        orig_write(path, cursor, snap, hsnap, extra)
        if not mid:
            shutil.copy(path, path + ".mid")
            mid["cursor"] = cursor

    r1._ckpt_write = hook
    r1.run_file_native(READS, checkpoint=ck, checkpoint_every=256,
                       prefilter=True)
    r1.write_kam(kam1)
    r1.write_bubbles(str(tmp_path / "a.bub.kmdb"))
    assert (tmp_path / "a.kam").read_bytes() == _gold("out.kam")
    assert (tmp_path / "a.bub.kmdb").read_bytes() == _gold("out.bub.kmdb")
    assert 0 < mid["cursor"] < 4595, "the first save should be mid-run"

    kam2 = str(tmp_path / "b.kam")
    shutil.copy(kam1, kam2)
    shutil.copy(ck + ".mid", ck)
    r2 = _port(_okam_cfg(reads_per_batch=512), **kw)
    r2.kam_rows = RowSink(kam2, append=True)
    r2.run_file_native(READS, checkpoint=ck, checkpoint_every=256,
                       prefilter=True)
    r2.write_kam(kam2)
    r2.write_trkmc_ar(str(tmp_path / "b.trkmc.ar"))
    r2.write_bubbles(str(tmp_path / "b.bub.kmdb"))
    for ext in ("kam", "trkmc.ar", "bub.kmdb"):
        assert (tmp_path / f"b.{ext}").read_bytes() == _gold(f"out.{ext}"), \
            ext


def test_okam_resume_config_mismatch_refused(tmp_path):
    ck = str(tmp_path / "mm.npz")
    r1 = _port(_okam_cfg(), batch_pairs=128)
    r1.kam_rows = RowSink(str(tmp_path / "m.kam"))
    r1.run_file_native(READS, checkpoint=ck, checkpoint_every=256,
                       prefilter=True)
    r2 = _port(batch_pairs=128)
    with pytest.raises(ValueError, match="okam"):
        r2.run_file_native(READS, checkpoint=ck, checkpoint_every=256,
                           prefilter=True)


def test_jax_checkpoint_resumes_in_port(tmp_path):
    """The checkpoint is the state the packages share: a counting-mode
    checkpoint written mid-run by the JAX DeviceAlignRunner resumes in
    the port to the golden .trkmc.ar, and the port writes the same npz
    keys with the same dtypes."""
    from danbing_tk_tpu.engine.align_runner import \
        DeviceAlignRunner as JaxRunner
    from danbing_tk_tpu.engine.host_align import AlignConfig as JaxConfig
    from danbing_tk_tpu.engine.host_align import RPGG as JaxRPGG

    ck = str(tmp_path / "jax.npz")
    j = JaxRunner(JaxRPGG(PAN), JaxConfig(**KW), batch_pairs=256,
                  max_read_len=192, expand_cap=128, retry_expand=512)
    n = {"c": 0}
    orig = j.step

    def bomb(*a, **kw):
        if n["c"] >= 6:
            raise Stop()
        n["c"] += 1
        return orig(*a, **kw)

    j.step = bomb
    with pytest.raises(Stop):
        j.run_file_native(READS, prefilter=True, checkpoint=ck,
                          checkpoint_every=512)
    zj = np.load(ck)
    assert 0 < int(zj["cursor"]) < 4595

    port_ck = str(tmp_path / "port.npz")
    shutil.copy(ck, port_ck)
    r = _port(batch_pairs=256, expand_cap=128, retry_expand=512)
    r.run_file_native(READS, prefilter=True, checkpoint=port_ck,
                      checkpoint_every=512)
    r.write_trkmc_ar(tmp_path / "o.trkmc.ar")
    assert (tmp_path / "o.trkmc.ar").read_bytes() == _gold("out.trkmc.ar")
    zp = np.load(port_ck)
    assert sorted(zp.files) == sorted(zj.files)
    for key in zj.files:
        if key == "dev_stats":
            # JAX's stats are int64 with jax_enable_x64, else int32; the
            # port writes the x64 layout
            assert zp[key].dtype == np.int64
            assert zj[key].dtype in (np.int32, np.int64)
            continue
        assert zp[key].dtype == zj[key].dtype, key


def test_cli_retry_and_checkpoint_golden(tmp_path):
    """The CLI with --retry-expand and --checkpoint writes the golden
    .trkmc.ar; a second run over the finished checkpoint writes it too."""
    out, ck = str(tmp_path / "OUT"), str(tmp_path / "ck.npz")
    argv = ["align", "--device", "--native-io", "--prefilter", "-ka",
            "-cth", "20", "-kf", "4", "1", "--expand-cap", "128",
            "--retry-expand", "512", "--checkpoint", ck, "-qs", PAN,
            "-fa", READS, "-o", out, "--torch-device", "cpu"]
    for _ in range(2):
        cli.main(argv)
        with open(out + ".trkmc.ar", "rb") as f:
            assert f.read() == _gold("out.trkmc.ar")
        assert os.path.exists(ck)
