"""The device runner's Python ingest (DeviceAlignRunner.run_file, the JAX
runner's run_file) and the host-only align on the CPU: counting (-ka),
the default .kam rows, -s 1, -b, -qc, -fq and -bu give the reference
goldens byte for byte; -bu at a small reads_per_batch gives the JAX
HostAligner's .bub.kmdb at the same flush cadence; a checkpointed
counting run stopped mid-file resumes to the golden counts, with the JAX
run_file's npz keys, both ways between the packages; and
``python -m danbing_tk_tpu_torch align`` without --device is the host
engine (the twin of tests/test_cli.py:test_cli_align)."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from danbing_tk_tpu.engine.host_align import AlignConfig as JCfg
from danbing_tk_tpu.engine.host_align import HostAligner as JHost
from danbing_tk_tpu.engine.host_align import RPGG as JRPGG
from danbing_tk_tpu_torch.engine.align_runner import DeviceAlignRunner
from danbing_tk_tpu_torch.engine.host_align import AlignConfig, RPGG

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "golden")
PAN = os.path.join(GOLDEN, "pan")
READS = os.path.join(GOLDEN, "reads.fa")
KW = dict(ksize=21, cth=20, n_filter=4, nm_filter=1)
SUM3 = ("kam", "trkmc.ar", "tr.summary.txt")

# name: (config, reads, golden prefix, outputs, RPGG keywords)
MODES = {
    "ka": (dict(okam=False), "reads.fa", "out",
           ("trkmc.ar", "tr.summary.txt"), {}),
    "okam_bu": (dict(output_bubbles=True), "reads.fa", "out",
                SUM3 + ("bub.kmdb",), {}),
    "s1": (dict(simmode=1), "reads.s1.fa", "out.s1", SUM3, {}),
    "bait": (dict(simmode=2, bait=True), "reads.sim.fa", "out.bait", SUM3,
             dict(bait=True)),
    "qc": (dict(simmode=2, qc=True), "reads.sim.fa", "out.qc", SUM3,
           dict(qc_file=os.path.join(GOLDEN, "qc.txt"))),
    "fq": (dict(simmode=2, bait=True, is_fastq=True), "reads.sim.fq",
           "out.fq", SUM3, dict(bait=True)),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _gold(name):
    with open(os.path.join(GOLDEN, name), "rb") as f:
        return f.read()


def _write(run, pref, outs):
    writers = {"kam": run.write_kam, "trkmc.ar": run.write_trkmc_ar,
               "tr.summary.txt": run.write_summary,
               "bub.kmdb": run.write_bubbles}
    for ext in outs:
        writers[ext](f"{pref}.{ext}")


@pytest.mark.parametrize("mode", sorted(MODES))
def test_run_file_golden(tmp_path, mode):
    kw, reads, gold, outs, rkw = MODES[mode]
    run = DeviceAlignRunner(RPGG(PAN, **rkw), AlignConfig(**KW, **kw),
                            batch_pairs=1024, max_read_len=192,
                            device="cpu")
    run.run_file(os.path.join(GOLDEN, reads))
    _write(run, str(tmp_path / "o"), outs)
    for ext in outs:
        assert (tmp_path / f"o.{ext}").read_bytes() == \
            _gold(f"{gold}.{ext}"), ext
    assert run.n_step_pairs > 0 and run.n_prefiltered == 0
    stats = run.state["stats"].tolist()
    if mode in ("bait", "fq"):
        assert stats[8] > 0              # bait-filtered reads
    if mode == "qc":
        assert stats[7] > 0              # QC-dropped reads


def test_bubbles_flush_cadence(tmp_path):
    """-bu merges the batch-local maps after every reader batch of
    reads_per_batch / 2 pairs: at 1,024 pairs a batch (five batches, each
    cut into chunks of 384 pairs, so the last chunk of a batch is short)
    the runner merges at the JAX HostAligner's five points and its
    .bub.kmdb equals the HostAligner's at the same cadence."""
    mk = dict(KW, okam=False, output_bubbles=True, reads_per_batch=2048)
    ref = JHost(JRPGG(PAN), JCfg(**mk))
    merged = []

    def counting(flush, sizes):
        def f():
            sizes.append(sum(len(c) for _, c in
                             (v for v in bm._bub_batch.values())))
            flush()
        return f

    bm = ref
    ref.flush_batch = counting(ref.flush_batch, merged)
    ref.run_file(READS)
    ref.write_bubbles(str(tmp_path / "host.bub.kmdb"))
    run = DeviceAlignRunner(RPGG(PAN), AlignConfig(**mk), batch_pairs=384,
                            max_read_len=192, device="cpu")
    dev_merged = []
    bm = run.bubbles
    bm.flush_batch = counting(bm.flush_batch, dev_merged)
    run.run_file(READS)
    run.write_bubbles(str(tmp_path / "dev.bub.kmdb"))
    assert (tmp_path / "dev.bub.kmdb").read_bytes() == \
        (tmp_path / "host.bub.kmdb").read_bytes()
    # the same merges, each of the same batch-local edges
    assert len(merged) == 5 and dev_merged == merged
    np.testing.assert_array_equal(run.flat_counts(), ref.flat_counts())


class Stop(Exception):
    pass


def _bomb(runner, n_ok):
    """The runner's step after its first n_ok raises Stop."""
    n = {"c": 0}
    orig = runner.step

    def step(*a, **kw):
        if n["c"] >= n_ok:
            raise Stop()
        n["c"] += 1
        return orig(*a, **kw)

    runner.step = step


def _jax_runner(cfg_kw):
    from danbing_tk_tpu.engine.align_runner import \
        DeviceAlignRunner as JRunner

    return JRunner(JRPGG(PAN), JCfg(**cfg_kw), batch_pairs=256,
                   max_read_len=192, expand_cap=128)


def test_run_file_checkpoint_resume(tmp_path):
    """A counting run_file stopped mid-file resumes from its checkpoint to
    the golden counts; the npz holds the JAX run_file's keys, and a
    checkpoint written by the JAX run_file resumes in the port."""
    kw = dict(KW, okam=False)
    ck = str(tmp_path / "ck.npz")
    r1 = DeviceAlignRunner(RPGG(PAN), AlignConfig(**kw), batch_pairs=256,
                           max_read_len=192, expand_cap=128, device="cpu")
    _bomb(r1, 7)
    with pytest.raises(Stop):
        r1.run_file(READS, checkpoint=ck, checkpoint_every=512)
    zp = np.load(ck)
    # saves after every second chunk of 256 pairs; the seventh step ran
    assert int(zp["cursor"]) == 6 * 256

    jck = str(tmp_path / "jax.npz")
    j = _jax_runner(kw)
    _bomb(j, 7)
    with pytest.raises(Stop):
        j.run_file(READS, checkpoint=jck, checkpoint_every=512)
    zj = np.load(jck)
    assert sorted(zp.files) == sorted(zj.files)
    assert int(zp["cursor"]) == int(zj["cursor"])
    for key in zj.files:
        if key != "dev_stats":
            assert zp[key].dtype == zj[key].dtype, key

    for path in (ck, jck):
        r2 = DeviceAlignRunner(RPGG(PAN), AlignConfig(**kw),
                               batch_pairs=256, max_read_len=192,
                               expand_cap=128, device="cpu")
        r2.run_file(READS, checkpoint=path, checkpoint_every=512)
        r2.write_trkmc_ar(tmp_path / "o.trkmc.ar")
        r2.write_summary(tmp_path / "o.tr.summary.txt")
        assert (tmp_path / "o.trkmc.ar").read_bytes() == \
            _gold("out.trkmc.ar"), path
        assert (tmp_path / "o.tr.summary.txt").read_bytes() == \
            _gold("out.tr.summary.txt"), path


def test_run_file_checkpoint_refusals(tmp_path):
    """run_file's checkpoint covers counting mode only (JAX
    align_runner.py:977-979): okam and -bu are refused; a native-path
    (prefilter) checkpoint does not resume here."""
    ck = str(tmp_path / "ck.npz")
    for kw in (dict(KW), dict(KW, okam=False, output_bubbles=True)):
        run = DeviceAlignRunner(RPGG(PAN), AlignConfig(**kw),
                                batch_pairs=256, device="cpu")
        with pytest.raises(ValueError, match="counting mode only"):
            run.run_file(READS, checkpoint=ck)
    assert not os.path.exists(ck)
    run = DeviceAlignRunner(RPGG(PAN), AlignConfig(**KW, okam=False),
                            batch_pairs=256, max_read_len=192,
                            device="cpu")
    run.prefilter_window = 1            # each dispatch drains at once
    _bomb(run, 6)
    with pytest.raises(Stop):
        run.run_file_native(READS, prefilter=True, checkpoint=ck,
                            checkpoint_every=256)
    assert "x_buf_codes" in np.load(ck).files
    run = DeviceAlignRunner(RPGG(PAN), AlignConfig(**KW, okam=False),
                            batch_pairs=256, max_read_len=192,
                            device="cpu")
    with pytest.raises(ValueError, match="prefilter"):
        run.run_file(READS, checkpoint=ck)


def test_cli_host_align():
    """align without --device runs the host engine: the twin of
    tests/test_cli.py:test_cli_align, byte-equal .tr.kmers and .kam."""
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        out = os.path.join(d, "out")
        r = subprocess.run(
            [sys.executable, "-m", "danbing_tk_tpu_torch", "align",
             "-k", "21", "-qs", PAN, "-fa", READS, "-cth", "20", "-kf",
             "4", "1", "-on", out],
            cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT),
            capture_output=True, text=True, timeout=600)
        assert r.returncode == 0, r.stderr[-2000:]
        with open(out + ".tr.kmers", "rb") as f:
            assert f.read() == _gold("out.on.tr.kmers")
        with open(out + ".kam", "rb") as f:
            assert f.read() == _gold("out.kam")
        assert "referee pairs" not in r.stderr
        assert sorted(os.listdir(d)) == ["out.kam", "out.tr.kmers"]


def test_cli_device_checkpoint_resume(tmp_path):
    """align --device --checkpoint CK -ka (run_file): a rerun resumes
    from CK and gives the golden counts."""
    from danbing_tk_tpu_torch.apps import cli

    ck = str(tmp_path / "ck.npz")
    out = str(tmp_path / "o")
    argv = ["align", "--device", "-ka", "-cth", "20", "-kf", "4", "1",
            "--checkpoint", ck, "--checkpoint-every", "4096", "-qs", PAN,
            "-fa", READS, "-o", out, "--torch-device", "cpu"]
    cli.main(argv)
    assert int(np.load(ck)["cursor"]) == 4595
    shutil.copy(ck, ck + ".done")
    cli.main(argv)                      # every chunk skipped
    for ext in ("trkmc.ar", "tr.summary.txt"):
        with open(f"{out}.{ext}", "rb") as f:
            assert f.read() == _gold(f"out.{ext}"), ext
