"""The port's native referee (danbing_tk_tpu_torch/engine/native_referee.py,
native/dtk_align.cpp built by kernels/build.py) against the Python
HostAligner, on the dict-backed RPGG and on the flat view, and its wiring
into the runner.

* NativeReferee equals HostAligner (counts, nmapread, kmc, stats, .kam
  rows) for plain, -s 2, -b, -fq -b and -qc, on the dict RPGG (as
  tests/test_native_referee.py holds the JAX engine) and on the flat view
  of the port's DeviceRPGG; the dict-RPGG Python referee equals the JAX
  package's HostAligner on the same pairs.
* ParallelReferee applies pooled verdicts in submission order, and a
  synchronous call after pooled ones lands after them.
* The runner picks the pooled engine where ``supported(cfg)`` holds and
  DTK_NO_NATIVE_REFEREE is unset (-bu, -e and -tb are not supported).
"""

import os

import pytest
import torch

from danbing_tk_tpu_torch.engine import native_referee as nr
from danbing_tk_tpu_torch.engine.align_runner import DeviceAlignRunner
from danbing_tk_tpu_torch.engine.device_align import DeviceRPGG
from danbing_tk_tpu_torch.engine.flat_rpgg import FlatRPGG
from danbing_tk_tpu_torch.engine.host_align import (AlignConfig, HostAligner,
                                                    RPGG)
from danbing_tk_tpu_torch.kernels import build

from test_torch_flat_rpgg import (GOLDEN, KW, PAN, _drp, assert_same_host,
                                  pairs_of, run_host)

# name: (config, reads, RPGG keywords)
CONFIGS = {
    "plain": (dict(), "reads.fa", {}),
    "sim2": (dict(simmode=2), "reads.sim.fa", {}),
    "bait": (dict(simmode=2, bait=True), "reads.sim.fa", dict(bait=True)),
    "fq-bait": (dict(simmode=2, bait=True, is_fastq=True), "reads.sim.fq",
                dict(bait=True)),
    "qc": (dict(simmode=2, qc=True), "reads.sim.fa",
           dict(qc_file=os.path.join(GOLDEN, "qc.txt"))),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_native_matches_python(name):
    """The C++ engine and the Python HostAligner agree on the dict RPGG
    and on the flat view; the Python referee agrees with the JAX
    package's HostAligner."""
    from danbing_tk_tpu.engine.host_align import AlignConfig as JCfg
    from danbing_tk_tpu.engine.host_align import HostAligner as JHost
    from danbing_tk_tpu.engine.host_align import RPGG as JRPGG

    cfgkw, reads, rpggkw = CONFIGS[name]
    cfg = AlignConfig(**KW, **cfgkw)
    rp = RPGG(PAN, **rpggkw)
    pairs = pairs_of(reads, rp.nloci, cfg.simmode, cfg.is_fastq, stride=4)
    want = run_host(rp, cfg, pairs)
    jhost = JHost(JRPGG(PAN, **rpggkw), JCfg(**KW, **cfgkw))
    for rec in pairs:
        jhost.process_pair(*rec)
    jhost.flush_batch()
    assert_same_host(want, jhost)
    assert_same_host(want, run_host(RPGG(PAN, **rpggkw), cfg, pairs,
                                    nr.NativeReferee))
    flat = FlatRPGG.from_device_tables(_drp(RPGG(PAN, **rpggkw)))
    assert_same_host(want, run_host(flat, cfg, pairs, nr.NativeReferee))
    assert_same_host(want, run_host(flat.renew(), cfg, pairs,
                                    nr.ParallelReferee))


def test_parallel_referee_submission_order():
    """Pooled calls over three threads apply in submission order (the
    .kam rows come out in pair order), and a synchronous process_pair
    after them lands last."""
    rp = RPGG(PAN)
    cfg = AlignConfig(**KW, simmode=2)
    pairs = pairs_of("reads.sim.fa", rp.nloci, 2, False, stride=5)
    want = run_host(rp, cfg, pairs)
    host = HostAligner(RPGG(PAN), cfg)
    ref = nr.ParallelReferee(host, nthreads=3)
    for rec in pairs[:-1]:
        ref.submit(*rec)
    ref.process_pair(*pairs[-1])
    ref.close()
    host.flush_batch()
    assert ref.nthreads == 3 and not ref._pending
    assert_same_host(want, host)
    assert len(want.kam_rows) > 100


def test_supported():
    assert nr.supported(AlignConfig())
    assert nr.supported(AlignConfig(threading=True, bait=True, qc=True))
    for kw in (dict(output_bubbles=True), dict(extract=1),
               dict(track_bait=True)):
        assert not nr.supported(AlignConfig(**kw))


def test_runner_referee_choice(monkeypatch):
    """The pooled native engine where supported (counting, okam,
    threading), the Python HostAligner for -bu or with
    DTK_NO_NATIVE_REFEREE; the engine's library is the port's own build,
    under build/torch_native/ with its source hash in the name."""
    rp = RPGG(PAN)
    drp = DeviceRPGG.build(rp, with_tre=True)

    def referee(**kw):
        run = DeviceAlignRunner(rp, AlignConfig(**KW, **kw), batch_pairs=16,
                                drp=drp, device="cpu")
        return run.referee, run.host

    for kw in (dict(okam=False), dict(), dict(threading=True)):
        ref, host = referee(**kw)
        assert isinstance(ref, nr.ParallelReferee) and ref.host is host
    ref, host = referee(output_bubbles=True)
    assert ref is host
    monkeypatch.setenv("DTK_NO_NATIVE_REFEREE", "1")
    ref, host = referee(okam=False)
    assert ref is host
    name = os.path.basename(build._libs["align"]._name)
    assert name.startswith("libdtk_align-") and os.path.dirname(
        build._libs["align"]._name) == build.NATIVE_DIR


@pytest.mark.parametrize("native", [True, False])
def test_runner_referee_golden(tmp_path, monkeypatch, native):
    """The counting runner with expand_cap = 16 on the dict RPGG writes
    the golden .trkmc.ar and .tr.summary.txt through either referee."""
    if not native:
        monkeypatch.setenv("DTK_NO_NATIVE_REFEREE", "1")
    run = DeviceAlignRunner(RPGG(PAN), AlignConfig(**KW, okam=False),
                            batch_pairs=1024, max_read_len=192,
                            expand_cap=16, device="cpu")
    assert isinstance(run.referee, nr.ParallelReferee) == native
    run.run_file_native(os.path.join(GOLDEN, "reads.fa"), prefilter=True)
    assert run.n_referee > 1000 and run.n_resolved == run.n_referee
    assert run.referee_s > 0
    run.write_trkmc_ar(str(tmp_path / "o.trkmc.ar"))
    run.write_summary(str(tmp_path / "o.tr.summary.txt"))
    for ext in ("trkmc.ar", "tr.summary.txt"):
        with open(os.path.join(GOLDEN, f"out.{ext}"), "rb") as g:
            assert (tmp_path / f"o.{ext}").read_bytes() == g.read(), ext
    assert run.host.flat_counts().any()
