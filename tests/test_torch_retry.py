"""The port's retry ladder (--retry-expand) on the CPU: overflow pairs of a
small-E primary step climb tiers of growing E on the device before any
host referee, with counts byte-equal to the goldens and the funnel's
counters equal to the JAX runner's on the same configuration.  Mirrors
tests/test_retry_expand.py and the ladder half of
tests/test_okam_retry_checkpoint.py."""

import os

import numpy as np
import pytest
import torch

from danbing_tk_tpu.engine.align_runner import \
    DeviceAlignRunner as JaxRunner
from danbing_tk_tpu.engine.host_align import AlignConfig as JaxConfig
from danbing_tk_tpu.engine.host_align import RPGG as JaxRPGG
from danbing_tk_tpu_torch.engine import device_align as tda
from danbing_tk_tpu_torch.engine.align_runner import DeviceAlignRunner
from danbing_tk_tpu_torch.engine.host_align import AlignConfig, RPGG

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
READS = os.path.join(GOLDEN, "reads.fa")
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
    return DeviceAlignRunner(RPGG(os.path.join(GOLDEN, "pan")),
                             cfg or AlignConfig(**KW), max_read_len=192,
                             device="cpu", **kw)


def _nmap(run):
    return run._dev_state("nmapread")[:-1] + run.host.nmapread


def test_retry_expand_counts_identical(tmp_path):
    """One tier (E = 48 -> 512): nearly every pair overflows the primary
    step, resolves in the tier, and the host referee sees only what the
    big-E run sends it."""
    ref = _port(batch_pairs=512)
    ref.run_file_native(READS)
    two = _port(batch_pairs=512, expand_cap=48, retry_expand=512)
    two.run_file_native(READS)
    assert two.n_retried > 0
    assert two.retry_P == [256]
    assert two.n_referee == ref.n_referee, (two.n_referee, ref.n_referee)
    two.write_trkmc_ar(tmp_path / "o.trkmc.ar")
    assert (tmp_path / "o.trkmc.ar").read_bytes() == _gold("out.trkmc.ar")
    np.testing.assert_array_equal(_nmap(two), _nmap(ref))


@pytest.fixture(scope="module")
def jax_ladder():
    """The JAX runner's funnel on the ladder configuration below."""
    j = JaxRunner(JaxRPGG(os.path.join(GOLDEN, "pan")), JaxConfig(**KW),
                  batch_pairs=64, max_read_len=192, expand_cap=48,
                  retry_expand=[96, 512])
    j.run_file_native(READS, prefilter=True)
    nm = np.asarray(j.state["nmapread"])[:-1] + j.host.nmapread
    return dict(counts=j.flat_counts(), n_retried=j.n_retried,
                n_referee=j.n_referee, reasons=dict(j.referee_reasons),
                n_prefiltered=j.n_prefiltered, nmap=nm)


def test_retry_ladder_matches_jax(jax_ladder):
    """E = 48 -> 96 -> 512 with the prefilter: pairs climb two tiers; the
    counts, nmapread and every funnel counter equal the JAX runner's."""
    lad = _port(batch_pairs=64, expand_cap=48, retry_expand=[96, 512])
    lad.run_file_native(READS, prefilter=True)
    assert lad.n_retried > 0
    assert lad.retry_steps[1] is not None, "tier 2 never ran"
    assert lad.n_retried == jax_ladder["n_retried"]
    assert lad.n_referee == jax_ladder["n_referee"]
    assert lad.referee_reasons == jax_ladder["reasons"]
    assert lad.n_prefiltered == jax_ladder["n_prefiltered"]
    np.testing.assert_array_equal(lad.flat_counts(), jax_ladder["counts"])
    np.testing.assert_array_equal(_nmap(lad), jax_ladder["nmap"])
    from danbing_tk_tpu_torch.io.binary import read_karray

    np.testing.assert_array_equal(
        lad.flat_counts(), read_karray(os.path.join(GOLDEN, "out.trkmc.ar")))


def test_ladder_must_grow():
    with pytest.raises(ValueError, match="strictly grow"):
        _port(batch_pairs=64, expand_cap=128, retry_expand=[512, 256])
    with pytest.raises(ValueError, match="strictly grow"):
        _port(batch_pairs=64, expand_cap=512, retry_expand=512)


def test_tier_batch_sizes():
    """A tier's batch keeps P * E within ~4x the primary step's (JAX
    _tier_P): the production ladder's E = 4096 tier over E = 512 steps
    halves the batch."""
    run = _port(batch_pairs=4096, expand_cap=512, retry_expand=[4096])
    assert run.retry_P == [2048]
    assert tda.check_vote_shape(2 * (192 - 21 + 1), 4096) == "large-E"
    run = _port(batch_pairs=256, expand_cap=32, retry_expand=[64, 512])
    assert run.retry_P == [256, 128]


def test_okam_bub_retry_ladder_bit_exact(tmp_path):
    """A tiny primary cap sends most pairs up the ladder; the ordinal
    buffer restores pair order, so .kam, .trkmc.ar and .bub.kmdb still
    equal the goldens byte for byte."""
    cfg = AlignConfig(ksize=21, cth=20, n_filter=4, nm_filter=1,
                      output_bubbles=True)
    al = _port(cfg, batch_pairs=256, expand_cap=32, retry_expand=[64, 512])
    al.run_file_native(READS, prefilter=True)
    assert al.n_retried > 0
    al.write_kam(str(tmp_path / "r.kam"))
    al.write_trkmc_ar(str(tmp_path / "r.trkmc.ar"))
    al.write_bubbles(str(tmp_path / "r.bub.kmdb"))
    for ext in ("kam", "trkmc.ar", "bub.kmdb"):
        assert (tmp_path / f"r.{ext}").read_bytes() == _gold(f"out.{ext}"), \
            ext


def test_threading_retry_ladder_golden(tmp_path):
    """Threading (-s 2 -gc 50 3 -a) with E = 32 -> 64 -> 512: a deferred
    pair is walked (and its fallback counted) only in the tier that
    resolves it; .aln and .tr.kmers equal the goldens.  A checkpoint
    does not hold .aln rows, so asking for one there is refused."""
    cfg = AlignConfig(ksize=21, cth=20, n_filter=4, nm_filter=1, okam=False,
                      simmode=2, threading=True, thread_cth=50,
                      maxncorrection=3, aln=True)
    run = _port(cfg, batch_pairs=1024, expand_cap=32,
                retry_expand=[64, 512])
    run.run_file_native(os.path.join(GOLDEN, "reads.sim.fa"),
                        prefilter=True)
    assert run.n_retried > 0
    run.write_aln(str(tmp_path / "t.aln"))
    run.write_tr_kmers(str(tmp_path / "t.tr.kmers"))
    assert (tmp_path / "t.aln").read_bytes() == _gold("out.thread.aln")
    assert (tmp_path / "t.tr.kmers").read_bytes() == \
        _gold("out.thread.tr.kmers")
    with pytest.raises(ValueError, match=".aln"):
        _port(cfg, batch_pairs=1024).run_file_native(
            os.path.join(GOLDEN, "reads.sim.fa"), prefilter=True,
            checkpoint=str(tmp_path / "ck.npz"))
