"""Port counting step and prefilter against the JAX package's.

The JAX DeviceRPGG.build tables are carried into the port with
upload_tables (through a port DeviceRPGG holding them), and the port's own
DeviceRPGG.build must give byte-equal numpy levels.  make_step (plain
versions of KA-KD on the CPU) must equal the JAX make_step on every output
key and every state key, on golden-panel batches and a fuzz batch, at the
default expansion cap and at E = 32 (forces overflow referees).  Every
comparison is exact: the pipeline is integer.  test_torch_gpu.py holds the
kernels against these plain versions on a card."""

import os

import numpy as np
import pytest
import torch

from danbing_tk_tpu.engine import device_align as jda
from danbing_tk_tpu.engine.host_align import AlignConfig as JCfg
from danbing_tk_tpu.engine.host_align import RPGG as JRPGG
from danbing_tk_tpu.ops import kmers_np as JK
from danbing_tk_tpu_torch.engine import device_align as tda
from danbing_tk_tpu_torch.engine.host_align import AlignConfig, RPGG
from danbing_tk_tpu_torch.ops.kmers import pack_reads

P, L = 256, 192
GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
KW = dict(ksize=21, cth=20, n_filter=4, nm_filter=1, okam=False)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several workers per machine: one intra-op thread
    each keeps torch's CPU kernels from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    jd = jda.DeviceRPGG.build(JRPGG(os.path.join(GOLDEN, "pan")),
                              with_tre=False)
    # the port's DeviceRPGG over the JAX package's numpy tables
    td = tda.DeviceRPGG(jd.nloci, jd.dbi_tab, jd.vv, jd.trfl_tab, None,
                        jd.locus_offsets, jd.nslots,
                        member_tab=jd.member_tab)
    return jd, td


@pytest.fixture(scope="module")
def batches():
    seqs = [l.strip() for l in open(os.path.join(GOLDEN, "reads.fa"))
            if not l.startswith(">")]
    rng = np.random.default_rng(11)

    def rand_seq(n):
        return "".join("ACGTN"[i] for i in
                       rng.choice(5, n, p=[.24, .24, .24, .24, .04]))

    out = {}
    # golden pairs, and golden reads paired across neighbouring pairs
    # (mates from different loci: ties and test2-only passes)
    for name, off in (("golden", 0), ("golden_x", 1)):
        codes, rlen = pack_reads(seqs[off: off + 2 * P], L)
        live = np.ones(P, dtype=bool)
        live[-3:] = False
        out[name] = (codes, rlen, live)
    fz = []
    for i in range(P):
        kind = i % 4
        a = seqs[int(rng.integers(len(seqs)))]
        if kind == 0:
            fz += [a, seqs[int(rng.integers(len(seqs)))]]
        elif kind == 1:
            fz += [rand_seq(150), rand_seq(150)]
        elif kind == 2:
            fz += [a[: int(rng.integers(0, 60))],
                   rand_seq(int(rng.integers(0, 45)))]
        else:
            fz += [a[:70] + rand_seq(80), rand_seq(60) + a[70:]]
    codes, rlen = pack_reads(fz, L)
    out["fuzz"] = (codes, rlen, rng.random(P) < 0.95)
    return out


def _eq(name, want, got):
    a = np.asarray(want).astype(np.int64)
    b = got.cpu().numpy().astype(np.int64)
    assert a.shape == b.shape, (name, a.shape, b.shape)
    np.testing.assert_array_equal(a, b, err_msg=name)


def test_build_byte_equal_to_jax(models):
    jd, _ = models
    td = tda.DeviceRPGG.build(RPGG(os.path.join(GOLDEN, "pan")),
                              with_tre=True)
    for tn in ("dbi_tab", "trfl_tab", "member_tab", "tre_tab"):
        a, b = getattr(jd, tn), getattr(td, tn)
        if tn == "tre_tab":
            a = jda.DeviceRPGG.build(JRPGG(os.path.join(GOLDEN, "pan")),
                                     with_tre=True).tre_tab
        assert len(a.levels) == len(b.levels), tn
        for (x, s), (y, t) in zip(a.levels, b.levels):
            assert s == t and x.tobytes() == y.tobytes(), tn
    np.testing.assert_array_equal(jd.vv, td.vv)
    np.testing.assert_array_equal(jd.locus_offsets, td.locus_offsets)
    assert (jd.nloci, jd.nslots) == (td.nloci, td.nslots)


def test_upload_tables_same_bytes(models):
    jd, td = models
    tabs = tda.upload_tables({"dbi": jd.dbi_tab, "trfl": jd.trfl_tab},
                             jd.vv, jd.locus_offsets, "cpu")
    for name, jt in (("dbi", jd.dbi_tab), ("trfl", jd.trfl_tab)):
        for t, (x, s) in zip(tabs[name].levels, jt.levels):
            assert t.numpy().view(np.uint32).tobytes() == x.tobytes()
    np.testing.assert_array_equal(
        tabs["vv"].numpy().view(np.uint32), jd.vv.astype(np.uint32))
    assert td.tables("cpu") is td.tables("cpu")      # uploaded once


def test_prefilter_matches_jax(models, batches):
    jd, td = models
    jstep = jda.make_prefilter_step_q(jd, JCfg(**KW), P)
    tstep = tda.make_prefilter_step_q(td, AlignConfig(**KW), P, "cpu")
    for name, (codes, rlen, live) in batches.items():
        qlo, qhi, valid, nonshort = JK.sample_subfilter_queries(
            codes, rlen, 21, 4)
        want = jstep(qlo, qhi, valid, nonshort, live)
        got = tstep((qlo, qhi), valid, nonshort, live)
        _eq(name, want, got)
        got64 = tstep(tda.query_int64(qlo, qhi), valid, nonshort, live)
        _eq(name, want, got64)


@pytest.mark.parametrize("E", [512, 32])
def test_step_matches_jax(models, batches, E):
    jd, td = models
    jstep = jda.make_step(jd, JCfg(**KW), P, L, expand_cap=E,
                          with_annot=False)
    tstep = tda.make_step(td, AlignConfig(**KW), P, L, expand_cap=E,
                          device="cpu")
    jstate = jda.init_state(jd)
    tstate = tda.init_state(td, "cpu")
    nref = 0
    for name, (codes, rlen, live) in batches.items():
        jstate, jout = jstep(jstate, codes, rlen, live)
        tstate, tout = tstep(tstate, codes, rlen, live)
        assert set(jout) == set(tout), name
        for key in jout:
            _eq(f"{name}:{key}", jout[key], tout[key])
        for key in ("counts", "nmapread", "kmc"):
            np.testing.assert_array_equal(
                np.asarray(jstate[key]), tda.state_u32(tstate[key]),
                err_msg=f"{name}:state {key}")
        _eq(f"{name}:stats", jstate["stats"], tstate["stats"])
        nref += int(np.asarray(jout["referee"]).sum())
    assert nref > 0      # the batches reach the referee paths
    if E == 32:
        assert int(tstate["stats"][0]) > 0


def test_unported_modes_raise(models):
    _, td = models
    # bait tracking (-tb) is the one mode the device step refuses
    cfg = AlignConfig(**{**KW, "bait": True, "track_bait": True})
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tda.make_step(td, cfg, P, L, device="cpu")
    # okam, simmode, bait, QC, fastq, bubbles and extract are ported
    # (threading with -e: tests/test_torch_extract.py)
    for kw in (dict(okam=True), dict(bait=True), dict(output_bubbles=True),
               dict(qc=True), dict(simmode=2), dict(is_fastq=True),
               dict(extract=1), dict(extract=2)):
        tda.make_step(td, AlignConfig(**{**KW, **kw}), P, L, device="cpu")


def test_vote_shape_limit():
    W = 2 * (256 - 21 + 1)
    # the runner defaults take KC's main instance; the retry ladder's
    # E = 4096 tier still fits a block's shared memory (its large-E
    # instance); a larger E takes KC's global-workspace mode
    assert tda.check_vote_shape(W, 512) == "shared"
    assert tda.check_vote_shape(W, 4096) == "large-E"
    assert tda.kc_smem_bytes(W, 16384) > tda.SMEM_LIMIT
    assert tda.check_vote_shape(W, 16384) == "global"
    assert tda.kc_workspace_stride(W, 16384) % 256 == 0
    assert tda.kc_workspace_stride(W, 16384) >= tda.kc_smem_bytes(W, 16384)
    with pytest.raises(ValueError, match="E >= 1"):
        tda.check_vote_shape(W, 0)

