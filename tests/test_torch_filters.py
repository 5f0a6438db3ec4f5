"""Port QC (K10), bait (K9) and bubble (K11) stages against the JAX
package's.

The port's DeviceRPGG.build must give the JAX bait and tre tables byte for
byte, and qmask_batch the JAX quality mask.  make_step with the ann plane,
bubbles and the quality mask (plain versions of KA-KG on the CPU) must
equal the JAX make_step on every output plane, every state key and all 9
stats, on reads.sim.fq batches with the golden bait table and QC mask, and
on fuzz batches (Ns, a fuzz bait table and QC mask from a numpy seed, so
that the filters fire often); KF's and KG's plain versions, called on the
port step's own inputs, must give the JAX step's planes.  Every
comparison is exact: the pipeline is integer.  test_torch_gpu.py holds the
kernels against these plain versions on a card."""

import os

import numpy as np
import pytest
import torch

from danbing_tk_tpu.engine import device_align as jda
from danbing_tk_tpu.engine.host_align import AlignConfig as JCfg
from danbing_tk_tpu.engine.host_align import RPGG as JRPGG
from danbing_tk_tpu.index import device_table as jdt
from danbing_tk_tpu_torch.engine import device_align as tda
from danbing_tk_tpu_torch.engine.host_align import AlignConfig, RPGG
from danbing_tk_tpu_torch.io.native_reader import NativeBatchReader

P, L = 256, 192
GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
PAN = os.path.join(GOLDEN, "pan")
QC = os.path.join(GOLDEN, "qc.txt")
KW = dict(ksize=21, cth=20, n_filter=4, nm_filter=1, simmode=2, bait=True,
          qc=True, is_fastq=True, output_bubbles=True)


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
    jd = jda.DeviceRPGG.build(JRPGG(PAN, bait=True, qc_file=QC),
                              with_tre=True)
    td = tda.DeviceRPGG.build(RPGG(PAN, bait=True, qc_file=QC),
                              with_tre=True)
    return jd, td


@pytest.fixture(scope="module")
def fq_batches():
    """The reads.sim.fq batches of P pairs: (codes, rlen, n, quals)."""
    rd = NativeBatchReader(os.path.join(GOLDEN, "reads.sim.fq"), P, L,
                           is_fastq=True, min_read_size=40,
                           with_titles=False, with_quals=True)
    return [(c, r, n, q) for c, r, n, _, q in rd]


def _fuzz_models(jd, td, rng):
    """The golden models with a fuzz bait table (a quarter of each locus's
    TR k-mers, windows [mi, ma] with mi, ma in 0..3 or ma = 255) and a
    fuzz QC mask (a third of the loci fail), the same numpy tables on
    both sides."""
    rp = RPGG(PAN)
    bk, bl, bv = [], [], []
    for li in range(rp.nloci):
        kms = np.array(list(rp.tr_orders[li]), dtype=np.uint64)
        kms = kms[rng.random(len(kms)) < 0.25]
        mi = rng.integers(0, 3, len(kms))
        ma = np.where(rng.random(len(kms)) < 0.5, 255,
                      mi + rng.integers(0, 2, len(kms)))
        bk.append(kms)
        bl.append(np.full(len(kms), li, np.uint32))
        bv.append(((mi << 8) | ma).astype(np.uint32))
    bait = jdt.build_bucket_table(np.concatenate(bk), np.concatenate(bv),
                                  np.concatenate(bl))
    qc = (rng.random(rp.nloci) >= 1 / 3).astype(np.uint8)
    jf = jda.DeviceRPGG(jd.nloci, jd.dbi_tab, jd.vv, jd.trfl_tab,
                        jd.tre_tab, jd.locus_offsets, jd.nslots, bait, qc,
                        member_tab=jd.member_tab)
    tf = tda.DeviceRPGG(td.nloci, td.dbi_tab, td.vv, td.trfl_tab,
                        td.tre_tab, td.locus_offsets, td.nslots, bait, qc,
                        member_tab=td.member_tab)
    return jf, tf


def _eq(name, want, got):
    a = np.asarray(want).astype(np.int64)
    b = got.cpu().numpy().astype(np.int64)
    assert a.shape == b.shape, (name, a.shape, b.shape)
    np.testing.assert_array_equal(a, b, err_msg=name)


def test_tables_equal_jax(models):
    jd, td = models
    for tn in ("bait_tab", "tre_tab"):
        a, b = getattr(jd, tn), getattr(td, tn)
        assert (a.composite, a.nval) == (b.composite, b.nval), tn
        assert len(a.levels) == len(b.levels), tn
        for (x, s), (y, t) in zip(a.levels, b.levels):
            assert s == t and x.tobytes() == y.tobytes(), tn
    np.testing.assert_array_equal(jd.qc, td.qc)
    assert int((td.qc == 0).sum()) > 0
    qc = td.tables("cpu", qc=True)["qc"]
    assert qc.dtype == torch.uint8 and qc.shape == (td.nloci + 1,)
    assert int(qc[-1]) == 0 and (qc[:-1].numpy() == td.qc).all()


def test_qmask_batch_matches_jax():
    rng = np.random.default_rng(5)
    R, Lq, k = 300, 120, 21
    quals = rng.integers(53, 74, (R, Lq)).astype(np.uint8)
    quals[rng.random((R, Lq)) < 0.03] = ord("#")
    rlen = rng.integers(0, Lq + 1, R).astype(np.int32)
    quals[np.arange(Lq)[None, :] >= rlen[:, None]] = 0
    for qth in (2, 15, 20):
        want = jda.qmask_batch(quals, rlen, qth, k)
        got = tda.qmask_batch(quals, rlen, qth, k)
        np.testing.assert_array_equal(want, got)
        assert got.any() and not got.all()


@pytest.mark.parametrize("kind", ["golden", "fuzz"])
def test_step_matches_jax(models, fq_batches, kind):
    jd, td = models
    picks = [fq_batches[0], fq_batches[3]]
    if kind == "fuzz":
        rng = np.random.default_rng(17)
        jd, td = _fuzz_models(jd, td, rng)
        picks = []
        for codes, rlen, n, quals in fq_batches[7:9]:
            codes = codes.copy()
            # Ns inside the reads: EMPTY k-mer and edge positions
            ns = (rng.random(codes.shape) < 0.004) \
                & (np.arange(L)[None, :] < rlen[:, None])
            codes[ns] = 255
            picks.append((codes, rlen, n, quals))
    jstep = jda.make_step(jd, JCfg(**KW), P, L, with_annot=True,
                          with_bubbles=True, with_qual=True)
    cap = {}
    tstep = tda.make_step(td, AlignConfig(**KW), P, L, with_annot=True,
                          with_bubbles=True, with_qual=True, device="cpu",
                          capture=cap)
    jstate, tstate = jda.init_state(jd), tda.init_state(td, "cpu")
    n_bf = n_qc = n_novel = 0
    for bi, (codes, rlen, n, quals) in enumerate(picks):
        live = np.arange(P) < n
        qm = tda.qmask_batch(quals, rlen, 20, 21)
        jstate, jout = jstep(jstate, codes, rlen, live, qm)
        tstate, tout = tstep(tstate, codes, rlen, live, qm)
        assert set(jout) == set(tout) >= {"ann", "novel_pack", "novel_edge"}
        for key in jout:
            _eq(f"{kind}{bi}:{key}", jout[key], tout[key])
        for key in ("counts", "nmapread", "kmc"):
            np.testing.assert_array_equal(
                np.asarray(jstate[key]), tda.state_u32(tstate[key]),
                err_msg=f"{kind}{bi}:state {key}")
        _eq(f"{kind}{bi}:stats", jstate["stats"], tstate["stats"])
        # the plain kernels on the step's own inputs give the JAX planes
        dev_pair, qc_drop, bf, bf_pair = tda.read_filter_plain(*cap["KF"])
        _eq("KF qc_drop", jout["qc_drop"], qc_drop)
        _eq("KF bf", jout["bf"], bf)
        _eq("KF bf_pair", np.asarray(jout["bf"]).reshape(P, 2).any(1),
            bf_pair)
        _eq("KG", jout["novel_pack"], tda.novel_edges_plain(*cap["KG"]))
        n_bf += int(bf_pair.sum())
        n_qc += int(qc_drop.sum())
        n_novel += int(np.asarray(jout["novel_edge"]).sum())
    assert n_bf > 0 and n_qc > 0 and n_novel > 0
    assert int(tstate["stats"][7]) > 0 and int(tstate["stats"][8]) > 0


def test_pack_bits_is_numpy_packbits():
    rng = np.random.default_rng(3)
    for n in (1, 8, 13, 139):
        m = rng.random((5, n)) < 0.4
        b = tda.pack_bits(torch.from_numpy(m))
        np.testing.assert_array_equal(b.numpy(), np.packbits(m, axis=-1))
        np.testing.assert_array_equal(tda.unpack_bits(b, n).numpy(), m)


def test_cli_fastq_bait_golden_on_cpu(tmp_path):
    """``align ... -fq reads.sim.fq -b -s 2 --torch-device cpu``: KF with
    the quality mask through the CLI, byte-equal to out.fq.*."""
    from danbing_tk_tpu_torch.apps import cli

    out = str(tmp_path / "OUT")
    cli.main(["align", "--device", "--native-io", "--prefilter", "-cth",
              "20", "-kf", "4", "1", "-qs", PAN, "-o", out, "--torch-device",
              "cpu", "-b", "-s", "2", "-fq",
              os.path.join(GOLDEN, "reads.sim.fq")])
    for ext in ("kam", "trkmc.ar", "tr.summary.txt"):
        with open(f"{out}.{ext}", "rb") as f, \
                open(os.path.join(GOLDEN, f"out.fq.{ext}"), "rb") as g:
            assert f.read() == g.read(), ext
