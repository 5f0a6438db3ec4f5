"""Each hand-written kernel against its plain torch version on a card, and
the golden counting, threading, okam and pred runs end to end on cuda.
Every comparison is exact (KH's as u32 views, NaNs included).

These tests import only the port (the card's machine has no JAX) and skip
without a card.  On the card:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""

import os

import numpy as np
import pytest
import torch

from danbing_tk_tpu_torch.engine import device_align as da
from danbing_tk_tpu_torch.engine.align_runner import DeviceAlignRunner
from danbing_tk_tpu_torch.engine.host_align import AlignConfig, RPGG
from danbing_tk_tpu_torch.index import device_table as dt
from danbing_tk_tpu_torch.kernels import build
from danbing_tk_tpu_torch.ops import kmers as km
from test_torch_assign_count import kd_cases, kd_run
from test_torch_kmers_filter_cases import (FLAGS, KF_MODES, ka_cases,
                                           kf_args, kf_cases, kk_cases)
from test_torch_pair_vote import vote_cases
from test_torch_site_scorer_cases import kj_args, kj_cases
from test_torch_walk_edges_cases import (ke_args, ke_cases, ke_state,
                                         kg_args, kg_cases)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
KW = dict(ksize=21, cth=20, n_filter=4, nm_filter=1, okam=False)
pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (python -m pytest --noconftest "
                    "-m gpu tests/test_torch_gpu.py on the card)")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def drp():
    return da.DeviceRPGG.build(RPGG(os.path.join(GOLDEN, "pan")),
                               with_tre=False)


def _reads(P, L, off=0):
    seqs = [l.strip() for l in open(os.path.join(GOLDEN, "reads.fa"))
            if not l.startswith(">")]
    return km.pack_reads(seqs[off: off + 2 * P], L)


@pytest.mark.parametrize("k", [21, 31])
def test_ka_matches_plain(cuda, k):
    rng = np.random.default_rng(k)
    codes = rng.integers(0, 4, (512, 160)).astype(np.uint8)
    codes[rng.random(codes.shape) < 0.02] = 255
    rlen = rng.integers(0, 161, 512).astype(np.int32)
    c = torch.from_numpy(codes).to(cuda)
    r = torch.from_numpy(rlen).to(cuda)
    n0 = build.launch_counts()["KA"]
    got = km.extract_kmers(c, r, k)
    want = km.extract_kmers_plain(c, r, k)
    assert build.launch_counts()["KA"] == n0 + 1
    for key in want:
        assert torch.equal(got[key], want[key]), key


@pytest.mark.parametrize("L", [150, 157, 160, 192, 256])
@pytest.mark.parametrize("k", [1, 21, 31])
def test_ka_adversarial_matches_plain(cuda, L, k):
    """KA in each plane set (nc and edges on or off) equals the plain
    version on the seeded adversarial reads of
    tests/test_torch_kmers_filter_cases.py (N runs at both ends, rlen 0 to
    L, bases past rlen), rows off a 16-B boundary (L = 150, 157) and an
    odd read count, so the planes' rows start off their pair boundary."""
    codes, rlen = ka_cases(11, 257, L, k)
    c = torch.from_numpy(codes).to(cuda)
    r = torch.from_numpy(rlen).to(cuda)
    for flags in FLAGS:
        n0 = build.launch_counts()["KA"]
        got = km.extract_kmers(c, r, k, **flags)
        assert build.launch_counts()["KA"] == n0 + 1
        want = km.extract_kmers_plain(c, r, k, **flags)
        assert set(got) == set(want)
        for key in want:
            assert torch.equal(got[key], want[key]), (key, flags)


@pytest.mark.parametrize("L", [21, 150, 160, 192])
@pytest.mark.parametrize("nf", [1, 2, 4, 7])
def test_kk_adversarial_matches_plain(cuda, L, nf):
    """KK equals prefilter_sample_plain on the seeded adversarial reads of
    tests/test_torch_kmers_filter_cases.kk_cases (reads shorter than k,
    rlen = L, Ns inside sampled windows, L = k: one window a read), an
    odd read count so the last block is partial."""
    k = 21
    codes, rlen = kk_cases(7, 1001, L, k, nf)
    c = torch.from_numpy(codes).to(cuda)
    r = torch.from_numpy(rlen).to(cuda)
    n0 = build.launch_counts()["KK"]
    got = km.prefilter_sample(c, r, k, nf)
    assert build.launch_counts()["KK"] == n0 + 1
    want = km.prefilter_sample_plain(c, r, k, nf)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    assert want[1].any()


def test_device_sampled_prefilter_on_cuda(cuda, drp, tmp_path, monkeypatch):
    """make_prefilter_step (KK, KB member) equals make_prefilter_step_q
    over the native host sampler on golden reads, one KK launch a
    dispatch; the golden funnel with DTK_PREFILTER_HOSTQ=0 writes the
    golden .trkmc.ar and launches KK."""
    from danbing_tk_tpu_torch.io.native_reader import sample_queries

    P, L = 1024, 160
    codes, rlen = _reads(P, L)
    live = np.ones(P, dtype=bool)
    cfg = AlignConfig(**KW)
    n0 = build.launch_counts()["KK"]
    got = da.make_prefilter_step(drp, cfg, P, L, cuda)(codes, rlen, live)
    assert build.launch_counts()["KK"] == n0 + 1
    qlo, qhi, valid, nonshort = sample_queries(codes, rlen, 21, 4)
    want = da.make_prefilter_step_q(drp, cfg, P, cuda)(
        (qlo, qhi), valid, nonshort, live)
    assert torch.equal(got, want) and bool(want.any())
    monkeypatch.setenv("DTK_PREFILTER_HOSTQ", "0")
    run = DeviceAlignRunner(RPGG(os.path.join(GOLDEN, "pan")),
                            AlignConfig(**KW), batch_pairs=1024,
                            max_read_len=192, device=cuda)
    n0 = build.launch_counts()["KK"]
    run.run_file_native(os.path.join(GOLDEN, "reads.fa"), prefilter=True)
    assert build.launch_counts()["KK"] > n0
    run.write_trkmc_ar(tmp_path / "out.trkmc.ar")
    with open(os.path.join(GOLDEN, "out.trkmc.ar"), "rb") as f:
        assert (tmp_path / "out.trkmc.ar").read_bytes() == f.read()


@pytest.mark.parametrize("NKW", [1, 2, 131, 140, 300, 2000])
@pytest.mark.parametrize("mode", range(len(KF_MODES)))
def test_kf_adversarial_matches_plain(cuda, NKW, mode):
    """KF (bait with and without QC and the quality mask, QC alone)
    equals read_filter_plain on the seeded adversarial pairs of
    tests/test_torch_kmers_filter_cases.py: one k-mer a read, k-mers at
    256 and 257 positions (the u8 wrap at NKW >= 257), mask holes, EMPTY
    and fully masked reads, dst0 = nloci, non-dev pairs; NKW = 2000 takes
    the four-warp blocks."""
    case = kf_cases(13, 101, NKW)
    a = kf_args(case, cuda, **KF_MODES[mode])
    n0 = build.launch_counts()["KF"]
    got = da.read_filter(*a)
    assert build.launch_counts()["KF"] == n0 + 1
    want = da.read_filter_plain(*a)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    if KF_MODES[mode]["bait"] and NKW > 2:
        assert want[3].any()


def test_kb_matches_plain(cuda, drp):
    rng = np.random.default_rng(1)
    keys = np.array(sorted(RPGG(os.path.join(GOLDEN, "pan")).dbi),
                    dtype=np.uint64).view(np.int64)
    q = np.concatenate([keys, rng.integers(0, 1 << 42, 5000),
                        np.full(64, -1)])
    qd = torch.from_numpy(q).to(cuda)
    loc = torch.from_numpy(rng.integers(0, drp.nloci, len(q))).to(cuda)
    tabs = drp.tables(cuda)
    for name in ("dbi", "member", "trfl"):
        ql = loc if tabs[name].composite else None
        n0 = build.launch_counts()["KB"]
        got = dt.lookup_bucket(tabs[name], qd, ql)
        want = dt.lookup_bucket_plain(tabs[name], qd, ql)
        assert build.launch_counts()["KB"] == n0 + 1
        for g, w in zip(got, want):
            assert torch.equal(g, w), name


@pytest.mark.parametrize("E,off", [(512, 0), (512, 1), (32, 1)])
def test_kc_kd_match_plain_on_step_inputs(cuda, drp, E, off):
    P, L = 1024, 192
    codes, rlen = _reads(P, L, off)
    cap = {}
    step = da.make_step(drp, AlignConfig(**KW), P, L, expand_cap=E,
                        device=cuda, capture=cap)
    state = da.init_state(drp, cuda)
    step(state, codes, rlen, np.ones(P, dtype=bool))
    for g, w in zip(da.pair_vote(*cap["KC"]),
                    da.pair_vote_plain(*cap["KC"])):
        assert torch.equal(g, w)
    sk, sp = da.init_state(drp, cuda), da.init_state(drp, cuda)
    got = da.assign_count(sk, *cap["KD"])
    want = da.assign_count_plain(sp, *cap["KD"])
    for key in want:
        assert torch.equal(got[key], want[key]), key
    for key in ("counts", "nmapread", "kmc"):
        assert torch.equal(sk[key], sp[key]), key


def test_golden_funnel_on_cuda(cuda, tmp_path):
    build.reset_launch_counts()
    run = DeviceAlignRunner(RPGG(os.path.join(GOLDEN, "pan")),
                            AlignConfig(**KW), device=cuda)
    run.run_file_native(os.path.join(GOLDEN, "reads.fa"), prefilter=True)
    run.write_trkmc_ar(tmp_path / "out.trkmc.ar")
    with open(os.path.join(GOLDEN, "out.trkmc.ar"), "rb") as f:
        assert (tmp_path / "out.trkmc.ar").read_bytes() == f.read()
    counts = build.launch_counts()
    assert min(counts[t] for t in ("KA", "KB", "KC", "KD")) > 0
    assert counts["KE"] == 0           # the walk runs only when threading


THR = dict(ksize=21, cth=20, n_filter=4, nm_filter=1, simmode=2,
           threading=True, thread_cth=50, maxncorrection=3, aln=True)


@pytest.fixture(scope="module")
def drp_graph():
    rp = RPGG(os.path.join(GOLDEN, "pan"))
    d = da.DeviceRPGG.build(rp, with_tre=False)
    d.add_graph(rp)
    return d


def test_kb_graph_kd_ke_match_plain_on_step_inputs(cuda, drp_graph):
    from danbing_tk_tpu_torch.io.native_reader import NativeBatchReader

    P, L = 1024, 192
    rd = NativeBatchReader(os.path.join(GOLDEN, "reads.sim.fa"), P, L,
                           min_read_size=40, with_titles=False)
    codes, rlen, n, _ = next(iter(rd))
    rd.close()
    cap = {}
    step = da.make_step(drp_graph, AlignConfig(**THR), P, L, device=cuda,
                        capture=cap)
    step(da.init_state(drp_graph, cuda), codes, rlen, np.arange(P) < n)
    # KB on the graph table at the walk's (nc, dst0), which the step's KE
    # probes itself
    graph, nc, dst0 = cap["KE"][:3]
    loc = dst0.repeat_interleave(2)[:, None].expand(-1, nc.shape[1])
    for g, w in zip(dt.lookup_bucket(graph, nc, loc),
                    dt.lookup_bucket_plain(graph, nc, loc)):
        assert torch.equal(g, w)
    sk, sp = da.init_state(drp_graph, cuda), da.init_state(drp_graph, cuda)
    got = da.assign_count(sk, *cap["KD"])
    want = da.assign_count_plain(sp, *cap["KD"])
    assert set(got) == set(want) >= {"tr_member", "slot"}
    for key in want:
        assert torch.equal(got[key], want[key]), key
    n0 = build.launch_counts()["KE"]
    got = da.thread_walk_graph(sk, *cap["KE"])
    want = da.thread_walk_graph_plain(sp, *cap["KE"])
    assert build.launch_counts()["KE"] == n0 + 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert bool(got[1].any()) and not bool(got[1].all())
    for key in ("counts", "nmapread", "kmc"):
        assert torch.equal(sk[key], sp[key]), key


def _golden_sites(rp, rng, n, k=21):
    """n failure sites [(kmers, ki, locus)] of golden-panel walks with a
    substitution at ki, a NAN64 hole at ki + 2, a truncation or a NAN64
    node (tests/test_torch_correct.py makes the same kinds)."""
    from danbing_tk_tpu_torch.ops.correct import NAN64

    rmask = (1 << (2 * (k - 1))) - 1
    graphs = rp.load_graphs()
    out = []
    while len(out) < n:
        li = int(rng.integers(0, rp.nloci))
        g = graphs[li]
        if not g:
            continue
        nodes = list(g)
        cur = int(nodes[int(rng.integers(0, len(nodes)))])
        kmers = [cur]
        while len(kmers) < 60 and g.get(cur, 0):
            bits, b = g[cur], int(rng.integers(0, 4))
            while not (bits >> b) & 1:
                b = (b + 1) % 4
            cur = ((cur & rmask) << 2) | b
            kmers.append(cur)
        if len(kmers) < 13:
            continue
        ki, mode = int(rng.integers(1, len(kmers) - 3)), len(out) % 4
        if mode == 0:
            kmers[ki] ^= int(rng.integers(1, 4))
        elif mode == 1:
            kmers[ki + 2] = NAN64
        elif mode == 2:
            kmers = kmers[: ki + int(rng.integers(1, 4))]
        else:
            kmers[ki - 1] = NAN64
        out.append((kmers, ki, li))
    return out


@pytest.mark.parametrize("mes", [2, 1])
def test_kj_matches_plain(cuda, drp_graph, mes):
    """KJ equals score_sites_plain on golden-panel sites with pad rows,
    NAN64 holes and nodes, at mes 2 and 1; one launch per call."""
    from danbing_tk_tpu_torch.ops import correct as cr

    rp = RPGG(os.path.join(GOLDEN, "pan"))
    B, k = 512, 21
    sites = _golden_sites(rp, np.random.default_rng(mes), B - 37, k)
    w_lo, w_hi, nkrem, loc = cr.sites_to_batch(sites, k=k, B=B)
    gtab = drp_graph.tables(cuda, graph=True)["graph"]
    args = [torch.from_numpy(a).to(cuda)
            for a in (cr.join_w(w_lo, w_hi), nkrem, loc)]
    n0 = build.launch_counts()["KJ"]
    got = cr.score_sites(gtab, *args, k, mes)
    assert build.launch_counts()["KJ"] == n0 + 1
    want = cr.score_sites_plain(gtab, *args, k, mes)
    assert got.dtype == torch.int32 and torch.equal(got, want)
    assert bool(got[:B - 37].any()) and not bool(got[B - 37:].any())
    scorer = cr.make_site_scorer(drp_graph, B, k=k, mes=mes)
    assert torch.equal(scorer(cr.join_w(w_lo, w_hi), nkrem, loc), want)
    assert build.launch_counts()["KJ"] == n0 + 2


@pytest.mark.parametrize("k,mes", [(17, 2), (21, 1), (21, 2), (32, 2)])
def test_kj_cases_match_plain(cuda, k, mes):
    """KJ equals score_sites_plain on tests/test_torch_site_scorer_cases.py's
    adversarial sites (edits of every kind, N holes, NAN64 nodes, nkrem 1-3,
    pad rows, tandem-repeat loci, branching graphs, keys past level 0),
    k = 17, 21 and 32, mes 1 and 2; one launch per call."""
    from danbing_tk_tpu_torch.ops import correct as cr

    case = kj_cases(5, 256, k)
    args = kj_args(case, cuda)
    n0 = build.launch_counts()["KJ"]
    got = cr.score_sites(*args, k, mes)
    assert build.launch_counts()["KJ"] == n0 + 1
    want = cr.score_sites_plain(*args, k, mes)
    assert torch.equal(got, want)
    assert bool(got.any()) and not bool(got[256 - case["npad"]:].any())


def test_golden_threading_on_cuda(cuda, tmp_path):
    build.reset_launch_counts()
    run = DeviceAlignRunner(RPGG(os.path.join(GOLDEN, "pan")),
                            AlignConfig(**THR), device=cuda)
    run.run_file_native(os.path.join(GOLDEN, "reads.sim.fa"), prefilter=True)
    run.write_aln(tmp_path / "out.aln")
    run.write_tr_kmers(tmp_path / "out.tr.kmers")
    for name, gold in (("out.aln", "out.thread.aln"),
                       ("out.tr.kmers", "out.thread.tr.kmers")):
        with open(os.path.join(GOLDEN, gold), "rb") as f:
            assert (tmp_path / name).read_bytes() == f.read(), name
    counts = build.launch_counts()
    assert min(counts[t] for t in ("KA", "KB", "KC", "KD", "KE")) > 0


@pytest.fixture(scope="module")
def drp_filters():
    rp = RPGG(os.path.join(GOLDEN, "pan"), bait=True,
              qc_file=os.path.join(GOLDEN, "qc.txt"))
    return da.DeviceRPGG.build(rp, with_tre=True)


FQ = dict(KW, okam=True, simmode=2, bait=True, qc=True, is_fastq=True,
          output_bubbles=True)


def test_kf_kg_kd_annot_match_plain_on_step_inputs(cuda, drp_filters):
    from danbing_tk_tpu_torch.io.native_reader import NativeBatchReader

    P, L = 1024, 192
    rd = NativeBatchReader(os.path.join(GOLDEN, "reads.sim.fq"), P, L,
                           is_fastq=True, min_read_size=40,
                           with_titles=False, with_quals=True)
    n_bf = n_qc = n_novel = 0
    for codes, rlen, n, _, quals in rd:
        cap = {}
        step = da.make_step(drp_filters, AlignConfig(**FQ), P, L,
                            with_annot=True, with_bubbles=True,
                            with_qual=True, device=cuda, capture=cap)
        qm = da.qmask_batch(quals, rlen, 20, 21)
        step(da.init_state(drp_filters, cuda), codes, rlen,
             np.arange(P) < n, qm)
        n0 = build.launch_counts()
        got = da.read_filter(*cap["KF"])
        want = da.read_filter_plain(*cap["KF"])
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        gk = da.novel_edges(*cap["KG"])
        assert torch.equal(gk, da.novel_edges_plain(*cap["KG"]))
        sk, sp = da.init_state(drp_filters, cuda), \
            da.init_state(drp_filters, cuda)
        gd = da.assign_count(sk, *cap["KD"])
        wd = da.assign_count_plain(sp, *cap["KD"])
        assert set(gd) == set(wd) >= {"ann"}
        for key in wd:
            assert torch.equal(gd[key], wd[key]), key
        for key in ("counts", "nmapread", "kmc"):
            assert torch.equal(sk[key], sp[key]), key
        n1 = build.launch_counts()
        assert [n1[t] - n0[t] for t in ("KD", "KF", "KG")] == [1, 1, 1]
        n_bf += int(got[3].sum())
        n_qc += int(got[1].sum())
        n_novel += int((gk != 0).sum())
    assert n_bf > 0 and n_qc > 0 and n_novel > 0


@pytest.mark.parametrize("mode", ["okam_bu", "fastq_bait"])
def test_golden_okam_on_cuda(cuda, tmp_path, mode):
    if mode == "okam_bu":
        rp = RPGG(os.path.join(GOLDEN, "pan"))
        cfg = AlignConfig(**dict(KW, okam=True, output_bubbles=True))
        reads, gold = "reads.fa", "out"
        outs = ("kam", "trkmc.ar", "bub.kmdb")
    else:
        rp = RPGG(os.path.join(GOLDEN, "pan"), bait=True)
        cfg = AlignConfig(**dict(KW, okam=True, simmode=2, bait=True,
                                 is_fastq=True))
        reads, gold = "reads.sim.fq", "out.fq"
        outs = ("kam", "trkmc.ar", "tr.summary.txt")
    build.reset_launch_counts()
    run = DeviceAlignRunner(rp, cfg, device=cuda)
    run.run_file_native(os.path.join(GOLDEN, reads), prefilter=True)
    run.write_kam(tmp_path / "o.kam")
    run.write_trkmc_ar(tmp_path / "o.trkmc.ar")
    run.write_summary(tmp_path / "o.tr.summary.txt")
    if cfg.output_bubbles:
        run.write_bubbles(tmp_path / "o.bub.kmdb")
    for ext in outs:
        with open(os.path.join(GOLDEN, f"{gold}.{ext}"), "rb") as f:
            assert (tmp_path / f"o.{ext}").read_bytes() == f.read(), ext
    counts = build.launch_counts()
    assert counts["KG" if mode == "okam_bu" else "KF"] > 0


def _pred_cases(cuda, tmp_path):
    """(gt on the card, ikmer.meta arrays): the golden cohort (nk % 4 ==
    2: KH's scalar divide) and fuzz cohorts of 13 samples (a ragged
    sample chunk) with skipped, zero-mean and zero-bias loci, with loci of
    200 k-mers (16 B aligned blocks) and of 203 (unaligned block ends)."""
    from danbing_tk_tpu_torch.analysis import pred
    from danbing_tk_tpu_torch.io import binary as bio
    from danbing_tk_tpu_torch.tools import scale_pred

    meta, ik = scale_pred.write_golden_cohort(GOLDEN, str(tmp_path))
    fns, rds = pred.read_gt_meta(meta)
    gmeta = bio.read_ikmer_meta(ik)
    gold = pred.load_gt_normalized(fns, rds, int(gmeta[0][-1]))
    cases = [(torch.from_numpy(gold).to(cuda), gmeta)]
    for kpl in (200, 203):
        co = scale_pred.build_cohort(13, nloci=300, kmers_per_locus=kpl,
                                     seed=3, p_dead=0.05, p_zero=0.05)
        cases.append((scale_pred.build_gt(co, cuda), (
            co["nk_cum"], co["nik_cum"], co["iki"], co["ikc"])))
    return cases


def test_kh_matches_plain_and_host_oracle(cuda, tmp_path):
    from danbing_tk_tpu_torch.analysis import pred

    for gt, meta in _pred_cases(cuda, tmp_path):
        k, p = gt.clone(), gt.clone()
        n0 = build.launch_counts()["KH"]
        bk = pred.bias_correction(k, *meta)
        bp = pred.bias_correction_plain(p, *meta)
        assert build.launch_counts()["KH"] == n0 + 1
        torch.cuda.synchronize()
        assert torch.equal(k.view(torch.int32), p.view(torch.int32))
        assert torch.equal(bk.view(torch.int32), bp.view(torch.int32))
        host = gt.cpu().numpy()
        with np.errstate(divide="ignore", invalid="ignore"):
            hb = pred.bias_correction_np(host, *meta)
        assert np.array_equal(k.cpu().numpy().view(np.uint32),
                              host.view(np.uint32))
        assert np.array_equal(bk.cpu().numpy().view(np.uint32),
                              hb.view(np.uint32))
    assert bool(torch.isnan(k).any()) and bool(torch.isinf(k).any())


def test_golden_pred_cli_on_cuda(cuda, tmp_path):
    from danbing_tk_tpu_torch.analysis import pred
    from danbing_tk_tpu_torch.apps import cli
    from danbing_tk_tpu_torch.io import binary as bio
    from danbing_tk_tpu_torch.tools import scale_pred

    meta, ik = scale_pred.write_golden_cohort(GOLDEN, str(tmp_path))
    outs = [str(tmp_path / o) for o in ("raw.gt", "corr.gt", "bias.tsv")]
    n0 = build.launch_counts()["KH"]
    cli.main(["pred", meta, ik] + outs)
    assert build.launch_counts()["KH"] == n0 + 1
    fns, rds = pred.read_gt_meta(meta)
    nk_cum, nik_cum, iki, ikc = bio.read_ikmer_meta(ik)
    gt = pred.load_gt_normalized(fns, rds, int(nk_cum[-1]))
    bio.write_gt_matrix(str(tmp_path / "o.raw"), gt)
    with np.errstate(divide="ignore", invalid="ignore"):
        bias = pred.bias_correction_np(gt, nk_cum, nik_cum, iki, ikc)
    bio.write_gt_matrix(str(tmp_path / "o.corr"), gt)
    pred.write_bias(str(tmp_path / "o.bias"), bias)
    for got, want in zip(outs, ("o.raw", "o.corr", "o.bias")):
        assert open(got, "rb").read() == (tmp_path / want).read_bytes()


def test_ki_matches_plain_on_row_blocks(cuda, drp):
    """KI on D = 4 row-block views of each golden table equals its plain
    version block by block, and the blocks' sum equals KB on the whole
    table for every non-EMPTY query (EMPTY queries match empty slots on
    every level, so only the collective's semantics, not KB's, hold for
    them)."""
    from danbing_tk_tpu_torch.parallel.sharded_index import row_blocks

    rng = np.random.default_rng(3)
    keys = np.array(sorted(RPGG(os.path.join(GOLDEN, "pan")).dbi),
                    dtype=np.uint64).view(np.int64)
    q = np.concatenate([keys, rng.integers(0, 1 << 42, 5000),
                        np.full(64, -1)])
    qd = torch.from_numpy(q).to(cuda)
    loc = torch.from_numpy(rng.integers(0, drp.nloci, len(q))).to(cuda)
    real = qd != -1
    tabs = drp.tables(cuda)
    for name in ("dbi", "member", "trfl"):
        ql = loc if tabs[name].composite else None
        tot = torch.zeros((3, len(q)), dtype=torch.int64, device=cuda)
        for block, meta in row_blocks(tabs[name], 4):
            n0 = build.launch_counts()["KI"]
            got = dt.lookup_bucket_owned(block, meta, qd, ql)
            assert build.launch_counts()["KI"] == n0 + 1
            want = dt.lookup_bucket_owned_plain(block, meta, qd, ql)
            for i, (g, w) in enumerate(zip(got, want)):
                assert torch.equal(g, w), name
                tot[i] += g.long() & 0xFFFFFFFF
        f, v, v2 = dt.lookup_bucket(tabs[name], qd, ql)
        assert torch.equal((tot[0] > 0)[real], f[real]), name
        assert torch.equal(tot[1][real], v[real]), name
        assert torch.equal(tot[2][real], v2[real]), name


def test_kc_large_e_matches_plain(cuda, drp):
    """KC's large-E mode (E = 4096, the retry tier: 512 threads a pair,
    the tables still in shared memory) equals pair_vote_plain on a step's
    real inputs."""
    P, L, E = 512, 192, 4096
    assert da.check_vote_shape(2 * (L - 20), E) == "large-E"
    # pairs 1024-1535 of the golden reads (the first ~800 pairs hold no
    # k-mer shared by many loci, so nothing there overflows E = 32)
    codes, rlen = _reads(P, L, 2048)
    cap = {}
    step = da.make_step(drp, AlignConfig(**KW), P, L, expand_cap=32,
                        device=cuda, capture=cap)
    step(da.init_state(drp, cuda), codes, rlen, np.ones(P, dtype=bool))
    args = list(cap["KC"])
    args[5] = E
    n0 = build.launch_counts()["KC[large-E]"]
    got = da.pair_vote(*args)
    assert build.launch_counts()["KC[large-E]"] == n0 + 1
    want = da.pair_vote_plain(*args)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    # the pairs overflow E = 32 and fit E = 4096
    assert bool((da.pair_vote_plain(*cap["KC"])[2] & 4).any())
    assert not bool((want[2] & 4).any())


@pytest.mark.parametrize("NKW", [140, 7])
@pytest.mark.parametrize("E", [512, 4096, 12000])
def test_kc_adversarial_matches_plain(cuda, NKW, E):
    """KC in each of its modes (E = 512: the main instance; E = 4096: the
    retry tier's shared-memory instance; E = 12000: past a block's shared
    memory, the global workspace) equals pair_vote_plain on the seeded
    adversarial pairs of tests/test_torch_pair_vote.py: empty and
    pair_kf-false pairs, all entries one k-mer, designed ties, vv runs
    totalling E and E + 1 and one longer than E, dead NAN32 loci, values
    varying within a run, EMPTY and INT64_MAX k-mers."""
    mode = da.check_vote_shape(2 * NKW, E)
    assert mode == {512: "shared", 4096: "large-E", 12000: "global"}[E]
    kmer, val, use, kf, vv = [
        torch.from_numpy(np.ascontiguousarray(a)).to(cuda)
        for a in vote_cases(E + NKW, 9 * 64, NKW, E)]
    cth = 20 if NKW == 140 else 2
    key = "KC" if mode == "shared" else "KC[large-E]"
    n0 = build.launch_counts()[key]
    got = da.pair_vote(kmer, val, use, kf, vv, E, cth)
    assert build.launch_counts()[key] == n0 + 1
    want = da.pair_vote_plain(kmer, val, use, kf, vv, E, cth)
    for g, w in zip(got, want):
        assert torch.equal(g, w), mode


@pytest.mark.parametrize("composite,nval", [(False, 2), (False, 0),
                                            (True, 1), (False, 1),
                                            (True, 2), (True, 0)])
def test_kb_edge_cases_match_plain(cuda, composite, nval):
    """KB on a dense seeded table of each row width (W = 4: dbi-like and
    composite; W = 2: the member table; W = 3 and 5: the scalar path):
    first- and second-level hits, misses through every level, EMPTY
    queries, and for a composite table keys with a wrong locus."""
    rng = np.random.default_rng(11 + 2 * composite + nval)
    n = 20000
    keys = np.unique(rng.integers(0, 1 << 62, n)).astype(np.uint64)
    n = len(keys)
    loci = rng.integers(0, 50, n).astype(np.uint32) if composite else None
    vals = rng.integers(0, 1 << 32, n).astype(np.uint32) if nval else None
    vals2 = rng.integers(0, 1 << 32, n).astype(np.uint32) \
        if nval == 2 else None
    tab = dt.build_bucket_table(keys, vals, loci, lam=7.0, vals2=vals2)
    assert len(tab.levels) >= 2
    dtab = dt.DevTable.upload(tab, cuda)
    q = np.concatenate([keys.view(np.int64), rng.integers(0, 1 << 62, 5000),
                        np.full(64, -1)])
    qd = torch.from_numpy(q).to(cuda)
    ql = None
    if composite:
        lq = np.concatenate([loci, rng.integers(0, 50, 5064)]).astype(
            np.int64)
        lq[: n // 10] += 1                       # a wrong locus: a miss
        ql = torch.from_numpy(lq).to(cuda)
    n0 = build.launch_counts()["KB"]
    got = dt.lookup_bucket(dtab, qd, ql)
    assert build.launch_counts()["KB"] == n0 + 1
    want = dt.lookup_bucket_plain(dtab, qd, ql)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    first = dt.DevTable(dtab.levels[:1], dtab.salts[:1], dtab.composite,
                        dtab.nval)
    f0 = dt.lookup_bucket_plain(first, qd, ql)[0]
    assert bool((want[0] & ~f0).any())            # second-level hits
    assert bool((~want[0][n:n + 5000]).any())     # misses


def test_sharded_runner_golden_on_cuda(cuda, tmp_path):
    """The sharded funnel on a world-1 NCCL group, index sharded, with
    the retry ladder: the golden .trkmc.ar, KI launched."""
    from danbing_tk_tpu_torch.parallel.runner import ShardedAlignRunner

    build.reset_launch_counts()
    run = ShardedAlignRunner(RPGG(os.path.join(GOLDEN, "pan")),
                             AlignConfig(**KW), batch_pairs=64,
                             max_read_len=192, expand_cap=128,
                             retry_expand=512, shard_index=True,
                             device=cuda)
    run.run_file_native(os.path.join(GOLDEN, "reads.fa"), prefilter=True)
    run.write_trkmc_ar(tmp_path / "out.trkmc.ar")
    with open(os.path.join(GOLDEN, "out.trkmc.ar"), "rb") as f:
        assert (tmp_path / "out.trkmc.ar").read_bytes() == f.read()
    assert run.n_retried > 0 and build.launch_counts()["KI"] > 0


def test_tables_uploaded_once_per_card(cuda, drp):
    """"cuda" and "cuda:<current>" share one upload of the tables (the
    sharded runner's mesh names the card with its index)."""
    idx = torch.device("cuda", torch.cuda.current_device())
    assert drp.tables(cuda) is drp.tables(idx)
    assert drp.tables(cuda)["dbi"] is drp.tables(idx)["dbi"]


@pytest.mark.parametrize("NKW", [1, 31, 33, 140, 172, 300])
@pytest.mark.parametrize("mode", ["counting", "annot", "threading",
                                  "no_bait"])
def test_kd_adversarial_matches_plain(cuda, NKW, mode):
    """KD in each instance equals assign_count_plain on the seeded
    adversarial reads of tests/test_torch_assign_count.py (no known
    position, alternating annotations, nt 1-3 after bs 1 and 2, ntr at
    nm_tr - 1 and nm_tr, kf == 1 and bait-filtered pairs, dev_pair false,
    dst0 = nloci and NAN32, one slot over a read, counts at the u32 wrap):
    the nine fields, counts / nmapread / kmc, and the ann, tr_member and
    slot planes; NKW 1 to 300 covers a partial chunk, reads shorter than
    a warp and reads past the register chunks."""
    case = kd_cases(7, 256, NKW)
    kw = dict(threading=mode == "threading", annot=mode == "annot",
              bait=mode != "no_bait")
    n0 = build.launch_counts()["KD"]
    got, gst = kd_run(case, cuda, **kw)
    assert build.launch_counts()["KD"] == n0 + 1
    want, wst = kd_run(case, "cpu", **kw)
    assert set(got) == set(want)
    for key in want:
        assert torch.equal(got[key].cpu(), want[key]), key
    for key in wst:
        assert torch.equal(gst[key].cpu(), wst[key]), key
    if mode != "threading":
        assert not torch.equal(wst["counts"],
                               torch.from_numpy(case["counts"]))


def _ki_table(rng, composite, nval, n=20000):
    keys = np.unique(rng.integers(0, 1 << 62, n)).astype(np.uint64)
    loci = rng.integers(0, 50, len(keys)).astype(np.uint32) \
        if composite else None
    vals = rng.integers(0, 1 << 32, len(keys)).astype(np.uint32) \
        if nval else None
    vals2 = rng.integers(0, 1 << 32, len(keys)).astype(np.uint32) \
        if nval == 2 else None
    return keys, loci, dt.build_bucket_table(keys, vals, loci, lam=7.0,
                                             vals2=vals2)


@pytest.mark.parametrize("D", [1, 2, 4])
@pytest.mark.parametrize("composite,nval", [(False, 2), (True, 1),
                                            (False, 0)])
def test_ki_edge_cases_match_plain(cuda, D, composite, nval):
    """KI on each of D row blocks of a dense seeded table (W = 4 dbi-like,
    the composite trfl layout, the W = 2 member table) equals
    lookup_bucket_owned_plain, and the blocks' sum equals KB for every
    non-EMPTY query: first- and second-level keys (among them keys whose
    level-0 bucket one rank owns and whose level-1 hit another owns),
    misses, EMPTY queries, wrong loci, and tiles of one repeated query."""
    from danbing_tk_tpu_torch.parallel.sharded_index import row_blocks

    rng = np.random.default_rng(21 + D + 2 * composite + nval)
    keys, loci, tab = _ki_table(rng, composite, nval)
    n = len(keys)
    assert len(tab.levels) >= 2
    dtab = dt.DevTable.upload(tab, cuda)
    # 64 copies of one key and 64 EMPTY queries fill 32-query tiles
    q = np.concatenate([keys.view(np.int64), rng.integers(0, 1 << 62, 5000),
                        np.full(32, -1), np.full(64, keys[7].view(np.int64)),
                        np.full(64, -1)])
    qd = torch.from_numpy(q).to(cuda)
    ql = None
    if composite:
        lq = np.concatenate([loci, rng.integers(0, 50, len(q) - n)]).astype(
            np.int64)
        lq[: n // 10] += 1                        # a wrong locus: a miss
        lq[-128:-64] = loci[7]
        ql = torch.from_numpy(lq).to(cuda)
    real = qd != -1
    tot = torch.zeros((3, len(q)), dtype=torch.int64, device=cuda)
    owners = []
    for block, meta in row_blocks(dtab, D):
        n0 = build.launch_counts()["KI"]
        got = dt.lookup_bucket_owned(block, meta, qd, ql)
        assert build.launch_counts()["KI"] == n0 + 1
        want = dt.lookup_bucket_owned_plain(block, meta, qd, ql)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        for i, g in enumerate(got):
            tot[i] += g.long() & 0xFFFFFFFF
        owners.append(got[0].bool())
    f, v, v2 = dt.lookup_bucket(dtab, qd, ql)
    assert torch.equal((tot[0] > 0)[real], f[real])
    assert torch.equal(tot[1][real], v[real])
    assert torch.equal(tot[2][real], v2[real])
    # second-level hits whose level-0 bucket lies in another block
    first = dt.DevTable(dtab.levels[:1], dtab.salts[:1], dtab.composite,
                        dtab.nval)
    lv2 = f & ~dt.lookup_bucket_plain(first, qd, ql)[0]
    assert bool(lv2.any())
    if D > 1:
        lo, hi = qd & 0xFFFFFFFF, (qd >> 32) & 0xFFFFFFFF
        lc = None if ql is None else ql & 0xFFFFFFFF
        b0 = dt.bucket_index(lo, hi, lc, dtab.salts[0],
                             dtab.levels[0].shape[0])
        rows0 = dtab.levels[0].shape[0] // D
        cross = torch.zeros_like(lv2)
        for d_, own in enumerate(owners):
            cross |= lv2 & own & (b0 // rows0 != d_)
        assert bool(cross.any())


@pytest.mark.parametrize("NKW", [1, 31, 33, 140, 300])
def test_ke_adversarial_matches_plain(cuda, NKW):
    """KE (the graph probe, the walk to each mate's first failure and the
    count scatter) equals thread_walk_graph_plain on the seeded adversarial
    mates of tests/test_torch_walk_edges_cases.py (failures at chunk edges,
    stalls, missing edge bits, nk 0 and past NKW, tandem repeats, slots out
    of range and in runs) on a two-level graph table, and launches once."""
    case = ke_cases(13, 300, NKW)
    sk, sp = ke_state(case, cuda), ke_state(case, cuda)
    n0 = build.launch_counts()["KE"]
    got = da.thread_walk_graph(sk, *ke_args(case, cuda))
    assert build.launch_counts()["KE"] == n0 + 1
    want = da.thread_walk_graph_plain(sp, *ke_args(case, cuda))
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert torch.equal(sk["counts"], sp["counts"])
    if NKW > 1:
        assert bool(got[1].any()) and not bool(got[1].all())


@pytest.mark.parametrize("NE", [1, 129, 130, 135, 139])
def test_kg_adversarial_matches_plain(cuda, NE):
    """KG equals novel_edges_plain on the seeded adversarial reads of
    tests/test_torch_walk_edges_cases.py (empty and clipped segments,
    rm and counted off, evalid holes, edges repeated in a tile) on a
    two-level tre table, and launches once."""
    case = kg_cases(13, 300, NE)
    n0 = build.launch_counts()["KG"]
    got = da.novel_edges(*kg_args(case, cuda))
    assert build.launch_counts()["KG"] == n0 + 1
    want = da.novel_edges_plain(*kg_args(case, cuda))
    assert torch.equal(got, want)
    assert bool(want.any())


@pytest.mark.parametrize("name", ["br", "bp"])
def test_golden_svms_on_cuda_match_cpu(cuda, name):
    """The golden SVM pickles (tests/golden_analysis/, read without
    sklearn) on cuda: on the 100,000 seeded rows of the production-batch
    check the labels equal sklearn's (svm_labels.npy) and the CPU's,
    decisions within 1e-9 relative or 1e-13 of their terms' magnitudes."""
    from danbing_tk_tpu_torch.models.svm import load_model
    from danbing_tk_tpu_torch.tools import analysis_scenario as sc

    ga = os.path.join(os.path.dirname(__file__), "golden_analysis")
    path = os.path.join(ga, f"{name}.svm")
    X = torch.from_numpy(sc.svm_batch(sc.SVM_ROWS, sc.SEED)[
        0 if name == "br" else 1])
    want = torch.from_numpy(sc.read_labels(
        os.path.join(ga, "svm_labels.npy"))[name])
    mg, mc = load_model(path, cuda), load_model(path, "cpu")
    assert mg.support_vectors_.is_cuda
    got = mg.predict(X.to(cuda)).cpu()
    assert torch.equal(got, want)
    assert torch.equal(got, mc.predict(X))
    dg = mg.decision_function(X.to(cuda)).cpu()
    dc = mc.decision_function(X)
    terms = (mc._kernel(X) * mc.dual_coef_[0]).abs().sum(1)
    assert bool(((dg - dc).abs() <= 1e-9 * dc.abs() + 1e-13 * terms).all())
