"""The port's graph-threading funnel against the JAX package and the
reference goldens, on the CPU (plain versions of the kernels).

* The runner's ordered threading funnel and the CLI on the golden panel
  write .aln and .tr.kmers byte-equal to the reference binary's
  tests/golden/out.thread.{aln,tr.kmers} (the JAX package's
  tests/test_native_threading.py holds its own runner to the same files);
  with -gcc, to the JAX HostAligner's.
* The threading step equals the JAX make_step(threading=True) on every
  output plane and every state key, trash slot included.
* KE's plain version equals a straightforward walk on hand-made mates.
* The port's native engine equals its Python engine read by read.
* The scale index's graph table and host view follow the fa2kmers -g rule.
Every comparison is exact: the pipeline is integer."""

import os

import numpy as np
import pytest
import torch

from danbing_tk_tpu.engine import device_align as jda
from danbing_tk_tpu.engine.host_align import AlignConfig as JCfg
from danbing_tk_tpu.engine.host_align import HostAligner as JHost
from danbing_tk_tpu.engine.host_align import RPGG as JRPGG
from danbing_tk_tpu_torch.apps import cli
from danbing_tk_tpu_torch.engine import device_align as tda
from danbing_tk_tpu_torch.engine import native_thread as nt
from danbing_tk_tpu_torch.engine import threading as thr
from danbing_tk_tpu_torch.engine.align_runner import (DeviceAlignRunner,
                                                      _decode)
from danbing_tk_tpu_torch.engine.host_align import AlignConfig, RPGG
from danbing_tk_tpu_torch.io.native_reader import NativeBatchReader
from danbing_tk_tpu_torch.ops import kmers_np as K

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
READS = os.path.join(GOLDEN, "reads.sim.fa")
# the golden run: -cth 20 -kf 4 1 -s 2 -gc 50 3 -a
KW = dict(ksize=21, cth=20, n_filter=4, nm_filter=1, simmode=2,
          threading=True, thread_cth=50, maxncorrection=3, aln=True)
P, L = 256, 192


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several workers per machine: one intra-op thread
    each keeps torch's CPU kernels from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _gold(name):
    with open(os.path.join(GOLDEN, name), "rb") as f:
        return f.read()


@pytest.mark.parametrize("prefilter", [False, True])
def test_runner_threading_golden(tmp_path, prefilter):
    run = DeviceAlignRunner(RPGG(os.path.join(GOLDEN, "pan")),
                            AlignConfig(**KW), batch_pairs=512,
                            max_read_len=L, device="cpu")
    run.run_file_native(READS, prefilter=prefilter)
    run.write_aln(tmp_path / "out.aln")
    run.write_tr_kmers(tmp_path / "out.tr.kmers")
    assert (tmp_path / "out.aln").read_bytes() == _gold("out.thread.aln")
    assert (tmp_path / "out.tr.kmers").read_bytes() == \
        _gold("out.thread.tr.kmers")
    # most pairs walk clean on the device; the rest take the engine
    assert run.n_device_thread > run.n_host_thread > 0
    assert run.n_device_thread + run.n_host_thread + run.n_referee == \
        len(_gold("out.thread.aln").splitlines())


def test_runner_gcc_matches_jax_host(tmp_path):
    """-gcc (cfg.tc): fallback pairs go to the Python engine and its
    thread_check, which marks a broken re-walk with '!' in the .aln
    annotation, so the rows differ from the goldens by design; the JAX
    HostAligner with tc on the same 200 pairs is the reference."""
    sub = tmp_path / "sub.fa"
    with open(READS) as f:        # pairs 2300-2499 hold a marked row
        sub.write_text("".join(f.readlines()[4 * 2300: 4 * 2500]))
    run = DeviceAlignRunner(RPGG(os.path.join(GOLDEN, "pan")),
                            AlignConfig(**KW, tc=True), batch_pairs=128,
                            max_read_len=L, device="cpu")
    assert run.nthr is None
    run.run_file_native(str(sub), prefilter=True)
    assert run.n_host_thread > 0
    ref = JHost(JRPGG(os.path.join(GOLDEN, "pan")), JCfg(**KW, tc=True))
    ref.run_file(str(sub))
    run.write_aln(tmp_path / "port.aln")
    ref.write_aln(tmp_path / "jax.aln")
    got = (tmp_path / "port.aln").read_bytes()
    assert got == (tmp_path / "jax.aln").read_bytes()
    assert b"!" in got
    np.testing.assert_array_equal(run.flat_counts(), ref.flat_counts())


def test_cli_threading_golden_on_cpu(tmp_path):
    out = str(tmp_path / "OUT")
    cli.main(["align", "--device", "--native-io", "--prefilter", "-cth",
              "20", "-kf", "4", "1", "-s", "2", "-gc", "50", "3", "-a",
              "-qs", os.path.join(GOLDEN, "pan"), "-fa", READS, "-on", out,
              "--torch-device", "cpu"])
    with open(out + ".aln", "rb") as f:
        assert f.read() == _gold("out.thread.aln")
    with open(out + ".tr.kmers", "rb") as f:
        assert f.read() == _gold("out.thread.tr.kmers")
    # the JAX CLI writes no summary in threading mode
    assert not os.path.exists(out + ".tr.summary.txt")


@pytest.fixture(scope="module")
def models():
    jr = JRPGG(os.path.join(GOLDEN, "pan"))
    jd = jda.DeviceRPGG.build(jr, with_tre=False)
    jd.add_graph(jr)
    td = tda.DeviceRPGG(jd.nloci, jd.dbi_tab, jd.vv, jd.trfl_tab, None,
                        jd.locus_offsets, jd.nslots,
                        member_tab=jd.member_tab, graph_tab=jd.graph_tab)
    return jd, td


def _sim_batches(n):
    rd = NativeBatchReader(READS, P, L, min_read_size=40, with_titles=False)
    it = iter(rd)
    out = [next(it)[:3] for _ in range(n)]
    rd.close()
    return out


def test_add_graph_byte_equal_to_jax(models):
    jd, _ = models
    rp = RPGG(os.path.join(GOLDEN, "pan"))
    td = tda.DeviceRPGG.build(rp, with_tre=False)
    td.add_graph(rp)
    assert len(td.graph_tab.levels) == len(jd.graph_tab.levels)
    for (a, s), (b, t) in zip(jd.graph_tab.levels, td.graph_tab.levels):
        assert s == t and a.tobytes() == b.tobytes()
    # counting steps never hold the graph table; threading steps share one
    tabs = td.tables("cpu", graph=True)
    assert tabs["graph"].composite and tabs is td.tables("cpu", graph=True)
    assert "graph" not in td.tables("cpu")
    assert tabs["dbi"] is td.tables("cpu")["dbi"]


def test_threading_step_matches_jax(models):
    jd, td = models
    jstep = jda.make_step(jd, JCfg(**KW), P, L, with_annot=False,
                          threading=True)
    tstep = tda.make_step(td, AlignConfig(**KW), P, L, device="cpu")
    js, ts = jda.init_state(jd), tda.init_state(td, "cpu")
    n_clean = n_unclean = 0
    for bi, (codes, rlen, n) in enumerate(_sim_batches(3)):
        live = np.zeros(P, dtype=bool)
        live[:n] = True
        if bi == 2:
            live[-5:] = False        # dead slots inside a batch
        js, jo = jstep(js, codes, rlen, live)
        ts, to = tstep(ts, codes, rlen, live)
        assert set(jo) == set(to)
        assert {"clean", "clean_pair", "tr_member"} <= set(to)
        for key in jo:
            a = np.asarray(jo[key]).astype(np.int64)
            b = to[key].numpy().astype(np.int64)
            assert a.shape == b.shape, key
            np.testing.assert_array_equal(a, b, err_msg=f"{bi}:{key}")
        for key in ("counts", "nmapread", "kmc"):
            np.testing.assert_array_equal(
                np.asarray(js[key]), tda.state_u32(ts[key]),
                err_msg=f"{bi}:state {key}")
        np.testing.assert_array_equal(np.asarray(js["stats"]),
                                      ts["stats"].numpy())
        cp, vp = to["clean_pair"].numpy(), to["vote_pass"].numpy()
        n_clean += int(cp.sum())
        n_unclean += int((vp & ~cp).sum())
    assert n_clean > 0 and n_unclean > 0
    # nmapread / kmc stay untouched in threading mode; the trash slot
    # holds every position no clean pair counted
    assert not ts["nmapread"].any() and not ts["kmc"].any()
    assert int(ts["counts"][-1]) > 0


def _walk_np(nc, gfound, gmask, kvalid, nk, dev_pair):
    """The clean walk, one position at a time."""
    R, _ = nc.shape
    clean = np.zeros(R, dtype=bool)
    for r in range(R):
        n = int(nk[r])
        ok = n > 0 and bool(dev_pair[r // 2])
        for j in range(n):
            if not kvalid[r, j] or not gfound[r, j]:
                ok = False
            if j > 0 and nc[r, j] == nc[r, j - 1]:
                ok = False
            if j + 1 < n and not (int(gmask[r, j]) >> (int(nc[r, j + 1])
                                                        & 3)) & 1:
                ok = False
        clean[r] = ok
    return clean


def test_thread_walk_plain_on_handmade_mates():
    NKW, nslots = 8, 50
    rng = np.random.default_rng(3)
    # a clean mate: consecutive nodes, each edge bit set for the next base
    base = rng.integers(0, 1 << 40, NKW).astype(np.int64)
    mask = np.zeros(NKW, dtype=np.int64)
    mask[:-1] = 1 << (base[1:] & 3)
    R = 12
    nc = np.tile(base, (R, 1))
    gmask = np.tile(mask, (R, 1))
    gfound = np.ones((R, NKW), dtype=bool)
    kvalid = np.ones((R, NKW), dtype=bool)
    nk = np.full(R, NKW, dtype=np.int32)
    dev_pair = np.ones(R // 2, dtype=bool)
    kvalid[2, 4] = False                  # an N inside the read
    nc[2, 4] = -1
    nc[4, 5] = nc[4, 4]                   # a homopolymer stall
    gmask[6, 2] = 0                       # a missing edge
    nk[8] = 0                             # no k-mer at all
    nk[10] = 5                            # past nk: EMPTY, not in the
    nc[10, 5:] = -1                       # graph, no edge -- still clean
    gfound[10, 5:] = False
    kvalid[10, 5:] = False
    gmask[10, 4:] = 0
    gfound[11, 7] = False                 # a node missing from the graph
    tr_member = rng.integers(0, 2, (R, NKW)).astype(np.uint8)
    slot = rng.integers(0, nslots + 3, (R, NKW)).astype(np.int64)

    want = _walk_np(nc, gfound, gmask, kvalid, nk, dev_pair)
    assert want.tolist() == [True, True, False, True, False, True, False,
                             True, False, True, True, False]
    t = torch.from_numpy
    state = {"counts": torch.zeros(nslots + 1, dtype=torch.int32)}
    clean, clean_pair = tda.thread_walk_plain(
        state, t(nc), t(gfound), t(gmask), t(kvalid), t(nk), t(dev_pair),
        t(tr_member), t(slot))
    assert clean.numpy().tolist() == want.tolist()
    pair = want.reshape(-1, 2).all(1)
    assert clean_pair.numpy().tolist() == pair.tolist()
    # counts: TR members of clean pairs inside the read, out-of-range
    # slots dropped, everything else in the trash slot
    expect = np.zeros(nslots + 1, dtype=np.int64)
    for r in range(R):
        for j in range(NKW):
            if pair[r // 2] and j < nk[r] and tr_member[r, j]:
                if slot[r, j] <= nslots:
                    expect[slot[r, j]] += 1
            else:
                expect[nslots] += 1
    np.testing.assert_array_equal(state["counts"].numpy(), expect)


def test_native_engine_matches_python(models):
    """NativeThreader.thread_read == the Python is_thread_feasible on 50
    reads that the device walk sends to the fallback."""
    _, td = models
    cfg = AlignConfig(**KW)
    rp = RPGG(os.path.join(GOLDEN, "pan"))
    graphs = rp.load_graphs()
    step = tda.make_step(td, cfg, P, L, device="cpu")
    codes, rlen, n = _sim_batches(1)[0]
    live = np.arange(P) < n
    _, out = step(tda.init_state(td, "cpu"), codes, rlen, live)
    fb = (out["vote_pass"] & ~out["clean_pair"] & ~out["referee"]).numpy()
    pairs = np.nonzero(fb)[0][:25]
    assert len(pairs) == 25
    native = nt.NativeThreader()
    n_corr = 0
    for i in pairs:
        d = int(out["dst0"][i])
        native.prepare(d, graphs[d], rp.tr_counts[d])
        for r in (2 * i, 2 * i + 1):
            seq = _decode(codes[r], rlen[r])
            st, es, tr, kms = native.thread_read(
                d, seq, cfg.thread_cth, cfg.correction, cfg.ksize,
                cfg.maxncorrection)
            cg = thr.Cigar(seq, cfg.ksize)
            st_p, _, kms_p = thr.is_thread_feasible(
                graphs[d], seq, cfg.thread_cth, cfg.correction, cg,
                rp.tr_counts[d], cfg.ksize, cfg.maxncorrection)
            assert st == st_p
            assert thr.write_cigar(es) == thr.write_cigar(cg.es)
            assert thr.write_annot(tr) == thr.write_annot(cg.tr)
            assert kms == [int(x) for x in kms_p]
            n_corr += st == 2
    assert n_corr > 0          # error correction was exercised


def test_truncated_engine_row_raises():
    assert nt.split_cg_row(b"150=\t20.130=", 3, 64) == ("150=", "20.130=")
    with pytest.raises(ValueError, match=r"row 7 .*cg_stride=48"):
        nt.split_cg_row(b"1=1X1=1X1=1X1=1X1=1X1=1X1=1X1=1X1=1X1=1X1=1X1=",
                        7, 48)


def test_scale_graph_follows_fa2kmers_rule():
    from danbing_tk_tpu_torch.tools import scale_index as si

    rng = np.random.default_rng(5)
    seqs = rng.integers(0, 4, (6, 90), dtype=np.uint8)
    seqs[2, 30:60] = seqs[2, 0]           # a homopolymer: self-loops
    acgt = np.frombuffer(b"ACGT", np.uint8)
    node, mask, rows = si.locus_graphs(seqs, 21)
    view = si.ScaleThreadView(seqs)
    ahead = si.ScaleThreadView(seqs)         # built up front, in chunks
    ahead.build([4, 0, -1, 5, 1, 2, 3, 4], chunk=4)
    for d in range(len(seqs)):
        seq = acgt[seqs[d]].tobytes().decode()
        g, tr = {}, {}
        K.build_kmer_graph(g, seq, 21)
        K.count_kmers(tr, seq, 21)
        sel = rows == d
        assert g == dict(zip(node[sel].tolist(), mask[sel].tolist()))
        for v in (view, ahead):
            vn, vm = v.graphs[d]
            assert g == dict(zip(vn.tolist(), vm.tolist()))
            assert set(v.tr_counts[d]) == set(tr)
    tab, n = si.build_scale_graph(seqs, chunk=4, verbose=False)
    assert n == len(node) and tab.composite
    codes, _ = si.sample_read_batch(seqs, 200, 60, np.random.default_rng(
        [5, 1]), frac_tr=1.0, flen=80, read_len=60, sub_rate=0.05)
    clean, _, loci = si.sample_read_batch(
        seqs, 200, 60, np.random.default_rng([5, 1]), frac_tr=1.0, flen=80,
        read_len=60, with_loci=True)
    assert 0.02 < (codes != clean).mean() < 0.08
    # mate 1 is a stretch of its source locus
    for i in range(200):
        row, src = clean[2 * i].tobytes(), seqs[loci[i]].tobytes()
        assert row in src
