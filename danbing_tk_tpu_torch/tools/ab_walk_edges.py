"""Same-call A/B of KG (the novel-edge tre probe) and KE (the threading
walk with its graph probe) against another checkout's.

    python -m danbing_tk_tpu_torch.tools.ab_walk_edges --parent DIR
        [--nloci N] [--pairs N] [--seed S]

Builds ``DIR/danbing_tk_tpu_torch/csrc/{novel_edges,thread_walk,
bucket_lookup}.cu`` (another checkout with the same entry points, e.g. the
parent commit unpacked with ``git archive``; only its ``csrc/`` is read)
beside this tree's, with ``-Xptxas -v`` (KI's ``sharded_lookup.cu`` too,
for its registers), and captures the inputs once, P = 4,096 pairs, L =
160, k = 21:

* KE (a): ``chip_smoke.py`` phase 6's threading-step inputs: the synthetic
  scale index (``tools/scale_index.py``, 1,500 k-mers per locus) and its
  graph table, ``-gc 85 3``, TR pairs with 0.5% substitutions; (b) the
  golden threading step (the first 4,096 pairs of
  ``tests/golden/reads.sim.fa``, ``-s 2 -gc 50 3``).
* KG (a): phase 7b's okam-step inputs (the scale tre table, a bait table
  of 64 k-mers a locus, a QC mask failing 5% of the loci, TR pairs with
  0.5% substitutions, ``-s 2 -b -qc -bu``); (b) the golden ``-bu`` step
  (the first 4,096 pairs of ``tests/golden/reads.fa``).

A side whose ``thread_walk`` library exports ``dtk_thread_walk_graph``
runs KE fused, one launch; any other side runs KB on the graph table at
(nc, dst0) and then its walk-only KE, two launches, as the parent's
threading step did.  Both compute the same function.

Each case is first run through both builds, which must give the plain
version's outputs (KE: clean, clean_pair and the counts from a zero
state).  Then, in ``--pairs`` alternating pairs (parent first in even
pairs), each side's time: bare, the ctypes calls with their arguments
built once, the median over 10 CUDA-event windows of 20 back-to-back
calls divided by 20; graph, the same 20 calls captured in a CUDA graph
and replayed (10 windows of 5 replays, divided by 100), which leaves out
the host's ctypes call (about 7 us a call, so below about 10 us only the
graph time measures the kernel); and the wrapper window the smoke times
(10 windows of 10 calls), which holds the host's enqueue and
allocations.  Prints the card, the builds' registers and shared memory,
each side's grid, what sets each case's work, every pair, both medians
and quartiles, and the change's wins.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ..engine import device_align as da
from ..engine.host_align import RPGG, AlignConfig
from ..index import device_table as dt
from ..kernels import build
from ..ops import kmers as km
from .ab_assign_count import ab_pairs, card_name
from .ab_kmers_filter import GOLDEN, ab_all
from .scale_index import (build_scale_bait, build_scale_graph, build_scale_qc,
                          build_scale_rpgg, build_scale_tre,
                          sample_read_batch)

KB_SIG = "ppipppiiipppp"
KE_SIG = "ii" + "p" * 8 + "i" + "p" * 4
KEG_SIG = "ii" + "p" * 7 + "i" + "pppi" + "pppp"
KG_SIG = "ii" + "p" * 7 + "pppi" + "pp"
P, L, K, E, RL, SUB = 4096, 160, 21, 512, 150, 0.005
SOURCES = ("novel_edges", "thread_walk", "bucket_lookup", "sharded_lookup")


def fused(lib) -> bool:
    return hasattr(lib, "dtk_thread_walk_graph")


def ke_inputs(drp, cfg, codes, rlen, dev) -> tuple:
    """The threading step's KE inputs (graph, nc, dst0, kvalid, nk,
    dev_pair, tr_member, slot), from its KA and KD captures (the same in
    both trees), and the index's slot count."""
    cap: dict = {}
    da.make_step(drp, cfg, P, L, expand_cap=E, device=dev, capture=cap)(
        da.init_state(drp, dev), codes, rlen, np.ones(P, dtype=bool))
    c, r, k = cap["KA"][:3]
    nc = km.extract_kmers_plain(c, r, k, nc=True, edges=False)["nc"]
    kd = cap["KD"]
    a = da.assign_count_plain(da.init_state(drp, dev), *kd)
    return (drp.tables(dev, graph=True)["graph"], nc, kd[6], kd[3], kd[9],
            kd[7], a["tr_member"], a["slot"]), drp.nslots


def ke_bare(libs, a, counts):
    """KE's bare launch(es) on one side's libraries; returns (launch(stream),
    (clean, clean_pair)).  The launch holds every tensor it writes."""
    graph, nc, dst0, kvalid, nk, dev_pair, tr_member, slot = a
    R, NKW = nc.shape
    dev = nc.device
    clean = torch.empty(R, dtype=torch.bool, device=dev)
    pair = torch.empty(R // 2, dtype=torch.bool, device=dev)
    nslots = counts.shape[0] - 1
    ptr = build.ptr
    if fused(libs["thread_walk"]):
        fn = build.bind(libs["thread_walk"], "dtk_thread_walk_graph",
                        KEG_SIG)
        args = (R // 2, NKW, ptr(nc), ptr(dst0), ptr(kvalid), ptr(nk),
                ptr(dev_pair), ptr(tr_member), ptr(slot), nslots,
                *dt.level_args(graph), ptr(counts), ptr(clean), ptr(pair))
        return (lambda s, keep=(counts, clean, pair): build.check(
            fn(*args, s), "thread_walk_graph"), (clean, pair))
    loc = dst0.repeat_interleave(2)[:, None].expand(-1, NKW).contiguous()
    gf = torch.empty(R * NKW, dtype=torch.bool, device=dev)
    gm = torch.empty(R * NKW, dtype=torch.int64, device=dev)
    g2 = torch.empty_like(gm)
    kb = build.bind(libs["bucket_lookup"], "dtk_bucket_lookup", KB_SIG)
    kb_args = (ptr(nc), ptr(loc), R * NKW, *dt.level_args(graph), 1,
               graph.nval, ptr(gf), ptr(gm), ptr(g2))
    ke = build.bind(libs["thread_walk"], "dtk_thread_walk", KE_SIG)
    ke_args = (R // 2, NKW, ptr(nc), ptr(gf), ptr(gm), ptr(kvalid),
               ptr(nk), ptr(dev_pair), ptr(tr_member), ptr(slot), nslots,
               ptr(counts), ptr(clean), ptr(pair))

    def launch(s, keep=(counts, clean, pair, loc, gf, gm, g2)):
        build.check(kb(*kb_args, s), "bucket_lookup")
        build.check(ke(*ke_args, s), "thread_walk")
    return launch, (clean, pair)


def ke_wrapper(libs, state, a):
    """One side's KE as the step calls it: thread_walk_graph on a fused
    build, else lookup_bucket on the graph table and the parent's
    thread_walk wrapper as it stood."""
    graph, nc, dst0, kvalid, nk, dev_pair, tr_member, slot = a
    kl_da, kl_dt = da.kernel_lib, dt.kernel_lib
    da.kernel_lib = dt.kernel_lib = lambda name: libs[name]
    try:
        if fused(libs["thread_walk"]):
            return da.thread_walk_graph(state, *a)
        R, NKW = nc.shape
        loc = dst0.repeat_interleave(2)[:, None].expand(-1, NKW)
        gfound, gmask, _ = dt.lookup_bucket(graph, nc, loc)
        args = [x.contiguous() for x in (nc, gfound, gmask, kvalid)]
        rest = [x.contiguous() for x in (dev_pair, tr_member, slot)]
        clean = torch.empty(R, dtype=torch.bool, device=nc.device)
        pair = torch.empty(R // 2, dtype=torch.bool, device=nc.device)
        fn = build.bind(libs["thread_walk"], "dtk_thread_walk", KE_SIG)
        build.check(fn(R // 2, NKW, *[build.ptr(x) for x in args],
                       build.ptr(nk.to(torch.int32).contiguous()),
                       *[build.ptr(x) for x in rest],
                       state["counts"].shape[0] - 1,
                       build.ptr(state["counts"]), build.ptr(clean),
                       build.ptr(pair), build.stream_of(nc)), "thread_walk")
        return clean, pair
    finally:
        da.kernel_lib, dt.kernel_lib = kl_da, kl_dt


def kg_bare(lib, a):
    """KG's bare launch on ``lib``; returns (launch(stream), out)."""
    edge, evalid, si_, ei_, rm, counted, dst0, tre = a
    R, NE = edge.shape
    out = torch.empty((R, (NE + 7) // 8), dtype=torch.uint8,
                      device=edge.device)
    fn = build.bind(lib, "dtk_novel_edges", KG_SIG)
    args = (R // 2, NE, *[build.ptr(x) for x in a[:7]],
            *dt.level_args(tre), build.ptr(out))
    return (lambda s, keep=out: build.check(fn(*args, s), "novel_edges"),
            out)


def kg_wrapper(lib, a):
    kl = da.kernel_lib
    da.kernel_lib = lambda _name: lib
    try:
        return da.novel_edges(*a)
    finally:
        da.kernel_lib = kl


def walk_work(a) -> str:
    """What sets KE's work: device-resolved mates, the positions a walk
    that stops at its first failure reads, and clean pairs."""
    graph, nc, dst0, kvalid, nk, dev_pair, tr_member, slot = a
    R, NKW = nc.shape
    loc = dst0.repeat_interleave(2)[:, None].expand(-1, NKW)
    gfound, gmask, _ = dt.lookup_bucket_plain(graph, nc, loc)
    nin = nk.long().clamp(0, NKW)
    inr = torch.arange(NKW, device=nc.device) < nin[:, None]
    bad = ~kvalid | ~gfound
    bad[:, 1:] |= nc[:, 1:] == nc[:, :-1]
    bad[:, :-1] |= (((gmask[:, :-1] >> (nc[:, 1:] & 3)) & 1) == 0) \
        & inr[:, 1:]
    bad &= inr
    upto = torch.where(bad.any(1), bad.int().argmax(1) + 1, nin)
    devr = dev_pair.repeat_interleave(2) & (nk > 0)
    state = {"counts": torch.zeros(2, dtype=torch.int32, device=nc.device)}
    _, pair = da.thread_walk_plain(state, nc, gfound, gmask, kvalid, nk,
                                   dev_pair, tr_member,
                                   torch.zeros_like(slot))
    return (f"walked_mates={int(devr.sum())} walked_positions="
            f"{int(torch.where(devr, upto, 0).sum())} in_read_positions="
            f"{int(torch.where(devr, nin, 0).sum())} clean_pairs="
            f"{int(pair.sum())}")


def run_ke(name, libs, inputs, pairs, smi):
    a, nslots = inputs
    graph, nc = a[:2]
    R, NKW = nc.shape
    print(f"KE {name}: P={R // 2} NKW={NKW} graph levels="
          f"{len(graph.levels)} {walk_work(a)}", flush=True)
    for s, lb in libs.items():
        grid = (f"fused, a warp a mate: blocks={-(-R // 8)} x 256 threads"
                if fused(lb["thread_walk"]) else
                f"KB[graph] + KE: KE blocks={R // 2} x 64 threads")
        print(f"KE {name} {s}: {grid}", flush=True)
    sp = {"counts": torch.zeros(nslots + 1, dtype=torch.int32,
                                device=nc.device)}
    want = da.thread_walk_graph_plain(sp, *a)
    launches = {}
    for s, lb in libs.items():
        counts = torch.zeros(nslots + 1, dtype=torch.int32, device=nc.device)
        launch, outs = ke_bare(lb, a, counts)
        launch(build.stream_of(nc))
        torch.cuda.synchronize()
        if not (all(torch.equal(g, w) for g, w in zip(outs, want))
                and torch.equal(counts, sp["counts"])):
            raise RuntimeError(f"KE {name}: {s} disagrees")
        st = {"counts": torch.zeros_like(counts)}
        if not (all(torch.equal(g, w) for g, w in
                    zip(ke_wrapper(lb, st, a), want))
                and torch.equal(st["counts"], sp["counts"])):
            raise RuntimeError(f"KE {name}: {s}'s wrapper disagrees")
        launches[s] = launch
    ab_all(f"KE {name}", launches, build.stream_of(nc), pairs, smi)
    st = {"counts": torch.zeros(nslots + 1, dtype=torch.int32,
                                device=nc.device)}
    ab_pairs(f"KE {name} wrapper", lambda s: ke_wrapper(libs[s], st, a),
             pairs, smi, reps=10)


def run_kg(name, libs, a, pairs, smi):
    edge = a[0]
    R, NE = edge.shape
    want = da.novel_edges_plain(*a)
    print(f"KG {name}: P={R // 2} NE={NE} tre levels={len(a[7].levels)} "
          f"counted_pairs={int(a[5].sum())} novel_edges="
          f"{int(da.unpack_bits(want, NE).sum())} blocks={-(-R // 8)} x "
          f"256 threads (a warp a read, both sides)", flush=True)
    launches = {}
    for s, lb in libs.items():
        launch, out = kg_bare(lb["novel_edges"], a)
        launch(build.stream_of(edge))
        torch.cuda.synchronize()
        if not torch.equal(out, want) or not torch.equal(
                kg_wrapper(lb["novel_edges"], a), want):
            raise RuntimeError(f"KG {name}: {s} disagrees")
        launches[s] = launch
    ab_all(f"KG {name}", launches, build.stream_of(edge), pairs, smi)
    ab_pairs(f"KG {name} wrapper",
             lambda s: kg_wrapper(libs[s]["novel_edges"], a), pairs, smi,
             reps=10)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True)
    ap.add_argument("--nloci", type=int, default=80_000)
    ap.add_argument("--pairs", type=int, default=6)
    ap.add_argument("--seed", type=int, default=9)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("ab_walk_edges needs a CUDA card")
    dev = torch.device("cuda")
    smi = card_name()
    print(f"card: {smi}", flush=True)
    libs: dict = {"parent": {}, "change": {}}
    for side, root in (("parent", os.path.join(
            args.parent, "danbing_tk_tpu_torch", "csrc")),
            ("change", build.CSRC)):
        for name in SOURCES:
            libs[side][name], regs = build.build_ab(
                os.path.join(root, f"{name}.cu"), f"{side}_{name}")
            print(f"{side} {name} ptxas: {regs}", flush=True)

    def up(x):
        return torch.from_numpy(x).to(dev)

    # ---- KE ----
    drp, seqs = build_scale_rpgg(args.nloci, 1500, seed=args.seed,
                                 verbose=False)
    drp.graph_tab, _ = build_scale_graph(seqs, verbose=False)
    tcfg = AlignConfig(ksize=K, cth=20, n_filter=4, nm_filter=1, okam=False,
                       threading=True, thread_cth=85, maxncorrection=3)
    tc, tr = sample_read_batch(seqs, P, L, np.random.default_rng(
        [args.seed, 2]), frac_tr=1.0, read_len=RL, sub_rate=SUB)
    run_ke("a scale -gc 85 3", libs,
           ke_inputs(drp, tcfg, up(tc), up(tr), dev), args.pairs, smi)
    rp = RPGG(os.path.join(GOLDEN, "pan"))
    gd = da.DeviceRPGG.build(rp, with_tre=True)
    gd.add_graph(rp)
    gcfg = AlignConfig(ksize=K, cth=20, n_filter=4, nm_filter=1, simmode=2,
                       threading=True, thread_cth=50, maxncorrection=3,
                       aln=True)

    def golden(name):
        seqs_g = [ln.strip() for ln in open(os.path.join(GOLDEN, name))
                  if not ln.startswith(">")]
        c, r = km.pack_reads(seqs_g[: 2 * P], L)
        return up(c), up(r)

    run_ke("b golden -gc 50 3", libs, ke_inputs(gd, gcfg,
                                                *golden("reads.sim.fa"),
                                                dev), args.pairs, smi)
    drp.release(dev, "graph")
    drp.graph_tab = None
    torch.cuda.empty_cache()

    # ---- KG ----
    drp.tre_tab, _ = build_scale_tre(seqs, verbose=False)
    drp.bait_tab, _ = build_scale_bait(seqs, seed=args.seed)
    drp.qc = build_scale_qc(args.nloci, seed=args.seed)
    ocfg = AlignConfig(ksize=K, cth=20, n_filter=4, nm_filter=1, okam=True,
                       simmode=2, bait=True, qc=True, output_bubbles=True)
    oc, orl = sample_read_batch(seqs, P, L, np.random.default_rng(
        [args.seed, 4]), frac_tr=1.0, read_len=RL, sub_rate=SUB)
    for name, d, cfg, (c, r) in (
            ("a scale okam -s 2 -b -qc -bu", drp, ocfg, (up(oc), up(orl))),
            ("b golden -bu", gd, AlignConfig(
                ksize=K, cth=20, n_filter=4, nm_filter=1, okam=True,
                output_bubbles=True), golden("reads.fa"))):
        cap: dict = {}
        da.make_step(d, cfg, P, L, expand_cap=E, with_annot=True,
                     with_bubbles=True, device=dev, capture=cap)(
            da.init_state(d, dev), c, r, np.ones(P, dtype=bool))
        run_kg(name, libs, cap["KG"], args.pairs, smi)


if __name__ == "__main__":
    main()
