"""Same-call A/B of the sharded prefilter under a collective probe
(``make_sharded_prefilter(shard_index=True)``) against another checkout's.

    python -m danbing_tk_tpu_torch.tools.ab_sharded_prefilter --parent DIR
        [--nloci N] [--pairs N] [--seed S]

Builds ``DIR/danbing_tk_tpu_torch/csrc/{prefilter_sample,sharded_lookup,
pair_filter}.cu`` (another checkout whose KK[sample], KI and KL[decide]
entry points are the parent commit's: KI's three value planes per query
and the found/valid decision; only its ``csrc/`` is read) and this tree's
``prefilter_sample.cu``, ``sharded_lookup.cu`` and ``pair_filter.cu``,
with ``-Xptxas -v``, and makes the inputs of ``chip_smoke.py`` phase 3's
prefilter dispatch: the synthetic scale index (``tools/scale_index.py``,
1,500 k-mers per locus, the smoke's 80,000 loci by default) and 16,384
pairs (32,768 reads) of 150 codes in L = 160 rows, 5% from the TR pool,
k = 21, nf = 4, nmf = 1, on a world-1 NCCL group.

Every side's outputs are held first: KK[sample]'s queries, valid and nk
equal prefilter_sample_plain's; both dispatches' survivors equal
prefilter_fused_plain's on the member table; KI[count]'s counts equal the
parent's found plane summed a read; the change's dispatch launches one
KK[sample], one KI[count] and one KL[decide].  Then, in ``--pairs``
alternating pairs (parent first in even pairs):

* KK[sample] bare and graph: the parent's sample-only launch against this
  tree's, each the same ctypes call with its arguments built once (the
  median over 10 CUDA-event windows of 20 launches, and 20 launches
  captured in a CUDA graph, 10 windows of 5 replays); KK's fused launch
  (the same staged front end, with the member probe) graphed too;
* probe graph: the parent's KI on the 4 nf queries of each read (three
  int32 planes) against KI[count] (one int32 a read), at D = 1;
* KL[decide] graph: the parent's decision over (2P, nf) found and valid
  planes against this tree's over the summed counts and nk;
* dispatch window: the whole collective dispatch on device tensors (10
  windows of 10 calls): the parent's as its wrappers and glue stood
  (KK[sample]'s wrapper; the all_gather, KI's wrapper, the planes'
  stack, transpose and copy, the reduce_scatter of three planes, the
  ``> 0`` and two ``& 0xFFFFFFFF``; ``nk > 0`` and KL[decide]'s wrapper;
  the survivors' all_gather) against make_sharded_prefilter's step.

Prints the card, every build's registers and spills, every pair, the
medians and quartiles, the change's wins and each side's reduce_scatter
bytes.  ``--sample-only`` builds and times KK[sample] alone (DIR may then
hold any build of prefilter_sample.cu with its entry point, e.g. a copy
with one constant changed).  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch
import torch.distributed as dist

from ..engine import device_align as da
from ..engine.host_align import AlignConfig
from ..index import device_table as dt
from ..kernels import build
from ..ops import kmers as km
from ..parallel import mesh as pm
from ..parallel import sharded_index as si
from .ab_assign_count import ab_pairs, card_name
from .ab_kmers_filter import GRAPH, timers
from .kernel_bounds import bound_ms, kk_sample_bytes
from .scale_index import build_scale_rpgg, sample_read_batch

KK_SIG = "ppiiiipppp"                   # dtk_prefilter_sample
KI_SIG = "ppi" + "ppppp" + "iii" + "pppp"   # the parent's dtk_sharded_lookup
KLD_SIG = "ppppiiipp"                   # the parent's dtk_prefilter_decide
KIC_SIG = "pii" + "ppppp" + "iipp"      # dtk_sharded_lookup_count
NKLD_SIG = "ppipiipp"                   # dtk_prefilter_decide
SOURCES = ("prefilter_sample", "sharded_lookup", "pair_filter")
M32 = 0xFFFFFFFF


def parent_dispatch(libs, blk, meta, mesh, P, k, nf, nmf):
    """The parent's collective prefilter dispatch as its wrappers and glue
    ran it (make_sharded_prefilter with shard_index: KK[sample], then
    lookup_bucket_sharded's found plane, then KL[decide] over found and
    valid, then the survivors' all_gather)."""
    kk_lib, ki_lib, kld_lib = (libs["parent", n] for n in SOURCES)

    def dispatch(codes, rlen, live):
        c = pm.local_rows(codes, mesh, P).contiguous()
        r = pm.local_rows(rlen, mesh, P).to(torch.int32).contiguous()
        lv = pm.local_rows(live, mesh, P, per_read=False)
        B, L = c.shape
        dev = c.device
        q = torch.empty((B, nf), dtype=torch.int64, device=dev)
        valid = torch.empty((B, nf), dtype=torch.bool, device=dev)
        nk = torch.empty(B, dtype=torch.int32, device=dev)
        fn = build.bind(kk_lib, "dtk_prefilter_sample", KK_SIG)
        build.check(fn(build.ptr(c), build.ptr(r), B, L, k, nf,
                       build.ptr(q), build.ptr(valid), build.ptr(nk),
                       build.stream_of(c)), "parent prefilter_sample")
        # lookup_bucket_sharded
        world = dist.get_world_size(mesh.group)
        qf = q.reshape(-1).to(torch.int64).contiguous()
        n = qf.numel()
        gq = torch.empty(world * n, dtype=torch.int64, device=dev)
        dist.all_gather_into_tensor(gq, qf, group=mesh.group)
        dt._check_block(blk, meta)
        out3 = torch.empty(3 * world * n, dtype=torch.int32, device=dev)
        o = out3.data_ptr()
        ki = build.bind(ki_lib, "dtk_sharded_lookup", KI_SIG)
        build.check(ki(gq.data_ptr(), None, world * n,
                       *dt.owned_args(blk, meta), 0, blk.nval, o,
                       o + 4 * world * n, o + 8 * world * n,
                       build.stream_of(gq)), "parent sharded_lookup")
        f, v, v2 = out3.view(3, world * n).unbind(0)
        planes = torch.stack([f, v, v2]).view(3, world, n).transpose(0, 1)
        out = torch.empty(3 * n, dtype=torch.int32, device=dev)
        dist.reduce_scatter_tensor(out, planes.contiguous().view(-1),
                                   op=dist.ReduceOp.SUM, group=mesh.group)
        out = out.view(3, n)
        found = (out[0] > 0).view(q.shape)
        (out[1].long() & M32).view(q.shape)
        (out[2].long() & M32).view(q.shape)
        # prefilter_decision(found, valid, nk > 0, live, nmf, P)
        args = [t.contiguous() for t in (found, valid, nk > 0, lv)]
        surv = torch.empty(P, dtype=torch.bool, device=dev)
        kld = build.bind(kld_lib, "dtk_prefilter_decide", KLD_SIG)
        build.check(kld(*[build.ptr(t) for t in args], P, nf, nmf,
                        build.ptr(surv), build.stream_of(found)),
                    "parent prefilter_decide")
        return pm.gather_planes({"s": surv}, mesh)["s"]

    return dispatch


def bare_launches(libs, name, sig, args_of) -> dict:
    """{side: launch(stream)}: the entry point ``name`` of each side's
    library with its arguments (args_of(side)) built once."""
    out = {}
    for side in ("parent", "change"):
        fn = build.bind(libs[side, name[side][0]], name[side][1], sig[side])
        a = args_of(side)
        out[side] = (lambda s, fn=fn, a=a, side=side: build.check(
            fn(*a, s), f"{side} {name[side][1]}"))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True)
    ap.add_argument("--nloci", type=int, default=80_000)
    ap.add_argument("--pairs", type=int, default=6)
    ap.add_argument("--seed", type=int, default=9)
    ap.add_argument("--sample-only", action="store_true",
                    help="build and time KK[sample] alone (DIR's "
                         "prefilter_sample.cu may be any build with its "
                         "entry point)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("ab_sharded_prefilter needs a CUDA card")
    dev = torch.device("cuda")
    smi = card_name()
    print(f"card: {smi}", flush=True)
    libs = {}
    for side, root in (("parent", os.path.join(
            args.parent, "danbing_tk_tpu_torch", "csrc")),
            ("change", build.CSRC)):
        for name in SOURCES[:1] if args.sample_only else SOURCES:
            libs[side, name], regs = build.build_ab(
                os.path.join(root, f"{name}.cu"), f"{side}_{name}")
            print(f"{side} {name} ptxas: {regs}", flush=True)

    P, L, k, nf, nmf, RL = 4096, 160, 21, 4, 1, 150
    Pp = 4 * P
    B = 2 * Pp
    drp, seqs = build_scale_rpgg(args.nloci, 1500, seed=args.seed,
                                 verbose=False)
    # phase 3's draws: its step batch first, then the dispatch's reads
    rng = np.random.default_rng([args.seed, 1])
    sample_read_batch(seqs, P, L, rng, frac_tr=1.0, read_len=RL)
    pb, pr = sample_read_batch(seqs, Pp, L, rng, frac_tr=0.05, read_len=RL)
    codes = torch.from_numpy(pb).to(dev)
    rlen = torch.from_numpy(pr).to(dev)
    live = torch.ones(Pp, dtype=torch.bool, device=dev)
    cfg = AlignConfig(ksize=k, cth=20, n_filter=nf, nm_filter=nmf,
                      okam=False)
    mtab = drp.tables(dev)["member"]
    mesh = pm.make_mesh(device=dev)
    blk, meta = si.row_blocks(mtab, 1)[0]
    want = da.prefilter_fused_plain(codes, rlen, live, mtab, k, nf, nmf)
    sq, sv, snk = km.prefilter_sample_plain(codes, rlen, k, nf)
    print(f"P={Pp} reads={B} L={L} k={k} nf={nf} nmf={nmf} member W="
          f"{mtab.W} levels={len(mtab.levels)} survivors={int(want.sum())} "
          f"world={mesh.world} backend={dist.get_backend()}", flush=True)

    # ---- KK[sample] ----
    outs = {s: (torch.empty((B, nf), dtype=torch.int64, device=dev),
                torch.empty((B, nf), dtype=torch.bool, device=dev),
                torch.empty(B, dtype=torch.int32, device=dev))
            for s in ("parent", "change")}
    kk = bare_launches(
        libs, {s: ("prefilter_sample", "dtk_prefilter_sample")
               for s in outs}, {s: KK_SIG for s in outs},
        lambda s: (codes.data_ptr(), rlen.data_ptr(), B, L, k, nf,
                   *(t.data_ptr() for t in outs[s])))
    stream = build.stream_of(codes)
    for side, f in kk.items():
        f(stream)
        torch.cuda.synchronize()
        for a, b in zip(outs[side], (sq, sv, snk)):
            if not torch.equal(a, b):
                raise RuntimeError(f"the {side} KK[sample] differs from "
                                   f"prefilter_sample_plain")
    bare, replay = timers(kk, stream)
    ab_pairs("KK[sample] bare", lambda s: bare[s](), args.pairs, smi)
    ab_pairs("KK[sample] graph", lambda s: replay[s](), args.pairs, smi,
             reps=5, per=GRAPH)
    kk_bytes = kk_sample_bytes(B, L, nf)
    print(f"KK[sample] bound_ms={bound_ms(kk_bytes):.4f} (bytes={kk_bytes})",
          flush=True)
    if args.sample_only:
        return
    # KK's fused launch shares the staged front end: both sides' on the
    # member table
    fsurv = {s: torch.empty(Pp, dtype=torch.bool, device=dev)
             for s in ("parent", "change")}
    lvl = dt.level_args(mtab)
    fused = bare_launches(
        libs, {s: ("prefilter_sample", "dtk_prefilter_fused")
               for s in fsurv}, {s: da.KKF_SIG for s in fsurv},
        lambda s: (codes.data_ptr(), rlen.data_ptr(), live.data_ptr(), Pp,
                   L, k, nf, nmf, *lvl, mtab.W, fsurv[s].data_ptr()))
    for side, f in fused.items():
        f(stream)
        torch.cuda.synchronize()
        if not torch.equal(fsurv[side], want):
            raise RuntimeError(f"the {side} fused KK differs from "
                               f"prefilter_fused_plain")
    _, replay = timers(fused, stream)
    ab_pairs("KK (fused) graph", lambda s: replay[s](), args.pairs, smi,
             reps=5, per=GRAPH)

    # ---- the probe: KI's three planes against KI[count] ----
    n = B * nf
    p3 = torch.empty(3 * n, dtype=torch.int32, device=dev)
    hits = torch.empty(B, dtype=torch.int32, device=dev)
    oa = dt.owned_args(blk, meta)
    probe = bare_launches(
        libs, {"parent": ("sharded_lookup", "dtk_sharded_lookup"),
               "change": ("sharded_lookup", "dtk_sharded_lookup_count")},
        {"parent": KI_SIG, "change": KIC_SIG},
        lambda s: ((sq.data_ptr(), None, n, *oa, 0, blk.nval,
                    p3.data_ptr(), p3.data_ptr() + 4 * n,
                    p3.data_ptr() + 8 * n) if s == "parent" else
                   (sq.data_ptr(), B, nf, *oa, blk.nval, hits.data_ptr())))
    for f in probe.values():
        f(stream)
    torch.cuda.synchronize()
    if not torch.equal(hits, (p3[:n].view(B, nf) != 0).logical_and(
            sq != -1).sum(1, dtype=torch.int32)):
        raise RuntimeError("KI[count] differs from the parent's found "
                           "plane summed a read")
    _, replay = timers(probe, stream)
    ab_pairs("probe graph (KI 3 planes -> KI[count])",
             lambda s: replay[s](), args.pairs, smi, reps=5, per=GRAPH)

    # ---- KL[decide] ----
    found = p3[:n].view(B, nf) != 0
    nonshort = snk > 0
    surv = {s: torch.empty(Pp, dtype=torch.bool, device=dev)
            for s in ("parent", "change")}
    kld = bare_launches(
        libs, {s: ("pair_filter", "dtk_prefilter_decide") for s in surv},
        {"parent": KLD_SIG, "change": NKLD_SIG},
        lambda s: ((found.data_ptr(), sv.data_ptr(), nonshort.data_ptr(),
                    live.data_ptr(), Pp, nf, nmf, surv[s].data_ptr())
                   if s == "parent" else
                   (hits.data_ptr(), snk.data_ptr(), 4, live.data_ptr(), Pp,
                    nmf, surv[s].data_ptr())))
    for side, f in kld.items():
        f(stream)
        torch.cuda.synchronize()
        if not torch.equal(surv[side], want):
            raise RuntimeError(f"the {side} KL[decide] differs from "
                               f"prefilter_fused_plain")
    _, replay = timers(kld, stream)
    ab_pairs("KL[decide] graph", lambda s: replay[s](), args.pairs, smi,
             reps=5, per=GRAPH)

    # ---- the collective dispatch ----
    disp = {"parent": parent_dispatch(libs, blk, meta, mesh, Pp, k, nf,
                                      nmf),
            "change": si.make_sharded_prefilter(drp, cfg, mesh, Pp, L)[0]}
    for side, fn in disp.items():
        got = fn(codes, rlen, live)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise RuntimeError(f"the {side} dispatch's survivors differ")
    n0 = build.launch_counts()
    disp["change"](codes, rlen, live)
    n1 = build.launch_counts()
    moved = {key: n1[key] - n0[key] for key in n1 if n1[key] != n0[key]}
    if moved != {"KK[sample]": 1, "KI[count]": 1, "KL[decide]": 1}:
        raise RuntimeError(f"a dispatch launched {moved}")
    print(f"reduce_scatter bytes: parent={3 * 4 * n} change={4 * B}",
          flush=True)
    ab_pairs("dispatch window", lambda s: disp[s](codes, rlen, live),
             args.pairs, smi, reps=10)
    del disp, kk, fused, probe, kld, bare, replay
    torch.cuda.synchronize()
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
