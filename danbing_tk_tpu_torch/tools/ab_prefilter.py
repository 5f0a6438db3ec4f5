"""Same-call A/B of the device-sampled prefilter dispatch: KK's fused
launch (the sample, the member probe and the decision) against another
checkout's KK + KB + decision.

    python -m danbing_tk_tpu_torch.tools.ab_prefilter --parent DIR
        [--nloci N] [--pairs N] [--seed S]

Builds ``DIR/danbing_tk_tpu_torch/csrc/{prefilter_sample,bucket_lookup}.cu``
(another checkout with the same entry points, e.g. the parent commit
unpacked with ``git archive``; only its ``csrc/`` is read) and this tree's
``prefilter_sample.cu``, with ``-Xptxas -v``, and makes the inputs of
``chip_smoke.py`` phase 3's prefilter dispatch: the synthetic scale index
(``tools/scale_index.py``, 1,500 k-mers per locus, the smoke's 80,000 loci
by default) and 16,384 pairs (32,768 reads) of 150 codes in L = 160 rows,
5% from the TR pool, k = 21, nf = 4, nmf = 1.  Two cases: (a) the member
table (W = 2), (b) the dbi table (W = 4, the probe of a DeviceRPGG
without a member table).

Each case first runs both sides, whose survivors must be equal to each
other and to prefilter_fused_plain's, and prints what the fused launch
reads on these inputs (engine/device_align.py prefilter_fused_work: the
queries it probes, the distinct rows per level, the bytes and the bound
over 3.35 TB/s).  Then, in
``--pairs`` alternating pairs (parent first in even pairs):

* KK bare: the parent's sample-only launch against the fused launch, each
  the same ctypes call with its arguments built once, the median over 10
  CUDA-event windows of 20 back-to-back launches divided by 20;
* KK graph: the same 20 launches captured in a CUDA graph and replayed
  (10 windows of 5 replays, divided by 100), without the host's call;
* dispatch window: the whole device-sampled dispatch on device tensors
  as a step makes it (10 windows of 10 calls): the parent's KK and KB
  wrappers as they stood (their allocations, bind and level arguments on
  every call) and prefilter_decide, against this tree's
  make_prefilter_step (one allocation and one ctypes call);
* dispatch graph: each side's dispatch captured 20 times in a CUDA graph
  and replayed, as above.

Prints the card, every build's registers and spills, every pair, the
medians and quartiles, and the change's wins.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import os
from types import SimpleNamespace

import numpy as np
import torch

from ..engine import device_align as da
from ..engine.host_align import AlignConfig
from ..index import device_table as dt
from ..kernels import build
from ..ops import kmers as km
from .ab_assign_count import ab_pairs, card_name
from .ab_kmers_filter import GRAPH, graph_of, timers
from .kernel_bounds import bound_ms
from .scale_index import build_scale_rpgg, sample_read_batch

KK_SIG = "ppiiiipppp"
KB_SIG = "ppipppiiipppp"


def parent_dispatch(kk_lib, kb_lib, tab: dt.DevTable, k, nf, nmf):
    """The parent's device-sampled dispatch as its step ran it: KK's
    wrapper (contiguous inputs, three allocations, bind, the call), KB's
    (the queries flattened, three allocations, bind, the table's level
    arguments, the call), then prefilter_decide over the found samples'
    count (read_hits) and nk."""
    def dispatch(codes, rlen, live):
        c = codes.contiguous()
        r = rlen.to(torch.int32).contiguous()
        B, L = c.shape
        dev = c.device
        q = torch.empty((B, nf), dtype=torch.int64, device=dev)
        valid = torch.empty((B, nf), dtype=torch.bool, device=dev)
        nk = torch.empty(B, dtype=torch.int32, device=dev)
        fn = build.bind(kk_lib, "dtk_prefilter_sample", KK_SIG)
        build.check(fn(build.ptr(c), build.ptr(r), B, L, k, nf,
                       build.ptr(q), build.ptr(valid), build.ptr(nk),
                       build.stream_of(c)), "parent prefilter_sample")
        qf = q.reshape(-1).contiguous()
        n = qf.numel()
        found = torch.empty(n, dtype=torch.bool, device=dev)
        val = torch.empty(n, dtype=torch.int64, device=dev)
        val2 = torch.empty_like(val)
        kb = build.bind(kb_lib, "dtk_bucket_lookup", KB_SIG)
        build.check(kb(build.ptr(qf), None, n, *dt.level_args(tab), 0,
                       tab.nval, build.ptr(found), build.ptr(val),
                       build.ptr(val2), build.stream_of(qf)),
                    "parent bucket_lookup")
        return da.prefilter_decide(da.read_hits(found.view(q.shape), valid),
                                   nk, live, nmf, B // 2)

    return dispatch


def bare_launches(kk_lib, fused_lib, tab, codes, rlen, live, k, nf, nmf):
    """{side: launch(stream)} with arguments built once: the parent's
    sample-only KK and this tree's fused KK; and the outputs."""
    B, L = codes.shape
    dev = codes.device
    q = torch.empty((B, nf), dtype=torch.int64, device=dev)
    valid = torch.empty((B, nf), dtype=torch.bool, device=dev)
    nk = torch.empty(B, dtype=torch.int32, device=dev)
    surv = torch.empty(B // 2, dtype=torch.bool, device=dev)
    kk = build.bind(kk_lib, "dtk_prefilter_sample", KK_SIG)
    fu = build.bind(fused_lib, "dtk_prefilter_fused", da.KKF_SIG)
    a = (codes.data_ptr(), rlen.data_ptr(), B, L, k, nf, q.data_ptr(),
         valid.data_ptr(), nk.data_ptr())
    lv = dt.level_args(tab)
    f = (codes.data_ptr(), rlen.data_ptr(), live.data_ptr(), B // 2, L, k,
         nf, nmf, *lv, tab.W, surv.data_ptr())
    return ({"parent": lambda s: build.check(kk(*a, s), "parent KK"),
             "change": lambda s: build.check(fu(*f, s), "fused KK")},
            (q, valid, nk), surv)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True)
    ap.add_argument("--nloci", type=int, default=80_000)
    ap.add_argument("--pairs", type=int, default=6)
    ap.add_argument("--seed", type=int, default=9)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("ab_prefilter needs a CUDA card")
    dev = torch.device("cuda")
    smi = card_name()
    print(f"card: {smi}", flush=True)
    proot = os.path.join(args.parent, "danbing_tk_tpu_torch", "csrc")
    libs = {}
    for side, root, name in (("parent", proot, "prefilter_sample"),
                             ("parent", proot, "bucket_lookup"),
                             ("change", build.CSRC, "prefilter_sample")):
        libs[side, name], regs = build.build_ab(
            os.path.join(root, f"{name}.cu"), f"{side}_{name}")
        print(f"{side} {name} ptxas: {regs}", flush=True)

    P, L, k, nf, nmf, RL = 4096, 160, 21, 4, 1, 150
    Pp = 4 * P
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
    tabs = drp.tables(dev)
    for case, tname in (("a member", "member"), ("b dbi", "dbi")):
        tab = tabs[tname]
        want = da.prefilter_fused_plain(codes, rlen, live, tab, k, nf, nmf)
        work = da.prefilter_fused_work(codes, rlen, live, tab, k, nf, nmf)
        if not torch.equal(work["survive"], want):
            raise RuntimeError(f"{case}: prefilter_fused_work's decision "
                               f"differs from the plain version's")
        bound = bound_ms(work["nbytes"])
        print(f"{case}: P={Pp} L={L} k={k} nf={nf} nmf={nmf} W={tab.W} "
              f"levels={len(tab.levels)} survivors={int(want.sum())} "
              f"pairs_probing={work['pairs_probing']} probed_queries="
              f"{int(work['probed'].sum())} of {2 * Pp * nf} distinct_rows="
              f"{work['rows']} bytes={work['nbytes']} bound_ms={bound:.4f} "
              f"grid: blocks={-(-Pp // (da.KKF_WARPS * da.KKF_PPW))} "
              f"threads={32 * da.KKF_WARPS}", flush=True)
        launches, sampled, surv = bare_launches(
            libs["parent", "prefilter_sample"],
            libs["change", "prefilter_sample"], tab, codes, rlen, live, k,
            nf, nmf)
        stream = build.stream_of(codes)
        for f in launches.values():
            f(stream)
        torch.cuda.synchronize()
        if not torch.equal(surv, want):
            raise RuntimeError(f"{case}: the fused launch differs from "
                               f"prefilter_fused_plain")
        for a, b in zip(sampled, km.prefilter_sample_plain(codes, rlen, k,
                                                           nf)):
            if not torch.equal(a, b):
                raise RuntimeError(f"{case}: the parent's KK differs from "
                                   f"prefilter_sample_plain")
        bare, replay = timers(launches, stream)
        ab_pairs(f"{case} KK bare", lambda s: bare[s](), args.pairs, smi)
        ab_pairs(f"{case} KK graph", lambda s: replay[s](), args.pairs, smi,
                 reps=5, per=GRAPH)
        # make_prefilter_step reads the model's tables alone: the dbi case
        # is a model whose tables hold no member table
        drp_t = drp if tname == "member" else SimpleNamespace(
            tables=lambda _dev, t=tab: {"dbi": t})
        disp = {"parent": parent_dispatch(
                    libs["parent", "prefilter_sample"],
                    libs["parent", "bucket_lookup"], tab, k, nf, nmf),
                "change": da.make_prefilter_step(drp_t, cfg, Pp, L, dev)}
        for side, fn in disp.items():
            got = fn(codes, rlen, live)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise RuntimeError(f"{case}: the {side} dispatch's "
                                   f"survivors differ")
        n0 = build.launch_counts()
        disp["change"](codes, rlen, live)
        n1 = build.launch_counts()
        moved = {key: n1[key] - n0[key] for key in n1 if n1[key] != n0[key]}
        if moved != {"KK": 1}:
            raise RuntimeError(f"{case}: a dispatch launched {moved}, not "
                               f"one fused KK")
        ab_pairs(f"{case} dispatch window",
                 lambda s: disp[s](codes, rlen, live), args.pairs, smi,
                 reps=10)
        graphs = {s: graph_of(fn, (codes, rlen, live))
                  for s, fn in disp.items()}
        ab_pairs(f"{case} dispatch graph", lambda s: graphs[s].replay(),
                 args.pairs, smi, reps=5, per=GRAPH)
        del graphs, disp, launches, bare, replay
        torch.cuda.synchronize()


if __name__ == "__main__":
    main()
