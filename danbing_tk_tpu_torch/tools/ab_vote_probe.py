"""Same-call A/B of KC (the pair vote), KB (the bucket probe) and KI (the
sharded owned-row probe) against another checkout's.

    python -m danbing_tk_tpu_torch.tools.ab_vote_probe --parent DIR
        [--nloci N] [--pairs N] [--seed S] [--no-graph] [--no-vote]

Builds ``DIR/danbing_tk_tpu_torch/csrc/{pair_vote,bucket_lookup,
sharded_lookup}.cu``
(another checkout, e.g. the parent commit unpacked with ``git archive``;
its KC takes the layout of one 256-thread block per pair, in shared
memory up to a block's limit, else in a global workspace) beside this
tree's, with ``-Xptxas -v``.  On the synthetic scale index
(``tools/scale_index.py``, 1,500 k-mers per locus) it captures one
counting step's inputs at P = 4096, L = 160, k = 21, E = 512 and times:

* KC at E = 512 on the step's 4,096 pairs;
* KC at E = 4096 on 2,048 pairs that overflow E = 512 (drawn from TR
  batches as ``chip_smoke.py`` phase 5s-c draws them);
* KB on the step's dbi and trfl probes, the prefilter's member probe
  (4P pairs, 5% from the TR pool) and, unless ``--no-graph``, the
  threading step's graph probe;
* KI on the same dbi, trfl and member queries, on each of the D = 4 row
  blocks of the table and on the one block of D = 1 (every row owned:
  the sharded funnel at world 1).

``--no-vote`` leaves KC out.

Each input set is first run through both builds, which must give the same
bytes.  Both sides are the same bare ctypes call (no wrapper; KB's and KI's
arguments are built once per input set, so a window of their short
launches times the card, not the host), each time is
the median over 10 CUDA-event windows of 20 back-to-back launches divided
by 20 (5 windows of 3 for the parent's E = 4096), in ``--pairs``
alternating pairs (parent first in even pairs).  Prints the card, both
builds' registers and shared memory, what sets KC's work (live entries
and live events per pair), every pair, both medians and quartiles, and
the change's wins.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ..engine import device_align as da
from ..engine.host_align import AlignConfig
from ..index import device_table as dt
from ..io.native_reader import sample_queries
from ..kernels import build
from ..parallel.sharded_index import row_blocks
from .ab_assign_count import ab_pairs, card_name
from .scale_index import build_scale_graph, build_scale_rpgg, \
    sample_read_batch


def _parent_kc_bytes(W: int, E: int) -> int:
    """The parent layout's shared bytes (its kc_smem_bytes, 256 threads)."""
    WP = 1 << max(W - 1, 1).bit_length()
    EV = W + E
    EVP = 1 << max(EV - 1, 1).bit_length()
    return (WP * 16 + (W + 1) * 20 + EV * 24 + EVP * 20 + (EV + 1) * 4
            + EV + (256 + 64) * 8 + 21 * 16)


def vote_work(kmer, use, val, vv, E: int) -> dict:
    """What sets KC's work per pair: live entries (used k-mers) and live
    events (the distinct runs with an even value plus min(total, E)
    expansion slots), as mean / p99 / max."""
    R, NKW = kmer.shape
    P = R // 2
    key = torch.where(use, kmer, da._I64MAX).reshape(P, 2 * NKW)
    s_key, order = torch.sort(key, dim=1, stable=True)
    s_val = val.reshape(P, 2 * NKW).gather(1, order)
    live = s_key != da._I64MAX
    first = torch.ones((P, 1), dtype=torch.bool, device=kmer.device)
    newrun = live & torch.cat([first, s_key[:, 1:] != s_key[:, :-1]], 1)
    odd = (s_val & 1) == 1
    vv64 = vv.long() & 0xFFFFFFFF
    nm = torch.where(newrun & odd,
                     vv64[(s_val >> 1).clamp(0, vv.numel() - 1)], 0)
    events = (newrun & ~odd).sum(1) + nm.sum(1).clamp(max=E)

    def stats(x):
        x = x.double().cpu().numpy()
        return dict(mean=float(x.mean()), p99=float(np.percentile(x, 99)),
                    max=float(x.max()))

    return dict(entries=stats(live.sum(1)), events=stats(events))


def overflow_pairs(drp, seqs, cfg, P, L, RL, Pt, rng, dev):
    """Pt pairs of TR batches whose vote overflows E = 512 (KC's inputs)."""
    kcap: dict = {}
    step = da.make_step(drp, cfg, P, L, expand_cap=512, device=dev,
                        capture=kcap)
    parts, n_have = [], 0
    live = np.ones(P, dtype=bool)
    while n_have < Pt:
        c_, r_ = sample_read_batch(seqs, P, L, rng, frac_tr=1.0,
                                   read_len=RL)
        _, out = step(da.init_state(drp, dev), c_, r_, live)
        ovf = torch.nonzero((out["referee_pack"] & 4) != 0).reshape(-1)
        kmer, val, use, pkf = kcap["KC"][:4]
        rows = torch.stack([2 * ovf, 2 * ovf + 1], 1).reshape(-1)
        parts.append((kmer[rows], val[rows], use[rows], pkf[ovf]))
        n_have += int(ovf.numel())
    return [torch.cat([p_[i] for p_ in parts])[: (2 if i < 3 else 1) * Pt]
            .contiguous() for i in range(4)] + [kcap["KC"][4]]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True)
    ap.add_argument("--nloci", type=int, default=80_000)
    ap.add_argument("--pairs", type=int, default=6)
    ap.add_argument("--seed", type=int, default=9)
    ap.add_argument("--no-graph", action="store_true")
    ap.add_argument("--no-vote", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("ab_vote_probe needs a CUDA card")
    dev = torch.device("cuda")
    smi = card_name()
    print(f"card: {smi}", flush=True)
    libs, regs = {}, {}
    for side, root in (("parent", os.path.join(
            args.parent, "danbing_tk_tpu_torch", "csrc")),
            ("change", build.CSRC)):
        for name in ("pair_vote", "bucket_lookup", "sharded_lookup"):
            libs[side, name], regs[side, name] = build.build_ab(
                os.path.join(root, f"{name}.cu"), f"{side}_{name}")
            print(f"{side} {name} ptxas: {regs[side, name]}", flush=True)

    P, L, E, k, RL = 4096, 160, 512, 21, 150
    NKW = L - k + 1
    cfg = AlignConfig(ksize=k, cth=20, n_filter=4, nm_filter=1, okam=False)
    drp, seqs = build_scale_rpgg(args.nloci, 1500, seed=args.seed,
                                 verbose=False)
    tabs = drp.tables(dev)
    rng = np.random.default_rng([args.seed, 1])
    codes, rlen = sample_read_batch(seqs, P, L, rng, frac_tr=1.0,
                                    read_len=RL)
    cap: dict = {}
    step = da.make_step(drp, cfg, P, L, expand_cap=E, device=dev,
                        capture=cap)
    step(da.init_state(drp, dev), codes, rlen, np.ones(P, dtype=bool))
    pb, pr = sample_read_batch(seqs, 4 * P, L, rng, frac_tr=0.05,
                               read_len=RL)
    qlo, qhi, _, _ = sample_queries(pb, pr, k, 4)
    probes = {"dbi": cap["KB_dbi"] + (None,), "trfl": cap["KB_trfl"],
              "member": (tabs["member"], torch.from_numpy(
                  da.query_int64(qlo, qhi)).to(dev), None)}
    vote_sets = {}
    if not args.no_vote:
        vote_sets[512] = list(cap["KC"][:5])
        vote_sets[4096] = overflow_pairs(
            drp, seqs, cfg, P, L, RL, 2048,
            np.random.default_rng([args.seed, 6]), dev)
    if not args.no_graph:
        drp.graph_tab, _ = build_scale_graph(seqs, verbose=False)
        tcfg = AlignConfig(ksize=k, cth=20, n_filter=4, nm_filter=1,
                           okam=False, threading=True, thread_cth=85,
                           maxncorrection=3)
        tc, tr = sample_read_batch(seqs, P, L, np.random.default_rng(
            [args.seed, 2]), frac_tr=1.0, read_len=RL, sub_rate=0.005)
        tcap: dict = {}
        da.make_step(drp, tcfg, P, L, expand_cap=E, device=dev,
                     capture=tcap)(da.init_state(drp, dev), tc, tr,
                                   np.ones(P, dtype=bool))
        # KE probes the graph table itself; KB's graph case takes its
        # (nc, dst0) queries
        gtab, nc, tdst0 = tcap["KE"][:3]
        probes["graph"] = (gtab, nc, tdst0.repeat_interleave(2)[:, None]
                           .expand(-1, nc.shape[1]))
    torch.cuda.synchronize()

    def vote_call(side, E_, inp, outs):
        kmer, val, use, pkf, vv = inp
        Pn = pkf.shape[0]
        W = 2 * NKW
        head = [build.ptr(t) for t in (kmer, val, use, pkf)] + [
            Pn, NKW, build.ptr(vv), vv.numel(), E_, 20]
        tail = [build.ptr(t) for t in outs] + [build.stream_of(kmer)]
        lib = libs[side, "pair_vote"]
        if side == "change":
            mode = da.check_vote_shape(W, E_)
            err = build.bind(lib, "dtk_pair_vote", "ppppiipiiiiipipppp")(
                *head, {"shared": 0, "large-E": 1}[mode],
                da.kc_smem_bytes(W, E_), None, 0, *tail)
        elif _parent_kc_bytes(W, E_) <= da.SMEM_LIMIT:
            err = build.bind(lib, "dtk_pair_vote", "ppppiipiiiipppp")(
                *head, _parent_kc_bytes(W, E_), *tail)
        else:
            stride = -(-_parent_kc_bytes(W, E_) // 256) * 256
            ws = parent_ws.setdefault((E_, Pn), torch.empty(
                Pn * stride, dtype=torch.uint8, device=dev))
            err = build.bind(lib, "dtk_pair_vote_global",
                             "ppppiipiiipipppp")(*head, build.ptr(ws),
                                                 stride, *tail)
        build.check(err, f"{side} pair_vote")

    def probe_call(tab, q, loc, outs):
        """KB's launch on both sides, its arguments built once."""
        args = {s: (build.bind(libs[s, "bucket_lookup"], "dtk_bucket_lookup",
                               "ppipppiiipppp"),
                    (q.data_ptr(), None if loc is None else loc.data_ptr(),
                     q.numel(), *dt.level_args(tab), int(tab.composite),
                     tab.nval, *[t.data_ptr() for t in outs[s]],
                     build.stream_of(q))) for s in ("parent", "change")}

        def call(side):
            fn, a = args[side]
            build.check(fn(*a), f"{side} bucket_lookup")
        return call

    def owned_call(blk, meta, q, loc, outs):
        """KI's launch on both sides, its arguments built once."""
        la = dt.owned_args(blk, meta)
        args = {s: (build.bind(libs[s, "sharded_lookup"],
                               "dtk_sharded_lookup",
                               "ppi" + "ppppp" + "iii" + "pppp"),
                    (q.data_ptr(), None if loc is None else loc.data_ptr(),
                     q.numel(), *la, int(blk.composite), blk.nval,
                     *[t.data_ptr() for t in outs[s]], build.stream_of(q)))
                for s in ("parent", "change")}

        def call(side):
            fn, a = args[side]
            build.check(fn(*a), f"{side} sharded_lookup")
        return call

    parent_ws: dict = {}
    cases = []
    for E_, inp in vote_sets.items():
        inp = [t.contiguous() for t in inp]
        Pn = inp[3].shape[0]
        w = vote_work(inp[0], inp[2], inp[1], inp[4], E_)
        print(f"KC E={E_} P={Pn} live entries/pair mean="
              f"{w['entries']['mean']:.2f} p99={w['entries']['p99']:.0f} "
              f"max={w['entries']['max']:.0f}; live events/pair mean="
              f"{w['events']['mean']:.2f} p99={w['events']['p99']:.0f} "
              f"max={w['events']['max']:.0f}", flush=True)
        outs = {s: [torch.empty(Pn, dtype=dt_, device=dev) for dt_ in
                    (torch.int64, torch.bool, torch.uint8)]
                for s in ("parent", "change")}
        cases.append((f"KC E={E_} P={Pn}", outs,
                      lambda s, E_=E_, inp=inp, outs=outs:
                      vote_call(s, E_, inp, outs[s]),
                      (5, 3) if E_ > 512 else (10, 20)))
    for name, (tab, q, loc) in probes.items():
        qf = q.reshape(-1).contiguous()
        lf = None if loc is None else loc.reshape(-1).to(
            torch.int64).contiguous()
        outs = {s: [torch.empty(qf.numel(), dtype=dt_, device=dev)
                    for dt_ in (torch.bool, torch.int64, torch.int64)]
                for s in ("parent", "change")}
        cases.append((f"KB {name} queries={qf.numel()}", outs,
                      probe_call(tab, qf, lf, outs), (10, 20)))
    for name in ("dbi", "trfl", "member"):
        tab, q, loc = probes[name]
        qf = q.reshape(-1).contiguous()
        lf = None if loc is None else loc.reshape(-1).to(
            torch.int64).contiguous()
        for D in (1, 4):
            for d_, (blk, meta) in enumerate(row_blocks(tab, D)):
                outs = {s: [torch.empty(qf.numel(), dtype=torch.int32,
                                        device=dev) for _ in range(3)]
                        for s in ("parent", "change")}
                cases.append((f"KI {name} D={D} block={d_} "
                              f"queries={qf.numel()}", outs,
                              owned_call(blk, meta, qf, lf, outs),
                              (10, 20)))

    for name, outs, call, (n, reps) in cases:
        for side in ("parent", "change"):
            call(side)
        torch.cuda.synchronize()
        for a, b in zip(outs["parent"], outs["change"]):
            if not torch.equal(a, b):
                raise RuntimeError(f"{name}: the two builds disagree")
        ab_pairs(name, call, args.pairs, smi, reps=reps, n=n)


if __name__ == "__main__":
    main()
