"""Same-call A/B of KD's counting instance against another checkout's.

    python -m danbing_tk_tpu_torch.tools.ab_assign_count --parent DIR
        [--nloci N] [--pairs N] [--seed S]

Builds ``DIR/danbing_tk_tpu_torch/csrc/assign_count.cu`` (another checkout
of this repository, e.g. the parent commit unpacked with ``git archive``;
its entry point takes no bf_pair / annot arguments) beside this tree's,
captures one counting step's KD inputs on the synthetic scale index at
P = 4096, L = 160, E = 512, checks that both give the same fields and
state, then times them in ``--pairs`` alternating pairs (parent first in
even pairs).  Both sides are the same bare ctypes call (no wrapper), and
each time is the median over 10 CUDA-event windows of 20 back-to-back
launches, divided by 20, so the host's enqueue cost stays out of it.
Prints both builds' register use, every pair, both medians and
quartiles, and the change's wins.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import os
import subprocess

import numpy as np
import torch

from ..engine import device_align as da
from ..engine.host_align import AlignConfig
from ..kernels import build
from .scale_index import build_scale_rpgg, sample_read_batch


def _ms_per_launch(fn, reps: int = 20, n: int = 10) -> float:
    for _ in range(3):
        fn()
    ts = []
    for _ in range(n):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(reps):
            fn()
        e1.record()
        e1.synchronize()
        ts.append(e0.elapsed_time(e1) / reps)
    return float(np.median(ts))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True)
    ap.add_argument("--nloci", type=int, default=8000)
    ap.add_argument("--pairs", type=int, default=10)
    ap.add_argument("--seed", type=int, default=9)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("ab_assign_count needs a CUDA card")
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    P, L, E = 4096, 160, 512
    drp, seqs = build_scale_rpgg(args.nloci, 1500, seed=args.seed,
                                 verbose=False)
    rng = np.random.default_rng([args.seed, 1])
    codes, rlen = sample_read_batch(seqs, P, L, rng, frac_tr=1.0,
                                    read_len=150)
    cap: dict = {}
    cfg = AlignConfig(ksize=21, cth=20, n_filter=4, nm_filter=1, okam=False)
    step = da.make_step(drp, cfg, P, L, expand_cap=E, device=dev,
                        capture=cap)
    step(da.init_state(drp, dev), codes, rlen, np.ones(P, dtype=bool))
    kd = cap["KD"]
    (found, val, annv, kvalid, afound_t, aval_t, dst0, dev_pair, kf, nk,
     loff, nloci, nm_tr) = kd[:13]
    R, NKW = found.shape
    kf, nk = kf.to(torch.int32), nk.to(torch.int32)     # kept alive
    ptrs = [build.ptr(t) for t in (
        found, val, annv, kvalid, afound_t, aval_t, dst0, dev_pair, kf, nk,
        loff)]
    plib, preg = build.build_ab(os.path.join(
        args.parent, "danbing_tk_tpu_torch", "csrc", "assign_count.cu"),
        "parent")
    clib, creg = build.build_ab(os.path.join(build.CSRC, "assign_count.cu"),
                                "change")
    print(f"parent registers: {preg}\nchange registers: {creg}", flush=True)
    pfn = build.bind(plib, "dtk_assign_count",
                     "ii" + "p" * 11 + "iiii" + "p" * 7)
    cfn = build.bind(clib, "dtk_assign_count",
                     "ii" + "p" * 12 + "iiiii" + "p" * 8)

    def call(side, state, out):
        head = (R // 2, NKW, *ptrs[:8])
        tail = (build.ptr(state["counts"]), build.ptr(state["nmapread"]),
                build.ptr(state["kmc"]), build.ptr(out), None, None)
        consts = (nloci, state["counts"].shape[0] - 1, nm_tr, 0)
        stream = build.stream_of(found)
        if side == "parent":
            err = pfn(*head, *ptrs[8:], *consts, *tail, stream)
        else:       # no bf_pair, no ann plane: the counting instance
            err = cfn(*head, None, *ptrs[8:], *consts, 0, *tail, None,
                      stream)
        build.check(err, f"{side} assign_count")

    outs = {side: torch.empty((len(da.ASSIGN_KEYS), R), dtype=torch.int32,
                              device=dev) for side in ("parent", "change")}
    states = {side: da.init_state(drp, dev) for side in outs}
    for side in outs:
        call(side, states[side], outs[side])
    torch.cuda.synchronize()
    if not torch.equal(outs["parent"], outs["change"]):
        raise RuntimeError("the two KD builds disagree on the fields")
    for key in ("counts", "nmapread", "kmc"):
        if not torch.equal(states["parent"][key], states["change"][key]):
            raise RuntimeError(f"the two KD builds disagree on {key}")
    ms = {"parent": [], "change": []}
    for i in range(args.pairs):
        order = ("parent", "change") if i % 2 == 0 else ("change", "parent")
        for side in order:
            ms[side].append(_ms_per_launch(
                lambda s=side: call(s, states[s], outs[s])))
        print(f"pair {i} {order[0]} first: parent={ms['parent'][-1]:.4f} "
              f"change={ms['change'][-1]:.4f}", flush=True)
    wins = sum(c < p for p, c in zip(ms["parent"], ms["change"]))
    for name, v in ms.items():
        q1, med, q3 = np.percentile(v, [25, 50, 75])
        print(f"{name}: median={med:.4f} ms q1={q1:.4f} q3={q3:.4f}",
              flush=True)
    print(f"change faster in {wins} of {args.pairs} pairs; P={P} NKW={NKW} "
          f"nloci={args.nloci}", flush=True)


if __name__ == "__main__":
    main()
