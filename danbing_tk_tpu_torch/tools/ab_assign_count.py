"""Same-call A/B of KD (assign_count) against another checkout's, in its
three instances.

    python -m danbing_tk_tpu_torch.tools.ab_assign_count --parent DIR
        [--nloci N] [--pairs N] [--seed S]

Builds ``DIR/danbing_tk_tpu_torch/csrc/assign_count.cu`` (another checkout
of this repository with the same entry point, e.g. the parent commit
unpacked with ``git archive``) beside this tree's, with ``-Xptxas -v``.
On the synthetic scale index (``tools/scale_index.py``, 1,500 k-mers per
locus, the smoke's 80,000 loci by default) at P = 4096, L = 160, k = 21,
E = 512 it captures KD's inputs from:

* the counting step, on TR-pool pairs (the counting instance);
* the okam step (``-s 2 -b -qc``, ``with_annot``: the ann plane and the
  bait's bf_pair) on TR pairs with 0.5% substitutions (the annot
  instance);
* the threading step's KD inputs (the same planes a counting step makes
  on the threading reads, TR pairs with 0.5% substitutions; KD then runs
  with ``threading``, writing the tr_member and slot planes);
* the counting step on the golden panel's reads (``tests/golden/pan``,
  the first 4,096 pairs of ``tests/golden/reads.fa``: real VNTR loci,
  whose tandem repeats put neighbouring positions of a read on one count
  slot; the counting instance).

For each instance it also prints, from the plain version's slot and ann
planes, how many TR positions of counted reads KD adds to ``counts`` and
how many of them share their slot with another position of their
32-position chunk (the adds that aggregating equal slots of a warp
would save).

Each instance is first run through both builds, which must give the same
fields, planes and state.  Both sides are the same bare ctypes call (no
wrapper, its arguments built once) of ``dtk_assign_count``: KD without the
step's tail (KM), which the counting step runs in KD's launch through
``dtk_assign_count_tail`` (``tools/step_window.py`` times KD as the step
launches it, beside another checkout's KD and KM), and each time is the
median over 10 CUDA-event windows of 20 back-to-back launches, divided by
20, so the host's enqueue cost stays out of it, in ``--pairs`` alternating
pairs (parent first in even pairs).
Prints the card, both builds' registers and shared memory, KD's grid,
every pair, both medians and quartiles, and the change's wins.  Needs a
CUDA card.
"""

from __future__ import annotations

import argparse
import os
import subprocess

import numpy as np
import torch

from ..engine import device_align as da
from ..engine.host_align import RPGG, AlignConfig
from ..kernels import build
from ..ops.kmers import pack_reads
from .scale_index import (build_scale_bait, build_scale_qc, build_scale_rpgg,
                          sample_read_batch)


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


def ab_pairs(name: str, call, pairs: int, smi: str, reps: int = 20,
             n: int = 10, per: int = 1) -> dict:
    """Times call("parent") and call("change") in ``pairs`` alternating
    pairs (ms per call, divided by ``per``: the launches one call makes);
    prints each pair, both medians and quartiles and the wins, and
    returns {side: [ms, ...]}."""
    ms = {"parent": [], "change": []}
    for i in range(pairs):
        order = ("parent", "change") if i % 2 == 0 else ("change", "parent")
        for side in order:
            ms[side].append(
                _ms_per_launch(lambda s=side: call(s), reps, n) / per)
        print(f"{name} pair {i} {order[0]} first: "
              f"parent={ms['parent'][-1]:.4f} change={ms['change'][-1]:.4f}",
              flush=True)
    wins = sum(c < p for p, c in zip(ms["parent"], ms["change"]))
    for side, v in ms.items():
        q1, med, q3 = np.percentile(v, [25, 50, 75])
        print(f"{name} {side}: median={med:.4f} ms q1={q1:.4f} q3={q3:.4f}",
              flush=True)
    print(f"{name}: change faster in {wins} of {pairs} pairs; card {smi}",
          flush=True)
    return ms


def slot_sharing(state: dict, a) -> tuple:
    """KD's count adds on the captured inputs ``a`` (its 16 arguments),
    from the plain version: (TR positions of counted reads, those whose
    slot another position of their 32-position chunk also adds to, the
    adds left when each chunk adds once per distinct slot)."""
    R, NKW = a[0].shape
    o = da.assign_count_plain(state, *a[:13], True, a[14], True)
    rm = o["rm"].view(R // 2, 2) == 1
    counted = (a[7] & ~rm.all(1)).repeat_interleave(2) & ~rm.reshape(-1)
    tr = (o["ann"] == 2) & counted[:, None]
    # a position that adds nothing gets a key of its own (negative)
    nch = -(-NKW // 32)
    key = -1 - torch.arange(R * nch * 32, device=tr.device).view(R, -1)
    key[:, :NKW] = torch.where(tr, o["slot"], key[:, :NKW])
    srt = key.view(R, nch, 32).sort(-1).values
    eq = (srt[..., 1:] == srt[..., :-1]) & (srt[..., 1:] >= 0)
    shared = torch.zeros_like(srt, dtype=torch.bool)
    shared[..., 1:] |= eq
    shared[..., :-1] |= eq
    n_tr = int(tr.sum())
    return n_tr, int(shared.sum()), n_tr - int(eq.sum())


def card_name() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True)
    ap.add_argument("--nloci", type=int, default=80_000)
    ap.add_argument("--pairs", type=int, default=6)
    ap.add_argument("--seed", type=int, default=9)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("ab_assign_count needs a CUDA card")
    dev = torch.device("cuda")
    smi = card_name()
    print(f"card: {smi}", flush=True)
    libs = {}
    for side, root in (("parent", os.path.join(
            args.parent, "danbing_tk_tpu_torch", "csrc")),
            ("change", build.CSRC)):
        libs[side], regs = build.build_ab(
            os.path.join(root, "assign_count.cu"), f"{side}_assign_count")
        print(f"{side} assign_count ptxas: {regs}", flush=True)
    P, L, E, k, RL, SUB = 4096, 160, 512, 21, 150, 0.005
    drp, seqs = build_scale_rpgg(args.nloci, 1500, seed=args.seed,
                                 verbose=False)
    drp.bait_tab, _ = build_scale_bait(seqs, seed=args.seed)
    drp.qc = build_scale_qc(args.nloci, seed=args.seed)
    live = np.ones(P, dtype=bool)

    def capture(cfg, rng_key, sub, **kw):
        codes, rlen = sample_read_batch(seqs, P, L, np.random.default_rng(
            [args.seed, rng_key]), frac_tr=1.0, read_len=RL, sub_rate=sub)
        cap: dict = {}
        da.make_step(drp, cfg, P, L, expand_cap=E, device=dev, capture=cap,
                     **kw)(da.init_state(drp, dev), codes, rlen, live)
        return list(cap["KD"])[:16]          # KD's own arguments

    base = dict(ksize=k, cth=20, n_filter=4, nm_filter=1)
    inst = {"counting": capture(AlignConfig(**base, okam=False), 1, 0.0)}
    inst["annot"] = capture(AlignConfig(**base, okam=True, simmode=2,
                                        bait=True, qc=True), 4, SUB,
                            with_annot=True)
    thr = capture(AlignConfig(**base, okam=False), 2, SUB)
    thr[13] = True                              # threading
    inst["threading"] = thr
    gold = os.path.join(os.path.dirname(build.CSRC), os.pardir, "tests",
                        "golden")
    gd = da.DeviceRPGG.build(RPGG(os.path.join(gold, "pan")),
                             with_tre=False)
    seqs_g = [ln.strip() for ln in open(os.path.join(gold, "reads.fa"))
              if not ln.startswith(">")]
    gcodes, grlen = pack_reads(seqs_g[: 2 * P], L)
    gcap: dict = {}
    da.make_step(gd, AlignConfig(**base, okam=False), P, L, expand_cap=E,
                 device=dev, capture=gcap)(da.init_state(gd, dev), gcodes,
                                           grlen, live)
    inst["golden"] = list(gcap["KD"])[:16]
    models = {"golden": gd}
    blocks, warps = da.assign_count_grid(P)
    print(f"KD grid (change): blocks={blocks} warps={warps}", flush=True)

    for name, a in inst.items():
        model = models.get(name, drp)
        n_tr, n_sh, n_agg = slot_sharing(da.init_state(model, dev), a)
        print(f"KD {name}: {n_tr} TR adds, {n_sh} share a slot with "
              f"another position of their chunk "
              f"({100 * n_sh / max(n_tr, 1):.2f}%); {n_agg} adds once "
              f"per distinct slot of a chunk", flush=True)
        (found, val, annv, kvalid, afound_t, aval_t, dst0, dev_pair, kf, nk,
         loff, nloci, nm_tr, threading, bf_pair, annot) = a
        R, NKW = found.shape
        kf, nk = kf.to(torch.int32), nk.to(torch.int32)  # kept alive
        ptrs = [build.ptr(t) for t in (found, val, annv, kvalid, afound_t,
                                       aval_t, dst0, dev_pair)]
        ptrs += [None if bf_pair is None else build.ptr(bf_pair),
                 build.ptr(kf), build.ptr(nk), build.ptr(loff)]
        states = {s: da.init_state(model, dev) for s in libs}
        outs = {s: dict(out=torch.empty((len(da.ASSIGN_KEYS), R),
                                        dtype=torch.int32, device=dev),
                        tr=torch.zeros((R, NKW), dtype=torch.uint8,
                                       device=dev),
                        slot=torch.zeros((R, NKW), dtype=torch.int64,
                                         device=dev),
                        ann=torch.zeros((R, NKW), dtype=torch.uint8,
                                        device=dev)) for s in libs}

        def launch(side, st):
            """KD's bare launch on ``side`` into state ``st``, its
            arguments built once."""
            o = outs[side]
            fn = build.bind(libs[side], "dtk_assign_count",
                            "ii" + "p" * 12 + "iiiii" + "p" * 8)
            kd = (R // 2, NKW, *ptrs, nloci, st["counts"].shape[0] - 1, nm_tr,
                 int(threading), int(annot), build.ptr(st["counts"]),
                 build.ptr(st["nmapread"]), build.ptr(st["kmc"]),
                 build.ptr(o["out"]),
                 build.ptr(o["tr"]) if threading else None,
                 build.ptr(o["slot"]) if threading else None,
                 build.ptr(o["ann"]) if annot else None,
                 build.stream_of(found))
            return lambda: build.check(fn(*kd),
                                       f"{side} assign_count[{name}]")

        timed = {s: launch(s, states[s]) for s in libs}

        fresh = {s: da.init_state(model, dev) for s in libs}
        for side in libs:
            launch(side, fresh[side])()
        torch.cuda.synchronize()
        for key in outs["parent"]:
            if not torch.equal(outs["parent"][key], outs["change"][key]):
                raise RuntimeError(f"KD[{name}]: the builds disagree on "
                                   f"{key}")
        for key in ("counts", "nmapread", "kmc"):
            if not torch.equal(fresh["parent"][key], fresh["change"][key]):
                raise RuntimeError(f"KD[{name}]: the builds disagree on "
                                   f"{key}")
        del fresh
        ab_pairs(f"KD {name} P={R // 2} NKW={NKW}", lambda s: timed[s](),
                 args.pairs, smi)


if __name__ == "__main__":
    main()
