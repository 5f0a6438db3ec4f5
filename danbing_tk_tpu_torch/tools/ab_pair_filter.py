"""Same-call A/B of KL (the sub/k-filter, ``pair_filter``) against other
checkouts' (or copies of ``csrc/`` with a constant changed).

    python -m danbing_tk_tpu_torch.tools.ab_pair_filter --parent DIR
        [--parent DIR2 ...] [--rounds N]

Builds ``DIR/danbing_tk_tpu_torch/csrc/pair_filter.cu`` for each
``--parent`` (only its ``csrc/`` is read; the same C entry point
``dtk_pair_filter``) beside this tree's, with ``-Xptxas -v``, and times
each build's bare launch on the same inputs:

* golden: the counting step's KL inputs on the golden panel's index and
  its first P = 4,096 pairs (L = 160, k = 21, -kf 4 1, cth 20: NKW = 140);
* random: seeded planes at P = 4,096, NKW = 140 (found in 30% of the
  positions, kvalid in 90%, nk up to NKW), nf = 4, nmf = 1, cth = 20.

Each case is first run through every build, whose planes must equal the
plain version's.  Then, in ``--rounds`` rounds (the sides in a rotating
order), each side's CUDA-graph time: GRAPH bare launches captured in one
graph, the median of 10 CUDA-event windows of 5 replays, per launch
(below ~10 us only a graph times a kernel).  Prints the card, each
build's registers and spills, every round and each side's median and
quartiles.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import os

import numpy as np
import torch

from ..engine import device_align as da
from ..engine.host_align import RPGG, AlignConfig
from ..kernels import build
from ..ops import kmers as km
from .ab_assign_count import _ms_per_launch, card_name
from .ab_kmers_filter import GOLDEN, GRAPH, graph_of

KL_SIG = "ppppp" + "iiiii" + "pppppp" + "p"


def kl_inputs(dev) -> dict:
    """{case: pair_filter's arguments} on ``dev``."""
    P, L = 4096, 160
    seqs = [ln.strip() for ln in open(os.path.join(GOLDEN, "reads.fa"))
            if not ln.startswith(">")]
    codes, rlen = km.pack_reads(seqs[: 2 * P], L)
    drp = da.DeviceRPGG.build(RPGG(os.path.join(GOLDEN, "pan")),
                              with_tre=False)
    cap: dict = {}
    cfg = AlignConfig(ksize=21, cth=20, n_filter=4, nm_filter=1, okam=False)
    da.make_step(drp, cfg, P, L, device=dev, capture=cap)(
        da.init_state(drp, dev), codes, rlen, np.ones(P, dtype=bool))
    rng = np.random.default_rng(7)
    R, NKW = 2 * P, L - 21 + 1
    up = lambda a: torch.from_numpy(a).to(dev)       # noqa: E731
    rand = (up(rng.random((R, NKW)) < 0.3), up(rng.random((R, NKW)) < 0.9),
            up(rng.integers(0, NKW + 1, R).astype(np.int32)),
            up(rng.random(R) < 0.97), up(rng.random(P) < 0.99), 4, 1, 20)
    return {"golden": cap["KL"], "random": rand}


def launcher(lib, args):
    """A bare launch of ``lib``'s dtk_pair_filter on ``args`` (outputs
    allocated once): (launch(stream), outputs)."""
    found, kvalid, nk, any_valid, live, nf, nmf, cth = args
    R, NKW = found.shape
    P = R // 2
    dev = found.device
    outs = (torch.empty_like(found), torch.empty(R, dtype=torch.int32,
                                                 device=dev),
            *(torch.empty(P, dtype=torch.bool, device=dev)
              for _ in range(3)), torch.empty_like(found))
    fn = build.bind(lib, "dtk_pair_filter", KL_SIG)
    ptr = build.ptr
    call = (ptr(found), ptr(kvalid), ptr(nk), ptr(any_valid), ptr(live), P,
            NKW, nf, nmf, cth, *[ptr(t) for t in outs])
    return (lambda s, keep=(args, outs): build.check(fn(*call, s),
                                                     "pair_filter")), outs


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", action="append", required=True)
    ap.add_argument("--rounds", type=int, default=6)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("ab_pair_filter needs a CUDA card")
    dev = torch.device("cuda")
    smi = card_name()
    print(f"card: {smi}", flush=True)
    roots = {"change": build.CSRC}
    for i, d in enumerate(args.parent):
        roots[f"parent{i}:{os.path.basename(os.path.normpath(d))}"] = \
            os.path.join(d, "danbing_tk_tpu_torch", "csrc")
    libs = {}
    for i, (side, root) in enumerate(roots.items()):
        libs[side], regs = build.build_ab(os.path.join(root, "pair_filter.cu"),
                                          f"kl_ab{i}")
        print(f"{side} pair_filter ptxas: {regs}", flush=True)
    for case, a in kl_inputs(dev).items():
        want = da.pair_filter_plain(*a)
        replay = {}
        for side, lib in libs.items():
            launch, outs = launcher(lib, a)
            launch(ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
            torch.cuda.synchronize()
            if not all(torch.equal(g, w) for g, w in zip(outs, want)):
                raise RuntimeError(f"KL {case}: {side} disagrees with the "
                                   f"plain version")
            replay[side] = graph_of(lambda f=launch: f(ctypes.c_void_p(
                torch.cuda.current_stream().cuda_stream))).replay
        ms = {s: [] for s in libs}
        sides = list(libs)
        for r in range(args.rounds):
            order = sides[r % len(sides):] + sides[: r % len(sides)]
            for side in order:
                ms[side].append(_ms_per_launch(replay[side], 5, 10) / GRAPH)
            print(f"KL {case} graph round {r}: " + " ".join(
                f"{s}={ms[s][-1]:.5f}" for s in sides), flush=True)
        for side, v in ms.items():
            q1, med, q3 = np.percentile(v, [25, 50, 75])
            print(f"KL {case} graph {side}: median={med:.5f} ms "
                  f"q1={q1:.5f} q3={q3:.5f}; card {smi}", flush=True)


if __name__ == "__main__":
    main()
