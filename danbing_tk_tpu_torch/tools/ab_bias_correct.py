"""Same-call timing of KH (csrc/bias_correct.cu), alone or against
other checkouts' builds.

    python -m danbing_tk_tpu_torch.tools.ab_bias_correct [--parent DIR ...]

Builds this tree's KH and each ``DIR/danbing_tk_tpu_torch/csrc/
bias_correct.cu`` (another checkout of this repository, e.g. unpacked with
``git archive``; same entry point) with the same nvcc flags, makes the
synthetic cohort of tools/scale_pred.py at NS = 32 samples x (NLOCI =
80,000 x 1500) k-mers on the card, as chip_smoke.py's phase 8b does,
checks that every build's corrected matrix and bias are bit-equal to this
tree's, then times every build in ROUNDS rounds (order reversed in odd
rounds), each call on a fresh copy of the cohort (KH works in place).
It also times:
  * this tree's KH on the same cohort with every invariant-k-mer column
    zeroed, so that no locus is active and the divide launch does no
    work: what its sums and normalisation take ("sums_only");
  * ``copy_`` of the cohort matrix, a streaming yardstick that moves the
    same bytes as the divide.
Prints the registers of each build and the median, min and max ms of
each.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import os
import subprocess

import numpy as np
import torch

from ..analysis import pred
from ..kernels import build
from . import scale_pred


NS, NLOCI, ROUNDS, SEED = 32, 80_000, 6, 9


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", action="append", default=[])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("ab_bias_correct needs a CUDA card")
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    libs = {}
    for i, d in enumerate(args.parent):
        libs[f"parent{i}"], reg = build.build_ab(os.path.join(
            d, "danbing_tk_tpu_torch", "csrc", "bias_correct.cu"),
            f"parent{i}")
        print(f"parent{i} ({d}) registers: {reg}", flush=True)
    libs["change"], reg = build.build_ab(
        os.path.join(build.CSRC, "bias_correct.cu"), "change")
    print(f"change registers: {reg}", flush=True)

    co = scale_pred.build_cohort(NS, nloci=NLOCI, seed=SEED)
    base = scale_pred.build_gt(co, dev)
    idx = pred.index_tensors(co["nk_cum"], co["nik_cum"], co["iki"],
                             co["ikc"], dev)
    ns, nk = base.shape
    n_tr = idx[0].numel()
    dead = base.clone()
    dead[:, idx[2].long()] = 0.0    # no invariant coverage anywhere
    work = torch.empty_like(base)

    def call(lib, g):
        bias = torch.empty((ns, n_tr), dtype=torch.float32, device=dev)
        act = torch.empty(n_tr, dtype=torch.uint8, device=dev)
        fn = build.bind(lib, "dtk_bias_correct", "iii" + "p" * 7 + "ip")
        build.check(fn(ns, nk, n_tr, build.ptr(g),
                       *[build.ptr(t) for t in idx], build.ptr(bias),
                       build.ptr(act), pred.HOST_NAN_BITS,
                       build.stream_of(g)), "bias_correct")
        return bias

    work.copy_(base)
    want_bias = call(libs["change"], work)
    want = work.clone()
    for name, lib in libs.items():
        work.copy_(base)
        got_bias = call(lib, work)
        torch.cuda.synchronize()
        if not (torch.equal(work.view(torch.int32), want.view(torch.int32))
                and torch.equal(got_bias.view(torch.int32),
                                want_bias.view(torch.int32))):
            raise RuntimeError(f"{name} disagrees with this tree's KH")
    del want
    runs = {name: (lambda g, lib=lib: call(lib, g), base)
            for name, lib in libs.items()}
    runs["sums_only"] = (lambda g: call(libs["change"], g), dead)
    runs["copy_"] = (None, base)
    ms = {name: [] for name in runs}
    for r in range(ROUNDS):
        order = list(runs) if r % 2 == 0 else list(runs)[::-1]
        for name in order:
            fn, src = runs[name]
            if fn is not None:
                work.copy_(src)
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            if fn is None:
                work.copy_(src)
            else:
                fn(work)
            e1.record()
            e1.synchronize()
            ms[name].append(e0.elapsed_time(e1))
    for name, v in ms.items():
        print(f"{name}: median={np.median(v):.4f} ms min={min(v):.4f} "
              f"max={max(v):.4f}", flush=True)
    print(f"ns={ns} nk={nk} n_tr={n_tr} rounds={ROUNDS}", flush=True)


if __name__ == "__main__":
    main()
