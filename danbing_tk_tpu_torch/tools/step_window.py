"""Times one counting step on the card, to compare two checkouts' host code
around the kernels (what a step costs the host to enqueue) in one call:

    python danbing_tk_tpu_torch/tools/step_window.py --root DIR [--reps N]

``--root`` is the checkout whose ``danbing_tk_tpu_torch`` is imported (this
one, or another unpacked beside it with ``git archive``); its kernels build
into its own ``build/``.  On the golden panel's index and its first P = 4096
read pairs (L = 160, -kf 4 1, cth 20, E = 512): the median ms of a step over
windows of 10 back-to-back calls (CUDA events: the device is idle between
the host's launches, so this is the host's enqueue rate), the median host ms
of one call ended by a synchronize, and the launches of one step by kernel;
the same for the host-sampled prefilter's dispatch of 4P pairs (those
reads four times over; the native sampler's queries uploaded first).
Then, on the step's captured inputs, the CUDA-graph replays (GRAPH
launches a graph, the median of windows of 5 replays) of KL
(``pair_filter``) and of KD as the step launches it (``assign_count``),
with the step's tail (KM) in KD's launch where the checkout runs it there,
else KD and the checkout's own KM launch (``step_tail``) in one graph;
and of KE (``thread_walk_graph``, with KM the same way) on the golden
threading step's inputs (``-gc 50 3``, the first P pairs of
``reads.sim.fa``, the graph table added).  So one call with the parent and
this tree in turns gives the same-call A/B of each and of the step
window.  Prints one JSON line, with the card and
its power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

GRAPH = 20                # launches a CUDA graph replays


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", required=True)
    ap.add_argument("--reps", type=int, default=21)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)

    import numpy as np
    import torch

    from danbing_tk_tpu_torch.engine import device_align as da
    from danbing_tk_tpu_torch.engine.host_align import AlignConfig, RPGG
    from danbing_tk_tpu_torch.io.native_reader import sample_queries
    from danbing_tk_tpu_torch.kernels import build
    from danbing_tk_tpu_torch.ops.kmers import pack_reads

    if not torch.cuda.is_available():
        sys.exit("step_window needs a CUDA card")
    dev = torch.device("cuda")
    gold = os.path.join(root, "tests", "golden")
    P, L = 4096, 160
    seqs = [ln.strip() for ln in open(os.path.join(gold, "reads.fa"))
            if not ln.startswith(">")]
    codes, rlen = pack_reads(seqs[: 2 * P], L)
    drp = da.DeviceRPGG.build(RPGG(os.path.join(gold, "pan")),
                              with_tre=False)
    cfg = AlignConfig(ksize=21, cth=20, n_filter=4, nm_filter=1, okam=False)
    step = da.make_step(drp, cfg, P, L, expand_cap=512, device=dev)
    state = da.init_state(drp, dev)
    inputs = (torch.from_numpy(codes).to(dev), torch.from_numpy(rlen).to(dev),
              torch.ones(P, dtype=torch.bool, device=dev))
    pre = da.make_prefilter_step_q(drp, cfg, 4 * P, dev)
    qlo, qhi, valid, nonshort = sample_queries(
        np.tile(codes, (4, 1)), np.tile(rlen, 4), 21, 4)
    pre_in = [torch.from_numpy(x).to(dev) for x in (
        da.query_int64(qlo, qhi), valid, nonshort,
        np.ones(4 * P, dtype=bool))]

    def timed(fn):
        """(median window ms, median synchronized call ms, launches)."""
        for _ in range(5):
            fn()
        torch.cuda.synchronize()
        build.reset_launch_counts()
        fn()
        launches = {k: v for k, v in build.launch_counts().items() if v}
        windows, calls = [], []
        for _ in range(args.reps):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            for _ in range(10):
                fn()
            e1.record()
            e1.synchronize()
            windows.append(e0.elapsed_time(e1) / 10)
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            calls.append(1e3 * (time.perf_counter() - t0))
        return statistics.median(windows), statistics.median(calls), launches

    step_w, step_c, step_l = timed(lambda: step(state, *inputs))
    pre_w, pre_c, pre_l = timed(lambda: pre(*pre_in))

    # the kernels on the steps' captured inputs, each as a CUDA graph
    cap: dict = {}
    da.make_step(drp, cfg, P, L, expand_cap=512, device=dev, capture=cap)(
        da.init_state(drp, dev), *inputs)
    st = da.init_state(drp, dev)
    rp = RPGG(os.path.join(gold, "pan"))
    drp.add_graph(rp)
    tcfg = AlignConfig(ksize=21, cth=20, n_filter=4, nm_filter=1,
                       simmode=2, threading=True, thread_cth=50,
                       maxncorrection=3, aln=True)
    tseqs = [ln.strip() for ln in open(os.path.join(gold, "reads.sim.fa"))
             if not ln.startswith(">")]
    tcodes, trlen = pack_reads(tseqs[: 2 * P], L)
    tcap: dict = {}
    da.make_step(drp, tcfg, P, L, expand_cap=512, device=dev,
                 capture=tcap)(da.init_state(drp, dev), tcodes, trlen,
                               np.ones(P, dtype=bool))
    tst = da.init_state(drp, dev)
    kernels = {"KL": lambda: da.pair_filter(*cap["KL"])}
    if "KM" in cap:                      # KM a launch of its own
        kernels["KD+KM"] = lambda: (da.assign_count(st, *cap["KD"]),
                                    da.step_tail(st["stats"], *cap["KM"]))
        kernels["KE+KM"] = lambda: (
            da.thread_walk_graph(tst, *tcap["KE"]),
            da.step_tail(tst["stats"], *tcap["KM"]))
    else:                                # KM in KD's and KE's launches
        kernels["KD+KM"] = lambda: da.assign_count(st, *cap["KD"])
        kernels["KE+KM"] = lambda: da.thread_walk_graph(tst, *tcap["KE"])
    graph_ms = {}
    for name, fn in kernels.items():
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(GRAPH):
                fn()
        ms = []
        for _ in range(args.reps):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            for _ in range(5):
                g.replay()
            e1.record()
            e1.synchronize()
            ms.append(e0.elapsed_time(e1) / (5 * GRAPH))
        graph_ms[name] = statistics.median(ms)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(json.dumps(dict(
        root=args.root, P=P, L=L, step_window_ms=step_w, step_call_ms=step_c,
        step_launches=step_l, prefilter_window_ms=pre_w,
        prefilter_call_ms=pre_c, prefilter_launches=pre_l,
        graph_ms=graph_ms,
        km_launch="own" if "KM" in cap else "in KD and KE",
        card=smi.strip())), flush=True)


if __name__ == "__main__":
    main()
