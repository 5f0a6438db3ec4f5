"""Where the time goes in the production-size funnel on a card.

    python -m danbing_tk_tpu_torch.tools.profile_funnel [--nloci N]
        [--pairs N] [--out DIR] [--threading | --okam | --sharded]

Builds the synthetic scale index (tools/scale_index.py), runs the funnel
of chip_smoke.py phase 5 (counting), with --threading phase 6 (-gc 85 3
on reads with 0.5% substitutions, the graph table built too) or with
--okam phase 7 (.kam rows, -s 2 -b -qc -bu on reads with 0.5%
substitutions and simmode-2 titles; the tre table, bait table and QC mask
built too) or with --sharded phase 5s(d) (the sharded runner on a world-1
NCCL group, index sharded, E = 512 -> [4096]) once to warm up, then once more under torch.profiler (CPU +
CUDA activities).  Prints the host wall, the summed device time per kernel
name, the device busy time (union of kernel and copy intervals) and the
idle share (1 - busy / wall), and writes the chrome trace and the
key_averages table under --out.  In threading mode the host view's locus
builds are done in the warm-up pass (the profiled pass reuses them), and
the host seconds spent waiting on the batched native engine are printed
beside the wall; in okam mode, the host seconds spent making .kam rows,
inserting bubbles and merging the bubble maps.  Every mode but threading
resolves its referee'd pairs over the flat host view of the index
(engine/flat_rpgg.py, built before the warm-up), as chip_smoke.py's
phases do: its build seconds, and per pass the pairs resolved and the
host seconds spent in the referee (native pool, or the Python HostAligner
with -bu), are printed.  Threading keeps the thread_view and counts its
referee'd pairs unresolved, as no host view carries the graphs at scale.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time

import numpy as np
import torch

from ..engine.align_runner import DeviceAlignRunner
from ..engine.flat_rpgg import FlatRPGG
from ..engine.host_align import AlignConfig
from .scale_index import (ScaleThreadView, build_scale_bait,
                          build_scale_graph, build_scale_qc, build_scale_rpgg,
                          build_scale_tre, sample_read_batch, sim_titles)


def _busy_ms(events) -> float:
    """Union of the device intervals of the trace's kernels and copies."""
    iv = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                if e.get("ph") == "X"
                and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    busy, end = 0.0, -1.0
    for s, e in iv:
        if s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy / 1e3


def _time_calls(obj, name: str):
    """Wraps the method ``name`` of ``obj`` (when obj is not None) so the
    seconds its calls take are summed into the returned one-element
    list."""
    acc = [0.0]
    if obj is None:
        return acc
    call = getattr(obj, name)

    def timed(*a, **k):
        t0 = time.perf_counter()
        try:
            return call(*a, **k)
        finally:
            acc[0] += time.perf_counter() - t0

    setattr(obj, name, timed)
    return acc


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--nloci", type=int, default=80_000)
    ap.add_argument("--pairs", type=int, default=1 << 20)
    ap.add_argument("--seed", type=int, default=9)
    ap.add_argument("--out", default="build/profile")
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--threading", action="store_true")
    mode.add_argument("--okam", action="store_true")
    mode.add_argument("--sharded", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("profile_funnel needs a CUDA card")
    os.makedirs(args.out, exist_ok=True)
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    t0 = time.time()
    drp, seqs = build_scale_rpgg(args.nloci, 1500, seed=args.seed,
                                 verbose=False)
    view = sub_rate = None
    cfg = AlignConfig(ksize=21, cth=20, n_filter=4, nm_filter=1, okam=False)
    if args.threading:
        drp.graph_tab, _ = build_scale_graph(seqs, verbose=False)
        cfg = AlignConfig(ksize=21, cth=20, n_filter=4, nm_filter=1,
                          okam=False, threading=True, thread_cth=85,
                          maxncorrection=3)
        view, sub_rate = ScaleThreadView(seqs), 0.005
    if args.okam:
        drp.tre_tab, _ = build_scale_tre(seqs, verbose=False)
        drp.bait_tab, _ = build_scale_bait(seqs, seed=args.seed)
        drp.qc = build_scale_qc(args.nloci, seed=args.seed)
        cfg = AlignConfig(ksize=21, cth=20, n_filter=4, nm_filter=1,
                          okam=True, simmode=2, bait=True, qc=True,
                          output_bubbles=True)
        sub_rate = 0.005
    print(f"index nloci={args.nloci} built in {time.time() - t0:.1f}s "
          f"threading={args.threading} okam={args.okam}", flush=True)
    flat = None
    if not args.threading:
        t0 = time.time()
        flat = FlatRPGG.from_device_tables(drp)
        print(f"flat host view built in {time.time() - t0:.1f}s", flush=True)
    P, L = 4096, 160
    rng = np.random.default_rng(
        [args.seed, 3 if args.threading else 5 if args.okam else 1])
    if args.sharded:
        from ..parallel.runner import ShardedAlignRunner

        runner = ShardedAlignRunner(flat, cfg, batch_pairs=P,
                                    max_read_len=L, expand_cap=512,
                                    retry_expand=[4096], shard_index=True,
                                    drp=drp, device=dev)
    else:
        runner = DeviceAlignRunner(flat, cfg, batch_pairs=P,
                                   max_read_len=L, drp=drp, device=dev,
                                   thread_view=view)
    Pd = runner.dispatch_pairs(True)
    nbat = -(-args.pairs // Pd)
    batches = []
    for _ in range(nbat):
        c, r, li = sample_read_batch(seqs, Pd, L, rng, frac_tr=0.05,
                                     read_len=150, sub_rate=sub_rate or 0.0,
                                     with_loci=True)
        batches.append((c, r, Pd, sim_titles(li) if args.okam else None))
    runner.run_batches(batches, prefilter=True)         # warm-up
    engine_wait = _time_calls(runner.nthr, "thread_pairs")
    kam_s = _time_calls(runner, "_kam_device_row")
    bub_s = _time_calls(runner, "_add_bubbles_codes")
    merge_s = _time_calls(runner.bubbles, "flush_batch")
    torch.cuda.synchronize()
    steps0, ret0 = runner.n_steps, runner.n_retried
    res0, ref_s0 = runner.n_resolved, runner.referee_s
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.time()
        runner.run_batches(batches, prefilter=True)
        torch.cuda.synchronize()
        wall_ms = (time.time() - t0) * 1e3
    trace = os.path.join(args.out, "funnel_trace.json")
    prof.export_chrome_trace(trace)
    with open(trace) as f:
        events = json.load(f)["traceEvents"]
    busy = _busy_ms(events)
    per = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "kernel":
            name = e["name"].split("(")[0][:60]
            per[name] = per.get(name, 0.0) + e["dur"] / 1e3
    table = prof.key_averages().table(sort_by="cuda_time_total",
                                      row_limit=40)
    with open(os.path.join(args.out, "key_averages.txt"), "w") as f:
        f.write(table)
    print(f"funnel pairs={nbat * Pd} wall_ms={wall_ms:.3f} "
          f"device_busy_ms={busy:.3f} idle_share={1 - busy / wall_ms:.4f} "
          f"steps={runner.n_steps - steps0} dispatches={nbat} "
          f"retried={runner.n_retried - ret0} "
          f"referee_resolved={runner.n_resolved - res0} "
          f"referee_ms={(runner.referee_s - ref_s0) * 1e3:.3f} "
          f"engine_call_ms={engine_wait[0] * 1e3:.3f} "
          f"kam_row_ms={kam_s[0] * 1e3:.3f} bubble_insert_ms="
          f"{bub_s[0] * 1e3:.3f} bubble_merge_ms={merge_s[0] * 1e3:.3f}",
          flush=True)
    for name, ms in sorted(per.items(), key=lambda kv: -kv[1])[:20]:
        print(f"  {ms:10.3f} ms  {name}", flush=True)


if __name__ == "__main__":
    main()
