"""Observability: structured per-stage counters + torch profiler hooks
(replaces the reference's stderr prose logging and commented-out
gperftools hooks, SURVEY §5).

The device step already accumulates the read-funnel counters as a device
array (stats[0..8]); this module renders them and wraps profiling.
"""

from __future__ import annotations

import contextlib
import json
import sys
import time

import numpy as np

STAT_NAMES = [
    "nReads", "nShort(pairs)", "nSubFiltered", "nKmerFiltered",
    "nLocusAssignFiltered", "nThreadingReads", "nAsgnReads",
    "nQCFiltered", "nBaitFiltered",
]


def funnel_report(stats, host_stats: dict | None = None, out=sys.stderr):
    """Render the read-filter funnel (reference stderr summary,
    aQueryFasta_thread.cpp:2617-2627), merging device + host counters."""
    s = {name: int(v) for name, v in zip(STAT_NAMES, np.asarray(stats))}
    if host_stats:
        for k, v in host_stats.items():
            if k in s:
                s[k] += int(v)
            elif k == "nShort":
                s["nShort(pairs)"] += int(v)
    for k, v in s.items():
        print(f"{k}: {v}", file=out)
    return s


@contextlib.contextmanager
def stage_timer(name: str, log=None):
    t0 = time.time()
    yield
    dt = time.time() - t0
    rec = {"stage": name, "seconds": round(dt, 4)}
    print(json.dumps(rec), file=log or sys.stderr)


@contextlib.contextmanager
def device_trace(logdir: str):
    """torch.profiler trace of the block (view in TensorBoard's profiler
    plugin): host activity, and the card's kernels and copies when a card
    is present.  The trace is written to ``logdir`` as
    ``<worker>.<ns>.pt.trace.json`` when the block ends, also when it
    raises.  Yields the profiler."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(
        activities=acts,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(logdir))
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
