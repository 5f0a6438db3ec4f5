"""The bench's panel-funnel worker: one metric per process.

    python -m danbing_tk_tpu_torch.tools.bench_panel_funnel

Port of tools/bench_panel_funnel.py.  tools/bench.py (the orchestrator)
runs it as a subprocess under a hard timeout, so a slow build or a
contended host never takes the other metrics down with it.  It prints
exactly ONE JSON line on stdout the moment the metric is measured;
diagnostics go to stderr.

Panels (DTK_PF_PANEL):
  synthetic — the 512-locus random panel (tools/make_bench_rpgg.py) and a
              4,000,000-pair reads file (DTK_BENCH_E2E_PAIRS), 5% of the
              pairs from the haplotypes, 0.2%/base substitutions; metric
              ``wgs_funnel_reads_per_sec_per_chip`` (the bench's primary).
  real      — the real-VNTR-motif panel on an hg38 chr12 background.  It
              is built from danbing-tk's bundled test sequences, which are
              not in this repository: the worker exits non-zero and names
              them, and never falls back to the synthetic panel.

Measures the whole counting funnel of ``align --device --native-io
--prefilter -ka``: the native reader's ingest, the device prefilter, the
survivors' repack, the device step (and its retry tier), the exact host
referee.  A warm pass first, then up to DTK_PF_PASSES (5) timed passes,
each on a fresh runner that reuses the warm runner's steps; each timed
pass ends with a scalar read of the count state inside its window, so no
card work is left outside the clock.  With spread > 15% a fresh window
is run (up to 3).  Soft deadline: DTK_PF_DEADLINE_TS (absolute epoch
seconds), checked between passes: the worker reports with however many
passes fit (>= 1) and flags a short or spread window ``contaminated``.

The card is DTK_TORCH_DEVICE (default ``cuda``; without a card the worker
raises unless it is ``cpu``).  Panels, reads and their caches go under
DTK_BENCH_BUILD (default ``<repo>/build``).  Baseline: danbing-tk align
genotypes a 30x sample (~6.2e8 reads) in ~12 CPU-hours, ~14.35k reads/s
per core.
"""

from __future__ import annotations

import json
import os
import sys
import time

REF_READS_PER_SEC = 6.2e8 / (12 * 3600)  # ~14.35k reads/s/core
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
# the real panel's sources (tools/make_real_panel.py): danbing-tk's bundled
# haplotype slices and its hg38 chr12 background
REAL_PANEL_FILES = (
    "test/input/hg38.chr12.2155791.2356090.fasta",
    "test/input/HG00514.{0,1}.fa", "test/input/HG00733.{0,1}.fa",
    "test/QC/input/HG002.{0,1}.fa", "test/QC/input/hs1.{0,1}.fa")
REAL_PANEL_MISSING = (
    "the real-motif panel and the real hg38 chr12 background are built "
    "from danbing-tk's bundled test sequences (" + ", ".join(
        REAL_PANEL_FILES) + "), which are not in this repository")


# the stderr words before the JSON object of a timed pass's launches
LAUNCHES_TAG = "kernel launches of the last timed pass"


def build_dir() -> str:
    return os.environ.get("DTK_BENCH_BUILD") or os.path.join(ROOT, "build")


def worker_device():
    """The card the orchestrator passed (DTK_TORCH_DEVICE), resolved:
    raises without one unless the CPU was asked for."""
    from .._device import resolve_device

    return resolve_device(os.environ.get("DTK_TORCH_DEVICE") or "cuda")


def spread_of(times):
    s = sorted(times)
    med = s[len(s) // 2]
    return (s[-1] - s[0]) / med if med else 0.0


def deadline_left():
    ts = float(os.environ.get("DTK_PF_DEADLINE_TS", 0) or 0)
    return (ts - time.time()) if ts else float("inf")


def sink(al) -> int:
    """A device -> host dependency on the runner's count state: a scalar
    read that waits for every launch that wrote it."""
    return int(al.state["counts"].sum())


def measure_funnel(make_runner, reads, npairs, passes=5, max_rounds=3,
                   tol=0.15, tag=""):
    """Warm once (kernels loaded, tables uploaded), then run up to
    ``passes`` timed passes; on spread > tol re-run a fresh window
    (transient contention) up to max_rounds.  Respects the soft deadline
    between passes.  Prints the last pass's kernel launches (the counts
    set to 0 just before it, read just after) on stderr.  Returns
    (median_rate, times, warm_s, last_runner)."""
    from ..kernels import build

    al = make_runner(None)
    print(f"# {tag}: runner built (tables uploaded); warm pass "
          f"starting", file=sys.stderr, flush=True)
    t0 = time.time()
    al.run_file_native(reads, prefilter=True)
    sink(al)
    warm = time.time() - t0
    print(f"# {tag}: warm pass (incl kernel load) {warm:.1f}s",
          file=sys.stderr, flush=True)
    times, al2, launches = [], al, {}
    for rnd in range(max_rounds):
        times = []
        for _ in range(passes):
            al2 = make_runner(al)
            build.reset_launch_counts()
            t0 = time.time()
            al2.run_file_native(reads, prefilter=True)
            sink(al2)
            times.append(time.time() - t0)
            launches = {k: v for k, v in build.launch_counts().items()
                        if v}
            # leave room for one more pass of the same cost (+10%)
            if times and deadline_left() < 1.2 * max(times):
                break
        if spread_of(times) <= tol or rnd + 1 >= max_rounds:
            break
        if deadline_left() < 1.2 * passes * max(times):
            break  # no budget for another window; report what we have
        print(f"# {tag}: spread {100*spread_of(times):.1f}% > "
              f"{100*tol:.0f}% on {[round(t,1) for t in times]} — "
              f"re-running window {rnd+2}/{max_rounds}", file=sys.stderr,
              flush=True)
    med = sorted(times)[len(times) // 2]
    rate = 2 * npairs / med
    print(f"# {tag}: {med:.1f}s steady median of "
          f"{[round(t, 1) for t in times]} "
          f"(spread {100*spread_of(times):.1f}%, {warm:.1f}s warm) "
          f"prefiltered={al2.n_prefiltered}/{npairs} "
          f"referee={al2.n_referee} retried={al2.n_retried} "
          f"reasons={al2.referee_reasons}",
          file=sys.stderr, flush=True)
    print(f"# {tag}: {LAUNCHES_TAG} {json.dumps(launches)}",
          file=sys.stderr, flush=True)
    return rate, times, warm, al2


def result_line(metric: str, rate: float, times: list) -> dict:
    """The worker's JSON line: the rate, its spread and passes, and
    ``contaminated`` where the window is short (< 3 passes) or spread
    (> 15%)."""
    m = {
        "metric": metric,
        "value": round(rate, 1),
        "unit": "reads/s",
        "vs_baseline": round(rate / REF_READS_PER_SEC, 3),
        "spread": round(spread_of(times), 4),
        "passes": len(times),
    }
    if spread_of(times) > 0.15 or len(times) < 3:
        m["contaminated"] = True
    return m


def panel_data(nloci: int, npairs: int) -> tuple:
    """The synthetic panel (tools/make_bench_rpgg.py) and its reads file
    (5% of the pairs from hap0, 0.2%/base substitutions) under
    build_dir(), each built once and cached; returns (pan, reads)."""
    from ..apps.fa2kmers import read_fasta_seqs
    from .bench_e2e import synth_reads
    from .make_bench_rpgg import build

    t0 = time.time()
    pan = build(os.path.join(
        build_dir(), f"bench_rpgg{'' if nloci == 512 else nloci}"), nloci)
    print(f"# [synthetic] panel ready ({time.time()-t0:.1f}s)",
          file=sys.stderr, flush=True)
    reads = os.path.join(os.path.dirname(pan),
                         f"e2e_v2_{npairs}_0.05_0.002.fa")
    t0 = time.time()
    if not os.path.exists(reads):
        seqs = read_fasta_seqs(os.path.join(os.path.dirname(pan),
                                            "hap0.fa"))
        synth_reads(reads, npairs, 0.05, seqs, L=150, err=0.002)
    print(f"# [synthetic] reads file ready: {npairs} pairs "
          f"({time.time()-t0:.1f}s)", file=sys.stderr, flush=True)
    return pan, reads


def main(argv=None):
    """Runs the worker; returns the last timed pass's runner.  With
    ``--prepare`` it only builds the panel and the reads file (no card
    work) and returns None."""
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--prepare", action="store_true",
                    help="build the synthetic panel and its reads file "
                         "under DTK_BENCH_BUILD, then exit")
    args = ap.parse_args(argv)
    panel = os.environ.get("DTK_PF_PANEL", "synthetic")
    if panel == "real":
        sys.exit(f"bench_panel_funnel: DTK_PF_PANEL=real: "
                 f"{REAL_PANEL_MISSING}")
    if panel != "synthetic":
        sys.exit(f"bench_panel_funnel: unknown DTK_PF_PANEL={panel!r}")
    nloci = int(os.environ.get("DTK_BENCH_NLOCI", 512))
    npairs = int(os.environ.get("DTK_BENCH_E2E_PAIRS", 4_000_000))
    if args.prepare:
        panel_data(nloci, npairs)
        return None
    dev = worker_device()

    from ..utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    from ..engine.align_runner import DeviceAlignRunner
    from ..engine.host_align import AlignConfig, RPGG

    P = int(os.environ.get("DTK_PF_P", 4096))
    passes = int(os.environ.get("DTK_PF_PASSES", 5))
    pan, reads = panel_data(nloci, npairs)
    # split expansion is the engine default; E only holds multi-locus
    # expansions, so 192 covers the panel's odd demand (p99 = 65) with 3x
    # margin; the [1024] retry tier is a lazy guard
    E = int(os.environ.get("DTK_PF_E", 192))
    retry = [int(x) for x in os.environ.get(
        "DTK_PF_RETRY", str(max(4 * E, 1024))).split(",")
        if x and int(x)]
    metric = "wgs_funnel_reads_per_sec_per_chip"

    t0 = time.time()
    rpgg = RPGG(pan)
    print(f"# [{panel}] RPGG loaded ({time.time()-t0:.1f}s)",
          file=sys.stderr, flush=True)
    cfg = AlignConfig(ksize=21, cth=20, n_filter=4, nm_filter=1,
                      okam=False)

    def mk(prev):
        al = DeviceAlignRunner(rpgg, cfg, batch_pairs=P,
                               max_read_len=160, expand_cap=E,
                               retry_expand=retry, device=dev,
                               drp=None if prev is None else prev.drp)
        if prev is not None:
            al.step = prev.step
            al.retry_steps = prev.retry_steps
            al.prefilter_step = prev.prefilter_step
            al.prefilter_P = prev.prefilter_P
        return al

    rate, times, warm, al = measure_funnel(
        mk, reads, npairs, passes=passes, tag=f"{panel}-panel funnel e2e")
    print(json.dumps(result_line(metric, rate, times)), flush=True)
    return al


if __name__ == "__main__":
    main()
