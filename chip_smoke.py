#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (danbing_tk_tpu_torch) on one card.

    python3 chip_smoke.py [--nloci N] [--pairs N] [--seed S]

Phases; any failure exits non-zero (nothing is caught and continued):
  1. environment: torch / CUDA / nvcc versions, the card and its power
     limit, the host's MemTotal and MemAvailable
  2. build through the code ``warmup`` runs (utils/compile_cache.py's
     enable_compile_cache, kernels/build.py's build_all): the twelve CUDA
     kernel sources (nvcc, -Xptxas -v) and the host runtime, threading and
     referee engines (g++), all compilers at once, each library's seconds;
     then the synthetic production-size index
     (danbing_tk_tpu_torch/tools/scale_index.py), and beside it, in a
     thread joined before phase 3, phase 6's graph table and phase 7's
     tre table (host arrays until their phases upload them)
  3. first, phase 5's flat view and ``warmup``'s step pass
     (align_runner.warmup_steps) on the scale index in counting mode: the
     full step (P = 4096, L = 160, E = 512), the retry tier (E = 4096) and
     the prefilter dispatch (4P), each step's first-call ms beside its warm
     ms, the runner's state zero afterwards; then
     every kernel of the counting step against its plain torch version on
     the same inputs at the main path's shapes (P = 4096 pairs, L = 160,
     k = 21, E = 512, prefilter dispatch 4P), on the production-size
     index: KA (the counting instance the step launches, and the
     all-planes instance), KB (dbi, member, trfl), KC, KD with KM's tail
     (the per-pair tail and read statistics, run where KD's mates meet:
     hf, counted, dest and the nine counters) and KL (the sub/k-filter,
     a block of 8 pairs staged in shared memory) replayed on the step's
     captured inputs, KK's
     sample-only instance (KK[sample], the fused launch's staged front
     end) on the prefilter dispatch's reads (its queries also equal to
     the host sampler's; window and CUDA-graph replay), KK's fused launch
     (sample, member probe and decision) on the same reads, with its
     bound from the rows it reads (engine/device_align.py
     prefilter_fused_work), and KK[q] (the probe and decision over the
     host sampler's queries of the same reads: its survivors = the fused
     launch's); KL's, KD's (with and without the tail: what the tail
     adds), KK's and KK[q]'s
     CUDA-graph replays beside their windows, and the device-sampled
     dispatch's survivors equal to the host-sampled one's; exact
     equality required; CUDA-event times of kernel and plain version
     (median of 10 windows of 10 back-to-back calls); KC's live entries
     and live events per pair (mean, p99, max)
  4. golden end to end on cuda through the CLI: ``align --device
     --native-io --prefilter -ka`` (.trkmc.ar byte-equal) and the
     threading run ``-s 2 -gc 50 3 -a -on`` (.aln and .tr.kmers
     byte-equal, no .tr.summary.txt); every kernel launched
 4b. golden on cuda through the CLI's Python ingest (``align --device``
     with neither --native-io nor --prefilter: DeviceAlignRunner.run_file):
     -e 2 and -fq -s 2 -e 1 (rows on stdout), -ka (.trkmc.ar,
     .tr.summary.txt), the default okam (.kam) and -ka --checkpoint, and a
     checkpointed run_file stopped after five steps and resumed, all
     byte-equal; KA-KD launched in every run
  4c. RPGG construction and bait QC on cuda through the CLI: (a) the
     tests/golden_qc stages 3-8 from its frozen *.annot.fa (extract -e 1,
     raw map -s 2, baitbuilder v1.pf and v2, ktools serialize-bt, bait
     map -b), every file byte-equal to tests/golden_qc/; (b) a seeded
     scenario (danbing_tk_tpu_torch/tools/build_scenario.py: 256 loci in 2
     genomes, k = 21, FS = 700, TRWINDOW = 800, 64 decoys a haplotype of
     the control genome) built with ``build --paf --prune-reads -p 2
     --device`` and QC'd with ``qc --device``, each of its 7 align calls
     run again on the host engine (stdout and files byte-equal), in one
     worker process started after phase 2's kernel build and joined
     before phase 3 (it runs beside the scale index build, and no kernel
     window is taken while it runs); FPSkmer non-empty and the bait map
     dropping the control genome's decoy pairs; each stage's seconds
     (host stages and align calls apart, with the pairs each align call
     took and its host engine's seconds), the launches of the build
     (KA-KE) and the qc (KA-KD, KF)
 4d. the downstream analyses on cuda through the CLI, in this process
     after 4b: (a) ``align --device --native-io --prefilter -ka -bu -on``
     of tests/golden_analysis/reads.fa.gz (4,442 read pairs over the golden
     panel's 24 loci with planted substitutions,
     danbing_tk_tpu_torch/tools/analysis_scenario.py), .tr.kmers and
     .bub.kmdb byte-equal to the JAX package's, KA-KD and KG launched;
     the .bub text and count-only file; ``ktools raava`` byte-equal; and
     ``call --torch-device cuda`` with the golden sklearn SVM pickles,
     again with the 3-class mc.svm as the bubble-path model, and with the
     stratified and the uniform DummyClassifier pickles as both models
     (labels drawn on the host from their random states), each callset
     equal to the JAX package's; (b) ``length`` byte-equal and
     ``eqtl`` (over the committed raw genotype cache) with its non-float
     fields equal and its %.4e fields within one unit of the last digit,
     numpy's and scipy's versions printed; (c) the golden SVMs (br and bp,
     11 and 49 support vectors: not a production model's; mc, 3 classes,
     1,280) on 100,000 seeded rows each, on cuda: labels equal to
     sklearn's committed labels and to the CPU's, the largest difference
     of the one-vs-one decisions and ms; each step's seconds
 4e. ``python -m danbing_tk_tpu_torch warmup`` on cuda over the golden
     panel (P = 4096, L = 160, --prefilter, --retry-expand 4096), in -ka
     and okam (-b -qc -bu -fq) form, two processes at once: exit 0, every
     library reported cached (phase 2 built them), the JAX command's
     lines printed; the phase's seconds
 5. the production-size counting funnel: >= 1M read pairs (5% from the
     TR pool, 95% random background, 150 bp in L = 160 rows) through the
     host-sampled prefilter, survivor repack and the full step; flagged
     pairs are resolved by the pooled native referee over the flat host
     view of the index (engine/flat_rpgg.py, built from the device tables
     before the run: its build seconds, the referee's seconds and the
     resolved pairs are printed, resolved = flagged); then the first 256
     flagged pairs through the native referee and the Python HostAligner
     on two fresh copies of the view (okam): counts, stats and .kam rows
     equal; then the same batches again with DTK_PREFILTER_HOSTQ=0 (the
     prefilter uploads the code rows and KK's fused launch samples,
     probes and decides) over a fresh copy of the view: every dispatch's
     survivor mask, the count state and the referee's pairs and host
     counts equal to the first pass's, one KK launch a dispatch (one
     KK[q] a dispatch in the first pass) and no KB launch on the member
     table in either, reads/s of both, and the first 8 dispatches'
     prefilter split (host-sampled: native sampler + query upload +
     KK[q]; device-sampled: code upload + KK's fused launch)
 5b. the Python ingest at full width: phase 5's first 65,536 pairs as a
     FASTA file through run_file (-ka) and run_file_native (prefilter),
     each over a fresh copy of phase 5's flat view: equal counts, resolved
     = flagged in each, reads/s of both and their referee seconds; then
     -e 2 through run_file on the first 512 pairs, rows equal to the
     HostAligner's over the flat view
 5s. the sharded funnel on a world-1 NCCL group: (a) the golden funnel
     through ShardedAlignRunner (index sharded, E = 128 -> 512,
     checkpoints every 64 pairs), a run stopped after three prefilter
     dispatches and resumed, and the CLI with --retry-expand 512
     --checkpoint, all byte-equal; (b) KI on D = 4 row-block views of the
     scale index's dbi, trfl and member tables at the main path's query
     shapes, each block against its plain version and the blocks' sum
     against KB (non-EMPTY queries), CUDA-event times, and KI at D = 1
     (every row owned) against KB on the same queries, timed in turns
     beside it; (c) KC's large-E
     mode (E = 4096, P = _tier_P(4096) = 2048 overflow pairs of the TR
     pool; 512 threads a pair, the tables in shared memory) against
     pair_vote_plain, with what sets its work (live entries and events
     per pair); (d) phase 5's batches through ShardedAlignRunner
     (shard_index, E = 512 -> [4096]; its prefilter samples on the card
     with KK[sample], for KI[count]'s collective probe) over a fresh copy
     of phase 5's flat view: reads/s, retried
     pairs, the referee share beside phase 5's and
     its resolved pairs, the collectives' ms per step, peak memory; KI and
     KC[large-E] launched, KI's launches by table (dbi and trfl), one
     KK[sample], KI[count] and KL[decide] a prefilter dispatch; then on
     phase 3's dispatch reads (KK[sample]'s queries) KI[count] against
     its plain version at D = 1 and on 4 row blocks summed (= D = 1 = the
     collective's count), KL[decide] on the summed counts and nk against
     its plain version and KK[q]'s survivors, each timed (window and
     CUDA-graph replay), and the collective dispatch's window with its
     reduce_scatter bytes
  6. the production-size threading funnel (-gc 85 3): the index's graph
     table (the fa2kmers -g rule over the loci's sequences), built on the
     host in phase 2 and uploaded only now, so the counting phases never
     hold it on the card; the
     threading step's KD (threading mode) and KE (the graph probe, the
     walk, the count scatter and KM's tail in one launch) against their plain
     versions as in phase 3, on TR pairs with 0.5% substitutions, and KB
     on the graph table at the walk's (nc, dst0) queries (the step no
     longer launches it);
     then >= 1M pairs, 5% from the TR pool with 0.5% substitutions, through
     prefilter, full step and KE; pairs whose walk is not clean go to the
     batched native engine through a host view of the loci's graphs (test
     data, built for the pool fragments' loci before the timed run);
     referee'd pairs are counted, not resolved: no host view carries the
     locus graphs at scale, in either package
 6c. the error-correction site scorer on the same graph table: B = 8192
     failure sites (a TR mate's first k-mer that is no out-neighbour of
     the node before it in its source locus's graph) from phase 6's
     funnel pairs, scored through make_site_scorer (KJ launched); KJ
     against its plain version (exact) and both against the host oracle
     score_site_np on the first 256 sites (same counters and edit
     decisions); CUDA-event ms, us per site, the probes the counters need
     per site beside JAX's 21 + 62k and those KJ's lookahead makes, and
     the bound of the graph rows the needed probes read under the level
     stop
  7. okam, bait, QC and bubbles: (a) the golden CLI on cuda with .kam
     output (the default) and -bu, with -fq -b -s 2 and with -qc -s 2, all
     outputs byte-equal, KF and KG launched; (b) after the graph table's
     device copy is dropped, the index's tre table (the fa2kmers tre
     rule, built on the host in phase 2), a bait table of 64 of each locus's own k-mers and a QC mask
     failing 5% of the loci; KF (bait, and its QC-only instance), KG and
     KD with the ann plane against
     their plain versions as in phase 3, on TR pairs with 0.5%
     substitutions; (c) >= 1M pairs through the okam funnel (-s 2 -b -qc
     -bu, simmode-2 titles, 5% TR pool with 0.5% substitutions): .kam
     rows, bubble maps at the reference's flush cadence; referee'd pairs
     resolved by the Python HostAligner (-bu has no native referee) over
     phase 5's flat view renewed with the tre sets, bait maps and QC mask
  8. pred (danbing-tk's bias correction), once phases 2-7 have released
     the card: (a) the golden cohort (the six non-empty
     tests/golden/out*.trkmc.ar, pan.tr.ksi, invariant k-mers from the
     seed) through ``pred`` on cuda, all three files byte-equal to the host
     oracle (the numpy bias_correction_np), KH launched; (b) KH against
     its plain version on the card at ns = 32 x nk = 120M
     (danbing_tk_tpu_torch/tools/scale_pred.py; 15.36 GB a copy, offsets
     past 2^31), bit-equal as u32 views, CUDA-event ms, bound and peak
     memory; (c) the ``pred`` CLI through files at ns = 8, full nk
     (failing when the temp disk cannot hold 8 samples' inputs and
     outputs), byte-equal to the host oracle, with each span's seconds and
     the device's share of the wall
  8d. ``python -m danbing_tk_tpu_torch bench`` as a subprocess on the
     card at the primary metric's shapes with 262,144 pairs
     (DTK_BENCH_E2E_PAIRS=262144 DTK_PF_PASSES=3 DTK_BENCH_SCALE=0, the
     quiesce wait cut to 5 s): exit 0, the last stdout line the primary
     metric (wgs_funnel_reads_per_sec_per_chip) with a value above 0 and
     passes >= 1, the real-panel skip line on stderr; the 512-locus panel
     and its reads file are built by ``bench_panel_funnel --prepare`` in a
     worker process started after phase 2's kernel build (beside the scale
     index build, joined here); the line, the worker's warm and timed
     passes, and the phase's seconds; its last timed pass's launches are
     the ``bench`` path of phase 9
  8f. the genome-wide geometry, once phase 7's tables are freed
     (danbing_tk_tpu_torch/tools/full_index_probe.py, in this process):
     the full index's dbi level 0 (2^28 buckets of 8 slots x W = 4 u32,
     34,359,738,368 B) holding build_full_tables's own k-mers of 285 of
     its 80,000 loci (whole families, the last locus among them) at
     build_bucket_table's hash and rank, every other slot EMPTY, uploaded
     through DevTable.upload's pinned chunks (its seconds and GB/s);
     locus_offsets of ~15,000 slots a locus, so the count state holds
     1,199,999,646 slots; then, on a world-1 NCCL group, KB over 65,536
     hit and miss queries, KI over 1 and 4 row blocks and the collective
     probe, each = the host lookup; the prefilter over 16,384 pairs three
     ways (KK[q], KK, and KK[sample] -> KI[count] -> KL[decide]), each =
     the host's decisions; the counting step (P = 4096) over reads of
     the planted loci, whose state = the same step's over a compact
     index of the same entries, with counts in slots past 2^30 (byte
     offsets past 4 GiB); then each kernel replayed against its plain
     version (exact) and timed beside its bound (distinct 128-B rows
     over 3.35 TB/s) and its scale-index time; peak device memory; the
     launches of the driven run are the ``full_geometry`` path of
     phase 9
  9. the kernels line (JSON): KA-KM (KK: the fused prefilter launch; KM
     fused in KD / KE, its source csrc/step_tail.cuh), KC's
     large-E instance, KK's host-sampled (KK[q]) and sample-only
     instances, KI's count instance (KI[count]) and KL's prefilter
     decision (KL[decide]); KL's launches
     and KM's tails equal KA's on every path (a step runs each once), KM's
     equal KD's, KE none in counting and okam, KM's = KE's in threading
     (no path launches a standalone KM); each
     kernel's ``launches`` is the sum over its paths' runs (per path in
     ``launches_by_path``: phase 3's warmup pass (``warmup``), the
     counting funnel's two passes (``counting``, host-sampled prefilter,
     and ``counting_device_sampled``), the sharded, threading and okam
     funnel runs, the site scorer's run, phase 5b's run_file and phase
     4c's device build (``build_prune``) and qc (``qc``), phase 4d's align
     -bu run (``analysis``), phase 8d's last timed pass (``bench``,
     read in its worker process), phase 8f's driven run
     (``full_geometry``), and for KH the
     pred file run), the counts set to 0 just before each run and read
     just after it (4c (b)'s in its worker process)
 10. the last line: {"ok": true, "device": {...}}

Needs a CUDA card; exits 1 without one, or without the package beside it.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
# the counting path's kernels
COUNTING = ("KA", "KB", "KL", "KC", "KD", "KM")
THREADING = COUNTING + ("KE",)
OKAM = COUNTING + ("KF", "KG")          # -b -qc -bu adds KF and KG
SHARDED = ("KA", "KL", "KC", "KD", "KM", "KI", "KI[count]", "KK[sample]",
           "KL[decide]")            # shard_index: KI in place of KB,
                                    # queries by KK[sample], KI[count]'s
                                    # hit counts, KL[decide]
BUILD_PRUNE = THREADING                 # build's align -g (run_file)
QC = COUNTING + ("KF",)                 # qc's -e 1, -s 2 and -b maps
BQ_NLOCI, BQ_COV, BQ_PROCS = 256, 2, 2  # phase 4c (b)'s scenario and run
BENCH_PAIRS = 262_144                   # phase 8d's reads file


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def cuda_ms(fn, n: int = 10, reps: int = 10, warm: int = 3) -> float:
    """Milliseconds per fn() call: the median over n CUDA-event windows of
    reps back-to-back calls after warm-up.  A window of one call would
    also time the wrapper's host work before its launch, which is longer
    than a short kernel."""
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
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
    ts.sort()
    return ts[len(ts) // 2]


def vote_work_line(kc_args, E: int) -> str:
    """What sets KC's work on these inputs: live entries and live events
    per pair (tools/ab_vote_probe.vote_work)."""
    from danbing_tk_tpu_torch.tools.ab_vote_probe import vote_work

    kmer, val, use, _, vv = kc_args[:5]
    w = vote_work(kmer, use, val, vv, E)
    return " ".join(f"live_{k}/pair mean={v['mean']:.2f} p99={v['p99']:.0f} "
                    f"max={v['max']:.0f}" for k, v in w.items())


def max_abs_err(a, b) -> int:
    """Largest |a - b| over matching tensors (tuples / dicts of them;
    tools/kernel_bounds.max_abs_err); a shape mismatch fails the run."""
    from danbing_tk_tpu_torch.tools.kernel_bounds import max_abs_err as err

    try:
        return err(a, b)
    except AssertionError as e:
        fail(f"shape mismatch: {e}")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--nloci", type=int, default=80_000)
    ap.add_argument("--pairs", type=int, default=1 << 20)
    ap.add_argument("--seed", type=int, default=9)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: the smoke run needs a card", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(ROOT, "danbing_tk_tpu_torch")):
        print("danbing_tk_tpu_torch/ is not beside chip_smoke.py",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)

    t_start = time.time()
    # ---- 1. environment ----
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    log(f"[1] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {kind}")
    from danbing_tk_tpu_torch.kernels import build

    nv = subprocess.run([build.nvcc_path(), "--version"],
                        capture_output=True, text=True).stdout.strip(
                        ).splitlines()
    log(f"[1] nvcc: {nv[-1] if nv else '?'}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"[1] card: {smi}")
    with open("/proc/meminfo") as f:
        mem = dict(ln.split(":", 1) for ln in f if ":" in ln)
    log(f"[1] host memory: MemTotal {mem['MemTotal'].strip()}, "
        f"MemAvailable {mem['MemAvailable'].strip()}")

    # ---- 2. build, through warmup's code ----
    from danbing_tk_tpu_torch.utils.compile_cache import enable_compile_cache

    t0 = time.time()
    enable_compile_cache()
    libs = build.build_all()
    log(f"[2] libraries built by build_all in {time.time() - t0:.2f}s "
        f"into {build.BUILD_ROOT}: " + ", ".join(
            f"{n} {'cached' if c else f'{s:.2f}s'}"
            for n, (s, c) in libs.items()))
    for name, out in build.build_logs.items():
        for line in out.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[2] {name}: {line.strip()}")

    bq = start_build_qc()
    bd = start_bench_data()
    try:
        return run_phases(args, dev, kind, smi, t_start, bq, bd)
    finally:
        import shutil

        for w in (bq, bd):
            if w["proc"].poll() is None:
                w["proc"].kill()
                w["proc"].wait()
            shutil.rmtree(w["root"], ignore_errors=True)


def run_phases(args, dev, kind, smi, t_start, bq, bd) -> int:
    """Phases 2 (scale index) to 10."""
    import gc

    import torch

    res = align_phases(args, dev, smi, bq)
    # ---- 8. pred ----
    # every device tensor of phases 2-7 died with align_phases
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[8] device memory held after phase 7: "
        f"{torch.cuda.memory_allocated()} B")
    kh, kh_launches = pred_phase(args.seed, dev)
    # ---- 8d. the bench command ----
    gc.collect()
    torch.cuda.empty_cache()
    res["bench_launches"] = bench_phase(bd, smi)
    # ---- 8f. the genome-wide geometry ----
    gc.collect()
    torch.cuda.empty_cache()
    res["geo_launches"] = geometry_phase(dev, smi, res["results"])
    return finish(res, kh, kh_launches, kind, smi, t_start)


def align_phases(args, dev, smi: str, bq: dict) -> dict:
    """Phases 2 (scale index) to 7; returns the kernel results and the
    launch counts of every path."""
    import numpy as np
    import torch

    from danbing_tk_tpu_torch.engine import device_align as da
    from danbing_tk_tpu_torch.engine.align_runner import DeviceAlignRunner
    from danbing_tk_tpu_torch.engine.flat_rpgg import FlatRPGG
    from danbing_tk_tpu_torch.engine.host_align import AlignConfig
    from danbing_tk_tpu_torch.index import device_table as dt
    from danbing_tk_tpu_torch.io.native_reader import sample_queries
    from danbing_tk_tpu_torch.kernels import build
    from danbing_tk_tpu_torch.ops import kmers as km
    from danbing_tk_tpu_torch.tools import kernel_bounds as kbd
    from danbing_tk_tpu_torch.tools.ab_kmers_filter import GRAPH, graph_of
    from danbing_tk_tpu_torch.tools.scale_index import (
        ScaleThreadView, build_scale_bait, build_scale_qc, build_scale_rpgg,
        sample_read_batch, sim_titles)

    tables = start_table_builds(args.nloci, args.seed)
    t0 = time.time()
    drp, seqs = build_scale_rpgg(args.nloci, 1500, seed=args.seed,
                                 verbose=False)
    t_index = time.time() - t0
    t0 = time.time()
    tabs = drp.tables(dev)
    torch.cuda.synchronize()
    t_upload = time.time() - t0
    tab_bytes = sum(t.nbytes for t in (drp.dbi_tab, drp.member_tab,
                                       drp.trfl_tab))
    log(f"[2] scale index: nloci={args.nloci} kmers/locus=1500 "
        f"slots={drp.nslots} dbi_keys_levels={len(drp.dbi_tab.levels)} "
        f"tables={tab_bytes / 1e9:.3f} GB vv={len(drp.vv)} "
        f"build={t_index:.1f}s upload={t_upload:.1f}s")
    # ---- 4c (b) and the graph and tre tables, joined before any kernel
    # window ----
    bq_launches = finish_build_qc(bq, smi)
    finish_table_builds(tables)

    # ---- 3. kernels against their plain versions ----
    P, L, E, k, RL = 4096, 160, 512, 21, 150
    SUB = 0.005           # per-base substitutions of the threading reads
    Pp = 4 * P
    NKW = L - k + 1
    cfg = AlignConfig(ksize=k, cth=20, n_filter=4, nm_filter=1, okam=False)
    # the referee's host view of phases 5-7 (the flat arrays of the device
    # tables), built first: the warmup pass's runner needs one
    t0 = time.time()
    flat = FlatRPGG.from_device_tables(drp)
    t_flat = time.time() - t0
    wlaunches = warmup_pass(drp, flat, cfg, P, L, E, dev, smi)
    # reads draw from their own stream: the index's sequences came from
    # default_rng(seed), and the same stream would copy them into the
    # "random" background
    rng = np.random.default_rng([args.seed, 1])
    # a full step sees prefilter survivors: TR-pool pairs
    codes, rlen = sample_read_batch(seqs, P, L, rng, frac_tr=1.0,
                                    read_len=RL)
    cap: dict = {}
    step = da.make_step(drp, cfg, P, L, expand_cap=E, device=dev,
                        capture=cap)
    scratch = da.init_state(drp, dev)
    live = np.ones(P, dtype=bool)
    codes_d = torch.from_numpy(codes).to(dev)
    rlen_d = torch.from_numpy(rlen).to(dev)
    live_d = torch.from_numpy(live).to(dev)
    step(scratch, codes_d, rlen_d, live_d)
    torch.cuda.synchronize()
    pbatch, prlen = sample_read_batch(seqs, Pp, L, rng, frac_tr=0.05,
                                      read_len=RL)
    qlo, qhi, qvalid, qnon = sample_queries(pbatch, prlen, k, 4)
    q_mem = torch.from_numpy(da.query_int64(qlo, qhi)).to(dev)

    def compare(name, kern, plain, bound_bytes, extra="", phase=3):
        """Holds kern() against plain() (exact), then times both."""
        err = max_abs_err(kern(), plain())
        torch.cuda.synchronize()
        if err != 0:
            fail(f"{name} disagrees with its plain version (max |err| "
                 f"{err})")
        ms, plain_ms = cuda_ms(kern), cuda_ms(plain)
        bound = kbd.bound_ms(bound_bytes)
        log(f"[{phase}] {name} match=True max_abs_err={err} ms={ms:.4f} "
            f"plain_ms={plain_ms:.4f} bound_ms={bound:.4f} {extra}")
        return dict(match=True, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                    bound_ms=bound, bound_by="bytes", library_ms=None)

    def ke_bytes(graph, nc, dst0, kvalid, nk, dev_pair, tr_member, slot,
                 clean_pair, n_slots):
        """Bytes this data makes KE move.  A mate of a device-resolved
        pair is walked up to its first failure and the position after it
        (its nc for the edge check), or over all its in-read positions
        when clean: 9 B each (nc, kvalid); its valid positions up to the
        failure are probed, and the distinct graph rows they read at the
        levels they need (the level stop) are read once.  Other mates need
        none (dev_pair alone decides them).  A pair that walks clean reads
        tr_member (1 B) at each in-read position and the slot (8 B) at
        each TR member.  Plus nk and dev_pair in, dst0 for each walked
        mate, clean and clean_pair out, and 8 B per distinct slot written,
        trash slot included.  Returns (bytes, walked positions, counted
        positions, distinct graph rows)."""
        R, NKW = nc.shape
        nin = nk.long().clamp(0, NKW)
        inr = torch.arange(NKW, device=nc.device) < nin[:, None]
        loc = dst0.repeat_interleave(2)[:, None].expand(-1, NKW)
        gfound, gmask, _ = dt.lookup_bucket_plain(graph, nc, loc)
        bad = ~kvalid | ~gfound
        bad[:, 1:] |= nc[:, 1:] == nc[:, :-1]
        bad[:, :-1] |= (((gmask[:, :-1] >> (nc[:, 1:] & 3)) & 1) == 0) \
            & inr[:, 1:]
        bad &= inr
        first = torch.where(bad.any(1), bad.int().argmax(1), nin)
        walk_r = dev_pair.repeat_interleave(2) & (nk > 0)
        upto = torch.minimum(first + 2, nin)
        walked = int(torch.where(walk_r, upto, 0).sum())
        probed = (walk_r[:, None] & kvalid & inr
                  & (torch.arange(NKW, device=nc.device)
                     <= first[:, None]))
        _, rows, _ = kbd.probe_bytes(graph, nc[probed], loc[probed],
                                     stop=True)
        thr_r = (dev_pair & clean_pair).repeat_interleave(2)
        members = int(torch.where(thr_r, nin, 0).sum())
        counted = int(((tr_member != 0) & inr & thr_r[:, None]).sum())
        return (9 * walked + rows * 8 * graph.W * 4 + members + 8 * counted
                + R * (4 + 1) + 8 * int(walk_r.sum()) + R // 2 * 2
                + 8 * (n_slots + 1)), walked, counted, rows

    B = 2 * P
    # KA's counting instance (what the counting step launches: kmer,
    # kvalid, nk, any_valid) and its all-planes instance (nc for
    # threading, the edges for bubbles)
    ka_c, ka_r, _, ka_nc, ka_edges = cap["KA"]
    if ka_nc or ka_edges:
        fail(f"the counting step asked KA for nc={ka_nc} edges={ka_edges}")
    ka = compare("KA extract_kmers[counting]",
                 lambda: km.extract_kmers(ka_c, ka_r, k, False, False),
                 lambda: km.extract_kmers_plain(ka_c, ka_r, k, False, False),
                 kbd.ka_bytes(B, L, k),
                 f"shape=({B},{L}) launch={km.kmers_launch(B, L)} "
                 f"launches/step=1")
    compare("KA extract_kmers[all-planes]",
            lambda: km.extract_kmers(ka_c, ka_r, k),
            lambda: km.extract_kmers_plain(ka_c, ka_r, k),
            kbd.ka_bytes(B, L, k, all_planes=True),
            f"shape=({B},{L}) launches/step=1 with -bu and threading")
    kb = {}
    mtab = tabs["member"]
    for tname, (tab, q, loc) in (
            ("dbi", cap["KB_dbi"] + (None,)), ("member", (mtab, q_mem, None)),
            ("trfl", cap["KB_trfl"])):
        nbytes, rows, reads = kbd.probe_bytes(tab, q, loc)
        kb[tname] = compare(
            f"KB bucket_lookup[{tname}]",
            lambda tab=tab, q=q, loc=loc: dt.lookup_bucket(tab, q, loc),
            lambda tab=tab, q=q, loc=loc: dt.lookup_bucket_plain(tab, q, loc),
            nbytes, f"queries={q.numel()} distinct_rows={rows} "
            f"row_reads={reads} launches/step="
            f"{'1 per prefilter dispatch' if tname == 'member' else 1}")
    kc_args = cap["KC"]
    kc = compare("KC pair_vote", lambda: da.pair_vote(*kc_args),
                 lambda: da.pair_vote_plain(*kc_args),
                 kbd.kc_bytes(P, NKW),
                 f"P={P} W={2 * NKW} E={E} mode="
                 f"{da.check_vote_shape(2 * NKW, E)} smem_bytes="
                 f"{da.kc_smem_bytes(2 * NKW, E)} launches/step=1")
    log(f"[3] KC work: {vote_work_line(kc_args, E)}")
    # KD with KM's tail (the counting step's launch: hf, counted, dest and
    # the nine read statistics where the mates meet) on the step's
    # captured inputs
    kd_args = cap["KD"]
    tail = kd_args[-1]
    if tail is None:
        fail("the counting step launched KD without KM's tail")
    st_k = da.init_state(drp, dev)
    st_p = da.init_state(drp, dev)
    a_k = da.assign_count(st_k, *kd_args)
    a_p = da.assign_count_plain(st_p, *kd_args)
    torch.cuda.synchronize()
    for key in ("counts", "nmapread", "kmc", "stats"):
        if not torch.equal(st_k[key], st_p[key]):
            fail(f"KD state {key} disagrees with the plain version")
    if not bool(st_k["stats"].any()):
        fail("KD's tail added no read statistic")
    km_err = max_abs_err(tuple(a_k[x] for x in ("hf", "counted", "dest")),
                         tuple(a_p[x] for x in ("hf", "counted", "dest")))
    if km_err != 0:
        fail(f"KM's tail in KD disagrees with the plain version (max |err| "
             f"{km_err})")
    n_counted = int((st_k["counts"][:-1].long() & 0xFFFFFFFF).sum())
    n_slots = kbd.touched_slots(st_k["counts"])
    kd_blocks, kd_warps = da.assign_count_grid(P)
    kd = compare("KD assign_count (with KM's tail)",
                 lambda: da.assign_count(st_k, *kd_args),
                 lambda: da.assign_count_plain(st_p, *kd_args),
                 kbd.kd_bytes(P, NKW, n_slots),
                 f"reads={B} counted_kmers={n_counted} slots={n_slots} "
                 f"stats={st_k['stats'].tolist()} grid: blocks={kd_blocks} "
                 f"warps={kd_warps} launches/step=1")
    # KL on the step's captured inputs, and KL's, KD's (with and without
    # the tail) and the plain tail's CUDA-graph replays: below ~10 us only
    # a graph times a kernel
    kl_args = cap["KL"]
    kl_blocks, kl_g = da.pair_filter_grid(P, NKW)
    kl = compare("KL pair_filter", lambda: da.pair_filter(*kl_args),
                 lambda: da.pair_filter_plain(*kl_args),
                 kbd.kl_bytes(P, NKW),
                 f"P={P} NKW={NKW} nf=4 nmf=1 cth=20 blocks={kl_blocks} of "
                 f"{kl_g} pairs (256 threads, a 16-byte chunk each) "
                 f"launches/step=1")
    kd_alone = kd_args[:-1] + (None,)
    sg = da.init_state(drp, dev)
    graphs = {"KL": lambda: da.pair_filter(*kl_args),
              "KD": lambda: da.assign_count(sg, *kd_args),
              "KD alone": lambda: da.assign_count(sg, *kd_alone)}
    gms = {}
    for name, fn in graphs.items():
        gms[name] = cuda_ms(graph_of(fn).replay, reps=5) / GRAPH
    kl["graph_ms"] = gms["KL"]
    kd["graph_ms"] = gms["KD"]
    kd["alone_graph_ms"] = gms["KD alone"]
    for name, r_ in (("KL", kl), ("KD", kd)):
        log(f"[3] {name} graph_ms={r_['graph_ms']:.4f} ({GRAPH} launches a "
            f"CUDA graph, replayed) ms={r_['ms']:.4f} (window) bound_ms="
            f"{r_['bound_ms']:.4f}; card {smi}")
    # KM: the tail's plain version on KD's rm, beside what the tail adds
    # to KD's graph time
    t_ = tail
    km_args = (t_.live, t_.nonshort, t_.sub_drop, t_.pair_kf, t_.vote_pass,
               t_.pack, kd_args[7], t_.qc_drop, kd_args[8], t_.bf,
               a_k["rm"], kd_args[6], kd_args[11])
    s9 = torch.zeros(9, dtype=torch.int64, device=dev)
    km_plain_ms = cuda_ms(lambda: da.step_tail_plain(s9, *km_args))
    km_ = dict(match=True, max_abs_err=km_err, ms=kd["ms"],
               graph_ms=kd["graph_ms"], plain_ms=km_plain_ms,
               bound_ms=kbd.bound_ms(kbd.km_bytes(P)), bound_by="bytes",
               library_ms=None, fused_in="KD (counting, okam), KE "
               "(threading)", tail_graph_ms=gms["KD"] - gms["KD alone"])
    log(f"[3] KM step tail fused in KD: match=True max_abs_err={km_err} "
        f"KD graph_ms={gms['KD']:.4f} KD without the tail "
        f"{gms['KD alone']:.4f} (the tail adds "
        f"{km_['tail_graph_ms']:.4f}) plain_ms={km_plain_ms:.4f} "
        f"bound_ms={km_['bound_ms']:.5f}; card {smi}")
    del sg
    results = {
        "KL": dict(kl, source="danbing_tk_tpu_torch/csrc/pair_filter.cu",
                   replaces="danbing_tk_tpu/engine/device_align.py:597"),
        "KM": dict(km_, source="danbing_tk_tpu_torch/csrc/step_tail.cuh",
                   replaces="danbing_tk_tpu/engine/device_align.py:1193"),
        "KA": dict(ka, source="danbing_tk_tpu_torch/csrc/kmers.cu",
                   replaces="danbing_tk_tpu/ops/kmers_jax.py:63"),
        "KB": dict(kb["dbi"],
                   source="danbing_tk_tpu_torch/csrc/bucket_lookup.cu",
                   replaces="danbing_tk_tpu/index/device_table.py:356"),
        "KC": dict(kc, source="danbing_tk_tpu_torch/csrc/pair_vote.cu",
                   replaces="danbing_tk_tpu/engine/device_align.py:618"),
        "KD": dict(kd, source="danbing_tk_tpu_torch/csrc/assign_count.cu",
                   replaces="danbing_tk_tpu/engine/device_align.py:1063"),
    }
    # KK's sample-only instance on the prefilter dispatch's reads: its
    # queries are the host sampler's (q_mem), and it equals its plain
    # version
    pb_d = torch.from_numpy(pbatch).to(dev)
    pr_d = torch.from_numpy(prlen).to(dev)
    Bp = 2 * Pp
    kq, kv, knk = km.prefilter_sample(pb_d, pr_d, k, 4)
    if not (torch.equal(kq, q_mem)
            and torch.equal(kv.cpu(), torch.from_numpy(qvalid))
            and torch.equal((knk > 0).cpu(), torch.from_numpy(qnon))):
        fail("KK's queries differ from the host sampler's on the "
             "prefilter dispatch")
    kks = compare("KK[sample] prefilter_sample",
                  lambda: km.prefilter_sample(pb_d, pr_d, k, 4),
                  lambda: km.prefilter_sample_plain(pb_d, pr_d, k, 4),
                  kbd.kk_sample_bytes(Bp, L, 4),
                  f"shape=({Bp},{L}) nf=4 threads={Bp * 4} queries = the "
                  f"host sampler's; launches/dispatch=1 (the sharded "
                  f"prefilter under a collective probe, shard_index)")
    kks["graph_ms"] = cuda_ms(graph_of(
        lambda: km.prefilter_sample(pb_d, pr_d, k, 4)).replay,
        reps=5) / GRAPH
    log(f"[3] KK[sample] prefilter_sample graph_ms={kks['graph_ms']:.4f} "
        f"({GRAPH} launches a CUDA graph, replayed) ms={kks['ms']:.4f} "
        f"(window) bound_ms={kks['bound_ms']:.4f}; card {smi}")
    results["KK[sample]"] = dict(
        kks, source="danbing_tk_tpu_torch/csrc/prefilter_sample.cu",
        replaces="danbing_tk_tpu/engine/device_align.py:343")
    # KK's fused launch (sample, member probe and decision) on the same
    # reads, bound once as make_prefilter_step binds it
    pl = torch.ones(Pp, dtype=torch.bool, device=dev)
    fused = da.prefilter_fused_launcher(mtab, k, 4, 1)
    work = da.prefilter_fused_work(pb_d, pr_d, pl, mtab, k, 4, 1)
    kk = compare("KK prefilter_fused", lambda: fused(pb_d, pr_d, pl),
                 lambda: da.prefilter_fused_plain(pb_d, pr_d, pl, mtab, k,
                                                  4, 1),
                 work["nbytes"],
                 f"P={Pp} L={L} nf=4 nmf=1 member W={mtab.W} "
                 f"survivors={int(work['survive'].sum())} pairs_probing="
                 f"{work['pairs_probing']} probed_queries="
                 f"{int(work['probed'].sum())} distinct_rows={work['rows']} "
                 f"bytes={work['nbytes']} launches/dispatch=1 "
                 f"(DTK_PREFILTER_HOSTQ=0, the sharded prefilter's whole "
                 f"table)")
    kk["graph_ms"] = cuda_ms(graph_of(lambda: fused(pb_d, pr_d, pl)).replay,
                             reps=5) / GRAPH
    log(f"[3] KK prefilter_fused graph_ms={kk['graph_ms']:.4f} ({GRAPH} "
        f"launches "
        f"a CUDA graph, replayed) ms={kk['ms']:.4f} (window) bound_ms="
        f"{kk['bound_ms']:.4f}; card {smi}")
    results["KK"] = dict(
        kk, source="danbing_tk_tpu_torch/csrc/prefilter_sample.cu",
        replaces="danbing_tk_tpu/engine/device_align.py:379")
    # KK[q], the same probe and decision over the host sampler's queries
    # of the same reads (the default prefilter's one launch a dispatch):
    # its survivors = its plain version's = the fused launch's
    qv = torch.from_numpy(qvalid).to(dev)
    qn = torch.from_numpy(qnon).to(dev)
    fused_q = da.prefilter_fused_q_launcher(mtab, 1)
    if not torch.equal(fused_q(q_mem, qv, qn, pl), fused(pb_d, pr_d, pl)):
        fail("KK[q]'s survivors differ from KK's fused launch's")
    qwork = da.prefilter_fused_q_work(q_mem, qv, qn, pl, mtab, 1)
    kkq = compare("KK[q] prefilter_fused_q",
                  lambda: fused_q(q_mem, qv, qn, pl),
                  lambda: da.prefilter_fused_q_plain(q_mem, qv, qn, pl,
                                                     mtab, 1),
                  qwork["nbytes"],
                  f"P={Pp} nf=4 nmf=1 member W={mtab.W} survivors="
                  f"{int(qwork['survive'].sum())} probed_queries="
                  f"{int(qwork['probed'].sum())} distinct_rows="
                  f"{qwork['rows']} bytes={qwork['nbytes']} "
                  f"launches/dispatch=1 (host-sampled prefilter, the "
                  f"single-card default)")
    kkq["graph_ms"] = cuda_ms(graph_of(
        lambda: fused_q(q_mem, qv, qn, pl)).replay, reps=5) / GRAPH
    log(f"[3] KK[q] prefilter_fused_q graph_ms={kkq['graph_ms']:.4f} "
        f"(KK graph_ms={kk['graph_ms']:.4f}) ms={kkq['ms']:.4f} (window) "
        f"bound_ms={kkq['bound_ms']:.4f}; card {smi}")
    results["KK[q]"] = dict(
        kkq, source="danbing_tk_tpu_torch/csrc/prefilter_sample.cu",
        replaces="danbing_tk_tpu/engine/device_align.py:415")
    pre_q = da.make_prefilter_step_q(drp, cfg, Pp, dev)
    pre_d = da.make_prefilter_step(drp, cfg, Pp, L, dev)
    if not torch.equal(pre_d(pb_d, pr_d, pl), pre_q(q_mem, qv, qn, pl)):
        fail("the device-sampled prefilter's survivors differ from the "
             "host-sampled one's")
    pre_ms = cuda_ms(lambda: pre_q(q_mem, qv, qn, pl))
    pre_dev_ms = cuda_ms(lambda: pre_d(pb_d, pr_d, pl))
    step_ms = cuda_ms(lambda: step(scratch, codes_d, rlen_d, live_d))
    log(f"[3] prefilter dispatch (Pp={Pp}, device tensors) "
        f"ms={pre_ms:.4f} (host-sampled queries: KK[q]), "
        f"{pre_dev_ms:.4f} (code rows: KK's fused launch); full step "
        f"(P={P}) ms={step_ms:.4f}")

    # ---- 4. golden end to end through the CLI ----
    from danbing_tk_tpu_torch.apps import cli

    gold = os.path.join(ROOT, "tests", "golden")
    build.reset_launch_counts()
    t0 = time.time()
    with tempfile.TemporaryDirectory(prefix="dtk_smoke_") as out_dir:
        cli.main(["align", "--device", "--native-io", "--prefilter", "-ka",
                  "-cth", "20", "-kf", "4", "1", "-qs",
                  os.path.join(gold, "pan"), "-fa",
                  os.path.join(gold, "reads.fa"), "-o",
                  os.path.join(out_dir, "OUT")])
        torch.cuda.synchronize()
        golden_counts = build.launch_counts()
        with open(os.path.join(out_dir, "OUT.trkmc.ar"), "rb") as f:
            got = f.read()
    with open(os.path.join(gold, "out.trkmc.ar"), "rb") as f:
        want = f.read()
    if got != want:
        fail("golden .trkmc.ar differs from tests/golden/out.trkmc.ar")
    if min(golden_counts[t] for t in COUNTING) <= 0:
        fail(f"golden run skipped a kernel: {golden_counts}")
    log(f"[4] golden CLI on cuda: .trkmc.ar byte-equal, "
        f"{time.time() - t0:.1f}s, launches {golden_counts}")
    build.reset_launch_counts()
    t0 = time.time()
    with tempfile.TemporaryDirectory(prefix="dtk_smoke_") as out_dir:
        out = os.path.join(out_dir, "OUT")
        cli.main(["align", "--device", "--native-io", "--prefilter", "-cth",
                  "20", "-kf", "4", "1", "-s", "2", "-gc", "50", "3", "-a",
                  "-qs", os.path.join(gold, "pan"), "-fa",
                  os.path.join(gold, "reads.sim.fa"), "-on", out])
        torch.cuda.synchronize()
        golden_thr_counts = build.launch_counts()
        for ext, name in ((".aln", "out.thread.aln"),
                          (".tr.kmers", "out.thread.tr.kmers")):
            with open(out + ext, "rb") as f, \
                    open(os.path.join(gold, name), "rb") as g:
                if f.read() != g.read():
                    fail(f"golden threading {ext} differs from "
                         f"tests/golden/{name}")
        if os.path.exists(out + ".tr.summary.txt"):
            fail("threading mode wrote a .tr.summary.txt")
    if min(golden_thr_counts[t] for t in THREADING) <= 0:
        fail(f"golden threading run skipped a kernel: {golden_thr_counts}")
    log(f"[4] golden threading CLI on cuda: .aln and .tr.kmers byte-equal, "
        f"{time.time() - t0:.1f}s, launches {golden_thr_counts}")
    # ---- 4b. golden, Python ingest (run_file), through the CLI ----
    golden_py_counts = python_ingest_golden(gold, smi)
    # ---- 4d. the downstream analyses: call, length, eqtl ----
    alaunches = analysis_phase(gold, smi)
    # ---- 4c. RPGG construction and bait QC ----
    golden_qc_counts = golden_qc_stages(smi)
    # ---- 4e. the warmup command ----
    warmup_cli(gold, smi)

    # ---- 5. production-size funnel ----
    runner = DeviceAlignRunner(flat, cfg, batch_pairs=P, max_read_len=L,
                               expand_cap=E, drp=drp, device=dev)
    if type(runner.referee).__name__ != "ParallelReferee":
        fail(f"phase 5's referee is {type(runner.referee).__name__}, not "
             f"the pooled native engine")
    flagged = []                    # the first 256 referee calls' inputs
    submit = runner.referee.submit

    def record(*a):
        if len(flagged) < 256:
            flagged.append(a)
        submit(*a)

    runner.referee.submit = record
    Pd = runner.dispatch_pairs(True)
    nbat = -(-args.pairs // Pd)
    t0 = time.time()
    batches = [sample_read_batch(seqs, Pd, L, rng, frac_tr=0.05,
                                 read_len=RL) + (Pd,) for _ in range(nbat)]
    t_data = time.time() - t0
    npairs = nbat * Pd
    host_surv = record_survivors(runner, Pd)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launch_counts()
    t0 = time.time()
    runner.run_batches(batches, prefilter=True)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = build.launch_counts()
    if min(launches[t] for t in COUNTING) <= 0:
        fail(f"the funnel skipped a kernel: {launches}")
    stats = runner.state["stats"].cpu().tolist()
    nmap = da.state_u32(runner.state["nmapread"])[:-1].astype(np.int64)
    if int(nmap.sum()) != stats[6] or runner.n_prefiltered + \
            runner.n_step_pairs != npairs:
        fail(f"funnel bookkeeping disagrees: nmapread {int(nmap.sum())} "
             f"vs stats {stats}, pairs {npairs}")
    ref_share = runner.n_referee / max(runner.n_step_pairs, 1)
    if runner.n_resolved != runner.n_referee or not runner.n_referee:
        fail(f"phase 5 resolved {runner.n_resolved} of {runner.n_referee} "
             f"referee'd pairs")
    log(f"[5] referee: flat view built in {t_flat:.1f}s (dbi keys "
        f"{len(flat.dbi)}, TR slots {flat.nslots}), referee'd pairs "
        f"{runner.n_referee} resolved {runner.n_resolved} by "
        f"{runner.referee.nthreads} native threads, referee_s="
        f"{runner.referee_s:.3f} (host wall in the calls and flushes), "
        f"host counts {int(flat.flat_counts().sum())}")
    referee_gate(flat, cfg, flagged)
    dlaunches = device_sampled_pass(drp, flat, batches, cfg, P, L, E, dev,
                                    runner, host_surv, wall, launches, smi)
    log(f"[5] funnel: pairs={npairs} (data made in {t_data:.1f}s) "
        f"wall={wall:.3f}s reads/s={2 * npairs / wall:.0f} "
        f"prefilter_dispatches={nbat} ms/dispatch={pre_ms:.4f} "
        f"steps={runner.n_steps} step_ms={step_ms:.4f} "
        f"survivors={runner.n_step_pairs} referee={runner.n_referee} "
        f"referee_share={ref_share:.5f} reasons={runner.referee_reasons} "
        f"index_build_s={t_index:.1f} nloci={args.nloci} "
        f"max_memory_allocated={torch.cuda.max_memory_allocated()} "
        f"stats={stats} launches={launches}")

    # ---- 5b. the Python ingest at full width ----
    plaunches = python_ingest_scale(drp, flat, batches, cfg, P, L, E, dev,
                                    smi)

    # ---- 5s. the sharded funnel (world-1 NCCL group) ----
    sharded = sharded_phase(args, dev, dict(
        drp=drp, seqs=seqs, cap=cap, q_mem=q_mem, qvalid=qv, qnon=qn,
        batches=batches, P=P, L=L, E=E, k=k, RL=RL, cfg=cfg, pb=pb_d,
        pr=pr_d,
        reads_s=2 * npairs / wall, ref_share=ref_share, flat=flat, smi=smi))

    # ---- 6. production-size threading funnel ----
    (drp.graph_tab, n_graph), t_graph = tables.pop("graph")
    t0 = time.time()
    drp.tables(dev, graph=True)
    torch.cuda.synchronize()
    log(f"[6] graph table: entries={n_graph} bytes={drp.graph_tab.nbytes} "
        f"levels={len(drp.graph_tab.levels)} build={t_graph:.1f}s (beside "
        f"the index) "
        f"upload={time.time() - t0:.1f}s")
    # the threading step (-gc 85 3, the reference README's setting) on TR
    # pairs with substitutions, so both clean and corrected walks occur
    tcfg = AlignConfig(ksize=k, cth=20, n_filter=4, nm_filter=1, okam=False,
                       threading=True, thread_cth=85, maxncorrection=3)
    trng = np.random.default_rng([args.seed, 2])
    tcodes, trlen = sample_read_batch(seqs, P, L, trng, frac_tr=1.0,
                                      read_len=RL, sub_rate=SUB)
    tcap: dict = {}
    tstep = da.make_step(drp, tcfg, P, L, expand_cap=E, device=dev,
                         capture=tcap)
    tscratch = da.init_state(drp, dev)
    tcodes_d = torch.from_numpy(tcodes).to(dev)
    trlen_d = torch.from_numpy(trlen).to(dev)
    _, tout = tstep(tscratch, tcodes_d, trlen_d, live_d)
    torch.cuda.synchronize()
    n_vote = int(tout["vote_pass"].sum())
    n_clean = int(tout["clean_pair"].sum())
    # KB on the graph table at the walk's (nc, dst0) queries, all of them:
    # the threading step no longer launches it (KE probes the table
    # itself), but KB is still held on the 8.86 GB table
    tab, q, tdst0 = tcap["KE"][:3]
    loc = tdst0.repeat_interleave(2)[:, None].expand(-1, q.shape[1])
    nbytes, rows, reads = kbd.probe_bytes(tab, q, loc)
    kb["graph"] = compare(
        "KB bucket_lookup[graph]", lambda: dt.lookup_bucket(tab, q, loc),
        lambda: dt.lookup_bucket_plain(tab, q, loc), nbytes,
        f"queries={q.numel()} distinct_rows={rows} row_reads={reads} "
        f"launches/step=0 (KE probes the graph table itself)", phase=6)
    kdt_args = tcap["KD"]
    st_k, st_p = da.init_state(drp, dev), da.init_state(drp, dev)
    compare("KD assign_count[threading]",
            lambda: da.assign_count(st_k, *kdt_args),
            lambda: da.assign_count_plain(st_p, *kdt_args),
            B * NKW * 36 + B * (9 * 4 + 8) + P * 9,
            f"reads={B} writes tr_member + slot planes, no counts "
            f"grid: blocks={kd_blocks} warps={kd_warps}", phase=6)
    for key in ("counts", "nmapread", "kmc"):
        if st_k[key].any() or st_p[key].any():
            fail(f"KD in threading mode touched state {key}")
    # KE with KM's tail (counted = dev_pair & clean_pair)
    ke_args = tcap["KE"]
    st_k, st_p = da.init_state(drp, dev), da.init_state(drp, dev)
    _, ke_pair, ke_tail = da.thread_walk_graph(st_k, *ke_args)
    want = da.thread_walk_graph_plain(st_p, *ke_args)
    torch.cuda.synchronize()
    for key in ("counts", "stats"):
        if not torch.equal(st_k[key], st_p[key]):
            fail(f"KE {key} disagree with the plain version")
    if max_abs_err(ke_tail, want[2]) != 0 or not bool(st_k["stats"].any()):
        fail("KM's tail in KE disagrees with the plain version")
    n_thr_counted = int((st_k["counts"][:-1].long() & 0xFFFFFFFF).sum())
    n_thr_slots = kbd.touched_slots(st_k["counts"])
    ke_b, ke_walked, ke_counted, ke_rows = ke_bytes(*ke_args[:8], ke_pair,
                                                    n_thr_slots)
    ke = compare("KE thread_walk (with KM's tail)",
                 lambda: da.thread_walk_graph(st_k, *ke_args),
                 lambda: da.thread_walk_graph_plain(st_p, *ke_args),
                 ke_b + 48 * P + 144,
                 f"pairs={P} vote_pass={n_vote} clean_pairs={n_clean} "
                 f"walked_positions={ke_walked} graph_rows={ke_rows} "
                 f"counted_kmers={n_thr_counted} "
                 f"counted_positions={ke_counted} slots={n_thr_slots} grid: "
                 f"blocks,warps={da.thread_walk_grid(P)} launches/step=1",
                 phase=6)
    results["KE"] = dict(
        ke, source="danbing_tk_tpu_torch/csrc/thread_walk.cu",
        replaces="danbing_tk_tpu/engine/device_align.py:1145")
    tstep_ms = cuda_ms(lambda: tstep(tscratch, tcodes_d, trlen_d, live_d))
    log(f"[6] threading step (P={P}, sub_rate={SUB}) ms={tstep_ms:.4f} "
        f"clean_pair_share={n_clean / max(n_vote, 1):.4f}")
    del tscratch, st_k, st_p, tcap, kdt_args, ke_args

    view = ScaleThreadView(seqs, k)
    trunner = DeviceAlignRunner(None, tcfg, batch_pairs=P, max_read_len=L,
                                expand_cap=E, drp=drp, device=dev,
                                thread_view=view)
    trng = np.random.default_rng([args.seed, 3])
    t0 = time.time()
    tbatches, src_loci = [], []
    for _ in range(nbat):
        c, r, li = sample_read_batch(seqs, Pd, L, trng, frac_tr=0.05,
                                     read_len=RL, sub_rate=SUB,
                                     with_loci=True)
        tbatches.append((c, r, Pd))
        src_loci.append(li)
    t_tdata = time.time() - t0
    # the host view stands in for an index's graphs, which a real run
    # loads before it aligns: build the pool fragments' loci up front
    view.build(np.concatenate(src_loci))
    t_view, n_view = view.build_s, len(view.graphs)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launch_counts()
    t0 = time.time()
    trunner.run_batches(tbatches, prefilter=True)
    torch.cuda.synchronize()
    twall = time.time() - t0
    tlaunches = build.launch_counts()
    if min(tlaunches[t] for t in THREADING) <= 0:
        fail(f"the threading funnel skipped a kernel: {tlaunches}")
    n_surv = trunner.n_step_pairs
    n_dev, n_host = trunner.n_device_thread, trunner.n_host_thread
    n_ref = trunner.n_referee
    host_counted = sum(sum(d.values()) for d in view.tr_counts.values())
    dev_counted = int((trunner.state["counts"][:-1].long()
                       & 0xFFFFFFFF).sum())
    if trunner.n_prefiltered + n_surv != npairs or \
            n_dev + n_host + n_ref > n_surv or min(n_dev, n_host) <= 0 \
            or host_counted <= 0 or dev_counted <= 0:
        fail(f"threading funnel bookkeeping: survivors {n_surv}, device "
             f"{n_dev}, host {n_host}, referee {n_ref}, counted "
             f"{dev_counted} + {host_counted}")
    log(f"[6] threading funnel (-gc 85 3): pairs={npairs} (data made in "
        f"{t_tdata:.1f}s; host view of {n_view} source loci built before "
        f"in {t_view:.1f}s) wall={twall:.3f}s "
        f"reads/s={2 * npairs / twall:.0f} "
        f"survivors={n_surv} device_clean={n_dev} host_thread={n_host} "
        f"referee={n_ref} (counted, not resolved: no host view carries the "
        f"locus graphs at scale, in either package) "
        f"shares(device/host/referee of survivors)="
        f"{n_dev / n_surv:.4f}/{n_host / n_surv:.4f}/{n_ref / n_surv:.4f} "
        f"host_view_loci_built_in_run={len(view.graphs) - n_view} "
        f"host_view_build_s_in_run={view.build_s - t_view:.3f} "
        f"counted_kmers(device/host)={dev_counted}/{host_counted} "
        f"steps={trunner.n_steps} graph_table_bytes={drp.graph_tab.nbytes} "
        f"graph_build_s={t_graph:.1f} "
        f"max_memory_allocated={torch.cuda.max_memory_allocated()} "
        f"stats={trunner.state['stats'].cpu().tolist()} "
        f"launches={tlaunches}")

    # ---- 6c. the error-correction site scorer (KJ) ----
    results["KJ"], jlaunches = site_scorer_phase(
        drp, dev, tbatches, src_loci, view, k, RL)

    # ---- 7. okam, bait, QC and bubbles ----
    # (a) the golden CLI on cuda
    build.reset_launch_counts()
    t0 = time.time()
    okam_golden = (
        (["-bu", "-fa", "reads.fa"], "out",
         ("kam", "trkmc.ar", "tr.summary.txt", "bub.kmdb")),
        (["-fq", "reads.sim.fq", "-b", "-s", "2"], "out.fq",
         ("kam", "trkmc.ar", "tr.summary.txt")),
        (["-qc", "qc.txt", "-s", "2", "-fa", "reads.sim.fa"], "out.qc",
         ("kam", "trkmc.ar", "tr.summary.txt")),
    )
    with tempfile.TemporaryDirectory(prefix="dtk_smoke_") as out_dir:
        for flags, gname, exts in okam_golden:
            out = os.path.join(out_dir, gname)
            cli.main(["align", "--device", "--native-io", "--prefilter",
                      "-cth", "20", "-kf", "4", "1", "-qs",
                      os.path.join(gold, "pan"), "-o", out]
                     + [os.path.join(gold, a) if "." in a else a
                        for a in flags])
            for ext in exts:
                with open(f"{out}.{ext}", "rb") as f, \
                        open(os.path.join(gold, f"{gname}.{ext}"), "rb") as g:
                    if f.read() != g.read():
                        fail(f"golden {' '.join(flags)}: .{ext} differs "
                             f"from tests/golden/{gname}.{ext}")
        torch.cuda.synchronize()
    golden_okam_counts = build.launch_counts()
    if min(golden_okam_counts[t] for t in OKAM) <= 0:
        fail(f"golden okam runs skipped a kernel: {golden_okam_counts}")
    log(f"[7] golden CLI on cuda: default .kam + -bu, -fq -b -s 2, -qc -s 2 "
        f"byte-equal, {time.time() - t0:.1f}s, launches "
        f"{golden_okam_counts}")

    # (b) the okam step's kernels at scale; the graph table's device copy
    # goes first, so the peak is never graph + tre
    del tstep, trunner, view, tbatches, tab, q, loc, tout
    drp.release(dev, "graph")
    drp.graph_tab = None
    torch.cuda.empty_cache()
    (drp.tre_tab, n_tre), t_tre = tables.pop("tre")
    t0 = time.time()
    drp.bait_tab, n_bait = build_scale_bait(seqs, seed=args.seed)
    drp.qc = build_scale_qc(args.nloci, seed=args.seed)
    t_bait = time.time() - t0
    t0 = time.time()
    drp.tables(dev, bait=True, qc=True, tre=True)
    torch.cuda.synchronize()
    log(f"[7] tre table: entries={n_tre} bytes={drp.tre_tab.nbytes} "
        f"levels={len(drp.tre_tab.levels)} build={t_tre:.1f}s (beside the "
        f"index); bait table: "
        f"entries={n_bait} bytes={drp.bait_tab.nbytes} build+qc="
        f"{t_bait:.1f}s; qc fails {int((drp.qc == 0).sum())} loci; upload="
        f"{time.time() - t0:.1f}s")
    ocfg = AlignConfig(ksize=k, cth=20, n_filter=4, nm_filter=1, okam=True,
                       simmode=2, bait=True, qc=True, output_bubbles=True)
    orng = np.random.default_rng([args.seed, 4])
    ocodes, orlen = sample_read_batch(seqs, P, L, orng, frac_tr=1.0,
                                      read_len=RL, sub_rate=SUB)
    ocap: dict = {}
    ostep = da.make_step(drp, ocfg, P, L, expand_cap=E, with_annot=True,
                         with_bubbles=True, device=dev, capture=ocap)
    oscratch = da.init_state(drp, dev)
    ocodes_d = torch.from_numpy(ocodes).to(dev)
    orlen_d = torch.from_numpy(orlen).to(dev)
    _, oout = ostep(oscratch, ocodes_d, orlen_d, live_d)
    torch.cuda.synchronize()

    kf_args = ocap["KF"]
    kmer_, qm_, dst0_, _, _, _, bait_, _ = kf_args
    dp, qd, _, bfp = da.read_filter_plain(*kf_args)
    devr = dp.repeat_interleave(2)
    # the run starts KF probes: each dev_pair read's distinct k-mers
    srt = torch.sort(torch.where(kmer_[devr] == km.EMPTY, (1 << 63) - 1,
                                 kmer_[devr]), dim=1).values
    new = srt != (1 << 63) - 1
    new[:, 1:] &= srt[:, 1:] != srt[:, :-1]
    bq = srt[new]
    bloc = dst0_.repeat_interleave(2)[devr][:, None].expand_as(srt)[new]
    _, brows, _ = kbd.probe_bytes(bait_, bq, bloc)
    n_dev_reads = int(devr.sum())
    kf = compare("KF read_filter", lambda: da.read_filter(*kf_args),
                 lambda: da.read_filter_plain(*kf_args),
                 n_dev_reads * NKW * 8 + brows * 8 * bait_.W * 4
                 + P * (10 + 1 + 11),
                 f"pairs={P} dev_pairs={int(dp.sum())} bait_filtered="
                 f"{int(bfp.sum())} qc_dropped={int(qd.sum())} run_starts="
                 f"{bq.numel()} distinct_bait_rows={brows} launch="
                 f"{da.read_filter_launch(P, NKW, True)} launches/step=1",
                 phase=7)
    kfq_args = kf_args[:6] + (None,) + kf_args[7:]
    compare("KF read_filter[qc-only]", lambda: da.read_filter(*kfq_args),
            lambda: da.read_filter_plain(*kfq_args), P * (11 + 11),
            f"pairs={P} launch={da.read_filter_launch(P, NKW, False)} "
            f"launches/step=1 with -qc and no -b", phase=7)
    kg_args = ocap["KG"]
    edge_, evalid_, si__, ei__, rm_, counted_, dst0g, tre_ = kg_args
    NE = edge_.shape[1]
    pos = torch.arange(NE, device=dev)
    need = (evalid_ & (pos >= si__[:, None]) & (pos < (ei__ - 1)[:, None])
            & ((rm_ == 0) & counted_.repeat_interleave(2))[:, None])
    tq = edge_[need]
    tloc = dst0g.repeat_interleave(2)[:, None].expand_as(edge_)[need]
    _, trows, _ = kbd.probe_bytes(tre_, tq, tloc, stop=True)
    n_novel = int(da.unpack_bits(da.novel_edges_plain(*kg_args), NE).sum())
    kg = compare("KG novel_edges", lambda: da.novel_edges(*kg_args),
                 lambda: da.novel_edges_plain(*kg_args),
                 tq.numel() * 9 + trows * 8 * tre_.W * 4 + B * 12 + P * 9
                 + B * ((NE + 7) // 8),
                 f"reads={B} probed_positions={tq.numel()} novel_edges="
                 f"{n_novel} distinct_tre_rows={trows} launches/step=1",
                 phase=7)
    kda_args = ocap["KD"]
    st_k, st_p = da.init_state(drp, dev), da.init_state(drp, dev)
    da.assign_count(st_k, *kda_args)
    da.assign_count_plain(st_p, *kda_args)
    torch.cuda.synchronize()
    if kda_args[-1] is None:
        fail("the okam step launched KD without KM's tail")
    for key in ("counts", "nmapread", "kmc", "stats"):
        if not torch.equal(st_k[key], st_p[key]):
            fail(f"KD[annot] state {key} disagrees with the plain version")
    n_slots_a = kbd.touched_slots(st_k["counts"])
    kda = compare("KD assign_count[annot]",
                  lambda: da.assign_count(st_k, *kda_args),
                  lambda: da.assign_count_plain(st_p, *kda_args),
                  B * NKW * 28 + B * (9 * 4 + 8) + P * 10 + n_slots_a * 8,
                  f"reads={B} writes the ann plane, bf_pair in, slots="
                  f"{n_slots_a} grid: blocks={kd_blocks} warps={kd_warps} "
                  f"launches/step=1", phase=7)
    results["KF"] = dict(
        kf, source="danbing_tk_tpu_torch/csrc/read_filter.cu",
        replaces="danbing_tk_tpu/engine/device_align.py:990")
    results["KG"] = dict(
        kg, source="danbing_tk_tpu_torch/csrc/novel_edges.cu",
        replaces="danbing_tk_tpu/engine/device_align.py:1238")
    ostep_ms = cuda_ms(lambda: ostep(oscratch, ocodes_d, orlen_d, live_d))
    log(f"[7] okam step (P={P}, sub_rate={SUB}, -s 2 -b -qc -bu) "
        f"ms={ostep_ms:.4f} vote_pass={int(oout['vote_pass'].sum())} "
        f"counted={int(oout['counted'].sum())} KD[annot] ms={kda['ms']:.4f}")
    del oscratch, st_k, st_p, ocap, kf_args, kg_args, kda_args, ostep, oout

    # (c) the 1M-pair okam funnel; the referee's view gains the tre sets,
    # bait maps and QC mask
    t0 = time.time()
    oflat = flat.renew(drp)
    t_oflat = time.time() - t0
    del flat
    orunner = DeviceAlignRunner(oflat, ocfg, batch_pairs=P, max_read_len=L,
                                expand_cap=E, drp=drp, device=dev)
    orng = np.random.default_rng([args.seed, 5])
    t0 = time.time()
    obatches = []
    for _ in range(nbat):
        c, r, li = sample_read_batch(seqs, Pd, L, orng, frac_tr=0.05,
                                     read_len=RL, sub_rate=SUB,
                                     with_loci=True)
        obatches.append((c, r, Pd, sim_titles(li)))
    t_odata = time.time() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launch_counts()
    t0 = time.time()
    orunner.run_batches(obatches, prefilter=True)
    torch.cuda.synchronize()
    owall = time.time() - t0
    olaunches = build.launch_counts()
    if min(olaunches[t] for t in OKAM) <= 0:
        fail(f"the okam funnel skipped a kernel: {olaunches}")
    ost = orunner.state["stats"].cpu().tolist()
    onmap = da.state_u32(orunner.state["nmapread"])[:-1].astype(np.int64)
    rows = orunner.kam_rows
    n_same = sum(1 for row in rows
                 if row.split("\t", 2)[0] == row.split("\t", 2)[1])
    bub = orunner.bubbles
    n_novel_f = sum(sum(c.values()) for c in bub.bub_counts.values())
    n_osurv = orunner.n_step_pairs
    if orunner.n_resolved != orunner.n_referee or not orunner.n_referee:
        fail(f"phase 7c resolved {orunner.n_resolved} of "
             f"{orunner.n_referee} referee'd pairs")
    if (int(onmap.sum()) != ost[6]
            or orunner.n_prefiltered + n_osurv != npairs
            or not rows or ost[7] <= 0 or ost[8] <= 0 or n_novel_f <= 0
            or n_same <= len(rows) // 2):
        fail(f"okam funnel bookkeeping: nmapread {int(onmap.sum())}, stats "
             f"{ost}, survivors {n_osurv}, rows {len(rows)} (src == dest "
             f"{n_same}), novel edges {n_novel_f}")
    log(f"[7] okam funnel (-s 2 -b -qc -bu): pairs={npairs} (data made in "
        f"{t_odata:.1f}s) wall={owall:.3f}s "
        f"reads/s={2 * npairs / owall:.0f} survivors={n_osurv} "
        f"kam_rows={len(rows)} src_eq_dest_share={n_same / len(rows):.4f} "
        f"bait_filtered_reads={ost[8]} share_of_dev_reads="
        f"{ost[8] / max(ost[5], 1):.4f} qc_dropped_reads={ost[7]} "
        f"share={ost[7] / max(ost[5] + ost[7], 1):.4f} "
        f"novel_edges={n_novel_f} bubble_kmers="
        f"{sum(len(c) for c in bub.bub_counts.values())} "
        f"referee={orunner.n_referee} referee_share="
        f"{orunner.n_referee / max(n_osurv, 1):.5f} resolved="
        f"{orunner.n_resolved} by the Python HostAligner, referee_s="
        f"{orunner.referee_s:.3f}; flat view renewed with tre, bait and QC "
        f"in {t_oflat:.1f}s (tre edges {len(oflat.tre_sets.keys)}) "
        f"steps={orunner.n_steps} "
        f"max_memory_allocated={torch.cuda.max_memory_allocated()} "
        f"stats={ost} launches={olaunches}")

    results["KI"] = dict(sharded["KI"],
                         source="danbing_tk_tpu_torch/csrc/sharded_lookup.cu",
                         replaces="danbing_tk_tpu/parallel/sharded_index.py:53",
                         by_table=sharded["ki_all"])
    results["KI[count]"] = dict(
        sharded["KIC"], source="danbing_tk_tpu_torch/csrc/sharded_lookup.cu",
        replaces="danbing_tk_tpu/parallel/sharded_index.py:131")
    results["KC[large-E]"] = dict(
        sharded["KCL"], source="danbing_tk_tpu_torch/csrc/pair_vote.cu",
        replaces="danbing_tk_tpu/engine/device_align.py:618")
    results["KL[decide]"] = dict(
        sharded["KLD"], source="danbing_tk_tpu_torch/csrc/pair_filter.cu",
        replaces="danbing_tk_tpu/engine/device_align.py:371")
    return dict(results=results, launches=launches, wlaunches=wlaunches,
                dlaunches=dlaunches, tlaunches=tlaunches,
                olaunches=olaunches, slaunches=sharded["launches"],
                jlaunches=jlaunches, plaunches=plaunches,
                alaunches=alaunches, bq_launches=bq_launches,
                golden=(golden_counts, golden_thr_counts,
                        golden_okam_counts, golden_py_counts,
                        golden_qc_counts))


def warmup_pass(drp, flat, cfg, P, L, E, dev, smi: str) -> dict:
    """Phase 3's first window: ``warmup``'s step pass
    (engine/align_runner.warmup_steps) over the scale index in counting
    (-ka) mode at P = 4096, L = 160, E = 512, the retry tier E = 4096 and
    the prefilter dispatch 4P, on a runner over phase 5's flat view: each
    step's first call (kernel libraries loaded, first launches) beside the
    same step warm (the median of three more passes), in ms.  The state
    must be zero afterwards.  Returns the first pass's launches."""
    import statistics

    import torch

    from danbing_tk_tpu_torch.engine.align_runner import (DeviceAlignRunner,
                                                          warmup_steps)
    from danbing_tk_tpu_torch.kernels import build

    runner = DeviceAlignRunner(flat, cfg, batch_pairs=P, max_read_len=L,
                               expand_cap=E, retry_expand=4096, drp=drp,
                               device=dev)
    torch.cuda.synchronize()
    build.reset_launch_counts()
    first = warmup_steps(runner, prefilter=True)
    launches = build.launch_counts()
    if min(launches[t] for t in COUNTING + ("KC[large-E]",)) <= 0:
        fail(f"the warmup pass skipped a kernel: {launches}")
    warm = [warmup_steps(runner, prefilter=True) for _ in range(3)]
    bad = [key for key, t in runner.state.items() if bool(t.any())]
    if bad:
        fail(f"the warmup pass left state {bad} non-zero")
    log(f"[3] warmup pass (counting, scale index): " + "; ".join(
        f"{name} first_ms={1e3 * s:.2f} warm_ms="
        f"{1e3 * statistics.median(w[name] for w in warm):.3f}"
        for name, s in first.items())
        + f"; state zero after it; launches {launches}; card {smi}")
    return launches


def record_survivors(runner, Pp: int) -> list:
    """Builds ``runner``'s prefilter dispatch of Pp pairs and keeps each
    dispatch's survivor mask (the device tensor the runner reads) in the
    list returned."""
    runner._prefilter(Pp)
    step, kept = runner.prefilter_step, []

    def recorded(codes, rlen, live):
        surv = step(codes, rlen, live)
        kept.append(surv)
        return surv

    runner.prefilter_step = recorded
    return kept


def device_sampled_pass(drp, flat, batches, cfg, P, L, E, dev, host,
                        host_surv, host_wall, host_launches,
                        smi: str) -> dict:
    """Phase 5's second pass: its batches through a runner built with
    DTK_PREFILTER_HOSTQ=0, whose prefilter uploads the code rows and
    samples, probes and decides on the card in one launch (KK's fused
    launch), over a fresh copy of the flat view: every dispatch's
    survivor mask, the device count state, the referee's pairs and its
    host counts equal the host-sampled pass's (``host``); KB's member
    launches (its launches beyond two a step) none in either pass, one KK
    a dispatch in this pass and one KK[q] a dispatch in the host-sampled
    one (``host_launches``); the reads/s of both.  Then the first 8
    dispatches through each prefilter's parts, synchronized apart (host
    clock): host-sampled = native sampler + query upload + KK[q],
    device-sampled = code upload + KK's fused launch.  Returns the pass's
    launches."""
    import statistics

    import numpy as np
    import torch

    from danbing_tk_tpu_torch.engine import device_align as da
    from danbing_tk_tpu_torch.engine.align_runner import DeviceAlignRunner
    from danbing_tk_tpu_torch.io.native_reader import sample_queries
    from danbing_tk_tpu_torch.kernels import build

    t_phase = time.time()
    view = flat.renew()
    old = os.environ.get("DTK_PREFILTER_HOSTQ")
    os.environ["DTK_PREFILTER_HOSTQ"] = "0"
    try:
        r = DeviceAlignRunner(view, cfg, batch_pairs=P, max_read_len=L,
                              expand_cap=E, drp=drp, device=dev)
        Pd = r.dispatch_pairs(True)
        surv = record_survivors(r, Pd)
    finally:
        if old is None:
            del os.environ["DTK_PREFILTER_HOSTQ"]
        else:
            os.environ["DTK_PREFILTER_HOSTQ"] = old
    torch.cuda.synchronize()
    build.reset_launch_counts()
    t0 = time.time()
    r.run_batches(batches, prefilter=True)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = build.launch_counts()
    if min(launches[t] for t in COUNTING + ("KK",)) <= 0:
        fail(f"the device-sampled funnel skipped a kernel: {launches}")
    # KB probes dbi and trfl once a step; the rest is the member probe
    kb_member = launches["KB"] - 2 * r.n_steps
    kb_member_host = host_launches["KB"] - 2 * host.n_steps
    if kb_member != 0 or launches["KK"] != len(surv) \
            or kb_member_host != 0 or launches["KK[q]"] != 0 \
            or host_launches["KK[q]"] != len(host_surv) \
            or host_launches["KK"] != 0:
        fail(f"the prefilter dispatches launched KB on the member table "
             f"{kb_member} times (host-sampled pass {kb_member_host}), KK "
             f"{launches['KK']} times for {len(surv)} dispatches and "
             f"KK[q] {host_launches['KK[q]']} times for {len(host_surv)} "
             f"(host-sampled pass)")
    if len(surv) != len(host_surv) or not all(
            torch.equal(a, b) for a, b in zip(surv, host_surv)):
        fail("a dispatch's survivors differ between the device-sampled "
             "and the host-sampled prefilter")
    for key, t in host.state.items():
        if not torch.equal(t, r.state[key]):
            fail(f"the device-sampled funnel's state {key} differs")
    if (r.n_referee, r.n_resolved, r.n_step_pairs) != (
            host.n_referee, host.n_resolved, host.n_step_pairs) or \
            not np.array_equal(view.flat_counts(), flat.flat_counts()):
        fail("the device-sampled funnel's referee pairs or host counts "
             "differ")
    npairs = sum(b[2] for b in batches)
    pre_q = da.make_prefilter_step_q(drp, cfg, Pd, dev)
    pre_d = da.make_prefilter_step(drp, cfg, Pd, L, dev)
    k, nf = cfg.ksize, cfg.n_filter
    parts = {"host": [], "device": []}

    def clock():
        torch.cuda.synchronize()
        return time.perf_counter()

    for codes, rlen, n in batches[:8]:
        live = np.arange(Pd) < n
        t0 = clock()
        qlo, qhi, valid, nonshort = sample_queries(codes, rlen, k, nf)
        t1 = clock()
        up = [torch.from_numpy(x).to(dev) for x in (
            da.query_int64(qlo, qhi), valid, nonshort, live)]
        t2 = clock()
        a = pre_q(*up)
        t3 = clock()
        parts["host"].append((t1 - t0, t2 - t1, t3 - t2))
        t0 = clock()
        c, rl, lv = (torch.from_numpy(x).to(dev) for x in (codes, rlen,
                                                           live))
        t1 = clock()
        b = pre_d(c, rl, lv)
        t2 = clock()
        parts["device"].append((t1 - t0, t2 - t1))
        if not torch.equal(a, b):
            fail("the split's device-sampled survivors differ")
    med = {p: [1e3 * statistics.median(x[i] for x in v)
               for i in range(len(v[0]))] for p, v in parts.items()}
    B = 2 * Pd
    log(f"[5] device-sampled pass (DTK_PREFILTER_HOSTQ=0, KK's fused "
        f"launch): pairs={npairs} wall={wall:.3f}s reads/s="
        f"{2 * npairs / wall:.0f} (host-sampled: "
        f"{2 * npairs / host_wall:.0f}); {len(surv)} dispatches' "
        f"survivors, the count state, the referee's {r.n_referee} pairs and "
        f"host counts = the host-sampled pass's; referee_s="
        f"{r.referee_s:.3f} KB member launches {kb_member} (host-sampled "
        f"pass: {kb_member_host}, KK[q] {host_launches['KK[q]']}) "
        f"launches={launches}")
    h, d = med["host"], med["device"]
    log(f"[5] prefilter split, median of 8 dispatches of {Pd} pairs "
        f"(host clock, synchronized apart): host-sampled "
        f"sample_queries_ms={h[0]:.3f} query_upload_ms={h[1]:.3f} "
        f"({B * nf * 9 + B + Pd} B) KKq_ms={h[2]:.3f} "
        f"total={sum(h):.3f}; device-sampled code_upload_ms={d[0]:.3f} "
        f"({B * (L + 4) + Pd} B) KK_fused_ms={d[1]:.3f} "
        f"total={sum(d):.3f}; phase_s={time.time() - t_phase:.1f}; "
        f"card {smi}")
    return launches


def python_ingest_golden(gold: str, smi: str) -> dict:
    """Phase 4b: the CLI's --device route without --native-io or
    --prefilter (DeviceAlignRunner.run_file, the Python ingest) on cuda
    over the golden panel: -e 2 and -fq -s 2 -e 1 (rows on stdout),
    -ka (.trkmc.ar, .tr.summary.txt), the default okam (.kam), and -ka
    --checkpoint in one go, and through the runner stopped after five
    steps and resumed, all byte-equal to the goldens.  Returns the launch
    counts summed over the runs; KA-KD must each have launched in every
    run."""
    import contextlib

    import numpy as np
    import torch

    from danbing_tk_tpu_torch.apps import cli
    from danbing_tk_tpu_torch.engine.align_runner import DeviceAlignRunner
    from danbing_tk_tpu_torch.engine.host_align import AlignConfig, RPGG
    from danbing_tk_tpu_torch.kernels import build

    t_phase = time.time()
    pan = os.path.join(gold, "pan")
    base = ["align", "--device", "-cth", "20", "-kf", "4", "1", "-qs", pan]
    total: dict = {}

    def counted(what, fn):
        build.reset_launch_counts()
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        c = build.launch_counts()
        if min(c[t] for t in COUNTING) <= 0:
            fail(f"phase 4b {what} skipped a kernel: {c}")
        for key, v in c.items():
            total[key] = total.get(key, 0) + v
        return time.time() - t0

    def same(path, name, what):
        with open(path, "rb") as f, open(os.path.join(gold, name), "rb") as g:
            if f.read() != g.read():
                fail(f"phase 4b {what}: {os.path.basename(path)} differs "
                     f"from tests/golden/{name}")

    secs = {}
    with tempfile.TemporaryDirectory(prefix="dtk_smoke_") as d:
        out = os.path.join(d, "OUT")
        for what, extra, name in (
                ("-e 2", ["-fa", os.path.join(gold, "reads.fa"), "-e", "2"],
                 "out.e2.fa"),
                ("-fq -e 1", ["-fq", os.path.join(gold, "reads.sim.fq"),
                              "-s", "2", "-e", "1"], "out.fq.e1.fq")):
            rows = os.path.join(d, "rows")
            with open(rows, "w") as fh, contextlib.redirect_stdout(fh):
                secs[what] = counted(what, lambda: cli.main(
                    base + extra + ["-o", out]))
            same(rows, name, what)
        reads = ["-fa", os.path.join(gold, "reads.fa")]
        secs["-ka"] = counted("-ka", lambda: cli.main(
            base + reads + ["-ka", "-o", out]))
        same(out + ".trkmc.ar", "out.trkmc.ar", "-ka")
        same(out + ".tr.summary.txt", "out.tr.summary.txt", "-ka")
        secs["okam"] = counted("okam", lambda: cli.main(
            base + reads + ["-o", out + "k"]))
        same(out + "k.kam", "out.kam", "okam")
        ck = os.path.join(d, "ck.npz")
        what = "-ka --checkpoint"
        secs[what] = counted(what, lambda: cli.main(
            base + reads + ["-ka", "--checkpoint", ck, "-o", out + "c"]))
        same(out + "c.trkmc.ar", "out.trkmc.ar", "-ka --checkpoint")

        class Stop(Exception):
            pass

        cfg = AlignConfig(ksize=21, cth=20, n_filter=4, nm_filter=1,
                          okam=False)
        ck2 = os.path.join(d, "ck2.npz")
        r1 = DeviceAlignRunner(RPGG(pan), cfg, batch_pairs=512)
        inner, n = r1.step, [0]

        def step(*a):
            if n[0] >= 5:
                raise Stop()
            n[0] += 1
            return inner(*a)

        r1.step = step
        try:
            r1.run_file(os.path.join(gold, "reads.fa"), checkpoint=ck2,
                        checkpoint_every=1024)
            fail("phase 4b: the stopped run was not stopped")
        except Stop:
            pass
        cursor = int(np.load(ck2)["cursor"])
        r2 = DeviceAlignRunner(RPGG(pan), cfg, batch_pairs=512)
        secs["resume"] = counted("resume", lambda: r2.run_file(
            os.path.join(gold, "reads.fa"), checkpoint=ck2,
            checkpoint_every=1024))
        r2.write_trkmc_ar(out + "r.trkmc.ar")
        r2.write_summary(out + "r.tr.summary.txt")
        same(out + "r.trkmc.ar", "out.trkmc.ar", "resumed run")
        same(out + "r.tr.summary.txt", "out.tr.summary.txt", "resumed run")
    log(f"[4b] golden Python ingest (run_file) on cuda through the CLI: "
        f"-e 2 and -fq -s 2 -e 1 rows on stdout, -ka .trkmc.ar and "
        f".tr.summary.txt, okam .kam, -ka --checkpoint in one go, and "
        f"stopped at pair {cursor} and resumed (batch_pairs=512): all "
        f"byte-equal; seconds {secs}; phase_s={time.time() - t_phase:.1f} "
        f"launches {total}; card {smi}")
    return total


def analysis_phase(gold: str, smi: str) -> dict:
    """Phase 4d: the downstream analyses on cuda, in this process.  (a)
    ``align --device --native-io --prefilter -ka -bu -on`` of the
    planted-variant reads over the golden panel (tests/golden_analysis/,
    written by danbing_tk_tpu_torch/tools/analysis_scenario.py), its
    .tr.kmers and .bub.kmdb byte-equal to the JAX package's, KA-KD and KG
    launched; the harness's .bub text and count-only file; ``ktools
    raava`` (.bi_tr/.bi_fl.kdb byte-equal to tests/golden/); ``call
    --torch-device cuda`` (both SVM stages on the card), the callset equal
    to the JAX package's, and again with mc.svm and with the stratified
    and uniform DummyClassifier pickles as both models; (b) ``length``
    byte-equal to the golden TSV, and
    ``eqtl`` over the committed raw genotype cache: every non-float field
    equal and every %.4e field within one unit of its last digit (scipy's
    t.sf may differ between versions), and the genotype files' columns in
    this file system's glob order each equal to the cache's column of its
    genome; (c) both golden SVMs on 100,000 seeded rows each (a
    production batch's row count; the golden models have 11 and 49
    support vectors, not a production model's), on cuda and on the CPU:
    the cuda labels equal sklearn's (tests/golden_analysis/svm_labels.npy)
    and the CPU's, the largest decision difference, ms.
    Returns the align run's launch counts."""
    import contextlib
    import glob
    import io
    import pickle
    import shutil

    import numpy as np
    import scipy
    import torch

    from danbing_tk_tpu_torch.analysis.eqtl_pipeline import (
        read_genotype_matrix)
    from danbing_tk_tpu_torch.apps import cli
    from danbing_tk_tpu_torch.kernels import build
    from danbing_tk_tpu_torch.models.svm import load_model
    from danbing_tk_tpu_torch.tools import analysis_scenario as sc

    t_phase = time.time()
    ga = os.path.join(ROOT, "tests", "golden_analysis")
    secs = {}

    def same(path, want, what):
        with open(path, "rb") as f, open(want, "rb") as g:
            if f.read() != g.read():
                fail(f"phase 4d {what}: {os.path.basename(path)} differs "
                     f"from {os.path.relpath(want, ROOT)}")

    with tempfile.TemporaryDirectory(prefix="dtk_smoke_") as d:
        out = os.path.join(d, "out")
        reads = sc.gunzip(os.path.join(ga, "reads.fa.gz"),
                          os.path.join(d, "reads.fa"))
        build.reset_launch_counts()
        t0 = time.time()
        with contextlib.redirect_stderr(io.StringIO()):
            cli.main(["align", "--device", "--native-io", "--prefilter",
                      "-ka", "-bu", "-cth", "20", "-kf", "4", "1", "-qs",
                      os.path.join(gold, "pan"), "-fa", reads, "-on", out])
        torch.cuda.synchronize()
        launches = build.launch_counts()
        secs["align"] = time.time() - t0
        if min(launches[t] for t in COUNTING + ("KG",)) <= 0:
            fail(f"phase 4d align -bu skipped a kernel: {launches}")
        for x in (".tr.kmers", ".bub.kmdb"):
            same(out + x, os.path.join(ga, "out" + x), "align -bu")
        t0 = time.time()
        sc.bub_text(out + ".bub.kmdb", os.path.join(d, "gt.bub"))
        sc.counts_text(out + ".tr.kmers", os.path.join(d, "gt.counts"))
        pan = os.path.join(d, "pan")
        for x in (".tr.kmers", ".fl.kmers", ".reindex.tr.kmers"):
            os.symlink(os.path.join(gold, "pan" + x), pan + x)
        cli.main(["ktools", "raava", pan, "21"])
        for x in (".bi_tr.kdb", ".bi_fl.kdb", ".reindex.tr.kdb"):
            same(pan + x, os.path.join(gold, "pan" + x), "ktools raava")
        secs["bub+raava"] = time.time() - t0
        ncalled = {}
        # the binary bubble-path model, the 3-class one (mc.svm), and the
        # sampled DummyClassifiers as both models (labels drawn on the
        # host from the pickled random states, as sklearn draws them)
        for br, bp, golden in (
                ("br", "bp", "callset.txt"), ("br", "mc", "callset.mc.txt"),
                ("br.stratified", "bp.stratified", "callset.stratified.txt"),
                ("br.uniform", "bp.uniform", "callset.uniform.txt")):
            t0 = time.time()
            with contextlib.redirect_stderr(io.StringIO()):
                cli.main(["call", pan, os.path.join(d, "gt.counts"),
                          out + ".tr.kmers", os.path.join(d, "gt.bub"),
                          os.path.join(ga, f"{br}.svm"),
                          os.path.join(ga, f"{bp}.svm"),
                          os.path.join(d, "calls.pickle"),
                          "--torch-device", "cuda"])
            torch.cuda.synchronize()
            secs[f"call {bp}"] = time.time() - t0
            with open(os.path.join(d, "calls.pickle"), "rb") as f:
                calls = pickle.load(f)
            with open(os.path.join(ga, golden)) as f:
                if sc.callset_text(calls) != f.read():
                    fail(f"phase 4d: call's callset with {br}.svm and "
                         f"{bp}.svm differs from "
                         f"tests/golden_analysis/{golden}")
            ncalled[bp] = {li: len(v[0]) for li, v in sorted(calls.items())}

        # ---- (b) length and eqtl ----
        t0 = time.time()
        with contextlib.redirect_stderr(io.StringIO()):
            cli.main(["length"] + sc.length_argv(
                os.path.join(ga, "length"), os.path.join(d, "length")))
        same(os.path.join(d, "length", "estimated_TR_len.tsv"),
             os.path.join(ga, "length", "estimated_TR_len.tsv"), "length")
        secs["length"] = time.time() - t0
        t0 = time.time()
        eq, eqin = os.path.join(d, "eqtl"), os.path.join(ga, "eqtl")
        os.makedirs(eq)
        for name in ("ctrl.cov", "rawGenotype.pickle"):
            shutil.copy(os.path.join(eqin, name), eq)
        with contextlib.redirect_stderr(io.StringIO()):
            cli.main(["eqtl"] + sc.eqtl_argv(eqin, eq))
        worst = 0.0
        for t in sc.EQ_TISSUES:
            name = f"{t}.v8.egenes.txt"
            got = open(os.path.join(eq, name)).read().splitlines()
            want = open(os.path.join(eqin, name)).read().splitlines()
            if len(got) != len(want) or got[:1] != want[:1]:
                fail(f"phase 4d eqtl: {name} has {len(got)} lines, the "
                     f"golden {len(want)}")
            for gl, wl in zip(got[1:], want[1:]):
                gf, wf = gl.split("\t"), wl.split("\t")
                if gf[:10] != wf[:10]:
                    fail(f"phase 4d eqtl: {name} row {wl!r} is {gl!r}")
                for a, b in zip(gf[10:], wf[10:]):
                    exp = min(int(a.split("e")[1]), int(b.split("e")[1]))
                    worst = max(worst, abs(float(a) - float(b))
                                / 10.0 ** (exp - 4))
        if worst > 1.0 + 1e-6:
            fail(f"phase 4d eqtl: a %.4e field is {worst:.2f} units of its "
                 f"last digit from the golden")
        gen = os.path.join(eqin, "gen")
        genomes = open(os.path.join(eqin, "genomes.txt")).read().split()
        with open(os.path.join(eqin, "rawGenotype.pickle"), "rb") as f:
            raw = pickle.load(f)
        cols = read_genotype_matrix(gen, raw.shape[0], len(genomes))
        for fi, fn in enumerate(glob.glob(f"{gen}/*.tr.kmers")):
            g = genomes.index(os.path.basename(fn).split(".")[0])
            if not np.array_equal(cols[:, fi], raw[:, g]):
                fail(f"phase 4d eqtl: genotype column {fi} ({fn}) is not "
                     f"the raw cache's column {g}")
        secs["eqtl"] = time.time() - t0

    # ---- (c) the golden SVMs at a production batch's row count ----
    n = sc.SVM_ROWS
    Xr, Xp = sc.svm_batch(n, sc.SEED)
    sk = sc.read_labels(os.path.join(ga, "svm_labels.npy"))
    sk["mc"] = np.load(os.path.join(ga, "mc_labels.npy"))
    svm_line = []
    for name, X in (("br", Xr), ("bp", Xp), ("mc", Xp)):
        path = os.path.join(ga, f"{name}.svm")
        m_gpu, m_cpu = load_model(path, "cuda"), load_model(path, "cpu")
        xg, xc = torch.from_numpy(X).cuda(), torch.from_numpy(X)
        t0 = time.perf_counter()
        lc = m_cpu.predict(xc)
        cpu_ms = (time.perf_counter() - t0) * 1e3
        dg = m_gpu.ovo_decision(xg)
        lg = m_gpu.predict(xg).cpu()
        nsk = int((lg != torch.from_numpy(sk[name])).sum())
        if nsk:
            fail(f"phase 4d {name}.svm: {nsk} of {n} cuda labels differ "
                 f"from sklearn's (tests/golden_analysis/"
                 f"{'mc' if name == 'mc' else 'svm'}_labels.npy)")
        if not torch.equal(lg, lc):
            fail(f"phase 4d {name}.svm: {int((lg != lc).sum())} of {n} "
                 f"labels differ between cuda and the CPU")
        diff = float((dg.cpu() - m_cpu.ovo_decision(xc)).abs().max())
        ms = cuda_ms(lambda: m_gpu.predict(xg), n=5, reps=3)
        nclass = len(m_gpu.classes_)
        svm_line.append(
            f"{name}.svm ({m_gpu.kernel}, {nclass} classes, "
            f"{m_gpu.support_vectors_.shape[0]} SVs x "
            f"{m_gpu.n_features_in_}) rows={n} labels by class="
            f"{torch.bincount(lc.long(), minlength=nclass).tolist()} = "
            f"sklearn's = the CPU's, max |ovo decision cuda - cpu|="
            f"{diff:.3e}, cuda ms={ms:.3f} cpu ms={cpu_ms:.1f}")
    log(f"[4d] (a) align -bu of 4,442 planted-variant read pairs on cuda: "
        f".tr.kmers and .bub.kmdb "
        f"byte-equal, raava byte-equal, call --torch-device cuda callsets "
        f"= the JAX package's with bp.svm, with the 3-class mc.svm and "
        f"with the stratified and uniform DummyClassifiers (edges by "
        f"locus {ncalled}); (b) length "
        f"byte-equal, eqtl within {worst:.3f} units of the last digit "
        f"(numpy {np.__version__} scipy {scipy.__version__}; goldens from "
        f"numpy 2.0.2 scipy 1.17.0); (c) {'; '.join(svm_line)}; seconds "
        f"{ {k: round(v, 2) for k, v in secs.items()} } phase_s="
        f"{time.time() - t_phase:.1f} launches {launches}; card {smi}")
    return launches


def warmup_cli(gold: str, smi: str) -> None:
    """Phase 4e: ``python -m danbing_tk_tpu_torch warmup`` on cuda over the
    golden panel at P = 4096, L = 160, the prefilter and the E = 4096
    tier, in counting (-ka) and okam (-b -qc -bu -fq) form, two processes
    at once over phase 2's build cache: each exits 0, reports every
    library cached and prints the JAX command's lines."""
    t0 = time.time()
    from danbing_tk_tpu_torch.kernels import build

    base = ["-qs", os.path.join(gold, "pan"), "-P", "4096", "-L", "160",
            "--prefilter", "--retry-expand", "4096"]
    forms = {"-ka": ["-ka"],
             "okam": ["-b", "-qc", os.path.join(gold, "qc.txt"), "-bu",
                      "-fq", os.path.join(gold, "reads.sim.fq")]}
    env = dict(os.environ, PYTHONPATH=ROOT,
               DTK_COMPILE_CACHE=build.BUILD_ROOT)
    procs = {name: subprocess.Popen(
        [sys.executable, "-m", "danbing_tk_tpu_torch", "warmup"] + base
        + flags, cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for name, flags in forms.items()}
    want = ["align step P=4096 E=512 compiled+cached in",
            "retry tier step P=2048 E=4096 compiled+cached in",
            "prefilter P=16384 compiled+cached in",
            f"warmup done -> {build.BUILD_ROOT}"]
    libs = list(build.KERNELS) + ["dtk_native", "dtk_thread", "dtk_align"]
    firsts = {}
    for name, p in procs.items():
        try:
            _, err = p.communicate(timeout=120)
        except subprocess.TimeoutExpired:
            p.kill()
            p.communicate()
            fail(f"phase 4e warmup {name} did not finish in 120 s")
        if p.returncode != 0:
            print(err[-3000:], file=sys.stderr)
            fail(f"phase 4e warmup {name} exited {p.returncode}")
        lines = err.splitlines()
        missing = [w for w in want if not any(w in x for x in lines)] + [
            f"warmup: {lib} cached" for lib in libs
            if f"warmup: {lib} cached" not in lines]
        if missing:
            print(err[-3000:], file=sys.stderr)
            fail(f"phase 4e warmup {name}: no line {missing}")
        firsts[name] = [x.split("warmup: ")[1] for x in lines
                        if "compiled+cached" in x]
    wall = time.time() - t0
    log(f"[4e] warmup CLI on cuda (-ka; -b -qc -bu -fq), two processes: "
        f"exit 0, all {len(libs)} libraries cached, the JAX lines present: "
        f"{firsts}; phase_s={wall:.1f}; card {smi}")


def golden_qc_stages(smi: str) -> dict:
    """Phase 4c (a): tests/golden_qc's stages 3-8 through the CLI on cuda,
    from its frozen *.annot.fa and 1-locus pan: extract (-cth 5 -e 1, rows
    on stdout), raw map (-cth 10 -c 40 -s 2), baitbuilder v1.pf (--tp for
    each genome, both profiles for the control hs1) and v2, ktools
    serialize-bt and the bait map (-b): every file byte-equal to
    tests/golden_qc/.  Returns the align calls' launch counts; each of
    them must have launched KA-KD, and the bait maps KF."""
    import contextlib

    import torch

    from danbing_tk_tpu_torch.apps import cli
    from danbing_tk_tpu_torch.kernels import build

    t_phase = time.time()
    gqc = os.path.join(ROOT, "tests", "golden_qc")
    gs, ref = ("HG002", "hs1"), "hs1"
    total: dict = {}

    def align(what, argv, need=COUNTING):
        build.reset_launch_counts()
        cli.main(["align", "-qs", pan] + argv + ["--device"])
        torch.cuda.synchronize()
        c = build.launch_counts()
        if min(c[t] for t in need) <= 0:
            fail(f"phase 4c (a) {what} skipped a kernel: {c}")
        for key, v in c.items():
            total[key] = total.get(key, 0) + v

    with tempfile.TemporaryDirectory(prefix="dtk_smoke_") as d:
        for suf in (".kmers.dbi", ".fl.kdb", ".tre.kdb", ".tr.kmers"):
            os.symlink(os.path.join(gqc, "pan" + suf),
                       os.path.join(d, "pan" + suf))
        pan = os.path.join(d, "pan")
        out = {g: os.path.join(d, g) for g in gs}
        for g in gs:
            with open(out[g] + ".extract.fa", "w") as fh, \
                    contextlib.redirect_stdout(fh):
                align(f"{g} -e 1", ["-cth", "5", "-e", "1", "-fa",
                                    os.path.join(gqc, f"{g}.annot.fa")])
            align(f"{g} raw", ["-cth", "10", "-c", "40", "-s", "2", "-fa",
                               out[g] + ".extract.fa", "-o",
                               out[g] + ".raw"])
            cli.main(["baitbuilder", "v1.pf", "--kam", out[g] + ".raw.kam",
                      "--nloci", "1", "--out",
                      os.path.join(d, f"profile.{g}"), "--tp"])
        cli.main(["baitbuilder", "v1.pf", "--kam", out[ref] + ".raw.kam",
                  "--nloci", "1", "--out", os.path.join(d, f"map.{ref}")])
        cli.main(["baitbuilder", "v2", "--nloci", "1", "--out",
                  os.path.join(d, "FPSkmer.v0.tsv"), "--fp-pf",
                  os.path.join(d, f"map.{ref}.FP_pf.txt"), "--tp-pfs",
                  os.path.join(d, f"map.{ref}.TP_pf.txt")]
                 + [os.path.join(d, f"profile.{g}.TP_pf.txt") for g in gs])
        cli.main(["ktools", "serialize-bt", os.path.join(d, "FPSkmer.v0.tsv"),
                  "1", pan])
        for g in gs:
            align(f"{g} -b", ["-b", "-cth", "10", "-c", "40", "-s", "2",
                              "-fa", out[g] + ".extract.fa", "-o",
                              out[g] + ".bait"], QC)
        names = ["FPSkmer.v0.tsv", "pan.bt.kmdb", f"map.{ref}.FP_pf.txt",
                 f"map.{ref}.TP_pf.txt"] + [
            f"profile.{g}.TP_pf.txt" for g in gs]
        for g in gs:
            names += [f"{g}.extract.fa"] + [
                f"{g}.{st}{x}" for st in ("raw", "bait")
                for x in (".kam", ".trkmc.ar", ".tr.summary.txt")]
        for name in names:
            with open(os.path.join(d, name), "rb") as f, \
                    open(os.path.join(gqc, name), "rb") as g:
                if f.read() != g.read():
                    fail(f"phase 4c (a): {name} differs from "
                         f"tests/golden_qc/{name}")
    log(f"[4c] (a) golden_qc stages 3-8 on cuda through the CLI: "
        f"{len(names)} files byte-equal to tests/golden_qc/; "
        f"phase_s={time.time() - t_phase:.1f} launches {total}; card {smi}")
    return total


def start_build_qc() -> dict:
    """Phase 4c (b), started after phase 2's kernel build: the seeded
    scenario built and QC'd through the CLI with --device on cuda by one
    worker process (tools/build_scenario.py --run --device), each align
    call held to the host engine's (the same argv without --device: stdout
    and files byte-equal).  It runs beside phase 2's scale index build and
    is joined before phase 3, so no kernel window of this script is taken
    while it uses the card or the host."""
    root = tempfile.mkdtemp(prefix="dtk_smoke_bq_")
    log_f = open(os.path.join(root, "run.log"), "w")
    p = subprocess.Popen(
        [sys.executable, "-m", "danbing_tk_tpu_torch.tools.build_scenario",
         "--out", os.path.join(root, "run"), "--nloci", str(BQ_NLOCI),
         "--run", "--cov", str(BQ_COV), "-p", str(BQ_PROCS), "--device",
         "--torch-device", "cuda"], cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=ROOT), stdout=log_f,
        stderr=subprocess.STDOUT)
    log(f"[2] phase 4c (b) started: build + qc --device of {BQ_NLOCI} loci "
        f"in a worker process, each align call held to the host engine")
    return dict(root=root, proc=p, log=log_f, t0=time.time())


def start_bench_data() -> dict:
    """Phase 8d's data, started after phase 2's kernel build: the bench's
    512-locus synthetic panel and its reads file of BENCH_PAIRS pairs,
    built by ``bench_panel_funnel --prepare`` (host code, no card work) in
    a worker process beside phase 2's scale index build, into a
    directory of its own."""
    root = tempfile.mkdtemp(prefix="dtk_smoke_bench_")
    log_f = open(os.path.join(root, "prepare.log"), "w")
    p = subprocess.Popen(
        [sys.executable, "-m", "danbing_tk_tpu_torch.tools.bench_panel_funnel",
         "--prepare"], cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=ROOT, DTK_BENCH_BUILD=root,
                 DTK_BENCH_E2E_PAIRS=str(BENCH_PAIRS)),
        stdout=log_f, stderr=subprocess.STDOUT)
    log(f"[2] phase 8d's data started: the bench's 512-locus panel and "
        f"{BENCH_PAIRS} pairs in a worker process")
    return dict(root=root, proc=p, log=log_f, t0=time.time())


def bench_phase(bd: dict, smi: str) -> dict:
    """Phase 8d: ``python -m danbing_tk_tpu_torch bench`` on the card at
    the primary metric's shapes with BENCH_PAIRS pairs (its data from
    start_bench_data's worker).  Fails unless it exits 0 with the primary
    metric's line last (value > 0, passes >= 1) and the real-panel skip
    line on stderr.  Returns its last timed pass's launches."""
    from danbing_tk_tpu_torch.kernels import build
    from danbing_tk_tpu_torch.tools.bench_panel_funnel import LAUNCHES_TAG

    t_wait = time.time()
    try:
        rc = bd["proc"].wait(timeout=300)
    except subprocess.TimeoutExpired:
        fail("phase 8d's data worker did not finish in 300 s")
    bd["log"].close()
    with open(bd["log"].name) as f:
        prep = [ln for ln in f.read().splitlines() if ln.startswith("#")]
    if rc != 0:
        fail(f"phase 8d's data worker exited {rc}: {prep[-5:]}")
    log(f"[8d] data: {'; '.join(ln[2:] for ln in prep)} (the worker "
        f"started {t_wait - bd['t0']:.1f}s before the join, which waited "
        f"{time.time() - t_wait:.1f}s)")
    env = dict(os.environ, PYTHONPATH=ROOT, DTK_BENCH_BUILD=bd["root"],
               DTK_BENCH_E2E_PAIRS=str(BENCH_PAIRS), DTK_PF_PASSES="3",
               DTK_BENCH_SCALE="0", DTK_QUIESCE_TIMEOUT="5")
    t0 = time.time()
    try:
        r = subprocess.run([sys.executable, "-m", "danbing_tk_tpu_torch",
                            "bench"], cwd=ROOT, env=env, capture_output=True,
                           text=True, timeout=300)
    except subprocess.TimeoutExpired:
        fail("phase 8d: bench did not finish in 300 s")
    secs = time.time() - t0
    err = r.stderr.splitlines()
    out = r.stdout.strip().splitlines()
    if r.returncode != 0 or not out:
        print("\n".join(err[-40:]), file=sys.stderr)
        fail(f"phase 8d: bench exited {r.returncode}")
    last = json.loads(out[-1])
    if last.get("metric") != "wgs_funnel_reads_per_sec_per_chip" \
            or not last.get("value", 0) > 0 or last.get("passes", 0) < 1:
        fail(f"phase 8d: bench's last line is {out[-1]}")
    if not any(ln.startswith("# real-panel funnel (wgs_funnel_real_panel_"
                             "reads_per_sec) skipped: ") for ln in err):
        fail("phase 8d: bench printed no real-panel skip line")
    tagged = [ln for ln in err if LAUNCHES_TAG in ln]
    if not tagged:
        fail("phase 8d: the panel worker printed no launches")
    launches = dict.fromkeys(build.launch_counts(), 0)
    launches.update(json.loads(tagged[-1].split(LAUNCHES_TAG, 1)[1]))
    for t in ("KK[q]",) + COUNTING:
        if launches[t] <= 0:
            fail(f"phase 8d: bench's timed pass skipped {t}: {launches}")
    for ln in err:
        if "warm pass (incl" in ln or "steady median" in ln:
            log(f"[8d] {ln[2:]}")
    log(f"[8d] bench line: {out[-1]}; phase_s={secs:.1f} pairs={BENCH_PAIRS} "
        f"launches {launches}; card {smi}")
    return launches


def geometry_phase(dev, smi: str, scale: dict) -> dict:
    """Phase 8f: the genome-wide geometry (tools/full_index_probe.py) on a
    world-1 NCCL group.  Builds the full index's dbi level 0 with planted
    keys, uploads it in pinned chunks, drives its probes, prefilters and
    counting step once (their launches, the counts set to 0 just before,
    are returned: the ``full_geometry`` path), holds them against the
    host lookup, the host's decisions and the compact index's state, then
    replays each kernel against its plain version and times it beside
    its bound and its scale-index time (``scale``: phase 3's and 5s's
    results, which gain a ``full_geometry`` entry)."""
    import torch
    import torch.distributed as dist

    from danbing_tk_tpu_torch.kernels import build
    from danbing_tk_tpu_torch.parallel.mesh import make_mesh
    from danbing_tk_tpu_torch.tools import full_index_probe as fip

    t_phase = t0 = time.time()
    log(f"[8f] device memory held before the phase: "
        f"{torch.cuda.memory_allocated()} B")
    geo = fip.build_geometry()
    drp = geo["drp"]
    lv0 = drp.dbi_tab.levels[0][0]
    log(f"[8f] geometry: dbi level 0 {lv0.shape[0]} buckets x "
        f"{lv0.shape[1]} u32 = {lv0.nbytes} B, {geo['nkeys']} keys of "
        f"{len(geo['loci'])} planted loci (first {geo['loci'][:3].tolist()},"
        f" last {geo['loci'][-3:].tolist()}), {len(drp.vv)} vv entries, "
        f"trfl {drp.trfl_tab.nbytes} B, count state {drp.nslots} slots; "
        f"host build {time.time() - t0:.1f}s")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    up = drp.tables(dev)["dbi"].uploads
    torch.cuda.synchronize()
    if not up or up[0]["nbytes"] != lv0.nbytes:
        fail(f"phase 8f: the {lv0.nbytes}-B level did not go through the "
             f"chunked upload: {up}")
    log(f"[8f] upload: level 0 {up[0]['nbytes']} B in "
        f"{up[0]['seconds']:.2f}s = {up[0]['gbps']:.2f} GB/s (pinned "
        f"chunks; the rows are made on the host as they are read), all "
        f"tables {time.time() - t0:.2f}s; device memory "
        f"{torch.cuda.memory_allocated()} B")
    mesh = make_mesh(device=dev)
    try:
        build.reset_launch_counts()
        t0 = time.time()
        ctx = fip.drive(drp, geo["seqs"], dev, mesh, B=65_536, pairs=16_384,
                        geo=geo, P=4096)
        torch.cuda.synchronize()
        launches = build.launch_counts()
        t_drive = time.time() - t0
        try:
            res = fip.verify(ctx, geo)
        except AssertionError as e:
            fail(f"phase 8f: {e}")
        if res["slots_above_2_30"] <= 0:
            fail(f"phase 8f: no count landed past slot 2^30: {res}")
        log(f"[8f] checks = the host and the compact index: {res}; drive "
            f"{t_drive:.1f}s, launches {launches}")
        for t in ("KA", "KB", "KL", "KC", "KD", "KM", "KI", "KI[count]",
                  "KK", "KK[q]", "KK[sample]", "KL[decide]"):
            if launches[t] <= 0:
                fail(f"phase 8f: the geometry run skipped {t}: {launches}")
        try:
            kres = fip.compare_kernels(ctx, timer=cuda_ms)
        except AssertionError as e:
            fail(f"phase 8f: {e}")
    finally:
        dist.destroy_process_group()
    # each kernel beside its scale-index time (phase 3, 5s)
    at_scale = {"KB": ("KB", "ms"), "KI[D=4]": ("KI", "ms"),
                "KI[D=1]": ("KI", "d1_ms"),
                "KI[count] D=1 block 0": ("KI[count]", "ms"),
                "KL[decide]": ("KL[decide]", "ms"), "KK[q]": ("KK[q]", "ms"),
                "KK": ("KK", "ms"), "KK[sample]": ("KK[sample]", "ms"),
                "KA": ("KA", "ms"), "KL": ("KL", "ms"), "KC": ("KC", "ms"),
                "KD": ("KD", "ms")}
    for name, r in kres.items():
        ref = at_scale.get(name)
        sms = scale[ref[0]].get(ref[1]) if ref else None
        log(f"[8f] {name} match=True max_abs_err=0 ms={r['ms']:.4f} "
            f"plain_ms={r['plain_ms']:.4f} bound_ms={r['bound_ms']:.4f} "
            f"rows={r.get('rows', '-')} bytes={r['bytes']} scale_index_ms="
            f"{'-' if sms is None else f'{sms:.4f}'}; card {smi}")
        if ref:
            scale[ref[0]].setdefault("full_geometry", {})[name] = dict(
                ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                rows=r.get("rows"))
    peak = torch.cuda.max_memory_allocated()
    del ctx, geo, drp
    log(f"[8f] genome-wide geometry: every kernel = its plain version and "
        f"the host; max_memory_allocated={peak} B; "
        f"phase_s={time.time() - t_phase:.1f}; card {smi}")
    return launches


def start_table_builds(nloci: int, seed: int) -> dict:
    """Phase 6's graph table and phase 7's tre table (host numpy, pure
    functions of the index's sequences), built one after the other in a
    thread beside phase 2's index build (numpy's sorts and copies release
    the interpreter lock) and joined before phase 3, so no kernel window
    is taken while it runs; the tables stay on the host until their
    phases upload them."""
    import threading

    from danbing_tk_tpu_torch.tools.scale_index import (
        build_scale_graph, build_scale_tre, scale_seqs)

    box: dict = {"t0": time.time()}

    def run():
        try:
            seqs = scale_seqs(nloci, 1500, seed=seed)
            for name, fn in (("graph", build_scale_graph),
                             ("tre", build_scale_tre)):
                t0 = time.time()
                box[name] = (fn(seqs, verbose=False), time.time() - t0)
        except BaseException as e:        # re-raised by the join
            box["error"] = e

    box["thread"] = threading.Thread(target=run, daemon=True)
    box["thread"].start()
    return box


def finish_table_builds(box: dict) -> None:
    """Joins start_table_builds' thread; fails if it raised."""
    t_wait = time.time()
    box.pop("thread").join()
    if "error" in box:
        fail(f"the graph and tre table builds raised {box['error']!r}")
    log(f"[2] graph and tre tables built beside the index in "
        f"{box['graph'][1]:.1f}s and {box['tre'][1]:.1f}s (started "
        f"{t_wait - box.pop('t0'):.1f}s before the join, which waited "
        f"{time.time() - t_wait:.1f}s)")


def finish_build_qc(bq: dict, smi: str) -> dict:
    """Phase 4c (b), joined before phase 3: waits for the run, checks that
    every align call was held to the host engine, that the decoys made an
    FPSkmer and that the bait map dropped pairs; prints each stage's
    seconds, each align call's seconds and pairs, and the launches.
    Returns the launch counts by path."""
    t_wait = time.time()
    try:
        rc = bq["proc"].wait(timeout=600)
    except subprocess.TimeoutExpired:
        fail("phase 4c (b) did not finish in 600 s")
    waited = time.time() - t_wait
    bq["log"].close()
    with open(bq["log"].name) as f:
        lines = f.read().splitlines()
    if rc != 0 or not lines:
        print("\n".join(lines[-40:]), file=sys.stderr)
        fail(f"phase 4c (b) exited {rc}")
    r = json.loads(lines[-1])
    if len(r["aligns"]) != 7 or not all("host_s" in a for a in r["aligns"]):
        fail(f"phase 4c (b): not every align call was held to the host "
             f"engine: {r['aligns']}")
    qc_dir = os.path.join(bq["root"], "run", "qc")

    def rows(name):
        with open(os.path.join(qc_dir, name)) as f:
            return sum(1 for _ in f)

    n_fps = rows("FPSkmer.v0.tsv")
    ctrl = "g1"
    raw, bait = rows(f"{ctrl}.raw.kam"), rows(f"{ctrl}.bait.kam")
    if n_fps == 0 or bait >= raw:
        fail(f"phase 4c (b): FPSkmer rows {n_fps}, control raw.kam rows "
             f"{raw}, bait.kam rows {bait}")
    launches = r["launches"]
    for path, need in (("build_prune", BUILD_PRUNE), ("qc", QC)):
        if min(launches[path][t] for t in need) <= 0:
            fail(f"phase 4c (b) {path} skipped a kernel: {launches[path]}")
    nfiles = sum(a["files"] for a in r["aligns"])
    log(f"[4c] (b) scenario: nloci={r['nloci']} genomes=2 k=21 FS=700 "
        f"TRWINDOW=800 bases={r['nbases']} prune_pairs={r['prune_pairs']} "
        f"qc_cov={BQ_COV} mbe_procs={BQ_PROCS}; 7 align calls --device == "
        f"host engine, {nfiles} outputs byte-equal; FPSkmer rows={n_fps}, "
        f"{ctrl} raw.kam rows={raw} bait.kam rows={bait}; run wall="
        f"{r['wall']:.1f}s (started {t_wait - bq['t0']:.1f}s before the "
        f"join, which waited {waited:.1f}s); card {smi}")
    host = {k: round(v, 2) for k, v in r["stages"].items()}
    aligns = [f"{a['stage']}:{a['what']} pairs={a['pairs']} "
              f"s={a['s']:.2f} host_engine_s={a['host_s']:.2f}"
              for a in r["aligns"]]
    log(f"[4c] (b) build={r['build_s']:.1f}s qc={r['qc_s']:.1f}s; host stage "
        f"seconds {host}; align calls: {'; '.join(aligns)}")
    log(f"[4c] (b) launches: build_prune {launches['build_prune']} qc "
        f"{launches['qc']}")
    return launches


def python_ingest_scale(drp, flat, batches, cfg, P, L, E, dev,
                        smi: str) -> dict:
    """Phase 5b: the first 65,536 pairs of phase 5 as a FASTA file,
    through run_file (Python ingest, -ka) and run_file_native (prefilter)
    at full width, each over a fresh copy of phase 5's flat view (the
    view is not built again): equal counts, every flagged pair resolved;
    then -e 2 through run_file on the first 512 pairs, rows equal to the
    HostAligner's over the flat view.  Returns run_file's launch counts."""
    import dataclasses
    import io

    import numpy as np
    import torch

    from danbing_tk_tpu_torch.engine.align_runner import DeviceAlignRunner
    from danbing_tk_tpu_torch.engine.host_align import HostAligner
    from danbing_tk_tpu_torch.kernels import build

    t_phase = time.time()
    decode = np.frombuffer(b"ACGT" + b"N" * 252, dtype=np.uint8)
    npairs = 65_536

    def write_fasta(path, n):
        rows, got = [], 0
        for codes, rlen, m in batches:
            for i in range(min(m, n - got)):
                j = got + i
                # iter_fasta_pairs (and the native reader) take a pair's
                # second record for mate 1
                for mate in (1, 0):
                    r = 2 * i + mate
                    seq = decode[codes[r, : rlen[r]]].tobytes().decode()
                    rows.append(f">p{j}/{mate + 1}\n{seq}\n")
            got += min(m, n - got)
            if got == n:
                break
        with open(path, "w") as f:
            f.writelines(rows)

    with tempfile.TemporaryDirectory(prefix="dtk_smoke_") as d:
        fa, fa512 = os.path.join(d, "reads.fa"), os.path.join(d, "r512.fa")
        t0 = time.time()
        write_fasta(fa, npairs)
        write_fasta(fa512, 512)
        t_write = time.time() - t0
        runs = {}
        for name in ("run_file", "run_file_native"):
            r = DeviceAlignRunner(flat.renew(), cfg, batch_pairs=P,
                                  max_read_len=L, expand_cap=E, drp=drp,
                                  device=dev)
            torch.cuda.synchronize()
            build.reset_launch_counts()
            t0 = time.time()
            if name == "run_file":
                r.run_file(fa)
            else:
                r.run_file_native(fa, prefilter=True)
            torch.cuda.synchronize()
            wall = time.time() - t0
            c = build.launch_counts()
            if min(c[t] for t in COUNTING) <= 0:
                fail(f"phase 5b {name} skipped a kernel: {c}")
            if r.n_resolved != r.n_referee or not r.n_referee:
                fail(f"phase 5b {name} resolved {r.n_resolved} of "
                     f"{r.n_referee} flagged pairs")
            runs[name] = (r, wall, c)
        (rp, wp, cp), (rn, wn, _) = runs["run_file"], runs["run_file_native"]
        if not np.array_equal(rp.flat_counts(), rn.flat_counts()):
            fail("phase 5b: run_file's counts differ from run_file_native's")
        # -e 2 on the first 512 pairs: device rows vs the HostAligner's
        ecfg = dataclasses.replace(cfg, extract=2)
        t0 = time.time()
        er = DeviceAlignRunner(flat.renew(), ecfg, batch_pairs=P,
                               max_read_len=L, expand_cap=E, drp=drp,
                               device=dev)
        er.run_file(fa512)
        dev_rows = io.StringIO()
        er.write_extract(dev_rows)
        t_edev = time.time() - t0
        t0 = time.time()
        host = HostAligner(flat.renew(), ecfg)
        host.run_file(fa512)
        host_rows = io.StringIO()
        host.write_extract(host_rows)
        t_ehost = time.time() - t0
        if dev_rows.getvalue() != host_rows.getvalue():
            fail("phase 5b: -e 2 rows of run_file differ from the "
                 "HostAligner's over the flat view")
        nrows = dev_rows.getvalue().count("\n") // 4
    log(f"[5b] Python ingest at full width (P={P}, L={L}, E={E}): "
        f"{npairs} pairs of phase 5 as FASTA (written in {t_write:.1f}s); "
        f"run_file reads/s={2 * npairs / wp:.0f} wall={wp:.3f}s "
        f"survivors={rp.n_step_pairs} steps={rp.n_steps} referee="
        f"{rp.n_referee} resolved={rp.n_resolved} referee_s="
        f"{rp.referee_s:.3f}; run_file_native (prefilter) reads/s="
        f"{2 * npairs / wn:.0f} wall={wn:.3f}s survivors={rn.n_step_pairs} "
        f"referee={rn.n_referee} resolved={rn.n_resolved} referee_s="
        f"{rn.referee_s:.3f}; counts equal ({int(rp.flat_counts().sum())} "
        f"TR k-mers); -e 2 on 512 pairs: {nrows} rows equal to the "
        f"HostAligner's (device {t_edev:.1f}s, host {t_ehost:.1f}s, "
        f"referee {er.n_referee}); phase_s={time.time() - t_phase:.1f} "
        f"launches {cp}; card {smi}")
    return cp


def referee_gate(flat, cfg, flagged) -> None:
    """Phase 5's referee gate: the flagged pairs' referee calls through the
    port's NativeReferee and through the Python HostAligner (okam), each
    on a fresh copy of the flat view; their counts, nmapread, kmc, stats
    and .kam rows must be equal."""
    import dataclasses

    import numpy as np

    from danbing_tk_tpu_torch.engine import native_referee as nr
    from danbing_tk_tpu_torch.engine.host_align import HostAligner

    gcfg = dataclasses.replace(cfg, okam=True)
    t0 = time.time()
    py = HostAligner(flat.renew(), gcfg)
    for a in flagged:
        py.process_pair(*a)
    t_py = time.time() - t0
    t0 = time.time()
    nat = HostAligner(flat.renew(), gcfg)
    eng = nr.NativeReferee(nat)
    for a in flagged:
        eng.process_pair(*a)
    t_nat = time.time() - t0
    same = (np.array_equal(py.flat_counts(), nat.flat_counts())
            and np.array_equal(py.nmapread, nat.nmapread)
            and np.array_equal(py.kmc, nat.kmc) and py.stats == nat.stats
            and py.kam_rows == nat.kam_rows)
    if len(flagged) < 256 or not py.kam_rows:
        fail(f"referee gate: {len(flagged)} flagged pairs, "
             f"{len(py.kam_rows)} .kam rows (256 pairs and rows needed)")
    if not same:
        fail(f"referee gate: native and Python referees disagree on "
             f"{len(flagged)} flagged pairs (stats {py.stats} vs "
             f"{nat.stats})")
    log(f"[5] referee gate: {len(flagged)} flagged pairs, native = Python "
        f"referee on the flat view (counts, nmapread, kmc, stats, "
        f"{len(py.kam_rows)} .kam rows equal; counted TR k-mers "
        f"{int(py.flat_counts().sum())}) python_s={t_py:.2f} "
        f"native_s={t_nat:.2f}")


def site_scorer_phase(drp, dev, tbatches, src_loci, view, k, RL):
    """Phase 6c: B = 8192 failure sites (the mates of one P = 4096 step)
    from phase 6's TR pairs, scored on the scale graph table through
    make_site_scorer (the launches counted), KJ held exactly against its
    plain version and both against the host oracle score_site_np on the
    first 256 sites.  Returns KJ's kernels-line entry and the launches."""
    import numpy as np
    import torch

    from danbing_tk_tpu_torch.kernels import build
    from danbing_tk_tpu_torch.ops import correct as cr
    from danbing_tk_tpu_torch.tools import kernel_bounds as kbd
    from danbing_tk_tpu_torch.tools.scale_index import failure_sites

    B, mes = 8192, 2
    t_phase = t0 = time.time()
    sites, n_pairs = failure_sites(tbatches, src_loci, view, k, RL, B)
    if len(sites) < B:
        fail(f"phase 6c: {len(sites)} sites from {n_pairs} TR pairs")
    w_lo, w_hi, nkrem, loc = cr.sites_to_batch(sites, k=k, B=B)
    w = cr.join_w(w_lo, w_hi)
    t_sites = time.time() - t0

    # the path: make_site_scorer over the uploaded graph table
    scorer = cr.make_site_scorer(drp, B, k=k, mes=mes, device=dev)
    build.reset_launch_counts()
    t0 = time.time()
    got = scorer(w, nkrem, loc)
    torch.cuda.synchronize()
    t_first = time.time() - t0
    jlaunches = build.launch_counts()
    if jlaunches["KJ"] <= 0:
        fail(f"the site scorer did not launch KJ: {jlaunches}")

    gtab = drp.tables(dev, graph=True)["graph"]
    args = [torch.from_numpy(a).to(dev) for a in (w, nkrem, loc)]

    def kj():
        return cr.score_sites(gtab, *args, k, mes)

    def plain():
        return cr.score_sites_plain(gtab, *args, k, mes)

    want = plain()
    err = max(max_abs_err(kj(), want), max_abs_err(got, want))
    torch.cuda.synchronize()
    if err != 0:
        fail(f"KJ disagrees with its plain version (max |err| {err})")
    # the host oracle on the view's arrays
    gh = got[:256].cpu().numpy()
    n_edit = 0
    for i, (kms, ki, d) in enumerate(sites[:256]):
        node, mask = view.graphs[d]

        def gbits(km, node=node, mask=mask):
            j = int(np.searchsorted(node, np.uint64(km)))
            if j < len(node) and int(node[j]) == km:
                return True, int(mask[j])
            return False, 0

        ref = cr.score_site_np(gbits, kms, ki, k, mes)
        edit = cr.get_edit_from_counters(ref, mes)
        if not np.array_equal(gh[i], ref) \
                or cr.get_edit_from_counters(gh[i], mes) != edit:
            fail(f"phase 6c: site {i} differs from the host oracle")
        n_edit += edit[0] > 0
    ms = cuda_ms(kj)
    plain_ms = cuda_ms(plain, n=5, reps=2, warm=1)
    # the bound: the distinct graph rows of the probes the counters need
    # (the serial early exit's, at the levels they need under the level
    # stop), the sites' k-mers, nkrem and loc in, the counters out; KJ's
    # rounds of D steps make more probes
    kjc = cr.site_scorer_config()
    site, q = cr.site_probes(gtab, *args, k, mes)
    made = len(cr.site_probes(gtab, *args, k, mes, ahead=kjc["ahead"])[1])
    _, rows, reads = kbd.probe_bytes(gtab, q, args[2][site], stop=True)
    nbytes = rows * 8 * gtab.W * 4 + B * ((k + 3) * 8 + 8 + cr.NCHAINS * 4)
    bound = kbd.bound_ms(nbytes)
    log(f"[6c] KJ site_scorer match=True max_abs_err={err} ms={ms:.4f} "
        f"plain_ms={plain_ms:.4f} bound_ms={bound:.4f} "
        f"us_per_site={1e3 * ms / B:.4f} (host engine ~1.1 ms per corrected "
        f"read, PERF.md) sites={B} from {n_pairs} TR pairs (found in "
        f"{t_sites:.1f}s) mes={mes} probes_needed={len(q)} "
        f"probes_per_site={len(q) / B:.2f} (JAX: 21 + 62k = "
        f"{21 + 62 * k}) KJ {kjc}: probes_made={made} "
        f"({made / B:.2f} a site) distinct_rows={rows} row_reads={reads} "
        f"bytes={nbytes} nonzero_sites={int(got.any(1).sum())} "
        f"oracle_sites=256 with_edit={n_edit} first_call_s={t_first:.3f} "
        f"launches={jlaunches['KJ']} phase_s={time.time() - t_phase:.1f}")
    return dict(match=True, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound, bound_by="bytes", library_ms=None,
                source="danbing_tk_tpu_torch/csrc/site_scorer.cu",
                replaces="danbing_tk_tpu/ops/correct_jax.py:268"), jlaunches


def sharded_phase(args, dev, ctx) -> dict:
    """Phase 5s: the sharded funnel on a world-1 NCCL group.  (a) the
    golden funnel through ShardedAlignRunner (index sharded, E = 128 ->
    512, checkpoints every 64 pairs), a run stopped after three prefilter
    dispatches and resumed, and the CLI with --retry-expand 512
    --checkpoint, all byte-equal; (b) KI on D = 4 row-block views of the
    scale index's dbi, trfl and member tables at the main path's query
    shapes, each block against its plain version and the blocks' sum
    against KB; (c) KC's large-E mode at E = 4096 and P = _tier_P(4096) on
    overflow pairs of the TR pool against pair_vote_plain; (d) phase 5's
    batches through ShardedAlignRunner(shard_index=True, expand_cap=512,
    retry_expand=[4096]), one KK[sample], KI[count] and KL[decide] a
    prefilter dispatch; then on phase 3's dispatch reads KI[count] at D =
    1 and over 4 row blocks against its plain version, and KL[decide]
    after the collective count against its plain version and KK[q]'s
    survivors, and the collective dispatch's window.  Returns the KI,
    KI[count], KC[large-E] and KL[decide] results and the launches of
    (d)."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from danbing_tk_tpu_torch.apps import cli
    from danbing_tk_tpu_torch.engine import device_align as da
    from danbing_tk_tpu_torch.engine.align_runner import (
        Stopped, stop_after_prefilter)
    from danbing_tk_tpu_torch.engine.host_align import AlignConfig, RPGG
    from danbing_tk_tpu_torch.index import device_table as dt
    from danbing_tk_tpu_torch.kernels import build
    from danbing_tk_tpu_torch.ops import kmers as km
    from danbing_tk_tpu_torch.parallel import mesh as pm
    from danbing_tk_tpu_torch.parallel import sharded_index as si
    from danbing_tk_tpu_torch.parallel.runner import ShardedAlignRunner
    from danbing_tk_tpu_torch.tools import kernel_bounds as kbd
    from danbing_tk_tpu_torch.tools.ab_kmers_filter import GRAPH, graph_of
    from danbing_tk_tpu_torch.tools.scale_index import sample_read_batch

    drp, seqs, cap, q_mem, batches = (ctx["drp"], ctx["seqs"], ctx["cap"],
                                      ctx["q_mem"], ctx["batches"])
    P, L, E, k, RL = ctx["P"], ctx["L"], ctx["E"], ctx["k"], ctx["RL"]
    smi = ctx["smi"]
    mesh = pm.make_mesh(device=dev)
    log(f"[5s] mesh: backend={dist.get_backend()} world={mesh.world} "
        f"rank={mesh.rank} device={mesh.device}")

    # ---- (a) golden: funnel, stop + resume, CLI ----
    gold = os.path.join(ROOT, "tests", "golden")
    reads = os.path.join(gold, "reads.fa")
    with open(os.path.join(gold, "out.trkmc.ar"), "rb") as f:
        want = f.read()
    gcfg = AlignConfig(ksize=21, cth=20, n_filter=4, nm_filter=1,
                       okam=False)
    t0 = time.time()

    def golden_runner():
        return ShardedAlignRunner(RPGG(os.path.join(gold, "pan")), gcfg,
                                  mesh=mesh, batch_pairs=64,
                                  max_read_len=192, expand_cap=128,
                                  retry_expand=512, shard_index=True)

    with tempfile.TemporaryDirectory(prefix="dtk_smoke_") as d:
        build.reset_launch_counts()
        r = golden_runner()
        r.run_file_native(reads, prefilter=True,
                          checkpoint=os.path.join(d, "full.npz"),
                          checkpoint_every=64)
        torch.cuda.synchronize()
        gl = build.launch_counts()
        r.write_trkmc_ar(os.path.join(d, "a.trkmc.ar"))
        n_ret = r.n_retried
        r1 = golden_runner()
        stop_after_prefilter(r1, 3)
        ck = os.path.join(d, "stop.npz")
        try:
            r1.run_file_native(reads, prefilter=True, checkpoint=ck,
                               checkpoint_every=64)
            fail("the stopped sharded run did not stop")
        except Stopped:
            pass
        cursor = int(np.load(ck)["cursor"])
        r2 = golden_runner()
        r2.run_file_native(reads, prefilter=True, checkpoint=ck,
                           checkpoint_every=64)
        r2.write_trkmc_ar(os.path.join(d, "b.trkmc.ar"))
        cli.main(["align", "--device", "--native-io", "--prefilter", "-ka",
                  "-cth", "20", "-kf", "4", "1", "--expand-cap", "128",
                  "--retry-expand", "512", "--checkpoint",
                  os.path.join(d, "cli.npz"), "-qs",
                  os.path.join(gold, "pan"), "-fa", reads, "-o",
                  os.path.join(d, "c")])
        for name in ("a", "b", "c"):
            with open(os.path.join(d, f"{name}.trkmc.ar"), "rb") as f:
                if f.read() != want:
                    fail(f"golden sharded run {name}: .trkmc.ar differs "
                         f"from tests/golden/out.trkmc.ar")
    # with the index sharded KI answers every probe (member, dbi, trfl)
    if min(gl[t] for t in SHARDED) <= 0 or n_ret <= 0:
        fail(f"the golden sharded funnel skipped a kernel or the ladder: "
             f"{gl}, retried {n_ret}")
    log(f"[5s-a] golden sharded funnel (shard_index, E=128->512, "
        f"checkpoint every 64 pairs), stop after 3 dispatches at cursor "
        f"{cursor} + resume, and the CLI with --retry-expand 512 "
        f"--checkpoint: .trkmc.ar byte-equal; retried={n_ret}, "
        f"{time.time() - t0:.1f}s, launches {gl}")

    # ---- (b) KI on D = 4 row-block views at the main path's shapes ----
    tabs = drp.tables(dev)
    D = 4

    ki_res = {}
    for tname, (tab, q, loc) in (("dbi", cap["KB_dbi"] + (None,)),
                                 ("trfl", cap["KB_trfl"]),
                                 ("member", (tabs["member"], q_mem, None))):
        real = q.reshape(-1) != -1
        tot = torch.zeros((3, q.numel()), dtype=torch.int64, device=dev)
        worst = None
        for d_, (blk, meta) in enumerate(si.row_blocks(tab, D)):
            got = dt.lookup_bucket_owned(blk, meta, q, loc)
            err = max_abs_err(got, dt.lookup_bucket_owned_plain(blk, meta,
                                                                q, loc))
            if err:
                fail(f"KI[{tname}] block {d_} disagrees with its plain "
                     f"version (max |err| {err})")
            for i, x in enumerate(got):
                tot[i] += x.reshape(-1).long() & 0xFFFFFFFF
            ms = cuda_ms(lambda b=blk, m=meta: dt.lookup_bucket_owned(
                b, m, q, loc))
            if worst is None or ms > worst[0]:
                worst = (ms, d_, blk, meta)
        f, v, v2 = (x.reshape(-1) for x in dt.lookup_bucket(tab, q, loc))
        sum_err = max(int((tot[0][real] > 0).ne(f[real]).sum()),
                      int((tot[1][real] - v[real]).abs().max()),
                      int((tot[2][real] - v2[real]).abs().max()))
        if sum_err:
            fail(f"KI[{tname}]: the blocks' sum differs from KB "
                 f"(max |err| {sum_err})")
        ms, d_, blk, meta = worst
        plain_ms = cuda_ms(lambda: dt.lookup_bucket_owned_plain(
            blk, meta, q, loc), n=3, reps=3, warm=1)
        nbytes, rows = kbd.owned_bytes(blk, meta, q, loc)
        bound = kbd.bound_ms(nbytes)
        log(f"[5s-b] KI sharded_lookup[{tname}] D={D} match=True "
            f"max_abs_err=0 sum_vs_KB_max_abs_err=0 (on "
            f"{int(real.sum())} non-EMPTY of {q.numel()} queries) "
            f"slowest_block={d_} ms={ms:.4f} plain_ms={plain_ms:.4f} "
            f"bound_ms={bound:.4f} bytes={nbytes} owned_rows={rows}")
        # D = 1 (the funnel's world-1 shape: every row owned) beside KB on
        # the same queries: KI must give KB's answer, as int32 planes
        blk1, meta1 = si.row_blocks(tab, 1)[0]
        got1 = dt.lookup_bucket_owned(blk1, meta1, q, loc)
        err1 = max(max_abs_err(got1, dt.lookup_bucket_owned_plain(
            blk1, meta1, q, loc)), max_abs_err(
            tuple(x.reshape(-1) for x in (got1[0] != 0,
                                          got1[1].long() & 0xFFFFFFFF,
                                          got1[2].long() & 0xFFFFFFFF)),
            (f, v, v2)))
        if err1:
            fail(f"KI[{tname}] D=1 disagrees with its plain version or KB "
                 f"(max |err| {err1})")
        ki1, kb1 = [], []
        for _ in range(3):                  # KI, KB, KB, KI, ...
            ki1.append(cuda_ms(lambda: dt.lookup_bucket_owned(
                blk1, meta1, q, loc)))
            kb1 += [cuda_ms(lambda: dt.lookup_bucket(tab, q, loc))
                    for _ in range(2)]
            ki1.append(cuda_ms(lambda: dt.lookup_bucket_owned(
                blk1, meta1, q, loc)))
        ms1, kb_ms1 = float(np.median(ki1)), float(np.median(kb1))
        nbytes1, rows1 = kbd.owned_bytes(blk1, meta1, q, loc)
        log(f"[5s-b] KI sharded_lookup[{tname}] D=1 match=True "
            f"max_abs_err=0 vs_KB_max_abs_err=0 ms={ms1:.4f} KB_ms="
            f"{kb_ms1:.4f} (same queries, alternating) bound_ms="
            f"{kbd.bound_ms(nbytes1):.4f} owned_rows={rows1}")
        ki_res[tname] = dict(match=True, max_abs_err=0, ms=ms,
                             plain_ms=plain_ms, bound_ms=bound,
                             bound_by="bytes", library_ms=None,
                             d1_ms=ms1, d1_kb_ms=kb_ms1,
                             d1_bound_ms=kbd.bound_ms(nbytes1))

    # ---- (c) KC large-E on overflow pairs of the TR pool ----
    E4 = 4096
    srunner = ShardedAlignRunner(ctx["flat"].renew(), ctx["cfg"], mesh=mesh,
                                 batch_pairs=P, max_read_len=L,
                                 expand_cap=E, retry_expand=[E4],
                                 shard_index=True, drp=drp)
    Pt = srunner.retry_P[0]             # _tier_P(4096)
    kc_rng = np.random.default_rng([args.seed, 6])
    kcap: dict = {}
    step = da.make_step(drp, ctx["cfg"], P, L, expand_cap=E, device=dev,
                        capture=kcap)
    parts, n_have, n_batches = [], 0, 0
    live = np.ones(P, dtype=bool)
    while n_have < Pt:
        c_, r_ = sample_read_batch(seqs, P, L, kc_rng, frac_tr=1.0,
                                   read_len=RL)
        _, out = step(da.init_state(drp, dev), c_, r_, live)
        n_batches += 1
        ovf = torch.nonzero((out["referee_pack"] & 4) != 0).reshape(-1)
        kmer, val, use, pkf = kcap["KC"][:4]
        rows = torch.stack([2 * ovf, 2 * ovf + 1], 1).reshape(-1)
        parts.append((kmer[rows], val[rows], use[rows], pkf[ovf]))
        n_have += int(ovf.numel())
    kc_args = [torch.cat([p_[i] for p_ in parts])[: (2 if i < 3 else 1) * Pt]
               for i in range(4)] + [kcap["KC"][4], E4, kcap["KC"][6]]
    mode = da.check_vote_shape(2 * (L - k + 1), E4)
    if mode != "large-E":
        fail(f"E={E4} did not select KC's large-E mode ({mode})")
    got = da.pair_vote(*kc_args)
    err = max_abs_err(got, da.pair_vote_plain(*kc_args))
    torch.cuda.synchronize()
    if err:
        fail(f"KC[large-E] disagrees with pair_vote_plain (max |err| {err})")
    n_ovf4 = int(((got[2] & 4) != 0).sum())
    kcl_ms = cuda_ms(lambda: da.pair_vote(*kc_args))
    kcl_plain = cuda_ms(lambda: da.pair_vote_plain(*kc_args), n=3, reps=1,
                        warm=1)
    NKW = L - k + 1
    kcl_bound = kbd.bound_ms(kbd.kc_bytes(Pt, NKW))
    log(f"[5s-c] KC pair_vote[large-E] P={Pt} W={2 * NKW} E={E4} "
        f"match=True max_abs_err=0 ms={kcl_ms:.4f} plain_ms={kcl_plain:.4f} "
        f"bound_ms={kcl_bound:.4f} mode={mode} (512 threads a pair) "
        f"smem_bytes={da.kc_smem_bytes(2 * NKW, E4)} (<= "
        f"{da.SMEM_LIMIT - da.KC_STATIC_BYTES}; no workspace) "
        f"overflow_pairs_from={n_batches} TR batches, still overflowing at "
        f"E={E4}: {n_ovf4}")
    log(f"[5s-c] KC work: {vote_work_line(kc_args, E4)}")
    kcl = dict(match=True, max_abs_err=0, ms=kcl_ms, plain_ms=kcl_plain,
               bound_ms=kcl_bound, bound_by="bytes", library_ms=None)
    del kc_args, parts, got, kcap, step

    # ---- (d) phase 5's batches through the sharded runner ----
    npairs = sum(b[2] for b in batches)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launch_counts()
    t0 = time.time()
    srunner.run_batches(batches, prefilter=True)
    torch.cuda.synchronize()
    wall = time.time() - t0
    sl = build.launch_counts()
    if min(sl[t] for t in SHARDED + ("KC[large-E]",)) <= 0:
        fail(f"the sharded funnel skipped a kernel: {sl}")
    stats = srunner._dev_state("stats").tolist()
    nmap = srunner._dev_state("nmapread")[:-1]
    if int(nmap.sum()) != stats[6] or srunner.n_prefiltered + \
            srunner.n_step_pairs != npairs:
        fail(f"sharded funnel bookkeeping: nmapread {int(nmap.sum())} vs "
             f"stats {stats}, pairs {npairs}")
    peak = torch.cuda.max_memory_allocated()
    # the collectives of one step: the dbi and trfl probes' all_gather +
    # reduce_scatter (the full collective probe less KI alone) and the
    # referee pack's gather
    dblk, dmeta = si.device_block(drp, "dbi", 1, 0, dev)
    tblk, tmeta = si.device_block(drp, "trfl", 1, 0, dev)
    dq, (_, tq, tl) = cap["KB_dbi"][1], cap["KB_trfl"]
    coll = 0.0
    for blk, meta, q, loc in ((dblk, dmeta, dq, None),
                              (tblk, tmeta, tq, tl)):
        full = cuda_ms(lambda: si.lookup_bucket_sharded(
            blk, meta, q, loc, group=mesh.group))
        ki = cuda_ms(lambda: dt.lookup_bucket_owned(blk, meta, q, loc))
        coll += max(full - ki, 0.0)
    pk = torch.zeros(P, dtype=torch.uint8, device=dev)
    coll += cuda_ms(lambda: pm.gather_planes({"referee_pack": pk}, mesh))
    # K15: the finalize merge of the counts (int64, one all_reduce)
    nslots = srunner.state["counts"].numel()
    k15_ms = cuda_ms(lambda: pm.merged_tensor(srunner.state, "counts", mesh),
                     n=5, reps=3, warm=1)
    k15_bound = kbd.bound_ms(12 * nslots)
    ref_share = srunner.n_referee / max(srunner.n_step_pairs, 1)
    if srunner.n_resolved != srunner.n_referee:
        fail(f"phase 5s-d resolved {srunner.n_resolved} of "
             f"{srunner.n_referee} referee'd pairs")
    log(f"[5s-d] sharded funnel (world 1, shard_index, E={E}->{E4}): "
        f"pairs={npairs} wall={wall:.3f}s reads/s={2 * npairs / wall:.0f} "
        f"(phase 5: {ctx['reads_s']:.0f}) survivors={srunner.n_step_pairs} "
        f"retried={srunner.n_retried} steps={srunner.n_steps} "
        f"referee={srunner.n_referee} referee_share={ref_share:.5f} "
        f"(phase 5: {ctx['ref_share']:.5f}) resolved={srunner.n_resolved} "
        f"(flat view shared with phase 5, built in 0s here) referee_s="
        f"{srunner.referee_s:.3f} reasons={srunner.referee_reasons} "
        f"collective_probe_ms_per_step={coll:.4f} (world 1: the probes' "
        f"cost beyond KI, collectives and their glue, and the pack's "
        f"gather) K15_finalize_merge_ms={k15_ms:.4f} (counts, {nslots} "
        f"slots, bound_ms={k15_bound:.4f}) memory_held_before={held} "
        f"max_memory_allocated={peak} stats={stats} launches={sl}")
    # KI's launches by table: each step (tier steps too) probes dbi and
    # trfl once; each prefilter dispatch's member probe is KI[count]'s
    ki_n = dict(dbi=srunner.n_steps, trfl=srunner.n_steps,
                member=sl["KI"] - 2 * srunner.n_steps)
    for tname, r_ in ki_res.items():
        r_["sharded_launches"] = ki_n[tname]
        log(f"[5s-d] KI[{tname}] launches={ki_n[tname]} (of {sl['KI']}) "
            f"D=4 slowest block ms={r_['ms']:.4f} bound_ms="
            f"{r_['bound_ms']:.4f}; D=1 ms={r_['d1_ms']:.4f} bound_ms="
            f"{r_['d1_bound_ms']:.4f} KB_ms={r_['d1_kb_ms']:.4f}")
    # one KK[sample], KI[count] and KL[decide] a prefilter dispatch
    if not sl["KL[decide]"] == sl["KI[count]"] == sl["KK[sample]"] \
            or ki_n["member"] != 0:
        fail(f"the sharded funnel's prefilter dispatches launched "
             f"KK[sample] {sl['KK[sample]']}, KI[count] {sl['KI[count]']}, "
             f"KL[decide] {sl['KL[decide]']} and a member KI "
             f"{ki_n['member']} times")
    # KI[count] and KL[decide] on phase 3's dispatch (16,384 pairs): its
    # reads sampled by KK[sample], the member table at D = 1 and over its
    # 4 row blocks summed, then through the collective; KL[decide] on the
    # summed counts and the sampler's nk, against its plain version and
    # the host-sampled prefilter's (KK[q]) survivors on the same reads
    q_mem, qv, qn = ctx["q_mem"], ctx["qvalid"], ctx["qnon"]
    Pq = qn.shape[0] // 2
    sq, _, snk = km.prefilter_sample(ctx["pb"], ctx["pr"], k, 4)
    mtab = tabs["member"]
    blk1, meta1 = si.row_blocks(mtab, 1)[0]
    hits1 = dt.lookup_bucket_owned_count(blk1, meta1, sq)
    err = max_abs_err(hits1, dt.lookup_bucket_owned_count_plain(
        blk1, meta1, sq))
    tot = torch.zeros_like(hits1)
    for blk, meta in si.row_blocks(mtab, D):
        h = dt.lookup_bucket_owned_count(blk, meta, sq)
        err = max(err, max_abs_err(
            h, dt.lookup_bucket_owned_count_plain(blk, meta, sq)))
        tot += h
    mblk = si.device_block(drp, "member", 1, 0, dev)
    hits = si.prefilter_hits_sharded(*mblk, sq, group=mesh.group)
    torch.cuda.synchronize()
    if err or not torch.equal(tot, hits1) or not torch.equal(hits, hits1):
        fail(f"KI[count] disagrees with its plain version (max |err| "
             f"{err}), or its D = 4 blocks' sum or the collective's count "
             f"with D = 1")

    kic_b, kic_rows = kbd.owned_count_bytes(blk1, meta1, sq)
    kic = dict(match=True, max_abs_err=err,
               ms=cuda_ms(lambda: dt.lookup_bucket_owned_count(
                   blk1, meta1, sq)),
               plain_ms=cuda_ms(lambda: dt.lookup_bucket_owned_count_plain(
                   blk1, meta1, sq), n=3, reps=3, warm=1),
               bound_ms=kbd.bound_ms(kic_b), bound_by="bytes",
               library_ms=None, sharded_launches=sl["KI[count]"])
    kic["graph_ms"] = cuda_ms(graph_of(
        lambda: dt.lookup_bucket_owned_count(blk1, meta1, sq)).replay,
        reps=5) / GRAPH
    log(f"[5s-d] KI[count] sharded_lookup_count (member, D=1, the world-1 "
        f"dispatch's shape) reads={sq.shape[0]} nf={sq.shape[1]} match=True "
        f"max_abs_err={err} D=4 blocks' sum = D=1 = the collective's; "
        f"reads_with_hits={int((hits1 > 0).sum())} ms={kic['ms']:.4f} "
        f"graph_ms={kic['graph_ms']:.4f} plain_ms={kic['plain_ms']:.4f} "
        f"bound_ms={kic['bound_ms']:.4f} bytes={kic_b} rows={kic_rows} "
        f"launches={sl['KI[count]']} (one a dispatch); card {smi}")
    pl = torch.ones(Pq, dtype=torch.bool, device=dev)
    kld_args = (hits, snk, pl, 1, Pq)
    got = da.prefilter_decision(*kld_args)
    err = max_abs_err(got, da.prefilter_decide(*kld_args))
    if err or not torch.equal(got, da.make_prefilter_step_q(
            drp, ctx["cfg"], Pq, dev)(q_mem, qv, qn, pl)):
        fail(f"KL[decide] after KI[count] disagrees with its plain version "
             f"(max |err| {err}) or with KK[q]'s survivors")
    kld = dict(match=True, max_abs_err=err,
               ms=cuda_ms(lambda: da.prefilter_decision(*kld_args)),
               plain_ms=cuda_ms(lambda: da.prefilter_decide(*kld_args)),
               bound_ms=kbd.bound_ms(kbd.kl_decide_bytes(Pq)),
               bound_by="bytes", library_ms=None)
    kld["graph_ms"] = cuda_ms(graph_of(
        lambda: da.prefilter_decision(*kld_args)).replay, reps=5) / GRAPH
    log(f"[5s-d] KL[decide] prefilter_decide after KI[count] (member, "
        f"world 1) P={Pq} match=True max_abs_err={err} survivors="
        f"{int(got.sum())} ms={kld['ms']:.4f} graph_ms="
        f"{kld['graph_ms']:.4f} plain_ms={kld['plain_ms']:.4f} bound_ms="
        f"{kld['bound_ms']:.5f} (hits and nk int32, live, survive: 18 B a "
        f"pair) launches={sl['KL[decide]']} (one a dispatch); card {smi}")
    # the collective prefilter's dispatch window on the same reads:
    # KK[sample], all_gather, KI[count], reduce_scatter, KL[decide], the
    # survivors' all_gather (device tensors, world 1)
    pstep, _ = si.make_sharded_prefilter(drp, ctx["cfg"], mesh, Pq, L)
    if not torch.equal(pstep(ctx["pb"], ctx["pr"], pl), got):
        fail("the collective prefilter's survivors differ from KL[decide]'s")
    disp_ms = cuda_ms(lambda: pstep(ctx["pb"], ctx["pr"], pl))
    log(f"[5s-d] collective prefilter dispatch (P={Pq}, world 1) window "
        f"ms={disp_ms:.4f} reduce_scatter_bytes={hits.numel() * 4} (one "
        f"int32 a read); card {smi}")
    del srunner
    dist.destroy_process_group()
    return dict(KI=ki_res["dbi"], KCL=kcl, KLD=kld, KIC=kic, launches=sl,
                ki_all=ki_res)


def gt_file_equal(path: str, m) -> bool:
    """Whether the GT matrix file ``path`` holds the (ns, nk) f32 array m
    bit for bit (u32 dims, then column-major data), read in blocks."""
    import numpy as np

    ns, nk = m.shape
    block = max(1, (1 << 26) // (4 * ns))
    with open(path, "rb") as f:
        if np.fromfile(f, np.uint32, 2).tolist() != [ns, nk]:
            return False
        for c0 in range(0, nk, block):
            c1 = min(nk, c0 + block)
            got = np.fromfile(f, np.uint32, (c1 - c0) * ns)
            if got.size != (c1 - c0) * ns or not np.array_equal(
                    got.reshape(c1 - c0, ns), m[:, c0:c1].T.view(np.uint32)):
                return False
        return f.read(1) == b""


def pred_oracle_check(meta, ik, outs, what):
    """Holds pred's three files against the host oracle (the numpy
    bias_correction_np on the port's loader) on the same inputs; returns
    (NaN, inf) counts of the corrected matrix."""
    import numpy as np

    from danbing_tk_tpu_torch.analysis import pred
    from danbing_tk_tpu_torch.io import binary as bio

    fns, rds = pred.read_gt_meta(meta)
    nk_cum, nik_cum, iki, ikc = bio.read_ikmer_meta(ik)
    gt = pred.load_gt_normalized(fns, rds, int(nk_cum[-1]))
    if not gt_file_equal(outs[0], gt):
        fail(f"{what} pred: raw GT differs from the host oracle")
    with np.errstate(divide="ignore", invalid="ignore"):
        bias = pred.bias_correction_np(gt, nk_cum, nik_cum, iki, ikc)
    if not gt_file_equal(outs[1], gt):
        fail(f"{what} pred: corrected GT differs from the host oracle")
    want = outs[2] + ".oracle"
    pred.write_bias(want, bias)
    with open(outs[2], "rb") as f, open(want, "rb") as g:
        if f.read() != g.read():
            fail(f"{what} pred: bias TSV differs from the host oracle")
    return int(np.isnan(gt).sum()), int(np.isinf(gt).sum())


def pred_phase(seed: int, dev):
    """Phase 8: (a) the golden cohort through ``pred`` on cuda, (b) KH
    against its plain version at ns = 32 x nk = 120M, (c) the ``pred`` CLI
    through files at ns = 8, full nk.  Returns (KH's result, its launches
    in (c))."""
    import shutil

    import numpy as np
    import torch

    from danbing_tk_tpu_torch.analysis import pred
    from danbing_tk_tpu_torch.apps import cli
    from danbing_tk_tpu_torch.kernels import build
    from danbing_tk_tpu_torch.tools import kernel_bounds as kbd
    from danbing_tk_tpu_torch.tools import scale_pred

    def outs_of(d):
        return [os.path.join(d, o) for o in ("raw.gt", "corr.gt",
                                              "bias.tsv")]

    # (a) the golden cohort
    t0 = time.time()
    with tempfile.TemporaryDirectory(prefix="dtk_smoke_") as d:
        meta, ik = scale_pred.write_golden_cohort(
            os.path.join(ROOT, "tests", "golden"), d, seed=seed)
        build.reset_launch_counts()
        cli.main(["pred", meta, ik] + outs_of(d))
        n_gold = build.launch_counts()["KH"]
        g_nan, g_inf = pred_oracle_check(meta, ik, outs_of(d), "golden")
    if n_gold != 1:
        fail(f"golden pred launched KH {n_gold} times")
    log(f"[8a] golden pred CLI on cuda: raw, corr and bias.tsv byte-equal "
        f"to the host oracle (NaN {g_nan}, inf {g_inf}), KH launches "
        f"{n_gold}, {time.time() - t0:.1f}s")

    # (b) KH against the plain version at ns = 32, nk = 120M
    ns = 32
    co = scale_pred.build_cohort(ns, seed=seed)
    n_tr = len(co["nk_cum"])
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    base = scale_pred.build_gt(co, dev)
    torch.cuda.synchronize()
    t_gen = time.time() - t0
    nk = base.shape[1]
    idx = pred.index_tensors(co["nk_cum"], co["nik_cum"], co["iki"],
                             co["ikc"], dev)
    k = base.clone()
    bk = pred.bias_correction(k, *idx)
    p = base.clone()
    bp = pred.bias_correction_plain(p, *idx)
    torch.cuda.synchronize()
    if not torch.equal(k.view(torch.int32), p.view(torch.int32)):
        fail("KH's corrected GT differs from the plain version's")
    if not torch.equal(bk.view(torch.int32), bp.view(torch.int32)):
        fail("KH's bias differs from the plain version's")
    peak = torch.cuda.max_memory_allocated()

    def timed(fn, target, reps):
        """Median ms of fn(target) over reps, target restored from base
        before each (KH works in place)."""
        ts = []
        for _ in range(reps):
            target.copy_(base)
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            fn(target)
            e1.record()
            e1.synchronize()
            ts.append(e0.elapsed_time(e1))
        ts.sort()
        return ts[len(ts) // 2]

    kh_ms = timed(lambda g: pred.bias_correction(g, *idx), k, 9)
    plain_ms = timed(lambda g: pred.bias_correction_plain(g, *idx), p, 3)
    del p, bp
    n_nan = int(torch.isnan(k).sum())
    n_inf = int(torch.isinf(k).sum())
    # the bytes this data makes KH move: every column of an active locus
    # read and written, the invariant columns of a skipped locus read,
    # 5 B per invariant k-mer (u32 iki, u8 ikc), 8 B per locus (u32
    # nk_cum, nik_cum), the bias written
    active = (bk != 0).any(0).cpu().numpy()
    nk_per = np.diff(co["nk_cum"].astype(np.int64), prepend=0)
    nik = np.diff(co["nik_cum"].astype(np.int64), prepend=0)
    act_cols = int(nk_per[active].sum())
    ik_skipped = int(nik[~active].sum())
    kh_bytes = (4 * ns * (2 * act_cols + ik_skipped) + 5 * int(nik.sum())
                + 8 * n_tr + 4 * ns * n_tr)
    bound = kbd.bound_ms(kh_bytes)
    n_dead = int(((nik > 0) & ~active).sum())
    log(f"[8b] KH bias_correct ns={ns} nk={nk} (ns*nk={ns * nk}) match=True "
        f"max_abs_err=0 ms={kh_ms:.4f} plain_ms={plain_ms:.4f} "
        f"bound_ms={bound:.4f} bytes={kh_bytes} active_loci="
        f"{int(active.sum())} no_ik_loci={int((nik == 0).sum())} "
        f"zero_mean_loci={n_dead} nan={n_nan} inf={n_inf} "
        f"gen={t_gen:.1f}s peak_memory_allocated={peak}")
    kh = dict(match=True, max_abs_err=0, ms=kh_ms, plain_ms=plain_ms,
              bound_ms=bound, bound_by="bytes", library_ms=None,
              source="danbing_tk_tpu_torch/csrc/bias_correct.cu",
              replaces="danbing_tk_tpu/analysis/pred.py:99")
    del base, k, bk, idx
    torch.cuda.empty_cache()

    # (c) the pred CLI through files
    tmp = tempfile.gettempdir()
    free = shutil.disk_usage(tmp).free
    # the u64 inputs and the two f32 outputs of ns = 8, with 10% to spare
    ns = 8
    need = ns * nk * (8 + 2 * 4) * 1.1
    log(f"[8c] free disk in {tmp}: {free} B; ns={ns} needs ~{need:.0f} B")
    if free < need:
        fail(f"not enough disk for the pred file run: {free} B free in "
             f"{tmp}, ~{need:.0f} B needed")
    co = scale_pred.build_cohort(ns, seed=seed + 1)
    with tempfile.TemporaryDirectory(prefix="dtk_smoke_") as d:
        t0 = time.time()
        meta, ik = scale_pred.write_cohort(co, d, dev)
        t_files = time.time() - t0
        build.reset_launch_counts()
        spans = cli.main(["pred", meta, ik] + outs_of(d))
        n_launch = build.launch_counts()["KH"]
        t0 = time.time()
        c_nan, c_inf = pred_oracle_check(meta, ik, outs_of(d), "file run")
        t_oracle = time.time() - t0
    if n_launch <= 0:
        fail("the pred file run did not launch KH")
    wall = spans["wall"]
    log(f"[8c] pred CLI on cuda, ns={ns} nk={nk}: outputs byte-equal to "
        f"the host oracle (NaN {c_nan}, inf {c_inf}); spans(s) "
        + " ".join(f"{k_}={v:.3f}" for k_, v in spans.items())
        + f" KH_share_of_wall={spans['kernel'] / wall:.5f} "
        f"transfer_share={(spans['h2d'] + spans['d2h']) / wall:.4f} "
        f"inputs_written_in={t_files:.1f}s oracle={t_oracle:.1f}s "
        f"KH launches {n_launch}")
    return kh, n_launch


def finish(res, kh, kh_launches, kind, smi, t_start) -> int:
    """Phases 9 and 10: the kernels line and the last line."""
    import torch

    # ---- 9. kernels line ----
    names = {"KA": "KA extract_kmers", "KB": "KB bucket_lookup",
             "KC": "KC pair_vote", "KC[large-E]": "KC pair_vote[large-E]",
             "KD": "KD assign_count", "KE": "KE thread_walk",
             "KF": "KF read_filter", "KG": "KG novel_edges",
             "KI": "KI sharded_lookup",
             "KI[count]": "KI[count] sharded_lookup_count",
             "KJ": "KJ site_scorer",
             "KK": "KK prefilter_fused",
             "KK[q]": "KK[q] prefilter_fused_q",
             "KK[sample]": "KK[sample] prefilter_sample",
             "KL": "KL pair_filter",
             "KL[decide]": "KL[decide] prefilter_decide",
             "KM": "KM step_tail (fused in KD / KE)"}
    paths = {"warmup": res["wlaunches"],
             "counting": res["launches"],
             "counting_device_sampled": res["dlaunches"],
             "sharded": res["slaunches"],
             "threading": res["tlaunches"], "okam": res["olaunches"],
             "site_scorer": res["jlaunches"],
             "python_ingest": res["plaunches"],
             "analysis": res["alaunches"],
             "build_prune": res["bq_launches"]["build_prune"],
             "qc": res["bq_launches"]["qc"],
             "bench": res["bench_launches"],
             "full_geometry": res["geo_launches"]}
    # a step launches KA and KL once each and runs KM's tail once, in KD's
    # launch (counting, okam) or in KE's (threading); no standalone KM
    for path, c in paths.items():
        if not c["KL"] == c["KM"] == c["KA"]:
            fail(f"the {path} path launched KA {c['KA']}, KL {c['KL']} and "
                 f"ran KM {c['KM']} times: a step runs each once")
        if c["KM"] != c["KD"]:
            fail(f"the {path} path ran KM {c['KM']} times in {c['KD']} "
                 f"steps (KD launches)")
    for path in ("counting", "okam"):
        if paths[path]["KE"] != 0:
            fail(f"the {path} path launched KE: its tail runs in KD")
    if not 0 < paths["threading"]["KE"] == paths["threading"]["KM"]:
        fail(f"the threading path ran KM {paths['threading']['KM']} times "
             f"in {paths['threading']['KE']} KE launches")
    kern = [dict(name=names[t], route="cuda",
                 launches=sum(c[t] for c in paths.values()),
                 launches_by_path={p: c[t] for p, c in paths.items()},
                 **res["results"][t]) for t in names]
    kern.append(dict(name="KH bias_correct", route="cuda",
                     launches=kh_launches,
                     launches_by_path={"pred": kh_launches}, **kh))
    golden_counts, golden_thr_counts, golden_okam_counts, golden_py, \
        golden_qc = res["golden"]
    log(f"[9] golden launches {golden_counts} / threading "
        f"{golden_thr_counts} / okam {golden_okam_counts} / Python ingest "
        f"{golden_py} / golden_qc {golden_qc}; card {smi}; smoke wall "
        f"{time.time() - t_start:.1f}s")
    print(json.dumps({"kernels": kern}), flush=True)
    # ---- 10. last line ----
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
