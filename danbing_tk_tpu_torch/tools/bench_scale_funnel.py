"""The bench's scale-funnel worker: the counting funnel at production index
scale.

    python -m danbing_tk_tpu_torch.tools.bench_scale_funnel

Port of tools/bench_scale_funnel.py.  Runs ``align --device --native-io
--prefilter -ka``'s whole path (the native reader's ingest, the device
prefilter, the survivors' repack, the device step with its retry ladder,
the exact referee over the flat host view, engine/flat_rpgg.FlatRPGG)
against the cached 80,000-locus synthetic scale index
(tools/scale_index.py).  Prints one JSON line ``scale_funnel_reads_per_sec``
and, with DTK_SF_CKPT=1, a second, ``scale_funnel_ckpt_overhead``;
diagnostics (survivors, retried and referee'd pairs, the referee's
reasons, each build's seconds) go to stderr.

Passes: one cold pass, then DTK_SF_STEADY timed passes on fresh runners
that reuse the cold runner's steps, the host counts zeroed between
passes; the statistic is their median, without the first when there are
4 or more (it still carries settling cost).  Each pass ends with a
scalar read of the count state inside its window.  The soft deadline
DTK_PF_DEADLINE_TS (absolute epoch seconds, set by tools/bench.py) stops
the timed passes early.

Env knobs:
  DTK_SF_NLOCI=80000 DTK_SF_KPL=1500    index shape (cache key)
  DTK_SF_PAIRS=2000000 DTK_SF_FRAC=0.05 reads file shape
  DTK_SF_ERR=0.002                      per-base substitution rate
  DTK_SF_BG=random                      background (``real``, an hg38
                                        chr12 slice, is not in this
                                        repository: the worker exits
                                        non-zero and says so)
  DTK_SF_P=4096 DTK_SF_E=768            step shapes
  DTK_SF_RETRY=4096                     retry ladder ('' disables)
  DTK_SF_STEADY=5                       timed passes
  DTK_SF_CKPT=1                         also measure checkpoint overhead
  DTK_SF_CKPT_EVERY=1000000             pairs between checkpoints
The card is DTK_TORCH_DEVICE (default ``cuda``); the index, its flat view,
the reads file and the checkpoint go under DTK_BENCH_BUILD (default
``<repo>/build``).
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

from .bench_panel_funnel import (LAUNCHES_TAG, REAL_PANEL_MISSING,
                                 REF_READS_PER_SEC, build_dir, sink,
                                 worker_device)


def steady_stat(walls: list) -> tuple:
    """(median, spread) of the timed passes, the first dropped when there
    are 4 or more: the pass right after the cold one still carries
    settling cost (program residency, page cache)."""
    stat = walls[1:] if len(walls) >= 4 else walls
    med = sorted(stat)[len(stat) // 2]
    return med, (max(stat) - min(stat)) / med


def read_pool(seqs, n: int = 20_000) -> list:
    """The first ``n`` loci's sequences as ACGT strings: the pool the
    bench's reads are drawn from."""
    dec = np.frombuffer(b"ACGT", dtype=np.uint8)[np.asarray(seqs[:n])]
    return [dec[i].tobytes().decode() for i in range(len(dec))]


def reads_file(root, seqs, nloci, kpl, npairs, frac, err, bg="random",
               L: int = 150, seed: int = 3, tag: str = "sf") -> str:
    """The WGS-shaped reads file (tools/bench_e2e.synth_reads, uniform
    random background), cached under ``root`` by its shape; returns its
    path."""
    from .bench_e2e import synth_reads

    sfx = "" if seed == 3 else f"_s{seed}"
    reads = os.path.join(
        root, f"{tag}_{nloci}_{kpl}_{npairs}_{frac}_{err}_{bg}{sfx}.fa")
    if not os.path.exists(reads):
        t0 = time.time()
        pool = read_pool(seqs)
        flen = min(500, len(pool[0]))
        assert flen >= L, (
            f"panel sequences ({len(pool[0])}bp) shorter than the read "
            f"length {L} — raise DTK_SF_KPL")
        synth_reads(reads, npairs, frac, pool, L=L, err=err, flen=flen,
                    seed=seed)
        print(f"# reads synthesized: {npairs} pairs "
              f"({os.path.getsize(reads)/1e9:.1f} GB, "
              f"{time.time()-t0:.0f}s)", file=sys.stderr)
    return reads


def main():
    """Runs the worker; returns the last pass's runner."""
    bg = os.environ.get("DTK_SF_BG", "random")
    if bg == "real":
        sys.exit(f"bench_scale_funnel: DTK_SF_BG=real: {REAL_PANEL_MISSING}")
    if bg != "random":
        sys.exit(f"bench_scale_funnel: unknown DTK_SF_BG={bg!r}")
    dev = worker_device()

    from ..utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    from ..engine.align_runner import DeviceAlignRunner
    from ..engine.flat_rpgg import FlatRPGG
    from ..engine.host_align import AlignConfig
    from ..kernels import build
    from .scale_index import build_scale_rpgg_cached

    nloci = int(os.environ.get("DTK_SF_NLOCI", 80_000))
    kpl = int(os.environ.get("DTK_SF_KPL", 1500))
    npairs = int(os.environ.get("DTK_SF_PAIRS", 2_000_000))
    frac = float(os.environ.get("DTK_SF_FRAC", 0.05))
    err = float(os.environ.get("DTK_SF_ERR", 0.002))
    P = int(os.environ.get("DTK_SF_P", 4096))
    E = int(os.environ.get("DTK_SF_E", 768))
    retry = [int(x) for x in os.environ.get(
        "DTK_SF_RETRY", "4096").split(",") if x and int(x)]
    L = 150
    root = build_dir()

    t0 = time.time()
    drp, seqs = build_scale_rpgg_cached(nloci, kpl, cache_dir=root)
    print(f"# index load: {time.time()-t0:.0f}s", file=sys.stderr)

    t0 = time.time()
    flat = FlatRPGG.from_device_tables_cached(
        drp, os.path.join(root, f"flat_{nloci}_{kpl}_v1.npz"))
    print(f"# flat host view (exact referee substrate): "
          f"{len(flat.dbi)/1e6:.1f}M keys in {time.time()-t0:.0f}s",
          file=sys.stderr, flush=True)

    reads = reads_file(root, seqs, nloci, kpl, npairs, frac, err, bg, L)
    del seqs

    cfg = AlignConfig(ksize=21, cth=20, n_filter=4, nm_filter=1,
                      okam=False)

    def mk(warm=None):
        al = DeviceAlignRunner(flat, cfg, batch_pairs=P,
                               max_read_len=160, expand_cap=E,
                               retry_expand=retry, drp=drp, device=dev)
        if warm is not None:
            al.step = warm.step
            al.retry_steps = warm.retry_steps
            al.prefilter_step = warm.prefilter_step
            al.prefilter_P = warm.prefilter_P
        return al

    def report(tag, al, wall):
        nreads = 2 * npairs
        surv = npairs - al.n_prefiltered
        print(f"# {tag}: wall={wall:.1f}s -> {nreads/wall:.0f} reads/s "
              f"(P={P} E={E} retry={retry}) "
              f"survivors={surv}/{npairs} ({100*surv/npairs:.3f}%) "
              f"retried={al.n_retried} referee={al.n_referee} "
              f"{al.referee_reasons}", file=sys.stderr)
        return nreads / wall

    # the cold pass: kernels loaded, tables uploaded, steps built
    al = mk()
    t0 = time.time()
    al.run_file_native(reads, prefilter=True)
    sink(al)
    report("cold (incl kernel load)", al, time.time() - t0)

    # timed passes (reusing the cold runner's steps): the median of
    # DTK_SF_STEADY, with the spread printed
    nsteady = int(os.environ.get("DTK_SF_STEADY", 5))
    deadline_ts = float(os.environ.get("DTK_PF_DEADLINE_TS", 0) or 0)
    walls = []
    al2 = al
    for _ in range(max(nsteady, 1)):
        flat.flat_counts()[:] = 0
        prev, al2 = al2, mk(al)
        prev.state = None    # free the previous device accumulators
        build.reset_launch_counts()
        t0 = time.time()
        al2.run_file_native(reads, prefilter=True)
        sink(al2)
        walls.append(time.time() - t0)
        launches = {k: v for k, v in build.launch_counts().items() if v}
        # soft deadline: stop early with however many passes fit rather
        # than being hard-killed with nothing
        if deadline_ts and time.time() + 1.2 * max(walls) > deadline_ts:
            print(f"# steady: soft deadline reached after {len(walls)} "
                  f"pass(es)", file=sys.stderr, flush=True)
            break
    wall2, spread = steady_stat(walls)
    rps2 = report("steady", al2, wall2)
    print(f"# steady walls: {[round(w, 1) for w in walls]} "
          f"(median {wall2:.1f}s, spread {100*spread:.1f}%)",
          file=sys.stderr)
    print(f"# steady: {LAUNCHES_TAG} {json.dumps(launches)}",
          file=sys.stderr, flush=True)

    ck_over = None
    if os.environ.get("DTK_SF_CKPT"):
        every = int(os.environ.get("DTK_SF_CKPT_EVERY", 1_000_000))
        al_prev = al2
        # two passes: the first pays the snapshot path's first use, the
        # second is the steady overhead
        for tag in ("ckpt cold", "ckpt warm"):
            flat.flat_counts()[:] = 0
            al_prev.state = None
            al3 = mk(al)
            ckpt = os.path.join(root, "sf_ckpt.npz")
            if os.path.exists(ckpt):
                os.unlink(ckpt)
            t0 = time.time()
            al3.run_file_native(reads, checkpoint=ckpt, prefilter=True,
                                checkpoint_every=every)
            sink(al3)
            wall3 = time.time() - t0
            ck_over = (wall3 - wall2) / wall2
            report(f"{tag}@{every/1e6:g}M (overhead {100*ck_over:.1f}%)",
                   al3, wall3)
            al_prev = al2 = al3

    nkeys = len(flat.dbi)
    out = {
        "metric": "scale_funnel_reads_per_sec",
        "value": round(rps2, 1),
        "unit": f"reads/s@{nkeys/1e6:.0f}Mkeys",
        "vs_baseline": round(rps2 / REF_READS_PER_SEC, 2),
        "spread": round(spread, 4),
        "passes": len(walls),
    }
    # the number carries its spread, and a flag when it is untrustworthy
    if spread > 0.15 or len(walls) < 3:
        out["contaminated"] = True
    print(json.dumps(out), flush=True)
    if ck_over is not None:
        print(json.dumps({"metric": "scale_funnel_ckpt_overhead",
                          "value": round(ck_over, 4), "unit": "frac",
                          "vs_baseline": 0}), flush=True)
    return al2


if __name__ == "__main__":
    main()
