"""A sustained production funnel run: many windows of pairs through one
runner, okam and auto-cadence checkpoints on, and the rate's drift from
the first window to the last.

    python -m danbing_tk_tpu_torch.tools.bench_sustained [random|real]

Counterpart of tools/bench_sustained.py (the same knobs).  The pairs ride
as DTK_SUST_WINDOWS files of DTK_SUST_PAIRS pairs each (distinct seeds),
processed one after another by ONE DeviceAlignRunner over the scale index
(scale_index.build_scale_rpgg_cached) and its flat host view, with
run_file_native(prefilter=True): the ingest is that of one file of all
the pairs, and the per-file walls give the drift windows.  With okam the
.kam rows stream to a RowSink; with checkpoints each window saves at the
runner's auto cadence (every 20 x the last save's wall, the first after
60 s) and at its end.  A window's checkpoint is removed when the window
ends: the runner resumes from a checkpoint it finds, so the next file
must not start from the last one's end (the JAX tool reuses one path, and
every window after its first resumes past its own last pair).

The background of the reads is uniform random, as the bench's workers
make it (tools/bench_e2e.synth_reads); ``real`` (the JAX tool's hg38
chr12 background, tools/make_real_panel.py background_pool) needs
danbing-tk's bundled sequences, which are not in this repository: the
tool exits non-zero and names them.

Env knobs:
  DTK_SUST_WINDOWS=10      windows
  DTK_SUST_PAIRS=10000000  pairs a window
  DTK_SUST_FRAC=0.05       share of pairs from the loci
  DTK_SUST_ERR=0.002       per-base substitution rate
  DTK_SUST_OKAM=1          okam (.kam rows) on
  DTK_SUST_CKPT=1          auto-cadence checkpoints on
  DTK_SUST_SYNTH_ONLY=1    write the window files and exit
  DTK_SUST_BG=random       the background (``real``: see above)
  DTK_SF_NLOCI, DTK_SF_KPL, DTK_SF_P, DTK_SF_E, DTK_SF_RETRY: the index
  and the step, as the bench's scale worker reads them.
Files go under DTK_BENCH_BUILD (default <repo>/build); the card is
DTK_TORCH_DEVICE (default cuda).  Prints one JSON line
``sustained_reads_per_sec``: the whole run's reads/s, each window's, the
first-to-last drift, each window's checkpoint seconds, and the run's
provenance.
"""

from __future__ import annotations

import json
import os
import resource
import sys
import time

from .bench_panel_funnel import REF_READS_PER_SEC, build_dir, worker_device

# tools/make_real_panel.py:249-254 (background_pool)
REAL_BG_FILE = "test/input/hg38.chr12.2155791.2356090.fasta"
REAL_BG_MISSING = (
    f"the real background (tools/make_real_panel.py:249-254, "
    f"background_pool) reads danbing-tk's {REAL_BG_FILE}, which is not in "
    f"this repository")


def _env() -> dict:
    e = os.environ
    return dict(nwin=int(e.get("DTK_SUST_WINDOWS", 10)),
                npairs=int(e.get("DTK_SUST_PAIRS", 10_000_000)),
                frac=float(e.get("DTK_SUST_FRAC", 0.05)),
                err=float(e.get("DTK_SUST_ERR", 0.002)),
                okam=e.get("DTK_SUST_OKAM", "1") != "0",
                ckpt=e.get("DTK_SUST_CKPT", "1") != "0",
                nloci=int(e.get("DTK_SF_NLOCI", 80_000)),
                kpl=int(e.get("DTK_SF_KPL", 1500)),
                P=int(e.get("DTK_SF_P", 4096)),
                E=int(e.get("DTK_SF_E", 768)),
                retry=[int(x) for x in e.get("DTK_SF_RETRY", "4096").split(
                    ",") if x and int(x)])


def window_files(kn: dict, seqs, root: str) -> list:
    """The windows' read files (cached by shape), seeds 100 + w."""
    from .bench_scale_funnel import reads_file

    paths = []
    for w in range(kn["nwin"]):
        t0 = time.time()
        paths.append(reads_file(root, seqs, kn["nloci"], kn["kpl"],
                                kn["npairs"], kn["frac"], kn["err"],
                                seed=100 + w, tag="sust"))
        print(f"# window {w}: {os.path.getsize(paths[-1]) / 1e9:.2f} GB "
              f"({time.time() - t0:.0f}s)", file=sys.stderr, flush=True)
    return paths


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    bg = argv[0] if argv else os.environ.get("DTK_SUST_BG", "random")
    if bg == "real":
        sys.exit(f"bench_sustained: real background: {REAL_BG_MISSING}")
    if bg != "random":
        sys.exit(f"bench_sustained: unknown background {bg!r} (random or "
                 f"real)")
    kn, root = _env(), build_dir()
    from .scale_index import build_scale_rpgg_cached

    t0 = time.time()
    drp, seqs = build_scale_rpgg_cached(kn["nloci"], kn["kpl"],
                                        cache_dir=root)
    paths = window_files(kn, seqs, root)
    del seqs
    if os.environ.get("DTK_SUST_SYNTH_ONLY"):
        print(f"# synth done: {kn['nwin']} windows", file=sys.stderr)
        return 0
    dev = worker_device()

    from ..engine.align_runner import DeviceAlignRunner
    from ..engine.flat_rpgg import FlatRPGG
    from ..engine.host_align import AlignConfig
    from ..io.rowsink import RowSink
    from ..utils.compile_cache import enable_compile_cache
    from .bench_panel_funnel import sink

    enable_compile_cache()
    flat = FlatRPGG.from_device_tables_cached(
        drp, os.path.join(root, f"flat_{kn['nloci']}_{kn['kpl']}_v1.npz"))
    t_ready = time.time() - t0
    print(f"# index + flat view ready: {len(flat.dbi) / 1e6:.1f}M keys "
          f"({t_ready:.0f}s)", file=sys.stderr, flush=True)
    okam, ckpt_on = kn["okam"], kn["ckpt"]
    cfg = AlignConfig(ksize=21, cth=20, n_filter=4, nm_filter=1, okam=okam)
    al = DeviceAlignRunner(flat, cfg, batch_pairs=kn["P"], max_read_len=160,
                           expand_cap=kn["E"], retry_expand=kn["retry"],
                           drp=drp, device=dev)
    kam_path = os.path.join(root, "sust.kam")
    if okam:
        al.kam_rows = RowSink(kam_path)
    ck = os.path.join(root, "sust.ckpt.npz") if ckpt_on else None
    if ck and os.path.exists(ck):
        os.unlink(ck)

    walls, ckpt_walls, rates = [], [], []
    npairs = kn["npairs"]
    t_all = time.time()
    for w, path in enumerate(paths):
        t0 = time.time()
        al.run_file_native(path, prefilter=True, checkpoint=ck)
        sink(al)
        walls.append(time.time() - t0)
        rates.append(2 * npairs / walls[-1])
        ckpt_walls.append(al._last_ckpt_wall)
        if ck and os.path.exists(ck):
            os.unlink(ck)
        rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20
        print(f"# window {w}: {walls[-1]:.1f}s -> {rates[-1]:.0f} reads/s "
              f"referee={al.n_referee} retried={al.n_retried} "
              f"maxrss={rss:.1f}GiB ckpt_wall={ckpt_walls[-1]}",
              file=sys.stderr, flush=True)
    wall = time.time() - t_all
    if okam:
        al.write_kam(kam_path)
    al.write_trkmc_ar(os.path.join(root, "sust.trkmc.ar"))

    rate = 2 * npairs * kn["nwin"] / wall
    out = {
        "metric": "sustained_reads_per_sec",
        "value": round(rate, 1),
        "unit": f"reads/s@{len(flat.dbi) / 1e6:.0f}Mkeys",
        "vs_baseline": round(rate / REF_READS_PER_SEC, 2),
        "windows": [round(r, 1) for r in rates],
        "window_walls_s": [round(x, 3) for x in walls],
        "first_last_drift": round(rates[-1] / rates[0] - 1, 4),
        "ckpt_walls_s": ckpt_walls,
        "okam": okam, "ckpt": ckpt_on,
        "kam_bytes": os.path.getsize(kam_path) if okam else 0,
        "pairs_per_window": npairs, "n_windows": kn["nwin"],
        "referee": al.n_referee, "retried": al.n_retried,
        "survivors": kn["nwin"] * npairs - al.n_prefiltered,
        "setup_s": round(t_ready, 1),
        "provenance": (f"scale index {kn['nloci']} loci x {kn['kpl']} "
                       f"k-mers; {kn['frac']} of pairs from the loci, "
                       f"{kn['err']} substitutions a base; uniform random "
                       f"background (the JAX tool's hg38 chr12 slice is "
                       f"not in this repository); P={kn['P']} "
                       f"E={kn['E']} retry={kn['retry']}"),
    }
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
