"""Builds the genome-wide index (~1.2e9 (kmer, locus) slots at the
defaults, the reference's production RPGG size) on the host and writes it
to disk.

    python -m danbing_tk_tpu_torch.tools.build_full_index \
        [nloci] [kmers_per_locus] [outdir]

Counterpart of tools/build_full_index.py (defaults 80,000 loci x 15,000
k-mers, outdir build/full_index_<nloci>_<kpl>), on the port's own builder
(scale_index.build_full_tables: the same files and bytes as the JAX
tool's).  Prints one JSON line ``full_index_build``: the build's wall,
peak RSS, slots, keys, each table's GB and levels, and the directory.
scale_index.load_full_tables reads it back; tools/full_index_probe.py
checks it on the card.
"""

from __future__ import annotations

import json
import os
import resource
import sys
import time

from .scale_index import build_full_tables

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    nloci = int(argv[0]) if len(argv) > 0 else 80_000
    kpl = int(argv[1]) if len(argv) > 1 else 15_000
    outdir = (argv[2] if len(argv) > 2
              else os.path.join(ROOT, "build", f"full_index_{nloci}_{kpl}"))
    t0 = time.time()
    man = build_full_tables(outdir, nloci, kpl)
    wall = time.time() - t0
    # ru_maxrss is in KiB on Linux
    rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024 / 1e9
    gb = {p: man[p]["nbytes"] / 1e9 for p in ("dbi", "trfl")}
    print(json.dumps(dict(
        metric="full_index_build", nloci=nloci, kmers_per_locus=kpl,
        nslots=man["nslots"], nkeys=man["nkeys"], wall_s=round(wall, 1),
        peak_rss_gb=round(rss, 3), dbi_gb=gb["dbi"], trfl_gb=gb["trfl"],
        total_gb=sum(gb.values()),
        dbi_levels=[lv[0] for lv in man["dbi"]["levels"]],
        trfl_levels=[lv[0] for lv in man["trfl"]["levels"]],
        outdir=outdir)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
