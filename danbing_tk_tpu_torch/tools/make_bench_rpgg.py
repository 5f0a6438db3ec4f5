"""The bench's synthetic RPGG: 512 loci x 4 haplotypes by default.

    python -m danbing_tk_tpu_torch.tools.make_bench_rpgg [OUTDIR [NLOCI]]

Port of tools/make_bench_rpgg.py on the port's own index tools
(apps/fa2kmers.py, index/dbi.py): from seed 42 it writes the same
``hap*.fa`` and ``pan.*`` files byte for byte.  Each locus is a random TR
motif of 3-15 bases repeated 20-100 times (per haplotype +-5) between two
random 700-base flanks; every fifth locus reuses an earlier locus's
motif.  A directory that already holds ``pan.kmers.dbi`` is taken as
built.  OUTDIR defaults to ``<repo>/build/bench_rpgg``.
"""

from __future__ import annotations

import os
import sys

import numpy as np

from ..apps.fa2kmers import fa2kmers, make_tre_kmers
from ..index import dbi as dbi_mod

KSIZE, FS = 21, 700
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def build(outdir: str, nloci: int = 512, nhap: int = 4, seed: int = 42):
    """Writes the panel under ``outdir``; returns its prefix
    (``outdir/pan``)."""
    os.makedirs(outdir, exist_ok=True)
    pan = os.path.join(outdir, "pan")
    if os.path.exists(pan + ".kmers.dbi"):
        return pan
    rng = np.random.default_rng(seed)
    bases = "ACGT"

    def rand_seq(n):
        return "".join(bases[i] for i in rng.integers(0, 4, n))

    motifs = []
    hapfiles = []
    haps = [[] for _ in range(nhap)]
    for li in range(nloci):
        if li % 5 == 4 and motifs:
            motif = motifs[int(rng.integers(0, len(motifs)))]
        else:
            motif = rand_seq(int(rng.integers(3, 16)))
        motifs.append(motif)
        lf, rf = rand_seq(FS), rand_seq(FS)
        base_n = int(rng.integers(20, 100))
        for h in range(nhap):
            n = max(3, base_n + int(rng.integers(-5, 6)))
            tr = motif * n
            haps[h].append(lf + tr + rf)
    for h in range(nhap):
        p = os.path.join(outdir, f"hap{h}.fa")
        with open(p, "w") as f:
            for li, s in enumerate(haps[h]):
                f.write(f">locus{li}\n{s}\n")
        hapfiles.append(p)
    print(f"building {nloci}-locus RPGG...", file=sys.stderr)
    fa2kmers(pan, hapfiles, k=KSIZE, fsi=FS, fso=FS)
    make_tre_kmers(pan, hapfiles, KSIZE, FS)
    dbi_mod.serialize(pan)
    return pan


if __name__ == "__main__":
    out = sys.argv[1] if len(sys.argv) > 1 else os.path.join(
        ROOT, "build", "bench_rpgg")
    n = int(sys.argv[2]) if len(sys.argv) > 2 else 512
    print(build(out, n))
