"""WGS-shaped paired-end reads for the bench workers.

Port of tools/bench_e2e.py's ``synth_reads`` (numpy only): for the same
arguments it writes the same bytes.  The bench's panel worker
(bench_panel_funnel.py) and scale worker (bench_scale_funnel.py) make
their reads files with it.
"""

from __future__ import annotations

import os
import sys

import numpy as np


def synth_reads(path, npairs, frac, seqs, L=150, err=0.0,
                chunk=1_000_000, seed=3, flen=500, bg_pool=None):
    """WGS-shaped PE fasta, vectorized (a 5e7-pair/30GB file is feasible):
    frac of pairs drawn from the haplotype pool, the rest background —
    uniform random (bg_pool=None) or proper PE fragments of real sequence
    (bg_pool=[byte arrays]).  err = per-base substitution rate; with a
    real background the profile applies to every read (real reads carry
    errors everywhere).  The file is written under ``path + ".tmp"`` and
    renamed at the end, so an interrupted synthesis never leaves a
    truncated file that a later run takes for a cached one."""
    rng = np.random.default_rng(seed)
    pool = [np.frombuffer(s.encode(), dtype=np.uint8)
            for s in seqs if len(s) >= flen]
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    comp = np.zeros(256, dtype=np.uint8)
    for a, b in zip(b"ACGTN", b"TGCAN"):
        comp[a] = b
    b2i = np.zeros(256, dtype=np.int64)
    for i_, a in enumerate(b"ACGT"):
        b2i[a] = i_
    nl = np.uint8(ord("\n"))
    bg = None
    if bg_pool is not None:
        bg = np.concatenate(bg_pool)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        done = 0
        while done < npairs:
            n = min(chunk, npairs - done)
            if bg is None:
                r1 = bases[rng.integers(0, 4, (n, L))]
                r2 = bases[rng.integers(0, 4, (n, L))]
            else:
                # proper PE fragments from the background; RC the whole
                # fragment half the time (strand randomness)
                starts = rng.integers(0, len(bg) - flen, n)
                w = np.arange(L)
                r1 = bg[starts[:, None] + w]
                r2 = comp[bg[(starts + flen - L)[:, None] + w]][:, ::-1]
                flip = rng.random(n) < 0.5
                r1f = comp[r2[flip, ::-1]][:, ::-1]      # RC of mate2
                r2f = comp[r1[flip, ::-1]][:, ::-1]
                r1[flip], r2[flip] = r1f, r2f
                if err:
                    for r in (r1, r2):
                        m = rng.random((n, L)) < err
                        cur = b2i[r[m]]
                        r[m] = bases[(cur + rng.integers(
                            1, 4, int(m.sum()))) % 4]
            for i in np.flatnonzero(rng.random(n) < frac):
                s = pool[int(rng.integers(len(pool)))]
                b = int(rng.integers(0, len(s) - flen + 1))
                r1[i] = s[b:b + L]
                r2[i] = comp[s[b + flen - L:b + flen]][::-1]
                if err:
                    for r in (r1, r2):
                        m = np.flatnonzero(rng.random(L) < err)
                        # substitute a DIFFERENT base, so the nominal rate
                        # is the effective rate
                        cur = b2i[r[i, m]]
                        r[i, m] = bases[(cur + rng.integers(
                            1, 4, len(m))) % 4]
            r1 = np.concatenate([r1, np.full((n, 1), nl)], axis=1)
            r2 = np.concatenate([r2, np.full((n, 1), nl)], axis=1)
            f.write(b"".join(
                b">p%d/1\n%s>p%d/2\n%s" % (done + i, r1[i].tobytes(),
                                           done + i, r2[i].tobytes())
                for i in range(n)))
            done += n
            print(f"  {done}/{npairs} pairs", file=sys.stderr)
    os.replace(tmp, path)
