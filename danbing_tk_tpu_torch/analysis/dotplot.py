"""Repeat dot-plot and cross-contamination analysis (numeric core of
vntrutils.plotCrossContamination / getbadkmc_bothhaps, reference
script/vntrutils.py:427-514; plotting glue omitted).

Two TR+flank sequences are compared through their shared canonical
k-mers; a shared k-mer whose position pair falls in one sequence's flank
while inside the other's TR is "contamination" (TR k-mers leaking into
flanks -> mapping ambiguity), counted per quadrant 0L/0R/1L/1R.
"""

from __future__ import annotations

import numpy as np

from ..ops import kmers_np as K

INVALID = 0xFFFFFFFFFFFFFFFF


def shared_kmer_points(ctg0: str, ctg1: str, ksize: int = 21):
    """All (i, j) position pairs of canonical k-mers shared by both
    sequences (the dot-plot point cloud)."""
    k0 = K.seq_to_kmers(K.encode_bases(ctg0), ksize)
    k1 = K.seq_to_kmers(K.encode_bases(ctg1), ksize)
    pos1: dict[int, list[int]] = {}
    for j, km in enumerate(k1.tolist()):
        if km != INVALID:
            pos1.setdefault(km, []).append(j)
    xs, ys = [], []
    for i, km in enumerate(k0.tolist()):
        for j in pos1.get(km, ()):
            xs.append(i)
            ys.append(j)
    return np.array(xs), np.array(ys)


def cross_contamination(ctg0: str, ctg1: str, ksize: int = 21,
                        fs: int = 700):
    """-> (badkmc[4] = 0L,0R,1L,1R counts, bad_points (xs, ys)).

    Regions follow getbadkmc_bothhaps: TR = [fs, len-fs); a point is bad
    when one coordinate is in a flank window and the other inside the TR.
    """
    s0, e0 = fs, len(ctg0) - fs
    s1, e1 = fs, len(ctg1) - fs
    r0 = (s0, e0 - ksize + 1)
    r1 = (s1, e1 - ksize + 1)
    xs, ys = shared_kmer_points(ctg0, ctg1, ksize)
    ss0, ee0 = r0[0] - fs, r0[1] + fs
    ss1, ee1 = r1[0] - fs, r1[1] + fs
    m = (xs >= ss0) & (xs <= ee0) & (ys >= ss1) & (ys <= ee1)
    xs_, ys_ = xs[m], ys[m]
    quad = [
        ((ss0, r0[0]), (r1[0], r1[1])),   # 0L
        ((r0[1], ee0), (r1[0], r1[1])),   # 0R
        ((r0[0], r0[1]), (ss1, r1[0])),   # 1L
        ((r0[0], r0[1]), (r1[1], ee1)),   # 1R
    ]
    badkmc = np.zeros(4, dtype=int)
    badmask = np.zeros(len(xs_), dtype=bool)
    for qi, ((x0, x1), (y0, y1)) in enumerate(quad):
        mm = (xs_ >= x0) & (xs_ < x1) & (ys_ >= y0) & (ys_ < y1)
        badkmc[qi] = mm.sum()
        badmask |= mm
    return badkmc, (xs_[badmask], ys_[badmask])


def contamination_report(ctg0: str, ctg1: str, ksize: int = 21,
                         fs: int = 700) -> dict:
    """Cross-contamination QC summary for one locus pair
    (plotCrossContamination's title stat + point clouds,
    vntrutils.py:452-514; matplotlib glue omitted).

    rate = 100 * sum(badkmc) / (TRsize0 + TRsize1), the percentage the
    reference prints as "contam=..., X%".
    """
    tr0 = len(ctg0) - 2 * fs
    tr1 = len(ctg1) - 2 * fs
    badkmc, bad = cross_contamination(ctg0, ctg1, ksize, fs)
    points = shared_kmer_points(ctg0, ctg1, ksize)
    return {
        "badkmc": badkmc,
        "rate_pct": 100.0 * badkmc.sum() / (tr0 + tr1),
        "points": points,
        "bad_points": bad,
    }


def self_repeat(seq: str, ksize: int = 13, fs: int = 700) -> dict:
    """Self dot-plot QC (visSelfRepeat, vntrutils.py:514-519): the same
    contamination analysis of a sequence against itself, k=13 by default
    to expose diffuse self-similarity."""
    return contamination_report(seq, seq, ksize, fs)
