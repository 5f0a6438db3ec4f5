"""RPGG evaluation by per-locus linear regression (kmers.linreg.py
equivalent, reference script/kmers.linreg.py + vntrutils.PlotRegression).

Per locus: OLS (no intercept) of SRS k-mer counts (y) against assembly
k-mer counts (x), with the reference's outlier-rejection modes; reports
TrueDosage (sum of assembly counts), PredDosage (sum(y)/slope), Slope and
uncentered R^2 in the same .pred table format.

statsmodels is unavailable here; the no-intercept OLS is closed-form
(slope = <x,y>/<x,x>, R^2 uncentered = 1 - SSR/<y,y>), identical math to
sm.OLS(y, x).
"""

from __future__ import annotations

import numpy as np


def read_kmer_table(path: str, sort: bool = True, with_names: bool = False):
    """vntrutils.readKmers equivalent: per-locus count column (sorted by
    kmer value), list indexed by locus; with_names keeps [kmer, count]."""
    out = []
    cur = []
    with open(path) as f:
        f.readline()  # consume first '>'
        for line in f:
            if line[0] == ">":
                out.append(_table(cur, sort, with_names))
                cur = []
            else:
                cur.append(line.split())
        out.append(_table(cur, sort, with_names))
    return out


def _table(rows, sort, with_names=False):
    if not rows:
        shape = (0, 2) if with_names else 0
        return np.zeros(shape, dtype=np.int64)
    t = np.array(rows, dtype=np.int64)
    if sort:
        t = t[t[:, 0].argsort()]
    return t if with_names else t[:, 1]


def ols_no_intercept(x: np.ndarray, y: np.ndarray):
    """-> (slope, resid, r2_uncentered)."""
    denom = float(np.dot(x, x))
    if denom == 0:
        return 0.0, y.astype(float), 0.0
    a = float(np.dot(x, y)) / denom
    resid = y - a * x
    ssr = float(np.dot(resid, resid))
    sst = float(np.dot(y, y))
    r2 = 1 - ssr / sst if sst else 0.0
    return a, resid, r2


def recursive_rejection(x, y):
    """Drop points with |residual - mean| >= 10*std, iteratively."""
    while True:
        a, resid, _ = ols_no_intercept(x, y)
        m, s = resid.mean(), resid.std()
        keep = np.abs(resid - m) < 10 * s
        if keep.sum() == 0:
            return x[keep], y[keep]
        if keep.all():
            return x, y
        x, y = x[keep], y[keep]


def reject_outlier(x, y, rule: int):
    logic = np.isfinite(x) & np.isfinite(y)
    if rule == 0:
        return x[logic], y[logic], 0
    if rule in (1, 2):
        logic &= (x != 0) & (y != 0)
        if rule == 1:
            return x[logic], y[logic], 0
    if rule in (2, 3):
        x, y = x[logic], y[logic]
        x0, y0 = recursive_rejection(x, y)
        return x0, y0, x.size - x0.size
    raise ValueError(rule)


_RULES = {"invalid": 0, "invalid|zero": 1, "invalid|bad|zero": 2,
          "invalid|bad": 3}


def regress_locus(x, y, outlier: str = "invalid"):
    """PlotRegression math (sans plotting): (slope, r2, pred_dosage)."""
    x1, y1, _ = reject_outlier(x, y, _RULES[outlier])
    if not x1.size or not y1.size:
        x1, y1, _ = reject_outlier(x, y, 1)
    if not x1.size or not y1.size:
        return 0.0, 0.0, 0.0
    a, _, r2 = ols_no_intercept(x1.astype(float), y1.astype(float))
    pred = float(np.sum(y1)) / a if a else 0.0
    return a, r2, pred


def linreg(pacbio_kmers: str, illumina_kmers: str, out_pred: str,
           outlier: str = "invalid", mapkmer: bool = False):
    """Writes the .pred table: TrueDosage PredDosage Slope r^2 per locus.

    mapkmer joins the two tables on the shared k-mer names per locus
    (the reference's --mapkmer flow for cross-index comparisons)."""
    xs = read_kmer_table(pacbio_kmers, with_names=mapkmer)
    ys = read_kmer_table(illumina_kmers, with_names=mapkmer)
    nloci = len(ys)
    results = np.zeros((nloci, 4))
    for k in range(nloci):
        xk, yk = xs[k], ys[k]
        if mapkmer and xk.size and yk.size:
            shared = np.intersect1d(xk[:, 0], yk[:, 0])
            results[k, 0] = xk[:, 1].sum()
            xk = xk[np.isin(xk[:, 0], shared), 1]
            yk = yk[np.isin(yk[:, 0], shared), 1]
        elif mapkmer:
            results[k, 0] = xk[:, 1].sum() if xk.size else 0
            xk = yk = np.zeros(0, dtype=np.int64)
        else:
            if xk.size:
                results[k, 0] = xk.sum()
        if yk.size and xk.size:
            # leading zero point per reference (np.insert(...,0,0))
            x = np.insert(xk, 0, 0)
            y = np.insert(yk, 0, 0)
            a, r2, pred = regress_locus(x, y, outlier)
            results[k, 1:] = [pred, a, r2]
    np.savetxt(out_pred, results, fmt=["%i", "%.1f", "%.2f", "%.4f"],
               delimiter="\t", header="TrueDosage\tPredDosage\tSlope\tr^2")
    return results
