"""VNTR length prediction from k-mer dosage (kmc2length.py equivalent,
reference script/kmc2length.py).

Uses precomputed locus-specific biases (LSB): control-region read-depth
normalization with IQR outlier masking, nearest-neighbor LSB donor chosen
by non-TR bias distance, then length = kmc / (cov * bias) with the
reference's k-mer -> bp correction.

Note: the reference's ``loadvntrmat`` passes the output row where
``readKms`` expects the locus index array (kmc2length.py:20, bit-rotted at
HEAD); we take an explicit ksi (per-locus k-mer counts from `ktools ksi`)
and implement the intended per-locus sums.
"""

from __future__ import annotations

import numpy as np


def iqr_mask(data: np.ndarray, whis: float = 1.5) -> np.ndarray:
    """True = outlier/invalid (get1DIQRmask)."""
    m = np.isfinite(data)
    q1 = np.quantile(data[m], 0.25)
    q3 = np.quantile(data[m], 0.75)
    k = (q3 - q1) * whis
    return ~m | (data < q1 - k) | (data > q3 + k)


def process_ctrl_cov(covmat: np.ndarray, ctrlsize: np.ndarray,
                     whis: float = 1.5):
    """-> (per-sample ctrl coverage, pruned normalized covmat, full
    normalized covmat)."""
    cov = covmat @ ctrlsize / ctrlsize.sum()
    normcov = covmat / (covmat @ ctrlsize / ctrlsize.sum())[:, None]
    bad = iqr_mask(normcov.std(axis=0)) | iqr_mask(normcov.mean(axis=0))
    psize = ctrlsize[~bad]
    pcov = covmat[:, ~bad] @ psize / psize.sum()
    return pcov, covmat[:, ~bad] / pcov[:, None], covmat / cov[:, None]


def row_distance(mat1, mat2, reject: bool = True):
    """Mean |1 - a/b| over jointly valid columns, all row pairs."""
    n1, n2 = mat1.shape[0], mat2.shape[0]
    out = np.zeros((n1, n2))
    with np.errstate(all="ignore"):
        for i in range(n1):
            for j in range(n2):
                if reject:
                    bm = (iqr_mask(mat1[i]) | iqr_mask(mat2[j])
                          | (mat1[i] == 0) | (mat2[j] == 0))
                else:
                    bm = (~np.isfinite(mat1[i]) | ~np.isfinite(mat2[j])
                          | (mat1[i] == 0) | (mat2[j] == 0))
                gt, est = mat1[i][~bm], mat2[j][~bm]
                out[i, j] = np.nanmean(np.abs(1 - gt / est))
    return out


def len_pred(ilkms, bias, cov, ksize: int):
    est = np.full(len(ilkms), np.nan)
    m = (bias > 0) & np.isfinite(bias)
    est[m] = ilkms[m] / (cov * bias[m])
    est[est >= 1] += ksize - 1
    est[est < 1] *= ksize
    return est


def read_locus_sums(counts_path: str, ksi: list[int]) -> np.ndarray:
    """Per-locus sums of a count-only kmer file (intended readKms)."""
    from ..apps.ktools import kms_sum

    return np.array(kms_sum(ksi, counts_path), dtype=np.int64)


def seqrun_prior_donor(dis: np.ndarray, runs, runs_db=None,
                       bad_donors=()) -> np.ndarray:
    """Donor index per sample, preferring the nearest donor from the same
    sequencing run (kmc2length.LOO.py:107-120 getBestUsingSeqrunPrior).

    dis: (samples x donors) distance matrix; runs / runs_db: sequencing-run
    label per sample / donor (runs_db defaults to runs for the LOO case
    where samples are their own donor panel); bad_donors: donor indices
    excluded from the search.  A sample whose own run is "individual"
    accepts a donor from any run.  Falls back to donor 0 when no candidate
    qualifies, as the reference's zero-initialized bestind does.
    """
    if runs_db is None:
        runs_db = runs
    bad = set(bad_donors)
    order = np.argsort(dis, axis=1)
    chosen = np.zeros(dis.shape[0], dtype=int)
    for i, candidates in enumerate(order):
        run = runs[i]
        for j in candidates:
            if j not in bad and (runs_db[j] == run or run == "individual"):
                chosen[i] = j
                break
    return chosen


def kmc2length(trmat: np.ndarray, ntrbias: np.ndarray,
               trbias_db: np.ndarray, ntrbias_db: np.ndarray,
               cov: np.ndarray, ksize: int, runs=None, runs_db=None,
               bad_donors=()) -> np.ndarray:
    """Bias-corrected length estimates (samples x loci).

    trmat: per-sample locus k-mer sums; ntrbias: per-sample control-region
    bias rows; *_db: precomputed LSB panel; cov: per-sample coverage.
    With ``runs`` (sequencing-run label per sample), donors are picked by
    the seqrun prior instead of the unconditioned nearest neighbor.
    """
    dis = row_distance(ntrbias, ntrbias_db)
    if runs is not None:
        best = seqrun_prior_donor(dis, runs, runs_db, bad_donors)
    else:
        best = np.argsort(dis, axis=1)[:, 0]
    ests = np.full(trmat.shape, np.nan)
    for i, b in enumerate(best):
        ests[i] = len_pred(trmat[i], trbias_db[b], cov[i], ksize)
    return ests
