"""eQTL association core (eqtl.noPerm.py equivalent, reference
script/eqtl.noPerm.py).

Implements the statistical machinery without the GTEx-specific file glue:
covariate residualization (projection onto the orthogonal complement),
per-(TR, gene) OLS association on z-scored dosage/expression with
Bonferroni correction, best-TR-per-gene selection, and Benjamini-Hochberg
FDR (statsmodels.fdrcorrection equivalent, implemented natively).
"""

from __future__ import annotations

import numpy as np
from scipy import stats as sps


def residualize(tpm: np.ndarray, C: np.ndarray) -> np.ndarray:
    """Remove covariates: (I - C (C'C)^-1 C') @ tpm  (samples x genes in
    columns; C: samples x covariates)."""
    P = C @ np.linalg.inv(C.T @ C) @ C.T
    return (np.eye(C.shape[0]) - P) @ tpm


def zscore(m: np.ndarray, axis: int = 1) -> np.ndarray:
    mu = m.mean(axis=axis, keepdims=True)
    sd = m.std(axis=axis, keepdims=True)
    return (m - mu) / sd


def ols_assoc(y: np.ndarray, x: np.ndarray):
    """OLS y ~ const + x: returns (beta, se, pvalue) for the slope."""
    n = len(x)
    X = np.column_stack([np.ones(n), x])
    XtX_inv = np.linalg.inv(X.T @ X)
    beta = XtX_inv @ X.T @ y
    resid = y - X @ beta
    dof = n - 2
    s2 = resid @ resid / dof
    se = np.sqrt(s2 * np.diag(XtX_inv))
    t = beta[1] / se[1]
    p = 2 * sps.t.sf(abs(t), dof)
    return beta[1], se[1], p


def fdr_bh(pvals: np.ndarray, alpha: float = 0.05):
    """Benjamini-Hochberg: returns (rejected bool[], adjusted p[])."""
    p = np.asarray(pvals, dtype=float)
    n = len(p)
    order = np.argsort(p)
    ranked = p[order] * n / np.arange(1, n + 1)
    adj = np.minimum.accumulate(ranked[::-1])[::-1]
    adj = np.minimum(adj, 1.0)
    out = np.empty(n)
    out[order] = adj
    rejected = out <= alpha
    return rejected, out


def map_eqtls(dosage: np.ndarray, expression: np.ndarray,
              pairs: dict[int, list[int]], alpha: float = 0.05):
    """dosage: (nloci, ns); expression: (ngenes, ns) (residualized);
    pairs: locus -> candidate gene indices (cis window).

    Per gene keeps the best-p TR (Bonferroni by #TRs tested per gene),
    then BH-FDR across genes (runRegressionZ3 + fdr, reference :185-214).
    Returns list of (gene, locus, beta, se, p_bonf, p_fdr, rejected).
    """
    genei2n: dict[int, int] = {}
    for locusi, genes in pairs.items():
        for g in genes:
            genei2n[g] = genei2n.get(g, 0) + 1
    X = zscore(dosage)
    Y = zscore(expression)
    best: dict[int, tuple] = {}
    for locusi, genes in pairs.items():
        for g in genes:
            xs, ys = X[locusi], Y[g]
            if not (np.isfinite(xs).all() and np.isfinite(ys).all()):
                continue
            b, se, p = ols_assoc(ys, xs)
            p *= genei2n[g]
            if g not in best or p < best[g][0]:
                best[g] = (p, b, se, locusi)
    if not best:
        return []
    genes = sorted(best)
    ps = np.array([min(best[g][0], 1.0) for g in genes])
    rejected, adj = fdr_bh(ps, alpha)
    return [(g, best[g][3], best[g][1], best[g][2], best[g][0], adj[i],
             bool(rejected[i])) for i, g in enumerate(genes)]
