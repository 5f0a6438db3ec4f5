"""Runnable single-tissue eQTL mapping (the reference's end-to-end file
glue, script/eqtl.noPerm.py:60-333).

Inputs are GTEx-shaped files:
  - TR bed + (gene, TR) cis-window pair bed + gene id/name bed
  - per-sample ``.tr.kmers`` genotypes (locus dosage = sum of counts,
    eqtl.noPerm.py:101-121) or a cached genotype pickle
  - normalized-expression beds ({tissue}.v8.normalized_expression.bed.gz)
  - covariates ({tissue}.v8.covariates.txt) + optional SNP-PC evec file
  - subject phenotypes (sex) + ctrl-region coverage for dosage
    normalization (eqtl.noPerm.py:124-166)

Output: {tissue}.v8.egenes.txt per tissue, byte-identical to the
reference script executed on the same inputs (oracle-tested).

Structure: analysis.eqtl carries the statistical core (residualize,
BH-FDR); this module adds the file formats and the per-tissue driver,
replacing the reference's per-pair statsmodels OLS loop with one
vectorized slope/t pass over z-scored matrices.

Replicated quirks (for parity):
  - genotype matrix columns follow ``glob.glob`` file order, which the
    reference assumes matches the genomes list order
    (eqtl.noPerm.py:103 vs :171-178)
  - the Bonferroni-scaled p (which can exceed 1) is both the ranking key
    and the value written as ``pval_nominal`` (:195, :278)
  - loci in [NL1, NL2) (chrX) divide by the subject's sex code, loci
    beyond NL2 get no ploidy correction (:163-164)
"""

from __future__ import annotations

import glob
import os
import pickle

import numpy as np
from scipy import stats as sps

from .eqtl import fdr_bh, zscore


# ---------------------------------------------------------------------------
# input readers
# ---------------------------------------------------------------------------

def locus_dosage_from_kmers(path: str, nloci: int) -> np.ndarray:
    """Per-locus dosage = sum of k-mer counts in one .tr.kmers file."""
    out = np.zeros(nloci)
    li = -1
    acc = 0
    with open(path) as f:
        for line in f:
            if line[0] == ">":
                if li >= 0:
                    out[li] = acc
                li += 1
                acc = 0
            else:
                acc += int(line.split()[1])
    if li >= 0:
        out[li] = acc
    return out


def read_genotype_matrix(gen_dir: str, nloci: int, nwgs: int) -> np.ndarray:
    """(nloci, nwgs) raw dosage matrix; column order = glob order (see
    module docstring)."""
    gen = np.zeros((nloci, nwgs))
    for fi, fname in enumerate(glob.glob(f"{gen_dir}/*.tr.kmers")):
        gen[:, fi] = locus_dosage_from_kmers(fname, nloci)
    return gen


def ctrl_normalized_coverage(cov_path: str, ctrl_bed: str,
                             mth: float = 1.2, sth: float = 0.1
                             ) -> np.ndarray:
    """Per-sample global coverage over ctrl regions, with high-variance /
    high-mean ctrl loci rejected (processBamCov, eqtl.noPerm.py:124-143)."""
    bed = np.loadtxt(ctrl_bed, usecols=[1, 2], dtype=int)
    size = bed[:, 1] - bed[:, 0]
    cov = np.loadtxt(cov_path, dtype=object)[:, 2:].astype(float)
    percov = cov / (cov @ size / np.sum(size))[:, None]
    bad = (np.std(percov, axis=0) > sth) | (np.mean(percov, axis=0) > mth)
    return cov[:, ~bad] @ size[~bad] / np.sum(size[~bad])


def sex_by_genome(phenotype_path: str, genomes: np.ndarray) -> np.ndarray:
    """Subject sex codes aligned to the genomes list ('GTEX-<id>' rows,
    id = token after the first dash)."""
    rows = np.loadtxt(phenotype_path, dtype=object, usecols=[0, 1])[1:]
    sex = {r[0].split("-")[1]: int(r[1]) for r in rows}
    return np.array([sex[g] for g in genomes], dtype=int)


def normalize_genotypes(gen: np.ndarray, out_dir: str, ctrl_bed: str,
                        phenotype_path: str, genomes: np.ndarray,
                        nl1: int, nl2: int) -> np.ndarray:
    """Depth + ploidy correction (correctGenMat, eqtl.noPerm.py:146-166)."""
    gcov = ctrl_normalized_coverage(f"{out_dir}/ctrl.cov", ctrl_bed)
    norm = gen / gcov
    norm[:nl1] /= 2
    norm[nl1:nl2] /= sex_by_genome(phenotype_path, genomes)
    return norm


def _expression_header_samples(path: str) -> np.ndarray:
    head = np.loadtxt(path, dtype=object, max_rows=1, comments="!")[4:]
    return np.array([s[5:] for s in head])       # strip 'GTEX-'


def load_snp_pcs(evec_path: str | None, ndim: int = 838):
    """(PCs, sample ids) from a joint PCA .evec file; sample id = token
    after the last dash (eqtl.noPerm.py:65-73)."""
    if evec_path is None:
        return None, None
    rows = np.loadtxt(evec_path, usecols=np.arange(11),
                      dtype=object)[:ndim]
    return rows[:, 1:].astype(float), [s.split("-")[-1]
                                       for s in rows[:, 0]]


def residual_expression(exp_bed: str, cov_path: str, snp_pcs,
                        snp_samples) -> np.ndarray:
    """(ngenes, nsamples) expression with GTEx covariates + SNP PCs
    projected out (getTisSNPResTpmMat, eqtl.noPerm.py:76-97)."""
    samples = _expression_header_samples(exp_bed)
    snp_ind = {s: i for i, s in enumerate(snp_samples)}
    pcs = snp_pcs[[snp_ind[s] for s in samples]]
    gtex = np.loadtxt(cov_path, dtype=object,
                      skiprows=1)[:, 1:].astype(float).T
    C = np.hstack((gtex, pcs))
    tpm = np.loadtxt(exp_bed, dtype=object,
                     skiprows=1)[:, 4:].astype(float).T
    # NOTE: the reference computes (1 - P) @ tpm with SCALAR 1
    # (eqtl.noPerm.py:96) — an elementwise ones-minus-projection, not the
    # I - P residualizer (analysis.eqtl.residualize).  Downstream results
    # depend on it, so parity replicates the reference's arithmetic here.
    P = C @ np.linalg.inv(C.T @ C) @ C.T
    return ((1 - P) @ tpm).T


# ---------------------------------------------------------------------------
# association
# ---------------------------------------------------------------------------

def batched_slope_test(Y: np.ndarray, X: np.ndarray):
    """OLS y ~ const + x slope inference for each row pair: returns
    (beta, se, p).  One vectorized pass — equivalent to the reference's
    per-pair sm.OLS fits (runRegressionZ3, eqtl.noPerm.py:184-206)."""
    n = X.shape[1]
    mx = X.mean(axis=1, keepdims=True)
    my = Y.mean(axis=1, keepdims=True)
    xc = X - mx
    sxx = (xc * xc).sum(axis=1)
    sxy = (xc * (Y - my)).sum(axis=1)
    b = sxy / sxx
    resid = (Y - my) - b[:, None] * xc
    s2 = (resid * resid).sum(axis=1) / (n - 2)
    se = np.sqrt(s2 / sxx)
    with np.errstate(divide="ignore", invalid="ignore"):
        t = b / se
    p = 2 * sps.t.sf(np.abs(t), n - 2)
    return b, se, p


def best_tr_per_gene(dosage: np.ndarray, res_expr: np.ndarray,
                     locus2genes: dict[int, list[int]]):
    """Z-score, associate every (TR, gene) pair, Bonferroni-scale by the
    gene's candidate-TR count, keep the best TR per gene (first-reach on
    ties).  Returns (gene_tr (N,2) int, stats (N,3) [p, b, se],
    gene2ntr)."""
    gene2ntr: dict[int, int] = {}
    pairs: list[tuple[int, int]] = []
    for li, genes in locus2genes.items():
        for g in genes:
            gene2ntr[g] = gene2ntr.get(g, 0) + 1
            pairs.append((li, g))
    X = zscore(dosage)
    Y = zscore(res_expr)
    li_arr = np.array([p[0] for p in pairs], dtype=int)
    g_arr = np.array([p[1] for p in pairs], dtype=int)
    xs, ys = X[li_arr], Y[g_arr]
    ok = np.isfinite(xs).all(axis=1) & np.isfinite(ys).all(axis=1)
    b, se, p = batched_slope_test(ys, xs)
    best: dict[int, tuple] = {}
    for i in range(len(pairs)):
        if not ok[i]:
            continue
        g = g_arr[i]
        padj = p[i] * gene2ntr[g]
        if g not in best or padj < best[g][0]:
            best[g] = (padj, b[i], se[i], li_arr[i])
    gene_tr = np.array([[g, v[-1]] for g, v in best.items()], dtype=int)
    stats = np.array([[v[0], v[1], v[2]] for v in best.values()])
    return gene_tr, stats, gene2ntr


# ---------------------------------------------------------------------------
# per-tissue driver
# ---------------------------------------------------------------------------

def run_tissue(tissue: str, *, exp_dir: str, cov_dir: str, res_dir,
               out_dir: str, gen_mat: np.ndarray,
               genomes: np.ndarray, tr_by_pair, loci2ind,
               snp_pcs, snp_samples):
    """One tissue: map TR/gene candidates into this tissue's gene and
    sample spaces, residualize expression (cached as a pickle), run the
    associations, BH-FDR across genes.  Returns (egene rows, gene list)
    — rows are [gene_id, num_var, TR_locus, p, b, se, qval] for FDR-
    rejected genes (singleTissue_eGene_stat, eqtl.noPerm.py:218-244)."""
    exp_bed = f"{exp_dir}/{tissue}.v8.normalized_expression.bed.gz"
    gene_list = np.loadtxt(exp_bed, dtype=object, skiprows=1, usecols=[3])
    gene2ind = {g: i for i, g in enumerate(gene_list)}

    locus2genes: dict[int, list[int]] = {}
    for row in tr_by_pair:
        li = loci2ind["_".join(row[:-1])]
        if row[-1] in gene2ind:
            locus2genes.setdefault(li, []).append(gene2ind[row[-1]])

    # this tissue's samples -> genotype columns
    geno_ind = {g: i for i, g in enumerate(genomes)}
    samples = _expression_header_samples(exp_bed)
    tis_gen = gen_mat[:, [geno_ind[s] for s in samples]]

    cached = (f"{res_dir}/{tissue}.ResMat.pickle" if res_dir else None)
    if cached and glob.glob(cached):
        res_expr = pickle.load(open(cached, "rb"))
    else:
        res_expr = residual_expression(
            exp_bed, f"{cov_dir}/{tissue}.v8.covariates.txt",
            snp_pcs, snp_samples)
        pickle.dump(res_expr,
                    open(f"{out_dir}/{tissue}.ResMat.pickle", "wb"))

    gene_tr, stats, gene2ntr = best_tr_per_gene(tis_gen, res_expr,
                                                locus2genes)
    rejected, adjp = fdr_bh(stats[:, 0])
    nvar = np.array([gene2ntr[g] for g in gene_tr[:, 0]], dtype=int)
    rows = np.hstack((
        gene_list[gene_tr[:, 0]][:, None], nvar[:, None],
        gene_tr[:, 1][:, None], stats, adjp[:, None]))[rejected]
    return rows


def run_eqtl(args) -> list[str]:
    """Full driver (eqtl.noPerm.py __main__ + writeAlleGeneTR): returns
    the list of written egenes files."""
    genomes = np.loadtxt(args.genomes, dtype=object)
    nwgs = genomes.size
    nloci = np.loadtxt(args.TRbed, usecols=[1]).size
    tr_rows = np.loadtxt(args.TRbed, dtype=object, usecols=[0, 1, 2])
    loci2ind = {"_".join(r): i for i, r in enumerate(tr_rows)}
    tr_by_pair = np.loadtxt(args.pair, dtype=object, usecols=[5, 6, 7, 3])

    if args.genMat:
        gen_mat = pickle.load(open(args.genMat, "rb"))
    else:
        raw_cache = f"{args.outDir}/rawGenotype.pickle"
        if glob.glob(raw_cache):
            gen_mat = pickle.load(open(raw_cache, "rb"))
        else:
            gen_mat = read_genotype_matrix(args.genDir, nloci, nwgs)
            pickle.dump(gen_mat, open(raw_cache, "wb"))
        gen_mat = normalize_genotypes(
            gen_mat, args.outDir, args.ctrlbed, args.phenotype, genomes,
            args.NL1, args.NL2)
        pickle.dump(gen_mat,
                    open(f"{args.outDir}/normedGenotype.pickle", "wb"))

    # gene annotation: id -> (name, chr, start, end)
    gene_info = np.loadtxt(args.geneBed, dtype=object)[:, [3, 4, 0, 1, 2]]
    gene_info[:, 3:] = gene_info[:, 3:].astype(int)
    gene2row = {gene_info[i, 0]: i for i in range(gene_info.shape[0])}
    tr_info = np.loadtxt(args.TRbed, dtype=object, usecols=[0, 1, 2])
    tr_info[:, 1:] = tr_info[:, 1:].astype(int)

    snp_pcs, snp_samples = load_snp_pcs(args.SNPPC)
    written = []
    for tissue in np.loadtxt(args.tissues, dtype=object, ndmin=1):
        rows = run_tissue(
            tissue, exp_dir=args.expDir, cov_dir=args.covDir,
            res_dir=args.resDir, out_dir=args.outDir, gen_mat=gen_mat,
            genomes=genomes, tr_by_pair=tr_by_pair, loci2ind=loci2ind,
            snp_pcs=snp_pcs, snp_samples=snp_samples)
        gidx = np.array([gene2row[g] for g in rows[:, 0]], dtype=int)
        out = np.hstack((rows[:, 0:1], gene_info[gidx, 1:], rows[:, 1:2],
                         tr_info[rows[:, 2].astype(int)], rows[:, 2:]))
        out = out[np.argsort(rows[:, 2])]
        path = f"{args.outDir}/{tissue}.v8.egenes.txt"
        np.savetxt(
            path, out, delimiter="\t",
            header="gene_id\tgene_name\tchr\tstart\tend\tnum_var\t"
                   "TR_chr\tTR_start\tTR_end\tTR_locus\tpval_nominal\t"
                   "slope\tslope_se\tqval",
            fmt=["%s", "%s", "%s", "%i", "%i", "%i", "%s", "%i", "%i",
                 "%i", "%.4e", "%.4e", "%.4e", "%.4e"])
        written.append(path)
    return written
