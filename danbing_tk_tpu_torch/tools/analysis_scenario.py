"""Seeded inputs of the downstream analyses (``call``, ``length``,
``eqtl``) on the golden panel, and the conversions their harness needs.

    python -m danbing_tk_tpu_torch.tools.analysis_scenario --out DIR [--svms]

writes:
  * DIR/reads.fa.gz: read pairs over the golden panel's loci (tests/golden/
    hap{0,1}.fa, one diploid sample) with substitutions planted in them,
    and DIR/plants.tsv, one row a planted base (locus, haplotype,
    position, ref, alt, region).  A locus gets none, a heterozygous
    substitution in its TR, a homozygous one, two heterozygous ones
    40-80 bases apart (less in a short TR), or a heterozygous one in a
    flank (its novel edges reach flank k-mers, so the snarl walk kills
    them).  Reads are 150 bp
    mates of 400 bp fragments at COV pairs-worth of depth a haplotype,
    with 0.1% substitution errors;
  * DIR/length/: the ``length`` inputs (tr.bed, lsb.tsv, cov.txt,
    pan.ksi, per-sample count-only k-mer files listed in kmers.txt,
    runs.txt and dbruns.txt for ``--seqruns``), LSB values written with
    repr, one locus with zero biases (a nan estimate);
  * DIR/eqtl/: GTEx-shaped ``eqtl`` inputs (beds, per-sample .tr.kmers,
    gzipped expression beds, covariates, SNP PCs, phenotypes, control
    coverage) for two tissues, with planted associations, and
    rawGenotype.pickle, the raw dosage matrix in the genomes list's order
    (the cache ``eqtl`` reads from its --outDir instead of globbing
    --genDir, whose order is the file system's);
  * with --svms (needs sklearn): DIR/br.svm and DIR/bp.svm, the two SVMs
    of ``call`` as sklearn pickles, fitted on seeded feature rows spread
    over the ranges the scenario's snarls show: the bubble-root model a
    linear SVC fitted on a DataFrame (so it carries feature names), the
    bubble-path model an rbf SVC fitted on an array; each learns a
    one-feature threshold, so they have few support vectors (11 and 49
    at seed 14), far fewer than a model fitted on real snarls would.
    And DIR/mc.svm, a 3-class rbf SVC (0 rejects; 1 and 2 are two kinds
    of accept) fitted on a DataFrame of MC_ROWS bubble-path rows whose
    labels follow mcov and scov with MC_NOISE of them redrawn at random,
    so it keeps 1,280 support vectors at seed 14: a kernel matrix of a
    real model's size.  DIR/svm_labels.npy holds sklearn's labels of br
    and bp on ``svm_batch(SVM_ROWS, SEED)``, DIR/mc_labels.npy mc's on
    its path rows, as integers.  And DIR/{br,bp}.{stratified,uniform}.svm,
    sklearn DummyClassifiers of the two sampled strategies fitted on the
    br and bp training labels (``fit_dummies``): br with an int
    random_state, bp with a RandomState instance.

The align run that ``call`` needs (``align -ka -bu -cth 20 -kf 4 1 -on
OUT``) writes OUT.tr.kmers and OUT.bub.kmdb; ``bub_text`` turns the
binary bubbles into the text ``.bub`` that ``call`` reads (no command of
either package writes it) and ``counts_text`` the readable OUT.tr.kmers
into the count-only file (``call``'s TR_KMERS; OUT.tr.kmers itself is
its TR_INDEX).  ``callset_text`` writes a callset as sorted text.
Everything comes from numpy's default_rng(SEED) (14); nothing here
imports the JAX package.
"""

from __future__ import annotations

import argparse
import contextlib
import gzip
import io
import os
import pickle
import shutil

import numpy as np

from ..io.text import iter_fasta_records

GOLD = os.path.join(os.path.dirname(__file__), "..", "..", "tests",
                    "golden")
SEED = 14
FS = 700                 # the golden panel's flank size
RLEN, FRAG = 150, 400
COV = 15                 # depth a haplotype
ERR = 0.001
BASES = "ACGT"
_RC = str.maketrans("ACGT", "TGCA")


def _sub(seq: str, pos: int, rng) -> tuple[str, str]:
    alt = BASES[(BASES.index(seq[pos]) + int(rng.integers(1, 4))) % 4]
    return seq[:pos] + alt + seq[pos + 1:], alt


def plant_variants(rng):
    """-> (haps[h][locus] with the planted bases, plant rows)."""
    haps = [[seq for _, seq in iter_fasta_records(
        os.path.join(GOLD, f"hap{h}.fa"))] for h in (0, 1)]
    nloci = len(haps[0])
    kinds = (["het"] * 7 + ["hom"] * 5 + ["two"] * 3 + ["flank"] * 2
             + ["none"] * (nloci - 17))
    kinds = [kinds[i] for i in rng.permutation(nloci)]
    rows = []
    for li, kind in enumerate(kinds):
        tr = min(len(haps[0][li]), len(haps[1][li])) - 2 * FS
        if kind == "none":
            continue
        if kind == "flank":
            spots = [(0, int(rng.integers(200, FS - 100)))]
        else:
            gap = min(int(rng.integers(40, 81)), tr - 12) \
                if kind == "two" else 0
            p = FS + 5 + int(rng.integers(0, tr - 10 - gap))
            hs = (0, 1) if kind == "hom" else (int(rng.integers(0, 2)),)
            spots = [(h, p) for h in hs]
            if kind == "two":
                spots.append((1 - spots[0][0], p + gap))
        for h, p in spots:
            ref = haps[h][li][p]
            haps[h][li], alt = _sub(haps[h][li], p, rng)
            region = "flank" if kind == "flank" else "tr"
            rows.append((li, h, p, ref, alt, region))
    return haps, rows


def sim_pairs(haps, rng):
    """Read pairs (r1, r2) over every locus and haplotype."""
    pairs = []
    for li in range(len(haps[0])):
        for hap in haps:
            seq = hap[li]
            npair = int(round(len(seq) * COV / (2 * RLEN)))
            starts = rng.integers(0, len(seq) - FRAG + 1, npair)
            for s in starts.tolist():
                frag = list(seq[s:s + FRAG])
                for j in np.nonzero(rng.random(FRAG) < ERR)[0].tolist():
                    frag[j] = BASES[(BASES.index(frag[j])
                                     + int(rng.integers(1, 4))) % 4]
                frag = "".join(frag)
                pairs.append((frag[:RLEN], frag[-RLEN:].translate(_RC)[::-1]))
    order = rng.permutation(len(pairs))
    return [pairs[i] for i in order.tolist()]


def write_reads(out: str) -> int:
    rng = np.random.default_rng([SEED, 1])
    haps, rows = plant_variants(rng)
    pairs = sim_pairs(haps, rng)
    with _gz_text(os.path.join(out, "reads.fa.gz")) as f:
        for i, (r1, r2) in enumerate(pairs):
            f.write(f">read{i}/1\n{r1}\n>read{i}/2\n{r2}\n")
    with open(os.path.join(out, "plants.tsv"), "w") as f:
        f.write("locus\thap\tpos\tref\talt\tregion\n")
        for r in rows:
            f.write("\t".join(str(v) for v in r) + "\n")
    return len(pairs)


@contextlib.contextmanager
def _gz_text(path: str):
    """A gzip text file whose bytes depend only on what is written (no
    time stamp in its header)."""
    with open(path, "wb") as raw, \
            gzip.GzipFile(fileobj=raw, mode="wb", mtime=0) as gz, \
            io.TextIOWrapper(gz) as f:
        yield f


def gunzip(path: str, out: str) -> str:
    """Decompress path into out (align reads plain FASTA); returns out."""
    with gzip.open(path, "rb") as f, open(out, "wb") as g:
        shutil.copyfileobj(f, g)
    return out


def bub_text(kmdb: str, out: str) -> None:
    """Binary ``.bub.kmdb`` (per-locus edge -> count map) -> the text
    ``.bub`` of ``call``: one ``>locus`` line a locus, then ``edge\\tcount``
    rows in the file's order."""
    from ..io.binary import read_kmap_db

    index, ks, vs = read_kmap_db(kmdb)
    p = 0
    with open(out, "w") as f:
        for li, n in enumerate(index.tolist()):
            f.write(f">{li}\n")
            for e, c in zip(ks[p:p + n].tolist(), vs[p:p + n].tolist()):
                f.write(f"{e}\t{c}\n")
            p += n


def counts_text(tr_kmers: str, out: str) -> None:
    """Readable ``.tr.kmers`` (``kmer\\tcount`` rows) -> the count-only
    file, one count a line in the same order."""
    with open(tr_kmers) as f, open(out, "w") as g:
        for line in f:
            if line[0] != ">":
                g.write(line.split()[1] + "\n")


def callset_text(calls: dict) -> str:
    """A callset (locus -> [edge set, per-bubble edge sets]) as text: a
    ``>locus`` line a called locus in order, its sorted union edge set on
    one line, then each bubble's sorted edges on one line, in the
    callset's order."""
    lines = []
    for li in sorted(calls):
        union, bubbles = calls[li]
        lines.append(f">{li}")
        lines.append(" ".join(str(e) for e in sorted(union)))
        lines += ["bubble " + " ".join(str(e) for e in sorted(b))
                  for b in bubbles]
    return "\n".join(lines) + "\n"


ROOT_RANGES = (("c_root", 5, 2000), ("c_nv_e", 0, 40),
               ("c_ex_e", -20, 2000), ("c_tm_e", 0, 20), ("r_nve_r", 0, 2),
               ("r_nve_exe", 0, 20), ("n_snrl", 1, 4), ("n_tm_e", 0, 4),
               ("n_bb_e", 1, 60), ("h1", 1, 2), ("h2", 2, 4),
               ("h3", 2.5, 4.5))
PATH_RANGES = (("bbs", 1, 60), ("mcov", 0, 40), ("scov", 0, 10),
               ("fcmax", 0, 30), ("cdiff", -30, 40), ("n3gp", 0, 8),
               ("n4gp", 0, 8), ("bdir", 0, 1))
BR_CUT, BP_CUT = 15.5, 16.0   # c_nv_e and mcov above which a row is true
MC_ROWS, MC_NOISE, MC_SCOV = 1800, 0.3, 5.0   # mc.svm's training rows


def _feature_rows(ranges, n, rng):
    lo = np.array([r[1] for r in ranges], dtype=np.float64)
    hi = np.array([r[2] for r in ranges], dtype=np.float64)
    X = lo + (hi - lo) * rng.random((n, len(ranges)))
    for j, (name, _, _) in enumerate(ranges):
        if name.startswith("n") or name == "bdir":
            X[:, j] = np.floor(X[:, j] + (name == "bdir") * 0.5)
    return X


def fit_svms(out: str) -> None:
    """br.svm (linear, fitted on a DataFrame), bp.svm (rbf, fitted on an
    array) and mc.svm (3-class rbf, fitted on a DataFrame); needs pandas
    and sklearn."""
    import pandas as pd

    from ..models.svm import save_model, train_svm

    rng = np.random.default_rng([SEED, 2])
    Xr = _feature_rows(ROOT_RANGES, 400, rng)
    df = pd.DataFrame(Xr, columns=[r[0] for r in ROOT_RANGES])
    br = train_svm(df, Xr[:, 1] > BR_CUT, kernel="linear")
    Xp = _feature_rows(PATH_RANGES, 400, rng)
    bp = train_svm(Xp, Xp[:, 1] > BP_CUT, kernel="rbf", C=10.0)
    save_model(br, os.path.join(out, "br.svm"))
    save_model(bp, os.path.join(out, "bp.svm"))
    rng = np.random.default_rng([SEED, 6])
    Xm = _feature_rows(PATH_RANGES, MC_ROWS, rng)
    y = np.where(Xm[:, 1] > BP_CUT, np.where(Xm[:, 2] < MC_SCOV, 1, 2), 0)
    redraw = rng.random(MC_ROWS) < MC_NOISE
    y[redraw] = rng.integers(0, 3, int(redraw.sum()))
    mc = train_svm(pd.DataFrame(Xm, columns=[r[0] for r in PATH_RANGES]),
                   y, kernel="rbf")
    save_model(mc, os.path.join(out, "mc.svm"))


DUMMIES = ("stratified", "uniform")


def fit_dummies(out: str) -> None:
    """DIR/br.<strategy>.svm and DIR/bp.<strategy>.svm for each sampled
    DummyClassifier strategy, fitted on the SVMs' seeded training labels:
    the bubble-root model with random_state SEED (an int: a fresh
    RandomState each predict), the bubble-path model with a
    RandomState(SEED) instance (pickled with its state).  Needs sklearn."""
    from sklearn.dummy import DummyClassifier

    from ..models.svm import save_model

    rng = np.random.default_rng([SEED, 2])
    Xr = _feature_rows(ROOT_RANGES, 400, rng)
    Xp = _feature_rows(PATH_RANGES, 400, rng)
    for strategy in DUMMIES:
        for name, X, y, rs in (
                ("br", Xr, Xr[:, 1] > BR_CUT, SEED),
                ("bp", Xp, Xp[:, 1] > BP_CUT, np.random.RandomState(SEED))):
            clf = DummyClassifier(strategy=strategy, random_state=rs)
            save_model(clf.fit(X, y),
                       os.path.join(out, f"{name}.{strategy}.svm"))


SVM_ROWS = 100_000       # rows of the card's production-batch check


def svm_batch(n: int, seed: int):
    """n seeded bubble-root rows and n path rows over the same ranges
    (the card's production-batch check)."""
    rng = np.random.default_rng([seed, 3])
    return (_feature_rows(ROOT_RANGES, n, rng),
            _feature_rows(PATH_RANGES, n, rng))


def sklearn_labels(models: str, out: str) -> None:
    """sklearn's ``predict`` on ``svm_batch(SVM_ROWS, SEED)`` of
    models/br.svm and models/bp.svm -> out/svm_labels.npy, one np.packbits
    row a model (br, bp), and of models/mc.svm (on the path rows) ->
    out/mc_labels.npy as int8; a model fitted on a DataFrame gets one with
    its columns.  Needs pandas and sklearn."""
    import pandas as pd

    def predict(name, X, ranges):
        with open(os.path.join(models, f"{name}.svm"), "rb") as f:
            clf = pickle.load(f)
        if getattr(clf, "feature_names_in_", None) is not None:
            X = pd.DataFrame(X, columns=[r[0] for r in ranges])
        return clf.predict(X)

    Xr, Xp = svm_batch(SVM_ROWS, SEED)
    rows = [np.packbits(predict(name, X, ranges).astype(bool))
            for name, X, ranges in (("br", Xr, ROOT_RANGES),
                                    ("bp", Xp, PATH_RANGES))]
    np.save(os.path.join(out, "svm_labels.npy"), np.stack(rows))
    np.save(os.path.join(out, "mc_labels.npy"),
            predict("mc", Xp, PATH_RANGES).astype(np.int8))


def read_labels(path: str) -> dict:
    """svm_labels.npy -> {"br": bool array, "bp": bool array}."""
    packed = np.load(path)
    return {name: np.unpackbits(row, count=SVM_ROWS).astype(bool)
            for name, row in zip(("br", "bp"), packed)}


LEN_NLOCI, LEN_NCTRL, LEN_NDB, LEN_NSAMPLES = 12, 30, 4, 3


def length_inputs(d: str) -> None:
    """The ``length`` inputs (the layout of the reference's release
    assets and align outputs); kmers.txt lists the count files by name,
    relative to itself."""
    rng = np.random.default_rng([SEED, 4])
    nloci, nctrl, ndb, nsamples = (LEN_NLOCI, LEN_NCTRL, LEN_NDB,
                                   LEN_NSAMPLES)
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "tr.bed"), "w") as f:
        for i in range(nloci):
            f.write(f"chr{1 + i % 2}\t{1000 * i}\t{1000 * i + 500}\n")
    ctrl_lo = rng.integers(100, 5000, nctrl)
    ctrl_sz = rng.integers(200, 2000, nctrl)
    names = [f"ctr.chr1_{lo}_{lo + sz}" for lo, sz in zip(ctrl_lo, ctrl_sz)]
    names += [f"tr_{i}" for i in range(nloci)]
    ntr_db = 1.0 + 0.2 * rng.standard_normal((nctrl, ndb))
    tr_db = np.abs(1.0 + 0.3 * rng.standard_normal((nloci, ndb)))
    tr_db[0, :] = 0.0                      # a bias-less locus -> nan est
    with open(os.path.join(d, "lsb.tsv"), "w") as f:
        f.write("\t" + "\t".join(f"g{j}" for j in range(ndb)) + "\n")
        for n, row in zip(names, np.vstack([ntr_db, tr_db])):
            f.write(n + "\t" + "\t".join(repr(float(v)) for v in row)
                    + "\n")
    covmat = np.abs(30 + 5 * rng.standard_normal((nsamples, nctrl)))
    with open(os.path.join(d, "cov.txt"), "w") as f:
        for i in range(nsamples):
            f.write(f"s{i}\tx\t" + "\t".join(
                repr(float(v)) for v in covmat[i]) + "\n")
    ksi = np.cumsum(rng.integers(3, 9, nloci))
    np.savetxt(os.path.join(d, "pan.ksi"), ksi, fmt="%d")
    files = []
    for i in range(nsamples):
        counts = rng.integers(0, 50, int(ksi[-1]))
        np.savetxt(os.path.join(d, f"s{i}.kms"), counts, fmt="%d")
        files.append(f"s{i}.kms")
    with open(os.path.join(d, "kmers.txt"), "w") as f:
        f.write("\n".join(files) + "\n")
    runs = ["runA", "runB"] * nsamples
    with open(os.path.join(d, "runs.txt"), "w") as f:
        f.write("".join(f"s{i}\t{runs[i]}\n" for i in range(nsamples)))
    with open(os.path.join(d, "dbruns.txt"), "w") as f:
        f.write("".join(f"g{j}\t{runs[j + 1]}\n" for j in range(ndb)))


EQ_SAMPLES = [f"{a}{b}16" for a in "ABCDEFGH" for b in "ABCDEF"]
EQ_TISSUES = ["Adipose_Test", "Brain_Test"]
EQ_NLOCI, EQ_NGENE, EQ_NCTRL = 10, 12, 6
EQ_NL1, EQ_NL2 = 7, 9
PLANTED = ((2, 1), (4, 5), (0, 3))       # (TR, gene) associations


def eqtl_inputs(root: str) -> None:
    """GTEx-shaped ``eqtl`` inputs: 48 samples (each tissue drops one),
    10 TRs, 12 genes (one tested against every TR, one absent from the
    expression beds), 6 control regions (two of them rejected), a TR of
    constant dosage, and three planted TR-gene associations (PLANTED,
    each pair among the tested ones) carried by the covariates (the
    reference residualizes with 1 - P).  The associations are planted on
    the dosage in the genomes list's order,
    which is rawGenotype.pickle's; a run that globs --genDir pairs its
    files with the genomes in the file system's order instead."""
    rng = np.random.default_rng([SEED, 5])
    for sub in ("gen", "exp", "cov"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    S, NL, NG = EQ_SAMPLES, EQ_NLOCI, EQ_NGENE
    tr_rows = [(f"chr{1 + i % 3}", 1000 * i + 37, 1000 * i + 400 + 13 * i)
               for i in range(NL)]
    with open(f"{root}/tr.bed", "w") as f:
        for c, s, e in tr_rows:
            f.write(f"{c}\t{s}\t{e}\n")
    genes = [f"ENSG{i:08d}.{1 + i % 4}" for i in range(NG)]
    with open(f"{root}/genes.bed", "w") as f:
        for i, g in enumerate(genes):
            f.write(f"chr{1 + i % 3}\t{2000 * i}\t{2000 * i + 900}\t{g}\t"
                    f"GENE{i}\n")
    pairs = []
    for li in range(NL):
        cand = sorted(rng.choice(NG, size=int(rng.integers(1, 4)),
                                 replace=False).tolist())
        pairs += [(li, gi) for gi in cand] + [(li, 3)]
    pairs += [p for p in PLANTED if p not in pairs]
    with open(f"{root}/pairs.bed", "w") as f:
        for li, gi in pairs:
            c, s, e = tr_rows[li]
            f.write(f"chrG\t{500 * gi}\t{500 * gi + 100}\t{genes[gi]}\t."
                    f"\t{c}\t{s}\t{e}\n")
        c, s, e = tr_rows[0]
        f.write(f"chrG\t0\t1\tENSG99999999.9\t.\t{c}\t{s}\t{e}\n")
    with open(f"{root}/genomes.txt", "w") as f:
        f.write("\n".join(S) + "\n")
    with open(f"{root}/phenos.txt", "w") as f:
        f.write("SUBJID\tSEX\tAGE\n")
        for i, s in enumerate(S):
            f.write(f"GTEX-{s}\t{1 + i % 2}\t55\n")
    ctrl = [(f"chr{1 + i % 2}", 100 * i, 100 * i + 80 + 10 * i)
            for i in range(EQ_NCTRL)]
    with open(f"{root}/ctrl.bed", "w") as f:
        for c, s, e in ctrl:
            f.write(f"{c}\t{s}\t{e}\n")
    depth = rng.uniform(25, 35, len(S))
    cov = depth[:, None] * (1 + rng.normal(0, 0.02, (len(S), EQ_NCTRL)))
    cov[:, 4] *= rng.uniform(0.7, 1.4, len(S))        # high-variance ctrl
    cov[:, 5] *= 1.8                                  # biased-mean ctrl
    with open(f"{root}/ctrl.cov", "w") as f:
        for i, s in enumerate(S):
            f.write(f"{s}\t.\t" + "\t".join(f"{v:.4f}" for v in cov[i])
                    + "\n")
    dose = rng.uniform(20, 120, (NL, len(S)))
    dose[6] = 77.0                       # constant: the non-finite z skip
    for si, s in enumerate(S):
        with open(f"{root}/gen/{s}.tr.kmers", "w") as f:
            for li in range(NL):
                total = int(dose[li, si])
                f.write(f">{li}\n{li * 7 + 1}\t{total // 2}\n"
                        f"{li * 7 + 2}\t{total - total // 2}\n")
    with open(f"{root}/snp.evec", "w") as f:
        for s in S:
            pcs = "\t".join(f"{v:.5f}" for v in rng.normal(0, 1, 10))
            f.write(f"V-{s}\t{pcs}\tignored\n")
    eff = np.floor(dose)
    with open(f"{root}/rawGenotype.pickle", "wb") as f:
        pickle.dump(eff, f)
    for t in EQ_TISSUES:
        sub = list(S)
        rng.shuffle(sub)
        sub = sub[:len(S) - 1]
        cols = [S.index(s) for s in sub]
        expr = rng.normal(0, 1, (NG, len(sub)))
        for (li, gi), w in zip(PLANTED, (0.5, -0.6, 0.4)):
            expr[gi] += w * eff[li][cols]
        with _gz_text(f"{root}/exp/{t}.v8.normalized_expression.bed.gz") \
                as f:
            f.write("#chr\tstart\tend\tgene_id\t"
                    + "\t".join(f"GTEX-{s}" for s in sub) + "\n")
            for gi, g in enumerate(genes):
                vals = "\t".join(f"{v:.6f}" for v in expr[gi])
                f.write(f"chr{1 + gi % 3}\t{2000 * gi}\t{2000 * gi + 900}"
                        f"\t{g}\t{vals}\n")
        covs = np.vstack([eff[li][cols] / 40 + rng.normal(0, 0.1, len(sub))
                          for li, _ in PLANTED])
        with open(f"{root}/cov/{t}.v8.covariates.txt", "w") as f:
            f.write("ID\t" + "\t".join(f"GTEX-{s}" for s in sub) + "\n")
            for ci in range(3):
                vals = "\t".join(f"{v:.5f}" for v in covs[ci])
                f.write(f"PC{ci + 1}\t{vals}\n")
    with open(f"{root}/tissues.txt", "w") as f:
        f.write("\n".join(EQ_TISSUES) + "\n")


def eqtl_argv(root: str, out: str) -> list:
    """The ``eqtl`` command line over eqtl_inputs(root), writing to out."""
    return ["--TRbed", f"{root}/tr.bed", "--geneBed", f"{root}/genes.bed",
            "--pair", f"{root}/pairs.bed", "--expDir", f"{root}/exp",
            "--genDir", f"{root}/gen", "--covDir", f"{root}/cov",
            "--outDir", out, "--phenotype", f"{root}/phenos.txt",
            "--genomes", f"{root}/genomes.txt",
            "--tissues", f"{root}/tissues.txt",
            "--NL1", str(EQ_NL1), "--NL2", str(EQ_NL2),
            "--SNPPC", f"{root}/snp.evec", "--ctrlbed", f"{root}/ctrl.bed"]


def length_argv(d: str, out: str) -> list:
    """The ``length`` command line over length_inputs(d)."""
    return ["--outdir", out, "--ksize", "21", "--kmers",
            f"{d}/kmers.txt", "--trbed", f"{d}/tr.bed", "--LSB",
            f"{d}/lsb.tsv", "--cov", f"{d}/cov.txt", "--ksi",
            f"{d}/pan.ksi"]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--svms", action="store_true")
    a = ap.parse_args(argv)
    os.makedirs(a.out, exist_ok=True)
    n = write_reads(a.out)
    length_inputs(os.path.join(a.out, "length"))
    eqtl_inputs(os.path.join(a.out, "eqtl"))
    if a.svms:
        fit_svms(a.out)
        fit_dummies(a.out)
        sklearn_labels(a.out, a.out)
    print(f"{n} read pairs -> {a.out}")


if __name__ == "__main__":
    main()
