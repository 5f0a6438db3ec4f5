"""Runnable VNTR length-prediction pipeline (P8/P9 end-to-end).

The reference ships this flow as ``script/kmc2length.py`` (main at
:119-139), whose HEAD main is broken: ``loadvntrmat`` passes the output
row where ``readKms`` expects the per-locus cumulative k-mer index
(``ki_tr``) and discards the return (kmc2length.py:19-23 vs
vntrutils.py:160-193).  This module implements the INTENDED flow — the
same file formats, the same math (oracle-tested against the reference's
own functions in tests/test_length_pipeline_oracle.py) — with the ksi
index supplied explicitly:

  inputs   --trbed    VNTR bed (nloci rows; row ids name the output rows)
           --LSB      precomputed locus-specific-bias TSV (release asset
                      format: nctrl non-TR rows then nloci TR rows,
                      columns = panel genomes; ctrl sizes parse from the
                      non-TR row names, loadLSB kmc2length.py:53-61)
           --cov      per-sample control-region coverage table (cols 2+
                      = coverage per ctrl region, kmc2length.py:126-128)
           --kmers    file listing per-sample count-only kmer files
                      (the align output format, README.md:153)
           --ksi      per-locus cumulative k-mer index (`ktools ksi`)
                      or --qs RPGG prefix to derive it from pan.tr.kmers
  output   {outdir}/estimated_TR_len.tsv  (loci x samples, na_rep=nan)

The optional ``--seqruns`` input switches the LSB-donor pick to the
sequencing-run prior of the LOO variant (kmc2length.LOO.py:107-120).

The reference reads the LSB table with pandas and writes the estimates
with ``DataFrame.to_csv``; here both are plain Python with the same
results: ``load_lsb`` parses each LSB value as pandas' default C parser
does (``csv_float``: at most 17 digits, leading zeros included, scaled
by a power of ten, so a value is not always the nearest double to its
text), and ``save_estimates`` writes pandas' bytes (an empty first header
cell, integer column labels, each float in its shortest round-trip form,
``nan`` for NaN).
"""

from __future__ import annotations

import csv
import os

import numpy as np

from .kmc2length import (kmc2length, process_ctrl_cov, read_locus_sums)


# pandas' default missing-value spellings (read_csv's na_values)
_NA = frozenset(("", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN",
                 "-NaN", "-nan", "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA",
                 "NULL", "NaN", "None", "n/a", "nan", "null"))
_INF = {"inf": np.inf, "+inf": np.inf, "-inf": -np.inf, "infinity": np.inf,
        "+infinity": np.inf, "-infinity": -np.inf}
_POW10 = [float(f"1e{i}") for i in range(309)]
_MAX_DIGITS = 17


def csv_float(tok: str) -> float:
    """One field as pandas' default C parser reads a float column
    (precise_xstrtod, pandas/_libs/src/parser/tokenizer.c): the first 17
    digits accumulate as number * 10 + d, later integer digits raise the
    exponent and later decimals are dropped, and the result is scaled by
    one correctly rounded power of ten."""
    t = tok.strip()
    if t in _NA:
        return float("nan")
    if t.lower() in _INF:
        return float(_INF[t.lower()])
    i, n = 0, len(t)
    negative = t[:1] == "-"
    if t[:1] in ("+", "-"):
        i = 1
    number, exponent, ndig, ndec = 0.0, 0, 0, 0
    while i < n and "0" <= t[i] <= "9":
        if ndig < _MAX_DIGITS:
            number = number * 10.0 + (ord(t[i]) - 48)
            ndig += 1
        else:
            exponent += 1
        i += 1
    if i < n and t[i] == ".":
        i += 1
        while ndig < _MAX_DIGITS and i < n and "0" <= t[i] <= "9":
            number = number * 10.0 + (ord(t[i]) - 48)
            i += 1
            ndig += 1
            ndec += 1
        while i < n and "0" <= t[i] <= "9":
            i += 1
        exponent -= ndec
    if ndig == 0:
        raise ValueError(f"not a number: {tok!r}")
    if negative:
        number = -number
    if i < n and t[i] in "eE":
        j, eneg = i + 1, False
        if j < n and t[j] in "+-":
            eneg = t[j] == "-"
            j += 1
        k, ev = j, 0
        while k < n and k - j < _MAX_DIGITS and "0" <= t[k] <= "9":
            ev = ev * 10 + (ord(t[k]) - 48)
            k += 1
        if k > j:
            exponent += -ev if eneg else ev
            i = k
    if i != n:
        raise ValueError(f"not a number: {tok!r}")
    if exponent > 308:
        return float("inf") if number > 0 else float("-inf")
    if exponent > 0:
        return number * _POW10[exponent]
    if exponent < -308:
        if exponent < -616:
            return 0.0
        return number / _POW10[-308 - exponent] / _POW10[308]
    return number / _POW10[-exponent]


def read_tsv_table(path: str):
    """A tab-separated table with a header row and the row names in its
    first column (``read_csv(sep="\\t", index_col=0)``) -> (row names,
    column names, (rows, cols) float64 values)."""
    with open(path) as f:
        header = f.readline().rstrip("\r\n").split("\t")
        rows = [line.rstrip("\r\n").split("\t") for line in f
                if line.strip()]
    bad = [i for i, r in enumerate(rows) if len(r) != len(header)]
    if bad:
        raise ValueError(f"{path}: row {bad[0] + 1} has {len(rows[bad[0]])} "
                         f"fields, the header {len(header)}")
    vals = np.array([[csv_float(t) for t in r[1:]] for r in rows],
                    dtype=np.float64).reshape(len(rows), len(header) - 1)
    return [r[0] for r in rows], header[1:], vals


def load_lsb(path: str, nloci: int):
    """LSB release-asset TSV -> (trbias_db, ntrbias_db, dbgenomes,
    ctrlsize); rows = nctrl non-TR regions then nloci TR loci, columns =
    panel genomes (loadLSB, kmc2length.py:53-61)."""
    names, cols, vals = read_tsv_table(path)
    nloci0 = vals.shape[0] - nloci
    assert nloci0 > 0, (
        f"LSB has {vals.shape[0]} rows but the bed names {nloci} loci")
    ntrbias_db = np.ascontiguousarray(vals[:nloci0].T)
    trbias_db = np.ascontiguousarray(vals[nloci0:].T)
    dbgenomes = np.array(cols, dtype=object)
    cbed = np.array([v[4:].split("_") for v in names[:nloci0]],
                    dtype=object)
    ctrlsize = cbed[:, 2].astype(int) - cbed[:, 1].astype(int)
    return trbias_db, ntrbias_db, dbgenomes, ctrlsize


def load_cov(path: str) -> np.ndarray:
    """Raw coverage table -> (nsamples, nctrl) float matrix (columns 0-1
    are sample metadata, kmc2length.py:126-127)."""
    raw = np.loadtxt(path, dtype=object, ndmin=2)
    return raw[:, 2:].astype(float)


def load_trmat(kmers_list: str, ksi: list[int]) -> np.ndarray:
    """Per-sample locus k-mer sums from count-only kmer files (the
    intended loadvntrmat: readKms with a real ki_tr index)."""
    files = [ln.strip() for ln in open(kmers_list) if ln.strip()]
    base = os.path.dirname(os.path.abspath(kmers_list))
    rows = []
    for f in files:
        p = f if os.path.isabs(f) else os.path.join(base, f)
        if not os.path.exists(p) and os.path.exists(f):
            p = f
        rows.append(read_locus_sums(p, ksi))
    return np.array(rows, dtype=np.int64)


def save_estimates(ests: np.ndarray, trbed: np.ndarray, outdir: str):
    """estimated_TR_len.tsv, byte-compatible with SaveEstErr
    (kmc2length.py:100-103): loci x samples, row ids = '_'.join(bed
    row), na_rep='nan'), as ``DataFrame.to_csv(sep="\\t",
    na_rep="nan")`` writes it."""
    trid = ["_".join(r) for r in trbed]
    os.makedirs(outdir, exist_ok=True)
    with open(os.path.join(outdir, "estimated_TR_len.tsv"), "w",
              newline="") as f:
        w = csv.writer(f, delimiter="\t", lineterminator="\n")
        w.writerow([""] + [str(j) for j in range(ests.shape[0])])
        for tid, row in zip(trid, ests.T.tolist()):
            w.writerow([tid] + ["nan" if v != v else repr(v) for v in row])


def run_length(outdir: str, ksize: int, kmers: str, trbed_path: str,
               lsb: str, cov: str, ksi_path: str | None = None,
               qs: str | None = None, seqruns: str | None = None,
               db_seqruns: str | None = None,
               bad_donors: tuple = ()) -> np.ndarray:
    """The intended kmc2length main; returns (nsamples, nloci) length
    estimates and writes estimated_TR_len.tsv."""
    trbed = np.loadtxt(trbed_path, dtype=object, ndmin=2)
    nloci = trbed.shape[0]
    trbias_db, ntrbias_db, dbgenomes, ctrlsize = load_lsb(lsb, nloci)

    covmat = load_cov(cov)
    assert covmat.shape[1] == len(ctrlsize), (
        f"coverage table has {covmat.shape[1]} ctrl regions, LSB names "
        f"{len(ctrlsize)}")
    pbamcov, _, ntrbiasmat = process_ctrl_cov(covmat, ctrlsize)

    if ksi_path is not None:
        ksi = [int(x) for x in open(ksi_path).read().split()]
    else:
        assert qs is not None, "need --ksi or --qs to index kmer files"
        from ..apps.ktools import ksi as make_ksi

        ksi = make_ksi(qs + ".tr.kmers")
    assert len(ksi) == nloci, (
        f"ksi indexes {len(ksi)} loci, bed names {nloci}")
    trmat = load_trmat(kmers, ksi)

    runs = runs_db = None
    if seqruns is not None:
        runs = [ln.split()[1] for ln in open(seqruns) if ln.strip()]
        assert len(runs) == trmat.shape[0], "one seqrun label per sample"
        if db_seqruns is not None:
            runs_db = [ln.split()[1] for ln in open(db_seqruns)
                       if ln.strip()]
            assert len(runs_db) == len(dbgenomes), \
                "one seqrun label per LSB panel genome"
    ests = kmc2length(trmat, ntrbiasmat, trbias_db, ntrbias_db,
                      pbamcov, ksize, runs=runs, runs_db=runs_db,
                      bad_donors=bad_donors)
    save_estimates(ests, trbed, outdir)
    return ests
