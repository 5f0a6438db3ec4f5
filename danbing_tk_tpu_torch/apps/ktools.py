"""ktools equivalent: RPGG index utilities (reference src/kmertools.cpp).

Subcommands implemented as functions:
  ksi          per-locus kmer-count index (kmertools.cpp:38-57)
  kms_sum      locus dosage = sum of kmer counts (:59-137), single column
               or sample x locus matrix
  extract      slice one locus's RPGG (:138-173)
  extract_bt   QC-filter a bait kmdb (:174-220)
  serialize    binary index build -- see index/dbi.py
  serialize_bt FPSkmer.tsv -> .bt.kmdb with u16 (mi<<8)|ma (:346-371)
  raava        bidirectional tr/fl kset DBs + reindex (:372-449)
"""

from __future__ import annotations

import numpy as np

from ..io import binary as bio
from ..io.text import read_qc_file
from ..ops.kmers_np import revcomp_kmers
from ..utils.stdumap import StdUmapOrder


def ksi(kmers_path: str) -> list[int]:
    """Cumulative kmer counts at each locus boundary."""
    out = []
    nk = 0
    idx = -1
    with open(kmers_path, "rb") as f:
        for line in f:
            if line.startswith(b">"):
                idx += 1
                if idx:
                    out.append(nk)
            else:
                nk += 1
    if idx:
        out.append(nk)
    return out


def kms_sum_matrix(ksi_list: list[int], kmer_files: list[str], out):
    """ktools sum -f: sample x locus matrix (kmertools.cpp:68-108).
    Tab-separated per row; the final locus emits '\n' and stops reading
    that sample's file (same early break as the single-file mode)."""
    for path in kmer_files:
        idx, ki, kms = 0, 0, 0
        with open(path, "rb") as f:
            for line in f:
                kms += int(line)
                ki += 1
                stop = False
                while idx < len(ksi_list) and ksi_list[idx] == ki:
                    idx += 1
                    if idx != len(ksi_list):
                        out.write(f"{kms}\t")
                        kms = 0
                    else:
                        out.write(f"{kms}\n")
                        stop = True
                        break
                if stop:
                    break


def kms_sum(ksi_list: list[int], counts_path: str) -> list[int]:
    """Sum count-only kmer file (align -o readable output) per locus."""
    sums = []
    idx, ki, kms = 0, 0, 0
    with open(counts_path, "rb") as f:
        for line in f:
            kms += int(line)
            ki += 1
            while idx < len(ksi_list) and ksi_list[idx] == ki:
                idx += 1
                sums.append(kms)
                kms = 0
                if idx == len(ksi_list):
                    break
    return sums


def kms_table(ksi_list: list[int], count_paths: list[str]) -> np.ndarray:
    return np.array([kms_sum(ksi_list, p) for p in count_paths],
                    dtype=np.uint64)


def extract(in_pref: str, tri: int, out_pref: str,
            ftypes=("tr", "ntr", "graph")):
    """Slice locus ``tri`` from each <in_pref>.<ftype>.kmers."""
    for ft in ftypes:
        with open(f"{in_pref}.{ft}.kmers", "rb") as fin, \
                open(f"{out_pref}.{ft}.kmers", "wb") as fout:
            fout.write(f">{tri}\n".encode())
            cur = -1
            for line in fin:
                if line.startswith(b">"):
                    cur += 1
                    if cur > tri:
                        break
                elif cur == tri:
                    fout.write(line)


def serialize_bt(fps_path: str, nloci: int, out_pref: str):
    """FPSkmer.tsv -> <out_pref>.bt.kmdb (byte-exact vs ktools)."""
    # readFPSKmersV2 inserts in file order per locus; flatten in map order
    orders = [StdUmapOrder() for _ in range(nloci)]
    vals = [dict() for _ in range(nloci)]
    tri = -1
    with open(fps_path, "rb") as f:
        for line in f:
            if line.startswith(b">"):
                tri = int(line[1:].split()[0])
            else:
                km, mi, ma = (int(x) for x in line.split()[:3])
                orders[tri].insert(km)
                vals[tri][km] = (mi << 8) + ma
    index = np.array([len(v) for v in vals], dtype=np.uint64)
    ks, vs = [], []
    for o, v in zip(orders, vals):
        for km in o:
            ks.append(km)
            vs.append(v[km])
    bio.write_kmap_db(out_pref + ".bt.kmdb", index,
                      np.array(ks, np.uint64), np.array(vs, np.uint16))


def extract_bt(in_pref: str, qc_path: str, out_pref: str | None = None):
    """Zero out bait entries for loci failing QC -> <pref>.qc.bt.kmdb."""
    index, ks, vs = bio.read_kmap_db(in_pref + ".bt.kmdb")
    nloci = len(index)
    qc = read_qc_file(qc_path, nloci)
    out_index = np.zeros(nloci, dtype=np.uint64)
    out_ks, out_vs = [], []
    p = 0
    for tri in range(nloci):
        n = int(index[tri])
        if qc[tri]:
            out_index[tri] = n
            out_ks.append(ks[p : p + n])
            out_vs.append(vs[p : p + n])
        p += n
    out_pref = out_pref or (in_pref + ".qc")
    bio.write_kmap_db(
        out_pref + ".bt.kmdb", out_index,
        np.concatenate(out_ks) if out_ks else np.zeros(0, np.uint64),
        np.concatenate(out_vs) if out_vs else np.zeros(0, np.uint16))


def raava(pref: str, ksize: int):
    """Bidirectional tr/fl kset DBs + reindexed TR kset (byte-exact)."""
    for ftype, out_tp in (("tr", "bi_tr"), ("fl", "bi_fl")):
        orders = _read_kset_orders(f"{pref}.{ftype}.kmers")
        for o in orders:
            rcs = StdUmapOrder()
            for kf in o:
                rcs.insert(int(revcomp_kmers(
                    np.array([kf], dtype=np.uint64), ksize)[0]))
            for kr in rcs:
                o.insert(kr)
        index = np.array([len(o) for o in orders], dtype=np.uint64)
        ks = [km for o in orders for km in o]
        bio.write_kset_db(f"{pref}.{out_tp}.kdb", index,
                          np.array(ks, np.uint64))
    # reindex.tr: per-locus kmer arrays in FILE order (not set order)
    index, ks = [], []
    n = 0
    tri = -1
    with open(pref + ".reindex.tr.kmers", "rb") as f:
        for line in f:
            if line.startswith(b">"):
                if tri >= 0:
                    index.append(n)
                    n = 0
                tri += 1
            else:
                ks.append(int(line.split()[0]))
                n += 1
    index.append(n)
    bio.write_kset_db(pref + ".reindex.tr.kdb", np.array(index, np.uint64),
                      np.array(ks, np.uint64))


def _read_kset_orders(path: str):
    orders = []
    cur = None
    with open(path, "rb") as f:
        for line in f:
            if line.startswith(b">"):
                cur = StdUmapOrder()
                orders.append(cur)
            else:
                cur.insert(int(line.split()[0]))
    return orders
