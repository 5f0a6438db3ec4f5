"""RPGG inverted k-mer index (kmerDBi) construction + serialization.

Reimplements the semantics of ``ktools serialize`` (kmertools.cpp:221-345)
and ``readKmerIndex`` (kmerIO.hpp:47-78) from scratch:

  - kmerDBi maps canonical k-mer -> encoded value:
      even value  : unique k-mer, locus = value >> 1
      odd  value  : shared k-mer, (value >> 1) is an offset into the ``vv``
                    array where vv[off] = n and vv[off+1 : off+1+n] = loci
  - built by scanning <pref>.tr.kmers then <pref>.fl.kmers in file order;
    first sighting maps to the locus, later sightings from other loci
    promote the entry to a vv list (append order = first-collision order)
  - serialized as .kmers.dbi with keys/vals in hash-container iteration
    order (we reproduce libstdc++ order via utils.stdumap for byte-exact
    files); the device-side table layout is independent (see
    index/device_table.py)

Kset DBs (.fl.kdb / .tre.kdb) flatten per-locus unordered_set contents in
iteration order (flattenKsetDB, binaryKmerIO.hpp:119-130).
"""

from __future__ import annotations

import numpy as np

from ..io import binary as bio
from ..utils.stdumap import StdUmapOrder


class KmerDBi:
    """Inverted index under construction (host side)."""

    def __init__(self):
        self.order = StdUmapOrder()
        self.val: dict[int, int] = {}
        self.vec: list[list[int]] = []

    def add_file(self, path: str) -> None:
        """Scan a .kmers text file (">locus" groups, kmer first column)."""
        idx = -1
        with open(path, "rb") as f:
            for line in f:
                if line.startswith(b">"):
                    idx += 1
                else:
                    self.add(int(line.split()[0], 10), idx)

    def add(self, kmer: int, idx: int) -> None:
        v = self.val.get(kmer)
        if v is None:
            self.order.insert(kmer)
            self.val[kmer] = idx << 1
        elif v & 1:
            lst = self.vec[v >> 1]
            if idx not in lst:
                lst.append(idx)
        else:
            if (v >> 1) != idx:
                self.vec.append([v >> 1, idx])
                self.val[kmer] = ((len(self.vec) - 1) << 1) + 1

    def flatten(self):
        """Returns (keys u64[], vals u32[], vv u32[]) with vv-offset encoded
        odd values, in libstdc++ iteration order (ktools serialize layout).
        """
        vv = []
        vvi = []
        for v in self.vec:
            vvi.append(len(vv))
            vv.append(len(v))
            vv.extend(v)
        keys = np.fromiter(self.order, dtype=np.uint64, count=len(self.val))
        vals = np.empty(len(keys), dtype=np.uint32)
        for i, k in enumerate(keys):
            v = self.val[int(k)]
            if v & 1:
                v = (vvi[v >> 1] << 1) + 1
            vals[i] = v
        return keys, vals, np.asarray(vv, dtype=np.uint32)

    def lookup_loci(self, kmer: int):
        """Host-side query: list of loci for a kmer (or None)."""
        v = self.val.get(kmer)
        if v is None:
            return None
        if v & 1:
            return list(self.vec[v >> 1])
        return [v >> 1]


def build_index(pref: str):
    """ktools-serialize equivalent index build from <pref>.tr.kmers +
    <pref>.fl.kmers. Returns (keys, vals, vv)."""
    dbi = KmerDBi()
    dbi.add_file(pref + ".tr.kmers")
    dbi.add_file(pref + ".fl.kmers")
    return dbi.flatten()


def build_kset(path: str, nloci: int):
    """readKmers_ksetDB + flattenKsetDB equivalent: per-locus set of kmers
    from a text kmer file, flattened in libstdc++ set-iteration order.

    Returns (percount u64[nloci], ks u64[nk]).
    """
    orders = [StdUmapOrder() for _ in range(nloci)]
    tri = -1
    with open(path, "rb") as f:
        for line in f:
            if line.startswith(b">"):
                tri += 1
            else:
                orders[tri].insert(int(line.split()[0], 10))
    index = np.array([len(o) for o in orders], dtype=np.uint64)
    ks = np.concatenate(
        [np.fromiter(o, dtype=np.uint64, count=len(o)) for o in orders]
        or [np.zeros(0, np.uint64)]
    )
    return index, ks


def serialize(pref: str) -> None:
    """Write <pref>.kmers.dbi, <pref>.fl.kdb, <pref>.tre.kdb byte-identically
    to ``ktools serialize <pref>``."""
    from ..io.text import count_loci

    nloci = count_loci(pref + ".tr.kmers")
    keys, vals, vv = build_index(pref)
    bio.write_index_dbi(pref + ".kmers.dbi", keys, vals, vv)
    fli, fks = build_kset(pref + ".fl.kmers", nloci)
    bio.write_kset_db(pref + ".fl.kdb", fli, fks)
    ei, es = build_kset(pref + ".tre.kmers", nloci)
    bio.write_kset_db(pref + ".tre.kdb", ei, es)
