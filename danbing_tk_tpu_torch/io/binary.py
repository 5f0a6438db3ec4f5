"""Readers/writers for danbing-tk binary formats (L0).

All little-endian; specs from reference src/binaryKmerIO.hpp and
src/kmertools.cpp:240-314:

  *.kmers.dbi : u64 nk | u64 keys[nk] | u32 vals[nk] | u64 nvv | u32 vv[nvv]
                val even  -> locus = val>>1 (unique kmer)
                val odd   -> off = val>>1; vv[off] = n; vv[off+1:off+1+n] = loci
  *.kdb       : u64 nloci | u64 percount[nloci] | u64 nk | u64 ks[nk]
  *.kmdb      : u64 nloci | u64 percount[nloci] | u64 nk | u64 sizeof(val)
                | u64 ks[nk] | val vs[nk]
  *.ar        : u64 nk | u64 vals[nk]   (e.g. .trkmc.ar genotype counts)
  GT matrix   : u32 nrow | u32 ncol | f32 data[]     (pred outputs)
  ikmer.meta  : u64 n_kmer | u64 n_ikmer | u64 n_tr | u32 nk_cum[n_tr]
                | u32 nik_cum[n_tr] | (u32 ki, u8 kc)[n_ikmer]
"""

from __future__ import annotations

import numpy as np


def _r(f, dtype, n):
    a = np.fromfile(f, dtype=dtype, count=n)
    assert len(a) == n, f"short read: wanted {n} {dtype}"
    return a


def read_index_dbi(path: str):
    """Returns (keys u64[nk], vals u32[nk], vv u32[nvv])."""
    with open(path, "rb") as f:
        nk = int(_r(f, np.uint64, 1)[0])
        keys = _r(f, np.uint64, nk)
        vals = _r(f, np.uint32, nk)
        nvv = int(_r(f, np.uint64, 1)[0])
        vv = _r(f, np.uint32, nvv)
    return keys, vals, vv


def write_index_dbi(path: str, keys, vals, vv) -> None:
    keys = np.asarray(keys, dtype=np.uint64)
    vals = np.asarray(vals, dtype=np.uint32)
    vv = np.asarray(vv, dtype=np.uint32)
    with open(path, "wb") as f:
        np.uint64([len(keys)]).tofile(f)
        keys.tofile(f)
        vals.tofile(f)
        np.uint64([len(vv)]).tofile(f)
        vv.tofile(f)


def read_kset_db(path: str):
    """Returns (percount u64[nloci], ks u64[nk]) -- flattened kset DB."""
    with open(path, "rb") as f:
        nloci = int(_r(f, np.uint64, 1)[0])
        index = _r(f, np.uint64, nloci)
        nk = int(_r(f, np.uint64, 1)[0])
        ks = _r(f, np.uint64, nk)
    assert index.sum() == nk
    return index, ks


def write_kset_db(path: str, index, ks) -> None:
    index = np.asarray(index, dtype=np.uint64)
    ks = np.asarray(ks, dtype=np.uint64)
    with open(path, "wb") as f:
        np.uint64([len(index)]).tofile(f)
        index.tofile(f)
        np.uint64([len(ks)]).tofile(f)
        ks.tofile(f)


_KMDB_VAL_DTYPES = {1: np.uint8, 2: np.uint16, 4: np.uint32, 8: np.uint64}


def read_kmap_db(path: str):
    """Returns (percount u64[nloci], ks u64[nk], vs <sized>[nk])."""
    with open(path, "rb") as f:
        nloci = int(_r(f, np.uint64, 1)[0])
        index = _r(f, np.uint64, nloci)
        nk = int(_r(f, np.uint64, 1)[0])
        szv = int(_r(f, np.uint64, 1)[0])
        ks = _r(f, np.uint64, nk)
        vs = _r(f, _KMDB_VAL_DTYPES[szv], nk)
    assert index.sum() == nk
    return index, ks, vs


def write_kmap_db(path: str, index, ks, vs) -> None:
    index = np.asarray(index, dtype=np.uint64)
    ks = np.asarray(ks, dtype=np.uint64)
    vs = np.asarray(vs)
    assert vs.dtype.itemsize in _KMDB_VAL_DTYPES
    with open(path, "wb") as f:
        np.uint64([len(index)]).tofile(f)
        index.tofile(f)
        np.uint64([len(ks)]).tofile(f)
        np.uint64([vs.dtype.itemsize]).tofile(f)
        ks.tofile(f)
        vs.tofile(f)


def read_karray(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        nk = int(_r(f, np.uint64, 1)[0])
        return _r(f, np.uint64, nk)


def write_karray(path: str, vals) -> None:
    vals = np.asarray(vals, dtype=np.uint64)
    with open(path, "wb") as f:
        np.uint64([len(vals)]).tofile(f)
        vals.tofile(f)


def read_gt_matrix(path: str) -> np.ndarray:
    """Data is COLUMN-major on disk (Eigen's default layout, written raw
    by the reference's save_matrix, pred.h:235-248)."""
    with open(path, "rb") as f:
        nrow = int(_r(f, np.uint32, 1)[0])
        ncol = int(_r(f, np.uint32, 1)[0])
        return _r(f, np.float32, nrow * ncol).reshape(
            (nrow, ncol), order="F")


GT_BLOCK_BYTES = 1 << 26


def write_gt_matrix(path: str, m) -> None:
    """Column-major like read_gt_matrix, written in blocks of columns of
    ~GT_BLOCK_BYTES, so no full transposed copy of a cohort matrix is
    ever held."""
    m = np.asarray(m, dtype=np.float32)
    nrow, ncol = m.shape
    block = max(1, GT_BLOCK_BYTES // (4 * max(nrow, 1)))
    with open(path, "wb") as f:
        np.uint32([nrow, ncol]).tofile(f)
        for c0 in range(0, ncol, block):
            np.ascontiguousarray(m[:, c0:c0 + block].T).tofile(f)


def read_ikmer_meta(path: str):
    """Returns (nk_cum u32[ntr], nik_cum u32[ntr], ki u32[nik], kc u8[nik]).

    Matches pred.h:69-126 (explicit little-endian decode in the reference).
    """
    with open(path, "rb") as f:
        n_kmer = int(_r(f, np.uint64, 1)[0])
        n_ikmer = int(_r(f, np.uint64, 1)[0])
        n_tr = int(_r(f, np.uint64, 1)[0])
        nk_cum = _r(f, np.uint32, n_tr)
        nik_cum = _r(f, np.uint32, n_tr)
        rec = np.fromfile(f, dtype=np.dtype([("ki", "<u4"), ("kc", "u1")]),
                          count=n_ikmer)
        assert len(rec) == n_ikmer
    assert nk_cum[-1] == n_kmer and nik_cum[-1] == n_ikmer
    return nk_cum, nik_cum, rec["ki"].copy(), rec["kc"].copy()


def write_ikmer_meta(path: str, nk_cum, nik_cum, ki, kc) -> None:
    nk_cum = np.asarray(nk_cum, dtype=np.uint32)
    nik_cum = np.asarray(nik_cum, dtype=np.uint32)
    rec = np.zeros(len(ki), dtype=np.dtype([("ki", "<u4"), ("kc", "u1")]))
    rec["ki"] = ki
    rec["kc"] = kc
    with open(path, "wb") as f:
        np.uint64([nk_cum[-1], len(ki), len(nk_cum)]).tofile(f)
        nk_cum.tofile(f)
        nik_cum.tofile(f)
        rec.tofile(f)
