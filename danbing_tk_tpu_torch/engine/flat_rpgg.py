"""Flat-array host view of a production-scale RPGG.

Counterpart of danbing_tk_tpu/engine/flat_rpgg.py.  The dict-based host
index (``host_align.RPGG``) is exact but its build cost and per-entry
overhead top out around ~10M keys, and referee'd pairs still need the exact
host semantics at production scale.  This module provides a
HostAligner-compatible *view* over flat sorted numpy arrays:

  * ``dbi`` probes are binary searches over one sorted u64 key plane
    (the native C++ referee takes the arrays directly and does its own
    binary search; the Python referee uses ``np.searchsorted``)
  * per-locus TR/flank membership is CSR (concatenated sorted keys +
    offsets), with the in-locus rank plane alongside, so a TR count
    update lands in ONE flat u64 array laid out in trkmc flatten order
    (``locus_offsets[locus] + rank``)
  * the whole view is recovered from the device bucket tables
    (``from_device_tables``), so the device index is the only artifact a
    production run needs

Beyond the JAX module, the view recovered from a DeviceRPGG also carries
the index's bait maps (per-locus ``FlatDbiMap`` over the bait table) and
its QC mask when the DeviceRPGG has them, so the referee runs -b and -qc
at scale; ``renew`` gives a view with its own zero counts over the same
arrays (and the tre sets, bait and QC of a DeviceRPGG that gained them)
without sorting again; and the CSRs sort one packed (locus, key) u64 plane
where the two fit in 64 bits, which gives lexsort's order, since a
(key, locus) entry is unique in its table.

Exactness: tests/test_torch_flat_rpgg.py holds the arrays equal to the
JAX package's and runs the same reads through the dict-backed and the
flat-backed HostAligner (Python and native referee).
"""

from __future__ import annotations

import os

import numpy as np

from ..index import device_table as dt
from .device_align import ANN_FL, ANN_TR, DeviceRPGG


def _bs_contains(skeys: np.ndarray, km: int) -> int:
    """Binary-search position if km present, else -1.  The key goes in
    as a u64 scalar: with a Python int numpy converts the whole array on
    every probe."""
    if km < 0:
        return -1
    i = int(skeys.searchsorted(np.uint64(km)))
    if i < len(skeys) and int(skeys[i]) == km:
        return i
    return -1


class FlatDbiMap:
    """Read-only kmer -> u32 mapping over sorted flat arrays (the
    kmerDBi dict replacement, and one locus's bait map; supports the
    probes host_align's subfilter/kfilter/bfilter issue)."""

    __slots__ = ("skeys", "svals")

    def __init__(self, skeys: np.ndarray, svals: np.ndarray):
        self.skeys = skeys
        self.svals = svals

    def __len__(self):
        return len(self.skeys)

    def __contains__(self, km: int) -> bool:
        return _bs_contains(self.skeys, km) >= 0

    def get(self, km: int, default=None):
        i = _bs_contains(self.skeys, km)
        return default if i < 0 else int(self.svals[i])

    def __getitem__(self, km: int) -> int:
        i = _bs_contains(self.skeys, km)
        if i < 0:
            raise KeyError(km)
        return int(self.svals[i])

    def keys(self) -> np.ndarray:
        return self.skeys

    def values(self) -> np.ndarray:
        return self.svals

    def arrays(self):
        return self.skeys, self.svals


class FlatLocusSet:
    """Set-view of one locus's CSR slice (flank / tre membership)."""

    __slots__ = ("keys",)

    def __init__(self, keys: np.ndarray):
        self.keys = keys

    def __contains__(self, km: int) -> bool:
        return _bs_contains(self.keys, km) >= 0

    def __len__(self):
        return len(self.keys)

    def __iter__(self):
        return iter(self.keys.tolist())


class FlatLocusCounts:
    """Dict-view of one locus's TR kmers: membership + count updates.

    Counts live in the SHARED flat array at ``base + rank`` (trkmc
    flatten order), so per-locus updates and the global finalize see the
    same storage."""

    __slots__ = ("keys", "ranks", "base", "counts")

    def __init__(self, keys, ranks, base, counts):
        self.keys = keys
        self.ranks = ranks
        self.base = base
        self.counts = counts

    def __len__(self):
        return len(self.keys)

    def __contains__(self, km: int) -> bool:
        return _bs_contains(self.keys, km) >= 0

    def _slot(self, km: int) -> int:
        i = _bs_contains(self.keys, km)
        if i < 0:
            raise KeyError(km)
        return self.base + int(self.ranks[i])

    def __getitem__(self, km: int) -> int:
        return int(self.counts[self._slot(km)])

    def __setitem__(self, km: int, v: int):
        self.counts[self._slot(km)] = v

    def keys_array(self) -> np.ndarray:
        return self.keys

    def rank_order(self) -> np.ndarray:
        """Locus kmers in trkmc flatten (rank) order."""
        return self.keys[np.argsort(self.ranks, kind="stable")]


class _CsrList:
    """Lazy list-of-views over a CSR (keys, offsets [, ranks])."""

    __slots__ = ("keys", "off", "ranks", "mk")

    def __init__(self, keys, off, mk, ranks=None):
        self.keys = keys
        self.off = off
        self.ranks = ranks
        self.mk = mk

    def __len__(self):
        return len(self.off) - 1

    def __getitem__(self, li: int):
        s, e = int(self.off[li]), int(self.off[li + 1])
        return self.mk(li, s, e)


def _entries_to_csr(nloci, ekeys, eloci, eranks=None):
    """Sort (key, locus) entries into per-locus sorted-key CSR: the order
    of np.lexsort((ekeys, eloci)), from one sort of the packed
    (locus << kbits) | key plane when it fits in 64 bits (the entries are
    unique, so any sort of it is lexsort's order)."""
    n = len(ekeys)
    kbits = int(ekeys.max()).bit_length() if n else 0
    lbits = int(nloci).bit_length()
    off = np.zeros(nloci + 1, dtype=np.int64)
    np.cumsum(np.bincount(eloci, minlength=nloci)[:nloci], out=off[1:])
    if kbits + lbits > 64:
        order = np.lexsort((ekeys, eloci))
        return ekeys[order], off, (None if eranks is None
                                   else eranks[order])
    packed = (eloci.astype(np.uint64) << np.uint64(kbits)) | ekeys
    if eranks is None:
        packed.sort()
        return packed & np.uint64((1 << kbits) - 1), off, None
    order = np.argsort(packed)
    return ekeys[order], off, eranks[order]


def _table_entries(tab: dt.BucketTable):
    """All live (key [, locus], val [, val2]) entries of a bucket table.

    Valid slots are recognized by the hi plane: canonical k-mers are
    <=62 bits, so hi < 2^31 and the EMPTY sentinel (0xFFFFFFFF) can only
    mark a free slot."""
    W = 2 + int(tab.composite) + tab.nval
    parts = [[] for _ in range(W)]
    for t, _ in tab.levels:
        r = t.reshape(-1, W)
        live = r[:, 1] != dt.EMPTY
        for c in range(W):
            parts[c].append(r[live, c])
    cols = [np.concatenate(p) if p else np.zeros(0, np.uint32)
            for p in parts]
    keys = cols[0].astype(np.uint64) | (cols[1].astype(np.uint64) << 32)
    return (keys, *cols[2:])


def _filter_arrays(drp: DeviceRPGG) -> dict:
    """The bait maps' CSR (``bait_k``/``bait_v``/``bait_off``) and the QC
    mask (``qc``) of a DeviceRPGG, for those it has."""
    f = {}
    if drp.bait_tab is not None and drp.bait_tab.levels:
        bk, bl, bv = _table_entries(drp.bait_tab)
        order = np.lexsort((bk, bl))
        f["bait_k"], f["bait_v"] = bk[order], bv[order]
        f["bait_off"] = np.zeros(drp.nloci + 1, dtype=np.int64)
        np.cumsum(np.bincount(bl, minlength=drp.nloci)[:drp.nloci],
                  out=f["bait_off"][1:])
    if drp.qc is not None:
        f["qc"] = np.asarray(drp.qc, np.uint8)
    return f


def _tre_arrays(drp: DeviceRPGG) -> dict:
    """The tre sets' CSR (``tre_k``/``tre_off``) of a DeviceRPGG's tre
    table, or {} without one."""
    if drp.tre_tab is None or not drp.tre_tab.levels:
        return {}
    tre_k, tre_l, _ = _table_entries(drp.tre_tab)
    k, off, _ = _entries_to_csr(drp.nloci, tre_k, tre_l.astype(np.int64))
    return dict(tre_k=k, tre_off=off)


class FlatRPGG:
    """HostAligner-compatible RPGG built from flat arrays.

    Constructor arguments mirror the index's logical content:
      dbi_keys/dbi_vals : kmerDBi (unsorted ok; sorted internally)
      vv                : the multi-locus expansion lists (shared layout
                          with the device, count_hit reads it directly)
      tr/fl/tre entries : (key, locus [, rank]) flat planes
      locus_offsets     : trkmc flatten-order slot bases (nloci+1)
      filters           : _filter_arrays' bait CSR and QC mask, or None
    """

    def __init__(self, nloci, dbi_keys, dbi_vals, vv,
                 tr_keys, tr_loci, tr_ranks,
                 fl_keys, fl_loci, locus_offsets, nslots,
                 tre_keys=None, tre_loci=None, filters=None):
        nloci = int(nloci)
        # kmerDBi keys are unique: any sort gives the stable sort's order
        order = np.argsort(dbi_keys)
        f = dict(nloci=nloci,
                 skeys=np.ascontiguousarray(dbi_keys[order]),
                 svals=np.ascontiguousarray(dbi_vals[order]),
                 vv=np.asarray(vv, dtype=np.uint32),
                 locus_offsets=np.asarray(locus_offsets, np.int64),
                 nslots=int(nslots))
        f["tr_k"], f["tr_off"], f["tr_rk"] = _entries_to_csr(
            nloci, tr_keys, tr_loci, tr_ranks)
        f["fl_k"], f["fl_off"], _ = _entries_to_csr(
            nloci, fl_keys, fl_loci)
        if tre_keys is not None:
            f["tre_k"], f["tre_off"], _ = _entries_to_csr(
                nloci, tre_keys, tre_loci)
        f.update(filters or {})
        self._attach(f)

    def _attach(self, f: dict):
        """Wire the views from FINAL (sorted/CSR) arrays — the cached
        fast path skips every sort."""
        self.nloci = int(f["nloci"])
        self.dbi = FlatDbiMap(f["skeys"], f["svals"])
        self.vv = f["vv"]
        self.locus_offsets = np.asarray(f["locus_offsets"], np.int64)
        self.nslots = int(f["nslots"])
        self._counts = np.zeros(self.nslots, dtype=np.uint64)
        tk, toff, trk = f["tr_k"], f["tr_off"], f["tr_rk"]
        base = self.locus_offsets
        cnt = self._counts
        self._tr = (tk, toff, trk)
        self.tr_counts = _CsrList(
            tk, toff,
            lambda li, s, e: FlatLocusCounts(tk[s:e], trk[s:e],
                                             int(base[li]), cnt))
        # per-locus slot-count sanity: ranks must address inside the
        # locus's flat-count span (a violated index corrupts counts
        # silently otherwise)
        span = np.diff(self.locus_offsets)
        ncsr = np.diff(toff)
        if not (ncsr == span).all():
            bad = int(np.flatnonzero(ncsr != span)[0])
            raise ValueError(
                f"locus {bad}: {int(ncsr[bad])} TR entries but slot span "
                f"{int(span[bad])} — index inconsistent")

        fk, foff = f["fl_k"], f["fl_off"]
        self._fl = (fk, foff)
        self.fl_sets = _CsrList(fk, foff,
                                lambda li, s, e: FlatLocusSet(fk[s:e]))
        if "tre_k" in f and f["tre_k"] is not None:
            gk, goff = f["tre_k"], f["tre_off"]
            self.tre_sets = _CsrList(
                gk, goff, lambda li, s, e: FlatLocusSet(gk[s:e]))
        else:
            ze = np.zeros(0, np.uint64)
            zo = np.zeros(self.nloci + 1, np.int64)
            self.tre_sets = _CsrList(
                ze, zo, lambda li, s, e: FlatLocusSet(ze[s:e]))
        self.bait_dbs = None
        self._bait = None
        if "bait_k" in f:
            bk, bv, boff = f["bait_k"], f["bait_v"], f["bait_off"]
            self._bait = (bk, bv, boff)
            self.bait_dbs = _CsrList(
                bk, boff, lambda li, s, e: FlatDbiMap(bk[s:e], bv[s:e]))
        self.qc_filter = f.get("qc")
        self.graphs = None
        # write_tr_kmers-style walks (rank order per locus), lazy
        self.tr_orders = _CsrList(
            tk, toff,
            lambda li, s, e: FlatLocusCounts(
                tk[s:e], trk[s:e], int(base[li]), cnt).rank_order())

    def _final_arrays(self) -> dict:
        f = dict(nloci=self.nloci, skeys=self.dbi.skeys,
                 svals=self.dbi.svals, vv=self.vv,
                 locus_offsets=self.locus_offsets, nslots=self.nslots)
        f["tr_k"], f["tr_off"], f["tr_rk"] = self._tr
        f["fl_k"], f["fl_off"] = self._fl
        if len(self.tre_sets.keys):
            f["tre_k"] = self.tre_sets.keys
            f["tre_off"] = self.tre_sets.off
        if self._bait is not None:
            f["bait_k"], f["bait_v"], f["bait_off"] = self._bait
        if self.qc_filter is not None:
            f["qc"] = self.qc_filter
        return f

    def renew(self, drp: DeviceRPGG | None = None) -> "FlatRPGG":
        """A view over this view's arrays with its own zero counts (a
        second runner's, or a second referee's on the same pairs).  With
        ``drp`` (the DeviceRPGG this view came from, since grown) the tre
        sets, bait maps and QC mask come from drp's tables; only those
        are built."""
        f = self._final_arrays()
        if drp is not None:
            for key in ("tre_k", "tre_off", "bait_k", "bait_v", "bait_off",
                        "qc"):
                f.pop(key, None)
            f.update(_tre_arrays(drp))
            f.update(_filter_arrays(drp))
        obj = type(self).__new__(type(self))
        obj._attach(f)
        return obj

    # -- fast paths consumed by NativeReferee / the runner --

    def dbi_arrays(self):
        return self.dbi.arrays()

    def locus_arrays(self, li: int):
        """(tr_keys, fl_keys) of one locus, for dtk_eng_set_locus."""
        tk, toff, _ = self._tr
        fk = self.fl_sets[li].keys
        return tk[int(toff[li]):int(toff[li + 1])], fk

    def engine_arrays(self):
        """Everything dtk_eng_new_flat needs, zero-copy: (dbi_keys,
        dbi_vals, vv, tr_keys, tr_offsets, fl_keys, fl_offsets)."""
        tk, toff, _ = self._tr
        fk, foff = self._fl
        return (self.dbi.skeys, self.dbi.svals, self.vv,
                tk, toff, fk, foff)

    def flat_counts(self) -> np.ndarray:
        """Host-side TR counts, already in trkmc flatten order."""
        return self._counts

    def load_graphs(self):
        raise NotImplementedError(
            "threading mode needs the dBG graphs; the flat view carries "
            "alignment tables only")

    @classmethod
    def from_device_tables(cls, drp: DeviceRPGG) -> "FlatRPGG":
        """Recover the exact host view from the device index alone.

        Annotation encoding (device_align.DeviceRPGG.build): per
        (kmer,locus) value = (rank<<3) | (in_tr<<2) | ann with ann
        1=flank 2=TR; single-locus kmers carry it in the dbi row's
        second plane, multi-locus ones in the composite trfl table.  The
        bait maps and the QC mask come along when drp has them."""
        return cls(**cls._inputs_from_device_tables(drp),
                   filters=_filter_arrays(drp))

    @classmethod
    def from_device_tables_cached(cls, drp: DeviceRPGG,
                                  cache: str) -> "FlatRPGG":
        """Disk-cached variant: the FINAL sorted arrays reload with zero
        sorting in ~np.load time."""
        if os.path.exists(cache):
            z = np.load(cache)
            f = {k: z[k] for k in z.files}
            obj = cls.__new__(cls)
            obj._attach(f)
            return obj
        flat = cls.from_device_tables(drp)
        np.savez(cache + ".tmp.npz", **flat._final_arrays())
        os.replace(cache + ".tmp.npz", cache)
        return flat

    @classmethod
    def _inputs_from_device_tables(cls, drp: DeviceRPGG) -> dict:
        keys, vals, ann = _table_entries(drp.dbi_tab)
        # single-locus (even) entries annotated in the dbi row itself
        ev = (vals & 1) == 0
        e_keys = [keys[ev]]
        e_loci = [(vals[ev] >> 1).astype(np.int64)]
        e_bits = [ann[ev]]
        if drp.trfl_tab is not None and drp.trfl_tab.levels:
            tk, tl, tv = _table_entries(drp.trfl_tab)
            e_keys.append(tk)
            e_loci.append(tl.astype(np.int64))
            e_bits.append(tv)
        ekeys = np.concatenate(e_keys)
        eloci = np.concatenate(e_loci)
        ebits = np.concatenate(e_bits)
        is_tr = ((ebits & 3) == ANN_TR) | ((ebits >> 2) & 1).astype(bool)
        is_fl = (ebits & 3) == ANN_FL
        tre_k = tre_l = None
        if drp.tre_tab is not None and drp.tre_tab.levels:
            tre_k, tre_l, _ = _table_entries(drp.tre_tab)
            tre_l = tre_l.astype(np.int64)
        return dict(
            nloci=drp.nloci, dbi_keys=keys, dbi_vals=vals, vv=drp.vv,
            tr_keys=ekeys[is_tr], tr_loci=eloci[is_tr],
            tr_ranks=(ebits[is_tr] >> 3).astype(np.int64),
            fl_keys=ekeys[is_fl], fl_loci=eloci[is_fl],
            locus_offsets=drp.locus_offsets, nslots=drp.nslots,
            tre_keys=tre_k, tre_loci=tre_l)
