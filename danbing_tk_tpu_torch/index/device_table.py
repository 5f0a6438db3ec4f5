"""Bucketized multi-level hash tables for device-resident k-mer lookup.

The numpy table construction and host probe are copies of
danbing_tk_tpu/index/device_table.py, so both packages build the same
bytes: per level a (nb, BUCKET * W) u32 row array, slot planes lo, hi,
[locus if composite], val, [val2 if nval == 2] (W = 2 + composite + nval),
empty slots EMPTY in every plane.  The port uploads each level as an
int32 view of the same rows (``DevTable``; a level past 1 GiB goes a chunk
at a time through one pinned buffer) and probes it with kernel KB
(``csrc/bucket_lookup.cu``): one 8-slot row per level, the first level
that hits wins.  ``lookup_bucket_owned`` (kernel KI,
``csrc/sharded_lookup.cu``) probes only the row blocks one rank of a
sharded index owns (parallel/sharded_index.py).
"""

from __future__ import annotations

import ctypes
import sys
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..kernels.build import (bind, check, kernel_lib, launched, ptr,
                             stream_of)

EMPTY = np.uint32(0xFFFFFFFF)
MAX_LEVELS = 32
_M32 = 0xFFFFFFFF


def _mix32_np(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.uint32)
    x ^= x >> np.uint32(16)
    x *= np.uint32(0x7FEB352D)
    x ^= x >> np.uint32(15)
    x *= np.uint32(0x846CA68B)
    x ^= x >> np.uint32(16)
    return x


BUCKET = 8


def _salted_hash_np(lo, hi, locus, salt: int):
    s = np.uint32((0x9E3779B9 * (salt + 1)) & 0xFFFFFFFF)
    h = _mix32_np(np.asarray(hi, np.uint32) ^ s)
    if locus is not None:
        h = _mix32_np(h ^ np.asarray(locus, np.uint32))
    return _mix32_np(np.asarray(lo, np.uint32) ^ h)


class BucketTable:
    """levels: list of (packed (nb, BUCKET, W) u32, salt).  Plane layout
    per slot: lo, hi, [locus if composite], val, [val2 if nval == 2] —
    W = 2 + composite + nval.  A second value plane rides in the SAME
    row, so fetching it is free (the gather unit is descriptor-bound,
    not width-bound): the dbi table uses it to carry the TR/flank
    annotation of single-locus k-mers, eliminating most composite-table
    annotation probes."""

    def __init__(self, levels, composite: bool, nval: int = 1):
        self.levels = levels
        self.composite = composite
        self.nval = nval

    @property
    def nbytes(self):
        return sum(t.nbytes for t, _ in self.levels)


def build_bucket_table(keys, vals, loci=None, lam: float = 5.0,
                       max_levels: int = 8,
                       fat_threshold: int = 0,
                       vals2=None) -> BucketTable:
    """vals=None builds a membership-only table (nval=0, 2-plane rows):
    lookups return found + a zero val.  The prefilter uses this — it only
    needs membership, and the narrower row measurably speeds the gather
    at level-0 bucket density."""
    keys = np.asarray(keys, dtype=np.uint64)
    vals = None if vals is None else np.asarray(vals, dtype=np.uint32)
    composite = loci is not None
    nval = (0 if vals is None else 1) + (0 if vals2 is None else 1)
    assert not (vals is None and vals2 is not None)
    W = 2 + int(composite) + nval
    lo = (keys & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    hi = (keys >> np.uint64(32)).astype(np.uint32)
    loc = None if loci is None else np.asarray(loci, dtype=np.uint32)
    v2 = None if vals2 is None else np.asarray(vals2, dtype=np.uint32)

    # idx=None means the identity (level 0) — at 1e9+ keys the arange
    # alone is ~10 GB, and the full-scale build is RAM-bound
    idx = None
    nidx = len(keys)
    levels = []
    salt = 0
    nlevel = 0
    while nidx:
        assert salt < max_levels + 16, "bucket table cascade diverged"
        # every level costs one full-width gather per probe at lookup
        # time, so the cascade depth IS the probe cost: level 0 packs
        # dense (lam keys/bucket); later levels go sparse (<=1 key/bucket
        # expected) and search up to 16 salts for a zero-overflow layout,
        # making 2 levels the norm at any table size.
        # (fat_threshold enables a single-level lam=0.5 layout for small
        # tables; measured SLOWER on v5e — a 16x bigger table loses more
        # to gather locality than the saved second-level gather — so it
        # defaults off.)
        fat = len(keys) <= fat_threshold
        if fat:
            level_lam, ntry = 0.5, 16
        else:
            level_lam = lam if nlevel == 0 else 1.0
            ntry = 1 if nlevel == 0 else 16
        nb = 64
        while nb * level_lam < nidx:
            nb *= 2

        def _at(a):
            return a if idx is None else a[idx]

        best = None
        for s in range(salt, salt + ntry):
            b = _salted_hash_np(_at(lo), _at(hi),
                                None if loc is None else _at(loc),
                                s) & np.uint32(nb - 1)
            order = np.argsort(b, kind="stable")
            b_sorted = b[order]
            del b
            # rank within bucket (frees between salts bound the search's
            # working set; at 1e9+ keys each temp is ~10 GB)
            first = np.ones(len(order), dtype=bool)
            first[1:] = b_sorted[1:] != b_sorted[:-1]
            grp = np.cumsum(first) - 1
            pos = np.arange(len(order)) - np.flatnonzero(first)[grp]
            del first, grp
            fits = pos < BUCKET
            nover = int((~fits).sum())
            if best is None or nover < best[0]:
                best = (nover, s, order, b_sorted,
                        pos.astype(np.uint8, copy=False) if nover == 0
                        else pos, fits)
            if nover == 0:
                break
        _, s, order, b_sorted, pos, fits = best
        del best
        sel = order[fits] if idx is None else idx[order[fits]]
        bb = b_sorted[fits]
        pp = pos[fits].astype(np.uint8)
        next_idx = order[~fits] if idx is None else idx[order[~fits]]
        del order, b_sorted, pos, fits
        tab = np.full((nb, BUCKET, W), EMPTY, dtype=np.uint32)
        tab[bb, pp, 0] = lo[sel]
        tab[bb, pp, 1] = hi[sel]
        if composite:
            tab[bb, pp, 2] = loc[sel]
        vp = 2 + int(composite)
        if vals is not None:
            tab[bb, pp, vp] = vals[sel]
        if v2 is not None:
            tab[bb, pp, vp + 1] = v2[sel]
        del sel, bb, pp
        # store rows FLAT (nb, BUCKET*W): 3-D row gathers lower ~3x slower
        # than 2-D on TPU; lookups reshape after the gather
        levels.append((tab.reshape(nb, BUCKET * W), s))
        idx = next_idx
        nidx = len(idx)
        salt = s + 1
        nlevel += 1
    return BucketTable(levels, composite, nval)


def lookup_bucket_np(tab: BucketTable, keys, loci=None):
    """Host-side probe.  Always returns (found, val, val2); val2 is a
    zeros plane when the table has no second value plane, so call-site
    arity never depends on table configuration (round-2 advice)."""
    keys = np.asarray(keys, dtype=np.uint64)
    lo = (keys & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    hi = (keys >> np.uint64(32)).astype(np.uint32)
    loc = None if loci is None else np.asarray(loci, dtype=np.uint32)
    nval = getattr(tab, "nval", 1)
    W = 2 + int(tab.composite) + nval
    vp = 2 + int(tab.composite)
    found = np.zeros(len(keys), dtype=bool)
    val = np.zeros(len(keys), dtype=np.uint32)
    val2 = np.zeros(len(keys), dtype=np.uint32)
    for t, salt in tab.levels:
        nb = t.shape[0]
        b = _salted_hash_np(lo, hi, loc, salt) & np.uint32(nb - 1)
        rows = t[b].reshape(len(b), BUCKET, W)
        m = (rows[:, :, 0] == lo[:, None]) & (rows[:, :, 1] == hi[:, None])
        if tab.composite:
            m &= rows[:, :, 2] == loc[:, None]
        hit = m.any(axis=1)
        new = hit & ~found
        if nval >= 1:
            v = np.where(m, rows[:, :, vp], 0).max(axis=1)
            val[new] = v[new]
        if nval == 2:
            v2 = np.where(m, rows[:, :, vp + 1], 0).max(axis=1)
            val2[new] = v2[new]
        found |= hit
    return found, val, val2


def salt_constant(salt: int) -> int:
    """The u32 the level's salt XORs into the key's high half."""
    return (0x9E3779B9 * (salt + 1)) & _M32


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 x in [0, 2^32), without int64 overflow."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _mix32_t(x: torch.Tensor) -> torch.Tensor:
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def bucket_index(lo, hi, loc, salt: int, nb: int) -> torch.Tensor:
    """Plain torch twin of _salted_hash_np & (nb - 1) (int64 in, int64
    out, every value in [0, 2^32))."""
    h = _mix32_t(hi ^ salt_constant(salt))
    if loc is not None:
        h = _mix32_t(h ^ loc)
    return _mix32_t(lo ^ h) & (nb - 1)


@dataclass
class DevTable:
    """A BucketTable's levels on one device, as int32 views of the u32
    rows (same bytes).  ``uploads``: for each level that upload() copied
    in chunks, its bytes, seconds and GB/s."""
    levels: list
    salts: list
    composite: bool
    nval: int
    uploads: list = field(default_factory=list)

    @property
    def W(self) -> int:
        return 2 + int(self.composite) + self.nval

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * 4 for t in self.levels)

    @classmethod
    def upload(cls, tab, device, chunk_bytes: int | None = None
               ) -> "DevTable":
        """``tab``: a BucketTable built by either package (anything with
        ``levels`` [(u32 rows, salt)], ``composite`` and ``nval``).  A
        level of more than ``chunk_bytes`` (default UPLOAD_CHUNK, 1 GiB)
        goes through upload_level_chunked; smaller levels in one copy."""
        chunk = UPLOAD_CHUNK if chunk_bytes is None else int(chunk_bytes)

        def one_shot(t):
            a = np.ascontiguousarray(t, dtype=np.uint32)
            if not a.flags.writeable:          # a read-only memmap
                a = a.copy()
            return torch.from_numpy(a.view(np.int32)).to(device)

        levels, uploads = [], []
        for t, _ in tab.levels:
            if t.nbytes > chunk:
                lv, rec = upload_level_chunked(t, device, chunk)
                uploads.append(rec)
            else:
                lv = one_shot(t)
            levels.append(lv)
        return cls(levels, [int(s) for _, s in tab.levels],
                   bool(tab.composite), int(getattr(tab, "nval", 1)),
                   uploads)


UPLOAD_CHUNK = 1 << 30


def upload_level_chunked(t, device, chunk_bytes: int = UPLOAD_CHUNK
                         ) -> tuple:
    """A level's (nb, row) u32 rows as an int32 tensor on ``device``,
    copied into the preallocated tensor a chunk of rows at a time through
    one staging buffer (pinned on a card; its two halves alternate, so
    the host fills one while the other crosses).  ``t`` is read a slice of
    rows at a time and never copied whole: an mmapped level pages in once,
    straight into the staging buffer.  Any object with ``shape``,
    ``nbytes`` and row slices that give u32 arrays will do; one with
    ``read_rows(s, e, out)`` writes rows [s, e) into the staging buffer
    itself (a level made as it is read: tools/full_index_probe's
    planted 34.4 GB level went up at 5.5-6.6 GB/s so on an H100's host,
    at 3.5 GB/s through slices that each made their chunk).  Returns
    (the tensor, dict(nbytes, seconds, gbps)), and logs the level's
    seconds and GB/s to stderr."""
    dev = torch.device(device)
    nb, row = int(t.shape[0]), int(np.prod(t.shape[1:]))
    t0 = time.time()
    out = torch.empty((nb,) + tuple(t.shape[1:]), dtype=torch.int32,
                      device=dev)
    flat = out.view(nb, row)
    step = max(1, chunk_bytes // 2 // (4 * row))
    cuda = dev.type == "cuda"
    stage = torch.empty((2, step, row), dtype=torch.int32, pin_memory=cuda)
    stage_np = stage.numpy()
    done = [None, None]
    for i, s in enumerate(range(0, nb, step)):
        e = min(s + step, nb)
        h = i % 2
        if done[h] is not None:
            done[h].synchronize()
        if hasattr(t, "read_rows"):
            t.read_rows(s, e, stage_np[h, :e - s])
        else:
            np.copyto(stage_np[h, :e - s], np.asarray(
                t[s:e], dtype=np.uint32).reshape(e - s, row).view(np.int32))
        flat[s:e].copy_(stage[h, :e - s], non_blocking=cuda)
        if cuda:
            done[h] = torch.cuda.Event()
            done[h].record()
    if cuda:
        torch.cuda.synchronize(dev)
    secs = time.time() - t0
    nbytes = nb * row * 4
    print(f"[upload] level of {nbytes / 1e9:.3f} GB ({nb} rows) in "
          f"{secs:.2f}s = {nbytes / 1e9 / max(secs, 1e-9):.2f} GB/s "
          f"through {2 * step * row * 4 / 2**20:.0f} MiB of "
          f"{'pinned ' if cuda else ''}staging", file=sys.stderr,
          flush=True)
    return out, dict(nbytes=nbytes, seconds=secs,
                     gbps=nbytes / 1e9 / secs if secs else None)


def level_args(tab: DevTable) -> tuple:
    """A table's levels as a kernel entry point takes them (csrc/bucket.cuh
    dtk_levels): the row pointers, bucket counts and salt constants, each
    a ctypes array cast to a pointer, and the level count.  The arrays are
    copied by the entry point before it returns."""
    if len(tab.levels) > MAX_LEVELS:
        raise ValueError(f"table has {len(tab.levels)} levels "
                         f"(kernels take <= {MAX_LEVELS})")
    tabs = (ctypes.c_void_p * MAX_LEVELS)(*[t.data_ptr()
                                            for t in tab.levels])
    nbs = (ctypes.c_int64 * MAX_LEVELS)(*[t.shape[0] for t in tab.levels])
    salts = (ctypes.c_int64 * MAX_LEVELS)(*[salt_constant(s)
                                            for s in tab.salts])
    return (ctypes.cast(tabs, ctypes.c_void_p),
            ctypes.cast(nbs, ctypes.c_void_p),
            ctypes.cast(salts, ctypes.c_void_p), len(tab.levels))


def lookup_bucket_plain(tab: DevTable, q: torch.Tensor, q_loc=None):
    """Plain torch version of KB: -> (found bool, val int64, val2 int64),
    each shaped like ``q``; val/val2 hold u32 values (0 where not found,
    val2 0 when the table has no second value plane)."""
    shape = q.shape
    q = q.reshape(-1)
    lo = q & _M32
    hi = (q >> 32) & _M32
    loc = None
    if tab.composite:
        loc = q_loc.reshape(-1).long() & _M32
    W, vp = tab.W, 2 + int(tab.composite)
    found = torch.zeros(q.shape, dtype=torch.bool, device=q.device)
    val = torch.zeros(q.shape, dtype=torch.int64, device=q.device)
    val2 = torch.zeros_like(val)
    for t, salt in zip(tab.levels, tab.salts):
        b = bucket_index(lo, hi, loc, salt, t.shape[0])
        rows = (t[b].long() & _M32).view(-1, BUCKET, W)
        m = (rows[..., 0] == lo[:, None]) & (rows[..., 1] == hi[:, None])
        if tab.composite:
            m &= rows[..., 2] == loc[:, None]
        hit = m.any(dim=-1)
        new = hit & ~found
        if tab.nval >= 1:
            v = torch.where(m, rows[..., vp], 0).amax(dim=-1)
            val = torch.where(new, v, val)
        if tab.nval == 2:
            v2 = torch.where(m, rows[..., vp + 1], 0).amax(dim=-1)
            val2 = torch.where(new, v2, val2)
        found |= hit
    return found.view(shape), val.view(shape), val2.view(shape)


def lookup_bucket(tab: DevTable, q: torch.Tensor, q_loc=None):
    """Probe ``tab`` with int64 k-mers ``q`` (and u32 loci ``q_loc`` for
    a composite table).  Same results as lookup_bucket_jax on the same
    table bytes, EMPTY queries included."""
    if q.device.type == "cpu":
        return lookup_bucket_plain(tab, q, q_loc)
    if q.dtype != torch.int64:
        raise ValueError("queries must be int64 k-mers")
    if tab.composite and q_loc is None:
        raise ValueError("a composite table needs q_loc")
    if any(t.device != q.device for t in tab.levels):
        raise ValueError("table and queries must be on the same device")
    shape = q.shape
    qf = q.reshape(-1).contiguous()
    n = qf.numel()
    lf = None
    if tab.composite:
        lf = q_loc.reshape(-1).to(torch.int64).contiguous()
        if lf.numel() != n:
            raise ValueError("q_loc must match q")
    found = torch.empty(n, dtype=torch.bool, device=q.device)
    val = torch.empty(n, dtype=torch.int64, device=q.device)
    val2 = torch.empty_like(val)
    fn = bind(kernel_lib("bucket_lookup"), "dtk_bucket_lookup",
              "ppipppiiipppp")
    check(fn(ptr(qf), None if lf is None else ptr(lf), n,
             *level_args(tab), int(tab.composite), tab.nval, ptr(found),
             ptr(val), ptr(val2), stream_of(qf)), "bucket_lookup")
    launched("KB")
    return found.view(shape), val.view(shape), val2.view(shape)


# ---------------------------------------------------------------------------
# KI: the probe of the row blocks one rank owns (parallel/sharded_index.py)
# ---------------------------------------------------------------------------

def _as_i32(x: torch.Tensor) -> torch.Tensor:
    """u32 values held as int64 -> int32 bit patterns."""
    return torch.where(x >= (1 << 31), x - (1 << 32), x).to(torch.int32)


def _check_block(block: DevTable, meta) -> None:
    if len(meta) != len(block.levels):
        raise ValueError("lookup_bucket_owned: one meta entry per level")
    for t, (_, nb, off, rows) in zip(block.levels, meta):
        if t.shape[0] != rows or not 0 <= off <= nb - rows \
                or nb & (nb - 1):
            raise ValueError(f"lookup_bucket_owned: a block of {rows} rows "
                             f"at {off} of {nb} (a power of 2) buckets, "
                             f"got {t.shape[0]} rows")


def lookup_bucket_owned_plain(block: DevTable, meta, q: torch.Tensor,
                              q_loc=None):
    """Plain torch version of KI.  ``block``: a DevTable whose levels are
    one rank's row blocks; ``meta``: per level (salt, nb, off, rows), nb
    the whole level's bucket count and [off, off + rows) the buckets the
    block holds.  Returns (found, val, val2) as int32 planes shaped like
    ``q``: 0 where this rank owns no matching bucket, else KB's answer
    (found 1; val / val2 as u32 bit patterns), the first hit in level
    order among the owned levels setting the values (JAX
    lookup_bucket_sharded)."""
    _check_block(block, meta)
    shape = q.shape
    q = q.reshape(-1)
    lo = q & _M32
    hi = (q >> 32) & _M32
    loc = None
    if block.composite:
        loc = q_loc.reshape(-1).long() & _M32
    W, vp = block.W, 2 + int(block.composite)
    found = torch.zeros(q.shape, dtype=torch.bool, device=q.device)
    val = torch.zeros(q.shape, dtype=torch.int64, device=q.device)
    val2 = torch.zeros_like(val)
    for t, (salt, nb, off, rows) in zip(block.levels, meta):
        b = bucket_index(lo, hi, loc, salt, nb)
        mine = (b >= off) & (b < off + rows)
        r = (t[(b - off).clamp(0, rows - 1)].long() & _M32).view(-1, BUCKET,
                                                                  W)
        m = (r[..., 0] == lo[:, None]) & (r[..., 1] == hi[:, None])
        if block.composite:
            m &= r[..., 2] == loc[:, None]
        m &= mine[:, None]
        hit = m.any(dim=-1)
        new = hit & ~found
        if block.nval >= 1:
            val = torch.where(new, torch.where(m, r[..., vp], 0).amax(-1),
                              val)
        if block.nval == 2:
            val2 = torch.where(new, torch.where(m, r[..., vp + 1],
                                                0).amax(-1), val2)
        found |= hit
    return (found.to(torch.int32).view(shape), _as_i32(val).view(shape),
            _as_i32(val2).view(shape))


def lookup_bucket_owned(block: DevTable, meta, q: torch.Tensor, q_loc=None):
    """KI: the probe of one rank's row blocks (KB's group probe when the
    block holds every row of a non-composite table, else a lane a query
    over the owned levels only).  Same contract as
    lookup_bucket_owned_plain."""
    if q.device.type == "cpu":
        return lookup_bucket_owned_plain(block, meta, q, q_loc)
    _check_block(block, meta)
    if q.dtype != torch.int64:
        raise ValueError("queries must be int64 k-mers")
    if block.composite and q_loc is None:
        raise ValueError("a composite table needs q_loc")
    for t in block.levels:
        if t.device != q.device or not t.is_contiguous():
            raise ValueError("row blocks must be contiguous, on the "
                             "queries' device")
    args = owned_args(block, meta)
    shape = q.shape
    qf = q.reshape(-1).contiguous()
    n = qf.numel()
    lf = None
    if block.composite:
        lf = q_loc.reshape(-1).to(torch.int64).contiguous()
        if lf.numel() != n:
            raise ValueError("q_loc must match q")
    out = torch.empty(3 * n, dtype=torch.int32, device=q.device)
    o = out.data_ptr()
    fn = bind(kernel_lib("sharded_lookup"), "dtk_sharded_lookup",
              "ppi" + "ppppp" + "iii" + "pppp")
    check(fn(qf.data_ptr(), None if lf is None else lf.data_ptr(), n, *args,
             int(block.composite), block.nval, o, o + 4 * n, o + 8 * n,
             stream_of(qf)), "sharded_lookup")
    launched("KI")
    return out.view(3, *shape).unbind(0)


def lookup_bucket_owned_count_plain(block: DevTable, meta,
                                    q: torch.Tensor) -> torch.Tensor:
    """Plain torch version of KI[count]: q (R, nf) int64, EMPTY (-1)
    where a sample is not valid -> hits (R,) int32, how many of a row's
    queries are not EMPTY and hit in a bucket this rank's ``block`` owns
    (``meta`` as lookup_bucket_owned_plain's); a repeated query counts as
    often as it occurs.  The sum over the ranks' blocks is each read's
    (found & valid).sum(1) in the whole table (the JAX
    prefilter_decide's)."""
    if block.composite:
        raise ValueError("lookup_bucket_owned_count: the prefilter's table "
                         "is keyed by the k-mer alone")
    if q.dim() != 2:
        raise ValueError("lookup_bucket_owned_count: q is (R, nf)")
    found = lookup_bucket_owned_plain(block, meta, q)[0]
    return ((found != 0) & (q != -1)).sum(1, dtype=torch.int32)


def lookup_bucket_owned_count(block: DevTable, meta,
                              q: torch.Tensor) -> torch.Tensor:
    """KI[count] (csrc/sharded_lookup.cu): the sharded prefilter's probe
    of one rank's row blocks, one int32 hit count a row of the gathered
    queries (rank-major, so a reduce_scatter takes the plane as it is).
    KB's group probe where the block holds every row, else a lane a query
    over the owned levels.  Same contract as
    lookup_bucket_owned_count_plain."""
    if q.device.type == "cpu":
        return lookup_bucket_owned_count_plain(block, meta, q)
    _check_block(block, meta)
    if block.composite:
        raise ValueError("lookup_bucket_owned_count: the prefilter's table "
                         "is keyed by the k-mer alone")
    if q.dtype != torch.int64 or q.dim() != 2 or q.shape[1] < 1:
        raise ValueError("lookup_bucket_owned_count: q is (R, nf >= 1) "
                         "int64 k-mers")
    for t in block.levels:
        if t.device != q.device or not t.is_contiguous():
            raise ValueError("row blocks must be contiguous, on the "
                             "queries' device")
    q = q.contiguous()
    R, nf = q.shape
    hits = torch.empty(R, dtype=torch.int32, device=q.device)
    fn = bind(kernel_lib("sharded_lookup"), "dtk_sharded_lookup_count",
              "pii" + "ppppp" + "iipp")
    check(fn(q.data_ptr(), R, nf, *owned_args(block, meta), block.nval,
             hits.data_ptr(), stream_of(q)), "sharded_lookup_count")
    launched("KI[count]")
    return hits


def owned_args(block: DevTable, meta) -> tuple:
    """A rank's row blocks as dtk_sharded_lookup takes them (as
    level_args, with KI's meta): the row pointers, the whole levels'
    bucket counts, salt constants, the blocks' first buckets and row
    counts, each a ctypes array cast to a pointer, and the level count."""
    if len(block.levels) > MAX_LEVELS:
        raise ValueError(f"table has {len(block.levels)} levels "
                         f"(kernels take <= {MAX_LEVELS})")

    def arr(ctype, vals):
        return ctypes.cast((ctype * MAX_LEVELS)(*vals), ctypes.c_void_p)

    return (arr(ctypes.c_void_p, [t.data_ptr() for t in block.levels]),
            arr(ctypes.c_int64, [m[1] for m in meta]),
            arr(ctypes.c_int64, [salt_constant(m[0]) for m in meta]),
            arr(ctypes.c_int64, [m[2] for m in meta]),
            arr(ctypes.c_int64, [m[3] for m in meta]), len(block.levels))
