"""The genome-wide index's probes on one card, held against the host.

    python -m danbing_tk_tpu_torch.tools.full_index_probe [--dir DIR]
        [--nloci N --kpl K] [--geometry [--nb NB] [--anchors A]]
        [--funnel PAIRS [--prefilter-mult 16]] [--B 65536] [--pairs 1024]
        [--world W --rank R --init URL] [--torch-device cuda|cpu]

Counterpart of tools/sharded_scale_probe.py, run on the card without a
virtual mesh.  It loads a full-index directory (tools/build_full_index.py,
scale_index.load_full_tables; default build/full_index_80000_15000), or
else the scale index's cache (scale_index.build_scale_rpgg_cached, --nloci
and --kpl), and checks three things:

  1. KB over the dbi table equals the host lookup (the numpy probe,
     index/device_table.lookup_bucket_np) on B mixed hit and miss queries:
     found, val and val2 planes;
  2. the collective probe equals the host lookup: KI over D = 1 and D = 4
     row blocks summed (as smoke phase 5s-b runs it), and
     parallel/sharded_index.lookup_bucket_sharded over this rank's row
     block at the process group's world (1 on one card);
  3. the sharded prefilter (KK[sample] -> KI[count] -> KL[decide],
     make_sharded_prefilter) makes the decisions of the replicated one
     (KK[q] over the host sampler's queries and KK's fused launch, both
     over the dbi table when the index has no member table) and of the
     host on `--pairs` WGS-shaped pairs.

``--geometry`` builds the genome-wide index's level-0 geometry instead:
2^28 buckets (``--nb``) of 8 slots of W = 4 planes, 34,359,738,368 B.  Its
keys are build_full_tables's own k-mers (scale_index, 80,000 loci x
15,000) of a few hundred loci spread over all of them, the last ones
included, each family whole (``planted_loci``); their vals, second planes,
vv lists and trfl entries are what the builder makes of those loci.  They
sit at the salted hash and in-bucket rank of build_bucket_table
(``PlantedLevel``, which raises on an overflowing bucket); every other
slot is EMPTY.  ``locus_offsets`` give each locus ~15,000 slots (a planted
locus its own count), so the count state holds 1,199,999,646 u32 slots,
the uncut build's.  Reads drawn from the planted loci then run the whole
counting step (KA, KB, KL, KC, KD with KM's tail), whose counts land in
slots above 2^30, at byte offsets beyond 4 GiB; its state must equal the
state of the same step over a compact index of the same entries
(``count_check``).

``--funnel PAIRS`` then runs one counting-funnel pass,
``run_file_native(prefilter=True)`` (-ka, E = 768 -> [4096], a prefilter
dispatch of 16 steps' pairs, the bench's scale dispatch; --prefilter-mult,
default DTK_PREFILTER_MULT where it is set) over PAIRS pairs of the
bench's WGS shape with a uniform random background, the referee over the
flat view built as tools/bench_scale_funnel.py builds it.

Worlds > 1 run as one process a rank: ``--world W --rank R --init URL``
(a gloo group on the CPU, NCCL on cards).  Prints one JSON line
``full_index_probe`` and last ``FULL-INDEX-PROBE-OK`` with the GB of each
table and row block.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from ..engine import device_align as da
from ..engine.host_align import AlignConfig
from ..index import device_table as dt
from ..ops import kmers_np as K
from . import kernel_bounds as kbd
from . import scale_index as si_

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
FULL_NLOCI, FULL_KPL = 80_000, 15_000
FULL_NB = 1 << 28                 # the uncut build's dbi level 0 buckets
FULL_NSLOTS = 1_199_999_646       # the uncut build's (kmer, locus) slots
CFG = dict(ksize=21, cth=20, n_filter=4, nm_filter=1, okam=False)


# ---------------------------------------------------------------------------
# the genome-wide geometry
# ---------------------------------------------------------------------------

class PlantedLevel:
    """A bucket-table level of ``nb`` rows that is EMPTY but for planted
    keys, read like a read-only (nb, 8 * W) u32 array (W = 2 + nval,
    keyed by the k-mer alone): row slices and integer row selections
    make the rows they ask for, so the level is never held whole on the
    host.  The keys sit where build_bucket_table's level 0 puts them at
    ``salt``: bucket = the salted hash & (nb - 1), rank in the bucket =
    the key's order among the bucket's keys.  Raises ValueError when a
    bucket would hold more than 8."""

    dtype = np.dtype(np.uint32)

    def __init__(self, keys, vals, vals2, nb: int, salt: int = 0):
        keys = np.asarray(keys, dtype=np.uint64)
        lo = (keys & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        hi = (keys >> np.uint64(32)).astype(np.uint32)
        planes = [lo, hi] + [np.asarray(v, dtype=np.uint32)
                             for v in (vals, vals2) if v is not None]
        W = len(planes)
        b = dt._salted_hash_np(lo, hi, None, salt) & np.uint32(nb - 1)
        order = np.argsort(b, kind="stable")
        bs = b[order]
        first = np.ones(len(order), dtype=bool)
        first[1:] = bs[1:] != bs[:-1]
        starts = np.flatnonzero(first)
        pos = np.arange(len(order)) - starts[np.cumsum(first) - 1]
        if len(pos) and pos.max() >= dt.BUCKET:
            worst = bs[int(np.argmax(pos))]
            raise ValueError(f"bucket {int(worst)} of {nb} holds "
                             f"{int(pos.max()) + 1} planted keys (> "
                             f"{dt.BUCKET})")
        self.buckets = bs[starts].astype(np.int64)     # ascending
        rows = np.full((len(starts), dt.BUCKET, W), dt.EMPTY,
                       dtype=np.uint32)
        r = np.cumsum(first) - 1
        for i, p in enumerate(planes):
            rows[r, pos, i] = p[order]
        self.rows = rows.reshape(len(starts), dt.BUCKET * W)
        self.keys = keys
        self.shape = (int(nb), dt.BUCKET * W)
        self.nbytes = int(nb) * dt.BUCKET * W * 4

    def __len__(self) -> int:
        return self.shape[0]

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            s, e, step = idx.indices(self.shape[0])
            if step != 1:
                raise IndexError("PlantedLevel slices take step 1")
            out = np.empty((max(e - s, 0), self.shape[1]), dtype=np.uint32)
            self.read_rows(s, max(e, s), out)
            return out
        idx = np.asarray(idx, dtype=np.int64)
        out = np.full(idx.shape + (self.shape[1],), dt.EMPTY,
                      dtype=np.uint32)
        if len(self.buckets):
            j = np.minimum(np.searchsorted(self.buckets, idx),
                           len(self.buckets) - 1)
            hit = self.buckets[j] == idx
            out[hit] = self.rows[j[hit]]
        return out

    def read_rows(self, s: int, e: int, out: np.ndarray) -> None:
        """Rows [s, e) into ``out`` ((e - s, 8 W) of 4-byte words, e.g.
        DevTable.upload's staging buffer), with no array of its own."""
        out.fill(-1 if out.dtype.kind == "i" else dt.EMPTY)
        j0, j1 = np.searchsorted(self.buckets, [s, e])
        out[self.buckets[j0:j1] - s] = self.rows[j0:j1].view(out.dtype)

    def __array__(self, dtype=None, copy=None):
        a = self[:]
        return a if dtype is None else a.astype(dtype)


def planted_loci(nloci: int, runs, n_anchor: int = 64) -> np.ndarray:
    """The loci the geometry plants: ``n_anchor`` anchors spread evenly
    over [0, nloci), the last locus among them; each anchor brings its
    whole family (``runs``: (first locus, size) as scale_seqs records
    them) or itself, and the next family that starts at or after it, so
    shared k-mers keep all of their loci.  Sorted ascending."""
    starts = np.array([s for s, _ in runs], dtype=np.int64)
    sizes = np.array([n for _, n in runs], dtype=np.int64)
    out = set()
    for a in np.unique(np.linspace(0, nloci - 1, n_anchor).round().astype(
            np.int64)):
        j = int(np.searchsorted(starts, a, side="right")) - 1
        if j >= 0 and a < starts[j] + sizes[j]:
            out.update(range(int(starts[j]), int(starts[j] + sizes[j])))
        else:
            out.add(int(a))
        j = int(np.searchsorted(starts, a, side="left"))
        if j < len(starts):
            out.update(range(int(starts[j]), int(starts[j] + sizes[j])))
    return np.array(sorted(out), dtype=np.int64)


def build_geometry(nloci: int = FULL_NLOCI, kpl: int = FULL_KPL,
                   nb: int = FULL_NB, n_anchor: int = 64,
                   nslots: int | None = FULL_NSLOTS, k: int = 21,
                   seed: int = 9, family_frac: float = 0.2) -> dict:
    """The genome-wide level-0 geometry (see the module's docstring).
    Returns dict(drp: its DeviceRPGG (dbi: one PlantedLevel, trfl, vv, no
    member table), compact: the same entries as an index built by
    build_bucket_table with the planted loci's slots packed, loci: the
    planted loci, seqs: their sequences, per_locus: their slot counts,
    slot_map: (geometry slot, compact slot) int64 of every planted slot,
    nkeys, seconds).  ``nslots`` None: rooms of kpl slots end to end."""
    t0 = time.time()
    runs: list = []
    seqs = si_.scale_seqs(nloci, kpl, family_frac, k, seed, runs=runs)
    loci = planted_loci(nloci, runs, n_anchor)
    sub = np.ascontiguousarray(seqs[loci])
    del seqs
    kms = si_.full_locus_kmers(sub, kpl, k)
    packed, rank16, loff = si_.full_entries(
        kms, loci, max(1, int(2e8 // sub.shape[1])))
    del kms
    per_locus = np.diff(loff)
    packed, rank16 = si_.sort_entries(packed, rank16)
    first, gstart, counts, shared = si_.group_entries(packed)
    vv, vv_off, ent_shared = si_.vv_plane(packed, first, counts, shared)
    keys, vals, ann = si_.dbi_planes(packed, rank16, gstart, shared, vv_off)
    tk, tv, tl = si_.trfl_entries(packed, rank16, ent_shared)
    del packed, rank16, first, gstart, counts, ent_shared
    level = PlantedLevel(keys, vals, ann, nb)
    trfl_tab = dt.build_bucket_table(tk, tv, tl)
    # slot rooms: kpl a locus, a planted locus its own count; the rooms
    # of unplanted loci (which no planted key points at) shrink or grow
    # evenly until the state holds ``nslots``
    room = np.full(nloci, kpl, dtype=np.int64)
    room[loci] = per_locus
    if nslots is not None:
        delta = nslots - int(room.sum())
        free = np.setdiff1d(np.arange(nloci), loci)
        if delta and not len(free):
            raise ValueError(f"every locus is planted: the state cannot "
                             f"hold {nslots} slots")
        if delta:
            q, r = divmod(abs(delta), len(free))
            adj = np.full(len(free), q, dtype=np.int64)
            adj[:r] += 1
            room[free] += adj if delta > 0 else -adj
        if (room < 0).any():
            raise ValueError(f"{nloci} loci of {kpl} slots cannot hold "
                             f"{nslots} slots")
    offsets = np.zeros(nloci + 1, dtype=np.int64)
    np.cumsum(room, out=offsets[1:])
    croom = np.zeros(nloci, dtype=np.int64)
    croom[loci] = per_locus
    coff = np.zeros(nloci + 1, dtype=np.int64)
    np.cumsum(croom, out=coff[1:])
    rank = np.arange(int(per_locus.sum())) - np.repeat(
        loff[:-1], per_locus)
    own = np.repeat(loci, per_locus)
    slot_map = np.stack([offsets[own] + rank, coff[own] + rank], 1)
    dbi_tab = dt.BucketTable([(level, 0)], composite=False, nval=2)
    drp = da.DeviceRPGG(nloci, dbi_tab, vv, trfl_tab, None, offsets,
                        int(offsets[-1]), member_tab=None)
    compact = da.DeviceRPGG(
        nloci, dt.build_bucket_table(keys, vals, vals2=ann), vv, trfl_tab,
        None, coff, int(coff[-1]), member_tab=None)
    return dict(drp=drp, compact=compact, loci=loci, seqs=sub,
                per_locus=per_locus, slot_map=slot_map, nkeys=len(keys),
                seconds=time.time() - t0)


# ---------------------------------------------------------------------------
# the checks
# ---------------------------------------------------------------------------

def hit_keys(tab, n: int, rng) -> np.ndarray:
    """n keys of ``tab`` (repeats allowed): off its planted list, or from
    level-0 rows read at random buckets."""
    t0 = tab.levels[0][0]
    if isinstance(t0, PlantedLevel):
        return t0.keys[rng.integers(0, len(t0.keys), n)]
    W = 2 + int(tab.composite) + tab.nval
    got: list = []
    while sum(len(g) for g in got) < n:
        r = np.asarray(t0[np.sort(rng.integers(0, t0.shape[0], n))]
                       ).reshape(-1, W)
        live = r[:, 1] != dt.EMPTY
        got.append(r[live, 0].astype(np.uint64)
                   | (r[live, 1].astype(np.uint64) << np.uint64(32)))
    keys = np.concatenate(got)
    return keys[rng.permutation(len(keys))[:n]]


def probe_queries(drp, B: int, rng) -> np.ndarray:
    """B u64 queries, half the dbi table's keys and half random 42-bit
    k-mers (nearly all misses), shuffled."""
    keys = np.concatenate([
        hit_keys(drp.dbi_tab, B // 2, rng),
        rng.integers(0, 1 << 42, B - B // 2, dtype=np.uint64)])
    rng.shuffle(keys)
    return keys


def wgs_pairs(seqs, P: int, rng, L: int = 150):
    """P WGS-shaped pairs (half from the loci, half random background) in
    (2P, L) code rows, from the first 4,096 loci's sequences."""
    pool = np.asarray(seqs[:4096])
    flen = min(400, pool.shape[1])
    return si_.sample_read_batch(pool, P, L, rng, frac_tr=0.5, flen=flen)


def _host_planes(drp, keys):
    f, v, v2 = dt.lookup_bucket_np(drp.dbi_tab, keys)
    return (torch.from_numpy(f), torch.from_numpy(v.astype(np.int64)),
            torch.from_numpy(v2.astype(np.int64)))


def _require(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(f"full_index_probe: {what}")


def drive(drp, seqs, dev, mesh, B: int = 65_536, pairs: int = 1024,
          seed: int = 7, geo: dict | None = None, P: int = 4096,
          L: int = 160, E: int = 512) -> dict:
    """The probes and dispatches of the three checks (and with ``geo``
    the counting step over its geometry), each run once through the
    entry points a runner calls: KB, KI over D = 1 and 4 row blocks, the
    collective probe, the prefilter three ways (KK[q], KK, and KK[sample]
    -> KI[count] -> KL[decide]) and the counting step.  Returns what
    ``verify`` holds against the host and ``compare_kernels`` replays."""
    from ..parallel import sharded_index as si
    from ..parallel.mesh import gather_planes

    rng = np.random.default_rng(seed)
    cfg = AlignConfig(**CFG)
    tabs = drp.tables(dev)
    ctx: dict = dict(drp=drp, dev=dev, mesh=mesh, cfg=cfg, tabs=tabs)
    keys = probe_queries(drp, B, rng)
    q = torch.from_numpy(keys.view(np.int64)).to(dev)
    ctx.update(keys=keys, q=q)
    ctx["kb"] = dt.lookup_bucket(tabs["dbi"], q)
    # KI over D row blocks of the whole table, summed
    for D in (1, 4):
        ctx[f"ki{D}"] = [dt.lookup_bucket_owned(b, m, q)
                         for b, m in si.row_blocks(tabs["dbi"], D)]
    # the collective probe over this rank's row block
    Bl = B // mesh.world
    blk = si.row_blocks(tabs["dbi"], mesh.world)[mesh.rank]
    ctx["coll"] = si.lookup_bucket_sharded(
        *blk, q[mesh.rank * Bl:(mesh.rank + 1) * Bl], group=mesh.group)
    # the prefilter: host-sampled (KK[q]), device-sampled (KK) and
    # sharded (KK[sample] -> KI[count] -> KL[decide])
    codes, rlen = wgs_pairs(seqs, pairs, rng)
    qlo, qhi, valid, nonshort = K.sample_subfilter_queries(
        codes, rlen, cfg.ksize, cfg.n_filter)
    live = np.ones(pairs, dtype=bool)
    pq = torch.from_numpy(da.query_int64(qlo, qhi)).to(dev)
    pv, pn, pl = (torch.from_numpy(x).to(dev) for x in (valid, nonshort,
                                                       live))
    pc, pr = (torch.from_numpy(x).to(dev) for x in (codes, rlen))
    ctx.update(codes=codes, rlen=rlen, qlo=qlo, qhi=qhi, valid=valid,
               nonshort=nonshort, pq=pq, pv=pv, pn=pn, pl=pl, pc=pc, pr=pr)
    ctx["s_q"] = da.make_prefilter_step_q(drp, cfg, pairs, dev)(
        pq, pv, pn, pl)
    ctx["s_d"] = da.make_prefilter_step(drp, cfg, pairs, codes.shape[1],
                                        dev)(pc, pr, pl)
    step_sh, _ = si.make_sharded_prefilter(drp, cfg, mesh, pairs,
                                           codes.shape[1])
    ctx["s_sh"] = step_sh(pc, pr, pl)
    if geo is not None:
        crng = np.random.default_rng([seed, 1])
        c2, r2 = si_.sample_read_batch(
            geo["seqs"], P, L, crng, frac_tr=1.0, read_len=150,
            flen=min(400, geo["seqs"].shape[1]))
        cap: dict = {}
        step = da.make_step(drp, cfg, P, L, expand_cap=E, device=dev,
                            capture=cap)
        state = da.init_state(drp, dev)
        live2 = torch.ones(P, dtype=torch.bool, device=dev)
        c2d, r2d = (torch.from_numpy(x).to(dev) for x in (c2, r2))
        _, out = step(state, c2d, r2d, live2)
        ctx.update(step_codes=c2d, step_rlen=r2d, step_live=live2,
                   cap=cap, state=state, out=out, P=P, L=L, E=E)
    # the collective ranks' planes come home for the checks
    ctx["coll_all"] = gather_planes(
        {"f": ctx["coll"][0], "v": ctx["coll"][1], "v2": ctx["coll"][2]},
        mesh)
    return ctx


def verify(ctx, geo: dict | None = None) -> dict:
    """Holds drive()'s answers against the host lookup (checks 1 and 2),
    the replicated prefilter and the host's decisions (check 3) and, with
    ``geo``, the counting step's state against the same step over the
    compact index (``count_check``).  Raises AssertionError on the first
    difference; returns the checks' figures."""
    drp, keys, cfg = ctx["drp"], ctx["keys"], ctx["cfg"]
    fh, vh, v2h = _host_planes(drp, keys)
    f, v, v2 = (x.cpu() for x in ctx["kb"])
    _require(torch.equal(f, fh) and torch.equal(v, vh)
             and torch.equal(v2, v2h), "KB over dbi != the host lookup")
    for D in (1, 4):
        tot = torch.zeros((3, len(keys)), dtype=torch.int64)
        for got in ctx[f"ki{D}"]:
            for i, x in enumerate(got):
                tot[i] += x.cpu().long() & 0xFFFFFFFF
        _require(torch.equal(tot[0] > 0, fh) and torch.equal(tot[1], vh)
                 and torch.equal(tot[2], v2h),
                 f"KI over {D} row blocks != the host lookup")
    ca = ctx["coll_all"]
    _require(torch.equal(ca["f"].cpu(), fh) and torch.equal(
        ca["v"].cpu(), vh) and torch.equal(ca["v2"].cpu(), v2h),
        f"the collective probe at world {ctx['mesh'].world} != the host "
        f"lookup")
    # check 3: the host's decisions over the sampled queries
    skeys = (ctx["qlo"].astype(np.uint64)
             | (ctx["qhi"].astype(np.uint64) << np.uint64(32))).ravel()
    sf = dt.lookup_bucket_np(drp.dbi_tab, skeys)[0].reshape(
        ctx["valid"].shape) & ctx["valid"]
    s_host = torch.from_numpy(
        ((sf.sum(1) >= cfg.nm_filter) & ctx["nonshort"]).reshape(-1, 2).all(
            1))
    for name in ("s_q", "s_d", "s_sh"):
        _require(torch.equal(ctx[name].cpu(), s_host),
                 f"prefilter decisions {name} != the host's")
    res = dict(queries=len(keys), hits=int(fh.sum()),
               pairs=len(ctx["nonshort"]) // 2, survive=int(s_host.sum()),
               world=ctx["mesh"].world)
    if geo is not None:
        res.update(count_check(ctx, geo))
    return res


def count_check(ctx, geo: dict) -> dict:
    """The counting step over the geometry equals the same step over the
    compact index of the same entries (built by build_bucket_table, the
    planted loci's slots packed): every output plane, nmapread, kmc and
    the read statistics, and each planted slot's count at its geometry
    slot and its compact slot; no other slot counted.  Returns the
    counted slots, the highest and the number above 2^30."""
    dev, cfg = ctx["dev"], ctx["cfg"]
    P, L, E = ctx["P"], ctx["L"], ctx["E"]
    step = da.make_step(geo["compact"], cfg, P, L, expand_cap=E,
                        device=dev)
    st = da.init_state(geo["compact"], dev)
    _, out = step(st, ctx["step_codes"], ctx["step_rlen"], ctx["step_live"])
    for key, x in out.items():
        _require(torch.equal(x, ctx["out"][key]),
                 f"the geometry step's {key} != the compact index's")
    sg = ctx["state"]
    for key in ("nmapread", "kmc", "stats"):
        _require(torch.equal(sg[key], st[key]),
                 f"the geometry state's {key} != the compact index's")
    sm = torch.from_numpy(geo["slot_map"]).to(dev)
    cg = sg["counts"]
    _require(torch.equal(cg[sm[:, 0]], st["counts"][sm[:, 1]]),
             "a planted slot's count differs from the compact index's")
    tot = lambda c: int((c[:-1].long() & 0xFFFFFFFF).sum())  # noqa: E731
    n_all, n_c = tot(cg), tot(st["counts"])
    _require(n_all == n_c and n_c > 0 and int(cg[-1]) == int(
        st["counts"][-1]), f"counted k-mers {n_all} at the geometry, "
        f"{n_c} compact")
    hit = sm[:, 0][cg[sm[:, 0]] != 0]
    return dict(counted_kmers=n_c, counted_slots=int(hit.numel()),
                max_slot=int(hit.max()), slots_above_2_30=int(
                    (hit >= (1 << 30)).sum()),
                count_state_slots=int(cg.numel() - 1))


# ---------------------------------------------------------------------------
# each kernel against its plain version, with its bound
# ---------------------------------------------------------------------------

def compare_kernels(ctx, timer=None) -> dict:
    """Each kernel of drive()'s run replayed on its inputs against its
    plain version (max abs error must be 0), and with ``timer`` (fn ->
    ms) both timed: KB, KI (D = 1; D = 4, its slowest block), KI[count]
    (D = 1 and 4), KL[decide], KK[q], KK, KK[sample], and with the
    geometry the counting step's KA, KB[trfl], KL, KC and KD with KM's
    tail on the step's captured inputs.  Returns {name: dict(
    max_abs_err, bound_ms, bytes, ms, plain_ms, rows, ...)}; the bounds
    are tools/kernel_bounds.py's, as chip_smoke.py's phases take them."""
    from ..ops import kmers as km
    from ..parallel import sharded_index as si

    dev, cfg, tabs = ctx["dev"], ctx["cfg"], ctx["tabs"]
    dbi = tabs["dbi"]
    k, nf, nmf = cfg.ksize, cfg.n_filter, cfg.nm_filter
    res: dict = {}

    def cmp(name, kern, plain, nbytes, **extra):
        err = kbd.max_abs_err(kern(), plain())
        if err:
            raise AssertionError(f"{name} disagrees with its plain version "
                                 f"(max |err| {err})")
        r = dict(max_abs_err=0, bound_ms=kbd.bound_ms(nbytes),
                 bytes=int(nbytes), **extra)
        if timer is not None:
            r.update(ms=timer(kern), plain_ms=timer(plain))
        res[name] = r
        return r

    geo = "cap" in ctx
    qkb = ctx["cap"]["KB_dbi"][1] if geo else ctx["q"]
    nbytes, rows, _ = kbd.probe_bytes(dbi, qkb)
    cmp("KB", lambda: dt.lookup_bucket(dbi, qkb),
        lambda: dt.lookup_bucket_plain(dbi, qkb), nbytes, rows=rows,
        queries=qkb.numel())
    for D in (1, 4):
        # each block against its plain version; the slowest block's times
        blocks = {}
        for d, (blk, meta) in enumerate(si.row_blocks(dbi, D)):
            nbytes, rows = kbd.owned_bytes(blk, meta, qkb)
            blocks[d] = cmp(
                f"KI[D={D}]",
                lambda b=blk, m=meta: dt.lookup_bucket_owned(b, m, qkb),
                lambda b=blk, m=meta: dt.lookup_bucket_owned_plain(b, m,
                                                                   qkb),
                nbytes, rows=rows, queries=qkb.numel(), block=d)
        if timer is not None:
            res[f"KI[D={D}]"] = max(blocks.values(), key=lambda r: r["ms"])
    # the prefilter's kernels on drive()'s dispatch
    pc, pr, pl, pq, pv, pn = (ctx[x] for x in ("pc", "pr", "pl", "pq", "pv",
                                               "pn"))
    R, L = pc.shape
    cmp("KK[sample]", lambda: km.prefilter_sample(pc, pr, k, nf),
        lambda: km.prefilter_sample_plain(pc, pr, k, nf),
        kbd.kk_sample_bytes(R, L, nf))
    sq, _, snk = km.prefilter_sample(pc, pr, k, nf)
    for D in (1, 4):
        for d, (blk, meta) in enumerate(si.row_blocks(dbi, D)):
            nbytes, rows = kbd.owned_count_bytes(blk, meta, sq)
            cmp(f"KI[count] D={D} block {d}",
                lambda b=blk, m=meta: dt.lookup_bucket_owned_count(b, m, sq),
                lambda b=blk, m=meta: dt.lookup_bucket_owned_count_plain(
                    b, m, sq), nbytes, rows=rows)
    hits = dt.lookup_bucket_owned_count(*si.row_blocks(dbi, 1)[0], sq)
    Pp = R // 2
    cmp("KL[decide]",
        lambda: da.prefilter_decision(hits, snk, pl, nmf, Pp),
        lambda: da.prefilter_decide(hits, snk, pl, nmf, Pp),
        kbd.kl_decide_bytes(Pp))
    fq = da.prefilter_fused_q_launcher(dbi, nmf)
    qw = da.prefilter_fused_q_work(pq, pv, pn, pl, dbi, nmf)
    cmp("KK[q]", lambda: fq(pq, pv, pn, pl),
        lambda: da.prefilter_fused_q_plain(pq, pv, pn, pl, dbi, nmf),
        qw["nbytes"], rows=qw["rows"])
    ff = da.prefilter_fused_launcher(dbi, k, nf, nmf)
    fw = da.prefilter_fused_work(pc, pr, pl, dbi, k, nf, nmf)
    cmp("KK", lambda: ff(pc, pr, pl),
        lambda: da.prefilter_fused_plain(pc, pr, pl, dbi, k, nf, nmf),
        fw["nbytes"], rows=fw["rows"])
    if not geo:
        return res
    cap = ctx["cap"]
    P, L2 = ctx["P"], ctx["L"]
    NKW = L2 - k + 1
    ka_c, ka_r = cap["KA"][:2]
    cmp("KA", lambda: km.extract_kmers(ka_c, ka_r, k, False, False),
        lambda: km.extract_kmers_plain(ka_c, ka_r, k, False, False),
        kbd.ka_bytes(2 * P, L2, k))
    ttab, tq, tloc = cap["KB_trfl"]
    nbytes, rows, _ = kbd.probe_bytes(ttab, tq, tloc)
    cmp("KB[trfl]", lambda: dt.lookup_bucket(ttab, tq, tloc),
        lambda: dt.lookup_bucket_plain(ttab, tq, tloc), nbytes, rows=rows)
    kl = cap["KL"]
    cmp("KL", lambda: da.pair_filter(*kl), lambda: da.pair_filter_plain(*kl),
        kbd.kl_bytes(P, NKW))
    kc = cap["KC"]
    cmp("KC", lambda: da.pair_vote(*kc), lambda: da.pair_vote_plain(*kc),
        kbd.kc_bytes(P, NKW))
    kd = cap["KD"]
    drp = ctx["drp"]
    st_k, st_p = da.init_state(drp, dev), da.init_state(drp, dev)
    a_k = da.assign_count(st_k, *kd)
    a_p = da.assign_count_plain(st_p, *kd)
    for key in ("counts", "nmapread", "kmc", "stats"):
        _require(torch.equal(st_k[key], st_p[key]),
                 f"KD's state {key} disagrees with its plain version")
    km_err = kbd.max_abs_err({x: a_k[x] for x in ("hf", "counted", "dest")},
                             {x: a_p[x] for x in ("hf", "counted", "dest")})
    _require(km_err == 0, "KM's tail in KD disagrees with its plain version")
    n_slots = kbd.touched_slots(st_k["counts"])
    del a_k, a_p
    # the replays below add to these states; only their times count
    cmp("KD", lambda: da.assign_count(st_k, *kd)["rm"],
        lambda: da.assign_count_plain(st_p, *kd)["rm"],
        kbd.kd_bytes(P, NKW, n_slots), slots=n_slots,
        count_state_slots=drp.nslots)
    return res


# ---------------------------------------------------------------------------
# one counting-funnel pass
# ---------------------------------------------------------------------------

def funnel_pass(drp, seqs, npairs: int, dev, root: str,
                prefilter_mult: int = 16) -> dict:
    """One ``run_file_native(prefilter=True)`` pass (-ka, E = 768 ->
    [4096], a prefilter dispatch of ``prefilter_mult`` steps' pairs,
    the bench's scale dispatch) over ``npairs`` pairs of the
    bench's WGS shape (5% from the first 20,000 loci, 0.2% substitutions,
    a uniform random background; tools/bench_e2e.synth_reads), the
    referee over the flat view (FlatRPGG.from_device_tables).  Returns
    reads/s, survivors, retried, referee'd and resolved pairs, peak device
    memory and the pass's launches."""
    from ..engine.align_runner import DeviceAlignRunner
    from ..engine.flat_rpgg import FlatRPGG
    from ..kernels import build
    from .bench_scale_funnel import reads_file

    t0 = time.time()
    flat = FlatRPGG.from_device_tables(drp)
    t_flat = time.time() - t0
    nloci, Ltr = seqs.shape
    t0 = time.time()
    reads = reads_file(root, seqs, nloci, Ltr, npairs, 0.05, 0.002,
                       tag="full")
    t_reads = time.time() - t0
    cfg = AlignConfig(**CFG)
    al = DeviceAlignRunner(flat, cfg, batch_pairs=4096, max_read_len=160,
                           expand_cap=768, retry_expand=[4096], drp=drp,
                           device=dev, prefilter_mult=prefilter_mult)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    build.reset_launch_counts()
    t0 = time.time()
    al.run_file_native(reads, prefilter=True)
    int(al.state["counts"].sum())
    wall = time.time() - t0
    launches = {kk: v for kk, v in build.launch_counts().items() if v}
    return dict(pairs=npairs, wall_s=wall, reads_per_s=2 * npairs / wall,
                survivors=npairs - al.n_prefiltered, retried=al.n_retried,
                referee=al.n_referee, resolved=al.n_resolved,
                referee_s=al.referee_s, flat_view_s=t_flat,
                reads_s=t_reads, launches=launches,
                peak_device_bytes=(torch.cuda.max_memory_allocated(dev)
                                   if dev.type == "cuda" else None),
                prefilter_mult=prefilter_mult)


# ---------------------------------------------------------------------------

def load_index(a):
    """(drp, seqs, provenance) from --dir, else the scale cache."""
    man = os.path.join(a.dir, "manifest.json")
    t0 = time.time()
    if os.path.exists(man):
        drp, seqs, _ = si_.load_full_tables(a.dir, mmap=True)
        prov = f"full index {a.dir}"
    else:
        drp, seqs = si_.build_scale_rpgg_cached(a.nloci, a.kpl,
                                                cache_dir=a.cache_dir)
        prov = f"{a.nloci}-locus scale cache ({a.cache_dir})"
    return drp, seqs, f"{prov}, loaded in {time.time() - t0:.1f}s"


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="full_index_probe")
    ap.add_argument("--dir", default=os.path.join(
        ROOT, "build", f"full_index_{FULL_NLOCI}_{FULL_KPL}"))
    ap.add_argument("--nloci", type=int, default=80_000)
    ap.add_argument("--kpl", type=int, default=1500)
    ap.add_argument("--cache-dir", default=os.path.join(ROOT, "build"))
    ap.add_argument("--geometry", action="store_true")
    ap.add_argument("--nb", type=int, default=FULL_NB)
    ap.add_argument("--anchors", type=int, default=64)
    ap.add_argument("--geo-nloci", type=int, default=FULL_NLOCI)
    ap.add_argument("--geo-kpl", type=int, default=FULL_KPL)
    ap.add_argument("--funnel", type=int, default=0)
    ap.add_argument("--prefilter-mult", type=int,
                    default=int(os.environ.get("DTK_PREFILTER_MULT", 16)))
    ap.add_argument("--B", type=int, default=65_536)
    ap.add_argument("--pairs", type=int, default=1024)
    ap.add_argument("--P", type=int, default=4096)
    ap.add_argument("--world", type=int, default=1)
    ap.add_argument("--rank", type=int, default=0)
    ap.add_argument("--init", default=None)
    ap.add_argument("--timeout", type=float, default=300.0)
    ap.add_argument("--threads", type=int, default=0,
                    help="torch CPU threads (0: torch's default)")
    ap.add_argument("--torch-device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    from datetime import timedelta

    import torch.distributed as dist

    from .._device import resolve_device
    from ..parallel.mesh import make_mesh

    a = parse_args(argv)
    if a.threads:
        torch.set_num_threads(a.threads)
    dev = resolve_device(a.torch_device)
    if a.world > 1 or a.init:
        if dev.type == "cuda":
            dev = torch.device("cuda", a.rank % torch.cuda.device_count())
            torch.cuda.set_device(dev)
        dist.init_process_group(
            "nccl" if dev.type == "cuda" else "gloo",
            init_method=a.init or "env://", rank=a.rank,
            world_size=a.world, timeout=timedelta(seconds=a.timeout))
    try:
        if dev.type == "cuda":
            from ..kernels import build
            from ..utils.compile_cache import enable_compile_cache

            # one nvcc a kernel source, all at once
            enable_compile_cache()
            build.build_all()
        mesh = make_mesh(device=dev)
        geo = None
        if a.geometry:
            geo = build_geometry(a.geo_nloci, a.geo_kpl, a.nb, a.anchors,
                                 FULL_NSLOTS if (a.geo_nloci, a.geo_kpl) == (
                                     FULL_NLOCI, FULL_KPL) else None)
            drp, seqs = geo["drp"], geo["seqs"]
            prov = (f"geometry: {len(geo['loci'])} planted loci of "
                    f"{a.geo_nloci}, {geo['nkeys']} keys in {a.nb} "
                    f"buckets, built in {geo['seconds']:.1f}s")
        else:
            drp, seqs, prov = load_index(a)
        print(f"# index: {prov}; dbi {drp.dbi_tab.nbytes / 1e9:.3f} GB "
              f"({len(drp.dbi_tab.levels)} levels), trfl "
              f"{drp.trfl_tab.nbytes / 1e9:.3f} GB", file=sys.stderr,
              flush=True)
        t0 = time.time()
        drp.tables(dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t_up = time.time() - t0
        ctx = drive(drp, seqs, dev, mesh, a.B, a.pairs, geo=geo, P=a.P)
        res = verify(ctx, geo)
        res.update(upload_s=t_up, uploads=[
            r for t in drp.tables(dev).values()
            for r in getattr(t, "uploads", [])])
        if a.funnel:
            res["funnel"] = funnel_pass(drp, seqs, a.funnel, dev,
                                        a.cache_dir, a.prefilter_mult)
        blocks = [drp.dbi_tab.nbytes / D / 1e9 for D in (1, 4, mesh.world)]
        out = dict(metric="full_index_probe", index=prov,
                   dbi_gb=drp.dbi_tab.nbytes / 1e9,
                   dbi_levels=[list(map(int, t.shape))
                               for t, _ in drp.dbi_tab.levels],
                   trfl_gb=drp.trfl_tab.nbytes / 1e9, nslots=drp.nslots,
                   **res)
        if dev.type == "cuda":
            out["peak_device_bytes"] = torch.cuda.max_memory_allocated(dev)
        if mesh.rank == 0:
            print(json.dumps(out), flush=True)
            print(f"FULL-INDEX-PROBE-OK dbi={blocks[0]:.2f}GB "
                  f"block={blocks[1]:.2f}GB x4 "
                  f"trfl={drp.trfl_tab.nbytes / 1e9:.2f}GB "
                  f"world={mesh.world} shard={blocks[2]:.2f}GB", flush=True)
        return 0
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    sys.exit(main())
