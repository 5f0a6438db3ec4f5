"""Synthetic production-scale RPGG built directly into device tables.

Port of tools/make_scale_index.py (build_scale_rpgg, its npz cache,
sample_read_batch, and the genome-wide index's memory-lean builder
build_full_tables and its loader load_full_tables) on the port's own
numpy table construction.  The reference's
production index is ~80k loci; building one through the text formats and
Python dicts is build-pipeline territory, so this constructs a DeviceRPGG
straight from numpy with the same table shapes and hit statistics:

  * per-locus random TR sequences (2-bit codes), with locus FAMILIES
    sharing a segment (=> shared k-mers => vv lists, the vote's expansion
    load, like real motif sharing)
  * canonical k-mers extracted with the host k-mer oracle
  * kmerDBi (keys/vals/vv) and the composite trfl slot table assembled
    with sorts/uniques only -- no per-key Python

Read batches are sampled from the same sequence pool (PE fragments, with
an optional per-base substitution rate) plus random background, so probes
hit and the full vote/annotate/count path runs realistically.

For graph threading, ``build_scale_graph`` makes the (node, locus) ->
out-edge-mask table from the loci's own sequences by the ``fa2kmers -g``
rule, and ``ScaleThreadView`` gives the host threading fallback
``graphs[d]`` / ``tr_counts[d]`` of a locus on first use.  For the okam
funnel (bait, QC, bubbles), ``build_scale_tre`` makes the (edge, locus)
table of the loci's canonical (k+1)-mers (the fa2kmers tre rule),
``build_scale_bait`` a bait table of each locus's own k-mers,
``build_scale_qc`` a QC mask, and ``sim_titles`` simmode-2 read titles.
Used by chip_smoke.py's production-size phases.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

from ..engine.device_align import ANN_TR, DeviceRPGG
from ..index import device_table as dt
from ..ops import kmers_np as K


def scale_seqs(nloci: int = 80_000, kmers_per_locus: int = 1500,
               family_frac: float = 0.2, k: int = 21,
               seed: int = 9, runs: list | None = None) -> np.ndarray:
    """The loci's sequences, (nloci, kmers_per_locus + k - 1) u8 codes, as
    build_scale_rpgg and build_full_tables make them (their tables are
    built from these).  ``runs``, a list, receives each family as (first
    locus, size)."""
    rng = np.random.default_rng(seed)
    Ltr = kmers_per_locus + k - 1
    seqs = rng.integers(0, 4, size=(nloci, Ltr), dtype=np.uint8)
    # families: runs of 2-8 consecutive loci share a ~25% SEGMENT (motif-
    # level sharing; fully duplicated loci would make every family read a
    # cap-overflowing all-locus tie, which real RPGGs don't have — MBE
    # merges true duplicates)
    li = 0
    fam_target = int(nloci * family_frac)
    seg = max(Ltr // 4, k)
    famed = 0
    while famed < fam_target and li < nloci - 8:
        size = int(rng.integers(2, 9))
        beg = int(rng.integers(0, Ltr - seg))
        seqs[li + 1 : li + size, beg : beg + seg] = seqs[li, beg : beg + seg]
        if runs is not None:
            runs.append((li, size))
        famed += size
        li += size + int(rng.integers(1, 20))
    return seqs


def build_scale_rpgg(nloci: int = 80_000, kmers_per_locus: int = 1500,
                     family_frac: float = 0.2, k: int = 21, seed: int = 9,
                     with_trfl: bool = True, verbose: bool = True):
    """Returns (drp: DeviceRPGG, seqs: (nloci, Ltr) u8 codes)."""
    def log(msg):
        if verbose:
            print(f"[scale-index] {msg}", file=sys.stderr)

    t0 = time.time()
    seqs = scale_seqs(nloci, kmers_per_locus, family_frac, k, seed)
    log(f"sequences {seqs.nbytes/1e6:.0f} MB in {time.time()-t0:.1f}s")

    # canonical k-mers, all loci in one shot (interior windows only)
    t0 = time.time()
    kms = full_locus_kmers(seqs, kmers_per_locus, k)
    log(f"kmers extracted in {time.time()-t0:.1f}s")

    # per-locus dedupe: sort within row, drop repeats (ragged flat form)
    t0 = time.time()
    kms.sort(axis=1)
    keep = np.ones(kms.shape, dtype=bool)
    keep[:, 1:] = kms[:, 1:] != kms[:, :-1]
    loc_of = np.broadcast_to(
        np.arange(nloci, dtype=np.uint32)[:, None], kms.shape)
    flat_k = kms[keep]
    flat_l = loc_of[keep].astype(np.uint32)
    per_locus = keep.sum(axis=1).astype(np.int64)
    offsets = np.zeros(nloci + 1, dtype=np.int64)
    np.cumsum(per_locus, out=offsets[1:])
    nslots = int(offsets[-1])
    del kms, keep, loc_of
    log(f"{nslots/1e6:.1f}M (kmer,locus) slots in {time.time()-t0:.1f}s")

    # kmerDBi: unique kmers; shared ones get vv lists
    t0 = time.time()
    order = np.argsort(flat_k, kind="stable")
    sk = flat_k[order]
    sl = flat_l[order]
    first = np.ones(len(sk), dtype=bool)
    first[1:] = sk[1:] != sk[:-1]
    grp = np.cumsum(first) - 1                     # group id per entry
    counts = np.bincount(grp)
    keys = sk[first]
    nkeys = len(keys)
    shared = counts > 1                            # per group
    # vv layout: [n, loci...] per shared group, concatenated
    vv_sizes = np.where(shared, counts + 1, 0)
    vv_off = np.zeros(nkeys + 1, dtype=np.int64)
    np.cumsum(vv_sizes, out=vv_off[1:])
    vv = np.zeros(int(vv_off[-1]), dtype=np.uint32)
    vv[vv_off[:-1][shared]] = counts[shared].astype(np.uint32)
    # scatter loci: entry positions within group = rank since group start
    grp_start = np.flatnonzero(first)
    rank = np.arange(len(sk)) - grp_start[grp]
    ent_shared = shared[grp]
    dst = vv_off[:-1][grp] + 1 + rank
    vv[dst[ent_shared]] = sl[ent_shared]
    vals = np.where(
        shared, (vv_off[:-1] << 1) | 1,
        sl[grp_start].astype(np.int64) << 1).astype(np.uint32)
    log(f"dbi {nkeys/1e6:.1f}M keys, vv {len(vv)/1e6:.1f}M "
        f"in {time.time()-t0:.1f}s")

    # single-locus k-mers carry their annotation value in the dbi row's
    # second plane; values hold the RANK within the locus (slot =
    # locus_offsets[dst] + rank on device — u32-safe at 1e9+ slots);
    # only shared (vv) k-mers keep composite trfl entries — see
    # DeviceRPGG.build for the probe-fusion rationale
    slot_of = order[grp_start].astype(np.int64)
    rank_of = slot_of - offsets[flat_l[slot_of]]
    ann = np.where(shared, 0, (rank_of << 3) | ANN_TR).astype(np.uint32)

    t0 = time.time()
    dbi_tab = dt.build_bucket_table(keys, vals, vals2=ann)
    member_tab = dt.build_bucket_table(keys, None)
    log(f"dbi table {dbi_tab.nbytes/1e9:.2f} GB "
        f"({len(dbi_tab.levels)} levels) + member "
        f"{member_tab.nbytes/1e9:.2f} GB in {time.time()-t0:.1f}s")
    ent_shared_flat = np.empty(len(flat_k), dtype=bool)
    ent_shared_flat[order] = ent_shared
    del keys, vals, order, sk, sl, first, grp, counts

    trfl_tab = None
    if with_trfl:
        # slot ids in trkmc flatten order (per-locus, sorted-kmer order)
        t0 = time.time()
        slots = np.flatnonzero(ent_shared_flat).astype(np.int64)
        ranks = (slots - offsets[flat_l[ent_shared_flat]]).astype(np.uint64)
        tv = ((ranks << np.uint64(3)) | np.uint64(ANN_TR)).astype(np.uint32)
        trfl_tab = dt.build_bucket_table(
            flat_k[ent_shared_flat], tv, flat_l[ent_shared_flat])
        log(f"trfl table {trfl_tab.nbytes/1e9:.2f} GB "
            f"({len(trfl_tab.levels)} levels, "
            f"{int(ent_shared_flat.sum())/1e6:.1f}M shared entries) "
            f"in {time.time()-t0:.1f}s")
    drp = DeviceRPGG(nloci, dbi_tab, vv, trfl_tab, None,
                     offsets, nslots, member_tab=member_tab)
    return drp, seqs


def _fwd_kmers(codes: np.ndarray, k: int) -> np.ndarray:
    """Forward k-mers of every row of (n, Lt) u8 codes (all ACGT)."""
    nk = codes.shape[1] - k + 1
    c = codes.astype(np.uint64)
    out = np.zeros((codes.shape[0], nk), dtype=np.uint64)
    for j in range(k):
        out |= c[:, j:j + nk] << np.uint64(2 * (k - 1 - j))
    return out


def locus_graphs(codes: np.ndarray, k: int):
    """The dBG of each row of ``codes`` ((n, Lt) u8, no N) by the
    ``fa2kmers -g`` rule (apps/fa2kmers.py:_graph_into, ops/kmers_np.py:
    build_kmer_graph): the whole sequence, forward and reverse-complement
    strands, an edge to the next k-mer unless it is a self-loop, the last
    k-mer a node with no edge.  Returns (node u64, mask u8, row u32) flat
    arrays, nodes ascending within each row."""
    n = codes.shape[0]
    ent = []
    for strand in (codes, (3 - codes)[:, ::-1]):
        km = _fwd_kmers(strand, k)
        nxt = km[:, 1:]
        bit = np.where(km[:, :-1] != nxt, np.uint64(1) << (nxt & np.uint64(3)),
                       np.uint64(0))
        bits = np.concatenate([bit, np.zeros((n, 1), np.uint64)], axis=1)
        ent.append((km << np.uint64(4)) | bits)
    key = np.concatenate(ent, axis=1)
    key.sort(axis=1)
    node = key >> np.uint64(4)
    first = np.ones(node.shape, dtype=bool)
    first[:, 1:] = node[:, 1:] != node[:, :-1]
    starts = np.flatnonzero(first)
    mask = np.bitwise_or.reduceat(
        (key & np.uint64(15)).astype(np.uint8).ravel(), starts)
    rows = np.repeat(np.arange(n, dtype=np.uint32), first.sum(axis=1))
    return node.ravel()[starts], mask, rows


def build_scale_graph(seqs: np.ndarray, k: int = 21, chunk: int = 4096,
                      verbose: bool = True):
    """The composite graph table (non-canonical k-mer, locus) -> 4-bit
    out-edge mask of every locus of ``seqs``, the table
    DeviceRPGG.add_graph builds from pan.graph.kmers.  Returns
    (BucketTable, entries)."""
    t0 = time.time()
    parts = [locus_graphs(seqs[s:s + chunk], k)
             for s in range(0, len(seqs), chunk)]
    nodes = np.concatenate([p[0] for p in parts])
    masks = np.concatenate([p[1] for p in parts]).astype(np.uint32)
    loci = np.concatenate([p[2] + np.uint32(s) for s, p in
                           zip(range(0, len(seqs), chunk), parts)])
    del parts
    if verbose:
        print(f"[scale-index] graph {len(nodes)/1e6:.1f}M nodes in "
              f"{time.time()-t0:.1f}s", file=sys.stderr)
    tab = dt.build_bucket_table(nodes, masks, loci)
    return tab, len(nodes)


def failure_sites(tbatches, src_loci, view, k: int, RL: int, B: int):
    """B error-correction sites of the threading reads ``tbatches``
    ((codes, rlen, n) batches of sample_read_batch(with_loci=True), whose
    pairs' source loci are ``src_loci``): a TR mate's forward k-mers, the
    first ki >= 1 whose k-mer is no out-neighbour of k-mer ki - 1, a node
    of the source locus's graph (where the threading walk calls error
    correction; ``view`` a ScaleThreadView), and that locus.  Returns
    ([(kmers, ki, locus)], TR pairs searched); fewer than B sites when the
    batches run out."""
    sites, n_pairs = [], 0
    for (codes, rlen, _), li in zip(tbatches, src_loci):
        t = np.flatnonzero(li >= 0)
        mates = np.stack([2 * t, 2 * t + 1], 1).ravel()
        if (rlen[mates] != RL).any():
            raise ValueError("a TR mate is not RL bases long")
        ml = np.repeat(li[t], 2)
        kms = _fwd_kmers(codes[mates, :RL], k)
        ul = np.unique(ml)
        gk = np.concatenate([(np.uint64(d) << np.uint64(42))
                             | view.graphs[d][0] for d in ul.tolist()])
        gm = np.concatenate([view.graphs[d][1] for d in ul.tolist()])
        key = (ml.astype(np.uint64)[:, None] << np.uint64(42)) | kms
        pos = np.searchsorted(gk, key).clip(max=len(gk) - 1)
        hit = gk[pos] == key
        bits = np.where(hit, gm[pos], 0).astype(np.int64)
        bad = hit[:, :-1] & (((bits[:, :-1] >> (kms[:, 1:] & np.uint64(3))
                               .astype(np.int64)) & 1) == 0)
        rows = np.flatnonzero(bad.any(1))[:B - len(sites)]
        ki = bad.argmax(1) + 1
        sites += [(kms[r], int(ki[r]), int(ml[r])) for r in rows]
        n_pairs += rows[-1] // 2 + 1 if len(sites) == B else len(t)
        if len(sites) == B:
            break
    return sites, n_pairs


def _canonical(codes: np.ndarray, k: int) -> np.ndarray:
    """Canonical k-mers of every row of (n, Lt) u8 codes (all ACGT)."""
    fwd = _fwd_kmers(codes, k)
    rc = _fwd_kmers((3 - codes)[:, ::-1], k)[:, ::-1]
    return np.minimum(fwd, rc)


def build_scale_tre(seqs: np.ndarray, k: int = 21, chunk: int = 4096,
                    verbose: bool = True):
    """The composite tre table (canonical (k+1)-mer edge, locus) -> 1 of
    every locus of ``seqs``, by the ``fa2kmers`` tre rule
    (apps/fa2kmers.py make_tre_kmers: the TR sequence's canonical
    (k+1)-mers, a set per locus; the synthetic loci are all TR).  The
    table DeviceRPGG.build makes from pan.tre.kmers.  Returns
    (BucketTable, entries)."""
    t0 = time.time()
    keys, loci = [], []
    for s in range(0, len(seqs), chunk):
        e = np.sort(_canonical(seqs[s:s + chunk], k + 1), axis=1)
        keep = np.ones(e.shape, dtype=bool)
        keep[:, 1:] = e[:, 1:] != e[:, :-1]
        keys.append(e[keep])
        loci.append(np.repeat(np.arange(s, s + len(e), dtype=np.uint32),
                              keep.sum(axis=1)))
    keys, loci = np.concatenate(keys), np.concatenate(loci)
    if verbose:
        print(f"[scale-index] tre {len(keys)/1e6:.1f}M edges in "
              f"{time.time()-t0:.1f}s", file=sys.stderr)
    tab = dt.build_bucket_table(keys, np.ones(len(keys), np.uint32), loci)
    return tab, len(keys)


def build_scale_bait(seqs: np.ndarray, k: int = 21, per_locus: int = 64,
                     seed: int = 9):
    """A bait table (canonical k-mer, locus) -> (mi << 8) | ma of
    ``per_locus`` of each locus's own k-mers, at evenly spaced windows
    from a random offset: all but one have the window [1, 255], which a
    k-mer present in a read always meets; one, drawn per locus, has
    [0, 0], so a mate that carries it is bait-filtered (a read covering
    ~130 of 1,500 windows does so ~9% of the time).  Returns
    (BucketTable, entries)."""
    nloci, Ltr = seqs.shape
    nw = Ltr - k + 1
    rng = np.random.default_rng([seed, 4])
    step = max(nw // per_locus, 1)
    pos = (rng.integers(0, nw - step * (per_locus - 1), nloci)[:, None]
           + step * np.arange(per_locus)[None, :])
    win = seqs[np.arange(nloci)[:, None, None],
               pos[:, :, None] + np.arange(k)[None, None, :]]
    kms = _canonical(win.reshape(-1, k), k).reshape(-1)
    vals = np.full((nloci, per_locus), (1 << 8) | 255, dtype=np.uint32)
    vals[np.arange(nloci), rng.integers(0, per_locus, nloci)] = 0
    loci = np.repeat(np.arange(nloci, dtype=np.uint32), per_locus)
    return dt.build_bucket_table(kms, vals.reshape(-1), loci), len(kms)


def build_scale_qc(nloci: int, fail_frac: float = 0.05,
                   seed: int = 9) -> np.ndarray:
    """A QC pass mask (u8[nloci], 1 = pass) with ``fail_frac`` of the
    loci, drawn from the seed, failing."""
    rng = np.random.default_rng([seed, 5])
    qc = np.ones(nloci, dtype=np.uint8)
    qc[rng.choice(nloci, int(nloci * fail_frac), replace=False)] = 0
    return qc


def sim_titles(loci: np.ndarray) -> list[str]:
    """Simmode-2 titles ``chr:beg-end:LOCUS`` ('.' for background, -1) of
    the pairs sample_read_batch(with_loci=True) made, '>'-stripped as the
    native reader gives them."""
    return [f"syn:{i}-{i + 1}:{'.' if d < 0 else d}"
            for i, d in enumerate(np.asarray(loci).tolist())]


class ScaleThreadView:
    """Host view of the synthetic index for the batched threading fallback
    (align_runner's ``thread_view``): ``graphs[d]`` (a (nodes, masks)
    array pair) and ``tr_counts[d]`` (the locus's canonical k-mers ->
    count) of a locus, built from ``seqs[d]`` on first use, so the
    fallback resolves pairs at 80k loci without building every locus's
    dicts.  Test data for the smoke run, not an aligner feature."""

    def __init__(self, seqs: np.ndarray, k: int = 21):
        self.seqs, self.k = seqs, k
        self.graphs = _OnFirstUse(self._locus)
        self.tr_counts = _OnFirstUse(self._locus)
        self.build_s = 0.0          # host seconds spent building loci

    def _locus(self, d: int):
        self.build([d])

    def build(self, loci, chunk: int = 2048):
        """Builds the entries of ``loci`` not built yet, vectorised over
        chunks of loci (a caller that knows its loci builds them up
        front, outside the time it measures)."""
        t0 = time.perf_counter()
        loci = np.unique(np.asarray(loci, dtype=np.int64))
        loci = [d for d in loci.tolist()
                if d >= 0 and d not in self.graphs]
        for s in range(0, len(loci), chunk):
            ls = loci[s:s + chunk]
            node, mask, rows = locus_graphs(self.seqs[ls], self.k)
            # the graph's nodes are both strands' k-mers: their canonical
            # forms are the locus's TR k-mers
            ca = np.minimum(node, K.revcomp_kmers(node, self.k))
            ends = np.searchsorted(rows, np.arange(len(ls) + 1))
            for i, d in enumerate(ls):
                a, b = ends[i], ends[i + 1]
                self.graphs[d] = (node[a:b], mask[a:b])
                self.tr_counts[d] = dict.fromkeys(
                    np.unique(ca[a:b]).tolist(), 0)
        self.build_s += time.perf_counter() - t0


class _OnFirstUse(dict):
    """A dict whose missing locus d is filled by make(d) on first use."""

    def __init__(self, make):
        super().__init__()
        self._make = make

    def __missing__(self, d):
        self._make(d)
        return dict.__getitem__(self, d)


def _tab_to_arrs(prefix: str, tab, arrs: dict):
    arrs[f"{prefix}_nlev"] = np.int64(len(tab.levels))
    arrs[f"{prefix}_composite"] = np.int64(tab.composite)
    arrs[f"{prefix}_nval"] = np.int64(getattr(tab, "nval", 1))
    for i, (t, s) in enumerate(tab.levels):
        arrs[f"{prefix}_t{i}"] = t
        arrs[f"{prefix}_s{i}"] = np.int64(s)


def _tab_from_arrs(prefix: str, z):
    levels = [(z[f"{prefix}_t{i}"], int(z[f"{prefix}_s{i}"]))
              for i in range(int(z[f"{prefix}_nlev"]))]
    return dt.BucketTable(
        levels, composite=bool(int(z[f"{prefix}_composite"])),
        nval=int(z[f"{prefix}_nval"]) if f"{prefix}_nval" in z else 1)


def build_scale_rpgg_cached(nloci, kmers_per_locus, with_trfl=True,
                            cache_dir="build", **kw):
    """Disk-cached build_scale_rpgg: reruns load the flat tables from an
    npz instead of rebuilding them."""
    os.makedirs(cache_dir, exist_ok=True)
    seed = kw.get("seed", 9)
    # v4: rank-encoded annotation values (u32-safe at 1e9+ slots)
    path = os.path.join(
        cache_dir,
        f"scale_{nloci}_{kmers_per_locus}_{seed}_{int(with_trfl)}_v4.npz")
    if os.path.exists(path):
        t0 = time.time()
        z = np.load(path)
        trfl = _tab_from_arrs("trfl", z) if int(z["with_trfl"]) else None
        drp = DeviceRPGG(int(z["nloci"]), _tab_from_arrs("dbi", z),
                         z["vv"], trfl, None, z["locus_offsets"],
                         int(z["nslots"]),
                         member_tab=_tab_from_arrs("member", z))
        print(f"[scale-index] cache hit {path} "
              f"({time.time()-t0:.0f}s)", file=sys.stderr)
        return drp, z["seqs"]
    drp, seqs = build_scale_rpgg(nloci, kmers_per_locus,
                                 with_trfl=with_trfl, **kw)
    arrs = {"seqs": seqs, "nloci": np.int64(drp.nloci), "vv": drp.vv,
            "locus_offsets": drp.locus_offsets,
            "nslots": np.int64(drp.nslots),
            "with_trfl": np.int64(drp.trfl_tab is not None)}
    _tab_to_arrs("dbi", drp.dbi_tab, arrs)
    _tab_to_arrs("member", drp.member_tab, arrs)
    if drp.trfl_tab is not None:
        _tab_to_arrs("trfl", drp.trfl_tab, arrs)
    np.savez(path, **arrs)
    print(f"[scale-index] cached -> {path}", file=sys.stderr)
    return drp, seqs


def sample_read_batch(seqs, P: int, L: int, rng, frac_tr: float = 1.0,
                      flen: int = 400, read_len: int | None = None,
                      sub_rate: float = 0.0, with_loci: bool = False):
    """P read pairs in (2P, L) code rows: a frac_tr share are PE fragments
    of length ``flen`` from the locus pool (mate 2 reverse-complemented),
    each base substituted with probability ``sub_rate``; the rest uniform
    random background.  Reads are ``read_len`` bases (default L) in rows
    padded to L with 255.  Returns (codes, rlen), and with ``with_loci``
    also each pair's source locus ((P,) int64, -1 for background)."""
    nloci, Ltr = seqs.shape
    rl = L if read_len is None else read_len
    assert rl <= L and rl <= flen <= Ltr, (rl, L, flen, Ltr)
    codes = np.full((2 * P, L), 255, dtype=np.uint8)
    rlen = np.full(2 * P, rl, dtype=np.int32)
    is_tr = rng.random(P) < frac_tr
    t = np.flatnonzero(is_tr)
    li = rng.integers(0, nloci, len(t))
    beg = rng.integers(0, Ltr - flen + 1, len(t))
    frag = seqs[li[:, None], beg[:, None] + np.arange(flen)]
    if sub_rate > 0:
        sub = rng.random(frag.shape) < sub_rate
        shift = rng.integers(1, 4, frag.shape, dtype=np.uint8)
        frag = np.where(sub, (frag + shift) & 3, frag).astype(np.uint8)
    codes[2 * t, :rl] = frag[:, :rl]
    codes[2 * t + 1, :rl] = (3 - frag[:, flen - rl:])[:, ::-1]
    b = np.flatnonzero(~is_tr)
    codes[2 * b, :rl] = rng.integers(0, 4, (len(b), rl), dtype=np.uint8)
    codes[2 * b + 1, :rl] = rng.integers(0, 4, (len(b), rl), dtype=np.uint8)
    if with_loci:
        loci = np.full(P, -1, dtype=np.int64)
        loci[t] = li
        return codes, rlen, loci
    return codes, rlen


# ---------------------------------------------------------------------------
# The genome-wide index (~1.2e9 slots): the memory-lean chunked builder
# ---------------------------------------------------------------------------

LOCUS_BITS = 17                 # entries ride as (kmer << 17) | locus
_LOCUS_MASK = np.uint64((1 << LOCUS_BITS) - 1)


def full_locus_kmers(seqs: np.ndarray, kmers_per_locus: int,
                     k: int = 21) -> np.ndarray:
    """(n, kmers_per_locus) u64: each row's canonical k-mers (its interior
    windows), extracted in blocks of ~2e8 bases."""
    n, Ltr = seqs.shape
    kms = np.empty((n, kmers_per_locus), dtype=np.uint64)
    chunk = max(1, int(2e8 // Ltr))
    for s in range(0, n, chunk):
        e = min(s + chunk, n)
        pad = np.full((e - s, k - 1), 255, dtype=np.uint8)
        flat = np.concatenate([seqs[s:e], pad], axis=1).reshape(-1)
        flat = np.concatenate([flat, np.full(k - 1, 255, np.uint8)])
        allk = K.seq_to_kmers(flat, k, canonical=True)
        kms[s:e] = allk.reshape(e - s, Ltr + k - 1)[:, :kmers_per_locus]
    return kms


def full_entries(kms: np.ndarray, loci: np.ndarray, chunk: int):
    """Per-locus dedupe of ``kms`` (each row sorted in place), row i being
    locus loci[i]: -> (packed (kmer << 17) | locus u64, rank16 the entry's
    rank within its locus, offsets (n + 1) int64), entries in row order."""
    n = len(kms)
    kms.sort(axis=1)
    per_locus = np.empty(n, dtype=np.int64)
    offsets = np.zeros(n + 1, dtype=np.int64)
    for s in range(0, n, chunk):
        e = min(s + chunk, n)
        kb = kms[s:e]
        keep = np.ones(kb.shape, dtype=bool)
        keep[:, 1:] = kb[:, 1:] != kb[:, :-1]
        per_locus[s:e] = keep.sum(axis=1)
    np.cumsum(per_locus, out=offsets[1:])
    nslots = int(offsets[-1])
    packed = np.empty(nslots, dtype=np.uint64)
    rank16 = np.empty(nslots, dtype=np.uint16)
    for s in range(0, n, chunk):
        e = min(s + chunk, n)
        kb = kms[s:e]
        keep = np.ones(kb.shape, dtype=bool)
        keep[:, 1:] = kb[:, 1:] != kb[:, :-1]
        loc = np.broadcast_to(
            np.asarray(loci[s:e], dtype=np.uint64)[:, None], kb.shape)
        dst = slice(int(offsets[s]), int(offsets[e]))
        packed[dst] = (kb[keep] << np.uint64(LOCUS_BITS)) | loc[keep]
        rk = (keep.cumsum(axis=1) - 1).astype(np.uint16)
        rank16[dst] = rk[keep]
    return packed, rank16, offsets


def sort_entries(packed: np.ndarray, rank16: np.ndarray):
    """The entries sorted by (kmer, locus), rank16 following."""
    order = np.argsort(packed, kind="stable")
    return packed[order], rank16[order]


def group_entries(packed: np.ndarray):
    """Sorted entries -> (first (an entry opens its k-mer's group), gstart
    the groups' first entries, counts int32 their sizes, shared: size >
    1); the compares run in chunks so transients stay ~100 MB."""
    nslots = len(packed)
    first = np.empty(nslots, dtype=bool)
    first[0] = True
    CH = 100_000_000
    for s in range(1, nslots, CH):
        e = min(s + CH, nslots)
        first[s:e] = (packed[s:e] >> np.uint64(LOCUS_BITS)) != \
            (packed[s - 1:e - 1] >> np.uint64(LOCUS_BITS))
    gstart = np.flatnonzero(first)
    counts = np.diff(gstart, append=nslots).astype(np.int32)
    return first, gstart, counts, counts > 1


def vv_plane(packed, first, counts, shared):
    """The vv plane: [n, loci...] a shared group.  Entries of a group are
    contiguous and locus-ascending after the sort, so loci fill
    sequentially; destinations skip one size slot a group.  -> (vv u32,
    each shared group's vv offset, ent_shared: the entry's group is
    shared)."""
    ent_shared = np.repeat(shared, counts)
    loci_sh = (packed[ent_shared] & _LOCUS_MASK).astype(np.uint32)
    nse = len(loci_sh)
    nsg = int(shared.sum())
    g_of = (np.cumsum(first[ent_shared], dtype=np.int64) - 1)
    vv = np.empty(nse + nsg, dtype=np.uint32)
    dst = np.arange(nse, dtype=np.int64) + g_of + 1
    vv[dst] = loci_sh
    size_pos = dst[first[ent_shared]] - 1
    vv[size_pos] = counts[shared].astype(np.uint32)
    assert len(vv) < (1 << 31), "vv exceeds the u32 odd-val encoding"
    return vv, size_pos, ent_shared


def dbi_planes(packed, rank16, gstart, shared, vv_off_shared):
    """The dbi table's keys, vals (locus << 1, or (vv offset << 1) | 1
    for a shared k-mer) and second plane (a single-locus k-mer's
    annotation: (rank << 3) | ANN_TR)."""
    keys = (packed[gstart] >> np.uint64(LOCUS_BITS))
    loc_first = (packed[gstart] & _LOCUS_MASK).astype(np.uint32)
    vals = np.empty(len(gstart), dtype=np.uint32)
    vals[~shared] = loc_first[~shared] << 1
    vals[shared] = (vv_off_shared.astype(np.uint32) << 1) | 1
    ann = np.zeros(len(gstart), dtype=np.uint32)
    ann[~shared] = (rank16[gstart[~shared]].astype(np.uint32) << 3) \
        | ANN_TR
    return keys, vals, ann


def trfl_entries(packed, rank16, ent_shared):
    """The composite trfl table's entries (shared k-mers only): keys,
    values ((rank << 3) | ANN_TR) and loci."""
    tk = (packed[ent_shared] >> np.uint64(LOCUS_BITS))
    tl = (packed[ent_shared] & _LOCUS_MASK).astype(np.uint32)
    tv = (rank16[ent_shared].astype(np.uint32) << 3) | ANN_TR
    return tk, tv, tl


def build_full_tables(outdir: str, nloci: int = 80_000,
                      kmers_per_locus: int = 15_000, k: int = 21,
                      seed: int = 9, family_frac: float = 0.2,
                      verbose: bool = True) -> dict:
    """Builds the genome-wide index (~1.2e9 (kmer, locus) slots at the
    defaults, the reference's production RPGG size) into ``outdir``, as
    tools/make_scale_index.py build_full_tables does (same files, same
    bytes):

      * entries ride as ONE packed u64 plane ((kmer << 17) | locus: k = 21
        k-mers are 42 bits, loci 17), sorted once
      * per-locus ranks ride as u16 (the rank-encoded annotation values
        need no global-slot array)
      * group statistics stream in bounded chunks; every finished table
        level spills to <outdir>/*.npy at once and is freed

    Writes seqs.npy, dbi_t{i}.npy, trfl_t{i}.npy, vv.npy, offsets.npy and
    manifest.json; returns the manifest.  load_full_tables() mmaps it back
    as a DeviceRPGG."""
    import gc
    import json

    os.makedirs(outdir, exist_ok=True)

    def log(msg):
        if verbose:
            print(f"[full-index] {msg}", file=sys.stderr)

    assert nloci <= (1 << LOCUS_BITS), nloci
    Ltr = kmers_per_locus + k - 1
    t_all = t0 = time.time()
    seqs = scale_seqs(nloci, kmers_per_locus, family_frac, k, seed)
    np.save(os.path.join(outdir, "seqs.npy"), seqs)
    log(f"sequences {seqs.nbytes/1e9:.1f} GB in {time.time()-t0:.0f}s")

    t0 = time.time()
    kms = full_locus_kmers(seqs, kmers_per_locus, k)
    del seqs
    gc.collect()
    log(f"kmers extracted in {time.time()-t0:.0f}s")

    t0 = time.time()
    packed, rank16, offsets = full_entries(
        kms, np.arange(nloci), max(1, int(2e8 // Ltr)))
    nslots = int(offsets[-1])
    del kms
    gc.collect()
    log(f"{nslots/1e9:.3f}e9 slots packed in {time.time()-t0:.0f}s")

    t0 = time.time()
    packed, rank16 = sort_entries(packed, rank16)
    gc.collect()
    log(f"entry sort in {time.time()-t0:.0f}s")

    t0 = time.time()
    first, gstart, counts, shared = group_entries(packed)
    nkeys = len(gstart)
    log(f"{nkeys/1e6:.1f}M keys ({int(shared.sum())/1e6:.1f}M shared "
        f"groups) in {time.time()-t0:.0f}s")

    t0 = time.time()
    vv, vv_off_shared, ent_shared = vv_plane(packed, first, counts, shared)
    gc.collect()
    log(f"vv {len(vv)/1e6:.0f}M in {time.time()-t0:.0f}s")

    t0 = time.time()
    keys, vals, ann = dbi_planes(packed, rank16, gstart, shared,
                                 vv_off_shared)
    log(f"dbi planes in {time.time()-t0:.0f}s")

    manifest = dict(nloci=nloci, nslots=nslots, nkeys=nkeys,
                    kmers_per_locus=kmers_per_locus)

    def spill(prefix, tab):
        meta = []
        for i, (t, s) in enumerate(tab.levels):
            np.save(os.path.join(outdir, f"{prefix}_t{i}.npy"), t)
            meta.append((list(t.shape), int(s)))
        manifest[prefix] = dict(levels=meta, composite=tab.composite,
                                nval=tab.nval, nbytes=int(tab.nbytes))
        log(f"{prefix} table {tab.nbytes/1e9:.2f} GB "
            f"({len(tab.levels)} levels) spilled")

    t0 = time.time()
    dbi_tab = dt.build_bucket_table(keys, vals, vals2=ann)
    log(f"dbi table build in {time.time()-t0:.0f}s")
    spill("dbi", dbi_tab)
    del dbi_tab, keys, vals, ann, gstart, counts, first
    gc.collect()

    t0 = time.time()
    tk, tv, tl = trfl_entries(packed, rank16, ent_shared)
    del packed, rank16, ent_shared
    gc.collect()
    trfl_tab = dt.build_bucket_table(tk, tv, tl)
    log(f"trfl table build in {time.time()-t0:.0f}s")
    spill("trfl", trfl_tab)
    del trfl_tab, tk, tl, tv
    gc.collect()

    np.save(os.path.join(outdir, "vv.npy"), vv)
    np.save(os.path.join(outdir, "offsets.npy"), offsets)
    manifest["wall_s"] = int(time.time() - t_all)
    with open(os.path.join(outdir, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    log(f"TOTAL build wall {manifest['wall_s']}s")
    return manifest


def load_full_tables(outdir: str, mmap: bool = True):
    """build_full_tables() output as (DeviceRPGG, seqs, manifest).  With
    ``mmap`` (the default) the multi-GB levels stay disk-backed until read
    (DevTable.upload copies a large level through a pinned buffer chunk by
    chunk).  The index has no member table: the prefilter probes dbi."""
    import json

    with open(os.path.join(outdir, "manifest.json")) as f:
        manifest = json.load(f)
    mode = "r" if mmap else None

    def tab(prefix):
        m = manifest[prefix]
        levels = [
            (np.load(os.path.join(outdir, f"{prefix}_t{i}.npy"),
                     mmap_mode=mode), salt)
            for i, (_, salt) in enumerate(m["levels"])]
        return dt.BucketTable(levels, composite=m["composite"],
                              nval=m["nval"])

    drp = DeviceRPGG(
        int(manifest["nloci"]), tab("dbi"),
        np.load(os.path.join(outdir, "vv.npy"), mmap_mode=mode),
        tab("trfl"), None,
        np.load(os.path.join(outdir, "offsets.npy")),
        int(manifest["nslots"]), member_tab=None)
    seqs = np.load(os.path.join(outdir, "seqs.npy"), mmap_mode=mode)
    return drp, seqs, manifest
