"""KE's and KG's plain versions on seeded adversarial inputs, lane-by-lane
emulations of their kernels, and those generators, which
tests/test_torch_gpu.py holds the kernels against on the card.

* KE (thread_walk_graph_plain: the graph probe at (nc, dst0), then
  thread_walk_plain): mates failing at position 0, at 31, 32 and 33 (chunk
  edges) and at their last in-read position; a homopolymer stall across a
  chunk edge; a missing edge bit whose next k-mer sits in the next chunk;
  an N mid-read; nk = 0, nk < NKW and nk >= NKW; tandem-repeat loci (a
  k-mer repeated in a chunk); clean mates in pairs that are not dev pairs
  and pairs with one clean mate; TR members at slots < 0, = nslots, >
  nslots and in runs of one slot.
* KG (novel_edges_plain): NE = 129, 130, 135 and 139; empty segments
  (si_ >= ei_ - 1, and the -1 of a mate that is not ok); rm = 1 on one
  mate; pairs not counted; evalid holes; edges repeated in a tile; edges
  of the read's locus, of another locus and of none; dst0 past the loci.
* Both tables are built with level 0 dense (lam = 7.5 keys a bucket), so
  keys sit in level 1 and misses on full rows read on; every key of a
  level l >= 1 of such a table meets a full row at every earlier level,
  which the kernels' level stop relies on.
* The emulations follow the kernels' chunk, ballot, shuffle, dedup and
  level-stop logic lane by lane (KE probes a repeated k-mer again, which
  gives the same answers) and equal the plain versions exactly; the
  plain versions equal the JAX package's K11 and K12 (its
  lookup_bucket_jax and walk), JAX imported inside the tests.

The module imports torch and the port only (the card's machine has no
JAX).
"""

import numpy as np
import pytest
import torch

from danbing_tk_tpu_torch.engine import device_align as da
from danbing_tk_tpu_torch.index import device_table as dt

K = 21
KMASK = (1 << (2 * K)) - 1
LAM = 7.5                 # level 0 dense: full rows, keys in level 1
M32 = 0xFFFFFFFF


def _kmers(seq: np.ndarray) -> np.ndarray:
    """Forward 2-bit k-mers (int64) of a base sequence, one per window."""
    v, out = 0, []
    for i, b in enumerate(seq.tolist()):
        v = ((v << 2) | b) & KMASK
        if i >= K - 1:
            out.append(v)
    return np.array(out, dtype=np.int64)


def _table(keys, loci, vals, lam=LAM) -> dt.BucketTable:
    return dt.build_bucket_table(
        np.asarray(keys, np.int64).view(np.uint64), np.asarray(vals, np.uint32),
        np.asarray(loci, np.uint32), lam=lam)


# ---------------------------------------------------------------------------
# generators
# ---------------------------------------------------------------------------

KE_MODES = 12


def ke_cases(seed: int, P: int, NKW: int, nloci: int = 24,
             nslots: int = 200) -> dict:
    """Seeded KE inputs (numpy) for P pairs of NKW positions a mate and
    the graph table they walk.  Locus d's graph is the forward k-mers of a
    random sequence (a period-7 repeat for every fourth locus), each node's
    mask the bit of its next base; a mate walks its pair's locus from a
    random offset.  Mates by mode (r + r // 12) % 12: clean; an N at 0;
    a node missing at 31, at 32; an N at 33; a node missing at the last
    in-read position; a homopolymer stall nc[32] = nc[31]; a missing edge
    bit 31 -> 32 (nc[32] a node of the locus off nc[31]'s mask); nk = 0;
    nk = NKW + 3; an N mid-read; nk short of NKW.  Positions past nk are
    EMPTY.  15% of the pairs are not dev pairs; tr_member is half set;
    slots run in blocks of 1-40 equal values, with -1, nslots and nslots
    + 2 sprinkled in."""
    rng = np.random.default_rng([seed, P, NKW])
    R = 2 * P
    span = NKW + 64
    node, mask, seqk = {}, {}, []
    for d in range(nloci):
        if d % 4 == 3:
            unit = rng.integers(0, 4, 7)
            seq = np.tile(unit, -(-(span + K) // 7))[: span + K]
        else:
            seq = rng.integers(0, 4, span + K)
        km = _kmers(seq)
        seqk.append(km)
        for j in range(len(km) - 1):
            mask[(int(km[j]), d)] = mask.get((int(km[j]), d), 0) \
                | (1 << int(km[j + 1] & 3))
        node.setdefault(d, set()).update(km.tolist())
    keys = [k_ for k_, _ in mask]
    loci = [d for _, d in mask]
    graph = _table(keys, loci, list(mask.values()))
    dst0 = rng.integers(0, nloci, P).astype(np.int64)
    nc = np.full((R, NKW), -1, np.int64)
    kvalid = np.zeros((R, NKW), bool)
    nk = np.full(R, NKW, np.int32)
    for r in range(R):
        d = int(dst0[r // 2])
        km = seqk[d]
        mode = (r + r // KE_MODES) % KE_MODES
        n = NKW
        if mode == 8:
            n = 0
        elif mode == 9:
            n = NKW + 3
        elif mode == 11:
            n = int(rng.integers(1, NKW + 1))
        nk[r] = n
        nin = min(n, NKW)
        o = int(rng.integers(0, len(km) - NKW))
        nc[r, :nin] = km[o: o + nin]
        kvalid[r, :nin] = True
        if nin == 0:
            continue

        def at(j):
            return min(j, nin - 1)

        if mode == 1:
            kvalid[r, 0], nc[r, 0] = False, -1
        elif mode in (2, 3, 5):
            j = at({2: 31, 3: 32, 5: nin - 1}[mode])
            nc[r, j] = int(rng.integers(0, 1 << 42)) | (1 << 41)
        elif mode == 4:
            j = at(33)
            kvalid[r, j], nc[r, j] = False, -1
        elif mode == 6 and nin > 32:
            nc[r, 32] = nc[r, 31]
        elif mode == 7 and nin > 32:
            off = [y for y in sorted(node[d])
                   if not (mask.get((int(nc[r, 31]), d), 0) >> (y & 3)) & 1]
            if off:
                nc[r, 32] = off[int(rng.integers(len(off)))]
        elif mode == 10:
            j = int(rng.integers(0, nin))
            kvalid[r, j], nc[r, j] = False, -1
    dev_pair = rng.random(P) >= 0.15
    tr_member = (rng.random((R, NKW)) < 0.5).astype(np.uint8)
    run = rng.integers(1, 41, (R, 1))
    slot = (rng.integers(0, nslots, (R, 1))
            + np.arange(NKW)[None, :] // run) % nslots
    odd = rng.random((R, NKW))
    slot[odd < 0.02] = -1
    slot[(odd >= 0.02) & (odd < 0.04)] = nslots
    slot[(odd >= 0.04) & (odd < 0.05)] = nslots + 2
    return dict(graph=graph, nc=nc, dst0=dst0, kvalid=kvalid, nk=nk,
                dev_pair=dev_pair, tr_member=tr_member,
                slot=slot.astype(np.int64), nslots=nslots)


def ke_args(case: dict, device) -> tuple:
    """thread_walk_graph's arguments after the state, on ``device``."""
    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return (dt.DevTable.upload(case["graph"], device), t(case["nc"]),
            t(case["dst0"]), t(case["kvalid"]), t(case["nk"]),
            t(case["dev_pair"]), t(case["tr_member"]), t(case["slot"]))


def ke_state(case: dict, device) -> dict:
    return {"counts": torch.zeros(case["nslots"] + 1, dtype=torch.int32,
                                  device=device)}


KG_MODES = 8


def kg_cases(seed: int, P: int, NE: int, nloci: int = 24) -> dict:
    """Seeded KG inputs (numpy) for P pairs of NE edge positions a read and
    the tre table.  Locus d holds 120 random (k+1)-mer edges.  Reads by
    mode (r + r // 8) % 8: the locus's own edges; own, other loci's and
    random edges mixed; a tile-periodic mix (period 5 of own edges, 3 of
    random ones: repeats in every tile); si_ >= ei_ - 1; rm = 1; a third of
    evalid cleared; si_ = ei_ = -1 (not ok); the segment [10, NE - 6).
    Otherwise si_ = 0 and ei_ = NE + 1 (the whole plane), a tenth past it.
    A fifth of the pairs are not counted, a tenth have dst0 = nloci."""
    rng = np.random.default_rng([seed, P, NE])
    R = 2 * P
    own = rng.integers(0, 1 << 44, (nloci, 120)).astype(np.int64)
    tre = _table(own.reshape(-1), np.repeat(np.arange(nloci), 120),
                 np.ones(own.size))
    dst0 = rng.integers(0, nloci, P).astype(np.int64)
    dst0[rng.random(P) < 0.1] = nloci
    edge = rng.integers(0, 1 << 44, (R, NE)).astype(np.int64)
    evalid = rng.random((R, NE)) >= 0.03
    si_ = np.zeros(R, np.int32)
    ei_ = np.where(rng.random(R) < 0.1, NE + 4, NE + 1).astype(np.int32)
    rm = np.zeros(R, np.int32)
    for r in range(R):
        d = int(dst0[r // 2]) % nloci
        mode = (r + r // KG_MODES) % KG_MODES
        if mode == 0:
            edge[r] = own[d, rng.integers(0, 120, NE)]
        elif mode == 1:
            u = rng.random(NE)
            edge[r, u < 0.5] = own[d, rng.integers(0, 120, (u < 0.5).sum())]
            o = (u >= 0.5) & (u < 0.75)
            edge[r, o] = own[rng.integers(0, nloci, o.sum()),
                             rng.integers(0, 120, o.sum())]
        elif mode == 2:
            pos = np.arange(NE)
            a, b = own[d, rng.integers(0, 120, 5)], edge[r, :3].copy()
            edge[r] = np.where(pos % 2 == 0, a[pos % 5], b[pos % 3])
        elif mode == 3:
            si_[r] = int(rng.integers(0, NE))
            ei_[r] = si_[r] + int(rng.integers(-3, 2))
        elif mode == 4:
            rm[r] = 1
            edge[r] = own[d, rng.integers(0, 120, NE)]
        elif mode == 5:
            edge[r] = own[d, rng.integers(0, 120, NE)]
            evalid[r, rng.random(NE) < 1 / 3] = False
        elif mode == 6:
            si_[r] = ei_[r] = -1
        else:
            si_[r], ei_[r] = 10, NE - 5
            edge[r, ::2] = own[d, rng.integers(0, 120, len(edge[r, ::2]))]
    edge[~evalid] = -1
    counted = rng.random(P) >= 0.2
    return dict(tre=tre, edge=edge, evalid=evalid, si_=si_, ei_=ei_, rm=rm,
                counted=counted, dst0=dst0)


def kg_args(case: dict, device) -> tuple:
    """novel_edges' arguments on ``device``."""
    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return tuple(t(case[x]) for x in ("edge", "evalid", "si_", "ei_", "rm",
                                      "counted", "dst0")) + (
        dt.DevTable.upload(case["tre"], device),)


# ---------------------------------------------------------------------------
# lane-by-lane emulations of the kernels (csrc/tile_probe.cuh,
# csrc/thread_walk.cu, csrc/novel_edges.cu)
# ---------------------------------------------------------------------------

class TileProbe:
    """dtk_tile_probe on a BucketTable: the active lanes' keys deduplicated
    (the lowest lane of a key probes it), each unique key walked through
    the levels until a hit or a miss on a row with an empty slot.  Counts
    the rows read at each level and the reads past a miss on a full
    row."""

    def __init__(self, tab: dt.BucketTable):
        self.levels = [(t.reshape(-1, 8, 4), s) for t, s in tab.levels]
        self.rows = [0] * len(self.levels)
        self.read_on = 0
        self.hits_past_0 = 0

    def __call__(self, act, key, loc):
        lead = [-1] * 32
        for ln in range(32):
            if act[ln]:
                lead[ln] = next(m for m in range(32)
                                if act[m] and key[m] == key[ln])
        uniq = [ln for ln in range(32) if act[ln] and lead[ln] == ln]
        ans = {}
        for ln in uniq:
            q = int(key[ln]) & 0xFFFFFFFFFFFFFFFF
            lo, hi = q & M32, q >> 32
            f, v = False, 0
            for lv, (t, salt) in enumerate(self.levels):
                if lv > 0:
                    self.read_on += 1
                self.rows[lv] += 1
                b = int(dt._salted_hash_np(
                    np.array([lo], np.uint32), np.array([hi], np.uint32),
                    np.array([loc], np.uint32), salt)[0]
                        & np.uint32(t.shape[0] - 1))
                row = t[b]
                m = (row[:, 0] == lo) & (row[:, 1] == hi) & (row[:, 2] == loc)
                if m.any():
                    f, v = True, int(row[m, 3].max())
                    self.hits_past_0 += lv > 0
                    break
                if not ((row[:, 0] & row[:, 1]) != M32).all():
                    break                        # a row with room: stop
            ans[ln] = (f, v)
        found = [act[ln] and ans[lead[ln]][0] for ln in range(32)]
        val = [ans[lead[ln]][1] if found[ln] else 0 for ln in range(32)]
        return found, val


def ke_emulate(case: dict):
    """thread_walk_graph_kernel lane by lane: (clean, clean_pair, counts,
    probe)."""
    nc, kvalid, nk = case["nc"], case["kvalid"], case["nk"]
    dev_pair, tr_member, slot = (case["dev_pair"], case["tr_member"],
                                 case["slot"])
    nslots = case["nslots"]
    R, NKW = nc.shape
    probe = TileProbe(case["graph"])
    clean = np.zeros(R, bool)
    lanes = np.arange(32)
    for r in range(R):
        p, n = r // 2, int(nk[r])
        if not (dev_pair[p] and n > 0):
            continue
        nin = min(n, NKW)
        loc = int(case["dst0"][p]) & M32
        ok, carry = True, 0

        def load(c0):
            j = c0 + lanes
            inr = j < nin
            x = np.where(inr, nc[r, np.minimum(j, NKW - 1)], 0)
            kv = inr & kvalid[r, np.minimum(j, NKW - 1)]
            return inr, x, kv

        inr, x, kv = load(0)
        c0 = 0
        while c0 < nin and ok:
            j = c0 + lanes
            inr_n, xn, kv_n = load(c0 + 32)
            prv = np.concatenate([[carry], x[:-1]])      # __shfl_up
            nxt = np.concatenate([x[1:], [xn[0]]])       # __shfl_down
            carry = int(x[31])
            cheap = inr & (~kv | ((j > 0) & (x == prv)))
            fc = int(np.argmax(cheap)) if cheap.any() else 32
            on = inr & (lanes < fc)
            gf, gm = probe(on.tolist(), x.tolist(), loc)
            gf, gm = np.array(gf), np.array(gm, np.int64)
            bad = cheap | (on & (~gf | ((j + 1 < nin)
                                        & (((gm >> (nxt & 3)) & 1) == 0))))
            ok = not bad.any()
            inr, x, kv = inr_n, xn, kv_n
            c0 += 32
        clean[r] = ok
    pair = clean.reshape(-1, 2).all(1)
    counts = np.zeros(nslots + 1, np.int64)
    trash = 0
    for r in range(R):
        n = int(nk[r])
        if not pair[r // 2]:
            trash += NKW
            continue
        nin = min(n, NKW)
        trash += NKW - nin
        for c0 in range(0, nin, 32):
            j = c0 + lanes
            inj = j < nin
            mem = inj & (tr_member[r, np.minimum(j, NKW - 1)] != 0)
            s = np.where(mem, slot[r, np.minimum(j, NKW - 1)], 0)
            add = mem & (s >= 0) & (s < nslots)
            for v in np.unique(s[add]):              # once per slot
                counts[v] += int((add & (s == v)).sum())
            trash += int((inj & (~mem | (s == nslots))).sum())
    counts[nslots] += trash
    return clean, pair, counts & M32, probe


def kg_emulate(case: dict):
    """novel_edges_kernel lane by lane: (packed bytes, probe)."""
    edge, evalid = case["edge"], case["evalid"]
    R, NE = edge.shape
    NB = (NE + 7) // 8
    out = np.zeros((R, NB), np.uint8)
    probe = TileProbe(case["tre"])
    lanes = np.arange(32)
    for r in range(R):
        p = r // 2
        act = bool(case["counted"][p]) and case["rm"][r] == 0
        lo = max(int(case["si_"][r]), 0) if act else 0
        hi = min(int(case["ei_"][r]) - 1, NE) if act else 0
        hi = max(hi, lo)
        loc = int(case["dst0"][p]) & M32 if act else 0
        for base in range(0, NE, 32):
            m = 0
            if base + 32 > lo and base < hi:
                pos = base + lanes
                inseg = (pos >= lo) & (pos < hi)
                on = inseg & evalid[r, np.minimum(pos, NE - 1)]
                e = np.where(on, edge[r, np.minimum(pos, NE - 1)], 0)
                found, _ = probe(on.tolist(), e.tolist(), loc)
                nov = on & ~np.array(found)
                m = int(sum(1 << int(ln) for ln in lanes[nov]))
            brev = int(f"{m:032b}"[::-1], 2)
            for ln in range(4):
                byte = base // 8 + ln
                if byte < NB:
                    out[r, byte] = (brev >> (24 - 8 * ln)) & 0xFF
    return out, probe


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("NKW", [31, 33, 140, 300])
def test_ke_emulation_matches_plain(NKW):
    case = ke_cases(7, 48, NKW)
    st = ke_state(case, "cpu")
    clean, pair = da.thread_walk_graph(st, *ke_args(case, "cpu"))
    want = da.thread_walk_graph_plain(ke_state(case, "cpu"),
                                      *ke_args(case, "cpu"))
    assert torch.equal(clean, want[0]) and torch.equal(pair, want[1])
    e_clean, e_pair, e_counts, probe = ke_emulate(case)
    np.testing.assert_array_equal(clean.numpy(), e_clean)
    np.testing.assert_array_equal(pair.numpy(), e_pair)
    np.testing.assert_array_equal(st["counts"].numpy().view(np.uint32),
                                  e_counts.astype(np.uint32))
    # every kind of verdict occurs, and the probe reads past level 0
    assert 0 < e_clean.sum() < case["dev_pair"].sum() * 2
    assert e_pair.any() and (e_clean.reshape(-1, 2).sum(1) == 1).any()
    assert (e_clean.reshape(-1, 2).all(1) & ~case["dev_pair"]).sum() == 0
    assert probe.read_on > 0 and probe.hits_past_0 > 0


@pytest.mark.parametrize("NE", [129, 130, 135, 139])
def test_kg_emulation_matches_plain(NE):
    case = kg_cases(7, 40, NE)
    got = da.novel_edges(*kg_args(case, "cpu"))
    assert torch.equal(got, da.novel_edges_plain(*kg_args(case, "cpu")))
    want, probe = kg_emulate(case)
    np.testing.assert_array_equal(got.numpy(), want)
    nov = np.unpackbits(want, axis=1)[:, :NE]
    assert 0 < nov.sum() < case["evalid"].sum()
    assert not np.unpackbits(want, axis=1)[:, NE:].any()
    assert probe.read_on > 0 and probe.hits_past_0 > 0


@pytest.mark.parametrize("kind", ["graph", "tre"])
def test_level_stop_invariant(kind):
    """In a composite table built with level 0 dense, every key of level
    l >= 1 meets a full row at every earlier level (so a query that misses
    a row with an empty slot is in no later level), and there are such
    keys."""
    tab = (ke_cases(3, 16, 140)["graph"] if kind == "graph"
           else kg_cases(3, 16, 139)["tre"])
    assert len(tab.levels) >= 2
    n_deep = 0
    for lv in range(1, len(tab.levels)):
        rows = tab.levels[lv][0].reshape(-1, 8, 4)
        keys = rows[(rows[:, :, 0] & rows[:, :, 1]) != M32]
        n_deep += len(keys)
        for t, salt in tab.levels[:lv]:
            b = dt._salted_hash_np(keys[:, 0], keys[:, 1], keys[:, 2],
                                   salt) & np.uint32(t.shape[0] - 1)
            r = t.reshape(-1, 8, 4)[b]
            assert ((r[:, :, 0] & r[:, :, 1]) != M32).all()
    assert n_deep > 0


def _jax_table_args(tab):
    import jax.numpy as jnp

    return [(jnp.asarray(t), s) for t, s in tab.levels]


def test_ke_plain_matches_jax():
    """thread_walk_graph_plain against the JAX K12 block
    (danbing_tk_tpu/engine/device_align.py: lookup_bucket_jax on the graph
    table at (nc, dst0), the walk masks, the counts scatter).  Slots are
    kept >= 0: the JAX step's slots are never negative."""
    import jax.numpy as jnp

    from danbing_tk_tpu.index import device_table as jdt

    case = ke_cases(11, 64, 140)
    case["slot"] = np.where(case["slot"] < 0, 5, case["slot"])
    st = ke_state(case, "cpu")
    clean, pair = da.thread_walk_graph_plain(st, *ke_args(case, "cpu"))

    nc, nk = case["nc"], case["nk"]
    P, NKW = len(case["dst0"]), nc.shape[1]
    nclo = jnp.asarray((nc & M32).astype(np.uint32))
    nchi = jnp.asarray(((nc >> 32) & M32).astype(np.uint32))
    q_loc = jnp.asarray(np.repeat(case["dst0"], 2)[:, None].repeat(
        NKW, 1).astype(np.uint32))
    gfound, gmask, _ = jdt.lookup_bucket_jax(
        case["graph"], nclo, nchi, q_loc=q_loc,
        levels_dev=_jax_table_args(case["graph"]))
    kvalid, nkj = jnp.asarray(case["kvalid"]), jnp.asarray(nk)
    dev_pair = jnp.asarray(case["dev_pair"])
    pos = jnp.arange(NKW, dtype=jnp.int32)[None, :]
    in_read = pos < nkj[:, None]
    no_n = (kvalid | ~in_read).all(axis=-1)
    same_prev = ((nclo[:, 1:] == nclo[:, :-1])
                 & (nchi[:, 1:] == nchi[:, :-1]) & in_read[:, 1:])
    no_homo = ~(same_prev.any(axis=-1))
    nb = (nclo & 3).astype(jnp.uint32)
    trans_ok = gfound[:, :-1] & (((gmask[:, :-1] >> nb[:, 1:]) & 1) == 1)
    trans_ok = trans_ok | ~in_read[:, 1:]
    node_ok = gfound | ~in_read
    jclean = (no_n & no_homo & trans_ok.all(axis=-1) & node_ok.all(axis=-1)
              & (nkj > 0) & dev_pair.repeat(2))
    jpair = jclean.reshape(P, 2).all(axis=1)
    thr_dev = dev_pair & jpair
    do_count = (jnp.asarray(case["tr_member"]) != 0) & in_read \
        & thr_dev.repeat(2)[:, None]
    cslot = jnp.where(do_count, jnp.asarray(case["slot"]), case["nslots"])
    counts = jnp.zeros(case["nslots"] + 1, jnp.uint32).at[
        cslot.reshape(-1)].add(1, mode="drop")
    np.testing.assert_array_equal(clean.numpy(), np.asarray(jclean))
    np.testing.assert_array_equal(pair.numpy(), np.asarray(jpair))
    np.testing.assert_array_equal(st["counts"].numpy().view(np.uint32),
                                  np.asarray(counts))
    assert 0 < int(np.asarray(jpair).sum()) < P


def test_kg_plain_matches_jax():
    """novel_edges_plain against the JAX K11 block
    (danbing_tk_tpu/engine/device_align.py: lookup_bucket_jax on the tre
    table at (edge, dst0), the novel mask and jnp.packbits)."""
    import jax.numpy as jnp

    from danbing_tk_tpu.index import device_table as jdt

    for NE in (130, 139):
        case = kg_cases(11, 48, NE)
        got = da.novel_edges_plain(*kg_args(case, "cpu"))
        e = case["edge"]
        q_loc = np.repeat(case["dst0"], 2)[:, None].repeat(NE, 1)
        efound, _, _ = jdt.lookup_bucket_jax(
            case["tre"], jnp.asarray((e & M32).astype(np.uint32)),
            jnp.asarray(((e >> 32) & M32).astype(np.uint32)),
            q_loc=jnp.asarray(q_loc.astype(np.uint32)),
            levels_dev=_jax_table_args(case["tre"]))
        si_, ei_ = jnp.asarray(case["si_"]), jnp.asarray(case["ei_"])
        rm = jnp.asarray(case["rm"])
        pos_e = jnp.arange(NE, dtype=jnp.int32)[None, :]
        in_seg = (pos_e >= si_[:, None]) & (pos_e < (ei_ - 1)[:, None])
        novel = (~efound) & jnp.asarray(case["evalid"]) & in_seg \
            & (rm == 0)[:, None]
        novel = novel & jnp.asarray(case["counted"]).repeat(2)[:, None]
        want = np.asarray(jnp.packbits(novel, axis=-1))
        np.testing.assert_array_equal(got.numpy(), want)
        assert want.any()
