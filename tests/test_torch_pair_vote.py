"""KC's plain version (pair_vote_plain) on pairs built by hand, whose
outputs are derived here by hand; the adversarial pair generator that
tests/test_torch_gpu.py holds KC against on the card; KC's mode boundary.

Torch only (no JAX): the plain version is held against the JAX vote in
test_torch_device_align.py.
"""

import numpy as np
import pytest
import torch

from danbing_tk_tpu_torch.engine import device_align as da

NAN32 = 0xFFFFFFFF
I64MAX = (1 << 63) - 1


def _vote(pairs, vv, E, cth, kf=None):
    """pairs: per pair (mate0, mate1), each a list of (kmer, val) entries
    (None: an unused entry), padded to one NKW."""
    NKW = max(len(m) for pr in pairs for m in pr)
    P = len(pairs)
    kmer = np.zeros((2 * P, NKW), np.int64)
    val = np.zeros((2 * P, NKW), np.int64)
    use = np.zeros((2 * P, NKW), bool)
    for p, pr in enumerate(pairs):
        for m, ents in enumerate(pr):
            for i, e in enumerate(ents):
                if e is not None:
                    kmer[2 * p + m, i], val[2 * p + m, i] = e
                    use[2 * p + m, i] = True
    kf = np.ones(P, bool) if kf is None else np.asarray(kf)
    vv = np.asarray(vv, np.uint32).view(np.int32)
    T = torch.from_numpy
    d, v, pk = da.pair_vote_plain(T(kmer), T(val), T(use), T(kf), T(vv), E,
                                  cth)
    return [(int(d[p]), bool(v[p]), int(pk[p])) for p in range(P)]


def even(kmer, locus):
    return (kmer, locus << 1)


def odd(kmer, vv_pos):
    return (kmer, (vv_pos << 1) | 1)


# pack bits: 0 referee, 1 unresolved tie, 2 expansion overflow, 3 test2-only
REF, TIE, OVF, T2 = 1, 2, 4, 8


def test_hand_built_pairs():
    # vv lists: [count, loci...] at positions 0, 3, 6, 9, 15, 19
    vv = [2, 20, 30,        # 0: {20, 30}
          2, 30, 20,        # 3: {30, 20}, the other order
          2, 10, 30,        # 6
          5, 1, 2, 3, 4, 5,  # 9: five loci
          3, 7, NAN32, 9,   # 15: a dead (NAN32) locus in the middle
          0]                # 19: an empty list
    ab = [even(1, 5), even(2, 5), even(3, 5), even(4, 5)]
    cases = [
        # (pair, E, cth, kf) -> (dst0, vote_pass, pack)
        # one locus, four runs in both mates: f = r = 4
        (((ab, ab), 8, 2, True), (5, True, 0)),
        # mate 1 empty: f = 4, r = 0 -> test2 only
        (((ab, [None] * 4), 8, 2, True), (5, True, REF | T2)),
        # the same run repeated: one run, f = 3, r = 2
        ((([even(9, 4)] * 3, [even(9, 4)] * 2), 8, 2, True),
         (4, True, 0)),
        # unresolved W-plane tie: loci 3 and 7 with 2 each (nm 1, nC = 2;
        # a W-plane run holds one candidate, never nC) -> dst0 the first
        # top locus, test2 only
        ((([even(1, 3), even(2, 3)], [even(4, 7), even(5, 7)]), 8, 1,
          True), (3, True, REF | TIE | T2)),
        # tie resolved at a lower nm level: locus 20 (two W-plane runs,
        # nm 1) against 10 and 30 (one vv run, nm 2), 2 each: m = 1 picks
        # 20, though 10 is the first top locus
        ((([even(1, 20), odd(7, 6)], [even(2, 20), odd(7, 6)]), 8, 1,
          True), (20, True, 0)),
        # tie resolved in scan order: one vv run holds both candidates, so
        # its first candidate (20) wins
        ((([odd(7, 0)], [odd(7, 0)]), 8, 1, True), (20, True, 0)),
        # the same loci from two runs listing them in opposite orders:
        # their first candidates differ -> unresolved, dst0 the first top
        ((([odd(7, 0)], [odd(8, 3)]), 8, 1, True),
         (20, True, REF | TIE)),
        # five loci, E = 3: total 5 > E overflows; the three kept loci
        # tie in one run, resolved to its first
        ((([odd(7, 9)], [odd(7, 9)]), 3, 1, True), (1, True, REF | OVF)),
        # total = E exactly: no overflow; total = E + 1: overflow
        ((([odd(7, 9)], [odd(7, 9)]), 5, 1, True), (1, True, 0)),
        ((([odd(7, 9)], [odd(7, 9)]), 4, 1, True), (1, True, REF | OVF)),
        # a dead locus: 7 and 9 get 1 each, and the dead event's count
        # runs into the last live segment (9) -> 9 alone on top, f = 2
        ((([odd(7, 15)], [None]), 8, 1, True), (9, True, REF | T2)),
        # an empty vv list: no event at all
        ((([odd(7, 19)], [odd(7, 19)]), 8, 1, True), (NAN32, False, 0)),
        # no used entry
        ((([None] * 3, [None] * 3), 8, 1, True), (NAN32, False, 0)),
        # pair_kf false: dst0 still voted, every flag off
        ((([odd(7, 0)], [odd(8, 3)]), 8, 1, False), (20, False, 0)),
        # INT64_MAX is the plain sort's filler, an unused entry; EMPTY (-1)
        # used is a k-mer like any other
        ((([(I64MAX, 6), (-1, 6)], [(-1, 6)]), 8, 1, True),
         (3, True, 0)),
        # the run's value is its first entry's (stable sort): kmer 5 is
        # locus 2 at entry 0, locus 9 later
        ((([(5, 4), (5, 18)], [(5, 18)]), 8, 1, True), (2, True, 0)),
    ]
    for (pair, E, cth, kf), want in cases:
        got = _vote([pair], vv, E, cth, [kf])[0]
        assert got == want, (pair, E, cth, kf, got, want)


def vote_cases(seed: int, P: int, NKW: int, E: int):
    """Adversarial KC inputs from a seed: (kmer, val, use, pair_kf, vv) as
    numpy arrays, pair p of kind p % 9: 0-2 random runs over a few k-mers
    and loci (values varying within a run, negative and INT64_MAX
    k-mers, dead NAN32 loci), 3 every entry one k-mer, 4 / 5 vv runs
    totalling E / E + 1, 6 one vv run longer than E, 7 no used entry, 8
    a designed tie (resolved at a lower nm level, in scan order, or left
    unresolved)."""
    rng = np.random.default_rng(seed)
    nl = 6
    lists, starts = [], []

    def add_list(loci):
        starts.append(sum(len(x) for x in lists))
        lists.append([len(loci)] + list(loci))
        return starts[-1]

    for n in (0, 1, 2, 3, 5, 9, 17, 40):
        loci = rng.integers(0, nl, n).tolist()
        if n > 4 and rng.random() < 0.5:
            loci[int(rng.integers(0, n))] = NAN32
        add_list(loci)
    rand_lists = list(starts)
    half = add_list(rng.integers(0, nl, E // 2).tolist())
    rest = add_list(rng.integers(0, nl, E - E // 2).tolist())
    rest1 = add_list(rng.integers(0, nl, E - E // 2 + 1).tolist())
    longl = add_list(rng.integers(0, nl, E + 5).tolist())
    ab = add_list([20, 30])
    ba = add_list([30, 20])
    tt = add_list([10, 30])
    vv = np.array([x for lst in lists for x in lst], np.uint32).view(
        np.int32)
    W = 2 * NKW
    kmer = np.zeros((P, W), np.int64)
    val = np.zeros((P, W), np.int64)
    use = np.zeros((P, W), bool)
    kf = rng.random(P) < 0.85
    special = np.array([-1, -7, I64MAX, 0], np.int64)

    def rand_val(n):
        v = rng.integers(0, nl, n) << 1
        oddm = rng.random(n) < 0.4
        v[oddm] = (np.array(rand_lists)[rng.integers(0, len(rand_lists),
                                                     oddm.sum())] << 1) | 1
        return v

    for p in range(P):
        kind = p % 9
        if kind <= 2:
            pool = rng.integers(0, 1 << 40, int(rng.integers(1, 12)))
            pool[rng.random(len(pool)) < 0.1] = rng.choice(special)
            kmer[p] = rng.choice(pool, W)
            pv = rand_val(len(pool))
            idx = np.searchsorted(np.sort(pool), kmer[p])
            val[p] = pv[np.argsort(pool)][np.clip(idx, 0, len(pool) - 1)]
            flip = rng.random(W) < 0.05          # a run's later value
            val[p][flip] = rand_val(int(flip.sum()))
            use[p] = rng.random(W) < np.repeat(rng.uniform(0.05, 1.0, 2),
                                               NKW)
        elif kind == 3:
            kmer[p] = int(rng.integers(0, 1 << 40))
            val[p] = rand_val(1)[0]
            use[p] = True
        elif kind in (4, 5, 6):
            k1, k2 = rng.integers(0, 1 << 40, 2)
            s2 = {4: rest, 5: rest1, 6: longl}[kind]
            kmer[p, :2] = (k1, k2) if kind != 6 else (k1, k1)
            val[p, :2] = ((half << 1) | 1, (s2 << 1) | 1)
            kmer[p, NKW] = k1
            val[p, NKW] = (half << 1) | 1
            use[p, [0, 1, NKW]] = True
            if kind == 6:
                val[p, :2] = (longl << 1) | 1
                val[p, NKW] = (longl << 1) | 1
        elif kind == 8:
            k = rng.integers(0, 1 << 40, 4)
            sub = int(rng.integers(0, 3))
            if sub == 0:    # 20 from W-plane runs (nm 1) vs 10, 30 (nm 2)
                kmer[p, [0, NKW]] = k[0], k[1]
                val[p, [0, NKW]] = 20 << 1
                kmer[p, [1, NKW + 1]] = k[2]
                val[p, [1, NKW + 1]] = (tt << 1) | 1
                use[p, [0, 1, NKW, NKW + 1]] = True
            elif sub == 1:  # one run holds both candidates
                kmer[p, [0, NKW]] = k[2]
                val[p, [0, NKW]] = (ab << 1) | 1
                use[p, [0, NKW]] = True
            else:           # two runs list them in opposite orders
                kmer[p, [0, NKW]] = k[2], k[3]
                val[p, [0, NKW]] = (ab << 1) | 1, (ba << 1) | 1
                use[p, [0, NKW]] = True
        # kind 7: no used entry
    return (kmer.reshape(2 * P, NKW), val.reshape(2 * P, NKW),
            use.reshape(2 * P, NKW), kf, vv)


def plain_on(case, E, cth=2):
    T = torch.from_numpy
    kmer, val, use, kf, vv = case
    return da.pair_vote_plain(T(kmer), T(val), T(use), T(kf), T(vv), E, cth)


@pytest.mark.parametrize("NKW,E,cth", [(140, 512, 20), (7, 16, 2)])
def test_vote_cases_cover_every_outcome(NKW, E, cth):
    """The generator reaches each referee bit, a resolved and an
    unresolved tie, no-entry pairs, E overflows and exact E totals."""
    P = 9 * 24
    case = vote_cases(3, P, NKW, E)
    dst0, vote, pack = plain_on(case, E, cth)
    kind = np.arange(P) % 9
    kf = case[3]
    pk = pack.numpy()
    for bit in (1, 2, 4, 8):
        assert ((pk & bit) != 0).any(), bit
    # no used entry: NAN32 and nothing flagged
    assert (dst0.numpy()[kind == 7] == NAN32).all()
    assert (pk[kind == 7] == 0).all()
    # total = E fits, E + 1 and a run longer than E overflow
    assert not (pk[kind == 4] & 4).any()
    assert ((pk[(kind == 5) | (kind == 6)] & 4) != 0)[
        kf[(kind == 5) | (kind == 6)]].all()
    # designed ties: resolved to 20 (lower level, scan order), or left
    # unresolved (the tie bit) with the first top locus
    tie = kind == 8
    d = dst0.numpy()[tie]
    t = (pk[tie] & 2) != 0
    assert (d == 20).all()
    assert t.any() and (~t).any()
    assert not (t & ~kf[tie]).any()


def test_vote_shape_modes():
    """The main path's E = 512 takes the 128-thread instance, the retry
    tier's E = 4096 the 512-thread shared-memory one (KC[large-E]), and an
    E past a block's shared memory the global workspace.  The boundaries
    are where kc_smem_bytes crosses a quarter of the limit and the limit
    less the static shared memory."""
    W = 280
    assert da.check_vote_shape(W, 512) == "shared"
    assert da.check_vote_shape(W, 4096) == "large-E"
    assert da.kc_smem_bytes(W, 4096) <= da.SMEM_LIMIT - da.KC_STATIC_BYTES
    E1 = max(E for E in range(1, 4096)
             if da.kc_smem_bytes(W, E) <= da.KC_SHARED_BYTES)
    assert da.check_vote_shape(W, E1) == "shared"
    assert da.check_vote_shape(W, E1 + 1) == "large-E"
    E2 = max(E for E in range(4096, 20000)
             if da.kc_smem_bytes(W, E) <= da.SMEM_LIMIT - da.KC_STATIC_BYTES)
    assert da.check_vote_shape(W, E2) == "large-E"
    assert da.check_vote_shape(W, E2 + 1) == "global"
    assert 1024 <= E1 < 2048 and 8192 < E2 < 16384
    assert da.kc_workspace_stride(W, E2 + 1) % 256 == 0
    # the layout's own arithmetic: 32,512 B at E = 512, 111,360 at 4096
    assert da.kc_smem_bytes(W, 512) == 32512
    assert da.kc_smem_bytes(W, 4096) == 111360
    with pytest.raises(ValueError, match="counters"):
        da.check_vote_shape(1 << 16, 8)
