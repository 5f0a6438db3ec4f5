"""KJ's plain version on seeded adversarial failure sites, a lane-by-lane
emulation of its kernel (csrc/site_scorer.cu), and the generator that
tests/test_torch_gpu.py holds the kernel against on the card.

* Sites (``kj_cases``): reads of a locus's sequence with one or two
  substitutions, insertions or deletions, an N hole past the failure, a
  NAN64 node, truncations leaving nkrem = 1, 2 or 3, and pad rows (nkrem
  = 0, every gate closed); loci of random sequence and tandem repeats of
  period 2-7 (whose chains of different read offsets meet on one k-mer),
  a fifth of the nodes with an extra out-edge (branching, and children
  that are no node); k = 17, 21 and 32, mes 1 and 2.
* The graph table is built with level 0 dense (lam = 7.5 keys a bucket),
  so keys sit in level 1 and misses on full rows read on.
* The emulation follows the kernel: the live chains compacted in rank
  order (one half of 32 lanes unless more than 32 live), the staging
  (slot (2 d + i) 32 + lane, ballot compaction, a round's steps staged
  while some lane's chain still passes), its staged probe with the level
  stop, and the lookahead replay of D steps, for D = 1 to 4; it equals
  score_site_np (the reference's serial loops) and score_sites_plain
  exactly, and makes exactly site_probes(ahead=D)'s probes (at D = 1 the
  serial early exit's).
  score_site_np equals the JAX package's copy.

The module imports torch and the port only (the card's machine has no
JAX).
"""

import os
import re

import numpy as np
import pytest
import torch

from danbing_tk_tpu_torch.index import device_table as dt
from danbing_tk_tpu_torch.ops import correct as cr

LAM = 7.5
M32 = 0xFFFFFFFF
M64 = (1 << 64) - 1
NAN64 = cr.NAN64
SRC = os.path.join(os.path.dirname(__file__), "..", "danbing_tk_tpu_torch",
                   "csrc", "site_scorer.cu")

# ---------------------------------------------------------------------------
# generator
# ---------------------------------------------------------------------------

KJ_MODES = 10


def _fwd(seq, k):
    """Forward 2-bit k-mers of a base list (NAN64 where a window holds an
    N, base 4)."""
    out, v, last_n = [], 0, -1
    mask = (1 << (2 * k)) - 1
    for i, b in enumerate(seq):
        if b > 3:
            last_n = i
            b = 0
        v = ((v << 2) | b) & mask
        if i >= k - 1:
            out.append(NAN64 if last_n > i - k else v)
    return out


def kj_cases(seed: int, B: int, k: int, nloci: int = 12) -> dict:
    """Seeded KJ inputs for B sites and the graph table they probe.

    Locus d's graph is the forward k-mers of its sequence (random, or for
    every third locus a tandem repeat of period 2 + d % 6), each node's
    mask the bits of the bases that follow it, a fifth of the nodes with
    one more random bit.  Site s (mode s % 10; the last B // 8 rows pad):
    a read from a random offset of its locus with, at read position p, 0
    a substitution, 1 an insertion, 2 a deletion, 3 two substitutions, 4
    an insertion and a substitution, 5 two deletions, 6 a substitution
    and an N three bases on, 7 a substitution with the read ending 1-3
    k-mers past the failure, 8 no edit, 9 a substitution with a NAN64
    node; ki = p - k + 1, the first k-mer holding the edit."""
    rng = np.random.default_rng([seed, B, k])
    span = 3 * k + 60
    seqs, mask = [], {}
    for d in range(nloci):
        if d % 3 == 2:
            unit = rng.integers(0, 4, 2 + d % 6).tolist()
            seq = (unit * span)[:span]
        else:
            seq = rng.integers(0, 4, span).tolist()
        seqs.append(seq)
        km = _fwd(seq, k)
        for j in range(len(km) - 1):
            key = (km[j], d)
            mask[key] = mask.get(key, 0) | (1 << (km[j + 1] & 3))
        mask[(km[-1], d)] = mask.get((km[-1], d), 0)
    for key in list(mask):
        if rng.random() < 0.2:
            mask[key] |= 1 << int(rng.integers(0, 4))
    keys = np.array([q for q, _ in mask], dtype=np.uint64)
    loci = np.array([d for _, d in mask], dtype=np.uint32)
    graph = dt.build_bucket_table(keys, np.array(list(mask.values()),
                                                 np.uint32), loci, lam=LAM)
    sites = []
    npad = B // 8
    for s in range(B - npad):
        d = int(rng.integers(0, nloci))
        mode = s % KJ_MODES
        rl = 2 * k + 8 + int(rng.integers(0, 12))
        o = int(rng.integers(0, span - rl - 4))
        read = list(seqs[d][o: o + rl + 4])
        p = int(rng.integers(k, k + 6))          # ki = p - k + 1 >= 1

        def sub(i):
            read[i] = (read[i] + int(rng.integers(1, 4))) % 4

        if mode in (0, 6, 7, 9):
            sub(p)
        elif mode == 1:
            read.insert(p, int(rng.integers(0, 4)))
        elif mode == 2:
            del read[p]
        elif mode == 3:
            sub(p)
            sub(p + int(rng.integers(1, 4)))
        elif mode == 4:
            read.insert(p, int(rng.integers(0, 4)))
            sub(p + 2)
        elif mode == 5:
            del read[p]
            del read[p]
        if mode == 6:
            read[p + 3] = 4
        read = read[:rl]
        kms = _fwd(read, k)
        ki = p - k + 1
        if mode == 7:
            kms = kms[: ki + int(rng.integers(1, 4))]
        if mode == 9:
            kms[ki - 1] = NAN64
        sites.append((kms, ki, d))
    w_lo, w_hi, nkrem, loc = cr.sites_to_batch(sites, k=k, B=B)
    return dict(graph=graph, w=cr.join_w(w_lo, w_hi), nkrem=nkrem, loc=loc,
                sites=sites, k=k, npad=npad)


def kj_args(case: dict, device) -> tuple:
    """score_sites' graph table, w, nkrem and loc on ``device``."""
    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return (dt.DevTable.upload(case["graph"], device), t(case["w"]),
            t(case["nkrem"]), t(case["loc"]))


def gbits_of(case: dict, locus: int):
    """score_site_np's graph probe of one locus (every level, no stop)."""
    tab = case["graph"]

    def gbits(km):
        f, v = dt.lookup_bucket_np(tab, np.array([km], np.uint64),
                                   np.array([locus], np.uint32))[:2]
        return bool(f[0]), int(v[0]) if f[0] else 0
    return gbits


# ---------------------------------------------------------------------------
# lane-by-lane emulation of the kernel
# ---------------------------------------------------------------------------

class StagedProbe:
    """kj_probe on a BucketTable: each staged key walked through the
    levels until a hit or a miss on a row with an empty slot.  Counts the
    keys probed, the rows read at each level and the hits past level 0."""

    def __init__(self, tab):
        self.levels = [(t.reshape(-1, 8, 4), s) for t, s in tab.levels]
        self.rows = [0] * len(self.levels)
        self.keys = 0
        self.hits_past_0 = 0
        self.read_on = 0

    def __call__(self, keys, loc):
        out = []
        for q in keys:
            self.keys += 1
            lo, hi = q & M32, q >> 32
            f, v = False, 0
            for lv, (t, salt) in enumerate(self.levels):
                self.rows[lv] += 1
                self.read_on += lv > 0
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
                    break                    # a row with room: stop
            out.append((f, v))
        return out


def kj_emulate(case: dict, mes: int, D: int):
    """site_scorer_kernel warp by warp, lane by lane: ((B, 62) counters,
    the probe, {site: [keys probed]})."""
    k = case["k"]
    rmask = (1 << (2 * (k - 1))) - 1
    w = case["w"].view(np.uint64)
    B = len(w)
    probe = StagedProbe(case["graph"])
    out = np.zeros((B, cr.NCHAINS), np.int32)
    probed = {}
    off = [0, 4, 8, 9, 25, 41, 57, 61, 62]
    joffs = [0, -1, 0, 1, 0, -1, 1, 1]
    jmos = [1, 0, 1, 2, 1, 0, 2, 2]
    for s in range(B):
        ws = [int(x) for x in w[s]]
        nk = int(case["nkrem"][s])
        lc = int(case["loc"][s]) & M32
        rnt = [x & 3 for x in ws[1:]]
        good = [ws[1 + j] != NAN64 and j < nk for j in range(k + 2)]
        if not any(good[:3]):
            continue
        keys_s = probed.setdefault(s, [])

        def run(slot_keys):
            """One staged probe: {slot: key} -> {slot: (found, the value's
            low 4 bits)}."""
            staged = sorted(slot_keys)
            keys_s.extend(slot_keys[p] for p in staged)
            return {p: (f, v & 15) for p, (f, v) in zip(
                staged, probe([slot_keys[p] for p in staged], lc))}

        node = ws[0]
        f, v = run({0: node})[0]
        nb = v if f else 0
        cbase = (node & rmask) << 2
        ch = {b: cbase | b for b in range(4) if (nb >> b) & 1}
        ca = run(ch)
        cb = [ca[b][1] if b in ca and ca[b][0] else 0 for b in range(4)]
        gk = {}
        for ln in range(16):
            b, b1 = ln >> 2, ln & 3
            if (cb[b] >> b1) & 1:
                gk[ln] = (((cbase | b) & rmask) << 2) | b1
        ga = run(gk)
        gb = [ga[ln][1] if ln in ga and ga[ln][0] else 0 for ln in range(32)]
        nts0 = nb & 15
        nts1 = 0
        for b in range(4):
            nts1 |= cb[b] & 15
        nts2 = 0
        for ln in range(16):
            nts2 |= gb[ln] & 15
        or1 = sum(1 << ln for ln in range(16) if gb[ln] & 15)
        r0, r1, r2 = rnt[0], rnt[1], rnt[2]
        g0, g1, g2 = good[0], good[1], good[2]
        m2 = mes >= 2
        gate1 = nk > 1 and (nts1 >> r1) & 1 and g1
        gates = [gate1,
                 (nts1 >> r0) & 1 and g0,
                 nk > 1 and (nts0 >> r1) & 1 and g1,
                 not gate1 and nk > 2 and (nts2 >> r2) & 1 and m2 and g2,
                 nk > 1 and (nts2 >> r1) & 1 and m2 and g1,
                 (nts2 >> r0) & 1 and m2 and g0,
                 nk > 2 and (nts1 >> r2) & 1 and m2 and g2,
                 nk > 2 and (nts0 >> r2) & 1 and m2 and g2]
        chains = []                          # index c = lane + 32 i
        for c in range(64):
            fam = max(f_ for f_ in range(8) if c >= off[f_]) if c < 62 \
                else 7
            idx = c - off[fam]
            nt0 = idx >> 2 if 3 <= fam <= 5 else idx
            or1m = (or1 >> (4 * (nt0 & 3))) & 15
            g3m = gb[idx if 3 <= fam <= 5 else 0] & 15
            x0 = (ws[1] & ~3 & M64) | (nt0 & 3)
            if fam in (2, 7):
                km, m, en = node, nts0, True
            elif 3 <= fam <= 5:
                nt1 = idx & 3
                km, m = ((x0 & rmask) << 2) | nt1, g3m
                en = (nts0 >> nt0) & 1 and (or1m >> nt1) & 1
            else:
                km, m, en = x0, or1m, (nts0 >> nt0) & 1
            if c < 62 and en and gates[fam]:
                chains.append(dict(km=km, m=m, cnt=0, joff=joffs[fam],
                                   jm=min(k + jmos[fam], nk), c=c,
                                   alive=True))
        # the live chains in rank (c) order: rank r in lane r % 32 of half
        # r // 32; one half unless more than 32 live
        halves = 2 if len(chains) > 32 else 1
        chains += [dict(alive=False)] * (64 - len(chains))
        t0 = 1
        while t0 <= k and any(x["alive"] for x in chains):
            slots = {}
            for i in range(halves):
                go = [x["alive"] for x in chains[32 * i: 32 * i + 32]]
                y = [x.get("km") for x in chains[32 * i: 32 * i + 32]]
                for d in range(D):
                    for ln in range(32):
                        x = chains[ln + 32 * i]
                        if not go[ln]:
                            continue
                        t = t0 + d
                        j = t + x["joff"]
                        go[ln] = t <= k and j < x["jm"] and good[j]
                        if go[ln]:
                            y[ln] = ((y[ln] & rmask) << 2) | rnt[j]
                        if d == 0:
                            go[ln] = go[ln] and bool(
                                (x["m"] >> (y[ln] & 3)) & 1)
                        if go[ln] and t < k and j + 1 < x["jm"] \
                                and good[j + 1]:
                            slots[(2 * d + i) * 32 + ln] = y[ln]
                    if not any(go):
                        break
            ans = run(slots)
            for i in range(halves):
                for ln in range(32):
                    x = chains[ln + 32 * i]
                    for d in range(D):
                        t = t0 + d
                        if not x["alive"] or t > k:
                            break
                        j = t + x["joff"]
                        if j >= x["jm"] or not good[j]:
                            x["alive"] = False
                            break
                        x["km"] = ((x["km"] & rmask) << 2) | rnt[j]
                        if not (x["m"] >> (x["km"] & 3)) & 1:
                            x["alive"] = False
                            break
                        x["cnt"] += 1
                        if t < k and j + 1 < x["jm"] and good[j + 1]:
                            f, v = ans[(2 * d + i) * 32 + ln]
                            if f:
                                x["m"] = v
            t0 += D
        for x in chains:
            if "c" in x:
                out[s, x["c"]] = x["cnt"]
    return out, probe, probed


def source_ahead() -> int:
    """KJ_AHEAD of csrc/site_scorer.cu."""
    return int(re.search(r"KJ_AHEAD = (\d+);", open(SRC).read()).group(1))


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k,mes", [(17, 2), (21, 1), (21, 2), (32, 2)])
def test_plain_matches_oracle(k, mes):
    """score_sites_plain equals score_site_np on every site (pad rows
    score 0), and the cases reach every kind the generator promises."""
    case = kj_cases(5, 96, k)
    got = cr.score_sites_plain(*kj_args(case, "cpu"), k, mes).numpy()
    for i, (kms, ki, d) in enumerate(case["sites"]):
        np.testing.assert_array_equal(
            got[i], cr.score_site_np(gbits_of(case, d), kms, ki, k, mes),
            err_msg=f"site {i}")
    assert not got[len(case["sites"]):].any()
    nk = case["nkrem"][: len(case["sites"])]
    assert {1, 2, 3} <= set(nk.tolist())
    assert got.any(1).sum() > len(case["sites"]) // 3
    assert len(case["graph"].levels) >= 2


@pytest.mark.parametrize("D", [1, 2, 3, 4])
def test_emulation_matches_plain(D):
    """The kernel's compaction, staging, staged probe and lookahead replay
    give score_sites_plain's counters at every lookahead D; D > 1 probes
    more keys in fewer rounds."""
    case = kj_cases(7, 96, 21)
    want = cr.score_sites_plain(*kj_args(case, "cpu"), 21, 2).numpy()
    got, probe, _ = kj_emulate(case, 2, D)
    np.testing.assert_array_equal(got, want)
    assert probe.read_on > 0 and probe.hits_past_0 > 0
    if D > 1:
        base = kj_emulate(case, 2, 1)[1]
        assert probe.keys > base.keys


@pytest.mark.parametrize("k,mes", [(17, 1), (32, 2)])
def test_emulation_shipped_config(k, mes):
    """The source's own lookahead at k = 17 and 32."""
    case = kj_cases(11, 64, k)
    want = cr.score_sites_plain(*kj_args(case, "cpu"), k, mes).numpy()
    np.testing.assert_array_equal(
        kj_emulate(case, mes, source_ahead())[0], want)


@pytest.mark.parametrize("D", [1, 2, 4])
def test_probes_are_site_probes(D):
    """The emulation at lookahead D probes exactly the keys
    site_probes(ahead=D) lists, site by site (at D = 1 the serial early
    exit's probes)."""
    case = kj_cases(3, 96, 21)
    args = kj_args(case, "cpu")
    site, q = cr.site_probes(*args, 21, 2, ahead=D)
    want = {}
    for s_, q_ in zip(site.tolist(), q.tolist()):
        want.setdefault(s_, []).append(q_ & M64)
    _, probe, probed = kj_emulate(case, 2, D)
    assert {s: sorted(v) for s, v in probed.items() if v} == \
        {s: sorted(v) for s, v in want.items()}
    assert probe.keys == len(q)


def test_score_site_np_matches_jax():
    """The port's score_site_np (the oracle above) equals the JAX
    package's on these sites."""
    from danbing_tk_tpu.ops import correct_jax as cj

    case = kj_cases(5, 48, 21)
    for kms, ki, d in case["sites"]:
        for mes in (1, 2):
            np.testing.assert_array_equal(
                cr.score_site_np(gbits_of(case, d), kms, ki, 21, mes),
                cj.score_site_np(gbits_of(case, d), kms, ki, 21, mes))
