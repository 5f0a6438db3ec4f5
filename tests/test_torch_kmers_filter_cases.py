"""KA's and KF's plain versions on seeded adversarial inputs, and those
generators, which tests/test_torch_gpu.py holds the kernels against on the
card.

* KA (extract_kmers_plain): N runs at read starts and ends, rlen from 0 to
  L, codes past rlen that are not 255, L = 150, 157 and 192 (not
  multiples of 16) and k = 1, 21 and 31, against the JAX package's
  extract_kmers_edges (k-mers compared as (hi << 32) | lo), at every
  nc / edges setting.
* KK (prefilter_sample_plain): ``kk_cases``, KA's rows with an N put
  inside a sampled window; tests/test_torch_prefilter_sample.py holds the
  plain version to the JAX package's prefilter_sample.  ``kkf_pairs``,
  golden pairs with short mates, Ns in sampled windows and dead pairs,
  for KK's fused launch (tests/test_torch_prefilter_fused.py).
* KF (read_filter_plain): reads whose k-mers are all equal, a k-mer
  repeated 256 and 257 times (the u8 count wraps), quality-mask holes,
  EMPTY and fully masked reads, dst0 = nloci, pairs that are not dev
  pairs, bait with and without QC and the quality mask, and QC alone,
  against a per-read Counter over the bait dict; the wrap case's bf is
  derived by hand.

Every comparison is exact.  The module imports torch and the port only
(the card's machine has no JAX); the JAX comparison imports it inside.
"""

import os
from collections import Counter

import numpy as np
import pytest
import torch

from danbing_tk_tpu_torch.engine import device_align as da
from danbing_tk_tpu_torch.index import device_table as dt
from danbing_tk_tpu_torch.ops import kmers as km

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
FLAGS = [dict(nc=nc, edges=e) for nc in (False, True) for e in (False, True)]


def ka_cases(seed: int, B: int, L: int, k: int):
    """Seeded (codes (B, L) u8, rlen (B,) i32) for KA: rlen runs over 0,
    1, k - 1, k, k + 1, L - 1 and L, then at random; rows by r % 6 start
    with an N run, end (at rlen) with one, have 2% Ns, all N, no N, or
    alternate N and base; half the rows keep random bases past rlen, the
    rest 255 there."""
    rng = np.random.default_rng([seed, B, L, k])
    codes = rng.integers(0, 4, (B, L)).astype(np.uint8)
    rlen = rng.integers(0, L + 1, B).astype(np.int32)
    fixed = [0, 1, max(k - 1, 0), k, min(k + 1, L), L - 1, L]
    rlen[:len(fixed)] = fixed
    for r in range(B):
        rl, mode = int(rlen[r]), r % 6
        n = int(rng.integers(1, k + 4))
        if mode == 0:
            codes[r, :n] = 255
        elif mode == 1:
            codes[r, max(rl - n, 0):rl] = 255
        elif mode == 2:
            codes[r, rng.random(L) < 0.02] = 255
        elif mode == 3 and r % 12 == 3:
            codes[r] = 255
        elif mode == 5:
            codes[r, ::int(rng.integers(2, k + 3))] = 255
        if r % 2:
            codes[r, rl:] = 255
    return codes, rlen


def kk_starts(rlen, L: int, k: int, nf: int) -> np.ndarray:
    """The prefilter's sampled window starts (kmers_np's rule), (B, nf)."""
    nk = np.maximum(rlen.astype(np.int64) - (k - 1), 0)
    S = nk // max(nf - 1, 1)
    starts = np.where(np.arange(nf) == nf - 1, (nk - 1)[:, None],
                      np.arange(nf) * S[:, None])
    return np.clip(starts, 0, L - k)


def kk_cases(seed: int, B: int, L: int, k: int, nf: int):
    """Seeded (codes, rlen) for KK: ka_cases' rows (rlen 0, 1, k - 1, k,
    k + 1, L - 1, L and random; N runs, all-N rows, bases past rlen), and
    in every third row one N placed inside a sampled window (its first,
    last or a middle position)."""
    codes, rlen = ka_cases(seed, B, L, k)
    rng = np.random.default_rng([seed, B, L, k, nf])
    starts = kk_starts(rlen, L, k, nf)
    for r in range(0, B, 3):
        j = int(rng.integers(nf))
        off = (0, k - 1, int(rng.integers(k)))[r // 3 % 3]
        codes[r, starts[r, j] + off] = 255
    return codes, rlen


def kkf_pairs(seed: int, P: int, L: int, nf: int, k: int = 21):
    """Seeded (codes (2P, L) u8, rlen (2P,) i32, live (P,) bool): golden
    pairs, and by p % 8: 1 a mate cut below k, 2 a 255 in one sampled
    window of mate 1, 3 a 255 in every sampled window of mate 0, 4 both
    mates from kk_cases, 5 mate 1 cut to a random length; every 7th pair
    dead.  KK's fused launch is held to its plain version on them."""
    seqs = [ln.strip() for ln in open(os.path.join(GOLDEN, "reads.fa"))
            if not ln.startswith(">")]
    rng = np.random.default_rng([seed, P, L, nf])
    codes, rlen = km.pack_reads(seqs[: 2 * P], L)
    adv_c, adv_r = kk_cases(seed, 2 * P, L, k, nf)
    for p in range(P):
        a, b = 2 * p, 2 * p + 1
        kind = p % 8
        if kind == 1:
            rlen[a + int(rng.integers(2))] = int(rng.integers(0, k))
        elif kind == 5:
            rlen[b] = int(rng.integers(0, rlen[b] + 1))
        elif kind == 4:
            codes[a:b + 1], rlen[a:b + 1] = adv_c[a:b + 1], adv_r[a:b + 1]
    starts = kk_starts(rlen, L, k, nf)
    for p in range(P):
        a, b = 2 * p, 2 * p + 1
        if p % 8 == 2:
            j = int(rng.integers(nf))
            codes[b, starts[b, j] + int(rng.integers(k))] = 255
        elif p % 8 == 3:
            codes[a, starts[a] + int(rng.integers(k))] = 255
    live = np.arange(P) % 7 != 6
    return codes, rlen, live


def _u64(lo, hi):
    lo = np.asarray(lo).astype(np.uint64)
    hi = np.asarray(hi).astype(np.uint64)
    return ((hi << np.uint64(32)) | lo).view(np.int64)


@pytest.mark.parametrize("L", [150, 157, 192])
@pytest.mark.parametrize("k", [1, 21, 31])
def test_ka_plain_matches_jax(L, k):
    from danbing_tk_tpu.ops.kmers_jax import extract_kmers_edges

    codes, rlen = ka_cases(3, 64, L, k)
    ref = {key: np.asarray(v) for key, v in
           extract_kmers_edges(codes, rlen, k).items()}
    want = dict(kmer=_u64(ref["klo"], ref["khi"]),
                nc=_u64(ref["nclo"], ref["nchi"]),
                edge=_u64(ref["elo"], ref["ehi"]),
                **{key: ref[key] for key in ("kvalid", "evalid", "nk",
                                              "any_valid")})
    assert want["kvalid"].any() and not want["kvalid"].all()
    for flags in FLAGS:
        got = km.extract_kmers(torch.from_numpy(codes),
                               torch.from_numpy(rlen), k, **flags)
        keys = {"kmer", "kvalid", "nk", "any_valid"} \
            | ({"nc"} if flags["nc"] else set()) \
            | ({"edge", "evalid"} if flags["edges"] else set())
        assert set(got) == keys, flags
        for key in keys:
            np.testing.assert_array_equal(got[key].numpy(), want[key],
                                          err_msg=f"{key} {flags}")


def kf_cases(seed: int, P: int, NKW: int, nloci: int = 24) -> dict:
    """Seeded KF inputs (numpy) for P pairs of NKW positions a read, and
    the bait dict {(k-mer, locus): (mi << 8) | ma} its table holds.
    Reads by r % 8: one k-mer at every position; a bait k-mer repeated
    256 times (count 0 after the u8 wrap) among others; one repeated 257
    times (count 1); k-mers of a small pool with a third of the positions
    masked; EMPTY everywhere; every position masked; the locus's bait
    k-mers with EMPTY runs at both ends; random k-mers of the locus.
    Pairs: a tenth at dst0 = nloci, 15% without vote_pass, 10% with the
    referee bit, a third of the loci failing QC."""
    rng = np.random.default_rng([seed, P, NKW])
    R = 2 * P
    pool = rng.integers(0, 1 << 62, (nloci, 40)).astype(np.int64)
    bait = {}
    for li in range(nloci):
        for km_ in pool[li, rng.random(40) < 0.6]:
            mi = int(rng.integers(0, 4))
            ma = 255 if rng.random() < 0.4 else mi + int(rng.integers(0, 3))
            bait[(int(km_), li)] = (mi << 8) | ma
    dst0 = rng.integers(0, nloci, P).astype(np.int64)
    dst0[rng.random(P) < 0.1] = nloci
    kmer = rng.integers(0, 1 << 62, (R, NKW)).astype(np.int64)
    qmask = rng.random((R, NKW)) >= 0.05
    for r in range(R):
        d = int(dst0[r // 2])
        lp = pool[d % nloci]
        mode = r % 8
        if mode == 0:
            kmer[r] = lp[int(rng.integers(40))]
        elif mode in (1, 2):
            n = min(256 if mode == 1 else 257, NKW)
            pos = rng.permutation(NKW)[:n]
            kmer[r, pos] = lp[int(rng.integers(40))]
        elif mode == 3:
            kmer[r] = lp[rng.integers(0, 6, NKW)]
            qmask[r, rng.random(NKW) < 1 / 3] = False
        elif mode == 4:
            kmer[r] = -1
        elif mode == 5:
            kmer[r] = lp[rng.integers(0, 40, NKW)]
            qmask[r] = False
        elif mode == 6:
            kmer[r] = lp[rng.integers(0, 40, NKW)]
            e = int(rng.integers(0, NKW // 4 + 1))
            kmer[r, :e] = -1
            kmer[r, NKW - e:] = -1
        else:
            kmer[r, rng.random(NKW) < 0.5] = lp[rng.integers(0, 40)]
    qc = (rng.random(nloci + 1) >= 1 / 3).astype(np.uint8)
    qc[-1] = 0
    pack = np.where(rng.random(P) < 0.1, 1, 0).astype(np.uint8) \
        | (rng.integers(0, 8, P).astype(np.uint8) << 1)
    return dict(kmer=kmer, qmask=qmask, dst0=dst0,
                vote_pass=rng.random(P) >= 0.15, pack=pack, qc=qc,
                bait=bait, nloci=nloci)


def kf_table(bait: dict, device) -> dt.DevTable:
    """The composite (k-mer, locus) -> (mi << 8) | ma table of a bait
    dict, on ``device``."""
    keys = np.array([k for k, _ in bait], dtype=np.int64).view(np.uint64)
    loci = np.array([loc for _, loc in bait], dtype=np.uint32)
    vals = np.array(list(bait.values()), dtype=np.uint32)
    return dt.DevTable.upload(dt.build_bucket_table(keys, vals, loci),
                              device)


def kf_args(case: dict, device, qc: bool, bait: bool, qmask: bool):
    """read_filter's arguments for a case on ``device``: QC, the bait table
    and the quality mask each on or off."""
    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return (t(case["kmer"]), t(case["qmask"]) if qmask else None,
            t(case["dst0"]), t(case["vote_pass"]), t(case["pack"]),
            t(case["qc"]) if qc else None,
            kf_table(case["bait"], device) if bait else None, case["nloci"])


def kf_oracle(case: dict, qc: bool, bait: bool, qmask: bool):
    """dev_pair, qc_drop, bf, bf_pair from a Counter per read."""
    P, nloci = len(case["dst0"]), case["nloci"]
    dev = np.zeros(P, bool)
    drop = np.zeros(P, bool)
    bf = np.zeros(2 * P, np.int32)
    for p in range(P):
        d = int(case["dst0"][p])
        vp = bool(case["vote_pass"][p]) and not case["pack"][p] & 1
        ok = not qc or case["qc"][min(d, nloci)] == 1
        dev[p], drop[p] = vp and ok, vp and not ok
        if not (bait and dev[p]):
            continue
        for r in (2 * p, 2 * p + 1):
            keys = case["kmer"][r]
            if qmask:
                keys = keys[case["qmask"][r]]
            for key, n in Counter(keys[keys != -1].tolist()).items():
                v = case["bait"].get((key, d))
                if v is not None and not (v >> 8) <= (n & 0xFF) <= (v & 0xFF):
                    bf[r] = 1
    return dev, drop, bf, bf.reshape(P, 2).any(1)


KF_MODES = [dict(qc=True, bait=True, qmask=True),
            dict(qc=True, bait=True, qmask=False),
            dict(qc=False, bait=True, qmask=True),
            dict(qc=True, bait=False, qmask=False)]


@pytest.mark.parametrize("NKW", [131, 300])
@pytest.mark.parametrize("mode", range(len(KF_MODES)))
def test_kf_plain_matches_counter(NKW, mode):
    flags = KF_MODES[mode]
    case = kf_cases(5, 48, NKW)
    got = da.read_filter_plain(*kf_args(case, "cpu", **flags))
    want = kf_oracle(case, **flags)
    for name, g, w in zip(("dev_pair", "qc_drop", "bf", "bf_pair"), got,
                          want):
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    if flags["bait"]:
        assert 0 < want[3].sum() < want[0].sum()
    else:
        assert not want[2].any() and want[1].any()


def test_kf_plain_u8_wrap_by_hand():
    """One pair at locus 0, NKW = 300: mate 0 carries X at 256 positions
    (the rest EMPTY), mate 1 X at 257 and Y at 43.  X's u8 counts are 0
    and 1.  With X at [1, 255]: mate 0 violates (0 < 1), and mate 1 does
    only where Y's window ends below 43.  With X at [0, 254] and Y at
    [0, 43] neither mate violates."""
    X, Y = 12345, 67890
    kmer = np.full((2, 300), -1, np.int64)
    kmer[0, :256] = X
    kmer[1, :257] = X
    kmer[1, 257:] = Y
    case = dict(kmer=kmer, qmask=np.ones_like(kmer, bool),
                dst0=np.zeros(1, np.int64), vote_pass=np.ones(1, bool),
                pack=np.zeros(1, np.uint8), qc=np.array([1, 0], np.uint8),
                nloci=1)
    for xwin, ywin, want in ((1 << 8 | 255, 42, [1, 1]),
                             (1 << 8 | 255, 43, [1, 0]),
                             (254, 43, [0, 0])):
        case["bait"] = {(X, 0): xwin, (Y, 0): ywin}
        got = da.read_filter_plain(*kf_args(case, "cpu", True, True, True))
        assert got[2].tolist() == want, (xwin, ywin)
        assert got[3].tolist() == [any(want)] and got[0].tolist() == [True]
        assert kf_oracle(case, True, True, True)[2].tolist() == want
