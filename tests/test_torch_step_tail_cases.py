"""KL's, KL[decide]'s and KM's plain versions on seeded adversarial inputs,
each against an emulation of its kernel, and those generators, which
tests/test_torch_gpu.py holds the kernels against on the card.

* KL (pair_filter_plain): ``kl_cases``, pairs whose mates have nk = 0, 1,
  nf - 1, NKW and past NKW, found counts at cth - 1 and cth after the
  kvalid mask, every position found, a mate without a valid k-mer and
  dead pairs; NKW = 1, 2, 31, 32, 33, 140 and 300 (ballot words whose
  mate boundary falls inside a word, on it, or past one word); nf = 0,
  1, 2, 4, 5 and 40 (more samples than a warp's lanes), nmf = 0, 1, nf
  and nf + 1 and negative.  The emulation is a pair's positions in
  ballot words of 32 (the kernel's first design, a warp a pair): the
  mates' counts by popc under the mate mask, the sampled positions read
  back from the words, the use plane from them;
  tests/test_torch_pair_filter_staged.py emulates the kernel's chunk
  design.
* KL[decide] (prefilter_decide): ``kld_cases``, each read's hits (the
  valid found samples of (2P, nf) planes), nonshort as bool or as the
  sampler's nk, short mates and dead pairs, nf = 1, 4 and 17.
* KM (step_tail_plain): ``km_cases``, random pair planes (sub_drop within
  nonshort), kf, rm and bf beyond 0 and 1, dst0 up to NAN32, with and
  without clean_pair (threading), an odd pair count.  The emulation
  follows csrc/step_tail.cuh as KD and KE run it: a thread a pair, the
  nine counters summed by blocks of 4 pairs, then over the blocks
  (tests/test_torch_pair_filter_staged.py holds the fused tails).

Every comparison is exact.  The module imports torch and the port only
(the card's machine has no JAX).
"""

import numpy as np
import pytest
import torch

from danbing_tk_tpu_torch.engine import device_align as da

NAN32 = 0xFFFFFFFF


def kl_cases(seed: int, P: int, NKW: int, nf: int, cth: int) -> dict:
    """Seeded KL inputs: found and kvalid (2P, NKW) bool, nk (2P,) int32,
    any_valid (2P,) bool, live (P,) bool.  By p % 8: 0 random planes and
    nk in [0, NKW + 2]; 1 a mate with nk = 0; 2 nk = 1; 3 nk = nf - 1;
    4 mate 0 with cth - 1 and mate 1 with cth positions found, or both
    with cth - 1 (kvalid all set, nk = NKW and its last position found;
    as far as NKW allows); 5 every position found and valid; 6 a mate
    without a valid k-mer; 7 dead."""
    rng = np.random.default_rng([seed, P, NKW, nf, cth])
    R = 2 * P
    found = rng.random((R, NKW)) < rng.random((R, 1))
    kvalid = rng.random((R, NKW)) < 0.9
    nk = rng.integers(0, NKW + 3, R).astype(np.int32)
    any_valid = np.ones(R, bool)
    live = np.ones(P, bool)
    for p in range(P):
        a, b = 2 * p, 2 * p + 1
        kind = p % 8
        if kind == 1:
            nk[a + int(rng.integers(2))] = 0
        elif kind == 2:
            nk[a:b + 1] = 1
        elif kind == 3:
            nk[a:b + 1] = max(nf - 1, 0)
        elif kind == 4:
            # every other such pair has both mates at cth - 1; the last
            # position (the last sample at nk = NKW) is found
            kvalid[a:b + 1] = True
            nk[a:b + 1] = NKW
            n1 = cth if p // 8 % 2 == 0 else cth - 1
            for r, n in ((a, cth - 1), (b, n1)):
                n = min(max(n, 0), NKW)
                found[r] = False
                if n:
                    found[r, NKW - 1] = True
                    found[r, rng.choice(NKW - 1, n - 1, replace=False)] = True
        elif kind == 5:
            found[a:b + 1] = kvalid[a:b + 1] = True
            nk[a:b + 1] = NKW
        elif kind == 6:
            any_valid[a + int(rng.integers(2))] = False
        elif kind == 7:
            live[p] = False
    return dict(found=found, kvalid=kvalid, nk=nk, any_valid=any_valid,
                live=live)


def kl_args(case: dict, device, nf: int, nmf: int, cth: int) -> tuple:
    """pair_filter's arguments from a kl_cases dict, on ``device``."""
    t = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
         for k, v in case.items()}
    return (t["found"], t["kvalid"], t["nk"], t["any_valid"], t["live"], nf,
            nmf, cth)


def kl_emulated(case: dict, nf: int, nmf: int, cth: int) -> tuple:
    """KL's arithmetic a pair at a time over ballot words of 32, in
    Python ints."""
    found, kvalid, nk = case["found"], case["kvalid"], case["nk"]
    R, NKW = found.shape
    P = R // 2
    nw = (2 * NKW + 31) // 32
    f_out = np.zeros_like(found)
    use = np.zeros_like(found)
    kf = np.zeros(R, np.int32)
    nonshort, sub_drop, pair_kf = (np.zeros(P, bool) for _ in range(3))
    for p in range(P):
        row = np.concatenate([found[2 * p] & kvalid[2 * p],
                              found[2 * p + 1] & kvalid[2 * p + 1]])
        f_out[2 * p: 2 * p + 2] = row.reshape(2, NKW)
        # ballot word c: bit i is position 32 c + i of the pair's 2 NKW
        padded = np.zeros(32 * nw, np.uint64)
        padded[:2 * NKW] = row
        words = [int(w) for w in (padded.reshape(nw, 32)
                                  << np.arange(32, dtype=np.uint64)).sum(1)]
        cnt = [0, 0]
        for c, b in enumerate(words):
            m0 = NKW - 32 * c
            lo = 0xFFFFFFFF if m0 >= 32 else (0 if m0 <= 0 else
                                               (1 << m0) - 1)
            cnt[0] += bin(b & lo).count("1")
            cnt[1] += bin(b & ~lo & 0xFFFFFFFF).count("1")
        sub_pass = True
        if nf != 0 and nmf != 0:
            d = max(nf - 1, 1)
            hits = [0, 0]
            for m in range(2):
                n = int(nk[2 * p + m])
                S = n // d                   # floor division, as torch's
                for i in range(nf):
                    idx = i * S if i != nf - 1 else n - 1
                    pos = m * NKW + min(max(idx, 0), NKW - 1)
                    hits[m] += (words[pos >> 5] >> (pos & 31)) & 1
            sub_pass = hits[0] >= nmf and hits[1] >= nmf
        ns = bool(case["any_valid"][2 * p] and case["any_valid"][2 * p + 1]
                  and case["live"][p])
        pair_sub = ns and sub_pass
        k0, k1 = int(cnt[0] < cth), int(cnt[1] < cth)
        pk = pair_sub and not (k0 == 1 and k1 == 1)
        kf[2 * p: 2 * p + 2] = k0, k1
        nonshort[p], sub_drop[p], pair_kf[p] = ns, ns and not pair_sub, pk
        bit = np.array([(words[j >> 5] >> (j & 31)) & 1
                        for j in range(2 * NKW)], bool).reshape(2, NKW)
        use[2 * p: 2 * p + 2] = bit & pk & (np.array([k0, k1]) == 0)[:, None]
    return f_out, kf, nonshort, sub_drop, pair_kf, use


KL_GRID = [(nf, nmf) for nf in (0, 1, 2, 4, 5, 40)
           for nmf in sorted({0, 1, nf, nf + 1, -1})]


@pytest.mark.parametrize("NKW", [1, 2, 31, 32, 33, 140, 300])
def test_kl_plain_matches_emulation(NKW):
    """The kernel's arithmetic equals pair_filter_plain on every plane."""
    P = 61
    for nf, nmf in KL_GRID:
        for cth in (1, 20, NKW + 1):
            case = kl_cases(3, P, NKW, nf, cth)
            want = da.pair_filter_plain(*kl_args(case, "cpu", nf, nmf, cth))
            got = kl_emulated(case, nf, nmf, cth)
            for name, w, g in zip(("found", "kf", "nonshort", "sub_drop",
                                   "pair_kf", "use"), want, got):
                np.testing.assert_array_equal(
                    w.numpy(), g, err_msg=f"{name} nf={nf} nmf={nmf} "
                    f"cth={cth}")
    # the cases reach both sides of each decision
    case = kl_cases(3, P, 140, 4, 20)
    f, kf, ns, sd, pk, use = da.pair_filter_plain(*kl_args(case, "cpu", 4,
                                                            1, 20))
    assert kf.any() and not kf.all() and sd.any() and pk.any() \
        and (ns & ~sd & ~pk).any() and use.any()


def kld_cases(seed: int, P: int, nf: int) -> dict:
    """Seeded KL[decide] inputs: hits (2P,) int32, the valid found samples
    of seeded (2P, nf) found and valid planes (kept beside them); nk (2P,)
    int32 (every 5th read short: nk 0, else 1 to 140) and nonshort = nk >
    0; live (P,) bool (every 7th pair dead)."""
    rng = np.random.default_rng([seed, P, nf])
    R = 2 * P
    found = rng.random((R, nf)) < rng.random((R, 1))
    valid = rng.random((R, nf)) < 0.9
    nk = np.where(np.arange(R) % 5 != 4, rng.integers(1, 141, R),
                  0).astype(np.int32)
    return dict(found=found, valid=valid,
                hits=(found & valid).sum(1).astype(np.int32), nk=nk,
                nonshort=nk > 0, live=np.arange(P) % 7 != 6)


def kld_args(case: dict, device, nmf: int, ns: str = "nonshort") -> tuple:
    """prefilter_decide's arguments: hits, ``ns`` ("nonshort", bool, or
    "nk", the sampler's int32), live, nmf, P."""
    t = {k: torch.from_numpy(case[k]).to(device)
         for k in ("hits", ns, "live")}
    return (t["hits"], t[ns], t["live"], nmf, len(case["live"]))


@pytest.mark.parametrize("nf", [1, 4, 17])
def test_kld_plain_matches_emulation(nf):
    """prefilter_decide_kernel, a thread a pair: live, both mates
    nonshort, each with >= nmf valid found samples."""
    case = kld_cases(5, 301, nf)
    for nmf in (-1, 0, 1, 2, nf, nf + 1):
        want = da.prefilter_decide(*kld_args(case, "cpu", nmf)).numpy()
        np.testing.assert_array_equal(
            want, da.prefilter_decide(*kld_args(case, "cpu", nmf,
                                                "nk")).numpy())
        hits = (case["found"] & case["valid"]).sum(1)
        ok = case["live"] & case["nonshort"][0::2] & case["nonshort"][1::2]
        got = ok & (hits[0::2] >= nmf) & (hits[1::2] >= nmf)
        np.testing.assert_array_equal(want, got, err_msg=f"nmf={nmf}")
        if nmf == 1:
            assert want.any() and not want.all()


def km_cases(seed: int, P: int, threading: bool, nloci: int = 24) -> dict:
    """Seeded KM inputs (the pair planes, pack u8 0-15, kf, bf and rm
    (2P,) int32 with values past 0 and 1 now and then, dst0 (P,) int64 up
    to NAN32, clean_pair with ``threading``)."""
    rng = np.random.default_rng([seed, P, int(threading)])
    R = 2 * P

    def flag(p):
        return rng.random(P) < p

    nonshort = flag(0.8)
    out = dict(live=flag(0.95), nonshort=nonshort,
               sub_drop=nonshort & flag(0.2), pair_kf=flag(0.6),
               vote_pass=flag(0.5),
               pack=rng.integers(0, 16, P).astype(np.uint8),
               dev_pair=flag(0.4), qc_drop=flag(0.1),
               kf=rng.choice([0, 1, 2, -1], R, p=[.6, .35, .03, .02]),
               bf=rng.choice([0, 1, 7, -3], R, p=[.8, .15, .03, .02]),
               rm=rng.choice([0, 1, 2], R, p=[.5, .48, .02]),
               dst0=np.where(flag(0.9), rng.integers(0, nloci, P), NAN32),
               clean_pair=flag(0.5) if threading else None)
    for key in ("kf", "bf", "rm"):
        out[key] = out[key].astype(np.int32)
    out["dst0"] = out["dst0"].astype(np.int64)
    return out


KM_KEYS = ("live", "nonshort", "sub_drop", "pair_kf", "vote_pass", "pack",
           "dev_pair", "qc_drop", "kf", "bf", "rm", "dst0")


def km_args(case: dict, device, nloci: int = 24) -> tuple:
    """step_tail's arguments after stats from a km_cases dict."""
    t = [torch.from_numpy(case[k]).to(device) for k in KM_KEYS]
    cp = case["clean_pair"]
    return (*t, nloci, None if cp is None else torch.from_numpy(cp).to(
        device))


def km_emulated(case: dict, nloci: int = 24) -> tuple:
    """dtk_pair_tail: a thread a pair, each counter summed per block of
    4 pairs (KD's and KE's), then over the blocks."""
    c = {k: v for k, v in case.items()}
    P = len(c["live"])
    hf = np.zeros(2 * P, np.int32)
    counted = np.zeros(P, bool)
    dest = np.zeros(P, np.int64)
    stats = [0] * 9
    for b0 in range(0, P, 4):
        part = [0] * 9
        for p in range(b0, min(b0 + 4, P)):
            lv, ns, sd = c["live"][p], c["nonshort"][p], c["sub_drop"][p]
            ref = bool(c["pack"][p] & 1)
            k0, k1 = int(c["kf"][2 * p]), int(c["kf"][2 * p + 1])
            b0_, b1 = int(c["bf"][2 * p]), int(c["bf"][2 * p + 1])
            r0, r1 = int(c["rm"][2 * p]), int(c["rm"][2 * p + 1])
            dp = bool(c["dev_pair"][p])
            h = c["pair_kf"][p] and not c["vote_pass"][p] and not ref
            h0, h1 = int(h and k0 == 0), int(h and k1 == 0)
            cnt = dp and not (r0 == 1 and r1 == 1)
            nmate = 2 - r0 - r1 if cnt else 0
            if c["clean_pair"] is not None:
                cnt = dp and bool(c["clean_pair"][p])
                nmate = nmate if cnt else 0
            hf[2 * p: 2 * p + 2] = h0, h1
            counted[p] = cnt
            dest[p] = c["dst0"][p] if cnt else nloci
            for i, v in enumerate((
                    2 * int(lv and not ref), int(lv and not ns), 2 * int(sd),
                    k0 + k1 if ns and not sd and not ref else 0, h0 + h1,
                    2 * int(dp), nmate,
                    2 - k0 - k1 if c["qc_drop"][p] else 0,
                    int(b0_ != 0 and k0 == 0) + int(b1 != 0 and k1 == 0))):
                part[i] += v
        stats = [s + x for s, x in zip(stats, part)]
    return hf, counted, dest, np.array(stats, np.int64)


@pytest.mark.parametrize("threading", [False, True])
@pytest.mark.parametrize("P", [1, 255, 1001])
def test_km_plain_matches_emulation(threading, P):
    """step_tail_plain's planes and counters (added to a non-zero stats
    vector) equal the kernel's arithmetic."""
    case = km_cases(7, P, threading)
    base = torch.arange(9, dtype=torch.int64) * 1000
    stats = base.clone()
    hf, counted, dest = da.step_tail_plain(stats, *km_args(case, "cpu"))
    ehf, ecounted, edest, estats = km_emulated(case)
    np.testing.assert_array_equal(hf.numpy(), ehf)
    np.testing.assert_array_equal(counted.numpy(), ecounted)
    np.testing.assert_array_equal(dest.numpy(), edest)
    np.testing.assert_array_equal((stats - base).numpy(), estats)
    if P > 255:
        assert counted.any() and (~counted).any() and hf.any()
