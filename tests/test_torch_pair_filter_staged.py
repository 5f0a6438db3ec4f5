"""KL's block-staged design and KM's tail at KD's and KE's pair meeting,
emulated in numpy and held against their plain versions on the CPU (the
kernels run only on the card: tests/test_torch_gpu.py).

* KL (csrc/pair_filter.cu): a block of G = 8 consecutive pairs, whose rows
  are one span of 2 G NKW bytes in each plane, a thread a 16-byte chunk of
  it: the chunk of found and of kvalid loaded as 16 bytes where the span
  starts 16-byte aligned and the chunk is whole, else byte by byte (0 past
  the span); ANDed as four 32-bit words of 0/1 bytes; stored to found_out
  and into the block's shared span; each row's ones in the chunk (popc of
  the words under the row's byte mask) added into the row's count; then
  warp 0, a lane a row, reading the row's samples from the shared span
  and deciding each pair with its mate's lane, and use stored as the
  masked chunk under the used rows' byte masks.
  Emulated at NKW = 1, 7, 33, 140, 141 and 250, P = 61 (the last block
  holds 5 pairs), nf = 0, 1, 2, 4 and 5, with the planes 16-byte aligned
  and at odd address offsets (every chunk byte-wise); the outputs are
  poisoned first, so a byte the stores miss shows.
* KM (csrc/step_tail.cuh): the tail of each pair run by lane 0 of its even
  warp, 4 pairs a block of 8 warps, each block's nine counters summed in
  shared memory and added once (none where 0); in KD's counting instance
  on seeded KD inputs (counted from KD's rm), in KE's on seeded walk
  inputs (counted = dev_pair & clean_pair, nmate from KD's rm), at pair
  counts whose last block is partly filled.

Every comparison is exact.  Torch and the port only (no JAX)."""

import numpy as np
import pytest
import torch

from danbing_tk_tpu_torch.engine import device_align as da
from test_torch_assign_count import kd_cases
from test_torch_step_tail_cases import kl_args, kl_cases, km_cases
from test_torch_walk_edges_cases import ke_args, ke_cases

G = 8                      # KL_G: pairs a block at most
SMEM = 232448              # a block's shared memory
POISON = 0xA5


def kl_smem(g: int, NKW: int) -> int:
    """The masked span in 16-byte chunks, a count and a use flag a row."""
    return ((2 * g * NKW + 15) & ~15) + g * 2 * 8


def kl_block_pairs(NKW: int) -> int:
    """dtk_pair_filter_block_pairs: G halved until the block's shared
    memory fits (0 past one pair's)."""
    g = G
    while g > 1 and kl_smem(g, NKW) > SMEM:
        g //= 2
    return g if kl_smem(g, NKW) <= SMEM else 0


def kl_bytes(a: int, b: int) -> int:
    """Bytes [a, b) of a 32-bit word as a mask."""
    a, b = min(max(a, 0), 4), min(max(b, 0), 4)
    return 0 if a >= b else ((1 << 8 * b) - 1) & ~((1 << 8 * a) - 1)


def chunk_mask(a: int, b: int) -> list:
    return [kl_bytes(a - 4 * k, b - 4 * k) for k in range(4)]


def load(g: np.ndarray, aligned: bool, c: int, n: int) -> tuple:
    """kl_load: chunk c as four little-endian words, and whether it was one
    16-byte load."""
    j0 = 16 * c
    if aligned and j0 + 16 <= n:
        return [int(x) for x in g[j0: j0 + 16].view("<u4")], True
    w = [0] * 4
    for t in range(16):
        if j0 + t < n:
            w[t >> 2] |= int(g[j0 + t]) << 8 * (t & 3)
    return w, False


def store(g: np.ndarray, aligned: bool, c: int, n: int, w: list) -> bool:
    j0 = 16 * c
    if aligned and j0 + 16 <= n:
        g[j0: j0 + 16] = np.array(w, "<u4").view(np.uint8)
        return True
    for t in range(16):
        if j0 + t < n:
            g[j0 + t] = (w[t >> 2] >> 8 * (t & 3)) & 0xFF
    return False


def rows_of(c: int, n: int, NKW: int):
    """(row, a, b): the rows chunk c meets and their bytes [a, b) in it."""
    j0 = 16 * c
    j1 = min(j0 + 16, n)
    r, a = j0 // NKW, j0
    while a < j1:
        b = min((r + 1) * NKW, j1)
        yield r, a - j0, b - j0
        a, r = b, r + 1


def kl_staged(case: dict, nf: int, nmf: int, cth: int,
              addrs=(0, 0, 0, 0)) -> tuple:
    """pair_filter_kernel block by block.  addrs: the address mod 16 of
    found, kvalid, found_out and use."""
    found, kvalid, nk = case["found"], case["kvalid"], case["nk"]
    R, NKW = found.shape
    P, n2 = R // 2, 2 * NKW
    g_f = found.reshape(-1).astype(np.uint8)
    g_k = kvalid.reshape(-1).astype(np.uint8)
    o_f = np.full(R * NKW, POISON, np.uint8)
    o_u = np.full(R * NKW, POISON, np.uint8)
    kf = np.zeros(R, np.int32)
    nonshort, sub_drop, pair_kf = (np.zeros(P, bool) for _ in range(3))
    vec = [0, 0]                         # chunks loaded as 16 B, byte-wise
    for p0 in range(0, P, G):
        npairs = min(G, P - p0)
        nr = 2 * npairs
        n, base = nr * NKW, p0 * n2
        nch = -(-n // 16)
        al = [(x + base) % 16 == 0 for x in addrs]
        span = np.full(16 * nch, POISON, np.uint8)
        cnt = [0] * nr
        masked = []
        for c in range(nch):                       # 1. one round trip in
            f, v = load(g_f[base:], al[0], c, n)
            k, _ = load(g_k[base:], al[1], c, n)
            vec[not v] += 1
            m = [x & y for x, y in zip(f, k)]
            masked.append(m)
            store(o_f[base:], al[2], c, n, m)
            span[16 * c: 16 * c + 16] = np.array(m, "<u4").view(np.uint8)
            for r, a, b in rows_of(c, n, NKW):
                cnt[r] += sum(bin(x & y).count("1")
                              for x, y in zip(m, chunk_mask(a, b)))
        # 2. warp 0, a lane a row: its samples and kf, then the pair's
        # decision with its mate's lane
        hits, kfr = [0] * nr, [int(x < cth) for x in cnt]
        sub = nf != 0 and nmf != 0
        for r in range(nr):
            if sub:
                nkr = int(nk[2 * p0 + r])
                S = nkr // max(nf - 1, 1)          # floor, as torch's //
                for i in range(nf):
                    idx = i * S if i != nf - 1 else nkr - 1
                    hits[r] += int(span[r * NKW + min(max(idx, 0), NKW - 1)])
        used = [False] * nr
        for w in range(npairs):
            p, a = p0 + w, 2 * w
            ns = bool(case["any_valid"][2 * p]
                      and case["any_valid"][2 * p + 1] and case["live"][p])
            sub_pass = not sub or (hits[a] >= nmf and hits[a + 1] >= nmf)
            pair_sub = ns and sub_pass
            k0, k1 = kfr[a], kfr[a + 1]
            pk = pair_sub and not (k0 == 1 and k1 == 1)
            kf[2 * p: 2 * p + 2] = k0, k1
            nonshort[p], sub_drop[p] = ns, ns and not pair_sub
            pair_kf[p] = pk
            used[a], used[a + 1] = pk and k0 == 0, pk and k1 == 0
        for c in range(nch):                       # 3. one round trip out
            keep = [0] * 4
            for r, a, b in rows_of(c, n, NKW):
                if used[r]:
                    keep = [x | y for x, y in zip(keep, chunk_mask(a, b))]
            store(o_u[base:], al[3], c, n,
                  [x & y for x, y in zip(masked[c], keep)])
    assert set(np.unique(o_f)) <= {0, 1} and set(np.unique(o_u)) <= {0, 1}
    return (o_f.reshape(R, NKW).astype(bool), kf, nonshort, sub_drop,
            pair_kf, o_u.reshape(R, NKW).astype(bool)), vec


KL_NAMES = ("found", "kf", "nonshort", "sub_drop", "pair_kf", "use")


@pytest.mark.parametrize("NKW", [1, 7, 33, 140, 141, 250])
def test_kl_staged_matches_plain(NKW):
    """The staged design = pair_filter_plain on every plane, the last
    block partly filled, with aligned and with odd plane addresses."""
    P = 61
    assert kl_block_pairs(NKW) == G and P % G
    vec = [0, 0]
    for nf in (0, 1, 2, 4, 5):
        for nmf in sorted({0, 1, nf, nf + 1}):
            for cth in (1, 20, NKW + 1):
                case = kl_cases(11, P, NKW, nf, cth)
                want = da.pair_filter_plain(*kl_args(case, "cpu", nf, nmf,
                                                     cth))
                for addrs in ((0, 0, 0, 0), (3, 9, 0, 5)):
                    if addrs[0] and cth != 20:
                        continue
                    got, v = kl_staged(case, nf, nmf, cth, addrs)
                    for name, w, g in zip(KL_NAMES, want, got):
                        np.testing.assert_array_equal(
                            w.numpy(), g, err_msg=f"{name} nf={nf} "
                            f"nmf={nmf} cth={cth} addrs={addrs}")
                    vec = [a + b for a, b in zip(vec, v)]
    # chunks of both kinds: 16-byte loads, and byte-wise (the odd
    # addresses, and the last block's partial chunk)
    assert vec[0] > 0 and vec[1] > 0


def test_kl_block_pairs():
    """8 pairs a block up to NKW ~14,500 (their span fits 227 KB), fewer
    past it, none past one pair's; a block of 8 pairs' span is a multiple
    of 16 bytes, so its chunks load as 16 bytes where the planes start
    16-byte aligned."""
    for NKW in (1, 7, 140, 250, 14000):
        assert kl_block_pairs(NKW) == 8 and (2 * 8 * NKW) % 16 == 0
    assert kl_block_pairs(20000) == 4 and kl_block_pairs(100000) == 1
    assert kl_block_pairs(120000) == 0
    assert kl_smem(8, 140) == 2240 + 128


# ---------------------------------------------------------------------------
# KM's tail at the pair meeting
# ---------------------------------------------------------------------------

TAIL_KEYS = ("live", "nonshort", "sub_drop", "pair_kf", "vote_pass", "pack",
             "qc_drop", "bf")


def tail_planes(P: int, seed: int) -> dict:
    """The tail's planes (km_cases's) for P pairs."""
    c = km_cases(seed, P, False)
    return {k: c[k] for k in TAIL_KEYS}


def step_tail_of(t: dict) -> da.StepTail:
    return da.StepTail(*(torch.from_numpy(np.ascontiguousarray(t[k]))
                         for k in TAIL_KEYS))


def tail_emulated(t: dict, dev_pair, kf, rm, dst0, nloci: int,
                  clean_pair=None) -> tuple:
    """dtk_pair_tail by the even warp's lane 0, 4 pairs a block of 8
    warps (an inactive pair's row zero), dtk_tail_flush: each counter
    summed over the block's rows and added where not 0."""
    P = len(dev_pair)
    hf = np.full(2 * P, -7, np.int32)
    counted = np.zeros(P, bool)
    dest = np.full(P, -7, np.int64)
    stats = [0] * 9
    adds = 0
    for p0 in range(0, 4 * -(-P // 4), 4):
        part = [[0] * 9 for _ in range(4)]
        for w in range(4):
            p = p0 + w
            if p >= P:
                continue
            dp = bool(dev_pair[p])
            r0, r1 = int(rm[2 * p]), int(rm[2 * p + 1])
            k0, k1 = int(kf[2 * p]), int(kf[2 * p + 1])
            if clean_pair is None:              # KD: its own rm, 0 or 1
                cnt = dp and not (r0 and r1)
                nmate = 2 - r0 - r1 if cnt else 0
            else:                               # KE: the walk's counted
                cnt = dp and bool(clean_pair[p])
                nmate = 2 - r0 - r1 if cnt and not (r0 == 1 and r1 == 1) \
                    else 0
            ref = bool(t["pack"][p] & 1)
            lv, ns, sd = t["live"][p], t["nonshort"][p], t["sub_drop"][p]
            h = t["pair_kf"][p] and not t["vote_pass"][p] and not ref
            h0, h1 = int(h and k0 == 0), int(h and k1 == 0)
            b0, b1 = int(t["bf"][2 * p]), int(t["bf"][2 * p + 1])
            hf[2 * p: 2 * p + 2] = h0, h1
            counted[p] = cnt
            dest[p] = dst0[p] if cnt else nloci
            part[w] = [2 * int(lv and not ref), int(lv and not ns),
                       2 * int(sd),
                       k0 + k1 if ns and not sd and not ref else 0,
                       h0 + h1, 2 * int(dp), nmate,
                       2 - k0 - k1 if t["qc_drop"][p] else 0,
                       int(b0 != 0 and k0 == 0) + int(b1 != 0 and k1 == 0)]
        for i in range(9):
            s = sum(row[i] for row in part)
            if s:
                stats[i] += s
                adds += 1
    return hf, counted, dest, np.array(stats, np.int64), adds


@pytest.mark.parametrize("P", [1, 6, 63])
def test_kd_tail_emulation_matches_plain(P):
    """KD's counting instance with the tail = assign_count_plain's
    composition with step_tail_plain, on KD's own rm."""
    case = kd_cases(13, P, 37)
    T = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    args = [T(case[k]) for k in ("found", "val", "annv", "kvalid",
                                 "afound_t", "aval_t", "dst0", "dev_pair",
                                 "kf", "nk", "loff")]
    args += [case["nloci"], case["nm_tr"], False, T(case["bf_pair"]), False]

    def state():
        st = {k: T(case[k].copy()) for k in ("counts", "nmapread", "kmc")}
        st["stats"] = torch.arange(9, dtype=torch.int64) * 1000
        return st

    t = tail_planes(P, 13)
    s_plain, s_tail = state(), state()
    plain = da.assign_count_plain(s_plain, *args)
    got = da.assign_count(s_tail, *args, step_tail_of(t))
    for k in plain:
        assert torch.equal(plain[k], got[k]), k
    for k in ("counts", "nmapread", "kmc"):
        assert torch.equal(s_plain[k], s_tail[k]), k
    rm = plain["rm"].numpy()
    hf, counted, dest, stats, adds = tail_emulated(
        t, case["dev_pair"], case["kf"], rm, case["dst0"], case["nloci"])
    np.testing.assert_array_equal(got["hf"].numpy(), hf)
    np.testing.assert_array_equal(got["counted"].numpy(), counted)
    np.testing.assert_array_equal(got["dest"].numpy(), dest)
    np.testing.assert_array_equal(
        (s_tail["stats"] - torch.arange(9) * 1000).numpy(), stats)
    assert adds <= 9 * -(-P // 4)
    if P > 6:
        assert counted.any() and (~counted).any() and hf.any()
        assert ((rm.reshape(-1, 2) == 1).all(1) & case["dev_pair"]).any()
    with pytest.raises(ValueError, match="threading"):
        da.assign_count_plain(state(), *args[:13], True, *args[14:],
                              step_tail_of(t))


@pytest.mark.parametrize("P", [1, 7, 49])
def test_ke_tail_emulation_matches_plain(P):
    """KE with the tail = thread_walk_graph_plain's walk, then
    step_tail_plain with its clean_pair, nmate from KD's rm (values past
    0 and 1 too)."""
    case = ke_cases(17, P, 140)
    km = km_cases(17, P, True)
    t = tail_planes(P, 17)
    kf, rm = torch.from_numpy(km["kf"]), torch.from_numpy(km["rm"])
    nloci = 24

    def state():
        return {"counts": torch.zeros(case["nslots"] + 1, dtype=torch.int32),
                "stats": torch.arange(9, dtype=torch.int64) * 1000}

    s0, s1 = state(), state()
    clean, pair = da.thread_walk_graph_plain(s0, *ke_args(case, "cpu"))
    g_clean, g_pair, (hf, counted, dest) = da.thread_walk_graph(
        s1, *ke_args(case, "cpu"), step_tail_of(t), kf, rm, nloci)
    assert torch.equal(clean, g_clean) and torch.equal(pair, g_pair)
    assert torch.equal(s0["counts"], s1["counts"])
    e_hf, e_counted, e_dest, e_stats, _ = tail_emulated(
        t, case["dev_pair"], km["kf"], km["rm"], case["dst0"], nloci,
        pair.numpy())
    np.testing.assert_array_equal(hf.numpy(), e_hf)
    np.testing.assert_array_equal(counted.numpy(), e_counted)
    np.testing.assert_array_equal(dest.numpy(), e_dest)
    np.testing.assert_array_equal(
        (s1["stats"] - torch.arange(9) * 1000).numpy(), e_stats)
    want = da.step_tail_plain(
        state()["stats"], *step_tail_of(t)[:6],
        torch.from_numpy(case["dev_pair"]), step_tail_of(t).qc_drop, kf,
        step_tail_of(t).bf, rm, torch.from_numpy(case["dst0"]), nloci, pair)
    for w, g in zip(want, (hf, counted, dest)):
        assert torch.equal(w, g)
    if P > 7:
        assert counted.any() and (case["dev_pair"] & ~pair.numpy()).any()
