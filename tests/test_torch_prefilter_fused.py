"""KK's fused launch (the sample, the member probe and the decision in one
launch: engine/device_align.py prefilter_fused_launcher,
csrc/prefilter_sample.cu) on the CPU, against the JAX package.

* prefilter_fused_plain (what the fused route runs on CPU tensors) and
  the port's make_prefilter_step (no probe: the fused route) equal the
  JAX make_prefilter_step, survivors exactly, on seeded adversarial pairs
  over the golden panel (tests/test_torch_kmers_filter_cases.kkf_pairs:
  golden pairs (hits), a mate shorter than k (nk = 0), code 255 in
  sampled windows of one mate or in every window, dead pairs (live
  false) and KK's adversarial reads); for
  nf = 1, 2, 4 (nmf 1, and 2 at nf = 4) on the member table and on a
  model without one (the dbi table, W = 4);
* the front end's float division (kk_div) is exact over its operands'
  ranges; the kernel's window packing (kk_codes: 32-bit words of the staged
  rows, four codes a multiply) equals the codes one by one for spans of
  0-31 codes at every alignment, a byte above 3 invalidating its span;
* a warp-by-warp emulation of the fused kernel (KKF_PPW pairs a warp,
  each window built in parts by 4, 2 or 1 lanes (kk_codes) and made canonical
  through the bit-reversed complement, tiles of 32 queries from nf = 5,
  every valid query of a pair that probes at all probed, hits added up
  per (pair, mate), the host's clamp of nmf, an odd pair count) gives
  the plain version's queries and survivors and probes exactly the
  queries engine/device_align.py prefilter_fused_work counts for the
  bound, for nf = 1, 2, 3, 4, 5, 9, 16, 17 and 20 and nmf = 0 to 3 and
  nf + 1; the kernel's KKF_WARPS and KKF_PPW are the module's;
* KK[q], the same launch over the host sampler's queries
  (prefilter_fused_q_launcher): a warp-by-warp emulation (the warp's
  queries contiguous, tiles of 32, one probe round a tile) gives
  prefilter_fused_q_plain's survivors and probes exactly the queries
  prefilter_fused_q_work counts, on the member and dbi tables, for the
  same nf and nmf;
* the launchers refuse a composite table, inputs off its device and
  malformed planes.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from danbing_tk_tpu.engine import device_align as jda
from danbing_tk_tpu.engine.host_align import AlignConfig as JCfg
from danbing_tk_tpu.engine.host_align import RPGG as JRPGG
from danbing_tk_tpu_torch.engine import device_align as tda
from danbing_tk_tpu_torch.engine.host_align import AlignConfig
from danbing_tk_tpu_torch.index import device_table as dt
from danbing_tk_tpu_torch.ops import kmers as km
from test_torch_kmers_filter_cases import kkf_pairs

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
CSRC = os.path.join(os.path.dirname(__file__), os.pardir,
                    "danbing_tk_tpu_torch", "csrc")
K = 21


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    """{"member": (JAX model, port model), "dbi": the same without a
    member table}, over the JAX package's golden tables."""
    jd = jda.DeviceRPGG.build(JRPGG(os.path.join(GOLDEN, "pan")),
                              with_tre=False)
    out = {}
    for name, mt in (("member", jd.member_tab), ("dbi", None)):
        j = dataclasses.replace(jd, member_tab=mt)
        t = tda.DeviceRPGG(jd.nloci, jd.dbi_tab, jd.vv, jd.trfl_tab, None,
                           jd.locus_offsets, jd.nslots, member_tab=mt)
        out[name] = (j, t)
    return out


def _cfg(nf, nmf):
    return dict(ksize=K, cth=20, n_filter=nf, nm_filter=nmf, okam=False)


@pytest.mark.parametrize("table", ["member", "dbi"])
@pytest.mark.parametrize("nf,nmf", [(1, 1), (2, 1), (4, 1), (4, 2)])
def test_fused_matches_jax(models, table, nf, nmf):
    jd, td = models[table]
    P, L = 128, 160
    codes, rlen, live = kkf_pairs(7, P, L, nf)
    want = np.asarray(jda.make_prefilter_step(
        jd, JCfg(**_cfg(nf, nmf)), P, L)(codes, rlen, live))
    tab = tda._prefilter_table(td, "cpu")
    assert tab.W == (2 if table == "member" else 4)
    c, r, lv = (torch.from_numpy(x) for x in (codes, rlen, live))
    plain = tda.prefilter_fused_plain(c, r, lv, tab, K, nf, nmf)
    np.testing.assert_array_equal(plain.numpy(), want)
    step = tda.make_prefilter_step(td, AlignConfig(**_cfg(nf, nmf)), P, L,
                                   "cpu")
    np.testing.assert_array_equal(step(codes, rlen, live).numpy(), want)
    # the cases reach both outcomes, and each kind of failure
    assert want.sum() > P // 4 and (~want).sum() > P // 8
    kind = np.arange(P) % 8
    assert not want[~live].any()
    assert not want[(kind == 1) & live].any()
    assert want[(kind == 0) & live].any()


def _canonical_emulated(fwd, k):
    """kk_canonical: the reverse complement as the complement of the
    forward word with its 64 bits reversed, each code's two bits swapped
    back, shifted down by 64 - 2k."""
    x = int(f"{~fwd & (2**64 - 1):064b}"[::-1], 2)
    m = 0x5555555555555555
    x = ((x >> 1) & m) | ((x & m) << 1)
    rc = x >> (64 - 2 * k)
    return min(rc, fwd)


PACK, M32, M64 = 0x40100401, 2**32 - 1, 2**64 - 1


def _codes_emulated(flat, i, n, lead):
    """kk_codes: the n codes from flat[i] on, read as the 32-bit words of
    the staged row (``lead``: the byte's place in its word, the staged
    address mod 4; bytes off the span masked to 0), each word's four
    codes packed by one multiply by PACK mod 2^32.  Returns (the 2n-bit
    word, whether every code is <= 3)."""
    if n <= 0:
        return 0, True

    def word(j):
        b0 = i - lead + 4 * j
        return sum(int(flat[b0 + t]) << (8 * t) for t in range(4)
                   if 0 <= b0 + t < len(flat))

    last = (lead + n - 1) >> 2
    tail = lead + n - 4 * last
    x = word(0) & (M32 << (8 * lead)) & M32
    if last == 0:
        x &= M32 >> (32 - 8 * tail)
    bad = x
    f = ((x * PACK) & M32) >> (24 + 2 * (4 - (tail if last == 0 else 4)))
    for j in range(1, last):
        x = word(j)
        bad |= x
        f = ((f << 8) | (((x * PACK) & M32) >> 24)) & M64
    if last > 0:
        x = word(last) & (M32 >> (32 - 8 * tail))
        bad |= x
        f = ((f << (2 * tail))
             | (((x * PACK) & M32) >> (24 + 2 * (4 - tail)))) & M64
    return f, bad & 0xFCFCFCFC == 0


def test_codes_emulation_packs_words():
    """_codes_emulated (the kernel's word packing) = the codes one by one,
    for every span length 0-31 at every alignment, and any byte above 3
    (4, 128, 255) inside a span invalidates it, none outside it does."""
    rng = np.random.default_rng(5)
    flat = rng.integers(0, 4, 96).astype(np.uint8)
    for i in range(8, 16):
        for n in range(32):
            want = 0
            for b in flat[i:i + n]:
                want = (want << 2) | int(b)
            for lead in (i & 3, (i + 1) & 3):
                assert _codes_emulated(flat, i, n, lead) == (want, True)
            for bad in (4, 128, 255):
                g = flat.copy()
                g[i - 1] = g[i + n] = bad
                assert _codes_emulated(g, i, n, i & 3)[1]
                if n:
                    g[i + n // 2] = bad
                    assert not _codes_emulated(g, i, n, i & 3)[1]


def test_float_division_is_exact():
    """kk_div: floor(n / d) as the float32 product (n + 0.5) * (1 / d),
    each step rounded to nearest, for the front end's operands: nk up to
    2^20 over nf - 1, and query indices up to 8 nf + 31 over nf and 2 nf,
    nf up to 2^16 (the entry points' limit)."""
    f32 = np.float32
    n = np.concatenate([np.arange(1 << 16), np.arange(1 << 16, 1 << 20, 97),
                        (1 << 20) - np.arange(64),
                        8 * 65536 * 2 + 31 - np.arange(4096)])
    for d in list(range(1, 300)) + [511, 1000, 4095, 65535, 65536, 131072]:
        r = f32(1) / f32(d)
        got = ((n.astype(f32) + f32(0.5)) * r).astype(np.int64)
        np.testing.assert_array_equal(got, n // d, err_msg=f"d={d}")


def _lanes_a_query(nf):
    """The kernel's lpq: the largest power of 2 (<= 16) with the warp's
    KKF_PPW * 2 nf queries of that many lanes in 32 lanes."""
    lsh = 0
    while lsh < 5 and (tda.KKF_PPW * 2 * nf) << (lsh + 1) <= 32:
        lsh += 1
    return 1 << lsh


def test_kernel_layout_constants():
    src = open(os.path.join(CSRC, "prefilter_sample.cu")).read()
    for name in ("KKF_WARPS", "KKF_PPW"):
        assert f"constexpr int {name} = {getattr(tda, name)};" in src


def _fused_emulated(codes, rlen, live, found, q, k, nf, nmf):
    """prefilter_fused_kernel warp by warp (KKF_PPW pairs a warp), in
    Python integers; ``found`` (2P, nf) is the table's answer to each
    (read, sample) query and ``q`` the plain version's queries, which
    each window's key (built in lpq parts, merged, made canonical as the
    kernel does) must equal.  Returns (survive (P,), probed (2P, nf))."""
    B, L = codes.shape
    P = B // 2
    flat = codes.reshape(-1)
    ppw = tda.KKF_PPW
    m = min(max(nmf, 0), nf + 1)            # dtk_prefilter_fused's clamp
    nq = 2 * nf
    lpq = _lanes_a_query(nf)
    qt = 32 // lpq
    ntile = -(-ppw * nq // qt)
    sl = -(-k // lpq)
    survive = np.zeros(P, bool)
    probed = np.zeros((B, nf), bool)
    for p0 in range(0, P, ppw):
        npw = min(ppw, P - p0)
        rl = [int(x) for x in rlen[2 * p0: 2 * (p0 + npw)]]
        nk = [max(x - k + 1, 0) for x in rl]
        alive = [bool(live[p0 + i]) and nk[2 * i] > 0 and nk[2 * i + 1] > 0
                 for i in range(npw)]
        if m <= 0 or m > nf or not any(alive):
            for i in range(npw):
                survive[p0 + i] = m <= 0 and alive[i]
            continue
        hits = [0] * (2 * npw)
        for w in range(qt * ntile):         # tile by tile, lane order
            pp, u = divmod(w, nq)
            if w >= ppw * nq or pp >= npw or not alive[pp]:
                continue
            mate, j = u & 1, u >> 1
            r = 2 * pp + mate
            s = nk[r] - 1 if j == nf - 1 else j * (nk[r] // (nf - 1))
            s = min(max(s, 0), L - k)
            ok = s + k <= rl[r] and s < nk[r]
            f = 0
            for seg in range(lpq if ok else 0):
                a = min(seg * sl, k)
                e = min(a + sl, k)
                # the staged codes keep the rows' alignment mod 16
                idx = (2 * p0 + r) * L + s + a
                part, good = _codes_emulated(flat, idx, e - a, idx & 3)
                ok &= good
                f |= (part << (2 * (k - e))) & M64
            if ok:
                assert _canonical_emulated(f, k) == int(q[2 * p0 + r, j])
                probed[2 * p0 + r, j] = True
                hits[r] += bool(found[2 * p0 + r, j])
        for i in range(npw):
            survive[p0 + i] = alive[i] and hits[2 * i] >= m \
                and hits[2 * i + 1] >= m
    return survive, probed


@pytest.mark.parametrize("nf", [1, 2, 3, 4, 5, 9, 16, 17, 20])
def test_fused_kernel_emulation(models, nf):
    """The kernel's decision and the queries it probes, for each nmf."""
    _, td = models["member"]
    tab = tda._prefilter_table(td, "cpu")
    P, L = 63, 160
    codes, rlen, live = kkf_pairs(3, P, L, nf)
    c, r, lv = (torch.from_numpy(x) for x in (codes, rlen, live))
    q, valid, _ = km.prefilter_sample_plain(c, r, K, nf)
    found = (dt.lookup_bucket_plain(tab, q)[0] & valid).numpy()
    for nmf in (0, 1, 2, 3, nf + 1):
        want = tda.prefilter_fused_plain(c, r, lv, tab, K, nf, nmf).numpy()
        surv, probed = _fused_emulated(codes, rlen, live, found,
                                       q.numpy(), K, nf, nmf)
        np.testing.assert_array_equal(surv, want, err_msg=f"nmf={nmf}")
        work = tda.prefilter_fused_work(c, r, lv, tab, K, nf, nmf)
        np.testing.assert_array_equal(work["survive"].numpy(), want)
        np.testing.assert_array_equal(work["probed"].numpy(), probed,
                                      err_msg=f"nmf={nmf}")
        assert not (probed & ~valid.numpy()).any()
        if 1 <= nmf <= nf:
            assert want.any() or nmf > 2
            assert probed.any()
        else:
            assert not probed.any()
        assert work["nbytes"] >= 2 * P * L + 10 * P


def _fused_q_emulated(q, valid, nonshort, live, found, nmf):
    """prefilter_fused_q_kernel warp by warp (KKF_PPW pairs a warp, their
    2 KKF_PPW nf queries contiguous in q, lane i of tile t taking query
    32 t + i, read (32 t + i) / nf of the warp's); ``found`` (2P, nf) is
    the table's answer to each query.  Returns (survive (P,), probed (2P,
    nf))."""
    B, nf = q.shape
    P = B // 2
    ppw = tda.KKF_PPW
    m = min(max(nmf, 0), nf + 1)            # dtk_prefilter_fused_q's clamp
    survive = np.zeros(P, bool)
    probed = np.zeros((B, nf), bool)
    for p0 in range(0, P, ppw):
        npw = min(ppw, P - p0)
        alive = [bool(live[p0 + i] and nonshort[2 * (p0 + i)]
                      and nonshort[2 * (p0 + i) + 1]) for i in range(npw)]
        if m <= 0 or m > nf or not any(alive):
            for i in range(npw):
                survive[p0 + i] = m <= 0 and alive[i]
            continue
        hits = [0] * (2 * npw)
        nw = 2 * npw * nf
        for t in range(-(-nw // 32)):
            lanes = [w for w in range(32 * t, min(32 * t + 32, nw))
                     if alive[w // nf >> 1]
                     and valid[2 * p0 + w // nf, w % nf]]
            # one round: compacted query c to group c % 4, flight c // 4
            assert len(lanes) <= 4 * 8
            for w in lanes:
                r, j = 2 * p0 + w // nf, w % nf
                probed[r, j] = True
                hits[w // nf] += bool(found[r, j])
        for i in range(npw):
            survive[p0 + i] = alive[i] and hits[2 * i] >= m \
                and hits[2 * i + 1] >= m
    return survive, probed


@pytest.mark.parametrize("table", ["member", "dbi"])
@pytest.mark.parametrize("nf", [1, 2, 3, 4, 5, 9, 16, 17, 20])
def test_fused_q_kernel_emulation(models, table, nf):
    """KK[q] (the host-sampled instance): the kernel's decision and the
    queries it probes equal prefilter_fused_q_plain's survivors and what
    prefilter_fused_q_work counts for the bound, for each nmf, on the
    sampled queries of the adversarial pairs (an odd pair count)."""
    _, td = models[table]
    tab = tda._prefilter_table(td, "cpu")
    P, L = 63, 160
    codes, rlen, live = kkf_pairs(4, P, L, nf)
    c, r, lv = (torch.from_numpy(x) for x in (codes, rlen, live))
    q, valid, nk = km.prefilter_sample_plain(c, r, K, nf)
    nonshort = nk > 0
    found = dt.lookup_bucket_plain(tab, q)[0].numpy()
    run = None
    for nmf in (0, 1, 2, 3, nf + 1):
        run = tda.prefilter_fused_q_launcher(tab, nmf)
        want = run(q, valid, nonshort, lv).numpy()
        np.testing.assert_array_equal(
            want, tda.prefilter_fused_q_plain(q, valid, nonshort, lv, tab,
                                              nmf).numpy())
        surv, probed = _fused_q_emulated(q.numpy(), valid.numpy(),
                                         nonshort.numpy(), live, found, nmf)
        np.testing.assert_array_equal(surv, want, err_msg=f"nmf={nmf}")
        work = tda.prefilter_fused_q_work(q, valid, nonshort, lv, tab, nmf)
        np.testing.assert_array_equal(work["survive"].numpy(), want)
        np.testing.assert_array_equal(work["probed"].numpy(), probed,
                                      err_msg=f"nmf={nmf}")
        # the same decision as the code-row launch's
        np.testing.assert_array_equal(want, tda.prefilter_fused_plain(
            c, r, lv, tab, K, nf, nmf).numpy())
        assert probed.any() == (1 <= nmf <= nf)
        assert work["nbytes"] >= 9 * q.numel() + 4 * P
    with pytest.raises(ValueError, match="nf >= 1"):
        run(q[:, :0], valid[:, :0], nonshort, lv)
    with pytest.raises(ValueError, match="live"):
        run(q, valid, nonshort, lv[:-1])


def test_launcher_refusals(models):
    _, td = models["member"]
    tab = tda._prefilter_table(td, "cpu")
    run = tda.prefilter_fused_launcher(tab, K, 4, 1)
    codes, rlen, live = kkf_pairs(1, 8, 160, 4)
    c, r, lv = (torch.from_numpy(x) for x in (codes, rlen, live))
    assert run(c, r, lv).shape == (8,)
    with pytest.raises(ValueError, match="2P"):
        run(c[:15], r[:15], lv)
    with pytest.raises(ValueError, match="int32"):
        run(c, r.long(), lv)
    with pytest.raises(ValueError, match="int32"):
        run(c, r, lv[:7])
    comp = dt.DevTable(tab.levels, tab.salts, True, 1)
    with pytest.raises(ValueError, match="k-mer alone"):
        tda.prefilter_fused_launcher(comp, K, 4, 1)
    with pytest.raises(ValueError, match="nf"):
        tda.prefilter_fused_launcher(tab, K, 0, 1)
    with pytest.raises(ValueError, match="must lie on cpu"):
        run(c.to("meta"), r, lv)
