"""Bounded-edit error-correction scoring over failure sites (kernel KJ).

Counterpart of danbing_tk_tpu/ops/correct_jax.py.  The reference's
threading-mode error correction scores 8 hypothesis families (62
extension counters) per failure site with serial early-exit loops
(aQueryFasta_thread.cpp:898-1106; the Python oracle is
engine/threading.error_correction_forward).  Every chain's k-mers follow
from the read's and the hypothesis's nucleotides alone; a chain stops at
the first step whose nucleotide the allowed-nucleotide mask refuses, and
the mask is overwritten only where the chain k-mer is PRESENT in the graph
(getNextNucs' stale-mask quirk).

  score_site_np     numpy, one site (copied unchanged from the JAX module);
                    counter-exact against the Python oracle
  score_sites_plain plain torch batch scorer: every mask probe and all
                    62 x k chain k-mers probed at once, then a prefix-AND
                    with the stale-mask forward fill (the JAX batch body)
  score_sites       KJ (csrc/site_scorer.cu) for CUDA tensors: one warp
                    per site, the reference's serial early exit per chain;
                    the plain version for CPU tensors
  make_site_scorer  the batch scorer over a DeviceRPGG's composite graph
                    table, (k-mer, locus) -> 4-bit out-edge mask (the
                    table KB[graph] and KE probe)

K-mers are int64 with NAN64 (past the read, N holes) all ones, i.e. -1.
The JAX module wires the scorer into no runner; neither does the port.
"""

from __future__ import annotations

import numpy as np
import torch

from .._device import resolve_device
from ..index import device_table as dt
from ..kernels.build import (bind, check, kernel_lib, launched, ptr,
                             stream_of)

NAN64 = 0xFFFFFFFFFFFFFFFF

# chain layout: 8 families -> 62 chains.
# (name, n_chains, joff, jmax_off) where step t (1-based) consumes read
# nucleotide rnt[t + joff] and the loop bound is j < min(k + jmax_off,
# nkrem).  Families with two hypothesis nucleotides fold nt1 into the
# chain init.
FAMILIES = (
    ("nem1", 4, 0, 1),    # one mismatch
    ("ned1", 4, -1, 0),   # 1 deletion
    ("nei1", 1, 0, 1),    # 1 insertion
    ("nem2", 16, 1, 2),   # two mismatches
    ("nemd", 16, 0, 1),   # 1 substitution + 1 deletion
    ("ned2", 16, -1, 0),  # 2 deletions
    ("nemi", 4, 1, 2),    # 1 substitution + 1 insertion
    ("nei2", 1, 1, 2),    # 2 insertions
)
NCHAINS = sum(f[1] for f in FAMILIES)          # 62
_OFF = {}
_o = 0
for _n, _c, _j, _m in FAMILIES:
    _OFF[_n] = _o
    _o += _c

MSC = 5  # min extension scores: ms1 = MSC, ms2 = 2 * MSC


def _shift(km, nt, rmask):
    return ((km & rmask) << 2) | nt


def site_inputs(kmers, ki, k):
    """Host prep for one failure site: (w, rnt, good, nkrem).

    w[j] = kmers[ki-1+j] for j in 0..k+2 (NAN64-padded past the read),
    rnt[j] = w[1+j] & 3, good[j] as the reference fills it."""
    nk = len(kmers)
    w = np.full(k + 3, NAN64, dtype=np.uint64)
    hi = min(nk, ki - 1 + k + 3)
    w[: hi - (ki - 1)] = kmers[ki - 1: hi]
    rnt = (w[1:] & np.uint64(3)).astype(np.int64)
    nkrem = nk - ki
    good = np.zeros(k + 2, dtype=bool)
    lim = min(k + 2, nkrem)
    good[:lim] = w[1: 1 + lim] != NAN64
    return w, rnt, good, nkrem


def _graph_masks(gbits_fn, node, k):
    """nts0 (4,), nts1 (4,), nts2 (4,), gnt3 (4,4,4), from <=21 probes.

    gbits_fn(km) -> (present, 4-bit out mask) for a packed k-mer."""
    rmask = (1 << (2 * (k - 1))) - 1
    _, b0 = gbits_fn(node)
    nts0 = np.array([(b0 >> i) & 1 for i in range(4)], dtype=bool)
    nts1 = np.zeros(4, dtype=bool)
    nts2 = np.zeros(4, dtype=bool)
    gnt3 = np.zeros((4, 4, 4), dtype=bool)
    cb = np.zeros(4, dtype=np.int64)          # child edge masks
    for b in range(4):
        if not nts0[b]:
            continue
        c = _shift(int(node), b, rmask)
        _, bits = gbits_fn(c)
        cb[b] = bits
        for i in range(4):
            nts1[i] |= bool((bits >> i) & 1)
        for b1 in range(4):
            if not (bits >> b1) & 1:
                continue
            c2 = _shift(c, b1, rmask)
            _, bits2 = gbits_fn(c2)
            for i in range(4):
                nts2[i] |= bool((bits2 >> i) & 1)
                gnt3[b, b1, i] = bool((bits2 >> i) & 1)
    return nts0, nts1, nts2, gnt3


def chain_table(w, rnt, nts0, gnt3, k):
    """Static chain definitions -> (init k-mer, init 4-bit mask,
    enable, joff, jmax_off) per chain, plus family slices."""
    rmask = (1 << (2 * (k - 1))) - 1
    w0, w1 = int(w[0]), int(w[1])
    oldnt = w1 & 3
    g3m = np.zeros((4, 4), dtype=np.int64)    # gnt3[b, b1] as bitmask
    for b in range(4):
        for b1 in range(4):
            g3m[b, b1] = sum(int(gnt3[b, b1, i]) << i for i in range(4))
    # get_nnts1(nt0) mask: bit nt1 = OR over nt2 of gnt3[nt0, nt1, nt2]
    or1m = np.array([sum((int(gnt3[b, j, :].any()) << j)
                         for j in range(4)) for b in range(4)],
                    dtype=np.int64)
    nts0m = sum(int(nts0[i]) << i for i in range(4))

    init_km = np.zeros(NCHAINS, dtype=np.uint64)
    init_mask = np.zeros(NCHAINS, dtype=np.int64)
    enable = np.zeros(NCHAINS, dtype=bool)
    x0 = [(w1 & ~3) | nt0 for nt0 in range(4)]
    for nt0 in range(4):
        e0 = bool(nts0[nt0])
        o = _OFF["nem1"] + nt0
        init_km[o], init_mask[o], enable[o] = x0[nt0], or1m[nt0], e0
        o = _OFF["ned1"] + nt0
        init_km[o], init_mask[o], enable[o] = x0[nt0], or1m[nt0], e0
        o = _OFF["nemi"] + nt0
        init_km[o], init_mask[o], enable[o] = x0[nt0], or1m[nt0], e0
        for nt1 in range(4):
            e01 = e0 and bool((or1m[nt0] >> nt1) & 1)
            x01 = _shift(x0[nt0], nt1, rmask)
            for fam in ("nem2", "nemd", "ned2"):
                o = _OFF[fam] + nt0 * 4 + nt1
                init_km[o] = x01
                init_mask[o] = g3m[nt0, nt1]
                enable[o] = e01
    for fam in ("nei1", "nei2"):
        o = _OFF[fam]
        init_km[o], init_mask[o], enable[o] = w0, nts0m, True
    return init_km, init_mask, enable


def family_gates(rnt, good, nts0, nts1, nts2, nkrem, mes):
    """The per-family top-level guards (incl. the nem1-elif-nem2
    exclusivity)."""
    g1 = nkrem > 1 and bool(nts1[rnt[1]]) and bool(good[1])
    gates = {
        "nem1": g1,
        "nem2": (not g1) and nkrem > 2 and bool(nts2[rnt[2]])
                and mes >= 2 and bool(good[2]),
        "nemi": nkrem > 2 and bool(nts1[rnt[2]]) and mes >= 2
                and bool(good[2]),
        "nemd": nkrem > 1 and bool(nts2[rnt[1]]) and mes >= 2
                and bool(good[1]),
        "nei1": nkrem > 1 and bool(nts0[rnt[1]]) and bool(good[1]),
        "ned1": bool(nts1[rnt[0]]) and bool(good[0]),
        "nei2": nkrem > 2 and bool(nts0[rnt[2]]) and mes >= 2
                and bool(good[2]),
        "ned2": bool(nts2[rnt[0]]) and mes >= 2 and bool(good[0]),
    }
    return gates


def score_site_np(gbits_fn, kmers, ki, k, mes):
    """Counter-exact numpy mirror of error_correction_forward for one
    site: returns the (62,) counter vector in FAMILIES order.

    gbits_fn(km) -> (present: bool, out-edge 4-bit mask: int)."""
    rmask = (1 << (2 * (k - 1))) - 1
    w, rnt, good, nkrem = site_inputs(np.asarray(kmers, dtype=np.uint64),
                                      ki, k)
    node = int(w[0])
    nts0, nts1, nts2, gnt3 = _graph_masks(gbits_fn, node, k)
    init_km, init_mask, enable = chain_table(w, rnt, nts0, gnt3, k)
    gates = family_gates(rnt, good, nts0, nts1, nts2, nkrem, mes)

    counters = np.zeros(NCHAINS, dtype=np.int64)
    for name, nch, joff, jmax_off in FAMILIES:
        if not gates[name]:
            continue
        jm = min(k + jmax_off, nkrem)
        for c in range(nch):
            o = _OFF[name] + c
            if not enable[o]:
                continue
            km = int(init_km[o])
            mask = int(init_mask[o])
            for t in range(1, k + 1):
                j = t + joff
                if j >= jm or not good[j]:
                    break
                km = _shift(km, int(rnt[j]), rmask)
                if not (mask >> (km & 3)) & 1:
                    break
                counters[o] += 1
                present, bits = gbits_fn(km)
                if present:                    # stale-mask quirk
                    mask = bits
    return counters


def get_edit_from_counters(counters, mes):
    """Exact mirror of ThreadExt.get_edit's priority scan -> (score,
    edits) with edits as [type, '', graph_char] rows."""
    from ..engine.threading import ALPHABET

    score = 0
    edits = []
    c = counters

    def sl(name):
        n = dict((f[0], f[1]) for f in FAMILIES)[name]
        return c[_OFF[name]: _OFF[name] + n]

    nem1, ned1, nei1 = sl("nem1"), sl("ned1"), int(sl("nei1")[0])
    nem2, nemd, ned2 = sl("nem2"), sl("nemd"), sl("ned2")
    nemi, nei2 = sl("nemi"), int(sl("nei2")[0])
    for i in range(4):
        if nem1[i] > score and nem1[i] >= MSC:
            score, edits = int(nem1[i]), [["X", "", ALPHABET[i]]]
    for i in range(4):
        if ned1[i] > score and ned1[i] >= MSC:
            score, edits = int(ned1[i]), [["D", "", ALPHABET[i]]]
    if nei1 > score and nei1 >= MSC:
        score, edits = int(nei1), [["I", "", ""]]
    if mes > 1:
        for i in range(4):
            for j in range(4):
                sm2, smd, sd2 = (int(nem2[i * 4 + j]),
                                 int(nemd[i * 4 + j]),
                                 int(ned2[i * 4 + j]))
                if sm2 > score and sm2 >= 2 * MSC:
                    score, edits = sm2, [["X", "", ALPHABET[i]],
                                         ["X", "", ALPHABET[j]]]
                if smd > score and smd >= 2 * MSC:
                    score, edits = smd, [["X", "", ALPHABET[i]],
                                         ["D", "", ALPHABET[j]]]
                if sd2 > score and sd2 >= 2 * MSC:
                    score, edits = sd2, [["D", "", ALPHABET[i]],
                                         ["D", "", ALPHABET[j]]]
            if nemi[i] > score and nemi[i] >= 2 * MSC:
                score, edits = int(nemi[i]), [["X", "", ALPHABET[i]],
                                              ["I", "", ""]]
        if nei2 > score and nei2 >= 2 * MSC:
            score, edits = int(nei2), [["I", "", ""], ["I", "", ""]]
    return score, edits


def sites_to_batch(site_list, k: int = 21, B: int | None = None):
    """Host prep: [(kmers, ki, locus)] -> padded (w_lo, w_hi, nkrem,
    loc) arrays for make_site_scorer (pad rows score 0: nkrem = 0)."""
    n = len(site_list)
    B = B or n
    w_lo = np.full((B, k + 3), 0xFFFFFFFF, dtype=np.uint32)
    w_hi = np.full((B, k + 3), 0xFFFFFFFF, dtype=np.uint32)
    nkrem = np.zeros(B, dtype=np.int32)
    loc = np.zeros(B, dtype=np.int32)
    for i, (kmers, ki, li) in enumerate(site_list[:B]):
        w, _, _, nr = site_inputs(np.asarray(kmers, dtype=np.uint64),
                                  ki, k)
        w_lo[i] = (w & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        w_hi[i] = (w >> np.uint64(32)).astype(np.uint32)
        nkrem[i] = nr
        loc[i] = li
    return w_lo, w_hi, nkrem, loc


def join_w(w_lo, w_hi) -> np.ndarray:
    """sites_to_batch's u32 halves -> the int64 k-mer windows the port's
    scorers take (NAN64 becomes -1)."""
    return ((np.asarray(w_hi, np.uint64) << np.uint64(32))
            | np.asarray(w_lo, np.uint64)).view(np.int64)


# ---------------------------------------------------------------------------
# the batch scorer: plain torch version and KJ
# ---------------------------------------------------------------------------

# per chain, FAMILIES order: family, joff, jmax_off
_FAMID = np.concatenate([np.full(f[1], i) for i, f in enumerate(FAMILIES)])
_JOFF = np.concatenate([np.full(f[1], f[2]) for f in FAMILIES])
_JMAXO = np.concatenate([np.full(f[1], f[3]) for f in FAMILIES])


def _mask4(b: torch.Tensor) -> torch.Tensor:
    """(..., 4) bool -> (...) int64 4-bit mask."""
    return (b.long() << torch.arange(4, device=b.device)).sum(-1)


def _score_plain(tab, w, nkrem, loc, k: int, mes: int, probes=False,
                 ahead: int = 1):
    """The JAX batch body on int64 tensors.  Returns the (B, 62) int32
    counters, or with ``probes`` the probes of the serial early exit, as
    (site, k-mer) int64 pairs: the node of a site where good[0..2] is not
    all false (no gate opens otherwise), the children its mask allows,
    the grandchildren their masks allow, and a chain step's k-mer where
    the step passed and the next step reads the mask (it is in range and
    good).  With ``ahead`` = D > 1 the chain probes are those of KJ's
    rounds of D steps: step r + d of a round starting at step r where
    step r passed, steps r + 1 .. r + d are in range and good, and the
    next step reads the mask."""
    B, dev = w.shape[0], w.device
    rmask = (1 << (2 * (k - 1))) - 1
    a4 = torch.arange(4, device=dev)
    nkrem = nkrem.long()
    loc = loc.long()
    rnt = w[:, 1:] & 3                                      # (B, k+2)
    jj = torch.arange(k + 2, device=dev)
    good = (w[:, 1:] != -1) & (jj < nkrem.clamp(max=k + 2)[:, None])

    def probe(q, lc):
        found, v, _ = dt.lookup_bucket_plain(tab, q, lc.expand(q.shape))
        return found, v

    # ---- mask probes: node -> children -> grandchildren ----
    node = w[:, 0]
    _, nbits = probe(node, loc)
    nts0 = ((nbits[:, None] >> a4) & 1) > 0                 # (B, 4)
    c = _shift(node[:, None], a4, rmask)                    # (B, 4)
    _, cb = probe(c, loc[:, None])
    cb = torch.where(nts0, cb, 0)
    g = _shift(c[:, :, None], a4, rmask)                    # (B, 4, 4)
    _, gb = probe(g, loc[:, None, None])
    has_e = ((cb[:, :, None] >> a4) & 1) > 0                # (B, 4, 4)
    gb = torch.where(has_e, gb, 0)
    gnt3 = ((gb[..., None] >> a4) & 1) > 0                  # (B, 4, 4, 4)
    nts1 = (nts0[:, :, None] & has_e).any(1)                # (B, 4)
    nts2 = gnt3.any(2).any(1)                               # (B, 4)
    or1m = _mask4(gnt3.any(3))                              # (B, 4): bit nt1
    g3m = _mask4(gnt3)                                      # (B, 4, 4)
    nts0m = _mask4(nts0)                                    # (B,)

    # ---- family gates ----
    def at(m, j):
        return m.gather(1, rnt[:, j:j + 1])[:, 0]

    g0, g1, g2 = good[:, 0], good[:, 1], good[:, 2]
    m2 = mes >= 2
    gate1 = (nkrem > 1) & at(nts1, 1) & g1
    gates = torch.stack([
        gate1,                                              # nem1
        at(nts1, 0) & g0,                                   # ned1
        (nkrem > 1) & at(nts0, 1) & g1,                     # nei1
        ~gate1 & (nkrem > 2) & at(nts2, 2) & m2 & g2,       # nem2
        (nkrem > 1) & at(nts2, 1) & m2 & g1,                # nemd
        at(nts2, 0) & m2 & g0,                              # ned2
        (nkrem > 2) & at(nts1, 2) & m2 & g2,                # nemi
        (nkrem > 2) & at(nts0, 2) & m2 & g2,                # nei2
    ], 1)                                                   # (B, 8)
    gate_chain = gates[:, torch.from_numpy(_FAMID).to(dev)]  # (B, 62)

    # ---- chain inits ----
    x0 = (w[:, 1:2] & ~3) | a4                              # (B, 4)
    x01 = _shift(x0[:, :, None], a4, rmask).reshape(B, 16)
    w0 = w[:, :1]
    init = torch.cat([x0, x0, w0, x01, x01, x01, x0, w0], 1)
    g3m16, n0m = g3m.reshape(B, 16), nts0m[:, None]
    m = torch.cat([or1m, or1m, n0m, g3m16, g3m16, g3m16, or1m, n0m], 1)
    e01 = (nts0[:, :, None] & (((or1m[:, :, None] >> a4) & 1) > 0)
           ).reshape(B, 16)
    tru = torch.ones((B, 1), dtype=torch.bool, device=dev)
    enable = torch.cat([nts0, nts0, tru, e01, e01, e01, nts0, tru], 1)

    # ---- chain k-mers (graph-independent), all probed at once ----
    jt = (torch.from_numpy(_JOFF).to(dev)[None, :]
          + torch.arange(1, k + 1, device=dev)[:, None])    # (k, 62)
    jt_c = jt.clamp(0, k + 1)
    ck, km = [], init
    for t in range(k):
        km = _shift(km, rnt[:, jt_c[t]], rmask)
        ck.append(km)
    ck = torch.stack(ck, 1)                                 # (B, k, 62)
    found, bits = probe(ck, loc[:, None, None])

    # ---- prefix-AND scoring with the stale-mask forward fill ----
    alive = enable & gate_chain
    cnt = torch.zeros((B, NCHAINS), dtype=torch.int32, device=dev)
    jmax = torch.minimum(
        k + torch.from_numpy(_JMAXO).to(dev)[None, :], nkrem[:, None])
    reads = (jt < jmax[:, None, :]) & good.gather(
        1, jt_c.reshape(1, -1).expand(B, -1)).view(B, k, NCHAINS)
    oks = []
    for t in range(k):
        chk = ((m >> (ck[:, t] & 3)) & 1) > 0
        ok = alive & reads[:, t] & chk
        cnt += ok.int()
        m = torch.where(ok & found[:, t], bits[:, t], m)
        alive = ok
        oks.append(ok)
    if not probes:
        return cnt

    # ---- the probes KJ makes ----
    live = good[:, :3].any(1)
    c_live = live[:, None] & nts0
    g_live = c_live[:, :, None] & has_e
    passed = torch.stack(oks, 1)
    step = torch.zeros_like(passed)
    for t in range(k - 1):
        r = t - t % ahead                       # the round's first step
        step[:, t] = passed[:, r] & reads[:, r + 1:t + 2].all(1)
    pick = [(s.nonzero()[:, 0], q[s]) for s, q in
            ((live, node), (c_live, c), (g_live, g), (step, ck))]
    return tuple(torch.cat(p) for p in zip(*pick))


def score_sites_plain(graph_tab, w, nkrem, loc, k: int, mes: int):
    """Plain torch version of KJ.  graph_tab: the composite (k-mer,
    locus) -> out-edge mask DevTable; w (B, k+3) int64 k-mers
    kmers[ki-1 .. ki+k+1] of each site (-1 past the read and at N holes);
    nkrem (B,) int32 = nkmers - ki (0 on a pad row, which scores 0); loc
    (B,) int32 the site's locus.  Returns (B, 62) int32 counters in
    FAMILIES order."""
    return _score_plain(graph_tab, w, nkrem, loc, k, mes)


def site_probes(graph_tab, w, nkrem, loc, k: int, mes: int, ahead: int = 1):
    """The (site, k-mer) int64 pairs of the graph probes on these inputs:
    with ``ahead`` = 1 the early-exit walk's live probes (the probes the
    counters need), with ``ahead`` = D those KJ makes when a round stages
    D steps of each chain (site_scorer_config()["ahead"]);
    score_sites_plain's arguments."""
    return _score_plain(graph_tab, w, nkrem, loc, k, mes, probes=True,
                        ahead=ahead)


def site_scorer_config(lib=None) -> dict:
    """The lookahead D and the keys a probe group takes a pass that KJ
    (csrc/site_scorer.cu, or the build ``lib`` of it) was made with;
    builds KJ on first use (needs nvcc)."""
    c = (lib or kernel_lib("site_scorer")).dtk_site_scorer_config()
    return dict(ahead=c & 0xFF, keys=(c >> 8) & 0xFF)


def score_sites(graph_tab, w, nkrem, loc, k: int, mes: int):
    """KJ: the batch scorer, one warp per site.  Same contract as
    score_sites_plain."""
    if w.device.type == "cpu":
        return score_sites_plain(graph_tab, w, nkrem, loc, k, mes)
    B = w.shape[0]
    if not 16 < k <= 32:
        raise ValueError(f"score_sites: 16 < k <= 32, got {k}")
    if w.dtype != torch.int64 or w.shape != (B, k + 3) \
            or not w.is_contiguous():
        raise ValueError("score_sites: w must be contiguous (B, k+3) int64")
    for t in (nkrem, loc):
        if t.dtype != torch.int32 or t.shape != (B,) \
                or not t.is_contiguous() or t.device != w.device:
            raise ValueError("score_sites: nkrem and loc must be "
                             "contiguous (B,) int32 on w's device")
    if not graph_tab.composite or graph_tab.nval != 1:
        raise ValueError("score_sites: the graph table is a composite "
                         "1-value table")
    if any(t.device != w.device for t in graph_tab.levels):
        raise ValueError("score_sites: table and sites must be on the "
                         "same device")
    out = torch.empty((B, NCHAINS), dtype=torch.int32, device=w.device)
    fn = bind(kernel_lib("site_scorer"), "dtk_site_scorer",
              "iii" + "ppp" + "pppi" + "pp")
    check(fn(B, k, mes, ptr(w), ptr(nkrem), ptr(loc),
             *dt.level_args(graph_tab), ptr(out), stream_of(w)),
          "site_scorer")
    launched("KJ")
    return out


def make_site_scorer(drp, B: int, k: int = 21, mes: int = 2, device=None):
    """The batch hypothesis scorer over B failure sites, probing the
    DeviceRPGG composite graph table ((k-mer, locus) -> edge mask, the
    table the threading walk uses) on ``device`` (cuda by default).

    scorer(w, nkrem, loc) -> (B, 62) int32 counters on the device
      w:     (B, k+3) int64 kmers[ki-1 .. ki+k+1] (-1 past the read and
             at N holes; join_w of sites_to_batch's halves)
      nkrem: (B,) int32 = nkmers - ki
      loc:   (B,) int32 destination locus per site
    Arrays may be numpy or tensors; they are moved to the device."""
    assert 16 < k <= 32, "k-mer windows of 16 < k <= 32"
    dev = resolve_device(device)
    gtab = drp.tables(dev, graph=True)["graph"]

    def scorer(w, nkrem, loc):
        w, nkrem, loc = (torch.as_tensor(x).to(dev, dtype).contiguous()
                         for x, dtype in ((w, torch.int64),
                                          (nkrem, torch.int32),
                                          (loc, torch.int32)))
        if w.shape != (B, k + 3) or nkrem.shape != (B,) \
                or loc.shape != (B,):
            raise ValueError(f"scorer: w ({B}, {k + 3}), nkrem and loc "
                             f"({B},)")
        return score_sites(gtab, w, nkrem, loc, k, mes)

    return scorer
