"""Device aligner in PyTorch: the asgn-mode counting step of
danbing_tk_tpu/engine/device_align.py on tensors, with hand-written CUDA
kernels on the card and their plain torch versions on the CPU.

Pipeline per batch of P read pairs (2P reads, L columns):

  codes (2P, L) u8
   -> KA  extract_kmers: canonical int64 k-mers, and only where the
          mode reads them the forward k-mers (threading) and the
          (k+1)-mer edges (bubbles)                 (ops/kmers.py)
   -> KB  lookup_bucket on the kmerDBi table         (index/device_table.py)
   -> subfilter / kfilter                            (torch ops)
   -> KC  pair_vote: per-pair run table by k-mer, split CSR expansion of
          the vv-listed runs, per-locus totals, top / tie census,
          test1/test2, referee bits, dst0           (csrc/pair_vote.cu)
   -> KF  read_filter (with -qc or -b): the QC mask, dev_pair, and the
          bait filter's per-read k-mer counts (a shared-memory hash
          table) probed against the (kmer, dst0) bait table
                                                     (csrc/read_filter.cu)
   -> KB  lookup_bucket on the (kmer, dst0) trfl table for vv k-mers
   -> KD  assign_count: annotation (and the .kam ann plane with
          with_annot), the assignTRkmc scan, count atomics
                                                     (csrc/assign_count.cu)
   -> KG  novel_edges (with -bu): the tre probe of each counted mate's
          in-segment (k+1)-mer edges, bit-packed  (csrc/novel_edges.cu)

The sampled-k-mer prefilter that runs before the step on 4P pairs takes
its nf queries a read from the host sampler (make_prefilter_step_q) or,
with DTK_PREFILTER_HOSTQ=0 and on the sharded runner, samples them on the
card:

   -> KK  prefilter_sample (make_prefilter_step)   (csrc/prefilter_sample.cu)
   -> KB  lookup_bucket on the membership table (or KI's collective probe)
   -> prefilter_decide                               (torch ops)

In graph-threading mode (cfg.threading) KD stops at the tr_member and slot
planes, and one launch follows:

   -> KE  thread_walk_graph: the (nc kmer, dst0) graph-table probe and the
          clean-walk DFA per mate, up to its first failure, and the
          TR-member count atomics of pairs whose both mates walk clean
                                                     (csrc/thread_walk.cu)

Decision equivalence with the reference is the JAX module's: ties,
test2-only passes and expansion overflows are flagged for the host referee
(engine/host_align.process_pair) and masked out of every device count;
threading pairs whose walk is not clean go to the host threading engine.
Extract (-e) runs on the counting step (its rows come from the runner's
planes); bait tracking (-tb) is the one mode the device engine refuses:
check_ported_config raises NotImplementedError for it (the host engine
runs it).  The quality mask of fastq + bait runs
(qmask_batch) is computed on the host, as in the JAX package.

K-mers are int64 with EMPTY = -1; u32 values (dbi vals, loci, counts) ride
as int64 values or int32 bit patterns.  The state (counts, nmapread, kmc:
u32 as int32 bit patterns; stats: int64) is updated in place.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import numpy as np
import torch

from .._device import resolve_device
from ..index import device_table as dt
from ..kernels.build import (bind, check, kernel_lib, launched, ptr,
                             stream_of)
from ..ops.kmers import EMPTY, extract_kmers, prefilter_sample
from .host_align import AlignConfig, RPGG

NAN32 = 0xFFFFFFFF
_I64MAX = (1 << 63) - 1
_SIGN = -(1 << 63)
_M32 = 0xFFFFFFFF
# KC keeps a pair's tables in one block's shared memory up to the opt-in
# limit of an H100 block, less its static shared memory (larger E: a
# global workspace); the main path's mode leaves room for four blocks an SM
SMEM_LIMIT = 232448
KC_STATIC_BYTES = 1024
KC_SHARED_BYTES = SMEM_LIMIT // 4

# ---------------------------------------------------------------------------
# Host-side table construction from the RPGG (copied from the JAX module)
# ---------------------------------------------------------------------------

ANN_FL = 1
ANN_TR = 2


@dataclass
class DeviceRPGG:
    """Device-resident RPGG model: flat tables + metadata."""
    nloci: int
    dbi_tab: dt.BucketTable
    vv: np.ndarray
    trfl_tab: dt.BucketTable      # (kmer, locus) -> (slot<<2)|ANN  or ANN_FL
    tre_tab: dt.BucketTable | None  # (edge, locus) -> 1
    locus_offsets: np.ndarray     # slot base per locus (trkmc flatten order)
    nslots: int
    bait_tab: dt.BucketTable | None = None  # (kmer, locus) -> (mi<<8)|ma
    qc: np.ndarray | None = None            # u8[nloci] pass mask
    graph_tab: dt.BucketTable | None = None  # (nc kmer, locus) -> edge mask
    member_tab: dt.BucketTable | None = None  # kmer -> (membership only):
    # 2-plane rows for the prefilter, which never reads vals — the
    # narrower row gathers measurably faster than the 4-plane dbi rows

    def tables(self, device, graph: bool = False, bait: bool = False,
               qc: bool = False, tre: bool = False) -> dict:
        """The device tables on ``device``, uploaded once and shared by
        every step made from it (the uploads reach ~7 GB at production
        scale).  Each flag adds one table that only some steps read,
        uploaded on the first call that asks for it, so a counting step
        never holds them: ``graph`` (threading; ~9 GB at production
        scale), ``bait`` (-b), ``qc`` (-qc: the mask as nloci + 1 u8, the
        last entry 0) and ``tre`` (-bu).  Calls with the same flags get
        the same dict."""
        cache = self.__dict__.setdefault("_dev_cache", {})
        dev = _device_key(device)
        key = (dev, graph, bait, qc, tre)
        if key not in cache:
            if (dev, "base") not in cache:
                tabs = {"dbi": self.dbi_tab, "trfl": self.trfl_tab}
                if self.member_tab is not None:
                    tabs["member"] = self.member_tab
                cache[(dev, "base")] = upload_tables(
                    tabs, self.vv, self.locus_offsets, device)
            out = dict(cache[(dev, "base")])
            for name, on in (("graph", graph), ("bait", bait), ("qc", qc),
                             ("tre", tre)):
                if on:
                    if (dev, name) not in cache:
                        cache[(dev, name)] = self._upload(name, device)
                    out[name] = cache[(dev, name)]
            cache[key] = out
        return cache[key]

    def _upload(self, name: str, device):
        if name == "qc":
            if self.qc is None:
                raise ValueError("no QC mask: build the RPGG with a qc file")
            return torch.from_numpy(np.concatenate(
                [np.asarray(self.qc, np.uint8), [0]]).astype(np.uint8)).to(
                    device)
        tab = getattr(self, f"{name}_tab")
        if tab is None:
            raise ValueError(f"no {name} table" + (
                ": call drp.add_graph(rpgg) first" if name == "graph"
                else ""))
        return dt.DevTable.upload(tab, device)

    def release(self, device, name: str) -> None:
        """Drops the device copy of the extra table ``name`` (and every
        cached dict holding it); steps made before still hold theirs."""
        cache = self.__dict__.get("_dev_cache", {})
        dev = _device_key(device)
        for key in [k for k, v in cache.items() if k[0] == dev
                    and (k == (dev, name) or (isinstance(v, dict)
                                              and name in v))]:
            del cache[key]

    def add_graph(self, rpgg: RPGG):
        """Builds the dBG transition table for the threading DFA walk
        (GraphType node -> 4-bit out-edge mask, per locus)."""
        graphs = rpgg.load_graphs()
        gk, gl, gv = [], [], []
        for li, g in enumerate(graphs):
            for km, mask in g.items():
                gk.append(km)
                gl.append(li)
                gv.append(mask)
        self.graph_tab = dt.build_bucket_table(
            np.array(gk, np.uint64), np.array(gv, np.uint32),
            np.array(gl, np.uint32))

    @classmethod
    def build(cls, rpgg: RPGG, with_tre: bool = True) -> "DeviceRPGG":
        keys = np.fromiter(rpgg.dbi.keys(), dtype=np.uint64,
                           count=len(rpgg.dbi))
        vals = np.fromiter(rpgg.dbi.values(), dtype=np.uint32,
                           count=len(rpgg.dbi))

        # trfl annotation entries; TR slot ids follow the .trkmc.ar flatten
        # order (per-locus insertion order of pan.tr.kmers).  Value
        # encoding: (rank << 3) | (in_tr << 2) | ann, where rank is the
        # slot's offset WITHIN its locus (slot = locus_offsets[dst] +
        # rank, resolved on device); ann 1=flank 2=TR (flank wins when a
        # kmer is in both sets, assignTRkmc :1464-1467, but aln-mode
        # counting still needs the TR slot -> in_tr bit).  Rank encoding
        # keeps the u32 value plane valid at production index scale:
        # global slots reach 1.2e9 (>2^29, which a (slot<<3) u32 cannot
        # hold), ranks stay < kmers-per-locus.
        tk, tl, tv = [], [], []
        offsets = np.zeros(rpgg.nloci + 1, dtype=np.int64)
        slot = 0
        for li in range(rpgg.nloci):
            offsets[li] = slot
            fl = rpgg.fl_sets[li]
            for rank, km in enumerate(rpgg.tr_orders[li]):
                tk.append(km)
                tl.append(li)
                if km in fl:
                    tv.append((rank << 3) | (1 << 2) | ANN_FL)
                else:
                    tv.append((rank << 3) | ANN_TR)
                slot += 1
            for km in fl:
                if km not in rpgg.tr_counts[li]:
                    tk.append(km)
                    tl.append(li)
                    tv.append(ANN_FL)
        offsets[rpgg.nloci] = slot

        # A single-locus k-mer (even dbi encoding) has exactly ONE trfl
        # entry — (km, its locus) — so its annotation value rides in the
        # dbi row itself (second value plane; same gather, descriptor-
        # bound so the wider row is free).  Only multi-locus (vv) k-mers
        # keep composite-table entries, which shrinks the trfl table to
        # the sharing tail and turns most annotation-probe lanes into
        # constant-bucket no-ops (see make_step).
        tk_a = np.array(tk, dtype=np.uint64)
        tl_a = np.array(tl, dtype=np.uint32)
        tv_a = np.array(tv, dtype=np.uint32)
        korder = np.argsort(keys, kind="stable")
        sk = keys[korder]
        pos = np.searchsorted(sk, tk_a)
        if len(tk_a):
            assert len(sk) > 0, "trfl kmers present but kmerDBi is empty"
            assert (sk[np.minimum(pos, len(sk) - 1)] == tk_a).all(), \
                "trfl kmer missing from kmerDBi"
        entry_even = (vals[korder[pos]] & 1) == 0 if len(tk_a) else \
            np.zeros(0, dtype=bool)
        ee = korder[pos[entry_even]]
        # an even (single-locus) dbi entry must (a) point at the same
        # locus as its trfl entry — ev_hit attaches the annotation at the
        # dbi-encoded locus — and (b) own exactly ONE trfl entry; an
        # index violating either would silently corrupt annotations, so
        # fail loudly at build time instead
        assert (tl_a[entry_even] == (vals[ee] >> 1)).all(), \
            "single-locus dbi entry locus != its trfl entry locus"
        if len(ee):
            ees = np.sort(ee)
            assert not (ees[1:] == ees[:-1]).any(), \
                "multiple trfl entries map to one single-locus dbi entry"
        ann = np.zeros(len(keys), dtype=np.uint32)
        ann[ee] = tv_a[entry_even]
        dbi_tab = dt.build_bucket_table(keys, vals, vals2=ann)
        trfl_tab = dt.build_bucket_table(
            tk_a[~entry_even], tv_a[~entry_even], tl_a[~entry_even])

        tre_tab = None
        if with_tre:
            ek, el = [], []
            for li in range(rpgg.nloci):
                for e in rpgg.tre_sets[li]:
                    ek.append(e)
                    el.append(li)
            if ek:
                tre_tab = dt.build_bucket_table(
                    np.array(ek, dtype=np.uint64),
                    np.ones(len(ek), dtype=np.uint32),
                    np.array(el, dtype=np.uint32))
        vv = rpgg.vv.astype(np.uint32)
        if len(vv) == 0:
            vv = np.zeros(1, dtype=np.uint32)  # keep gathers well-formed
        bait_tab = None
        if rpgg.bait_dbs is not None:
            bk, bl, bv = [], [], []
            for li, db in enumerate(rpgg.bait_dbs):
                for km, v in db.items():
                    bk.append(km)
                    bl.append(li)
                    bv.append(v)
            if bk:
                bait_tab = dt.build_bucket_table(
                    np.array(bk, np.uint64), np.array(bv, np.uint32),
                    np.array(bl, np.uint32))
        qc = rpgg.qc_filter
        member_tab = dt.build_bucket_table(keys, None)
        return cls(rpgg.nloci, dbi_tab, vv, trfl_tab,
                   tre_tab, offsets, slot, bait_tab, qc,
                   member_tab=member_tab)


def _device_key(device) -> str:
    """One cache key per device: "cuda" and "cuda:<current>" name the
    same card (a second key would upload every table twice)."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return str(dev)


def upload_tables(tables: dict, vv: np.ndarray, locus_offsets: np.ndarray,
                  device) -> dict:
    """Turns numpy tables built by either package into the port's device
    tables: ``tables`` maps a name ("dbi", "member", "trfl", ...) to a
    BucketTable (its ``levels`` [(u32 rows, salt)], ``composite`` and
    ``nval``); each level is uploaded as an int32 view of the same bytes.
    ``vv`` (u32) becomes int32 bit patterns (at least one entry, so its
    clamped gathers stay well-formed); ``locus_offsets`` int64."""
    out = {name: dt.DevTable.upload(tab, device)
           for name, tab in tables.items() if tab is not None}
    vv = np.asarray(vv, dtype=np.uint32)
    if len(vv) == 0:
        vv = np.zeros(1, dtype=np.uint32)
    out["vv"] = torch.from_numpy(np.ascontiguousarray(vv).view(
        np.int32)).to(device)
    out["loff"] = torch.from_numpy(np.asarray(
        locus_offsets, dtype=np.int64)).to(device)
    return out


def init_state(drp: DeviceRPGG, device=None) -> dict:
    dev = resolve_device(device)
    return dict(
        counts=torch.zeros(drp.nslots + 1, dtype=torch.int32, device=dev),
        nmapread=torch.zeros(drp.nloci + 1, dtype=torch.int32, device=dev),
        kmc=torch.zeros(drp.nloci + 1, dtype=torch.int32, device=dev),
        stats=torch.zeros(9, dtype=torch.int64, device=dev),
    )


def state_u32(t: torch.Tensor) -> np.ndarray:
    """A u32 accumulator (int32 bit patterns) as a host uint32 array."""
    return t.cpu().numpy().view(np.uint32)


# ---------------------------------------------------------------------------
# small torch helpers (plain versions)
# ---------------------------------------------------------------------------

def _take(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """a[..., idx] per row with idx clamped into range (JAX's clamping
    gather)."""
    idx = idx.clamp(0, a.shape[-1] - 1).long()
    return a.gather(-1, idx.unsqueeze(-1)).squeeze(-1)


def _first_true(m: torch.Tensor) -> torch.Tensor:
    """Index of the first True along -1, or the width if none."""
    w = m.shape[-1]
    ar = torch.arange(w, device=m.device)
    return torch.where(m, ar, w).amin(dim=-1)


def _pad0(x: torch.Tensor) -> torch.Tensor:
    """Exclusive-prefix layout: a zero column in front of cumsum(x)."""
    return torch.nn.functional.pad(x.long().cumsum(-1), (1, 0))


def _rev_cummin(x: torch.Tensor) -> torch.Tensor:
    return x.flip(-1).cummin(-1).values.flip(-1)


def _u32_unsigned_key(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """int64 whose signed order is the unsigned order of (hi << 32) | lo
    for u32 hi, lo held as int64."""
    return ((hi << 32) | lo) ^ _SIGN


# ---------------------------------------------------------------------------
# KC pair_vote
# ---------------------------------------------------------------------------

def pair_vote_plain(kmer, val, use, pair_kf, vv, E: int, cth: int):
    """Plain torch version of KC.  kmer/val (2P, NKW) int64 (val: the dbi
    u32 value), use (2P, NKW) bool, pair_kf (P,) bool, vv int32 bit
    patterns of u32.  Returns dst0 (P,) int64 (NAN32 when the pair has no
    entries), vote_pass (P,) bool and referee_pack (P,) uint8 (bit 0
    referee, 1 unresolved tie, 2 expansion overflow, 3 test2-only)."""
    dev = kmer.device
    P = pair_kf.shape[0]
    NKW = kmer.shape[1]
    W = 2 * NKW
    nvv = vv.shape[0]
    vv64 = vv.long() & _M32

    def vv_at(pos):
        return vv64[pos.clamp(0, nvv - 1)]

    # ---- per-pair dedupe sort: unused entries sort last ----
    key = torch.where(use, kmer, _I64MAX).reshape(P, W)
    s_key, order = torch.sort(key, dim=1, stable=True)
    mate = (torch.arange(W, device=dev) >= NKW).long().expand(P, W)
    s_val = val.reshape(P, W).gather(1, order)
    s_mate = mate.gather(1, order)
    s_use = s_key != _I64MAX
    first = torch.ones((P, 1), dtype=torch.bool, device=dev)
    newrun = s_use & torch.cat([first, s_key[:, 1:] != s_key[:, :-1]], 1)
    widx = torch.arange(W, device=dev).expand(P, W)
    nxt = torch.cat([_rev_cummin(torch.where(newrun, widx, W))[:, 1:],
                     torch.full((P, 1), W, device=dev)], 1)
    nuse = s_use.sum(1, keepdim=True)
    run_end = torch.where(s_use, torch.minimum(nxt, nuse), 0)
    cf = _pad0(s_use & (s_mate == 0))
    cr = _pad0(s_use & (s_mate == 1))
    fcnt = torch.where(newrun, cf.gather(1, run_end) - cf[:, :-1], 0)
    rcnt = torch.where(newrun, cr.gather(1, run_end) - cr[:, :-1], 0)
    rval = s_val
    odd = (rval & 1) == 1
    nmapped = torch.where(newrun, torch.where(odd, vv_at(rval >> 1), 1), 0)

    # ---- split CSR expansion of vv-listed (odd) runs into E slots ----
    odd_run = newrun & odd
    nm_x = torch.where(odd_run, nmapped, 0)
    csum = nm_x.cumsum(1)
    total = csum[:, -1]
    overflow = total > E
    starts = csum - nm_x
    eidx = torch.arange(E, device=dev).expand(P, E).contiguous()
    evalid = eidx < total.clamp(max=E)[:, None]
    # covering run of slot e: the first run whose inclusive prefix
    # passes e (an empty slot past `total` gathers 0, as the one-hot did)
    j = torch.searchsorted(csum, eidx, right=True).clamp(max=W - 1)

    def at_cover(x):
        return torch.where(evalid, x.gather(1, j), 0)

    e_rval, e_st = at_cover(rval), at_cover(starts)
    e_f, e_r, e_nm = at_cover(fcnt), at_cover(rcnt), at_cover(nmapped)
    e_odd = (e_rval & 1) == 1
    e_locus = torch.where(e_odd, vv_at((e_rval >> 1) + 1 + eidx - e_st),
                          e_rval >> 1)
    e_locus = torch.where(evalid, e_locus, NAN32)
    even_run = newrun & ~odd_run
    ev_locus = torch.cat([torch.where(even_run, rval >> 1, NAN32),
                          e_locus], 1)
    ev_f = torch.cat([torch.where(even_run, fcnt, 0), e_f], 1)
    ev_r = torch.cat([torch.where(even_run, rcnt, 0), e_r], 1)
    ev_nm = torch.cat([even_run.long(), e_nm], 1)
    ev_starts = torch.cat([widx, W + e_st], 1)
    ev_run_nm = torch.cat([torch.ones((P, W), dtype=torch.int64,
                                      device=dev), e_nm], 1)
    EV = W + E

    # ---- per-(pair, locus) totals: sort events by (locus, -nm) ----
    ekey = _u32_unsigned_key(ev_locus, _M32 - ev_nm)
    _, gsrc = torch.sort(ekey, dim=1, stable=True)
    g_loc = ev_locus.gather(1, gsrc)
    g_nm = ev_nm.gather(1, gsrc)
    g_f, g_r = ev_f.gather(1, gsrc), ev_r.gather(1, gsrc)
    g_valid = g_loc != NAN32
    segnew = g_valid & torch.cat([first, g_loc[:, 1:] != g_loc[:, :-1]], 1)
    segnew_pad = torch.cat([segnew, first], 1)
    gcf, gcr = _pad0(g_f), _pad0(g_r)
    gcf_end = _rev_cummin(torch.where(segnew_pad, gcf, _I64MAX))[:, 1:]
    gcr_end = _rev_cummin(torch.where(segnew_pad, gcr, _I64MAX))[:, 1:]
    seg_f = torch.where(segnew, gcf_end - gcf[:, :-1], 0)
    seg_r = torch.where(segnew, gcr_end - gcr[:, :-1], 0)
    seg_tot = torch.where(segnew, seg_f + seg_r, -1)
    top_tot = seg_tot.amax(1, keepdim=True)
    is_top = segnew & (seg_tot == top_tot)
    n_top = is_top.sum(1)
    top_seg = _first_true(is_top)
    top_loc, top_f, top_r = (_take(g_loc, top_seg), _take(seg_f, top_seg),
                             _take(seg_r, top_seg))
    has_entries = segnew.any(1)
    tie = (n_top > 1) & has_entries

    # ---- scan-order tie resolution (see the JAX module) ----
    BIGI = 0x7FFFFFF0
    seg_nm = torch.where(segnew, g_nm, 0)
    m_lvl = torch.where(is_top, seg_nm, BIGI).amin(1, keepdim=True)
    cand_seg = is_top & (seg_nm == m_lvl)
    nC = cand_seg.sum(1)
    winner1 = torch.where(cand_seg, g_loc, NAN32).amin(1)
    gidx = torch.arange(EV, device=dev).expand(P, EV)
    seg_start = torch.where(segnew, gidx, -1).cummax(1).values
    in_cand = cand_seg.gather(1, seg_start.clamp(min=0)) & (seg_start >= 0)
    g_cand = in_cand & (g_nm == m_lvl) & g_valid
    e_cand = torch.zeros_like(g_cand).scatter_(1, gsrc, g_cand)
    ccum = _pad0(e_cand)
    c_start = ccum.gather(1, ev_starts.clamp(0, EV))
    c_end = ccum.gather(1, (ev_starts + ev_run_nm).clamp(max=EV))
    ccr = c_end - c_start
    c_before = ccum[:, :-1] - c_start
    firstflag = e_cand & (c_before == 0)
    ok_counts = ~(e_cand & (ccr != nC[:, None])).any(1)
    floc_min = torch.where(firstflag, ev_locus, NAN32).amin(1)
    floc_max = torch.where(firstflag, ev_locus, 0).amax(1)
    multi_ok = ok_counts & (floc_min == floc_max) & (floc_min != NAN32)
    tie_res = tie & torch.where(nC == 1, True, multi_ok)
    win_loc = torch.where(nC == 1, winner1, floc_min)
    use_win = tie & tie_res
    wseg = _first_true(segnew & (g_loc == win_loc[:, None]))
    top_loc = torch.where(use_win, win_loc, top_loc)
    top_f = torch.where(use_win, _take(seg_f, wseg), top_f)
    top_r = torch.where(use_win, _take(seg_r, wseg), top_r)

    test1 = (top_f >= cth) & (top_r >= cth)
    test2 = (top_f + top_r) >= 2 * cth
    vote_pass = (test1 | test2) & has_entries & pair_kf
    r_tie = pair_kf & tie & ~tie_res
    r_ovf = pair_kf & overflow
    r_t2 = pair_kf & ~test1 & test2
    referee = r_tie | r_ovf | r_t2
    pack = (referee.to(torch.uint8) | (r_tie.to(torch.uint8) << 1)
            | (r_ovf.to(torch.uint8) << 2) | (r_t2.to(torch.uint8) << 3))
    dst0 = torch.where(has_entries, top_loc, NAN32)
    return dst0, vote_pass, pack


def _r16(b: int) -> int:
    return -(-b // 16) * 16


def kc_smem_bytes(W: int, E: int) -> int:
    """Bytes of one pair's tables in KC for W entries and E expansion
    slots (csrc/pair_vote.cu kc_layout lays them out; the wrapper checks
    the two agree): a k-mer table of CE = 1.5 W and a locus table of
    CL = 1.125 (W + E) 16-byte records (each rounded up to 32 records),
    the distinct-locus list (W + E u32) and the odd-run arrays (28 W)."""
    EV = W + E
    ce = (3 * W // 2 + 31) // 32 * 32
    cl = (EV + EV // 8 + 31) // 32 * 32
    return (16 * ce + 16 * cl + _r16(4 * EV) + 2 * _r16(8 * W)
            + 3 * _r16(4 * W))


def check_vote_shape(W: int, E: int) -> str:
    """KC's mode for a pair of W entries and E expansion slots, from the
    shape alone: "shared" (128 threads a pair) while the tables leave room
    for four blocks an SM, "large-E" (512 threads, the retry tier's
    instance) while they fit one block's shared memory, else "global"
    (512 threads, the tables in a global workspace of
    kc_workspace_stride(W, E) bytes a pair; counted as KC[large-E] too)."""
    if W < 2 or E < 1:
        raise ValueError(f"pair_vote needs W >= 2 and E >= 1, got W={W}, "
                         f"E={E}")
    if W >= 1 << 16 or (W + E) * W >= 1 << 32:
        # the per-run counts are u16 halves, the per-locus sums u32 halves
        raise ValueError(f"pair_vote: W={W}, E={E} is past its counters")
    b = kc_smem_bytes(W, E)
    if b <= KC_SHARED_BYTES:
        return "shared"
    return "large-E" if b <= SMEM_LIMIT - KC_STATIC_BYTES else "global"


def kc_workspace_stride(W: int, E: int) -> int:
    """Bytes of one pair's slice of the global-mode workspace (the shared
    layout, rounded up to 256 B)."""
    return -(-kc_smem_bytes(W, E) // 256) * 256


_KC_MODES = {"shared": 0, "large-E": 1, "global": 2}


@functools.lru_cache(maxsize=None)
def _kc_layout_checked(NKW: int, E: int) -> int:
    """kc_smem_bytes(2 NKW, E), once checked against the kernel's own
    layout (csrc/pair_vote.cu dtk_pair_vote_bytes)."""
    nbytes = kc_smem_bytes(2 * NKW, E)
    need = bind(kernel_lib("pair_vote"), "dtk_pair_vote_bytes", "ii")
    need.restype = ctypes.c_int64
    if need(NKW, E) != nbytes:
        raise RuntimeError("pair_vote: kc_smem_bytes disagrees with "
                           "csrc/pair_vote.cu's layout")
    return nbytes


def pair_vote(kmer, val, use, pair_kf, vv, E: int, cth: int):
    """KC: the per-pair vote.  Same inputs and results as
    ``pair_vote_plain``; one CUDA block per pair on the card, its tables
    in shared memory, or with an E too large for that in a global
    workspace.  The mode comes from the shape (check_vote_shape); the
    main path's E counts as "KC", the retry tier's and any larger E
    as "KC[large-E]"."""
    if kmer.device.type == "cpu":
        return pair_vote_plain(kmer, val, use, pair_kf, vv, E, cth)
    P, NKW = pair_kf.shape[0], kmer.shape[1]
    if kmer.shape[0] != 2 * P or val.shape != kmer.shape \
            or use.shape != kmer.shape:
        raise ValueError("pair_vote: kmer/val/use must be (2P, NKW)")
    mode = check_vote_shape(2 * NKW, E)
    dev = kmer.device
    kmer, val = kmer.contiguous(), val.contiguous()
    use, pair_kf, vv = use.contiguous(), pair_kf.contiguous(), \
        vv.contiguous()
    dst0 = torch.empty(P, dtype=torch.int64, device=dev)
    vote_pass = torch.empty(P, dtype=torch.bool, device=dev)
    pack = torch.empty(P, dtype=torch.uint8, device=dev)
    lib = kernel_lib("pair_vote")
    nbytes = _kc_layout_checked(NKW, E)
    ws, stride = None, 0
    if mode == "global":
        stride = kc_workspace_stride(2 * NKW, E)
        ws = torch.empty(max(P, 1) * stride, dtype=torch.uint8, device=dev)
    fn = bind(lib, "dtk_pair_vote", "ppppiipiiiiipipppp")
    check(fn(ptr(kmer), ptr(val), ptr(use), ptr(pair_kf), P, NKW, ptr(vv),
             vv.shape[0], E, cth, _KC_MODES[mode], nbytes,
             None if ws is None else ptr(ws), stride, ptr(dst0),
             ptr(vote_pass), ptr(pack), stream_of(kmer)),
          f"pair_vote[{mode}]")
    launched("KC" if mode == "shared" else "KC[large-E]")
    return dst0, vote_pass, pack


# ---------------------------------------------------------------------------
# KD assign_count
# ---------------------------------------------------------------------------

ASSIGN_KEYS = ("rm", "af", "nt", "bs", "ti", "si", "ei", "si_", "ei_")


def _add_u32(acc: torch.Tensor, idx: torch.Tensor, inc: torch.Tensor):
    """acc[idx] += inc with u32 wrap, acc holding int32 bit patterns;
    out-of-range indices are dropped (JAX's mode="drop")."""
    n = acc.shape[0]
    keep = (idx >= 0) & (idx < n)
    add = torch.zeros(n, dtype=torch.int64, device=acc.device)
    add.index_add_(0, idx[keep], inc[keep].long())
    s = ((acc.long() & _M32) + add) & _M32
    acc.copy_(torch.where(s >= (1 << 31), s - (1 << 32), s).int())


def assign_count_plain(state, found, val, annv, kvalid, afound_t, aval_t,
                       dst0, dev_pair, kf, nk, loff, nloci: int, nm_tr: int,
                       threading: bool = False, bf_pair=None,
                       annot: bool = False):
    """Plain torch version of KD.  found/kvalid/afound_t (2P, NKW) bool
    (found already masked by kvalid); val/annv/aval_t (2P, NKW) int64 u32
    values from the dbi and trfl probes; dst0 (P,) int64; dev_pair (P,)
    bool; kf/nk (2P,) int32; bf_pair (P,) bool or None (KF's bait
    verdict: a filtered pair's mates enter removed).  Adds the pairs' TR
    k-mer counts, nmapread and kmc into ``state`` in place and returns the
    per-read assignTRkmc fields (ASSIGN_KEYS, each (2P,) int32), with
    ``annot`` also the (2P, NKW) uint8 "ann" plane.  With ``threading``
    the state is left alone and the result also holds the (2P, NKW)
    planes "tr_member" (uint8) and "slot" (int64), KE's inputs."""
    dev = found.device
    R, NKW = found.shape
    P = R // 2
    nslots = state["counts"].shape[0] - 1
    dst0_read = dst0.repeat_interleave(2)
    devr = dev_pair.repeat_interleave(2)
    ev_hit = found & ((val & 1) == 0) & ((val >> 1) == dst0_read[:, None])
    afound = (afound_t | ev_hit) & kvalid & devr[:, None]
    aval = torch.where(ev_hit, annv, aval_t)
    ann = torch.where(afound, aval & 3, 0)
    base = loff[dst0_read.clamp(0, nloci)]
    slot = base[:, None] + (aval >> 3)

    pos = torch.arange(NKW, device=dev).expand(R, NKW)
    known = ann > 0
    # last nonzero annotation strictly before i (0 if none)
    lki = torch.where(known, pos, -1).cummax(1).values   # last known <= i
    lk_idx = torch.cat([torch.full((R, 1), -1, device=dev),
                        lki[:, :-1]], 1)
    lk = torch.where(lk_idx >= 0, ann.gather(1, lk_idx.clamp(min=0)), 0)
    trans = known & (lk > 0) & (ann != lk)
    cumtrans = trans.long().cumsum(1)
    nt_total = cumtrans[:, -1]
    ti1 = _first_true(trans)
    ti2 = _first_true(trans & (cumtrans == 2))
    fk = _first_true(known)
    bs = torch.where(fk < NKW, _take(ann, fk), 0)
    ntr = (ann == 2).sum(1)
    adj1 = (nt_total >= 1) & (_take(ann, ti1 - 1) == 0)
    si1 = torch.where(adj1, _take(lki, ti1 - 1) + 1, -1)
    ei1 = torch.where(adj1, ti1, -1)
    adj2 = (nt_total >= 2) & (_take(ann, ti2 - 1) == 0)
    si2 = torch.where(adj2, _take(lki, ti2 - 1) + 1, -1)
    ei2 = torch.where(adj2, ti2, -1)

    rm_entry = kf == 1
    if bf_pair is not None:
        rm_entry = rm_entry | bf_pair.repeat_interleave(2)
    nt_rec = torch.where((bs == 2) & (nt_total >= 2), 2,
                         torch.where((bs == 1) & (nt_total >= 3), 3,
                                     nt_total))
    af_early = ((bs == 2) & (nt_total >= 2)) | ((bs == 1) & (nt_total >= 3))
    af_nt0 = (nt_total == 0) & (bs != 2)
    af_nt2 = (nt_total == 2) & (bs == 1) & (ntr < nm_tr)
    af = torch.where(rm_entry, False, af_early | af_nt0 | af_nt2) & devr
    rm = torch.where(devr, rm_entry | af, True)
    ok = ~af & ~rm_entry & devr
    nkr = nk.long()
    mid1 = torch.where(si1 >= 0, (si1 + ei1) // 2, ti1)
    mid2 = torch.where(si2 >= 0, (si2 + ei2) // 2, ti2)
    nt0, nt1, b1 = nt_total == 0, nt_total == 1, bs == 1
    si = torch.where(nt0, 0, torch.where(nt1, torch.where(b1, mid1, 0),
                                         mid1))
    ei = torch.where(nt0, nkr, torch.where(nt1, torch.where(b1, nkr, mid1),
                                           mid2))
    si_ = torch.where(nt0, 0, torch.where(
        nt1, torch.where(b1, torch.where(si1 >= 0, ei1, ti1), 0),
        torch.where(ei1 >= 0, ei1, ti1)))
    ei_ = torch.where(nt0, nkr, torch.where(
        nt1, torch.where(b1, nkr, torch.where(si1 >= 0, si1, ti1)),
        torch.where(si2 >= 0, si2, ti2)))
    si, ei = torch.where(ok, si, -1), torch.where(ok, ei, -1)
    si_, ei_ = torch.where(ok, si_, -1), torch.where(ok, ei_, -1)
    rmd = rm_entry & devr
    out = dict(rm=rm, af=af, nt=torch.where(rmd, -1, nt_rec),
               bs=torch.where(rmd, -1, bs),
               ti=torch.where(rmd, -1, torch.where(nt_total >= 1, ti1, -1)),
               si=si, ei=ei, si_=si_, ei_=ei_)
    out = {k: v.int() for k, v in out.items()}
    if annot:
        out["ann"] = ann.to(torch.uint8)
    if threading:
        in_tr = afound & (((aval >> 2) & 1) == 1)
        out["tr_member"] = (((ann == 2) | in_tr) & kvalid).to(torch.uint8)
        out["slot"] = slot
        return out

    # ---- accumulation ----
    rm_p = rm.view(P, 2)
    counted = dev_pair & ~rm_p.all(1)
    nmate = 2 - rm_p.long().sum(1)
    seglen = (ei - si).clamp(min=0).view(P, 2).sum(1)
    do_count = (ann == 2) & (~rm & counted.repeat_interleave(2))[:, None]
    cslot = torch.where(do_count, slot, nslots).reshape(-1)
    _add_u32(state["counts"], cslot, torch.ones_like(cslot))
    dcl = torch.where(counted, dst0, nloci).clamp(0, nloci)
    _add_u32(state["nmapread"], dcl, torch.where(counted, nmate, 0))
    _add_u32(state["kmc"], dcl, torch.where(counted, seglen, 0))
    return out


def assign_count_grid(P: int) -> tuple:
    """KD's launch for P pairs on the card: (blocks, warps), one warp a
    read (builds the kernel library)."""
    per = bind(kernel_lib("assign_count"), "dtk_assign_count_block_warps",
               "")()
    return -(-2 * P // per), 2 * P


def assign_count(state, found, val, annv, kvalid, afound_t, aval_t,
                 dst0, dev_pair, kf, nk, loff, nloci: int, nm_tr: int,
                 threading: bool = False, bf_pair=None, annot: bool = False):
    """KD: annotation, the assignTRkmc scan per read (a warp a read, as a
    warp scan over chunks of 32 positions) and the count scatter (u32
    atomics).  Same contract as assign_count_plain."""
    if found.device.type == "cpu":
        return assign_count_plain(state, found, val, annv, kvalid,
                                  afound_t, aval_t, dst0, dev_pair, kf, nk,
                                  loff, nloci, nm_tr, threading, bf_pair,
                                  annot)
    R, NKW = found.shape
    P = R // 2
    for t in (found, kvalid, afound_t):
        if t.dtype != torch.bool or t.shape != (R, NKW):
            raise ValueError("assign_count: bool planes must be (2P, NKW)")
    for t in (val, annv, aval_t):
        if t.dtype != torch.int64 or t.shape != (R, NKW):
            raise ValueError("assign_count: value planes must be int64")
    for name in ("counts", "nmapread", "kmc"):
        if state[name].dtype != torch.int32:
            raise ValueError(f"state[{name!r}] must be int32")
    if bf_pair is not None and (bf_pair.dtype != torch.bool
                                or bf_pair.shape != (P,)):
        raise ValueError("assign_count: bf_pair must be (P,) bool")
    args = [x.contiguous() for x in (found, val, annv, kvalid, afound_t,
                                      aval_t, dst0, dev_pair)]
    bf_pair = None if bf_pair is None else bf_pair.contiguous()
    kf = kf.to(torch.int32).contiguous()
    nk = nk.to(torch.int32).contiguous()
    loff = loff.contiguous()
    out = torch.empty((len(ASSIGN_KEYS), R), dtype=torch.int32,
                      device=found.device)
    tr_member = slot = None
    if threading:
        tr_member = torch.empty((R, NKW), dtype=torch.uint8,
                                device=found.device)
        slot = torch.empty((R, NKW), dtype=torch.int64, device=found.device)
    ann = torch.empty((R, NKW), dtype=torch.uint8, device=found.device) \
        if annot else None
    fn = bind(kernel_lib("assign_count"), "dtk_assign_count",
              "ii" + "p" * 12 + "iiiii" + "p" * 8)
    check(fn(P, NKW, *[ptr(a) for a in args],
             None if bf_pair is None else ptr(bf_pair), ptr(kf), ptr(nk),
             ptr(loff), nloci, state["counts"].shape[0] - 1, nm_tr,
             int(threading), int(annot), ptr(state["counts"]),
             ptr(state["nmapread"]), ptr(state["kmc"]), ptr(out),
             None if tr_member is None else ptr(tr_member),
             None if slot is None else ptr(slot),
             None if ann is None else ptr(ann), stream_of(found)),
          "assign_count")
    launched("KD")
    res = dict(zip(ASSIGN_KEYS, out.unbind(0)))
    if annot:
        res["ann"] = ann
    if threading:
        res.update(tr_member=tr_member, slot=slot)
    return res


# ---------------------------------------------------------------------------
# KE thread_walk
# ---------------------------------------------------------------------------

def thread_walk_plain(state, nc, gfound, gmask, kvalid, nk, dev_pair,
                      tr_member, slot):
    """Plain torch version of KE.  nc (2P, NKW) int64 forward k-mers
    (EMPTY-masked, KA's "nc"); gfound bool / gmask int64 (2P, NKW): KB on
    the graph table at (nc, dst0); kvalid (2P, NKW) bool; nk (2P,) int32;
    dev_pair (P,) bool; tr_member (2P, NKW) uint8 and slot (2P, NKW)
    int64 from KD's threading mode.  Adds the TR-member counts of pairs
    whose both mates walk clean into state["counts"] in place (every other
    position into the trash slot) and returns (clean (2P,) bool,
    clean_pair (P,) bool)."""
    R, NKW = nc.shape
    P = R // 2
    nslots = state["counts"].shape[0] - 1
    pos = torch.arange(NKW, device=nc.device)
    in_read = pos < nk.long()[:, None]
    no_n = (kvalid | ~in_read).all(1)
    same_prev = (nc[:, 1:] == nc[:, :-1]) & in_read[:, 1:]
    no_homo = ~same_prev.any(1)
    nb = nc & 3
    trans_ok = (gfound[:, :-1] & (((gmask[:, :-1] >> nb[:, 1:]) & 1) == 1)
                ) | ~in_read[:, 1:]
    node_ok = gfound | ~in_read
    clean = (no_n & no_homo & trans_ok.all(1) & node_ok.all(1) & (nk > 0)
             & dev_pair.repeat_interleave(2))
    clean_pair = clean.view(P, 2).all(1)
    thr_dev = dev_pair & clean_pair
    do_count = (tr_member != 0) & in_read \
        & thr_dev.repeat_interleave(2)[:, None]
    cslot = torch.where(do_count, slot, nslots).reshape(-1)
    _add_u32(state["counts"], cslot, torch.ones_like(cslot))
    return clean, clean_pair


def thread_walk_graph_plain(state, graph, nc, dst0, kvalid, nk, dev_pair,
                            tr_member, slot):
    """Plain torch version of KE: KB's plain version on the graph table
    (a DevTable) at (nc, dst0) (dst0 (P,) int64), then thread_walk_plain
    on its (gfound, gmask).  Same state update and returns as
    thread_walk_plain."""
    loc = dst0.repeat_interleave(2)[:, None].expand(-1, nc.shape[1])
    gfound, gmask, _ = dt.lookup_bucket_plain(graph, nc, loc)
    return thread_walk_plain(state, nc, gfound, gmask, kvalid, nk, dev_pair,
                             tr_member, slot)


def thread_walk_grid(P: int) -> tuple:
    """KE's launch for P pairs on the card: (blocks, warps), one warp a
    mate (builds the kernel library)."""
    per = bind(kernel_lib("thread_walk"), "dtk_thread_walk_block_warps",
               "")()
    return -(-2 * P // per), 2 * P


def thread_walk_graph(state, graph, nc, dst0, kvalid, nk, dev_pair,
                      tr_member, slot):
    """KE: the graph probe at (nc, dst0), the threading DFA walk up to each
    mate's first failure and the count scatter (u32 atomics), a warp a
    mate.  Same contract as thread_walk_graph_plain."""
    if nc.device.type == "cpu":
        return thread_walk_graph_plain(state, graph, nc, dst0, kvalid, nk,
                                       dev_pair, tr_member, slot)
    R, NKW = nc.shape
    P = R // 2
    for t, dtype in ((nc, torch.int64), (kvalid, torch.bool),
                     (tr_member, torch.uint8), (slot, torch.int64)):
        if t.dtype != dtype or t.shape != (R, NKW):
            raise ValueError(f"thread_walk_graph: planes must be (2P, NKW), "
                             f"got {t.dtype} {tuple(t.shape)}")
    if dev_pair.shape != (P,) or nk.shape != (R,) or dst0.shape != (P,) \
            or dst0.dtype != torch.int64:
        raise ValueError("thread_walk_graph: dev_pair (P,), dst0 (P,) int64 "
                         "and nk (2P,)")
    if not graph.composite or graph.nval != 1:
        raise ValueError("thread_walk_graph: graph is a composite 1-value "
                         "table")
    if state["counts"].dtype != torch.int32:
        raise ValueError("state['counts'] must be int32")
    args = [x.contiguous() for x in (nc, dst0, kvalid)]
    nk = nk.to(torch.int32).contiguous()
    rest = [x.contiguous() for x in (dev_pair, tr_member, slot)]
    clean = torch.empty(R, dtype=torch.bool, device=nc.device)
    clean_pair = torch.empty(P, dtype=torch.bool, device=nc.device)
    fn = bind(kernel_lib("thread_walk"), "dtk_thread_walk_graph",
              "ii" + "p" * 7 + "i" + "pppi" + "pppp")
    check(fn(P, NKW, *[ptr(a) for a in args], ptr(nk),
             *[ptr(a) for a in rest], state["counts"].shape[0] - 1,
             *dt.level_args(graph), ptr(state["counts"]), ptr(clean),
             ptr(clean_pair), stream_of(nc)), "thread_walk_graph")
    launched("KE")
    return clean, clean_pair


# ---------------------------------------------------------------------------
# KF read_filter (QC + bait)
# ---------------------------------------------------------------------------

def qmask_batch(quals: np.ndarray, rlen: np.ndarray, qth: int,
                k: int) -> np.ndarray:
    """Vectorized qString2qMask (aQueryFasta_thread.h:1043-1078) over a
    (R, L) batch of raw phred+33 quality bytes (0-padded), on the host.

    The reference's two-pointer scan is NOT a plain sliding-window AND:
    once the scan position reaches nk (= nq-k+1), later windows are left
    False even if their bases all pass.  Closed form:
        qmask[w] = all(q[w..w+k-1] >= qth)
                   AND (w <= nk-k  OR  w is a good-run start)
    Returns (R, L-k+1) bool aligned with the k-mer window index.
    """
    R, L = quals.shape
    NKW = L - k + 1
    good = (quals.astype(np.int32) - 33) >= qth
    # padded tail bytes are 0 -> good False there already
    c = np.cumsum(good.astype(np.int32), axis=1)
    c = np.concatenate([np.zeros((R, 1), np.int32), c], axis=1)
    fullgood = (c[:, k:] - c[:, :-k]) == k          # (R, NKW)
    w = np.arange(NKW, dtype=np.int32)[None, :]
    nk = (rlen - k + 1).astype(np.int32)[:, None]
    runstart = np.concatenate(
        [np.ones((R, 1), bool), ~good[:, : NKW - 1]], axis=1)
    return fullgood & (w < nk) & ((w <= nk - k) | runstart)


def read_filter_plain(kmer, qmask, dst0, vote_pass, pack, qc, bait,
                      nloci: int):
    """Plain torch version of KF.  kmer (2P, NKW) int64 (EMPTY-masked);
    qmask (2P, NKW) bool or None; dst0 (P,) int64; vote_pass (P,) bool;
    pack (P,) uint8 (KC's referee bits); qc the (nloci + 1,) uint8 pass
    mask with a trailing 0, or None; bait the (kmer, locus) -> (mi << 8) |
    ma table (a DevTable), or None.  Returns dev_pair (P,) bool, qc_drop
    (P,) bool, bf (2P,) int32 and bf_pair (P,) bool."""
    P = dst0.shape[0]
    vp = vote_pass & ((pack & 1) == 0)
    if qc is not None:
        qc_ok = qc[dst0.clamp(0, nloci)] == 1
    else:
        qc_ok = torch.ones_like(vp)
    dev_pair, qc_drop = vp & qc_ok, vp & ~qc_ok
    if bait is None:
        return (dev_pair, qc_drop,
                torch.zeros(2 * P, dtype=torch.int32, device=kmer.device),
                torch.zeros_like(vp))
    R, NKW = kmer.shape
    key = kmer if qmask is None else torch.where(qmask, kmer, EMPTY)
    # valid k-mers are < 2^62: INT64_MAX puts EMPTY last, as JAX's u32 sort
    s = torch.sort(torch.where(key == EMPTY, _I64MAX, key), dim=1).values
    valid = s != _I64MAX
    first = torch.ones((R, 1), dtype=torch.bool, device=kmer.device)
    new = valid & torch.cat([first, s[:, 1:] != s[:, :-1]], 1)
    widx = torch.arange(NKW, device=kmer.device).expand(R, NKW)
    nxt = torch.cat([_rev_cummin(torch.where(new, widx, NKW))[:, 1:],
                     torch.full((R, 1), NKW, device=kmer.device)], 1)
    cnt = torch.where(new, torch.minimum(nxt, valid.sum(1, keepdim=True))
                      - widx, 0) & 0xFF
    loc = dst0.repeat_interleave(2)[:, None].expand(R, NKW)
    bfound, bval, _ = dt.lookup_bucket_plain(
        bait, torch.where(new, s, EMPTY), loc)
    viol = bfound & new & ((cnt < (bval >> 8)) | (cnt > (bval & 0xFF)))
    bf = viol.any(1) & dev_pair.repeat_interleave(2)
    return dev_pair, qc_drop, bf.int(), bf.view(P, 2).any(1)


KF_WARPS = 8              # warps a block, 2 a pair (csrc/read_filter.cu)
SMEM_MAX = 232448         # a block's shared memory on the H100


def read_filter_launch(P: int, NKW: int, bait: bool) -> tuple:
    """KF's launch for P pairs of NKW k-mer positions a read
    (csrc/read_filter.cu kf_table_slots, kf_block_warps): (blocks,
    threads, dynamic shared bytes).  With a bait table, a warp a read, a
    pair's mates in adjacent warps, and per warp the staged row (8 B a
    position) and a table of TS u32 words, TS the power of two >= 1.25 NKW
    + 1 (at least 32); fewer warps a block where eight pass a block's
    shared memory.  QC only: a thread a pair."""
    if not bait:
        return -(-P // 256), 256, 0
    ts = 32
    while ts < NKW + NKW // 4 + 1:
        ts *= 2
    w = KF_WARPS
    while w > 2 and w * (8 * NKW + 4 * ts) > SMEM_MAX:
        w //= 2
    return -(-P // (w // 2)), 32 * w, w * (8 * NKW + 4 * ts)


def read_filter(kmer, qmask, dst0, vote_pass, pack, qc, bait, nloci: int):
    """KF: QC mask and bait filter (read_filter_launch: a warp a read with
    a bait table, a thread a pair without).  Same contract as
    read_filter_plain; needs qc or bait."""
    if kmer.device.type == "cpu":
        return read_filter_plain(kmer, qmask, dst0, vote_pass, pack, qc,
                                 bait, nloci)
    R, NKW = kmer.shape
    P = R // 2
    if qc is None and bait is None:
        raise ValueError("read_filter: nothing to do without qc or bait")
    for t, dtype, shape in ((kmer, torch.int64, (2 * P, NKW)),
                            (dst0, torch.int64, (P,)),
                            (vote_pass, torch.bool, (P,)),
                            (pack, torch.uint8, (P,))):
        if t.dtype != dtype or t.shape != shape:
            raise ValueError("read_filter: kmer (2P, NKW) int64, dst0 (P,) "
                             "int64, vote_pass (P,) bool, pack (P,) uint8")
    if qmask is not None and (qmask.dtype != torch.bool
                              or qmask.shape != kmer.shape):
        raise ValueError("read_filter: qmask must be a bool plane like kmer")
    if qc is not None and (qc.dtype != torch.uint8
                           or qc.shape != (nloci + 1,)):
        raise ValueError("read_filter: qc must be (nloci + 1,) uint8")
    if bait is not None and (not bait.composite or bait.nval != 1):
        raise ValueError("read_filter: bait is a composite 1-value table")
    if bait is not None and (NKW > 0xFFFF or read_filter_launch(
            P, NKW, True)[2] > SMEM_MAX):
        raise ValueError(f"read_filter: NKW={NKW} k-mers a read pass the "
                         f"tables a block's shared memory holds")
    dev = kmer.device
    kmer, dst0 = kmer.contiguous(), dst0.contiguous()
    vote_pass, pack = vote_pass.contiguous(), pack.contiguous()
    qmask = None if qmask is None or bait is None else qmask.contiguous()
    dev_pair = torch.empty(P, dtype=torch.bool, device=dev)
    qc_drop = torch.empty(P, dtype=torch.bool, device=dev)
    bf = torch.empty(R, dtype=torch.int32, device=dev)
    bf_pair = torch.empty(P, dtype=torch.bool, device=dev)
    lv = dt.level_args(bait) if bait is not None else (None, None, None, 0)
    fn = bind(kernel_lib("read_filter"), "dtk_read_filter",
              "iipppppp" + "i" + "pppi" + "ppppp")
    check(fn(P, NKW, ptr(kmer), None if qmask is None else ptr(qmask),
             ptr(dst0), ptr(vote_pass), ptr(pack),
             None if qc is None else ptr(qc), nloci, *lv, ptr(dev_pair),
             ptr(qc_drop), ptr(bf), ptr(bf_pair), stream_of(kmer)),
          "read_filter")
    launched("KF")
    return dev_pair, qc_drop, bf, bf_pair


# ---------------------------------------------------------------------------
# KG novel_edges (bubbles)
# ---------------------------------------------------------------------------

_BITS = (1 << torch.arange(7, -1, -1)).to(torch.uint8)


def pack_bits(m: torch.Tensor) -> torch.Tensor:
    """np.packbits(m, axis=-1) of a (R, n) bool plane: position 8j + t is
    bit 7 - t of byte j, zeros past n."""
    R, n = m.shape
    pad = torch.nn.functional.pad(m.to(torch.uint8), (0, -n % 8))
    return (pad.view(R, -1, 8) * _BITS.to(m.device)).sum(
        -1, dtype=torch.uint8)


def unpack_bits(b: torch.Tensor, n: int) -> torch.Tensor:
    """The (R, n) bool plane of pack_bits."""
    return ((b[:, :, None] & _BITS.to(b.device)) != 0).reshape(
        b.shape[0], -1)[:, :n]


def novel_edges_plain(edge, evalid, si_, ei_, rm, counted, dst0, tre):
    """Plain torch version of KG.  edge (2P, NE) int64 canonical (k+1)-mer
    edges and evalid (2P, NE) bool (KA's); si_/ei_/rm (2P,) int32 (KD's);
    counted (P,) bool; dst0 (P,) int64; tre the (edge, locus) table.
    Returns the bit-packed novel-edge plane (2P, ceil(NE / 8)) uint8."""
    R, NE = edge.shape
    pos = torch.arange(NE, device=edge.device)
    act = (rm == 0) & counted.repeat_interleave(2)
    need = evalid & (pos >= si_[:, None]) & (pos < (ei_ - 1)[:, None]) \
        & act[:, None]
    loc = dst0.repeat_interleave(2)[:, None].expand(R, NE)
    found = dt.lookup_bucket_plain(tre, torch.where(need, edge, EMPTY),
                                   loc)[0]
    return pack_bits(need & ~found)


def novel_edges(edge, evalid, si_, ei_, rm, counted, dst0, tre):
    """KG: the novel-edge plane, one warp per read.  Same contract as
    novel_edges_plain."""
    if edge.device.type == "cpu":
        return novel_edges_plain(edge, evalid, si_, ei_, rm, counted, dst0,
                                 tre)
    R, NE = edge.shape
    P = R // 2
    if edge.dtype != torch.int64 or evalid.dtype != torch.bool \
            or evalid.shape != edge.shape or R != 2 * P:
        raise ValueError("novel_edges: edge (2P, NE) int64, evalid bool")
    for t in (si_, ei_, rm):
        if t.dtype != torch.int32 or t.shape != (R,):
            raise ValueError("novel_edges: si_/ei_/rm must be (2P,) int32")
    if counted.dtype != torch.bool or counted.shape != (P,) \
            or dst0.dtype != torch.int64 or dst0.shape != (P,):
        raise ValueError("novel_edges: counted (P,) bool, dst0 (P,) int64")
    if not tre.composite or tre.nval != 1:
        raise ValueError("novel_edges: tre is a composite 1-value table")
    args = [x.contiguous() for x in (edge, evalid, si_, ei_, rm, counted,
                                      dst0)]
    out = torch.empty((R, (NE + 7) // 8), dtype=torch.uint8,
                      device=edge.device)
    fn = bind(kernel_lib("novel_edges"), "dtk_novel_edges",
              "ii" + "p" * 7 + "pppi" + "pp")
    check(fn(P, NE, *[ptr(a) for a in args], *dt.level_args(tre), ptr(out),
             stream_of(edge)), "novel_edges")
    launched("KG")
    return out


# ---------------------------------------------------------------------------
# step constructors
# ---------------------------------------------------------------------------

def check_ported_config(cfg: AlignConfig) -> None:
    """Raises NotImplementedError for bait tracking (-tb), the one align
    mode the device engine does not run: its step does not track the
    first-violator bait k-mers, and the JAX DeviceAlignRunner has no
    write_btk either (ROADMAP.md, queue 3, inherited).  The host engine
    runs it."""
    if cfg.track_bait:
        raise NotImplementedError(
            "bait tracking (-tb) runs on the host engine only (drop "
            "--device): the device step does not track first-violator "
            "bait k-mers, and the JAX device runner has no write_btk "
            "(ROADMAP: queue 3, inherited)")


def _as(x, dtype, dev) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=dev, dtype=dtype, non_blocking=True)
    return torch.from_numpy(np.ascontiguousarray(x)).to(
        device=dev, dtype=dtype, non_blocking=True)


def query_int64(qlo, qhi) -> np.ndarray:
    """u32 (lo, hi) planes -> int64 k-mers (EMPTY planes -> -1)."""
    return ((np.asarray(qhi, np.uint32).astype(np.uint64) << np.uint64(32))
            | np.asarray(qlo, np.uint32)).view(np.int64)


def prefilter_decide(found, valid, nonshort, live, nmf: int, P: int):
    """The sampled-k-mer prefilter's decision (the JAX prefilter_decide,
    with ``nonshort`` = nk > 0): a read passes with >= nmf valid sampled
    k-mers found, a pair when both of its reads pass and it is live."""
    read_pass = (found & valid).sum(1) >= nmf
    return (read_pass & nonshort).view(P, 2).all(1) & live


def _prefilter_probe(drp: DeviceRPGG, dev):
    """KB on the membership table (the dbi table without one): q ->
    found."""
    tabs = drp.tables(dev)
    ptab = tabs["member"] if "member" in tabs else tabs["dbi"]
    return lambda q: dt.lookup_bucket(ptab, q)[0]


def make_prefilter_step_q(drp: DeviceRPGG, cfg: AlignConfig, P: int,
                          device=None, probe=None):
    """Prefilter over host-sampled queries (kmers_np.sample_subfilter_
    queries / io.native_reader.sample_queries): KB on the membership
    table, then the decision in torch ops.  ``probe`` (q -> found)
    replaces KB: the sharded prefilter's collective probe.

    Returns step(q (2P, nf) int64, valid (2P, nf) bool, nonshort (2P,)
    bool, live (P,) bool) -> survive (P,) bool on the device.  ``q`` may
    also be given as its u32 (lo, hi) planes, a tuple."""
    dev = resolve_device(device)
    probe = probe or _prefilter_probe(drp, dev)
    nmf = cfg.nm_filter

    def step(q, valid, nonshort, live):
        if isinstance(q, tuple):
            q = query_int64(*q)
        q = _as(q, torch.int64, dev)
        return prefilter_decide(probe(q), _as(valid, torch.bool, dev),
                                _as(nonshort, torch.bool, dev),
                                _as(live, torch.bool, dev), nmf, P)

    return step


def make_prefilter_step(drp: DeviceRPGG, cfg: AlignConfig, P: int, L: int,
                        device=None, probe=None):
    """Prefilter over device-sampled queries (the JAX make_prefilter_step,
    the runner's DTK_PREFILTER_HOSTQ=0): the L-byte code rows go to the
    card, KK samples the nf queries of each read, then the probe and the
    decision of make_prefilter_step_q.  Decision-identical to it.

    Returns step(codes (2P, L) u8, rlen (2P,) i32, live (P,) bool) ->
    survive (P,) bool on the device (``L`` None: any width)."""
    dev = resolve_device(device)
    probe = probe or _prefilter_probe(drp, dev)
    k, nf, nmf = cfg.ksize, cfg.n_filter, cfg.nm_filter

    def step(codes, rlen, live):
        if L is not None and codes.shape[1] != L:
            raise ValueError(f"code rows of {codes.shape[1]} columns, not "
                             f"the step's L = {L}")
        q, valid, nk = prefilter_sample(_as(codes, torch.uint8, dev),
                                        _as(rlen, torch.int32, dev), k, nf)
        return prefilter_decide(probe(q), valid, nk > 0,
                                _as(live, torch.bool, dev), nmf, P)

    return step


def make_step(drp: DeviceRPGG, cfg: AlignConfig, P: int, L: int,
              expand_cap: int = 512, with_annot: bool = False,
              with_bubbles: bool = False, with_qual: bool = False,
              device=None, capture: dict | None = None,
              probe_fns: dict | None = None):
    """Builds the per-batch step: counting mode, or graph-threading mode
    when ``cfg.threading`` (the JAX make_step(threading=True)).  QC
    (cfg.qc and a QC mask) and bait (cfg.bait and a bait table) add KF;
    ``with_annot`` adds the (2P, NKW) uint8 "ann" plane of .kam rows (the
    JAX default is on; here it is off, the production counting step);
    ``with_bubbles`` (and a tre table) adds KG's "novel_pack" and its
    unpacked "novel_edge"; ``with_qual`` makes the step take the bait's
    quality mask (qmask_batch) as a fifth argument.

    Returns step(state, codes (2P, L) u8, rlen (2P,) i32, live (P,) bool
    [, qmask (2P, L-k+1) bool]) -> (state, outputs dict); state
    (init_state) is updated in place.  Inputs may be numpy arrays or
    tensors; outputs are device tensors with the JAX step's keys
    (threading mode adds "clean", "clean_pair" and "tr_member").  With
    ``capture`` (a dict) each call stores every kernel's arguments under
    its name, so a check can replay one kernel on the step's real
    inputs.  ``probe_fns`` replaces the dbi and trfl probes, as in the JAX
    make_step: {"dbi": fn(q) -> (found, val, val2), "trfl": fn(q, q_loc)
    -> (found, val, val2)} (the sharded index's collective probes)."""
    check_ported_config(cfg)
    threading = bool(cfg.threading)
    has_qc = bool(cfg.qc) and drp.qc is not None
    has_bait = bool(cfg.bait) and drp.bait_tab is not None
    has_tre = bool(with_bubbles) and drp.tre_tab is not None
    dev = resolve_device(device)
    tabs = drp.tables(dev, graph=threading, bait=has_bait, qc=has_qc,
                      tre=has_tre)
    k, cth = cfg.ksize, int(cfg.cth)
    E = int(expand_cap)
    nloci = drp.nloci
    nf, nmf = cfg.n_filter, cfg.nm_filter

    def step(state, codes, rlen, live, qmask=None):
        if with_qual and qmask is None:
            raise ValueError("this step was made with_qual: pass the "
                             "quality mask (qmask_batch)")
        codes = _as(codes, torch.uint8, dev)
        rlen = _as(rlen, torch.int32, dev)
        live = _as(live, torch.bool, dev)
        # KA writes only what this mode reads: nc for threading, the
        # edges for bubbles
        ex = extract_kmers(codes, rlen, k, nc=threading, edges=has_tre)
        kmer, kvalid, nk = ex["kmer"], ex["kvalid"], ex["nk"]
        if probe_fns and "dbi" in probe_fns:
            found, val, annv = probe_fns["dbi"](kmer)
        else:
            found, val, annv = dt.lookup_bucket(tabs["dbi"], kmer)
        found = found & kvalid
        pair_nonshort = ex["any_valid"].view(P, 2).all(1) & live

        # ---- subfilter / kfilter (K4) ----
        if nf and nmf:
            # nf = 1 samples nk - 1 alone: S is never read (-kf 1 x)
            S = nk // max(nf - 1, 1)
            hits = torch.zeros(2 * P, dtype=torch.int64, device=dev)
            for i in range(nf):
                idx = i * S if i != nf - 1 else nk - 1
                hits += _take(found, idx).long()
            sub_pass = (hits >= nmf).view(P, 2).all(1)
        else:
            sub_pass = torch.ones(P, dtype=torch.bool, device=dev)
        pair_sub = pair_nonshort & sub_pass
        kf = (found.sum(1) < cth).int()
        pair_kf = pair_sub & ~(kf.view(P, 2) == 1).all(1)
        use = found & (kf == 0)[:, None] \
            & pair_kf.repeat_interleave(2)[:, None]

        # ---- vote (K5) ----
        dst0, vote_pass, pack = pair_vote(kmer, val, use, pair_kf,
                                          tabs["vv"], E, cth)
        referee = (pack & 1) != 0
        hf = ((pair_kf & ~vote_pass & ~referee).repeat_interleave(2)
              & (kf == 0)).int()

        # ---- QC (K10) and bait (K9) ----
        bf_pair = None
        if has_qc or has_bait:
            qm = _as(qmask, torch.bool, dev) if with_qual else None
            kf_args = (kmer, qm, dst0, vote_pass, pack, tabs.get("qc"),
                       tabs.get("bait"), nloci)
            if capture is not None:
                capture["KF"] = kf_args
            dev_pair, qc_drop, bf, bf_pair = read_filter(*kf_args)
            if not has_bait:
                bf_pair = None
        else:
            dev_pair = vote_pass & ~referee
            qc_drop = torch.zeros(P, dtype=torch.bool, device=dev)
            bf = torch.zeros(2 * P, dtype=torch.int32, device=dev)

        # ---- annotation probe for vv k-mers at (kmer, dst0) (K6) ----
        need = found & ((val & 1) == 1)
        pq = torch.where(need, kmer, EMPTY)
        pq_loc = torch.where(need, dst0.repeat_interleave(2)[:, None], 0)
        if probe_fns and "trfl" in probe_fns:
            afound_t, aval_t, _ = probe_fns["trfl"](pq, pq_loc)
        else:
            afound_t, aval_t, _ = dt.lookup_bucket(tabs["trfl"], pq, pq_loc)

        # ---- assignTRkmc + accumulation (K7, K8) ----
        kd_args = (found, val, annv, kvalid, afound_t, aval_t, dst0,
                   dev_pair, kf, nk, tabs["loff"], nloci, cfg.nm_tr,
                   threading, bf_pair, bool(with_annot))
        if capture is not None:
            capture.update(
                KA=(codes, rlen, k, threading, has_tre),
                KB_dbi=(tabs["dbi"], kmer),
                KC=(kmer, val, use, pair_kf, tabs["vv"], E, cth),
                KB_trfl=(tabs["trfl"], pq, pq_loc), KD=kd_args)
        a = assign_count(state, *kd_args)
        rm_p = a["rm"].view(P, 2)
        counted = dev_pair & ~(rm_p == 1).all(1)
        nmate = torch.where(counted, 2 - rm_p.sum(1), 0)
        thr_out = {}
        if threading:
            # ---- DFA walk (K12): KE probes the graph table at (nc, dst0)
            # as it walks; device-threaded pairs replace the assign-mode
            # "counted" after nmate was taken from it, as in the JAX step
            tr_member = a.pop("tr_member")
            ke_args = (tabs["graph"], ex["nc"], dst0, kvalid, nk, dev_pair,
                       tr_member, a.pop("slot"))
            if capture is not None:
                capture["KE"] = ke_args
            clean, clean_pair = thread_walk_graph(state, *ke_args)
            counted = dev_pair & clean_pair
            nmate = torch.where(counted, nmate, 0)
            thr_out = dict(clean=clean, clean_pair=clean_pair,
                           tr_member=tr_member)
        dest = torch.where(counted, dst0, nloci)
        kf_p = kf.view(P, 2)
        state["stats"] += torch.stack([
            2 * (live & ~referee).sum(),
            (live & ~pair_nonshort).sum(),
            2 * (pair_nonshort & ~pair_sub).sum(),
            torch.where((pair_sub & ~referee)[:, None], kf_p, 0).sum(),
            hf.sum(),
            2 * dev_pair.sum(),
            nmate.sum(),
            torch.where(qc_drop, 2 - kf_p.sum(1), 0).sum(),
            ((bf != 0) & (kf == 0)).sum(),
        ]).long()
        out = dict(
            pair_alive=pair_kf, vote_pass=vote_pass, referee=referee,
            referee_tie=(pack & 2) != 0, referee_ovf=(pack & 4) != 0,
            referee_t2=(pack & 8) != 0, referee_pack=pack,
            dst0=dst0, counted=counted, dest=dest, qc_drop=qc_drop,
            bf=bf, kf=kf, hf=hf, nk=nk,
            sub_drop=pair_nonshort & ~pair_sub, nonshort=pair_nonshort,
            **a, **thr_out)
        if has_tre:
            # ---- bubbles (K11): novel (k+1)-mer edges of counted mates
            kg_args = (ex["edge"], ex["evalid"], a["si_"], a["ei_"],
                       a["rm"], counted, dst0, tabs["tre"])
            if capture is not None:
                capture["KG"] = kg_args
            out["novel_pack"] = novel_edges(*kg_args)
            out["novel_edge"] = unpack_bits(out["novel_pack"], L - k)
        return state, out

    return step
