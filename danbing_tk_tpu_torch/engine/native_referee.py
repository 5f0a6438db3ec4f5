"""ctypes bindings for the native (C++) host-referee engine.

Counterpart of danbing_tk_tpu/engine/native_referee.py.
``native/dtk_align.cpp`` (built with g++ into build/torch_native/ on first
use by kernels/build.py; a failed build raises) runs the host-exact asgn
pipeline (subfilter -> kfilter -> countHit vote -> QC -> bait ->
assignTRkmc) for the referee pairs the device engine routes back to the
host.  The verdict semantics mirror ``host_align.process_pair`` statement
for statement (tests/test_torch_native_referee.py holds them against it
across plain/sim/bait/fastq configs, on the dict-backed RPGG and on the
flat view); this wrapper applies each verdict to the SAME HostAligner
state (counts, stats, kam rows), so outputs remain byte-identical while
the referee runs ~2 orders of magnitude faster than the Python path.

Unsupported configs (bubbles, extract, the bait tracker) stay on the
Python referee: ``supported(cfg)`` says which.  The port has no silent
fall-back: where ``supported`` holds the runner uses this engine unless
DTK_NO_NATIVE_REFEREE asks for the Python referee.
"""

from __future__ import annotations

import ctypes as C
import os
import threading as _threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from ..kernels.build import align_lib
from .host_align import HostAligner, ReadAsgn, _kam_row

_LIB = None


def supported(cfg) -> bool:
    # threading mode is supported: the C++ engine answers the vote, the
    # threading walk runs on the native thread engine via _thread_pair
    return not (cfg.output_bubbles or cfg.extract or cfg.track_bait)


def _load():
    global _LIB
    if _LIB is not None:
        return _LIB
    lib = align_lib()
    u64p = C.POINTER(C.c_uint64)
    u32p = C.POINTER(C.c_uint32)
    u16p = C.POINTER(C.c_uint16)
    u8p = C.POINTER(C.c_uint8)
    i64p = C.POINTER(C.c_int64)
    lib.dtk_eng_new.restype = C.c_void_p
    lib.dtk_eng_new.argtypes = [u64p, u32p, C.c_int64, u32p, C.c_int64,
                                C.c_int64, u8p]
    lib.dtk_eng_new_flat.restype = C.c_void_p
    lib.dtk_eng_new_flat.argtypes = [u64p, u32p, C.c_int64, u32p,
                                     C.c_int64, C.c_int64, u8p,
                                     u64p, i64p, u64p, i64p]
    lib.dtk_eng_set_locus.argtypes = [C.c_void_p, C.c_int64, u64p,
                                      C.c_int64, u64p, C.c_int64]
    lib.dtk_eng_set_bait.argtypes = [C.c_void_p, C.c_int64, u64p, u16p,
                                     C.c_int64]
    lib.dtk_eng_free.argtypes = [C.c_void_p]
    lib.dtk_eng_pair.restype = C.c_int
    lib.dtk_eng_pair.argtypes = [
        C.c_void_p, C.c_char_p, C.c_int64, C.c_char_p, C.c_int64,
        C.c_char_p, C.c_char_p, C.c_int, C.c_int, C.c_int, C.c_int,
        C.c_int, C.c_int, C.c_int, C.c_int, C.c_int, C.c_int,
        i64p, u8p, u8p, u64p, u64p]
    _LIB = lib
    return lib


class NativeReferee:
    """Drop-in for HostAligner.process_pair on supported configs,
    mutating the wrapped HostAligner's state."""

    def __init__(self, host: HostAligner):
        self.host = host
        self.cfg = host.cfg
        self.lib = _load()
        g = host.g
        u64p = C.POINTER(C.c_uint64)
        u32p = C.POINTER(C.c_uint32)
        i64p = C.POINTER(C.c_int64)
        qc = None
        if self.cfg.qc and g.qc_filter is not None:
            qc = np.ascontiguousarray(g.qc_filter, dtype=np.uint8)
        qcp = (qc.ctypes.data_as(C.POINTER(C.c_uint8))
               if qc is not None else None)
        if hasattr(g, "engine_arrays"):
            # flat host view (flat_rpgg.FlatRPGG): the engine keeps
            # zero-copy binary-search views over the sorted arrays —
            # no 1e8-entry hash build at production index scale
            keys, vals, vv, trk, tro, flk, flo = (
                np.ascontiguousarray(a) for a in g.engine_arrays())
            if len(vv) == 0:
                vv = np.zeros(1, dtype=np.uint32)
            if len(flk) == 0:
                flk = np.zeros(1, dtype=np.uint64)
            self._keep = (keys, vals, vv, trk, tro, flk, flo, qc)
            self.h = self.lib.dtk_eng_new_flat(
                keys.ctypes.data_as(u64p), vals.ctypes.data_as(u32p),
                len(keys), vv.ctypes.data_as(u32p), len(vv), g.nloci,
                qcp, trk.ctypes.data_as(u64p),
                tro.ctypes.data_as(i64p), flk.ctypes.data_as(u64p),
                flo.ctypes.data_as(i64p))
        else:
            keys = np.fromiter(g.dbi.keys(), dtype=np.uint64,
                               count=len(g.dbi))
            vals = np.fromiter(g.dbi.values(), dtype=np.uint32,
                               count=len(g.dbi))
            vv = np.ascontiguousarray(g.vv, dtype=np.uint32)
            if len(vv) == 0:
                vv = np.zeros(1, dtype=np.uint32)
            self._keep = (keys, vals, vv, qc)
            self.h = self.lib.dtk_eng_new(
                keys.ctypes.data_as(u64p), vals.ctypes.data_as(u32p),
                len(keys), vv.ctypes.data_as(u32p), len(vv), g.nloci,
                qcp)
            for li in range(g.nloci):
                trk = np.fromiter(g.tr_counts[li].keys(),
                                  dtype=np.uint64,
                                  count=len(g.tr_counts[li]))
                flk = np.fromiter(g.fl_sets[li], dtype=np.uint64,
                                  count=len(g.fl_sets[li]))
                self.lib.dtk_eng_set_locus(
                    self.h, li, trk.ctypes.data_as(u64p), len(trk),
                    flk.ctypes.data_as(u64p), len(flk))
        if self.cfg.bait and g.bait_dbs is not None:
            for li in range(g.nloci):
                bdb = g.bait_dbs[li]
                if bdb:
                    bk = np.fromiter(bdb.keys(), dtype=np.uint64,
                                     count=len(bdb))
                    bv = np.fromiter(bdb.values(), dtype=np.uint16,
                                     count=len(bdb))
                    self.lib.dtk_eng_set_bait(
                        self.h, li, bk.ctypes.data_as(u64p),
                        bv.ctypes.data_as(C.POINTER(C.c_uint16)), len(bk))
        self._scratch = _threading.local()

    def _buffers(self, cap_min: int = 1024):
        """Per-thread scratch: the engine handle is read-only after
        construction, so concurrent dtk_eng_pair calls (which release
        the GIL) are safe as long as output buffers are thread-local."""
        s = self._scratch
        if getattr(s, "as1", None) is None or len(s.as1) < cap_min:
            cap = max(1024, cap_min)
            s.vd = np.zeros(64, dtype=np.int64)
            s.as1 = np.zeros(cap, dtype=np.uint8)
            s.as2 = np.zeros(cap, dtype=np.uint8)
            s.km1 = np.zeros(cap, dtype=np.uint64)
            s.km2 = np.zeros(cap, dtype=np.uint64)
        return s

    def __del__(self):
        if getattr(self, "h", None):
            self.lib.dtk_eng_free(self.h)
            self.h = None

    def _call(self, seq1, seq2, quals):
        """Engine call only (no state mutation; GIL released inside the
        C call).  Returns the verdict tuple for _apply."""
        cfg = self.cfg
        q1 = quals[0].encode() if cfg.is_fastq and quals[0] else None
        q2 = quals[1].encode() if cfg.is_fastq and quals[1] else None
        s = self._buffers(max(len(seq1), len(seq2)) + 8)
        u64p = C.POINTER(C.c_uint64)
        u8p = C.POINTER(C.c_uint8)
        stage = self.lib.dtk_eng_pair(
            self.h, seq1.encode(), len(seq1), seq2.encode(), len(seq2),
            q1, q2, cfg.ksize, cfg.cth, cfg.n_filter, cfg.nm_filter,
            cfg.nm_tr, cfg.max_nt, int(cfg.okam), int(cfg.bait),
            int(cfg.qc), cfg.qth,
            s.vd.ctypes.data_as(C.POINTER(C.c_int64)),
            s.as1.ctypes.data_as(u8p), s.as2.ctypes.data_as(u8p),
            s.km1.ctypes.data_as(u64p),
            s.km2.ctypes.data_as(u64p))
        vd = s.vd
        nk1, nk2 = int(vd[3]), int(vd[4])
        return (stage, vd.copy(), s.as1[:nk1].copy(), s.as2[:nk2].copy(),
                s.km1[:nk1].copy(), s.km2[:nk2].copy())

    def process_pair(self, title, seq1, seq2, src=-1, quals=(None, None)):
        self._apply(self._call(seq1, seq2, quals),
                    title, seq1, seq2, src, quals)

    def _apply(self, verdict, title, seq1, seq2, src, quals):
        cfg, host = self.cfg, self.host
        g = host.g
        st = host.stats
        stage, vd, as1, as2, km1, km2 = verdict
        dest, dst0 = int(vd[1]), int(vd[2])
        nk1, nk2 = int(vd[3]), int(vd[4])
        r1, r2 = ReadAsgn(), ReadAsgn()
        for m, r in ((0, r1), (1, r2)):
            o = 5 + 15 * m
            (r.kf, r.hf, r.bf, r.qf, r.af, r.rm, r.qn, r.qm, r.si, r.ei,
             r.si_, r.ei_, r.nt, r.bs, r.ti) = (
                int(x) for x in vd[o:o + 15])
        if stage == 0:
            st["nShort"] += 1
            return
        if stage == 1:
            st["nSubFiltered"] += 2
            return
        st["nKmerFiltered"] += r1.kf + r2.kf
        if stage == 2:
            return
        if stage == 3:
            st["nLocusAssignFiltered"] += r1.hf + r2.hf
            return
        if stage == 4:
            st["nQCFiltered"] += 2 - int(vd[5 + 5]) - int(vd[5 + 15 + 5])
            return
        st["nThreadingReads"] += 2
        if cfg.threading:
            # mirror process_pair: the walk (and its counting/aln output)
            # runs in _thread_pair against the vote's dst0
            host._thread_pair(title, seq1, seq2, src, dst0)
            return
        st["nFeasibleReads"] += 2
        if cfg.bait and (r1.bf or r2.bf):
            rm_pre1, rm_pre2 = int(vd[35]), int(vd[36])
            st["nBaitFiltered"] += (r1.bf & (not rm_pre1)) + (
                r2.bf & (not rm_pre2))
        r1.as_ = as1.tolist()
        r2.as_ = as2.tolist()
        if not (r1.rm and r2.rm):
            n = 2 - r1.rm - r2.rm
            host.nmapread[dest] += n
            st["nAsgnReads"] += n
            host.kmc[dest] += (r1.ei - r1.si) + (r2.ei - r2.si)
            trc = g.tr_counts[dst0]
            if not r1.rm:
                for i in range(nk1):
                    if r1.as_[i] == 2:
                        trc[int(km1[i])] += 1
            if not r2.rm:
                for i in range(nk2):
                    if r2.as_[i] == 2:
                        trc[int(km2[i])] += 1
        if cfg.okam and ((src != g.nloci and src != -1) or dest != g.nloci):
            host.kam_rows.append(
                _kam_row(title, src, dest, dst0, r1, r2, seq1, seq2,
                         cfg.is_fastq, quals[0] or ".", quals[1] or "."))


class ParallelReferee(NativeReferee):
    """NativeReferee with the engine calls fanned over a thread pool.

    dtk_eng_pair releases the GIL for the whole C computation and the
    engine is read-only after construction, so N workers overlap the
    expensive part; state application (Python dict/array mutation, kam
    rows) happens in SUBMISSION order at drain time — sequential
    semantics, parallel compute.  At real-panel referee rates (test2
    boundaries ~17% of survivors) the single-threaded referee would
    dominate the funnel wall; this keeps it in the device-queue shadow.
    """

    def __init__(self, host: HostAligner, nthreads: int | None = None):
        super().__init__(host)
        if nthreads is None:
            nthreads = int(os.environ.get(
                "DTK_REFEREE_THREADS", min(4, os.cpu_count() or 1)))
        self.nthreads = max(1, nthreads)
        self._pool = ThreadPoolExecutor(self.nthreads)
        self._pending: deque = deque()

    def submit(self, title, seq1, seq2, src=-1, quals=(None, None)):
        self._pending.append(
            (self._pool.submit(self._call, seq1, seq2, quals),
             title, seq1, seq2, src, quals))
        if len(self._pending) > 8192:
            self._drain_one()

    def _drain_one(self):
        fut, title, s1, s2, src, quals = self._pending.popleft()
        self._apply(fut.result(), title, s1, s2, src, quals)

    def flush(self):
        while self._pending:
            self._drain_one()

    def process_pair(self, title, seq1, seq2, src=-1, quals=(None, None)):
        # synchronous API (kam-row pop pattern); keep order vs pending
        self.flush()
        super().process_pair(title, seq1, seq2, src, quals)

    def close(self):
        self.flush()
        self._pool.shutdown(wait=True)
