"""ctypes bindings for the native (C++) graph-threading engine.

A copy of danbing_tk_tpu/engine/native_thread.py.  ``native/dtk_thread.cpp``
(built with g++ into ``build/torch_native/`` by kernels/build.py, on first
use) implements the same algorithm as ``engine.threading``
(isThreadFeasible + error correction + CIGAR surgery) at C++ speed.  The
host threading fallback takes every pair whose walk the device DFA (kernel
KE) does not resolve.

The wrapper returns results in the exact shapes ``host_align._thread_pair``
consumes: an ``es`` list compatible with ``threading.write_cigar``, the
``tr`` annotation list for ``write_annot``, and the corrected k-mer
stream (with NAN64 placeholders preserved) for counting.

Held byte-exact against the Python engine by tests/test_torch_threading.py.
"""

from __future__ import annotations

import ctypes as C
import os

import numpy as np

from ..kernels.build import thread_lib

_LIB = None


def _load():
    """The engine library, built on first use; a failed build raises."""
    global _LIB
    if _LIB is not None:
        return _LIB
    lib = thread_lib()
    lib.dtk_graph_new.restype = C.c_void_p
    lib.dtk_graph_add.argtypes = [C.c_void_p, C.POINTER(C.c_uint64),
                                  C.POINTER(C.c_uint8), C.c_int64]
    lib.dtk_graph_free.argtypes = [C.c_void_p]
    lib.dtk_thread_read.restype = C.c_int
    lib.dtk_thread_read.argtypes = [
        C.c_void_p, C.c_void_p, C.c_char_p, C.c_int64, C.c_uint64,
        C.c_int, C.c_uint64, C.c_int, C.c_char_p,
        C.POINTER(C.c_int64), C.c_char_p, C.POINTER(C.c_int64),
        C.POINTER(C.c_uint64), C.POINTER(C.c_int64)]
    lib.dtk_counts_new.restype = C.c_void_p
    lib.dtk_counts_free.argtypes = [C.c_void_p]
    lib.dtk_counts_size.restype = C.c_int64
    lib.dtk_counts_size.argtypes = [C.c_void_p]
    lib.dtk_counts_drain.argtypes = [C.c_void_p, C.POINTER(C.c_uint64),
                                     C.POINTER(C.c_uint64)]
    lib.dtk_thread_pairs.restype = C.c_int64
    lib.dtk_thread_pairs.argtypes = [
        C.POINTER(C.c_void_p), C.POINTER(C.c_void_p),
        C.POINTER(C.c_void_p), C.POINTER(C.c_uint8),
        C.POINTER(C.c_int32), C.c_int64, C.c_int64, C.c_uint64,
        C.c_int, C.c_uint64, C.c_int, C.c_int, C.c_int,
        C.POINTER(C.c_uint8), C.c_char_p, C.c_int64,
        C.POINTER(C.c_int64)]
    _LIB = lib
    return lib


def row_stride(L: int) -> int:
    """Bytes per mate of ``thread_pairs``'s cigar/annotation rows for
    L-column reads: worst case RLE ~2 chars/op + counts, so 8x the read
    length is ample."""
    return 8 * int(L)


def split_cg_row(row: bytes, r: int, cg_stride: int) -> tuple[str, str]:
    """(cigar, annotation) of mate row ``r`` of ``thread_pairs``.  The
    engine cuts a row that would overrun ``cg_stride`` bytes
    (native/dtk_thread.cpp), which can cut away its tab: such a row
    raises here, naming the row and the stride, instead of yielding a
    wrong .aln line."""
    if b"\t" not in row:
        raise ValueError(
            f"thread_pairs row {r} has no tab: the cigar/annotation text "
            f"was truncated at cg_stride={cg_stride} bytes")
    cg, ann = row.decode().split("\t", 1)
    return cg, ann


class _CGraph:
    __slots__ = ("h", "lib")

    def __init__(self, lib, kv):
        """``kv``: a dict kmer -> mask, or a (keys u64, masks u8) pair of
        arrays."""
        self.lib = lib
        self.h = lib.dtk_graph_new()
        n = len(kv) if isinstance(kv, dict) else len(kv[0])
        if n and isinstance(kv, dict):
            keys = np.fromiter(kv.keys(), dtype=np.uint64, count=n)
            vals = np.fromiter((v & 0xFF for v in kv.values()),
                               dtype=np.uint8, count=n)
        elif n:
            keys = np.ascontiguousarray(kv[0], dtype=np.uint64)
            vals = np.ascontiguousarray(kv[1], dtype=np.uint8)
        if n:
            lib.dtk_graph_add(
                self.h, keys.ctypes.data_as(C.POINTER(C.c_uint64)),
                vals.ctypes.data_as(C.POINTER(C.c_uint8)), n)

    def __del__(self):
        if self.h:
            self.lib.dtk_graph_free(self.h)
            self.h = None


class NativeThreader:
    """Per-RPGG cache of native graph handles + the thread_read call.

    ``thread_read`` and ``thread_pairs`` only read the shared graph
    handles (ctypes releases the GIL for the engine's duration);
    ``prepare`` mutates the handle cache and must stay on one thread."""

    def __init__(self):
        self.lib = _load()
        self._graphs: dict[int, _CGraph] = {}
        self._trks: dict[int, _CGraph] = {}
        self._cnts: dict[int, int] = {}   # locus -> CountMap handle

    def __del__(self):
        lib = getattr(self, "lib", None)
        if lib is not None:
            for h in getattr(self, "_cnts", {}).values():
                lib.dtk_counts_free(h)
            self._cnts = {}

    def prepare(self, locus: int, graph, tr_counts: dict):
        """Native handles of a locus: ``graph`` a dict node -> mask or a
        (nodes, masks) array pair; ``tr_counts`` the locus's TR k-mers."""
        if locus not in self._graphs:
            self._graphs[locus] = _CGraph(self.lib, graph)
            trk = np.fromiter(tr_counts, dtype=np.uint64,
                              count=len(tr_counts))
            self._trks[locus] = _CGraph(
                self.lib, (trk, np.zeros(len(trk), np.uint8)))
            self._cnts[locus] = self.lib.dtk_counts_new()

    def thread_pairs(self, dests, codes: np.ndarray, rlens: np.ndarray,
                     thread_cth: int, correction: bool, ksize: int,
                     maxncorrection: int, nworkers: int = 0,
                     want_aln: bool = False):
        """Batched fallback: one C call walks every pair over internal
        worker threads.  codes is (2n, L) u8 2-bit rows (255 = non-ACGT),
        dests the per-pair locus ids (all prepare()d).  Corrected-k-mer
        counts accumulate in the per-locus native CountMaps (drain with
        drain_counts_into at checkpoint/finalize boundaries).

        Returns (status (2n,) u8, cg_rows or None) where cg_rows[r] is
        the ready b"<cigar>\\t<annot>" bytes for mate r (want_aln)."""
        n = len(dests)
        if n == 0:
            return np.zeros(0, np.uint8), [] if want_aln else None
        codes = np.ascontiguousarray(codes, dtype=np.uint8)
        rlens = np.ascontiguousarray(rlens, dtype=np.int32)
        VP = C.c_void_p * n
        gh = VP(*(self._graphs[d].h for d in dests))
        th = VP(*(self._trks[d].h for d in dests))
        ch = VP(*(self._cnts[d] for d in dests))
        status = np.zeros(2 * n, dtype=np.uint8)
        if want_aln:
            cg_stride = row_stride(codes.shape[1])
            cg_buf = np.zeros(2 * n * cg_stride, dtype=np.uint8)
            cg_lens = np.zeros(2 * n, dtype=np.int64)
            cg_ptr = cg_buf.ctypes.data_as(C.c_char_p)
            cl_ptr = cg_lens.ctypes.data_as(C.POINTER(C.c_int64))
        else:
            cg_stride, cg_buf, cg_lens = 0, None, None
            cg_ptr, cl_ptr = C.c_char_p(), C.cast(
                C.c_void_p(), C.POINTER(C.c_int64))
        if nworkers <= 0:
            nworkers = max((os.cpu_count() or 2) - 1, 1)
        self.lib.dtk_thread_pairs(
            gh, th, ch, codes.ctypes.data_as(C.POINTER(C.c_uint8)),
            rlens.ctypes.data_as(C.POINTER(C.c_int32)), n,
            codes.shape[1], thread_cth, int(correction), ksize,
            maxncorrection, nworkers, int(want_aln), status.ctypes
            .data_as(C.POINTER(C.c_uint8)), cg_ptr, cg_stride, cl_ptr)
        if not want_aln:
            return status, None
        rows = cg_buf.reshape(2 * n, cg_stride)
        cg_rows = [rows[r, :cg_lens[r]].tobytes() for r in range(2 * n)]
        return status, cg_rows

    def drain_counts_into(self, tr_counts: list) -> int:
        """Merge every native CountMap into the per-locus Python dicts
        (tr_counts[locus][km] += c) and clear them.  Adds commute, so
        draining at checkpoint/finalize boundaries is exact.  Returns
        the number of distinct (locus, kmer) entries merged."""
        lib = self.lib
        total = 0
        for locus, h in self._cnts.items():
            nsz = lib.dtk_counts_size(h)
            if not nsz:
                continue
            keys = np.empty(nsz, dtype=np.uint64)
            vals = np.empty(nsz, dtype=np.uint64)
            lib.dtk_counts_drain(
                h, keys.ctypes.data_as(C.POINTER(C.c_uint64)),
                vals.ctypes.data_as(C.POINTER(C.c_uint64)))
            trc = tr_counts[locus]
            for km, c in zip(keys.tolist(), vals.tolist()):
                trc[km] += c
            total += nsz
        return total

    def thread_read(self, locus: int, seq: str, thread_cth: int,
                    correction: bool, ksize: int, maxncorrection: int):
        """-> (status, es, tr, kmers); es rows are [type, '', graph_nuc]
        (read nucleotides are never consulted by write_cigar)."""
        cap = 4 * max(len(seq), 64)
        es_buf = C.create_string_buffer(cap)
        tr_buf = C.create_string_buffer(cap)
        km_buf = np.empty(cap, dtype=np.uint64)
        es_len = C.c_int64(cap)
        tr_len = C.c_int64(cap)
        nk = C.c_int64(cap)
        st = self.lib.dtk_thread_read(
            self._graphs[locus].h, self._trks[locus].h,
            seq.encode(), len(seq), thread_cth, int(correction), ksize,
            maxncorrection, es_buf, C.byref(es_len), tr_buf,
            C.byref(tr_len), km_buf.ctypes.data_as(
                C.POINTER(C.c_uint64)), C.byref(nk))
        raw = es_buf.raw[:es_len.value]
        es = []
        i = 0
        while i < len(raw):
            t = chr(raw[i])
            i += 1
            if t in ("X", "D"):
                gch = chr(raw[i])
                i += 1
                es.append([t, "", gch])
            else:
                es.append([t, "", ""])
        tr = [chr(b) for b in tr_buf.raw[:tr_len.value]]
        kmers = [int(x) for x in km_buf[:nk.value]]
        return st, es, tr, kmers

