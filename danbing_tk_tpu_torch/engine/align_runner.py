"""Device-aligner runner: streams read batches from the native reader
through the optional sampled-k-mer prefilter and the device step, routes
referee-flagged pairs through the host oracle, and writes the byte-exact
outputs (.trkmc.ar / .tr.kmers / .tr.summary.txt, .kam, .bub.kmdb, and
.aln in threading mode).

Counterpart of DeviceAlignRunner.run_file_native in
danbing_tk_tpu/engine/align_runner.py; the retry ladder and checkpoints are
not ported yet, and asking for one raises NotImplementedError.  The device
accumulates TR-k-mer counts in a flat u32 array in .trkmc.ar order;
referee'd pairs are masked out on the device and recomputed by
host_align.process_pair, so the final counts are device + host.

Threading, okam (.kam rows, the default) and bubbles (-bu) are ordered:
every pair entering a full step gets an ordinal, its side effects (a .kam
row, bubble inserts, a device-clean .aln row, a host threading fallback, a
referee call) are buffered per ordinal and applied strictly in pair order,
so rows interleave and the bubble maps fill exactly as the reference's.
With -bu the batch-local bubble maps merge into the global DB every
reads_per_batch / 2 input pairs, the reference's flush cadence, which
shapes the .bub.kmdb bytes.  Pairs whose DFA walk is not clean go to the
native threading engine (native/dtk_thread.cpp) in one batched call per
step on a one-worker pool.
"""

from __future__ import annotations

from collections import deque

import numpy as np
import torch

from .._device import resolve_device
from ..io import binary as bio
from . import device_align as da
from ..ops import kmers_np as K
from .host_align import (AlignConfig, BubbleMaps, HostAligner, RPGG,
                         ReadAsgn, _kam_row, parse_read_name_sim1,
                         parse_read_name_sim2)
from .native_thread import NativeThreader, row_stride, split_cg_row

# a prefilter dispatch carries PREFILTER_MULT x the step's pairs (the
# per-read prefilter cost is tiny, so bigger dispatches amortize the
# per-call overhead); PREFILTER_WINDOW dispatches stay in flight;
# READER_PREFETCH batches are parsed ahead by the reader thread
PREFILTER_MULT = 4
PREFILTER_WINDOW = 8
READER_PREFETCH = 4

# the step planes the host reads per pair: threading (JAX align_runner.py
# THR_KEYS) and .kam rows (KAM_KEYS); -bu adds BUB_KEYS
THR_KEYS = ("nonshort", "sub_drop", "pair_alive", "qc_drop", "vote_pass",
            "dst0", "clean_pair", "tr_member", "nk")
KAM_KEYS = ("nonshort", "sub_drop", "pair_alive", "qc_drop", "vote_pass",
            "counted", "dest", "dst0", "kf", "hf", "bf", "rm", "af", "nt",
            "bs", "ti", "si", "ei", "nk", "ann")
BUB_KEYS = ("novel_pack", "dest")

_DECODE = np.full(256, ord("N"), dtype=np.uint8)
_DECODE[:4] = np.frombuffer(b"ACGT", dtype=np.uint8)


def _decode(codes: np.ndarray, rlen: int) -> str:
    return _DECODE[codes[:rlen]].tobytes().decode()


def _decode_qual(quals: np.ndarray, rlen: int) -> str:
    return quals[:rlen].tobytes().decode()


def _fetch_async(t: torch.Tensor):
    """Starts one non_blocking copy of ``t`` into pinned host memory;
    returns a handle for ``_fetched``."""
    if t.device.type == "cpu":
        return t, None
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    ev = torch.cuda.Event()
    ev.record()
    return host, ev


def _fetched(handle) -> np.ndarray:
    host, ev = handle
    if ev is not None:
        ev.synchronize()
    return host.numpy()


class DeviceAlignRunner:
    def __init__(self, rpgg: RPGG, cfg: AlignConfig, batch_pairs: int = 4096,
                 max_read_len: int = 256, expand_cap: int = 512,
                 retry_expand: int | list = 0, drp=None, device=None,
                 thread_view=None):
        """In threading mode a step's fallback pairs (walk not clean) go
        to the native engine in one batched call, or with ``cfg.tc``
        (-gcc) to the Python engine pair by pair, as in the JAX package.
        ``thread_view`` stands in for ``rpgg`` when there is none (a
        DeviceRPGG built straight from arrays): an object with per-locus
        ``graphs[d]`` (a dict or a (nodes, masks) array pair) and
        ``tr_counts[d]`` (a dict) for the batched fallback.  Without an
        rpgg, referee'd pairs are counted, not resolved, and write no .kam
        row; the runner keeps its own bubble maps."""
        da.check_ported_config(cfg)
        if retry_expand:
            raise NotImplementedError(
                "the retry ladder (--retry-expand) is not ported yet "
                "(ROADMAP: port queue item 1)")
        self.device = resolve_device(device)
        self.rpgg = rpgg
        self.cfg = cfg
        self.P = batch_pairs
        self.L = max_read_len
        self.expand_cap = expand_cap
        self.drp = drp if drp is not None else \
            da.DeviceRPGG.build(rpgg, with_tre=cfg.output_bubbles)
        if cfg.threading and self.drp.graph_tab is None:
            self.drp.add_graph(rpgg)
        # threading never writes .kam
        self.okam = bool(cfg.okam and not cfg.threading)
        # fastq + bait: the bait count profile skips quality-masked k-mers
        # (aQueryFasta_thread.h:1038-1078); the mask is made on the host
        self.with_qual = bool(cfg.is_fastq and cfg.bait
                              and self.drp.bait_tab is not None)
        self.step = da.make_step(
            self.drp, cfg, self.P, self.L, expand_cap=expand_cap,
            with_annot=self.okam, with_bubbles=cfg.output_bubbles,
            with_qual=self.with_qual, device=self.device)
        self.state = da.init_state(self.drp, self.device)
        # host oracle: referee'd pairs' counts go into the rpgg dicts.
        # Without an rpgg (a DeviceRPGG built straight from arrays, as the
        # synthetic scale index is) flagged pairs are counted, not resolved
        self.host = HostAligner(rpgg, cfg) if rpgg is not None else None
        # the batch-local maps merged at the end of the run (and, with
        # -bu, at each flush): the host's, which its referee calls fill
        # too, or the runner's own bubble maps without an rpgg
        self.bubbles = self.host
        if self.host is None and cfg.output_bubbles:
            self.bubbles = BubbleMaps(self.drp.nloci)
        # threading fallback: the native engine over the host graphs
        self.nthr = None
        self.tview = rpgg if rpgg is not None else thread_view
        if cfg.threading:
            if self.host is not None:
                self.nthr = self.host._nthr      # None with cfg.tc
            elif thread_view is not None and not cfg.tc:
                self.nthr = NativeThreader()
            else:
                raise ValueError("threading without an rpgg needs a "
                                 "thread_view (and no -gcc check)")
        self.kam_rows: list[str] = []
        self.aln_rows: list[str] = []
        self.n_referee = 0
        self.referee_reasons = {"tie": 0, "ovf": 0, "t2": 0}
        self.n_prefiltered = 0
        self.n_steps = 0            # full steps dispatched
        self.n_step_pairs = 0       # live pairs entering full steps
        self.n_host_thread = 0      # pairs of the host threading fallback
        self.n_device_thread = 0    # pairs threaded clean on the device
        self.prefilter_step = None
        self.prefilter_P = None

    def _build_prefilter(self, Pp: int):
        """Returns step(codes, rlen, live) -> survive (Pp,) on the device:
        host-sampled queries (native sampler), KB on the member table."""
        cfg = self.cfg
        qstep = da.make_prefilter_step_q(self.drp, cfg, Pp, self.device)
        from ..io.native_reader import sample_queries

        def _pre(codes, rlen, live):
            qlo, qhi, valid, nonshort = sample_queries(
                codes, rlen, cfg.ksize, cfg.n_filter)
            return qstep(da.query_int64(qlo, qhi), valid, nonshort, live)

        return _pre

    def run_file_native(self, path: str, prefilter: bool = False,
                        checkpoint: str | None = None,
                        checkpoint_every: int | None = None):
        """Production ingest: the C reader packs batches directly; read
        strings are decoded from the 2-bit codes only where the host needs
        them.  With ``prefilter`` a sampled-k-mer pass on the device drops
        non-matching pairs first and only densely re-packed survivors run
        the full step."""
        if checkpoint is not None or checkpoint_every is not None:
            raise NotImplementedError(
                "checkpoints are not ported yet (ROADMAP: port queue "
                "item 1)")
        from ..io.native_reader import NativeBatchReader
        from ..io.prefetch import PrefetchIterator

        cfg = self.cfg
        reader = NativeBatchReader(
            path, self.dispatch_pairs(prefilter), self.L,
            is_fastq=cfg.is_fastq, min_read_size=cfg.cth + cfg.ksize - 1,
            with_titles=self._with_titles(), with_quals=self._with_quals())
        reader = PrefetchIterator(reader, READER_PREFETCH)
        try:
            self.run_batches(reader, prefilter)
        finally:
            reader.close()

    def _with_titles(self) -> bool:
        """Titles ride along for .kam and .aln rows and the simmode src."""
        cfg = self.cfg
        return bool(self.okam or (cfg.threading and (cfg.aln or cfg.simmode)))

    def _with_quals(self) -> bool:
        """Fastq quality strings ride along for the bait's quality mask,
        .kam rows and the referee."""
        return bool(self.cfg.is_fastq)

    def dispatch_pairs(self, prefilter: bool) -> int:
        """Pairs per input batch."""
        return self.P * (PREFILTER_MULT if prefilter else 1)

    def run_batches(self, batches, prefilter: bool = False):
        """Runs packed batches (codes (2n', L) u8, rlen (2n',) i32, n
        live pairs[, titles[, quals]]) of ``dispatch_pairs(prefilter)``
        rows each through the funnel; the file path feeds it the native
        reader.  Titles are '>'-stripped (None without them), quals the
        (2n', L) u8 phred+33 rows."""
        P, L = self.P, self.L
        cfg = self.cfg
        thr = cfg.threading
        okam = self.okam
        bub = bool(cfg.output_bubbles)
        ordered = thr or okam or bub
        wt, wq = self._with_titles(), self._with_quals()
        sim = cfg.simmode
        nloci = self.drp.nloci
        Pp = self.dispatch_pairs(prefilter)
        if prefilter and self.prefilter_P != Pp:
            self.prefilter_step = self._build_prefilter(Pp)
            self.prefilter_P = Pp
        aux_keys = (("referee_pack",)
                    + (THR_KEYS if thr else KAM_KEYS if okam else ())
                    + (BUB_KEYS if bub else ()))

        def new_buffers():
            return (np.full((2 * P, L), 255, dtype=np.uint8),
                    np.zeros(2 * P, dtype=np.int32),
                    np.empty(P, dtype=object) if wt else None,
                    np.zeros((2 * P, L), dtype=np.uint8) if wq else None)

        buf_codes, buf_rlen, buf_titles, buf_quals = new_buffers()
        nbuf = 0

        # threading fallback: batched calls MUST serialize, since each
        # dtk_thread_pairs call merges into the shared per-locus CountMaps
        # at its end (one worker = one call in flight; its own threads
        # give the parallelism)
        thr_batch_pool = None
        if thr and self.nthr is not None:
            from concurrent.futures import ThreadPoolExecutor

            thr_batch_pool = ThreadPoolExecutor(1)

        # ordered mode: ordinal -> buffered effects, applied strictly in
        # ordinal (pair) order
        ord_next = 0
        ord_pend: dict[int, list] = {}
        n_ord = 0

        def pair_src(title):
            if sim == 2:
                return parse_read_name_sim2(title, nloci)
            if sim == 1:
                return parse_read_name_sim1(title)
            return -1

        def title_of(titles, i):
            # native titles come '>'-stripped and pruned
            return ">" + titles[i] if titles is not None else ">r"

        def ref_effect(codes, rlen, quals, titles, i):
            """The referee call's inputs, captured now; the call runs at
            apply time so its .kam / .aln row and bubbles land in pair
            order."""
            qs = (None, None)
            if quals is not None:
                qs = (_decode_qual(quals[2 * i], rlen[2 * i]),
                      _decode_qual(quals[2 * i + 1], rlen[2 * i + 1]))
            title = title_of(titles, i)
            return ("ref", title, _decode(codes[2 * i], rlen[2 * i]),
                    _decode(codes[2 * i + 1], rlen[2 * i + 1]),
                    pair_src(title) if sim else -1, qs)

        def apply_effect(e):
            tag = e[0]
            host = self.host
            if tag == "kam":
                self.kam_rows.append(e[1])
            elif tag == "bub":
                self._add_bubbles_codes(*e[1:])
            elif tag == "aln":
                self.aln_rows.append(e[1])
            elif tag == "thr":
                # -gcc: the Python engine walks and checks the pair here
                _, title, s1, s2, src, dst0_i = e
                self.n_host_thread += 1
                host.stats["nThreadingReads"] += 2
                rows = host.aln_rows
                n0 = len(rows)
                host._thread_pair(title, s1, s2, src, dst0_i)
                if len(rows) > n0:
                    self.aln_rows.append(rows.pop())
            elif tag == "thrb":
                # batched fallback: the C++ call did the walks,
                # corrections and k-mer counting for the whole step; the
                # apply reads the per-mate status (and the ready
                # cigar/annotation text in aln mode)
                _, title, s1, s2, src, dest, fut, j = e
                self.n_host_thread += 1
                status, cg_rows = fut.result()
                a0, a1 = int(status[2 * j]), int(status[2 * j + 1])
                if host is not None:
                    host.stats["nThreadingReads"] += 2
                    if a0 or a1:
                        host.stats["nFeasibleReads"] += (
                            int(bool(a0)) + int(bool(a1)))
                if not (a0 or a1):
                    dest = nloci
                if cfg.aln:
                    if cfg.simmode:
                        keep = (not cfg.aln_minimal) or (
                            src != nloci or dest != nloci)
                    else:
                        keep = (not cfg.aln_minimal) or dest != nloci
                    if keep:
                        stride = row_stride(L)
                        c2, t2 = split_cg_row(cg_rows[2 * j + 1],
                                              2 * j + 1, stride)
                        c1, t1 = split_cg_row(cg_rows[2 * j], 2 * j, stride)
                        src_s = "." if src == -1 else str(src)
                        self.aln_rows.append(
                            f"{src_s}\t{dest}\t{title}\t{s2}\t{s1}\t"
                            f"{c2}\t{t2}\t{c1}\t{t1}\n")
            else:                               # referee (synchronous)
                _, title, s1, s2, src, qs = e
                self.n_referee += 1
                # the referee's freshly appended row moves into the
                # runner's sink in pair order
                rows, sink = ((host.kam_rows, self.kam_rows) if okam else
                              (host.aln_rows, self.aln_rows))
                n0 = len(rows)
                host.process_pair(title, s1, s2, src, qs)
                if len(rows) > n0:
                    sink.append(rows.pop())

        def emit(o, effs):
            nonlocal ord_next
            ord_pend[o] = effs
            while ord_next in ord_pend:
                for e in ord_pend.pop(ord_next):
                    apply_effect(e)
                ord_next += 1

        def submit_batch(bidx, ko, codes, rlen):
            """One dtk_thread_pairs call for this step's fallback pairs;
            returns (future, {pair index: slot in the call})."""
            nthr = self.nthr
            tv = self.tview
            bdests = [int(d) for d in ko["dst0"][bidx]]
            for d in bdests:
                nthr.prepare(d, tv.graphs[d], tv.tr_counts[d])
            rows = np.empty(2 * len(bidx), dtype=np.int64)
            rows[0::2] = 2 * bidx
            rows[1::2] = 2 * bidx + 1
            fut = thr_batch_pool.submit(
                nthr.thread_pairs, bdests, codes[rows],
                np.asarray(rlen)[rows], cfg.thread_cth, cfg.correction,
                cfg.ksize, cfg.maxncorrection, 0, cfg.aln)
            return fut, {int(i): j for j, i in enumerate(bidx)}

        def thread_effects(ko, referee, codes, rlen, quals, titles, n, lo,
                           ords):
            """The ordinal-buffered effects of one threading step."""
            alive = (ko["nonshort"][:n] & ~ko["sub_drop"][:n]
                     & ko["pair_alive"][:n] & ~ko["qc_drop"][:n]
                     & ko["vote_pass"][:n])
            alive[:lo] = False
            clean = ko["clean_pair"][:n]
            self.n_device_thread += int((alive & clean & ~referee).sum())
            thr_batch = None
            bidx = np.nonzero(alive & ~clean & ~referee)[0]
            if thr_batch_pool is not None and len(bidx):
                thr_batch = submit_batch(bidx, ko, codes, rlen)
            for i in range(lo, n):
                effs = []
                if referee[i]:
                    if self.host is None:
                        self.n_referee += 1
                    else:
                        effs.append(ref_effect(codes, rlen, quals, titles,
                                               i))
                elif alive[i]:
                    dst0_i = int(ko["dst0"][i])
                    title = title_of(titles, i)
                    srcv = pair_src(title) if sim else -1
                    if clean[i]:
                        if cfg.aln:
                            effs.append(("aln", self._thread_aln_row(
                                ko, i, codes, rlen, title, srcv)))
                    elif thr_batch is not None:
                        # sequences are only needed for the .aln row
                        s1 = s2 = None
                        if cfg.aln:
                            s1 = _decode(codes[2 * i], rlen[2 * i])
                            s2 = _decode(codes[2 * i + 1], rlen[2 * i + 1])
                        effs.append(("thrb", title, s1, s2, srcv, dst0_i,
                                     thr_batch[0], thr_batch[1][i]))
                    else:
                        effs.append((
                            "thr", title, _decode(codes[2 * i], rlen[2 * i]),
                            _decode(codes[2 * i + 1], rlen[2 * i + 1]),
                            srcv, dst0_i))
                emit(int(ords[i]), effs)

        def count_effects(ko, referee, codes, rlen, quals, titles, n, lo,
                          ords):
            """The ordinal-buffered effects of one okam / -bu step: the
            referee call, or the pair's bubble inserts and .kam row."""
            if bub:
                novp = ko["novel_pack"][: 2 * n]
                has = novp.any(axis=1)
                pair_bub = (has[0::2] | has[1::2]) & ~referee
            for i in range(lo, n):
                effs = []
                if referee[i]:
                    if self.host is None:
                        self.n_referee += 1
                    else:
                        effs.append(ref_effect(codes, rlen, quals, titles,
                                               i))
                else:
                    if bub and pair_bub[i]:
                        d = int(ko["dest"][i])
                        for ridx in (2 * i, 2 * i + 1):
                            if has[ridx]:
                                effs.append((
                                    "bub", d, codes[ridx].copy(),
                                    int(rlen[ridx]),
                                    np.unpackbits(novp[ridx])))
                    if okam:
                        row = self._kam_device_row(
                            ko, codes, rlen, quals, titles, i, pair_src)
                        if row is not None:
                            effs.append(("kam", row))
                emit(int(ords[i]), effs)

        # full steps are processed fs_window steps after dispatch: the
        # referee pack and the planes the host reads travel device->host
        # in non_blocking copies, so the fetch overlaps the next steps;
        # effects apply in dispatch order
        fs_pending: deque = deque()
        fs_window = 3

        def process_step():
            (handles, codes, rlen, n, lo, titles, quals,
             ords) = fs_pending.popleft()
            ko = {key: _fetched(h) for key, h in handles.items()}
            pk = ko["referee_pack"][:n]
            referee = (pk & 1) != 0
            for bit, key in ((2, "tie"), (4, "ovf"), (8, "t2")):
                self.referee_reasons[key] += int(((pk & bit) != 0).sum())
            if thr:
                thread_effects(ko, referee, codes, rlen, quals, titles, n,
                               lo, ords)
            elif ordered:
                count_effects(ko, referee, codes, rlen, quals, titles, n,
                              lo, ords)
            elif self.host is None:
                self.n_referee += int(referee.sum())
            else:
                # counting mode: only flagged pairs need host work; the
                # order of their count adds is irrelevant
                for i in np.nonzero(referee)[0]:
                    apply_effect(ref_effect(codes, rlen, quals, titles, i))

        def full_step(codes, rlen, n, titles=None, quals=None, lo=0):
            """One step over pairs [lo, n) of the batch (pairs before lo
            belong to an earlier dispatch of the same batch)."""
            nonlocal n_ord
            live = np.zeros(P, dtype=bool)
            live[lo:n] = True
            self.n_steps += 1
            self.n_step_pairs += n - lo
            if self.with_qual:
                qm = da.qmask_batch(quals, rlen, cfg.qth, cfg.ksize)
                self.state, out = self.step(self.state, codes, rlen, live,
                                            qm)
            else:
                self.state, out = self.step(self.state, codes, rlen, live)
            ords = None
            if ordered:
                ords = np.zeros(n, dtype=np.int64)
                ords[lo:] = np.arange(n_ord, n_ord + n - lo)
                n_ord += n - lo
            fs_pending.append(({key: _fetch_async(out[key])
                                for key in aux_keys}, codes, rlen, n, lo,
                               titles, quals, ords))
            while len(fs_pending) > fs_window:
                process_step()

        def step_buf():
            nonlocal nbuf, buf_codes, buf_rlen, buf_titles, buf_quals
            if not nbuf:
                return
            full_step(buf_codes, buf_rlen, nbuf, buf_titles, buf_quals)
            buf_codes, buf_rlen, buf_titles, buf_quals = new_buffers()
            nbuf = 0

        def copy_survivors(sel, codes, rlen, titles, quals):
            # block-copy survivors into the repack buffer (chunked at
            # full-step boundaries); rows interleave the two mates
            nonlocal nbuf
            taken = 0
            while taken < len(sel):
                chunk = sel[taken: taken + (P - nbuf)]
                taken += len(chunk)
                src = np.stack([2 * chunk, 2 * chunk + 1], axis=1).ravel()
                dst = slice(2 * nbuf, 2 * (nbuf + len(chunk)))
                buf_codes[dst] = codes[src]
                buf_rlen[dst] = rlen[src]
                if wq:
                    buf_quals[dst] = quals[src]
                if wt:
                    buf_titles[nbuf: nbuf + len(chunk)] = \
                        np.asarray(titles, dtype=object)[chunk]
                nbuf += len(chunk)
                if nbuf == P:
                    step_buf()

        # -bu flush cadence: the reference merges batch-local bubble maps
        # into the global DB every reads_per_batch reads (accumBubbles);
        # the .bub bytes depend on that merge order, so the funnel
        # barriers at the same input-pair boundaries
        bflush = max(cfg.reads_per_batch // 2, 1)
        next_flush = bflush
        cursor = 0                  # input pairs consumed

        def batch_flush_barrier():
            # everything before the boundary lands (referee and bubble
            # effects) before the batch-local maps merge
            nonlocal next_flush
            step_buf()
            while fs_pending:
                process_step()
            self.bubbles.flush_batch()
            next_flush += bflush

        pending: deque = deque()

        def drain_one():
            nonlocal cursor
            codes, rlen, n, titles, quals, handle = pending.popleft()
            idx = np.nonzero(_fetched(handle)[:n])[0]
            self.n_prefiltered += int(n - len(idx))
            if not bub:
                copy_survivors(idx, codes, rlen, titles, quals)
            else:
                # survivors segment by segment: every pair before a flush
                # boundary is processed and merged before any pair after
                # it enters the repack buffer
                p = 0
                while True:
                    rel = next_flush - cursor
                    q = int(np.searchsorted(idx[p:], rel)) + p
                    copy_survivors(idx[p:q], codes, rlen, titles, quals)
                    p = q
                    if rel > n:
                        break
                    batch_flush_barrier()
            cursor += n

        try:
            for rec in batches:
                codes, rlen, n = rec[0], rec[1], rec[2]
                titles = rec[3] if wt else None
                quals = rec[4] if wq else None
                if prefilter:
                    live = np.zeros(Pp, dtype=bool)
                    live[:n] = True
                    # several dispatches stay in flight; every batch is a
                    # fresh array, so queueing needs no copies
                    surv = self.prefilter_step(codes, rlen, live)
                    pending.append((codes, rlen, n, titles, quals,
                                    _fetch_async(surv)))
                    if len(pending) >= PREFILTER_WINDOW:
                        drain_one()
                    continue
                lo = 0
                if bub:
                    # split the batch at flush boundaries (live range
                    # [lo, hi)); the maps merge between the parts
                    while next_flush - cursor <= n:
                        rel = next_flush - cursor
                        if rel > lo:
                            full_step(codes, rlen, rel, titles, quals, lo)
                            lo = rel
                        batch_flush_barrier()
                if n > lo:
                    full_step(codes, rlen, n, titles, quals, lo)
                cursor += n
            while pending:
                drain_one()
            step_buf()
            while fs_pending:
                process_step()
            if ord_pend:
                raise RuntimeError(f"{len(ord_pend)} ordinals unresolved "
                                   f"after the last step")
            if self.bubbles is not None:
                self.bubbles.flush_batch()
            # batched threading counts live in native CountMaps until
            # here; the outputs read the per-locus dicts
            if self.nthr is not None:
                self.nthr.drain_counts_into(self.tview.tr_counts)
        finally:
            if thr_batch_pool is not None:
                thr_batch_pool.shutdown(wait=True)

    # -- okam rows and bubbles --

    def _kam_device_row(self, ko, codes, rlen, quals, titles, i, pair_src):
        """The .kam row of a device-resolved pair (JAX _kam_device_row and
        _kam_from_device): the funnel filters over the fetched planes,
        reads decoded only for emitted rows.  Returns the row, or None
        when the pair emits nothing."""
        nloci = self.drp.nloci
        if not ko["nonshort"][i] or ko["sub_drop"][i] \
                or not ko["pair_alive"][i] or ko["qc_drop"][i]:
            return None
        title = ">" + titles[i]
        src = pair_src(title) if self.cfg.simmode else -1
        dest = int(ko["dest"][i]) if ko["counted"][i] else nloci
        if not ko["vote_pass"][i]:
            dest = nloci
        if not ((src != nloci and src != -1) or dest != nloci):
            return None
        qs = (".", ".")
        if quals is not None:
            qs = (_decode_qual(quals[2 * i], rlen[2 * i]),
                  _decode_qual(quals[2 * i + 1], rlen[2 * i + 1]))
        # the assignTRkmc fields are set whenever the pair passed the vote
        # (even if both mates were then removed); pairs that failed it
        # keep the struct defaults (reference :2056-2062)
        ran_asgn = bool(ko["vote_pass"][i])
        rs = []
        for ridx in (2 * i, 2 * i + 1):
            r = ReadAsgn()
            r.kf, r.hf, r.bf = (int(ko["kf"][ridx]), int(ko["hf"][ridx]),
                                int(ko["bf"][ridx]))
            r.rm, r.af = int(ko["rm"][ridx]), int(ko["af"][ridx])
            if ran_asgn:
                r.nt, r.bs, r.ti = (int(ko["nt"][ridx]), int(ko["bs"][ridx]),
                                    int(ko["ti"][ridx]))
                r.si, r.ei = int(ko["si"][ridx]), int(ko["ei"][ridx])
                r.as_ = ko["ann"][ridx][: int(ko["nk"][ridx])].tolist()
            rs.append(r)
        return _kam_row(title, src, dest, int(ko["dst0"][i]), rs[0], rs[1],
                        _decode(codes[2 * i], rlen[2 * i]),
                        _decode(codes[2 * i + 1], rlen[2 * i + 1]),
                        self.cfg.is_fastq, qs[0], qs[1])

    def _add_bubbles_codes(self, dest, codes_row, rl, novel_bits):
        """Inserts a mate's novel edges into the batch-local bubble map of
        ``dest``; edge values come straight from the 2-bit code row."""
        _, edges = K.seq_to_kmers_and_edges(codes_row[:rl], self.cfg.ksize)
        order, counts = self.bubbles.batch_map(dest)
        for pos in np.nonzero(novel_bits[: len(edges)])[0]:
            e = int(edges[pos])
            order.insert(e)
            counts[e] = counts.get(e, 0) + 1

    # -- threading rows --

    @staticmethod
    def _annot_str(ko, ridx):
        from .threading import write_annot

        nk = int(ko["nk"][ridx])
        tm = ko["tr_member"][ridx][:nk]
        return write_annot(["=" if x else "." for x in tm])

    def _thread_aln_row(self, ko, i, codes, rlen, title, src):
        """The .aln row of a device-clean pair: a clean DFA walk is an
        all-match CIGAR, annotations come from the tr_member plane."""
        src_s = "." if src == -1 else str(src)
        dst0 = int(ko["dst0"][i])
        s1 = _decode(codes[2 * i], rlen[2 * i])
        s2 = _decode(codes[2 * i + 1], rlen[2 * i + 1])
        ann2 = self._annot_str(ko, 2 * i + 1)
        ann1 = self._annot_str(ko, 2 * i)
        return (f"{src_s}\t{dst0}\t{title}\t{s2}\t{s1}\t"
                f"{len(s2)}=\t{ann2}\t{len(s1)}=\t{ann1}\n")

    # -- outputs --

    def _dev_state(self, key: str) -> np.ndarray:
        """A u32 device accumulator as a host uint32 array."""
        return da.state_u32(self.state[key])

    def flat_counts(self) -> np.ndarray:
        dev = self._dev_state("counts")[:-1].astype(np.uint64)
        return dev + self.host.flat_counts()

    def write_trkmc_ar(self, path):
        bio.write_karray(path, self.flat_counts())

    def write_tr_kmers(self, path):
        flat = self.flat_counts()
        off = self.drp.locus_offsets
        with open(path, "w") as f:
            for i in range(self.rpgg.nloci):
                f.write(f">{i}\n")
                cnts = flat[off[i]: off[i + 1]]
                for km, c in zip(self.rpgg.tr_orders[i], cnts):
                    f.write(f"{km}\t{c}\n")

    def write_summary(self, path):
        nmap = self._dev_state("nmapread")[:-1] + self.host.nmapread
        kmc = self._dev_state("kmc")[:-1].astype(np.uint64) + \
            self.host.kmc
        with open(path, "w") as f:
            for i in range(self.rpgg.nloci):
                f.write(f"{nmap[i]}\t{kmc[i]}\n")

    def write_aln(self, path):
        from ..io.rowsink import finalize_rows

        finalize_rows(self.aln_rows, path)

    def write_kam(self, path):
        from ..io.rowsink import finalize_rows

        finalize_rows(self.kam_rows, path)

    def write_bubbles(self, path, threshold: int = 5):
        self.bubbles.write_bubbles(path, threshold)
