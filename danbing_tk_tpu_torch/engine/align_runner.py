"""Device-aligner runner: streams read batches from the native reader
through the optional sampled-k-mer prefilter and the device step, routes
referee-flagged pairs through the host oracle, and writes the byte-exact
outputs (.trkmc.ar / .tr.kmers / .tr.summary.txt, and .aln in threading
mode).

Counterpart of DeviceAlignRunner.run_file_native in
danbing_tk_tpu/engine/align_runner.py, cut to counting and graph-threading
modes: .kam / bubbles, the retry ladder and checkpoints are not ported yet;
asking for one raises NotImplementedError.  The device accumulates
TR-k-mer counts in a flat u32 array in .trkmc.ar order; referee'd pairs
are masked out on the device and recomputed by host_align.process_pair, so
the final counts are device + host.

Threading mode is ordered: every pair entering a full step gets an
ordinal, its side effects (a device-clean .aln row, a host threading
fallback, a referee call) are buffered per ordinal and applied strictly in
pair order, so .aln rows interleave exactly as the reference writes them.
Pairs whose DFA walk is not clean go to the native threading engine
(native/dtk_thread.cpp) in one batched call per step on a one-worker pool.
"""

from __future__ import annotations

from collections import deque

import numpy as np
import torch

from .._device import resolve_device
from ..io import binary as bio
from . import device_align as da
from .host_align import (AlignConfig, HostAligner, RPGG,
                         parse_read_name_sim1, parse_read_name_sim2)
from .native_thread import NativeThreader, row_stride, split_cg_row

# a prefilter dispatch carries PREFILTER_MULT x the step's pairs (the
# per-read prefilter cost is tiny, so bigger dispatches amortize the
# per-call overhead); PREFILTER_WINDOW dispatches stay in flight;
# READER_PREFETCH batches are parsed ahead by the reader thread
PREFILTER_MULT = 4
PREFILTER_WINDOW = 8
READER_PREFETCH = 4

# the step planes the threading funnel reads on the host (JAX
# align_runner.py THR_KEYS)
THR_KEYS = ("nonshort", "sub_drop", "pair_alive", "qc_drop", "vote_pass",
            "dst0", "clean_pair", "tr_member", "nk")

_DECODE = np.full(256, ord("N"), dtype=np.uint8)
_DECODE[:4] = np.frombuffer(b"ACGT", dtype=np.uint8)


def _decode(codes: np.ndarray, rlen: int) -> str:
    return _DECODE[codes[:rlen]].tobytes().decode()


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
        ``tr_counts[d]`` (a dict) for the batched fallback; referee'd
        pairs are then counted, not resolved."""
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
            da.DeviceRPGG.build(rpgg, with_tre=False)
        if cfg.threading and self.drp.graph_tab is None:
            self.drp.add_graph(rpgg)
        self.step = da.make_step(self.drp, cfg, self.P, self.L,
                                 expand_cap=expand_cap, device=self.device)
        self.state = da.init_state(self.drp, self.device)
        # host oracle: referee'd pairs' counts go into the rpgg dicts.
        # Without an rpgg (a DeviceRPGG built straight from arrays, as the
        # synthetic scale index is) flagged pairs are counted, not resolved
        self.host = HostAligner(rpgg, cfg) if rpgg is not None else None
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
            path, self.dispatch_pairs(prefilter), self.L, is_fastq=False,
            min_read_size=cfg.cth + cfg.ksize - 1,
            with_titles=self._with_titles())
        reader = PrefetchIterator(reader, READER_PREFETCH)
        try:
            self.run_batches(reader, prefilter)
        finally:
            reader.close()

    def _with_titles(self) -> bool:
        """Titles ride along for .aln rows and the simmode src."""
        cfg = self.cfg
        return bool(cfg.threading and (cfg.aln or cfg.simmode))

    def dispatch_pairs(self, prefilter: bool) -> int:
        """Pairs per input batch."""
        return self.P * (PREFILTER_MULT if prefilter else 1)

    def run_batches(self, batches, prefilter: bool = False):
        """Runs packed batches (codes (2n', L) u8, rlen (2n',) i32, n
        live pairs[, titles]) of ``dispatch_pairs(prefilter)`` rows each
        through the funnel; the file path feeds it the native reader."""
        P, L = self.P, self.L
        cfg = self.cfg
        thr = cfg.threading
        wt = self._with_titles()
        sim = cfg.simmode
        nloci = self.drp.nloci
        Pp = self.dispatch_pairs(prefilter)
        if prefilter and self.prefilter_P != Pp:
            self.prefilter_step = self._build_prefilter(Pp)
            self.prefilter_P = Pp
        buf_codes = np.full((2 * P, L), 255, dtype=np.uint8)
        buf_rlen = np.zeros(2 * P, dtype=np.int32)
        buf_titles = np.empty(P, dtype=object) if wt else None
        nbuf = 0

        # threading fallback: batched calls MUST serialize, since each
        # dtk_thread_pairs call merges into the shared per-locus CountMaps
        # at its end (one worker = one call in flight; its own threads
        # give the parallelism)
        thr_batch_pool = None
        if thr and self.nthr is not None:
            from concurrent.futures import ThreadPoolExecutor

            thr_batch_pool = ThreadPoolExecutor(1)

        # ordered mode (threading): ordinal -> buffered effects, applied
        # strictly in ordinal (pair) order
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

        def apply_effect(e):
            tag = e[0]
            host = self.host
            if tag == "aln":
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
                _, title, s1, s2, src = e
                self.n_referee += 1
                n0 = len(host.aln_rows)
                host.process_pair(title, s1, s2, src, (None, None))
                if len(host.aln_rows) > n0:
                    self.aln_rows.append(host.aln_rows.pop())

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

        def thread_effects(ko, referee, codes, rlen, titles, n, ords):
            """The ordinal-buffered effects of one threading step."""
            alive = (ko["nonshort"][:n] & ~ko["sub_drop"][:n]
                     & ko["pair_alive"][:n] & ~ko["qc_drop"][:n]
                     & ko["vote_pass"][:n])
            clean = ko["clean_pair"][:n]
            self.n_device_thread += int((alive & clean & ~referee).sum())
            thr_batch = None
            bidx = np.nonzero(alive & ~clean & ~referee)[0]
            if thr_batch_pool is not None and len(bidx):
                thr_batch = submit_batch(bidx, ko, codes, rlen)
            for i in range(n):
                effs = []
                if referee[i]:
                    if self.host is None:
                        self.n_referee += 1
                    else:
                        effs.append((
                            "ref", title_of(titles, i),
                            _decode(codes[2 * i], rlen[2 * i]),
                            _decode(codes[2 * i + 1], rlen[2 * i + 1]),
                            pair_src(title_of(titles, i)) if sim else -1))
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

        # full steps are processed fs_window steps after dispatch: the
        # referee pack (and in threading mode the THR_KEYS planes) travel
        # device->host in non_blocking copies, so the fetch overlaps the
        # next steps; effects apply in dispatch order
        fs_pending: deque = deque()
        fs_window = 3

        def process_step():
            handle, thr_h, codes, rlen, n, titles, ords = \
                fs_pending.popleft()
            pk = _fetched(handle)[:n]
            referee = (pk & 1) != 0
            for bit, key in ((2, "tie"), (4, "ovf"), (8, "t2")):
                self.referee_reasons[key] += int(((pk & bit) != 0).sum())
            if thr:
                ko = {key: _fetched(h) for key, h in thr_h.items()}
                thread_effects(ko, referee, codes, rlen, titles, n, ords)
                return
            # counting mode: only flagged pairs need host work; order of
            # referee side effects is irrelevant (count adds commute)
            if self.host is None:
                self.n_referee += int(referee.sum())
                return
            for i in np.nonzero(referee)[0]:
                self.n_referee += 1
                s1 = _decode(codes[2 * i], rlen[2 * i])
                s2 = _decode(codes[2 * i + 1], rlen[2 * i + 1])
                self.host.process_pair(">r", s1, s2, -1, (None, None))

        def full_step(codes, rlen, n, titles=None):
            nonlocal n_ord
            live = np.zeros(P, dtype=bool)
            live[:n] = True
            self.n_steps += 1
            self.n_step_pairs += n
            self.state, out = self.step(self.state, codes, rlen, live)
            thr_h = ords = None
            if thr:
                thr_h = {key: _fetch_async(out[key]) for key in THR_KEYS}
                ords = np.arange(n_ord, n_ord + n)
                n_ord += n
            fs_pending.append((_fetch_async(out["referee_pack"]), thr_h,
                               codes, rlen, n, titles, ords))
            while len(fs_pending) > fs_window:
                process_step()

        def step_buf():
            nonlocal nbuf, buf_codes, buf_rlen, buf_titles
            if not nbuf:
                return
            full_step(buf_codes, buf_rlen, nbuf, buf_titles)
            buf_codes = np.full((2 * P, L), 255, dtype=np.uint8)
            buf_rlen = np.zeros(2 * P, dtype=np.int32)
            buf_titles = np.empty(P, dtype=object) if wt else None
            nbuf = 0

        def copy_survivors(sel, codes, rlen, titles):
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
                if wt:
                    buf_titles[nbuf: nbuf + len(chunk)] = \
                        np.asarray(titles, dtype=object)[chunk]
                nbuf += len(chunk)
                if nbuf == P:
                    step_buf()

        pending: deque = deque()

        def drain_one():
            codes, rlen, n, titles, handle = pending.popleft()
            idx = np.nonzero(_fetched(handle)[:n])[0]
            self.n_prefiltered += int(n - len(idx))
            copy_survivors(idx, codes, rlen, titles)

        try:
            for rec in batches:
                codes, rlen, n = rec[0], rec[1], rec[2]
                titles = rec[3] if wt else None
                if prefilter:
                    live = np.zeros(Pp, dtype=bool)
                    live[:n] = True
                    # several dispatches stay in flight; every batch is a
                    # fresh array, so queueing needs no copies
                    surv = self.prefilter_step(codes, rlen, live)
                    pending.append((codes, rlen, n, titles,
                                    _fetch_async(surv)))
                    if len(pending) >= PREFILTER_WINDOW:
                        drain_one()
                else:
                    full_step(codes, rlen, n, titles)
            while pending:
                drain_one()
            step_buf()
            while fs_pending:
                process_step()
            if ord_pend:
                raise RuntimeError(f"{len(ord_pend)} ordinals unresolved "
                                   f"after the last step")
            if self.host is not None:
                self.host.flush_batch()
            # batched threading counts live in native CountMaps until
            # here; the outputs read the per-locus dicts
            if self.nthr is not None:
                self.nthr.drain_counts_into(self.tview.tr_counts)
        finally:
            if thr_batch_pool is not None:
                thr_batch_pool.shutdown(wait=True)

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
