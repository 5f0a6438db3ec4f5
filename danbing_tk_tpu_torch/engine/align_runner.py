"""Device-aligner runner: streams read batches from the native reader
(run_file_native, through the optional sampled-k-mer prefilter) or from
the Python reader (run_file) through the device step, routes
referee-flagged pairs through the host oracle, and writes the byte-exact
outputs (.trkmc.ar / .tr.kmers / .tr.summary.txt, .kam, .bub.kmdb, .aln
in threading mode, and the extracted pairs of -e).

Counterpart of DeviceAlignRunner.run_file_native and run_file in
danbing_tk_tpu/engine/align_runner.py, with the retry ladder and
checkpoints.  The device accumulates TR-k-mer counts in a flat u32 array
in .trkmc.ar order; referee'd pairs are masked out on the device and
recomputed by host_align.process_pair, so the final counts are device +
host.

The retry ladder (``retry_expand``): a pair whose k-mer -> locus expansion
overflows the step's E slots (referee bit 2) re-batches through steps of
growing E (an int is one tier, a list a ladder) before the host referee
sees it; only the last tier's overflow goes there.  Checkpoints
(``checkpoint=``) write an npz with the JAX runner's keys and dtypes (the
pair cursor, the host counts, ``dev_<state key>`` as u32 / int64 and
``x_<extra>``: the configuration, the prefilter repack buffer, the retry
buffers and, in ordered mode, the .kam high-water mark and the bubble
maps), so a checkpoint crosses between the packages.

Threading, okam (.kam rows, the default), bubbles (-bu) and extract (-e)
are ordered: every pair entering a full step gets an ordinal, its side
effects (a .kam row, bubble inserts, a device-clean .aln row, an extract
row, a host threading fallback, a referee call) are buffered per ordinal
and applied strictly in pair order, so rows interleave and the bubble maps
fill exactly as the reference's.
With -bu the batch-local bubble maps merge into the global DB every
reads_per_batch / 2 input pairs, the reference's flush cadence, which
shapes the .bub.kmdb bytes.  Pairs whose DFA walk is not clean go to the
native threading engine (native/dtk_thread.cpp) in one batched call per
step on a one-worker pool.

run_file packs each batch of the Python reader (iter_fasta_pairs) into
P-pair chunks of the same format, with the reads cut to L for the step;
the host sees the full records (titles, sequences, quality strings and
source loci), so referee calls, .kam, .aln and extract rows are the JAX
run_file's.  Its unclean threading pairs go to the host engine pair by
pair, as there.
"""

from __future__ import annotations

import os
import time
from collections import deque

import numpy as np
import torch

from .._device import resolve_device
from ..io import binary as bio
from . import device_align as da
from ..ops import kmers_np as K
from .host_align import (AlignConfig, BubbleMaps, HostAligner, RPGG,
                         ReadAsgn, _kam_row, iter_fasta_pairs,
                         parse_read_name_sim1, parse_read_name_sim2)
from .native_thread import NativeThreader, row_stride, split_cg_row

# a prefilter dispatch carries PREFILTER_MULT x the step's pairs, or
# DTK_PREFILTER_MULT x where it is set, as in the JAX runner (the per-read
# prefilter cost is tiny, so bigger dispatches amortize the per-call
# overhead); PREFILTER_WINDOW dispatches stay in flight;
# READER_PREFETCH batches are parsed ahead by the reader thread
PREFILTER_MULT = 4
PREFILTER_WINDOW = 8
READER_PREFETCH = 4
# auto checkpoint cadence: the first save after CKPT_FIRST_S seconds, then
# every CKPT_WALL_MULT x the last save's wall (<5% overhead)
CKPT_FIRST_S = 60.0
CKPT_WALL_MULT = 20.0
# state keys that hold u32 accumulators (int32 bit patterns on the device)
U32_KEYS = ("counts", "nmapread", "kmc")

# the step planes the host reads per pair: threading (JAX align_runner.py
# THR_KEYS) and .kam rows (KAM_KEYS); -bu adds BUB_KEYS
THR_KEYS = ("nonshort", "sub_drop", "pair_alive", "qc_drop", "vote_pass",
            "dst0", "clean_pair", "tr_member", "nk")
KAM_KEYS = ("nonshort", "sub_drop", "pair_alive", "qc_drop", "vote_pass",
            "counted", "dest", "dst0", "kf", "hf", "bf", "rm", "af", "nt",
            "bs", "ti", "si", "ei", "nk", "ann")
BUB_KEYS = ("novel_pack", "dest")
# -e rows (JAX _post_chunk_extract): bait and QC do not apply
EXT_KEYS = ("nonshort", "sub_drop", "pair_alive", "vote_pass", "dst0")

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


def _snapshot_async(state: dict) -> dict:
    """{key: handle for ``_fetched``} of a copy of ``state`` taken now:
    on the card each tensor is cloned on a side stream (the current
    stream then waits for the clones, not for the host copies) and copied
    into pinned memory with a non-blocking copy on the same side stream."""
    dev = next(iter(state.values())).device
    if dev.type == "cpu":
        return {k: (v.clone(), None) for k, v in state.items()}
    main = torch.cuda.current_stream(dev)
    side = torch.cuda.Stream(dev)
    side.wait_stream(main)
    with torch.cuda.stream(side):
        clones = {k: v.clone() for k, v in state.items()}
    main.wait_stream(side)
    out = {}
    with torch.cuda.stream(side):
        for k, c in clones.items():
            host = torch.empty(c.shape, dtype=c.dtype, pin_memory=True)
            host.copy_(c, non_blocking=True)
            out[k] = host
        ev = torch.cuda.Event()
        ev.record(side)
    return {k: (h, ev) for k, h in out.items()}


def _npz_state(key: str, a: np.ndarray) -> np.ndarray:
    """A state array in the JAX runner's checkpoint dtype: u32 for the
    accumulators (int32 bit patterns, or a rank sum in int64 that must
    fit), int64 for stats."""
    if key not in U32_KEYS:
        return a.astype(np.int64)
    if a.dtype == np.int32:
        return a.view(np.uint32)
    if a.size and (int(a.min()) < 0 or int(a.max()) > 0xFFFFFFFF):
        raise OverflowError(f"state {key!r} passes the u32 range of the "
                            f"checkpoint format")
    return a.astype(np.uint32)


def _state_tensor(key: str, a: np.ndarray, device) -> torch.Tensor:
    """A checkpoint's state array as the runner's device tensor: u32
    accumulators as int32 bit patterns, stats int64."""
    if key in U32_KEYS:
        a = np.ascontiguousarray(a.astype(np.uint32)).view(np.int32)
    else:
        a = a.astype(np.int64)
    return torch.from_numpy(a).to(device)


class DeviceAlignRunner:
    def __init__(self, rpgg: RPGG, cfg: AlignConfig, batch_pairs: int = 4096,
                 max_read_len: int = 256, expand_cap: int = 512,
                 retry_expand: int | list = 0, drp=None, device=None,
                 thread_view=None, prefilter_mult: int | None = None):
        """``rpgg`` is the host view of the index that referee'd pairs
        are resolved against: a host_align.RPGG (dict-backed, built from
        the text formats) or, at production scale, a flat_rpgg.FlatRPGG
        view of ``drp``'s tables.  The referee is the pooled native
        engine (native_referee.ParallelReferee) where
        native_referee.supported(cfg) holds and DTK_NO_NATIVE_REFEREE is
        unset, else the Python HostAligner, as in the JAX package.

        In threading mode a step's fallback pairs (walk not clean) go to
        the native engine in one batched call, or with ``cfg.tc`` (-gcc)
        to the Python engine pair by pair, as in the JAX package.  At
        scale no host view carries the locus graphs (the JAX package's
        FlatRPGG.load_graphs raises too), so threading may run with
        ``rpgg=None`` and a ``thread_view``: an object with per-locus
        ``graphs[d]`` (a dict or a (nodes, masks) array pair) and
        ``tr_counts[d]`` (a dict) for the batched fallback.  Its
        referee'd pairs are counted, not resolved.  ``rpgg=None`` without
        a ``thread_view`` raises ValueError.  ``prefilter_mult``: a
        prefilter dispatch's pairs over the step's (default
        DTK_PREFILTER_MULT, else PREFILTER_MULT)."""
        da.check_ported_config(cfg)
        if rpgg is None and (thread_view is None or not cfg.threading):
            raise ValueError("a runner needs an rpgg (a FlatRPGG view of "
                             "drp at scale) to resolve referee'd pairs; "
                             "only threading with a thread_view runs "
                             "without one")
        self.device = resolve_device(device)
        self.rpgg = rpgg
        self.cfg = cfg
        self.prefilter_mult = prefilter_mult
        self.P = batch_pairs
        self.L = max_read_len
        self.expand_cap = expand_cap
        self.drp = drp if drp is not None else \
            da.DeviceRPGG.build(rpgg, with_tre=cfg.output_bubbles)
        if cfg.threading and self.drp.graph_tab is None:
            self.drp.add_graph(rpgg)
        # threading and extract never write .kam
        self.okam = bool(cfg.okam and not cfg.threading and not cfg.extract)
        # fastq + bait: the bait count profile skips quality-masked k-mers
        # (aQueryFasta_thread.h:1038-1078); the mask is made on the host
        self.with_qual = bool(cfg.is_fastq and cfg.bait
                              and self.drp.bait_tab is not None)
        # the retry ladder: tiers of strictly growing E, each with a batch
        # size that keeps P * E within ~4x the primary step's; the steps
        # are built on first use
        if not retry_expand:
            ladder = []
        elif isinstance(retry_expand, int):
            ladder = [retry_expand]
        else:
            ladder = [int(e) for e in retry_expand]
        if not all(b > a for a, b in zip([expand_cap] + ladder, ladder)):
            raise ValueError(f"the retry ladder must strictly grow from "
                             f"expand_cap={expand_cap}: {ladder}")
        self.retry_E = ladder
        self.retry_P = [self._tier_P(E) for E in ladder]
        self.retry_steps: list = [None] * len(ladder)
        self.n_retried = 0
        self.step = self._build_step(expand_cap, with_annot=self.okam,
                                     with_qual=self.with_qual)
        self.state = self._init_state()
        # host oracle: referee'd pairs' counts go into the rpgg's counts.
        # Without an rpgg (threading at scale) flagged pairs are counted,
        # not resolved
        self.host = HostAligner(rpgg, cfg) if rpgg is not None else None
        # the pooled C++ engine runs supported configs with identical
        # state updates: its calls fan over threads (GIL released in C)
        # and the verdicts apply in submission order
        self.referee = self.host
        if self.host is not None \
                and not os.environ.get("DTK_NO_NATIVE_REFEREE"):
            from . import native_referee as nr

            if nr.supported(cfg):
                self.referee = nr.ParallelReferee(self.host)
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
        self.extract_rows: list[str] = []
        self.n_referee = 0
        self.referee_reasons = {"tie": 0, "ovf": 0, "t2": 0}
        # referee calls made (each pooled call has landed when run_batches
        # returns) and the host seconds spent in them and in the flushes
        self.n_resolved = 0
        self.referee_s = 0.0
        self.n_prefiltered = 0
        self.n_steps = 0            # full steps dispatched (retry tiers too)
        self.n_step_pairs = 0       # live pairs entering primary steps
        self.n_host_thread = 0      # pairs of the host threading fallback
        self.n_device_thread = 0    # pairs threaded clean on the device
        self.prefilter_step = None
        self.prefilter_P = None
        # prefilter dispatches in flight (the checkpoint tests drain each
        # dispatch at once, so saves land before an injected fault)
        self.prefilter_window = PREFILTER_WINDOW
        # this process applies host effects (referee calls, rows, bubble
        # inserts) and writes checkpoints; a sharded runner's other ranks
        # only step their slices and keep the ladder in lockstep
        self.lead = True
        self._ckpt_pool = None
        self._ckpt_fut = None
        self._last_ckpt_wall = None

    def _tier_P(self, E: int) -> int:
        """Batch size of a retry tier: keep P * E (the vote's working set)
        within ~4x the primary step's."""
        scale = max(1, E // (4 * self.expand_cap))
        return max(128, self.P // scale)

    # -- step construction hooks (the sharded runner overrides them) --

    def _build_step(self, expand_cap, with_annot, with_qual, P=None):
        return da.make_step(
            self.drp, self.cfg, P or self.P, self.L, expand_cap=expand_cap,
            with_annot=with_annot, with_bubbles=self.cfg.output_bubbles,
            with_qual=with_qual, device=self.device)

    def _init_state(self):
        return da.init_state(self.drp, self.device)

    def _retry_step(self, t: int):
        """Retry tier t's step, built on first use (an okam tier carries
        the annotation plane for .kam rows)."""
        if self.retry_steps[t] is None:
            self.retry_steps[t] = self._build_step(
                self.retry_E[t], with_annot=self.okam,
                with_qual=self.with_qual, P=self.retry_P[t])
        return self.retry_steps[t]

    def _prefilter(self, Pp: int):
        """The prefilter dispatch of Pp pairs, built on first use."""
        if self.prefilter_P != Pp:
            self.prefilter_step = self._build_prefilter(Pp)
            self.prefilter_P = Pp
        return self.prefilter_step

    def _build_prefilter(self, Pp: int):
        """Returns step(codes, rlen, live) -> survive (Pp,) on the device:
        host-sampled queries (native sampler), then KK[q]'s member probe
        and decision in one launch; with DTK_PREFILTER_HOSTQ=0 (read here,
        once, as the JAX runner does) the code rows go to the card and KK
        samples, probes and decides there."""
        cfg = self.cfg
        if os.environ.get("DTK_PREFILTER_HOSTQ", "1") == "0":
            return da.make_prefilter_step(self.drp, cfg, Pp, self.L,
                                          self.device)
        qstep = da.make_prefilter_step_q(self.drp, cfg, Pp, self.device)
        from ..io.native_reader import sample_queries

        def _pre(codes, rlen, live):
            qlo, qhi, valid, nonshort = sample_queries(
                codes, rlen, cfg.ksize, cfg.n_filter)
            return qstep(da.query_int64(qlo, qhi), valid, nonshort, live)

        return _pre

    def _dev_state(self, key: str) -> np.ndarray:
        """A device accumulator as a host array: u32 keys as uint32, stats
        int64 (a sharded runner merges its ranks' in int64)."""
        t = self.state[key]
        return da.state_u32(t) if key in U32_KEYS else t.cpu().numpy()

    def _outputs(self, out: dict, keys) -> dict:
        """The step planes the host reads, for the whole batch (a sharded
        runner gathers its ranks' slices)."""
        return {key: out[key] for key in keys}

    def _agree(self, flag: bool) -> bool:
        """A decision every rank takes together (a sharded runner's ranks
        must save checkpoints at the same dispatch)."""
        return flag

    def run_file_native(self, path: str, prefilter: bool = False,
                        checkpoint: str | None = None,
                        checkpoint_every: int | None = None):
        """Production ingest: the C reader packs batches directly; read
        strings are decoded from the 2-bit codes only where the host needs
        them.  With ``prefilter`` a sampled-k-mer pass on the device drops
        non-matching pairs first and only densely re-packed survivors run
        the full step.  ``checkpoint`` and ``checkpoint_every`` are
        run_batches'."""
        from ..io.native_reader import NativeBatchReader
        from ..io.prefetch import PrefetchIterator

        cfg = self.cfg
        if cfg.extract:
            raise ValueError("-e extract mode uses run_file (the native "
                             "reader path has no extract rows)")
        reader = NativeBatchReader(
            path, self.dispatch_pairs(prefilter), self.L,
            is_fastq=cfg.is_fastq, min_read_size=cfg.cth + cfg.ksize - 1,
            with_titles=self._with_titles(), with_quals=self._with_quals())
        reader = PrefetchIterator(reader, READER_PREFETCH)
        try:
            self.run_batches(reader, prefilter, checkpoint=checkpoint,
                             checkpoint_every=checkpoint_every)
        finally:
            reader.close()

    def run_file(self, path: str, checkpoint: str | None = None,
                 checkpoint_every: int = 1_000_000):
        """Python ingest (the JAX runner's run_file): iter_fasta_pairs
        batches of reads_per_batch / 2 pairs, each cut into chunks of P
        pairs, one full step a chunk (no prefilter).  The step sees the
        reads cut to L; the host gets the full records.  With -bu the
        bubble maps merge after every reader batch.  ``checkpoint`` covers
        counting mode only (no .kam rows, no -bu), with a chunk-aligned
        pair cursor; it saves every ``checkpoint_every`` pairs and at the
        end."""
        cfg = self.cfg
        if checkpoint is not None and (cfg.okam or cfg.output_bubbles):
            raise ValueError("checkpointing run_file covers counting mode "
                             "only: pass -ka and no -bu")
        batches = iter_fasta_pairs(
            path, cfg.cth + cfg.ksize - 1, self.drp.nloci, cfg.simmode,
            cfg.reads_per_batch // 2, is_fastq=cfg.is_fastq)
        chunks = (self._pack_chunk(batch[i: i + self.P])
                  for batch in batches
                  for i in range(0, len(batch), self.P))
        self.run_batches(chunks, reads=True, checkpoint=checkpoint,
                         checkpoint_every=checkpoint_every)

    def _pack_chunk(self, pairs) -> tuple:
        """One run_batches record of up to P pairs of iter_fasta_pairs
        records: codes cut to L and padded with 255, rlen, n, the records
        (in an object array), and the phred+33 quality rows for fastq."""
        P, L = self.P, self.L
        codes = np.full((2 * P, L), 255, dtype=np.uint8)
        rlen = np.zeros(2 * P, dtype=np.int32)
        quals = (np.zeros((2 * P, L), dtype=np.uint8) if self.cfg.is_fastq
                 else None)
        recs = np.empty(len(pairs), dtype=object)
        for i, rec in enumerate(pairs):
            recs[i] = rec
            for m in (0, 1):
                c = K.encode_bases(rec[1 + m])[:L]
                codes[2 * i + m, : len(c)] = c
                rlen[2 * i + m] = len(c)
                if quals is not None:
                    q = np.frombuffer(rec[4 + m].encode(), np.uint8)[:L]
                    quals[2 * i + m, : len(q)] = q
        return codes, rlen, len(pairs), recs, quals

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
        if not prefilter:
            return self.P
        if self.prefilter_mult is not None:
            return self.P * int(self.prefilter_mult)
        return self.P * int(os.environ.get("DTK_PREFILTER_MULT",
                                           PREFILTER_MULT))

    def run_batches(self, batches, prefilter: bool = False,
                    checkpoint: str | None = None,
                    checkpoint_every: int | None = None,
                    reads: bool = False):
        """Runs packed batches (codes (2n', L) u8, rlen (2n',) i32, n
        live pairs[, titles[, quals]]) of ``dispatch_pairs(prefilter)``
        rows each through the funnel; the file path feeds it the native
        reader.  Titles are '>'-stripped (None without them), quals the
        (2n', L) u8 phred+33 rows.  With ``reads`` (run_file) the titles'
        place holds the pairs' iter_fasta_pairs records, and the host
        takes titles, sources, sequences and quality strings from them
        in full; unclean threading pairs then go to the host engine pair
        by pair.

        With ``checkpoint`` the run resumes from that file when it exists
        (batches up to its pair cursor are skipped; a resume under another
        configuration raises) and saves to it every ``checkpoint_every``
        input pairs, or with ``checkpoint_every=None`` at a cadence sized
        from the measured save cost (the first save after 60 s, then every
        20 x the last save's wall), and once at the end.  Saves are
        deferred: the state is snapshotted on the device and written by a
        background thread."""
        P, L = self.P, self.L
        cfg = self.cfg
        thr = cfg.threading
        okam = self.okam
        bub = bool(cfg.output_bubbles)
        ext = bool(cfg.extract)
        ordered = thr or okam or bub or ext
        wt, wq = reads or self._with_titles(), self._with_quals()
        sim = cfg.simmode
        nloci = self.drp.nloci
        lead = self.lead
        if checkpoint and thr and cfg.aln:
            raise ValueError("a checkpoint does not hold the .aln rows: run "
                             "threading with -a/-ae without --checkpoint")
        Pp = self.dispatch_pairs(prefilter)
        if prefilter:
            self._prefilter(Pp)
        # counting mode submits referee calls to the native pool (their
        # count adds commute); ordered modes call it synchronously, so a
        # pair's row lands in pair order.  The pool is flushed before a
        # -bu merge, a checkpoint save and the finalize
        ref = self.referee
        ref_submit = None if ordered else getattr(ref, "submit", None)

        def ref_call(fn, *a):
            t0 = time.perf_counter()
            fn(*a)
            self.referee_s += time.perf_counter() - t0

        def ref_flush():
            if hasattr(ref, "flush"):
                ref_call(ref.flush)
        aux_keys = (("referee_pack",)
                    + (THR_KEYS if thr else KAM_KEYS if okam
                       else EXT_KEYS if ext else ())
                    + (BUB_KEYS if bub else ()))

        def new_buffers(n):
            return dict(codes=np.full((2 * n, L), 255, dtype=np.uint8),
                        rlen=np.zeros(2 * n, dtype=np.int32),
                        titles=np.empty(n, dtype=object) if wt else None,
                        quals=np.zeros((2 * n, L), dtype=np.uint8)
                        if wq else None,
                        ords=np.zeros(n, dtype=np.int64) if ordered
                        else None, n=0)

        buf = new_buffers(P)

        done, pre = (self._load_checkpoint(checkpoint) if checkpoint
                     else (0, None))
        if pre is not None:
            self._check_resume(pre, prefilter, Pp)
            if prefilter:
                buf.update(codes=pre["buf_codes"], rlen=pre["buf_rlen"],
                           n=int(pre["nbuf"]))
                self.n_prefiltered = int(pre["n_prefiltered"])
                if wq and "buf_quals" in pre:
                    buf["quals"] = pre["buf_quals"]

        # the retry tiers' buffers; tier 0's npz keys keep the JAX
        # runner's single-tier names
        ntier = len(self.retry_E)
        ret = []
        for t in range(ntier):
            r = new_buffers(self.retry_P[t])
            pk, nk = ("ret", "nret") if t == 0 else (f"ret{t}", f"nret{t}")
            if pre is not None and f"{pk}_codes" in pre:
                r.update(codes=pre[f"{pk}_codes"], rlen=pre[f"{pk}_rlen"],
                         n=int(pre[nk]))
                if wq and f"{pk}_quals" in pre:
                    r["quals"] = pre[f"{pk}_quals"]
            ret.append(r)
        if ntier and pre is not None and "n_retried" in pre:
            self.n_retried = int(pre["n_retried"])

        # threading fallback: batched calls MUST serialize, since each
        # dtk_thread_pairs call merges into the shared per-locus CountMaps
        # at its end (one worker = one call in flight; its own threads
        # give the parallelism)
        thr_batch_pool = None
        if thr and self.nthr is not None and not reads:
            from concurrent.futures import ThreadPoolExecutor

            thr_batch_pool = ThreadPoolExecutor(1)

        # ordered mode: ordinal -> buffered effects, applied strictly in
        # ordinal (pair) order; a pair deferred to a retry tier leaves a
        # hole that its tier (or the referee) fills later
        ord_next = 0
        ord_pend: dict[int, list] = {}
        n_ord = 0

        def pair_src(title):
            if sim == 2:
                return parse_read_name_sim2(title, nloci)
            if sim == 1:
                return parse_read_name_sim1(title)
            return -1

        def title_src(titles, i):
            """Pair i's title and source locus: from its record, or from
            the native title ('>'-stripped and pruned)."""
            if reads:
                return titles[i][0], titles[i][3]
            title = ">" + titles[i] if titles is not None else ">r"
            return title, pair_src(title) if sim else -1

        def host_reads(codes, rlen, quals, titles, i):
            """Pair i's (seq1, seq2, (qual1, qual2)) as the host sees
            them: from its record, or decoded from the packed rows."""
            if reads:
                rec = titles[i]
                return (rec[1], rec[2],
                        tuple(rec[4:6]) if len(rec) > 4 else (None, None))
            qs = (None, None)
            if quals is not None:
                qs = (_decode_qual(quals[2 * i], rlen[2 * i]),
                      _decode_qual(quals[2 * i + 1], rlen[2 * i + 1]))
            return (_decode(codes[2 * i], rlen[2 * i]),
                    _decode(codes[2 * i + 1], rlen[2 * i + 1]), qs)

        def ref_effect(codes, rlen, quals, titles, i):
            """The referee call's inputs, captured now; the call runs at
            apply time so its .kam / .aln / extract row and bubbles land
            in pair order."""
            title, src = title_src(titles, i)
            s1, s2, qs = host_reads(codes, rlen, quals, titles, i)
            return ("ref", title, s1, s2, src, qs)

        def apply_effect(e):
            tag = e[0]
            host = self.host
            if tag == "kam":
                self.kam_rows.append(e[1])
            elif tag == "bub":
                self._add_bubbles_codes(*e[1:])
            elif tag == "aln":
                self.aln_rows.append(e[1])
            elif tag == "ext":
                _, title, s1, s2, dst0_i, qs = e
                host._record_extract(title, s1, s2, dst0_i, qs)
                self.extract_rows.append(host.extract_rows.pop())
            elif tag == "thr":
                # -gcc, or the Python ingest: the host engine walks (and
                # with -gcc checks) the pair here
                _, title, s1, s2, src, dst0_i = e
                self.n_host_thread += 1
                host.stats["nThreadingReads"] += 2
                rows, sink = ((host.extract_rows, self.extract_rows) if ext
                              else (host.aln_rows, self.aln_rows))
                n0 = len(rows)
                host._thread_pair(title, s1, s2, src, dst0_i)
                if len(rows) > n0:
                    sink.append(rows.pop())
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
            elif ref_submit is not None:        # referee, pooled
                self.n_resolved += 1
                ref_call(ref_submit, *e[1:])
            else:                               # referee (synchronous)
                _, title, s1, s2, src, qs = e
                # the referee's freshly appended row moves into the
                # runner's sink in pair order
                rows, sink = ((host.kam_rows, self.kam_rows) if okam else
                              (host.extract_rows, self.extract_rows) if ext
                              else (host.aln_rows, self.aln_rows))
                n0 = len(rows)
                self.n_resolved += 1
                ref_call(ref.process_pair, title, s1, s2, src, qs)
                if len(rows) > n0:
                    sink.append(rows.pop())

        def emit(o, effs):
            nonlocal ord_next
            ord_pend[o] = effs
            while ord_next in ord_pend:
                for e in ord_pend.pop(ord_next):
                    apply_effect(e)
                ord_next += 1

        def referee_pair(codes, rlen, quals, titles, i):
            """A flagged pair's effects: the host referee's call, or with
            no rpgg (or on a rank that does not lead) none: it is
            counted."""
            self.n_referee += 1
            if self.host is None or not lead:
                return []
            return [ref_effect(codes, rlen, quals, titles, i)]

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
            """The ordinal-buffered effects of one threading step (pairs
            deferred to a retry tier are no longer flagged here)."""
            alive = (ko["nonshort"][:n] & ~ko["sub_drop"][:n]
                     & ko["pair_alive"][:n] & ~ko["qc_drop"][:n]
                     & ko["vote_pass"][:n])
            alive[:lo] = False
            # a pair deferred to a retry tier (ordinal -1) is threaded there
            alive &= ords[:n] >= 0
            clean = ko["clean_pair"][:n]
            self.n_device_thread += int((alive & clean & ~referee).sum())
            thr_batch = None
            bidx = np.nonzero(alive & ~clean & ~referee)[0]
            if thr_batch_pool is not None and len(bidx):
                thr_batch = submit_batch(bidx, ko, codes, rlen)
            for i in range(lo, n):
                if ords[i] < 0:
                    continue
                effs = []
                if referee[i]:
                    effs = referee_pair(codes, rlen, quals, titles, i)
                elif alive[i]:
                    dst0_i = int(ko["dst0"][i])
                    title, srcv = title_src(titles, i)
                    if clean[i] and ext:
                        # a clean walk: both mates feasible
                        s1, s2, qs = host_reads(codes, rlen, quals, titles, i)
                        effs.append(("ext", title, s1, s2, dst0_i, qs))
                    elif clean[i]:
                        if cfg.aln:
                            s1, s2, _ = host_reads(codes, rlen, quals,
                                                   titles, i)
                            effs.append(("aln", self._thread_aln_row(
                                ko, i, s1, s2, title, srcv)))
                    elif thr_batch is not None:
                        # sequences are only needed for the .aln row
                        s1 = s2 = None
                        if cfg.aln:
                            s1, s2, _ = host_reads(codes, rlen, quals,
                                                   titles, i)
                        effs.append(("thrb", title, s1, s2, srcv, dst0_i,
                                     thr_batch[0], thr_batch[1][i]))
                    else:
                        s1, s2, _ = host_reads(codes, rlen, quals, titles, i)
                        effs.append(("thr", title, s1, s2, srcv, dst0_i))
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
                if ords[i] < 0:
                    continue
                effs = []
                if referee[i]:
                    effs = referee_pair(codes, rlen, quals, titles, i)
                elif lead:
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
                            ko, i, title_src(titles, i),
                            lambda: host_reads(codes, rlen, quals, titles, i))
                        if row is not None:
                            effs.append(("kam", row))
                emit(int(ords[i]), effs)

        def extract_effects(ko, referee, codes, rlen, quals, titles, n, lo,
                            ords):
            """The ordinal-buffered effects of one -e step (JAX
            _post_chunk_extract): the referee call, or the row of a pair
            that passed the vote, at dst0."""
            keep = (ko["nonshort"][:n] & ~ko["sub_drop"][:n]
                    & ko["pair_alive"][:n] & ko["vote_pass"][:n])
            for i in range(lo, n):
                if ords[i] < 0:
                    continue
                effs = []
                if referee[i]:
                    effs = referee_pair(codes, rlen, quals, titles, i)
                elif lead and keep[i]:
                    title, _ = title_src(titles, i)
                    s1, s2, qs = host_reads(codes, rlen, quals, titles, i)
                    effs.append(("ext", title, s1, s2, int(ko["dst0"][i]),
                                 qs))
                emit(int(ords[i]), effs)

        def defer_pair(t, codes, rlen, quals, titles, i, o):
            """Moves pair i into retry tier t's buffer (a full buffer
            steps at once)."""
            self.n_retried += 1
            r = ret[t]
            j = r["n"]
            r["codes"][2 * j: 2 * j + 2] = codes[2 * i: 2 * i + 2]
            r["rlen"][2 * j: 2 * j + 2] = rlen[2 * i: 2 * i + 2]
            if wq:
                r["quals"][2 * j: 2 * j + 2] = quals[2 * i: 2 * i + 2]
            if wt:
                r["titles"][j] = titles[i]
            if ordered:
                r["ords"][j] = o
            r["n"] = j + 1
            if r["n"] == self.retry_P[t]:
                flush_retry(t)

        # steps are processed fs_window steps after dispatch: the referee
        # pack and the planes the host reads travel device->host in
        # non_blocking copies, so the fetch overlaps the next steps;
        # effects apply in dispatch order
        fs_pending: deque = deque()
        fs_window = 3

        def process_step():
            (handles, b, n, lo, next_tier) = fs_pending.popleft()
            codes, rlen, quals, titles = (b["codes"], b["rlen"], b["quals"],
                                          b["titles"])
            ords = b["ords"]
            ko = {key: _fetched(h) for key, h in handles.items()}
            pk = ko["referee_pack"][:n]
            referee = (pk & 1) != 0
            for bit, key in ((2, "tie"), (4, "ovf"), (8, "t2")):
                self.referee_reasons[key] += int(((pk & bit) != 0).sum())
            if next_tier is not None:
                # overflow pairs climb to the next tier instead
                ovf = ((pk & 4) != 0) & referee
                ovf[:lo] = False
                for i in np.nonzero(ovf)[0]:
                    defer_pair(next_tier, codes, rlen, quals, titles, i,
                               int(ords[i]) if ordered else 0)
                referee &= ~ovf
                if ordered:
                    ords = ords.copy()
                    ords[:n][ovf] = -1
            if thr:
                thread_effects(ko, referee, codes, rlen, quals, titles, n,
                               lo, ords)
            elif ext:
                extract_effects(ko, referee, codes, rlen, quals, titles, n,
                                lo, ords)
            elif ordered:
                count_effects(ko, referee, codes, rlen, quals, titles, n,
                              lo, ords)
            else:
                # counting mode: only flagged pairs need host work; the
                # order of their count adds is irrelevant
                for i in np.nonzero(referee[lo:])[0] + lo:
                    for e in referee_pair(codes, rlen, quals, titles, i):
                        apply_effect(e)

        def drain_steps(to: int = 0):
            while len(fs_pending) > to:
                process_step()

        def run_step(step_fn, liveP, b, n, lo, next_tier):
            """Dispatches one step over pairs [lo, n) of buffer b."""
            live = np.zeros(liveP, dtype=bool)
            live[lo:n] = True
            self.n_steps += 1
            if self.with_qual:
                qm = da.qmask_batch(b["quals"], b["rlen"], cfg.qth,
                                    cfg.ksize)
                self.state, out = step_fn(self.state, b["codes"], b["rlen"],
                                          live, qm)
            else:
                self.state, out = step_fn(self.state, b["codes"], b["rlen"],
                                          live)
            got = self._outputs(out, aux_keys)
            fs_pending.append(({key: _fetch_async(v)
                                for key, v in got.items()}, b, n, lo,
                               next_tier))
            drain_steps(fs_window)

        def flush_retry(t: int):
            r = ret[t]
            if not r["n"]:
                return
            Pt = self.retry_P[t]
            ret[t] = new_buffers(Pt)
            run_step(self._retry_step(t), Pt, r, r["n"], 0,
                     t + 1 if t + 1 < ntier else None)

        def drain_ladder():
            """Resolves every in-flight and deferred pair: tier flushes
            cascade (a tier's overflow lands in the next tier's buffer)
            and the last tier's overflow goes to the referee."""
            drain_steps()
            for t in range(ntier):
                flush_retry(t)
                drain_steps()
            if ordered and ord_pend:
                raise RuntimeError(f"{len(ord_pend)} ordinals unresolved "
                                   f"after the ladder drained")

        def full_step(b, n, lo=0):
            """One primary step over pairs [lo, n) of buffer b (pairs
            before lo belong to an earlier dispatch of the same batch)."""
            nonlocal n_ord
            self.n_step_pairs += n - lo
            if ordered:
                b["ords"][lo:n] = np.arange(n_ord, n_ord + n - lo)
                n_ord += n - lo
            run_step(self.step, P, b, n, lo, 0 if ntier else None)

        def step_buf():
            nonlocal buf
            if not buf["n"]:
                return
            full_step(buf, buf["n"])
            buf = new_buffers(P)

        def copy_survivors(sel, codes, rlen, titles, quals):
            # block-copy survivors into the repack buffer (chunked at
            # full-step boundaries); rows interleave the two mates
            taken = 0
            while taken < len(sel):
                nb = buf["n"]
                chunk = sel[taken: taken + (P - nb)]
                taken += len(chunk)
                src = np.stack([2 * chunk, 2 * chunk + 1], axis=1).ravel()
                dst = slice(2 * nb, 2 * (nb + len(chunk)))
                buf["codes"][dst] = codes[src]
                buf["rlen"][dst] = rlen[src]
                if wq:
                    buf["quals"][dst] = quals[src]
                if wt:
                    buf["titles"][nb: nb + len(chunk)] = \
                        np.asarray(titles, dtype=object)[chunk]
                buf["n"] = nb + len(chunk)
                if buf["n"] == P:
                    step_buf()

        # -bu flush cadence: the reference merges batch-local bubble maps
        # into the global DB every reads_per_batch reads (accumBubbles);
        # the .bub bytes depend on that merge order, so the funnel
        # barriers at the same input-pair boundaries.  On resume every
        # boundary <= the saved cursor had fired in the writing run
        bflush = max(cfg.reads_per_batch // 2, 1)
        next_flush = (done // bflush + 1) * bflush
        cursor = 0                  # input pairs consumed
        since = 0                   # input pairs since the last save
        auto_ck = checkpoint is not None and checkpoint_every is None
        last_save = time.time()

        def batch_flush_barrier():
            # everything before the boundary lands (referee, retry and
            # bubble effects) before the batch-local maps merge; deferred
            # pairs flush through their tiers here (a partial tier batch
            # gives the same per-pair results)
            nonlocal next_flush
            step_buf()
            drain_ladder()
            ref_flush()
            self.bubbles.flush_batch()
            next_flush += bflush

        def ckpt_due() -> bool:
            if not checkpoint:
                return False
            if not auto_ck:
                return since >= checkpoint_every
            interval = CKPT_FIRST_S
            if self._last_ckpt_wall is not None:
                interval = max(CKPT_WALL_MULT * self._last_ckpt_wall,
                               CKPT_FIRST_S)
            return self._agree(time.time() - last_save >= interval)

        def save_ckpt():
            nonlocal since, last_save
            # every effect up to the cursor lands first; ordered mode and
            # the Python ingest also step the repack buffer and drain the
            # ladder, so no pending effect (or record) needs saving
            if ordered or reads:
                step_buf()
                drain_ladder()
            else:
                drain_steps()
            ref_flush()
            if reads:
                # the JAX run_file's checkpoint: the cursor and the counts
                self._save_checkpoint(checkpoint, cursor, defer=True)
                since = 0
                last_save = time.time()
                return
            extra = dict(cfg_P=P, cfg_retry_E=sum(self.retry_E),
                         cfg_prefilter=int(bool(prefilter)),
                         cfg_okam=int(okam), cfg_bub=int(bub))
            if ordered:
                import pickle

                from ..io.rowsink import RowSink

                if okam:
                    kr = self.kam_rows
                    if isinstance(kr, RowSink) and kr.path is not None:
                        extra["kam_offset"] = kr.byte_offset()
                        extra["kam_nrows"] = kr.n_written
                    else:
                        extra["kam_rows_pkl"] = np.frombuffer(
                            pickle.dumps(list(kr)), np.uint8)
                if bub:
                    bm = self.bubbles
                    extra["bub_pkl"] = np.frombuffer(pickle.dumps(
                        (bm.bub_orders, bm.bub_counts, bm._bub_batch)),
                        np.uint8)
            if prefilter:
                extra.update(buf_codes=buf["codes"], buf_rlen=buf["rlen"],
                             nbuf=buf["n"], n_prefiltered=self.n_prefiltered,
                             pre_P=Pp)
                if wq:
                    extra["buf_quals"] = buf["quals"]
            for t in range(ntier):
                pk, nk = (("ret", "nret") if t == 0
                          else (f"ret{t}", f"nret{t}"))
                extra[f"{pk}_codes"] = ret[t]["codes"]
                extra[f"{pk}_rlen"] = ret[t]["rlen"]
                extra[nk] = ret[t]["n"]
                extra["n_retried"] = self.n_retried
                if wq:
                    extra[f"{pk}_quals"] = ret[t]["quals"]
            self._save_checkpoint(checkpoint, cursor, extra, defer=True)
            since = 0
            last_save = time.time()

        pending: deque = deque()

        def drain_one():
            nonlocal cursor, since
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
            since += n
            if ckpt_due():
                save_ckpt()

        try:
            for rec in batches:
                codes, rlen, n = rec[0], rec[1], rec[2]
                titles = rec[3] if wt else None
                quals = rec[4] if wq else None
                if cursor + n <= done:
                    cursor += n
                    continue
                if cursor < done:
                    raise ValueError(
                        "checkpoint cursor is not aligned to this run's "
                        "dispatch size: resume with the batch_pairs and "
                        "prefilter of the checkpointing run")
                if prefilter:
                    live = np.zeros(Pp, dtype=bool)
                    live[:n] = True
                    # several dispatches stay in flight; every batch is a
                    # fresh array, so queueing needs no copies
                    surv = self.prefilter_step(codes, rlen, live)
                    pending.append((codes, rlen, n, titles, quals,
                                    _fetch_async(surv)))
                    if len(pending) >= self.prefilter_window:
                        drain_one()
                    continue
                b = dict(codes=codes, rlen=rlen, titles=titles, quals=quals,
                         ords=np.zeros(n, dtype=np.int64) if ordered
                         else None)
                lo = 0
                if bub:
                    # split the batch at flush boundaries (live range
                    # [lo, hi)); the maps merge between the parts
                    while next_flush - cursor <= n:
                        rel = next_flush - cursor
                        if rel > lo:
                            full_step(b, rel, lo)
                            lo = rel
                        batch_flush_barrier()
                if n > lo:
                    full_step(b, n, lo)
                cursor += n
                since += n
                if ckpt_due():
                    save_ckpt()
            while pending:
                drain_one()
            step_buf()
            drain_ladder()
            ref_flush()
            if self.bubbles is not None:
                self.bubbles.flush_batch()
            # batched threading counts live in native CountMaps until
            # here; the outputs read the per-locus dicts
            if self.nthr is not None:
                self.nthr.drain_counts_into(self.tview.tr_counts)
            if checkpoint and since:
                save_ckpt()
        finally:
            # a deferred write lands (or raises) before the run returns,
            # also when the run is abandoned by an exception
            if thr_batch_pool is not None:
                thr_batch_pool.shutdown(wait=True)
            if checkpoint:
                self._ckpt_join()

    def _check_resume(self, pre: dict, prefilter: bool, Pp: int) -> None:
        """Refuses a resume whose configuration differs from the
        checkpointing run's: the cursor's granularity and the saved
        buffers mean something only under that configuration."""
        def require(key, cur, what):
            if key in pre and int(pre[key]) != int(cur):
                raise ValueError(
                    f"checkpoint resume config mismatch: {what} was "
                    f"{int(pre[key])} in the checkpointing run, now "
                    f"{int(cur)}")

        require("cfg_P", self.P, "batch_pairs")
        require("cfg_retry_E", sum(self.retry_E), "retry_expand")
        require("cfg_prefilter", int(bool(prefilter)), "prefilter")
        require("cfg_okam", int(self.okam), "okam (.kam output)")
        require("cfg_bub", int(self.cfg.output_bubbles),
                "output_bubbles (-bu)")
        if prefilter:
            require("pre_P", Pp, "prefilter dispatch size")
            if "buf_codes" not in pre:
                raise ValueError("checkpoint was written without "
                                 "prefilter; resume with prefilter=False")
        elif "buf_codes" in pre:
            raise ValueError("checkpoint was written by a prefilter run; "
                             "resume with prefilter=True")
        if "ret_codes" in pre and not self.retry_E \
                and int(pre.get("nret", 0)) > 0:
            raise ValueError("checkpoint holds pending retry-buffer pairs; "
                             "resume with the same retry_expand")

    # -- checkpoints --

    def _state_snapshot(self) -> dict:
        """The device state copied to the host without stalling the
        steps: each tensor is cloned on a side stream (the main stream
        waits for the clones only), then copied into pinned memory with a
        non-blocking copy.  Returns {key: (host tensor, event)} for
        ``_fetched``."""
        return _snapshot_async(self.state)

    def _save_checkpoint(self, path: str, cursor: int,
                         extra: dict | None = None, defer: bool = False):
        """Persists the count state and the cursor.  ``defer=True`` (the
        funnel) writes the npz from a background thread once the
        snapshot's copy lands; the cursor inside always matches its own
        snapshot."""
        self._ckpt_join()
        snap = self._state_snapshot()
        if not self.lead:
            return
        hsnap = self._host_snapshot()
        # the loop mutates the repack and retry buffers in place later
        ex = None if extra is None else {
            k: (np.array(v) if isinstance(v, np.ndarray) else v)
            for k, v in extra.items()}
        if not defer:
            self._ckpt_write(path, cursor, snap, hsnap, ex)
            return
        if self._ckpt_pool is None:
            from concurrent.futures import ThreadPoolExecutor

            self._ckpt_pool = ThreadPoolExecutor(1)
        self._ckpt_fut = self._ckpt_pool.submit(
            self._ckpt_write, path, cursor, snap, hsnap, ex)

    def _host_snapshot(self) -> dict:
        """The host side of a checkpoint: the referee's counts (zeros
        without an rpgg) and n_referee."""
        if self.nthr is not None:
            self.nthr.drain_counts_into(self.tview.tr_counts)
        if self.host is None:
            nl = self.drp.nloci
            return dict(host_counts=np.zeros(self.drp.nslots, np.uint64),
                        host_nmapread=np.zeros(nl, np.uint64),
                        host_kmc=np.zeros(nl, np.uint64),
                        n_referee=self.n_referee)
        return dict(host_counts=self.host.flat_counts().copy(),
                    host_nmapread=self.host.nmapread.copy(),
                    host_kmc=self.host.kmc.copy(),
                    n_referee=self.n_referee)

    def _ckpt_write(self, path, cursor, snap, hsnap, extra):
        t0 = time.time()
        state = {k: _npz_state(k, _fetched(h)) for k, h in snap.items()}
        np.savez(path + ".tmp.npz", cursor=cursor, **hsnap,
                 **{f"dev_{k}": v for k, v in state.items()},
                 **{f"x_{k}": v for k, v in (extra or {}).items()})
        os.replace(path + ".tmp.npz", path)
        # the measured save wall sizes the auto cadence
        self._last_ckpt_wall = time.time() - t0

    def _ckpt_join(self):
        fut = self._ckpt_fut
        if fut is not None:
            self._ckpt_fut = None
            fut.result()

    def _load_checkpoint(self, path: str) -> tuple[int, dict | None]:
        """Restores the state of the checkpoint at ``path`` (written by
        this runner or the JAX package's); returns (pair cursor, extra
        state or None).  Without the file: (0, None)."""
        if not os.path.exists(path):
            return 0, None
        z = np.load(path)
        self.state = {k[4:]: _state_tensor(k[4:], z[k], self.device)
                      for k in z.files if k.startswith("dev_")}
        flat = z["host_counts"]
        if self.host is None:
            if flat.any():
                raise ValueError("checkpoint holds referee counts but this "
                                 "runner has no rpgg to restore them into")
        elif hasattr(self.rpgg, "flat_counts"):
            # the flat view: one array copy
            self.rpgg.flat_counts()[:] = flat
        else:
            p = 0
            for li in range(self.rpgg.nloci):
                cnt = self.rpgg.tr_counts[li]
                for km in self.rpgg.tr_orders[li]:
                    cnt[km] = int(flat[p])
                    p += 1
        if self.host is not None:
            self.host.nmapread = z["host_nmapread"].astype(np.uint64)
            self.host.kmc = z["host_kmc"].astype(np.uint64)
        self.n_referee = int(z["n_referee"])
        extra = {k[2:]: z[k] for k in z.files if k.startswith("x_")}
        # an okam / -bu mismatch is diagnosed before any side state is
        # restored (a counting run would otherwise trip on the kam sink)
        for key, cur, what in (("cfg_okam", int(self.okam),
                                "okam (.kam output)"),
                               ("cfg_bub", int(self.cfg.output_bubbles),
                                "output_bubbles (-bu)")):
            if key in extra and int(extra[key]) != cur:
                raise ValueError(
                    f"checkpoint resume config mismatch: {what} was "
                    f"{int(extra[key])} in the checkpointing run, now {cur}")
        # ordered mode: truncate the .kam sink back to the checkpoint's
        # high-water mark (rows streamed after the save are replayed) and
        # restore the bubble maps
        if "kam_offset" in extra and self.lead:
            from ..io.rowsink import RowSink

            kr = self.kam_rows
            if not (isinstance(kr, RowSink) and kr.path is not None):
                raise ValueError(
                    "checkpoint recorded a streamed .kam high-water mark; "
                    "bind kam_rows to a RowSink(path, append=True) before "
                    "resuming")
            kr.truncate_to(int(extra["kam_offset"]), int(extra["kam_nrows"]))
        if "kam_rows_pkl" in extra:
            import pickle

            self.kam_rows = pickle.loads(extra["kam_rows_pkl"].tobytes())
        if "bub_pkl" in extra:
            import pickle

            bm = self.bubbles
            bm.bub_orders, bm.bub_counts, bm._bub_batch = pickle.loads(
                extra["bub_pkl"].tobytes())
        return int(z["cursor"]), (extra or None)

    # -- okam rows and bubbles --

    def _kam_device_row(self, ko, i, title_src, host_reads):
        """The .kam row of device-resolved pair i (JAX _kam_device_row and
        _kam_from_device): the funnel filters over the fetched planes.
        ``title_src`` is the pair's (title, source locus); ``host_reads()``
        gives its (seq1, seq2, (qual1, qual2)), called only for an emitted
        row.  Returns the row, or None when the pair emits nothing."""
        nloci = self.drp.nloci
        if not ko["nonshort"][i] or ko["sub_drop"][i] \
                or not ko["pair_alive"][i] or ko["qc_drop"][i]:
            return None
        # a pair that failed the vote emits no row, as in HostAligner and
        # both referees (the JAX device runner writes one for a known
        # source: ROADMAP queue 3, inherited)
        if not ko["vote_pass"][i]:
            return None
        title, src = title_src
        dest = int(ko["dest"][i]) if ko["counted"][i] else nloci
        if not ((src != nloci and src != -1) or dest != nloci):
            return None
        s1, s2, (q1, q2) = host_reads()
        # the assignTRkmc fields are set whenever the pair passed the vote
        # (even if both mates were then removed)
        rs = []
        for ridx in (2 * i, 2 * i + 1):
            r = ReadAsgn()
            r.kf, r.hf, r.bf = (int(ko["kf"][ridx]), int(ko["hf"][ridx]),
                                int(ko["bf"][ridx]))
            r.rm, r.af = int(ko["rm"][ridx]), int(ko["af"][ridx])
            r.nt, r.bs, r.ti = (int(ko["nt"][ridx]), int(ko["bs"][ridx]),
                                int(ko["ti"][ridx]))
            r.si, r.ei = int(ko["si"][ridx]), int(ko["ei"][ridx])
            r.as_ = ko["ann"][ridx][: int(ko["nk"][ridx])].tolist()
            rs.append(r)
        return _kam_row(title, src, dest, int(ko["dst0"][i]), rs[0], rs[1],
                        s1, s2, self.cfg.is_fastq, q1 or ".", q2 or ".")

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

    def _thread_aln_row(self, ko, i, s1, s2, title, src):
        """The .aln row of device-clean pair i: a clean DFA walk is an
        all-match CIGAR, annotations come from the tr_member plane."""
        src_s = "." if src == -1 else str(src)
        dst0 = int(ko["dst0"][i])
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

    def write_extract(self, fh):
        from ..io.rowsink import finalize_rows_fh

        finalize_rows_fh(self.extract_rows, fh)

    def write_kam(self, path):
        from ..io.rowsink import finalize_rows

        finalize_rows(self.kam_rows, path)

    def write_bubbles(self, path, threshold: int = 5):
        self.bubbles.write_bubbles(path, threshold)


class Stopped(Exception):
    """The interruption drill's fault (stop_after_prefilter)."""


def stop_after_prefilter(runner: DeviceAlignRunner, n_ok: int) -> None:
    """An interruption drill: the runner's prefilter dispatch after its
    first ``n_ok`` raises Stopped (on every rank of a sharded runner at
    the same one).  Each dispatch drains at once, so the checkpoints
    before it have landed."""
    runner.prefilter_window = 1
    build = runner._build_prefilter

    def counted(Pp):
        inner, n = build(Pp), [0]

        def step(codes, rlen, live):
            if n[0] >= n_ok:
                raise Stopped(f"stopped after {n[0]} prefilter dispatches")
            n[0] += 1
            return inner(codes, rlen, live)

        return step

    runner._build_prefilter = counted


def warmup_steps(runner: DeviceAlignRunner, prefilter: bool) -> dict:
    """Runs each step a run of ``runner`` can launch once, on the JAX
    warmup's empty batch (codes 255, rlen 0, every pair live; with the
    quality mask when the step takes one): the full step, each retry
    tier's step and, with ``prefilter``, the prefilter dispatch of
    dispatch_pairs(True) pairs, the last two built and kept on the runner
    as run_batches builds them.  Returns {step:
    seconds of its first call, synchronized}, named as the JAX ``warmup``
    prints them.  Empty reads count no k-mer, but the live empty pairs
    add to the read statistics and the trash slots (each accumulator's
    last entry, which no output reads): both are put back, so the
    runner's state is as it was."""
    cfg, L, dev = runner.cfg, runner.L, runner.device

    def empty(Pb):
        return (np.full((2 * Pb, L), 255, dtype=np.uint8),
                np.zeros(2 * Pb, dtype=np.int32), np.ones(Pb, dtype=bool))

    def first_call(fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return out, time.perf_counter() - t0

    def run_step(fn, Pb):
        codes, rlen, live = empty(Pb)
        a = [runner.state, codes, rlen, live]
        if runner.with_qual:
            a.append(da.qmask_batch(np.zeros((2 * Pb, L), np.uint8), rlen,
                                    cfg.qth, cfg.ksize))
        (runner.state, _), s = first_call(fn, *a)
        return s

    kept = {key: (v if key == "stats" else v[-1:]).clone()
            for key, v in runner.state.items()}
    secs = {f"align step P={runner.P} E={runner.expand_cap}":
            run_step(runner.step, runner.P)}
    for t, (E, Pt) in enumerate(zip(runner.retry_E, runner.retry_P)):
        secs[f"retry tier step P={Pt} E={E}"] = run_step(
            runner._retry_step(t), Pt)
    for key, v in kept.items():
        runner.state[key][-len(v):] = v
    if prefilter:
        Pp = runner.dispatch_pairs(True)
        secs[f"prefilter P={Pp}"] = first_call(runner._prefilter(Pp),
                                               *empty(Pp))[1]
    return secs
