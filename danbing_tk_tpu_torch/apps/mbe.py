"""Multi-boundary expansion (MBE) -- the core RPGG build-QC step
(reference script/multiBoundaryExpansion.parallel.py).

Jointly expands each locus's TR boundaries across all haplotypes until no
TR k-mer appears within the FS-wide flanks: any flank k-mer found in the
growing TR k-mer set is "noise"; boundaries move to cover it (adding the
newly covered k-mers to the set) and the scan repeats.  A haplotype fails
if its boundary would cross the TRWINDOW or expand beyond UB.

This implementation is vectorized numpy per locus (the flank scans are
array ops); loci are independent, so ``run_mbe(nproc=N)`` forks a pool of
N workers over them.  The module imports numpy and the port's numpy k-mer
helpers only: a worker forked from a process that already holds a CUDA
context (``build --device``, the smoke run) never touches torch or the
card.  Outputs
(pan.tr.mbe.v1.bed, locusMap.v1.to.v0.txt, per-hap tmp2 beds) are
byte-compatible with the reference.
"""

from __future__ import annotations

import os

import numpy as np

from ..ops import kmers_np as K

INVALID = 0xFFFFFFFFFFFFFFFF


def window_kmers(seq: str, k: int, skip_left: int = 0,
                 skip_right: int = 0) -> np.ndarray:
    """Canonical k-mers of seq[skip_left : len-skip_right] (positional,
    INVALID on N windows)."""
    codes = K.encode_bases(seq)[skip_left : len(seq) - skip_right]
    return K.seq_to_kmers(codes, k, canonical=True)


class _KmerPool:
    """Growing TR k-mer set as a sorted u64 array; membership tests are
    vectorized searchsorted (the reference does per-element Python set
    probes here — ~1200 CPU-hours at production scale)."""

    def __init__(self):
        self._sorted = np.empty(0, dtype=np.uint64)
        self._staged: list[np.ndarray] = []

    def stage(self, kms: np.ndarray):
        kms = kms[kms != INVALID]
        if len(kms):
            self._staged.append(kms)

    def _flush(self):
        if self._staged:
            self._sorted = np.unique(
                np.concatenate([self._sorted, *self._staged]))
            self._staged = []

    def contains(self, rows: np.ndarray) -> np.ndarray:
        self._flush()
        pool = self._sorted
        if not len(pool):
            return np.zeros(rows.shape, dtype=bool)
        pos = np.searchsorted(pool, rows)
        pos[pos == len(pool)] = 0
        return pool[pos] == rows


def mbe_locus(seqs, spans, FS: int, UB: int, ksize: int = 21):
    """Joint boundary expansion for one locus (the reference flow,
    multiBoundaryExpansion.parallel.py:79-167, re-derived: scan both
    FS-wide flanks of every haplotype for k-mers already in the joint TR
    pool; any hit pushes that boundary outward past it, the newly covered
    windows join the pool, and the scan repeats until clean).

    seqs[h]: TRWINDOW-padded sequence or None; spans[h]: (start, end) TR
    span within seqs[h].  Returns (expanded, failed list[bool],
    new_spans).  A haplotype fails when its window would cross the
    sequence breakpoint or grow more than UB beyond the original span.
    """
    nhap = len(seqs)
    cur = list(spans)
    live = [h for h, sp in enumerate(spans) if sp is not None]
    pool = _KmerPool()
    for h in live:
        start, end = cur[h]
        pool.stage(window_kmers(seqs[h], ksize, start,
                                len(seqs[h]) - end))

    LEFT, RIGHT = 0, 1
    expanded = False
    # moved[h, side]: windows newly exposed since the last scan (FS on
    # the first round = fill the whole flank cache)
    moved = np.full((nhap, 2), FS, dtype=int)
    flank = np.full((nhap, 2, FS), INVALID, dtype=np.uint64)
    failed = [False] * nhap
    while True:
        tainted = np.zeros((nhap, 2, FS), dtype=bool)
        for h in live:
            if failed[h]:
                continue
            seq = seqs[h]
            n = len(seq)
            start, end = cur[h]
            if start - FS < 0 or end + FS > n:  # TR near breakpoint
                failed[h] = True
                continue
            d0, d1 = moved[h, LEFT], moved[h, RIGHT]
            if d0:
                # left flank cache holds windows of [start-FS, start),
                # outermost first; slide right, refill the exposed head
                flank[h, LEFT, d0:] = flank[h, LEFT, : FS - d0].copy()
                flank[h, LEFT, :d0] = window_kmers(
                    seq, ksize, start - FS,
                    n - (start - FS) - d0 - ksize + 1)
            if d1:
                # right flank holds windows of [end, end+FS); slide left,
                # refill the exposed tail
                flank[h, RIGHT, : FS - d1] = flank[h, RIGHT, d1:].copy()
                flank[h, RIGHT, FS - d1:] = window_kmers(
                    seq, ksize, end + FS - d1 - ksize + 1, n - end - FS)
            tainted[h] = pool.contains(flank[h])
        if not tainted.any() or all(failed):
            break
        expanded = True
        moved = np.zeros((nhap, 2), dtype=int)
        for h in live:
            if failed[h]:
                continue
            hit_l, hit_r = tainted[h, LEFT], tainted[h, RIGHT]
            if hit_l.any():
                # expand left past the outermost contaminated window
                moved[h, LEFT] = FS - np.nonzero(hit_l)[0][0]
                pool.stage(flank[h, LEFT, FS - moved[h, LEFT]:])
            if hit_r.any():
                moved[h, RIGHT] = np.nonzero(hit_r)[0][-1] + 1
                pool.stage(flank[h, RIGHT, : moved[h, RIGHT]])
            if hit_l.any() or hit_r.any():
                cur[h] = (cur[h][0] - moved[h, LEFT],
                          cur[h][1] + moved[h, RIGHT])
                if (spans[h][0] - cur[h][0] > UB
                        or cur[h][1] - spans[h][1] > UB):
                    failed[h] = True
        if all(failed):
            break
    return expanded, failed, cur


class ExpStat:
    __slots__ = ("exp", "fail", "es", "opos", "npos")

    def __init__(self, exp, fail, es, opos, npos):
        self.exp = exp
        self.fail = fail
        self.es = es
        self.opos = opos
        self.npos = npos


def _load_fasta_indexed(path: str):
    """-> dict contig -> sequence (whole-file load; fine for build step)."""
    seqs = {}
    name, cur = None, []
    with open(path) as f:
        for line in f:
            line = line.rstrip("\n")
            if line.startswith(">"):
                if name is not None:
                    seqs[name] = "".join(cur)
                name = line[1:].split()[0]
                cur = []
            else:
                cur.append(line)
    if name is not None:
        seqs[name] = "".join(cur)
    return seqs


_G = None  # (beds, fastas, panmap, nh, FS, UB, ksize) for forked workers


def _mbe_one(idx: int):
    """Per-locus MBE unit (reads shared state inherited via fork;
    mirrors the reference's pickled-shard Pool workers,
    multiBoundaryExpansion.parallel.py:37-47,300-315)."""
    beds, fastas, panmap, nh, FS, UB, ksize, TRWINDOW = _G
    seqs, poss = [None] * nh, [None] * nh
    for hi in range(nh):
        if beds[hi, idx, 0] is None:
            continue
        ctg = fastas[hi][beds[hi, idx, 0]]
        s, e = int(beds[hi, idx, 1]), int(beds[hi, idx, 2])
        ns = s - TRWINDOW if s > TRWINDOW else 0
        ne = e + TRWINDOW if e + TRWINDOW < len(ctg) else len(ctg)
        seqs[hi] = ctg[ns:ne]
        poss[hi] = (s - ns, e - ns)
    expanded, failed, npos = mbe_locus(seqs, poss, FS, UB, ksize)
    if expanded:
        if not all(failed):
            es = np.average([
                poss[hi][0] - npos[hi][0] + npos[hi][1] - poss[hi][1]
                for hi in range(nh) if npos[hi] is not None])
        else:
            es = -1
    else:
        es = 0
    return idx, ExpStat(expanded, np.nonzero(failed)[0].tolist(),
                        es, poss, npos)


def run_mbe(workdir: str, indir: str, gs: list[str], ksize: int, FS: int,
            TRWINDOW: int, th1: float = 0.1, th2: float = 0.8,
            ignore_case: bool = False, nproc: int = 1):
    """Full MBE flow over the reference's file layout (tmp1 beds +
    pan.tr.mbe.v0.bed); writes v1 bed + locus map + per-hap tmp2 beds."""
    nh = 2 * len(gs)
    v0 = np.loadtxt(os.path.join(workdir, "pan.tr.mbe.v0.bed"),
                    dtype=object, ndmin=2)
    panmap = v0[:, 3:].astype(int)
    nloci = v0.shape[0]

    beds = np.full([nh, nloci, 4], None, dtype=object)
    for gi, g in enumerate(gs):
        for h in (0, 1):
            hi = 2 * gi + h
            m0 = panmap[:, hi] == 1
            bed = np.loadtxt(os.path.join(workdir, g, f"tmp1.{h}.bed"),
                             dtype=object, usecols=[0, 1, 2, 6], ndmin=2,
                             comments=None)
            m1 = bed[:, 0] != "."
            assert m0.sum() == m1.sum()
            beds[hi, m0] = bed[m1]

    fastas = []
    for g in gs:
        for h in (0, 1):
            seqs = _load_fasta_indexed(os.path.join(indir, f"{g}.{h}.fa"))
            if ignore_case:
                seqs = {k: v.upper() for k, v in seqs.items()}
            fastas.append(seqs)

    global _G
    UB = TRWINDOW - FS
    _G = (beds, fastas, panmap, nh, FS, UB, ksize, TRWINDOW)
    live = [idx for idx in range(nloci) if panmap[idx].sum() > 0]
    if nproc > 1:
        # data-parallel over loci.  fork inherits the loaded fastas/beds
        # so (unlike the reference) nothing is re-pickled.
        import multiprocessing as mp

        with mp.get_context("fork").Pool(nproc) as pool:
            idx2exp = dict(pool.map(_mbe_one, live,
                                    chunksize=max(1, len(live) // (4 * nproc))))
    else:
        idx2exp = dict(_mbe_one(idx) for idx in live)
    _G = None

    _write_bed_mbe(workdir, gs, nh, nloci, panmap, idx2exp, th1, th2)
    return idx2exp


def _write_bed_mbe(workdir, gs, nh, nloci, panmap, idx2exp, th1, th2):
    """writeBed_MBE equivalent (byte-compatible numpy savetxt output)."""
    bs = set()
    for idx, st in idx2exp.items():
        if st.exp:
            if len(st.fail) == nh:
                bs.add(idx)
            else:
                nf = len(st.fail) + sum(v is None for v in st.npos)
                if 1 - nf / nh < th1:
                    bs.add(idx)
    ns = nh * th2
    bs |= set(np.nonzero(panmap.sum(axis=1) < ns)[0].tolist())
    vi = sorted(set(range(nloci)) - bs)
    np.savetxt(os.path.join(workdir, "locusMap.v1.to.v0.txt"), vi, fmt="%i")

    panbed = np.full([nloci, 3 + nh * 4], None, dtype=object)
    panbed[:, :3] = np.loadtxt(os.path.join(workdir, "pan.tr.mbe.v0.bed"),
                               usecols=[0, 1, 2], dtype=object)
    for hi in range(nh):
        g = gs[hi // 2]
        h = hi % 2
        bed = np.loadtxt(os.path.join(workdir, g, f"tmp1.{h}.bed"),
                         dtype=object, ndmin=2, comments=None)
        bed = bed[bed[:, 0] != "."]
        p2g = np.full(nloci, None, dtype=object)
        p2g[panmap[:, hi] == 1] = np.arange(bed.shape[0])
        with open(os.path.join(workdir, g, f"tmp2.{h}.mbe.bed"), "w") as f:
            for pid in vi:
                if pid not in idx2exp or idx2exp[pid].opos[hi] is None:
                    continue
                if hi in idx2exp[pid].fail:
                    panbed[pid, 3 + hi * 4 : 7 + hi * 4] = [None] * 4
                    continue
                gid = p2g[pid]
                os_, oe = idx2exp[pid].opos[hi]
                ns_, ne = idx2exp[pid].npos[hi]
                dts = [os_ - ns_, ne - oe]
                s, e = int(bed[gid, 1]), int(bed[gid, 2])
                s -= dts[0]
                e += dts[1]
                f.write(f"{bed[gid, 0]}\t{s}\t{e}\t{bed[gid, 3]}\t"
                        f"{bed[gid, 4]}\t{bed[gid, 5]}\t{bed[gid, 6]}\n")
                panbed[pid, 3 + hi * 4 : 7 + hi * 4] = [
                    bed[gid, 0], s, e, bed[gid, 6]]
    np.savetxt(os.path.join(workdir, "pan.tr.mbe.v1.bed"), panbed[vi],
               delimiter="\t", fmt="%s")
