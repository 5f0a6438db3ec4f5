"""Each kernel's bound and its check against its plain version, defined
once for chip_smoke.py's phases and tools/full_index_probe.py.

A bound is the least time the card could take for the kernel's work: the
bytes it must move on these inputs (each input read once, each output
written once) over the HBM rate.  The kernels below do a few integer
operations a byte, so bytes bound them all.  A table probe moves the
distinct 8-slot rows this data makes it read, at the levels it needs;
the per-kernel formulas take the batch's shape.
"""

from __future__ import annotations

import torch

from ..index import device_table as dt

HBM_BYTES_PER_MS = 3.35e12 / 1e3        # H100 SXM HBM3, published peak


def bound_ms(nbytes) -> float:
    """Milliseconds to move ``nbytes`` at the HBM rate."""
    return nbytes / HBM_BYTES_PER_MS


def max_abs_err(a, b) -> int:
    """Largest |a - b| over matching tensors (tuples, lists or dicts of
    them); a bool pair counts 1 where any element differs.  Raises
    AssertionError on a shape mismatch."""
    if isinstance(a, dict):
        return max(max_abs_err(a[k], b[k]) for k in a)
    if isinstance(a, (tuple, list)):
        return max(max_abs_err(x, y) for x, y in zip(a, b))
    if a.shape != b.shape:
        raise AssertionError(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    if a.numel() == 0:
        return 0
    if a.dtype == torch.bool:
        return int((a != b).any())
    return int((a.long() - b.long()).abs().max())


def row_bytes(tab) -> int:
    """One bucket row: 8 slots of W 4-byte planes."""
    return 8 * tab.W * 4


def probe_bytes(tab, q, loc=None, stop: bool = False) -> tuple:
    """KB: each distinct row this data reads (its level-0 row for every
    query, its level-l row for a query that missed levels < l) read once;
    8 B a query (16 with a locus) in and 17 B out.  With ``stop`` (KG's,
    KE's and KJ's probe) a query reads level l only after a miss on a
    full row at every level < l: a level passes on only a full bucket's
    overflow.  Returns (bytes, distinct rows, row reads)."""
    qf = q.reshape(-1)
    lf = None if loc is None else loc.reshape(-1).long() & 0xFFFFFFFF
    lo, hi = qf & 0xFFFFFFFF, (qf >> 32) & 0xFFFFFFFF
    rows = reads = 0
    need = torch.ones(qf.numel(), dtype=torch.bool, device=q.device)
    for t, salt in zip(tab.levels, tab.salts):
        b = dt.bucket_index(lo[need], hi[need],
                            None if lf is None else lf[need], salt,
                            t.shape[0])
        rows += int(torch.unique(b).numel())
        reads += int(need.sum())
        sub = dt.DevTable([t], [salt], tab.composite, tab.nval)
        hit = dt.lookup_bucket_plain(sub, qf, lf)[0]
        if stop:
            full = torch.zeros_like(need)
            r = t[b].view(-1, 8, tab.W)
            full[need] = ((r[..., 0] & r[..., 1]) != -1).all(-1)
            need &= ~hit & full
        else:
            need &= ~hit
    return (rows * row_bytes(tab)
            + q.numel() * (8 + 8 * (loc is not None) + 17)), rows, reads


def _owned_rows(blk, meta, qf, lf) -> int:
    """Distinct rows of one row block that queries ``qf`` probe up to
    their first hit in the block."""
    lo, hi = qf & 0xFFFFFFFF, (qf >> 32) & 0xFFFFFFFF
    rows = 0
    done = torch.zeros(qf.shape, dtype=torch.bool, device=qf.device)
    for t, m in zip(blk.levels, meta):
        salt, nb, off, nrow = m
        b = dt.bucket_index(lo, hi, lf, salt, nb)
        probe = (b >= off) & (b < off + nrow) & ~done
        rows += int(torch.unique(b[probe]).numel())
        one = dt.DevTable([t], [salt], blk.composite, blk.nval)
        done |= dt.lookup_bucket_owned_plain(one, [m], qf, lf)[0] != 0
    return rows


def owned_bytes(blk, meta, q, loc=None) -> tuple:
    """KI, one rank's row block: each gathered query (and locus) read
    once, each distinct owned row that a query probes up to its first
    owned hit read once, three int32 planes written.  Returns (bytes,
    rows)."""
    qf = q.reshape(-1)
    lf = None if loc is None else loc.reshape(-1).long() & 0xFFFFFFFF
    rows = _owned_rows(blk, meta, qf, lf)
    return (rows * row_bytes(blk)
            + qf.numel() * (8 + 8 * (loc is not None) + 12)), rows


def owned_count_bytes(blk, meta, q) -> tuple:
    """KI[count], one row block, ``q`` (reads, nf): each query read once,
    each distinct owned row a non-EMPTY query probes up to its first hit
    read once, 4 B a read written.  Returns (bytes, rows)."""
    qf = q.reshape(-1)
    rows = _owned_rows(blk, meta, qf[qf != -1], None)
    return 8 * q.numel() + 4 * q.shape[0] + rows * row_bytes(blk), rows


def ka_bytes(B: int, L: int, k: int, all_planes: bool = False) -> int:
    """KA over B reads of L bases: codes and rlen in; the counting
    instance writes kmer (8 B) and kvalid (1 B) a window, nk and
    any_valid a read; the all-planes instance adds nc (8 B) and the
    edges (9 B a window pair)."""
    NKW = L - k + 1
    if all_planes:
        return B * L + 4 * B + B * NKW * 17 + B * (NKW - 1) * 9 + 5 * B
    return B * L + 4 * B + B * NKW * 9 + 5 * B


def kk_sample_bytes(R: int, L: int, nf: int) -> int:
    """KK[sample] over R reads: codes and rlen in, nf queries (8 B) and
    their valid flags a read, and nk, out."""
    return R * L + 4 * R + R * nf * 9 + 4 * R


def kl_bytes(P: int, NKW: int) -> int:
    """KL over P pairs: a 4-byte found/val plane a window of both mates
    in, 22 B of pair planes."""
    return 4 * 2 * P * NKW + 22 * P


def kc_bytes(P: int, NKW: int) -> int:
    """KC over P pairs: kmer, val and use (17 B) a window of both mates
    in, 11 B a pair (the k-filter flag in, the vote out)."""
    return 2 * P * NKW * 17 + 11 * P


def km_bytes(P: int) -> int:
    """KM, the step tail as a pass of its own over P pairs: its pair
    planes in and out, 57 B a pair, and the nine 8-byte counters read
    and written."""
    return 57 * P + 144


def kd_bytes(P: int, NKW: int, n_slots: int) -> int:
    """KD with KM's tail over P pairs: 27 B a window and 44 B a read of
    planes, 9 B a pair, each distinct count slot this data touches read
    and written (8 B); the tail's bytes beyond KD's own: 7 B of u8
    planes and 8 B of bf in, 8 B of hf, 1 of counted and 8 of dest out
    a pair, the nine counters' 72 B read and written."""
    B = 2 * P
    return B * NKW * 27 + B * (9 * 4 + 8) + P * 9 + n_slots * 8 + 32 * P \
        + 144


def kl_decide_bytes(P: int) -> int:
    """KL[decide] over P pairs: hits and nk (int32) a read, live in and
    survive out: 18 B a pair."""
    return 18 * P


def touched_slots(counts) -> int:
    """Distinct count slots a run wrote (the trash slot aside)."""
    return int((counts[:-1] != 0).sum())
