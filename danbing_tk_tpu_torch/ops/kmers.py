"""Device k-mer extraction over padded read batches (kernel KA).

Counterpart of danbing_tk_tpu/ops/kmers_jax.py.  Input: codes (B, L)
uint8 2-bit base codes (255 = N / pad) and rlen (B,) int32.  K-mers are
int64 (canonical k <= 31, so at most 62 bits); EMPTY is -1, the
reference's -1ULL.  A (k+1)-mer edge of k = 31 uses all 64 bits, so edges
compare as unsigned.

``extract_kmers`` launches the CUDA kernel ``csrc/kmers.cu`` for a CUDA
tensor and runs ``extract_kmers_plain`` for a CPU tensor;
``prefilter_sample`` (KK's sample-only instance, counted as "KK[sample]",
``csrc/prefilter_sample.cu``) and ``prefilter_sample_plain`` likewise give
the sampled-k-mer prefilter's queries, for a probe that runs apart (the
sharded prefilter's collective probe); KK's fused launch, which also
probes and decides, is engine/device_align.py's
prefilter_fused_launcher.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels.build import (bind, check, kernel_lib, launched, ptr,
                             stream_of)

EMPTY = -1
_SIGN = -(1 << 63)


def pack_reads(seqs: list, L: int):
    """Host helper: ASCII reads -> (codes (B,L) u8, rlen (B,) i32)."""
    from .kmers_np import encode_bases

    B = len(seqs)
    codes = np.full((B, L), 255, dtype=np.uint8)
    rlen = np.zeros(B, dtype=np.int32)
    for i, s in enumerate(seqs):
        cs = encode_bases(s)[:L]
        codes[i, : len(cs)] = cs
        rlen[i] = len(cs)
    return codes, rlen


def _planes(out: dict, nc: bool, edges: bool) -> dict:
    """The planes a caller asked for: kmer, kvalid, nk and any_valid,
    with ``nc`` the forward k-mers and with ``edges`` edge and evalid."""
    drop = ({"nc"} if not nc else set()) | \
        ({"edge", "evalid"} if not edges else set())
    return {key: v for key, v in out.items() if key not in drop}


def extract_kmers_plain(codes: torch.Tensor, rlen: torch.Tensor, k: int,
                        nc: bool = True, edges: bool = True):
    """Plain torch version of KA (same outputs as ``extract_kmers`` for
    the same flags; it computes every plane and returns those asked
    for)."""
    B, L = codes.shape
    n, ne = L - k + 1, L - k
    valid = codes != 255
    c = torch.where(valid, codes, 0).long()
    rl = rlen.long()[:, None]
    cbad = torch.nn.functional.pad((~valid).int().cumsum(1), (1, 0))
    pos = torch.arange(n, device=codes.device)
    wvalid = ((cbad[:, k:] - cbad[:, :-k]) == 0) & (pos + k <= rl)
    fwd = torch.zeros((B, n), dtype=torch.int64, device=codes.device)
    rc = torch.zeros_like(fwd)
    for j in range(k):
        b = c[:, j:j + n]
        fwd |= b << (2 * (k - 1 - j))
        rc |= (3 - b) << (2 * j)
    kmer = torch.where(wvalid, torch.minimum(fwd, rc), EMPTY)
    fc = torch.where(wvalid, fwd, EMPTY)
    b_next = c[:, k:k + ne]
    ef = (fwd[:, :ne] << 2) | b_next
    er = rc[:, :ne] | ((3 - b_next) << (2 * k))
    e = torch.where((er ^ _SIGN) < (ef ^ _SIGN), er, ef)
    pos_e = torch.arange(ne, device=codes.device)
    evalid = ((cbad[:, k + 1:] - cbad[:, :-(k + 1)]) == 0) \
        & (pos_e + k + 1 <= rl)
    return _planes(dict(
        kmer=kmer, kvalid=wvalid, nc=fc,
        edge=torch.where(evalid, e, EMPTY), evalid=evalid,
        nk=torch.clamp(rlen.int() - (k - 1), min=0),
        any_valid=wvalid.any(dim=1),
    ), nc, edges)


KA_WARPS = 8          # reads a block (csrc/kmers.cu KA_WARPS)


def kmers_launch(B: int, L: int) -> tuple:
    """KA's launch for B reads of L codes (csrc/kmers.cu): (blocks,
    threads, dynamic shared bytes), one warp a read.  Each warp packs its
    read into 2-bit forward and reverse-complement words and an N bitmask
    over Lp = L rounded up to 32, with a spare word each (csrc/kmers.cu
    ka_words)."""
    n16 = -(-L // 32) * 2
    return -(-B // KA_WARPS), 32 * KA_WARPS, \
        KA_WARPS * 4 * (2 * (n16 + 2) + n16 // 2 + 1)


def extract_kmers(codes: torch.Tensor, rlen: torch.Tensor, k: int,
                  nc: bool = True, edges: bool = True):
    """Canonical k-mers + (k+1)-mer edges for a read batch.

    Returns a dict of
      kmer   (B, L-k+1) int64  canonical k-mer, EMPTY where invalid
      kvalid (B, L-k+1) bool
      nk     (B,)       int32  number of k-mer positions (rlen-k+1, >= 0)
      any_valid (B,)    bool   read has >= 1 valid k-mer
    and, with ``nc``,
      nc     (B, L-k+1) int64  forward (non-canonical) k-mer, EMPTY-masked
    and, with ``edges``,
      edge   (B, L-k)   int64  canonical (k+1)-mer edge, EMPTY-masked
      evalid (B, L-k)   bool
    The kernel writes only the planes asked for (one template instance
    per plane set): the counting step needs neither nc nor the edges.
    """
    if codes.device.type == "cpu":
        return extract_kmers_plain(codes, rlen, k, nc, edges)
    if codes.dtype != torch.uint8 or codes.dim() != 2:
        raise ValueError("codes must be a (B, L) uint8 tensor")
    if not 1 <= k <= 31 or codes.shape[1] < k:
        raise ValueError(f"unsupported k={k} for L={codes.shape[1]}")
    codes = codes.contiguous()
    rlen = rlen.to(torch.int32).contiguous()
    B, L = codes.shape
    n, ne = L - k + 1, L - k
    dev = codes.device
    out = dict(kmer=torch.empty((B, n), dtype=torch.int64, device=dev),
               kvalid=torch.empty((B, n), dtype=torch.bool, device=dev),
               nk=torch.empty(B, dtype=torch.int32, device=dev),
               any_valid=torch.empty(B, dtype=torch.bool, device=dev))
    if nc:
        out["nc"] = torch.empty((B, n), dtype=torch.int64, device=dev)
    if edges:
        out["edge"] = torch.empty((B, ne), dtype=torch.int64, device=dev)
        out["evalid"] = torch.empty((B, ne), dtype=torch.bool, device=dev)
    fn = bind(kernel_lib("kmers"), "dtk_extract_kmers", "ppiiippppppp")
    opt = [ptr(out[key]) if key in out else None
           for key in ("nc", "edge", "evalid")]
    check(fn(ptr(codes), ptr(rlen), B, L, k, ptr(out["kmer"]), opt[0],
             ptr(out["kvalid"]), opt[1], opt[2], ptr(out["nk"]),
             ptr(out["any_valid"]), stream_of(codes)), "extract_kmers")
    launched("KA")
    return out


def prefilter_sample_plain(codes: torch.Tensor, rlen: torch.Tensor, k: int,
                           nf: int):
    """Plain torch version of KK: the arithmetic of
    kmers_np.sample_subfilter_queries in int64 (same outputs as
    ``prefilter_sample``)."""
    if nf < 1:
        raise ValueError(f"the prefilter samples nf >= 1 k-mers, not {nf}")
    B, L = codes.shape
    dev = codes.device
    rl = rlen.long()
    nk = torch.clamp(rl - (k - 1), min=0)
    j = torch.arange(nf, device=dev)
    # with nf = 1 the one start is nk - 1: the step S is never used
    S = nk // max(nf - 1, 1)
    starts = torch.where(j == nf - 1, (nk - 1)[:, None], j * S[:, None])
    starts = starts.clamp(0, L - k)
    win = codes.long().gather(
        1, (starts[..., None] + torch.arange(k, device=dev)).view(B, -1)
    ).view(B, nf, k)
    ok = (win <= 3).all(-1) & (starts + k <= rl[:, None]) \
        & (starts < nk[:, None])
    c = win & 3
    fwd = torch.zeros((B, nf), dtype=torch.int64, device=dev)
    rc = torch.zeros_like(fwd)
    for i in range(k):
        fwd |= c[..., i] << (2 * (k - 1 - i))
        rc |= (3 - c[..., i]) << (2 * i)
    q = torch.where(ok, torch.minimum(fwd, rc), EMPTY)
    return q, ok, nk.int()


def prefilter_sample(codes: torch.Tensor, rlen: torch.Tensor, k: int,
                     nf: int):
    """The sampled-k-mer prefilter's queries of a read batch (the JAX
    prefilter_sample, reference subfilter): the nf evenly spaced windows
    of each read, starts j * (nk // (nf - 1)) for j < nf - 1 and nk - 1,
    clipped to [0, L - k].  Returns
      q     (B, nf) int64  canonical k-mer, EMPTY where not valid
      valid (B, nf) bool   window of codes 0-3 inside the read, start < nk
      nk    (B,)    int32  number of k-mer positions (rlen-k+1, >= 0)
    The decision reads ``nk > 0`` (kmers_np's nonshort).  KK's
    sample-only instance ("KK[sample]")."""
    if codes.device.type == "cpu":
        return prefilter_sample_plain(codes, rlen, k, nf)
    if codes.dtype != torch.uint8 or codes.dim() != 2:
        raise ValueError("codes must be a (B, L) uint8 tensor")
    if not 1 <= k <= 31 or codes.shape[1] < k or nf < 1:
        raise ValueError(f"unsupported k={k}, nf={nf} for "
                         f"L={codes.shape[1]}")
    codes = codes.contiguous()
    rlen = rlen.to(torch.int32).contiguous()
    B, L = codes.shape
    dev = codes.device
    q = torch.empty((B, nf), dtype=torch.int64, device=dev)
    valid = torch.empty((B, nf), dtype=torch.bool, device=dev)
    nk = torch.empty(B, dtype=torch.int32, device=dev)
    fn = bind(kernel_lib("prefilter_sample"), "dtk_prefilter_sample",
              "ppiiiipppp")
    check(fn(ptr(codes), ptr(rlen), B, L, k, nf, ptr(q), ptr(valid),
             ptr(nk), stream_of(codes)), "prefilter_sample")
    launched("KK[sample]")
    return q, valid, nk
