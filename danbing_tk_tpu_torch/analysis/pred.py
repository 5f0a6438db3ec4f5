"""Bias correction (`danbing-tk-pred` equivalent, reference src/pred.cpp +
pred.h): the port of danbing_tk_tpu/analysis/pred.py.

Pipeline (pred.h:166-233):
  1. read each sample's .trkmc.ar (u64 counts), cast f32, divide by the
     sample's read depth: one (ns, nk) f32 host buffer filled row by row
     (``load_gt_normalized``)
  2. per locus: B = GT[:, ikmer_idx] / ikmer_count; bias = rowmean(B);
     bias /= mean(bias); GT[:, locus_block] /= bias[:, None];
     Bias[:, tri] = bias -- on the card in KH (csrc/bias_correct.cu),
     on the CPU in its plain torch version, in place either way
  3. write raw GT, corrected GT (u32 dims + column-major f32 data, in
     column blocks) and the bias matrix (TSV)

The three output files are byte-identical to the JAX package's default
(numpy) path.  That holds because both KH and the plain version add in
numpy's order -- each (sample, locus) sum runs over the locus's invariant
k-mers in file order, the mean over samples in sample order -- divide
with IEEE division (never by a reciprocal), and write every NaN they make
with the host's NaN bits (``HOST_NAN_BITS``: x86's 0/0 is 0xFFC00000, a
CUDA 0/0 is 0x7FFFFFFF).  A locus whose invariant k-mers reach outside its
own column block would make numpy's in-place loop read corrected values of
an earlier locus; ``bias_correction`` refuses such arrays.

Deviation, as in the JAX package: the reference leaves Bias columns of
skipped loci (no k-mers, no invariant k-mers, or no invariant coverage in
any sample) uninitialised (pred.h:218); these are 0 here.
"""

from __future__ import annotations

import ctypes
import sys
import time

import numpy as np
import torch

from ..io import binary as bio

_libc = ctypes.CDLL(None)
_libc.strtof.restype = ctypes.c_float
_libc.strtof.argtypes = [ctypes.c_char_p, ctypes.c_void_p]

with np.errstate(invalid="ignore"):
    HOST_NAN_BITS = int((np.zeros(1, np.float32) / np.zeros(1, np.float32))
                        .view(np.uint32)[0])
LOAD_CHUNK = 1 << 24            # counts per read in load_gt_normalized
PLAIN_CHUNK = 1 << 27           # elements per chunk of the plain division


def _parse_f32(s: str) -> np.float32:
    """Decimal -> f32 in ONE rounding via libc strtof, matching the
    reference's stof (pred.h:46).  np.float32(s) would round via f64
    first and can land 1 ulp off at half-ulp boundaries."""
    return np.float32(_libc.strtof(s.encode(), None))


def _fmt_f32(x: np.float32) -> str:
    """Eigen StreamPrecision float formatting (~std::ostream << float)."""
    return f"{float(x):g}"


def read_gt_meta(path: str):
    """-> (per-sample .trkmc.ar paths, read depths as f32)."""
    fns, rds = [], []
    with open(path) as f:
        for line in f:
            a, b = line.rstrip("\n").split("\t")
            fns.append(a)
            rds.append(_parse_f32(b))
    return fns, rds


def load_gt_normalized(paths, rds, nk: int, out=None) -> np.ndarray:
    """(ns, nk) f32, row s = read_karray(paths[s]).astype(f32) / rds[s],
    bit-equal to the JAX package's norm_read_depth(load_gt(...)) without
    its (nk, ns) u64 stack and transposed copies.  Fills ``out`` (an
    (ns, nk) f32 array, e.g. a view of a pinned tensor) when given; reads
    LOAD_CHUNK counts at a time."""
    ns = len(paths)
    if out is None:
        out = np.empty((ns, nk), dtype=np.float32)
    if out.shape != (ns, nk) or out.dtype != np.float32:
        raise ValueError(f"load_gt_normalized: out must be ({ns}, {nk}) "
                         f"float32")
    for s, (p, rd) in enumerate(zip(paths, rds)):
        rd = np.float32(rd)
        with open(p, "rb") as f:
            n = int(bio._r(f, np.uint64, 1)[0])
            if n != nk:
                raise ValueError(f"{p}: nk {n} != {nk}")
            for c0 in range(0, nk, LOAD_CHUNK):
                c1 = min(nk, c0 + LOAD_CHUNK)
                v = bio._r(f, np.uint64, c1 - c0).astype(np.float32)
                np.divide(v, rd, out=out[s, c0:c1])
    return out


def bias_correction_np(gt: np.ndarray, nk_cum, nik_cum, iki, ikc):
    """Reference bias_correction in numpy f32.  Mutates gt, returns Bias
    (ns, n_tr) with zeros for skipped loci.  The host oracle of the
    tests and chip_smoke.py; the port's own path is bias_correction."""
    ns = gt.shape[0]
    n_tr = len(nk_cum)
    bias_mat = np.zeros((ns, n_tr), dtype=np.float32)
    for tri in range(n_tr):
        si = nk_cum[tri - 1] if tri else 0
        ei = nk_cum[tri]
        isi = nik_cum[tri - 1] if tri else 0
        iei = nik_cum[tri]
        if si == ei or isi == iei:
            continue
        ikis = iki[isi:iei]
        ikmc = ikc[isi:iei].astype(np.float32)
        B = gt[:, ikis] / ikmc[None, :]
        # strictly SEQUENTIAL f32 sums (cumsum), matching naive C++
        # accumulation (the executed-reference oracle's eigen_lite shim);
        # np.mean's pairwise blocking differs in the last ulp
        bias = np.cumsum(B, axis=1, dtype=np.float32)[:, -1] \
            / np.float32(B.shape[1])
        m = np.cumsum(bias, dtype=np.float32)[-1] / np.float32(len(bias))
        if m == 0.0:
            # no sample has any invariant-kmer coverage at this locus:
            # the reference (pred.cpp, Eigen) would divide by zero and
            # poison the locus with NaN/inf; we pin the semantics to
            # "skip" (counts untouched, bias row stays 0) instead.
            continue
        bias = bias / m
        with np.errstate(divide="ignore", invalid="ignore"):
            # a single zero-bias sample still yields inf for that
            # sample's columns, matching the reference's arithmetic
            gt[:, si:ei] = gt[:, si:ei] / bias[:, None]
        bias_mat[:, tri] = bias
    return bias_mat


def index_tensors(nk_cum, nik_cum, iki, ikc, device):
    """The ikmer.meta arrays as tensors on ``device``, in the file's widths:
    nk_cum, nik_cum and iki as int32 tensors holding their u32 bits, ikc
    as uint8.  Tensors already so are passed through."""
    def conv(x, dtype):
        if isinstance(x, torch.Tensor):
            return x.to(device=device, dtype=dtype).contiguous()
        x = np.ascontiguousarray(x)
        x = x.astype(np.uint32).view(np.int32) if dtype == torch.int32 \
            else x.astype(np.uint8)
        return torch.from_numpy(x).to(device)
    return (conv(nk_cum, torch.int32), conv(nik_cum, torch.int32),
            conv(iki, torch.int32), conv(ikc, torch.uint8))


def _i64(x: torch.Tensor) -> torch.Tensor:
    """The u32 values an index_tensors int32 tensor holds, as int64."""
    return x.to(torch.int64) & 0xFFFFFFFF


def _host_nan(device) -> torch.Tensor:
    return torch.from_numpy(np.array([HOST_NAN_BITS], np.uint32).view(
        np.float32)).to(device)


def bias_correction_plain(gt: torch.Tensor, nk_cum, nik_cum, iki,
                          ikc) -> torch.Tensor:
    """Plain torch version of KH (the CPU path, and KH's yardstick on the
    card).  Corrects the (ns, nk) f32 ``gt`` in place and returns the
    (ns, n_tr) bias, 0 for skipped loci.

    Sums run in numpy's order: a loop over the j-th invariant k-mer of
    every locus at once, then a loop over samples; every divisor is a
    tensor on gt's device (torch divides a CUDA tensor by a host scalar
    through its reciprocal).  NaNs are written with the host's bits.  The
    division plane is built PLAIN_CHUNK elements at a time."""
    ns, nk = gt.shape
    dev = gt.device
    nk_cum, nik_cum, iki, ikc = index_tensors(nk_cum, nik_cum, iki, ikc,
                                               dev)
    nk_cum, nik_cum, iki = _i64(nk_cum), _i64(nik_cum), _i64(iki)
    n_tr = nk_cum.numel()
    zero = torch.zeros(1, dtype=torch.int64, device=dev)
    nk0 = torch.cat([zero, nk_cum[:-1]])
    nik0 = torch.cat([zero, nik_cum[:-1]])
    nik = nik_cum - nik0
    has = (nk_cum > nk0) & (nik > 0)
    nan = _host_nan(dev)

    def canon(x):
        return torch.where(torch.isnan(x), nan, x)

    ikc_f = ikc.to(torch.float32)
    acc = torch.zeros((ns, n_tr), dtype=torch.float32, device=dev)
    for j in range(int(nik.max()) if n_tr else 0):
        sel = torch.nonzero(nik > j).squeeze(1)
        idx = nik0[sel] + j
        term = gt[:, iki[idx]] / ikc_f[idx][None, :]
        acc[:, sel] = term if j == 0 else acc[:, sel] + term
    raw = acc / nik.clamp(min=1).to(torch.float32)[None, :]
    m = raw[0].clone() if ns else torch.zeros(n_tr, device=dev)
    for s in range(1, ns):
        m = m + raw[s]
    m = m / torch.full_like(m, ns)
    active = has & (m != 0)
    bias = torch.where(active[None, :],
                       canon(raw / torch.where(active, m, 1.0)[None, :]),
                       torch.zeros((), device=dev))
    chunk = max(1, PLAIN_CHUNK // max(ns, 1))
    for c0 in range(0, nk, chunk):
        c1 = min(nk, c0 + chunk)
        loc = torch.searchsorted(nk_cum, torch.arange(c0, c1, device=dev),
                                 right=True)
        act = active[loc]
        if not bool(act.any()):
            continue
        blk = gt[:, c0:c1]
        blk.copy_(torch.where(act[None, :], canon(blk / bias[:, loc]), blk))
    return bias


def check_index(nk, nk_cum, nik_cum, iki, ikc) -> None:
    """Raises ValueError unless the ikmer.meta tensors describe nk columns:
    cumulative counts that do not decrease and end at nk and at len(iki),
    and each locus's invariant k-mers inside its own column block.  KH
    indexes with them unchecked, and only then do numpy's in-place locus
    loop and a correction of all loci at once agree."""
    nk_cum, nik_cum, iki = _i64(nk_cum), _i64(nik_cum), _i64(iki)
    n_tr = nk_cum.numel()
    ok = nik_cum.numel() == n_tr and ikc.numel() == iki.numel() and (
        n_tr == 0 or (int(nk_cum[-1]) == nk and int(nik_cum[-1])
                      == iki.numel()))
    if ok and n_tr:
        zero = torch.zeros(1, dtype=torch.int64, device=nk_cum.device)
        nk0 = torch.cat([zero, nk_cum[:-1]])
        nik = nik_cum - torch.cat([zero, nik_cum[:-1]])
        ok = bool((nk_cum >= nk0).all() & (nik >= 0).all())
        if ok and iki.numel():
            loc = torch.repeat_interleave(
                torch.arange(n_tr, device=nk_cum.device), nik)
            ok = bool(((iki >= nk0[loc]) & (iki < nk_cum[loc])).all())
    if not ok:
        raise ValueError(f"ikmer.meta arrays do not describe {nk} columns "
                         "with each locus's invariant k-mers in its own "
                         "block")


def bias_correction(gt: torch.Tensor, nk_cum, nik_cum, iki,
                    ikc) -> torch.Tensor:
    """K16 on the port: corrects the (ns, nk) f32 ``gt`` in place and
    returns the (ns, n_tr) f32 bias (0 for skipped loci).  A CUDA tensor
    goes through KH (csrc/bias_correct.cu); a CPU tensor through
    bias_correction_plain.  The ikmer.meta arrays may be numpy arrays or
    tensors; pass index_tensors' on gt's device to skip the conversion.  Raises ValueError for arrays check_index refuses."""
    idx = index_tensors(nk_cum, nik_cum, iki, ikc, gt.device)
    check_index(gt.shape[1], *idx)
    if gt.device.type == "cpu":
        return bias_correction_plain(gt, *idx)
    if gt.device.type != "cuda":
        raise ValueError(f"bias_correction: unsupported device {gt.device}")
    if gt.dtype != torch.float32 or gt.dim() != 2 or \
            not gt.is_contiguous():
        raise ValueError("bias_correction: gt must be a contiguous (ns, nk) "
                         "float32 tensor")
    from ..kernels.build import (bind, check, kernel_lib, launched, ptr,
                             stream_of)

    ns, nk = gt.shape
    nk_cum, nik_cum, iki, ikc = idx
    n_tr = nk_cum.numel()
    bias = torch.empty((ns, n_tr), dtype=torch.float32, device=gt.device)
    active = torch.empty(n_tr, dtype=torch.uint8, device=gt.device)
    fn = bind(kernel_lib("bias_correct"), "dtk_bias_correct",
              "iii" + "p" * 7 + "ip")
    check(fn(ns, nk, n_tr, ptr(gt), ptr(nk_cum), ptr(nik_cum), ptr(iki),
             ptr(ikc), ptr(bias), ptr(active), HOST_NAN_BITS,
             stream_of(gt)), "bias_correct")
    launched("KH")
    return bias


def write_bias(path: str, bias: np.ndarray) -> None:
    """The (ns, n_tr) bias matrix as TSV, one sample per line."""
    with open(path, "w") as f:
        for row in bias:
            f.write("\t".join(_fmt_f32(x) for x in row) + "\n")


def run_pred(gt_meta_path: str, ikmer_meta_path: str, out_raw: str,
             out_corrected: str, out_bias: str, device=None) -> dict:
    """Full danbing-tk-pred flow (pred.cpp:15-83) on ``device`` (cuda
    unless the caller asks for the CPU).  Returns the seconds of each
    span: load (read + normalise into the host buffer), raw (write), h2d,
    kernel (KH, or the plain version on the CPU), d2h, corrected (write),
    bias (TSV), wall."""
    from .._device import resolve_device

    dev = resolve_device(device)
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    spans = {}
    t_start = t0 = time.perf_counter()

    def span(name):
        nonlocal t0
        sync()
        t1 = time.perf_counter()
        spans[name] = t1 - t0
        t0 = t1

    fns, rds = read_gt_meta(gt_meta_path)
    nk_cum, nik_cum, iki, ikc = bio.read_ikmer_meta(ikmer_meta_path)
    idx = index_tensors(nk_cum, nik_cum, iki, ikc, dev)
    nk = int(nk_cum[-1])
    host = torch.empty((len(fns), nk), dtype=torch.float32, pin_memory=cuda)
    gt = load_gt_normalized(fns, rds, nk, out=host.numpy())
    span("load")
    bio.write_gt_matrix(out_raw, gt)
    span("raw")
    g = host.to(dev) if cuda else host
    span("h2d")
    bias = bias_correction(g, *idx)
    span("kernel")
    if cuda:
        host.copy_(g)
        del g
    bias = bias.cpu().numpy()
    span("d2h")
    bio.write_gt_matrix(out_corrected, gt)
    span("corrected")
    write_bias(out_bias, bias)
    span("bias")
    spans["wall"] = time.perf_counter() - t_start
    print("pred spans (s): " + " ".join(f"{k}={v:.3f}"
                                        for k, v in spans.items()),
          file=sys.stderr)
    return spans
