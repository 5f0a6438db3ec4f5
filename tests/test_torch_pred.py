"""The port's pred (bias correction) on the CPU against the JAX package:
bit-equal to the numpy path (``bias_correction_np``, the JAX CLI's
default) and within rtol 1e-5 of ``bias_correction_jax`` (the tolerance
of tests/test_pred.py), on the hand-checked toy, the zero-mean case and
fuzz cohorts with skipped loci, wide loci and zero-bias samples (inf and
NaN columns, compared as u32 views); the row-by-row loader, the
block-wise GT writer and ``python -m danbing_tk_tpu_torch pred
--torch-device cpu`` byte for byte against the JAX package."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from danbing_tk_tpu.analysis import pred as jpred
from danbing_tk_tpu.apps import cli as jcli
from danbing_tk_tpu.io import binary as jbio
from danbing_tk_tpu_torch.analysis import pred
from danbing_tk_tpu_torch.apps import cli
from danbing_tk_tpu_torch.io import binary as bio
from danbing_tk_tpu_torch.kernels import build
from danbing_tk_tpu_torch.tools import scale_pred

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "golden")
OUTS = ("raw.gt", "corr.gt", "bias.tsv")


def u32(a):
    return np.ascontiguousarray(a, dtype=np.float32).view(np.uint32)


def _toy():
    # tests/test_pred.py's toy: 3 loci with [3, 2, 4] k-mers; locus 1 has
    # no invariant k-mers
    nk_cum = np.array([3, 5, 9], dtype=np.uint32)
    nik_cum = np.array([2, 2, 3], dtype=np.uint32)
    iki = np.array([0, 2, 5], dtype=np.uint32)
    ikc = np.array([2, 1, 3], dtype=np.uint8)
    gt = np.arange(2 * 9, dtype=np.float32).reshape(2, 9) + 1.0
    return gt, nk_cum, nik_cum, iki, ikc


def _check(gt, nk_cum, nik_cum, iki, ikc):
    """The port's bias_correction on a CPU tensor against the JAX numpy
    path (bit-equal) and the JAX device path (rtol 1e-5)."""
    want = gt.copy()
    with np.errstate(divide="ignore", invalid="ignore"):
        want_bias = jpred.bias_correction_np(want, nk_cum, nik_cum, iki, ikc)
    got = torch.from_numpy(gt.copy())
    n0 = build.launch_counts()["KH"]
    got_bias = pred.bias_correction(got, nk_cum, nik_cum, iki, ikc)
    assert build.launch_counts()["KH"] == n0        # CPU: plain version
    assert np.array_equal(u32(got.numpy()), u32(want))
    assert np.array_equal(u32(got_bias.numpy()), u32(want_bias))
    corr_jax, bias_jax = jpred.bias_correction_jax(gt.copy(), nk_cum,
                                                   nik_cum, iki, ikc)
    np.testing.assert_allclose(got.numpy(), np.asarray(corr_jax), rtol=1e-5)
    np.testing.assert_allclose(got_bias.numpy(), np.asarray(bias_jax),
                               rtol=1e-5)
    return got.numpy(), got_bias.numpy()


def test_toy_hand_checked():
    gt, *meta = _toy()
    corr, bias = _check(gt, *meta)
    b0 = np.array([1.75, 8.5], dtype=np.float32)
    np.testing.assert_allclose(bias[:, 0], b0 / b0.mean(), rtol=1e-6)
    assert (bias[:, 1] == 0).all()
    np.testing.assert_array_equal(corr[:, 3:5], gt[:, 3:5])


def test_zero_mean_locus_skipped():
    gt, *meta = _toy()
    gt[:, [0, 2]] = 0.0          # locus 0's invariant k-mers: 0 everywhere
    corr, bias = _check(gt, *meta)
    assert (bias[:, 0] == 0).all()
    np.testing.assert_array_equal(corr[:, :3], gt[:, :3])
    assert np.isfinite(corr).all()


def _fuzz(seed, ns, n_tr, wide=False, zero_bias=False):
    """A cohort with loci without k-mers, loci without invariant k-mers,
    a zero-mean locus, invariant k-mers in random order (more than a warp
    of them with ``wide``) and, with ``zero_bias``, (locus, sample) pairs
    with no invariant coverage at active loci."""
    rng = np.random.default_rng(seed)
    nk_per = rng.integers(0, 60, n_tr)
    nk_per[rng.random(n_tr) < 0.15] = 0
    nk_cum = np.cumsum(nk_per).astype(np.uint32)
    iki, ikc, nik_cum = [], [], []
    for t in range(n_tr):
        si = int(nk_cum[t] - nk_per[t])
        top = int(nk_per[t]) if wide else min(int(nk_per[t]), 8)
        n = 0 if rng.random() < 0.15 else int(rng.integers(0, top + 1))
        iki.extend(si + rng.permutation(int(nk_per[t]))[:n])
        ikc.extend(rng.integers(1, 5, n))
        nik_cum.append(len(iki))
    iki = np.array(iki, np.uint32)
    ikc = np.array(ikc, np.uint8)
    nik_cum = np.array(nik_cum, np.uint32)
    rd = np.float32(rng.uniform(25, 35, ns))
    gt = (rng.poisson(26 * rng.integers(1, 5, (ns, 1)),
                      (ns, int(nk_cum[-1]))) / rd[:, None]).astype(np.float32)
    gt[rng.random(gt.shape) < 0.05] = 0.0
    nik = np.diff(nik_cum.astype(np.int64), prepend=0)
    live = np.nonzero((nik > 0) & (nk_per > 0))[0]
    if len(live):
        t = live[0]                         # a zero-mean locus
        gt[:, iki[nik_cum[t] - nik[t]: nik_cum[t]]] = 0.0
    if zero_bias:
        for t in live[1::3]:
            s = rng.integers(0, ns)
            gt[s, iki[nik_cum[t] - nik[t]: nik_cum[t]]] = 0.0
    return gt, nk_cum, nik_cum, iki, ikc


@pytest.mark.parametrize("seed,ns,n_tr,wide,zero_bias", [
    (1, 1, 20, False, False),
    (2, 5, 30, False, False),
    (3, 12, 40, True, False),
    (4, 7, 25, False, True),
    (5, 12, 40, True, True),
    (6, 1, 33, True, True),
])
def test_fuzz_cohorts(seed, ns, n_tr, wide, zero_bias):
    gt, nk_cum, nik_cum, iki, ikc = _fuzz(seed, ns, n_tr, wide, zero_bias)
    if wide:
        assert np.diff(nik_cum.astype(np.int64), prepend=0).max() > 32
    corr, _ = _check(gt, nk_cum, nik_cum, iki, ikc)
    if zero_bias and ns > 1:
        assert np.isnan(corr).any() and np.isinf(corr).any()
        nan_bits = np.unique(u32(corr)[np.isnan(corr)])
        assert nan_bits.tolist() == [pred.HOST_NAN_BITS]


def test_plain_chunks_and_oracle_copy(monkeypatch):
    """The plain version's column chunks do not change a byte, and the
    port's carried-over numpy oracle is the JAX package's."""
    gt, *meta = _fuzz(7, 6, 30, wide=True, zero_bias=True)
    whole = torch.from_numpy(gt.copy())
    b0 = pred.bias_correction_plain(whole, *meta)
    for chunk in (1, 7, 50):
        monkeypatch.setattr(pred, "PLAIN_CHUNK", chunk * 6)
        part = torch.from_numpy(gt.copy())
        b1 = pred.bias_correction_plain(part, *meta)
        assert torch.equal(part.view(torch.int32), whole.view(torch.int32))
        assert torch.equal(b1.view(torch.int32), b0.view(torch.int32))
    a, b = gt.copy(), gt.copy()
    with np.errstate(divide="ignore", invalid="ignore"):
        ba = pred.bias_correction_np(a, *meta)
        bb = jpred.bias_correction_np(b, *meta)
    assert np.array_equal(u32(a), u32(b)) and np.array_equal(u32(ba), u32(bb))


def test_load_gt_normalized(tmp_path, monkeypatch):
    rng = np.random.default_rng(11)
    nk, paths, rds = 1000, [], []
    for s, text in enumerate(("30.0", "28.53", "33.337", "25.1")):
        v = rng.integers(0, 1 << 40, nk, dtype=np.uint64)
        v[rng.random(nk) < 0.3] = rng.integers(0, 200, 1)[0]
        p = str(tmp_path / f"s{s}.trkmc.ar")
        bio.write_karray(p, v)
        paths.append(p)
        rds.append(pred._parse_f32(text))
    want = jpred.norm_read_depth(jpred.load_gt(paths, nk), rds)
    for chunk in (1 << 24, 7):
        monkeypatch.setattr(pred, "LOAD_CHUNK", chunk)
        got = pred.load_gt_normalized(paths, rds, nk)
        assert got.shape == (4, nk)
        assert np.array_equal(u32(got), u32(want))


@pytest.mark.parametrize("block", [None, 1, 7, 64, 1000])
def test_write_gt_matrix_blocks(tmp_path, monkeypatch, block):
    """Blocks of 1, 7, 64 and 1000 columns of a 5 x 203 matrix (and the
    default, one block) give the JAX writer's bytes."""
    m = np.random.default_rng(3).random((5, 203)).astype(np.float32)
    m[0, 5] = np.nan
    if block:
        monkeypatch.setattr(bio, "GT_BLOCK_BYTES", 4 * 5 * block)
    jbio.write_gt_matrix(str(tmp_path / "j.gt"), m)
    bio.write_gt_matrix(str(tmp_path / "t.gt"), m)
    assert (tmp_path / "j.gt").read_bytes() == (tmp_path / "t.gt").read_bytes()


def _run_both(meta, ik, tmp_path, port_cmd):
    j, t = tmp_path / "jax", tmp_path / "port"
    j.mkdir()
    t.mkdir()
    jcli.main(["pred", meta, ik] + [str(j / o) for o in OUTS])
    port_cmd(["pred", meta, ik] + [str(t / o) for o in OUTS]
             + ["--torch-device", "cpu"])
    for o in OUTS:
        assert (j / o).read_bytes() == (t / o).read_bytes(), o
    return bio.read_gt_matrix(str(t / "corr.gt"))


def test_cli_golden_cohort(tmp_path):
    """``python -m danbing_tk_tpu_torch pred --torch-device cpu`` on the
    six golden samples writes the JAX CLI's bytes."""
    meta, ik = scale_pred.write_golden_cohort(GOLDEN, str(tmp_path))

    def port(argv):
        env = dict(os.environ, PYTHONPATH=ROOT)
        r = subprocess.run([sys.executable, "-m", "danbing_tk_tpu_torch"]
                           + argv, cwd=ROOT, env=env, capture_output=True,
                           text=True, timeout=300)
        assert r.returncode == 0, r.stderr[-2000:]

    corr = _run_both(meta, ik, tmp_path, port)
    assert corr.shape == (6, 6638)


@pytest.mark.parametrize("seed", [1, 2])
def test_cli_fuzz_cohorts(tmp_path, seed):
    """The scale cohort's generator at a small size (skipped, zero-mean
    and zero-bias loci) through both CLIs."""
    co = scale_pred.build_cohort(6, nloci=40, kmers_per_locus=50, seed=seed,
                                 p_dead=0.1, p_zero=0.1)
    meta, ik = scale_pred.write_cohort(co, str(tmp_path / "in"), "cpu")
    corr = _run_both(meta, ik, tmp_path, cli.main)
    assert np.isnan(corr).any() and np.isinf(corr).any()


def test_ikmer_outside_its_locus_refused(tmp_path):
    meta, ik = scale_pred.write_golden_cohort(GOLDEN, str(tmp_path))
    nk_cum, nik_cum, iki, ikc = bio.read_ikmer_meta(ik)
    iki[-1] = 0                           # the last locus points at locus 0
    bio.write_ikmer_meta(ik, nk_cum, nik_cum, iki, ikc)
    with pytest.raises(ValueError, match="do not describe"):
        cli.main(["pred", meta, ik] + [str(tmp_path / o) for o in OUTS]
                 + ["--torch-device", "cpu"])


def test_index_check():
    """bias_correction refuses ikmer.meta arrays that KH would index
    outside the matrix with, or whose invariant k-mers leave their locus's
    block (the check runs before any launch, on any device)."""
    gt, nk_cum, nik_cum, iki, ikc = _toy()
    good = pred.index_tensors(nk_cum, nik_cum, iki, ikc, "cpu")
    pred.check_index(9, *good)
    for j, col in ((2, 9), (0, 4)):       # past nk; into locus 1's block
        bad = good[2].clone()
        bad[j] = col
        with pytest.raises(ValueError, match="do not describe"):
            pred.bias_correction(torch.from_numpy(gt.copy()), good[0],
                                 good[1], bad, good[3])
    for nk, args in ((10, good), (9, (good[0].flip(0), *good[1:])),
                     (9, (good[0], good[1][:2], *good[2:]))):
        with pytest.raises(ValueError, match="do not describe"):
            pred.check_index(nk, *args)


def test_index_tensors_keep_u32_widths():
    """KH reads nk_cum, nik_cum and iki as ikmer.meta stores them (u32),
    ikc as u8; values past 2^31 keep their bits, from numpy or int64
    tensors, and read back as the same int64 values."""
    big = np.array([5, 2**31 + 7, 2**32 - 1], dtype=np.uint32)
    ikc = np.array([1, 2, 3], dtype=np.uint8)
    got = pred.index_tensors(big, big, big, ikc, "cpu")
    assert [t.dtype for t in got] == [torch.int32] * 3 + [torch.uint8]
    for t in got[:3]:
        assert pred._i64(t).tolist() == big.tolist()
    wide = torch.from_numpy(big.astype(np.int64))
    again = pred.index_tensors(wide, wide, wide, got[3], "cpu")
    for a, b in zip(again, got):
        assert torch.equal(a, b)
