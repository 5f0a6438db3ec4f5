"""Synthetic `pred` cohort at the scale index's layout, made from a seed.

    python -m danbing_tk_tpu_torch.tools.scale_pred --out DIR --ns 8 \
        [--nloci 80000] [--kmers-per-locus 1500] [--seed S] \
        [--torch-device cuda|cpu]

writes DIR/ikmer.meta, DIR/gt.meta and DIR/sample<s>.trkmc.ar, the inputs
of ``pred``.  ``build_gt`` makes the normalised (ns, nk) f32 matrix
straight on a device instead, row by row, for an in-memory run of KH.

The cohort (80,000 loci x 1,500 TR k-mers, nk = 120,000,000 by default):
  * each locus has a uniform 0-100 invariant k-mers (so ~1% have none) at
    distinct columns of its own block, each with an expected count ikc in
    1-4 (u8);
  * sample s has copy number 1-4 at each locus, and a k-mer's count is
    Poisson with mean 26 per copy (a 30x sample's k-mer depth for 150 bp
    reads);
  * 1% of loci have no invariant coverage in any sample (pred skips them:
    m == 0), and 1% of the other (locus, sample) pairs have none while the
    rest of the cohort has some (their columns become inf and NaN);
  * read depths are decimal strings in 25-35.
Counts come from a torch generator on the chosen device, seeded per
sample from ``seed``, so the card makes the 15.36 GB of a 32-sample cohort
in seconds; the layout comes from numpy.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ..io import binary as bio

DEPTH_PER_COPY = 26.0


def build_cohort(ns: int, nloci: int = 80_000, kmers_per_locus: int = 1500,
                 seed: int = 9, p_dead: float = 0.01,
                 p_zero: float = 0.01) -> dict:
    """The cohort's layout and per-(locus, sample) settings, on the host:
    nk_cum, nik_cum (u32), iki (u32), ikc (u8), cn (ns, nloci) u8 copy
    numbers, zero_ik (ns, nloci) bool (no invariant coverage), rd_text
    (read depths as decimal strings).  p_dead and p_zero are the shares of
    loci with no invariant coverage anywhere and of (locus, sample) pairs
    with none."""
    rng = np.random.default_rng([seed, 8])
    kpl = kmers_per_locus
    nk_cum = (np.arange(1, nloci + 1, dtype=np.int64) * kpl).astype(
        np.uint32)
    nik = rng.integers(0, min(100, kpl) + 1, nloci)
    nik_cum = np.cumsum(nik).astype(np.uint32)
    # the j-th of a locus's n invariant k-mers sits in the j-th of n equal
    # strides of its block, at a random offset: distinct and in the block
    loc = np.repeat(np.arange(nloci), nik)
    j = np.arange(len(loc)) - np.repeat(np.cumsum(nik) - nik, nik)
    n = nik[loc]
    stride = kpl // np.maximum(n, 1)
    iki = (loc * kpl + j * stride + rng.integers(0, 1 << 30, len(loc))
           % stride).astype(np.uint32)
    ikc = rng.integers(1, 5, len(loc)).astype(np.uint8)
    cn = rng.integers(1, 5, (ns, nloci)).astype(np.uint8)
    dead = rng.random(nloci) < p_dead
    zero_ik = (rng.random((ns, nloci)) < p_zero) | dead[None, :]
    rd_text = [f"{x:.2f}" for x in rng.uniform(25.0, 35.0, ns)]
    return dict(nk_cum=nk_cum, nik_cum=nik_cum, iki=iki, ikc=ikc, cn=cn,
                zero_ik=zero_ik, rd_text=rd_text, seed=seed)


def sample_counts(cohort: dict, s: int, device) -> torch.Tensor:
    """(nk,) float32 integer counts of sample s on ``device``: Poisson with
    mean 26 x the locus's copy number, 0 at the invariant k-mers of loci
    with no invariant coverage in this sample."""
    device = torch.device(device)
    kpl = int(cohort["nk_cum"][0])
    nloci = len(cohort["nk_cum"])
    gen = torch.Generator(device=device)
    gen.manual_seed(cohort["seed"] * 1_000_003 + s)
    rate = (torch.from_numpy(cohort["cn"][s]).to(device).to(torch.float32)
            * DEPTH_PER_COPY).repeat_interleave(kpl)
    counts = torch.poisson(rate, generator=gen)
    del rate
    nik = np.diff(cohort["nik_cum"].astype(np.int64), prepend=0)
    off = np.repeat(cohort["zero_ik"][s], nik)
    if off.any():
        cols = torch.from_numpy(cohort["iki"][off].astype(np.int64))
        counts[cols.to(device)] = 0.0
    assert counts.numel() == nloci * kpl
    return counts


def read_depths(cohort: dict) -> list:
    """The read depths as f32, parsed from their decimal strings as pred
    parses gt.meta."""
    from ..analysis.pred import _parse_f32

    return [_parse_f32(t) for t in cohort["rd_text"]]


def build_gt(cohort: dict, device) -> torch.Tensor:
    """The normalised (ns, nk) f32 matrix on ``device``, row s = counts /
    rd[s] (the same f32 division as load_gt_normalized), made row by row
    into one preallocated tensor."""
    device = torch.device(device)
    ns = cohort["cn"].shape[0]
    nk = int(cohort["nk_cum"][-1])
    gt = torch.empty((ns, nk), dtype=torch.float32, device=device)
    for s, rd in enumerate(read_depths(cohort)):
        row = sample_counts(cohort, s, device)
        torch.div(row, torch.full((1,), float(rd), device=device),
                  out=gt[s])
        del row
    return gt


def write_cohort(cohort: dict, out_dir: str, device) -> tuple[str, str]:
    """Writes out_dir/sample<s>.trkmc.ar (u64 counts), gt.meta and
    ikmer.meta.  Returns (gt.meta path, ikmer.meta path)."""
    os.makedirs(out_dir, exist_ok=True)
    ik_path = os.path.join(out_dir, "ikmer.meta")
    bio.write_ikmer_meta(ik_path, cohort["nk_cum"], cohort["nik_cum"],
                         cohort["iki"], cohort["ikc"])
    meta = os.path.join(out_dir, "gt.meta")
    with open(meta, "w") as f:
        for s, rd in enumerate(cohort["rd_text"]):
            p = os.path.join(out_dir, f"sample{s}.trkmc.ar")
            counts = sample_counts(cohort, s, device).to(torch.int64).cpu()
            bio.write_karray(p, counts.numpy().view(np.uint64))
            del counts
            f.write(f"{p}\t{rd}\n")
    return meta, ik_path


def write_golden_cohort(golden_dir: str, out_dir: str,
                        seed: int = 9) -> tuple[str, str]:
    """pred inputs over the golden panel: the non-empty
    golden_dir/out*.trkmc.ar as samples, golden_dir/pan.tr.ksi as nk_cum,
    and from ``seed`` 0-40 invariant k-mers per locus (distinct columns of
    its block, in random order, ikc 1-4) and read depths in 25-35.
    Writes out_dir/gt.meta and out_dir/ikmer.meta; returns their paths."""
    import glob

    rng = np.random.default_rng([seed, 7])
    nk_cum = np.loadtxt(os.path.join(golden_dir, "pan.tr.ksi"),
                        dtype=np.int64, ndmin=1)
    iki, ikc, nik_cum = [], [], []
    for t, ei in enumerate(nk_cum):
        si = int(nk_cum[t - 1]) if t else 0
        n = int(rng.integers(0, min(int(ei) - si, 40) + 1))
        iki.extend(si + rng.permutation(int(ei) - si)[:n])
        ikc.extend(rng.integers(1, 5, n))
        nik_cum.append(len(iki))
    os.makedirs(out_dir, exist_ok=True)
    ik_path = os.path.join(out_dir, "ikmer.meta")
    bio.write_ikmer_meta(ik_path, nk_cum, nik_cum, np.array(iki, np.uint32),
                         np.array(ikc, np.uint8))
    meta = os.path.join(out_dir, "gt.meta")
    samples = [p for p in sorted(glob.glob(
        os.path.join(golden_dir, "out*.trkmc.ar"))) if os.path.getsize(p)]
    with open(meta, "w") as f:
        for p in samples:
            f.write(f"{p}\t{rng.uniform(25.0, 35.0):.2f}\n")
    return meta, ik_path


def main(argv=None) -> None:
    from .._device import resolve_device

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--ns", type=int, default=8)
    ap.add_argument("--nloci", type=int, default=80_000)
    ap.add_argument("--kmers-per-locus", type=int, default=1500)
    ap.add_argument("--seed", type=int, default=9)
    ap.add_argument("--torch-device", default="cuda")
    args = ap.parse_args(argv)
    cohort = build_cohort(args.ns, args.nloci, args.kmers_per_locus,
                          args.seed)
    meta, ik = write_cohort(cohort, args.out,
                            resolve_device(args.torch_device))
    print(f"{meta} {ik}")


if __name__ == "__main__":
    main()
