"""Same-call A/B of KJ (the error-correction site scorer) against other
checkouts'.

    python -m danbing_tk_tpu_torch.tools.ab_site_scorer --parent DIR
        [--parent DIR2 ...] [--nloci N] [--pairs N] [--seed S]

Builds ``DIR/danbing_tk_tpu_torch/csrc/site_scorer.cu`` of each --parent
(another checkout with the same entry point, e.g. the parent commit
unpacked with ``git archive``, or a copy of this tree's csrc/ with a
constant changed; only its ``csrc/`` is read) beside this tree's, with
``-Xptxas -v``, and scores B = 8,192 sites, mes = 2, k = 21:

* (a) ``chip_smoke.py`` phase 6c's sites: the threading reads of phase 6
  (TR pairs with 0.5% substitutions, 5% of the batches) on the synthetic
  scale index's loci (``tools/scale_index.py``; only the sequences and the
  8.86 GB graph table are built), the first 8,192 failure sites
  (``scale_index.failure_sites``);
* (b) golden-panel sites of the kinds ``tests/test_torch_correct.py``
  scores (walks of a locus graph with a substitution, a NAN64 hole, a
  truncation or a NAN64 node; ``golden_sites``, seed 23), whose graph
  table sits in L2.

Each case is first scored by every build, which must give the plain
version's counters.  Then, for each --parent in turn, in ``--pairs``
alternating pairs (the parent first in even pairs), each side's time:
bare (the ctypes call with its arguments built once: the median over 10
CUDA-event windows of 20 back-to-back calls, divided by 20), graph (the
same 20 calls captured in a CUDA graph and replayed, which leaves out the
host's ctypes call) and the wrapper (score_sites as the scorer calls it,
10 windows of 10 calls).  Prints the card, each build's registers and its
lookahead (``dtk_site_scorer_config``; "-" for a build without it), what
sets each case's work (the probes the counters need, the probes each
build's lookahead makes, the graph levels), every pair, both medians and
quartiles, and the change's wins.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ..engine import device_align as da
from ..engine.host_align import RPGG
from ..index import device_table as dt
from ..kernels import build
from ..ops import correct as cr
from .ab_assign_count import ab_pairs, card_name
from .ab_kmers_filter import GOLDEN, ab_all
from .scale_index import (ScaleThreadView, build_scale_graph, failure_sites,
                          sample_read_batch, scale_seqs)

KJ_SIG = "iii" + "ppp" + "pppi" + "pp"
B, K, MES, L, RL, SUB = 8192, 21, 2, 160, 150, 0.005


def config(lib) -> dict | None:
    """A build's lookahead and keys a pass, or None when the build does
    not export them."""
    if not hasattr(lib, "dtk_site_scorer_config"):
        return None
    return cr.site_scorer_config(lib)


def golden_sites(panel, rng, nsites: int, k: int = K) -> list:
    """[(kmers, ki, locus)]: a walk of up to 60 steps from a random node
    of a locus graph, then a substitution at ki, a NAN64 hole at ki + 2, a
    truncation after ki, a NAN64 node at ki - 1 or nothing (the kinds
    tests/test_torch_correct.py makes)."""
    rmask = (1 << (2 * (k - 1))) - 1
    out = []
    for li in rng.integers(0, panel.nloci, 20 * nsites):
        g = panel.graphs[int(li)]
        if not g:
            continue
        nodes = list(g)
        cur = node = int(nodes[int(rng.integers(0, len(nodes)))])
        kmers = [node]
        for _ in range(60):
            bits = g.get(cur, 0)
            if not bits:
                break
            b = int(rng.integers(0, 4))
            while not (bits >> b) & 1:
                b = (b + 1) % 4
            cur = ((cur & rmask) << 2) | b
            kmers.append(cur)
        if len(kmers) < 13:
            continue
        mode = int(rng.integers(0, 5))
        ki = int(rng.integers(1, len(kmers)))
        if mode == 0 and ki + 2 < len(kmers):
            kmers[ki] ^= int(rng.integers(1, 4))
        elif mode == 1 and ki + 3 < len(kmers):
            kmers[ki + 2] = cr.NAN64
        elif mode == 2:
            kmers = kmers[: ki + int(rng.integers(1, 6))]
        elif mode == 3:
            kmers[ki - 1] = cr.NAN64
        if ki >= len(kmers):
            continue
        out.append((kmers, ki, int(li)))
        if len(out) == nsites:
            break
    if len(out) < nsites:
        raise RuntimeError("golden site generator starved")
    return out


def scale_case(nloci: int, seed: int, dev):
    """Case (a): the scale graph table and phase 6c's sites."""
    seqs = scale_seqs(nloci, 1500, seed=seed)
    gtab, _ = build_scale_graph(seqs, verbose=False)
    view = ScaleThreadView(seqs, K)
    rng = np.random.default_rng([seed, 3])
    sites = []
    while len(sites) < B:
        c, r, li = sample_read_batch(seqs, 4 * 4096, L, rng, frac_tr=0.05,
                                     read_len=RL, sub_rate=SUB,
                                     with_loci=True)
        view.build(li)
        more, _ = failure_sites([(c, r, len(li))], [li], view, K, RL,
                                B - len(sites))
        sites += more
    return dt.DevTable.upload(gtab, dev), sites


def golden_case(seed: int, dev):
    """Case (b): the golden panel's graph table and its walks' sites."""
    rp = RPGG(os.path.join(GOLDEN, "pan"))
    rp.load_graphs()
    gd = da.DeviceRPGG.build(rp, with_tre=False)
    gd.add_graph(rp)
    sites = golden_sites(rp, np.random.default_rng(seed), B)
    return gd.tables(dev, graph=True)["graph"], sites


def kj_bare(lib, gtab, args):
    """One build's bare launch; returns (launch(stream), out)."""
    w, nkrem, loc = args
    out = torch.empty((B, cr.NCHAINS), dtype=torch.int32, device=w.device)
    fn = build.bind(lib, "dtk_site_scorer", KJ_SIG)
    a = (B, K, MES, build.ptr(w), build.ptr(nkrem), build.ptr(loc),
         *dt.level_args(gtab), build.ptr(out))
    return (lambda s, keep=(out, args): build.check(fn(*a, s),
                                                    "site_scorer"), out)


def kj_wrapper(lib, gtab, args):
    kl = cr.kernel_lib
    cr.kernel_lib = lambda _name: lib
    try:
        return cr.score_sites(gtab, *args, K, MES)
    finally:
        cr.kernel_lib = kl


def run_case(name, libs, gtab, sites, pairs, smi):
    w_lo, w_hi, nkrem, loc = cr.sites_to_batch(sites, k=K, B=B)
    dev = gtab.levels[0].device
    args = tuple(torch.from_numpy(a).to(dev)
                 for a in (cr.join_w(w_lo, w_hi), nkrem, loc))
    want = cr.score_sites_plain(gtab, *args, K, MES)
    need = len(cr.site_probes(gtab, *args, K, MES)[1])
    work = [f"KJ {name}: B={B} graph levels={len(gtab.levels)} "
            f"nonzero_sites={int(want.any(1).sum())} probes the counters "
            f"need={need} ({need / B:.2f} a site)"]
    launches = {}
    for side, lib in libs.items():
        c = config(lib)
        if c is not None:
            made = len(cr.site_probes(gtab, *args, K, MES,
                                      ahead=c["ahead"])[1])
            work.append(f"{side} {c}: probes made={made} "
                        f"(+{100 * (made - need) / max(need, 1):.1f}%)")
        launch, out = kj_bare(lib, gtab, args)
        launch(build.stream_of(args[0]))
        torch.cuda.synchronize()
        if not torch.equal(out, want) or not torch.equal(
                kj_wrapper(lib, gtab, args), want):
            raise RuntimeError(f"KJ {name}: {side} disagrees with "
                               f"score_sites_plain")
        launches[side] = launch
    print("; ".join(work), flush=True)
    stream = build.stream_of(args[0])
    for side in libs:
        if side == "change":
            continue
        tag = f"KJ {name} [parent={side}]"
        ab_all(tag, {"parent": launches[side], "change": launches["change"]},
               stream, pairs, smi)
        ab_pairs(f"{tag} wrapper", lambda s, p=side: kj_wrapper(
            libs[p if s == "parent" else "change"], gtab, args), pairs, smi,
            reps=10)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True, action="append")
    ap.add_argument("--nloci", type=int, default=80_000)
    ap.add_argument("--pairs", type=int, default=6)
    ap.add_argument("--seed", type=int, default=9)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("ab_site_scorer needs a CUDA card")
    dev = torch.device("cuda")
    smi = card_name()
    print(f"card: {smi}", flush=True)
    libs = {}
    for i, root in enumerate(args.parent + [None]):
        side = "change" if root is None else os.path.basename(
            os.path.normpath(root)) or f"parent{i}"
        src = os.path.join(build.CSRC if root is None else os.path.join(
            root, "danbing_tk_tpu_torch", "csrc"), "site_scorer.cu")
        libs[side], regs = build.build_ab(src, f"kj_{i}")
        c = config(libs[side])
        print(f"{side} ({src}) ptxas: {regs} config: "
              f"{'-' if c is None else c}", flush=True)
    run_case("(b) golden", libs, *golden_case(23, dev), args.pairs, smi)
    run_case("(a) scale", libs, *scale_case(args.nloci, args.seed, dev),
             args.pairs, smi)


if __name__ == "__main__":
    main()
