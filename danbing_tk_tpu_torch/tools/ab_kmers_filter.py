"""Same-call A/B of KA (k-mer and edge extraction) and KF (the QC and bait
read filter) against another checkout's.

    python -m danbing_tk_tpu_torch.tools.ab_kmers_filter --parent DIR
        [--nloci N] [--pairs N] [--seed S]

Builds ``DIR/danbing_tk_tpu_torch/csrc/{kmers,read_filter}.cu`` (another
checkout with the same entry points, e.g. the parent commit unpacked with
``git archive``; only its ``csrc/`` is read) beside this tree's, with
``-Xptxas -v``, and captures the inputs once:

* KA (a): the counting step's batch of ``chip_smoke.py`` phase 3 on the
  synthetic scale index (``tools/scale_index.py``, 1,500 k-mers per
  locus, the smoke's 80,000 loci by default): B = 8,192 reads of 150
  codes in L = 160 rows, k = 21; (b) the same codes at k = 31; (c) the
  golden panel's first 4,096 pairs (``tests/golden/reads.fa``) at
  L = 160, k = 21.  Each case in the counting instance (kmer, kvalid, nk
  and any_valid: what the counting and sharded steps read) and the
  all-planes instance (nc, edge and evalid too).  The parent writes every
  plane in both (it had no other instance).
* KF (a): phase 7b's okam-step inputs (TR pairs with 0.5% substitutions,
  a bait table of 64 k-mers a locus, a QC mask failing 5% of the loci,
  no quality mask); (b) the golden fastq bait step
  (``tests/golden/reads.sim.fq``, P = 1024, L = 192, its quality mask,
  the golden bait table and QC mask); (c) the QC-only instance, case
  (a)'s inputs without the bait table.

Each case is first run through both builds, which must give the same
planes (and the plain version's).  Then, in ``--pairs`` alternating
pairs (parent first in even pairs), each side's time (the parent's KA
any_valid plane is zeroed once before: re-running it sets the same
bytes): bare, the same ctypes call with its arguments built once, the
median over 10 CUDA-event windows of 20 back-to-back launches divided by
20, as the other A/B tools time; graph, the same 20 launches captured in
a CUDA graph and replayed (10 windows of 5 replays, divided by 100),
which leaves out the host's ctypes call and launch (about 7 us a call,
longer than these kernels' work, so a bare window of a short kernel
times the host); and the wrapper window the smoke times (``chip_smoke.py``
cuda_ms: 10 windows of 10 calls), which holds the host's enqueue and
allocations: this tree's ``extract_kmers`` and ``read_filter``, and for
the parent its KA wrapper as it stood (seven allocations, one a zero
fill, and the call) and this tree's ``read_filter`` calling the parent's
library (KF's wrapper is unchanged).  Prints the card, both builds'
registers and shared memory, each side's grid, every pair, both medians
and quartiles, and the change's wins.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import os

import numpy as np
import torch

from ..engine import device_align as da
from ..engine.host_align import RPGG, AlignConfig
from ..index import device_table as dt
from ..io.native_reader import NativeBatchReader
from ..kernels import build
from ..ops import kmers as km
from .ab_assign_count import ab_pairs, card_name
from .scale_index import (build_scale_bait, build_scale_qc, build_scale_rpgg,
                          sample_read_batch)

GOLDEN = os.path.join(os.path.dirname(build.CSRC), os.pardir, "tests",
                      "golden")
KA_SIG = "ppiiippppppp"
KF_SIG = "iipppppp" + "i" + "pppi" + "ppppp"
COUNTING = ("kmer", "kvalid", "nk", "any_valid")
GRAPH = 20                # launches a CUDA graph replays


def parent_extract_kmers(lib, codes, rlen, k):
    """The parent's KA wrapper as it stood: every plane, any_valid
    zero-filled (a second launch), then the kernel."""
    if codes.dtype != torch.uint8 or codes.dim() != 2:
        raise ValueError("codes must be a (B, L) uint8 tensor")
    codes = codes.contiguous()
    rlen = rlen.to(torch.int32).contiguous()
    B, L = codes.shape
    n, ne = L - k + 1, L - k
    dev = codes.device
    kmer = torch.empty((B, n), dtype=torch.int64, device=dev)
    nc = torch.empty_like(kmer)
    kvalid = torch.empty((B, n), dtype=torch.bool, device=dev)
    edge = torch.empty((B, ne), dtype=torch.int64, device=dev)
    evalid = torch.empty((B, ne), dtype=torch.bool, device=dev)
    nk = torch.empty(B, dtype=torch.int32, device=dev)
    any_valid = torch.zeros(B, dtype=torch.bool, device=dev)
    fn = build.bind(lib, "dtk_extract_kmers", KA_SIG)
    build.check(fn(build.ptr(codes), build.ptr(rlen), B, L, k,
                   build.ptr(kmer), build.ptr(nc), build.ptr(kvalid),
                   build.ptr(edge), build.ptr(evalid), build.ptr(nk),
                   build.ptr(any_valid), build.stream_of(codes)),
                "parent extract_kmers")
    return dict(kmer=kmer, kvalid=kvalid, nc=nc, edge=edge, evalid=evalid,
                nk=nk, any_valid=any_valid)


def ka_bare(lib, codes, rlen, k, planes):
    """KA's bare launch on ``lib`` writing ``planes`` (every plane, or
    COUNTING: null pointers for the rest); returns (launch(stream),
    outputs)."""
    B, L = codes.shape
    n, ne = L - k + 1, L - k
    dev = codes.device
    out = dict(kmer=torch.empty((B, n), dtype=torch.int64, device=dev),
               kvalid=torch.empty((B, n), dtype=torch.bool, device=dev),
               nk=torch.empty(B, dtype=torch.int32, device=dev),
               any_valid=torch.zeros(B, dtype=torch.bool, device=dev))
    if "nc" in planes:
        out["nc"] = torch.empty((B, n), dtype=torch.int64, device=dev)
    if "edge" in planes:
        out["edge"] = torch.empty((B, ne), dtype=torch.int64, device=dev)
        out["evalid"] = torch.empty((B, ne), dtype=torch.bool, device=dev)
    fn = build.bind(lib, "dtk_extract_kmers", KA_SIG)
    p = {key: build.ptr(v) for key, v in out.items()}
    a = (build.ptr(codes), build.ptr(rlen), B, L, k, p["kmer"], p.get("nc"),
         p["kvalid"], p.get("edge"), p.get("evalid"), p["nk"],
         p["any_valid"])
    return lambda s: build.check(fn(*a, s), "extract_kmers"), out


def kf_bare(lib, kf_args):
    """KF's bare launch on ``lib`` with the wrapper's arguments built once;
    returns (launch(stream), outputs)."""
    kmer, qmask, dst0, vote_pass, pack, qc, bait, nloci = kf_args
    R, NKW = kmer.shape
    P, dev = R // 2, kmer.device
    out = (torch.empty(P, dtype=torch.bool, device=dev),
           torch.empty(P, dtype=torch.bool, device=dev),
           torch.empty(R, dtype=torch.int32, device=dev),
           torch.empty(P, dtype=torch.bool, device=dev))
    lv = dt.level_args(bait) if bait is not None else (None, None, None, 0)
    qm = None if qmask is None or bait is None else build.ptr(qmask)
    fn = build.bind(lib, "dtk_read_filter", KF_SIG)
    a = (P, NKW, build.ptr(kmer), qm, build.ptr(dst0), build.ptr(vote_pass),
         build.ptr(pack), None if qc is None else build.ptr(qc), nloci, *lv,
         *[build.ptr(t) for t in out])
    return lambda s: build.check(fn(*a, s), "read_filter"), out


def graph_of(fn, args=()) -> torch.cuda.CUDAGraph:
    """fn(*args) GRAPH times, captured in one CUDA graph, after three
    calls outside it (so what a first call allocates is not captured)."""
    for _ in range(3):
        fn(*args)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(GRAPH):
            fn(*args)
    return g


def timers(launches: dict, stream) -> tuple:
    """For {side: launch(stream)}: the bare call of each side on
    ``stream``, and the replay of a CUDA graph of GRAPH launches."""
    bare = {s: (lambda f=f: f(stream)) for s, f in launches.items()}
    replay = {side: graph_of(lambda f=f: f(ctypes.c_void_p(
                  torch.cuda.current_stream().cuda_stream))).replay
              for side, f in launches.items()}
    return bare, replay


def ab_all(name: str, launches: dict, stream, pairs: int, smi: str):
    """The bare and the graph A/B of one case."""
    bare, replay = timers(launches, stream)
    ab_pairs(f"{name} bare", lambda s: bare[s](), pairs, smi)
    ab_pairs(f"{name} graph", lambda s: replay[s](), pairs, smi, reps=5,
             per=GRAPH)


def _same(name, a: dict, b: dict):
    for key in a:
        if not torch.equal(a[key], b[key]):
            raise RuntimeError(f"{name}: the builds disagree on {key}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True)
    ap.add_argument("--nloci", type=int, default=80_000)
    ap.add_argument("--pairs", type=int, default=6)
    ap.add_argument("--seed", type=int, default=9)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("ab_kmers_filter needs a CUDA card")
    dev = torch.device("cuda")
    smi = card_name()
    print(f"card: {smi}", flush=True)
    libs: dict = {"parent": {}, "change": {}}
    for side, root in (("parent", os.path.join(
            args.parent, "danbing_tk_tpu_torch", "csrc")),
            ("change", build.CSRC)):
        for name in ("kmers", "read_filter"):
            libs[side][name], regs = build.build_ab(
                os.path.join(root, f"{name}.cu"), f"{side}_{name}")
            print(f"{side} {name} ptxas: {regs}", flush=True)

    P, L, E, k, RL, SUB = 4096, 160, 512, 21, 150, 0.005
    drp, seqs = build_scale_rpgg(args.nloci, 1500, seed=args.seed,
                                 verbose=False)
    codes, rlen = sample_read_batch(seqs, P, L, np.random.default_rng(
        [args.seed, 1]), frac_tr=1.0, read_len=RL)
    seqs_g = [ln.strip() for ln in open(os.path.join(GOLDEN, "reads.fa"))
              if not ln.startswith(">")]
    gcodes, grlen = km.pack_reads(seqs_g[: 2 * P], L)
    up = lambda a: torch.from_numpy(a).to(dev)       # noqa: E731
    ka_cases = (("a scale k=21", up(codes), up(rlen), 21),
                ("b scale k=31", up(codes), up(rlen), 31),
                ("c golden k=21", up(gcodes), up(grlen), 21))

    # ---- KA ----
    for name, c, r, kk in ka_cases:
        B = c.shape[0]
        NKW = L - kk + 1
        print(f"KA {name}: B={B} L={L} NKW={NKW} grid parent: blocks="
              f"{-(-B * NKW // 256)} threads=256 smem=0; change: "
              f"blocks, threads, smem = {km.kmers_launch(B, L)}",
              flush=True)
        plain = km.extract_kmers_plain(c, r, kk)
        for inst, planes in (("counting", COUNTING),
                             ("all-planes", tuple(plain))):
            flags = dict(nc="nc" in planes, edges="edge" in planes)
            bare = {"parent": ka_bare(libs["parent"]["kmers"], c, r, kk,
                                      tuple(plain)),
                    "change": ka_bare(libs["change"]["kmers"], c, r, kk,
                                      planes)}
            stream = build.stream_of(c)
            for launch, _ in bare.values():
                launch(stream)
            torch.cuda.synchronize()
            got = {s: {key: o[key] for key in planes}
                   for s, (_, o) in bare.items()}
            _same(f"KA {name} {inst}", got["parent"], got["change"])
            _same(f"KA {name} {inst} vs plain", got["change"],
                  {key: plain[key] for key in planes})
            wrapped = km.extract_kmers(c, r, kk, **flags)
            if set(wrapped) != set(planes):
                raise RuntimeError(f"KA {name} {inst}: the wrapper gave "
                                   f"{sorted(wrapped)}")
            _same(f"KA {name} {inst} wrapper", wrapped, got["change"])
            ab_all(f"KA {name} {inst}",
                   {s: f for s, (f, _) in bare.items()}, stream,
                   args.pairs, smi)
            wrap = {"parent": lambda: parent_extract_kmers(
                        libs["parent"]["kmers"], c, r, kk),
                    "change": lambda: km.extract_kmers(c, r, kk, **flags)}
            ab_pairs(f"KA {name} {inst} wrapper",
                     lambda s: wrap[s](), args.pairs, smi, reps=10)
    del ka_cases, plain, bare, got, wrapped

    # ---- KF ----
    drp.bait_tab, _ = build_scale_bait(seqs, seed=args.seed)
    drp.qc = build_scale_qc(args.nloci, seed=args.seed)
    ocfg = AlignConfig(ksize=k, cth=20, n_filter=4, nm_filter=1, okam=True,
                       simmode=2, bait=True, qc=True)
    ocodes, orlen = sample_read_batch(seqs, P, L, np.random.default_rng(
        [args.seed, 4]), frac_tr=1.0, read_len=RL, sub_rate=SUB)
    cap: dict = {}
    da.make_step(drp, ocfg, P, L, expand_cap=E, with_annot=True,
                 device=dev, capture=cap)(
        da.init_state(drp, dev), ocodes, orlen, np.ones(P, dtype=bool))
    kf_cases = [("a okam bait", cap["KF"]),
                ("c qc-only", cap["KF"][:6] + (None,) + cap["KF"][7:])]
    Pg, Lg = 1024, 192
    gd = da.DeviceRPGG.build(RPGG(os.path.join(GOLDEN, "pan"), bait=True,
                                  qc_file=os.path.join(GOLDEN, "qc.txt")),
                             with_tre=False)
    rd = NativeBatchReader(os.path.join(GOLDEN, "reads.sim.fq"), Pg, Lg,
                           is_fastq=True, min_read_size=40,
                           with_titles=False, with_quals=True)
    gc_, gr_, gn, _, gq = next(iter(rd))
    gcap: dict = {}
    fq = AlignConfig(ksize=k, cth=20, n_filter=4, nm_filter=1, okam=True,
                     simmode=2, bait=True, qc=True, is_fastq=True)
    da.make_step(gd, fq, Pg, Lg, with_annot=True, with_qual=True,
                 device=dev, capture=gcap)(
        da.init_state(gd, dev), gc_, gr_, np.arange(Pg) < gn,
        da.qmask_batch(gq, gr_, 20, k))
    kf_cases.insert(1, ("b golden fastq bait+qmask", gcap["KF"]))
    for name, a in kf_cases:
        R, NKW = a[0].shape
        bait = a[6] is not None
        NP = 1 << max(NKW - 1, 0).bit_length()
        print(f"KF {name}: P={R // 2} NKW={NKW} grid parent: blocks="
              f"{R // 2} threads=256 smem={2 * NP * 8 if bait else 0}; "
              f"change: blocks, threads, smem = "
              f"{da.read_filter_launch(R // 2, NKW, bait)}", flush=True)
        bare = {s: kf_bare(libs[s]["read_filter"], a) for s in libs}
        stream = build.stream_of(a[0])
        for launch, _ in bare.values():
            launch(stream)
        torch.cuda.synchronize()
        keys = ("dev_pair", "qc_drop", "bf", "bf_pair")
        want = dict(zip(keys, da.read_filter_plain(*a)))
        for s, (_, o) in bare.items():
            _same(f"KF {name} {s} vs plain", dict(zip(keys, o)), want)
        _same(f"KF {name} wrapper", dict(zip(keys, da.read_filter(*a))),
              want)
        print(f"KF {name}: dev_pairs={int(want['dev_pair'].sum())} "
              f"qc_dropped={int(want['qc_drop'].sum())} bait_filtered="
              f"{int(want['bf_pair'].sum())}", flush=True)
        ab_all(f"KF {name}", {s: f for s, (f, _) in bare.items()}, stream,
               args.pairs, smi)

        def wrapper(side, a=a):
            """This tree's read_filter on ``side``'s library."""
            lib = libs[side]["read_filter"]
            kl = da.kernel_lib
            da.kernel_lib = lambda _name: lib
            try:
                return da.read_filter(*a)
            finally:
                da.kernel_lib = kl

        ab_pairs(f"KF {name} wrapper", wrapper, args.pairs, smi, reps=10)


if __name__ == "__main__":
    main()
