"""A seeded RPGG build-and-QC scenario: assemblies, liftover beds and reads.

    python -m danbing_tk_tpu_torch.tools.build_scenario --out DIR \
        [--nloci 256] [--fs 700] [--trwindow 800] [--decoys 64] \
        [--run [--device [--torch-device D]] [--cov C] [-p P]]

writes what ``build`` and ``qc`` read:
  * DIR/input/<g>.<h>.fa: one contig per locus and haplotype,
    ``ctg<locus>_<hap>``, a TR (a random 5-11 bp motif repeated over
    450-750 bases, the motif shared by every haplotype of the locus and no
    two loci sharing a TR k-mer) between two
    random flanks of TRWINDOW + 50 bases, so the TRWINDOW-padded window of
    MBE lies inside the contig;
  * DIR/work/<g>/tmp1.<h>.bed: the liftover beds, so ``build DIR/work
    DIR/input DIR/genomes.txt DIR/ref.tr.bed`` starts at the support
    counts;
  * DIR/paf/<g>.<h>.paf: a minimap2 record a locus mapping its reference
    region onto its TR, from which ``build --paf <g>=<g>.0.paf,<g>.1.paf
    --lift-min-len 100`` writes those same tmp1 beds;
  * DIR/ref.tr.bed and DIR/genomes.txt;
  * decoys in g1, the second and last of the two genomes (the negative
    control of ``qc``): contigs
    ``decoy<j>_<hap>``, a shorter copy of a locus's TR (its motif repeated
    over 350 bases, which both mates of one of qc's 500-base fragments can
    reach) between foreign 400-base flanks.  Their reads are annotated '.'
    (the true copy has more TR k-mer hits) and those whose mates both reach
    the repeat land on the locus, so they are the false positives the
    bait is built from;
  * DIR/g0.reads.fa: the first genome's own short reads for ``build
    --prune-reads`` (sim_reads at prune_cov over both haplotypes, reads
    of every prune_skip-th locus left out so its k-mers are pruned).

``qc_input(work, indir, out)`` links the built index and the assemblies
into the directory ``qc`` reads.  Everything comes from numpy's
default_rng(seed).

With ``--run`` the tool then drives the scenario through the CLI, as a
user would: ``build DIR/build ... --paf ... --prune-reads g0=READS -p P``
and ``qc DIR/qcin DIR/qc g0,g1 g1 -c COV``, both with ``--device
--torch-device D`` when ``--device`` is given (else on the host engine).
A device run holds every align call to the host engine (``held_to_host``):
the call runs again without ``--device``, and its stdout and output files
must be byte-equal.  Everything else the two commands do is host code fed
by those outputs, so the device run's trees are the host run's.  It
prints, as its last line, one JSON object: each build and qc stage's host
seconds (an align call's seconds, device and host engine, are listed
apart, with the read pairs of its input and the files compared, and left
out of its stage's), the build's and the qc's wall, the kernels' launch
counts of the build (``build_prune``) and of the qc (``qc``), each set to
0 just before and read just after, and the wall.  ``chip_smoke.py`` phase
4c runs it with ``--device``.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import shutil
import sys
import time

import numpy as np

BASES = "ACGT"
TR_MIN, TR_MAX = 450, 750    # a locus's TR length
DECOY_FLANK = 400
DECOY_TR = 350          # both mates of a 500-base fragment can reach it


def make_scenario(root: str, nloci: int = 256, FS: int = 700, TRWINDOW: int = 800, decoys: int = 64,
                  prune_cov: int = 1, prune_skip: int = 8,
                  seed: int = 12) -> dict:
    """Writes the scenario under ``root``; returns its paths and sizes."""
    from ..apps.sim_reads import sim_reads
    from ..ops import kmers_np as K

    rng = np.random.default_rng(seed)

    def rand_seq(n):
        return "".join(BASES[i] for i in rng.integers(0, 4, n))

    gs = ["g0", "g1"]       # g1 is the control genome
    # no two loci share a TR k-mer: a shared motif would let one locus's
    # reads overlap another's annotation (qc's comma lists, which the
    # simmode-2 title parse does not take)
    motifs, seen = [], set()
    while len(motifs) < nloci:
        m = rand_seq(int(rng.integers(5, 12)))
        kms = set(K.seq_to_kmers(K.encode_bases(m * (42 // len(m) + 1)),
                                 21, canonical=True).tolist())
        if not kms & seen:
            motifs.append(m)
            seen |= kms
    indir = os.path.join(root, "input")
    work = os.path.join(root, "work")
    pafdir = os.path.join(root, "paf")
    os.makedirs(indir, exist_ok=True)
    os.makedirs(pafdir, exist_ok=True)
    nbases = 0
    for gi, g in enumerate(gs):
        os.makedirs(os.path.join(work, g), exist_ok=True)
        for h in (0, 1):
            hi = 2 * gi + h
            recs, rows = [], []
            for li in range(nloci):
                m = motifs[li]
                tr = m * (int(rng.integers(TR_MIN, TR_MAX)) // len(m) + 1)
                lf = rand_seq(TRWINDOW + 50)
                rf = rand_seq(TRWINDOW + 50)
                name = f"ctg{li}_{hi}"
                recs.append((name, lf + tr + rf))
                rows.append((name, len(lf), len(lf) + len(tr),
                             "chr1", 1000 * li, 1000 * li + 500))
            if g == gs[-1]:
                for j in range(decoys):
                    m = motifs[(j * 7 + h) % nloci]
                    recs.append((f"decoy{j}_{hi}",
                                 rand_seq(DECOY_FLANK)
                                 + m * (DECOY_TR // len(m))
                                 + rand_seq(DECOY_FLANK)))
            with open(os.path.join(indir, f"{g}.{h}.fa"), "w") as f:
                for nm, s in recs:
                    f.write(f">{nm}\n{s}\n")
                    nbases += len(s)
            with open(os.path.join(work, g, f"tmp1.{h}.bed"), "w") as f:
                for nm, s, e, rc, rs, re_ in rows:
                    f.write(f"{nm}\t{s}\t{e}\t{rc}\t{rs}\t{re_}\t1\n")
            with open(os.path.join(pafdir, f"{g}.{h}.paf"), "w") as f:
                for (nm, s, e, rc, rs, re_), (_, seq) in zip(rows, recs):
                    f.write(paf_row(rc, rs, re_, nm, len(seq), s, e) + "\n")
    ref_bed = os.path.join(root, "ref.tr.bed")
    with open(ref_bed, "w") as f:
        for li in range(nloci):
            f.write(f"chr1\t{1000 * li}\t{1000 * li + 500}\n")
    genomes = os.path.join(root, "genomes.txt")
    with open(genomes, "w") as f:
        f.write("".join(f"{g}\n" for g in gs))

    buf = io.StringIO()
    for h in (0, 1):
        sim_reads(os.path.join(indir, f"{gs[0]}.{h}.fa"), buf, cov=prune_cov,
                  flen=300, rlen=100, min_ctg_len=100)
    reads = os.path.join(root, f"{gs[0]}.reads.fa")
    lines = buf.getvalue().splitlines()
    npairs = 0
    with open(reads, "w") as f:
        for t1, s1, t2, s2 in zip(lines[::4], lines[1::4], lines[2::4],
                                  lines[3::4]):
            name = t1[1:].split(":")[0]
            if not name.startswith("ctg") or (
                    int(name[3:].split("_")[0]) % prune_skip
                    == prune_skip - 1):
                continue
            f.write(f"{t1}\n{s1}\n{t2}\n{s2}\n")
            npairs += 1
    pafs = [f"{g}=" + ",".join(os.path.join(pafdir, f"{g}.{h}.paf")
                               for h in (0, 1)) for g in gs]
    return dict(indir=indir, work=work, genomes=genomes, gs=gs, pafs=pafs,
                ref_bed=ref_bed, reads=reads, prune_pairs=npairs,
                nbases=nbases, FS=FS, TRWINDOW=TRWINDOW, nloci=nloci)


def paf_row(qname: str, qs: int, qe: int, tname: str, tlen: int, ts: int,
            te: int) -> str:
    """A minimap2 PAF record (with its cg:Z: cigar) aligning the reference
    region [qs, qe) of ``qname`` onto [ts, te) of ``tname``, the length
    difference taken by one indel in the middle, so that the LiftTR lifts
    the region onto exactly [ts, te)."""
    q, t = qe - qs, te - ts
    if q == t:
        cg = f"{q}M"
    elif t < q:
        cg = f"{t // 2}M{q - t}I{t - t // 2}M"
    else:
        cg = f"{q // 2}M{t - q}D{q - q // 2}M"
    blen = max(q, t)
    return "\t".join(map(str, [qname, qe + 1000, qs, qe, "+", tname, tlen,
                               ts, te, min(q, t), blen, 60, "de:f:0.0001",
                               f"cg:Z:{cg}"]))


def qc_input(work: str, indir: str, out: str) -> str:
    """Links the assemblies of ``indir`` and the index that ``build`` wrote
    to ``work`` (pan.kmers.dbi, .fl.kdb, .tre.kdb, .tr.kmers) into
    ``out``, the input directory of ``qc``."""
    os.makedirs(out, exist_ok=True)
    for name in sorted(os.listdir(indir)):
        if name.endswith(".fa"):
            os.symlink(os.path.abspath(os.path.join(indir, name)),
                       os.path.join(out, name))
    for suf in (".kmers.dbi", ".fl.kdb", ".tre.kdb", ".tr.kmers"):
        os.symlink(os.path.abspath(os.path.join(work, "pan" + suf)),
                   os.path.join(out, "pan" + suf))
    return out


def _timed(mod, name: str, acc: dict, label: str):
    """Wraps the function ``name`` of module ``mod`` so the seconds of its
    calls are summed into acc[label]."""
    call = getattr(mod, name)

    def timed(*a, **k):
        t0 = time.perf_counter()
        try:
            return call(*a, **k)
        finally:
            acc[label] = acc.get(label, 0.0) + time.perf_counter() - t0

    setattr(mod, name, timed)


def _stdout_of(main, argv) -> str:
    old, sys.stdout = sys.stdout, io.StringIO()
    try:
        main(argv)
        return sys.stdout.getvalue()
    finally:
        sys.stdout = old


def _outputs(prefix: str) -> list:
    d, base = os.path.split(prefix)
    return sorted(n for n in os.listdir(d or ".") if n.startswith(base + "."))


@contextlib.contextmanager
def held_to_host(scratch: str):
    """Within it, the port's ``cli.main`` runs an ``align`` argv that has
    ``--device`` as given and then again on the host engine (``--device``
    and ``--torch-device D`` dropped, its ``-o``/``-on`` prefix moved
    under ``scratch``), and raises RuntimeError unless the two runs'
    stdout and output files are byte-equal.  Yields the list of align
    calls, each a dict (what, pairs, s, and for a device call host_s and
    the files compared), appended as the calls end."""
    from ..apps import cli

    main = cli.main
    calls: list = []

    def align_or_command(argv=None):
        if not argv or argv[0] != "align":
            return main(argv)
        fq = "-fq" in argv
        with open(argv[argv.index("-fq" if fq else "-fa") + 1]) as f:
            pairs = sum(1 for _ in f) // (8 if fq else 4)
        what = ("prune -g" if "-g" in argv else "extract -e 1"
                if "-e" in argv else "bait map -b" if "-b" in argv
                else "raw map -s 2")
        call = dict(what=what, pairs=pairs)
        t0 = time.perf_counter()
        out = _stdout_of(main, argv)
        call["s"] = time.perf_counter() - t0
        sys.stdout.write(out)
        if "--device" in argv:
            host = [a for a in argv if a != "--device"]
            if "--torch-device" in host:
                j = host.index("--torch-device")
                del host[j:j + 2]
            twin = os.path.join(scratch, str(len(calls)))
            os.makedirs(twin)
            flag = next((f for f in ("-o", "-on") if f in argv), None)
            names = []
            if flag is not None:
                j = argv.index(flag) + 1
                host[j] = os.path.join(twin, os.path.basename(argv[j]))
                names = _outputs(argv[j])
            t0 = time.perf_counter()
            host_out = _stdout_of(main, host)
            call["host_s"] = time.perf_counter() - t0
            if host_out != out:
                raise RuntimeError(f"align {what}: the device engine's "
                                   f"stdout differs from the host engine's")
            if flag is not None:
                if names != _outputs(host[j]):
                    raise RuntimeError(
                        f"align {what}: the device engine wrote {names}, "
                        f"the host engine {_outputs(host[j])}")
                d = os.path.dirname(argv[j]) or "."
                for n in names:
                    with open(os.path.join(d, n), "rb") as f, \
                            open(os.path.join(twin, n), "rb") as g:
                        if f.read() != g.read():
                            raise RuntimeError(
                                f"align {what}: {n} of the device engine "
                                f"differs from the host engine's")
            call["files"] = len(names) + bool(out)
            shutil.rmtree(twin)
        calls.append(call)

    cli.main = align_or_command
    try:
        yield calls
    finally:
        cli.main = main


def run_scenario(sc: dict, out: str, device: str | None, cov: int = 2,
                 procs: int = 1) -> dict:
    """Builds and QCs the scenario through the CLI under ``out`` (build/,
    qcin/, qc/); ``device`` None runs the host engine, else each align
    call is held to the host engine (``held_to_host``, under out/host/).
    Returns the stage seconds, the align calls and the launch counts."""
    from ..apps import baitbuilder, cli, ktools, sim_reads
    from ..kernels import build as kb
    from ..pipeline import build, qc

    dev = [] if device is None else ["--device", "--torch-device", device]
    stages: dict = {}
    main = cli.main
    step = build._step
    os.makedirs(os.path.join(out, "host"))
    with held_to_host(os.path.join(out, "host")) as aligns:

        def align_s():
            return sum(a["s"] + a.get("host_s", 0.0) for a in aligns)

        def timed_step(workdir, name, fn, force=False):
            t0, a0 = time.perf_counter(), align_s()
            step(workdir, name, fn, force)
            stages[f"build {name}"] = (time.perf_counter() - t0
                                       - (align_s() - a0))

        build._step = timed_step
        for mod, name, label in (
                (sim_reads, "sim_reads", "qc simulate"),
                (qc, "derive_tr_bed", "qc annotate"),
                (qc, "annotate_reads", "qc annotate"),
                (baitbuilder, "build_profiles", "qc profiles"),
                (baitbuilder, "enrichment_filter", "qc FPSkmer"),
                (ktools, "serialize_bt", "qc serialize-bt")):
            _timed(mod, name, stages, label)
        launches = {}
        t_all = time.perf_counter()
        argv = ["build", os.path.join(out, "build"), sc["indir"],
                sc["genomes"], sc["ref_bed"], "-fs", str(sc["FS"]),
                "--trwindow", str(sc["TRWINDOW"]), "--dist-merge",
                str(sc["FS"]), "-p", str(procs), "--lift-min-len", "100",
                "--prune-reads", f"{sc['gs'][0]}={sc['reads']}"]
        for kv in sc["pafs"]:
            argv += ["--paf", kv]
        kb.reset_launch_counts()
        t0 = time.perf_counter()
        main(argv + dev)
        _sync(device)
        launches["build_prune"] = kb.launch_counts()
        build_s = time.perf_counter() - t0
        for a in aligns:
            a["stage"] = "build"
        qin = qc_input(os.path.join(out, "build"), sc["indir"],
                       os.path.join(out, "qcin"))
        kb.reset_launch_counts()
        t0 = time.perf_counter()
        main(["qc", qin, os.path.join(out, "qc"), ",".join(sc["gs"]),
              sc["gs"][-1], "-c", str(cov)] + dev)
        _sync(device)
        launches["qc"] = kb.launch_counts()
        qc_s = time.perf_counter() - t0
        for a in aligns:
            a.setdefault("stage", "qc")
        stages["qc other"] = qc_s - sum(
            v for k, v in stages.items() if k.startswith("qc ")) - sum(
            a["s"] + a.get("host_s", 0.0) for a in aligns
            if a["stage"] == "qc")
    build._step = step
    return dict(stages=stages, aligns=aligns, launches=launches,
                build_s=build_s, qc_s=qc_s, wall=time.perf_counter() - t_all)


def _sync(device):
    if device is not None and device.startswith("cuda"):
        import torch

        torch.cuda.synchronize()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--nloci", type=int, default=256)
    ap.add_argument("--fs", type=int, default=700)
    ap.add_argument("--trwindow", type=int, default=800)
    ap.add_argument("--decoys", type=int, default=64)
    ap.add_argument("--run", action="store_true",
                    help="then build and qc the scenario through the CLI")
    ap.add_argument("--device", action="store_true",
                    help="with --run: the device engine, each align call "
                         "held to the host engine's (else the host's alone)")
    ap.add_argument("--torch-device", default="cuda")
    ap.add_argument("--cov", type=int, default=2,
                    help="with --run: qc's read coverage")
    ap.add_argument("-p", type=int, default=1,
                    help="with --run: build's MBE worker processes")
    a = ap.parse_args(argv)
    t0 = time.perf_counter()
    sc = make_scenario(os.path.join(a.out, "sc"), a.nloci, a.fs,
                       a.trwindow, a.decoys)
    res = dict(scenario_s=time.perf_counter() - t0,
               **{k: sc[k] for k in ("nloci", "prune_pairs", "nbases")})
    if a.run:
        res.update(run_scenario(sc, a.out,
                                a.torch_device if a.device else None,
                                a.cov, a.p))
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
