"""RPGG build orchestration (L6) — replaces the reference's Snakemake DAG
(pipeline/GoodPanGenomeGraph.snakefile) with plain Python steps.

Stages (JointTRAnnotation onward; the upstream MapRef2Asm stage needs
the external minimap2 aligner exactly as in the reference, but its PAF
output feeds the NATIVE LiftTR (pipeline/liftover.py, `build --paf`) --
paftools.js/bedtools are no longer required):

  1. support counts   : refTR bed + per-hap tmp1 beds -> pan.tr.mbe.v0.bed
                        (bedtools map -c 1 -o count equivalent)
  2. MBE              : joint boundary expansion -> pan.tr.mbe.v1.bed
  3. collision scan   : merged-region groups -> mbe.m0.loci
  4. mergeMBEbed      : -> pan.tr.mbe.v2.bed + OrthoMap.v2.tsv
  5. SelectRegions    : TR +/- FS windows -> per-hap tr fastas
  6. fa2kmers         : per-genome {tr,fl,graph}.kmers (+tre)
  7. genPanKmers      : pan merge
  8. serialize        : pan.kmers.dbi / .fl.kdb / .tre.kdb

Each stage writes a sentinel under <workdir>/checkpoint/ and is skipped on
re-run (the reference's Snakemake resume granularity, SURVEY §5).
"""

from __future__ import annotations

import os

from ..apps.fa2kmers import fa2kmers
from ..apps.genpankmers import gen_pan_kmers, read_ortho_map
from ..apps.mbe import run_mbe
from ..apps.merge_mbe import write_bed_merge_mbe
from ..apps.select_regions import select_regions
from ..index import dbi as dbi_mod
from ..utils.bedops import bed_map_count, collision_scan, write_m0_loci


def _sentinel(workdir: str, name: str) -> str:
    os.makedirs(os.path.join(workdir, "checkpoint"), exist_ok=True)
    return os.path.join(workdir, "checkpoint", name + ".done")


def _step(workdir: str, name: str, fn, force: bool = False):
    s = _sentinel(workdir, name)
    if os.path.exists(s) and not force:
        print(f"[build] {name}: cached")
        return
    print(f"[build] {name}: running")
    fn()
    open(s, "w").close()


def build_rpgg(workdir: str, indir: str, gs: list[str], ref_tr_bed: str,
               ksize: int = 21, FS: int = 700, TRWINDOW: int = 100000,
               dist_merge: int = 700, th1: float = 0.1, th2: float = 0.8,
               ignore_case: bool = True, force: bool = False,
               nproc: int = 1, prune_reads: dict[str, str] | None = None,
               cth: int = 45, thcth: int = 50, use_device: bool = False,
               device: str = "cuda"):
    """Runs the full build; returns the pan prefix path.

    ``prune_reads`` maps genome name -> PE reads path (fasta/fastq) of
    that genome's own short reads; when given, the prune path of
    GenRawGenomeGraph/GenPrunedGenomeGraph
    (GoodPanGenomeGraph.snakefile:241-336) runs per genome:
    raw graph -> threading-mode self-alignment (-g thcth -cth cth) ->
    count==0 prune list -> pruned graph, plus the EvalRawGenomeGraph
    linreg diagnostic ({g}.rawLR.pred).  cth/thcth defaults follow
    pipeline/goodPanGenomeGraph.json.

    ``use_device`` runs the prune alignment on the port's device engine
    (``align --device``) on the torch ``device`` (default ``cuda``; without
    a card this raises before any stage runs, unless ``device="cpu"``);
    without it the host engine aligns and no card work is done."""
    if use_device:
        from .._device import resolve_device

        device = str(resolve_device(device))
    nh = 2 * len(gs)
    os.makedirs(workdir, exist_ok=True)

    def support_counts():
        ref = [line.split()[:3] for line in open(ref_tr_bed)]
        cols = [ref]
        for g in gs:
            for h in (0, 1):
                rows = [line.split() for line in
                        open(os.path.join(workdir, g, f"tmp1.{h}.bed"))]
                b = [(r[3], r[4], r[5]) for r in rows if r[0] != "."]
                cols.append(bed_map_count(ref, b))
        with open(os.path.join(workdir, "pan.tr.mbe.v0.bed"), "w") as f:
            for i in range(len(ref)):
                row = list(ref[i]) + [str(c[i]) for c in cols[1:]]
                f.write("\t".join(row) + "\n")

    _step(workdir, "support", support_counts, force)
    _step(workdir, "mbe", lambda: run_mbe(
        workdir, indir, gs, ksize, FS, TRWINDOW, th1, th2, ignore_case,
        nproc=nproc), force)

    def collide():
        rows = [line.split("\t") for line in
                open(os.path.join(workdir, "pan.tr.mbe.v1.bed"))
                .read().splitlines()]
        groups = collision_scan(rows, nh, dist_merge)
        write_m0_loci(os.path.join(workdir, "mbe.m0.loci"), gs, groups)

    _step(workdir, "collision", collide, force)
    _step(workdir, "merge", lambda: write_bed_merge_mbe(
        workdir, len(gs), th2), force)

    def trfa():
        os.makedirs(os.path.join(workdir, "trfa"), exist_ok=True)
        v2 = [line.split("\t") for line in
              open(os.path.join(workdir, "pan.tr.mbe.v2.bed"))
              .read().splitlines()]
        hi = 0
        for g in gs:
            for h in (0, 1):
                bed = os.path.join(workdir, "trfa", f"{g}.{h}.bed")
                with open(bed, "w") as f:
                    for cols in v2:
                        c, s, e = cols[3 + 4 * hi : 6 + 4 * hi]
                        if c == "None":
                            continue
                        f.write(f"{c}\t{int(s) - FS}\t{int(e) + FS}\n")
                select_regions(
                    bed, os.path.join(indir, f"{g}.{h}.fa"),
                    os.path.join(workdir, "trfa", f"{g}.{h}.tr.fasta"))
                hi += 1

    _step(workdir, "trfa", trfa, force)

    def genome_kmers():
        omap = read_ortho_map(os.path.join(workdir, "OrthoMap.v2.tsv"), nh)
        nloci = len(omap)
        for gi, g in enumerate(gs):
            fas = [os.path.join(workdir, "trfa", f"{g}.{h}.tr.fasta")
                   for h in (0, 1)]
            gmap = [[omap[li][2 * gi + h] for h in (0, 1)]
                    for li in range(nloci)]
            pb = os.path.join(workdir, f"{g}.PB")
            prune_file = None
            if prune_reads and g in prune_reads:
                prune_file = _gen_prune_list(
                    workdir, g, fas, gmap, nloci, ksize, FS,
                    prune_reads[g], cth, thcth, use_device, device)
            fa2kmers(pb, fas, k=ksize, fsi=FS, fso=FS, orthomap=gmap,
                     nloci=nloci, prune_file=prune_file)
            make_tre_kmers_mapped(pb, fas, gmap, nloci, ksize, FS)

    _step(workdir, "genome_kmers", genome_kmers, force)
    _step(workdir, "pan_kmers", lambda: gen_pan_kmers(
        os.path.join(workdir, "pan"),
        [os.path.join(workdir, f"{g}.PB") for g in gs]), force)
    _step(workdir, "serialize", lambda: dbi_mod.serialize(
        os.path.join(workdir, "pan")), force)
    return os.path.join(workdir, "pan")


def _read_fasta(path: str) -> dict[str, str]:
    from ..io.text import iter_fasta_records

    return dict(iter_fasta_records(path))


def kmer_lift_tmp1(ref_fa: str, ref_tr_bed: str, asm_fa: str,
                   ksize: int = 21):
    """Liftover substitute for fixtures without minimap2 output
    (MapRef2Asm/LiftTR, GoodPanGenomeGraph.snakefile:55-150): locate each
    refTR locus inside the assembly by scanning for the reference TR's
    canonical k-mers and emit tmp1-format rows
    [asm_ctg, s, e, ref_ctg, ref_s, ref_e, strand=1] ('.'-rows for absent
    loci).  Per locus the contig with the most hits wins (a haplotype
    carries one true copy); the span is [first_hit, last_hit + k).
    Shared oracle glue — not a production replacement for real liftover.
    """
    from ..ops import kmers_np as K

    ref = _read_fasta(ref_fa)
    rows = [line.split()[:3] for line in open(ref_tr_bed)]
    kmer2loci: dict[int, list[int]] = {}
    for li, (c, s, e) in enumerate(rows):
        tr = ref[c][int(s):int(e)].upper()
        kms = K.seq_to_kmers(K.encode_bases(tr), ksize, canonical=True)
        for km in set(kms.tolist()) - {int(K.NAN64)}:
            kmer2loci.setdefault(km, []).append(li)

    # best[li] = (-nhits, scan_idx, ctg, start, end)
    best: dict[int, tuple] = {}
    for scan_idx, (ctg, seq) in enumerate(_read_fasta(asm_fa).items()):
        kms = K.seq_to_kmers(K.encode_bases(seq.upper()), ksize,
                             canonical=True)
        hits: dict[int, list[int]] = {}
        for i, km in enumerate(kms.tolist()):
            for li in kmer2loci.get(km, ()):
                hits.setdefault(li, []).append(i)
        for li, pos in hits.items():
            cand = (-len(pos), scan_idx, ctg, pos[0], pos[-1] + ksize)
            if li not in best or cand < best[li]:
                best[li] = cand

    out = []
    for li, (c, s, e) in enumerate(rows):
        if li in best:
            _, _, ctg, beg, end = best[li]
            out.append((ctg, beg, end, c, int(s), int(e), 1))
        else:
            out.append((".",) * 7)
    return out


def _gen_prune_list(workdir, g, fas, gmap, nloci, ksize, FS, reads,
                    cth, thcth, use_device, device="cuda"):
    """GenRawGenomeGraph's prune branch + EvalRawGenomeGraph
    (GoodPanGenomeGraph.snakefile:241-311): build the genome's raw graph,
    thread its own short reads through it, and emit the k-mers the reads
    never covered (count==0) as the fa2kmers -p prune list."""
    import io as _io
    import sys as _sys

    from ..analysis.linreg import linreg
    from ..index import dbi as _dbi

    raw = os.path.join(workdir, f"{g}.rawPB")
    fa2kmers(raw, fas, k=ksize, fsi=FS, fso=FS, orthomap=gmap,
             nloci=nloci)
    make_tre_kmers_mapped(raw, fas, gmap, nloci, ksize, FS)
    _dbi.serialize(raw)

    # threading-mode self-alignment: danbing-tk -g thcth -cth cth
    from ..apps import cli as _cli

    raw_il = os.path.join(workdir, f"{g}.rawIL")
    is_fq = reads.endswith((".fq", ".fastq"))
    argv = ["align", "-qs", raw, "-g", str(thcth), "-k", str(ksize),
            "-cth", str(cth), "-fq" if is_fq else "-fa", reads,
            "-on", raw_il] + (["--device", "--torch-device", device]
                              if use_device else [])
    old = _sys.stdout
    _sys.stdout = _io.StringIO()
    try:
        _cli.main(argv)
    finally:
        _sys.stdout = old

    # EvalRawGenomeGraph diagnostic (non-gating, R2threshold=-2 == keep all)
    linreg(raw + ".tr.kmers", raw_il + ".tr.kmers",
           os.path.join(workdir, f"{g}.rawLR.pred"), outlier="invalid")

    # awk '$1 ~ />/ || $2 == 0' {g}.rawIL.tr.kmers
    prune_file = os.path.join(workdir, f"{g}.prune.kmers")
    with open(raw_il + ".tr.kmers") as fin, open(prune_file, "w") as out:
        for line in fin:
            fields = line.split()
            if not fields:
                continue
            # numeric compare like the awk filter ('0', '00', '0.0' all
            # prune); header lines pass through
            if line[0] == ">" or (len(fields) > 1
                                  and float(fields[1]) == 0.0):
                out.write(line)
    return prune_file


def make_tre_kmers_mapped(out_pref, fastas, orthomap, nloci, k, fsi):
    """Per-genome TR (k+1)-mers with orthology-mapped loci."""
    from ..apps.fa2kmers import read_fasta_seqs
    from ..ops import kmers_np as K

    tre = [set() for _ in range(nloci)]
    for h, path in enumerate(fastas):
        locus = 0
        for seq in read_fasta_seqs(path):
            while not orthomap[locus][h]:
                locus += 1
            codes = K.encode_bases(seq.upper())
            kms = K.seq_to_kmers(codes, k + 1, canonical=True)
            lo, hi = fsi, len(codes) - fsi - (k + 1) + 1
            for km in kms[lo:hi]:
                if km != K.NAN64:
                    tre[locus].add(int(km))
            locus += 1
    with open(out_pref + ".tre.kmers", "w") as f:
        for li in range(nloci):
            f.write(f">{li}\n")
            for km in sorted(tre[li]):
                f.write(f"{km}\n")
