"""Reference-genome RPGG build (L6) — the live subset of
pipeline/RefGraph.snakefile as of reference HEAD.

The reference pipeline treats the (haploid) reference genome as a
pseudo-diploid sample — both "haplotypes" symlink the same fasta and the
refTR bed doubles as both tmp1 liftover beds (RefGraph.snakefile:72-98) —
then reuses the joint-annotation machinery:

  1. stage        : tmp1.{0,1}.bed = refTR + dummy annot cols;
                    pan.tr.mbe.v0.bed = refTR + per-hap support 1
  2. MBE          : boundary expansion -> pan.tr.mbe.v1.bed
  3. collision    : merged-region groups -> mbe.m0.loci
  4. mergeMBEbed  : -> pan.tr.mbe.v2.bed + OrthoMap.v2.tsv + locus maps
  5. v0->v2 map   : compose locusMap.v2.to.v1 o v1.to.v0 into
                    locusMap.v0.to.v2.txt ('.' = dropped;
                    RefGraph.snakefile:124-147 GenMap_v0_v2)
  6. TR fasta     : v2 bed hap-0 windows +/- FS, uppercased
                    (RefGraph.snakefile:109-120)
  7. ref kmers    : fa2kmers -g -m locusMap.v0.to.v2.txt over the single
                    TR fasta -> <g>.{tr,fl,graph}.kmers in v0 locus space
                    (RefGraph.snakefile:149-171 GenRefGraph)
  8. serialize    : (extension) <g>.kmers.dbi/.fl.kdb so the graph is
                    directly consumable by the align engine

NOTE: the downstream rules (GenPanGraph / GenotypeSamples / EvalRefGraph,
RefGraph.snakefile:175-268) are bit-rotted at reference HEAD — GenPanGraph
reads `input.TRbed` which is not declared as an input (:176-177 commented
out), and `rule all` only requires the MBE sentinel + ref kmers (:33-44) —
so steps 1-7 above are the complete live behavior.
"""

from __future__ import annotations

import os

import numpy as np

from ..apps.fa2kmers import fa2kmers
from ..apps.mbe import run_mbe
from ..apps.merge_mbe import write_bed_merge_mbe
from ..apps.select_regions import select_regions
from ..index import dbi as dbi_mod
from ..utils.bedops import collision_scan, write_m0_loci
from .build import _step


def build_ref_rpgg(workdir: str, ref_fa: str, ref_tr_bed: str,
                   g: str = "hg38", ksize: int = 21, FS: int = 700,
                   TRWINDOW: int = 100000, dist_merge: int = 700,
                   th1: float = 0.1, th2: float = 0.8, nproc: int = 1,
                   serialize: bool = True, force: bool = False) -> str:
    """Builds <workdir>/<g>.{tr,fl,graph}.kmers (+ index); returns the
    <workdir>/<g> prefix."""
    os.makedirs(os.path.join(workdir, g), exist_ok=True)
    indir = os.path.join(workdir, "input")
    os.makedirs(indir, exist_ok=True)

    def stage():
        for h in (0, 1):
            lnk = os.path.join(indir, f"{g}.{h}.fa")
            if not os.path.exists(lnk):
                os.symlink(os.path.abspath(ref_fa), lnk)
        rows = [line.split("\t")[:3] for line in
                open(ref_tr_bed).read().splitlines()]
        # strand col "1" = the live scripts' no-inversion flag.  The
        # reference stages "+" here (RefGraph.snakefile:84) but its own
        # mergeMBEbed.py does int() on the field (mergeMBEbed.py:79), and
        # the writeMBEbed.py/preMBE.py scripts this rule invokes don't
        # exist at HEAD — the rule is bit-rotted, so we follow the live
        # pan-pipeline convention instead.
        for h in (0, 1):
            with open(os.path.join(workdir, g, f"tmp1.{h}.bed"),
                      "w") as f:
                for r in rows:
                    f.write("\t".join(r) + "\t.\t.\t.\t1\n")
        with open(os.path.join(workdir, "pan.tr.mbe.v0.bed"), "w") as f:
            for r in rows:
                f.write("\t".join(r) + "\t1\t1\n")

    _step(workdir, "stage", stage, force)
    _step(workdir, "mbe", lambda: run_mbe(
        workdir, indir, [g], ksize, FS, TRWINDOW, th1, th2,
        ignore_case=True, nproc=nproc), force)

    def collide():
        rows = [line.split("\t") for line in
                open(os.path.join(workdir, "pan.tr.mbe.v1.bed"))
                .read().splitlines()]
        groups = collision_scan(rows, 2, dist_merge)
        write_m0_loci(os.path.join(workdir, "mbe.m0.loci"), [g], groups)

    _step(workdir, "collision", collide, force)
    _step(workdir, "merge", lambda: write_bed_merge_mbe(
        workdir, 1, th2), force)

    def map_v0_v2():
        nloci = sum(1 for _ in open(os.path.join(
            workdir, "pan.tr.mbe.v0.bed")))
        m21 = np.loadtxt(os.path.join(workdir, "locusMap.v2.to.v1.txt"),
                         dtype=int, ndmin=1)
        m10 = np.loadtxt(os.path.join(workdir, "locusMap.v1.to.v0.txt"),
                         dtype=int, ndmin=1)
        m02 = np.full(nloci, ".", dtype=object)
        m02[m10[m21]] = np.arange(m21.size)
        np.savetxt(os.path.join(workdir, "locusMap.v0.to.v2.txt"), m02,
                   fmt="%s")

    _step(workdir, "map_v0_v2", map_v0_v2, force)

    def trfa():
        v2 = [line.split("\t") for line in
              open(os.path.join(workdir, "pan.tr.mbe.v2.bed"))
              .read().splitlines()]
        bed = os.path.join(workdir, f"{g}.tr.bed")
        with open(bed, "w") as f:
            for cols in v2:
                c, s, e = cols[3:6]
                if c == "None":
                    continue
                f.write(f"{c}\t{int(s) - FS}\t{int(e) + FS}\n")
        out = os.path.join(workdir, f"{g}.tr.fasta")
        select_regions(bed, os.path.join(indir, f"{g}.0.fa"), out)
        # reference pipes through awk toupper (RefGraph.snakefile:118)
        txt = open(out).read()
        with open(out, "w") as f:
            for line in txt.splitlines():
                f.write(line if line.startswith(">") else line.upper())
                f.write("\n")

    _step(workdir, "trfa", trfa, force)

    def ref_kmers():
        from .build import make_tre_kmers_mapped

        m02 = [line.strip() for line in
               open(os.path.join(workdir, "locusMap.v0.to.v2.txt"))]
        omap = [[x != "."] for x in m02]
        trfa_path = os.path.join(workdir, f"{g}.tr.fasta")
        fa2kmers(os.path.join(workdir, g), [trfa_path], k=ksize,
                 fsi=FS, fso=FS, orthomap=omap, nloci=len(omap))
        make_tre_kmers_mapped(os.path.join(workdir, g), [trfa_path],
                              omap, len(omap), ksize, FS)

    _step(workdir, "ref_kmers", ref_kmers, force)
    if serialize:
        _step(workdir, "serialize", lambda: dbi_mod.serialize(
            os.path.join(workdir, g)), force)
    return os.path.join(workdir, g)
