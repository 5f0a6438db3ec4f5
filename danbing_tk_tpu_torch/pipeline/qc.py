"""QC / bait-build harness: the fn1a->fn2a3 loop from the reference's
test/QC/*.sh scripts, orchestrated as one callable pipeline.

Flow (per reference test/QC/fn1a.sim.sh .. fn2a3.bait.map.sh):
  1. simulate error-free PE reads from each haplotype assembly
  2. annotate read origins against the pan TR bed (bedtools-map
     equivalent; locus id or '.' appended to the read title)
  3. extract: align -e 1 pulls reads hitting the RPGG
  4. raw map: align -s 2 scores every extracted read against its
     annotated source locus -> .kam
  5. profile: baitBuilder v1.pf builds per-locus TP/FP kmer-count
     profiles from the kam files
  6. FPSkmer: baitBuilder v2 keeps FP-enriched kmers whose TP count
     distribution is separable -> FPSkmer.v0.tsv
  7. serialize-bt: FPSkmer tsv -> $pan.bt.kmdb
  8. bait map: align -b re-runs the raw map with the bait filter
     removing FP reads

The annotation step is shared glue (also used by tools/make_golden_qc.py
when freezing reference-binary goldens) so oracle comparisons isolate
the align/baitBuilder implementations, not the bed arithmetic.

The bundled mini dataset stores each haplotype as genome *fragments*
named "ctg:beg-end" (or "ctg:beg:end"); read coordinates are translated
by the fragment offset before intersecting the pan bed, which the
production flow (whole-genome fastas, fn1b.annot.sh) does not need.
"""

from __future__ import annotations

import io
import os
import re
import sys

_FRAG_RE = re.compile(r"^(.*?):(\d+)[-:](\d+)$")


def parse_fragment_name(name: str):
    """'ctg:beg-end' / 'ctg:beg:end' -> (ctg, beg); plain name -> (name, 0)."""
    m = _FRAG_RE.match(name)
    if m:
        return m.group(1), int(m.group(2))
    return name, 0


def sanitize(name: str) -> str:
    """Fragment name -> simmode-2-safe title token (':'/'-' would break
    the >CHR:START-END:LOCUS title parse)."""
    return name.replace(":", "_").replace("-", "_")


def derive_tr_bed(pan_tr_kmers: str, fasta: str, ksize: int = 21):
    """Locate each pan locus's TR span within a haplotype assembly by
    scanning for its TR k-mers: {genome_ctg: [(start, end, locus)]} in
    genome coordinates (fragment offsets resolved).

    The production harness annotates reads against the build pipeline's
    pan.tr.mbe.v2.bed (fn1b.annot.sh); the bundled mini fixtures ship an
    RPGG whose source bed is not included, so the span is re-derived
    from the index itself — identical glue for both oracles.

    A haplotype carries exactly one true copy of each locus, but decoy
    regions (the FP source the harness exists to profile) share a
    subset of its TR k-mers; only the contig with the MOST hits for a
    locus is annotated (first by scan order on ties), so decoy-derived
    reads stay '.'-annotated and count as FP downstream.
    """
    from ..io.text import iter_fasta_records
    from ..ops import kmers_np as K

    # inverted kmer->loci index: one pass per contig instead of a
    # per-locus membership scan (same single-pass shape as
    # build.kmer_lift_tmp1)
    kmer2loci: dict[int, list[int]] = {}
    locus = -1
    with open(pan_tr_kmers) as f:
        for line in f:
            if line[0] == ">":
                locus += 1
            else:
                kmer2loci.setdefault(int(line.split()[0]),
                                     []).append(locus)

    # best[locus] = (-nhits, scan_idx, gctg, start, end)
    best: dict[int, tuple[int, int, str, int, int]] = {}
    for scan_idx, (name, seq) in enumerate(iter_fasta_records(fasta)):
        gctg, off = parse_fragment_name(name)
        kms = K.seq_to_kmers(K.encode_bases(seq), ksize, canonical=True)
        hits: dict[int, list[int]] = {}
        for i, km in enumerate(kms.tolist()):
            for li in kmer2loci.get(km, ()):
                hits.setdefault(li, []).append(i)
        for li, pos in hits.items():
            cand = (-len(pos), scan_idx, gctg,
                    off + pos[0], off + pos[-1] + ksize)
            if li not in best or cand < best[li]:
                best[li] = cand

    intervals: dict[str, list[tuple[int, int, int]]] = {}
    for locus, (_, _, gctg, start, end) in best.items():
        intervals.setdefault(gctg, []).append((start, end, locus))
    for v in intervals.values():
        v.sort()
    return intervals


def load_pan_bed_hap(panbed: str, hap: int):
    """Locus intervals of haplotype ``hap`` from pan.tr.mbe.v2.bed:
    {genome_ctg: [(start, end, locus), ...]} (column group 4*hap+3,
    locus = 0-based row index; fn1b.annot.sh awk)."""
    by_ctg: dict[str, list[tuple[int, int, int]]] = {}
    with open(panbed) as f:
        for locus, line in enumerate(f):
            cols = line.split("\t")
            ctg = cols[3 + 4 * hap]
            start = int(cols[4 + 4 * hap])
            end = int(cols[5 + 4 * hap])
            by_ctg.setdefault(ctg, []).append((start, end, locus))
    return by_ctg


def annotate_reads(bed_paths: list[str], intervals, out):
    """bedtools-map equivalent of fn1b.annot.sh: append the
    distinct-sorted locus ids overlapping each read pair (or '.') and
    emit annotated PE fasta titled >CTG:BEG-END:LOCI/{1,2}.

    ``intervals``: {genome_ctg: [(start, end, locus)]} for this
    haplotype — from load_pan_bed_hap (production bed) or derive_tr_bed
    (bundled fragments)."""
    for path in bed_paths:
        with open(path) as f:
            for line in f:
                ctg, beg, end, fwd, rev = line.rstrip("\n").split("\t")
                beg, end = int(beg), int(end)
                gctg, off = parse_fragment_name(ctg)
                hits = sorted({locus for s, e, locus
                               in intervals.get(gctg, ())
                               if off + beg < e and s < off + end})
                annot = ",".join(str(h) for h in hits) if hits else "."
                head = f">{sanitize(ctg)}:{beg}-{end}:{annot}"
                out.write(f"{head}/1\n{fwd}\n{head}/2\n{rev}\n")


def _contig_names(fasta: str):
    with open(fasta) as f:
        return [line[1:].split()[0] for line in f if line[0] == ">"]


def run_qc_harness(input_dir: str, workdir: str, genomes: list[str],
                   ref_genome: str, nloci: int | None = None,
                   ksize: int = 21, cov: int = 15, min_ctg: int = 500,
                   extract_cth: int = 5, map_cth: int = 10,
                   use_device: bool = False, device: str = "cuda"):
    """Run the full QC loop.  ``input_dir`` must hold <g>.<h>.fa for each
    genome plus the pan RPGG (pan.kmers.dbi/.fl.kdb/.tre.kdb/.tr.kmers
    and pan.tr.mbe.v2.bed).  ``ref_genome`` names the negative-control
    genome whose mismapped reads define the FP profile (hs1 in the
    reference harness).  ``use_device`` runs the three align stages on
    the port's device engine on the torch ``device`` (default ``cuda``;
    without a card this raises before any stage runs, unless
    ``device="cpu"``).  Returns a dict of produced paths."""
    if use_device:
        from .._device import resolve_device

        device = str(resolve_device(device))
    from ..apps.baitbuilder import build_profiles, enrichment_filter
    from ..apps.ktools import serialize_bt
    from ..apps.sim_reads import sim_reads

    os.makedirs(workdir, exist_ok=True)
    # link the index into the workdir: stage 7 writes $pan.bt.kmdb next
    # to it and the input dir stays read-only
    pan = os.path.join(workdir, "pan")
    for suf in (".kmers.dbi", ".fl.kdb", ".tre.kdb", ".tr.kmers"):
        src = os.path.join(input_dir, "pan" + suf)
        if os.path.exists(src) and not os.path.exists(pan + suf):
            os.symlink(os.path.abspath(src), pan + suf)
    if nloci is None:
        with open(pan + ".tr.kmers") as f:
            nloci = sum(line[0] == ">" for line in f)
    produced = {}

    # 1+2: simulate + annotate each haplotype (fn1a + fn1b)
    for g in genomes:
        annot_fa = os.path.join(workdir, f"{g}.annot.fa")
        with open(annot_fa, "w") as out:
            for h in (0, 1):
                fa = os.path.join(input_dir, f"{g}.{h}.fa")
                pref = os.path.join(workdir, f"{g}.{h}.reads")
                with open(os.devnull, "w") as devnull:
                    sim_reads(fa, devnull, cov=cov, min_ctg_len=min_ctg,
                              bed=True, out_pref=pref, split=True)
                beds = [f"{pref}.{ctg}.reads.bed"
                        for ctg in _contig_names(fa)
                        if os.path.exists(f"{pref}.{ctg}.reads.bed")]
                intervals = derive_tr_bed(pan + ".tr.kmers", fa, ksize)
                annotate_reads(beds, intervals, out)
        produced[f"{g}.annot.fa"] = annot_fa

    # 3-4: extract then raw map (fn1c + fn2a1), via the align CLI so the
    # engine selection (--device) matches production.  The reference
    # streams both the extract fasta and the kam over stdout; our CLI
    # keeps extract on stdout but writes the kam to <-o pref>.kam.
    def align(extra):
        from ..apps import cli

        argv = ["align", "-qs", pan] + extra \
            + (["--device", "--torch-device", device] if use_device
               else [])
        old = sys.stdout
        sys.stdout = io.StringIO()
        try:
            cli.main(argv)
            return sys.stdout.getvalue()
        finally:
            sys.stdout = old

    for g in genomes:
        extract_fa = os.path.join(workdir, f"{g}.extract.fa")
        with open(extract_fa, "w") as f:
            f.write(align(["-cth", str(extract_cth), "-e", "1",
                           "-fa", produced[f"{g}.annot.fa"]]))
        produced[f"{g}.extract.fa"] = extract_fa
        align(["-cth", str(map_cth), "-c", "40", "-s", "2",
               "-fa", extract_fa,
               "-o", os.path.join(workdir, f"{g}.raw")])
        produced[f"{g}.raw.kam"] = os.path.join(workdir, f"{g}.raw.kam")

    # 5: profiles (fn2a2.build.profile: -tp for every genome; the
    # negative control additionally keeps its FP profile for stage 6)
    for g in genomes:
        build_profiles(produced[f"{g}.raw.kam"], nloci, ksize,
                       os.path.join(workdir, f"profile.{g}"),
                       tp_only=True)
        produced[f"profile.{g}.TP_pf.txt"] = os.path.join(
            workdir, f"profile.{g}.TP_pf.txt")
    build_profiles(produced[f"{ref_genome}.raw.kam"], nloci, ksize,
                   os.path.join(workdir, f"map.{ref_genome}"),
                   tp_only=False)
    for side in ("TP", "FP"):
        produced[f"map.{ref_genome}.{side}_pf.txt"] = os.path.join(
            workdir, f"map.{ref_genome}.{side}_pf.txt")

    # 6: FP-specific kmers (fn2a2.build.FPSkmer)
    fps = os.path.join(workdir, "FPSkmer.v0.tsv")
    enrichment_filter(
        nloci, ksize, fps,
        produced[f"map.{ref_genome}.FP_pf.txt"],
        [produced[f"map.{ref_genome}.TP_pf.txt"]]
        + [produced[f"profile.{g}.TP_pf.txt"] for g in genomes])
    produced["FPSkmer.v0.tsv"] = fps

    # 7: serialize bait next to the index (align loads $pan.bt.kmdb)
    serialize_bt(fps, nloci, pan)
    produced["pan.bt.kmdb"] = pan + ".bt.kmdb"

    # 8: bait map (fn2a3)
    for g in genomes:
        align(["-b", "-cth", str(map_cth), "-c", "40",
               "-s", "2", "-fa", produced[f"{g}.extract.fa"],
               "-o", os.path.join(workdir, f"{g}.bait")])
        produced[f"{g}.bait.kam"] = os.path.join(workdir, f"{g}.bait.kam")
    return produced
