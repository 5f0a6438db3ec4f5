"""Native LiftTR: lift refTR regions onto assembly haplotypes through
minimap2 PAF alignments, replacing the reference pipeline's external
`paftools.js liftover` + bedtools/awk glue
(GoodPanGenomeGraph.snakefile:93-150).  With this, the only external
tool the build pipeline needs is minimap2 itself (`minimap2 {asm} {ref}
-x asm5 -c --cs=long`, MapRef2Asm :55-89).

Spec-level port of `paftools.js liftover` (no oracle in this image):
per PAF record passing the mapq / alignment-length / divergence gates,
each overlapping bed region is clipped to the record's query span and
its endpoints walked through the cigar to target coordinates; endpoints
landing inside indels clamp to the nearest aligned base.  Output rows
are `tname  s  e  {qname}_{rs}_{re}  div  strand` — the 6-column shape
`script/liftbed.clean.py` consumes (f1..f4,f6; the region name keeps the
ORIGINAL bed coords so split lifts regroup downstream).

`liftover_min_len` is required by the snakefile but absent from the
bundled goodPanGenomeGraph.json (config drift); paftools' own `-l`
default (50000) is used here.
"""

from __future__ import annotations

import os
import re

from ..apps.liftbed_clean import liftbed_clean

_CG_RE = re.compile(r"(\d+)([MIDNSHP=X])")


def iter_paf(path: str):
    """Yields minimal PAF records (dict) that carry a cg: tag."""
    with open(path) as f:
        for line in f:
            c = line.rstrip("\n").split("\t")
            if len(c) < 12:
                continue
            rec = dict(qname=c[0], qs=int(c[2]), qe=int(c[3]),
                       strand=c[4], tname=c[5], ts=int(c[7]),
                       te=int(c[8]), mlen=int(c[9]), blen=int(c[10]),
                       mapq=int(c[11]), cg=None, div=None)
            for tag in c[12:]:
                if tag.startswith("cg:Z:"):
                    rec["cg"] = tag[5:]
                elif tag.startswith("de:f:"):
                    rec["div"] = float(tag[5:])
                elif tag.startswith("dv:f:") and rec["div"] is None:
                    rec["div"] = float(tag[5:])
            if rec["cg"]:
                yield rec


def cigar_blocks(rec) -> list[tuple[int, int, int]]:
    """Aligned blocks as (qlo, qhi, tlo); for '-' strand the query runs
    backwards, i.e. query position q in [qlo,qhi) maps to target
    tlo + (qhi - 1 - q)."""
    minus = rec["strand"] == "-"
    q = rec["qe"] if minus else rec["qs"]
    t = rec["ts"]
    out = []
    for m in _CG_RE.finditer(rec["cg"]):
        ln, op = int(m.group(1)), m.group(2)
        if op in "M=X":
            if minus:
                out.append((q - ln, q, t))
                q -= ln
            else:
                out.append((q, q + ln, t))
                q += ln
            t += ln
        elif op == "I":                    # consumes query only
            q = q - ln if minus else q + ln
        elif op in "DN":                   # consumes target only
            t += ln
    return out


def lift_region(rec, blocks, rs: int, re_: int):
    """Target span covering the aligned part of query interval
    [rs,re_) under this record, or None if none of it aligns."""
    a, b = max(rs, rec["qs"]), min(re_, rec["qe"])
    if a >= b:
        return None
    lo = hi = None
    minus = rec["strand"] == "-"
    for qlo, qhi, tlo in blocks:
        oa, ob = max(a, qlo), min(b, qhi)
        if oa >= ob:
            continue
        if minus:
            tl, th = tlo + (qhi - ob), tlo + (qhi - oa)
        else:
            tl, th = tlo + (oa - qlo), tlo + (ob - qlo)
        lo = tl if lo is None else min(lo, tl)
        hi = th if hi is None else max(hi, th)
    return None if lo is None else (lo, hi)


def paf_liftover(paf_path: str, bed_rows, min_len: int = 50_000,
                 min_mapq: int = 5, max_div: float = 1.0):
    """bed_rows: [(qname, start, end)] on the PAF's query side.
    Returns lifted 6-col rows sorted like `sort -k1,1 -k2,2n -k3,3n`."""
    by_q: dict[str, list[tuple[int, int]]] = {}
    for c, s, e in bed_rows:
        by_q.setdefault(c, []).append((int(s), int(e)))
    for v in by_q.values():
        v.sort()
    out = []
    for rec in iter_paf(paf_path):
        if rec["mapq"] < min_mapq or rec["blen"] < min_len:
            continue
        if rec["div"] is not None and rec["div"] > max_div:
            continue
        regions = by_q.get(rec["qname"])
        if not regions:
            continue
        blocks = None
        for rs, re_ in regions:
            if re_ <= rec["qs"]:
                continue
            if rs >= rec["qe"]:
                break
            if blocks is None:
                blocks = cigar_blocks(rec)
            span = lift_region(rec, blocks, rs, re_)
            if span is None:
                continue
            div = f"{rec['div']:.4f}" if rec["div"] is not None else "."
            out.append((rec["tname"], span[0], span[1],
                        f"{rec['qname']}_{rs}_{re_}", div,
                        rec["strand"]))
    out.sort(key=lambda r: (r[0], r[1], r[2]))
    return out


def _merge_singletons(rows):
    """`bedtools merge -c 1,4,5,6,7 -o count,collapse,... | awk '$4==1'
    | cut -f 1-3,5-8` on cleaned 7-col rows (asm s e chrom rs re strand):
    drop any cleaned region whose asm interval overlaps/touches
    another's (merge is book-ended by default)."""
    rows = sorted(rows, key=lambda r: (r[0], int(r[1]), int(r[2])))
    out, group, cur_hi = [], [], 0
    for r in rows:
        if group and r[0] == group[-1][0] and int(r[1]) <= cur_hi:
            group.append(r)
            cur_hi = max(cur_hi, int(r[2]))
            continue
        if len(group) == 1:
            out.append(group[0])
        group = [r]
        cur_hi = int(r[2])
    if len(group) == 1:
        out.append(group[0])
    return out


def lift_tr(paf_paths: list[str], ref_tr_bed: str, out_dir: str,
            min_len: int = 50_000):
    """The full LiftTR rule for one genome: per-hap PAF -> liftover ->
    liftbed.clean -> singleton merge -> join back onto refTR order ->
    tmp1.{hap}.bed (asm s e chrom rs re strand, '.'-rows when a hap
    misses the region or maps ambiguously)."""
    os.makedirs(out_dir, exist_ok=True)
    ref = [tuple(line.split()[:3]) for line in open(ref_tr_bed)]
    per_hap = []
    for paf in paf_paths:
        lifted = paf_liftover(paf, ref, min_len=min_len)
        import io

        buf = io.StringIO()
        liftbed_clean(lifted, buf)
        cleaned = [line.split("\t") for line in
                   buf.getvalue().splitlines()]
        per_hap.append({(c, rs, re_): (asm, s, e, st)
                        for asm, s, e, c, rs, re_, st in
                        _merge_singletons(cleaned)})
    # regions lifted in NEITHER hap are dropped from tmp1 outright
    # ('awk ($4!="." || $6!=".")'); a hap that misses a surviving region
    # gets a '.'-row.  (Deviation noted: overlapping refTR input rows
    # would comma-collapse under `bedtools map` and be dropped; this
    # exact-key join treats them independently.)
    paths = [os.path.join(out_dir, f"tmp1.{h}.bed")
             for h in range(len(per_hap))]
    files = [open(p, "w") for p in paths]
    for key in ref:
        hits = [amap.get(tuple(map(str, key))) for amap in per_hap]
        if not any(hits):
            continue
        for f, hit in zip(files, hits):
            if hit:
                asm, s, e, st = hit
                f.write(f"{asm}\t{s}\t{e}\t{key[0]}\t{key[1]}\t"
                        f"{key[2]}\t{st}\n")
            else:
                f.write(f".\t.\t.\t{key[0]}\t{key[1]}\t{key[2]}\t.\n")
    for f in files:
        f.close()
    return paths
