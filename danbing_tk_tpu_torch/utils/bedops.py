"""Minimal interval operations replacing the reference pipeline's bedtools
calls (GoodPanGenomeGraph.snakefile:190-216); bedtools is not available in
this environment and these three semantics are all the build needs:

  bed_map_count   : `bedtools map -c 1 -o count -a A -b B`
                    (count of B intervals overlapping each A interval;
                    both inputs position-sorted per chromosome)
  bed_merge_collapse : `bedtools merge -d D -c 4 -o collapse`
                    (merge sorted intervals within distance D, collapsing
                    the 4th column with commas)
  collision_scan  : the snakefile's per-hap loop producing mbe.m0.loci
                    (groups of locus ids whose expanded regions merge)
"""

from __future__ import annotations


def bed_map_count(a_rows, b_rows):
    """a_rows: [(chrom, s, e, *rest)]; b_rows: [(chrom, s, e)].
    Returns counts aligned with a_rows (overlap = standard half-open)."""
    from collections import defaultdict

    by_chrom = defaultdict(list)
    for c, s, e in b_rows:
        by_chrom[c].append((int(s), int(e)))
    for c in by_chrom:
        by_chrom[c].sort()
    out = []
    for row in a_rows:
        c, s, e = row[0], int(row[1]), int(row[2])
        cnt = 0
        for bs, be in by_chrom.get(c, ()):
            if bs >= e:
                break
            if be > s:
                cnt += 1
        out.append(cnt)
    return out


def bed_merge_collapse(rows, dist: int):
    """rows: sorted [(chrom, s, e, label)]. Returns merged
    [(chrom, s, e, [labels])]; intervals merge when gap <= dist."""
    out = []
    for c, s, e, lab in rows:
        s, e = int(s), int(e)
        if out and out[-1][0] == c and s - out[-1][2] <= dist:
            out[-1][2] = max(out[-1][2], e)
            out[-1][3].append(lab)
        else:
            out.append([c, s, e, [lab]])
    return out


def collision_scan(panbed_rows, nh: int, dist: int):
    """Reproduces the snakefile's mbe.m0.loci generation: per haplotype,
    take (ctg, s, e, v1_locus_ordinal) of non-None entries, sort by
    (ctg, s, e), merge within ``dist``, and report collapsed groups with
    >1 member.

    panbed_rows: pan.tr.mbe.v1.bed rows (list of str columns).
    Returns list of (hap_index, [group lists]) preserving hap order.
    """
    out = []
    for hi in range(nh):
        rows = []
        for ri, cols in enumerate(panbed_rows):
            c, s, e = cols[3 + 4 * hi : 6 + 4 * hi]
            if c == "None" or s == "None" or e == "None":
                continue
            rows.append((c, int(s), int(e), str(ri)))
        rows.sort(key=lambda r: (r[0], r[1], r[2]))
        merged = bed_merge_collapse(rows, dist)
        groups = [m[3] for m in merged if len(m[3]) > 1]
        out.append(groups)
    return out


def write_m0_loci(path: str, gs: list[str], groups_per_hap):
    with open(path, "w") as f:
        hi = 0
        for g in gs:
            for h in (0, 1):
                f.write(f">{g}.{h}\n")
                for grp in groups_per_hap[hi]:
                    f.write(",".join(grp) + "\n")
                hi += 1
