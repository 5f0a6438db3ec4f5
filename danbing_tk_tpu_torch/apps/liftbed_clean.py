"""Liftover bed cleanup (capability of reference script/liftbed.clean.py;
behavior matched via golden tests, structure re-derived).

paftools liftover splits one reference TR region into several assembly
segments.  This stitches them back together and QCs the mapping:

  * segments of one region landing on ONE assembly contig are merged when
    they overlap or sit within a 10 kb gap; anything else (multi-contig,
    far-apart) invalidates the region
  * each assembly contig gets a majority-vote chromosome (>= 60% of its
    regions); regions lifted to an off-major chromosome are dropped
  * surviving rows carry a strand-consistency tag: +1/-1 when every
    merged segment agreed on strand, 0 on mixed strands
"""

from __future__ import annotations

from dataclasses import dataclass, field


MERGE_GAP = 10_000
MAJORITY = 0.6


@dataclass
class _LiftGroup:
    """Merged liftover hull of one reference region on one contig."""
    contig: str
    lo: int
    hi: int
    strands: list = field(default_factory=list)
    alive: bool = True

    def absorb(self, contig: str, lo: int, hi: int, strand: str):
        if not self.alive:
            return
        if contig != self.contig:
            self.alive = False
            return
        if lo - self.hi <= 0 and hi - self.lo >= 0:   # overlap: take hull
            self.lo = min(self.lo, lo)
            self.hi = max(self.hi, hi)
        elif 0 < lo - self.hi < MERGE_GAP:            # short gap rightward
            self.hi = hi
        elif 0 < self.lo - hi < MERGE_GAP:            # short gap leftward
            self.lo = lo
        else:
            self.alive = False
            return
        self.strands.append(strand)


def _region_key(name: str) -> str:
    """Reference region id: first three '_'-fields of the bed name
    (chrom_start_end)."""
    return "_".join(name.split("_")[:3])


def _chrom_of(name: str) -> str:
    """Chromosome of the region id, 'chr' prefix stripped."""
    return name.split("_")[0][3:]


def liftbed_clean(rows, out):
    """rows: [(ctg, s, e, name, score, strand)] in sorted liftbed order;
    writes cleaned rows to the ``out`` stream."""
    groups: dict[str, _LiftGroup] = {}
    for contig, lo, hi, name, _, strand in rows:
        key = _region_key(name)
        lo, hi = int(lo), int(hi)
        g = groups.get(key)
        if g is None:
            groups[key] = _LiftGroup(contig, lo, hi, [strand])
        else:
            g.absorb(contig, lo, hi, strand)

    # majority chromosome per assembly contig (over ALL lifted rows);
    # ties resolve to the first maximum in row order
    votes: dict[str, dict[str, int]] = {}
    for contig, _, _, name, _, _ in rows:
        per = votes.setdefault(contig, {})
        ch = _chrom_of(name)
        per[ch] = per.get(ch, 0) + 1
    major = {}
    for contig, per in votes.items():
        total = sum(per.values())
        best_ch, best = None, 0
        for ch, n in per.items():
            if n > best:
                best_ch, best = ch, n
        if best / total >= MAJORITY:
            major[contig] = best_ch

    sign = {"+": 1, "-": -1}
    for key, g in groups.items():
        if not (g.alive and major.get(g.contig) == key.split("_")[0][3:]):
            continue
        consistent = all(s == g.strands[0] for s in g.strands)
        tag = int(consistent) * sign[g.strands[0]]
        fields = "\t".join(key.split("_"))
        out.write(f"{g.contig}\t{g.lo}\t{g.hi}\t{fields}\t{tag}\n")
