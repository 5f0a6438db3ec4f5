"""Merge colliding MBE loci: mergeMBEbed.py equivalent (reference
script/mergeMBEbed.py).

Consumes mbe.m0.loci (per-hap groups of v1 loci whose expanded regions
merge -- produced by utils.bedops.collision_scan, replacing the
snakefile's bedtools merge) and pan.tr.mbe.v1.bed; emits pan.tr.mbe.v2.bed
(merged boundaries), OrthoMap.v2.tsv (locus <-> hap ordinal map consumed
by fa2kmers -m / genPanKmers) and locusMap.v2.to.v1.txt.

QC drops: non-contiguous merge groups, cross-contig merges (hap removed),
SV > MAXSVLEN, hap support below THRESH (writeBed_MergeMBE
mergeMBEbed.py:87-156).
"""

from __future__ import annotations

import os

import numpy as np


def parse_merge_set(path: str):
    """Parse mbe.m0.loci collision groups into merge sets + a blacklist.

    Each input line lists v1 loci whose expanded regions collided within
    one haplotype; groups chain transitively across lines (lines sharing
    members union into one set, lowest set id wins).  QC rules, matched
    to the reference byte-for-byte:
      * a NON-CONTIGUOUS group blacklists every member, and any existing
        set a member belonged to is dissolved with ALL its loci banned;
      * a group touching an already-banned locus is banned wholesale —
        its members' old sets are dissolved WITHOUT banning bystander
        members (reference behavior, preserved for compatibility).
    Returns (surviving merge sets, blacklist).
    """
    sets: list[set | None] = []
    owner: dict[int, int] = {}        # locus -> index into sets
    banned: set[int] = set()

    with open(path) as fh:
        for line in fh:
            if line.startswith(">"):
                continue
            group = sorted(int(x) for x in line.rstrip().split(","))
            contiguous = all(b == a + 1 for a, b in zip(group, group[1:]))
            if not contiguous:
                for locus in group:
                    gi = owner.pop(locus, None)
                    if gi is not None and sets[gi] is not None:
                        banned.update(sets[gi])
                        sets[gi] = None
                    banned.add(locus)
                continue
            if any(locus in banned for locus in group):
                for locus in group:
                    banned.add(locus)
                    gi = owner.pop(locus, None)
                    if gi is not None:
                        sets[gi] = None
                continue
            touching = sorted({owner[x] for x in group if x in owner})
            if not touching:
                sets.append(set(group))
                for locus in group:
                    owner[locus] = len(sets) - 1
            else:
                root = touching[0]
                for gi in touching[1:]:
                    sets[root] |= sets[gi]
                    for locus in sets[gi]:
                        owner[locus] = root
                    sets[gi] = None
                sets[root] |= set(group)
                for locus in group:
                    owner[locus] = root

    alive = [s for s in sets if s is not None]
    for s in alive:
        assert not (s & banned)
    return alive, banned


def _getdist(bed):
    out = []
    if int(bed[0, 2]) == 1:  # no inversion marker in strand col? (ref uses
        # panbed[...,6+hi*4] ordering columns [s,e,strandflag])
        for i in range(bed.shape[0] - 1):
            out.append(int(bed[i + 1, 0]) - int(bed[i, 1]))
    else:
        for i in range(bed.shape[0] - 1):
            out.append(int(bed[i, 0]) - int(bed[i + 1, 1]))
    return out


def write_bed_merge_mbe(workdir: str, ng: int, thresh: float,
                        maxsvlen: int = 10000):
    ms, bs = parse_merge_set(os.path.join(workdir, "mbe.m0.loci"))
    panbed = np.loadtxt(os.path.join(workdir, "pan.tr.mbe.v1.bed"),
                        dtype=object, ndmin=2, comments=None)
    i1togood = {}
    qcb = []
    for i1s_ in ms:
        i1s = sorted(i1s_)
        nm = len(i1s) - 1
        dist = np.full([nm, 2 * ng], np.nan)
        for hi in range(2 * ng):
            if np.all(panbed[i1s, 3 + hi * 4] != "None"):
                if np.any(panbed[i1s, 3 + hi * 4]
                          != panbed[i1s[0], 3 + hi * 4]):
                    pass  # hap removed: merging across contigs
                else:
                    dist[:, hi] = _getdist(
                        panbed[i1s, 4 + hi * 4 : 7 + hi * 4])
        good = np.all(np.isfinite(dist), axis=0)
        with np.errstate(all="ignore"):
            import warnings

            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                mx = np.nanmax(dist) if dist.size else np.nan
        if mx > maxsvlen:
            qcb.append(i1s_)
        elif good.sum() / (2 * ng) < thresh:
            qcb.append(i1s_)
        else:
            i1togood[i1s[0]] = good
    for i1s_ in qcb:
        ms.remove(i1s_)
        for i1 in i1s_:
            bs.add(i1)
    nmi = 0
    mis = set()
    for i1s_ in ms:
        nmi += len(i1s_)
        mis |= i1s_

    nloci1 = panbed.shape[0]
    i2toi1 = (set(range(nloci1)) - mis - bs) | {
        sorted(i1s_)[0] for i1s_ in ms}
    i2toi1 = sorted(i2toi1)
    nloci2 = len(i2toi1)
    assert nloci2 == nloci1 - nmi + len(ms) - len(bs)
    i1toi2 = np.full(nloci1, None, dtype=object)
    i1toi2[i2toi1] = np.arange(nloci2)
    pv2bed = panbed[i2toi1]
    for i1s_ in ms:
        i1s = sorted(i1s_)
        i2 = i1toi2[i1s[0]]
        ids, ide = i1s[0], i1s[-1] + 1
        refs = min(int(s) for s in panbed[ids:ide, 1])
        refe = max(int(e) for e in panbed[ids:ide, 2])
        pv2bed[i2, [1, 2]] = [refs, refe]
        for hi in range(2 * ng):
            if not i1togood[i1s[0]][hi]:
                pv2bed[i2, 3 + hi * 4 : 7 + hi * 4] = ["None"] * 4
                continue
            asms = min(int(s) for s in panbed[ids:ide, 4 + hi * 4])
            asme = max(int(e) for e in panbed[ids:ide, 5 + hi * 4])
            pv2bed[i2, 4 + hi * 4 : 6 + hi * 4] = [asms, asme]
    np.savetxt(os.path.join(workdir, "pan.tr.mbe.v2.bed"), pv2bed,
               delimiter="\t", fmt="%s")

    lmap = np.full([nloci2, 2 * ng], ".", dtype=object)
    for hi in range(2 * ng):
        m = pv2bed[:, 3 + 4 * hi] != "None"
        lmap[m, hi] = np.arange(m.sum())
    np.savetxt(os.path.join(workdir, "OrthoMap.v2.tsv"), lmap,
               delimiter="\t", fmt="%s")
    np.savetxt(os.path.join(workdir, "locusMap.v2.to.v1.txt"), i2toi1,
               fmt="%s")
