"""Pan-genome k-mer DB merge: genPanKmers equivalent
(reference src/genPanKmers.cpp:72-169).

Merges per-genome {tr, fl, graph, tre}.kmers into pan DBs.  Counts add;
graph edge masks OR in the no-missing path.  NOTE: with an orthology map
the reference routes graph files through mapKmersFile2DB with the ``count``
flag in the ``graph`` parameter position (genPanKmers.cpp:144), so masks
are *added* (possible u8 wrap) instead of OR'd -- replicated verbatim for
byte-exactness and flagged here as reference-drift.

Output order reproduces writeKmersWithName's map iteration order.
"""

from __future__ import annotations

from ..utils.stdumap import StdUmapOrder


class _OC:
    __slots__ = ("order", "val")

    def __init__(self):
        self.order = StdUmapOrder()
        self.val = {}


def _read_into(dbs, path, gmap=None, graph_or=False, graph_add=False):
    """readKmersFile2DB / mapKmersFile2DB equivalent over a ">locus" file."""
    idx = -1
    first = True
    with open(path, "rb") as f:
        for line in f:
            if line.startswith(b">"):
                idx += 1
                if gmap is not None:
                    while not gmap[idx]:
                        idx += 1
                first = False
            else:
                if first:
                    continue
                km, c = (int(x) for x in line.split()[:2])
                db = dbs[idx]
                db.order.insert(km)
                if graph_or:
                    db.val[km] = db.val.get(km, 0) | c
                elif graph_add:
                    db.val[km] = (db.val.get(km, 0) + c) & 0xFF  # u8 wrap
                else:
                    db.val[km] = db.val.get(km, 0) + c
    return dbs


def read_ortho_map(path: str, nhap: int):
    omap = []
    with open(path) as f:
        for line in f:
            cols = line.split()
            omap.append([cols[i] != "." for i in range(nhap)])
    return omap


def gen_pan_kmers(out_pref: str, kmer_prefs: list[str],
                  ortho_map: str | None = None, tr_only: bool = False,
                  tre_only: bool = False, nloci: int | None = None):
    """Merge genome DBs <pref>.{tr,fl,graph,tre}.kmers -> <out_pref>.*.

    ortho_map: path to OrthoMap (2 haplotype columns per genome) or None
    for the no-missing case ('-' in the reference CLI).
    """
    ngenome = len(kmer_prefs)
    omap = None
    if ortho_map is not None:
        omap = read_ortho_map(ortho_map, 2 * ngenome)
        nloci = len(omap)
    elif nloci is None:
        from ..io.text import count_loci

        nloci = count_loci(kmer_prefs[0] + ".tr.kmers")

    for ftype in ["tr", "fl", "graph", "tre"]:
        if tr_only and ftype != "tr":
            continue
        if tre_only and ftype != "tre":
            continue
        graphmode = ftype == "graph"
        dbs = [_OC() for _ in range(nloci)]
        import os

        missing = [p for p in kmer_prefs
                   if not os.path.exists(p + f".{ftype}.kmers")]
        if missing:
            if ftype == "tre":  # optional input, as at reference HEAD
                continue
            raise FileNotFoundError(missing[0] + f".{ftype}.kmers")
        if ftype == "tre":
            # DEVIATION: the reference's tre merge mis-parses count-less
            # .tre.kmers (getline with '\t' delimiter swallows the file,
            # genPanKmers.cpp:127-164 via readKmersFile2DB) and emits
            # garbage; we do the intended set-union instead.
            sets = [set() for _ in range(nloci)]
            for pref in kmer_prefs:
                idx = -1
                with open(pref + ".tre.kmers", "rb") as f:
                    for line in f:
                        if line.startswith(b">"):
                            idx += 1
                        else:
                            sets[idx].add(int(line.split()[0]))
            with open(out_pref + ".tre.kmers", "w") as f:
                for i, s in enumerate(sets):
                    f.write(f">{i}\n")
                    for km in sorted(s):
                        f.write(f"{km}\n")
            continue
        for gi, pref in enumerate(kmer_prefs):
            path = pref + f".{ftype}.kmers"
            if omap is not None:
                gmap = [omap[i][2 * gi] or omap[i][2 * gi + 1]
                        for i in range(nloci)]
                _read_into(dbs, path, gmap,
                           graph_add=graphmode)  # reference-drift: += masks
            else:
                _read_into(dbs, path, None, graph_or=graphmode)
        with open(out_pref + f".{ftype}.kmers", "w") as f:
            for i, db in enumerate(dbs):
                f.write(f">{i}\n")
                for km in db.order:
                    f.write(f"{km}\t{db.val[km]}\n")
