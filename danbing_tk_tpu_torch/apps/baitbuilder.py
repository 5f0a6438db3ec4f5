"""Bait (FP-specific k-mer) construction: baitBuilder equivalent
(reference src/bait.cpp).

v1.pf : from a simmode .kam, build per-locus k-mer count *profiles* of
        TP (src==dst) vs FP (src!=dst) read pairs; each read contributes
        one count per k-mer it contains (bait.cpp:318-412).
v2    : enrichment-test FP profiles against TP profiles: a k-mer whose FP
        mean lies within TP.mean +/- 2*TP.sd is dropped; survivors get the
        allowed [mi,ma] = TP count range (255/0 if never seen in TP)
        (testAndFilter bait.cpp:194-220).

Float comparisons use float32 to match the reference's `float` fields.
Output iterates hash-map order (utils.stdumap) for byte-exactness.
"""

from __future__ import annotations

import numpy as np

from ..ops import kmers_np as K
from ..utils.stdumap import StdUmapOrder


def _read_kcp(seq: str, ksize: int):
    """Per-read canonical k-mer counts (u8 wrap), iterated in the temp
    hash-map's order (read2kcp walks its kc_t map, bait.cpp:76-81)."""
    counter = {}
    K.count_kmers(counter, seq, ksize, 0, 0, True)
    order = StdUmapOrder()
    for km in counter:
        order.insert(km)
    return {km: counter[km] & 0xFF for km in order}


class _Profile:
    __slots__ = ("order", "val")

    def __init__(self):
        self.order = StdUmapOrder()
        self.val = {}

    def add_read(self, kc: dict):
        for km, c in kc.items():
            self.order.insert(km)
            self.val.setdefault(km, []).append(c)


def parse_kam_row(line: str):
    """Returns (src, dst, as2, as1, name, seq2, seq1) from a kam row."""
    f = line.split()
    return (int(f[0]) if f[0] != "." else -1, int(f[1]), f[8], f[9], f[10],
            f[11], f[13])


def build_profiles(kam_path: str, nloci: int, ksize: int, out_pref: str,
                   tp_only: bool = False):
    """v1.pf: writes <out_pref>.TP_pf.txt [+ .FP_pf.txt]."""
    tp = {}
    fp = {}
    with open(kam_path) as f:
        for line in f:
            src, dst, _, _, _, seq2, seq1 = parse_kam_row(line)
            if dst == nloci:
                continue
            if src == dst:
                prof = tp.setdefault(dst, _Profile())
            else:
                if tp_only:
                    continue
                prof = fp.setdefault(dst, _Profile())
            prof.add_read(_read_kcp(seq2, ksize))
            prof.add_read(_read_kcp(seq1, ksize))
    _write_profiles(out_pref + ".TP_pf.txt", tp, nloci)
    if not tp_only:
        _write_profiles(out_pref + ".FP_pf.txt", fp, nloci)


def _write_profiles(path: str, db: dict, nloci: int):
    with open(path, "w") as f:
        for i in range(nloci):
            prof = db.get(i)
            if prof is None:
                continue
            f.write(f">{i}\n")
            for km in prof.order:
                v = np.asarray(prof.val[km], dtype=np.float64)
                mi, ma = int(v.min()), int(v.max())
                mn = v.mean()
                sd = np.sqrt(((v - mn) ** 2).mean())
                f.write(f"{km}\t{mi}\t{ma}\t{mn:.4f}\t{sd:.4f}\n")


def _read_profile_file(path: str):
    """-> dict locus -> list[(km, mi, ma, mn, sd)] in file order."""
    out = {}
    cur = None
    with open(path) as f:
        for line in f:
            if line.startswith(">"):
                cur = []
                out[int(line[1:])] = cur
            else:
                p = line.split()
                cur.append((int(p[0]), int(p[1]), int(p[2]),
                            np.float32(p[3]), np.float32(p[4])))
    return out


def enrichment_filter(nloci: int, ksize: int, out_path: str, fp_path: str,
                      tp_paths: list[str]):
    """v2: writes FPSkmer rows ">locus / km mi ma" for FP-enriched k-mers."""
    tps = [_read_profile_file(p) for p in tp_paths]
    fp = _read_profile_file(fp_path)
    f2 = np.float32(2)
    # one k2s container reused across loci: its clear() keeps the grown
    # bucket count, so iteration order differs from a fresh map's
    order = StdUmapOrder()
    with open(out_path, "w") as fout:
        for tri in fp.keys():  # insertion order == FP_pf file order
            order.clear()
            stat = {}
            for km, mi, ma, mn, sd in fp[tri]:
                order.insert(km)
                stat[km] = [255, 0, mn]
            for tp in tps:
                rows = tp.get(tri)
                if rows is None:
                    continue
                # k2s_TP keyed per TP file; iterate rows present in stat
                for km, mi, ma, mn, sd in rows:
                    if km not in stat:
                        continue
                    FP = stat[km]
                    fsd = f2 * sd
                    if mn - fsd <= FP[2] and FP[2] <= mn + fsd:
                        order.erase(km)
                        del stat[km]
                    else:
                        if FP[0] != 255:
                            FP[0] = min(mi, FP[0])
                            FP[1] = max(ma, FP[1])
                        else:
                            FP[0] = mi
                            FP[1] = ma
            fout.write(f">{tri}\n")
            for km in order:
                FP = stat[km]
                fout.write(f"{km}\t{FP[0]}\t{FP[1]}\n")
