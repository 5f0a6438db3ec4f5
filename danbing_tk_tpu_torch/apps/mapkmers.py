"""Pan->genome k-mer count mapping: mapkmers equivalent
(reference src/mapkmers.cpp:19-74).

For each pan locus row in the panbed, if the target column maps to a
genome locus, every k-mer of that genome locus gets its count from the pan
DB (0 if absent).  Output is count-only lines in map-iteration order
(writeKmers), reproduced via utils.stdumap.
"""

from __future__ import annotations

from ..utils.stdumap import StdUmapOrder


def _read_db(path: str, count: bool):
    orders, vals = [], []
    cur_o = cur_v = None
    with open(path, "rb") as f:
        for line in f:
            if line.startswith(b">"):
                cur_o = StdUmapOrder()
                cur_v = {}
                orders.append(cur_o)
                vals.append(cur_v)
            else:
                p = line.split()
                km = int(p[0])
                c = int(p[1]) if (count and len(p) > 1) else 0
                cur_o.insert(km)
                cur_v[km] = cur_v.get(km, 0) + c
    return orders, vals


def mapkmers(panbed: str, target_field: int, pankmers: str, kmers: str,
             out_path: str):
    pan_o, pan_v = _read_db(pankmers, count=True)
    g_o, g_v = _read_db(kmers, count=False)
    with open(panbed) as f:
        panlocus = 0
        for line in f:
            cols = line.split()
            v = cols[target_field] if target_field < len(cols) else "."
            if v != ".":
                locus = int(v)
                pv = pan_v[panlocus]
                for km in g_v[locus]:
                    g_v[locus][km] = pv.get(km, 0)
                    # NOTE reference's pankmers[p.first] default-inserts 0
                    # into the pan DB for missing kmers; harmless here
            panlocus += 1
    with open(out_path + ".kmers", "w") as fout:
        for o, v in zip(g_o, g_v):
            for km in o:
                fout.write(f"{v[km]}\n")
