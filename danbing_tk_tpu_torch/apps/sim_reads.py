"""Error-free PE read simulator: sim_reads equivalent
(reference src/sim_reads.cpp).

Fragment FLEN (500), read RLEN (150); forward read = fragment start,
reverse read = RC of fragment end; stride SHFT = 2*RLEN/cov, or uniform
sampling with ``-uni``.  Read names encode the source span
``>ctg:beg-end/1`` which align simmode-2 parses.  Contigs shorter than
min_ctg_len are skipped.

The reference seeds its Mersenne Twister from the OS (irreproducible);
we accept an explicit seed for the uniform mode.
"""

from __future__ import annotations

import numpy as np

_COMP = str.maketrans("ACGTacgtNn", "TGCATGCANN")


def _revcomp_cap(seq: str) -> str:
    return seq.translate(_COMP)[::-1]


def iter_fasta(path: str):
    name, cur = None, []
    with open(path) as f:
        for line in f:
            line = line.rstrip("\n")
            if line.startswith(">"):
                if name is not None:
                    yield name, "".join(cur)
                name = line[1:]
                cur = []
            else:
                cur.append(line)
    if name is not None:
        yield name, "".join(cur)


def sim_reads(fasta: str, out, cov: int = 15, flen: int = 500,
              rlen: int = 150, min_ctg_len: int = 50000,
              uni: bool = False, bed: bool = False, seed: int = 0,
              out_pref: str | None = None, split: bool = False):
    """Writes interleaved PE fasta (or bed rows) to the ``out`` stream;
    with ``out_pref`` (-o) writes <pref>.allctgs.reads.{fa,bed} instead,
    and ``split`` (-split) writes one <pref>.<ctg>.reads.* per contig
    (sim_reads.cpp:152-225)."""
    shft = 2 * rlen // cov
    nbeg = flen - rlen
    rng = np.random.default_rng(seed)
    ext = ".reads.bed" if bed else ".reads.fa"
    if out_pref and not split:
        out = open(out_pref + ".allctgs" + ext, "w")
    for name, ctg in iter_fasta(fasta):
        if len(ctg) < min_ctg_len:
            continue
        if out_pref and split:
            out = open(f"{out_pref}.{name}{ext}", "w")
        ctg_up = ctg.upper()
        if uni:
            nread = (len(ctg) * cov) // (2 * rlen)
            pos = np.sort(rng.integers(0, len(ctg) - flen + 1, nread))
            begs = pos.tolist()
        else:
            begs = range(0, len(ctg) - flen + 1, shft)
        for beg in begs:
            fwd = ctg_up[beg : beg + rlen]
            rev = _revcomp_cap(ctg_up[beg + nbeg : beg + flen])
            if bed:
                out.write(f"{name}\t{beg}\t{beg + flen}\t{fwd}\t{rev}\n")
            else:
                out.write(f">{name}:{beg}-{beg + flen}/1\n{fwd}\n"
                          f">{name}:{beg}-{beg + flen}/2\n{rev}\n")
        if out_pref and split:
            out.close()
    if out_pref and not split:
        out.close()
