"""RPGG per-genome build: fa2kmers equivalent (reference src/fa2kmers.cpp).

Given per-haplotype FASTAs of TR alleles (one record per locus, TR flanked
by ``fsi`` bases each side), counts canonical TR k-mers, flank-window
k-mers, and the bidirectional dBG edge masks, and writes the
.tr/.fl/.graph.kmers outputs.  Window semantics (fa2kmers.cpp:148-158):

  TR   : buildNuKmers(read, k, leftflank=fsi, rightflank=fsi)
  FL-L : leftflank=fsi-fso,             rightflank=len-fsi-(k-1)
  FL-R : leftflank=len-fsi-(k-1),       rightflank=fsi-fso
  graph: whole read, fwd + RC, no self loops

Output order reproduces the reference byte-for-byte: per-locus hash-map
iteration order via utils.stdumap over the first-occurrence insertion
sequence.

Also provides the ``.tre.kmers`` producer (TR-region (k+1)-mers) that the
serialized RPGG needs; the reference repo has no in-tree producer for it
(pipeline drift, SURVEY.md §2.1/§3.1) so the format here follows what
``ktools serialize``/align consume.
"""

from __future__ import annotations

import numpy as np

from ..ops import kmers_np as K
from ..utils.stdumap import StdUmapOrder


def read_fasta_seqs(path: str) -> list[str]:
    seqs, cur = [], []
    with open(path) as f:
        for line in f:
            if line.startswith(">"):
                if cur:
                    seqs.append("".join(cur))
                    cur = []
            else:
                cur.append(line.strip())
    if cur:
        seqs.append("".join(cur))
    return seqs


class _OrderedCounter:
    """Counts with libstdc++-iteration-order replay."""

    __slots__ = ("order", "val")

    def __init__(self):
        self.order = StdUmapOrder()
        self.val = {}

    def bump(self, key: int, inc: int):
        self.order.insert(key)
        self.val[key] = self.val.get(key, 0) + inc

    def bor(self, key: int, bits: int):
        self.order.insert(key)
        self.val[key] = self.val.get(key, 0) | bits

    def items_in_map_order(self):
        for k in self.order:
            yield k, self.val[k]

    def erase(self, key: int):
        if key in self.val:
            self.order.erase(key)
            del self.val[key]

    def __len__(self):
        return len(self.val)


def _count_into(oc: _OrderedCounter, seq: str, k: int, lf: int, rf: int,
                count: bool):
    codes = K.encode_bases(seq)
    n = len(codes)
    lo, hi = lf, n - rf - k + 1
    if hi <= lo:
        return
    kms = K.seq_to_kmers(codes, k, canonical=True)[lo:hi]
    inc = 1 if count else 0
    for km in kms:
        if km != K.NAN64:
            oc.bump(int(km), inc)


def _graph_into(oc: _OrderedCounter, seq: str, k: int):
    for s in (seq, K._revcomp_str(seq)):
        codes = K.encode_bases(s)
        kms = K.seq_to_kmers(codes, k, canonical=False)
        n = len(kms)
        for i in range(n):
            km = kms[i]
            if km == K.NAN64:
                continue
            km = int(km)
            nxt = int(kms[i + 1]) if i + 1 < n and kms[i + 1] != K.NAN64 \
                else -1
            if nxt >= 0:
                valid = km != nxt  # noselfloop
                oc.bor(km, (1 if valid else 0) << (nxt & 3))
            else:
                oc.bor(km, 0)


def _remove_node_from_graph(gr: "_OrderedCounter", node: int, k: int):
    """removeNodeFromGraph (fa2kmers.cpp:18-32): drop the node and clear
    the edge bit pointing at it from every possible upstream node."""
    mask = (1 << (2 * k)) - 1 - 3
    pref = 1 << (2 * (k - 1))
    if node in gr.val:
        gr.erase(node)
        nucmask = 0xFF - (1 << (node % 4))
        km1 = (node & mask) >> 2
        for nuc in range(4):
            prev = nuc * pref + km1
            if prev in gr.val:
                gr.val[prev] &= nucmask


def fa2kmers(out_pref: str, fastas: list[str], k: int = 21, fsi: int = 700,
             fso: int = 700, nfile2count: int | None = None,
             gen_graph: bool = True, tr_only: bool = False,
             threshold: int = 0, orthomap: list[list[bool]] | None = None,
             nloci: int | None = None, binary: bool = False,
             prune_file: str | None = None):
    """Writes <out_pref>.tr.kmers [+ .fl.kmers, .graph.kmers] (-on format),
    or binary .kmdb files when ``binary`` (the reference's default -o mode,
    dumpKmerMapDB with u64 values).

    orthomap[locus][hap] = present; when given, each hap's records map to
    the loci marked present (fa2kmers.cpp:116-121,146).
    """
    nhap = len(fastas)
    if nfile2count is None:
        nfile2count = nhap
    if nloci is None:
        if orthomap is not None:
            nloci = len(orthomap)
        else:
            nloci = len(read_fasta_seqs(fastas[0]))
    tr = [_OrderedCounter() for _ in range(nloci)]
    fl = [_OrderedCounter() for _ in range(nloci)]
    gr = [_OrderedCounter() for _ in range(nloci)]
    for h, path in enumerate(fastas):
        count = h < nfile2count
        locus = 0
        for seq in read_fasta_seqs(path):
            if orthomap is not None:
                while not orthomap[locus][h]:
                    locus += 1
            n = len(seq)
            _count_into(tr[locus], seq, k, fsi, fsi, count)
            if not tr_only:
                _count_into(fl[locus], seq, k, fsi - fso,
                            n - fsi - (k - 1), count)
                _count_into(fl[locus], seq, k, n - fsi - (k - 1),
                            fsi - fso, count)
                if gen_graph:
                    _graph_into(gr[locus], seq, k)
            locus += 1

    if prune_file is not None:
        # -p (fa2kmers.cpp:165-188): erase pruned kmers from the TR DB and
        # remove their fwd+RC nodes from the graph, in the pruned map's
        # own iteration order
        pruned = [_OrderedCounter() for _ in range(nloci)]
        li = -1
        with open(prune_file, "rb") as f:
            for line in f:
                if line.startswith(b">"):
                    li += 1
                else:
                    parts = line.split()
                    pruned[li].bump(int(parts[0]),
                                    int(parts[1]) if len(parts) > 1 else 0)
        from ..ops.kmers_np import revcomp_kmers
        import numpy as np

        for locus in range(nloci):
            for km, _ in pruned[locus].items_in_map_order():
                tr[locus].erase(km)
            if gen_graph:
                for km, _ in pruned[locus].items_in_map_order():
                    rc = int(revcomp_kmers(
                        np.array([km], dtype=np.uint64), k)[0])
                    _remove_node_from_graph(gr[locus], km, k)
                    _remove_node_from_graph(gr[locus], rc, k)

    if binary:
        _write_kmdb(out_pref + ".tr.kmdb", tr, threshold)
        if not tr_only:
            _write_kmdb(out_pref + ".fl.kmdb", fl, threshold)
            if gen_graph:
                _write_kmdb(out_pref + ".graph.kmdb", gr, 0)
    else:
        _write(out_pref + ".tr.kmers", tr, threshold)
        if not tr_only:
            _write(out_pref + ".fl.kmers", fl, threshold)
            if gen_graph:
                _write(out_pref + ".graph.kmers", gr, 0)
    return tr, fl, gr


def _write_kmdb(path: str, dbs, threshold: int):
    from ..io import binary as bio

    index, ks, vs = [], [], []
    for db in dbs:
        nskip = 0
        for km, c in db.items_in_map_order():
            if c >= threshold:
                ks.append(km)
                vs.append(c)
            else:
                nskip += 1
        index.append(len(db) - nskip)
    bio.write_kmap_db(path, np.array(index, np.uint64),
                      np.array(ks, np.uint64), np.array(vs, np.uint64))


def _write(path: str, dbs, threshold: int):
    with open(path, "w") as f:
        for i, db in enumerate(dbs):
            f.write(f">{i}\n")
            for km, c in db.items_in_map_order():
                if c < threshold:
                    continue
                f.write(f"{km}\t{c}\n")


def make_tre_kmers(out_pref: str, fastas: list[str], k: int = 21,
                   fsi: int = 700):
    """TR-region (k+1)-mer sets -> <out_pref>.tre.kmers (sorted per locus).

    No reference producer exists at HEAD; align only needs set membership
    (countNovelEdges, aQueryFasta_thread.cpp:1559-1567), so order is our
    choice (sorted for determinism)."""
    nloci = len(read_fasta_seqs(fastas[0]))
    tre = [set() for _ in range(nloci)]
    for path in fastas:
        for li, seq in enumerate(read_fasta_seqs(path)):
            codes = K.encode_bases(seq)
            kms = K.seq_to_kmers(codes, k + 1, canonical=True)
            lo, hi = fsi, len(codes) - fsi - (k + 1) + 1
            for km in kms[lo:hi]:
                if km != K.NAN64:
                    tre[li].add(int(km))
    with open(out_pref + ".tre.kmers", "w") as f:
        for li in range(nloci):
            f.write(f">{li}\n")
            for km in sorted(tre[li]):
                f.write(f"{km}\n")
