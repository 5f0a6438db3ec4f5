"""Read-pairing filter: bam2pe equivalent (reference src/bam2pe.cpp).

Re-pairs a ``samtools fasta -n`` stream into interleaved PE records via a
title hashmap.  On pairing, the *second* occurrence is emitted first with
suffix ``_0`` and the stored mate with ``_1`` (bam2pe.cpp:58-69); unpaired
reads are discarded.  The same buffering scheme feeds the aligner's reader
(engine/host_align.iter_fasta_pairs).
"""

from __future__ import annotations


def prune_pe_info(title: str) -> str:
    if len(title) >= 2 and title[-2] == "/" and title[-1] in "12":
        return title[:-2]
    return title


def bam2pe(inp, out) -> int:
    """Streams; returns number of PE reads written."""
    read_db: dict[str, str] = {}
    npe = 0
    title = None
    for line in inp:
        line = line.rstrip("\n")
        if line.startswith(">"):
            title = prune_pe_info(line)
        else:
            seq = line
            prev = read_db.pop(title, None)
            if prev is None:
                read_db[title] = seq
            else:
                # reference truncates lengths to uint8 (Read.len) and skips
                # pairs with len<1; 150bp reads keep len%256 semantics
                l2, l1 = len(seq) & 0xFF, len(prev) & 0xFF
                if l2 < 1 or l1 < 1:
                    continue
                out.write(f"{title}_0\n{seq[:l2]}\n{title}_1\n{prev[:l1]}\n")
                npe += 2
    return npe
