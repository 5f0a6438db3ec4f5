"""bed + fasta -> per-region fasta (SelectRegions.py equivalent,
reference script/SelectRegions.py + vntrutils.Fasta).

Each bed row becomes a record named ">col1:col2:...:coln" holding the
upper-cased subsequence; invalid rows keep the header with no sequence.
"""

from __future__ import annotations


class Fasta:
    """Random access via .fai (name, length, offset, linebases, linewidth).

    Falls back to loading the whole file if no .fai exists."""

    def __init__(self, path: str):
        self.path = path
        self.f = open(path, "rb")
        self.index = {}
        try:
            with open(path + ".fai") as fai:
                for line in fai:
                    name, ln, off, lb, lw = line.split()[:5]
                    self.index[name] = (int(ln), int(off), int(lb), int(lw))
        except FileNotFoundError:
            self._load_all()

    def _load_all(self):
        self.seqs = {}
        name, cur = None, []
        self.f.seek(0)
        for line in self.f.read().decode().splitlines():
            if line.startswith(">"):
                if name:
                    self.seqs[name] = "".join(cur)
                name = line[1:].split()[0]
                cur = []
            else:
                cur.append(line)
        if name:
            self.seqs[name] = "".join(cur)
        self.index = None

    def get_seq(self, name: str, start: int, end: int) -> str:
        if self.index is None:
            return self.seqs[name][start:end]
        ln, off, lb, lw = self.index[name]
        b0 = off + start // lb * lw + start % lb
        b1 = off + (end - 1) // lb * lw + (end - 1) % lb + 1
        self.f.seek(b0)
        return self.f.read(b1 - b0).decode().replace("\n", "")

    def close(self):
        self.f.close()


def select_regions(bed_path: str, fasta_path: str, out_path: str) -> None:
    fa = Fasta(fasta_path)
    with open(bed_path) as bed, open(out_path, "w") as out:
        for line in bed:
            vals = line.split()
            out.write(">" + ":".join(vals) + "\n")
            if vals[0] == "NA":
                continue
            s, e = int(vals[1]), int(vals[2])
            if s > e or s < 0 or e < 0:
                continue
            out.write(fa.get_seq(vals[0], s, e).upper() + "\n")
    fa.close()
