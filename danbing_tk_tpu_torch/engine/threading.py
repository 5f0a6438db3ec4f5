"""Graph-threading aligner with error correction (host exact path).

A copy of danbing_tk_tpu/engine/threading.py (numpy only), so the port
imports nothing of the JAX package; the two must stay byte-identical in
behaviour (tests/test_torch_threading.py holds the native engine against
this one).

Re-implements the reference's threading algorithm (disabled at HEAD but
fully present in source: isThreadFeasible aQueryFasta_thread.cpp:1114-1260,
errorCorrection_forward :898-1106, thread_ext_t :596-863, threadCheck
:1276-1342) and the `.aln` output format (writeAlignments :1742-1760).

A read "threads" through its assigned locus's bidirectional de Bruijn
graph if consecutive non-canonical k-mers follow out-edges; on a mismatch,
up to `maxncorrection` edits (1-2 substitutions / insertions / deletions,
scored by exact extension length >= MSC=5 per edit, priority mismatch >
del > ins) repair the k-mer stream and the CIGAR; otherwise the walk
re-anchors with skips.  A read is feasible if nskip <= nkmers-thread_cth.

The oracle for this module is the threading-re-enabled reference build
(tools/patch_ref_threading.py); outputs are byte-exact against it.

Device mapping: the no-edit fast path (the vast majority of reads) is the
DFA walk of kernel KE (csrc/thread_walk.cu) over a (node,locus)->edge-mask
table (see device_align); reads that fail the clean walk fall back to the
native engine (engine/native_thread.py) or, with -gcc, to this module.
"""

from __future__ import annotations

import numpy as np

from ..ops import kmers_np as K

NAN64 = 0xFFFFFFFFFFFFFFFF
M64 = 0xFFFFFFFFFFFFFFFF  # nskip is uint64 in the reference; subtractions
# (edit_kmers_backward, annot_gap) can wrap, making nskip > maxnskip --
# comparisons must use the wrapped value
MSC = 5  # min score for thread extension
ALPHABET = "ACGT"
_B2N = {c: i for i, c in enumerate("ACGT")}
_COMP = {"A": "T", "C": "G", "G": "C", "T": "A", "\0": "\0", "": ""}


def read2kmers_noncanonical(seq: str, k: int) -> list[int]:
    """read2kmers(..., canonical=false, keepN=true): positional
    non-canonical k-mers with NAN64 at invalid windows; empty if no valid
    k-mer exists."""
    codes = K.encode_bases(seq)
    kms = K.seq_to_kmers(codes, k, canonical=False)
    if len(kms) == 0 or not (kms != K.NAN64).any():
        return []
    return [int(x) for x in kms]


def to_ca(kmer: int, k: int) -> int:
    rc = int(K.revcomp_kmers(np.array([kmer], dtype=np.uint64), k)[0])
    return kmer if kmer < rc else rc


def get_nurc(kmer: int, k: int) -> int:
    return int(K.revcomp_kmers(np.array([kmer], dtype=np.uint64), k)[0])


class Cigar:
    __slots__ = ("ni", "es", "tr")

    def __init__(self, seq: str, ksize: int):
        self.ni = 0
        # es entries: [type, read_nuc, graph_nuc]
        self.es = [["*", c, ""] for c in seq]
        self.tr = ["*"] * (len(seq) - ksize + 1)


class ThreadExt:
    def __init__(self, mes: int, rv: bool):
        self.rv = rv
        self.nem1 = [0] * 4
        self.nem2 = [0] * 16
        self.nemi = [0] * 4
        self.nemd = [0] * 16
        self.ned1 = [0] * 4
        self.ned2 = [0] * 16
        self.nei1 = 0
        self.nei2 = 0
        self.mes = mes
        self.ms1 = MSC
        self.ms2 = 2 * MSC
        self.score = 0
        self.nrk = 0
        self.nm = 0
        self.nd = 0
        self.ni = 0
        self.edits: list[list] = []

    def get_edit(self) -> bool:
        for i in range(4):
            if self.nem1[i] > self.score and self.nem1[i] >= self.ms1:
                self.score = self.nem1[i]
                self.edits = [["X", "", ALPHABET[i]]]
        for i in range(4):
            if self.ned1[i] > self.score and self.ned1[i] >= self.ms1:
                self.score = self.ned1[i]
                self.edits = [["D", "", ALPHABET[i]]]
        if self.nei1 > self.score and self.nei1 >= self.ms1:
            self.score = self.nei1
            self.edits = [["I", "", ""]]
        if self.mes > 1:
            for i in range(4):
                for j in range(4):
                    sm2 = self.nem2[i * 4 + j]
                    smd = self.nemd[i * 4 + j]
                    sd2 = self.ned2[i * 4 + j]
                    if sm2 > self.score and sm2 >= self.ms2:
                        self.score = sm2
                        self.edits = [["X", "", ALPHABET[i]],
                                      ["X", "", ALPHABET[j]]]
                    if smd > self.score and smd >= self.ms2:
                        self.score = smd
                        self.edits = [["X", "", ALPHABET[i]],
                                      ["D", "", ALPHABET[j]]]
                    if sd2 > self.score and sd2 >= self.ms2:
                        self.score = sd2
                        self.edits = [["D", "", ALPHABET[i]],
                                      ["D", "", ALPHABET[j]]]
                if self.nemi[i] > self.score and self.nemi[i] >= self.ms2:
                    self.score = self.nemi[i]
                    self.edits = [["X", "", ALPHABET[i]], ["I", "", ""]]
            if self.nei2 > self.score and self.nei2 >= self.ms2:
                self.score = self.nei2
                self.edits = [["I", "", ""], ["I", "", ""]]
        return self.score > 0

    # ---- kmer/CIGAR surgery ----

    def edit_kmers_forward(self, st: "ThreadState", cg: Cigar, trKmers):
        kmers = st.kmers
        k = st.ksize
        rmask = st.rmask
        n0 = len(kmers) - st.ki
        good = [kmers[st.ki + i] != NAN64 for i in range(n0)]
        nts = [kmers[st.ki + i] % 4 for i in range(n0)]
        for e in self.edits:
            if e[0] == "X":
                kmers[st.ki] = ((kmers[st.ki - 1] & rmask) << 2) + _B2N[e[2]]
                st.ki += 1
                self.nm += 1
            elif e[0] == "D":
                kmers.insert(st.ki, 0)
                kmers[st.ki] = ((kmers[st.ki - 1] & rmask) << 2) + _B2N[e[2]]
                st.ki += 1
                self.nd += 1
            elif e[0] == "I":
                del kmers[st.ki]
                self.ni += 1
        dt_nti = self.nm + self.ni
        dt_ki = self.nm + self.nd
        dt_km = self.nd - self.ni
        i = st.ki
        while i < min(len(kmers), st.ki + k):
            if not good[dt_nti]:
                break
            kmers[i] = ((kmers[i - 1] & rmask) << 2) + nts[dt_nti]
            dt_nti += 1
            i += 1
        if dt_km > 0:
            cg.tr.extend(["*"] * dt_km)
        elif dt_km < 0:
            del cg.tr[len(cg.tr) + dt_km :]
        for _ in range(self.nd):
            cg.es.insert(cg.ni + k - 1 + self.nm, ["D", "", "*"])
        ki_ = st.ki - dt_ki
        for i in range(dt_ki + self.score):
            cg.tr[ki_ + i] = "=" if to_ca(kmers[ki_ + i], k) in trKmers \
                else "."
        for e in self.edits:
            e0 = cg.es[cg.ni + k - 1]
            e0[0] = e[0]
            e0[2] = e[2]
            cg.ni += 1
        for _ in range(self.score):
            cg.es[cg.ni + k - 1][0] = "="
            cg.ni += 1
        cg.ni -= 1
        st.ki += self.score - 1
        st.ncorrection += len(self.edits)

    def edit_kmers_backward(self, st: "ThreadState", cg: Cigar, trKmers):
        kmers = st.kmers
        k = st.ksize
        lbase = 1 << (2 * (k - 1))
        lmask = 3 << (2 * (k - 1))
        ki = st.ki
        good = [kmers[i] != NAN64 for i in range(ki)]
        nts = [kmers[i] & lmask for i in range(ki)]
        for e in self.edits:
            if e[0] == "X":
                self.nm += 1
            elif e[0] == "D":
                self.nd += 1
            elif e[0] == "I":
                self.ni += 1
        self.dt_km = self.nd - self.ni
        cg.ni += self.nd
        if self.dt_km > 0:
            for _ in range(self.dt_km):
                kmers.insert(ki, 0)
                cg.tr.insert(ki, "*")
        elif self.dt_km < 0:
            del kmers[ki + self.dt_km : ki]
            del cg.tr[ki + self.dt_km : ki]
        ki += self.dt_km
        st.ki = ki
        ki_ = ki
        for e in self.edits:
            if e[0] in ("X", "D"):
                kmers[ki_ - 1] = (kmers[ki_] >> 2) + \
                    (3 - _B2N[e[2]]) * lbase
                ki_ -= 1
        i = ki_
        while i > max(0, ki_ - k):
            if not good[i - 1]:
                break
            kmers[i - 1] = (kmers[i] >> 2) + nts[i - 1]
            i -= 1
        lb = ki - self.nm - self.nd - self.score
        for i in range(ki - 1, lb - 1, -1):
            if cg.tr[i] == "*":
                self.nrk += 1
            cg.tr[i] = "=" if to_ca(kmers[i], k) in trKmers else "."
        self.nrk -= self.nm + self.nd
        st.nskip -= self.nrk
        st.ncorrection += len(self.edits)

        # ---- CIGAR patch (aQueryFasta_thread.cpp:695-819) ----
        cni = 0
        nti_ = ki - self.dt_km
        i = 0
        while i < nti_ + cni:
            if cg.es[i][0] == "I":
                cni += 1
            i += 1
        nti = nti_ + cni - 1
        for e1 in self.edits:
            if e1[0] == "D":
                nti += 1
                cg.es.insert(nti, ["D", "", "*"])
            ed0 = cg.es[nti]
            if ed0[0] == "D":
                if e1[0] == "I":
                    del cg.es[nti]
                    cg.ni -= 1
                else:
                    ed0[2] = _COMP[e1[2]]
            else:
                while cg.es[nti][0] == "I":
                    nti -= 1
                ed0 = cg.es[nti]
                ed0[0] = e1[0]
                ed0[2] = _COMP[e1[2]] if e1[2] else ""
            nti -= 1
        e0 = nti + 1
        e1i = e0
        for _ in range(self.score):
            e = cg.es[nti]
            if e[0] == "=":
                pass
            elif e[0] == "*":
                e[0] = "="
            else:
                break
            nti -= 1
        t = cg.es[e1i][0]
        while t in ("X", "D", "I"):
            e1i += 1
            t = cg.es[e1i][0]
        t = cg.es[e0 - 1][0]
        while t in ("X", "D", "I"):
            e0 -= 1
            t = cg.es[e0 - 1][0]
        ets, rnts, gnts = [], [], []
        for i in range(e0, e1i):
            e = cg.es[i]
            ets.append(e[0])
            if e[1]:
                rnts.append(e[1])
            if e[2]:
                gnts.append(e[2])
        if len(rnts) == len(gnts):
            no_edit = all(a == b for a, b in zip(rnts, gnts))
            if no_edit:
                dt_es = 0
                for i in range(e0, e1i):
                    t = cg.es[i + dt_es][0]
                    if t == "D":
                        del cg.es[i + dt_es]
                        dt_es -= 1
                    else:
                        e = cg.es[i + dt_es]
                        e[0] = "="
                        e[2] = ""
                cg.ni += dt_es
                st.ncorrection -= e1i - e0
                st.nskip -= e1i - e0
            else:
                if len(ets) != len(rnts):
                    dt_es = 0
                    dt_es_ = len(rnts) - len(ets)
                    j = kk = 0
                    for i in range(e0, e1i):
                        t = cg.es[i + dt_es][0]
                        if t == "D" and dt_es != dt_es_:
                            del cg.es[i + dt_es]
                            dt_es -= 1
                        else:
                            e = cg.es[i + dt_es]
                            if rnts[kk] == gnts[kk]:
                                e[0] = "="
                                e[2] = ""
                            else:
                                e[0] = "X"
                                e[2] = gnts[j]
                            j += 1
                            kk += 1
                    assert dt_es == dt_es_
                    cg.ni += dt_es
                    st.ncorrection += dt_es
                    st.nskip += dt_es
                else:
                    for i in range(len(rnts)):
                        if rnts[i] == gnts[i]:
                            e = cg.es[e0 + i]
                            e[0] = "="
                            e[2] = ""
                            st.ncorrection -= 1
                            st.nskip -= 1
        else:
            for i in range(len(ets)):
                e = cg.es[e0 + i]
                if e[1] == e[2]:
                    e[0] = "="
                    e[2] = ""
                    st.ncorrection -= 1
                    st.nskip -= 1


class ThreadState:
    """Mutable threading-walk state shared across helpers."""

    def __init__(self, kmers, ksize):
        self.kmers = kmers
        self.ksize = ksize
        self.rmask = (1 << (2 * (ksize - 1))) - 1
        self.ki = 0
        self.nskip = 0
        self.ncorrection = 0


def get_out_nodes(g: dict, node: int, k: int):
    """-> (next nodes list, 4-bool next-nucleotide presence)."""
    bits = g[node]
    rmask = (1 << (2 * (k - 1))) - 1
    base = (node & rmask) << 2
    nnds = []
    nnts = [False] * 4
    for i in range(4):
        if (bits >> i) & 1:
            nnds.append(base + i)
            nnts[i] = True
    return nnds, nnts


def _get_next_nucs(g: dict, node: int, nnts: list):
    """getNextNucs: OVERWRITES nnts only if node present (else stale)."""
    bits = g.get(node)
    if bits is not None:
        for i in range(4):
            nnts[i] = bool((bits >> i) & 1)


class GraphTriplet:
    __slots__ = ("mat",)

    def __init__(self):
        self.mat = [False] * 64

    def get_nnts1(self, i, nnts):
        for j in range(4):
            for kk in range(4):
                nnts[j] |= self.mat[i * 16 + j * 4 + kk]

    def get_nnts2(self, i, j, nnts):
        for kk in range(4):
            nnts[kk] |= self.mat[i * 16 + j * 4 + kk]


def error_correction_forward(nnds, g, kmers, ki, nts0, txt: ThreadExt,
                             mes, k, rmask):
    nts1 = [False] * 4
    nts2 = [False] * 4
    gnt3 = GraphTriplet()
    nkmers = len(kmers)
    oldnt = kmers[ki] % 4
    for node_i in nnds:
        nt0 = node_i % 4
        n1, _ = get_out_nodes(g, node_i, k)
        for i in range(4):
            nts1[i] |= any(x % 4 == i for x in n1)
        for node_ip1 in n1:
            nt1 = node_ip1 % 4
            n2, _ = get_out_nodes(g, node_ip1, k)
            for i in range(4):
                nts2[i] |= any(x % 4 == i for x in n2)
            for node_ip2 in n2:
                gnt3.mat[nt0 * 16 + nt1 * 4 + (node_ip2 % 4)] = True

    good = [False] * (k + 2)
    for i in range(min(k + 2, nkmers - ki)):
        good[i] = kmers[ki + i] != NAN64

    def ext1(start_j, jmax, nnts, count_cb):
        """walk matching read nts from position ki+start_j while allowed."""
        pass  # inline below for clarity

    # one mismatch
    if ki + 1 < nkmers and nts1[kmers[ki + 1] % 4] and good[1]:
        for nt0 in range(4):
            if not nts0[nt0]:
                continue
            crk = kmers[ki] - oldnt + nt0
            nnts = [False] * 4
            gnt3.get_nnts1(nt0, nnts)
            for j in range(1, min(k + 1, nkmers - ki)):
                if not good[j]:
                    break
                crk = ((crk & rmask) << 2) + kmers[ki + j] % 4
                if nnts[crk % 4]:
                    txt.nem1[nt0] += 1
                    _get_next_nucs(g, crk, nnts)
                else:
                    break
    # two mismatches
    elif (ki + 2 < nkmers and nts2[kmers[ki + 2] % 4] and mes >= 2
          and good[2]):
        for nt0 in range(4):
            if not nts0[nt0]:
                continue
            crk0 = kmers[ki] - oldnt + nt0
            nnt0 = [False] * 4
            gnt3.get_nnts1(nt0, nnt0)
            for nt1 in range(4):
                if not nnt0[nt1]:
                    continue
                crk1 = ((crk0 & rmask) << 2) + nt1
                nnt1 = [False] * 4
                gnt3.get_nnts2(nt0, nt1, nnt1)
                for j in range(2, min(k + 2, nkmers - ki)):
                    if not good[j]:
                        break
                    crk1 = ((crk1 & rmask) << 2) + kmers[ki + j] % 4
                    if nnt1[crk1 % 4]:
                        txt.nem2[nt0 * 4 + nt1] += 1
                        _get_next_nucs(g, crk1, nnt1)
                    else:
                        break
    # 1 substitution + 1 insertion
    if ki + 2 < nkmers and nts1[kmers[ki + 2] % 4] and mes >= 2 and good[2]:
        for nt0 in range(4):
            if not nts0[nt0]:
                continue
            crk = kmers[ki] - oldnt + nt0
            nnt0 = [False] * 4
            gnt3.get_nnts1(nt0, nnt0)
            for j in range(2, min(k + 2, nkmers - ki)):
                if not good[j]:
                    break
                crk = ((crk & rmask) << 2) + kmers[ki + j] % 4
                if nnt0[crk % 4]:
                    txt.nemi[nt0] += 1
                    _get_next_nucs(g, crk, nnt0)
                else:
                    break
    # 1 substitution + 1 deletion
    if ki + 1 < nkmers and nts2[kmers[ki + 1] % 4] and mes >= 2 and good[1]:
        for nt0 in range(4):
            if not nts0[nt0]:
                continue
            crk0 = kmers[ki] - oldnt + nt0
            nnt0 = [False] * 4
            gnt3.get_nnts1(nt0, nnt0)
            for nt1 in range(4):
                if not nnt0[nt1]:
                    continue
                crk1 = ((crk0 & rmask) << 2) + nt1
                nnt1 = [False] * 4
                gnt3.get_nnts2(nt0, nt1, nnt1)
                for j in range(1, min(k + 1, nkmers - ki)):
                    if not good[j]:
                        break
                    crk1 = ((crk1 & rmask) << 2) + kmers[ki + j] % 4
                    if nnt1[crk1 % 4]:
                        txt.nemd[nt0 * 4 + nt1] += 1
                        _get_next_nucs(g, crk1, nnt1)
                    else:
                        break
    # 1 insertion
    if ki + 1 < nkmers and nts0[kmers[ki + 1] % 4] and good[1]:
        crk = kmers[ki - 1]
        nnt0 = list(nts0)
        for j in range(1, min(k + 1, nkmers - ki)):
            if not good[j]:
                break
            crk = ((crk & rmask) << 2) + kmers[ki + j] % 4
            if nnt0[crk % 4]:
                txt.nei1 += 1
                _get_next_nucs(g, crk, nnt0)
            else:
                break
    # 1 deletion
    if nts1[kmers[ki] % 4] and good[0]:
        for nt0 in range(4):
            if not nts0[nt0]:
                continue
            crk = kmers[ki] - oldnt + nt0
            nnt0 = [False] * 4
            gnt3.get_nnts1(nt0, nnt0)
            for j in range(0, min(k, nkmers - ki)):
                if not good[j]:
                    break
                crk = ((crk & rmask) << 2) + kmers[ki + j] % 4
                if nnt0[crk % 4]:
                    txt.ned1[nt0] += 1
                    _get_next_nucs(g, crk, nnt0)
                else:
                    break
    # 2 insertions
    if ki + 2 < nkmers and nts0[kmers[ki + 2] % 4] and mes >= 2 and good[2]:
        crk = kmers[ki - 1]
        nnt0 = list(nts0)
        for j in range(2, min(k + 2, nkmers - ki)):
            if not good[j]:
                break
            crk = ((crk & rmask) << 2) + kmers[ki + j] % 4
            if nnt0[crk % 4]:
                txt.nei2 += 1
                _get_next_nucs(g, crk, nnt0)
            else:
                break
    # 2 deletions
    if nts2[kmers[ki] % 4] and mes >= 2 and good[0]:
        for nt0 in range(4):
            if not nts0[nt0]:
                continue
            crk0 = kmers[ki] - oldnt + nt0
            nnt0 = [False] * 4
            gnt3.get_nnts1(nt0, nnt0)
            for nt1 in range(4):
                if not nnt0[nt1]:
                    continue
                crk1 = ((crk0 & rmask) << 2) + nt1
                nnt1 = [False] * 4
                gnt3.get_nnts2(nt0, nt1, nnt1)
                for j in range(0, min(k, nkmers - ki)):
                    if not good[j]:
                        break
                    crk1 = ((crk1 & rmask) << 2) + kmers[ki + j] % 4
                    if nnt1[crk1 % 4]:
                        txt.ned2[nt0 * 4 + nt1] += 1
                        _get_next_nucs(g, crk1, nnt1)
                    else:
                        break
    return not txt.get_edit()


def error_correction_backward(node, g, kmers, ki, txt, mes, k, rmask):
    node_rc = get_nurc(node, k)
    nnds_rc, nts0_rc = get_out_nodes(g, node_rc, k)
    kmers_rc = [0] * (ki + 1)
    kmers_rc[0] = node_rc
    kk = 1
    for j in range(ki - 1, -1, -1):
        kmers_rc[kk] = get_nurc(kmers[j], k) if kmers[j] != NAN64 else NAN64
        kk += 1
    return error_correction_forward(nnds_rc, g, kmers_rc, 1, nts0_rc, txt,
                                    mes, k, rmask)


def find_anchor_cg(g, st: ThreadState, cg: Cigar, trKmers):
    kmers = st.kmers
    while st.kmers[st.ki] not in g:
        st.nskip += 1
        cg.ni += 1
        st.ki += 1
        if st.ki >= len(kmers):
            return 0, 0
    node = kmers[st.ki]
    cg.tr[st.ki] = "=" if to_ca(node, st.ksize) in trKmers else "."
    for i in range(cg.ni, cg.ni + st.ksize):
        if cg.es[i][0] == "*":
            cg.es[i][0] = "="
    return 1, node


def is_thread_feasible(g: dict, seq: str, thread_cth: int, correction: bool,
                       cg: Cigar, trKmers, ksize: int,
                       maxncorrection: int = 4):
    """Returns (status, noncakmers, kmers): 0 infeasible, 1 feasible,
    2 feasible w/ correction.  kmers is the corrected walk."""
    noncakmers = read2kmers_noncanonical(seq, ksize)
    kmers = list(noncakmers)
    st = ThreadState(kmers, ksize)
    if not kmers:
        return 0, noncakmers, kmers
    maxnskip = len(kmers) - thread_cth if len(kmers) >= thread_cth else 0
    node = kmers[0]

    ok, node = find_anchor_cg(g, st, cg, trKmers)
    if not ok:
        return 0, noncakmers, kmers
    if st.ki > 0 and correction and st.ncorrection < maxncorrection:
        if st.ki >= MSC + 1:
            mes = 2 if st.ki >= 2 * MSC + 2 else 1
            txtr = ThreadExt(mes, True)
            skip = error_correction_backward(node, g, kmers, st.ki, txtr,
                                             mes, ksize, st.rmask)
            if not skip:
                txtr.edit_kmers_backward(st, cg, trKmers)

    st.ki += 1
    cg.ni += 1
    while st.ki < len(kmers):
        ki = st.ki
        if kmers[ki] == NAN64:
            cg.tr[ki] = "*"
            cg.es[cg.ni + ksize - 1][0] = "*"
            st.nskip += 1
            if (st.nskip & M64) > maxnskip:
                return 0, noncakmers, kmers
            st.ki += 1
            cg.ni += 1
            continue
        if kmers[ki] == kmers[ki - 1]:
            cg.tr[ki] = "*"
            cg.es[cg.ni + ksize - 1][0] = "*"
            st.nskip += 1
            if (st.nskip & M64) > maxnskip:
                return 0, noncakmers, kmers
            st.ki += 1
            cg.ni += 1
            continue
        if kmers[ki - 1] == NAN64:
            ok, node = find_anchor_cg(g, st, cg, trKmers)
            if not ok:
                break
            if (st.nskip & M64) > maxnskip:
                return 0, noncakmers, kmers
            st.ki += 1
            cg.ni += 1
            continue

        skip = True
        nnds, nts0 = get_out_nodes(g, node, ksize)
        for nnd in nnds:
            if kmers[ki] == nnd:
                node = nnd
                skip = False
                cg.tr[ki] = "=" if to_ca(kmers[ki], ksize) in trKmers \
                    else "."
                cg.es[cg.ni + ksize - 1][0] = "="
                break
        if not skip:
            st.ki += 1
            cg.ni += 1
            continue
        # error correction / re-anchor
        if ki + MSC >= len(kmers):
            st.nskip += len(kmers) - ki
            if st.nskip <= maxnskip:
                return (2 if st.ncorrection else 1), noncakmers, kmers
            return 0, noncakmers, kmers

        if correction and st.ncorrection < maxncorrection:
            mes = 2 if len(kmers) - ki >= 2 * MSC + 2 else 1
            txtf = ThreadExt(mes, False)
            skip = error_correction_forward(nnds, g, kmers, ki, nts0, txtf,
                                            mes, ksize, st.rmask)
            if not skip:
                st.nskip += len(txtf.edits)
                if (st.nskip & M64) > maxnskip:
                    return 0, noncakmers, kmers
                txtf.edit_kmers_forward(st, cg, trKmers)
                node = kmers[st.ki]
            else:
                ok, node = find_anchor_cg(g, st, cg, trKmers)
                if not ok:
                    break
                mes = 2
                txtr = ThreadExt(mes, True)
                skip = error_correction_backward(node, g, kmers, st.ki,
                                                 txtr, mes, ksize, st.rmask)
                if not skip:
                    txtr.edit_kmers_backward(st, cg, trKmers)
                    st.ncorrection += 1
                    gap = min(ksize, st.ki - txtr.nm - txtr.nd) - txtr.score
                    ki0 = ki1 = st.ki
                    while not skip and gap:
                        ki0 = ki1
                        ki1 = ki0 - txtr.nm - txtr.nd - txtr.score
                        mes = 2 if ki1 >= 2 * MSC + 2 else 1
                        if ki1 < MSC + 1:
                            break
                        txtr = ThreadExt(mes, True)
                        node_ = kmers[ki1]
                        assert node_ in g
                        skip = error_correction_backward(
                            node_, g, kmers, ki1, txtr, mes, ksize, st.rmask)
                        if not skip:
                            ki_save = st.ki
                            st.ki = ki1
                            txtr.edit_kmers_backward(st, cg, trKmers)
                            ki1 = st.ki
                            st.ki = ki_save + txtr.nd - txtr.ni
                            gap = min(ksize, ki1 - txtr.nm - txtr.nd) - \
                                txtr.score
                    if gap:
                        kk = ki1
                        for _ in range(gap):
                            kk -= 1
                            cg.tr[kk] = "*"
                        st.nskip -= gap
                    if (st.nskip & M64) > maxnskip:
                        return 0, noncakmers, kmers
                if skip:
                    ok, node = find_anchor_cg(g, st, cg, trKmers)
                    if not ok:
                        break
                    if (st.nskip & M64) > maxnskip:
                        return 0, noncakmers, kmers
                    st.ki += 1
                    cg.ni += 1
                    continue
        else:
            ok, node = find_anchor_cg(g, st, cg, trKmers)
            if not ok:
                break
            if (st.nskip & M64) > maxnskip:
                return 0, noncakmers, kmers
            st.ki += 1
            cg.ni += 1
            continue
        st.ki += 1
        cg.ni += 1

    if st.nskip <= maxnskip and st.ncorrection <= maxncorrection:
        return (2 if st.ncorrection else 1), noncakmers, kmers
    return 0, noncakmers, kmers


def _find_anchor_plain(g, kmers, ki):
    while ki < len(kmers) and kmers[ki] not in g:
        ki += 1
    if ki >= len(kmers):
        return 0, ki, 0
    return 1, ki, kmers[ki]


def thread_check(g: dict, seq: str, kmers: list, cg: Cigar, k: int):
    """-gcc sanity verification (threadCheck, :1276-1342): apply the CIGAR
    to the read, re-walk the graph, assert the corrected kmer stream."""
    cseq = list(seq)
    i = 0
    for e in cg.es:
        if e[0] == "X":
            if cseq[i] == e[2]:
                return  # reference logs failure and returns
            cseq[i] = e[2]
        elif e[0] == "D":
            cseq.insert(i, e[2])
        elif e[0] == "I":
            del cseq[i]
            i -= 1
        i += 1

    broken = False
    ki = 0
    dt = 0
    while cg.tr[ki] == "*":
        ki += 1
    node = kmers[ki]
    if node not in g:
        _, ki, node = _find_anchor_plain(g, kmers, ki)

    ki += 1
    while ki < len(kmers):
        if cg.tr[ki + dt] == "*":
            ki += 1
            continue
        if cg.tr[ki - 1 + dt] == "*":
            node = kmers[ki]
            assert node in g, "threadCheck: node not found"
            ki += 1
            continue
        if node == kmers[ki]:
            ki += 1
            continue
        nnds, _ = get_out_nodes(g, node, k)
        skip = True
        for nnd in nnds:
            if kmers[ki] == nnd:
                node = nnd
                skip = False
                break
        if skip:
            cg.tr.insert(ki + dt, "!")
            broken = True
            ok, ki, node = _find_anchor_plain(g, kmers, ki)
            dt += 1
        ki += 1
    if broken:
        return
    ckmers = read2kmers_noncanonical("".join(cseq), k)
    assert len(kmers) == len(ckmers), "threadCheck: size mismatch"
    for a, b in zip(kmers, ckmers):
        assert a == b, "threadCheck: cseq != kseq"


# ---- output formatting ----

def _e2c(e) -> str:
    if e[0] == "X":
        return e[2]
    if e[0] == "D":
        return str(_B2N.get(e[2], e[2]))
    return e[0]


def write_cigar(es: list) -> str:
    """writeCigar RLE (aQueryFasta_thread.cpp:1701-1740), exact
    transliteration including the trailing-element quirks."""
    if not es:
        return "*"
    out = []
    n = len(es)
    ct = 1
    e0 = es[0]
    i = 1
    while i < n:
        e1 = es[i]
        if e0[0] in ("=", ".", "*"):
            while e1[0] == e0[0]:
                ct += 1
                i += 1
                if i == n:
                    break
                e1 = es[i]
            out.append(f"{ct}{e0[0]}")
        elif e0[0] == "X":
            out.append("X" + e0[2])
        elif e0[0] == "D":
            if e1[0] == "I":
                out.append("X" + e0[2])
                i += 1
            else:
                out.append("D" + e0[2])
        elif e0[0] == "I":
            if e1[0] == "D":
                out.append("X" + e1[2])
                i += 1
            else:
                out.append("I")
        else:
            out.append(e0[0])
        if i == n:
            return "".join(out)
        ct = 1
        e0 = es[i]
        i += 1
    out.append(f"{ct}{e0[0]}")
    return "".join(out)


def write_annot(tr: list) -> str:
    """writeAnnot RLE (aQueryFasta_thread.h — '*' if empty)."""
    if not tr:
        return "*"
    out = []
    ct = 1
    c0 = tr[0]
    i = 1
    while i < len(tr):
        if c0 in ("=", ".", "*"):
            while i < len(tr) and tr[i] == c0:
                ct += 1
                i += 1
            out.append(f"{ct}{c0}")
            if i == len(tr):
                return "".join(out)
        else:
            out.append(c0)
        ct = 1
        c0 = tr[i]
        i += 1
    out.append(f"{ct}{c0}")
    return "".join(out)
