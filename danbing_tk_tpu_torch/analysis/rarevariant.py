"""Rare-variant (novel bubble) caller: danbing.call.py equivalent
(capability of reference script/danbing.call.py; behavior matched via
the synthetic end-to-end test, structure re-derived).

Two-stage filtering of novel (k+1)-mer bubbles from align's .bub output:
  1. snarl finding from TR-anchored roots (analysis/bubblecalling) +
     bubble-root SVM on coverage/entropy features
  2. heuristic per-locus coverage filter + bubble-path SVM on path
     features (size, cov stats, gap counts, bidirectionality)

SVM models are sklearn classifiers (pickles, as in the reference);
models/svm.py provides training helpers since the reference ships only
pretrained release assets.  Feature-column names (c_root, bbs, ...) are
part of the model contract and kept verbatim.

Both SVM stages run on a torch device: models/svm.load_model reads the
pickles without sklearn, and the feature tables are float64 arrays in
``_ROOT_COLS`` and ``PATH_COLS`` order; a model that carries
``feature_names_in_`` must have been fitted on exactly those columns in
that order (else it raises, as sklearn's ``predict`` on the reference's
DataFrame does); ``bdir`` is 0/1, as sklearn reads a bool column.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.kmers_np import decode_kmer
from .._device import resolve_device
from ..models.svm import load_model
from . import bubblecalling as bc


def load_tr_kmc(kmers_fn: str, index_fn: str, n_autosomal: int | None =
                None, sex: int = 2):
    """Per-locus {canonical TR kmer: count}: counts from the count-only
    align output, kmer names from the index file (row-aligned)."""
    counts_by_locus = {}
    with open(index_fn) as index_f, open(kmers_fn) as counts_f:
        locus = -1
        for line in index_f:
            if line[0] == ">":
                locus += 1
                if n_autosomal is not None and sex == 1 and \
                        locus >= n_autosomal:
                    break
                counts_by_locus[locus] = {}
            else:
                kmer = int(line.split()[0])
                counts_by_locus[locus][kmer] = int(counts_f.readline())
    return counts_by_locus


def load_bubbles(fn: str, n_autosomal: int | None = None, sex: int = 2):
    """Per-locus {canonical (k+1)-mer edge: count} from .bub output
    (forward/RC rows of one edge merge into its canonical form)."""
    by_locus = {}
    edge_counts = {}
    locus = -1
    with open(fn) as f:
        for line in f:
            if line[0] == ">":
                if locus >= 0 and edge_counts:
                    by_locus[locus] = edge_counts
                locus += 1
                edge_counts = {}
                if n_autosomal is not None and sex == 1 and \
                        locus >= n_autosomal:
                    break
            else:
                edge, count = (int(v) for v in line.split())
                ce = bc.e2ce(edge)
                edge_counts[ce] = edge_counts.get(ce, 0) + count
    if edge_counts:
        by_locus[locus] = edge_counts
    return by_locus


def seq_entropy(seq: str, k: int = 1) -> float:
    """Shannon entropy of the k-mer composition of seq."""
    counts = np.zeros(4 ** k)
    for i in range(len(seq) - k + 1):
        v = 0
        for c in seq[i : i + k]:
            v = v * 4 + "ACGT".index(c)
        counts[v] += 1
    p = counts / len(seq)
    p = p[p > 0]
    return float(-(p * np.log2(p)).sum())


# stage-1 SVM feature columns (model contract — names fixed)
_ROOT_COLS = ("c_root", "c_nv_e", "c_ex_e", "c_tm_e", "r_nve_r",
              "r_nve_exe", "n_snrl", "n_tm_e", "n_bb_e", "h1", "h2", "h3")
# stage-2 SVM feature columns
PATH_COLS = ("bbs", "mcov", "scov", "fcmax", "cdiff", "n3gp", "n4gp",
             "bdir")


def check_columns(cols, model) -> None:
    """Raise unless the model was fitted without feature names or on
    exactly ``cols`` in that order (sklearn's check of a DataFrame's
    columns against ``feature_names_in_``)."""
    names = getattr(model, "feature_names_in_", None)
    if names is not None and tuple(names) != tuple(cols):
        raise ValueError(f"The feature names should match those that were "
                         f"passed during fit: the model has "
                         f"({', '.join(names)}), the table "
                         f"({', '.join(cols)})")


def svm_accept(model_fn: str, X: np.ndarray, cols, device) -> np.ndarray:
    """The model's labels for the rows of X as a bool array (the
    reference's ``clf.predict(df).astype(bool)``)."""
    model = load_model(model_fn, device)
    check_columns(cols, model)
    X = np.ascontiguousarray(X, dtype=np.float64)
    return model.predict(torch.from_numpy(X).to(model.classes_.device)) \
        .bool().cpu().numpy()


class SnarlTable:
    """Flat store of candidate bubbles found by the snarl walk.

    One row per surviving bubble: feature columns in ``cols`` (keyed by
    the SVM model's column names), the concatenated alive-path edges in
    ``edges``/``edge_covs`` with per-bubble prefix ends ``bubble_ends``,
    and per-locus prefix ends ``locus_ends`` over the rows.  The first
    edge of each bubble's slice is its root edge (stage 2 relies on
    that).
    """

    def __init__(self, nloci: int):
        self.cols = {name: [] for name in _ROOT_COLS}
        self.edges: list[int] = []
        self.edge_covs: list[int] = []
        self.bubble_ends: list[int] = []
        self.locus_ends = np.zeros(nloci, dtype=int)

    def feature_matrix(self) -> np.ndarray:
        """(rows, 12) float64 in ``_ROOT_COLS`` order."""
        return np.array([self.cols[name] for name in _ROOT_COLS],
                        dtype=np.float64).reshape(len(_ROOT_COLS), -1).T

    def bubble_slice(self, bi: int):
        lo = self.bubble_ends[bi - 1] if bi else 0
        return lo, self.bubble_ends[bi]

    def locus_slice(self, locus: int):
        lo = self.locus_ends[locus - 1] if locus else 0
        return int(lo), int(self.locus_ends[locus])


def find_tr_snarls(qcfilter, locus_trks, locus_ntrks, bub_kmc, tr_kmc,
                   nloci: int, th_cne: int = 10,
                   graph_size_limit: int = 10000):
    """Walk snarls from every TR-anchored root edge of every QC-passing
    locus; collect per-bubble SVM features for the alive ones."""
    table = SnarlTable(nloci)
    col = table.cols
    for locus in bub_kmc:
        if not qcfilter[locus] or len(bub_kmc[locus]) > graph_size_limit:
            table.locus_ends[locus] = len(col["c_nv_e"])
            continue
        trks = locus_trks[locus]
        ntrks = locus_ntrks[locus]
        bub_cov = bub_kmc[locus]
        tr_cov = tr_kmc[locus]
        graph = bc.build_edge_graph(bub_cov.keys())
        alive, dead = set(), set()
        for node in graph:
            if node not in trks:
                continue
            root_cov = tr_cov[bc.k2ck(node)]
            # running per-root tallies, final values broadcast to every
            # bubble rooted here once the node's arcs are exhausted
            extant_cov = root_cov
            trimmed_cov = 0
            n_bubbles = 0
            n_trimmed = 0
            root = bc.Arc(None, None, node)
            _, arcs = bc.arcs_from_node(graph, node)
            for arc in arcs:
                nv_cov = bub_cov[bc.e2ce(arc.edge)]
                if nv_cov < th_cne:
                    extant_cov -= nv_cov
                    trimmed_cov += nv_cov
                    n_trimmed += 1
                    continue
                alive_path = bc.check_bubble_root_edge(
                    root, arc, graph, trks, ntrks, alive, dead)
                if arc.alive:
                    extant_cov -= nv_cov
                    seq = decode_kmer(arc.edge, bc.ESIZE)
                    n_bubbles += 1
                    col["c_root"].append(root_cov)
                    col["c_nv_e"].append(nv_cov)
                    col["r_nve_r"].append(nv_cov / root_cov)
                    col["n_bb_e"].append(len(alive_path))
                    col["h1"].append(seq_entropy(seq, 1))
                    col["h2"].append(seq_entropy(seq, 2))
                    col["h3"].append(seq_entropy(seq, 3))
                    path = [arc.edge] + [e for e in alive_path
                                         if e != arc.edge]
                    table.edges += path
                    table.edge_covs += [bub_cov[bc.e2ce(e)]
                                        for e in path]
                    table.bubble_ends.append(len(table.edges))
                else:
                    dead_cov = bub_cov[bc.e2ce(arc.edge)]
                    extant_cov -= dead_cov
                    trimmed_cov += dead_cov
                    n_trimmed += 1
            for i in range(n_bubbles):
                col["c_ex_e"].append(extant_cov)
                col["c_tm_e"].append(trimmed_cov)
                col["r_nve_exe"].append(
                    col["c_nv_e"][-n_bubbles + i] / (extant_cov + 1))
                col["n_snrl"].append(n_bubbles)
                col["n_tm_e"].append(n_trimmed)
        table.locus_ends[locus] = len(col["c_nv_e"])
    return table


def br_svm_filter(table: SnarlTable, model_fn: str, th: int,
                  device=None):
    """Stage-1 SVM over bubble-root features on ``device``; returns
    (feature matrix, indices of accepted bubbles)."""
    X = table.feature_matrix()
    table.edge_covs = np.array(table.edge_covs)
    coarse = X[:, _ROOT_COLS.index("c_nv_e")] > th
    if not coarse.any():
        return X, np.array([], dtype=int)
    accept = svm_accept(model_fn, X[coarse], _ROOT_COLS, device)
    return X, np.nonzero(coarse)[0][accept]


def filter_bubble_edges(accepted, table: SnarlTable, nloci: int,
                        th1: int, th2: int, th3: int):
    """Per-locus heuristic coverage filter: keep edges of SVM-accepted
    bubbles whose coverage clears a threshold derived from the gap
    between accepted-root and rejected-root coverages."""
    accepted_set = set(accepted.tolist())
    kept_by_locus = {}
    all_edges = np.asarray(table.edges, dtype=np.int64)
    all_covs = np.asarray(table.edge_covs, dtype=np.int64)
    for locus in range(nloci):
        first_bi, last_bi = table.locus_slice(locus)
        edges = np.array([], dtype=np.int64)
        covs = np.array([], dtype=np.int64)
        true_cov_min, false_cov_max = 99999, 0
        any_accepted = False
        for bi in range(first_bi, last_bi):
            lo, hi = table.bubble_slice(bi)
            root_cov = all_covs[lo]  # first edge of the slice = root
            if bi in accepted_set:
                any_accepted = True
                true_cov_min = min(true_cov_min, root_cov)
                edges = np.concatenate((edges, all_edges[lo:hi]))
                covs = np.concatenate((covs, all_covs[lo:hi]))
            else:
                false_cov_max = max(false_cov_max, root_cov)
        if not any_accepted:
            continue
        if true_cov_min - false_cov_max > th3:
            th = max(th2, false_cov_max)
        else:
            th = max(th2, true_cov_min - th1)
        keep = covs > th
        if not keep.any():
            continue
        edges, covs = edges[keep], covs[keep]
        cov_of = {}
        for e_fwd, c in zip(edges.tolist(), covs.tolist()):
            for e in (e_fwd, bc.rc(e_fwd, bc.ESIZE)):
                cov_of.setdefault(e, c)
        kept_by_locus[locus] = (edges, cov_of, false_cov_max)
    return kept_by_locus


def _coverage_gaps(covs):
    """Count adjacent coverage jumps >=3 and >=4 along a path."""
    n3 = n4 = 0
    prev = None
    for c in covs:
        if prev is not None:
            gap = abs(c - prev)
            if gap >= 3:
                n3 += 1
                if gap >= 4:
                    n4 += 1
        prev = c
    return n3, n4


def bubble_path_features(kept_by_locus, locus_trks, locus_ntrks):
    """Re-walk snarls over only the kept edges (directed graph this
    time) and emit stage-2 SVM features per surviving bubble path:
    (bubble paths, (rows, 8) float64 in ``PATH_COLS`` order)."""
    bubble_paths = []
    rows = []
    for locus in sorted(kept_by_locus):
        edges, cov_of, false_cov_max = kept_by_locus[locus]
        trks, ntrks = locus_trks[locus], locus_ntrks[locus]
        graph = bc.build_edge_graph(edges, bi=False)
        alive, dead = set(), set()
        alive_edges = set()
        root_edges = []
        first_row = len(rows)
        for node in graph:
            if node not in trks:
                continue
            root = bc.Arc(None, None, node)
            _, arcs = bc.arcs_from_node(graph, node)
            for arc in arcs:
                alive_path = bc.check_bubble_root_edge(
                    root, arc, graph, trks, ntrks, alive, dead)
                if alive_path:
                    covs = [cov_of[e] for e in alive_path]
                    n3, n4 = _coverage_gaps(covs)
                    rows.append([len(alive_path), np.mean(covs),
                                 np.std(covs), false_cov_max,
                                 np.mean(covs) - false_cov_max,
                                 n3, n4, None])
                    root_edges.append(arc.edge)
                    bubble_paths.append([locus, alive_path])
                    alive_edges |= alive_path
        # bidirectionality: was this bubble also reached via its RC?
        for i, e in enumerate(root_edges):
            rows[first_row + i][7] = bc.rc(e, bc.ESIZE) in alive_edges
    path_x = np.array(rows, dtype=np.float64).reshape(-1, len(PATH_COLS))
    return bubble_paths, path_x


def bp_svm_filter(bubble_paths, path_x, model_fn: str, device=None):
    """Stage-2 SVM on ``device``; returns locus -> [union edge set,
    per-bubble sets]."""
    accept = svm_accept(model_fn, path_x, PATH_COLS, device)
    calls = {}
    for keep, (locus, edges) in zip(accept, bubble_paths):
        if not keep:
            continue
        if locus not in calls:
            calls[locus] = [set(edges), [edges]]
        else:
            calls[locus][0] |= edges
            calls[locus][1].append(edges)
    for locus in calls:
        calls[locus][0] |= {bc.rc(e, bc.ESIZE) for e in calls[locus][0]}
    return calls


def build_metadata(pref: str, qcfilter=None):
    """Builds (qcfilter, locus_trks, locus_ntrks) from an RPGG's
    bidirectional kset DBs (`ktools raava` outputs <pref>.bi_tr.kdb /
    .bi_fl.kdb) -- the reference ships this as an opaque pickle."""
    from ..io import binary as bio

    def load(path):
        index, ks = bio.read_kset_db(path)
        out = {}
        p = 0
        for locus, n in enumerate(index.tolist()):
            out[locus] = set(ks[p : p + n].tolist())
            p += n
        return out

    locus_trks = load(pref + ".bi_tr.kdb")
    locus_ntrks = load(pref + ".bi_fl.kdb")
    if qcfilter is None:
        qcfilter = np.ones(len(locus_trks), dtype=int)
    return qcfilter, locus_trks, locus_ntrks


def call_rare_variants(qcfilter, locus_trks, locus_ntrks, tr_kmers_fn,
                       tr_index_fn, bub_fn, br_svm_fn, bp_svm_fn, nloci,
                       th=10, th1=5, th2=2, th3=8,
                       graph_size_limit=10000, device=None):
    """Full flow, both SVM stages on the torch ``device`` (``cuda`` by
    default; without a card this raises unless ``device="cpu"``); returns
    locus -> [edge set, per-bubble sets]."""
    device = resolve_device(device)
    tr_kmc = load_tr_kmc(tr_kmers_fn, tr_index_fn)
    bub_kmc = load_bubbles(bub_fn)
    if not bub_kmc:
        return {}
    table = find_tr_snarls(qcfilter, locus_trks, locus_ntrks, bub_kmc,
                           tr_kmc, nloci, th_cne=th,
                           graph_size_limit=graph_size_limit)
    _, accepted = br_svm_filter(table, br_svm_fn, th, device)
    if accepted.size == 0:
        return {}
    kept = filter_bubble_edges(accepted, table, nloci, th1, th2, th3)
    if not kept:
        return {}
    bubble_paths, path_x = bubble_path_features(kept, locus_trks,
                                                locus_ntrks)
    return bp_svm_filter(bubble_paths, path_x, bp_svm_fn, device)
