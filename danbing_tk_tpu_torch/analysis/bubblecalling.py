"""Snarl (bubble) traversal over novel-edge graphs (capability of
reference script/bubblecalling.py; behavior matched via fuzz tests
against the reference module, structure re-derived).

A sample's novel (k+1)-mer edges (.bub output) form a graph hanging off
the locus dBG.  Starting from a TR-rooted edge, a cyclic DFS walks the
graph: a branch SURVIVES when it reconnects to a TR k-mer or an already-
alive branch, and DIES at tips, NTR k-mers, or dead branches.  Cycles
and reconvergent paths collapse into supernodes so the walk terminates.

Fuzz-tested against the reference module on random graphs
(tests/test_bubblecalling.py).
"""

from __future__ import annotations

import numpy as np

from ..ops.kmers_np import revcomp_kmers

KSIZE = 21
ESIZE = 22


def rc(km: int, k: int) -> int:
    return int(revcomp_kmers(np.array([km], dtype=np.uint64), k)[0])


def e2ce(e: int) -> int:
    """Canonical (k+1)-mer edge."""
    return min(e, rc(e, ESIZE))


def k2ck(k: int) -> int:
    """Canonical k-mer node."""
    return min(k, rc(k, KSIZE))


class Arc:
    """One directed traversal step: the (k+1)-mer ``edge`` from node
    ``tail`` to node ``head``, linked into the DFS tree via ``up`` (the
    arc we came from) and ``down`` (arcs leaving ``head``)."""

    __slots__ = ("edge", "tail", "head", "alive", "up", "down")

    def __init__(self, edge, tail, head):
        self.edge = edge
        self.tail = tail
        self.head = head
        self.alive = False
        self.up = None
        self.down = []


def arcs_from_node(graph: dict, node: int):
    """Decode a node's 4-bit out-edge mask into Arc objects."""
    mask = (1 << (2 * KSIZE)) - 1
    shifted = (node << 2) & mask
    arcs = [Arc((node << 2) + nt, node, shifted + nt)
            for nt in range(4) if (graph[node] >> nt) & 1]
    return len(arcs), arcs


def build_edge_graph(edges, k: int = ESIZE, bi: bool = True) -> dict:
    """Edge set -> {node: 4-bit out-mask}, bidirectional by default."""
    graph: dict[int, int] = {}
    for e in edges:
        e = int(e)
        graph[e >> 2] = graph.get(e >> 2, 0) | (1 << (e & 3))
        if bi:
            er = rc(e, k)
            graph[er >> 2] = graph.get(er >> 2, 0) | (1 << (er & 3))
    return graph


class _Supernode:
    """A collapsed cycle/reconvergence: the member nodes and arcs, plus
    the exit point the walk resumes from when the supernode resolves."""

    __slots__ = ("exit_node", "exit_arc", "nodes", "arcs")

    def __init__(self, exit_node, exit_arc, nodes, arcs):
        self.exit_node = exit_node
        self.exit_arc = exit_arc
        self.nodes = nodes
        self.arcs = arcs


class SnarlWalker:
    """Cyclic-DFS state: pending branch stack, grey (in-progress) nodes,
    and supernode bookkeeping.

    NOTE: ``_drop_super`` removes by list.pop(index), shifting the ids of
    later supernodes while ``super_of`` keeps the old indices — replicated
    from the reference so fuzz results stay identical."""

    def __init__(self):
        self.stack: list[Arc] = []
        self.grey: set[int] = set()
        self.supers: list[_Supernode | None] = []
        self.super_of: dict[int, int] = {}

    def link(self, parent: Arc, children):
        for child in children:
            parent.down.append(child)
            child.up = parent

    def prune(self, dead: set, arc: Arc) -> Arc:
        """Retract a dead branch: walk up while unbranched, killing the
        traversed heads; detach at the first branching arc."""
        killed = set()
        last = None
        while len(arc.down) < 2 and arc.edge is not None:
            killed.add(arc.head)
            last = arc
            arc = arc.up
        if arc.edge is not None:
            arc.down.remove(last)
            last.up = None
        dead |= killed
        self.grey -= killed
        return arc

    def _drop_super(self, idx: int):
        for node in self.supers[idx].nodes:
            self.super_of.pop(node)
        self.supers.pop(idx)

    def make_alive(self, alive: set, alive_edges: set, arc: Arc):
        """Propagate survival up from ``arc``: every arc on the way to
        the root (or to an already-alive arc) survives; supernodes on the
        path survive wholesale and the walk continues from their exit."""
        survived = set()
        while True:
            if arc.edge is None or arc.alive:
                break
            if arc.tail in self.super_of:
                sup = self.supers[self.super_of[arc.tail]]
                survived |= sup.nodes
                for member in sup.arcs:
                    alive_edges.add(member.edge)
                    arc.alive = True
                self._drop_super(self.super_of[arc.tail])
                arc = sup.exit_arc
            else:
                survived.add(arc.tail)
                alive_edges.add(arc.edge)
                arc.alive = True
                arc = arc.up
        alive |= survived
        self.grey -= survived
        return self.stack[-1].up if self.stack else None

    def merge(self, arc: Arc) -> Arc:
        """Fold the cycle closed by ``arc`` (head already grey) into a
        supernode, absorbing any supernodes met on the way around."""
        if arc.head in self.super_of:
            exit_node = self.supers[self.super_of[arc.head]].exit_node
        else:
            exit_node = arc.head
        nodes = {arc.tail, arc.head}
        arcs = [arc]
        absorbed = ({self.super_of[arc.tail]}
                    if arc.tail in self.super_of else set())
        resume_tail = self.stack[-1].tail if self.stack else None
        found = arc if arc.head == resume_tail else False
        while arc.tail != exit_node:
            arc = arc.up
            assert arc.edge is not None
            if arc.head == resume_tail:
                found = arc
            if arc.tail in self.super_of:
                absorbed.add(self.super_of[arc.tail])
            else:
                nodes.add(arc.tail)
                arcs.append(arc)
        for idx in absorbed:
            sup = self.supers[idx]
            nodes |= sup.nodes
            arcs += sup.arcs
            self.supers[idx] = None
        self.supers.append(_Supernode(exit_node, arc.up, nodes, arcs))
        idx = len(self.supers) - 1
        for node in nodes:
            self.super_of[node] = idx
        return found if found else arc

    def check_survival(self, dead: set, arc: Arc):
        """At a backtrack point: if ``arc`` heads into a supernode AT its
        exit node, the supernode never found life — kill it and prune."""
        head = arc.head
        if head not in self.super_of:
            return None
        idx = self.super_of[head]
        if head != self.supers[idx].exit_node:
            return None
        for child in arc.down:
            child.up = None
        arc.down = []
        doomed = self.supers[idx].nodes
        dead |= doomed
        self.grey -= doomed
        self._drop_super(idx)
        return self.prune(dead, arc)


def check_edge_v1(graph, trks, ntrks, arc, walker, alive, alive_edges,
                  dead):
    """Classify one arc: 0 = dead (pruned), 1 = keep walking,
    2 = cycle (merged), 3 = survived (propagated)."""
    if arc.tail == arc.head:
        return 0, walker.prune(dead, arc)
    if arc.head in alive or arc.head in trks:
        return 3, walker.make_alive(alive, alive_edges, arc)
    if arc.head not in graph:
        dead.add(arc.head)
        return 0, walker.prune(dead, arc)
    if arc.head in dead or arc.head in ntrks:
        return 0, walker.prune(dead, arc)
    if arc.head in walker.grey:
        return 2, walker.merge(arc)
    walker.grey.add(arc.head)
    return 1, 0


def check_bubble_root_edge(root, arc, graph, trks, ntrks, alive, dead):
    """DFS from one TR-rooted arc; returns the surviving edge set."""
    alive_edges: set[int] = set()
    walker = SnarlWalker()
    walker.stack = [arc]
    walker.link(root, [arc])
    while True:
        cur = walker.stack.pop()
        verdict, back = check_edge_v1(graph, trks, ntrks, cur, walker,
                                      alive, alive_edges, dead)
        while back == 0:
            n, children = arcs_from_node(graph, cur.head)
            walker.link(cur, children)
            if n > 1:
                walker.stack.extend(children[:-1])
            cur = children[-1]
            verdict, back = check_edge_v1(graph, trks, ntrks, cur, walker,
                                          alive, alive_edges, dead)
        if not walker.stack:
            break
        resume_tail = walker.stack[-1].tail
        while back.head != resume_tail:
            out = walker.check_survival(dead, back)
            back = back.up if out is None else out
    return alive_edges
