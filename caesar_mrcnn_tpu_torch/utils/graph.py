"""Connected components and maximal cliques over small undirected graphs.

Replaces the reference's recursive-DFS ``Graph`` (reference:
mrcnn/graph.py:4-43) with an iterative union-find (no recursion limit —
the reference's recursive DFS overflowed on large merge graphs).

The port's copy of ``caesar_mrcnn_tpu/utils/graph.py``, unchanged in
behaviour, plus :func:`find_cliques`, the port's copy of
``networkx.find_cliques`` (the JAX package's Analyzer calls networkx, which
the port does not use).
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Mapping, Sequence


class UnionFind:
    def __init__(self, n: int):
        self.parent = list(range(n))
        self.rank = [0] * n

    def find(self, x: int) -> int:
        root = x
        while self.parent[root] != root:
            root = self.parent[root]
        while self.parent[x] != root:  # path compression
            self.parent[x], x = root, self.parent[x]
        return root

    def union(self, a: int, b: int) -> None:
        ra, rb = self.find(a), self.find(b)
        if ra == rb:
            return
        if self.rank[ra] < self.rank[rb]:
            ra, rb = rb, ra
        self.parent[rb] = ra
        if self.rank[ra] == self.rank[rb]:
            self.rank[ra] += 1


class Graph:
    """API-compatible with the reference's Graph: addEdge + connectedComponents."""

    def __init__(self, num_vertices: int):
        self.V = num_vertices
        self._uf = UnionFind(num_vertices)

    def addEdge(self, v: int, w: int) -> None:  # noqa: N802 (reference API)
        self._uf.union(v, w)

    add_edge = addEdge

    def connectedComponents(self) -> List[List[int]]:  # noqa: N802
        """Components as lists of vertex ids, in first-seen order
        (reference: mrcnn/graph.py:33-43)."""
        groups: Dict[int, List[int]] = {}
        for v in range(self.V):
            groups.setdefault(self._uf.find(v), []).append(v)
        return list(groups.values())

    connected_components = connectedComponents


def find_cliques(adj: Mapping[int, Sequence[int]]) -> Iterator[List[int]]:
    """Maximal cliques of an undirected graph, as ``networkx.find_cliques``
    yields them: the same cliques, in the same order, each with its members
    in the same order.

    ``adj`` maps each node, in the order the nodes were added, to its
    neighbours in the order the edges were added (what iterating a
    ``networkx.Graph`` and its ``G[u]`` gives). The order matters to
    callers: the Analyzer keeps the first member of equal score.

    Bron–Kerbosch with Tomita's pivot, iterative: the body of networkx
    3.x's ``find_cliques`` (``networkx/algorithms/clique.py``; networkx is
    BSD-3-Clause, copyright NetworkX Developers) without its ``nodes``
    argument. The set operations are the same, in the same order, so that
    Python's set iteration yields the same pops and maxima.
    """
    if len(adj) == 0:
        return

    adj = {u: {v for v in adj[u] if v != u} for u in adj}

    Q: List = [None]
    cand = set(adj)
    subg = cand.copy()
    stack = []

    u = max(subg, key=lambda u: len(cand & adj[u]))
    ext_u = cand - adj[u]

    try:
        while True:
            if ext_u:
                q = ext_u.pop()
                cand.remove(q)
                Q[-1] = q
                adj_q = adj[q]
                subg_q = subg & adj_q
                if not subg_q:
                    yield Q[:]
                else:
                    cand_q = cand & adj_q
                    if cand_q:
                        stack.append((subg, cand, ext_u))
                        Q.append(None)
                        subg = subg_q
                        cand = cand_q
                        u = max(subg, key=lambda u: len(cand & adj[u]))
                        ext_u = cand - adj[u]
            else:
                Q.pop()
                subg, cand, ext_u = stack.pop()
    except IndexError:
        pass
