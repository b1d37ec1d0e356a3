"""Vertex graph colouring for parallel Gauss-Seidel solvers (port of
``newton_tpu/sim/graph_coloring.py``, kept as its own copy so the port
never imports the JAX package).

Host-side numpy: ``color_graph`` (maximum-cardinality-search or greedy
order, then first-fit colours and a balancing pass), ``color_trimesh``,
``validate_graph_coloring`` and ``combine_independent_particle_coloring``
give the JAX package's colours in the same order, because ``SolverVBD``'s
Gauss-Seidel order, and so its result, follows them. The colour groups
become static index tensors, so a solver runs the colours in sequence and
the vertices of one colour all at once.
"""

from __future__ import annotations

import enum
from typing import List, Sequence, Tuple

import numpy as np

__all__ = ["ColoringAlgorithm", "color_graph", "color_trimesh",
           "validate_graph_coloring", "combine_independent_particle_coloring"]


class ColoringAlgorithm(enum.Enum):
    """(reference: graph_coloring.py:12)"""

    GREEDY = 0
    MCS = 1


def _adjacency(num_nodes: int, edges: np.ndarray) -> List[set]:
    adj: List[set] = [set() for _ in range(num_nodes)]
    for a, b in edges:
        if a == b:
            continue
        adj[int(a)].add(int(b))
        adj[int(b)].add(int(a))
    return adj


def color_graph(num_nodes: int, edges,
                algorithm: ColoringAlgorithm = ColoringAlgorithm.MCS,
                balance_colors: bool = True) -> List[np.ndarray]:
    """Color a constraint graph; returns per-color node index arrays
    (reference: graph_coloring.py:243)."""
    edges = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
    adj = _adjacency(num_nodes, edges)

    order: List[int]
    if algorithm == ColoringAlgorithm.MCS:
        # maximum cardinality search ordering
        weight = np.zeros(num_nodes, dtype=np.int64)
        visited = np.zeros(num_nodes, dtype=bool)
        order = []
        for _ in range(num_nodes):
            cand = np.where(~visited)[0]
            v = int(cand[np.argmax(weight[cand])])
            visited[v] = True
            order.append(v)
            for u in adj[v]:
                if not visited[u]:
                    weight[u] += 1
    else:
        order = sorted(range(num_nodes), key=lambda v: -len(adj[v]))

    colors = -np.ones(num_nodes, dtype=np.int64)
    for v in order:
        used = {int(colors[u]) for u in adj[v] if colors[u] >= 0}
        c = 0
        while c in used:
            c += 1
        colors[v] = c
    n_colors = int(colors.max()) + 1 if num_nodes else 0

    if balance_colors and n_colors > 1:
        # move nodes from large to small color classes when legal
        sizes = np.bincount(colors, minlength=n_colors)
        target = num_nodes / n_colors
        for v in range(num_nodes):
            c = int(colors[v])
            if sizes[c] <= target:
                continue
            used = {int(colors[u]) for u in adj[v]}
            for c2 in np.argsort(sizes):
                if int(c2) not in used and sizes[c2] < sizes[c] - 1:
                    sizes[c] -= 1
                    sizes[int(c2)] += 1
                    colors[v] = int(c2)
                    break
    return [np.where(colors == c)[0].astype(np.int32)
            for c in range(n_colors)]


def color_trimesh(num_particles: int, tri_indices,
                  algorithm: ColoringAlgorithm = ColoringAlgorithm.MCS
                  ) -> List[np.ndarray]:
    """Color cloth particles so no two adjacent (edge-sharing) particles
    share a color."""
    tris = np.asarray(tri_indices, dtype=np.int64).reshape(-1, 3)
    edges = np.concatenate([tris[:, [0, 1]], tris[:, [1, 2]], tris[:, [2, 0]]])
    return color_graph(num_particles, edges, algorithm)


def validate_graph_coloring(edges, groups: Sequence[np.ndarray]) -> bool:
    """No edge joins two nodes of the same color
    (reference: graph_coloring.py:26 expect-kernel)."""
    color_of = {}
    for c, g in enumerate(groups):
        for v in g:
            color_of[int(v)] = c
    for a, b in np.asarray(edges).reshape(-1, 2):
        if int(a) == int(b):
            continue
        if color_of.get(int(a)) == color_of.get(int(b)):
            return False
    return True


def combine_independent_particle_coloring(groups_a, groups_b):
    """Merge colorings of two independent particle systems
    (reference: graph_coloring utility) — pad the shorter list and
    concatenate per-color groups."""
    out = []
    for i in range(max(len(groups_a), len(groups_b))):
        parts = []
        if i < len(groups_a):
            parts.append(np.asarray(groups_a[i]))
        if i < len(groups_b):
            parts.append(np.asarray(groups_b[i]))
        out.append(np.concatenate(parts).astype(np.int32))
    return out
