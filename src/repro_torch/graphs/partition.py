"""Mapping a DFL communication graph onto pods (a numpy copy of the JAX
package's `graphs/partition.py`).

Each pod owns a group of graph nodes; for graphs larger than the pod count
the nodes are partitioned into `num_pods` balanced groups (a greedy BFS
partition), and only the cut edges cross pods.
"""
from __future__ import annotations

from typing import List

import numpy as np

from repro_torch.graphs.topology import Topology


def map_graph_to_pods(topo: Topology, num_pods: int) -> List[List[int]]:
    """Partition the graph's nodes into `num_pods` balanced,
    connectivity-aware groups; returns one node-id list per pod.

    Sizes are exact ±1 (a `divmod` split: the first `n % num_pods` groups
    get one extra node) and never empty.  Each group seeds at the
    highest-degree unassigned node (ties toward the lowest id) and grows by
    BFS; a stalled frontier (a disconnected remainder) fills from the
    lowest unassigned id."""
    n = topo.num_nodes
    if num_pods < 1:
        raise ValueError(f"num_pods must be >= 1, got {num_pods}")
    if num_pods > n:
        raise ValueError(
            f"num_pods={num_pods} > num_nodes={n} would leave empty pods; "
            "shard_map needs at least one node per pod")
    base, rem = divmod(n, num_pods)
    sizes = [base + 1 if g < rem else base for g in range(num_pods)]
    degrees = topo.degrees
    unassigned = set(range(n))
    groups: List[List[int]] = []
    for size in sizes:
        seed = max(unassigned, key=lambda u: (int(degrees[u]), -u))
        group = [seed]
        unassigned.discard(seed)
        frontier = [seed]
        while len(group) < size and frontier:
            u = frontier.pop(0)
            for v in np.nonzero(topo.adjacency[u])[0]:
                v = int(v)
                if v in unassigned and len(group) < size:
                    group.append(v)
                    unassigned.discard(v)
                    frontier.append(v)
        while len(group) < size and unassigned:
            v = min(unassigned)
            unassigned.discard(v)
            group.append(v)
        groups.append(group)
    if unassigned:
        raise RuntimeError(f"nodes {sorted(unassigned)} left unassigned")
    return groups


def pod_adjacency(topo: Topology, groups: List[List[int]]) -> np.ndarray:
    """Quotient adjacency between pods [P, P] float32: two pods are
    neighbours iff a cut edge joins their groups, weighted by the summed ω
    over the cut (accumulated in row-major edge order)."""
    p = len(groups)
    where = np.zeros(topo.num_nodes, np.int64)
    for g, nodes in enumerate(groups):
        if nodes:
            where[np.asarray(nodes, np.int64)] = g
    u, v = np.nonzero(topo.adjacency)
    gu, gv = where[u], where[v]
    cut = gu != gv
    w = np.zeros((p, p), np.float32)
    np.add.at(w, (gu[cut], gv[cut]),
              topo.weights[u[cut], v[cut]].astype(np.float32))
    return w
