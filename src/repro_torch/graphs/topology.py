"""Complex-network topologies for decentralized learning (a numpy copy of
the JAX package's `graphs/topology.py`: the same seed gives the same graph
in both packages, branch by branch).

The paper runs on an Erdős–Rényi graph (50 nodes, p=0.2 — above the ln(n)/n
connectivity threshold) and motivates with a Barabási–Albert example.  We
provide those plus other standard families from network science so the impact
of topology can be studied (ring, star, complete, Watts–Strogatz, 2-D grid).

A :class:`Topology` packages everything the vmapped simulator and the sharded
runtime need:
  * dense adjacency / weight matrices (numpy, row i = in-neighbourhood of i),
  * padded neighbour index/weight arrays (fixed max-degree layout for vmap),
  * graph metadata (family, parameters, connectivity).

Edge weights ω_ij default to 1 ("a simple communication link"), but any
positive weighting (e.g. social trust) can be attached via `weight_fn`.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import numpy as np

try:  # networkx when installed; the fallback samplers otherwise (they draw
    # other graphs than networkx for the same seed)
    import networkx as nx

    _HAVE_NX = True
except ImportError:  # pragma: no cover
    _HAVE_NX = False


@dataclasses.dataclass(frozen=True)
class Topology:
    """A static communication graph G(V, E) with weighted edges."""

    name: str
    num_nodes: int
    adjacency: np.ndarray  # [N, N] {0,1}, no self loops
    weights: np.ndarray  # [N, N] float, ω_ij (0 where no edge)
    neighbor_idx: np.ndarray  # [N, max_deg] int, padded with -1
    neighbor_mask: np.ndarray  # [N, max_deg] {0,1}
    max_degree: int
    connected: bool

    @property
    def degrees(self) -> np.ndarray:
        return self.adjacency.sum(axis=1).astype(np.int64)

    @property
    def num_edges(self) -> int:
        return int(self.adjacency.sum()) // 2

    def neighbor_weights(self) -> np.ndarray:
        """[N, max_deg] ω_ij aligned with neighbor_idx (0 at padding).

        One fancy-indexed gather over the padded layout (padding slots are
        clamped to column 0 and zeroed by the mask) — the O(N·max_deg)
        Python loop this replaces is pinned equivalent in
        tests/test_graphs_data.py."""
        n = self.num_nodes
        idx = np.maximum(self.neighbor_idx, 0)
        gathered = self.weights[np.arange(n)[:, None], idx]
        return (gathered * self.neighbor_mask).astype(np.float32)


def _is_connected(adj: np.ndarray) -> bool:
    n = adj.shape[0]
    seen = np.zeros(n, bool)
    stack = [0]
    seen[0] = True
    while stack:
        u = stack.pop()
        for v in np.nonzero(adj[u])[0]:
            if not seen[v]:
                seen[v] = True
                stack.append(int(v))
    return bool(seen.all())


def _padded_neighbors(adj: np.ndarray):
    """Vectorized padded neighbour layout from a dense {0,1} adjacency.

    Returns (neighbor_idx, neighbor_mask, max_degree).  `np.nonzero` is
    row-major, so within each row the neighbour ids come out ascending —
    the same order the per-row Python loop produced."""
    n = adj.shape[0]
    degs = adj.sum(axis=1).astype(np.int64)
    max_deg = max(int(degs.max()), 1)
    nbr = -np.ones((n, max_deg), np.int32)
    msk = np.zeros((n, max_deg), np.int8)
    rows, cols = np.nonzero(adj)
    if rows.size:
        starts = np.zeros(n, np.int64)
        np.cumsum(degs[:-1], out=starts[1:])
        pos = np.arange(rows.size) - np.repeat(starts, degs)
        nbr[rows, pos] = cols.astype(np.int32)
        msk[rows, pos] = 1
    return nbr, msk, max_deg


def _from_adjacency(name: str, adj: np.ndarray,
                    weight_fn: Optional[Callable[[int, int, np.random.Generator], float]] = None,
                    rng: Optional[np.random.Generator] = None) -> Topology:
    n = adj.shape[0]
    adj = adj.astype(np.int8)
    np.fill_diagonal(adj, 0)
    adj = np.maximum(adj, adj.T)  # undirected
    if weight_fn is None:
        weights = (adj != 0).astype(np.float32)
    else:
        # keep the explicit upper-triangle loop: weight_fn sees (i, j, rng)
        # in a defined order, so vectorizing would change the rng stream.
        rng = rng or np.random.default_rng(0)
        weights = np.zeros((n, n), np.float32)
        for i in range(n):
            for j in range(i + 1, n):
                if adj[i, j]:
                    w = float(weight_fn(i, j, rng))
                    weights[i, j] = weights[j, i] = w
    nbr, msk, max_deg = _padded_neighbors(adj)
    return Topology(
        name=name,
        num_nodes=n,
        adjacency=adj,
        weights=weights,
        neighbor_idx=nbr,
        neighbor_mask=msk,
        max_degree=max_deg,
        connected=_is_connected(adj),
    )


# ---------------------------------------------------------------- builders


def erdos_renyi(n: int, p: float = 0.2, seed: int = 0, ensure_connected: bool = True,
                **kw) -> Topology:
    """ER(n, p).  The paper uses n=50, p=0.2 (>> ln(50)/50 ≈ 0.078 threshold)."""
    for attempt in range(64):
        s = seed + attempt * 10007
        if _HAVE_NX:
            g = nx.erdos_renyi_graph(n, p, seed=s)
            adj = nx.to_numpy_array(g, dtype=np.int8)
        else:  # pragma: no cover
            r = np.random.default_rng(s)
            adj = (r.random((n, n)) < p).astype(np.int8)
            adj = np.triu(adj, 1)
            adj = adj + adj.T
        topo = _from_adjacency(f"erdos_renyi(n={n},p={p})", adj, **kw)
        if topo.connected or not ensure_connected:
            return topo
    raise RuntimeError(f"could not sample a connected ER({n},{p}) graph")


def barabasi_albert(n: int, m: int = 2, seed: int = 0,
                    ensure_connected: bool = True, **kw) -> Topology:
    """BA preferential-attachment graph (paper Fig. 1 motivating example).

    The networkx builder is connected by construction; the fallback sampler
    can leave early nodes isolated, so it gets the same seeded retry loop as
    :func:`erdos_renyi` (attempt 0 uses `seed` itself, preserving the
    original stream for graphs that come out connected first try).
    """
    for attempt in range(64):
        s = seed + attempt * 10007
        if _HAVE_NX:
            g = nx.barabasi_albert_graph(n, m, seed=s)
            adj = nx.to_numpy_array(g, dtype=np.int8)
        else:
            r = np.random.default_rng(s)
            adj = np.zeros((n, n), np.int8)
            # node m links to every seed node 0..m-1 (as in the standard
            # construction); without this the seeds root disjoint attachment
            # trees and m=1 graphs can never come out connected.
            adj[m, :m] = adj[:m, m] = 1
            for v in range(m + 1, n):
                deg = adj.sum(axis=1)[:v] + 1.0
                targets = r.choice(v, size=min(m, v), replace=False, p=deg / deg.sum())
                for t in targets:
                    adj[v, t] = adj[t, v] = 1
        topo = _from_adjacency(f"barabasi_albert(n={n},m={m})", adj, **kw)
        if topo.connected or not ensure_connected:
            return topo
    raise RuntimeError(f"could not sample a connected BA({n},{m}) graph")


def watts_strogatz(n: int, k: int = 4, p: float = 0.1, seed: int = 0, **kw) -> Topology:
    if _HAVE_NX:
        g = nx.connected_watts_strogatz_graph(n, k, p, seed=seed)
        adj = nx.to_numpy_array(g, dtype=np.int8)
    else:  # pragma: no cover
        raise RuntimeError("watts_strogatz requires networkx")
    return _from_adjacency(f"watts_strogatz(n={n},k={k},p={p})", adj, **kw)


def ring(n: int, **kw) -> Topology:
    adj = np.zeros((n, n), np.int8)
    for i in range(n):
        adj[i, (i + 1) % n] = adj[(i + 1) % n, i] = 1
    return _from_adjacency(f"ring(n={n})", adj, **kw)


def star(n: int, **kw) -> Topology:
    """Star graph — FL's implicit topology with the server at the hub."""
    adj = np.zeros((n, n), np.int8)
    adj[0, 1:] = adj[1:, 0] = 1
    return _from_adjacency(f"star(n={n})", adj, **kw)


def complete(n: int, **kw) -> Topology:
    adj = np.ones((n, n), np.int8)
    return _from_adjacency(f"complete(n={n})", adj, **kw)


def grid2d(rows: int, cols: int, **kw) -> Topology:
    n = rows * cols
    adj = np.zeros((n, n), np.int8)
    for r in range(rows):
        for c in range(cols):
            u = r * cols + c
            if c + 1 < cols:
                adj[u, u + 1] = adj[u + 1, u] = 1
            if r + 1 < rows:
                adj[u, u + cols] = adj[u + cols, u] = 1
    return _from_adjacency(f"grid2d({rows}x{cols})", adj, **kw)


TOPOLOGY_BUILDERS: Dict[str, Callable[..., Topology]] = {
    "erdos_renyi": erdos_renyi,
    "barabasi_albert": barabasi_albert,
    "watts_strogatz": watts_strogatz,
    "ring": ring,
    "star": star,
    "complete": complete,
    "grid2d": grid2d,
}


def make_topology(name: str, **kwargs) -> Topology:
    try:
        builder = TOPOLOGY_BUILDERS[name]
    except KeyError:
        raise ValueError(
            f"unknown topology {name!r}; available: {sorted(TOPOLOGY_BUILDERS)}"
        ) from None
    return builder(**kwargs)
