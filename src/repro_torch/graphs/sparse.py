"""Sparse CSR/edge-list topologies: the node axis at 10^4-10^6 participants
(a numpy copy of the JAX package's `graphs/sparse.py`: the same seed gives
the same arrays in both packages).

The dense :class:`~repro_torch.graphs.topology.Topology` materializes `[N, N]`
adjacency/weight matrices and a `[N, max_deg]` padded layout — O(N^2) memory
and, on hub-heavy graphs (star, BA), O(N^2) padding even when E is O(N).
:class:`SparseTopology` stores the directed edge list flat (`edge_src`,
`edge_dst`, `edge_weight`, sorted by `(dst, src)`) plus CSR `row_offsets`
over the receiver axis, so memory is O(N + E) and the builders sample
BA/ER/WS graphs with vectorized numpy instead of per-pair Python loops.

The two representations are exact duals at small N: `from_topology` /
`to_topology` round-trip bitwise (same neighbour order — src ascending per
receiver row — and the same float32 ω), which is what lets the dense engine
serve as the sparse engine's bit-equivalence oracle.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import numpy as np

from repro_torch.graphs.topology import Topology, _padded_neighbors

# Above this the dense [N, N] detour is refused: 4096^2 float32 weights is
# already 64 MiB and the padded layout on a star would be another 64 MiB.
_DENSE_GUARD = 4096


def _csr_connected(n: int, row_offsets: np.ndarray, edge_src: np.ndarray) -> bool:
    """BFS over the CSR structure with numpy frontier expansion (no per-node
    Python loop): one gather of all frontier neighbours per level."""
    if n == 0:
        return True
    seen = np.zeros(n, bool)
    seen[0] = True
    frontier = np.array([0], np.int64)
    while frontier.size:
        starts = row_offsets[frontier]
        counts = row_offsets[frontier + 1] - starts
        total = int(counts.sum())
        if total == 0:
            break
        base = np.repeat(starts, counts)
        local = np.arange(total) - np.repeat(np.cumsum(counts) - counts, counts)
        nbrs = edge_src[base + local]
        new = np.unique(nbrs[~seen[nbrs]])
        seen[new] = True
        frontier = new
    return bool(seen.all())


@dataclasses.dataclass(frozen=True)
class SparseTopology:
    """A static communication graph in flat directed edge-list form.

    Edges are directed (each undirected link appears twice) and sorted by
    `(dst, src)`: `row_offsets[i]:row_offsets[i+1]` slices the incoming
    edges of receiver `i`, senders ascending — the same per-row neighbour
    order as the dense padded layout."""

    name: str
    num_nodes: int
    edge_src: np.ndarray  # [E] int32, sender of each directed edge
    edge_dst: np.ndarray  # [E] int32, receiver (non-decreasing)
    edge_weight: np.ndarray  # [E] float32, ω_ij
    row_offsets: np.ndarray  # [N+1] int64, CSR offsets over edge_dst
    connected: bool

    @property
    def num_directed(self) -> int:
        return int(self.edge_src.shape[0])

    @property
    def num_edges(self) -> int:
        return self.num_directed // 2

    @property
    def degrees(self) -> np.ndarray:
        return np.diff(self.row_offsets).astype(np.int64)

    @property
    def max_degree(self) -> int:
        return max(int(self.degrees.max()), 1) if self.num_nodes else 1

    # ------------------------------------------------------------ converters

    @staticmethod
    def from_pairs(name: str, n: int, u: np.ndarray, v: np.ndarray,
                   weights: Optional[np.ndarray] = None) -> "SparseTopology":
        """Build from undirected pairs (self loops dropped, duplicates and
        orientation collapsed; `weights` aligns with the input pairs and the
        first occurrence of a duplicate wins)."""
        u = np.asarray(u, np.int64)
        v = np.asarray(v, np.int64)
        keep = u != v
        u, v = u[keep], v[keep]
        w = (np.ones(u.shape[0], np.float32) if weights is None
             else np.asarray(weights, np.float32)[keep])
        lo, hi = np.minimum(u, v), np.maximum(u, v)
        code = lo * n + hi
        _, first = np.unique(code, return_index=True)
        lo, hi, w = lo[first], hi[first], w[first]
        src = np.concatenate([lo, hi]).astype(np.int32)
        dst = np.concatenate([hi, lo]).astype(np.int32)
        ww = np.concatenate([w, w])
        order = np.lexsort((src, dst))
        src, dst, ww = src[order], dst[order], ww[order]
        offsets = np.searchsorted(dst, np.arange(n + 1)).astype(np.int64)
        return SparseTopology(
            name=name, num_nodes=n, edge_src=src, edge_dst=dst,
            edge_weight=ww, row_offsets=offsets,
            connected=_csr_connected(n, offsets, src),
        )

    @staticmethod
    def from_topology(topo: Topology) -> "SparseTopology":
        dst, src = np.nonzero(topo.adjacency)  # row i = in-neighbourhood of i
        w = topo.weights[dst, src].astype(np.float32)
        offsets = np.searchsorted(dst, np.arange(topo.num_nodes + 1))
        return SparseTopology(
            name=topo.name, num_nodes=topo.num_nodes,
            edge_src=src.astype(np.int32), edge_dst=dst.astype(np.int32),
            edge_weight=w, row_offsets=offsets.astype(np.int64),
            connected=topo.connected,
        )

    def to_topology(self) -> Topology:
        n = self.num_nodes
        if n > _DENSE_GUARD:
            raise ValueError(
                f"refusing to densify a {n}-node SparseTopology "
                f"(> {_DENSE_GUARD}): the [N, N] matrices it would build are "
                "exactly what the sparse layout exists to avoid")
        adj = np.zeros((n, n), np.int8)
        weights = np.zeros((n, n), np.float32)
        adj[self.edge_dst, self.edge_src] = 1
        weights[self.edge_dst, self.edge_src] = self.edge_weight
        nbr, msk, max_deg = _padded_neighbors(adj)
        return Topology(
            name=self.name, num_nodes=n, adjacency=adj, weights=weights,
            neighbor_idx=nbr, neighbor_mask=msk, max_degree=max_deg,
            connected=self.connected,
        )


# ------------------------------------------------------- edge-index helpers


def rev_edge_permutation(st: SparseTopology) -> np.ndarray:
    """[E] permutation pairing each directed edge with its reverse.

    `rev[e]` is the CSR position of the directed edge `(dst[e] -> src[e])` —
    the opposite record of the same undirected link.  The sparse per-edge
    transport keys BOTH directions' state by CSR edge id directly, so this
    permutation replaces the dense layout's `[N, max_deg]` reverse-slot
    gather; it is an involution (`rev[rev[e]] == e`)."""
    n = np.int64(st.num_nodes)
    src = st.edge_src.astype(np.int64)
    dst = st.edge_dst.astype(np.int64)
    # edges are sorted by (dst, src), so dst*n + src is strictly ascending
    # and searchsorted resolves the reverse edge's position exactly.
    rev = np.searchsorted(dst * n + src, src * n + dst)
    return rev.astype(np.int32)


def undirected_pair_ids(st: SparseTopology) -> Tuple[np.ndarray, int]:
    """[E] map from directed edge to canonical undirected pair id.

    Pairs are enumerated in ascending `(lo, hi)` order (`lo*n + hi` codes) —
    the SAME order the dense layout's `np.triu` enumeration yields — so a
    single `[num_pairs]` random draw indexed through this map produces
    bit-identical per-link coins on both layouts.  Returns
    `(pair_id [E] int32, num_pairs)`; `pair_id[e] == pair_id[rev[e]]`."""
    n = np.int64(st.num_nodes)
    lo = np.minimum(st.edge_src, st.edge_dst).astype(np.int64)
    hi = np.maximum(st.edge_src, st.edge_dst).astype(np.int64)
    codes, inv = np.unique(lo * n + hi, return_inverse=True)
    return inv.astype(np.int32), int(codes.shape[0])


# ------------------------------------------------------------------ builders
#
# All samplers are vectorized numpy (no per-pair Python loops) and mirror the
# dense builders' retry convention: attempt k reseeds at `seed + k * 10007`
# until the graph comes out connected (or `ensure_connected=False`).


def _retry(sample: Callable[[int], SparseTopology], seed: int,
           ensure_connected: bool, what: str) -> SparseTopology:
    for attempt in range(64):
        st = sample(seed + attempt * 10007)
        if st.connected or not ensure_connected:
            return st
    raise RuntimeError(f"could not sample a connected {what} graph")


def _pair_decode(n: int, codes: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Invert row-major upper-triangle enumeration: code k -> (i, j), i<j.
    Exact integer inversion via searchsorted on the per-row prefix sums."""
    rows = np.arange(n, dtype=np.int64)
    # offsets[i] = number of pairs in rows < i = i*n - i*(i+1)/2
    offsets = rows * n - rows * (rows + 1) // 2
    i = np.searchsorted(offsets, codes, side="right") - 1
    j = codes - offsets[i] + i + 1
    return i, j


def sparse_erdos_renyi(n: int, p: float = 0.2, seed: int = 0,
                       ensure_connected: bool = True) -> SparseTopology:
    """Exact G(n, p): E ~ Binomial(n(n-1)/2, p) distinct pairs, sampled by
    integer pair-code (rejection top-up, no [N, N] bernoulli matrix)."""
    m_all = n * (n - 1) // 2

    def sample(s: int) -> SparseTopology:
        r = np.random.default_rng(s)
        e = int(r.binomial(m_all, p)) if 0.0 < p < 1.0 else int(round(m_all * p))
        codes = np.unique(r.integers(0, m_all, size=e, dtype=np.int64))
        while codes.shape[0] < e:  # top up collisions; a few rounds at most
            extra = r.integers(0, m_all, size=e - codes.shape[0], dtype=np.int64)
            codes = np.unique(np.concatenate([codes, extra]))
        u, v = _pair_decode(n, codes)
        return SparseTopology.from_pairs(f"erdos_renyi(n={n},p={p})", n, u, v)

    return _retry(sample, seed, ensure_connected, f"ER({n},{p})")


def sparse_barabasi_albert(n: int, m: int = 2, seed: int = 0,
                           ensure_connected: bool = True) -> SparseTopology:
    """BA preferential attachment, vectorized (Batagelj–Brandes repeated-nodes
    with pointer chasing instead of a sequential Python loop).

    Node `m` links to seeds 0..m-1; each later node draws m targets uniformly
    from the repeated-endpoints array.  That array's layout is deterministic
    — even slots hold the step's source, odd slots hold drawn targets — so
    a drawn index resolves either immediately (even / seed slot) or by
    chasing to a strictly earlier step's draw: expected O(log) vectorized
    hops.  Duplicate targets within a node collapse (degree can come out
    slightly under m, as in the multigraph formulation); connectivity holds
    by construction, so the retry loop never fires for valid inputs.
    """
    if not 1 <= m < n:
        raise ValueError(f"need 1 <= m < n, got m={m}, n={n}")

    def sample(s: int) -> SparseTopology:
        r = np.random.default_rng(s)
        steps = n - m - 1  # nodes m+1 .. n-1 draw; node m is deterministic
        if steps > 0:
            # draws[t, j]: index into the repeated array (length 2m*(t+1))
            # drawn by node m+1+t for its j-th target.
            high = (2 * m * (np.arange(1, steps + 1, dtype=np.int64)))[:, None]
            draws = r.integers(0, high, size=(steps, m), dtype=np.int64)
            idx = draws.reshape(-1).copy()
            val = np.full(idx.shape[0], -1, np.int64)
            unresolved = np.ones(idx.shape[0], bool)
            while unresolved.any():
                cur = idx[unresolved]
                even = cur % 2 == 0
                seed_slot = (~even) & (cur < 2 * m)
                res = np.where(even, m + cur // (2 * m), (cur - 1) // 2)
                done = even | seed_slot
                where = np.nonzero(unresolved)[0]
                val[where[done]] = res[done]
                unresolved[where[done]] = False
                chase = where[~done]
                if chase.size:
                    c = idx[chase]  # odd slot of step t>=1 -> its own draw
                    t = c // (2 * m) - 1
                    j = (c % (2 * m)) // 2
                    idx[chase] = draws[t, j]
            targets = val.reshape(steps, m)
            vs = np.repeat(np.arange(m + 1, n, dtype=np.int64), m)
            u = np.concatenate([np.arange(m, dtype=np.int64), vs])
            v = np.concatenate([np.full(m, m, np.int64), targets.reshape(-1)])
        else:
            u = np.arange(m, dtype=np.int64)
            v = np.full(m, m, np.int64)
        return SparseTopology.from_pairs(f"barabasi_albert(n={n},m={m})", n, u, v)

    return _retry(sample, seed, ensure_connected, f"BA({n},{m})")


def sparse_watts_strogatz(n: int, k: int = 4, p: float = 0.1, seed: int = 0,
                          ensure_connected: bool = True) -> SparseTopology:
    """WS small world: ring lattice (each node to its k/2 nearest on each
    side), then each lattice edge rewires its far endpoint with probability
    p to a uniform node.  Rewires that would self-loop or duplicate an
    existing edge keep the original link (vectorized reject, one pass)."""
    if k % 2 or not 0 < k < n:
        raise ValueError(f"need even 0 < k < n, got k={k}, n={n}")

    def sample(s: int) -> SparseTopology:
        r = np.random.default_rng(s)
        base = np.arange(n, dtype=np.int64)
        u = np.tile(base, k // 2)
        d = np.repeat(np.arange(1, k // 2 + 1, dtype=np.int64), n)
        v = (u + d) % n
        rewire = r.random(u.shape[0]) < p
        new_v = r.integers(0, n, size=u.shape[0], dtype=np.int64)
        cand = np.where(rewire, new_v, v)
        lo, hi = np.minimum(u, cand), np.maximum(u, cand)
        code = lo * n + hi
        lattice_code = (np.minimum(u, v) * n + np.maximum(u, v))
        # reject: self loop, duplicate of a lattice edge, duplicate of
        # another (earlier-coded) rewire — keep the original lattice link.
        dup = np.isin(code, lattice_code) & (code != lattice_code)
        counts = np.unique(code, return_counts=True)
        clash = np.isin(code, counts[0][counts[1] > 1])
        bad = (u == cand) | dup | (rewire & clash)
        v_final = np.where(bad, v, cand)
        return SparseTopology.from_pairs(
            f"watts_strogatz(n={n},k={k},p={p})", n, u, v_final)

    return _retry(sample, seed, ensure_connected, f"WS({n},{k},{p})")


def sparse_ring(n: int, **kw) -> SparseTopology:
    u = np.arange(n, dtype=np.int64)
    return SparseTopology.from_pairs(f"ring(n={n})", n, u, (u + 1) % n)


def sparse_star(n: int, **kw) -> SparseTopology:
    """Star — max_degree = N-1, the shape the padded dense layout loses on."""
    v = np.arange(1, n, dtype=np.int64)
    return SparseTopology.from_pairs(f"star(n={n})", n, np.zeros(n - 1, np.int64), v)


def sparse_complete(n: int, **kw) -> SparseTopology:
    i, j = np.triu_indices(n, 1)
    return SparseTopology.from_pairs(f"complete(n={n})", n, i, j)


def sparse_grid2d(rows: int, cols: int, **kw) -> SparseTopology:
    n = rows * cols
    ids = np.arange(n, dtype=np.int64).reshape(rows, cols)
    right = np.stack([ids[:, :-1].reshape(-1), ids[:, 1:].reshape(-1)])
    down = np.stack([ids[:-1].reshape(-1), ids[1:].reshape(-1)])
    u, v = np.concatenate([right, down], axis=1)
    return SparseTopology.from_pairs(f"grid2d({rows}x{cols})", n, u, v)


SPARSE_BUILDERS: Dict[str, Callable[..., SparseTopology]] = {
    "erdos_renyi": sparse_erdos_renyi,
    "barabasi_albert": sparse_barabasi_albert,
    "watts_strogatz": sparse_watts_strogatz,
    "ring": sparse_ring,
    "star": sparse_star,
    "complete": sparse_complete,
    "grid2d": sparse_grid2d,
}


def make_sparse_topology(name: str, **kwargs) -> SparseTopology:
    try:
        builder = SPARSE_BUILDERS[name]
    except KeyError:
        raise ValueError(
            f"unknown sparse topology {name!r}; available: "
            f"{sorted(SPARSE_BUILDERS)}"
        ) from None
    return builder(**kwargs)
