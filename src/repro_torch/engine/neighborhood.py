"""Neighborhood views: one flat gossip reduce for both node-axis layouts.

A gossip strategy aggregates through the five primitives of a view:

  * ``local()``        — the block's own models as one [R, D] fp32 matrix;
  * ``reduce()``       — (Σ_k w·x_k [R, D], Σ_k w [R]) over delivered
    neighbour models;
  * ``reduce_delta()`` — the same contraction over (x_k - local);
  * ``n_active()``     — the count of delivered neighbours per receiver;
  * ``unflatten(out)`` — back to the params tree.

Two views share those semantics bit for bit:

  * :class:`DenseNeighborhood` — the padded [R, max_deg] layout over a full
    [N, D] model table (the small-N oracle);
  * :class:`SparseNeighborhood` — degree-bucketed ragged edge blocks from a
    :class:`SparsePlan` (the CSR edge list laid out as per-width slot
    tables), O(N + E) state instead of O(N·max_deg).

Every contraction goes through `repro_torch.kernels.ops.
segment_neighbor_avg` (the CUDA kernel on the card), which contracts each
receiver row on its own with its totals from the same ordered loop, so the
reduce is bitwise invariant to row blocking and to zero-weight K padding
(the dense max_deg slots against a bucket's power-of-two width).
Normalization happens after the reduce, on per-row scalars, in the
strategy's `flat_aggregate`.
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.ops import segment_neighbor_avg


class WidthBucket(NamedTuple):
    """One degree bucket's slot tables, stacked over the pod axis.

    All tensors lead with [P, B] (B = the bucket's receiver count, padded
    to the largest over pods with inert dummy rows: rows_local = per_pod,
    the scatter's trash row, and wgt = 0).  Indices are int64 (the
    reference's are int32; the values are equal)."""

    rows_local: torch.Tensor  # [P, B] receiver row within the pod
    src: torch.Tensor         # [P, B, K] sender node ids (pad 0)
    wgt: torch.Tensor         # [P, B, K] f32 ω_e·|D_src| (pad 0)
    epos: torch.Tensor        # [P, B, K] directed-edge position (pad 0)


class SparsePlan(NamedTuple):
    """The static ragged layout: everything the round needs to gossip over
    a :class:`~repro_torch.graphs.SparseTopology` without [N, N] or
    [N, max_deg] state."""

    widths: Tuple[int, ...]          # ascending bucket widths
    buckets: Dict[int, WidthBucket]  # width -> stacked slot tables
    degrees: torch.Tensor            # [N] f32 in-degree (byte accounting)
    num_directed: int
    per_pod: int
    n_pods: int


def _bucket_width(deg: int) -> int:
    """Per-receiver slot width: next power of two, floor 8 — the padded
    slots total at most 2E + 8N, against N·max_deg for the dense layout
    (O(N^2) on hubs)."""
    return max(8, 1 << int(np.ceil(np.log2(max(deg, 1)))))


def build_sparse_plan(st, counts: np.ndarray, n_pods: int = 1,
                      device: DeviceLike = "cpu") -> SparsePlan:
    """Lay a SparseTopology out as per-pod, per-width slot tables, built in
    numpy once and moved to `device` once.

    Nodes map to pods in contiguous blocks (node i -> pod i // per_pod);
    `counts` are the per-node |D_i| folded into the gossip weights exactly
    as the dense layout folds them (ω_e · |D_src| in float32, in that
    order)."""
    dev = resolve_device(device)
    n = st.num_nodes
    if n % n_pods:
        raise ValueError(f"{n} nodes do not tile {n_pods} pods")
    per_pod = n // n_pods
    offsets = st.row_offsets
    degs = np.diff(offsets).astype(np.int64)
    counts = np.asarray(counts)
    wgt_edge = st.edge_weight * counts[st.edge_src].astype(np.float32)
    node_width = np.array([_bucket_width(int(d)) for d in degs], np.int64)
    widths = sorted({int(w) for w in node_width})

    buckets = {}
    for wd in widths:
        per_pod_rows = []
        for p in range(n_pods):
            block = np.arange(p * per_pod, (p + 1) * per_pod)
            per_pod_rows.append(block[node_width[block] == wd])
        b = max(r.shape[0] for r in per_pod_rows)
        rows_local = np.full((n_pods, b), per_pod, np.int64)
        src = np.zeros((n_pods, b, wd), np.int64)
        wgt = np.zeros((n_pods, b, wd), np.float32)
        epos = np.zeros((n_pods, b, wd), np.int64)
        for p, nodes in enumerate(per_pod_rows):
            if not nodes.size:
                continue
            k = nodes.shape[0]
            rows_local[p, :k] = nodes - p * per_pod
            # slot j of receiver i is its j-th CSR in-edge, senders
            # ascending: the dense layout's slot order
            lo, deg = offsets[nodes], degs[nodes]
            slot = np.arange(wd)[None, :]
            real = slot < deg[:, None]
            pos = np.where(real, lo[:, None] + slot, 0)
            src[p, :k] = np.where(real, st.edge_src[pos], 0)
            wgt[p, :k] = np.where(real, wgt_edge[pos], np.float32(0))
            epos[p, :k] = pos
        buckets[wd] = WidthBucket(
            rows_local=torch.from_numpy(rows_local).to(dev),
            src=torch.from_numpy(src).to(dev),
            wgt=torch.from_numpy(wgt).to(dev),
            epos=torch.from_numpy(epos).to(dev))

    return SparsePlan(
        widths=tuple(widths), buckets=buckets,
        degrees=torch.from_numpy(degs.astype(np.float32)).to(dev),
        num_directed=st.num_directed, per_pod=per_pod, n_pods=n_pods)


class DenseNeighborhood:
    """table [N, D], nbr_idx / w [R, max_deg] (int64 ids, fp32 weights with
    0 at padding and undelivered slots).

    When the transport has already materialized the per-slot neighbour
    models (the per-edge transport's reverse-slot gather yields per-link
    reconstructions, so no single [N, D] table exists), pass them as
    ``panel`` [R, max_deg, D] instead of ``table``/``nbr_idx``: the reduce
    contracts the panel through the same kernel, so the bits match the
    table form whenever the values do."""

    def __init__(self, table: Optional[torch.Tensor],
                 nbr_idx: Optional[torch.Tensor], w: torch.Tensor,
                 local_mat: torch.Tensor, unflatten_fn: Callable,
                 panel: Optional[torch.Tensor] = None):
        self.table = table
        self.nbr_idx = nbr_idx
        self.w = w
        self.local_mat = local_mat
        self._unflatten = unflatten_fn
        self.panel = panel

    def _vals(self) -> torch.Tensor:
        if self.panel is not None:
            return self.panel
        return self.table[self.nbr_idx]  # [R, max_deg, D], contiguous

    def local(self) -> torch.Tensor:
        return self.local_mat

    def reduce(self):
        return segment_neighbor_avg(self._vals(), self.w)

    def reduce_delta(self):
        vals = self._vals() - self.local_mat[:, None, :]
        return segment_neighbor_avg(vals, self.w)

    def n_active(self) -> torch.Tensor:
        return torch.sum((self.w > 0).to(torch.float32), dim=1)

    def unflatten(self, out: torch.Tensor):
        return self._unflatten(out)


class SparseNeighborhood:
    """The ragged view: per-width buckets gathered from a full [N, D] table,
    scattered back to the pod's rows through a trash slot (row R of an
    [R+1] accumulator; dummy bucket rows land there and are sliced away).
    Every real row appears in exactly one bucket, so the trash row is the
    only one written twice (an indexed copy with repeated indices is
    nondeterministic on CUDA, harmless only there).  One bucket's
    [B, K, D] panel is alive at a time.

    `edge_mask` [E] {0,1} is the round's per-directed-edge weight factor,
    the product of every {0,1} factor that applies (link draw, senders'
    gates, delivery history, the per-edge transport's aggregation mask),
    applied through `epos` exactly where the dense layout multiplies its
    [N, max_deg] mask panel; its factors are exact, so the composed weights
    equal the dense layout's bit for bit.  Pass ``edge_table`` [E, D],
    per-directed-edge values (the sparse per-edge transport's
    reconstruction bank), instead of `table`: bucket slots then read
    `edge_table[epos]` instead of `table[src]` (a receiver's slots ARE its
    CSR edge positions, so no reverse gather is needed).

    Padding slots point at edge 0 / node 0 (finite values) with wgt = 0,
    which the reduce's contract makes bit-neutral.

    `pod` picks the caller's slab of the plan's [P, ...] tables: the pod
    backend's block of R = N / P receivers (`local_mat` [R, D]); `table`,
    `edge_table` and `edge_mask` stay full-axis."""

    def __init__(self, plan: SparsePlan, table: Optional[torch.Tensor],
                 local_mat: torch.Tensor, unflatten_fn: Callable,
                 edge_mask: torch.Tensor, *,
                 edge_table: Optional[torch.Tensor] = None, pod: int = 0):
        if not 0 <= pod < plan.n_pods:
            raise ValueError(f"pod {pod} of a {plan.n_pods}-pod plan")
        self.plan = plan
        self.pod = pod
        self.table = table
        self.local_mat = local_mat
        self._unflatten = unflatten_fn
        self.edge_mask = edge_mask
        self.edge_table = edge_table

    def _bucket(self, wd: int):
        """The caller's pod's slot tables of width `wd`."""
        bk, p = self.plan.buckets[wd], self.pod
        return bk.rows_local[p], bk.src[p], bk.wgt[p], bk.epos[p]

    def _weights(self, wgt, epos):
        return (wgt * self.edge_mask[epos]).contiguous()

    def local(self) -> torch.Tensor:
        return self.local_mat

    def _reduce(self, delta: bool):
        r, d = self.local_mat.shape
        dev = self.local_mat.device
        sums = torch.zeros((r + 1, d), dtype=torch.float32, device=dev)
        tot = torch.zeros((r + 1,), dtype=torch.float32, device=dev)
        local_pad = (torch.cat([self.local_mat,
                                torch.zeros((1, d), dtype=torch.float32,
                                            device=dev)])
                     if delta else None)
        for wd in self.plan.widths:
            rows_local, src, wgt, epos = self._bucket(wd)
            vals = (self.edge_table[epos] if self.edge_table is not None
                    else self.table[src])  # [B, K, D], a fresh tensor
            if delta:
                vals.sub_(local_pad[rows_local][:, None, :])
            s, t = segment_neighbor_avg(vals, self._weights(wgt, epos))
            del vals
            sums[rows_local] = s
            tot[rows_local] = t
        return sums[:r], tot[:r]

    def reduce(self):
        return self._reduce(delta=False)

    def reduce_delta(self):
        return self._reduce(delta=True)

    def n_active(self) -> torch.Tensor:
        r = self.local_mat.shape[0]
        na = torch.zeros((r + 1,), dtype=torch.float32,
                         device=self.local_mat.device)
        for wd in self.plan.widths:
            rows_local, src, wgt, epos = self._bucket(wd)
            w = self._weights(wgt, epos)
            na[rows_local] = torch.sum((w > 0).to(torch.float32), dim=1)
        return na[:r]

    def unflatten(self, out: torch.Tensor):
        return self._unflatten(out)
