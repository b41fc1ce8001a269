"""The dense Neighborhood view: one flat gossip reduce over the padded
[R, max_deg] layout.

A gossip strategy aggregates through the five primitives of this view:

  * ``local()``        — the block's own models as one [R, D] fp32 matrix;
  * ``reduce()``       — (Σ_k w·x_k [R, D], Σ_k w [R]) over delivered
    neighbour models;
  * ``reduce_delta()`` — the same contraction over (x_k - local);
  * ``n_active()``     — the count of delivered neighbours per receiver;
  * ``unflatten(out)`` — back to the params tree.

Every contraction goes through `repro_torch.kernels.ops.
segment_neighbor_avg` (the CUDA kernel on the card), whose totals come out
of the same ordered loop as the sums.  The sparse CSR view is ROADMAP A.6.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.kernels.ops import segment_neighbor_avg


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
