"""DecDiff aggregation — the paper's Eq. (5) and Eq. (6), for one node.

    w_i <- w_i + (w̄_i - w_i) / (||w̄_i - w_i||_2 + s),     s >= 1    (Eq. 5)

    w̄_i = Σ_{j in N_i} ω_ij p_ij w_j / Σ_{j in N_i} ω_ij p_ij       (Eq. 6)

The average excludes the local model, and the norm is taken over the whole
flattened model.  These are the counterparts of the JAX package's
`repro.core.decdiff`, on dict trees: Eq. 6 runs through
`repro_torch.kernels.ops.neighbor_avg` over the neighbours' flat [N, D]
rows (the `neighbor_avg` kernel on the card), Eq. 5 through the
`decdiff_update` kernels (`ops.decdiff_rows`).  The engine's rounds use
the row-batched forms of the strategies (`repro_torch.engine.strategies`);
these single-receiver forms serve callers that aggregate one node.
"""
from __future__ import annotations

from typing import List, Sequence

import torch

from repro_torch.kernels import ops
from repro_torch.utils.pytree import (
    tree_flatten_stacked,
    tree_leaves,
    tree_map,
    tree_unflatten_like,
)

DEFAULT_S = 1.0  # paper: smallest value limiting the denominator's influence.


def _leaf_rows(vec: torch.Tensor, like) -> List[torch.Tensor]:
    """Split a flat fp32 vector into one [1, numel] row per leaf of `like`
    (views, in the flat order)."""
    sizes = [t.numel() for t in tree_leaves(like)]
    return [p.reshape(1, -1) for p in torch.split(vec, sizes)]


def _eq5(local_model, avg_vec: torch.Tensor, gate, s: float):
    """Eq. 5 of one model toward a flat fp32 average, each leaf updated in
    its own dtype; `gate` [1] or None (see `ops.decdiff_rows`)."""
    leaves = tree_leaves(local_model)
    outs = ops.decdiff_rows([t.contiguous().reshape(1, -1) for t in leaves],
                            _leaf_rows(avg_vec, local_model), gate, s)
    return tree_unflatten_like(
        local_model, [o.reshape(t.shape) for o, t in zip(outs, leaves)])


def neighborhood_average(neighbor_models: Sequence, weights):
    """Eq. (6): the weighted average of the neighbours' models.

    neighbor_models: a list of like-structured trees, the models received
    from N_i; weights: per-neighbour ω_ij·p_ij (any positive scale,
    normalized here).  Returns w̄_i with the inputs' structure and dtypes."""
    models = list(neighbor_models)
    stacked = tree_map(lambda *ls: torch.stack(ls), models[0], *models[1:])
    mat, unflatten = tree_flatten_stacked(stacked)
    w = torch.as_tensor(weights, dtype=torch.float32, device=mat.device)
    avg = ops.neighbor_avg(mat, w)
    return tree_map(lambda t: t[0], unflatten(avg[None]))


def decdiff_step(local_model, avg_model, s: float = DEFAULT_S):
    """Eq. (5): the distance-attenuated step from `local_model` toward
    `avg_model`; the applied scale 1/(d + s) shrinks as the models move
    apart, which bounds the disruption of far-apart models."""
    return ops.decdiff_update_tree(local_model, avg_model, s)


def decdiff_aggregate(local_model, neighbor_models: Sequence, weights,
                      s: float = DEFAULT_S):
    """Eq. (6) then Eq. (5): what a node runs after receiving its
    neighbours' models (Alg. 1, lines 12-13)."""
    if len(neighbor_models) == 0:
        return local_model  # isolated this round: keep the local model.
    avg = neighborhood_average(neighbor_models, weights)
    return decdiff_step(local_model, avg, s=s)


def decdiff_aggregate_stacked(local_model, stacked_neighbors, weights,
                              mask=None, s: float = DEFAULT_S):
    """Eq. (6) + (5) over neighbours stacked along a leading slot axis.

    local_model: a tree of leaves [...]; stacked_neighbors: a tree of
    leaves [K, ...]; weights: [K] ω_ij·p_ij; mask: optional [K] {0,1}, the
    slots that delivered this round.  A node that heard from nobody keeps
    its model: the weights are normalized by a safe total (0 gives 0, not
    NaN) and the Eq. 5 step is gated on the total being > 0."""
    mat, _ = tree_flatten_stacked(stacked_neighbors)
    w = torch.as_tensor(weights, dtype=torch.float32, device=mat.device)
    if mask is not None:
        w = w * torch.as_tensor(mask, dtype=torch.float32, device=mat.device)
    total = torch.sum(w)
    safe_total = torch.where(total > 0, total, torch.ones_like(total))
    avg = ops.neighbor_avg_normalized(mat, (w / safe_total).contiguous())
    return _eq5(local_model, avg, total.reshape(1), s)

