"""Aggregation strategies for one node: the paper's baselines and DecDiff.

The counterparts of the JAX package's `repro.core.aggregation`, on dict
trees.  Every aggregator takes the local model, the neighbours' models
stacked along a leading slot axis, per-slot weights and an optional
{0,1} `mask` of the slots that delivered this round (the paper imposes no
synchronization):

  * ``decavg``  — Eq. (4): the weighted average of {local} ∪ {neighbours}
                  (DecAvg under common init, DecHetero under per-node init);
  * ``cfa``     — Eq. (9) (Savazzi et al.): w_i += ε Σ_j p_ij (w_j − w_i),
                  ε = 1/|N_i| by default;
  * ``decdiff`` — the paper's proposal, Eq. (5)+(6) (`core/decdiff.py`);
  * ``none``    — isolation (the ISOL baseline).

`cfa_ge_gradient_step` is CFA-GE's second phase and `fedavg_aggregate`
the FED baseline's server average.  Each contraction over the slots runs
through `repro_torch.kernels.ops.neighbor_avg` (the `neighbor_avg` kernel
on the card) on the flat [K, D] stack, with weights normalized here.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch

from repro_torch.core.decdiff import decdiff_aggregate_stacked
from repro_torch.kernels import ops
from repro_torch.utils.pytree import (
    tree_flatten_stacked,
    tree_flatten_to_vector,
    tree_map,
)

Aggregator = Callable  # (local, stacked_neighbors, weights, mask, **kw) -> new local


def _flat(local_model, stacked):
    """(local [D] fp32, stacked [K, D] fp32, unflatten of a [D] vector into
    the local model's structure and dtypes)."""
    lf, unflatten = tree_flatten_to_vector(local_model)
    st, _ = tree_flatten_stacked(stacked)
    return lf, st, unflatten


def _masked_weights(weights, mask, device):
    w = torch.as_tensor(weights, dtype=torch.float32, device=device)
    if mask is not None:
        w = w * torch.as_tensor(mask, dtype=torch.float32, device=device)
    return w


def _normalized(w):
    """(w / safe total, total): a zero total normalizes to all zeros."""
    total = torch.sum(w)
    safe_total = torch.where(total > 0, total, torch.ones_like(total))
    return (w / safe_total).contiguous(), total


def decavg_aggregate(local_model, stacked_neighbors, weights, mask=None,
                     self_weight=None, **_):
    """Eq. (4): the convex combination of {local} ∪ {delivered neighbours}.

    `weights` are the ω_ij·p_ij factors of the slots; `self_weight` the
    local model's ω_ii·p_ii, by default the mean active neighbour weight
    (the local model counts as one more neighbour)."""
    lf, st, unflatten = _flat(local_model, stacked_neighbors)
    w = _masked_weights(weights, mask, lf.device)
    if self_weight is None:
        n_active = torch.clamp(torch.sum((w > 0).to(torch.float32)), min=1.0)
        sw = torch.sum(w) / n_active
    else:
        sw = torch.as_tensor(self_weight, dtype=torch.float32,
                             device=lf.device)
    total = torch.sum(w) + sw
    neigh = ops.neighbor_avg_normalized(st, (w / total).contiguous())
    return unflatten((sw / total) * lf + neigh)


def cfa_aggregate(local_model, stacked_neighbors, weights, mask=None,
                  eps=None, **_):
    """Eq. (9): w_i <- w_i + ε Σ_j p_ij (w_j − w_i), ε = 1/(active
    neighbours) unless given; a node that heard from nobody keeps its
    model."""
    lf, st, unflatten = _flat(local_model, stacked_neighbors)
    w = _masked_weights(weights, mask, lf.device)
    p, total = _normalized(w)
    n_active = torch.sum((w > 0).to(torch.float32))
    if eps is None:
        eps_val = torch.where(n_active > 0,
                              1.0 / torch.clamp(n_active, min=1.0),
                              torch.zeros_like(n_active))
    else:
        eps_val = torch.as_tensor(eps, dtype=torch.float32, device=lf.device)
    gate = (total > 0).to(torch.float32)
    delta = ops.neighbor_avg_normalized((st - lf[None]).contiguous(), p)
    return unflatten(lf + gate * eps_val * delta)


def isolation_aggregate(local_model, stacked_neighbors, weights, mask=None,
                        **_):
    """ISOL baseline: ignore the neighbourhood entirely."""
    del stacked_neighbors, weights, mask
    return local_model


def cfa_ge_gradient_step(local_model, stacked_grads, weights, mask=None,
                         lr: float = 1.0, **_):
    """CFA-GE second phase: descend along the p_ij-weighted mean of the
    gradients ∇F_j(w_i) that the neighbours evaluated at our model on
    their data; a node that heard from nobody keeps its model."""
    lf, sg, unflatten = _flat(local_model, stacked_grads)
    w = _masked_weights(weights, mask, lf.device)
    p, total = _normalized(w)
    gate = (total > 0).to(torch.float32)
    g = ops.neighbor_avg_normalized(sg, p)
    return unflatten(lf - gate * lr * g)


def fedavg_aggregate(stacked_models, weights):
    """Server-side FedAvg: the p_i-weighted average over *all* clients (the
    partially-decentralized FED baseline, a star) -> one model, without
    the client axis, in the stack's dtypes."""
    st, unflatten = tree_flatten_stacked(stacked_models)
    w = torch.as_tensor(weights, dtype=torch.float32, device=st.device)
    avg = ops.neighbor_avg(st, w)
    return tree_map(lambda t: t[0], unflatten(avg[None]))


AGGREGATORS: Dict[str, Aggregator] = {
    "decavg": decavg_aggregate,
    "cfa": cfa_aggregate,
    "decdiff": decdiff_aggregate_stacked,
    "none": isolation_aggregate,
}


def get_aggregator(name: str) -> Aggregator:
    try:
        return AGGREGATORS[name]
    except KeyError:
        raise ValueError(
            f"unknown aggregator {name!r}; available: {sorted(AGGREGATORS)}"
        ) from None
