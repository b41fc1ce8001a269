"""SGD with heavy-ball momentum, the paper's optimizer, over dict trees.

PyTorch-convention momentum: v <- mu*v + g;  w <- w - lr*v.

The update is IN PLACE: `update` overwrites the parameter and momentum
tensors it is given and returns them.  This saves a second copy of every
node's model and momentum per step, which the JAX package's pure update
(new arrays each step) cannot avoid.  Callers that need the old values
must clone them first.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.utils.pytree import tree_leaves, tree_map


class Optimizer(NamedTuple):
    init: Callable    # params -> opt_state
    update: Callable  # (grads, opt_state, params) -> (params, opt_state)


def sgd_momentum(lr: float = 1e-3, momentum: float = 0.9) -> Optimizer:
    """Heavy-ball SGD; `update` works in place (see the module docstring)."""

    def init(params):
        return {"momentum": tree_map(torch.zeros_like, params)}

    @torch.no_grad()
    def update(grads, state, params):
        for g, v, p in zip(tree_leaves(grads), tree_leaves(state["momentum"]),
                           tree_leaves(params)):
            v.mul_(momentum).add_(g)
            p.sub_(lr * v)
        return params, state

    return Optimizer(init=init, update=update)
