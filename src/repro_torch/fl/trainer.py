"""Local training building blocks, node-batched.

`make_train_step` gives one autograd SGD step for all N nodes at once:
each node's loss depends only on its own parameters, so the gradient of
the summed per-node losses is every node's own gradient; `make_grad_fn`
gives those gradients alone (CFA-GE's exchange).  `make_eval_fn`
evaluates every node on the shared test set in fixed-size chunks and, as
the JAX package does, drops the remainder (`n_batches = n // batch_size`).
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core.virtual_teacher import cross_entropy_loss
from repro_torch.models.api import SmallModel
from repro_torch.optim.sgd import Optimizer
from repro_torch.utils.pytree import tree_leaves, tree_unflatten_like


def _loss_and_grads(model: SmallModel, loss_fn: Callable, params, x, y):
    """(per-node losses [N], the gradient tree of their sum: each node's
    own gradient, leaves [N, ...])."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    with torch.enable_grad():
        loss = loss_fn(model.apply(tree_unflatten_like(params, leaves), x), y)
        grads = torch.autograd.grad(loss.sum(), leaves)
    return loss.detach(), tree_unflatten_like(params, list(grads))


def make_train_step(model: SmallModel, optimizer: Optimizer,
                    loss_fn: Callable):
    """step(params, opt_state, x [N, B, ...], y [N, B]) -> (params, opt,
    loss [N]).  Params and optimizer state are updated in place."""

    def step(params, opt_state, x, y):
        loss, grads = _loss_and_grads(model, loss_fn, params, x, y)
        params, opt_state = optimizer.update(grads, opt_state, params)
        return params, opt_state, loss

    return step


def make_grad_fn(model: SmallModel, loss_fn: Callable):
    """grad(params, x [N, B, ...], y [N, B]) -> the gradient tree of every
    node's local loss at its own params, leaves [N, ...] (CFA-GE's
    exchange evaluates it at the receivers' models on their neighbours'
    data)."""

    def grad(params, x, y):
        return _loss_and_grads(model, loss_fn, params, x, y)[1]

    return grad


def make_eval_fn(model: SmallModel, batch_size: int = 512):
    """eval(params, x_test, y_test) -> (accuracy [N], mean CE loss [N]),
    on the device, with no host synchronisation."""

    @torch.no_grad()
    def eval_fn(params, x_test, y_test):
        n = x_test.shape[0]
        n_batches = n // batch_size
        used = n_batches * batch_size
        nodes = tree_leaves(params)[0].shape[0]
        correct = torch.zeros(nodes, dtype=torch.int64, device=x_test.device)
        loss_sum = torch.zeros(nodes, dtype=torch.float32,
                               device=x_test.device)
        for i in range(n_batches):
            x = x_test[i * batch_size:(i + 1) * batch_size]
            y = y_test[i * batch_size:(i + 1) * batch_size]
            logits = model.apply(params, x[None])
            correct += torch.sum(torch.argmax(logits, dim=-1) == y[None],
                                 dim=-1)
            loss_sum += cross_entropy_loss(logits, y[None]) * batch_size
        return correct.to(torch.float32) / used, loss_sum / used

    return eval_fn
