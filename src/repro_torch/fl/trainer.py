"""Local training building blocks, node-batched.

`make_train_step` gives one autograd SGD step for all N nodes at once:
each node's loss depends only on its own parameters, so the gradient of
the summed per-node losses is every node's own gradient; `make_grad_fn`
gives those gradients alone (CFA-GE's exchange).  Both run the model with
`train=True` and pass on a keep-mask source for its dropout layers
(`generator_keep`; a model without dropout never draws from it).
`make_eval_fn` evaluates every node on the shared test set in fixed-size
chunks with `train=False` and, as the JAX package does, drops the
remainder (`n_batches = n // batch_size`).  `centralized_train` is the
paper's Centralized benchmark: one model on all the data.
"""
from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch

from repro_torch.core.virtual_teacher import cross_entropy_loss, make_loss_fn
from repro_torch.data.pipeline import minibatches
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.api import SmallModel
from repro_torch.optim.sgd import Optimizer
from repro_torch.utils.pytree import tree_leaves, tree_map, tree_unflatten_like


def generator_keep(gen: torch.Generator, device) -> Callable:
    """A dropout keep-mask source drawing from `gen` on `device`: entry True
    iff its uniform is below the keep probability (the Bernoulli draw of
    the reference's `jax.random.bernoulli`)."""

    def keep(shape, p: float) -> torch.Tensor:
        return torch.rand(shape, generator=gen, device=device) < p

    return keep


def _loss_and_grads(model: SmallModel, loss_fn: Callable, params, x, y,
                    keep=None):
    """(per-node losses [N], the gradient tree of their sum: each node's
    own gradient, leaves [N, ...])."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    with torch.enable_grad():
        logits = model.apply(tree_unflatten_like(params, leaves), x,
                             train=True, keep=keep)
        loss = loss_fn(logits, y)
        grads = torch.autograd.grad(loss.sum(), leaves)
    return loss.detach(), tree_unflatten_like(params, list(grads))


def make_train_step(model: SmallModel, optimizer: Optimizer,
                    loss_fn: Callable):
    """step(params, opt_state, x [N, B, ...], y [N, B], step_idx=None,
    keep=None) -> (params, opt, loss [N]).  Params and optimizer state are
    updated in place; `step_idx` feeds the optimizer's schedule and `keep`
    the model's dropout."""

    def step(params, opt_state, x, y, step_idx=None, keep=None):
        loss, grads = _loss_and_grads(model, loss_fn, params, x, y, keep)
        params, opt_state = optimizer.update(grads, opt_state, params,
                                             step_idx)
        return params, opt_state, loss

    return step


def make_grad_fn(model: SmallModel, loss_fn: Callable):
    """grad(params, x [N, B, ...], y [N, B], keep=None) -> the gradient tree
    of every node's local loss at its own params, leaves [N, ...] (CFA-GE's
    exchange evaluates it at the receivers' models on their neighbours'
    data)."""

    def grad(params, x, y, keep=None):
        return _loss_and_grads(model, loss_fn, params, x, y, keep)[1]

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
            logits = model.apply(params, x[None], train=False)
            correct += torch.sum(torch.argmax(logits, dim=-1) == y[None],
                                 dim=-1)
            loss_sum += cross_entropy_loss(logits, y[None]) * batch_size
        return correct.to(torch.float32) / used, loss_sum / used

    return eval_fn


def centralized_train(model: SmallModel, optimizer: Optimizer,
                      x_train: np.ndarray, y_train: np.ndarray,
                      x_test: np.ndarray, y_test: np.ndarray,
                      epochs: int, batch_size: int, seed: int = 0,
                      loss: str = "ce", beta: float = 0.95,
                      eval_every: int = 1, *, init_params=None,
                      device: DeviceLike = None) -> Tuple[dict, list]:
    """The paper's Centralized benchmark: all data on one server.

    One model through the node-batched step and eval with N = 1.  Batches
    come from `minibatches` with `np.random.default_rng(seed)`, so they are
    the reference's own; dropout draws from a generator seeded with
    `seed + 1`.  The init is drawn from a generator seeded with `seed`
    unless `init_params` (one model's tree) is given — the point at which
    tests carry the reference's init across.  Returns (one model's params,
    [{"epoch", "acc", "loss"}] after every `eval_every` epochs and the
    last)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    loss_fn = make_loss_fn(loss, beta=beta)
    step_fn = make_train_step(model, optimizer, loss_fn)
    eval_fn = make_eval_fn(model, batch_size=min(512, len(x_test)))

    if init_params is None:
        init_params = model.init(torch.Generator().manual_seed(seed))
    # a copy: the optimizer updates in place, never the caller's tensors
    params = tree_map(lambda t: torch.as_tensor(t)[None].to(dev).clone(),
                      init_params)
    opt_state = optimizer.init(params)
    keep = generator_keep(torch.Generator(device=dev).manual_seed(seed + 1),
                          dev)
    xt = torch.from_numpy(np.ascontiguousarray(x_test)).to(dev)
    yt = torch.from_numpy(np.asarray(y_test).astype(np.int64)).to(dev)
    history = []
    step_idx = 0
    for epoch in range(epochs):
        for x, y in minibatches(x_train, y_train, batch_size, rng=rng):
            xb = torch.from_numpy(np.ascontiguousarray(x))[None].to(dev)
            yb = torch.from_numpy(y.astype(np.int64))[None].to(dev)
            params, opt_state, _ = step_fn(params, opt_state, xb, yb,
                                           step_idx, keep)
            step_idx += 1
        if (epoch + 1) % eval_every == 0 or epoch == epochs - 1:
            acc, tloss = eval_fn(params, xt, yt)
            history.append({"epoch": epoch, "acc": float(acc[0]),
                            "loss": float(tloss[0])})
    return tree_map(lambda t: t[0], params), history
