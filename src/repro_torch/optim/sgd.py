"""Optimizers over dict trees: the paper's SGD with momentum, AdamW and
learning-rate schedules.

PyTorch-convention momentum: v <- mu*v + g;  w <- w - lr*v.

The optimizer state is fp32 by default whatever the parameter dtype
(`momentum_dtype=` / `state_dtype=` hold it in another), and the step is
taken in fp32 and rounded once to the parameter's dtype, as the JAX
package's optimizers do for its bf16 LM leaves (an in-place op on a bf16
tensor with an fp32 operand computes in fp32 and rounds the result).  A
state held in another dtype is widened to fp32, updated there and rounded
once back into its tensor, as the reference does.

The update is IN PLACE: `update(grads, state, params, step=None)`
overwrites the parameter and state tensors it is given and returns them.
This saves a second copy of every node's model and state per step, which
the JAX package's pure update (new arrays each step) cannot avoid.
Callers that need the old values must clone them first.  `step` is the
global step index the learning-rate schedule reads; a constant rate needs
none.

A schedule maps a step to the learning rate as a Python float holding an
exact fp32 value, computed in fp32 as the reference computes it.

The parameters and state may be DTensors (a step partitioned on a mesh,
`dist.dfl_step.build_train_step(mesh=)`): each leaf's state takes its
parameter's placements from `init`, and a gradient in other placements (a
replicated weight's gradient comes out of the backward as partial sums
over "data") is redistributed to them first, so every update runs on the
local shards and no state is gathered.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.utils.pytree import tree_leaves, tree_map


class Optimizer(NamedTuple):
    init: Callable    # params -> opt_state
    update: Callable  # (grads, opt_state, params, step=None) -> (params, opt_state)


def constant_schedule(lr: float) -> Callable:
    lr32 = float(np.float32(lr))
    return lambda step: lr32


def cosine_schedule(peak_lr: float, warmup: int, total: int,
                    floor: float = 0.1) -> Callable:
    """Linear warm-up to `peak_lr` over `warmup` steps, then a cosine decay
    to `floor * peak_lr` at `total`, in fp32."""
    f32 = np.float32

    def sched(step):
        s = f32(step)
        warm = f32(peak_lr) * min(s / f32(max(warmup, 1)), f32(1.0))
        t = f32(np.clip((s - f32(warmup)) / f32(max(total - warmup, 1)),
                        f32(0.0), f32(1.0)))
        cos = f32(peak_lr) * (f32(floor) + f32((1 - floor) * 0.5)
                              * (f32(1) + f32(np.cos(f32(np.pi) * t))))
        return float(warm if s < warmup else cos)

    return sched


def _lr_at(sched: Callable, step) -> float:
    return sched(0 if step is None else int(step))


def _as_param(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """g in p's placements when both are DTensors; otherwise g itself."""
    placements = getattr(p, "placements", None)
    if placements is None or tuple(g.placements) == tuple(placements):
        return g
    return g.redistribute(p.device_mesh, placements)


def _zeros_like(p: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Zeros of p's shape in `dtype`, on p's device, or a DTensor in p's
    placements when p is one."""
    if getattr(p, "placements", None) is not None:
        return torch.zeros_like(p, dtype=dtype)
    return torch.zeros(p.shape, dtype=dtype, device=p.device)


def _store(state: torch.Tensor, new32: torch.Tensor):
    """Round the fp32 working copy of a non-fp32 state tensor back into it
    (`state.to(float32)` is the tensor itself for an fp32 state)."""
    if new32 is not state:
        state.copy_(new32)


def sgd_momentum(lr=1e-3, momentum: float = 0.9, nesterov: bool = False,
                 weight_decay: float = 0.0,
                 momentum_dtype: torch.dtype = torch.float32) -> Optimizer:
    """Heavy-ball SGD (optionally Nesterov, with L2 weight decay added to
    the gradient); `update` works in place (see the module docstring).
    `lr` is a float or a schedule (step -> float)."""
    sched = lr if callable(lr) else None

    def init(params):
        return {"momentum": tree_map(
            lambda p: _zeros_like(p, momentum_dtype), params)}

    @torch.no_grad()
    def update(grads, state, params, step=None):
        lr_t = lr if sched is None else _lr_at(sched, step)
        for g, v, p in zip(tree_leaves(grads), tree_leaves(state["momentum"]),
                           tree_leaves(params)):
            g32 = _as_param(g, p).to(torch.float32)
            if weight_decay:
                g32 = g32 + weight_decay * p.to(torch.float32)
            v32 = v.to(torch.float32)
            v32.mul_(momentum).add_(g32)
            if nesterov:
                p.sub_(lr_t * (g32 + momentum * v32))
            else:
                p.sub_(lr_t * v32)
            _store(v, v32)
        return params, state

    return Optimizer(init=init, update=update)


def adamw(lr=3e-4, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1,
          state_dtype: torch.dtype = torch.float32) -> Optimizer:
    """AdamW with bias correction and decoupled weight decay, in place."""
    sched = lr if callable(lr) else constant_schedule(lr)

    def init(params):
        def z(p):
            return _zeros_like(p, state_dtype)
        return {"m": tree_map(z, params), "v": tree_map(z, params)}

    @torch.no_grad()
    def update(grads, state, params, step=None):
        lr_t = _lr_at(sched, step)
        t = np.float32(0 if step is None else int(step)) + np.float32(1.0)
        c1 = float(np.float32(1.0) - np.float32(b1) ** t)
        c2 = float(np.float32(1.0) - np.float32(b2) ** t)
        for g, m, v, p in zip(tree_leaves(grads), tree_leaves(state["m"]),
                              tree_leaves(state["v"]), tree_leaves(params)):
            g32 = _as_param(g, p).to(torch.float32)
            m32, v32 = m.to(torch.float32), v.to(torch.float32)
            m32.mul_(b1).add_((1 - b1) * g32)
            v32.mul_(b2).add_((1 - b2) * torch.square(g32))
            delta = (m32 / c1) / (torch.sqrt(v32 / c2) + eps) \
                + weight_decay * p.to(torch.float32)
            p.sub_(lr_t * delta)
            _store(m, m32)
            _store(v, v32)
        return params, state

    return Optimizer(init=init, update=update)


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    name: str = "sgdm"
    lr: float = 1e-3
    momentum: float = 0.9
    weight_decay: float = 0.0
    warmup: int = 100
    total_steps: int = 10_000
    schedule: str = "constant"  # constant | cosine


def make_optimizer(cfg: Optional[OptimizerConfig] = None,
                   **overrides) -> Optimizer:
    cfg = dataclasses.replace(cfg or OptimizerConfig(), **overrides)
    lr: Callable = (
        cosine_schedule(cfg.lr, cfg.warmup, cfg.total_steps)
        if cfg.schedule == "cosine"
        else constant_schedule(cfg.lr)
    )
    if cfg.name in ("sgd", "sgdm"):
        return sgd_momentum(lr=lr, momentum=cfg.momentum,
                            weight_decay=cfg.weight_decay)
    if cfg.name == "adamw":
        return adamw(lr=lr, weight_decay=cfg.weight_decay)
    raise ValueError(f"unknown optimizer {cfg.name!r}")
