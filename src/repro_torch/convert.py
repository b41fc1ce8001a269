"""Carry weights, graphs and data across from plain numpy.

The JAX package's state reaches the port as numpy, never as JAX arrays, so
this module imports neither `jax` nor `repro`:

  * `params_from_numpy(tree, device)` takes the nested dict that
    `jax.tree.map(np.asarray, exp.params)` gives (leaves [N, ...]) and
    returns the port's stacked params; `params_to_numpy` is its inverse.
    Leaf order and layouts are the same in both packages (sorted keys,
    `Linear` weights [in, out], an LM's layers stacked [L, ...] under
    "layers"), so a round trip is lossless.  numpy has no bfloat16: a bf16
    tree (LM params) crosses as float32 arrays, which hold every bf16 value
    exactly, plus a like-structured tree of dtype names (`dtype_names`)
    that `params_from_numpy(..., dtypes=...)` casts back.  Optimizer state
    ({"momentum": tree}) crosses the same way.
  * `world_from_arrays(...)` builds a port World from a topology's
    adjacency and weights and the per-node data arrays.  Graph samplers
    differ between hosts (the networkx branch and the fallback draw
    different graphs), so comparisons against the reference hand over the
    reference world's arrays instead of sampling again.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.lm.config import torch_dtype
from repro_torch.utils.pytree import tree_map


def params_from_numpy(tree, device: DeviceLike = None, dtypes=None):
    """Nested dict of numpy arrays [N, ...] -> nested dict of tensors;
    `dtypes`, a like-structured tree of dtype names ("bfloat16", ...),
    casts each leaf."""
    dev = resolve_device(device)
    out = tree_map(
        lambda a: torch.from_numpy(np.array(a, copy=True)).to(dev), tree)
    if dtypes is None:
        return out
    return tree_map(lambda t, name: t.to(torch_dtype(name)), out, dtypes)


def params_to_numpy(params):
    """Inverse of `params_from_numpy`: tensors -> numpy arrays, bf16 leaves
    widened to float32 (exactly; `dtype_names` keeps the names)."""
    return tree_map(
        lambda t: t.detach().cpu().to(
            torch.float32 if t.dtype == torch.bfloat16 else t.dtype).numpy(),
        params)


def dtype_names(tree):
    """Like-structured tree of each leaf's dtype name ("float32", ...)."""
    return tree_map(lambda t: str(t.dtype).replace("torch.", ""), tree)


def world_from_arrays(*, model, adjacency: np.ndarray,
                      xs: Sequence[np.ndarray], ys: Sequence[np.ndarray],
                      x_test: np.ndarray, y_test: np.ndarray,
                      weights: Optional[np.ndarray] = None,
                      name: str = "from_arrays", device: DeviceLike = None):
    """A port World over a given graph and data.  `adjacency` is the
    [N, N] {0,1} matrix and `weights` the [N, N] ω_ij (edge indicator when
    omitted); the padded neighbour layout is rebuilt from them exactly as
    both packages build it."""
    from repro_torch.engine.experiment import World
    from repro_torch.graphs.topology import _from_adjacency

    topo = _from_adjacency(name, np.asarray(adjacency))
    if weights is not None:
        topo = dataclasses.replace(
            topo, weights=np.asarray(weights, np.float32))
    return World(model=model, topo=topo, xs=[np.asarray(x) for x in xs],
                 ys=[np.asarray(y) for y in ys], x_test=np.asarray(x_test),
                 y_test=np.asarray(y_test), device=device)
