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
  * `cache_from_numpy(tree, device, kv_dtype)` takes a reference decode
    cache of any family as numpy (k, v [L, B, W, K, hd] as float32, which
    holds bf16 exactly; slot_pos [L, W] and a 0-d length, int32; the
    SSM's conv windows and fp32 state, the hybrid's per-group rings, the
    enc-dec's cross K / V) and returns the port's cache;
    `params_to_numpy` is its inverse, so both packages decode from the
    same state.
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


#: decode-state entries kept in fp32 whatever the activation dtype (the
#: SSM's recurrent state); the other float entries are k / v-like
_FP32_CACHE = ("state",)


def cache_from_numpy(tree, device: DeviceLike = None,
                     kv_dtype: str = "float32"):
    """A decode cache as numpy -> the port's cache on `device`.  Every
    family's entries cross: the ring's k, v (and the hybrid's attn_k,
    attn_v, the enc-dec's cross_k, cross_v, the SSM's conv windows), cast
    to `kv_dtype` ("bfloat16" for a bf16 reference cache); the SSM's
    `state` in fp32; slot_pos / attn_slot_pos and a 0-d `length` as int32.
    `params_to_numpy` is its inverse."""
    dev = resolve_device(device)
    kv = torch_dtype(kv_dtype)
    out = {}
    for name, a in tree.items():
        a = np.asarray(a)
        if np.issubdtype(a.dtype, np.integer):
            dtype, arr = torch.int32, np.array(a, np.int32, copy=True)
        else:
            dtype = torch.float32 if name in _FP32_CACHE else kv
            arr = np.array(a, np.float32, copy=True)
        out[name] = torch.from_numpy(arr).to(dev).to(dtype)
    out["length"] = out["length"].reshape(())
    return out


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
