"""Partition-spec inference for the production mesh, and its placement on a
`torch.distributed` DeviceMesh.

The PyTorch counterpart of the JAX package's `repro.dist.sharding`, with
its rules and names.  Mesh convention (`launch/mesh.py`):

  * "data"  — batch / data parallelism,
  * "model" — tensor parallelism (weights and feature dims),
  * "pod"   — optional leading axis carrying the DFL node dimension: one
              decentralized-learning participant per pod (`NODE_AXIS`, the
              axis of the port's pod backend, `dist/dfl_step.py`).

Specs are inferred per leaf from shape + dtype alone, so the same rules
cover every architecture family without per-model sharding tables:

  * integer/bool leaves replicate (token ids, slot maps, counters),
  * small leaves replicate (norm scales, biases),
  * leading stack dims (the [L, ...] layer stacks, the DFL node dim) are
    never sharded over "data"/"model"; the node dim maps to "pod",
  * of the remaining dims, the largest dim divisible by the axis size goes
    to "model", the largest other divisible dim to "data"; non-divisible
    dims stay unsharded rather than forcing padding.

A spec is a `P`: a tuple with one entry per tensor dimension, each an axis
name, a tuple of axis names or None; it compares equal, as a tuple, to the
reference's `jax.sharding.PartitionSpec`.  `mesh` is anything with a
`.shape` mapping axis name -> size (as the reference's tests pass), or a
`DeviceMesh` (its `mesh_dim_names` and `shape`).  In place of the
reference's `named` (NamedShardings for `jit`), `placements` turns a spec
into DTensor placements on a DeviceMesh and `distribute_tree` places a
whole tree, and `full_tree` gathers one back.  The partitioned steps of
`dist/dfl_step.py` (`mesh=`) and the dry run (`launch/dryrun.py`) place
their params, state, batch and cache this way; the pod backend moves whole
node blocks between ranks instead.
"""
from __future__ import annotations

import math

import numpy as np
import torch

DATA_AXIS = "data"
MODEL_AXIS = "model"
NODE_AXIS = "pod"

# Leaves with fewer elements than this (ignoring reserved leading dims)
# replicate: at bf16 this is a 128 KiB ceiling.
SMALL_LEAF_ELEMS = 1 << 16

# Keys whose subtrees carry stacked per-layer params with this many leading
# stack dims ([L, ...]; zamba's mamba blocks are [G, E, ...]).
_STACK_LEAD = {"layers": 1, "enc_layers": 1, "dec_layers": 1, "mamba": 2}

# MoE expert weights [L, E, D, F]: with expert parallelism the E dim shards
# over "model".
_EXPERT_KEYS = {"wg", "wu", "wd"}


class P(tuple):
    """A partition spec: P("data", None, ("pod", "data"))."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


def _sizes(mesh) -> dict:
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, (int(d) for d in mesh.shape)))
    return {k: int(v) for k, v in mesh.shape.items()}


def _axis_size(mesh, name: str) -> int:
    return _sizes(mesh).get(name, 1)


def _replicated(dtype) -> bool:
    if isinstance(dtype, torch.dtype):
        return not (dtype.is_floating_point or dtype.is_complex)
    return np.dtype(dtype).kind in "iub"


def _is_leaf(x) -> bool:
    """A tensor (or anything with `.shape` and `.dtype`) or a (shape,
    dtype) pair, the port's spec form (`LM.input_specs`)."""
    return hasattr(x, "shape") or (
        isinstance(x, tuple) and len(x) == 2
        and isinstance(x[1], (torch.dtype, np.dtype)))


def _shape_dtype(leaf):
    if hasattr(leaf, "shape"):
        return tuple(int(d) for d in leaf.shape), leaf.dtype
    return tuple(int(d) for d in leaf[0]), leaf[1]


def _map_with_path(fn, tree, path=()):
    """`fn(path keys, leaf)` over nested dicts / lists / tuples."""
    if _is_leaf(tree):
        return fn(path, tree)
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, tree[k], path + (str(k),))
                for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, v, path + (str(i),))
                          for i, v in enumerate(tree))
    raise TypeError(f"not a tensor tree: {type(tree).__name__}")


def leaf_spec(shape, dtype, n_lead, data_axis, model_axis, mesh) -> P:
    """Infer the partition spec for one leaf.

    Args:
      shape, dtype: the leaf's shape and dtype (torch or numpy).
      n_lead: number of leading stack dims that must stay unsharded here
        (layer dims, the DFL node dim — the caller owns those).
      data_axis, model_axis: mesh axis names.
      mesh: anything with a `.shape` mapping axis name -> size, or a
        DeviceMesh.
    """
    shape = tuple(int(d) for d in shape)
    rank = len(shape)
    spec = [None] * rank
    if rank == 0 or rank <= n_lead or _replicated(dtype):
        return P(*spec)
    if math.prod(shape[n_lead:]) < SMALL_LEAF_ELEMS:
        return P(*spec)
    by_size = sorted(range(n_lead, rank), key=lambda i: (-shape[i], i))
    model_n = _axis_size(mesh, model_axis)
    model_dim = next((i for i in by_size if shape[i] % model_n == 0), None)
    if model_dim is not None:
        spec[model_dim] = model_axis
    data_n = _axis_size(mesh, data_axis)
    data_dim = next(
        (i for i in by_size if i != model_dim and shape[i] % data_n == 0),
        None)
    if data_dim is not None:
        spec[data_dim] = data_axis
    return P(*spec)


def make_param_specs(params, mesh, *, dfl_node_axis: bool = False,
                     expert_parallel: bool = False):
    """Partition specs for a parameter tree (same structure, P leaves).

    With `dfl_node_axis=True` every leaf carries a leading per-node stack
    dim (one model per DFL participant) which maps to the "pod" axis."""
    sizes = _sizes(mesh)
    pod_n = sizes.get(NODE_AXIS, 1)

    def one(keys, leaf):
        shape, dtype = _shape_dtype(leaf)
        n_stack = max((_STACK_LEAD.get(k, 0) for k in keys), default=0)
        n_lead = int(dfl_node_axis) + n_stack
        e_dim = n_lead
        if (expert_parallel and keys and keys[-1] in _EXPERT_KEYS
                and len(shape) > e_dim
                and shape[e_dim] % sizes.get(MODEL_AXIS, 1) == 0):
            spec = [None] * len(shape)
            spec[e_dim] = MODEL_AXIS
            rest = sorted(range(e_dim + 1, len(shape)),
                          key=lambda i: (-shape[i], i))
            data_dim = next((i for i in rest
                             if shape[i] % sizes.get(DATA_AXIS, 1) == 0),
                            None)
            if data_dim is not None:
                spec[data_dim] = DATA_AXIS
        else:
            spec = list(leaf_spec(shape, dtype, n_lead, DATA_AXIS,
                                  MODEL_AXIS, mesh))
        if (dfl_node_axis and shape and NODE_AXIS in sizes
                and shape[0] % pod_n == 0):
            spec[0] = NODE_AXIS
        return P(*spec)

    return _map_with_path(one, params)


def make_batch_specs(batch, mesh, *, dfl_node_axis: bool = False,
                     dp_axes=(DATA_AXIS,)):
    """Partition specs for input batches: the batch dim shards over
    `dp_axes` (e.g. ("pod", "data") for multi-pod prefill), everything else
    replicates.  With `dfl_node_axis=True` dim 0 is the per-node stack dim
    -> "pod"."""
    sizes = _sizes(mesh)
    total = math.prod(sizes.get(a, 1) for a in dp_axes)

    def one(_, leaf):
        shape, _dtype = _shape_dtype(leaf)
        rank = len(shape)
        spec = [None] * rank
        b_dim = 0
        if dfl_node_axis:
            if (rank and NODE_AXIS in sizes
                    and shape[0] % sizes[NODE_AXIS] == 0):
                spec[0] = NODE_AXIS
            b_dim = 1
        if rank > b_dim and shape[b_dim] % total == 0:
            spec[b_dim] = dp_axes[0] if len(dp_axes) == 1 else tuple(dp_axes)
        return P(*spec)

    return _map_with_path(one, batch)


def make_cache_specs(cache, mesh):
    """Partition specs for decode caches.

    KV caches are [L, B, W, H, hd] (ring-buffer window W); SSM states are
    [L, B, ...].  The layer-stack dim and the window dim never shard;
    batch -> "data", and the largest divisible trailing feature dim
    (head_dim, conv channels, state) -> "model".  Integer leaves (slot_pos,
    length) replicate."""
    model_n = _axis_size(mesh, MODEL_AXIS)
    data_n = _axis_size(mesh, DATA_AXIS)

    def one(_, leaf):
        shape, dtype = _shape_dtype(leaf)
        rank = len(shape)
        spec = [None] * rank
        if rank < 2 or _replicated(dtype):
            return P(*spec)
        if shape[1] % data_n == 0:
            spec[1] = DATA_AXIS
        first_feature = 3 if rank >= 4 else 2
        for i in range(rank - 1, first_feature - 1, -1):
            if shape[i] % model_n == 0:
                spec[i] = MODEL_AXIS
                break
        return P(*spec)

    return _map_with_path(one, cache)


def placements(spec, mesh):
    """DTensor placements of `spec` on a DeviceMesh: for each mesh
    dimension, `Shard(i)` where the spec names it at tensor dim i and
    `Replicate()` otherwise."""
    from torch.distributed.tensor import Replicate, Shard

    out = []
    for name in mesh.mesh_dim_names:
        dims = [i for i, e in enumerate(spec)
                if e == name or (isinstance(e, tuple) and name in e)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return out


def distribute_tree(tree, specs, mesh):
    """`distribute_tensor` of every leaf of `tree` by its spec in the
    like-structured `specs`: a tree of DTensors on `mesh`.  Every rank
    passes the same whole tree (rank 0's values are broadcast)."""
    from torch.distributed.tensor import distribute_tensor

    if isinstance(tree, dict):
        return {k: distribute_tree(tree[k], specs[k], mesh) for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(distribute_tree(t, s, mesh)
                          for t, s in zip(tree, specs))
    return distribute_tensor(tree, mesh, placements(specs, mesh))


def full_tree(tree):
    """The whole tensors of a tree of DTensors (`full_tensor()` of each
    leaf, an all-gather of its shards); other leaves as they are."""
    if isinstance(tree, dict):
        return {k: full_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(full_tree(v) for v in tree)
    if type(tree).__name__ == "DTensor":
        return tree.full_tensor()
    return tree

