"""Nested-dict parameter trees and their flat views.

Model and optimizer state in the port are plain nested dicts of tensors,
as in the JAX package.  The flat order is the one `jax.tree.flatten` gives
for such dicts: keys sorted at every level, depth first — so an MLP
flattens as fc0.b, fc0.w, fc1.b, fc1.w, ...  Row i of the stacked [N, D]
matrix therefore matches the JAX package's `tree_flatten_stacked` column
for column, which the DecDiff norm and any byte count depend on.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Tuple

import torch

Tree = Dict[str, object]


def tree_leaves(tree) -> List[torch.Tensor]:
    """Leaves in sorted-key depth-first order (`jax.tree.flatten` order)."""
    if isinstance(tree, dict):
        out: List[torch.Tensor] = []
        for k in sorted(tree):
            out.extend(tree_leaves(tree[k]))
        return out
    return [tree]


def tree_unflatten_like(tree, leaves: List[torch.Tensor]):
    """Rebuild `tree`'s structure from leaves given in `tree_leaves` order."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        return next(it)

    out = build(tree)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree has slots")
    return out


def tree_map(fn: Callable, tree, *rest):
    """Apply `fn` leafwise over like-structured trees."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    return fn(tree, *rest)


def tree_size(tree) -> int:
    """Total number of scalar parameters."""
    return int(sum(t.numel() for t in tree_leaves(tree)))


def tree_bytes(tree) -> int:
    """Total bytes of the leaves in their own dtypes."""
    return int(sum(t.numel() * t.element_size() for t in tree_leaves(tree)))


def tree_flatten_to_vector(tree) -> Tuple[torch.Tensor, Callable]:
    """All leaves concatenated into one flat fp32 vector, and its inverse."""
    leaves = tree_leaves(tree)
    shapes = [l.shape for l in leaves]
    dtypes = [l.dtype for l in leaves]
    sizes = [l.numel() for l in leaves]
    vec = torch.cat([l.reshape(-1).to(torch.float32) for l in leaves])

    def unflatten(v: torch.Tensor):
        out, off = [], 0
        for shape, dtype, size in zip(shapes, dtypes, sizes):
            out.append(v[off:off + size].reshape(shape).to(dtype))
            off += size
        return tree_unflatten_like(tree, out)

    return vec, unflatten


def tree_flatten_stacked(tree) -> Tuple[torch.Tensor, Callable]:
    """Leaves [N, ...] -> one [N, D] fp32 matrix (row i = node i's model),
    and an unflatten that accepts any [M, D] matrix and restores every
    leaf's shape and dtype (bf16 leaves round to nearest, as JAX's
    `astype` does)."""
    leaves = tree_leaves(tree)
    if not leaves:
        raise ValueError("empty parameter tree")
    lead = leaves[0].shape[0]
    tails = [tuple(l.shape[1:]) for l in leaves]
    dtypes = [l.dtype for l in leaves]
    sizes = [math.prod(t) for t in tails]
    # each leaf is cast straight into its columns: no fp32 copy of the
    # leaves besides the matrix itself (7.4 GB for four qwen1.5-0.5b nodes)
    mat = torch.empty((lead, sum(sizes)), dtype=torch.float32,
                      device=leaves[0].device)
    off = 0
    for leaf, size in zip(leaves, sizes):
        mat[:, off:off + size].copy_(leaf.reshape(lead, size))
        off += size

    def unflatten(m: torch.Tensor):
        out, off = [], 0
        for tail, dtype, size in zip(tails, dtypes, sizes):
            out.append(m[:, off:off + size].reshape((m.shape[0],) + tail)
                       .to(dtype).contiguous())
            off += size
        return tree_unflatten_like(tree, out)

    return mat, unflatten

