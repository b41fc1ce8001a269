"""Nested-dict parameter trees and their flat views.

Model and optimizer state in the port are plain nested dicts of tensors,
as in the JAX package.  The flat order is the one `jax.tree.flatten` gives
for such dicts: keys sorted at every level, depth first — so an MLP
flattens as fc0.b, fc0.w, fc1.b, fc1.w, ...  Row i of the stacked [N, D]
matrix therefore matches the JAX package's `tree_flatten_stacked` column
for column, which the DecDiff norm and any byte count depend on.

The arithmetic helpers (`tree_add` ... `tree_random_like`) are the JAX
package's, leafwise on tensors; the global reductions (`tree_dot`,
`tree_sq_norm`) sum each leaf in fp32 and add the leaves' sums in flat
order onto 0, as `jax.tree.reduce` does, and return a 0-d fp32 tensor.
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


def tree_add(a, b):
    return tree_map(torch.add, a, b)


def tree_sub(a, b):
    return tree_map(torch.sub, a, b)


def tree_scale(a, s):
    return tree_map(lambda x: x * s, a)


def tree_axpy(alpha, x, y):
    """alpha * x + y, leafwise."""
    return tree_map(lambda xi, yi: alpha * xi + yi, x, y)


def tree_zeros_like(a):
    return tree_map(torch.zeros_like, a)


def _reduce_sum(parts: List[torch.Tensor]) -> torch.Tensor:
    out = torch.zeros((), dtype=torch.float32,
                      device=parts[0].device if parts else None)
    for part in parts:
        out = out + part
    return out


def tree_dot(a, b) -> torch.Tensor:
    """Global inner product over all leaves (fp32 accumulation)."""
    return _reduce_sum([torch.sum(x.to(torch.float32) * y.to(torch.float32))
                        for x, y in zip(tree_leaves(a), tree_leaves(b))])


def tree_sq_norm(a) -> torch.Tensor:
    """Global squared L2 norm over all leaves (fp32 accumulation)."""
    return _reduce_sum([torch.sum(torch.square(x.to(torch.float32)))
                        for x in tree_leaves(a)])


def tree_l2_norm(a) -> torch.Tensor:
    return torch.sqrt(tree_sq_norm(a))


def tree_l2_dist(a, b) -> torch.Tensor:
    return tree_l2_norm(tree_sub(a, b))


def tree_weighted_sum(trees, weights):
    """Sum_k weights[k] * trees[k] over like-structured trees."""
    if not trees or len(trees) != len(weights):
        raise ValueError(f"{len(trees)} trees and {len(weights)} weights")
    out = tree_scale(trees[0], weights[0])
    for t, w in zip(trees[1:], weights[1:]):
        out = tree_map(lambda o, x, _w=w: o + _w * x, out, t)
    return out


def tree_stack(trees):
    """Stack like-structured trees along a new leading axis."""
    return tree_map(lambda *xs: torch.stack(xs, dim=0), *trees)


def tree_unstack(tree, n: int):
    """Inverse of `tree_stack`: the leading axis split into n trees."""
    return [tree_index(tree, i) for i in range(n)]


def tree_index(tree, i):
    """Index i along the leading axis of every leaf."""
    return tree_map(lambda x: x[i], tree)


def tree_cast(tree, dtype):
    return tree_map(lambda x: x.to(dtype), tree)


def tree_random_like(gen: torch.Generator, tree, scale=1.0):
    """Random-normal tree of the same structure, shapes and dtypes: each
    leaf N(0, 1) · scale drawn in fp32 from `gen` (on the leaves' device)
    in flat order, then cast (for tests)."""
    return tree_unflatten_like(tree, [
        (torch.randn(l.shape, generator=gen, dtype=torch.float32,
                     device=l.device) * scale).to(l.dtype)
        for l in tree_leaves(tree)])


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

