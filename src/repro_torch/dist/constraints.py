"""Sharding constraints inside the model forward passes.

The PyTorch counterpart of the JAX package's `repro.dist.constraints`,
with its signatures and axis rules.  The reference turns each call into a
`with_sharding_constraint` on the mesh of the enclosing `with mesh:` block
and into the identity without one (its CPU tests and the vmapped
simulator).  Here `use_mesh(mesh)` installs a `DeviceMesh` for the model
code, and each wrapper `redistribute`s a DTensor to the placements of the
reference's spec (`sharding.placements`):

  * `constrain_batch`     — dim 0 over the data-parallel axes;
  * `constrain_residual`  — [B, S, D]: batch over data ("batch"), and S
                            over "model" too ("batch_seq");
  * `constrain_logits`    — [B, S, V]: batch over data, vocabulary over
                            "model" (the unembed's natural layout; the
                            loss then runs vocab-parallel and [B, S, V]
                            is never gathered);
  * `constrain_expert_sharded` — [B, E, C, D]: experts over "model";
  * `gather_weights`      — one layer's weights replicated (ZeRO-3's
                            just-in-time all-gather).

`vocab_shard(mesh, v)` states that vocabulary split once (whether V lies
over "model", this rank's offset, the group) for the embedding, the
unembed and the loss.

An axis absent from the mesh, or a dim its size does not divide, drops out
of the spec, as in the reference.  Without a mesh, and for a tensor that
is not a DTensor, every wrapper returns its argument itself, so every
path that places nothing is unchanged bit for bit.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Optional

from repro_torch.dist.sharding import (DATA_AXIS, MODEL_AXIS, NODE_AXIS,
                                       _sizes, placements)

# The meshes of the enclosing `use_mesh` blocks, innermost last: one stack
# for the process, not per thread, because autograd replays a remat
# layer's forward on its own threads during the backward.
_MESHES: list = []


@contextlib.contextmanager
def use_mesh(mesh):
    """Run the enclosed model code on `mesh` (the counterpart of the
    reference's `with mesh:`); `None` installs no mesh."""
    _MESHES.append(mesh)
    try:
        yield mesh
    finally:
        _MESHES.pop()


def current_mesh():
    """The mesh of the innermost `use_mesh`, or None outside any."""
    return _MESHES[-1] if _MESHES else None


def is_dtensor(x) -> bool:
    """Whether `x` is a DTensor (without importing DTensor when no mesh
    is in use)."""
    if current_mesh() is None and type(x).__name__ != "DTensor":
        return False
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def _axis(mesh, name: str, dim: int):
    sizes = _sizes(mesh)
    if name in sizes and dim % sizes[name] == 0:
        return name
    return None


def _batch_axes(mesh, dim: int):
    """Data-parallel axes for a batch dim: ("pod", "data") when the pod
    axis exists, as the reference shards a multi-pod batch."""
    sizes = _sizes(mesh)
    axes = [a for a in (NODE_AXIS, DATA_AXIS) if a in sizes]
    total = math.prod(sizes[a] for a in axes)
    if axes and dim % total == 0:
        return axes[0] if len(axes) == 1 else tuple(axes)
    return _axis(mesh, DATA_AXIS, dim)


def _constrain(mesh, x, spec):
    if all(s is None for s in spec):
        return x  # nothing left to say, as in the reference
    return x.redistribute(mesh, placements(spec, mesh))


def _target(x):
    """The mesh to constrain `x` on, or None (no mesh, or not a DTensor)."""
    mesh = current_mesh()
    if mesh is None or not is_dtensor(x):
        return None
    return mesh


def constrain_batch(x):
    """Keep dim 0 (batch) sharded over the data-parallel axes."""
    mesh = _target(x)
    if mesh is None or x.dim() == 0:
        return x
    spec = [None] * x.dim()
    spec[0] = _batch_axes(mesh, x.shape[0])
    return _constrain(mesh, x, spec)


def constrain_residual(x, kind: str = "batch"):
    """Residual stream [B, S, D]: "batch" shards B over data; "batch_seq"
    also shards S over "model" (sequence parallelism between the
    matmuls)."""
    mesh = _target(x)
    if mesh is None or x.dim() < 2:
        return x
    spec = [None] * x.dim()
    spec[0] = _batch_axes(mesh, x.shape[0])
    if kind == "batch_seq" and x.dim() >= 3:
        spec[1] = _axis(mesh, MODEL_AXIS, x.shape[1])
    return _constrain(mesh, x, spec)


def constrain_logits(x):
    """Logits [B, S, V]: batch over data, vocabulary over "model" (the
    unembed's output layout: [B, S, V] is never gathered)."""
    mesh = _target(x)
    if mesh is None or x.dim() < 2:
        return x
    spec = [None] * x.dim()
    spec[0] = _batch_axes(mesh, x.shape[0])
    spec[-1] = _axis(mesh, MODEL_AXIS, x.shape[-1])
    return _constrain(mesh, x, spec)


@dataclasses.dataclass(frozen=True)
class VocabShard:
    """How a vocabulary lies over "model" on a mesh (`vocab_shard`):
    `split` when each "model" shard holds a range of it, `offset` the
    first id of this rank's range, `group` "model"'s process group."""
    split: bool
    offset: int = 0
    group: object = None
    axis: Optional[int] = None  # the index of "model" in the mesh's dims

    def place(self, pl, dim: int):
        """Placements `pl` with the vocabulary (tensor dim `dim`) split
        over "model" when `split`, else `pl` as they are."""
        from torch.distributed.tensor import Shard

        if not self.split:
            return tuple(pl)
        pl = list(pl)
        pl[self.axis] = Shard(dim)
        return tuple(pl)


def vocab_shard(mesh, v: int) -> VocabShard:
    """The vocabulary split of `constrain_logits` for `v` entries: over
    "model" when that axis has more than one shard and divides v.  The
    embedding, the unembed and the loss all take it from here."""
    sizes = _sizes(mesh)
    m = sizes.get(MODEL_AXIS, 1)
    if m == 1 or v % m:
        return VocabShard(False)
    return VocabShard(True, int(mesh.get_local_rank(MODEL_AXIS)) * (v // m),
                      mesh.get_group(MODEL_AXIS),
                      tuple(mesh.mesh_dim_names).index(MODEL_AXIS))


def constrain_expert_sharded(h):
    """MoE dispatch buffers [B, E, C, D]: experts over "model", batch over
    data."""
    mesh = _target(h)
    if mesh is None or h.dim() < 2:
        return h
    spec = [None] * h.dim()
    spec[0] = _batch_axes(mesh, h.shape[0])
    spec[1] = _axis(mesh, MODEL_AXIS, h.shape[1])
    return _constrain(mesh, h, spec)


def gather_weights(layer_params):
    """ZeRO-3: one layer's weights replicated just before use (an
    all-gather of each sharded weight, whose backward reduce-scatters the
    gradient back to the weight's shards)."""
    mesh = current_mesh()
    if mesh is None:
        return layer_params
    from repro_torch.utils.pytree import tree_map

    return tree_map(lambda w: w.redistribute(
        mesh, placements([None] * w.dim(), mesh)) if is_dtensor(w) else w,
        layer_params)
