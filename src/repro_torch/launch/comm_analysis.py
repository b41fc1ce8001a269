"""Collective traffic of a traced step, per op type.

The counterpart of the JAX package's `launch/hlo_analysis.py`
(`collective_bytes`).  The reference parses XLA's post-SPMD HLO text and
sums the operand bytes of every collective; the port has no HLO, so
`CollectiveCounter` is a dispatch mode that sees the collectives as the
step issues them: every `_c10d_functional` op (what DTensor's
redistributions and the port's own `funcol` calls dispatch, with or
without autograd) and every in-place `c10d` op (`torch.distributed`'s
eager API).  It steps aside for tensor subclasses, so under DTensor it
sees the ops on the local shards: the bytes are per device.

Operand conventions, the reference's (`hlo_analysis.py:59-64`): an
all-reduce, all-to-all, broadcast or permute counts its input; an
all-gather counts its input (the result divided by the group), and a
reduce-scatter its input (the result times the group).  `summary()` gives
the reference's keys: `"total"`, and for each op type seen its bytes and
`"<op>_count"`.  Under `FakeTensorMode` the collectives never run (their
fake kernels give the shapes), so a step traced on a fake process group
is counted as it would run.  `CollectiveCounter(apart=...)` keeps the
collectives over the named process groups apart (`summary(apart=True)`):
the dry run counts the multi mesh's pod-axis gossip that way, beside the
traffic inside a pod.
"""
from __future__ import annotations

from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

COLLECTIVE_OPS = (
    "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
    "collective-permute", "collective-broadcast", "ragged-all-to-all",
)

# op name (either namespace) -> (the reference's op type, index of the
# operand argument)
_KINDS = {
    "all_reduce": ("all-reduce", 0),
    "all_reduce_coalesced": ("all-reduce", 0),
    "all_gather_into_tensor": ("all-gather", 0),
    "all_gather_into_tensor_coalesced": ("all-gather", 0),
    "all_gather_into_tensor_out": ("all-gather", 0),
    "reduce_scatter_tensor": ("reduce-scatter", 0),
    "reduce_scatter_tensor_coalesced": ("reduce-scatter", 0),
    "all_to_all_single": ("all-to-all", 0),
    "broadcast": ("collective-broadcast", 0),
    # torch.distributed's in-place ops: (outputs, inputs, ...) or (tensors,
    # ...)
    "allreduce_": ("all-reduce", 0),
    "allreduce_coalesced_": ("all-reduce", 0),
    "allgather_": ("all-gather", 1),
    "allgather_into_tensor_coalesced_": ("all-gather", 1),
    "_allgather_base_": ("all-gather", 1),
    "reduce_scatter_": ("reduce-scatter", 1),
    "_reduce_scatter_base_": ("reduce-scatter", 1),
    "reduce_scatter_tensor_coalesced_": ("reduce-scatter", 1),
    "alltoall_": ("all-to-all", 1),
    "alltoall_base_": ("all-to-all", 1),
    "broadcast_": ("collective-broadcast", 0),
    "send": ("collective-permute", 0),
}
_NAMESPACES = ("_c10d_functional", "_c10d_functional_autograd", "c10d")


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_flatten(tree)[0]
               if isinstance(t, torch.Tensor))


def _group_name(args):
    """The process group a collective's arguments name: a c10d op's
    process group object, else a functional op's last string argument
    (its group name)."""
    import torch.distributed as dist

    for a in args:
        if isinstance(a, torch.ScriptObject):
            return dist.ProcessGroup.unbox(a).group_name
    names = [a for a in args if isinstance(a, str)]
    return names[-1] if names else None


class CollectiveCounter(TorchDispatchMode):
    """Per-device operand bytes and counts of the collectives dispatched
    inside it, by the reference's op types (module docstring), those over
    the process groups named in `apart` (group names) kept apart.  Leaves
    every op as it is."""

    def __init__(self, apart=()):
        super().__init__()
        self.apart = {str(g) for g in apart}
        self.bytes: Dict[str, int] = {op: 0 for op in COLLECTIVE_OPS}
        self.count: Dict[str, int] = {op: 0 for op in COLLECTIVE_OPS}
        self.bytes_apart: Dict[str, int] = {op: 0 for op in COLLECTIVE_OPS}
        self.count_apart: Dict[str, int] = {op: 0 for op in COLLECTIVE_OPS}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(t is not torch.Tensor and issubclass(t, torch.Tensor)
               and "FakeTensor" not in t.__name__ for t in types):
            return NotImplemented  # a subclass (DTensor): see its local ops
        kind = _KINDS.get(func._opname) if func.namespace in _NAMESPACES \
            else None
        if kind is not None:
            op, arg = kind
            apart = bool(self.apart) and _group_name(args) in self.apart
            nbytes, count = ((self.bytes_apart, self.count_apart) if apart
                             else (self.bytes, self.count))
            nbytes[op] += _nbytes(args[arg] if len(args) > arg else ())
            count[op] += 1
        return func(*args, **(kwargs or {}))

    def summary(self, apart: bool = False) -> Dict[str, int]:
        """{"total": bytes, op: bytes, op + "_count": n} for every op type
        seen (`hlo_analysis.collective_bytes`'s keys): of the collectives
        over the `apart` groups with `apart`, else of the others."""
        nbytes, count = ((self.bytes_apart, self.count_apart) if apart
                         else (self.bytes, self.count))
        out = {"total": sum(nbytes.values())}
        for op in COLLECTIVE_OPS:
            if count[op]:
                out[op] = nbytes[op]
                out[op + "_count"] = count[op]
        return out


def collective_bytes(fn, *args, **kwargs) -> Dict[str, int]:
    """`CollectiveCounter().summary()` of one call `fn(*args, **kwargs)`
    (the reference's `collective_bytes` of the call's compiled HLO)."""
    with CollectiveCounter() as counter:
        fn(*args, **kwargs)
    return counter.summary()
