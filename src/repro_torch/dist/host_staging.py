"""A process-group backend that stages every collective through host
memory: gloo on host copies of the tensors.

Several ranks sharing ONE card cannot use NCCL (it refuses two ranks on a
device), so they run gloo, whose CUDA collectives stage through the host
themselves.  On the H100 (torch 2.11, CUDA 12.8) gloo carries the eager
collectives on CUDA tensors and the functional ones that DTensor issues
-- all-reduce (sum, max), reduce-scatter, all-to-all, broadcast -- except
the functional all-gather (`_c10d_functional.all_gather_into_tensor`),
which ends the process with SIGSEGV.  DTensor gathers every sharded weight
with it, so the partitioned step cannot run over gloo there.  This backend
copies each collective's CUDA inputs to host tensors, runs gloo's own
collective on them, waits, and copies the results back into the CUDA
outputs: the same collectives, the same arithmetic (gloo's, on the same
values), nothing skipped.  It is for ranks that share a card; ranks on
cards of their own take NCCL.

    from repro_torch.dist import host_staging
    dist.init_process_group(host_staging.register(), store=..., rank=r,
                            world_size=n)

`register()` registers the backend (once) under `BACKEND` for CPU and CUDA
tensors and returns its name.  Every collective blocks until its result is
on the device (the returned work is complete), so a step over it costs the
host round trips that path m's gloo gather pays too.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

BACKEND = "hoststaged"


def _done(result):
    from torch._C._distributed_c10d import _create_work_from_future

    fut = torch.futures.Future()
    fut.set_result(result)
    return _create_work_from_future(fut)


def _host(tensors):
    return [t.detach().cpu() for t in tensors]


def _back(outs, hosts):
    for o, h in zip(outs, hosts):
        if o.data_ptr() != h.data_ptr():
            o.copy_(h)


class HostStagedGroup(dist.ProcessGroup):
    """gloo on host copies of each collective's tensors (module
    docstring).  Both the names of the collectives that this torch's
    process group calls and their older aliases are defined."""

    def __init__(self, store, rank, size, timeout):
        super().__init__(rank, size)
        self._gloo = dist.ProcessGroupGloo(store, rank, size, timeout)

    def getBackendName(self):  # noqa: N802 (the c10d method's name)
        return BACKEND

    @property
    def group_name(self):
        return dist.distributed_c10d._world.pg_names[self]

    def allreduce(self, tensors, opts=None):
        h = _host(tensors)
        self._gloo.allreduce(h, opts).wait()
        _back(tensors, h)
        return _done(tensors)

    def allreduce_coalesced(self, tensors, opts=None):
        h = _host(tensors)
        self._gloo.allreduce_coalesced(
            h, opts or dist.AllreduceCoalescedOptions()).wait()
        _back(tensors, h)
        return _done(tensors)

    def broadcast(self, tensors, opts=None):
        h = _host(tensors)
        self._gloo.broadcast(h, opts).wait()
        _back(tensors, h)
        return _done(tensors)

    def allgather(self, outputs, inputs, opts=None):
        ho = [_host(o) for o in outputs]
        self._gloo.allgather(ho, _host(inputs), opts).wait()
        for o, h in zip(outputs, ho):
            _back(o, h)
        return _done(outputs)

    def _allgather_base(self, output, inp, opts=None):
        (ho,), (hi,) = _host([output]), _host([inp])
        self._gloo._allgather_base(ho, hi).wait()
        _back([output], [ho])
        return _done([output])

    all_gather_single = _allgather_base

    def allgather_into_tensor_coalesced(self, outputs, inputs, opts=None):
        for o, i in zip(outputs, inputs):
            self._allgather_base(o, i)
        return _done(outputs)

    all_gather_single_coalesced = allgather_into_tensor_coalesced

    def _reduce_scatter_base(self, output, inp, opts=None):
        (ho,), (hi,) = _host([output]), _host([inp])
        self._gloo._reduce_scatter_base(ho, hi, opts).wait()
        _back([output], [ho])
        return _done([output])

    reduce_scatter_single = _reduce_scatter_base

    def reduce_scatter_tensor_coalesced(self, outputs, inputs, opts=None):
        for o, i in zip(outputs, inputs):
            self._reduce_scatter_base(o, i, opts)
        return _done(outputs)

    reduce_scatter_single_coalesced = reduce_scatter_tensor_coalesced

    def reduce_scatter(self, outputs, inputs, opts=None):
        ho = _host(outputs)
        self._gloo.reduce_scatter(ho, [_host(i) for i in inputs],
                                  opts).wait()
        _back(outputs, ho)
        return _done(outputs)

    def alltoall_base(self, output, inp, out_splits, in_splits, opts=None):
        (ho,), (hi,) = _host([output]), _host([inp])
        self._gloo.alltoall_base(ho, hi, out_splits, in_splits).wait()
        _back([output], [ho])
        return _done([output])

    all_to_all_single = alltoall_base

    def scatter(self, outputs, inputs, opts=None):
        ho = _host(outputs)
        self._gloo.scatter(ho, [_host(i) for i in inputs], opts).wait()
        _back(outputs, ho)
        return _done(outputs)

    def barrier(self, opts=None):
        self._gloo.barrier().wait()
        return _done([])


def _create(store, rank, size, timeout):
    return HostStagedGroup(store, rank, size, timeout)


def register() -> str:
    """Register the backend for CPU and CUDA tensors (once); its name."""
    if BACKEND.upper() not in dist.Backend._plugins:
        dist.Backend.register_backend(BACKEND, _create,
                                      devices=["cpu", "cuda"])
    return BACKEND
