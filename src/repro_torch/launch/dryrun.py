"""Fake-tensor dry run: every (arch x shape x mesh) built, placed on its
production mesh and traced, allocating nothing.

The PyTorch counterpart of the JAX package's `repro.launch.dryrun`, with
its CLI, shapes, variants and record fields.  The reference lowers and
compiles each step with XLA on 512 forced host devices and reads XLA's
cost and memory analyses; the port has no compiler to ask, so for each
combination it

  1. joins a fake process group of 256 ranks (single: data 16 x model 16)
     or 512 (multi: pod 2 x data 16 x model 16) and builds the mesh with
     `init_device_mesh` (device type "cpu": nothing lands on a card);
  2. under `FakeTensorMode`, builds the abstract params (one node, or one
     node per pod stacked [P, ...] for the multi-pod DFL round), the
     optimizer state, the batch from `lm.input_specs` and the decode cache
     from `init_cache`, and places each on the mesh by the ported specs
     (`repro_torch.dist.sharding`): `argument_size_in_bytes` is the sum of
     the placed leaves' `to_local()` bytes, exact per device;
  3. traces the step at the global batch with `remat=False` and the
     reference calibration's attention chunks (4096 x 8192; the FLOPs do
     not depend on them): `build_train_step` (single), `build_dfl_round`
     over the pods, one node per pod on a ring (multi), the forward
     (prefill), one `decode_step` (decode).  `FlopCounterMode` counts the
     FLOPs and `_BytesAccessed` the bytes every aten op reads and writes
     (XLA's unfused "bytes accessed"); both are divided by the chip count;
  4. traces the step once more at one device's data-parallel share of the
     batch, with the shape's own config (`remat` on for train_4k, as the
     reference compiles it) and the same attention chunks, under
     `MemTracker`: `temp_size_in_bytes` is the peak of the live bytes
     beyond the step's inputs.  It is an upper bound: the weights, their
     gradients and the activations are whole there, not split over
     "model" as a sharded step would hold them, and a 32k sequence's
     score block is 4096 x 8192 (the default 512 x 1024 chunks would make
     the trace walk 64 times the blocks).

Every family (`partitions`: all ten archs) traces the PARTITIONED step
instead, as the reference compiles it: params (with
`expert_parallel=cfg.expert_parallel`), optimizer state, batch and cache
placed by the specs, and
`build_*_step(mesh=)` run at the global batch on the fake group (steps 3
and 4 above become one trace each, with remat off and with the shape's
config, after one uncounted run that fills DTensor's sharding-propagation
cache).  On the multi mesh train_4k traces `build_dfl_round(mesh=)`: rank
0's pod block of one node on the pod's (data, model) sub-mesh
(`dist.sharding.place_node_block`), its share of the batch over "data",
the gossip over "pod" on the local shards; prefill and decode run on the
whole (pod, data, model) mesh, params replicated over "pod", prefill's
batch over ("pod", "data") and decode's tokens over "data" only, as the
reference's `t_specs` (`decode_token_specs`).  A dispatch mode that steps aside for DTensor sees
the ops on rank 0's local shards, so the FLOPs and bytes (`_LocalCounts`)
and the collectives (`launch/comm_analysis.py`, the counterpart of the
reference's `hlo_analysis.collective_bytes`, under its keys) are per
device as they come, and `temp_size_in_bytes` is the sharded step's own
peak (`temp_is_upper_bound: false`); the record says `"partitioned":
true`.  The multi mesh's shard_map variants keep the estimate above and
say `"partitioned": false`: they trace the reference's own shard_map
design (each pod holds its nodes whole).

XLA counts a while-loop body once, so the reference compiles extra
calibration points (1 and 2 layers) and extrapolates; a dispatch-level
count sees every layer, so `_calibration_points`, `calibrated_metrics`
and `_combine` have no counterpart.  `collectives.total` is the traffic
inside a pod (`intra_pod`, the partitioned step's collectives over the
"data" and "model" groups; null where the step is not partitioned) plus
the traffic over "pod": on a partitioned multi-mesh step, the collectives
over the pod group as counted (`pod_axis`, by op in `pod_axis_ops`; the
round's all-gathers of the models and of the loss are its `gossip`,
prefill's and decode's gathers of the new k / v and q are not); where the
round is not partitioned, the estimated `gossip` each device receives
(its shard of the other pods' models, in the gossip dtype; 0 for a
single pod).  The roofline uses the H100's data-sheet peaks (`HW`); `fits_hbm` compares argument + temp + output
bytes with the card's memory when a card is present, else with
`--hbm-bytes`.  Variants that change only the reference's sharding
constraints or its shard_map form trace the step of another variant where
the step is not partitioned, and their record says which (`"same_as"`);
on a partitioned step of the single mesh only the shard_map form has no
effect, and on the multi mesh the shard_map form selects the round over
whole nodes.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen1.5-0.5b --mesh both
  python -m repro_torch.launch.dryrun --all --mesh both
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import time
import traceback

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.dist.dfl_step import (
    build_dfl_round,
    build_prefill_step,
    build_serve_step,
    build_train_step,
)
from repro_torch.dist.sharding import (
    DATA_AXIS,
    NODE_AXIS,
    distribute_tree,
    make_batch_specs,
    make_cache_specs,
    make_param_specs,
    place_node_block,
)
from repro_torch.launch.comm_analysis import CollectiveCounter
from repro_torch.launch.mesh import HW
from repro_torch.launch.train import ring_adjacency
from repro_torch.models.lm import build_lm
from repro_torch.models.lm.config import torch_dtype
from repro_torch.optim.sgd import sgd_momentum
from repro_torch.utils.pytree import tree_leaves, tree_map

SHAPES = {
    # name: (seq_len, global_batch, kind)
    "train_4k": (4096, 256, "train"),
    "prefill_32k": (32768, 32, "prefill"),
    "decode_32k": (32768, 128, "decode"),
    "long_500k": (524288, 1, "decode"),
}

LONG_WINDOW = 8192  # ring-buffer window for full-attention archs at 500k

MESHES = {
    "single": ((16, 16), ("data", "model")),
    "multi": ((2, 16, 16), ("pod", "data", "model")),
}


# The reference's §Perf variants (EXPERIMENTS.md §Perf), by name.
VARIANTS = {
    "zero3": {"zero3_gather": True},
    "moelocal": {"moe_dispatch": "batch_local"},
    "expertpar": {"moe_dispatch": "batch_local", "expert_parallel": True},
    "gossipbf16": {"_gossip_dtype": "bfloat16"},  # DFL rounds only
    "moelocal+seqshard": {"moe_dispatch": "batch_local",
                          "residual_shard": "batch_seq"},
    "seqshard+gossipbf16": {"residual_shard": "batch_seq",
                            "_gossip_dtype": "bfloat16"},
    "shardmap": {"_dfl_shardmap": True},
    "shardmap+seqshard": {"_dfl_shardmap": True,
                          "residual_shard": "batch_seq"},
    "shardmap+seqshard+gossipbf16": {"_dfl_shardmap": True,
                                     "residual_shard": "batch_seq",
                                     "_gossip_dtype": "bfloat16"},
    "moelocal+bf16probs": {"moe_dispatch": "batch_local",
                           "attn_probs_bf16": True},
    "seqshard": {"residual_shard": "batch_seq"},
    "bf16probs": {"attn_probs_bf16": True},
    "zero3+bf16probs": {"zero3_gather": True, "attn_probs_bf16": True},
    "zero3+seqshard": {"zero3_gather": True, "residual_shard": "batch_seq"},
    "all": {"zero3_gather": True, "attn_probs_bf16": True,
            "residual_shard": "batch_seq"},
}

# Overrides that steer only the reference's sharding (its constraints,
# `dist/constraints.py`, are the identity in the port) or its shard_map
# form of the DFL round (one program over the pods either way here).
_SHARDING_ONLY = ("zero3_gather", "residual_shard", "_dfl_shardmap")

# The reference calibration's attention chunks: few enough blocks for a
# trace to walk, the same FLOPs (every block is computed and masked).
_TRACE_CHUNKS = {"attn_chunk_q": 4096, "attn_chunk_kv": 8192}


def _adapt_config(cfg, shape_name: str, layer_override=None):
    """Per-shape config adjustments, as the reference's."""
    layer_override = {k: v for k, v in (layer_override or {}).items()
                      if not k.startswith("_")}
    over = {}
    if shape_name == "long_500k" and cfg.family in ("dense", "vlm", "encdec"):
        # sliding-window variant: ring-buffer decode cache bounds state.
        over["decode_window"] = LONG_WINDOW
    over["remat"] = shape_name == "train_4k"
    over.update(layer_override)
    return dataclasses.replace(cfg, **over)


_SHARDMAP_REASON = (
    "the reference's shard_map form of the DFL round: every axis manual, "
    "so each pod holds its nodes' full replicas (src/repro/dist/"
    "dfl_step.py:202-205); traced as the round over whole nodes")


def partitions(cfg, mesh_kind: str, variant_override=None):
    """(whether the combination traces the partitioned step, and why not
    when it does not): every family does, on the single mesh and on the
    multi mesh, except for the multi mesh's shard_map variants, which
    trace the reference's own design (`_SHARDMAP_REASON`)."""
    if mesh_kind == "multi" and (variant_override or {}).get(
            "_dfl_shardmap"):
        return False, _SHARDMAP_REASON
    return True, None


def same_as(variant_override, partitioned: bool = False,
            keep=()) -> str | None:
    """The variant whose step a variant traces in the port, where its
    override differs from that one's only by keys that do not change the
    port's step ("baseline" for none left), else None: the
    `_SHARDING_ONLY` keys, or on a `partitioned` step the shard_map form
    alone; never the keys in `keep` (the multi mesh's shard_map form,
    which selects the unpartitioned round there)."""
    if not variant_override:
        return None
    inert = tuple(k for k in (("_dfl_shardmap",) if partitioned
                              else _SHARDING_ONLY) if k not in keep)
    rest = {k: v for k, v in variant_override.items() if k not in inert}
    if rest == variant_override:
        return None
    if not rest:
        return "baseline"
    return next((name for name, ov in VARIANTS.items() if ov == rest),
                None)


def model_flops_per_chip(cfg, shape_name: str, n_chips: int) -> float:
    """Analytic MODEL_FLOPS: 6·N·D train, 2·N·D forward; MoE uses active
    params (remat recompute is overhead by definition)."""
    seq_len, global_batch, kind = SHAPES[shape_name]
    n_active = cfg.active_param_count()
    if kind == "train":
        return 6.0 * n_active * seq_len * global_batch / n_chips
    if kind == "prefill":
        return 2.0 * n_active * seq_len * global_batch / n_chips
    return 2.0 * n_active * global_batch / n_chips  # one token a sequence


def roofline_terms(flops: float, bytes_accessed: float, coll_bytes: float):
    """The three roofline terms in seconds, per chip, at `HW`'s peaks."""
    return {"compute_s": flops / HW["peak_flops_bf16"],
            "memory_s": bytes_accessed / HW["hbm_bw"],
            "collective_s": coll_bytes / HW["link_bw"]}


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _tree_bytes(*trees) -> int:
    return sum(_nbytes(t) for t in tree_flatten(trees)[0]
               if isinstance(t, torch.Tensor))


class _BytesAccessed(TorchDispatchMode):
    """Σ over the aten ops of a trace of their tensor inputs' and outputs'
    bytes (XLA's unfused "bytes accessed"); a view moves nothing, and
    neither do the metadata queries (`prim.device`, ...) that a fake
    tensor dispatches."""

    def __init__(self):
        super().__init__()
        self.total = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.namespace == "aten" and not func.is_view:
            self.total += _tree_bytes(args, kwargs, out)
        return out


class _LocalCounts(CollectiveCounter):
    """FLOPs (`torch.utils.flop_counter`'s formulas) and bytes accessed
    (as `_BytesAccessed`) of the ops on the local shards, and the
    collectives (`CollectiveCounter`): steps aside for DTensor, so every
    count is one device's.  Count a step whose ops DTensor has seen
    before: its sharding propagation runs each new op once more at its
    global shape, which computes nothing on a device."""

    def __init__(self, apart=()):
        super().__init__(apart)
        self.flops = 0
        self.total = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.utils.flop_counter import flop_registry

        out = super().__torch_dispatch__(func, types, args, kwargs)
        if out is NotImplemented:
            return out
        if func.namespace == "aten" and not func.is_view:
            self.total += _tree_bytes(args, kwargs, out)
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            self.flops += int(formula(*args, **(kwargs or {}), out_val=out))
        return out


@contextlib.contextmanager
def fake_mesh(dims, names):
    """A DeviceMesh of `dims` over a fake process group of prod(dims)
    ranks (this process is rank 0), torn down on exit."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("the dry run needs a process without a process "
                           "group (it makes its own fake one)")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=math.prod(dims))
    try:
        yield init_device_mesh("cpu", tuple(dims),
                               mesh_dim_names=tuple(names))
    finally:
        dist.destroy_process_group()


def _local_sizes(tree, specs, mesh):
    """(bytes, elements): Σ over the placed leaves' `to_local()`."""
    local = [t.to_local() for t in
             tree_leaves(distribute_tree(tree, specs, mesh))]
    return sum(_nbytes(t) for t in local), sum(t.numel() for t in local)


def _local_bytes(tree, specs, mesh) -> int:
    return _local_sizes(tree, specs, mesh)[0]


def _empty(specs, lead=()):
    """Fake tensors of a {name: (shape, dtype)} spec dict, with leading
    dims `lead`."""
    return {k: torch.zeros(lead + tuple(s), dtype=d)
            for k, (s, d) in specs.items()}


def _init_params(lm, n_nodes=None):
    gen = torch.Generator().manual_seed(0)
    if n_nodes is None:
        return lm.init(gen, device="cpu")
    nodes = [lm.init(gen, device="cpu") for _ in range(n_nodes)]
    return tree_map(lambda *xs: torch.stack(xs), *nodes)


class _Combo:
    """One combination's inputs and step at a given batch, in fake mode."""

    def __init__(self, cfg, kind, multi, n_pods, batch, seq_len,
                 gossip_dtype):
        lm = build_lm(cfg)
        opt = sgd_momentum(lr=1e-3, momentum=0.9,
                           momentum_dtype=torch.float32)
        if kind == "train" and multi:
            self.params = _init_params(lm, n_pods)
            self.opt = opt.init(self.params)
            self.batch = _empty(lm.input_specs(batch // n_pods, seq_len),
                                (n_pods,))
            step = build_dfl_round(lm, opt, ring_adjacency(n_pods),
                                   gossip_dtype=gossip_dtype)
            self.args = (self.params, self.opt, 0, self.batch)
        elif kind == "train":
            self.params = _init_params(lm)
            self.opt = opt.init(self.params)
            self.batch = _empty(lm.input_specs(batch, seq_len))
            step = build_train_step(lm, opt)
            self.args = (self.params, self.opt, 0, self.batch)
        elif kind == "prefill":
            self.params = _init_params(lm)
            self.batch = _empty(lm.input_specs(batch, seq_len))
            step = build_prefill_step(lm)
            self.args = (self.params, self.batch)
        else:
            self.params = _init_params(lm)
            self.cache = lm.init_cache(batch, seq_len, device="cpu")
            self.tokens = torch.zeros((batch, 1), dtype=torch.int32)
            step = build_serve_step(lm)
            self.args = (self.params, self.cache, self.tokens)
        self.step = step

    def run(self):
        return self.step(*self.args)


def decode_token_specs(tokens, mesh):
    """The decode step's tokens [B, 1] placed as the reference's `t_specs`
    (`make_batch_specs(tokens_a, mesh)`): B over "data" only, on the
    multi mesh too (whose prefill batch lies over ("pod", "data"))."""
    return make_batch_specs(tokens, mesh)


def _dp_size(sizes, kind, multi) -> int:
    """How many ways the batch dim is split: over "pod" and "data" for
    multi-pod prefill, over "data" otherwise (in the DFL round the node
    dim carries the pods, and each node's batch splits over "data")."""
    if kind == "prefill" and multi:
        return sizes[NODE_AXIS] * sizes[DATA_AXIS]
    return sizes[DATA_AXIS]


def trace_combo(cfg, shape, mesh, *, multi: bool, gossip_dtype=None,
                shape_name: str = ""):
    """The record's measured fields for one combination on `mesh` (under
    a fake process group); `shape` = (seq_len, global_batch, kind)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.utils.flop_counter import FlopCounterMode

    seq_len, global_batch, kind = shape
    sizes = dict(zip(mesh.mesh_dim_names, (int(d) for d in mesh.shape)))
    n_chips = math.prod(sizes.values())
    n_pods = sizes.get(NODE_AXIS, 1)
    expert = cfg.expert_parallel
    out = {}
    with FakeTensorMode(allow_non_fake_inputs=True):
        # 2. the global inputs, placed on the mesh
        c = _Combo(cfg, kind, multi, n_pods, global_batch, seq_len,
                   gossip_dtype)
        p_specs = make_param_specs(c.params, mesh,
                                   dfl_node_axis=kind == "train" and multi,
                                   expert_parallel=expert)
        param_local, param_elems = _local_sizes(c.params, p_specs, mesh)
        arg = param_local
        if kind == "train":
            arg += _local_bytes(c.opt, {"momentum": p_specs}, mesh)
            arg += _local_bytes(c.batch, make_batch_specs(
                c.batch, mesh, dfl_node_axis=multi), mesh)
        elif kind == "prefill":
            dp = (NODE_AXIS, DATA_AXIS) if multi else (DATA_AXIS,)
            arg += _local_bytes(c.batch, make_batch_specs(
                c.batch, mesh, dp_axes=dp), mesh)
        else:
            arg += _local_bytes(c.cache, make_cache_specs(c.cache, mesh),
                                mesh)
            arg += _local_bytes(c.tokens, make_batch_specs(c.tokens, mesh),
                                mesh)
            out["cache_bytes_global"] = _tree_bytes(c.cache)
        out["traced_param_count"] = sum(
            t.numel() for t in tree_leaves(c.params)) // (
                n_pods if kind == "train" and multi else 1)
        del c

        # 3. FLOPs and bytes at the global batch, remat off
        flop_cfg = dataclasses.replace(cfg, remat=False, **_TRACE_CHUNKS)
        c = _Combo(flop_cfg, kind, multi, n_pods, global_batch, seq_len,
                   gossip_dtype)
        counted = _BytesAccessed()
        with FlopCounterMode(display=False) as flops, counted:
            c.run()
        flops_global = float(flops.get_total_flops())
        bytes_global = float(counted.total)
        del c

        # 4. live bytes at one device's share of the batch
        dfl = kind == "train" and multi
        batch = global_batch // n_pods if dfl else global_batch
        dp = _dp_size(sizes, kind, multi)
        share = batch // dp if batch % dp == 0 else batch
        # the DFL round keeps its node dim whole: every pod's node, each at
        # one device's share of its batch
        c = _Combo(dataclasses.replace(cfg, **_TRACE_CHUNKS), kind, multi,
                   n_pods, share * n_pods if dfl else share, seq_len,
                   gossip_dtype)
        inputs = _tree_bytes(c.args)
        mt = MemTracker()
        mt.track_external(*[t for t in tree_flatten(c.args)[0]
                            if isinstance(t, torch.Tensor)])
        with mt:
            result = c.run()
        peak = max(v["Total"] for v in mt.get_tracker_snapshot("peak")
                   .values())
        new_out = [t for t in tree_flatten(result)[0]
                   if isinstance(t, torch.Tensor)
                   and not any(t is a for a in tree_flatten(c.args)[0])]
        del c, result, mt

    # outputs that are new tensors: the DFL round's gossiped params (placed
    # as the params), the logits (batch split as the batch), the loss
    if kind == "train" and multi:
        output = param_local + 4
    else:
        output = sum(_nbytes(t) for t in new_out)
    coll = 0.0
    if kind == "train" and multi:  # the other pods' shards of the models
        coll = float((n_pods - 1) * (
            param_local if gossip_dtype is None
            else param_elems * gossip_dtype.itemsize))
    out.update(
        n_chips=n_chips,
        cost_analysis={"flops": flops_global / n_chips,
                       "bytes accessed": bytes_global / n_chips,
                       "flops_global": flops_global,
                       "bytes_accessed_global": bytes_global},
        memory_analysis={"argument_size_in_bytes": arg,
                         "output_size_in_bytes": output,
                         "temp_size_in_bytes": max(peak - inputs, 0),
                         "temp_is_upper_bound": True,
                         "temp_batch_per_device": share,
                         "attn_chunks": [_TRACE_CHUNKS["attn_chunk_q"],
                                         _TRACE_CHUNKS["attn_chunk_kv"]]},
        collectives={"total": coll, "intra_pod": None, "gossip": coll},
    )
    out["roofline"] = roofline_terms(out["cost_analysis"]["flops"],
                                     out["cost_analysis"]["bytes accessed"],
                                     coll)
    if shape_name in SHAPES:
        mf = model_flops_per_chip(cfg, shape_name, n_chips)
        out["model_flops_per_chip"] = mf
        out["useful_flops_ratio"] = (mf / out["cost_analysis"]["flops"]
                                     if flops_global else None)
    return out


class _Placed:
    """One partitioned combination's inputs, placed on the mesh by the
    specs, and its step (`build_*_step(mesh=)`; on the multi mesh
    `build_dfl_round(mesh=)` for train: rank 0's pod block of one node,
    its batch the node's share, on the pod's (data, model) sub-mesh)."""

    def __init__(self, cfg, kind, batch, seq_len, mesh, gossip_dtype=None):
        lm = build_lm(cfg)
        opt = sgd_momentum(lr=1e-3, momentum=0.9,
                           momentum_dtype=torch.float32)
        multi = NODE_AXIS in tuple(mesh.mesh_dim_names)
        if kind == "train" and multi:
            n_pods = int(mesh.size(0))
            self.params = place_node_block(
                _init_params(lm, 1), mesh,
                expert_parallel=cfg.expert_parallel)
            b = place_node_block(_empty(lm.input_specs(
                batch // n_pods, seq_len), (1,)), mesh, batch=True)
            self.step = build_dfl_round(lm, opt, ring_adjacency(n_pods),
                                        gossip_dtype=gossip_dtype, mesh=mesh)
            self.args = (self.params, opt.init(self.params), 0, b)
            return
        params = _init_params(lm)
        self.params = distribute_tree(params, make_param_specs(
            params, mesh, expert_parallel=cfg.expert_parallel), mesh)
        dp = (NODE_AXIS, DATA_AXIS) if multi else (DATA_AXIS,)
        if kind == "decode":
            cache = lm.init_cache(batch, seq_len, device="cpu")
            self.cache_bytes_global = _tree_bytes(cache)
            cache = distribute_tree(cache, make_cache_specs(cache, mesh),
                                    mesh)
            tokens = torch.zeros((batch, 1), dtype=torch.int32)
            tokens = distribute_tree(tokens, decode_token_specs(
                tokens, mesh), mesh)
            self.step = build_serve_step(lm, mesh=mesh)
            self.args = (self.params, cache, tokens)
            return
        b = _empty(lm.input_specs(batch, seq_len))
        b = distribute_tree(b, make_batch_specs(b, mesh, dp_axes=dp), mesh)
        if kind == "train":
            self.step = build_train_step(lm, opt, mesh=mesh)
            self.args = (self.params, opt.init(self.params), 0, b)
        else:
            self.step = build_prefill_step(lm, mesh=mesh)
            self.args = (self.params, b)

    def local_tensors(self, tree=None):
        tree = self.args if tree is None else tree
        return [t.to_local() if type(t).__name__ == "DTensor" else t
                for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]

    def run(self):
        return self.step(*self.args)


def trace_partitioned(cfg, shape, mesh, *, shape_name: str = "",
                      gossip_dtype=None):
    """The record's measured fields for a partitioned combination on
    `mesh` (under a fake process group): every count from rank 0's local
    ops (module docstring); on the multi mesh the collectives over the
    pod group are the gossip, the others the traffic inside the pod."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed._tools.mem_tracker import MemTracker

    seq_len, global_batch, kind = shape
    sizes = dict(zip(mesh.mesh_dim_names, (int(d) for d in mesh.shape)))
    n_chips = math.prod(sizes.values())
    pod_group = ([mesh.get_group(NODE_AXIS).group_name]
                 if NODE_AXIS in sizes else [])

    def placed(over):
        return _Placed(dataclasses.replace(cfg, **over, **_TRACE_CHUNKS),
                       kind, global_batch, seq_len, mesh, gossip_dtype)

    out = {}
    with FakeTensorMode(allow_non_fake_inputs=True):
        # FLOPs, bytes and collectives, remat off
        placed({"remat": False}).run()  # DTensor's sharding propagation,
        c = placed({"remat": False})    # cached from here on
        counted = _LocalCounts(apart=pod_group)
        with counted:
            c.run()
        del c
        # the sharded step's own live bytes, with the shape's config
        c = placed({})
        inputs = c.local_tensors()
        arg = sum(_nbytes(t) for t in inputs)
        out["traced_param_count"] = sum(
            t.numel() for t in tree_leaves(c.params))
        if kind == "decode":
            out["cache_bytes_global"] = c.cache_bytes_global
        mt = MemTracker()
        mt.track_external(*inputs)
        with mt:
            result = c.run()
        peak = max(v["Total"] for v in mt.get_tracker_snapshot("peak")
                   .values())
        held = {id(t) for t in tree_flatten(c.args)[0]}
        output = sum(_nbytes(t) for t in c.local_tensors(
            [t for t in tree_flatten(result)[0] if id(t) not in held]))
        del c, result, mt
    intra, pod_axis = counted.summary(), counted.summary(apart=True)
    coll = {**intra, "intra_pod": float(intra["total"]),
            "gossip": float(pod_axis["total"]) if kind == "train" else 0.0}
    if pod_group:  # the round's gossip; prefill's and decode's k, v, q
        coll.update(pod_axis=float(pod_axis["total"]),
                    pod_axis_ops=pod_axis)
    coll["total"] = coll["intra_pod"] + float(pod_axis["total"])
    dp, batch = sizes.get(DATA_AXIS, 1), global_batch
    if pod_group and kind == "train":  # a node's share, over "data"
        batch //= sizes[NODE_AXIS]
    elif pod_group and kind == "prefill":  # over ("pod", "data")
        dp *= sizes[NODE_AXIS]
    out.update(
        n_chips=n_chips, partitioned=True,
        cost_analysis={"flops": float(counted.flops),
                       "bytes accessed": float(counted.total)},
        memory_analysis={"argument_size_in_bytes": arg,
                         "output_size_in_bytes": output,
                         "temp_size_in_bytes": max(peak - arg, 0),
                         "temp_is_upper_bound": False,
                         "temp_batch_per_device": (
                             batch // dp if batch % dp == 0 else batch),
                         "attn_chunks": [_TRACE_CHUNKS["attn_chunk_q"],
                                         _TRACE_CHUNKS["attn_chunk_kv"]]},
        collectives=coll,
    )
    out["roofline"] = roofline_terms(counted.flops, counted.total,
                                     coll["total"])
    if shape_name in SHAPES:
        mf = model_flops_per_chip(cfg, shape_name, n_chips)
        out["model_flops_per_chip"] = mf
        out["useful_flops_ratio"] = mf / counted.flops if counted.flops \
            else None
    return out


def device_hbm_bytes(default: float = HW["hbm_bytes"]) -> float:
    """The card's memory when a card is present, else `default`."""
    if torch.cuda.is_available():
        return float(torch.cuda.get_device_properties(0).total_memory)
    return float(default)


def run_one(arch: str, shape_name: str, mesh_kind: str, out_dir: str,
            force: bool = False, variant: str = None,
            variant_override: dict = None, *, cfg=None, shape=None,
            mesh_dims=None, hbm_bytes: float = None) -> dict:
    """Trace one combination and write its record to
    `out_dir/<arch>__<shape>__<mesh>[__<variant>].json` (reused unless
    `force`).  `cfg`, `shape` ((seq_len, global_batch, kind)) and
    `mesh_dims` override the registered config, `SHAPES[shape_name]` and
    the production mesh (the tests' small cases)."""
    os.makedirs(out_dir, exist_ok=True)
    tag = f"{arch}__{shape_name}__{mesh_kind}".replace("/", "_")
    if variant:
        tag += f"__{variant}"
    path = os.path.join(out_dir, tag + ".json")
    if os.path.exists(path) and not force:
        with open(path) as f:
            return json.load(f)
    t0 = time.time()
    shape = shape or SHAPES[shape_name]
    seq_len, global_batch, kind = shape
    dims, names = MESHES[mesh_kind]
    dims = tuple(mesh_dims or dims)
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind, "ok": False,
           "variant": variant or "baseline",
           "variant_override": variant_override or {},
           "seq_len": seq_len, "global_batch": global_batch, "kind": kind,
           "mesh_shape": dict(zip(names, dims))}
    try:
        base = cfg if cfg is not None else get_config(arch)
        part, reason = partitions(base, mesh_kind, variant_override)
        twin = same_as(variant_override, part,
                       keep=("_dfl_shardmap",) if mesh_kind == "multi"
                       else ())
        if twin is not None:
            rec.update(ok=True, same_as=twin)
        else:
            full = _adapt_config(base, shape_name, variant_override)
            gd = (variant_override or {}).get("_gossip_dtype")
            with fake_mesh(dims, names) as mesh:
                if part:
                    rec.update(trace_partitioned(
                        full, shape, mesh,
                        shape_name=shape_name if cfg is None else "",
                        gossip_dtype=torch_dtype(gd) if gd else None))
                else:
                    rec.update(trace_combo(
                        full, shape, mesh, multi=mesh_kind == "multi",
                        gossip_dtype=torch_dtype(gd) if gd else None,
                        shape_name=shape_name if cfg is None else ""))
                    rec.update(partitioned=False, not_partitioned=reason)
            rec["param_count"] = int(base.param_count())
            rec["active_param_count"] = int(base.active_param_count())
            mem = rec["memory_analysis"]
            per_dev = (mem["argument_size_in_bytes"]
                       + mem["temp_size_in_bytes"]
                       + mem["output_size_in_bytes"])
            hbm = device_hbm_bytes() if hbm_bytes is None else hbm_bytes
            rec.update(ok=True, bytes_per_device=per_dev, hbm_bytes=hbm,
                       fits_hbm=bool(per_dev <= hbm))
    except Exception as e:  # noqa: BLE001 — record the failure, keep sweeping
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
    rec["trace_s"] = time.time() - t0
    with open(path, "w") as f:
        json.dump(rec, f, indent=2)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", choices=ARCH_IDS, default=None)
    ap.add_argument("--shape", choices=list(SHAPES), default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--all", action="store_true", help="sweep all combos")
    ap.add_argument("--out", default="artifacts/port/dryrun")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--variant", choices=sorted(VARIANTS), default=None,
                    help="apply a §Perf config variant (writes tagged "
                         "artifact)")
    ap.add_argument("--hbm-bytes", type=float, default=HW["hbm_bytes"],
                    help="device memory for fits_hbm without a card")
    args = ap.parse_args(argv)

    archs = ARCH_IDS if (args.all or args.arch is None) else [args.arch]
    shapes = list(SHAPES) if (args.all or args.shape is None) else [args.shape]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    hbm = device_hbm_bytes(args.hbm_bytes)

    n_ok = n_fail = 0
    records = []
    for arch in archs:
        for shape in shapes:
            for mesh_kind in meshes:
                rec = run_one(arch, shape, mesh_kind, args.out,
                              force=args.force, variant=args.variant,
                              variant_override=VARIANTS.get(args.variant),
                              hbm_bytes=hbm)
                records.append(rec)
                status = "OK " if rec.get("ok") else "FAIL"
                if rec.get("same_as"):
                    extra = f"same step as {rec['same_as']}"
                    n_ok += 1
                elif rec.get("ok"):
                    r = rec["roofline"]
                    extra = (f"compute {r['compute_s']*1e3:.2f}ms "
                             f"mem {r['memory_s']*1e3:.2f}ms "
                             f"coll {r['collective_s']*1e3:.2f}ms "
                             f"fits {rec['fits_hbm']} "
                             f"[{rec.get('trace_s', 0):.0f}s trace]")
                    n_ok += 1
                else:
                    extra = rec.get("error", "")[:160]
                    n_fail += 1
                print(f"[{status}] {arch:24s} {shape:12s} {mesh_kind:6s} "
                      f"{extra}", flush=True)
    print(f"dry-run complete: {n_ok} ok, {n_fail} failed")
    if n_fail:
        raise SystemExit(1)
    return records


if __name__ == "__main__":
    main()
