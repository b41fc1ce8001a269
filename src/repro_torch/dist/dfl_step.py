"""Train/prefill steps and the pod-level DFL round, over stacked node state.

The DFL round is the paper's Algorithm 1 at LM scale, over a stacked node
axis: every node takes one local SGD step on its own token stream under
the VT loss, then DecDiff gossip (Eq. 5-6) moves each node toward its
neighbourhood average with the distance-attenuated step.  The PyTorch
counterpart of the JAX package's `repro.dist.dfl_step`:

  * `build_dfl_round` — the local steps, then `decdiff_gossip` over every
    node at once (no exchange, a `gossip_dtype` cast, or a codec's
    encode -> decode round trip);
  * `build_dfl_round_shardmap` in its one-pod form: one process holds all
    N nodes, the all_gather over the pod ring is the identity and the
    receiver block is all N rows.  With an `Int8Codec` and
    `fuse_dequant=True` (the default) its gossip is `fused_int8_gossip`:
    the nodes' flat models are encoded to int8 and each receiver's Eq. 6
    average comes straight out of the int8 payload through
    `ops.dequant_neighbor_avg_rows` (the fp32 neighbour models never
    exist), then Eq. 5 runs on the flat [N, D] block.
    Otherwise it is `build_dfl_round`, which is what the reference's
    decode-then-average branch computes on one pod.  More than one pod (the
    `torch.distributed` ring) is ROADMAP A.10.

Local steps run node by node, each through one forward and one backward
(the `vt_kl_loss` kernels once each on the card), and the optimizer
updates each node's slice of the stacked params and momentum IN PLACE:
the round function overwrites the `params` and `opt_state` it is given and
returns the gossiped params as new tensors.  A round's two phases run
under `torch.profiler.record_function` ranges, "dfl_round.local_steps"
and "dfl_round.gossip", which a profiler trace reads (`chip_smoke.py
--profile`).  Every form's Eq. 5 step goes through `ops.decdiff_rows`
(the `decdiff_update` kernels on the card: one norm per node, no [N, D]
difference or square in device memory).  `build_serve_step` is one decode
step against the ring KV cache, under `torch.inference_mode()`.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.profiler import record_function

from repro_torch.comm.codecs import Int8Codec
from repro_torch.comm.transport import codec_roundtrip_stacked
from repro_torch.kernels import ops
from repro_torch.utils.pytree import (
    tree_flatten_stacked,
    tree_leaves,
    tree_map,
    tree_unflatten_like,
)

DEFAULT_S = 1.0  # the paper's Eq. 5 denominator offset


def _normalized(adj: torch.Tensor, mask: Optional[torch.Tensor]):
    adj = adj.to(torch.float32)
    if mask is not None:
        adj = adj * mask.to(torch.float32)
    row = torch.sum(adj, dim=1)
    return adj / torch.where(row > 0, row, 1.0)[:, None], row


def _decdiff_step_from_avg(local, avg, row, s):
    """Eq. 5 for a block of nodes, given the Eq. 6 average.

    `local` has leaves [R, ...] (the nodes being updated), `avg` the
    like-structured neighbourhood averages (fp32), `row` [R] the
    pre-normalization weight-row sums (0: the node heard from nobody and
    keeps its local model).  The single home of the gating and dtype rules:
    every form of the round goes through it, and through the
    `decdiff_update` kernels on the card."""
    leaves = ops.decdiff_rows(
        [x.contiguous() for x in tree_leaves(local)],
        [a.contiguous() for a in tree_leaves(avg)], row.contiguous(), s)
    return tree_unflatten_like(local, leaves)


def _decdiff_apply(local, full, wn, row, s):
    """Eq. 6 then Eq. 5 for a block of nodes: `full` has leaves [N, ...]
    (every candidate neighbour, already cast for the exchange), `wn` [R, N]
    row-normalized weights."""
    avg = tree_map(lambda x: torch.einsum("rj,j...->r...", wn,
                                          x.to(torch.float32)), full)
    return _decdiff_step_from_avg(local, avg, row, s)


def decdiff_gossip(stacked, adj, s=DEFAULT_S, *, mask=None,
                   gossip_dtype: Optional[torch.dtype] = None, codec=None):
    """DecDiff aggregation for all nodes at once.

    stacked: params with leaves [N, ...]; adj [N, N] non-negative gossip
    weights (rows normalized here, zero diagonal); mask: optional [N, N]
    {0, 1} delivery mask (mask[i, j] = 0: i did not receive j's model);
    gossip_dtype: the dtype the exchanged models are cast to (the norm and
    the update stay fp32); codec: a `repro_torch.comm` codec whose
    reference-free encode -> decode round trip every exchanged model goes
    through (takes precedence over `gossip_dtype`).  The local models stay
    exact.  Returns the updated stacked params as new tensors."""
    wn, row = _normalized(adj, mask)
    if codec is not None:
        full = codec_roundtrip_stacked(codec, stacked)
    elif gossip_dtype is not None:
        full = tree_map(lambda x: x.to(gossip_dtype), stacked)
    else:
        full = stacked
    return _decdiff_apply(stacked, full, wn, row, s)


def _make_node_step(lm, opt, loss_kind, beta):
    def node_step(params, opt_state, step, batch):
        leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
        with torch.enable_grad():
            total, _ = lm.loss(tree_unflatten_like(params, leaves), batch,
                               loss_kind=loss_kind, beta=beta)
            grads = torch.autograd.grad(total, leaves)
        params, opt_state = opt.update(
            tree_unflatten_like(params, list(grads)), opt_state, params)
        return params, opt_state, total.detach()

    return node_step


def build_train_step(lm, opt, *, loss_kind: str = "vt", beta: float = 0.98):
    """(params, opt_state, step, batch) -> (params, opt_state, loss) for a
    single model replica; params and opt_state are updated in place."""
    return _make_node_step(lm, opt, loss_kind, beta)


def build_prefill_step(lm):
    """(params, batch) -> logits: the forward pass, teacher-forced."""

    @torch.no_grad()
    def prefill_step(params, batch):
        logits, _ = lm.forward(params, batch)
        return logits

    return prefill_step


def build_serve_step(lm):
    """(params, cache, tokens [B, 1]) -> (logits [B, 1, V], cache): one
    decode step against the ring KV cache, under `torch.inference_mode()`.
    The cache is updated in place and returned."""

    def serve_step(params, cache, tokens):
        with torch.inference_mode():
            return lm.decode_step(params, cache, tokens)

    return serve_step


def _as_device(x, dev) -> Optional[torch.Tensor]:
    if x is None:
        return None
    return torch.as_tensor(x, dtype=torch.float32).to(dev)


def _local_steps(node_step, params, opt_state, step, batch) -> torch.Tensor:
    """One local step per node, each on its own slice of the stacked state
    (updated in place); returns the mean of the nodes' losses."""
    n = tree_leaves(params)[0].shape[0]
    losses = []
    for i in range(n):
        _, _, loss = node_step(tree_map(lambda t: t[i], params),
                               tree_map(lambda t: t[i], opt_state), step,
                               {k: v[i] for k, v in batch.items()})
        losses.append(loss)
    return torch.mean(torch.stack(losses))


def fused_int8_gossip(stacked, adj, s=DEFAULT_S, *, mask=None, codec):
    """DecDiff over the nodes' int8 payload with the dequantization fused
    into Eq. 6: flatten the models to [N, D] fp32 -> encode with the
    `Int8Codec` (one scale per node) -> `ops.dequant_neighbor_avg_rows(q,
    scale, wn)` -> Eq. 5 on the flat block -> unflatten (leaf dtypes
    restored).  The local models stay exact, as in `decdiff_gossip`."""
    wn, row = _normalized(adj, mask)
    w_local, unflatten = tree_flatten_stacked(stacked)  # [N, D] fp32
    payload, _ = codec.encode(w_local)  # q [N, D] int8, scale [N]
    avg = ops.dequant_neighbor_avg_rows(payload["q"], payload["scale"], wn)
    del payload
    out = _decdiff_step_from_avg({"w": w_local}, {"w": avg}, row, s)
    return unflatten(out["w"])


def _build_round(lm, opt, adj, loss_kind, beta, built_mask, gossip):
    """The round around `gossip(params, adj, mask) -> new params`."""
    adj = torch.as_tensor(adj, dtype=torch.float32)
    # adj moves to the device once: a blocking copy from host memory every
    # round would wait for the card
    on_device = {}
    node_step = _make_node_step(lm, opt, loss_kind, beta)

    def round_fn(params, opt_state, step, batch, mask=None):
        with record_function("dfl_round.local_steps"):
            loss = _local_steps(node_step, params, opt_state, step, batch)
        with record_function("dfl_round.gossip"):
            dev = tree_leaves(params)[0].device
            if dev not in on_device:
                on_device[dev] = adj.to(dev)
            m = mask if mask is not None else built_mask
            new_params = gossip(params, on_device[dev], _as_device(m, dev))
        return new_params, opt_state, loss

    return round_fn


def build_dfl_round(lm, opt, adj, *, loss_kind: str = "vt",
                    beta: float = 0.98, s=DEFAULT_S,
                    gossip_dtype: Optional[torch.dtype] = None, mask=None,
                    codec=None):
    """One DFL communication round over stacked per-node state.

    (params [N, ...], opt_state [N, ...], step, batch {"tokens", "labels"}
    [N, B, S], mask=None) -> (params, opt_state, mean loss).  A `mask`
    given here is baked in; the round function's `mask` overrides it for
    one round.  Use a deterministic codec (`Int8Codec(stochastic=False)`, or
    any codec without random numbers) so the round equals the reference's.
    """
    def gossip(params, adj_d, m):
        return decdiff_gossip(params, adj_d, s=s, mask=m,
                              gossip_dtype=gossip_dtype, codec=codec)

    return _build_round(lm, opt, adj, loss_kind, beta, mask, gossip)


def build_dfl_round_shardmap(lm, opt, adj, *, pods: int = 1,
                             loss_kind: str = "vt", beta: float = 0.98,
                             s=DEFAULT_S,
                             gossip_dtype: Optional[torch.dtype] = None,
                             mask=None, codec=None,
                             fuse_dequant: bool = True):
    """The reference's shard_map pod round in its one-pod form (see the
    module docstring); `pods` > 1 is ROADMAP A.10.  With an `Int8Codec`
    and `fuse_dequant=True` the gossip is `fused_int8_gossip`; the codec
    must be deterministic (`stochastic=False`, or no random numbers given)
    for the round to equal the reference's."""
    if pods != 1:
        raise NotImplementedError(
            f"a {pods}-pod round (the torch.distributed pod ring) is ROADMAP "
            f"A.10, not ported yet; the port runs the one-pod form")
    if not (fuse_dequant and isinstance(codec, Int8Codec)):
        return build_dfl_round(lm, opt, adj, loss_kind=loss_kind, beta=beta,
                               s=s, gossip_dtype=gossip_dtype, mask=mask,
                               codec=codec)

    def gossip(params, adj_d, m):
        return fused_int8_gossip(params, adj_d, s, mask=m, codec=codec)

    return _build_round(lm, opt, adj, loss_kind, beta, mask, gossip)
