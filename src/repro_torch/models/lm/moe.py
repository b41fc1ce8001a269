"""Mixture-of-Experts LMs: mixtral-8x7b (8 experts top-2, sliding window)
and arctic-480b (128 experts top-2 beside a dense residual FFN).

The PyTorch counterpart of the JAX package's `repro.models.lm.moe`, with
its dispatch: capacity-based sorted scatter (Switch-style, token-dropping):
  1. router softmax (fp32) -> top-k experts and combine weights per token,
  2. assignments sorted by expert id (a stable sort, as `jnp.argsort`);
     an assignment past its expert's capacity C (capacity_factor · k · T /
     E + 1, rounded up to a multiple of 8) is dropped, and each expert's
     kept ones fill a buffer of min(C, n) rows for n tokens (the k experts
     of a token differ, so no expert takes more than n),
  3. the expert GLU batched over experts: [E, C', D] x [E, D, F],
  4. outputs gathered back and combined with the router weights in fp32;
     an assignment past its expert's capacity is dropped (zero
     contribution): the dense residual (arctic) or the residual stream
     still carries the token.
The reference writes the buffer with `.at[slot].set(..., mode="drop")`,
where the dropped slot E·C is out of bounds; the port writes into E·C + 1
rows and drops the last, so no write leaves the buffer and nothing is
read back to the host.  `cfg.moe_dispatch` picks one capacity pool over
all B·S tokens ("global") or one per batch row ("batch_local", the
reference's sharded-mesh variant; capacity per row).

On a mesh (`dist.constraints.use_mesh`, params placed by the specs with
`expert_parallel=cfg.expert_parallel`) the same functions run
partitioned: the tokens are made whole over "model", the router product
runs as `linear` uses its spec (arctic's router, D over "model", is
row-parallel), and routing, dispatch and combine run on each rank's batch
shard.  The global pool spans the ranks that split the batch: its
capacity counts all B·S tokens, and an assignment's position adds the
counts of the shards before this rank's (one all-gather of [E] counts
over each dimension that splits the batch), so the drops are the
unpartitioned ones while each rank fills only its own tokens' slots.
The expert GLU runs on DTensors through `linear`: tensor-parallel inside
the experts (mixtral's F over "model": column- then row-parallel;
arctic's D: row- then column-parallel), or under `expert_parallel`
(`constrain_expert_sharded`, E over "model") each rank's E / m experts
on its slice of buffers that are whole over "model", the outputs
all-gathered over "model" for the combine.

The Switch load-balance auxiliary E · Σ_e f_e · P_e comes back beside
the layer output: f_e, the share of assignments routed to e, is counted
(no gradient), P_e the mean router probability (the gradient's only
path), both over the whole batch (on a mesh the counts all-gathered and
the probabilities' sums all-reduced over the ranks that split it);
`forward_moe` returns the mean over layers, which `LM.loss` weighs
by `cfg.router_aux_weight`.  `torch.topk` breaks ties in no promised
order where `lax.top_k` takes the lower index; random fp32 routers tie
with probability 0.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools

import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.dist.constraints import (
    constrain_batch,
    constrain_expert_sharded,
    constrain_logits,
    constrain_residual,
    gather_weights,
)
from repro_torch.models.lm.config import ArchConfig
from repro_torch.models.lm.dense import init_cache_dense, ring_view
from repro_torch.models.lm.layers import (
    _dense_init,
    _like,
    _mesh_of,
    _on_shards,
    _SumOverShards,
    _unsplit_singletons,
    _whole_over_model,
    apply_norm,
    attention,
    decode_attention,
    embed,
    init_attention,
    init_embedding,
    init_linear,
    init_mlp,
    init_norm,
    layer_params,
    linear,
    mlp,
    remat,
    unembed,
)


def init_moe_ffn(gen, cfg: ArchConfig, stack=(), device=None):
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    stack = tuple(stack)
    return {
        "router": _dense_init(gen, stack + (d, e), d, torch.float32, device),
        "wg": _dense_init(gen, stack + (e, d, f), d, cfg.pdtype, device),
        "wu": _dense_init(gen, stack + (e, d, f), d, cfg.pdtype, device),
        "wd": _dense_init(gen, stack + (e, f, d), f, cfg.pdtype, device),
    }


def _capacity(cfg: ArchConfig, n_tokens: int) -> int:
    c = int(cfg.capacity_factor * cfg.top_k * n_tokens / cfg.n_experts) + 1
    return max(8, -(-c // 8) * 8)  # round up to a multiple of 8


# the lists of the enclosing `record_choices` blocks, innermost last
_CHOICES: list = []


@contextlib.contextmanager
def record_choices():
    """Collect, for each MoE layer the enclosed code runs, what it routed
    on this rank's tokens [b, S]: a dict of "experts" (top_i [b, S, k]),
    "gap" (the probability by which each token's k-th choice beat the best
    expert it did not choose, [b, S]) and "kept" ([b, S, k], False where
    the assignment was dropped past its expert's capacity), detached.  The
    checks compare choices first: a near-tie that flips moves a token by a
    whole expert."""
    got: list = []
    _CHOICES.append(got)
    try:
        yield got
    finally:
        _CHOICES.pop()


def _route(p, h):
    """The router's fp32 logits [..., E] of the tokens h [..., D]: one
    `linear`, so that on a mesh a router the specs split over "model"
    (arctic's D) is used row-parallel and a replicated one whole (unit E:
    never split by columns)."""
    return linear(h.to(torch.float32), {"w": p["router"]},
                  unit=p["router"].shape[-1])


def _choose(cfg: ArchConfig, logits):
    """Router probabilities [..., E] (fp32) and the top-k weights,
    renormalized, and experts [..., k]."""
    probs = torch.softmax(logits, dim=-1)
    top_w, top_i = torch.topk(probs, cfg.top_k, dim=-1)
    return probs, top_w / torch.sum(top_w, dim=-1, keepdim=True), top_i


def _record(probs, top_i, order, keep):
    """One layer's entry of the innermost `record_choices` list."""
    k = top_i.shape[-1]
    best = torch.topk(probs, min(k + 1, probs.shape[-1]), dim=-1).values
    kept = torch.zeros_like(keep).scatter(1, order, keep)
    _CHOICES[-1].append({"experts": top_i.detach().clone(),
                         "gap": (best[..., k - 1] - best[..., -1]).detach(),
                         "kept": kept.reshape(top_i.shape)})


@dataclasses.dataclass(frozen=True)
class _Pool:
    """The ranks whose tokens form one load count: `tokens` in all, and
    the mesh dims that split them (`dims`: (group, size, this rank's
    index), outermost first, the order of DTensor's shards); none without
    a mesh."""
    tokens: int
    dims: tuple = ()

    def counts(self, local):
        """(the counts of the shards before this rank's, the whole
        pool's), from this rank's `local` [E] int64: an all-gather over
        each dim, innermost first."""
        import torch.distributed._functional_collectives as funcol

        # torch 2.13 renamed all_gather_tensor (which now warns)
        gather = getattr(funcol, "all_gather_single", None) \
            or funcol.all_gather_tensor
        before, total = torch.zeros_like(local), local
        for group, n, r in reversed(self.dims):
            every = funcol.wait_tensor(gather(total, 0, group)).view(n, -1)
            before = before + torch.sum(every[:r], dim=0)
            total = torch.sum(every, dim=0)
        return before, total

    def sum(self, x):
        """x summed over the pool's ranks (all-reduces; the gradient of
        the sum is every rank's own, as `layers._SumOverShards`)."""
        for group, _, _ in self.dims:
            x = _SumOverShards.apply(x, group)
        return x


def _pool_of(mesh, h) -> _Pool:
    """The pool of the tokens h [B, S, D]: the mesh dims that split B
    (h's `Shard(0)`), and all B · S tokens."""
    from torch.distributed.tensor import Shard

    b, s, _ = h.shape
    if mesh is None:
        return _Pool(b * s)
    return _Pool(b * s, tuple(
        (mesh.get_group(i), int(mesh.size(i)), int(mesh.get_local_rank(i)))
        for i, pl in enumerate(h.placements) if pl == Shard(0)))


def _dispatch(cfg: ArchConfig, pool: _Pool, h, logits):
    """Routing and the sorted capacity dispatch of this rank's tokens h
    [b, S, D] (logits [b, S, E]) into R rows of expert buffers: one row of
    all b · S tokens in the "global" pool, whose capacity and positions
    count the whole pool (`pool`: an assignment's position adds the
    counts of the shards before this one), or one row per sequence
    ("batch_local", capacity of S tokens).  A row of n tokens fills
    min(C, n) slots an expert (no expert takes more than n assignments
    from n tokens: the k experts of a token differ).  Returns (buffers
    [R, E, C', D], the sorted assignments' slots, tokens and combine
    weights [R, n·k], the aux loss)."""
    b, s, d = h.shape
    k, e = cfg.top_k, cfg.n_experts
    probs, top_w, top_i = _choose(cfg, logits)
    per_row = cfg.moe_dispatch == "batch_local"
    rows, n = (b, s) if per_row else (1, b * s)
    flat_e = top_i.reshape(rows, n * k)
    # static-shaped counts, which a fake-tensor trace (launch/dryrun.py)
    # can follow
    counts = torch.zeros((rows, e), dtype=torch.int64,
                         device=h.device).scatter_add_(
        1, flat_e, torch.ones_like(flat_e))
    before, total = pool.counts(torch.sum(counts, dim=0))
    # Switch load balance: E · Σ_e f_e · P_e over the whole pool
    f_e = total.to(torch.float32) / (pool.tokens * k)
    p_e = pool.sum(torch.sum(probs.reshape(-1, e), dim=0)) / pool.tokens
    aux = e * torch.sum(f_e * p_e)

    order = torch.argsort(flat_e, dim=1, stable=True)
    sorted_e = torch.gather(flat_e, 1, order)
    starts = torch.cumsum(counts, 1) - counts
    pos = (torch.arange(n * k, device=h.device)[None, :]
           - torch.gather(starts, 1, sorted_e))
    if per_row:
        cap = _capacity(cfg, s)
        keep = pos < cap
    else:  # the position in the whole pool
        cap = _capacity(cfg, pool.tokens)
        keep = pos + before[sorted_e] < cap
    c = min(cap, n)
    slot = torch.where(keep, sorted_e * c + pos, e * c)
    tok = order // k  # [R, n·k] the source token of each assignment
    if _CHOICES:
        _record(probs, top_i, order, keep)

    xr = h.to(cfg.adtype).reshape(rows, n, d)
    gathered = torch.gather(xr, 1, _rows(tok, d))  # [R, n·k, D]
    # row E·C' takes the dropped assignments and is cut off
    buf = torch.zeros((rows, e * c + 1, d), dtype=cfg.adtype,
                      device=h.device).scatter(1, _rows(slot, d), gathered)
    w_sorted = torch.gather(top_w.reshape(rows, n * k), 1, order) \
        * keep.to(torch.float32)
    return buf[:, :e * c].reshape(rows, e, c, d), slot, tok, w_sorted, aux


def _rows(idx, d: int):
    """[R, n] -> an index over D for gather / scatter."""
    return idx[..., None].expand(-1, -1, d)


def _experts(cfg: ArchConfig, p, buf):
    """The expert GLU on the buffers [R, E, C, D] -> [R, E·C, D]: each
    expert's slots of every row as one [E, R·C, D] block through
    `linear`, which uses the expert weights as their specs split them on
    a mesh (tensor-parallel inside the experts, or, under
    `expert_parallel`, E over "model": `constrain_expert_sharded` slices
    a rank's experts out of buffers whole over "model")."""
    r, e, c, d = buf.shape
    mesh = _mesh_of(buf)
    if mesh is not None:
        buf = _unsplit_singletons(mesh, buf)
    if cfg.expert_parallel:
        buf = constrain_expert_sharded(buf)
    h = buf.permute(1, 0, 2, 3).reshape(e, r * c, d)
    y = linear(F.silu(linear(h, {"w": p["wg"]})) * linear(h, {"w": p["wu"]}),
               {"w": p["wd"]})
    y = y.reshape(e, r, c, d).permute(1, 0, 2, 3)
    if cfg.expert_parallel:
        y = constrain_expert_sharded(y)
    return y.reshape(r, e * c, d)


def _combine(cfg: ArchConfig, s: int, y, slot, tok, w_sorted):
    """The outputs of the kept assignments, weighted, added onto their
    tokens: y [R, E·C', D] -> [b, S, D] fp32 (S = `s`)."""
    rows, d = y.shape[0], y.shape[-1]
    contrib = torch.gather(y, 1, _rows(torch.clamp(slot, max=y.shape[1] - 1),
                                       d))
    contrib = contrib.to(torch.float32) * w_sorted[..., None]
    # each token gets its k addends onto zero; at k = 2 the fp32 sum
    # 0 + a + b is the same in either order, so the scatter's order
    # (atomics on the card) does not show; at k > 2 it may
    out = torch.zeros((rows, tok.shape[1] // cfg.top_k, d),
                      dtype=torch.float32, device=y.device)
    return out.scatter_add(1, _rows(tok, d), contrib).reshape(-1, s, d)


def moe_ffn(cfg: ArchConfig, p, x):
    """x [B, S, D] -> (out [B, S, D] in x's dtype and layout, the aux
    loss, 0-d).

    "global" routes all B·S tokens through one capacity pool (the
    baseline); "batch_local" sorts and dispatches each batch row on its
    own, with the capacity of S tokens.  On a mesh the tokens are made
    whole over "model" (a "batch_seq" residual's all-gather), the router
    product runs as its spec splits it, routing, dispatch and combine run
    on each rank's batch shard (`local_map`; the global pool's counts are
    all-gathered over the ranks that split the batch, the aux's sums
    all-reduced), the expert GLU runs on DTensors (`_experts`), and its
    outputs come back whole over "model" for the combine."""
    mesh = _mesh_of(x)
    h = x if mesh is None else _whole_over_model(mesh, x)
    logits = _route(p, h)
    if mesh is not None:
        logits = _like(mesh, logits, h)
    buf, slot, tok, w_sorted, aux = _on_shards(
        mesh, functools.partial(_dispatch, cfg, _pool_of(mesh, h)), h,
        logits, outs=(True,) * 4 + (False,))
    y = _experts(cfg, p, buf)
    if mesh is not None:
        y = _like(mesh, y, h)
    out = _on_shards(mesh, functools.partial(_combine, cfg, h.shape[1]),
                     y, slot, tok, w_sorted)
    return _like(mesh, out.to(x.dtype), x), aux


def init_layer_moe(gen: torch.Generator, cfg: ArchConfig, stack=(),
                   device=None):
    """One MoE layer's params, leaves stacked over `stack`, on `device`
    (None: the card): the dense layer with `moe` in place of `mlp`, and
    arctic's `dense_mlp` beside it."""
    device = resolve_device(device)
    layer = {
        "ln1": init_norm(cfg, stack=stack, device=device),
        "attn": init_attention(gen, cfg, stack=stack, device=device),
        "ln2": init_norm(cfg, stack=stack, device=device),
        "moe": init_moe_ffn(gen, cfg, stack=stack, device=device),
    }
    if cfg.dense_residual:
        layer["dense_mlp"] = init_mlp(gen, cfg, stack=stack, device=device)
    return layer


def init_moe_lm(gen: torch.Generator, cfg: ArchConfig, device=None):
    """One node's params on `device` (None: the card): `init_layer_moe`
    stacked over the layers, then the embedding."""
    device = resolve_device(device)
    layers = init_layer_moe(gen, cfg, stack=(cfg.n_layers,), device=device)
    params = {
        "embed": init_embedding(gen, cfg, device=device),
        "layers": layers,
        "final_norm": init_norm(cfg, device=device),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = init_linear(gen, cfg.d_model, cfg.vocab, cfg,
                                        device=device)
    return params


def _ffn(cfg: ArchConfig, lp, h):
    y, aux = moe_ffn(cfg, lp["moe"], h)
    if cfg.dense_residual:
        y = y + mlp(cfg, lp["dense_mlp"], h)
    return y, aux


def layer_apply_moe(cfg: ArchConfig, lp, x, positions):
    x = x + attention(cfg, lp["attn"], apply_norm(cfg, x, lp["ln1"]),
                      positions)
    y, aux = _ffn(cfg, lp, apply_norm(cfg, x, lp["ln2"]))
    return x + y, aux


def forward_moe(cfg: ArchConfig, params, tokens, positions=None):
    """tokens [B, S] -> (logits [B, S, V], the mean of the layers' aux)."""
    x = constrain_batch(embed(cfg, params["embed"], tokens))
    if positions is None:
        positions = torch.arange(tokens.shape[1], dtype=torch.int32,
                                 device=tokens.device)
    auxs = []
    for lp in layer_params(params["layers"]):
        x = constrain_residual(x, cfg.residual_shard)
        if cfg.zero3_gather:
            lp = gather_weights(lp)
        x, aux = remat(cfg, layer_apply_moe, cfg, lp, x, positions)
        auxs.append(aux)
    x = apply_norm(cfg, x, params["final_norm"])
    logits = constrain_logits(unembed(cfg, params.get("unembed"),
                                      params["embed"], x))
    return logits, torch.mean(torch.stack(auxs))


init_cache_moe = init_cache_dense


def decode_step_moe(cfg: ArchConfig, params, cache, tokens):
    """tokens [B, 1] -> (logits [B, 1, V], cache), the ring KV cache
    updated in place as the dense family's (the B tokens of the step are
    one capacity pool)."""
    x = embed(cfg, params["embed"], tokens)
    length = cache["length"]
    for layer, lp in enumerate(layer_params(params["layers"])):
        a, _ = decode_attention(cfg, lp["attn"],
                                apply_norm(cfg, x, lp["ln1"]),
                                ring_view(cache, layer), length)
        x = x + a
        y, _ = _ffn(cfg, lp, apply_norm(cfg, x, lp["ln2"]))
        x = x + y
    x = apply_norm(cfg, x, params["final_norm"])
    logits = unembed(cfg, params.get("unembed"), params["embed"], x)
    cache["length"] = length + 1
    return logits, cache
