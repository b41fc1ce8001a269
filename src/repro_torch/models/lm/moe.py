"""Mixture-of-Experts LMs: mixtral-8x7b (8 experts top-2, sliding window)
and arctic-480b (128 experts top-2 beside a dense residual FFN).

The PyTorch counterpart of the JAX package's `repro.models.lm.moe`, with
its dispatch: capacity-based sorted scatter (Switch-style, token-dropping):
  1. router softmax (fp32) -> top-k experts and combine weights per token,
  2. assignments sorted by expert id (a stable sort, as `jnp.argsort`);
     each expert processes a [C, D] buffer (C = capacity_factor · k · T /
     E + 1, rounded up to a multiple of 8),
  3. the expert GLU batched over experts: [E, C, D] x [E, D, F],
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

The Switch load-balance auxiliary E · Σ_e f_e · P_e comes back beside
the layer output: f_e, the share of assignments routed to e, is counted
(no gradient), P_e the mean router probability (the gradient's only
path); `forward_moe` returns the mean over layers, which `LM.loss` weighs
by `cfg.router_aux_weight`.  `torch.topk` breaks ties in no promised
order where `lax.top_k` takes the lower index; random fp32 routers tie
with probability 0.
"""
from __future__ import annotations

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


def _route(cfg: ArchConfig, p, x):
    """Router probabilities [..., E] (fp32) and the top-k weights,
    renormalized, and experts [..., k]."""
    probs = torch.softmax(torch.matmul(x.to(torch.float32), p["router"]),
                          dim=-1)
    top_w, top_i = torch.topk(probs, cfg.top_k, dim=-1)
    return probs, top_w / torch.sum(top_w, dim=-1, keepdim=True), top_i


def _glu(p, h):
    """The expert GLU on dispatch buffers h [..., E, C, D] in h's dtype."""
    gate = F.silu(torch.einsum("...ecd,edf->...ecf", h, p["wg"].to(h.dtype)))
    up = torch.einsum("...ecd,edf->...ecf", h, p["wu"].to(h.dtype))
    return torch.einsum("...ecf,efd->...ecd", gate * up, p["wd"].to(h.dtype))


def moe_ffn(cfg: ArchConfig, p, x):
    """x [B, S, D] -> (out [B, S, D] in x's dtype, the aux loss, 0-d).

    "global" routes all B·S tokens through one capacity pool (the
    baseline); "batch_local" sorts and dispatches each batch row on its
    own, with the capacity of S tokens."""
    b, s, d = x.shape
    if cfg.moe_dispatch == "batch_local":
        return _moe_batch_local(cfg, p, x)
    out, aux = _moe_tokens(cfg, p, x.reshape(b * s, d))
    return out.reshape(b, s, d).to(x.dtype), aux


def _moe_tokens(cfg: ArchConfig, p, xf):
    """Sorted capacity dispatch and the expert GLU over a flat token block
    xf [T, D] -> (out [T, D] fp32, aux)."""
    t, d = xf.shape
    k, e = cfg.top_k, cfg.n_experts
    probs, top_w, top_i = _route(cfg, p, xf)  # [T, E], [T, k], [T, k]

    flat_e = top_i.reshape(-1)  # [kT] the expert of each assignment
    # bincount's integers from a static-shaped count, which a fake-tensor
    # trace (launch/dryrun.py) can follow
    counts = torch.zeros(e, dtype=torch.int64, device=xf.device).index_add_(
        0, flat_e, torch.ones_like(flat_e))
    f_e = counts.to(torch.float32) / (t * k)
    aux = e * torch.sum(f_e * torch.mean(probs, dim=0))

    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    starts = torch.cumsum(counts, 0) - counts
    pos_in_e = torch.arange(t * k, device=xf.device) - starts[sorted_e]
    cap = _capacity(cfg, t)
    keep = pos_in_e < cap
    slot = torch.where(keep, sorted_e * cap + pos_in_e, e * cap)
    tok = order // k  # the token of each sorted assignment

    # row E·C takes the dropped assignments and is cut off
    buf = torch.zeros((e * cap + 1, d), dtype=cfg.adtype, device=xf.device)
    buf = buf.index_copy(0, slot, xf[tok].to(cfg.adtype))
    y = _glu(p, buf[:e * cap].reshape(e, cap, d)).reshape(e * cap, d)

    w_sorted = top_w.reshape(-1)[order] * keep.to(torch.float32)
    contrib = y[torch.clamp(slot, max=e * cap - 1)].to(torch.float32) \
        * w_sorted[:, None]
    # each token gets its k addends onto zero; at k = 2 the fp32 sum
    # 0 + a + b is the same in either order, so the scatter's order
    # (atomics on the card) does not show; at k > 2 it may
    out = torch.zeros((t, d), dtype=torch.float32, device=xf.device)
    return out.index_add(0, tok, contrib), aux


def _moe_batch_local(cfg: ArchConfig, p, x):
    """Per-row sorted dispatch with the batch dim kept explicit: every
    tensor carries B as dim 0, and a row's tokens only fill that row's
    expert buffers (capacity of S tokens)."""
    b, s, d = x.shape
    k, e = cfg.top_k, cfg.n_experts
    xf = constrain_batch(x)
    probs, top_w, top_i = _route(cfg, p, xf)  # [B, S, E], [B, S, k] x 2

    onehot = F.one_hot(top_i, e).to(torch.float32)  # [B, S, k, E]
    f_e = torch.mean(onehot, dim=(0, 1, 2))
    aux = e * torch.sum(f_e * torch.mean(probs, dim=(0, 1)))

    flat_e = top_i.reshape(b, s * k)
    order = torch.argsort(flat_e, dim=1, stable=True)
    sorted_e = torch.gather(flat_e, 1, order)
    counts = torch.sum(onehot, dim=(1, 2)).to(torch.int64)  # [B, E]
    starts = torch.cumsum(counts, 1) - counts
    pos_in_e = (torch.arange(s * k, device=x.device)[None, :]
                - torch.gather(starts, 1, sorted_e))
    cap = _capacity(cfg, s)
    keep = pos_in_e < cap
    slot = torch.where(keep, sorted_e * cap + pos_in_e, e * cap)
    tok = order // k  # [B, kS] the source token of each assignment

    def rows(idx):  # [B, n] -> an index over D for gather / scatter
        return idx[..., None].expand(-1, -1, d)

    gathered = torch.gather(xf.to(cfg.adtype), 1, rows(tok))  # [B, kS, D]
    buf = torch.zeros((b, e * cap + 1, d), dtype=cfg.adtype, device=x.device)
    buf = constrain_batch(buf.scatter(1, rows(slot), gathered))
    h = buf[:, :e * cap].reshape(b, e, cap, d)
    if cfg.expert_parallel:
        h = constrain_expert_sharded(h)
    y = _glu(p, h)
    if cfg.expert_parallel:
        y = constrain_expert_sharded(y)
    y = constrain_batch(y.reshape(b, e * cap, d))

    w_sorted = torch.gather(top_w.reshape(b, s * k), 1, order) \
        * keep.to(torch.float32)
    contrib = torch.gather(y, 1, rows(torch.clamp(slot, max=e * cap - 1)))
    contrib = contrib.to(torch.float32) * w_sorted[..., None]
    out = torch.zeros((b, s, d), dtype=torch.float32, device=x.device)
    out = out.scatter_add(1, rows(tok), contrib)  # k addends onto zero
    return constrain_batch(out).to(x.dtype), aux


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
