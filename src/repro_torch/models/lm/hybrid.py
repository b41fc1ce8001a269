"""Zamba2-style hybrid: a Mamba2 backbone with one SHARED attention block
invoked periodically (arXiv:2411.15242).

The PyTorch counterpart of the JAX package's `repro.models.lm.hybrid`.
n_layers mamba2 layers fall into G = n_layers / shared_attn_every groups
of E; after each group the one shared transformer block (attention + MLP,
one set of weights for every invocation) runs on the concatenation of the
hidden state and the original embedding, projected 2D -> D.  As in the
reference, the per-invocation LoRA deltas of the shared block are left
out.  `params["mamba"]` is stacked [G, E, ...].

Decoding carries every mamba layer's conv window and state and one ring
KV cache per invocation group, [G, B, W, K, hd] (`attn_k`, `attn_v`,
`attn_slot_pos`), so each invocation attends over its own past; the
shared block's one-token attention runs through `ops.decode_attention_fused`
(the `decode_attention` kernel on the card).  The cache is updated in
place.

On a mesh the mamba layers partition as `ssm.py` says, each [G, E, ...]
leaf unbound per group and then per layer; the shared block runs on the
dense family's machinery (`layers.py`): its `in_proj` [2D, D]
row-parallel where the specs split 2D, attention heads and the MLP over
"model", and in decoding each group's ring, split over hd by the cache
specs, through the split-hd kernels (`ops.decode_scores_partial`, an
all-reduce, `ops.decode_softmax_combine`).
"""
from __future__ import annotations

import torch

from repro_torch.device import resolve_device
from repro_torch.dist.constraints import constrain_batch, constrain_logits
from repro_torch.models.lm.config import ArchConfig
from repro_torch.models.lm.dense import ring_view
from repro_torch.models.lm.layers import (
    CacheSpec,
    _like,
    _mesh_of,
    apply_norm,
    attention,
    decode_attention,
    embed,
    init_attention,
    init_embedding,
    init_kv_cache,
    init_linear,
    init_mlp,
    init_norm,
    layer_params,
    linear,
    mlp,
    unembed,
)
from repro_torch.models.lm.ssm import (
    decode_ssm_layers,
    init_cache_ssm,
    init_ssm_layer,
    run_ssm_layers,
)


def _n_groups(cfg: ArchConfig) -> int:
    if cfg.shared_attn_every <= 0 or cfg.n_layers % cfg.shared_attn_every:
        raise ValueError(f"the hybrid family wants n_layers "
                         f"({cfg.n_layers}) a multiple of shared_attn_every "
                         f"({cfg.shared_attn_every} > 0)")
    return cfg.n_layers // cfg.shared_attn_every


def init_hybrid_lm(gen: torch.Generator, cfg: ArchConfig, device=None):
    """One node's params on `device` (None: the card)."""
    device = resolve_device(device)
    g, e = _n_groups(cfg), cfg.shared_attn_every
    kw = dict(device=device)
    return {
        "embed": init_embedding(gen, cfg, **kw),
        "mamba": init_ssm_layer(gen, cfg, stack=(g, e), **kw),
        "shared": {
            "in_proj": init_linear(gen, 2 * cfg.d_model, cfg.d_model, cfg,
                                   **kw),
            "ln1": init_norm(cfg, **kw),
            "attn": init_attention(gen, cfg, **kw),
            "ln2": init_norm(cfg, **kw),
            "mlp": init_mlp(gen, cfg, **kw),
        },
        "final_norm": init_norm(cfg, **kw),
        "unembed": init_linear(gen, cfg.d_model, cfg.vocab, cfg, **kw),
    }


def _shared_in(sp, x, x0):
    """[x | x0] @ in_proj [2D, D] (on a mesh x0 in x's layout first, and
    in_proj used as its spec splits it: row-parallel over 2D)."""
    h = torch.cat([x, _like(_mesh_of(x), x0, x)], dim=-1)
    return linear(h, sp["in_proj"])


def _shared_block(cfg: ArchConfig, sp, x, x0, positions):
    h = _shared_in(sp, x, x0)
    h = h + attention(cfg, sp["attn"], apply_norm(cfg, h, sp["ln1"]),
                      positions)
    h = h + mlp(cfg, sp["mlp"], apply_norm(cfg, h, sp["ln2"]))
    return x + h


def forward_hybrid(cfg: ArchConfig, params, tokens, positions=None):
    """tokens [B, S] -> logits [B, S, V]."""
    x = constrain_batch(embed(cfg, params["embed"], tokens))
    x0 = x
    if positions is None:
        positions = torch.arange(tokens.shape[1], dtype=torch.int32,
                                 device=tokens.device)
    for group in layer_params(params["mamba"]):
        x = run_ssm_layers(cfg, group, x)
        x = constrain_batch(_shared_block(cfg, params["shared"], x, x0,
                                          positions))
    x = apply_norm(cfg, x, params["final_norm"])
    return constrain_logits(unembed(cfg, params.get("unembed"),
                                    params["embed"], x))


def init_cache_hybrid(cfg: ArchConfig, batch: int, seq_len: int,
                      device=None):
    """The mamba layers' conv windows and states, one ring KV cache per
    invocation group (W = seq_len, cut to `cfg.decode_window`) and
    `length`, on `device` (None: the card)."""
    ssm_cache = init_cache_ssm(cfg, batch, seq_len, device=device)
    window = seq_len if cfg.decode_window is None else min(cfg.decode_window,
                                                           seq_len)
    spec = CacheSpec(batch=batch, window=window, n_kv_heads=cfg.n_kv_heads,
                     head_dim=cfg.head_dim, dtype=cfg.activation_dtype)
    attn = init_kv_cache(spec, _n_groups(cfg), device=device)
    return {"conv": ssm_cache["conv"], "state": ssm_cache["state"],
            "attn_k": attn["k"], "attn_v": attn["v"],
            "attn_slot_pos": attn["slot_pos"], "length": attn["length"]}


def decode_step_hybrid(cfg: ArchConfig, params, cache, tokens):
    """tokens [B, 1] -> (logits [B, 1, V], cache), updated in place."""
    x = embed(cfg, params["embed"], tokens)[:, 0]  # [B, D]
    x0 = x
    e = cfg.shared_attn_every
    length = cache["length"]
    sp = params["shared"]
    for gi, group in enumerate(layer_params(params["mamba"])):
        x = decode_ssm_layers(cfg, group, x, cache["conv"], cache["state"],
                              first=gi * e)
        # the shared block on the single token, against group gi's ring
        h = _shared_in(sp, x, x0)[:, None, :]
        a, _ = decode_attention(cfg, sp["attn"], apply_norm(cfg, h, sp["ln1"]),
                                ring_view(cache, gi, "attn_"), length)
        h = h + a
        h = h + mlp(cfg, sp["mlp"], apply_norm(cfg, h, sp["ln2"]))
        x = x + h[:, 0]
    x = apply_norm(cfg, x, params["final_norm"])
    logits = unembed(cfg, params.get("unembed"), params["embed"],
                     x[:, None, :])
    cache["length"] = length + 1
    return logits, cache
