"""Dense decoder-only LM (llama/qwen family) over stacked layer params.

Covers deepseek-7b (llama arch), qwen1.5-0.5b / qwen2.5-14b (QKV bias) and
qwen3-32b (qk-norm, GQA, head_dim 128), and serves as the text trunk of
llava (`vlm.py`), as the JAX package's `repro.models.lm.dense` does.
Params are a nested dict with the reference's keys; the per-layer leaves
are stacked [L, ...] and `trunk` loops over them, so the flat [N, D] order
of a stack of nodes is `jax.tree.flatten`'s (embed/table,
final_norm/scale, layers/attn/wk/b, ...).  With `cfg.remat` every layer
runs under `torch.utils.checkpoint` (`layers.remat`).
Serving: `init_cache_dense` builds the ring KV cache (the reference's
window rule) and `decode_step_dense` runs one token through every layer
against it.  The reference's scan returns a new cache; the port writes
each layer's k, v and slot position into the cache it is given and
returns the same dict, with a new `length` tensor.
"""
from __future__ import annotations

import torch

from repro_torch.device import resolve_device
from repro_torch.dist.constraints import (
    constrain_batch,
    constrain_logits,
    constrain_residual,
    gather_weights,
)
from repro_torch.models.lm.config import ArchConfig
from repro_torch.models.lm.layers import (
    CacheSpec,
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
    mlp,
    remat,
    unembed,
)


def init_layer(gen: torch.Generator, cfg: ArchConfig, stack=(),
               device=None):
    """One dense layer's params, leaves stacked over `stack` (`init_dense`
    passes (n_layers,)), drawn from `gen` on `device` (None: the card)."""
    device = resolve_device(device)
    return {
        "ln1": init_norm(cfg, stack=stack, device=device),
        "attn": init_attention(gen, cfg, stack=stack, device=device),
        "ln2": init_norm(cfg, stack=stack, device=device),
        "mlp": init_mlp(gen, cfg, stack=stack, device=device),
    }


def init_dense(gen: torch.Generator, cfg: ArchConfig, device=None):
    """One node's params, drawn from `gen` (a generator of the same device)
    on `device`: None means the card and raises on a host without CUDA."""
    device = resolve_device(device)
    params = {
        "embed": init_embedding(gen, cfg, device=device),
        "layers": init_layer(gen, cfg, stack=(cfg.n_layers,), device=device),
        "final_norm": init_norm(cfg, device=device),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = init_linear(gen, cfg.d_model, cfg.vocab, cfg,
                                        device=device)
    return params


def layer_apply(cfg: ArchConfig, lp, x, positions):
    x = x + attention(cfg, lp["attn"], apply_norm(cfg, x, lp["ln1"]),
                      positions)
    x = x + mlp(cfg, lp["mlp"], apply_norm(cfg, x, lp["ln2"]))
    return x


def trunk(cfg: ArchConfig, params, x, positions):
    """Run the stacked layers on embedded input x [B, S, D]."""
    for lp in layer_params(params["layers"]):
        x = constrain_residual(x, cfg.residual_shard)
        if cfg.zero3_gather:
            lp = gather_weights(lp)
        x = remat(cfg, layer_apply, cfg, lp, x, positions)
    return apply_norm(cfg, x, params["final_norm"])


def forward_dense(cfg: ArchConfig, params, tokens, positions=None):
    """tokens [B, S] -> logits [B, S, V] in the activation dtype."""
    x = constrain_batch(embed(cfg, params["embed"], tokens))
    if positions is None:
        positions = torch.arange(tokens.shape[1], dtype=torch.int32,
                                 device=tokens.device)
    x = trunk(cfg, params, x, positions)
    return constrain_logits(unembed(cfg, params.get("unembed"),
                                    params["embed"], x))


def init_cache_dense(cfg: ArchConfig, batch: int, seq_len: int, device=None):
    """The ring KV cache for `batch` sequences of up to `seq_len` tokens:
    W = seq_len, cut to `cfg.decode_window` and to the sliding window
    where the config has them, in the activation dtype, on `device` (None:
    the card)."""
    window = seq_len if cfg.decode_window is None else min(cfg.decode_window,
                                                           seq_len)
    if cfg.sliding_window is not None:
        window = min(window, cfg.sliding_window)
    spec = CacheSpec(batch=batch, window=window, n_kv_heads=cfg.n_kv_heads,
                     head_dim=cfg.head_dim, dtype=cfg.activation_dtype)
    return init_kv_cache(spec, cfg.n_layers, device=device)


def ring_view(cache, layer: int, prefix: str = ""):
    """Layer `layer`'s ring of a stacked cache: {"k", "v", "slot_pos"}
    views (of `prefix`k, `prefix`v and `prefix`slot_pos), which
    `layers.decode_attention` writes into."""
    return {"k": cache[prefix + "k"][layer], "v": cache[prefix + "v"][layer],
            "slot_pos": cache[prefix + "slot_pos"][layer]}


def decode_step_dense(cfg: ArchConfig, params, cache, tokens):
    """tokens [B, 1] -> (logits [B, 1, V], cache).  Updates the cache's k,
    v and slot_pos IN PLACE and sets `cache["length"]` to a new 0-d tensor
    length + 1; the returned cache is the dict it was given."""
    x = embed(cfg, params["embed"], tokens)
    length = cache["length"]
    for layer, lp in enumerate(layer_params(params["layers"])):
        a, _ = decode_attention(cfg, lp["attn"],
                                apply_norm(cfg, x, lp["ln1"]),
                                ring_view(cache, layer), length)
        x = x + a
        x = x + mlp(cfg, lp["mlp"], apply_norm(cfg, x, lp["ln2"]))
    x = apply_norm(cfg, x, params["final_norm"])
    logits = unembed(cfg, params.get("unembed"), params["embed"], x)
    cache["length"] = length + 1
    return logits, cache
