"""Whisper-style encoder-decoder (arXiv:2212.04356), transformer backbone.

The PyTorch counterpart of the JAX package's `repro.models.lm.encdec`.
As there, the mel-spectrogram and conv feature extractor are a stub: the
model takes precomputed frame embeddings [B, S_enc, D] (S_enc = seq_len /
enc_seq_divisor, standing in for the conv stride-2 downsampling), and
RoPE takes the place of Whisper's learned absolute positions, so decoding
runs at any context length; the enc-dec attention structure is Whisper's
(LayerNorm, GELU MLPs, MHA).  The decoder's cross-attention turns q by
RoPE at the decoder positions and reads the encoder's K / V (`cross_kv`,
no RoPE) at the encoder positions, through `attention(..., kv_override)`.

Decode state: a ring KV cache per decoder layer for self-attention (k, v
[L, B, W, K, hd], slot_pos, length) and the cross-attention K / V of every
decoder layer, cross_k / cross_v [L, B, enc_len, K, hd], which
`prefill_cross_cache` (the LM's `prep_decode_cache`) fills once from the
encoder.  A decode step's self-attention runs through
`ops.decode_attention_fused` (the `decode_attention` kernel on the card),
its cross-attention over the encoder cache through the plain `attention`
path, as the reference's does in `jnp`.  The self-attention ring is
updated in place.
"""
from __future__ import annotations

import torch

from repro_torch.device import resolve_device
from repro_torch.dist.constraints import (
    constrain_logits,
    constrain_residual,
    gather_weights,
)
from repro_torch.models.lm.config import ArchConfig
from repro_torch.models.lm.dense import ring_view
from repro_torch.models.lm.layers import (
    CacheSpec,
    apply_norm,
    attention,
    cross_kv,
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


def init_encdec(gen: torch.Generator, cfg: ArchConfig, device=None):
    """One node's params on `device` (None: the card)."""
    device = resolve_device(device)
    kw = dict(device=device)
    enc, dec = (cfg.n_enc_layers,), (cfg.n_layers,)
    return {
        "embed": init_embedding(gen, cfg, **kw),  # decoder tokens
        "enc_layers": {
            "ln1": init_norm(cfg, stack=enc, **kw),
            "attn": init_attention(gen, cfg, stack=enc, **kw),
            "ln2": init_norm(cfg, stack=enc, **kw),
            "mlp": init_mlp(gen, cfg, stack=enc, **kw),
        },
        "enc_final_norm": init_norm(cfg, **kw),
        "dec_layers": {
            "ln1": init_norm(cfg, stack=dec, **kw),
            "self_attn": init_attention(gen, cfg, stack=dec, **kw),
            "ln_x": init_norm(cfg, stack=dec, **kw),
            "cross_attn": init_attention(gen, cfg, stack=dec, **kw),
            "ln2": init_norm(cfg, stack=dec, **kw),
            "mlp": init_mlp(gen, cfg, stack=dec, **kw),
        },
        "final_norm": init_norm(cfg, **kw),
        "unembed": init_linear(gen, cfg.d_model, cfg.vocab, cfg, **kw),
    }


def _enc_layer(cfg: ArchConfig, lp, h, positions):
    h = h + attention(cfg, lp["attn"], apply_norm(cfg, h, lp["ln1"]),
                      positions, causal=False)
    return h + mlp(cfg, lp["mlp"], apply_norm(cfg, h, lp["ln2"]))


def encode(cfg: ArchConfig, params, enc_embeds):
    """The stub-frontend encoder: enc_embeds [B, S_enc, D] -> [B, S_enc, D]
    (non-causal self-attention)."""
    positions = torch.arange(enc_embeds.shape[1], dtype=torch.int32,
                             device=enc_embeds.device)
    x = enc_embeds.to(cfg.adtype)
    for lp in layer_params(params["enc_layers"]):
        x = constrain_residual(x, cfg.residual_shard)
        if cfg.zero3_gather:
            lp = gather_weights(lp)
        x = remat(cfg, _enc_layer, cfg, lp, x, positions)
    return apply_norm(cfg, x, params["enc_final_norm"])


def _dec_layer(cfg: ArchConfig, lp, h, positions, enc_out, enc_pos):
    h = h + attention(cfg, lp["self_attn"], apply_norm(cfg, h, lp["ln1"]),
                      positions, causal=True)
    k, v = cross_kv(cfg, lp["cross_attn"], enc_out)
    h = h + attention(cfg, lp["cross_attn"], apply_norm(cfg, h, lp["ln_x"]),
                      positions, causal=False, kv_override=(k, v, enc_pos))
    return h + mlp(cfg, lp["mlp"], apply_norm(cfg, h, lp["ln2"]))


def decode_train(cfg: ArchConfig, params, tokens, enc_out):
    """The teacher-forced decoder: tokens [B, S_dec] -> logits
    [B, S_dec, V]."""
    dev = tokens.device
    positions = torch.arange(tokens.shape[1], dtype=torch.int32, device=dev)
    enc_pos = torch.arange(enc_out.shape[1], dtype=torch.int32, device=dev)
    x = embed(cfg, params["embed"], tokens)
    for lp in layer_params(params["dec_layers"]):
        x = constrain_residual(x, cfg.residual_shard)
        if cfg.zero3_gather:
            lp = gather_weights(lp)
        x = remat(cfg, _dec_layer, cfg, lp, x, positions, enc_out, enc_pos)
    x = apply_norm(cfg, x, params["final_norm"])
    return constrain_logits(unembed(cfg, params.get("unembed"),
                                    params["embed"], x))


def forward_encdec(cfg: ArchConfig, params, batch):
    """batch: tokens [B, S_dec], enc_embeds [B, S_enc, D] -> logits."""
    enc_out = encode(cfg, params, batch["enc_embeds"])
    return decode_train(cfg, params, batch["tokens"], enc_out)


def init_cache_encdec(cfg: ArchConfig, batch: int, seq_len: int,
                      enc_len: int = None, device=None):
    """The self-attention ring (W = seq_len, cut to `cfg.decode_window`)
    and zero cross_k / cross_v [L, B, enc_len, K, hd] (enc_len = seq_len /
    enc_seq_divisor, at least 1, unless given), on `device` (None: the
    card)."""
    dev = resolve_device(device)
    window = seq_len if cfg.decode_window is None else min(cfg.decode_window,
                                                           seq_len)
    spec = CacheSpec(batch=batch, window=window, n_kv_heads=cfg.n_kv_heads,
                     head_dim=cfg.head_dim, dtype=cfg.activation_dtype)
    cache = init_kv_cache(spec, cfg.n_layers, device=dev)
    enc_len = enc_len or max(seq_len // cfg.enc_seq_divisor, 1)
    shape = (cfg.n_layers, batch, enc_len, cfg.n_kv_heads, cfg.head_dim)
    cache["cross_k"] = torch.zeros(shape, dtype=cfg.adtype, device=dev)
    cache["cross_v"] = torch.zeros(shape, dtype=cfg.adtype, device=dev)
    return cache


def prefill_cross_cache(cfg: ArchConfig, params, cache, enc_embeds):
    """Run the encoder once on enc_embeds [B, S_enc, D] and return the
    cache with every decoder layer's cross K / V [L, B, S_enc, K, hd] (new
    tensors in the cache's dtype; the ring is the same)."""
    enc_out = encode(cfg, params, enc_embeds)
    ks, vs = zip(*(cross_kv(cfg, lp["cross_attn"], enc_out)
                   for lp in layer_params(params["dec_layers"])))
    return dict(cache, cross_k=torch.stack(ks).to(cache["cross_k"].dtype),
                cross_v=torch.stack(vs).to(cache["cross_v"].dtype))


def decode_step_encdec(cfg: ArchConfig, params, cache, tokens):
    """One decoder token against the self-attention ring and the cross
    caches: tokens [B, 1] -> (logits [B, 1, V], cache)."""
    x = embed(cfg, params["embed"], tokens)
    length = cache["length"]
    enc_pos = torch.arange(cache["cross_k"].shape[2], dtype=torch.int32,
                           device=x.device)
    for layer, lp in enumerate(layer_params(params["dec_layers"])):
        a, _ = decode_attention(cfg, lp["self_attn"],
                                apply_norm(cfg, x, lp["ln1"]),
                                ring_view(cache, layer), length)
        x = x + a
        kv = (cache["cross_k"][layer], cache["cross_v"][layer], enc_pos)
        x = x + attention(cfg, lp["cross_attn"],
                          apply_norm(cfg, x, lp["ln_x"]), length.reshape(1),
                          causal=False, kv_override=kv)
        x = x + mlp(cfg, lp["mlp"], apply_norm(cfg, x, lp["ln2"]))
    x = apply_norm(cfg, x, params["final_norm"])
    logits = unembed(cfg, params.get("unembed"), params["embed"], x)
    cache["length"] = length + 1
    return logits, cache
