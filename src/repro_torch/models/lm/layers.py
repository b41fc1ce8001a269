"""Shared transformer building blocks over plain dict params.

The PyTorch counterpart of the JAX package's `repro.models.lm.layers`, with
the same parameter names, layouts (`Linear` weights [in, out], applied as
`x @ w`) and arithmetic: norms and RoPE in fp32, attention scores and
softmax in fp32 with GQA grouping `h // kv_heads`, bias added in the
output's dtype.  `init_*` draws ONE layer's params, or a stack of them
when given a leading `stack` shape, from an explicit `torch.Generator` with
the reference's distributions (normal · 1/√fan_in for linear weights,
normal · 0.02 for the embedding, zero biases, unit norm scales).  The two
frameworks draw different numbers from a seed: tests carry the reference's
params across with `repro_torch.convert`.

Attention supports MHA/GQA, RoPE, qk-norm (qwen3), QKV bias (qwen1.5/2.5),
causal / non-causal / sliding-window masks and cross-attention (K / V
from `cross_kv` through `kv_override`), over a materialized [Sq, Sk] score
block up to `cfg.full_attn_max_seq` and flash-style chunks with an online
softmax above it (the reduced presets set that limit to 64 tokens).

Serving: `CacheSpec` / `init_kv_cache` build the ring KV cache (k, v
[L, B, W, K, hd], slot_pos [L, W] = −1, a 0-d int32 `length`), and
`decode_attention` runs one token against one layer's ring through
`ops.decode_attention_fused` (the `decode_attention` CUDA kernel on the
card).  Unlike the reference, which returns a new cache, it writes the new
token's k, v and slot position INTO the cache it is given.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.models.lm.config import ArchConfig, torch_dtype
from repro_torch.utils.pytree import tree_leaves, tree_unflatten_like

# ---------------------------------------------------------------- stacks


def layer_params(stacked):
    """The per-layer param trees of a stacked [L, ...] tree.  One unbind
    per leaf: its backward stacks the L layer gradients once, where L
    separate `leaf[l]` selects would each scatter into a full [L, ...] zero
    tensor."""
    per_leaf = [t.unbind(0) for t in tree_leaves(stacked)]
    return [tree_unflatten_like(stacked, list(ls)) for ls in zip(*per_leaf)]


def remat(cfg: ArchConfig, fn, *args):
    """fn(*args), under `torch.utils.checkpoint` when `cfg.remat` is set
    and autograd records: its activations are recomputed in the backward
    pass (the reference's `jax.checkpoint` of a layer), which changes no
    number."""
    if cfg.remat and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


# ---------------------------------------------------------------- norms


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6):
    x32 = x.to(torch.float32)
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * scale.to(torch.float32)).to(x.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5):
    x32 = x.to(torch.float32)
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, unbiased=False)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * scale.to(torch.float32) + bias.to(torch.float32)).to(x.dtype)


def apply_norm(cfg: ArchConfig, x, p):
    if cfg.norm == "rmsnorm":
        return rms_norm(x, p["scale"])
    return layer_norm(x, p["scale"], p["bias"])


def init_norm(cfg: ArchConfig, d: Optional[int] = None, stack=(),
              device=None):
    d = d or cfg.d_model
    p = {"scale": torch.ones(tuple(stack) + (d,), dtype=cfg.pdtype,
                             device=device)}
    if cfg.norm == "layernorm":
        p["bias"] = torch.zeros(tuple(stack) + (d,), dtype=cfg.pdtype,
                                device=device)
    return p


# ---------------------------------------------------------------- rotary


def rope_frequencies(head_dim: int, theta: float, device=None):
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """x: [..., S, H, hd]; positions: broadcastable to [..., S].  Half-split
    rotation in fp32, cast back to x's dtype."""
    hd = x.shape[-1]
    freqs = rope_frequencies(hd, theta, device=x.device)  # [hd/2]
    angles = positions.to(torch.float32)[..., None] * freqs  # [..., S, hd/2]
    cos = torch.cos(angles)[..., None, :]  # [..., S, 1, hd/2]
    sin = torch.sin(angles)[..., None, :]
    x32 = x.to(torch.float32)
    x1, x2 = x32[..., : hd // 2], x32[..., hd // 2:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------- linear


def _dense_init(gen: torch.Generator, shape, fan_in: int, dtype, device):
    std = 1.0 / math.sqrt(fan_in)
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (w * std).to(dtype)


def init_linear(gen, d_in: int, d_out: int, cfg: ArchConfig,
                bias: bool = False, stack=(), device=None):
    stack = tuple(stack)
    p = {"w": _dense_init(gen, stack + (d_in, d_out), d_in, cfg.pdtype,
                          device)}
    if bias:
        p["b"] = torch.zeros(stack + (d_out,), dtype=cfg.pdtype,
                             device=device)
    return p


def linear(x: torch.Tensor, p):
    y = torch.matmul(x, p["w"].to(x.dtype))
    if "b" in p:
        y = y + p["b"].to(y.dtype)
    return y


# ---------------------------------------------------------------- attention


def init_attention(gen, cfg: ArchConfig, stack=(), device=None):
    d = cfg.d_model
    kw = dict(stack=stack, device=device)
    p = {
        "wq": init_linear(gen, d, cfg.q_dim, cfg, bias=cfg.qkv_bias, **kw),
        "wk": init_linear(gen, d, cfg.kv_dim, cfg, bias=cfg.qkv_bias, **kw),
        "wv": init_linear(gen, d, cfg.kv_dim, cfg, bias=cfg.qkv_bias, **kw),
        "wo": init_linear(gen, cfg.q_dim, d, cfg, bias=False, **kw),
    }
    if cfg.qk_norm:
        ones = lambda: torch.ones(tuple(stack) + (cfg.head_dim,),
                                  dtype=cfg.pdtype, device=device)
        p["q_norm"] = {"scale": ones()}
        p["k_norm"] = {"scale": ones()}
    return p


def _project_q(cfg: ArchConfig, p, x, positions, rope: bool = True):
    b, s, _ = x.shape
    q = linear(x, p["wq"]).reshape(b, s, cfg.n_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"]["scale"])
    if rope:
        q = apply_rope(q, positions, cfg.rope_theta)
    return q


def _project_qkv(cfg: ArchConfig, p, x, positions, rope: bool = True):
    b, s, _ = x.shape
    q = _project_q(cfg, p, x, positions, rope)
    k = linear(x, p["wk"]).reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    v = linear(x, p["wv"]).reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    if cfg.qk_norm:
        k = rms_norm(k, p["k_norm"]["scale"])
    if rope:
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _mask_bias(q_pos, k_pos, causal: bool, window: Optional[int]):
    """Additive fp32 mask bias [..., Sq, Sk] from absolute positions."""
    qp = q_pos[..., :, None]
    kp = k_pos[..., None, :]
    ok = torch.ones(q_pos.shape[:-1] + (q_pos.shape[-1], k_pos.shape[-1]),
                    dtype=torch.bool, device=q_pos.device)
    if causal:
        ok = ok & (kp <= qp)
    if window is not None:
        ok = ok & (kp > qp - window)
    return torch.where(ok, 0.0, -1e30).to(torch.float32)


def _gqa_scores(q, k, scale: float):
    """q: [B,Sq,H,hd], k: [B,Sk,K,hd] -> fp32 scores [B,K,G,Sq,Sk]."""
    b, sq, h, hd = q.shape
    kk = k.shape[2]
    g = h // kk
    qg = q.reshape(b, sq, kk, g, hd)
    return torch.einsum("bqkgd,bskd->bkgqs", qg.to(torch.float32),
                        k.to(torch.float32)) * scale


def _gqa_combine(probs, v):
    """probs: [B,K,G,Sq,Sk], v: [B,Sk,K,hd] -> [B,Sq,H,hd]."""
    b, kk, g, sq, sk = probs.shape
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v.to(probs.dtype))
    return out.reshape(b, sq, kk * g, v.shape[-1])


def _plain_attention(cfg, q, k, v, q_pos, k_pos, causal, window):
    scale = 1.0 / math.sqrt(cfg.head_dim)
    scores = _gqa_scores(q, k, scale)  # [B,K,G,Sq,Sk] fp32
    bias = _mask_bias(q_pos, k_pos, causal, window)  # [Sq,Sk], broadcasts
    probs = torch.softmax(scores + bias, dim=-1)
    if cfg.attn_probs_bf16:
        probs = probs.to(torch.bfloat16)
    return _gqa_combine(probs, v).to(q.dtype)


def _chunked_attention(cfg, q, k, v, q_pos, k_pos, causal, window):
    """Flash-style two-level loop with online softmax: memory O(qc · kvc)
    instead of O(S²).  Every (q-chunk, kv-chunk) pair is computed and
    masking handles causality, as in the reference."""
    b, sq, h, hd = q.shape
    sk = k.shape[1]
    kk = cfg.n_kv_heads
    g = h // kk
    qc = min(cfg.attn_chunk_q, sq)
    kc = min(cfg.attn_chunk_kv, sk)
    if sq % qc or sk % kc:
        raise ValueError(f"sequence lengths {sq}, {sk} are not multiples of "
                         f"the attention chunks {qc}, {kc}")
    scale = 1.0 / math.sqrt(hd)
    outs = []
    for i in range(sq // qc):
        qg = q[:, i * qc:(i + 1) * qc].reshape(b, qc, kk, g, hd)
        qp = q_pos[i * qc:(i + 1) * qc]
        m = torch.full((b, kk, g, qc), -math.inf, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((b, kk, g, qc), dtype=torch.float32, device=q.device)
        acc = torch.zeros((b, kk, g, qc, hd), dtype=torch.float32,
                          device=q.device)
        for j in range(sk // kc):
            ki = k[:, j * kc:(j + 1) * kc]
            vi = v[:, j * kc:(j + 1) * kc]
            s = torch.einsum("bqkgd,bskd->bkgqs", qg.to(torch.float32),
                             ki.to(torch.float32)) * scale
            s = s + _mask_bias(qp, k_pos[j * kc:(j + 1) * kc], causal, window)
            m_new = torch.maximum(m, torch.amax(s, dim=-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            l = l * alpha + torch.sum(p, dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bkgqs,bskd->bkgqd", p, vi.to(torch.float32))
            m = m_new
        out = acc / torch.clamp(l[..., None], min=1e-30)
        outs.append(out.permute(0, 3, 1, 2, 4).reshape(b, qc, h, hd)
                    .to(q.dtype))
    return torch.cat(outs, dim=1)


def attention(cfg: ArchConfig, p, x, positions=None, *, causal: bool = True,
              rope: bool = True, kv_override=None):
    """Self- (or cross-, through `kv_override`) attention over a full
    sequence: x [B, S, D] -> [B, S, D], with the config's sliding window
    when set.

    kv_override: optional (k, v, k_pos) for cross-attention (the enc-dec
    decoder): k / v [B, Sk, K, hd] replace the projections of x, k_pos
    [Sk] their positions; RoPE (when `rope`) then turns q only, as in the
    reference, whose k and v projections of x go unused."""
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32, device=x.device)
    if kv_override is None:
        q, k, v = _project_qkv(cfg, p, x, positions, rope)
        k_pos = positions
    else:
        q = _project_q(cfg, p, x, positions, rope)
        k, v, k_pos = kv_override
    if max(s, k.shape[1]) <= cfg.full_attn_max_seq:
        out = _plain_attention(cfg, q, k, v, positions, k_pos, causal,
                               cfg.sliding_window)
    else:
        out = _chunked_attention(cfg, q, k, v, positions, k_pos, causal,
                                 cfg.sliding_window)
    return linear(out.reshape(b, s, cfg.q_dim), p["wo"])


def cross_kv(cfg: ArchConfig, p, enc_out):
    """Cross-attention K / V [B, S_enc, K, hd] from the encoder output (the
    enc-dec decoder's, precomputed once for decoding): the k and v
    projections, qk-norm on k, no RoPE."""
    b, s, _ = enc_out.shape
    k = linear(enc_out, p["wk"]).reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    v = linear(enc_out, p["wv"]).reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    if cfg.qk_norm:
        k = rms_norm(k, p["k_norm"]["scale"])
    return k, v


# ------------------------------------------------- decode (ring KV cache)


@dataclasses.dataclass(frozen=True)
class CacheSpec:
    batch: int
    window: int  # number of cache slots (= seq_len, or the SWA window)
    n_kv_heads: int
    head_dim: int
    dtype: str = "bfloat16"


def init_kv_cache(spec: CacheSpec, n_layers: int, device=None):
    """Zero k / v [L, B, W, K, hd] in the spec's dtype, slot_pos [L, W]
    int32 = −1 (empty), `length` a 0-d int32 (the next token's absolute
    position), all on `device`: None means the card and raises on a host
    without CUDA."""
    dev = resolve_device(device)
    shape = (n_layers, spec.batch, spec.window, spec.n_kv_heads,
             spec.head_dim)
    dtype = torch_dtype(spec.dtype)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=dev),
        "v": torch.zeros(shape, dtype=dtype, device=dev),
        "slot_pos": torch.full((n_layers, spec.window), -1,
                               dtype=torch.int32, device=dev),
        "length": torch.zeros((), dtype=torch.int32, device=dev),
    }


def decode_attention(cfg: ArchConfig, p, x, layer_cache, length):
    """One-token attention against a ring-buffer cache.

    x [B, 1, D]; layer_cache: dict(k, v [B, W, K, hd], slot_pos [W]);
    length: 0-d int32, the new token's absolute position.  Writes the new
    k, v into slot length % W and sets slot_pos there IN PLACE (no value is
    read back to the host), then attends over the ring.  Returns (out
    [B, 1, D] in x's dtype, the same layer_cache)."""
    b = x.shape[0]
    q, k_new, v_new = _project_qkv(cfg, p, x, length.reshape(1), True)
    k_cache, v_cache = layer_cache["k"], layer_cache["v"]
    slot_pos = layer_cache["slot_pos"]
    slot = torch.remainder(length, k_cache.shape[1]).reshape(1).to(
        torch.int64)
    k_cache.index_copy_(1, slot, k_new.to(k_cache.dtype))
    v_cache.index_copy_(1, slot, v_new.to(v_cache.dtype))
    slot_pos.index_copy_(0, slot, length.reshape(1).to(torch.int32))
    out = ops.decode_attention_fused(q[:, 0], k_cache, v_cache, slot_pos,
                                     length, window=cfg.sliding_window or 0)
    out = out.to(x.dtype).reshape(b, 1, cfg.q_dim)
    return linear(out, p["wo"]), layer_cache


# ---------------------------------------------------------------- MLP


def init_mlp(gen, cfg: ArchConfig, d_ff: Optional[int] = None, stack=(),
             device=None):
    d, f = cfg.d_model, d_ff or cfg.d_ff
    kw = dict(stack=stack, device=device)
    if cfg.act == "silu":
        return {"wg": init_linear(gen, d, f, cfg, **kw),
                "wu": init_linear(gen, d, f, cfg, **kw),
                "wd": init_linear(gen, f, d, cfg, **kw)}
    return {"w1": init_linear(gen, d, f, cfg, bias=True, **kw),
            "w2": init_linear(gen, f, d, cfg, bias=True, **kw)}


def mlp(cfg: ArchConfig, p, x):
    """SiLU-GLU, or a plain MLP with tanh-approximated GELU (the default of
    `jax.nn.gelu`)."""
    if cfg.act == "silu":
        return linear(F.silu(linear(x, p["wg"])) * linear(x, p["wu"]),
                      p["wd"])
    return linear(F.gelu(linear(x, p["w1"]), approximate="tanh"), p["w2"])


# ---------------------------------------------------------------- embeddings


def init_embedding(gen, cfg: ArchConfig, device=None):
    emb = torch.randn((cfg.vocab, cfg.d_model), generator=gen,
                      dtype=torch.float32, device=device) * 0.02
    return {"table": emb.to(cfg.pdtype)}


def embed(cfg: ArchConfig, p, tokens: torch.Tensor):
    return p["table"].to(cfg.adtype)[tokens.to(torch.int64)]


def unembed(cfg: ArchConfig, p_unemb, p_emb, x):
    if cfg.tie_embeddings:
        w = p_emb["table"].to(x.dtype).T
    else:
        w = p_unemb["w"].to(x.dtype)
    return torch.matmul(x, w)
