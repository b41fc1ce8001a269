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

On a mesh (`dist.constraints.use_mesh`, with params, batch and cache
placed as DTensors by `dist.sharding`'s specs) the same functions run
partitioned, the counterpart of GSPMD's partitioning of the reference:

  * a weight is all-gathered over every axis but "model" just before use,
    and over "model" takes the layout of its input: column-parallel
    (output features split) on an input whole over "model", row-parallel
    (input features split, the output's partial sums all-reduced) on an
    input split over its last dim; an MoE expert weight [E, D_in, D_out]
    (its input [E, N, D_in]) the same way, or split over its experts
    where its spec puts E over "model" (`expert_parallel`);
  * attention splits its heads over "model" when H (and K) divide by its
    size: q, k and v come out of column-parallel projections, RoPE,
    qk-norm and the score / softmax / combine (plain or chunked) run on
    the local heads (`local_map`), K / V heads are repeated to the query
    heads when only H divides (Megatron's rule), and when H does not
    divide either the attention runs whole on every "model" shard;
  * the embedding is vocab-parallel (each shard looks up its rows, the
    rest are zero, one all-reduce sums them), and the unembed's output is
    the vocab-sharded logits that `constrain_logits` asks for;
  * `decode_attention` writes the new k / v into the local shard of a
    cache split over hd ("model") and batch ("data"), and attends through
    the split-hd kernels: partial q·k over the local hd
    (`ops.decode_scores_partial`), an all-reduce over "model", then
    mask, softmax and p·v into the local hd (`ops.decode_softmax_combine`);
    `cross_decode_attention` runs the enc-dec decoder's cross-attention
    over its hd-split encoder cache through the same kernels;
  * a computation written on local tensors (the SSM layer, `ssm.py`)
    takes its inputs through `_local_part`, which says how autograd
    sums their gradients, and a norm over features split over "model"
    through `split_rms_norm` (one all-reduce of the sum of squares).

Each sublayer returns its output in its input's layout.  One function
serves both: without a mesh every placement step (`_to_heads`,
`_on_shards`, `_like`) is the identity, and the functions are the plain
ones above.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.dist.constraints import (current_mesh, is_dtensor,
                                          vocab_shard)
from repro_torch.dist.sharding import MODEL_AXIS
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


def linear(x: torch.Tensor, p, unit: int = 1):
    """x @ w (+ b).  On a mesh, w is used row- or column-parallel over
    "model" as its spec and its input allow (module docstring); a
    column-parallel w splits its output features in whole groups of `unit`
    (a head's width for q / k / v), or stays whole over "model" when their
    count does not divide."""
    mesh = _mesh_of(x)
    w = p["w"]
    if mesh is not None:
        w, x = _use_weight(mesh, w, x, unit)
    y = torch.matmul(x, w.to(x.dtype))
    if mesh is not None:
        y = _settle(mesh, y)
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


def _heads(cfg: ArchConfig, p, t, positions, rope: bool, norm, split: bool):
    """t [B, S, heads, hd] with its heads over "model" when `split` (on a
    mesh), then qk-norm (`norm`, the scale's name) and RoPE on the local
    heads."""
    mesh = _mesh_of(t)
    t = _to_heads(mesh, t, split)
    if cfg.qk_norm and norm:
        t = rms_norm(t, p[norm]["scale"])
    if rope:
        t = _on_shards(mesh, lambda u: apply_rope(u, positions,
                                                  cfg.rope_theta), t)
    return t


def _project_q(cfg: ArchConfig, p, x, positions, rope: bool = True):
    b, s, _ = x.shape
    q = linear(x, p["wq"], unit=cfg.head_dim).reshape(b, s, cfg.n_heads,
                                                       cfg.head_dim)
    h_split, _ = _head_split(cfg, _mesh_of(x))
    return _heads(cfg, p, q, positions, rope, "q_norm", h_split)


def _project_qkv(cfg: ArchConfig, p, x, positions, rope: bool = True):
    """q, k, v [B, S, heads, hd] from the projections (row- or
    column-parallel on a mesh, as `linear` picks), heads over "model"
    where `_head_split` allows."""
    b, s, _ = x.shape
    hd = cfg.head_dim
    _, kv_split = _head_split(cfg, _mesh_of(x))
    q = _project_q(cfg, p, x, positions, rope)
    k = linear(x, p["wk"], unit=hd).reshape(b, s, cfg.n_kv_heads, hd)
    v = linear(x, p["wv"], unit=hd).reshape(b, s, cfg.n_kv_heads, hd)
    return (q, _heads(cfg, p, k, positions, rope, "k_norm", kv_split),
            _heads(cfg, p, v, positions, False, None, kv_split))


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
    kk = k.shape[2]
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
    mesh = _mesh_of(x)
    positions = _local_value(positions)
    if kv_override is None:
        q, k, v = _project_qkv(cfg, p, x, positions, rope)
        k_pos = positions
    else:
        q = _project_q(cfg, p, x, positions, rope)
        k, v, k_pos = kv_override
        k_pos = _local_value(k_pos)
    if mesh is not None:
        q, k, v = _heads_alike(cfg, mesh, q, k, v)
    core = _plain_attention if max(s, k.shape[1]) <= cfg.full_attn_max_seq \
        else _chunked_attention

    def local(qq, kk, vv):
        return core(cfg, qq, kk, vv, positions, k_pos, causal,
                    cfg.sliding_window)

    out = _on_shards(mesh, local, q, k, v)
    out = linear(out.reshape(b, s, cfg.q_dim), p["wo"])
    return _like(mesh, out, x)


def cross_kv(cfg: ArchConfig, p, enc_out):
    """Cross-attention K / V [B, S_enc, K, hd] from the encoder output (the
    enc-dec decoder's, precomputed once for decoding): the k and v
    projections, qk-norm on k, no RoPE.  On a mesh their heads lie as
    `_project_qkv` lays a self-attention's K / V."""
    b, s, _ = enc_out.shape
    hd = cfg.head_dim
    _, kv_split = _head_split(cfg, _mesh_of(enc_out))
    k = linear(enc_out, p["wk"], unit=hd).reshape(b, s, cfg.n_kv_heads, hd)
    v = linear(enc_out, p["wv"], unit=hd).reshape(b, s, cfg.n_kv_heads, hd)
    return (_heads(cfg, p, k, None, False, "k_norm", kv_split),
            _heads(cfg, p, v, None, False, None, kv_split))


def cross_decode_attention(cfg: ArchConfig, p, x, cross_k, cross_v, length):
    """One decoder token's cross-attention over one layer's encoder K / V
    cache [B, S_enc, K, hd] (every slot live; k not turned by RoPE, q
    turned at `length`): x [B, 1, D] -> [B, 1, D].  The plain `attention`,
    as the reference computes it, except on a mesh whose "model" splits
    the cache's hd: there the split-hd kernels of `decode_attention` run
    on the local shards, over slot positions 0 .. S_enc − 1 with the
    query at S_enc − 1, and the cache never moves."""
    enc_len = cross_k.shape[1]
    mesh = _mesh_of(x)
    if mesh is None or not _hd_split(mesh, cross_k):
        enc_pos = torch.arange(enc_len, dtype=torch.int32, device=x.device)
        return attention(cfg, p, x, length.reshape(1), causal=False,
                         kv_override=(cross_k, cross_v, enc_pos))
    pos = _local_value(length)
    q = _project_q(cfg, p, x, pos.reshape(1))
    kl = cross_k.to_local()
    slots = torch.arange(enc_len, dtype=torch.int32, device=kl.device)
    return _attend_on_mesh(cfg, mesh, p, x, q, cross_k, kl,
                           cross_v.to_local(), slots, slots[-1], 0)


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
    mesh = _mesh_of(x)
    if mesh is not None:
        return _decode_attention_on_mesh(cfg, mesh, p, x, layer_cache,
                                         length)
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
    `jax.nn.gelu`).  On a mesh: column- then row-parallel, the output in
    x's layout."""
    if cfg.act == "silu":
        out = linear(F.silu(linear(x, p["wg"])) * linear(x, p["wu"]),
                     p["wd"])
    else:
        out = linear(F.gelu(linear(x, p["w1"]), approximate="tanh"),
                     p["w2"])
    return _like(_mesh_of(x), out, x)


# ---------------------------------------------------------------- embeddings


def init_embedding(gen, cfg: ArchConfig, device=None):
    emb = torch.randn((cfg.vocab, cfg.d_model), generator=gen,
                      dtype=torch.float32, device=device) * 0.02
    return {"table": emb.to(cfg.pdtype)}


def embed(cfg: ArchConfig, p, tokens: torch.Tensor):
    mesh = _mesh_of(p["table"])
    if mesh is not None:
        return _embed_on_mesh(cfg, mesh, p["table"], tokens)
    return F.embedding(tokens.to(torch.int64), p["table"].to(cfg.adtype))


def unembed(cfg: ArchConfig, p_unemb, p_emb, x):
    """x @ the unembedding [D, V] (the tied table's transpose); on a mesh
    the logits come out vocab-sharded over "model"."""
    mesh = _mesh_of(x)
    w, dim = (p_emb["table"], 0) if cfg.tie_embeddings else (p_unemb["w"], 1)
    if mesh is not None:
        w = w.redistribute(mesh, _vocab_placements(mesh, w, dim))
        # a "batch_seq" residual's tokens whole over "model" first: the
        # vocabulary is split there
        x = _whole_over_model(mesh, x)
    w = w.to(x.dtype)
    return torch.matmul(x, w.T if cfg.tie_embeddings else w)


# ------------------------------------------- partitioned forms (a mesh)


def _mesh_of(x):
    """The mesh of `use_mesh` when x is a DTensor on it, else None."""
    mesh = current_mesh()
    if mesh is None or not is_dtensor(x):
        return None
    return mesh


def _model_index(mesh):
    if mesh is None:
        return None
    names = tuple(mesh.mesh_dim_names)
    return names.index(MODEL_AXIS) if MODEL_AXIS in names else None


def _model_size(mesh) -> int:
    i = _model_index(mesh)
    return 1 if i is None else int(mesh.size(i))


def _gathered_but_model(mesh, w, dim: Optional[int]):
    """Placements of `w` replicated over every axis but "model", and split
    over "model" along `dim` when that is given and its size divides by
    the axis (else replicated there too)."""
    from torch.distributed.tensor import Replicate, Shard

    m, i = _model_size(mesh), _model_index(mesh)
    out = [Replicate()] * mesh.ndim
    if dim is not None and m > 1 and w.shape[dim] % m == 0:
        out[i] = Shard(dim)
    return out


def _vocab_placements(mesh, w, dim: int):
    """Placements of an embedding table / unembedding `w`: replicated over
    every axis but "model", its vocabulary dim `dim` split there as
    `vocab_shard` says."""
    from torch.distributed.tensor import Replicate

    return list(vocab_shard(mesh, w.shape[dim]).place(
        [Replicate()] * mesh.ndim, dim))


def _use_weight(mesh, w, x, unit: int):
    """(w, x) in the layouts of one product x @ w, w [D_in, D_out] (or
    [E, D_in, D_out] with a leading expert dim, x then [E, N, D_in])
    gathered over every axis but "model".  Over "model": expert-parallel
    (w and x split along E, the product local) where the spec splits E;
    row-parallel (w split along D_in, x along its last dim, the product's
    partial sums all-reduced after) where the spec splits D_in or x comes
    split along its last dim; column-parallel (w split along D_out in
    whole groups of `unit`, x whole) where the spec splits D_out; else
    whole."""
    from torch.distributed.tensor import Shard

    m, i = _model_size(mesh), _model_index(mesh)
    if m == 1:
        return w.redistribute(mesh, _gathered_but_model(mesh, w, None)), x
    d_in = w.dim() - 2  # 1 after a leading expert dim, else 0
    if d_in and w.placements[i] == Shard(0) and w.shape[0] % m == 0:
        return (w.redistribute(mesh, _gathered_but_model(mesh, w, 0)),
                _over_model(mesh, x, Shard(0)))
    xp = x.placements[i]
    x_split = isinstance(xp, Shard) and xp.dim in (-1, x.dim() - 1)
    d_out = w.shape[d_in + 1]
    cols = d_out % unit == 0 and (d_out // unit) % m == 0
    if (x_split or w.placements[i] == Shard(d_in)) \
            and w.shape[d_in] % m == 0:
        return (w.redistribute(mesh, _gathered_but_model(mesh, w, d_in)),
                _over_model(mesh, x, Shard(x.dim() - 1)))
    x = _whole_over_model(mesh, x)
    return w.redistribute(mesh, _gathered_but_model(
        mesh, w, d_in + 1 if cols else None)), x


def _unsplit_singletons(mesh, t):
    """t with its shards over one-rank mesh dims said to be replicas (the
    same local tensor, no collective): a view cannot merge a dim of global
    size 1 that such a mesh dim "splits" (the global MoE pool's rows when
    one rank holds the batch)."""
    from torch.distributed.tensor import DTensor, Replicate

    pl = [Replicate() if mesh.size(i) == 1 else p
          for i, p in enumerate(t.placements)]
    if pl == list(t.placements):
        return t
    return DTensor.from_local(t.to_local(), mesh, pl, shape=t.shape,
                              stride=t.stride())


def _settle(mesh, y):
    """Partial sums (a row-parallel product) all-reduced to replicas."""
    from torch.distributed.tensor import Partial, Replicate

    if not any(isinstance(p, Partial) for p in y.placements):
        return y
    return y.redistribute(mesh, [Replicate() if isinstance(p, Partial)
                                 else p for p in y.placements])


def _over_model(mesh, x, placement):
    """x with `placement` over "model" and its other placements kept."""
    i = _model_index(mesh)
    if i is None or x.placements[i] == placement:
        return x
    pl = list(x.placements)
    pl[i] = placement
    return x.redistribute(mesh, pl)


def _whole_over_model(mesh, x):
    """x replicated over "model" (the sequence-parallel all-gather of a
    "batch_seq" residual; a no-op for a "batch" one)."""
    from torch.distributed.tensor import Replicate

    return _over_model(mesh, x, Replicate())


def _like(mesh, y, x):
    """y in x's placements (y itself without a mesh)."""
    if mesh is None:
        return y
    y = _settle(mesh, y)
    if tuple(y.placements) == tuple(x.placements):
        return y
    return y.redistribute(mesh, x.placements)


def _on_shards(mesh, fn, x, *others, outs=None):
    """fn over the local shards of x and `others` (DTensors in x's
    placements), the result in x's placements (`local_map`); for a fn of
    several results, `outs` says for each whether it lies in x's
    placements (True) or is whole on every rank (False); fn(x, *others)
    without a mesh."""
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import local_map

    if mesh is None:
        return fn(x, *others)

    pl = tuple(x.placements)
    out = list(pl) if outs is None else tuple(
        list(pl) if o else [Replicate()] * mesh.ndim for o in outs)
    return local_map(fn, out_placements=out,
                     in_placements=tuple(pl for _ in (x,) + others),
                     device_mesh=mesh)(x, *others)


def _local_value(t):
    """A replicated DTensor's whole value; a plain tensor as it is."""
    return t.to_local() if is_dtensor(t) else t


def _head_split(cfg, mesh):
    """(q heads split over "model", K / V heads split with them)."""
    m = _model_size(mesh)
    h = m > 1 and cfg.n_heads % m == 0
    return h, h and cfg.n_kv_heads % m == 0


def _to_heads(mesh, t, split: bool):
    """t [B, S, heads, hd] with its heads over "model" (`split`) or whole
    there (a slice of a replicated t costs nothing); t without a mesh."""
    from torch.distributed.tensor import Replicate, Shard

    if mesh is None:
        return t
    return _over_model(mesh, _settle(mesh, t), Shard(2) if split
                       else Replicate())


def _heads_alike(cfg, mesh, q, k, v):
    """q, k, v with their heads in one layout over "model": K / V heads
    repeated to the query heads where only H divides (then split with
    them), all whole where H does not divide."""
    from torch.distributed.tensor import Replicate

    h_split, _ = _head_split(cfg, mesh)
    if h_split and tuple(k.placements) != tuple(q.placements):
        g = cfg.n_heads // k.shape[2]
        k, v = (_on_shards(mesh, lambda u: u.repeat_interleave(g, dim=2),
                           _whole_over_model(mesh, t)) for t in (k, v))
        k, v = (t.redistribute(mesh, q.placements) for t in (k, v))
    elif not h_split:
        q, k, v = (_over_model(mesh, t, Replicate()) for t in (q, k, v))
    return q, k, v


class _SumOverShards(torch.autograd.Function):
    """All-reduce (sum) over a process group; the backward is the identity
    (each rank's gradient of the summed value is already whole)."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed._functional_collectives as funcol

        return funcol.wait_tensor(funcol.all_reduce(x, "sum", group))

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SumOfPartials(torch.autograd.Function):
    """All-reduce (sum) over a process group of a value that each rank
    then uses on its own shard of a split computation: each rank's
    cotangent covers only its shard's uses, so the backward all-reduces
    the cotangents too."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed._functional_collectives as funcol

        ctx.group = group
        return funcol.wait_tensor(funcol.all_reduce(x, "sum", group))

    @staticmethod
    def backward(ctx, g):
        import torch.distributed._functional_collectives as funcol

        return funcol.wait_tensor(funcol.all_reduce(g, "sum", ctx.group)), \
            None


def split_rms_norm(x: torch.Tensor, scale: torch.Tensor, width: int, group,
                   eps: float = 1e-6):
    """`rms_norm` of a row split over the ranks of `group`: x [..., w] is
    this rank's w of the row's `width` features and `scale` their scales;
    the mean of squares sums each rank's part (one all-reduce of [..., 1],
    whose backward all-reduces too)."""
    x32 = x.to(torch.float32)
    ss = torch.sum(torch.square(x32), dim=-1, keepdim=True)
    var = _SumOfPartials.apply(ss, group) / width
    return (x32 * torch.rsqrt(var + eps) * scale.to(torch.float32)).to(x.dtype)


def _local_part(mesh, t, like, split: bool, replica: bool = False):
    """t's local tensor, for a computation on each rank's part of the
    activation `like` (a DTensor) that autograd leaves: the gradient is a
    shard where `like` is split, and, where the computation splits over
    "model" (`split`), a partial sum there.  `replica`: t is a replicated
    weight whose gradient is each rank's partial sum over every dimension
    that splits `like` (and over "model" with `split`); else t is an
    activation in `like`'s placements, or whole over "model" beside a
    split one (`split`: its gradient a partial sum there)."""
    from torch.distributed.tensor import Partial, Replicate

    i = _model_index(mesh)
    if replica:
        t = t.redistribute(mesh, [Replicate()] * mesh.ndim)
    grad = []
    for d, (tp, lp) in enumerate(zip(t.placements, like.placements)):
        if d == i and split and not tp.is_shard():
            grad.append(Partial())
        elif replica:
            grad.append(Partial() if lp.is_shard() else Replicate())
        else:
            grad.append(tp)
    return t.to_local(grad_placements=grad)


def _embed_on_mesh(cfg, mesh, table, tokens):
    """Vocab-parallel lookup: each "model" shard takes the rows of its
    vocabulary range (exact zeros elsewhere), one all-reduce sums them."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    if not is_dtensor(tokens):
        tokens = DTensor.from_local(tokens, mesh,
                                    [Replicate()] * mesh.ndim)
    vocab = vocab_shard(mesh, table.shape[0])
    t_pl = vocab.place([Replicate()] * mesh.ndim, 0)
    table = table.redistribute(mesh, t_pl)

    def look_up(t, tok):
        idx = tok.to(torch.int64)
        if not vocab.split:
            return F.embedding(idx, t.to(cfg.adtype))
        idx = idx - vocab.offset
        ok = (idx >= 0) & (idx < t.shape[0])
        rows = F.embedding(torch.where(ok, idx, 0), t.to(cfg.adtype))
        return _SumOverShards.apply(
            torch.where(ok[..., None], rows, torch.zeros_like(rows)),
            vocab.group)

    # the table's gradient sums over the ranks that split the tokens
    grad_pl = tuple(Partial() if isinstance(tp, Shard) else pl
                    for tp, pl in zip(tokens.placements, t_pl))
    return local_map(look_up, out_placements=list(tokens.placements),
                     in_placements=(t_pl, tuple(tokens.placements)),
                     in_grad_placements=(grad_pl, tuple(tokens.placements)),
                     device_mesh=mesh)(table, tokens)


def _hd_split(mesh, k_cache) -> bool:
    """Whether a placed ring [B, W, K, hd] has its hd split over "model"
    (of more than one rank)."""
    from torch.distributed.tensor import Shard

    i = _model_index(mesh)
    return i is not None and _model_size(mesh) > 1 \
        and k_cache.placements[i] == Shard(3)


def _decode_attention_on_mesh(cfg, mesh, p, x, layer_cache, length):
    """`decode_attention` on a mesh: the ring write into the local shard of
    a cache split over batch ("data") and hd ("model"), then
    `_attend_on_mesh`."""
    from torch.distributed.tensor import Replicate, Shard

    pos = _local_value(length)
    q, k_new, v_new = _project_qkv(cfg, p, x, pos.reshape(1))
    k_cache, v_cache = layer_cache["k"], layer_cache["v"]
    i = _model_index(mesh)
    if i is not None and k_cache.placements[i] not in (Replicate(),
                                                       Shard(3)):
        raise NotImplementedError(
            f"decode on a mesh takes a cache split over hd or whole over "
            f"'model'; got {k_cache.placements}")
    kl, vl = k_cache.to_local(), v_cache.to_local()
    sp = _local_value(layer_cache["slot_pos"])
    slot = torch.remainder(pos, kl.shape[1]).reshape(1).to(torch.int64)
    for new, loc in ((k_new, kl), (v_new, vl)):
        new = new.redistribute(mesh, k_cache.placements)
        loc.index_copy_(1, slot, new.to_local().to(loc.dtype))
    sp.index_copy_(0, slot, pos.reshape(1).to(torch.int32))
    return _attend_on_mesh(cfg, mesh, p, x, q, k_cache, kl, vl, sp, pos,
                           cfg.sliding_window or 0), layer_cache


def _attend_on_mesh(cfg, mesh, p, x, q, k_cache, kl, vl, sp, pos, window):
    """One token's q [B, 1, H, hd] against a placed ring `k_cache` (its
    local k / v shards kl, vl, slot positions sp, the query at pos), then
    wo, the output in x's layout: the split-hd kernels with an all-reduce
    of the partial scores between them where the ring's hd is split, else
    the fused kernel on the local batch."""
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor import DTensor, Replicate, Shard

    b = x.shape[0]
    i = _model_index(mesh)
    hd_split = _hd_split(mesh, k_cache)
    # q [B, H, hd]: batch as the cache's, hd over "model" when it is split
    q_pl = [Shard(0) if pl == Shard(0) else Replicate()
            for pl in k_cache.placements]
    if hd_split:
        q_pl[i] = Shard(2)
    q = q[:, 0].redistribute(mesh, q_pl)
    ql = q.to_local()
    if hd_split:
        scores = ops.decode_scores_partial(ql, kl,
                                           1.0 / math.sqrt(cfg.head_dim))
        scores = funcol.wait_tensor(funcol.all_reduce(
            scores, "sum", mesh.get_group(MODEL_AXIS)))
        out = ops.decode_softmax_combine(scores, vl, sp, pos, window)
    else:
        out = ops.decode_attention_fused(ql, kl, vl, sp, pos, window=window)
    out = DTensor.from_local(out.to(x.dtype), mesh, q_pl, shape=q.shape,
                             stride=q.stride())
    if i is not None:  # heads over "model" for the row-parallel wo
        h_split, _ = _head_split(cfg, mesh)
        out = _over_model(mesh, out, Shard(1) if h_split else Replicate())
    out = linear(out.reshape(b, 1, cfg.q_dim), p["wo"])
    return _like(mesh, out, x)
