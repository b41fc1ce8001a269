"""Mamba2 (SSD, state-space duality) LM, chunk-parallel, in plain PyTorch.

The PyTorch counterpart of the JAX package's `repro.models.lm.ssm`, which
computes the SSD core in `jnp` outside any Pallas kernel: so does the
port (einsum / matmul; a scan kernel of its own is later work, ROADMAP).
The SSD block decomposition of arXiv:2405.21060 splits the sequence into
chunks of Q tokens; within a chunk the output is the quadratic
"attention-like" term (C_i · B_j under the causal decay kernel), across
chunks an O(1)-per-chunk recurrent state is carried.  Work is O(S · Q)
and decoding keeps a per-head [P, N] state whose size does not depend on
the context length.

All decay factors are exp of non-positive numbers (a = -exp(A_log) · dt
< 0); the core runs in fp32.  The reference computes the intra-chunk
kernel exp(ca_i - ca_j) over the whole [Q, Q] block and then zeroes the
upper triangle, whose exponents are positive: where a chunk's summed
decay passes ~88 they overflow to inf, the forward still zeroes them, but
the backward multiplies the zeroed cotangent by inf and every gradient
turns NaN (mamba2-2.7b at full width on the card, from the first step).
The port masks the exponent before the exp (exp(-inf) = 0 above the
diagonal): the same forward values, and the reference's gradient
wherever that is finite.

Layer structure (mamba2): in_proj -> (z | xBC | dt); causal depthwise
conv on xBC; SSD core; gated RMSNorm (y · silu(z)); out_proj.  Decoding
updates each layer's conv window and state IN PLACE in the cache it is
given (the reference returns a new cache).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.dist.constraints import (
    constrain_batch,
    constrain_logits,
    constrain_residual,
    gather_weights,
)
from repro_torch.models.lm.config import ArchConfig
from repro_torch.models.lm.layers import (
    _dense_init,
    apply_norm,
    embed,
    init_embedding,
    init_linear,
    init_norm,
    layer_params,
    remat,
    rms_norm,
    unembed,
)


def _split_dims(cfg: ArchConfig):
    di = cfg.ssm_inner
    gn = cfg.ssm_groups * cfg.ssm_state
    h = cfg.ssm_heads
    return di, gn, h


def init_ssm_layer(gen, cfg: ArchConfig, stack=(), device=None):
    """One mamba2 layer (a stack of them with a leading `stack` shape):
    A = -1, D = 1, and dt_bias the inverse softplus of dt ~ log-uniform on
    [1e-3, 1e-1] (the mamba2 default)."""
    di, gn, h = _split_dims(cfg)
    d = cfg.d_model
    conv_ch = di + 2 * gn
    stack = tuple(stack)
    u = torch.rand(stack + (h,), generator=gen, dtype=torch.float32,
                   device=device)
    dt0 = torch.exp(u * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
    dt_bias = dt0 + torch.log(-torch.expm1(-dt0))  # inverse softplus
    ones = lambda n, dt: torch.ones(stack + (n,), dtype=dt, device=device)
    return {
        "norm": init_norm(cfg, stack=stack, device=device),
        "in_proj": init_linear(gen, d, 2 * di + 2 * gn + h, cfg, stack=stack,
                               device=device),
        "conv_w": _dense_init(gen, stack + (cfg.ssm_conv, conv_ch),
                              cfg.ssm_conv, cfg.pdtype, device),
        "conv_b": torch.zeros(stack + (conv_ch,), dtype=cfg.pdtype,
                              device=device),
        "A_log": torch.zeros(stack + (h,), dtype=torch.float32,
                             device=device),
        "D": ones(h, torch.float32),
        "dt_bias": dt_bias,
        "gate_norm": {"scale": ones(di, cfg.pdtype)},
        "out_proj": init_linear(gen, di, d, cfg, stack=stack, device=device),
    }


def _causal_depthwise_conv(x, w, b):
    """x [B, S, C], w [K, C]: the depthwise causal convolution (a
    cross-correlation over x padded with K - 1 zeros in front), + b."""
    k = w.shape[0]
    xp = F.pad(x.transpose(1, 2), (k - 1, 0))  # [B, C, S + K - 1]
    y = F.conv1d(xp, w.to(x.dtype).t()[:, None, :], groups=x.shape[-1])
    y = y.transpose(1, 2)
    return y + b.to(y.dtype)


def _project(cfg: ArchConfig, lp, x):
    """The pre-SSD projection: (z, xBC before the conv, dt before the
    softplus)."""
    di, gn, _ = _split_dims(cfg)
    zxbcdt = torch.matmul(x, lp["in_proj"]["w"].to(x.dtype))
    return (zxbcdt[..., :di], zxbcdt[..., di:2 * di + 2 * gn],
            zxbcdt[..., 2 * di + 2 * gn:])


def _split_xbc(cfg: ArchConfig, xbc):
    di, gn, _ = _split_dims(cfg)
    n, g = cfg.ssm_state, cfg.ssm_groups
    shape = xbc.shape[:-1]
    return (xbc[..., :di].reshape(*shape, cfg.ssm_heads, cfg.ssm_head_dim),
            xbc[..., di:di + gn].reshape(*shape, g, n),
            xbc[..., di + gn:].reshape(*shape, g, n))


def _expand_groups(cfg: ArchConfig, m):
    """[..., G, N] -> [..., H, N], each group repeated for its heads."""
    return torch.repeat_interleave(m, cfg.ssm_heads // cfg.ssm_groups,
                                   dim=-2)


def ssd_chunked(cfg: ArchConfig, x, b_mat, c_mat, a, state0=None):
    """The SSD core.  x [B, S, H, P]; b / c [B, S, H, N]; a [B, S, H]
    (negative).  Returns (y [B, S, H, P] in x's dtype, the final state
    [B, H, P, N] fp32).  S must be a multiple of the chunk min(ssm_chunk,
    S)."""
    bsz, s, h, p = x.shape
    n = b_mat.shape[-1]
    q = min(cfg.ssm_chunk, s)
    assert s % q == 0, (s, q)
    state = (torch.zeros((bsz, h, p, n), dtype=torch.float32,
                         device=x.device) if state0 is None else state0)
    causal = torch.tril(torch.ones((q, q), dtype=torch.bool,
                                   device=x.device))
    ys = []
    for c0 in range(0, s, q):
        xk = x[:, c0:c0 + q].to(torch.float32)  # [B, q, H, P]
        bk = b_mat[:, c0:c0 + q].to(torch.float32)  # [B, q, H, N]
        ck = c_mat[:, c0:c0 + q].to(torch.float32)
        ca = torch.cumsum(a[:, c0:c0 + q], dim=1)  # [B, q, H], decreasing
        total = ca[:, -1]  # [B, H]
        # the intra-chunk quadratic term
        cb = torch.einsum("bihn,bjhn->bhij", ck, bk)
        # exp(ca_i - ca_j) for j <= i, 0 above the diagonal: the masked
        # entries take exp(-inf) = 0 (see the module docstring)
        decay = torch.exp(torch.where(causal[None, :, :, None],
                                      ca[:, :, None, :] - ca[:, None, :, :],
                                      -math.inf))  # [B, i, j, H]
        kern = cb * decay.permute(0, 3, 1, 2)  # [B, H, i, j]
        y_intra = torch.einsum("bhij,bjhp->bihp", kern, xk)
        # the carried state's contribution
        y_inter = torch.einsum("bihn,bhpn->bihp",
                               ck * torch.exp(ca)[..., None], state)
        # the state at the chunk's end
        w_j = torch.exp(total[:, None] - ca)  # [B, q, H]
        s_add = torch.einsum("bjhp,bjhn->bhpn", xk * w_j[..., None], bk)
        state = state * torch.exp(total)[:, :, None, None] + s_add
        ys.append((y_intra + y_inter).to(x.dtype))
    return torch.cat(ys, dim=1), state


def _gated_out(cfg: ArchConfig, lp, y, z):
    """y · silu(z), the gated RMSNorm and out_proj."""
    y = rms_norm(y * F.silu(z), lp["gate_norm"]["scale"])
    return torch.matmul(y, lp["out_proj"]["w"].to(y.dtype))


def ssm_block(cfg: ArchConfig, lp, x):
    """One mamba2 layer on x [B, S, D] (a pre-norm residual block)."""
    h_in = apply_norm(cfg, x, lp["norm"])
    z, xbc, dt_raw = _project(cfg, lp, h_in)
    xbc = F.silu(_causal_depthwise_conv(xbc, lp["conv_w"], lp["conv_b"]))
    x_ssm, b_mat, c_mat = _split_xbc(cfg, xbc)
    b_h = _expand_groups(cfg, b_mat)
    c_h = _expand_groups(cfg, c_mat)
    dt = F.softplus(dt_raw.to(torch.float32) + lp["dt_bias"])  # [B, S, H]
    a = -torch.exp(lp["A_log"]) * dt  # negative
    xdt = x_ssm.to(torch.float32) * dt[..., None]
    y, _ = ssd_chunked(cfg, xdt.to(x.dtype), b_h, c_h, a)
    y = y.to(torch.float32) + lp["D"][None, None, :, None] \
        * x_ssm.to(torch.float32)
    bsz, s = x.shape[:2]
    y = y.reshape(bsz, s, cfg.ssm_inner).to(x.dtype)
    return x + _gated_out(cfg, lp, y, z)


def run_ssm_layers(cfg: ArchConfig, stacked, x):
    """The stacked mamba2 layers [L, ...] on x [B, S, D]."""
    for lp in layer_params(stacked):
        x = constrain_residual(x, cfg.residual_shard)
        if cfg.zero3_gather:
            lp = gather_weights(lp)
        x = remat(cfg, ssm_block, cfg, lp, x)
    return x


def init_ssm_lm(gen: torch.Generator, cfg: ArchConfig, device=None):
    """One node's params on `device` (None: the card); the unembedding is
    never tied."""
    device = resolve_device(device)
    return {
        "embed": init_embedding(gen, cfg, device=device),
        "layers": init_ssm_layer(gen, cfg, stack=(cfg.n_layers,),
                                 device=device),
        "final_norm": init_norm(cfg, device=device),
        "unembed": init_linear(gen, cfg.d_model, cfg.vocab, cfg,
                               device=device),
    }


def forward_ssm(cfg: ArchConfig, params, tokens, positions=None):
    """tokens [B, S] -> logits [B, S, V] (positions are not used)."""
    del positions
    x = constrain_batch(embed(cfg, params["embed"], tokens))
    x = run_ssm_layers(cfg, params["layers"], x)
    x = apply_norm(cfg, x, params["final_norm"])
    return constrain_logits(unembed(cfg, params.get("unembed"),
                                    params["embed"], x))


def init_cache_ssm(cfg: ArchConfig, batch: int, seq_len: int, device=None):
    """The recurrent decode state on `device` (None: the card): conv
    [L, B, K - 1, C] in the activation dtype, state [L, B, H, P, N] fp32
    and `length`.  Its size does not depend on `seq_len`."""
    del seq_len
    dev = resolve_device(device)
    di, gn, h = _split_dims(cfg)
    return {
        "conv": torch.zeros((cfg.n_layers, batch, cfg.ssm_conv - 1,
                             di + 2 * gn), dtype=cfg.adtype, device=dev),
        "state": torch.zeros((cfg.n_layers, batch, h, cfg.ssm_head_dim,
                              cfg.ssm_state), dtype=torch.float32,
                             device=dev),
        "length": torch.zeros((), dtype=torch.int32, device=dev),
    }


def ssm_decode_block(cfg: ArchConfig, lp, x1, conv_state, state):
    """One token's recurrent step through one layer: x1 [B, D], conv_state
    [B, K - 1, C], state [B, H, P, N] -> (x1 + out, the new conv window,
    the new state), new tensors."""
    h_in = apply_norm(cfg, x1, lp["norm"])
    z, xbc, dt_raw = _project(cfg, lp, h_in)
    window = torch.cat([conv_state, xbc[:, None, :].to(conv_state.dtype)],
                       dim=1)  # [B, K, C]
    conv_out = torch.einsum("bkc,kc->bc", window.to(torch.float32),
                            lp["conv_w"].to(torch.float32)) \
        + lp["conv_b"].to(torch.float32)
    xbc = F.silu(conv_out).to(x1.dtype)
    x_ssm, b_mat, c_mat = _split_xbc(cfg, xbc)
    b_h = _expand_groups(cfg, b_mat).to(torch.float32)  # [B, H, N]
    c_h = _expand_groups(cfg, c_mat).to(torch.float32)
    dt = F.softplus(dt_raw.to(torch.float32) + lp["dt_bias"])  # [B, H]
    a = -torch.exp(lp["A_log"]) * dt
    xdt = x_ssm.to(torch.float32) * dt[..., None]  # [B, H, P]
    state = state * torch.exp(a)[:, :, None, None] \
        + torch.einsum("bhp,bhn->bhpn", xdt, b_h)
    y = torch.einsum("bhn,bhpn->bhp", c_h, state)
    y = y + lp["D"][None, :, None] * x_ssm.to(torch.float32)
    y = y.reshape(x1.shape[0], cfg.ssm_inner).to(x1.dtype)
    return x1 + _gated_out(cfg, lp, y, z), window[:, 1:], state


def decode_ssm_layers(cfg: ArchConfig, stacked, x, conv, state, first=0):
    """x [B, D] through the stacked layers [E, ...], whose conv windows and
    states are rows first .. first + E - 1 of `conv` / `state` (updated in
    place)."""
    for i, lp in enumerate(layer_params(stacked)):
        x, conv_new, state_new = ssm_decode_block(
            cfg, lp, x, conv[first + i], state[first + i])
        conv[first + i].copy_(conv_new)
        state[first + i].copy_(state_new)
    return x


def decode_step_ssm(cfg: ArchConfig, params, cache, tokens):
    """tokens [B, 1] -> (logits [B, 1, V], cache): the conv windows and
    states updated in place, `length` a new 0-d tensor length + 1."""
    x = embed(cfg, params["embed"], tokens)[:, 0]  # [B, D]
    x = decode_ssm_layers(cfg, params["layers"], x, cache["conv"],
                          cache["state"])
    x = apply_norm(cfg, x, params["final_norm"])
    logits = unembed(cfg, params.get("unembed"), params["embed"],
                     x[:, None, :])
    cache["length"] = cache["length"] + 1
    return logits, cache
