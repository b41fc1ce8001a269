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

On a mesh (params placed by `dist.sharding`'s specs; `layers.py`'s
partitioned forms) the layer runs on each rank's own heads when "model"
divides H.  The specs split `in_proj` [D, 2·di + 2·G·N + H] in equal
column blocks, which do not line up with its z | x | B | C | dt segments,
so the layer gathers `in_proj` whole (one all-gather over every axis a
layer, as ZeRO-3 gathers a weight; the backward gathers each segment's
gradient and keeps the spec's block of their sum) and uses its segments
column-parallel in whole heads: z and x in blocks
of P columns, dt in single columns, B and C whole on every rank (G = 1
does not divide "model"; Megatron keeps K / V heads whole alike).  The
depthwise conv then runs on the rank's x channels and on B and C, the
SSD core on its heads, the gated RMSNorm's mean of squares is summed
over "model" (`layers.split_rms_norm`: one all-reduce of [B, S, 1]) and
`out_proj` runs row-parallel (its partial sums all-reduced).  The small
leaves (conv_w, conv_b, A_log, D, dt_bias, the gate's scale) are
replicated; each rank cuts its heads' part.  Where "model" does not
divide H, or has one rank, the layer runs whole on every rank's batch
rows (`in_proj` column-parallel in the specs' blocks, its output
gathered), the unpartitioned layer's own ops.

Decoding on a mesh works in the cache specs' layout, which splits the
conv window [L, B, K - 1, C] over its channels and the state [L, B, H, P,
N] over N, not over heads: `in_proj` is column-parallel in the specs'
blocks and its [B, F] output gathered (small at one token a sequence),
each rank convolves its channels and writes its window shard in place,
the conv output is gathered over "model", each rank updates its N-slice
of the state in place (local in N), and y = Σ_n c · state, a partial sum
over "model", is all-reduced; the gated norm runs whole and `out_proj`
row-parallel.  The state, the bulk of the cache, never moves.
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
from repro_torch.dist.sharding import MODEL_AXIS
from repro_torch.models.lm.config import ArchConfig
from repro_torch.utils.pytree import tree_map
from repro_torch.models.lm.layers import (
    _dense_init,
    _local_part,
    _mesh_of,
    _model_index,
    _model_size,
    _settle,
    _whole_over_model,
    _like,
    _local_value,
    apply_norm,
    embed,
    init_embedding,
    init_linear,
    init_norm,
    layer_params,
    linear,
    remat,
    rms_norm,
    split_rms_norm,
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


def _segments(cfg: ArchConfig, zxbcdt):
    """in_proj's output -> (z, xBC before the conv, dt before the
    softplus)."""
    di, gn, _ = _split_dims(cfg)
    return (zxbcdt[..., :di], zxbcdt[..., di:2 * di + 2 * gn],
            zxbcdt[..., 2 * di + 2 * gn:])


def _split_xbc(cfg: ArchConfig, xbc, heads=None):
    """xBC [..., hl·P + 2·G·N] -> x [..., hl, P], B and C [..., G, N]
    (`heads` hl: the x channels this block holds, default all)."""
    n, g = cfg.ssm_state, cfg.ssm_groups
    hl = cfg.ssm_heads if heads is None else heads
    xw = hl * cfg.ssm_head_dim
    shape = xbc.shape[:-1]
    return (xbc[..., :xw].reshape(*shape, hl, cfg.ssm_head_dim),
            xbc[..., xw:xw + g * n].reshape(*shape, g, n),
            xbc[..., xw + g * n:].reshape(*shape, g, n))


def _expand_groups(cfg: ArchConfig, m, h0=0, h1=None):
    """[..., G, N] -> [..., H, N], each group repeated for its heads; with
    h0 / h1, heads h0 .. h1 - 1 only (from the groups they lie in)."""
    r = cfg.ssm_heads // cfg.ssm_groups
    if h1 is None:
        return torch.repeat_interleave(m, r, dim=-2)
    g0, g1 = h0 // r, (h1 - 1) // r + 1
    return torch.repeat_interleave(m[..., g0:g1, :], r, dim=-2)[
        ..., h0 - g0 * r:h1 - g0 * r, :]


def ssd_chunked(cfg: ArchConfig, x, b_mat, c_mat, a, state0=None):
    """The SSD core.  x [B, S, H, P]; b / c [B, S, H, N]; a [B, S, H]
    (negative).  Returns (y [B, S, H, P] in x's dtype, the final state
    [B, H, P, N] fp32).  S must be a multiple of the chunk min(ssm_chunk,
    S).  Heads are independent: H may be any block of them."""
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


def _mixer(cfg: ArchConfig, p, z, xbc, dt_raw, h0=0, norm=None):
    """The layer between in_proj and out_proj, on plain tensors of the hl
    heads h0 .. h0 + hl - 1: z [B, S, hl·P], xbc [B, S, hl·P + 2·G·N] (the
    heads' x channels, then B and C), dt_raw [B, S, hl]; `p` the small
    leaves cut to them (conv_w / conv_b to xbc's channels, A_log, D,
    dt_bias [hl], `scale` [hl·P]).  Returns the gated, normed y [B, S,
    hl·P]: `rms_norm`, or `norm(g, scale)` over a row split between
    ranks."""
    hl = dt_raw.shape[-1]
    whole = hl == cfg.ssm_heads
    xbc = F.silu(_causal_depthwise_conv(xbc, p["conv_w"], p["conv_b"]))
    x_ssm, b_mat, c_mat = _split_xbc(cfg, xbc, hl)
    heads = () if whole else (h0, h0 + hl)
    b_h = _expand_groups(cfg, b_mat, *heads)
    c_h = _expand_groups(cfg, c_mat, *heads)
    dt = F.softplus(dt_raw.to(torch.float32) + p["dt_bias"])  # [B, S, hl]
    a = -torch.exp(p["A_log"]) * dt  # negative
    xdt = x_ssm.to(torch.float32) * dt[..., None]
    y, _ = ssd_chunked(cfg, xdt.to(z.dtype), b_h, c_h, a)
    y = y.to(torch.float32) + p["D"][None, None, :, None] \
        * x_ssm.to(torch.float32)
    bsz, s = z.shape[:2]
    y = y.reshape(bsz, s, hl * cfg.ssm_head_dim).to(z.dtype)
    g = y * F.silu(z)
    return rms_norm(g, p["scale"]) if norm is None else norm(g, p["scale"])


def _small(lp):
    """The layer's small leaves, by `_mixer`'s names."""
    return {"conv_w": lp["conv_w"], "conv_b": lp["conv_b"],
            "A_log": lp["A_log"], "D": lp["D"], "dt_bias": lp["dt_bias"],
            "scale": lp["gate_norm"]["scale"]}


def _heads_split(cfg: ArchConfig, mesh) -> bool:
    """Whether the layer runs on each rank's own heads on `mesh`."""
    m = _model_size(mesh)
    return m > 1 and cfg.ssm_heads % m == 0


def _cut_to_heads(cfg: ArchConfig, p, h0: int, h1: int):
    """The small leaves `p` (local tensors) cut to heads h0 .. h1 - 1:
    the conv's x channels of those heads and its B and C channels."""
    di, _, _ = _split_dims(cfg)
    pd = cfg.ssm_head_dim

    def channels(t):
        return torch.cat([t[..., h0 * pd:h1 * pd], t[..., di:]], dim=-1)

    return {"conv_w": channels(p["conv_w"]), "conv_b": channels(p["conv_b"]),
            "A_log": p["A_log"][h0:h1], "D": p["D"][h0:h1],
            "dt_bias": p["dt_bias"][h0:h1],
            "scale": p["scale"][h0 * pd:h1 * pd]}


def _mix_on_heads(cfg: ArchConfig, mesh, lp, h_in):
    """The layer's mixer on this rank's heads (the module docstring):
    h_in [B, S, D] -> the gated, normed y [B, S, di], split over "model"
    by heads."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    di, gn, h = _split_dims(cfg)
    pd = cfg.ssm_head_dim
    m, i = _model_size(mesh), _model_index(mesh)
    hl = h // m
    h0 = int(mesh.get_local_rank(MODEL_AXIS)) * hl
    h_in = _whole_over_model(mesh, h_in)  # a "batch_seq" residual's gather
    w = lp["in_proj"]["w"].redistribute(mesh, [Replicate()] * mesh.ndim)

    def columns(a, b, unit):
        # the segment's columns, this rank's block of whole units (or all)
        seg = w[:, a:b]
        if (b - a) % unit == 0 and ((b - a) // unit) % m == 0:
            pl = [Replicate()] * mesh.ndim
            pl[i] = Shard(1)
            seg = seg.redistribute(mesh, pl).contiguous()
        return linear(h_in, {"w": seg}, unit=unit)

    z = columns(0, di, pd)
    xs = columns(di, 2 * di, pd)
    bc = _settle(mesh, columns(2 * di, 2 * di + 2 * gn, 2 * gn))
    dt = columns(2 * di + 2 * gn, 2 * di + 2 * gn + h, 1)
    xbc = torch.cat([_local_part(mesh, xs, z, True),
                     _local_part(mesh, bc, z, True)], dim=-1)
    p = _cut_to_heads(cfg, {k: _local_part(mesh, t, z, True, replica=True)
                            for k, t in _small(lp).items()}, h0, h0 + hl)
    group = mesh.get_group(MODEL_AXIS)
    y = _mixer(cfg, p, _local_part(mesh, z, z, True), xbc,
               _local_part(mesh, dt, z, True), h0,
               norm=lambda g, s: split_rms_norm(g, s, di, group))
    return DTensor.from_local(y, mesh, z.placements, shape=z.shape,
                              stride=z.stride())


def _as_dtensor(mesh, y, u, width: int):
    """y, the local [..., width] result of rows laid out as u's, as a
    DTensor in u's placements."""
    from torch.distributed.tensor import DTensor

    shape = tuple(u.shape[:-1]) + (width,)
    stride = tuple(math.prod(shape[d + 1:]) for d in range(len(shape)))
    return DTensor.from_local(y, mesh, u.placements, shape=shape,
                              stride=stride)


def _mix_whole(cfg: ArchConfig, mesh, lp, h_in):
    """The layer's mixer whole on every "model" rank (its batch rows):
    in_proj as the specs and `linear` split it, its output gathered."""
    u = _whole_over_model(mesh, _settle(mesh, linear(h_in, lp["in_proj"])))
    ul = _local_part(mesh, u, u, False)
    p = {k: _local_part(mesh, t, u, False, replica=True)
         for k, t in _small(lp).items()}
    y = _mixer(cfg, p, *_segments(cfg, ul))
    return _as_dtensor(mesh, y, u, cfg.ssm_inner)


def ssm_block(cfg: ArchConfig, lp, x):
    """One mamba2 layer on x [B, S, D] (a pre-norm residual block)."""
    h_in = apply_norm(cfg, x, lp["norm"])
    mesh = _mesh_of(h_in)
    if mesh is None:
        y = _mixer(cfg, _small(lp),
                   *_segments(cfg, linear(h_in, lp["in_proj"])))
    elif _heads_split(cfg, mesh):
        y = _mix_on_heads(cfg, mesh, lp, h_in)
    else:
        y = _mix_whole(cfg, mesh, lp, h_in)
    return x + _like(mesh, linear(y, lp["out_proj"]), x)


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


def _decode_mix(cfg: ArchConfig, lp, z, xbc, dt_raw, conv_state, state,
                span=None, gather=None, reduce=None):
    """One token's recurrent step between in_proj and the gated norm, on
    plain tensors: z [B, di], xbc [B, C] and dt_raw [B, H] whole;
    conv_state [B, K - 1, c1 - c0] (channels c0 .. c1 - 1 of C) and state
    [B, H, P, n1 - n0] (state dims n0 .. n1 - 1 of N), `span` ((c0, c1),
    (n0, n1)), both written IN PLACE.  `gather` makes the conv output
    whole over the channels, `reduce` sums y's partials over N (None:
    nothing split).  Returns the gated, normed y [B, di]."""
    (c0, c1), (n0, n1) = span or ((0, xbc.shape[-1]), (0, cfg.ssm_state))
    window = torch.cat([conv_state,
                        xbc[:, None, c0:c1].to(conv_state.dtype)],
                       dim=1)  # [B, K, c]
    conv_out = torch.einsum("bkc,kc->bc", window.to(torch.float32),
                            lp["conv_w"][:, c0:c1].to(torch.float32)) \
        + lp["conv_b"][c0:c1].to(torch.float32)
    conv_state.copy_(window[:, 1:])
    xbc = F.silu(conv_out).to(z.dtype)
    if gather is not None:
        xbc = gather(xbc)
    x_ssm, b_mat, c_mat = _split_xbc(cfg, xbc)
    b_h = _expand_groups(cfg, b_mat).to(torch.float32)[..., n0:n1]
    c_h = _expand_groups(cfg, c_mat).to(torch.float32)[..., n0:n1]
    dt = F.softplus(dt_raw.to(torch.float32) + lp["dt_bias"])  # [B, H]
    a = -torch.exp(lp["A_log"]) * dt
    xdt = x_ssm.to(torch.float32) * dt[..., None]  # [B, H, P]
    new = state * torch.exp(a)[:, :, None, None] \
        + torch.einsum("bhp,bhn->bhpn", xdt, b_h)
    state.copy_(new)
    y = torch.einsum("bhn,bhpn->bhp", c_h, new)
    if reduce is not None:
        y = reduce(y)
    y = y + lp["D"][None, :, None] * x_ssm.to(torch.float32)
    y = y.reshape(z.shape[0], cfg.ssm_inner).to(z.dtype)
    return rms_norm(y * F.silu(z), lp["gate_norm"]["scale"])


def _cache_span(mesh, placement, size: int):
    """(first, end) of this rank's part of a cache dim of `size` entries
    that `placement` splits over "model" (or all of it)."""
    if not placement.is_shard():
        return 0, size
    n = size // _model_size(mesh)
    r = int(mesh.get_local_rank(MODEL_AXIS))
    return r * n, (r + 1) * n


def _decode_on_mesh(cfg: ArchConfig, mesh, lp, h_in, conv_state, state,
                    conv_pl, state_pl):
    """`_decode_mix` on a mesh (the module docstring): in_proj
    column-parallel and its [B, F] output gathered, the conv on this
    rank's channels of the window shard, the state's N-slice updated in
    place, y's partial sums all-reduced over "model"."""
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor import DTensor, Replicate, Shard

    i = _model_index(mesh)
    # the stacked caches' placements: conv [L, B, K-1, C], state [L, B, H,
    # P, N]
    if (conv_pl[i] not in (Replicate(), Shard(3))
            or state_pl[i] not in (Replicate(), Shard(4))):
        raise NotImplementedError(
            f"SSM decode on a mesh takes the conv window split over its "
            f"channels and the state over N, or whole over 'model'; got "
            f"{conv_pl} and {state_pl}")
    u = _whole_over_model(mesh, _settle(mesh, linear(h_in, lp["in_proj"])))
    z, xbc, dt_raw = _segments(cfg, u.to_local())
    small = {k: tree_map(_local_value, lp[k]) for k in (
        "conv_w", "conv_b", "A_log", "D", "dt_bias", "gate_norm")}
    span = (_cache_span(mesh, conv_pl[i], xbc.shape[-1]),
            _cache_span(mesh, state_pl[i], cfg.ssm_state))
    group = mesh.get_group(MODEL_AXIS)
    gather = reduce = None
    if conv_pl[i].is_shard():
        pl = list(u.placements)
        pl[i] = Shard(1)

        def gather(t):
            whole = list(u.placements)
            whole[i] = Replicate()
            return DTensor.from_local(
                t, mesh, pl, shape=(u.shape[0], xbc.shape[-1]),
                stride=(xbc.shape[-1], 1)).redistribute(
                mesh, whole).to_local()
    if state_pl[i].is_shard():
        def reduce(t):
            return funcol.wait_tensor(funcol.all_reduce(t, "sum", group))
    y = _decode_mix(cfg, small, z, xbc, dt_raw, conv_state, state, span,
                    gather, reduce)
    return _as_dtensor(mesh, y, u, cfg.ssm_inner)


def ssm_decode_block(cfg: ArchConfig, lp, x1, conv_state, state,
                     placements=None):
    """One token's recurrent step through one layer: x1 [B, D], conv_state
    [B, K - 1, C], state [B, H, P, N] (on a mesh their local shards,
    split as `placements` (conv's, state's) say) -> x1 + out; the conv
    window and the state are written IN PLACE."""
    h_in = apply_norm(cfg, x1, lp["norm"])
    mesh = _mesh_of(h_in)
    if mesh is None:
        y = _decode_mix(cfg, lp, *_segments(cfg, linear(h_in, lp["in_proj"])),
                        conv_state, state)
    else:
        y = _decode_on_mesh(cfg, mesh, lp, h_in, conv_state, state,
                            *placements)
    return x1 + _like(mesh, linear(y, lp["out_proj"]), x1)


def decode_ssm_layers(cfg: ArchConfig, stacked, x, conv, state, first=0):
    """x [B, D] through the stacked layers [E, ...], whose conv windows and
    states are rows first .. first + E - 1 of `conv` / `state` (updated in
    place; on a mesh, their local shards)."""
    pls = None
    if _mesh_of(x) is not None:
        pls = (tuple(conv.placements), tuple(state.placements))
    conv, state = _local_value(conv), _local_value(state)
    for i, lp in enumerate(layer_params(stacked)):
        x = ssm_decode_block(cfg, lp, x, conv[first + i], state[first + i],
                             pls)
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
