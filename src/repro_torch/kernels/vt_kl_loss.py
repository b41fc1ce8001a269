"""Fused virtual-teacher KL loss over the class axis: the CUDA kernels'
launchers, their plan and their plain PyTorch versions.

Per row b of logits z [B, V] with label c_b and a = (1-β)/(V-1):

    forward   KL_b = -H(p_t) - (β z_c + a (Σ_v z_v - z_c) - lse(z_b)),
              with the row's max and Σ exp(z - max) kept for the backward
    backward  dz_bv = (exp(z_bv - max_b) / Σexp_b - p_t(v)) · g_b,
              p_t(c_b) = β and a elsewhere, in the logits' dtype

The kernels are `csrc/vt_kl_loss.cu` (they replace the Pallas TPU kernels
`row_max`, `row_stats` and `vt_backward` of `repro.kernels.vt_kl_loss`).

Vocab-parallel forms, for logits split over a mesh's "model" axis (a shard
[B, V] holding the columns [offset, offset + V) of the whole vocabulary):
`vt_partial_*` give each row's partial statistics (max, Σexp(z - max), Σz
and z_c where the label falls in the shard, else 0), `vt_combine` merges
the shards' statistics as the all-reduces do (the max first, then the
rescaled sums), `vt_kl_from_stats` turns the merged ones into the KL, and
`vt_shard_backward_*` is the backward on the shard's columns.
`vt_plan` picks each unsplit launch's vector width, lanes per row and rows
per block from (V, dtype) and the pointers' alignment; `vt_shard_plan`
picks the vocab-parallel kernels' warps per row (forward) and CTAs per row
(backward) from (V, dtype) alone: they load 16-byte words at any width and
row phase, and give each lane its columns by index, so a shard's rows are
folded in the same order at every 16-byte phase.  Neither plan sees the
row count, so a row's summation order is the same in any call that holds
it.  The plain versions compute the same formulas with PyTorch reductions,
which sum in another order than the kernels, so on the card the two agree
to fp32 rounding.  Use `repro_torch.kernels.ops.vt_kl_loss`,
which validates the inputs, picks between the two by the tensors' device
and ties them together as one autograd function.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import torch

from repro_torch.kernels import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# The forward's tiers (csrc/vt_kl_loss.cu): a row of at most GROUP_BYTES
# takes a sub-warp of 2-32 lanes in blocks of GROUP_THREADS, each lane
# holding two vectors of it (a shorter butterfly than one), at most
# LOAD_BYTES; a longer row takes one CTA of a thread per 128 bytes of it,
# 64 to 256.
LOAD_BYTES = 32
GROUP_BYTES = 32 * LOAD_BYTES
GROUP_THREADS = 256
MIN_THREADS, MAX_THREADS = 64, 256


class VTPlan(NamedTuple):
    """One launch's shape: `vec_bytes` per load, `lanes` per row and
    `rows_per_block`."""
    vec_bytes: int
    lanes: int
    rows_per_block: int

    @property
    def threads(self) -> int:
        return self.lanes * self.rows_per_block


def _pow2_ceil(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def vt_plan(v: int, dtype: torch.dtype, align: int = 16) -> VTPlan:
    """The plan of a launch on rows of `v` logits of `dtype` whose pointers
    are all multiples of `align` bytes.  It takes no row count: each row's
    summation order then depends on (v, dtype) alone (and on the pointers'
    alignment, which a block of contiguous rows shares with the whole)."""
    if dtype not in _DTYPE_CODE:
        raise TypeError(f"vt_plan wants float32 or bfloat16 logits, got "
                        f"{dtype}")
    elt = torch.finfo(dtype).bits // 8
    if v < 2:
        raise ValueError(f"vt_plan wants at least 2 classes, got {v}")
    if align % elt:
        raise ValueError(f"logits at a {align}-byte alignment are not "
                         f"{elt}-byte elements")
    row_bytes = v * elt
    vec_bytes = next(w for w in (16, 8, 4, 2)
                     if w >= elt and row_bytes % w == 0 and align % w == 0)
    nvec = row_bytes // vec_bytes
    if row_bytes <= GROUP_BYTES:
        lanes = min(32, max(2, _pow2_ceil(-(-nvec // 2))))
        return VTPlan(vec_bytes, lanes, GROUP_THREADS // lanes)
    threads = min(MAX_THREADS, max(MIN_THREADS, _pow2_ceil(
        -(-row_bytes // 128))))
    return VTPlan(vec_bytes, threads, 1)


# The vocab-parallel kernels (csrc/vt_kl_loss.cu): CTAs of SPLIT_THREADS;
# a forward warp's lanes each hold a 16-byte chunk of a row a slot, 32 of
# them when a row is whole 16-byte words, else SPLIT_LANES (the last lane
# loads the word after its neighbour's chunk), SPLIT_STEP[dtype] slots a
# step; a backward thread takes SPLIT_BWD_WORDS 16-byte words of a row.
SPLIT_THREADS = 256
SPLIT_LANES = 31
SPLIT_STEP = {torch.float32: 2, torch.bfloat16: 3}
SPLIT_BWD_WORDS = 5
SPLIT_ROW_STEPS = 2  # the steps a row's lanes take at most, up to 8 warps


class VTShardPlan(NamedTuple):
    """The vocab-parallel launches' shape: `warps` a row in the forward
    (1, 2, 4 or 8; SPLIT_THREADS // 32 // warps rows a CTA) and
    `bwd_blocks` CTAs a row in the backward."""
    warps: int
    bwd_blocks: int

    @property
    def rows_per_block(self) -> int:
        return SPLIT_THREADS // 32 // self.warps


def shard_lanes(v: int, dtype: torch.dtype) -> int:
    """The forward's chunk-holding lanes a warp for rows of `v` columns."""
    return 32 if v * (torch.finfo(dtype).bits // 8) % 16 == 0 \
        else SPLIT_LANES


def vt_shard_plan(v: int, dtype: torch.dtype) -> VTShardPlan:
    """The vocab-parallel kernels' plan for a shard of `v` columns of
    `dtype`: the fewest warps (up to 8) whose lanes hold a row's 16-byte
    chunks in SPLIT_ROW_STEPS steps, and enough backward CTAs to cover the
    16-byte words a row spans at any phase.  It takes no row count and no
    alignment: each row's summation order depends on (v, dtype) alone."""
    if dtype not in _DTYPE_CODE:
        raise TypeError(f"vt_shard_plan wants float32 or bfloat16 logits, "
                        f"got {dtype}")
    if v < 2:
        raise ValueError(f"vt_shard_plan wants at least 2 columns, got {v}")
    chunks = -(-v * (torch.finfo(dtype).bits // 8) // 16)
    per_warp = shard_lanes(v, dtype) * SPLIT_STEP[dtype] * SPLIT_ROW_STEPS
    warps = min(8, _pow2_ceil(-(-chunks // per_warp)))
    bwd_blocks = -(-(chunks + 1) // (SPLIT_THREADS * SPLIT_BWD_WORDS))
    return VTShardPlan(warps, bwd_blocks)


def _align(*tensors: torch.Tensor) -> int:
    """The largest power of two up to 16 that divides every data pointer."""
    ptr = 0
    for t in tensors:
        ptr |= t.data_ptr()
    return 16 if ptr % 16 == 0 else ptr & -ptr


def teacher_tail(beta: float, vocab: int) -> float:
    """a = (1 - β) / (V - 1), the teacher's mass on each wrong class."""
    return (1.0 - beta) / (vocab - 1)


def vt_forward_plain(z: torch.Tensor, labels: torch.Tensor, beta: float,
                     neg_h: float
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """z [B, V] fp32/bf16, labels [B] int64, neg_h = -H(p_t) ->
    (kl [B], max [B], Σexp(z - max) [B]), all fp32."""
    z32 = z.to(torch.float32)
    a = teacher_tail(beta, z.shape[-1])
    mx = torch.amax(z32, dim=-1)
    sumexp = torch.sum(torch.exp(z32 - mx[:, None]), dim=-1)
    zsum = torch.sum(z32, dim=-1)
    zc = torch.gather(z32, -1, labels[:, None])[:, 0]
    lse = torch.log(sumexp) + mx
    cross = beta * zc + a * (zsum - zc) - lse
    return neg_h - cross, mx, sumexp


def vt_backward_plain(z: torch.Tensor, labels: torch.Tensor,
                      mx: torch.Tensor, sumexp: torch.Tensor,
                      g: torch.Tensor, beta: float) -> torch.Tensor:
    """(softmax(z) - p_t) · g per row, from the forward's row stats, in
    z's dtype."""
    a = teacher_tail(beta, z.shape[-1])
    p = torch.exp(z.to(torch.float32) - mx[:, None]) / sumexp[:, None]
    col = torch.arange(z.shape[-1], device=z.device)
    pt = torch.where(col[None, :] == labels[:, None], beta, a)
    return ((p - pt) * g[:, None]).to(z.dtype)


def vt_partial_plain(z: torch.Tensor, labels: torch.Tensor, offset: int
                     ) -> Tuple[torch.Tensor, ...]:
    """z [B, V] (the shard of columns [offset, offset + V)), labels [B]
    int64 in the whole vocabulary -> (max, Σexp(z - max), Σz, z_c or 0)
    [B] fp32."""
    z32 = z.to(torch.float32)
    mx = torch.amax(z32, dim=-1)
    sumexp = torch.sum(torch.exp(z32 - mx[:, None]), dim=-1)
    zsum = torch.sum(z32, dim=-1)
    loc = labels - offset
    ok = (loc >= 0) & (loc < z.shape[-1])
    zc = torch.gather(z32, -1, torch.where(ok, loc, 0)[:, None])[:, 0]
    return mx, sumexp, zsum, torch.where(ok, zc, torch.zeros_like(zc))


def vt_combine(mx: torch.Tensor, sumexp: torch.Tensor, zsum: torch.Tensor,
               zc: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """The shards' statistics, stacked [n, B], merged as the all-reduces
    merge them: M = max, S = Σ sumexp·exp(max - M), Σz and z_c summed."""
    m = torch.amax(mx, dim=0)
    return (m, torch.sum(sumexp * torch.exp(mx - m[None]), dim=0),
            torch.sum(zsum, dim=0), torch.sum(zc, dim=0))


def vt_kl_from_stats(mx, sumexp, zsum, zc, beta: float, neg_h: float,
                     vocab: int) -> torch.Tensor:
    """Each row's KL from its whole-vocabulary statistics."""
    a = teacher_tail(beta, vocab)
    lse = torch.log(sumexp) + mx
    return neg_h - (beta * zc + a * (zsum - zc) - lse)


def vt_shard_backward_plain(z: torch.Tensor, labels: torch.Tensor,
                            offset: int, mx: torch.Tensor,
                            sumexp: torch.Tensor, g: torch.Tensor,
                            beta: float, vocab: int) -> torch.Tensor:
    """(softmax(z) - p_t) · g on the shard's columns, from the merged row
    statistics, in z's dtype."""
    a = teacher_tail(beta, vocab)
    p = torch.exp(z.to(torch.float32) - mx[:, None]) / sumexp[:, None]
    col = torch.arange(z.shape[-1], device=z.device) + offset
    pt = torch.where(col[None, :] == labels[:, None], beta, a)
    return ((p - pt) * g[:, None]).to(z.dtype)


def _library() -> ctypes.CDLL:
    lib = _build.load("vt_kl_loss")
    # without argtypes ctypes would pass each Python int as a 32-bit int
    # and cut the pointers
    lib.vt_kl_fwd.argtypes = [ctypes.c_void_p, ctypes.c_int] \
        + [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 2 \
        + [ctypes.c_int] * 3 + [ctypes.c_float] * 3 + [ctypes.c_void_p]
    lib.vt_kl_fwd.restype = ctypes.c_int
    lib.vt_kl_bwd.argtypes = [ctypes.c_void_p, ctypes.c_int] \
        + [ctypes.c_void_p] * 5 + [ctypes.c_int64] * 2 + [ctypes.c_int] \
        + [ctypes.c_float] * 2 + [ctypes.c_void_p]
    lib.vt_kl_bwd.restype = ctypes.c_int
    lib.vt_kl_partial_fwd.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                      ctypes.c_void_p] \
        + [ctypes.c_int64] * 2 + [ctypes.c_void_p] * 4 \
        + [ctypes.c_int64] * 2 + [ctypes.c_int] + [ctypes.c_void_p]
    lib.vt_kl_partial_fwd.restype = ctypes.c_int
    lib.vt_kl_bwd_shard.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                    ctypes.c_void_p, ctypes.c_int64] \
        + [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 2 + [ctypes.c_int] \
        + [ctypes.c_float] * 2 + [ctypes.c_void_p]
    lib.vt_kl_bwd_shard.restype = ctypes.c_int
    return lib


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def vt_forward_cuda(z: torch.Tensor, labels: torch.Tensor, beta: float,
                    neg_h: float
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the forward kernel on the current stream, planned by
    `vt_plan`.  The caller validated the inputs: contiguous CUDA tensors on
    one device, z fp32 or bf16 [B, V] with V >= 2, labels int64 [B]."""
    b, v = z.shape
    plan = vt_plan(v, z.dtype, _align(z))
    kl, mx, sumexp = (torch.empty((b,), dtype=torch.float32, device=z.device)
                      for _ in range(3))
    lib = _library()
    with torch.cuda.device(z.device):
        err = lib.vt_kl_fwd(z.data_ptr(), _DTYPE_CODE[z.dtype],
                            labels.data_ptr(), kl.data_ptr(), mx.data_ptr(),
                            sumexp.data_ptr(), b, v, *plan, beta,
                            teacher_tail(beta, v), neg_h, _stream(z.device))
    if err != 0:
        raise RuntimeError(f"vt_kl_fwd launch failed: cudaError {err} "
                           f"(B={b}, V={v}, {z.dtype}, {plan})")
    return kl, mx, sumexp


def vt_backward_cuda(z: torch.Tensor, labels: torch.Tensor,
                     mx: torch.Tensor, sumexp: torch.Tensor, g: torch.Tensor,
                     beta: float) -> torch.Tensor:
    """Launch the backward kernel on the current stream (inputs as the
    forward's, plus contiguous fp32 row stats and row gradients g [B])."""
    b, v = z.shape
    dz = torch.empty_like(z)
    vec_bytes = vt_plan(v, z.dtype, _align(z, dz)).vec_bytes
    lib = _library()
    with torch.cuda.device(z.device):
        err = lib.vt_kl_bwd(z.data_ptr(), _DTYPE_CODE[z.dtype],
                            labels.data_ptr(), mx.data_ptr(),
                            sumexp.data_ptr(), g.data_ptr(), dz.data_ptr(), b,
                            v, vec_bytes, beta, teacher_tail(beta, v),
                            _stream(z.device))
    if err != 0:
        raise RuntimeError(f"vt_kl_bwd launch failed: cudaError {err} "
                           f"(B={b}, V={v}, {z.dtype}, {vec_bytes}-byte "
                           f"vectors)")
    return dz


def vt_partial_cuda(z: torch.Tensor, labels: torch.Tensor, offset: int,
                    vocab: int) -> Tuple[torch.Tensor, ...]:
    """Launch the partial-statistics forward on the current stream (inputs
    as `vt_forward_cuda`'s; the shard's columns start at `offset` of a
    `vocab`-wide row), planned by `vt_shard_plan`."""
    b, v = z.shape
    plan = vt_shard_plan(v, z.dtype)
    out = torch.empty((4, b), dtype=torch.float32, device=z.device)
    mx, sumexp, zsum, zc = out.unbind(0)
    lib = _library()
    with torch.cuda.device(z.device):
        err = lib.vt_kl_partial_fwd(
            z.data_ptr(), _DTYPE_CODE[z.dtype], labels.data_ptr(), offset,
            vocab, mx.data_ptr(), sumexp.data_ptr(), zsum.data_ptr(),
            zc.data_ptr(), b, v, plan.warps, _stream(z.device))
    if err != 0:
        raise RuntimeError(f"vt_kl_partial_fwd launch failed: cudaError "
                           f"{err} (B={b}, V={v} of {vocab} at {offset}, "
                           f"{z.dtype}, {plan})")
    return mx, sumexp, zsum, zc


def vt_shard_backward_cuda(z: torch.Tensor, labels: torch.Tensor,
                           offset: int, mx: torch.Tensor,
                           sumexp: torch.Tensor, g: torch.Tensor,
                           beta: float, vocab: int) -> torch.Tensor:
    """Launch the shard-local backward on the current stream, planned by
    `vt_shard_plan`."""
    b, v = z.shape
    dz = torch.empty_like(z)
    plan = vt_shard_plan(v, z.dtype)
    lib = _library()
    with torch.cuda.device(z.device):
        err = lib.vt_kl_bwd_shard(
            z.data_ptr(), _DTYPE_CODE[z.dtype], labels.data_ptr(), offset,
            mx.data_ptr(), sumexp.data_ptr(), g.data_ptr(), dz.data_ptr(), b,
            v, plan.bwd_blocks, beta, teacher_tail(beta, vocab),
            _stream(z.device))
    if err != 0:
        raise RuntimeError(f"vt_kl_bwd_shard launch failed: cudaError {err} "
                           f"(B={b}, V={v} of {vocab} at {offset}, "
                           f"{z.dtype}, {plan})")
    return dz
