"""One-token GQA attention over a ring KV cache: the CUDA kernel's launcher
and its plain PyTorch version.

    s[b, kh, g, w] = q[b, kh·G + g] · k[b, w, kh] / √hd     (fp32)
    s = -1e30 where slot w is masked;  out = softmax_w(s) · v   (fp32)

A slot takes part iff 0 ≤ slot_pos[w] ≤ pos, and, when `window` > 0,
slot_pos[w] > pos − window (the reference layer's sliding-window clause).
The kernel is `csrc/decode_attention.cu` (it replaces the Pallas TPU kernel
`repro.kernels.decode_attention.decode_attention_blocks`): split-W flash
decoding over K/V tiles that TMA stages in shared memory, scores from
tensor cores (bf16 k) or CUDA cores (fp32 k), an online softmax per tile,
merged over the splits by a second kernel.  The splits come from
`plan_splits`, a pure function of the card's SMs and the instance's
resident blocks per SM.  It sums in another order than the plain version,
so the two agree to a tolerance, not bitwise.  Use `repro_torch.kernels.
ops.decode_attention_fused`, which validates the inputs and picks between
the two by the tensors' device.

The split-hd form, for a cache split over a mesh's "model" axis along hd
(`csrc/decode_attention_split.cu`): `scores_partial_*` give the scaled
partial scores [B, H, W] fp32 over the local hd columns, which the caller
sums over the shards (an all-reduce), and `softmax_combine_*` mask them,
take the softmax and combine the local hd columns of v.
"""
from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import _build

#: the head dims the kernel is built for, and the widest query group
HEAD_DIMS = (16, 32, 64, 80, 128)
MAX_GROUP = 8
#: the least share of its last wave that a plan fills, where one can
MIN_WAVE_FILL = 0.9

#: (device, kv bf16, hd, group width, K) -> (slots per tile, resident
#: blocks per SM, SMs, KV heads per block), from the library; and the
#: splits per shape on top of it
_PLANS: Dict[tuple, Tuple[int, int, int, int]] = {}
_SPLITS: Dict[tuple, Tuple[int, int, int]] = {}
_LIB: Optional[ctypes.CDLL] = None
_SPLIT_LIB: Optional[ctypes.CDLL] = None


def decode_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           slot_pos: torch.Tensor, pos: torch.Tensor,
                           window: int = 0) -> torch.Tensor:
    """q [B, H, hd], k / v [B, W, K, hd], slot_pos [W], pos 0-d -> [B, H, hd]
    fp32 (mirrors the reference's `kernels/ref.py:decode_attention_ref`)."""
    b, h, hd = q.shape
    kk = k.shape[2]
    qg = q.to(torch.float32).reshape(b, kk, h // kk, hd)
    s = torch.einsum("bkgd,bwkd->bkgw", qg, k.to(torch.float32)) \
        * (1.0 / math.sqrt(hd))
    ok = (slot_pos >= 0) & (slot_pos <= pos)
    if window > 0:
        ok = ok & (slot_pos > pos - window)
    s = torch.where(ok[None, None, None, :], s, -1e30)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgw,bwkd->bkgd", p, v.to(torch.float32))
    return out.reshape(b, h, hd)


def _library() -> ctypes.CDLL:
    """The kernel's library, its functions' argtypes set once, at load."""
    global _LIB
    if _LIB is None:
        lib = _build.load("decode_attention")
        # q, q_bf16, k, v, kv_bf16, slot_pos, pos, window, B, W, K, G, HD,
        # S, sps, scale, part_acc, part_ml, out, stream
        lib.decode_attention_f32.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p] + [
                ctypes.c_int64] * 8 + [ctypes.c_float] + [
                    ctypes.c_void_p] * 4
        lib.decode_attention_f32.restype = ctypes.c_int
        # kv_bf16, HD, G, K, out[4]
        lib.decode_attention_plan.argtypes = [
            ctypes.c_int, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p]
        lib.decode_attention_plan.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def group_width(g: int) -> int:
    """The kernel instance's query group: G rounded up to 1, 2, 4 or 8."""
    return 1 if g <= 1 else 2 if g <= 2 else 4 if g <= 4 else 8


def plan_splits(b: int, kk: int, w: int, tile: int, sms: int,
                per_sm: int) -> Tuple[int, int]:
    """(S, slots per split) for B·K·S blocks over W slots in tiles of
    `tile`: every split a whole number of tiles and none empty (S·sps ≥ W >
    (S − 1)·sps), and the fewest splits whose blocks fill their last wave
    (of `sms`·`per_sm` resident blocks) to at least `MIN_WAVE_FILL`; where
    no split count reaches that, the count that fills it best (the fewest
    among equals)."""
    resident = sms * per_sm
    ntiles = -(-w // tile)
    best, best_fill = None, -1.0
    seen = set()
    for want in range(1, ntiles + 1):
        tps = -(-ntiles // want)  # tiles per split
        s = -(-ntiles // tps)
        if s in seen:
            continue
        seen.add(s)
        blocks = b * kk * s
        fill = blocks / (-(-blocks // resident) * resident)
        if fill >= MIN_WAVE_FILL:
            return s, tps * tile
        if fill > best_fill:
            best, best_fill = (s, tps * tile), fill
    return best


def splits(device: torch.device, b: int, kk: int, w: int, hd: int, g: int,
           kv_bf16: bool) -> Tuple[int, int, int]:
    """(S, slots per split, slots per tile) of a launch, from the
    library's plan for this instance on `device` (asked once) and
    `plan_splits` over its B·(K / heads per block) block rows (once per
    shape)."""
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    key = (idx, bool(kv_bf16), hd, group_width(g), kk, b, w)
    got = _SPLITS.get(key)
    if got is None:
        pkey = key[:5]
        plan = _PLANS.get(pkey)
        if plan is None:
            out = (ctypes.c_int64 * 4)()
            with torch.cuda.device(idx):
                err = _library().decode_attention_plan(
                    int(kv_bf16), hd, group_width(g), kk,
                    ctypes.addressof(out))
            if err != 0:
                raise RuntimeError(f"decode_attention_plan failed: cudaError "
                                   f"{err} (hd={hd}, G={g}, K={kk}, kv_bf16="
                                   f"{kv_bf16})")
            plan = _PLANS[pkey] = tuple(int(x) for x in out)
        tile, per_sm, sms, kpb = plan
        got = _SPLITS[key] = (*plan_splits(b, kk // kpb, w, tile, sms,
                                           per_sm), tile)
    return got


def decode_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          slot_pos: torch.Tensor, pos: torch.Tensor,
                          window: int = 0) -> torch.Tensor:
    """Launch the split kernel and the merge on the current stream.  The
    caller validated the inputs: contiguous CUDA tensors on one device, q
    and k / v bf16 or fp32 with k and v alike, slot_pos [W] and pos 0-d
    int32, hd in `HEAD_DIMS`, H / K ≤ `MAX_GROUP`, k and v 16-byte
    aligned.  The scratch and the output share one allocation; the output
    is a view of its tail."""
    b, h, hd = q.shape
    w, kk = k.shape[1], k.shape[2]
    kv_bf16 = k.dtype == torch.bfloat16
    s, sps, _ = splits(q.device, b, kk, w, hd, h // kk, kv_bf16)
    n_acc, n_ml = b * h * s * hd, b * h * s * 2
    buf = torch.empty((n_acc + n_ml + b * h * hd,), dtype=torch.float32,
                      device=q.device)
    base = buf.data_ptr()
    err = _build.launch(
        q.device, _library().decode_attention_f32, q.data_ptr(),
        int(q.dtype == torch.bfloat16), k.data_ptr(), v.data_ptr(),
        int(kv_bf16), slot_pos.data_ptr(), pos.data_ptr(), int(window), b, w,
        kk, h // kk, hd, s, sps, 1.0 / math.sqrt(hd), base, base + 4 * n_acc,
        base + 4 * (n_acc + n_ml))
    if err != 0:
        raise RuntimeError(f"decode_attention_f32 launch failed: cudaError "
                           f"{err} (B={b}, H={h}, W={w}, K={kk}, hd={hd}, "
                           f"splits={s}x{sps})")
    return buf[n_acc + n_ml:].view(b, h, hd)


def scores_partial_plain(q: torch.Tensor, k: torch.Tensor,
                         scale: float) -> torch.Tensor:
    """q [B, H, hdl], k [B, W, K, hdl] (a shard's hd columns) -> scale ·
    q·k over those columns, [B, H, W] fp32."""
    b, h, hd = q.shape
    kk = k.shape[2]
    qg = q.to(torch.float32).reshape(b, kk, h // kk, hd)
    s = torch.einsum("bkgd,bwkd->bkgw", qg, k.to(torch.float32)) * scale
    return s.reshape(b, h, k.shape[1])


def softmax_combine_plain(scores: torch.Tensor, v: torch.Tensor,
                          slot_pos: torch.Tensor, pos: torch.Tensor,
                          window: int = 0) -> torch.Tensor:
    """scores [B, H, W] (summed over the shards), v [B, W, K, hdl] ->
    softmax over the live slots · v, [B, H, hdl] fp32 (the masking of
    `decode_attention_plain`)."""
    b, h, w = scores.shape
    kk = v.shape[2]
    ok = (slot_pos >= 0) & (slot_pos <= pos)
    if window > 0:
        ok = ok & (slot_pos > pos - window)
    s = torch.where(ok[None, None, :], scores, -1e30)
    p = torch.softmax(s, dim=-1).reshape(b, kk, h // kk, w)
    out = torch.einsum("bkgw,bwkd->bkgd", p, v.to(torch.float32))
    return out.reshape(b, h, v.shape[-1])


def _split_library() -> ctypes.CDLL:
    global _SPLIT_LIB
    if _SPLIT_LIB is None:
        lib = _build.load("decode_attention_split")
        # q, q_bf16, k, kv_bf16, s, B, W, K, G, hdl, scale, stream
        lib.decode_scores_partial.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_void_p] + [ctypes.c_int64] * 5 + [ctypes.c_float,
                                                        ctypes.c_void_p]
        lib.decode_scores_partial.restype = ctypes.c_int
        # s, v, kv_bf16, slot_pos, pos, window, out, B, W, K, G, hdl, stream
        lib.decode_softmax_combine.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p] + [
                ctypes.c_int64] * 5 + [ctypes.c_void_p]
        lib.decode_softmax_combine.restype = ctypes.c_int
        _SPLIT_LIB = lib
    return _SPLIT_LIB


def scores_partial_cuda(q: torch.Tensor, k: torch.Tensor,
                        scale: float) -> torch.Tensor:
    """Launch the partial-score kernel on the current stream (contiguous
    CUDA tensors, validated by the caller)."""
    b, h, hd = q.shape
    w, kk = k.shape[1], k.shape[2]
    s = torch.empty((b, h, w), dtype=torch.float32, device=q.device)
    err = _build.launch(
        q.device, _split_library().decode_scores_partial, q.data_ptr(),
        int(q.dtype == torch.bfloat16), k.data_ptr(),
        int(k.dtype == torch.bfloat16), s.data_ptr(), b, w, kk, h // kk, hd,
        scale)
    if err != 0:
        raise RuntimeError(f"decode_scores_partial launch failed: cudaError "
                           f"{err} (B={b}, H={h}, W={w}, K={kk}, hdl={hd})")
    return s


def softmax_combine_cuda(scores: torch.Tensor, v: torch.Tensor,
                         slot_pos: torch.Tensor, pos: torch.Tensor,
                         window: int = 0) -> torch.Tensor:
    """Launch the mask / softmax / p·v kernel on the current stream."""
    b, h, w = scores.shape
    kk, hd = v.shape[2], v.shape[3]
    out = torch.empty((b, h, hd), dtype=torch.float32, device=v.device)
    err = _build.launch(
        v.device, _split_library().decode_softmax_combine,
        scores.data_ptr(), v.data_ptr(), int(v.dtype == torch.bfloat16),
        slot_pos.data_ptr(), pos.data_ptr(), int(window), out.data_ptr(), b,
        w, kk, h // kk, hd)
    if err != 0:
        raise RuntimeError(f"decode_softmax_combine launch failed: cudaError "
                           f"{err} (B={b}, H={h}, W={w}, K={kk}, hdl={hd})")
    return out
