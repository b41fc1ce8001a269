"""One-token GQA attention over a ring KV cache: the CUDA kernel's launcher
and its plain PyTorch version.

    s[b, kh, g, w] = q[b, kh·G + g] · k[b, w, kh] / √hd     (fp32)
    s = -1e30 where slot w is masked;  out = softmax_w(s) · v   (fp32)

A slot takes part iff 0 ≤ slot_pos[w] ≤ pos, and, when `window` > 0,
slot_pos[w] > pos − window (the reference layer's sliding-window clause).
The kernel is `csrc/decode_attention.cu` (it replaces the Pallas TPU kernel
`repro.kernels.decode_attention.decode_attention_blocks`): split-W flash
decoding with an online softmax, merged over the splits by a second
kernel.  It sums in another order than the plain version, so the two agree
to a tolerance, not bitwise.  Use `repro_torch.kernels.ops.
decode_attention_fused`, which validates the inputs and picks between the
two by the tensors' device.
"""
from __future__ import annotations

import ctypes
import math
from typing import Dict

import torch

from repro_torch.kernels import _build

#: the head dims the kernel is built for, and the widest query group
HEAD_DIMS = (16, 32, 64, 128)
MAX_GROUP = 8
#: W-splits are sized so that about this many blocks per SM are launched
_BLOCKS_PER_SM = 16
_MIN_SLOTS_PER_SPLIT = 64

_SM_COUNT: Dict[int, int] = {}


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
    lib = _build.load("decode_attention")
    fn = lib.decode_attention_f32
    # q, q_bf16, k, v, kv_bf16, slot_pos, pos, window, B, W, K, G, HD, S,
    # sps, scale, part_acc, part_ml, out, stream
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p] + [ctypes.c_int64] * 8 + [
                       ctypes.c_float] + [ctypes.c_void_p] * 4
    fn.restype = ctypes.c_int
    return lib


def splits(device: torch.device, b: int, kk: int, w: int):
    """(S, slots per split): about `_BLOCKS_PER_SM` blocks per SM over the
    (b, kv-head) pairs, at least `_MIN_SLOTS_PER_SPLIT` slots a split, and
    no split empty."""
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    if idx not in _SM_COUNT:
        _SM_COUNT[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    want = -(-_BLOCKS_PER_SM * _SM_COUNT[idx] // max(b * kk, 1))
    s = max(1, min(want, -(-w // _MIN_SLOTS_PER_SPLIT)))
    sps = -(-w // s)
    return -(-w // sps), sps


def decode_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          slot_pos: torch.Tensor, pos: torch.Tensor,
                          window: int = 0) -> torch.Tensor:
    """Launch the split kernel and the merge on the current stream.  The
    caller validated the inputs: contiguous CUDA tensors on one device, q
    and k / v bf16 or fp32 with k and v alike, slot_pos [W] and pos 0-d
    int32, hd in `HEAD_DIMS`, H / K ≤ `MAX_GROUP`, k and v 16-byte
    aligned."""
    b, h, hd = q.shape
    w, kk = k.shape[1], k.shape[2]
    s, sps = splits(q.device, b, kk, w)
    part_acc = torch.empty((b, h, s, hd), dtype=torch.float32,
                           device=q.device)
    part_ml = torch.empty((b, h, s, 2), dtype=torch.float32, device=q.device)
    out = torch.empty((b, h, hd), dtype=torch.float32, device=q.device)
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.decode_attention_f32(
            q.data_ptr(), int(q.dtype == torch.bfloat16), k.data_ptr(),
            v.data_ptr(), int(k.dtype == torch.bfloat16), slot_pos.data_ptr(),
            pos.data_ptr(), int(window), b, w, kk, h // kk, hd, s, sps,
            1.0 / math.sqrt(hd), part_acc.data_ptr(), part_ml.data_ptr(),
            out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"decode_attention_f32 launch failed: cudaError "
                           f"{err} (B={b}, H={h}, W={w}, K={kk}, hd={hd}, "
                           f"splits={s}x{sps})")
    return out
