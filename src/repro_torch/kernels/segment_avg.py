"""Ragged segment neighbour reduces: the CUDA kernels' launchers and their
plain PyTorch versions.

    sums[b] = Σ_k w[b, k] · vals[b, k, :]      tot[b] = Σ_k w[b, k]
    sums[b] = Σ_k ws[b, k] · float(q[b, k, :])      (int8 payloads)

The kernels are `csrc/segment_avg.cu` and `csrc/dequant_segment_avg.cu`
(they replace the Pallas TPU kernels `repro.kernels.segment_avg.
segment_avg_chunk` and `dequant_segment_avg_chunk`).  Each plain version
loops over k in Python with a separate multiply and add per step, which is
its kernel's arithmetic in its kernel's order, so on the card the two
agree bit for bit.  All of them contract every row on its own and
accumulate over k in order from +0, which makes the result invariant to
row blocking and to zero-weight K padding (a zero weight adds ±0, even
against finite garbage).  Use `repro_torch.kernels.ops.
segment_neighbor_avg` and `ops.dequant_segment_neighbor_avg`, which
validate the inputs and pick between kernel and plain version by the
tensors' device.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import _build


def segment_avg_plain(vals: torch.Tensor,
                      w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """vals [B, K, D] f32, w [B, K] f32 -> (sums [B, D], tot [B])."""
    b, k, d = vals.shape
    acc = torch.zeros((b, d), dtype=torch.float32, device=vals.device)
    tot = torch.zeros((b,), dtype=torch.float32, device=vals.device)
    for j in range(k):
        acc = acc + w[:, j, None] * vals[:, j, :]
        tot = tot + w[:, j]
    return acc, tot


def _library() -> ctypes.CDLL:
    lib = _build.load("segment_avg")
    fn = lib.segment_avg_f32
    # without argtypes ctypes would pass each Python int as a 32-bit int
    # and cut the pointers
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 3 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def segment_avg_cuda(vals: torch.Tensor,
                     w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel on the current stream.  The caller validated
    the inputs: contiguous fp32 CUDA tensors on one device."""
    b, k, d = vals.shape
    sums = torch.empty((b, d), dtype=torch.float32, device=vals.device)
    tot = torch.empty((b,), dtype=torch.float32, device=vals.device)
    lib = _library()
    with torch.cuda.device(vals.device):
        stream = torch.cuda.current_stream(vals.device).cuda_stream
        err = lib.segment_avg_f32(vals.data_ptr(), w.data_ptr(),
                                  sums.data_ptr(), tot.data_ptr(), b, k, d,
                                  stream)
    if err != 0:
        raise RuntimeError(f"segment_avg_f32 launch failed: cudaError {err} "
                           f"(B={b}, K={k}, D={d})")
    return sums, tot


def dequant_segment_avg_plain(q: torch.Tensor,
                              ws: torch.Tensor) -> torch.Tensor:
    """q [B, K, D] int8, ws [B, K] f32 -> sums [B, D] f32."""
    b, k, d = q.shape
    acc = torch.zeros((b, d), dtype=torch.float32, device=q.device)
    for j in range(k):
        acc = acc + ws[:, j, None] * q[:, j, :].to(torch.float32)
    return acc


def _dequant_library() -> ctypes.CDLL:
    lib = _build.load("dequant_segment_avg")
    fn = lib.dequant_segment_avg_f32
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 3 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def dequant_segment_avg_cuda(q: torch.Tensor,
                             ws: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream.  The caller validated
    the inputs: contiguous CUDA tensors on one device, q int8, ws fp32."""
    b, k, d = q.shape
    sums = torch.empty((b, d), dtype=torch.float32, device=q.device)
    lib = _dequant_library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.dequant_segment_avg_f32(q.data_ptr(), ws.data_ptr(),
                                          sums.data_ptr(), b, k, d, stream)
    if err != 0:
        raise RuntimeError(f"dequant_segment_avg_f32 launch failed: cudaError "
                           f"{err} (B={b}, K={k}, D={d})")
    return sums
