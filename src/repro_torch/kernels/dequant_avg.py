"""Fused int8 dequantize + weighted neighbour average, for one receiver and
for a block of receivers: the CUDA kernels' launchers and their plain
PyTorch versions.

    out[:]    = Σ_n ws[n] · float(q[n, :])        q [N, D] int8, ws [N] fp32
    out[r, :] = Σ_n ws[r, n] · float(q[n, :])     ws [R, N] fp32

The kernels are `csrc/dequant_avg.cu` and `csrc/dequant_avg_rows.cu` (they
replace the Pallas TPU kernels `repro.kernels.dequant_avg.
dequant_avg_blocks` and `dequant_avg_rows_blocks`).  Each plain version
loops over n with a separate multiply and add per step, which is its
kernel's arithmetic in its kernel's order, so on the card the two agree bit
for bit; the two kernels add the senders in one order, so the one-receiver
average is bitwise row r of the block's whenever the weights equal its row
r.  Use `repro_torch.kernels.ops.dequant_neighbor_avg` and
`ops.dequant_neighbor_avg_rows`, which fold the per-sender scales into the
weights, validate the inputs and pick between kernel and plain version by
the tensors' device.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build


def dequant_avg_rows_plain(q: torch.Tensor, ws: torch.Tensor) -> torch.Tensor:
    """q [N, D] int8, ws [R, N] fp32 -> [R, D] fp32."""
    n, d = q.shape
    acc = torch.zeros((ws.shape[0], d), dtype=torch.float32, device=q.device)
    for j in range(n):
        acc = acc + ws[:, j:j + 1] * q[j].to(torch.float32)
    return acc


def _library() -> ctypes.CDLL:
    lib = _build.load("dequant_avg_rows")
    fn = lib.dequant_avg_rows_f32
    # without argtypes ctypes would pass each Python int as a 32-bit int
    # and cut the pointers
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 3 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def dequant_avg_rows_cuda(q: torch.Tensor, ws: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream.  The caller validated
    the inputs: contiguous CUDA tensors on one device, q int8, ws fp32."""
    n, d = q.shape
    r = ws.shape[0]
    out = torch.empty((r, d), dtype=torch.float32, device=q.device)
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.dequant_avg_rows_f32(q.data_ptr(), ws.data_ptr(),
                                       out.data_ptr(), n, r, d, stream)
    if err != 0:
        raise RuntimeError(f"dequant_avg_rows_f32 launch failed: cudaError "
                           f"{err} (N={n}, R={r}, D={d})")
    return out


def dequant_avg_plain(q: torch.Tensor, ws: torch.Tensor) -> torch.Tensor:
    """q [N, D] int8, ws [N] fp32 -> [D] fp32."""
    n, d = q.shape
    acc = torch.zeros((d,), dtype=torch.float32, device=q.device)
    for j in range(n):
        acc = acc + ws[j] * q[j].to(torch.float32)
    return acc


def _single_library() -> ctypes.CDLL:
    lib = _build.load("dequant_avg")
    fn = lib.dequant_avg_f32
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 2 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def dequant_avg_cuda(q: torch.Tensor, ws: torch.Tensor) -> torch.Tensor:
    """Launch the one-receiver CUDA kernel on the current stream.  The
    caller validated the inputs: contiguous CUDA tensors on one device, q
    int8, ws fp32."""
    n, d = q.shape
    out = torch.empty((d,), dtype=torch.float32, device=q.device)
    lib = _single_library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.dequant_avg_f32(q.data_ptr(), ws.data_ptr(), out.data_ptr(),
                                  n, d, stream)
    if err != 0:
        raise RuntimeError(f"dequant_avg_f32 launch failed: cudaError {err} "
                           f"(N={n}, D={d})")
    return out
