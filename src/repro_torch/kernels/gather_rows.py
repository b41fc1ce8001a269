"""Row gather out of a stacked table: the CUDA kernel's launcher and its
plain PyTorch version.

    out[k, :] = tbl[idx[k], :]        tbl [M, D] fp32, idx [K] int64

The kernel is `csrc/gather_rows.cu` (it replaces the Pallas TPU kernel
`repro.kernels.gather_rows.gather_rows_blocks`).  The plain version is
fancy indexing, the reference's own oracle: the gather is a pure copy, so
kernel and plain version agree bit for bit.  Use
`repro_torch.kernels.ops.gather_rows`, which validates the inputs and picks
between the two by the tensors' device.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build


def gather_rows_plain(tbl: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """tbl [M, D], idx [K] int64 -> [K, D]."""
    return tbl[idx]


def _library() -> ctypes.CDLL:
    lib = _build.load("gather_rows")
    fn = lib.gather_rows_f32
    # without argtypes ctypes would pass each Python int as a 32-bit int
    # and cut the pointers
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 3 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def gather_rows_cuda(tbl: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream.  The caller validated
    the inputs: contiguous CUDA tensors on one device, tbl fp32, idx
    int64."""
    m, d = tbl.shape
    k = idx.shape[0]
    out = torch.empty((k, d), dtype=torch.float32, device=tbl.device)
    lib = _library()
    with torch.cuda.device(tbl.device):
        stream = torch.cuda.current_stream(tbl.device).cuda_stream
        err = lib.gather_rows_f32(tbl.data_ptr(), idx.data_ptr(),
                                  out.data_ptr(), m, k, d, stream)
    if err != 0:
        raise RuntimeError(f"gather_rows_f32 launch failed: cudaError {err} "
                           f"(M={m}, K={k}, D={d})")
    return out
