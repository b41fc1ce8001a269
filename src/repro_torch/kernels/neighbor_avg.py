"""Weighted neighbour-model average for one receiver (Eq. 6): the CUDA
kernel's launcher and its plain PyTorch version.

    out[:] = Σ_n w[n] · x[n, :]        x [N, D] fp32, w [N] fp32 normalized

The kernel is `csrc/neighbor_avg.cu` (it replaces the Pallas TPU kernel
`repro.kernels.neighbor_avg.neighbor_avg_blocks`).  The plain version loops
over n with a separate multiply and add per step, which is the kernel's
arithmetic in the kernel's order, so on the card the two agree bit for
bit.  Use `repro_torch.kernels.ops.neighbor_avg` (which normalizes the
weights) or `ops.neighbor_avg_normalized` (weights the caller already
normalized), which validate the inputs and pick between the two by the
tensors' device.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build


def neighbor_avg_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [N, D] f32, w [N] f32 -> [D] f32."""
    n, d = x.shape
    acc = torch.zeros((d,), dtype=torch.float32, device=x.device)
    for j in range(n):
        acc = acc + w[j] * x[j]
    return acc


def _library() -> ctypes.CDLL:
    lib = _build.load("neighbor_avg")
    fn = lib.neighbor_avg_f32
    # without argtypes ctypes would pass each Python int as a 32-bit int
    # and cut the pointers
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 2 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def neighbor_avg_cuda(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream.  The caller validated
    the inputs: contiguous fp32 CUDA tensors on one device."""
    n, d = x.shape
    out = torch.empty((d,), dtype=torch.float32, device=x.device)
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.neighbor_avg_f32(x.data_ptr(), w.data_ptr(), out.data_ptr(),
                                   n, d, stream)
    if err != 0:
        raise RuntimeError(f"neighbor_avg_f32 launch failed: cudaError {err} "
                           f"(N={n}, D={d})")
    return out
