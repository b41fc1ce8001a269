"""Weighted neighbour-model average for one receiver (Eq. 6): the CUDA
kernel's launcher and its plain PyTorch version.

    total = ((0 + w[0]) + w[1]) + ... + w[N-1]     (normalize=True)
    out[:] = Σ_n (w[n] / total) · x[n, :]           x [N, D] fp32, w [N] fp32

The kernel is `csrc/neighbor_avg.cu` (it replaces the Pallas TPU kernel
`repro.kernels.neighbor_avg.neighbor_avg_blocks`); it normalizes the
weights itself, so `ops.neighbor_avg` is one launch.  The plain version
sums the weights in n order and divides in IEEE, then loops over n with a
separate multiply and add per step, which is the kernel's arithmetic in
the kernel's order, so on the card the two agree bit for bit.  Use
`repro_torch.kernels.ops.neighbor_avg` (raw weights) or
`ops.neighbor_avg_normalized` (weights the caller already normalized),
which validate the inputs and pick between the two by the tensors'
device.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build


def neighbor_avg_plain(x: torch.Tensor, w: torch.Tensor,
                       normalize: bool = False) -> torch.Tensor:
    """x [N, D] f32, w [N] f32 -> [D] f32; with `normalize`, w is first
    divided by its sum taken in n order from +0."""
    n, d = x.shape
    if normalize:
        total = torch.zeros((), dtype=torch.float32, device=w.device)
        for j in range(n):
            total = total + w[j]
        w = w / total
    acc = torch.zeros((d,), dtype=torch.float32, device=x.device)
    for j in range(n):
        acc = acc + w[j] * x[j]
    return acc


_LIB: Optional[ctypes.CDLL] = None


def _library() -> ctypes.CDLL:
    """The kernel's library, its function's argtypes set once, at load:
    without them ctypes would pass each Python int as a 32-bit int and cut
    the pointers."""
    global _LIB
    if _LIB is None:
        lib = _build.load("neighbor_avg")
        # x, w, out, N, D, normalize, stream
        lib.neighbor_avg_f32.argtypes = [ctypes.c_void_p] * 3 + [
            ctypes.c_int64] * 2 + [ctypes.c_int, ctypes.c_void_p]
        lib.neighbor_avg_f32.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def neighbor_avg_cuda(x: torch.Tensor, w: torch.Tensor,
                      normalize: bool = False) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream.  The caller validated
    the inputs: contiguous fp32 CUDA tensors on one device."""
    n, d = x.shape
    out = torch.empty((d,), dtype=torch.float32, device=x.device)
    err = _build.launch(x.device, _library().neighbor_avg_f32, x.data_ptr(),
                        w.data_ptr(), out.data_ptr(), n, d, int(normalize))
    if err != 0:
        raise RuntimeError(f"neighbor_avg_f32 launch failed: cudaError {err} "
                           f"(N={n}, D={d})")
    return out
