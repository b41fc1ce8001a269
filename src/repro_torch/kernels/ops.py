"""Public wrappers of the port's kernels.

Each wrapper validates its inputs, then dispatches by the tensors' device:
a CPU tensor takes the kernel's plain PyTorch version, a CUDA tensor takes
the hand-written kernel — and a kernel that fails to build or launch
raises; it never falls back to the plain version.  Every kernel launch
adds one to the wrapper's entry in `LAUNCHES`, so a run can show that its
main path went through the kernel.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.kernels import segment_avg as _sa

#: kernel launches per wrapper since the last `reset_launches()`
LAUNCHES: Dict[str, int] = {"segment_neighbor_avg": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def segment_neighbor_avg(vals: torch.Tensor,
                         w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Ragged neighbour reduce: per-receiver (Σ_k w·vals, Σ_k w).

    vals [B, K, D] fp32 slot-padded neighbour rows (finite garbage allowed
    wherever w is 0), w [B, K] fp32 unnormalized gossip weights ->
    (sums [B, D], tot [B]).  Bitwise invariant to row blocking and to
    zero-weight K padding (see `repro_torch.kernels.segment_avg`)."""
    if vals.dim() != 3 or w.dim() != 2 or tuple(w.shape) != tuple(
            vals.shape[:2]):
        raise ValueError(f"segment_neighbor_avg wants vals [B, K, D] and w "
                         f"[B, K]; got {tuple(vals.shape)} and "
                         f"{tuple(w.shape)}")
    if vals.dtype != torch.float32 or w.dtype != torch.float32:
        raise TypeError(f"segment_neighbor_avg wants float32; got "
                        f"{vals.dtype} and {w.dtype}")
    if vals.device != w.device:
        raise ValueError(f"vals on {vals.device} but w on {w.device}")
    if not (vals.is_contiguous() and w.is_contiguous()):
        raise ValueError("segment_neighbor_avg wants contiguous tensors")
    if vals.device.type == "cpu":
        return _sa.segment_avg_plain(vals, w)
    if vals.device.type != "cuda":
        raise ValueError(f"segment_neighbor_avg runs on cpu (plain) or cuda "
                         f"(kernel); got {vals.device}")
    out = _sa.segment_avg_cuda(vals, w)
    LAUNCHES["segment_neighbor_avg"] += 1
    return out
