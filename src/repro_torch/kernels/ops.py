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

from repro_torch.kernels import gather_rows as _gr
from repro_torch.kernels import segment_avg as _sa

#: kernel launches per wrapper since the last `reset_launches()`
LAUNCHES: Dict[str, int] = {"segment_neighbor_avg": 0, "gather_rows": 0}


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


def gather_rows(tbl: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Row gather `tbl[idx]`: tbl [M, D] fp32, idx [K] int64 row ids ->
    [K, D].  A pure copy, bitwise equal to fancy indexing (see
    `repro_torch.kernels.gather_rows`).  Indices are not range-checked
    here (that would sync the card): the per-edge transport checks its
    static index once when it builds it, and the kernel traps on an index
    outside [0, M)."""
    if tbl.dim() != 2 or idx.dim() != 1:
        raise ValueError(f"gather_rows wants tbl [M, D] and idx [K]; got "
                         f"{tuple(tbl.shape)} and {tuple(idx.shape)}")
    if tbl.dtype != torch.float32 or idx.dtype != torch.int64:
        raise TypeError(f"gather_rows wants float32 tbl and int64 idx; got "
                        f"{tbl.dtype} and {idx.dtype}")
    if tbl.device != idx.device:
        raise ValueError(f"tbl on {tbl.device} but idx on {idx.device}")
    if not (tbl.is_contiguous() and idx.is_contiguous()):
        raise ValueError("gather_rows wants contiguous tensors")
    if tbl.shape[0] == 0 and idx.shape[0] > 0:
        raise ValueError("gather_rows: indices into an empty table")
    if tbl.device.type == "cpu":
        return _gr.gather_rows_plain(tbl, idx)
    if tbl.device.type != "cuda":
        raise ValueError(f"gather_rows runs on cpu (plain) or cuda (kernel); "
                         f"got {tbl.device}")
    out = _gr.gather_rows_cuda(tbl, idx)
    LAUNCHES["gather_rows"] += 1
    return out
