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

from repro_torch.kernels import dequant_avg as _dq
from repro_torch.kernels import gather_rows as _gr
from repro_torch.kernels import segment_avg as _sa
from repro_torch.kernels import vt_kl_loss as _vt

#: kernel launches per wrapper since the last `reset_launches()`
#: (`vt_kl_loss` counts its forward and backward kernels apart)
LAUNCHES: Dict[str, int] = {"segment_neighbor_avg": 0, "gather_rows": 0,
                            "dequant_neighbor_avg_rows": 0,
                            "vt_kl_loss_fwd": 0, "vt_kl_loss_bwd": 0}


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


def _device_kind(t: torch.Tensor, name: str) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cpu (plain) or cuda (kernel); got "
                         f"{t.device}")
    return t.device.type


def dequant_neighbor_avg_rows(q: torch.Tensor, scale: torch.Tensor,
                              wn: torch.Tensor) -> torch.Tensor:
    """Eq. 6 for a block of receivers over int8 payloads, fused.

    q [N, D] int8 (every node's wire payload), scale [N] fp32 per-sender
    dequantization scales, wn [R, N] fp32 per-receiver gossip weights,
    already row-normalized by the caller (an all-zero row gives an
    all-zero average: the receiver heard from nobody) -> [R, D] fp32,
    `wn @ (q * scale[:, None])` without materializing the dequantized
    models.  The senders' scales fold into the weights, ws = wn ·
    scale[None, :], as the reference's wrapper folds them (see
    `repro_torch.kernels.dequant_avg`)."""
    if q.dim() != 2 or scale.dim() != 1 or wn.dim() != 2 \
            or scale.shape[0] != q.shape[0] or wn.shape[1] != q.shape[0]:
        raise ValueError(f"dequant_neighbor_avg_rows wants q [N, D], scale "
                         f"[N] and wn [R, N]; got {tuple(q.shape)}, "
                         f"{tuple(scale.shape)} and {tuple(wn.shape)}")
    if q.dtype != torch.int8 or scale.dtype != torch.float32 \
            or wn.dtype != torch.float32:
        raise TypeError(f"dequant_neighbor_avg_rows wants int8 q and float32 "
                        f"scale and wn; got {q.dtype}, {scale.dtype} and "
                        f"{wn.dtype}")
    if not (q.device == scale.device == wn.device):
        raise ValueError(f"q on {q.device}, scale on {scale.device}, wn on "
                         f"{wn.device}")
    if not q.is_contiguous():
        raise ValueError("dequant_neighbor_avg_rows wants a contiguous q")
    ws = (wn * scale[None, :]).contiguous()
    if _device_kind(q, "dequant_neighbor_avg_rows") == "cpu":
        return _dq.dequant_avg_rows_plain(q, ws)
    out = _dq.dequant_avg_rows_cuda(q, ws)
    LAUNCHES["dequant_neighbor_avg_rows"] += 1
    return out


class _VTKLLoss(torch.autograd.Function):
    """Per-row VT KL with its own backward: the plain versions on the CPU,
    the kernels on the card."""

    @staticmethod
    def forward(ctx, z, labels, beta, neg_h):
        if z.device.type == "cpu":
            kl, mx, sumexp = _vt.vt_forward_plain(z, labels, beta, neg_h)
        else:
            kl, mx, sumexp = _vt.vt_forward_cuda(z, labels, beta, neg_h)
            LAUNCHES["vt_kl_loss_fwd"] += 1
        ctx.save_for_backward(z, labels, mx, sumexp)
        ctx.beta = beta
        return kl

    @staticmethod
    def backward(ctx, g):
        z, labels, mx, sumexp = ctx.saved_tensors
        g = g.to(torch.float32).contiguous()
        if z.device.type == "cpu":
            dz = _vt.vt_backward_plain(z, labels, mx, sumexp, g, ctx.beta)
        else:
            dz = _vt.vt_backward_cuda(z, labels, mx, sumexp, g, ctx.beta)
            LAUNCHES["vt_kl_loss_bwd"] += 1
        return dz, None, None, None


def vt_kl_loss(logits: torch.Tensor, labels: torch.Tensor, beta: float,
               neg_h: float) -> torch.Tensor:
    """Per-row virtual-teacher KL (the paper's Eq. 8), differentiable in
    `logits`.

    logits [B, V] fp32 or bf16, labels [B] int64 in [0, V), beta the
    teacher's confidence, neg_h = -H(p_t) (`core.virtual_teacher.
    teacher_entropy`) -> kl [B] fp32.  Its gradient is (softmax(z) - p_t) ·
    g per row, in the logits' dtype.  Labels are not range-checked here
    (that would sync the card): the plain version's gather raises and the
    kernel traps on a label outside [0, V)."""
    if logits.dim() != 2 or labels.dim() != 1 \
            or labels.shape[0] != logits.shape[0]:
        raise ValueError(f"vt_kl_loss wants logits [B, V] and labels [B]; "
                         f"got {tuple(logits.shape)} and "
                         f"{tuple(labels.shape)}")
    if logits.dtype not in (torch.float32, torch.bfloat16) \
            or labels.dtype != torch.int64:
        raise TypeError(f"vt_kl_loss wants float32 or bfloat16 logits and "
                        f"int64 labels; got {logits.dtype} and "
                        f"{labels.dtype}")
    if logits.shape[1] < 2:
        raise ValueError("vt_kl_loss needs at least 2 classes")
    if logits.device != labels.device:
        raise ValueError(f"logits on {logits.device} but labels on "
                         f"{labels.device}")
    if not (logits.is_contiguous() and labels.is_contiguous()):
        raise ValueError("vt_kl_loss wants contiguous tensors")
    _device_kind(logits, "vt_kl_loss")
    return _VTKLLoss.apply(logits, labels, float(beta), float(neg_h))
