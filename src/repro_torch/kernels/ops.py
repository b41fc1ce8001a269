"""Public wrappers of the port's kernels.

Each wrapper validates its inputs, then dispatches by the tensors' device:
a CPU tensor takes the kernel's plain PyTorch version, a CUDA tensor takes
the hand-written kernel — and a kernel that fails to build or launch
raises; it never falls back to the plain version.  Every kernel launch
adds one to the wrapper's entry in `LAUNCHES`, so a run can show that its
main path went through the kernel.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.kernels import decdiff_update as _dd
from repro_torch.kernels import decode_attention as _da
from repro_torch.kernels import dequant_avg as _dq
from repro_torch.kernels import gather_rows as _gr
from repro_torch.kernels import neighbor_avg as _na
from repro_torch.kernels import segment_avg as _sa
from repro_torch.kernels import vt_kl_loss as _vt
from repro_torch.utils.pytree import tree_leaves, tree_unflatten_like

#: kernel launches per wrapper since the last `reset_launches()`
#: (`vt_kl_loss` counts its forward and backward kernels apart, and so do
#: its vocab-parallel forms `vt_kl_partial_fwd` and `vt_kl_shard_bwd`;
#: `decode_scores_partial` and `decode_softmax_combine` are the split-hd
#: decode attention's two kernels, the latter counting its split kernel
#: and merge as one, as `decode_attention_fused` counts its own; and
#: `decdiff_update` one per Eq. 5 update: pass A over every leaf, the
#: scale kernel and pass B over every leaf; `drift_norms` one per call of
#: Eq. 5's pass A and scale kernel alone)
LAUNCHES: Dict[str, int] = {"segment_neighbor_avg": 0, "gather_rows": 0,
                            "dequant_neighbor_avg_rows": 0,
                            "vt_kl_loss_fwd": 0, "vt_kl_loss_bwd": 0,
                            "decode_attention_fused": 0,
                            "decdiff_update": 0, "neighbor_avg": 0,
                            "dequant_segment_neighbor_avg": 0,
                            "dequant_neighbor_avg": 0, "drift_norms": 0,
                            "vt_kl_partial_fwd": 0, "vt_kl_shard_bwd": 0,
                            "decode_scores_partial": 0,
                            "decode_softmax_combine": 0}


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


def dequant_segment_neighbor_avg(q: torch.Tensor, scales: torch.Tensor,
                                 w: torch.Tensor) -> torch.Tensor:
    """Ragged dequantize-and-reduce over int8 payload panels.

    q [B, K, D] int8 slot-padded wire payloads (any int8 wherever w is 0),
    scales [B, K] fp32 per-slot dequantization scales, w [B, K] fp32 gossip
    weights -> sums [B, D] fp32, Σ_k (w_k·s_k)·q_k per receiver, with ws =
    w·scales formed here as the reference's wrapper forms it.  Sums only:
    the totals come from `segment_neighbor_avg`.  Bitwise invariant to row
    blocking and to zero-weight K padding (see
    `repro_torch.kernels.segment_avg`).  No engine path calls it: (w·s)·q
    associates differently from the fp32 route's w·(s·q), so on a round it
    would break the bitwise equality of the two wires of one exchange and
    of the dense and sparse layouts."""
    if q.dim() != 3 or tuple(scales.shape) != tuple(q.shape[:2]) \
            or tuple(w.shape) != tuple(q.shape[:2]):
        raise ValueError(f"dequant_segment_neighbor_avg wants q [B, K, D], "
                         f"scales and w [B, K]; got {tuple(q.shape)}, "
                         f"{tuple(scales.shape)} and {tuple(w.shape)}")
    if q.dtype != torch.int8 or scales.dtype != torch.float32 \
            or w.dtype != torch.float32:
        raise TypeError(f"dequant_segment_neighbor_avg wants int8 q and "
                        f"float32 scales and w; got {q.dtype}, "
                        f"{scales.dtype} and {w.dtype}")
    if not (q.device == scales.device == w.device):
        raise ValueError(f"q on {q.device}, scales on {scales.device}, w on "
                         f"{w.device}")
    if not q.is_contiguous():
        raise ValueError("dequant_segment_neighbor_avg wants a contiguous q")
    ws = (w * scales).contiguous()
    if _device_kind(q, "dequant_segment_neighbor_avg") == "cpu":
        return _sa.dequant_segment_avg_plain(q, ws)
    out = _sa.dequant_segment_avg_cuda(q, ws)
    LAUNCHES["dequant_segment_neighbor_avg"] += 1
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


def _neighbor_avg(stacked: torch.Tensor, w: torch.Tensor,
                  normalize: bool) -> torch.Tensor:
    if stacked.dim() != 2 or tuple(w.shape) != (stacked.shape[0],):
        raise ValueError(f"neighbor_avg wants stacked [N, D] and weights [N]; "
                         f"got {tuple(stacked.shape)} and {tuple(w.shape)}")
    if stacked.dtype != torch.float32 or w.dtype != torch.float32:
        raise TypeError(f"neighbor_avg wants float32; got {stacked.dtype} and "
                        f"{w.dtype}")
    if stacked.device != w.device:
        raise ValueError(f"stacked on {stacked.device} but weights on "
                         f"{w.device}")
    if not (stacked.is_contiguous() and w.is_contiguous()):
        raise ValueError("neighbor_avg wants contiguous tensors")
    if _device_kind(stacked, "neighbor_avg") == "cpu":
        return _na.neighbor_avg_plain(stacked, w, normalize)
    out = _na.neighbor_avg_cuda(stacked, w, normalize)
    LAUNCHES["neighbor_avg"] += 1
    return out


def neighbor_avg_normalized(stacked: torch.Tensor,
                            wn: torch.Tensor) -> torch.Tensor:
    """Σ_n wn[n] · stacked[n, :] for weights the caller already normalized
    (the gated forms divide by a safe total, so that a receiver that heard
    from nobody gets 0, not NaN): stacked [N, D] fp32, wn [N] fp32 -> [D]
    fp32 (see `repro_torch.kernels.neighbor_avg`)."""
    return _neighbor_avg(stacked, wn, False)


def neighbor_avg(stacked: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Eq. 6: the (w / Σw)-weighted average of the stacked [N, D] fp32 rows,
    as the reference's wrapper normalizes -> [D] fp32.  The sum (in n
    order) and the division happen inside the one kernel launch (see
    `repro_torch.kernels.neighbor_avg`)."""
    w = weights if weights.dtype == torch.float32 \
        else weights.to(torch.float32)
    return _neighbor_avg(stacked, w.contiguous(), True)


def dequant_neighbor_avg(q: torch.Tensor, scales: torch.Tensor,
                         weights: torch.Tensor) -> torch.Tensor:
    """Eq. 6 for one receiver over int8 payloads, fused: q [N, D] int8 (the
    neighbours' wire payloads), scales [N] fp32 per-row dequantization
    scales, weights [N] (normalized here, w / Σw, as the reference's
    wrapper normalizes) -> [D] fp32, the average of the dequantized rows
    without materializing them.  ws = (w / Σw)·scales, so the result is
    bitwise row r of `dequant_neighbor_avg_rows` given the same normalized
    row (see `repro_torch.kernels.dequant_avg`)."""
    if q.dim() != 2 or tuple(scales.shape) != (q.shape[0],) \
            or tuple(weights.shape) != (q.shape[0],):
        raise ValueError(f"dequant_neighbor_avg wants q [N, D], scales and "
                         f"weights [N]; got {tuple(q.shape)}, "
                         f"{tuple(scales.shape)} and {tuple(weights.shape)}")
    if q.dtype != torch.int8 or scales.dtype != torch.float32:
        raise TypeError(f"dequant_neighbor_avg wants int8 q and float32 "
                        f"scales; got {q.dtype} and {scales.dtype}")
    if not (q.device == scales.device == weights.device):
        raise ValueError(f"q on {q.device}, scales on {scales.device}, "
                         f"weights on {weights.device}")
    if not q.is_contiguous():
        raise ValueError("dequant_neighbor_avg wants a contiguous q")
    w = weights.to(torch.float32)
    ws = ((w / torch.sum(w)) * scales).contiguous()
    if _device_kind(q, "dequant_neighbor_avg") == "cpu":
        return _dq.dequant_avg_plain(q, ws)
    out = _dq.dequant_avg_cuda(q, ws)
    LAUNCHES["dequant_neighbor_avg"] += 1
    return out


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


def _check_vt_shard(logits, labels, offset: int, vocab: int, name: str):
    if logits.dim() != 2 or labels.dim() != 1 \
            or labels.shape[0] != logits.shape[0]:
        raise ValueError(f"{name} wants logits [B, V] and labels [B]; got "
                         f"{tuple(logits.shape)} and {tuple(labels.shape)}")
    if logits.dtype not in (torch.float32, torch.bfloat16) \
            or labels.dtype != torch.int64:
        raise TypeError(f"{name} wants float32 or bfloat16 logits and int64 "
                        f"labels; got {logits.dtype} and {labels.dtype}")
    if vocab < 2 or offset < 0 or offset + logits.shape[1] > vocab \
            or logits.shape[1] < 2:
        raise ValueError(f"{name}: a shard of {logits.shape[1]} columns at "
                         f"{offset} does not fit a vocabulary of {vocab}")
    if logits.device != labels.device:
        raise ValueError(f"logits on {logits.device} but labels on "
                         f"{labels.device}")
    if not (logits.is_contiguous() and labels.is_contiguous()):
        raise ValueError(f"{name} wants contiguous tensors")
    return _device_kind(logits, name)


def vt_partial_stats(logits: torch.Tensor, labels: torch.Tensor, offset: int,
                     vocab: int) -> Tuple[torch.Tensor, ...]:
    """The vocab-parallel forward of B.3 on one shard: logits [B, V] (the
    columns [offset, offset + V) of `vocab`), labels [B] int64 in the whole
    vocabulary -> per row (max, Σexp(z - max), Σz, z_c or 0), fp32 [B]
    each (`kernels.vt_kl_loss.vt_combine` merges the shards')."""
    kind = _check_vt_shard(logits, labels, offset, vocab, "vt_partial_stats")
    if kind == "cpu":
        return _vt.vt_partial_plain(logits, labels, offset)
    out = _vt.vt_partial_cuda(logits, labels, offset, vocab)
    LAUNCHES["vt_kl_partial_fwd"] += 1
    return out


def vt_shard_backward(logits: torch.Tensor, labels: torch.Tensor,
                      offset: int, mx: torch.Tensor, sumexp: torch.Tensor,
                      g: torch.Tensor, beta: float,
                      vocab: int) -> torch.Tensor:
    """B.3's backward on one shard's columns, from the merged row
    statistics (max, Σexp) and the row gradients g [B] fp32."""
    kind = _check_vt_shard(logits, labels, offset, vocab,
                           "vt_shard_backward")
    mx, sumexp, g = (t.to(torch.float32).contiguous()
                     for t in (mx, sumexp, g))
    if kind == "cpu":
        return _vt.vt_shard_backward_plain(logits, labels, offset, mx,
                                           sumexp, g, beta, vocab)
    dz = _vt.vt_shard_backward_cuda(logits, labels, offset, mx, sumexp, g,
                                    beta, vocab)
    LAUNCHES["vt_kl_shard_bwd"] += 1
    return dz


def _all_reduce(t: torch.Tensor, op: str, group) -> torch.Tensor:
    import torch.distributed._functional_collectives as funcol

    return funcol.wait_tensor(funcol.all_reduce(t, op, group))


class _VTKLVocabParallel(torch.autograd.Function):
    """Per-row VT KL over logits split by columns over `group`: partial
    statistics, an all-reduce of the max, one of the rescaled sums, then
    the KL; the backward needs no communication."""

    @staticmethod
    def forward(ctx, z, labels, offset, vocab, beta, neg_h, group):
        mx, sumexp, zsum, zc = vt_partial_stats(z, labels, offset, vocab)
        m = _all_reduce(mx, "max", group)
        stats = _all_reduce(torch.stack([sumexp * torch.exp(mx - m), zsum,
                                         zc]), "sum", group)
        s, zs, zcs = stats.unbind(0)
        ctx.save_for_backward(z, labels, m, s)
        ctx.args = (offset, vocab, beta)
        return _vt.vt_kl_from_stats(m, s, zs, zcs, beta, neg_h, vocab)

    @staticmethod
    def backward(ctx, g):
        z, labels, m, s = ctx.saved_tensors
        offset, vocab, beta = ctx.args
        return (vt_shard_backward(z, labels, offset, m, s, g, beta, vocab),
                None, None, None, None, None, None)


def vt_kl_loss_vocab_parallel(logits: torch.Tensor, labels: torch.Tensor,
                              beta: float, neg_h: float, offset: int,
                              vocab: int, group) -> torch.Tensor:
    """`vt_kl_loss` on a shard of the columns: logits [B, V] the columns
    [offset, offset + V) of `vocab`, the other shards on the ranks of the
    process group `group` -> kl [B] fp32 (the same on every shard),
    differentiable in the shard's logits."""
    _check_vt_shard(logits, labels, offset, vocab,
                    "vt_kl_loss_vocab_parallel")
    return _VTKLVocabParallel.apply(logits, labels, int(offset), int(vocab),
                                    float(beta), float(neg_h), group)


def vt_kl_loss_fused(logits: torch.Tensor, labels: torch.Tensor,
                     beta: float = 0.95) -> torch.Tensor:
    """Mean KL(p_t || softmax(logits)) over the batch — Eq. 8 — as the JAX
    package's entry point of this name: logits [B, V] fp32 or bf16, labels
    [B] of any integer dtype -> a scalar, differentiable in `logits`
    through `vt_kl_loss`'s forward and backward kernels."""
    # here, not at the top: core.virtual_teacher imports this module
    from repro_torch.core.virtual_teacher import vt_kl_loss as vt_mean

    if logits.dim() != 2:
        raise ValueError(f"vt_kl_loss_fused wants logits [B, V]; got "
                         f"{tuple(logits.shape)}")
    return vt_mean(logits, labels, beta=beta)


def decode_attention_fused(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           slot_pos: torch.Tensor, pos: torch.Tensor,
                           window: int = 0) -> torch.Tensor:
    """One-token GQA attention over a ring KV cache: score, mask, softmax
    and combine, fused.

    q [B, H, hd] and k / v [B, W, K, hd] in bfloat16 or float32 (k and v
    alike), slot_pos [W] int32 absolute positions (−1: empty), pos a 0-d
    int32 tensor (the new token's position, read on the device) -> [B, H,
    hd] fp32.  A slot takes part iff 0 ≤ slot_pos ≤ pos, and slot_pos >
    pos − window when `window` > 0; H must be a multiple of K.  Any B and
    W, no padding (see `repro_torch.kernels.decode_attention`)."""
    if q.dim() != 3 or k.dim() != 4 or tuple(v.shape) != tuple(k.shape) \
            or slot_pos.dim() != 1 or pos.dim() != 0:
        raise ValueError(f"decode_attention_fused wants q [B, H, hd], k / v "
                         f"[B, W, K, hd], slot_pos [W] and a 0-d pos; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}, {tuple(slot_pos.shape)} and "
                         f"{tuple(pos.shape)}")
    b, h, hd = q.shape
    if k.shape[0] != b or k.shape[3] != hd or k.shape[1] == 0 \
            or slot_pos.shape[0] != k.shape[1] or k.shape[2] == 0 \
            or h % k.shape[2]:
        raise ValueError(f"decode_attention_fused: q {tuple(q.shape)} does "
                         f"not fit k {tuple(k.shape)} and slot_pos "
                         f"{tuple(slot_pos.shape)}")
    floats = (torch.float32, torch.bfloat16)
    if q.dtype not in floats or k.dtype not in floats or v.dtype != k.dtype \
            or slot_pos.dtype != torch.int32 or pos.dtype != torch.int32:
        raise TypeError(f"decode_attention_fused wants float32 or bfloat16 q "
                        f"and k / v (alike) and int32 slot_pos and pos; got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}, {slot_pos.dtype} "
                        f"and {pos.dtype}")
    if not (q.device == k.device == v.device == slot_pos.device
            == pos.device):
        raise ValueError(f"decode_attention_fused: q on {q.device}, k on "
                         f"{k.device}, v on {v.device}, slot_pos on "
                         f"{slot_pos.device}, pos on {pos.device}")
    if not all(t.is_contiguous() for t in (q, k, v, slot_pos)):
        raise ValueError("decode_attention_fused wants contiguous tensors")
    window = int(window or 0)
    if _device_kind(q, "decode_attention_fused") == "cpu":
        return _da.decode_attention_plain(q, k, v, slot_pos, pos, window)
    if hd not in _da.HEAD_DIMS or h // k.shape[2] > _da.MAX_GROUP:
        raise ValueError(f"decode_attention_fused: the kernel takes hd in "
                         f"{_da.HEAD_DIMS} and at most {_da.MAX_GROUP} query "
                         f"heads per KV head; got hd={hd}, H={h}, "
                         f"K={k.shape[2]}")
    if k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("decode_attention_fused: the kernel wants k and v "
                         "16-byte aligned")
    out = _da.decode_attention_cuda(q, k, v, slot_pos, pos, window)
    LAUNCHES["decode_attention_fused"] += 1
    return out


def _check_split_decode(q, k, name):
    if q.dim() != 3 or k.dim() != 4 or k.shape[0] != q.shape[0] \
            or k.shape[3] != q.shape[2] or k.shape[2] == 0 \
            or q.shape[1] % k.shape[2]:
        raise ValueError(f"{name} wants q [B, H, hdl] and k / v [B, W, K, "
                         f"hdl] with K dividing H; got {tuple(q.shape)} and "
                         f"{tuple(k.shape)}")
    floats = (torch.float32, torch.bfloat16)
    if q.dtype not in floats or k.dtype not in floats:
        raise TypeError(f"{name} wants float32 or bfloat16 tensors; got "
                        f"{q.dtype} and {k.dtype}")
    if q.device != k.device:
        raise ValueError(f"{name}: q on {q.device}, k on {k.device}")
    if not (q.is_contiguous() and k.is_contiguous()):
        raise ValueError(f"{name} wants contiguous tensors")
    return _device_kind(q, name)


def decode_scores_partial(q: torch.Tensor, k: torch.Tensor,
                          scale: float) -> torch.Tensor:
    """The split-hd decode attention's first kernel: q [B, H, hdl] and a
    ring k [B, W, K, hdl] holding a shard's hd columns -> scale · q·k over
    them, [B, H, W] fp32, to be summed over the shards."""
    if _check_split_decode(q, k, "decode_scores_partial") == "cpu":
        return _da.scores_partial_plain(q, k, scale)
    out = _da.scores_partial_cuda(q, k, scale)
    LAUNCHES["decode_scores_partial"] += 1
    return out


def decode_softmax_combine(scores: torch.Tensor, v: torch.Tensor,
                           slot_pos: torch.Tensor, pos: torch.Tensor,
                           window: int = 0) -> torch.Tensor:
    """The split-hd decode attention's second kernel: scores [B, H, W]
    fp32 (summed over the shards), v [B, W, K, hdl], slot_pos [W] and pos
    0-d int32 -> softmax over the live slots (those of
    `decode_attention_fused`) · v, [B, H, hdl] fp32."""
    if scores.dim() != 3 or v.dim() != 4 or slot_pos.dim() != 1 \
            or pos.dim() != 0 or v.shape[0] != scores.shape[0] \
            or v.shape[1] != scores.shape[2] \
            or slot_pos.shape[0] != scores.shape[2] or v.shape[2] == 0 \
            or scores.shape[1] % v.shape[2]:
        raise ValueError(f"decode_softmax_combine wants scores [B, H, W], v "
                         f"[B, W, K, hdl] with K dividing H, slot_pos [W] "
                         f"and a 0-d pos; got {tuple(scores.shape)}, "
                         f"{tuple(v.shape)}, {tuple(slot_pos.shape)} and "
                         f"{tuple(pos.shape)}")
    if scores.dtype != torch.float32 \
            or v.dtype not in (torch.float32, torch.bfloat16) \
            or slot_pos.dtype != torch.int32 or pos.dtype != torch.int32:
        raise TypeError(f"decode_softmax_combine wants fp32 scores, float32 "
                        f"or bfloat16 v and int32 slot_pos and pos; got "
                        f"{scores.dtype}, {v.dtype}, {slot_pos.dtype} and "
                        f"{pos.dtype}")
    if not (scores.device == v.device == slot_pos.device == pos.device):
        raise ValueError("decode_softmax_combine: its tensors lie on "
                         "different devices")
    if not all(t.is_contiguous() for t in (scores, v, slot_pos)):
        raise ValueError("decode_softmax_combine wants contiguous tensors")
    _device_kind(v, "decode_softmax_combine")
    window = int(window or 0)
    if scores.device.type == "cpu":
        return _da.softmax_combine_plain(scores, v, slot_pos, pos, window)
    if v.shape[3] > 64:
        raise ValueError(f"decode_softmax_combine: the kernel takes at most "
                         f"64 head dims a shard; got {v.shape[3]}")
    kk, g = v.shape[2], scores.shape[1] // v.shape[2]
    cols = 0 if _da.combine_by_head(g, v.shape[3]) else \
        _da.combine_columns(kk, g, v.shape[3])[2]
    if max(cols, kk * g) > _da.SPLIT_THREADS:
        raise ValueError(f"decode_softmax_combine: the kernel takes at most "
                         f"{_da.SPLIT_THREADS} heads and {_da.SPLIT_THREADS} "
                         f"columns (kv head, query group, head-dim run) a "
                         f"slot; got {kk * g} and {cols} (K={kk}, G={g}, "
                         f"hdl={v.shape[3]})")
    out = _da.softmax_combine_cuda(scores, v, slot_pos, pos, window)
    LAUNCHES["decode_softmax_combine"] += 1
    return out


def decdiff_rows(xs: Sequence[torch.Tensor], avgs: Sequence[torch.Tensor],
                 gate: Optional[torch.Tensor], s: float) -> List[torch.Tensor]:
    """The paper's Eq. 5 for a block of R nodes over a list of leaves.

    xs: leaves [R, ...] (float32 or bfloat16; row r = node r's model),
    avgs: like-shaped float32 neighbourhood averages, gate: [R] float32 or
    None (a row whose gate is not > 0 keeps its model: scale 0), s: the
    damping.  One distance per row over all its leaves ->
    x + (a − x) / (‖a − x‖ + s) per leaf, as new tensors in the leaves'
    dtypes (see `repro_torch.kernels.decdiff_update`)."""
    xs, avgs = list(xs), list(avgs)
    if not xs or len(xs) != len(avgs):
        raise ValueError(f"decdiff_rows wants as many averages as leaves "
                         f"(at least one); got {len(xs)} and {len(avgs)}")
    r = xs[0].shape[0] if xs[0].dim() else None
    for x, a in zip(xs, avgs):
        if x.dim() == 0 or tuple(x.shape) != tuple(a.shape) \
                or x.shape[0] != r:
            raise ValueError(f"decdiff_rows wants leaves [R, ...] with R = "
                             f"{r} and averages of the same shape; got "
                             f"{tuple(x.shape)} and {tuple(a.shape)}")
        if x.dtype not in (torch.float32, torch.bfloat16) \
                or a.dtype != torch.float32:
            raise TypeError(f"decdiff_rows wants float32 or bfloat16 leaves "
                            f"and float32 averages; got {x.dtype} and "
                            f"{a.dtype}")
        if not (x.is_contiguous() and a.is_contiguous()):
            raise ValueError("decdiff_rows wants contiguous tensors")
    if gate is not None and (tuple(gate.shape) != (r,)
                             or gate.dtype != torch.float32
                             or not gate.is_contiguous()):
        raise ValueError(f"decdiff_rows wants a contiguous float32 gate [{r}]; "
                         f"got {gate.dtype} {tuple(gate.shape)}")
    dev = xs[0].device
    if any(t.device != dev for t in xs + avgs) or (
            gate is not None and gate.device != dev):
        raise ValueError("decdiff_rows: the leaves, averages and gate are on "
                         "more than one device")
    if _device_kind(xs[0], "decdiff_rows") == "cpu":
        return _dd.decdiff_rows_plain(xs, avgs, gate, s)
    out = _dd.decdiff_rows_cuda(xs, avgs, gate, s)
    LAUNCHES["decdiff_update"] += 1
    return out


def drift_norms(x: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Per-row distance ‖x[r] − ref[r]‖₂: x, ref [R, D] contiguous float32
    -> [R] float32 (the event trigger's drift).  On the card it is Eq. 5's
    sum of squares (pass A and the scale kernel), whose per-row sum does
    not depend on R (see `repro_torch.kernels.decdiff_update`)."""
    if x.dim() != 2 or tuple(x.shape) != tuple(ref.shape):
        raise ValueError(f"drift_norms wants x and ref [R, D] of one shape; "
                         f"got {tuple(x.shape)} and {tuple(ref.shape)}")
    if x.dtype != torch.float32 or ref.dtype != torch.float32:
        raise TypeError(f"drift_norms wants float32; got {x.dtype} and "
                        f"{ref.dtype}")
    if x.device != ref.device:
        raise ValueError(f"x on {x.device} but ref on {ref.device}")
    if not (x.is_contiguous() and ref.is_contiguous()):
        raise ValueError("drift_norms wants contiguous tensors")
    if _device_kind(x, "drift_norms") == "cpu":
        return _dd.drift_norms_plain(x, ref)
    if x.shape[0] == 0:
        return torch.zeros((0,), dtype=torch.float32, device=x.device)
    out = _dd.drift_norms_cuda(x, ref)
    LAUNCHES["drift_norms"] += 1
    return out


def decdiff_update(w_flat: torch.Tensor, wbar_flat: torch.Tensor,
                   s: float = 1.0) -> torch.Tensor:
    """Eq. 5 on one flat model: w + (w̄ − w) / (‖w̄ − w‖ + s) in w's dtype
    (the reference wrapper's form; w̄ is read as float32)."""
    if w_flat.dim() != 1 or tuple(wbar_flat.shape) != tuple(w_flat.shape):
        raise ValueError(f"decdiff_update wants two flat vectors of one "
                         f"length; got {tuple(w_flat.shape)} and "
                         f"{tuple(wbar_flat.shape)}")
    a = wbar_flat.to(torch.float32).contiguous()[None]
    (out,) = decdiff_rows([w_flat.contiguous()[None]], [a], None, s)
    return out[0]


def decdiff_update_tree(params, avg_params, s: float = 1.0):
    """Eq. 5 on one model given as a tree: one distance over every leaf,
    each leaf updated in its own dtype (the reference wrapper's form)."""
    leaves = tree_leaves(params)
    xs = [t.contiguous().reshape(1, -1) for t in leaves]
    avgs = [t.to(torch.float32).contiguous().reshape(1, -1)
            for t in tree_leaves(avg_params)]
    outs = decdiff_rows(xs, avgs, None, s)
    return tree_unflatten_like(
        params, [o.reshape(t.shape) for o, t in zip(outs, leaves)])
