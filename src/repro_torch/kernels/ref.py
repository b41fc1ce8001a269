"""Plain PyTorch oracles of the kernels, written from the formulas (the
counterparts of the JAX package's `repro.kernels.ref`).

They share no code with the kernels' plain versions, which repeat each
kernel's arithmetic in its order: these compute the same functions the
straightforward way, in fp32, and the tests hold both the kernels' plain
versions and the JAX oracles against them.  Nothing on the port's run
path imports this module.
"""
from __future__ import annotations

import torch


def decdiff_update_ref(w: torch.Tensor, wbar: torch.Tensor,
                       s: float = 1.0) -> torch.Tensor:
    """Eq. 5 on flat vectors: w + (wbar − w) / (‖wbar − w‖ + s), in w's
    dtype."""
    w32 = w.to(torch.float32)
    diff = wbar.to(torch.float32) - w32
    d = torch.sqrt(torch.sum(diff * diff))
    return (w32 + diff / (d + s)).to(w.dtype)


def _teacher(logits: torch.Tensor, labels: torch.Tensor, beta: float):
    z = logits.to(torch.float32)
    v = z.shape[-1]
    a = (1.0 - beta) / (v - 1)
    onehot = torch.nn.functional.one_hot(labels.to(torch.int64), v).to(
        torch.float32)
    return z, onehot * beta + (1.0 - onehot) * a


def vt_kl_loss_ref(logits: torch.Tensor, labels: torch.Tensor,
                   beta: float) -> torch.Tensor:
    """Eq. 8: mean KL(p_t ‖ softmax(z)) with the teacher materialized."""
    z, p_t = _teacher(logits, labels, beta)
    logp = torch.log_softmax(z, dim=-1)
    log_pt = torch.log(torch.clamp(p_t, min=1e-30))
    return torch.mean(torch.sum(p_t * (log_pt - logp), dim=-1))


def vt_kl_grad_ref(logits: torch.Tensor, labels: torch.Tensor,
                   beta: float) -> torch.Tensor:
    """d(mean KL)/d logits = (softmax(z) − p_t) / n_rows."""
    z, p_t = _teacher(logits, labels, beta)
    return (torch.softmax(z, dim=-1) - p_t) / z.shape[0]


def decode_attention_ref(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor, slot_pos: torch.Tensor,
                         pos) -> torch.Tensor:
    """One-token GQA attention over a ring cache, fp32: q [B, H, hd], k / v
    [B, W, K, hd], slot_pos [W] (−1 empty) -> [B, H, hd]."""
    q32 = q.to(torch.float32)
    b, h, hd = q32.shape
    kk = k_cache.shape[2]
    qg = q32.reshape(b, kk, h // kk, hd)
    s = torch.einsum("bkgd,bwkd->bkgw", qg,
                     k_cache.to(torch.float32)) * (1.0 / hd ** 0.5)
    ok = (slot_pos >= 0) & (slot_pos <= pos)
    s = torch.where(ok[None, None, None, :], s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgw,bwkd->bkgd", p, v_cache.to(torch.float32))
    return out.reshape(b, h, hd)


def neighbor_avg_ref(stacked: torch.Tensor,
                     weights: torch.Tensor) -> torch.Tensor:
    """Eq. 6 on a stacked [N, D] matrix: the normalized weighted average."""
    w = weights.to(torch.float32)
    w = w / torch.sum(w)
    return torch.einsum("n,nd->d", w, stacked.to(torch.float32))


def dequant_neighbor_avg_ref(q: torch.Tensor, scales: torch.Tensor,
                             weights: torch.Tensor) -> torch.Tensor:
    """Eq. 6 over int8 payloads: dequantize the rows, then average."""
    w = weights.to(torch.float32)
    w = w / torch.sum(w)
    dq = q.to(torch.float32) * scales.to(torch.float32)[:, None]
    return torch.einsum("n,nd->d", w, dq)


def dequant_neighbor_avg_rows_ref(q: torch.Tensor, scales: torch.Tensor,
                                  wn: torch.Tensor) -> torch.Tensor:
    """Eq. 6 for many receivers over int8 payloads: dequantize, then apply
    each receiver's (already normalized) weight row."""
    dq = q.to(torch.float32) * scales.to(torch.float32)[:, None]
    return torch.einsum("rn,nd->rd", wn.to(torch.float32), dq)
