"""Virtual Teacher (VT) — the paper's Eq. (7) and Eq. (8), closed form.

    p_t(y) = beta                      if y == c (true class)
             (1 - beta) / (|L| - 1)    otherwise                     (Eq. 7)

and the loss is KL(p_t || p_model) (Eq. 8).  With logits z in R^V, true
class c and a = (1-beta)/(V-1):

    KL(p_t || p) = -H(p_t) - [ beta * z_c + a * (Σ_y z_y - z_c) - lse(z) ]

so three reductions over the class axis suffice (z_c, Σz, lse) and the
teacher distribution is never materialized.  Autograd gives the gradient
softmax(z) - p_t.

Node batching: logits are [..., B, V] and labels [..., B]; the losses
average over the batch axis B only, so [N, B, V] logits give one loss per
node ([N]) and [B, V] logits one scalar, as in the JAX package.
"""
from __future__ import annotations

import torch

DEFAULT_BETA = 0.95


def teacher_entropy(beta: float, num_classes: int) -> torch.Tensor:
    """H(p_t) for the virtual-teacher distribution of Eq. (7), in fp32."""
    beta_t = torch.tensor(beta, dtype=torch.float32)
    v = num_classes
    a = (1.0 - beta_t) / (v - 1)
    t1 = -torch.where(beta_t > 0,
                      beta_t * torch.log(torch.clamp(beta_t, min=1e-30)),
                      torch.zeros(()))
    t2 = -torch.where(a > 0, (v - 1) * a * torch.log(torch.clamp(a, min=1e-30)),
                      torch.zeros(()))
    return t1 + t2


def _true_class(z: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    idx = labels.to(torch.int64).expand(z.shape[:-1])
    return torch.gather(z, -1, idx[..., None])[..., 0]


def vt_kl_loss(logits: torch.Tensor, labels: torch.Tensor,
               beta: float = DEFAULT_BETA) -> torch.Tensor:
    """Mean KL(p_t || softmax(logits)) over the batch axis — Eq. (8)."""
    z = logits.to(torch.float32)
    v = z.shape[-1]
    a = (1.0 - beta) / (v - 1)
    lse = torch.logsumexp(z, dim=-1)
    z_sum = torch.sum(z, dim=-1)
    z_c = _true_class(z, labels)
    cross = beta * z_c + a * (z_sum - z_c) - lse  # Σ p_t log p
    h = float(teacher_entropy(beta, v))  # an exact fp32 value, host-side
    return torch.mean(-h - cross, dim=-1)


def cross_entropy_loss(logits: torch.Tensor,
                       labels: torch.Tensor) -> torch.Tensor:
    """Cross-entropy on hard labels, mean over the batch axis."""
    z = logits.to(torch.float32)
    return torch.mean(torch.logsumexp(z, dim=-1) - _true_class(z, labels),
                      dim=-1)


def make_loss_fn(kind: str, beta: float = DEFAULT_BETA):
    """'vt' -> virtual-teacher KL (Eq. 8), 'ce' -> cross-entropy."""
    if kind == "vt":
        return lambda logits, labels: vt_kl_loss(logits, labels, beta=beta)
    if kind == "ce":
        return cross_entropy_loss
    raise ValueError(f"unknown loss kind {kind!r} (expected 'vt' or 'ce')")
