"""Virtual Teacher (VT) — the paper's Eq. (7) and Eq. (8), closed form.

    p_t(y) = beta                      if y == c (true class)
             (1 - beta) / (|L| - 1)    otherwise                     (Eq. 7)

and the loss is KL(p_t || p_model) (Eq. 8).  With logits z in R^V, true
class c and a = (1-beta)/(V-1):

    KL(p_t || p) = -H(p_t) - [ beta * z_c + a * (Σ_y z_y - z_c) - lse(z) ]

so three reductions over the class axis suffice (z_c, Σz, lse) and the
teacher distribution is never materialized.  `vt_kl_loss` computes it per
row through `repro_torch.kernels.ops.vt_kl_loss`: the fused kernel on the
card (forward and backward, the gradient being softmax(z) - p_t), its
plain PyTorch version on the CPU.

Node batching: logits are [..., B, V] and labels [..., B]; the losses
average over the batch axis B only, so [N, B, V] logits give one loss per
node ([N]) and [B, V] logits one scalar, as in the JAX package.

On a mesh (logits a DTensor, `dist.constraints.use_mesh`) the loss runs on
the local shards: with the vocabulary split over "model" (the layout of
`constrain_logits`) each shard takes its rows' partial statistics and two
all-reduces over "model" combine them (`ops.vt_kl_loss_vocab_parallel`),
so [B, V] is never gathered; the mean over the data-split rows is a
DTensor reduction.  Cross-entropy there is the same computation at β = 1,
where a = 0 and H(p_t) = 0 make Eq. 8 lse(z) − z_c.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch._subclasses.fake_tensor import unset_fake_temporarily

from repro_torch.dist.constraints import is_dtensor, vocab_shard
from repro_torch.kernels import ops

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


def soft_labels(labels: torch.Tensor, num_classes: int,
                beta: float) -> torch.Tensor:
    """Materialized Eq. (7) distribution [..., V] in fp32 — O(B*V); for
    reference and testing only (the loss never builds it)."""
    a = (1.0 - beta) / (num_classes - 1)
    onehot = torch.nn.functional.one_hot(labels.to(torch.int64),
                                         num_classes).to(torch.float32)
    return onehot * beta + (1.0 - onehot) * a


def _true_class(z: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    idx = labels.to(torch.int64).expand(z.shape[:-1])
    return torch.gather(z, -1, idx[..., None])[..., 0]


def vt_kl_loss(logits: torch.Tensor, labels: torch.Tensor,
               beta: float = DEFAULT_BETA,
               where: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean KL(p_t || softmax(logits)) over the batch axis — Eq. (8).

    logits [..., B, V] fp32 or bf16 (the fused kernel reads either and
    computes in fp32), labels broadcastable to [..., B].  `where`, a bool
    mask broadcastable to [..., B] (e.g. padding tokens), zeroes the masked
    positions and excludes them from the mean, as the reference's does."""
    if is_dtensor(logits):
        if where is not None:
            raise NotImplementedError("vt_kl_loss takes no `where` on a "
                                      "mesh")
        return _mean_kl_on_mesh(logits, labels, beta)
    v = logits.shape[-1]
    lead = logits.shape[:-1]
    idx = labels.to(torch.int64).expand(lead).reshape(-1)
    # an exact fp32 value, host-side: real tensors even inside a fake-tensor
    # trace (launch/dryrun.py), which cannot read a fake scalar
    with unset_fake_temporarily():
        h = float(teacher_entropy(beta, v))
    kl = ops.vt_kl_loss(logits.reshape(-1, v).contiguous(), idx, beta,
                        -h).reshape(lead)
    if where is None:
        return torch.mean(kl, dim=-1)
    mask = where.to(torch.bool).expand(lead)
    kl = torch.where(mask, kl, torch.zeros_like(kl))
    denom = torch.clamp(torch.sum(mask, dim=-1), min=1)
    return torch.sum(kl, dim=-1) / denom


def _mean_kl_on_mesh(logits, labels, beta: float):
    """`vt_kl_loss` of DTensor logits [..., B, V] (module docstring)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = logits.device_mesh
    v = logits.shape[-1]
    lead = logits.shape[:-1]
    vocab = vocab_shard(mesh, v)
    z = logits.reshape(-1, v)
    rows = tuple(Shard(0) if p == Shard(0) else Replicate()
                 for p in z.placements)
    z_pl = vocab.place(z.placements, 1)
    if z_pl != tuple(z.placements):
        z = z.redistribute(mesh, z_pl)
    if not is_dtensor(labels):
        labels = DTensor.from_local(labels, mesh,
                                    [Replicate()] * mesh.ndim)
    idx = labels.to(torch.int64).reshape(-1).redistribute(mesh, rows)
    with unset_fake_temporarily():
        h = float(teacher_entropy(beta, v))

    def local(zl, il):
        zl, il = zl.contiguous(), il.contiguous()
        if vocab.split:
            return ops.vt_kl_loss_vocab_parallel(zl, il, beta, -h,
                                                 vocab.offset, v, vocab.group)
        return ops.vt_kl_loss(zl, il, beta, -h)

    kl = local_map(local, out_placements=list(rows),
                   in_placements=(z_pl, rows), device_mesh=mesh)(z, idx)
    return torch.mean(kl.reshape(lead), dim=-1)


def cross_entropy_loss(logits: torch.Tensor,
                       labels: torch.Tensor) -> torch.Tensor:
    """Cross-entropy on hard labels, mean over the batch axis."""
    if is_dtensor(logits):
        return _mean_kl_on_mesh(logits, labels, 1.0)
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
