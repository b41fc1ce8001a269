"""LM interface over the architecture families (the dense family so far).

    lm = build_lm(cfg)
    params = lm.init(generator)                 # one node's params, on the card
    logits, aux = lm.forward(params, batch)     # batch: {"tokens", "labels"}
    loss, metrics = lm.loss(params, batch)      # VT-KL or CE next-token

The PyTorch counterpart of the JAX package's `repro.models.lm.api`.  The
training loss is the paper's Virtual Teacher KL (Eq. 8) applied to
next-token prediction over the whole vocabulary, through the fused
`vt_kl_loss` kernel on the card; `loss_kind="ce"` is plain cross-entropy.
The router's load-balance auxiliary enters as `router_aux_weight · aux`
(0 for dense models).  `build_lm` builds the dense family; the MoE, SSM,
hybrid, encdec and VLM families, and serving (`init_cache`,
`decode_step`), are ROADMAP A.11.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.core.virtual_teacher import cross_entropy_loss, vt_kl_loss
from repro_torch.models.lm import dense
from repro_torch.models.lm.config import ArchConfig


@dataclasses.dataclass(frozen=True)
class LM:
    cfg: ArchConfig
    init: Callable     # (torch.Generator, device=None) -> params
    forward: Callable  # (params, batch) -> (logits [B, S, V], aux)

    def loss(self, params, batch, *, loss_kind: str = "vt",
             beta: float = 0.98):
        """(total, {"loss", "aux"}): the mean next-token loss over every
        position of the batch, plus the router auxiliary."""
        logits, aux = self.forward(params, batch)
        v = logits.shape[-1]
        z = logits.reshape(-1, v)
        labels = batch["labels"].reshape(-1)
        if loss_kind == "vt":
            main = vt_kl_loss(z, labels, beta=beta)
        elif loss_kind == "ce":
            main = cross_entropy_loss(z, labels)
        else:
            raise ValueError(f"unknown loss kind {loss_kind!r} (expected "
                             f"'vt' or 'ce')")
        total = main + self.cfg.router_aux_weight * aux
        return total, {"loss": main, "aux": aux}

    def init_cache(self, batch: int, seq_len: int):
        raise NotImplementedError(
            "LM serving (the ring KV cache and decode step) is ROADMAP A.11, "
            "not ported yet")

    def decode_step(self, params, cache, tokens):
        raise NotImplementedError(
            "LM serving (the ring KV cache and decode step) is ROADMAP A.11, "
            "not ported yet")


FAMILIES = ("dense", "moe", "ssm", "hybrid", "encdec", "vlm")


def build_lm(cfg: ArchConfig) -> LM:
    if cfg.family not in FAMILIES:
        raise ValueError(f"unknown family {cfg.family!r}")
    if cfg.family != "dense":
        raise NotImplementedError(
            f"the {cfg.family!r} family is ROADMAP A.11 (MoE, SSM, hybrid, "
            f"encdec and VLM models follow the dense one), not ported yet")

    def init(gen: torch.Generator, device=None):
        return dense.init_dense(gen, cfg, device=device)

    def forward(params, batch):
        return dense.forward_dense(cfg, params, batch["tokens"]), 0.0

    return LM(cfg, init, forward)
