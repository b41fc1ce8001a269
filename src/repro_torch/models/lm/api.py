"""LM interface over the architecture families (the dense family so far).

    lm = build_lm(cfg)
    params = lm.init(generator)                 # one node's params, on the card
    logits, aux = lm.forward(params, batch)     # batch: {"tokens", "labels"}
    loss, metrics = lm.loss(params, batch)      # VT-KL or CE next-token
    cache = lm.init_cache(batch_size, seq_len)  # ring KV cache, on the card
    logits, cache = lm.decode_step(params, cache, tokens)   # tokens [B, 1]

The PyTorch counterpart of the JAX package's `repro.models.lm.api`.  The
training loss is the paper's Virtual Teacher KL (Eq. 8) applied to
next-token prediction over the whole vocabulary, through the fused
`vt_kl_loss` kernel on the card; `loss_kind="ce"` is plain cross-entropy.
The router's load-balance auxiliary enters as `router_aux_weight · aux`
(0 for dense models).  Serving decodes one token per `decode_step`
through the `decode_attention` kernel on the card; the port's decode step
updates the cache it is given in place (the reference returns a new one).
`build_lm` builds the dense family, whose `prep_decode_cache` is None;
the MoE, SSM, hybrid, encdec and VLM families are ROADMAP A.11.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch.core.virtual_teacher import cross_entropy_loss, vt_kl_loss
from repro_torch.models.lm import dense
from repro_torch.models.lm.config import ArchConfig


@dataclasses.dataclass(frozen=True)
class LM:
    cfg: ArchConfig
    init: Callable     # (torch.Generator, device=None) -> params
    forward: Callable  # (params, batch) -> (logits [B, S, V], aux)
    #: encdec only: fill the cross-attention K/V (None for the dense family)
    prep_decode_cache: Optional[Callable] = None

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

    def init_cache(self, batch: int, seq_len: int, device=None):
        """The decode state for `batch` sequences of up to `seq_len` tokens
        on `device` (None: the card; raises on a host without CUDA)."""
        return dense.init_cache_dense(self.cfg, batch, seq_len,
                                      device=device)

    def decode_step(self, params, cache, tokens):
        """(params, cache, tokens [B, 1]) -> (logits [B, 1, V], cache): one
        token against the cache, which is updated in place."""
        return dense.decode_step_dense(self.cfg, params, cache, tokens)


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
