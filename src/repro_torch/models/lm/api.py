"""LM interface over the six architecture families.

    lm = build_lm(cfg)
    params = lm.init(generator)                 # one node's params, on the card
    logits, aux = lm.forward(params, batch)     # batch: dict (input_specs)
    loss, metrics = lm.loss(params, batch)      # VT-KL or CE next-token
    cache = lm.init_cache(batch_size, seq_len)  # decode state, on the card
    cache = lm.prep_decode_cache(params, cache, enc_embeds)  # encdec only
    logits, cache = lm.decode_step(params, cache, tokens)   # tokens [B, 1]
    specs = lm.input_specs(batch, seq_len)      # {name: (shape, dtype)}

The PyTorch counterpart of the JAX package's `repro.models.lm.api`, over
the dense (deepseek, qwen), MoE (mixtral, arctic), SSM (mamba2), hybrid
(zamba2), enc-dec (whisper) and VLM (llava) families.  The training loss
is the paper's Virtual Teacher KL (Eq. 8) applied to next-token prediction
over the whole vocabulary, through the fused `vt_kl_loss` kernel on the
card; `loss_kind="ce"` is plain cross-entropy.  The MoE router's
load-balance auxiliary enters as `router_aux_weight · aux` (0 for the
other families).  Serving decodes one token per `decode_step`; every
attention family's self-attention runs through the `decode_attention`
kernel on the card.  The port's decode step updates the cache it is given
in place (the reference returns a new one); `prep_decode_cache` (enc-dec
only, None elsewhere) returns the cache with the encoder's cross K / V.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.core.virtual_teacher import cross_entropy_loss, vt_kl_loss
from repro_torch.models.lm import dense, encdec, hybrid, moe, ssm, vlm
from repro_torch.models.lm.config import ArchConfig

Spec = Tuple[Tuple[int, ...], torch.dtype]


@dataclasses.dataclass(frozen=True)
class LM:
    cfg: ArchConfig
    init: Callable     # (torch.Generator, device=None) -> params
    forward: Callable  # (params, batch) -> (logits [B, S, V], aux)
    #: (cfg, batch, seq_len, device=None) -> the family's decode state
    init_cache_fn: Callable
    #: (cfg, params, cache, tokens [B, 1]) -> (logits [B, 1, V], cache)
    decode_step_fn: Callable
    #: encdec only: (params, cache, enc_embeds) -> the cache with its
    #: cross-attention K / V filled (None for the other families)
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
        return self.init_cache_fn(self.cfg, batch, seq_len, device=device)

    def decode_step(self, params, cache, tokens):
        """(params, cache, tokens [B, 1]) -> (logits [B, 1, V], cache): one
        token against the cache, which is updated in place."""
        return self.decode_step_fn(self.cfg, params, cache, tokens)

    def input_specs(self, batch: int, seq_len: int) -> Dict[str, Spec]:
        """{name: (shape, dtype)} of a training batch of `batch` sequences
        of `seq_len` positions, by the reference's rules: int32 tokens and
        labels; enc-dec adds enc_embeds [B, max(seq_len // enc_seq_divisor,
        1), D]; the VLM has max(seq_len - img_tokens, 1) text positions and
        adds img_embeds [B, img_tokens, D], both embeddings in the
        activation dtype."""
        cfg = self.cfg
        s = seq_len
        if cfg.family == "vlm":
            s = max(seq_len - cfg.img_tokens, 1)
        specs = {"tokens": ((batch, s), torch.int32),
                 "labels": ((batch, s), torch.int32)}
        if cfg.family == "encdec":
            enc_len = max(seq_len // cfg.enc_seq_divisor, 1)
            specs["enc_embeds"] = ((batch, enc_len, cfg.d_model), cfg.adtype)
        if cfg.family == "vlm":
            specs["img_embeds"] = ((batch, cfg.img_tokens, cfg.d_model),
                                   cfg.adtype)
        return specs


FAMILIES = ("dense", "moe", "ssm", "hybrid", "encdec", "vlm")


def build_lm(cfg: ArchConfig) -> LM:
    fam = cfg.family
    if fam not in FAMILIES:
        raise ValueError(f"unknown family {fam!r}")

    def init_with(fn):
        return lambda gen, device=None: fn(gen, cfg, device=device)

    if fam == "dense":
        return LM(cfg, init_with(dense.init_dense),
                  lambda p, b: (dense.forward_dense(cfg, p, b["tokens"]), 0.0),
                  dense.init_cache_dense, dense.decode_step_dense)
    if fam == "moe":
        return LM(cfg, init_with(moe.init_moe_lm),
                  lambda p, b: moe.forward_moe(cfg, p, b["tokens"]),
                  moe.init_cache_moe, moe.decode_step_moe)
    if fam == "ssm":
        return LM(cfg, init_with(ssm.init_ssm_lm),
                  lambda p, b: (ssm.forward_ssm(cfg, p, b["tokens"]), 0.0),
                  ssm.init_cache_ssm, ssm.decode_step_ssm)
    if fam == "hybrid":
        return LM(cfg, init_with(hybrid.init_hybrid_lm),
                  lambda p, b: (hybrid.forward_hybrid(cfg, p, b["tokens"]),
                                0.0),
                  hybrid.init_cache_hybrid, hybrid.decode_step_hybrid)
    if fam == "encdec":
        return LM(cfg, init_with(encdec.init_encdec),
                  lambda p, b: (encdec.forward_encdec(cfg, p, b), 0.0),
                  encdec.init_cache_encdec, encdec.decode_step_encdec,
                  prep_decode_cache=lambda p, c, e:
                  encdec.prefill_cross_cache(cfg, p, c, e))
    return LM(cfg, init_with(vlm.init_vlm),
              lambda p, b: (vlm.forward_vlm(cfg, p, b), 0.0),
              vlm.init_cache_vlm, vlm.decode_step_vlm)
