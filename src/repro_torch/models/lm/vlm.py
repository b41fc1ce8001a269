"""LLaVA-NeXT (mistral-7b backbone): a VLM whose vision tower is a stub.

The PyTorch counterpart of the JAX package's `repro.models.lm.vlm`.  As
there, the SigLIP/CLIP vision encoder and projector are not modelled:
batches carry precomputed, already projected patch embeddings
[B, img_tokens, D] (anyres tiling: 576 base + 4 x 576 tile tokens = 2880).
The language model is the dense mistral trunk; the image embeddings are
prepended to the text token embeddings, positions run over both, and
only the text positions produce logits (the loss is on text labels).

Decode is text-only and is the dense family's: the ring KV cache covers
the whole multimodal sequence, which a prefill of the image and prompt
would have filled; `decode_step` appends text tokens.
"""
from __future__ import annotations

import torch

from repro_torch.dist.constraints import constrain_batch, constrain_logits
from repro_torch.models.lm.config import ArchConfig
from repro_torch.models.lm.dense import (
    decode_step_dense,
    forward_dense,
    init_cache_dense,
    init_dense,
    trunk,
)
from repro_torch.models.lm.layers import embed, unembed

init_vlm = init_dense


def forward_vlm(cfg: ArchConfig, params, batch):
    """batch: tokens [B, S_text], img_embeds [B, I, D] -> logits
    [B, S_text, V]: the trunk runs over [img ; text] at positions
    0 .. I + S_text - 1, and the text positions are unembedded."""
    tokens = batch["tokens"]
    img = batch["img_embeds"].to(cfg.adtype)
    s_text = tokens.shape[1]
    i = img.shape[1]
    x_text = embed(cfg, params["embed"], tokens)
    x = constrain_batch(torch.cat([img, x_text], dim=1))
    positions = torch.arange(i + s_text, dtype=torch.int32,
                             device=tokens.device)
    x = trunk(cfg, params, x, positions)
    x = x[:, i:, :]  # text positions only
    return constrain_logits(unembed(cfg, params.get("unembed"),
                                    params["embed"], x))


init_cache_vlm = init_cache_dense
decode_step_vlm = decode_step_dense  # decode is text-only, the dense path
forward_text_only = forward_dense
