"""Dense decoder-only LM (llama/qwen family) over stacked layer params.

Covers deepseek-7b (llama arch), qwen1.5-0.5b / qwen2.5-14b (QKV bias) and
qwen3-32b (qk-norm, GQA, head_dim 128), as the JAX package's
`repro.models.lm.dense` does.  Params are a nested dict with the
reference's keys; the per-layer leaves are stacked [L, ...] and `trunk`
loops over them, so the flat [N, D] order of a stack of nodes is
`jax.tree.flatten`'s (embed/table, final_norm/scale, layers/attn/wk/b, ...).
With `cfg.remat` every layer runs under `torch.utils.checkpoint`: its
activations are recomputed in the backward pass, which changes no number.
Serving (`init_cache_dense`, `decode_step_dense`) is ROADMAP A.11.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.models.lm.config import ArchConfig
from repro_torch.models.lm.layers import (
    apply_norm,
    attention,
    embed,
    init_attention,
    init_embedding,
    init_linear,
    init_mlp,
    init_norm,
    mlp,
    unembed,
)
from repro_torch.utils.pytree import tree_leaves, tree_unflatten_like


def init_dense(gen: torch.Generator, cfg: ArchConfig, device=None):
    """One node's params, drawn from `gen` (a generator of the same device)
    on `device`: None means the card and raises on a host without CUDA."""
    device = resolve_device(device)
    stack = (cfg.n_layers,)
    params = {
        "embed": init_embedding(gen, cfg, device=device),
        "layers": {
            "ln1": init_norm(cfg, stack=stack, device=device),
            "attn": init_attention(gen, cfg, stack=stack, device=device),
            "ln2": init_norm(cfg, stack=stack, device=device),
            "mlp": init_mlp(gen, cfg, stack=stack, device=device),
        },
        "final_norm": init_norm(cfg, device=device),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = init_linear(gen, cfg.d_model, cfg.vocab, cfg,
                                        device=device)
    return params


def layer_apply(cfg: ArchConfig, lp, x, positions):
    x = x + attention(cfg, lp["attn"], apply_norm(cfg, x, lp["ln1"]),
                      positions)
    x = x + mlp(cfg, lp["mlp"], apply_norm(cfg, x, lp["ln2"]))
    return x


def trunk(cfg: ArchConfig, params, x, positions):
    """Run the stacked layers on embedded input x [B, S, D]."""
    stacked = params["layers"]
    # one unbind per leaf: its backward stacks the L layer gradients once,
    # where L separate `leaf[l]` selects would each scatter into a full
    # [L, ...] zero tensor
    per_leaf = [t.unbind(0) for t in tree_leaves(stacked)]
    for layer in range(cfg.n_layers):
        lp = tree_unflatten_like(stacked, [u[layer] for u in per_leaf])
        if cfg.remat and torch.is_grad_enabled():
            x = checkpoint(layer_apply, cfg, lp, x, positions,
                           use_reentrant=False)
        else:
            x = layer_apply(cfg, lp, x, positions)
    return apply_norm(cfg, x, params["final_norm"])


def forward_dense(cfg: ArchConfig, params, tokens, positions=None):
    """tokens [B, S] -> logits [B, S, V] in the activation dtype."""
    x = embed(cfg, params["embed"], tokens)
    if positions is None:
        positions = torch.arange(tokens.shape[1], dtype=torch.int32,
                                 device=tokens.device)
    x = trunk(cfg, params, x, positions)
    return unembed(cfg, params.get("unembed"), params["embed"], x)
