"""Synthetic LM token streams (a copy of the JAX package's numpy-only
`repro.data.tokens.synthetic_token_batch`, so both packages see the same
tokens from the same seed), and `lm_input_specs`, the allocation-free
(shape, dtype) stand-ins of a token batch that the dry run uses.

A deterministic next-token-prediction stream with Zipfian unigram
statistics and short-range Markov structure, so models actually reduce
loss during smoke training.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch


def synthetic_token_batch(batch: int, seq_len: int, vocab: int, seed: int = 0
                          ) -> Dict[str, np.ndarray]:
    """Zipf-unigram + order-1 Markov synthetic tokens with labels = shift."""
    rng = np.random.default_rng(seed)
    v_eff = min(vocab, 4096)  # concentrate mass; large vocab tails unused
    ranks = np.arange(1, v_eff + 1, dtype=np.float64)
    p = 1.0 / ranks**1.1
    p /= p.sum()
    toks = rng.choice(v_eff, size=(batch, seq_len + 1), p=p).astype(np.int32)
    # short-range structure: with prob .5 copy-shift the previous token + 1
    copy = rng.random((batch, seq_len)) < 0.5
    toks[:, 1:][copy] = (toks[:, :-1][copy] + 1) % v_eff
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def lm_input_specs(batch: int, seq_len: int, dtype=torch.int32
                   ) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """{name: (shape, dtype)} of a token batch, the form of
    `LM.input_specs`."""
    return {"tokens": ((batch, seq_len), dtype),
            "labels": ((batch, seq_len), dtype)}
