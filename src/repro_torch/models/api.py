"""Model API for the paper-scale models, node-batched.

A :class:`SmallModel` is an (init, apply) pair over plain dict trees:

  init(generator) -> params of ONE node (CPU tensors, drawn from the
                     given `torch.Generator`)
  apply(params, x) -> logits [N, B, classes], with every leaf of `params`
                     carrying a leading node axis [N, ...]; `x` is either
                     [N, B, ...] (each node its own batch) or [1, B, ...]
                     (one batch shared by every node, as in evaluation)

Weights keep the JAX package's layout (`Linear` weights [in, out], applied
as `x @ w`), so parameters carry across unchanged.
"""
from __future__ import annotations

from typing import Callable, NamedTuple


class SmallModel(NamedTuple):
    name: str
    init: Callable
    apply: Callable
    num_classes: int
