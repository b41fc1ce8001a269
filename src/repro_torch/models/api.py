"""Model API for the paper-scale models, node-batched.

A :class:`SmallModel` is an (init, apply) pair over plain dict trees:

  init(generator) -> params of ONE node (CPU tensors, drawn from the
                     given `torch.Generator`)
  apply(params, x, *, train=False, keep=None)
                  -> logits [N, B, classes], with every leaf of `params`
                     carrying a leading node axis [N, ...]; `x` is either
                     [N, B, ...] (each node its own batch) or [1, B, ...]
                     (one batch shared by every node, as in evaluation).
                     A model with dropout drops only when `train` is True
                     and a keep-mask source is given: `keep(shape, p)`
                     returns a bool tensor of `shape` whose entries are
                     True with probability p (the caller's generator, or
                     injected masks in tests), called once per dropout
                     layer in forward order.  Models without dropout
                     never call it.

Weights keep the JAX package's layout (`Linear` weights [in, out], applied
as `x @ w`), so parameters carry across unchanged.
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple


class SmallModel(NamedTuple):
    name: str
    init: Callable
    apply: Callable
    num_classes: int


SMALL_MODELS: Dict[str, Callable[..., SmallModel]] = {}


def register_small_model(name: str):
    def deco(fn):
        SMALL_MODELS[name] = fn
        return fn

    return deco


def make_small_model(name: str, **kwargs) -> SmallModel:
    import repro_torch.models.mlp_cnn  # noqa: F401  (populate registry)

    try:
        return SMALL_MODELS[name](**kwargs)
    except KeyError:
        raise ValueError(
            f"unknown small model {name!r}; available: {sorted(SMALL_MODELS)}"
        ) from None
