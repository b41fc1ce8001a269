"""The paper's local model architectures (Table I), node-batched.

  MNIST    : MLP  FC 512-256-128 (+ output head), ReLU
  Fashion  : CNN  (not ported yet: ROADMAP A.2)
  EMNIST   : CNN  (not ported yet: ROADMAP A.2)

Initialization is uniform in ±1/sqrt(fan_in) (PyTorch default-like); every
node draws its own init from its own generator (model heterogeneity).  The
forward pass runs all N nodes at once as batched products of the stacked
[N, in, out] weights.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch

from repro_torch.models.api import SmallModel


def _linear_init(gen: torch.Generator, fan_in: int, fan_out: int):
    bound = 1.0 / math.sqrt(fan_in)
    w = torch.empty(fan_in, fan_out).uniform_(-bound, bound, generator=gen)
    b = torch.empty(fan_out).uniform_(-bound, bound, generator=gen)
    return {"w": w, "b": b}


def make_mlp(num_classes: int = 10, input_dim: int = 784,
             hidden: Sequence[int] = (512, 256, 128)) -> SmallModel:
    dims = [input_dim, *hidden, num_classes]

    def init(gen: torch.Generator):
        return {f"fc{i}": _linear_init(gen, dims[i], dims[i + 1])
                for i in range(len(dims) - 1)}

    def apply(params, x):
        # x [N, B, ...] per-node batches, or [1, B, ...] one shared batch
        h = x.reshape(x.shape[0], x.shape[1], input_dim)
        for i in range(len(dims) - 1):
            p = params[f"fc{i}"]
            h = torch.matmul(h, p["w"]) + p["b"][:, None, :]
            if i < len(dims) - 2:
                h = torch.relu(h)
        return h

    return SmallModel("mlp", init, apply, num_classes)


def make_cnn(num_classes: int = 10, in_hw=(28, 28),
             use_pool_dropout: bool = False) -> SmallModel:
    raise NotImplementedError(
        "the CNN (Fashion / EMNIST, Table I) is not ported yet: ROADMAP A.2")


def model_for_dataset(dataset_name: str, num_classes: int) -> SmallModel:
    """Paper Table I mapping."""
    if "mnist" in dataset_name and "fashion" not in dataset_name \
            and "emnist" not in dataset_name:
        return make_mlp(num_classes=num_classes)
    if "fashion" in dataset_name:
        return make_cnn(num_classes=num_classes, use_pool_dropout=False)
    if "emnist" in dataset_name:
        return make_cnn(num_classes=num_classes, use_pool_dropout=True)
    raise ValueError(f"no paper model mapping for dataset {dataset_name!r}")
