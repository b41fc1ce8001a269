"""Minibatching: shuffled host-side minibatches and the node-batched
stride-gather `Batcher`.

`minibatches` is the JAX package's numpy generator, copied (numpy only,
so the same `rng` gives the same batches): the centralized baseline draws
its batches from it.

`Batcher` is the counterpart of the JAX package's `Batcher`: for
node-local data padded to [M, ...] with `count` real samples, batch `step`
takes indices `(step*bs + arange(bs)) * stride mod count`.  The index arithmetic is int32
with two's-complement wrap-around, exactly as `jnp` int32 computes it: the
product passes 2^31 near step 8474 at bs 32, and from there the indices
come from the wrapped (negative) value under a floor-sign modulo.  The wrap
is computed explicitly in int64 so it does not rest on how a backend
treats signed overflow.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Tuple

import numpy as np
import torch


def minibatches(x: np.ndarray, y: np.ndarray, batch_size: int, *,
                rng: np.random.Generator, drop_remainder: bool = True
                ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """One shuffled pass over (x, y) in batches of `batch_size`, the order
    from `rng.permutation`; the remainder is dropped unless asked for."""
    n = len(x)
    order = rng.permutation(n)
    end = (n // batch_size) * batch_size if drop_remainder else n
    for s in range(0, max(end, 0), batch_size):
        ix = order[s:s + batch_size]
        yield x[ix], y[ix]


def wrap_int32(v: torch.Tensor) -> torch.Tensor:
    """Two's-complement wrap of an int64 tensor into the int32 range."""
    return torch.remainder(v + 2 ** 31, 2 ** 32) - 2 ** 31


@dataclasses.dataclass(frozen=True)
class Batcher:
    """Deterministic stride-gather batching over every node at once."""

    batch_size: int
    stride: int = 7919  # prime

    def indices(self, counts: torch.Tensor, step) -> torch.Tensor:
        """[N, bs] int64 sample indices for every node at `step`: an int,
        or an [N] int64 tensor of per-row steps."""
        bs = self.batch_size
        ar = torch.arange(bs, dtype=torch.int64, device=counts.device)
        if isinstance(step, torch.Tensor):
            base = wrap_int32(step.to(torch.int64) * bs)[:, None]
        else:
            base = (step * bs + 2 ** 31) % 2 ** 32 - 2 ** 31  # int32 step*bs
        idx = wrap_int32(wrap_int32(base + ar) * self.stride)
        # floor-sign modulo (jnp `%` / torch.remainder), per node count
        return torch.remainder(
            idx.reshape(-1, bs),
            torch.clamp(counts.to(torch.int64), min=1)[:, None])

    def take(self, x: torch.Tensor, y: torch.Tensor, counts: torch.Tensor,
             step: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """x [N, M, ...], y [N, M], counts [N] -> ([N, bs, ...], [N, bs])."""
        idx = self.indices(counts, step)
        rows = torch.arange(x.shape[0], device=x.device)[:, None]
        return x[rows, idx], y[rows, idx]
