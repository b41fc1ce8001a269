"""Per-edge payload codecs for the gossip transport.

A codec turns flat model vectors (or model deltas) into a *wire payload* —
a dict of tensors whose dtypes are exactly what would be serialized onto
the network — and back.  The contracts, kept from the JAX package's
`repro.comm.codecs`:

  * `decode(encode(x)) ≈ x` with a codec-specific error bound (exact for
    fp32, one bf16 ulp for bf16, one quantization grain for int8), and the
    error-feedback invariant for top-k/int8: residual' + decode(payload)
    == x + residual, so nothing is silently dropped — only delayed;
  * `bytes_on_wire(payload)` is the byte length of the serialized payload
    (Σ numel × element_size);
  * `encode` and `decode` take a `[..., D]` tensor and treat every leading
    index as its own vector (the reference `vmap`s them per node or per
    edge), so one call encodes a whole `[N, E, D]` panel.

Codecs marked `is_delta=True` compress the model *difference* w − w_last_sent
(plus the carried residual); the transport reconstructs ŵ = w_last_sent +
decode(payload).

Randomness: int8 stochastic rounding takes `rng`, which is either a
`torch.Generator` (uniforms of the input's shape are drawn from it, never
from the global RNG) or a tensor of uniforms in [0, 1) of the input's shape
(the per-edge transport draws one row per canonical directed edge and
indexes it).  `rng=None`, or `stochastic=False`, is deterministic
round-to-nearest `floor(y + 0.5)`, exactly as the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Union

import torch

Payload = Dict[str, torch.Tensor]
Rng = Union[torch.Generator, torch.Tensor, None]


def payload_nbytes(payload: Payload) -> int:
    """Exact serialized size of a wire payload: every leaf ships as raw
    little-endian machine words, no framing (Σ numel × element_size)."""
    return int(sum(t.numel() * t.element_size() for t in payload.values()))


@dataclasses.dataclass(frozen=True)
class Codec:
    """Base codec: interface + shared accounting."""

    name: str = "codec"
    is_delta: bool = False      # compresses w - w_last_sent (EF scheme)
    needs_rng: bool = False     # encode consumes random numbers
    has_residual: bool = False  # carries an error-feedback residual

    def init_residual(self, vec: torch.Tensor) -> Optional[torch.Tensor]:
        """Zero residual for a `[..., D]` batch of vectors."""
        if not self.has_residual:
            return None
        return torch.zeros(vec.shape, dtype=torch.float32, device=vec.device)

    def encode(self, vec: torch.Tensor, rng: Rng = None,
               residual: Optional[torch.Tensor] = None):
        raise NotImplementedError

    def decode(self, payload: Payload, out_size: Optional[int] = None):
        raise NotImplementedError

    def bytes_on_wire(self, payload: Payload) -> int:
        return payload_nbytes(payload)

    def payload_bytes_for(self, size: int) -> int:
        """Exact wire bytes for one encoded vector of `size` elements,
        computed from payload shapes alone: the encode runs on the `meta`
        device, which allocates nothing and computes nothing."""
        proto = torch.zeros((size,), dtype=torch.float32, device="meta")
        payload, _ = self.encode(proto)
        return payload_nbytes(payload)


@dataclasses.dataclass(frozen=True)
class FP32Codec(Codec):
    """Dense fp32 passthrough — the accounting baseline (bit-exact)."""

    name: str = "fp32"

    def encode(self, vec, rng=None, residual=None):
        return {"w": vec.to(torch.float32)}, residual

    def decode(self, payload, out_size=None):
        return payload["w"]


@dataclasses.dataclass(frozen=True)
class BF16Codec(Codec):
    """Dense bf16 cast — halves the wire, one-bf16-ulp relative error."""

    name: str = "bf16"

    def encode(self, vec, rng=None, residual=None):
        return {"w": vec.to(torch.bfloat16)}, residual

    def decode(self, payload, out_size=None):
        return payload["w"].to(torch.float32)


def _uniforms(rng: Rng, like: torch.Tensor) -> torch.Tensor:
    if isinstance(rng, torch.Generator):
        return torch.rand(like.shape, generator=rng, dtype=torch.float32,
                          device=like.device)
    if tuple(rng.shape) != tuple(like.shape):
        raise ValueError(f"uniforms of shape {tuple(rng.shape)} for an input "
                         f"of shape {tuple(like.shape)}")
    return rng


@dataclasses.dataclass(frozen=True)
class Int8Codec(Codec):
    """Symmetric per-vector int8 with optional stochastic rounding + EF.

    scale = max|x| / 127; wire = int8 values + one fp32 scale per vector
    (4x fewer bytes than fp32, minus 4 bytes of scale)."""

    name: str = "int8"
    is_delta: bool = True
    needs_rng: bool = True   # only consumed when stochastic
    has_residual: bool = True
    stochastic: bool = True

    def encode(self, vec, rng=None, residual=None):
        x = vec.to(torch.float32)
        if residual is not None:
            x = x + residual
        amax = torch.amax(torch.abs(x), dim=-1)
        scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
        y = x / scale[..., None]
        if self.stochastic and rng is not None:
            y = y + _uniforms(rng, y)
        else:
            y = y + 0.5
        q = torch.clamp(torch.floor(y), -127, 127).to(torch.int8)
        new_res = (x - q.to(torch.float32) * scale[..., None]
                   if residual is not None else None)
        return {"q": q, "scale": scale}, new_res

    def decode(self, payload, out_size=None):
        return payload["q"].to(torch.float32) * payload["scale"][..., None]


@dataclasses.dataclass(frozen=True)
class TopKCodec(Codec):
    """Magnitude top-k sparsification with error-feedback residuals.

    Ships the k largest-|.| coordinates as (int32 index, fp32 value) pairs
    plus an int32 length word: 8k + 4 bytes, k = max(1, round(ratio·D)).
    With `momentum > 0` the selection runs on score = |x| + momentum ·
    score_prev, carried as row 1 of a `[..., 2, D]` residual (row 0 is the
    EF residual); a selected coordinate resets its score to zero.
    `momentum = 0` is plain magnitude top-k with a `[..., D]` residual.
    Ties in magnitude may be broken differently from `jax.lax.top_k`."""

    name: str = "topk"
    is_delta: bool = True
    has_residual: bool = True
    ratio: float = 0.01
    momentum: float = 0.0

    def k_for(self, size: int) -> int:
        return max(1, int(round(self.ratio * size)))

    def init_residual(self, vec):
        if self.momentum > 0:
            return torch.zeros(vec.shape[:-1] + (2, vec.shape[-1]),
                               dtype=torch.float32, device=vec.device)
        return super().init_residual(vec)

    def encode(self, vec, rng=None, residual=None):
        x = vec.to(torch.float32)
        with_momentum = self.momentum > 0 and residual is not None
        if residual is not None:
            x = x + (residual[..., 0, :] if with_momentum else residual)
        size = x.shape[-1]
        score = torch.abs(x)
        if with_momentum:
            score = score + self.momentum * residual[..., 1, :]
        _, idx = torch.topk(score, self.k_for(size), dim=-1)
        vals = torch.gather(x, -1, idx)
        if residual is None:
            new_res = None
        elif with_momentum:
            new_res = torch.stack([x.scatter(-1, idx, 0.0),
                                   score.scatter(-1, idx, 0.0)], dim=-2)
        else:
            new_res = x.scatter(-1, idx, 0.0)
        payload = {
            "idx": idx.to(torch.int32),
            "vals": vals,
            # length word: receivers must know the dense size to scatter into
            "size": torch.full(x.shape[:-1], size, dtype=torch.int32,
                               device=x.device),
        }
        return payload, new_res

    def decode(self, payload, out_size=None):
        idx = payload["idx"]
        if out_size is None:
            out_size = int(payload["size"].reshape(-1)[0])
        out = torch.zeros(idx.shape[:-1] + (out_size,), dtype=torch.float32,
                          device=idx.device)
        return out.scatter(-1, idx.to(torch.int64), payload["vals"])


CODECS = {
    "fp32": FP32Codec,
    "bf16": BF16Codec,
    "int8": Int8Codec,
    "topk": TopKCodec,
}


def make_codec(name: str, **kwargs) -> Codec:
    """Factory: `make_codec("int8", stochastic=False)`, `make_codec("topk",
    ratio=0.05)`, ..."""
    if name not in CODECS:
        raise ValueError(f"unknown codec {name!r}; available: {sorted(CODECS)}")
    return CODECS[name](**kwargs)
