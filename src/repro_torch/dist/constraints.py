"""Sharding hints inside the model forward passes, on one device.

The PyTorch counterpart of the JAX package's `repro.dist.constraints`,
with its signatures.  The reference turns each call into a
`with_sharding_constraint` on the active mesh and into the identity
without one (its CPU tests and the vmapped simulator).  The port's models
run on one card per node, and the multi-card backend moves whole node
blocks between `torch.distributed` ranks (`dist/dfl_step.py`), so no
tensor inside a forward pass is split over devices: every wrapper here is
the identity, as the reference's are without a mesh.  The model code calls
them where the reference does, so that sharding a model's weights and
activations over several cards (DTensor or FSDP, ROADMAP A.11.3) has its
hooks in place.
"""
from __future__ import annotations


def current_mesh():
    """The mesh the model code runs under: always None here, the
    reference's answer outside any `with mesh:` block (no tensor of a
    forward pass is split over devices)."""
    return None


def constrain_batch(x):
    """Dim 0 (batch) over the data-parallel axes: the identity here."""
    return x


def constrain_residual(x, kind: str = "batch"):
    """The residual stream [B, S, D], batch ("batch") or batch and
    sequence ("batch_seq") sharded: the identity here."""
    del kind
    return x


def constrain_logits(x):
    """Logits [B, S, V], batch over data and vocabulary over model: the
    identity here."""
    return x


def constrain_expert_sharded(h):
    """MoE dispatch buffers [B, E, C, D], experts over the model axis: the
    identity here."""
    return h


def gather_weights(layer_params):
    """One layer's weights gathered whole before use (ZeRO-3): the
    identity here, where every weight is whole on its card."""
    return layer_params
