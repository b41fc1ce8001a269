"""Method strategies: the paper's aggregation roster behind one protocol.

An :class:`AggregationStrategy` is what a *method* does at the
communication step of Algorithm 1; local SGD, delivery masks and the
neighbour reduce are the engine's.  Each strategy carries ONE frozen
:class:`Capabilities` record (``kind``: "gossip" | "server" | "none";
``grad_exchange``: the CFA-GE second phase; ``layouts``) and these hooks:

  * ``init_state(exp)`` — the static per-node tensors it aggregates with;
  * ``flat_aggregate(exp, state, nb)`` — the gossip update over a
    Neighborhood view (`engine/neighborhood.py`, either layout): one
    weighted neighbour reduce, then per-row scalar normalization on the
    flattened [R, D] model matrix.  Every built-in gossip method has it,
    and the engine lowers to it whenever it exists (the sparse layout
    has no other lowering);
  * ``exchange`` / ``aggregate`` — the padded-gather form: the per-slot
    neighbour views [R, max_deg, ...], then the update batched over the
    receivers (the weights normalized first, then one contraction through
    the segment reduce), as the reference's vmapped `core/aggregation.py`
    forms compute it.  A gossip strategy without a flat form runs this
    one; a "server" strategy (FedAvg) gets the full [N, ...] stack.

``Capabilities.transport`` (plain model gossip) says whether the method
may run over the `repro_torch.comm` transport; CFA-GE's gradient legs and
FedAvg's star may not.

A *method* (what users name in ``Experiment(method=...)``) is a
:class:`MethodSpec`: a strategy plus the loss ("ce" | "vt") and the init
coordination flag.  The registry holds the JAX package's roster, every
method runnable.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from repro_torch.core.aggregation import fedavg_aggregate
from repro_torch.kernels import ops
from repro_torch.utils.pytree import (tree_flatten_stacked, tree_leaves,
                                      tree_map)

KINDS = ("gossip", "server", "none")
LAYOUTS = ("dense", "sparse")


@dataclasses.dataclass(frozen=True)
class Capabilities:
    """What a strategy's communication step IS, validated on construction."""

    kind: str = "gossip"
    grad_exchange: bool = False
    layouts: Tuple[str, ...] = LAYOUTS

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"Capabilities.kind must be one of {KINDS}, "
                             f"got {self.kind!r}")
        if self.grad_exchange and self.kind != "gossip":
            raise ValueError(
                f"grad_exchange walks the neighbour table, so it requires "
                f"kind='gossip', got kind={self.kind!r}")
        layouts = tuple(self.layouts)
        if not layouts or any(lo not in LAYOUTS for lo in layouts):
            raise ValueError(
                f"Capabilities.layouts must be a non-empty subset of "
                f"{LAYOUTS}, got {self.layouts!r}")
        object.__setattr__(self, "layouts", layouts)

    @property
    def transport(self) -> bool:
        """Can the neighbour exchange ride the repro_torch.comm gossip
        transport?  True exactly for plain model-gossip: transport payload
        state models *model* traffic, not CFA-GE's extra gradient legs or
        FedAvg's star."""
        return self.kind == "gossip" and not self.grad_exchange


class AggregationStrategy:
    """Base strategy: stateless; per-experiment tensors live in `state`.

    A gossip strategy implements ``flat_aggregate`` (the form every
    built-in one has) and may implement ``aggregate`` over the padded
    per-slot views that ``exchange`` gathers; one without a flat form
    (``flat_aggregate = None``) must implement ``aggregate``, which the
    engine then takes for its dense rounds."""

    name: str = "base"
    capabilities: Capabilities = Capabilities()

    #: ``flat_aggregate(exp, state, nb)`` — the update over a
    #: Neighborhood view; None means the padded-gather form only.
    flat_aggregate = None

    @property
    def kind(self) -> str:
        return self.capabilities.kind

    @property
    def supports_transport(self) -> bool:
        return self.capabilities.transport

    def init_state(self, exp) -> Dict[str, torch.Tensor]:
        """Per-node |D_i| and, on the dense layout, the combined ω_ij·|D_j|
        neighbour weights [N, max_deg] (the flat forms take theirs from the
        view's w; the sparse plan carries the edge weights)."""
        state = {"counts": exp.counts.to(torch.float32)}
        if exp.nbr_weight is not None:
            state["weights"] = exp.nbr_weight
        return state

    def exchange(self, exp, params, nbr_idx):
        """Neighbour exchange for the padded-gather form: stacked models
        [N, ...] -> per-slot views [N, max_deg, ...]."""
        return tree_map(lambda p: p[nbr_idx], params)

    def aggregate(self, exp, state, params, gathered, mask):
        """Padded-gather form: new models from `params` [R, ...],
        `gathered` [R, max_deg, ...] and `mask` [R, max_deg] {0,1}
        delivered this round (for a "server" strategy: `gathered` the full
        [N, ...] stack and `mask` None or the [N] live clients)."""
        raise NotImplementedError

    def __repr__(self):  # pragma: no cover - debugging nicety
        return f"{type(self).__name__}(name={self.name!r}, kind={self.kind!r})"


def _padded(params, gathered):
    """(local [R, D], slot values [R, K, D], unflatten) in fp32, the flat
    order of `tree_flatten_stacked`."""
    local, unflatten = tree_flatten_stacked(params)
    r, d = local.shape
    leaves = tree_leaves(gathered)
    k = leaves[0].shape[1]
    vals = torch.cat([t.reshape(r, k, -1).to(torch.float32)
                      for t in leaves], dim=2)
    if vals.shape[2] != d:
        raise ValueError(f"gathered slots hold {vals.shape[2]} params per "
                         f"model, the local models {d}")
    return local, vals, unflatten


def _safe(total):
    return torch.where(total > 0, total, torch.ones_like(total))


class IsolationStrategy(AggregationStrategy):
    """ISOL baseline: never communicate, keep the local model."""

    name = "isol"
    capabilities = Capabilities(kind="none")

    def aggregate(self, exp, state, params, gathered, mask):
        del state, gathered, mask
        return params


class FedAvgStrategy(AggregationStrategy):
    """Server-side FedAvg over ALL clients (the partially-decentralized FED
    baseline): the |D_i|-weighted average through the `neighbor_avg`
    kernel, written into every node's row.  `mask` is None, or the [N]
    {0,1} live clients under a dynamics process, whose zero weight keeps a
    churned-out client's frozen params out of the average (the engine
    keeps the dead rows by a select, so an all-dead round's 0/0 average
    reaches no row)."""

    name = "fedavg"
    capabilities = Capabilities(kind="server")

    def aggregate(self, exp, state, params, gathered, mask):
        counts = state["counts"] if mask is None else state["counts"] * mask
        avg = fedavg_aggregate(gathered, counts)
        # one materialized copy per node row: an expanded view would make
        # every node one storage, and the in-place SGD of the next local
        # step would then write all of them at once
        return tree_map(lambda a, p: torch.empty_like(p).copy_(a.to(p.dtype)),
                        avg, params)


class DecAvgStrategy(AggregationStrategy):
    """Eq. 4 coordinate-wise average of {local} ∪ {delivered neighbours},
    the local model weighted ω_ii·|D_i|."""

    name = "decavg"

    def aggregate(self, exp, state, params, gathered, mask):
        local, vals, unflatten = _padded(params, gathered)
        w = state["weights"] * mask
        sw = state["counts"]
        total = torch.sum(w, dim=1) + sw
        neigh, _ = ops.segment_neighbor_avg(
            vals, (w / total[:, None]).contiguous())
        return unflatten((sw / total)[:, None] * local + neigh)

    def flat_aggregate(self, exp, state, nb):
        sums, tot = nb.reduce()
        sw = state["counts"]
        total = tot + sw
        out = (sw / total)[:, None] * nb.local() + sums / total[:, None]
        return nb.unflatten(out)


class CFAStrategy(AggregationStrategy):
    """Eq. 9 consensus step (Savazzi et al.): w_i += ε Σ_j p_ij (w_j - w_i)."""

    name = "cfa"

    def aggregate(self, exp, state, params, gathered, mask):
        local, vals, unflatten = _padded(params, gathered)
        w = state["weights"] * mask
        total = torch.sum(w, dim=1)
        p = (w / _safe(total)[:, None]).contiguous()
        na = torch.sum((w > 0).to(torch.float32), dim=1)
        eps = torch.where(na > 0, 1.0 / torch.clamp(na, min=1.0),
                          torch.zeros_like(na))
        gate = (total > 0).to(torch.float32)
        delta, _ = ops.segment_neighbor_avg(
            (vals - local[:, None, :]).contiguous(), p)
        return unflatten(local + (gate * eps)[:, None] * delta)

    def flat_aggregate(self, exp, state, nb):
        sums, tot = nb.reduce_delta()
        na = nb.n_active()
        safe = _safe(tot)
        eps = torch.where(na > 0, 1.0 / torch.clamp(na, min=1.0),
                          torch.zeros_like(na))
        gate = (tot > 0).to(torch.float32)
        out = nb.local() + ((gate * eps) / safe)[:, None] * sums
        return nb.unflatten(out)


class CFAGEStrategy(CFAStrategy):
    """CFA + gradient exchange: the engine runs the second phase
    (neighbour gradients of OUR aggregated model on THEIR data) when this
    capability is set — doubling communication twice over, the paper's
    efficiency foil."""

    name = "cfa"  # the aggregation IS Eq. 9; the exchange capability differs
    capabilities = Capabilities(grad_exchange=True)


class DecDiffStrategy(AggregationStrategy):
    """The paper's proposal: Eq. 6 neighbourhood average (excluding self),
    then the Eq. 5 distance-attenuated step with damping s."""

    name = "decdiff"

    def aggregate(self, exp, state, params, gathered, mask):
        local, vals, unflatten = _padded(params, gathered)
        w = state["weights"] * mask
        total = torch.sum(w, dim=1)
        avg, _ = ops.segment_neighbor_avg(
            vals, (w / _safe(total)[:, None]).contiguous())
        (out,) = ops.decdiff_rows([local], [avg], total, exp.train.s)
        return unflatten(out)

    def flat_aggregate(self, exp, state, nb):
        sums, tot = nb.reduce()
        avg = sums / _safe(tot)[:, None]
        # Eq. 5 with one norm per receiver, gated on tot > 0 (a node that
        # heard from nobody keeps its model): the decdiff_update kernels
        (out,) = ops.decdiff_rows([nb.local()], [avg], tot, exp.train.s)
        return nb.unflatten(out)


# --------------------------------------------------------------- registry

@dataclasses.dataclass(frozen=True)
class MethodSpec:
    """A runnable method: strategy + loss + init coordination."""

    name: str
    strategy: AggregationStrategy
    loss: str = "ce"            # "ce" | "vt" (virtual teacher, Eq. 7-8)
    common_init: bool = False   # True = coordinated init (FedAvg/DecAvg)


_REGISTRY: Dict[str, MethodSpec] = {}


def register_method(name: str, strategy: AggregationStrategy, *,
                    loss: str = "ce", common_init: bool = False,
                    overwrite: bool = False) -> MethodSpec:
    """Register a method so `Experiment(method=name)` can run it."""
    if not isinstance(strategy, AggregationStrategy):
        raise TypeError(f"strategy must be an AggregationStrategy instance, "
                        f"got {type(strategy).__name__}")
    if not isinstance(strategy.capabilities, Capabilities):
        raise TypeError(
            f"method {name!r}: strategy.capabilities must be a Capabilities "
            f"record, got {type(strategy.capabilities).__name__}")
    if name in _REGISTRY and not overwrite:
        raise ValueError(f"method {name!r} is already registered "
                         f"(pass overwrite=True to replace it)")
    spec = MethodSpec(name=name, strategy=strategy, loss=loss,
                      common_init=common_init)
    _REGISTRY[name] = spec
    return spec


def get_method(name: str) -> MethodSpec:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown method {name!r}; available: {sorted(_REGISTRY)}"
        ) from None


def available_methods() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


_ISOL = IsolationStrategy()
_FEDAVG = FedAvgStrategy()
_DECAVG = DecAvgStrategy()
_CFA = CFAStrategy()
_CFAGE = CFAGEStrategy()
_DECDIFF = DecDiffStrategy()

register_method("isol", _ISOL)
register_method("fedavg", _FEDAVG, common_init=True)
register_method("decavg", _DECAVG, common_init=True)
register_method("dechetero", _DECAVG)
register_method("cfa", _CFA)
register_method("cfa-ge", _CFAGE)
register_method("decdiff", _DECDIFF)
register_method("decdiff+vt", _DECDIFF, loss="vt")
register_method("dechetero+vt", _DECAVG, loss="vt")
register_method("cfa+vt", _CFA, loss="vt")
register_method("fedavg+vt", _FEDAVG, loss="vt", common_init=True)
register_method("decdiff+vt+coord", _DECDIFF, loss="vt", common_init=True)
