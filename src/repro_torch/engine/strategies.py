"""Method strategies: the paper's aggregation roster behind one protocol.

An :class:`AggregationStrategy` is what a *method* does at the
communication step of Algorithm 1; local SGD, delivery masks and the
neighbour reduce are the engine's.  Each strategy carries ONE frozen
:class:`Capabilities` record (``kind``: "gossip" | "server" | "none";
``grad_exchange``: the CFA-GE second phase; ``layouts``) and two hooks:

  * ``init_state(exp)`` — the static per-node tensors it aggregates with;
  * ``flat_aggregate(exp, state, nb)`` — the update over a
    :class:`~repro_torch.engine.neighborhood.DenseNeighborhood`: one
    weighted neighbour reduce, then per-row scalar normalization on the
    flattened [R, D] model matrix.  A strategy without it supplies the
    padded-gather pair ``exchange`` / ``aggregate`` instead.

``Capabilities.transport`` (plain model gossip) says whether the method
may run over the `repro_torch.comm` transport.

A *method* (what users name in ``Experiment(method=...)``) is a
:class:`MethodSpec`: a strategy plus the loss ("ce" | "vt") and the init
coordination flag.  The registry holds the JAX package's roster.  `fedavg`
(server kind) and `cfa-ge` (gradient exchange) are registered so that
their names resolve, and `Experiment` raises NotImplementedError for them
until ROADMAP A.3 ports them (``pending`` names the item).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import ops
from repro_torch.utils.pytree import tree_map

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

    A gossip strategy implements ``flat_aggregate`` (the form every ported
    method has).  One without it (``flat_aggregate = None``) implements
    ``aggregate`` over the padded per-slot views that ``exchange`` gathers
    instead, which the engine then takes for its dense rounds."""

    name: str = "base"
    capabilities: Capabilities = Capabilities()
    #: the ROADMAP item that ports this strategy, while it is not ported
    pending: Optional[str] = None

    #: ``flat_aggregate(exp, state, nb)`` — the update over a
    #: DenseNeighborhood view; None means the padded-gather form only.
    flat_aggregate = None

    @property
    def kind(self) -> str:
        return self.capabilities.kind

    @property
    def supports_transport(self) -> bool:
        return self.capabilities.transport

    def init_state(self, exp) -> Dict[str, torch.Tensor]:
        """Per-node |D_i| and the combined ω_ij·|D_j| neighbour weights
        [N, max_deg] (the flat forms take theirs from the view's w)."""
        return {"counts": exp.counts.to(torch.float32),
                "weights": exp.nbr_weight}

    def exchange(self, exp, params, nbr_idx):
        """Neighbour exchange for the padded-gather form: stacked models
        [N, ...] -> per-slot views [N, max_deg, ...]."""
        return tree_map(lambda p: p[nbr_idx], params)

    def aggregate(self, exp, state, params, gathered, mask):
        """Padded-gather form: new models from `params` [N, ...],
        `gathered` [N, max_deg, ...] and `mask` [N, max_deg] {0,1}
        delivered this round."""
        raise NotImplementedError

    def __repr__(self):  # pragma: no cover - debugging nicety
        return f"{type(self).__name__}(name={self.name!r}, kind={self.kind!r})"


class IsolationStrategy(AggregationStrategy):
    """ISOL baseline: never communicate, keep the local model."""

    name = "isol"
    capabilities = Capabilities(kind="none")


class FedAvgStrategy(AggregationStrategy):
    """Server-side FedAvg over all clients (not ported yet)."""

    name = "fedavg"
    capabilities = Capabilities(kind="server")
    pending = "A.3"


class DecAvgStrategy(AggregationStrategy):
    """Eq. 4 coordinate-wise average of {local} ∪ {delivered neighbours},
    the local model weighted ω_ii·|D_i|."""

    name = "decavg"

    def flat_aggregate(self, exp, state, nb):
        sums, tot = nb.reduce()
        sw = state["counts"]
        total = tot + sw
        out = (sw / total)[:, None] * nb.local() + sums / total[:, None]
        return nb.unflatten(out)


class CFAStrategy(AggregationStrategy):
    """Eq. 9 consensus step (Savazzi et al.): w_i += ε Σ_j p_ij (w_j - w_i)."""

    name = "cfa"

    def flat_aggregate(self, exp, state, nb):
        sums, tot = nb.reduce_delta()
        na = nb.n_active()
        safe = torch.where(tot > 0, tot, torch.ones_like(tot))
        eps = torch.where(na > 0, 1.0 / torch.clamp(na, min=1.0),
                          torch.zeros_like(na))
        gate = (tot > 0).to(torch.float32)
        out = nb.local() + ((gate * eps) / safe)[:, None] * sums
        return nb.unflatten(out)


class CFAGEStrategy(CFAStrategy):
    """CFA + gradient exchange (the second phase is not ported yet)."""

    name = "cfa"
    capabilities = Capabilities(grad_exchange=True)
    pending = "A.3"


class DecDiffStrategy(AggregationStrategy):
    """The paper's proposal: Eq. 6 neighbourhood average (excluding self),
    then the Eq. 5 distance-attenuated step with damping s."""

    name = "decdiff"

    def flat_aggregate(self, exp, state, nb):
        sums, tot = nb.reduce()
        safe = torch.where(tot > 0, tot, torch.ones_like(tot))
        avg = sums / safe[:, None]
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
