"""Event-clock models: per-node step time, per-edge latency + bandwidth
(the JAX package's `repro.timing.models`, its tables as torch tensors).

The paper's coordination-free setting has no central clock, yet a
synchronous round schedule advances every node in lock-step.  This module
prices a round in SIMULATED SECONDS instead:

  * a :class:`NodeTimeModel` gives every node the wall-clock cost of ONE
    local SGD step (constant, lognormal-heterogeneous, straggler-tiered or
    read from a trace table);
  * a :class:`LinkTimeModel` gives every directed edge a latency and a
    bandwidth, so a payload of ``payload_bytes`` (the codec's exact bytes on
    the wire) needs ``latency + bytes / bandwidth`` seconds to cross it.

:class:`Timing` packages one of each; ``Timing.bind(topo, payload_bytes,
device)`` freezes them against a topology into a :class:`BoundTiming`: the
per-node ``step_time(round_idx) -> [N]`` schedule and the per-edge
``transfer`` seconds, flat ``[E]`` in the canonical CSR directed-edge order
and, for a dense `Topology`, also the padded ``[N, max_deg]`` receiver
panel scattered from the same enumeration, so the two layouts agree bit
for bit on one graph.

Every stochastic model draws with NUMPY at bind time, keyed by its own
``seed``, in the reference's order, so its tables are bitwise the
reference's and binding consumes nothing of the experiment's generator.
Per-edge draws are one draw per UNDIRECTED pair in canonical ascending
``(lo, hi)`` order, mirrored onto both directed records.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.graphs.sparse import SparseTopology

PAST_END = ("wrap", "clamp")


def past_end_index(round_idx: int, length: int, past_end: str) -> int:
    """The shared period/clamp rule for ``[T, ...]`` schedule tables past
    the table end: ``wrap`` repeats the table periodically, ``clamp`` holds
    the last row forever.  The port's rounds take a Python int index."""
    r = int(round_idx)
    if past_end == "wrap":
        return r % length
    return min(r, length - 1)


def _check_past_end(past_end: str):
    if past_end not in PAST_END:
        raise ValueError(f"past_end must be one of {PAST_END}, "
                         f"got {past_end!r}")


# ----------------------------------------------------------- node models

class NodeTimeModel:
    """Protocol: the wall-clock seconds ONE local SGD step costs per node.

    ``bind(n, device)`` freezes the model against an ``n``-node world and
    returns ``step_time(round_idx) -> [N] float32`` on `device`: strictly
    positive seconds, a pure function of the round index."""

    def step_table(self, n: int) -> np.ndarray:
        """The [N] float32 seconds per step of a round-invariant model."""
        raise NotImplementedError

    def bind(self, n: int, device: DeviceLike = None) -> Callable:
        dt = torch.from_numpy(self.step_table(n)).to(resolve_device(device))
        return lambda round_idx: dt


def _positive(name: str, v: float):
    if not v > 0:
        raise ValueError(f"{name} must be > 0, got {v}")


@dataclasses.dataclass(frozen=True)
class ConstantStep(NodeTimeModel):
    """Every node takes ``dt`` seconds per local step: the homogeneous
    baseline (and half of the degenerate model that must reproduce the
    synchronous engine bit for bit)."""

    dt: float = 1.0

    def __post_init__(self):
        _positive("dt", self.dt)

    def step_table(self, n: int) -> np.ndarray:
        return np.full((n,), self.dt, np.float32)


@dataclasses.dataclass(frozen=True)
class LognormalStep(NodeTimeModel):
    """Static heterogeneous devices: node i's per-step time is one draw
    ``median * exp(sigma * z_i)``, z_i ~ N(0, 1), frozen for the run."""

    median: float = 1.0
    sigma: float = 0.5
    seed: int = 0

    def __post_init__(self):
        _positive("median", self.median)
        if self.sigma < 0:
            raise ValueError(f"sigma must be >= 0, got {self.sigma}")

    def step_table(self, n: int) -> np.ndarray:
        r = np.random.default_rng(self.seed)
        return (self.median * np.exp(self.sigma * r.standard_normal(n))
                ).astype(np.float32)


@dataclasses.dataclass(frozen=True)
class StragglerStep(NodeTimeModel):
    """A two-tier population: a ``frac`` fraction of nodes (chosen once,
    numpy-seeded) is ``factor`` x slower than the ``dt`` baseline."""

    dt: float = 1.0
    frac: float = 0.1
    factor: float = 8.0
    seed: int = 0

    def __post_init__(self):
        _positive("dt", self.dt)
        _positive("factor", self.factor)
        if not 0.0 <= self.frac <= 1.0:
            raise ValueError(f"frac must be in [0, 1], got {self.frac}")

    def slow_nodes(self, n: int) -> np.ndarray:
        """The straggler ids (deterministic in ``seed``)."""
        k = int(round(self.frac * n))
        if k == 0:
            return np.zeros((0,), np.int64)
        return np.sort(np.random.default_rng(self.seed)
                       .choice(n, size=k, replace=False))

    def step_table(self, n: int) -> np.ndarray:
        dt = np.full((n,), self.dt, np.float32)
        dt[self.slow_nodes(n)] *= self.factor
        return dt


@dataclasses.dataclass(frozen=True)
class TraceStep(NodeTimeModel):
    """Trace-table-driven step times: ``table[t, i]`` is node i's per-step
    seconds in round t.  Past the table end the ``past_end`` rule applies:
    ``"wrap"`` replays the trace periodically, ``"clamp"`` holds the last
    row."""

    table: Any  # [T, N] positive seconds (array-like)
    past_end: str = "wrap"

    def __post_init__(self):
        _check_past_end(self.past_end)
        tab = np.asarray(self.table, np.float32)
        if tab.ndim != 2 or tab.shape[0] < 1:
            raise ValueError(f"trace table must be [T >= 1, N], "
                             f"got shape {tab.shape}")
        if not (tab > 0).all():
            raise ValueError("trace step times must be strictly positive")

    def bind(self, n: int, device: DeviceLike = None) -> Callable:
        tab = np.asarray(self.table, np.float32)
        if tab.shape[1] != n:
            raise ValueError(f"trace table covers {tab.shape[1]} nodes, "
                             f"world has {n}")
        tab_t = torch.from_numpy(tab).to(resolve_device(device))
        t_len, past_end = int(tab.shape[0]), self.past_end

        def step_time(round_idx):
            return tab_t[past_end_index(round_idx, t_len, past_end)]

        return step_time


# ----------------------------------------------------------- link models

def _directed_edges(topo):
    """The canonical directed-edge enumeration both layouts share.

    Returns ``(src, dst, pair_id, num_pairs)`` with edges sorted by
    ``(dst, src)`` (the CSR order of a `SparseTopology` and the flattened
    valid-slot order of the dense padded layout) and ``pair_id[e]`` the
    undirected pair's index in ascending ``(lo, hi)`` order."""
    if isinstance(topo, SparseTopology):
        src = topo.edge_src.astype(np.int64)
        dst = topo.edge_dst.astype(np.int64)
    else:
        dst, src = np.nonzero(topo.adjacency)  # row-major = (dst, src) sort
        src, dst = src.astype(np.int64), dst.astype(np.int64)
    n = topo.num_nodes
    lo, hi = np.minimum(src, dst), np.maximum(src, dst)
    codes = np.unique(lo * n + hi)
    pair_id = np.searchsorted(codes, lo * n + hi)
    return src, dst, pair_id, int(codes.shape[0])


class LinkTimeModel:
    """Protocol: the seconds one payload needs to cross each directed edge.

    ``bind(topo, payload_bytes)`` returns ``latency_e + payload_bytes /
    bandwidth_e`` as a ``[num_directed]`` float32 numpy array in the
    canonical ``(dst, src)`` edge order of :func:`_directed_edges`."""

    def bind(self, topo, payload_bytes: float) -> np.ndarray:
        raise NotImplementedError


def _transfer(latency, bandwidth, payload_bytes: float) -> np.ndarray:
    lat = np.asarray(latency, np.float64)
    bw = np.asarray(bandwidth, np.float64)
    if (lat < 0).any():
        raise ValueError("latency must be >= 0")
    if not (bw > 0).all():
        raise ValueError("bandwidth must be > 0 (use float('inf') for an "
                         "infinitely fast link)")
    return (lat + payload_bytes / bw).astype(np.float32)


@dataclasses.dataclass(frozen=True)
class ConstantLink(LinkTimeModel):
    """Every link: fixed ``latency`` seconds plus ``payload / bandwidth``.
    The default (zero latency, infinite bandwidth) is the other half of
    the degenerate model: every payload lands instantly."""

    latency: float = 0.0
    bandwidth: float = float("inf")  # bytes per second

    def bind(self, topo, payload_bytes: float) -> np.ndarray:
        src, _, _, _ = _directed_edges(topo)
        t = _transfer(self.latency, self.bandwidth, payload_bytes)
        return np.full((src.shape[0],), float(t), np.float32)


@dataclasses.dataclass(frozen=True)
class LognormalLink(LinkTimeModel):
    """Heterogeneous links: per-UNDIRECTED-pair lognormal latency and
    bandwidth draws, mirrored onto both directed records, keyed by the
    canonical ascending ``(lo, hi)`` pair order."""

    latency_median: float = 0.01
    latency_sigma: float = 0.5
    bandwidth_median: float = 1e6
    bandwidth_sigma: float = 0.5
    seed: int = 0

    def __post_init__(self):
        _positive("latency_median", self.latency_median)
        _positive("bandwidth_median", self.bandwidth_median)
        for nm, v in (("latency_sigma", self.latency_sigma),
                      ("bandwidth_sigma", self.bandwidth_sigma)):
            if v < 0:
                raise ValueError(f"{nm} must be >= 0, got {v}")

    def bind(self, topo, payload_bytes: float) -> np.ndarray:
        _, _, pair_id, m = _directed_edges(topo)
        r = np.random.default_rng(self.seed)
        lat = self.latency_median * np.exp(
            self.latency_sigma * r.standard_normal(m))
        bw = self.bandwidth_median * np.exp(
            self.bandwidth_sigma * r.standard_normal(m))
        return _transfer(lat, bw, payload_bytes)[pair_id]


@dataclasses.dataclass(frozen=True)
class TableLink(LinkTimeModel):
    """Explicit per-edge latency / bandwidth tables.  Scalars broadcast;
    arrays are indexed by the canonical ``(dst, src)``-sorted directed-edge
    enumeration (CSR order)."""

    latency: Any = 0.0
    bandwidth: Any = float("inf")

    def bind(self, topo, payload_bytes: float) -> np.ndarray:
        src, _, _, _ = _directed_edges(topo)
        e = int(src.shape[0])
        lat = np.asarray(self.latency, np.float64)
        bw = np.asarray(self.bandwidth, np.float64)
        for nm, v in (("latency", lat), ("bandwidth", bw)):
            if v.ndim and v.shape != (e,):
                raise ValueError(
                    f"TableLink {nm} table has shape {v.shape}; the graph "
                    f"has {e} directed edges ((dst, src)-sorted)")
        return _transfer(np.broadcast_to(lat, (e,)),
                         np.broadcast_to(bw, (e,)), payload_bytes)


# ------------------------------------------------------------- the clock

class TimingState(NamedTuple):
    """The event clock's round-carried state, on the experiment's device.

    ``t`` is the absolute simulated time (seconds since round 0, a 0-d
    float32 tensor); ``last_cost`` the previous round's REALIZED per-node
    compute seconds (step time x trained steps), the observation an
    observing `GraphProcess` (``EnergyChurn``) reads, one round delayed."""

    t: torch.Tensor          # 0-d f32, absolute simulated seconds
    last_cost: torch.Tensor  # [N] f32, last round's realized compute seconds


@dataclasses.dataclass(frozen=True)
class BoundTiming:
    """A `Timing` frozen against a topology (see `Timing.bind`)."""

    timing: "Timing"
    payload_bytes: float
    step_time: Callable            # (round_idx) -> [N] f32 seconds per step
    transfer_e: torch.Tensor       # [num_directed] f32, canonical CSR order
    transfer_panel: Optional[torch.Tensor]  # [N, max_deg] f32 (dense)
    state0: TimingState

    @property
    def is_dense(self) -> bool:
        return self.transfer_panel is not None


@dataclasses.dataclass(frozen=True)
class Timing:
    """The event-clock configuration: one node model + one link model.

    The default ``Timing()`` is the DEGENERATE model (unit step time, zero
    latency, infinite bandwidth), which the engine reproduces bitwise equal
    to running with no timing at all; ``Schedule(deadline=None)`` then only
    adds a simulated-seconds axis to the same run."""

    node: NodeTimeModel = dataclasses.field(default_factory=ConstantStep)
    link: LinkTimeModel = dataclasses.field(default_factory=ConstantLink)

    def bind(self, topo, payload_bytes: float,
             device: DeviceLike = None) -> BoundTiming:
        """Freeze against ``topo`` (dense `Topology` or `SparseTopology`) and
        a per-payload byte size (the transport's exact ``payload_bytes``, or
        the dense fp32 model size without one), on `device`."""
        if not isinstance(self.node, NodeTimeModel):
            raise TypeError(f"Timing.node must be a NodeTimeModel, "
                            f"got {type(self.node).__name__}")
        if not isinstance(self.link, LinkTimeModel):
            raise TypeError(f"Timing.link must be a LinkTimeModel, "
                            f"got {type(self.link).__name__}")
        dev = resolve_device(device)
        n = topo.num_nodes
        transfer = np.asarray(self.link.bind(topo, float(payload_bytes)),
                              np.float32)
        panel = None
        if not isinstance(topo, SparseTopology):
            # scatter the canonical (dst, src)-ordered transfer times into
            # the padded receiver panel: slot e of receiver r is r's e-th
            # in-edge sender-ascending, i.e. canonical edge offsets[r] + e.
            valid = topo.neighbor_mask.astype(bool)
            deg = valid.sum(axis=1).astype(np.int64)
            offsets = np.concatenate([np.zeros(1, np.int64), np.cumsum(deg)])
            panel_np = np.zeros(valid.shape, np.float32)
            for r_i in range(n):
                panel_np[r_i, :deg[r_i]] = \
                    transfer[offsets[r_i]:offsets[r_i + 1]]
            panel = torch.from_numpy(panel_np).to(dev)
        state0 = TimingState(
            t=torch.zeros((), dtype=torch.float32, device=dev),
            last_cost=torch.zeros((n,), dtype=torch.float32, device=dev))
        return BoundTiming(timing=self, payload_bytes=float(payload_bytes),
                           step_time=self.node.bind(n, dev),
                           transfer_e=torch.from_numpy(transfer).to(dev),
                           transfer_panel=panel, state0=state0)


NODE_MODELS = {
    "constant": ConstantStep,
    "lognormal": LognormalStep,
    "straggler": StragglerStep,
    "trace": TraceStep,
}

LINK_MODELS = {
    "constant": ConstantLink,
    "lognormal": LognormalLink,
    "table": TableLink,
}


def make_node_model(name: str, **kwargs) -> NodeTimeModel:
    """Build a catalog node model by name (kwargs to its constructor)."""
    try:
        cls = NODE_MODELS[name]
    except KeyError:
        raise ValueError(f"unknown node time model {name!r}; "
                         f"available: {sorted(NODE_MODELS)}") from None
    return cls(**kwargs)


def make_link_model(name: str, **kwargs) -> LinkTimeModel:
    """Build a catalog link model by name (kwargs to its constructor)."""
    try:
        cls = LINK_MODELS[name]
    except KeyError:
        raise ValueError(f"unknown link time model {name!r}; "
                         f"available: {sorted(LINK_MODELS)}") from None
    return cls(**kwargs)
