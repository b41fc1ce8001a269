"""Time-varying communication graphs as pure state transitions on the
device (the JAX package's `repro.dynamics.processes`).

A :class:`GraphProcess` turns a static topology into a per-round
*sequence* of edge masks whose state is a small tuple of tensors.  Bound to
a topology on a device, it gives a :class:`BoundProcess` with two parts per
round:

  * ``draw(gen) -> u``: for a random process, ONE ``torch.rand`` vector of
    ``[num_pairs]`` (per-edge processes) or ``[N]`` (node churn) from the
    experiment's generator — what the reference's one
    ``jax.random.uniform(key, shape)`` per round draws; None for a
    deterministic process, which draws nothing;
  * ``transition(state, round_idx, u[, obs]) -> (state, GraphEvent)``: a
    pure function of its arguments, so feeding it the reference's own
    uniforms reproduces the reference's sequence bit for bit.

A :class:`GraphEvent` is what one round realizes:

  * ``live``     — ``[N, max_deg]`` {0,1} in the padded layout (symmetric,
    a subset of ``neighbor_mask``) or ``[E]`` {0,1} over the CSR edge list
    (``live[e] == live[rev_edge[e]]``): which edges exist THIS round;
  * ``alive``    — ``[N]`` {0,1}: devices present this round.  A dead node
    runs no local steps, transmits nothing, receives nothing, and its
    params and optimizer state freeze bit-exactly;
  * ``rejoined`` — ``[N]`` {0,1}: devices dead last round and back now; the
    transports reset every per-link state incident to them.

The catalog (`make_process` names): ``static`` (the frozen topology; bitwise
equal to no dynamics), ``edge_dropout`` (i.i.d. per-round edge failures),
``gilbert_elliott`` (a 2-state Markov chain per undirected edge),
``node_churn`` (a 2-state chain per node; an edge is live iff both ends
are), ``periodic_rewiring`` (a family of graphs compiled against their
UNION layout, round r masking it down to graph ``(r // period) %
num_graphs``), ``scripted`` (replay of a recorded ``[T, ...]`` mask table)
and ``energy_churn`` (drift-adaptive churn that observes the event clock's
realized compute cost, one round delayed).

Both node-axis layouts run the same processes and agree bitwise: every
per-edge draw is ONE uniform per undirected pair, pairs enumerated in
ascending ``(lo, hi)`` order; the dense layout scatters the coin vector
through a pair-id panel, the sparse one through
:func:`repro_torch.graphs.sparse.undirected_pair_ids`.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Mapping, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.graphs.sparse import (
    _DENSE_GUARD,
    SparseTopology,
    make_sparse_topology,
    undirected_pair_ids,
)
from repro_torch.graphs.topology import Topology, _from_adjacency, make_topology
from repro_torch.timing.models import PAST_END, past_end_index


class GraphEvent(NamedTuple):
    """One round's realized graph (see module docstring)."""

    live: torch.Tensor      # [N, max_deg] (dense) or [E] (sparse) {0,1} f32
    alive: torch.Tensor     # [N] {0,1} f32
    rejoined: torch.Tensor  # [N] {0,1} f32 (dead last round, alive now)


@dataclasses.dataclass(frozen=True)
class BoundProcess:
    """A process bound to a topology on a device: the static layout the
    engine runs against, the initial state, the round's draw shape and the
    pure transition.  `stationary_live_frac` is the binding's long-run
    edge-live fraction when known (None otherwise)."""

    process: "GraphProcess"
    topo: Any                 # Topology or SparseTopology static layout
    state0: Any               # tuple of tensors (or a tensor, or ())
    transition: Callable      # (state, round_idx, u[, obs]) -> (state, ev)
    device: torch.device
    draw_shape: Optional[tuple] = None  # None: the process draws nothing
    stationary_live_frac: Optional[float] = None

    @property
    def name(self) -> str:
        return self.process.name

    @property
    def needs_rng(self) -> bool:
        return self.process.needs_rng

    @property
    def observes(self) -> bool:
        return self.process.observes

    def draw(self, gen: torch.Generator) -> Optional[torch.Tensor]:
        """The round's uniforms from `gen` (one tensor), or None."""
        if self.draw_shape is None:
            return None
        return torch.rand(self.draw_shape, generator=gen, device=self.device)


def _f32(v: float, dev) -> torch.Tensor:
    """A 0-d float32 constant, as the reference's `jnp.float32(v)`."""
    return torch.tensor(np.float32(v), device=dev)


def _layout(topo: Topology, dev):
    """The padded-neighbour tensors a transition closes over."""
    idx = torch.from_numpy(
        np.maximum(topo.neighbor_idx, 0).astype(np.int64)).to(dev)
    valid = torch.from_numpy(topo.neighbor_mask.astype(np.float32)).to(dev)
    return topo.num_nodes, idx, valid


def _num_pairs(topo) -> int:
    """The undirected pair count, the length of a per-edge coin vector."""
    if isinstance(topo, SparseTopology):
        return undirected_pair_ids(topo)[1]
    return int(np.count_nonzero(np.triu(topo.adjacency, 1)))


def _pair_layout(topo, dev):
    """Canonical undirected-pair coin plumbing, shared by both layouts.

    Returns ``(num_pairs, to_live)``: pairs in ascending ``(lo, hi)``
    order, identically for a dense Topology and the SparseTopology of the
    same graph; ``to_live`` scatters a ``[num_pairs]`` {0,1} coin vector
    into the binding's live-mask shape (``[N, max_deg]`` / ``[E]``)."""
    if isinstance(topo, SparseTopology):
        pid, m = undirected_pair_ids(topo)
        pid_t = torch.from_numpy(pid.astype(np.int64)).to(dev)

        def to_live(up):
            return up[pid_t]

        return m, to_live
    n, _, valid = _layout(topo, dev)
    iu, ju = np.nonzero(np.triu(topo.adjacency, 1))
    codes = iu.astype(np.int64) * n + ju  # row-major triu = (lo, hi) order
    m = int(codes.shape[0])
    if m == 0:
        return 0, lambda up: torch.zeros_like(valid)
    idx = np.maximum(topo.neighbor_idx, 0).astype(np.int64)
    rows = np.arange(n, dtype=np.int64)[:, None]
    pcode = np.minimum(rows, idx) * n + np.maximum(rows, idx)
    panel = torch.from_numpy(
        np.clip(np.searchsorted(codes, pcode), 0, m - 1).astype(np.int64)
    ).to(dev)

    def to_live(up):
        return up[panel] * valid  # padding slots hit pair 0; valid zeroes them

    return m, to_live


def _pair_coords(topo):
    """The canonical undirected pair (lo, hi) node coordinates, in the
    order `_pair_layout` enumerates (how a recorded ``[T, N, N]`` adjacency
    table is read down to per-pair coins)."""
    n = topo.num_nodes
    if isinstance(topo, SparseTopology):
        lo = np.minimum(topo.edge_src, topo.edge_dst).astype(np.int64)
        hi = np.maximum(topo.edge_src, topo.edge_dst).astype(np.int64)
        codes = np.unique(lo * n + hi)
        return codes // n, codes % n
    iu, ju = np.nonzero(np.triu(topo.adjacency, 1))
    return iu.astype(np.int64), ju.astype(np.int64)


def _live_layout(topo, dev):
    """Per-layout aliveness plumbing: ``(n, all_live, live_from_alive)``;
    ``live_from_alive`` maps an ``[N]`` {0,1} aliveness vector to the live
    mask (endpoint AND: exact {0,1} products, so the layouts agree)."""
    if isinstance(topo, SparseTopology):
        src = torch.from_numpy(topo.edge_src.astype(np.int64)).to(dev)
        dst = torch.from_numpy(topo.edge_dst.astype(np.int64)).to(dev)
        all_live = torch.ones((topo.num_directed,), dtype=torch.float32,
                              device=dev)

        def from_alive(alive):
            return alive[src] * alive[dst]

        return topo.num_nodes, all_live, from_alive
    n, idx, valid = _layout(topo, dev)

    def from_alive(alive):
        return valid * alive[:, None] * alive[idx]

    return n, valid, from_alive


def _ones_zeros(n: int, dev):
    return (torch.ones((n,), dtype=torch.float32, device=dev),
            torch.zeros((n,), dtype=torch.float32, device=dev))


class GraphProcess:
    """Protocol: a topology-to-sequence-of-graphs generator.

    Subclasses override :meth:`prepare` (only rewiring changes the layout),
    :meth:`init_state`, :meth:`draw_shape` and :meth:`make_transition`;
    users call :meth:`bind` once.  ``needs_rng = False`` marks a
    deterministic transition: the engine then draws nothing, which is what
    makes ``StaticGraph`` bitwise equal to running without dynamics.
    ``observes = True`` marks a process whose transition takes a fourth
    ``obs`` argument, the event clock's per-node ``[N]`` float32 realized
    compute seconds of the previous round."""

    name: str = "graph-process"
    needs_rng: bool = True
    observes: bool = False

    def bind(self, topo, device: DeviceLike = None) -> BoundProcess:
        """Bind to a dense Topology or a SparseTopology on `device` (the
        live-mask layout follows the binding)."""
        dev = resolve_device(device)
        prepared = self.prepare(topo)
        return BoundProcess(process=self, topo=prepared,
                            state0=self.init_state(prepared, dev),
                            transition=self.make_transition(prepared, dev),
                            device=dev,
                            draw_shape=(self.draw_shape(prepared)
                                        if self.needs_rng else None),
                            stationary_live_frac=self.stationary_live_frac())

    # ---------------------------------------------------------------- hooks
    def prepare(self, topo):
        """The static layout the engine runs against (default: the world's
        own topology; rewiring returns the family's union graph)."""
        return topo

    def init_state(self, topo, dev):
        """Initial state (a tensor or a tuple of tensors; () if stateless)."""
        return ()

    def draw_shape(self, topo) -> tuple:
        """The shape of the round's uniform vector (random processes)."""
        raise NotImplementedError

    def make_transition(self, topo, dev) -> Callable:
        raise NotImplementedError

    def stationary_live_frac(self) -> Optional[float]:
        """Closed-form long-run fraction of EDGES live per round, when one
        exists (None otherwise)."""
        return None

    def __repr__(self):
        return f"{type(self).__name__}()"


@dataclasses.dataclass(frozen=True)
class StaticGraph(GraphProcess):
    """The frozen graph, every round: the identity process, bitwise equal
    to ``dynamics=None`` (no draw; the live mask is the neighbour mask)."""

    name = "static"
    needs_rng = False

    def make_transition(self, topo, dev):
        n, all_live, _ = _live_layout(topo, dev)
        ones, zeros = _ones_zeros(n, dev)

        def transition(state, round_idx, u):
            del round_idx, u
            return state, GraphEvent(live=all_live, alive=ones,
                                     rejoined=zeros)

        return transition

    def stationary_live_frac(self) -> float:
        return 1.0


@dataclasses.dataclass(frozen=True)
class EdgeDropout(GraphProcess):
    """i.i.d. edge dropout: every undirected edge is down with probability
    ``p`` each round, independently across edges and rounds."""

    p: float = 0.2

    name = "edge_dropout"

    def __post_init__(self):
        if not 0.0 <= self.p < 1.0:
            raise ValueError(f"drop probability must be in [0, 1), got {self.p}")

    def draw_shape(self, topo):
        return (_num_pairs(topo),)

    def make_transition(self, topo, dev):
        _, to_live = _pair_layout(topo, dev)
        ones, zeros = _ones_zeros(topo.num_nodes, dev)
        p = _f32(self.p, dev)

        def transition(state, round_idx, u):
            del round_idx
            up = (u >= p).to(torch.float32)
            return state, GraphEvent(live=to_live(up), alive=ones,
                                     rejoined=zeros)

        return transition

    def stationary_live_frac(self) -> float:
        return 1.0 - self.p


@dataclasses.dataclass(frozen=True)
class GilbertElliott(GraphProcess):
    """Bursty links: a 2-state (good/bad) Markov chain PER undirected edge.
    From good a link fails with probability ``p_gb``; from bad it recovers
    with probability ``p_bg``.  All links start good; the stationary
    up-rate is ``p_bg / (p_gb + p_bg)``, the mean outage ``1 / p_bg``
    rounds."""

    p_gb: float = 0.1   # P(good -> bad): burst onset
    p_bg: float = 0.3   # P(bad -> good): burst recovery

    name = "gilbert_elliott"

    def __post_init__(self):
        for nm, v in (("p_gb", self.p_gb), ("p_bg", self.p_bg)):
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"{nm} must be in [0, 1], got {v}")
        if self.p_bg == 0.0:
            raise ValueError("p_bg = 0 makes every outage permanent; use "
                             "edge removal in the topology instead")

    def init_state(self, topo, dev):
        # one chain per undirected pair, all good: the same [num_pairs]
        # vector on either layout
        return torch.ones((_num_pairs(topo),), dtype=torch.float32,
                          device=dev)

    def draw_shape(self, topo):
        return (_num_pairs(topo),)

    def make_transition(self, topo, dev):
        _, to_live = _pair_layout(topo, dev)
        ones, zeros = _ones_zeros(topo.num_nodes, dev)
        p_gb, p_bg = _f32(self.p_gb, dev), _f32(self.p_bg, dev)

        def transition(up, round_idx, u):
            del round_idx
            new_up = torch.where(up > 0, u >= p_gb, u < p_bg).to(
                torch.float32)
            return new_up, GraphEvent(live=to_live(new_up), alive=ones,
                                      rejoined=zeros)

        return transition

    def stationary_live_frac(self) -> float:
        return self.p_bg / (self.p_gb + self.p_bg)


@dataclasses.dataclass(frozen=True)
class NodeChurn(GraphProcess):
    """Device churn: each node leaves w.p. ``p_leave`` and rejoins w.p.
    ``p_rejoin`` per round (independent 2-state chains).  An edge is live
    iff both endpoints are alive; a rejoined node is flagged so the
    transports reset every per-link state incident to it.  Stationary
    aliveness ``p_rejoin / (p_leave + p_rejoin)``; the stationary edge-live
    fraction is its square."""

    p_leave: float = 0.05
    p_rejoin: float = 0.5

    name = "node_churn"

    def __post_init__(self):
        if not 0.0 <= self.p_leave < 1.0:
            raise ValueError(f"p_leave must be in [0, 1), got {self.p_leave}")
        if not 0.0 < self.p_rejoin <= 1.0:
            raise ValueError(f"p_rejoin must be in (0, 1] (a device that "
                             f"never rejoins is a smaller world), got "
                             f"{self.p_rejoin}")

    def init_state(self, topo, dev):
        return torch.ones((topo.num_nodes,), dtype=torch.float32,
                          device=dev)  # everyone present

    def draw_shape(self, topo):
        return (topo.num_nodes,)

    def make_transition(self, topo, dev):
        _, _, from_alive = _live_layout(topo, dev)
        p_leave, p_rejoin = _f32(self.p_leave, dev), _f32(self.p_rejoin, dev)

        def transition(alive, round_idx, u):
            del round_idx
            new_alive = torch.where(alive > 0, u >= p_leave,
                                    u < p_rejoin).to(torch.float32)
            rejoined = (1.0 - alive) * new_alive
            return new_alive, GraphEvent(live=from_alive(new_alive),
                                         alive=new_alive, rejoined=rejoined)

        return transition

    def stationary_alive_frac(self) -> float:
        """Long-run fraction of devices present."""
        return self.p_rejoin / (self.p_leave + self.p_rejoin)

    def stationary_live_frac(self) -> float:
        a = self.stationary_alive_frac()
        return a * a  # endpoint chains are independent


@dataclasses.dataclass(frozen=True)
class PeriodicRewiring(GraphProcess):
    """Deterministic periodic re-draws from a topology family.

    ``num_graphs`` graphs are drawn at bind time (default: Watts–Strogatz
    with per-graph seeds ``seed + 9176 g``), the engine runs against their
    UNION layout, and round r masks the union down to graph ``(r // period)
    % num_graphs``: the padded panel (or the union's flat edge list) and
    every per-edge state tensor stay fixed, only the mask row changes.  The
    base topology contributes its node count only."""

    period: int = 5
    num_graphs: int = 4
    topology: str = "watts_strogatz"
    seed: int = 0
    topo_kwargs: Mapping = dataclasses.field(default_factory=dict)

    name = "periodic_rewiring"
    needs_rng = False

    def __post_init__(self):
        if self.period < 1:
            raise ValueError(f"period must be >= 1, got {self.period}")
        if self.num_graphs < 1:
            raise ValueError(f"num_graphs must be >= 1, got {self.num_graphs}")

    def _kwargs(self):
        kw = dict(self.topo_kwargs)
        if self.topology == "watts_strogatz":
            kw.setdefault("k", 4)
            kw.setdefault("p", 0.1)
        return kw

    def _family(self, n: int):
        return [make_topology(self.topology, n=n, seed=self.seed + 9176 * g,
                              **self._kwargs())
                for g in range(self.num_graphs)]

    def _union_dense(self, n: int):
        family = self._family(n)
        union_adj = np.zeros((n, n), np.int8)
        for t in family:
            union_adj = np.maximum(union_adj, t.adjacency)
        union = _from_adjacency(
            f"rewire_union({self.topology},K={self.num_graphs},n={n})",
            union_adj)
        idx = np.maximum(union.neighbor_idx, 0)
        rows = np.arange(n)[:, None]
        masks = np.stack([
            t.adjacency[rows, idx].astype(np.float32) * union.neighbor_mask
            for t in family
        ])  # [K, N, max_deg]: graph g's edges in the union layout
        return union, masks, float(max(union.neighbor_mask.sum(), 1))

    def _union_sparse(self, n: int):
        # Below the densify guard, draw the SAME dense family, so the union
        # graph and masks match the dense binding edge for edge; above it,
        # the vectorized sparse samplers (another random stream).
        fam_codes = []
        if n <= _DENSE_GUARD:
            for t in self._family(n):
                iu, ju = np.nonzero(np.triu(t.adjacency, 1))
                fam_codes.append(iu.astype(np.int64) * n + ju)
        else:
            for g in range(self.num_graphs):
                t = make_sparse_topology(self.topology, n=n,
                                         seed=self.seed + 9176 * g,
                                         **self._kwargs())
                lo = np.minimum(t.edge_src, t.edge_dst).astype(np.int64)
                hi = np.maximum(t.edge_src, t.edge_dst).astype(np.int64)
                fam_codes.append(np.unique(lo * n + hi))
        union_codes = np.unique(np.concatenate(fam_codes))
        union = SparseTopology.from_pairs(
            f"rewire_union({self.topology},K={self.num_graphs},n={n})",
            n, union_codes // n, union_codes % n)
        ecode = (np.minimum(union.edge_src, union.edge_dst).astype(np.int64)
                 * n + np.maximum(union.edge_src, union.edge_dst))
        masks = np.stack([np.isin(ecode, c).astype(np.float32)
                          for c in fam_codes])  # [K, E] directed-edge masks
        return union, masks, float(max(union.num_directed, 1))

    def bind(self, topo, device: DeviceLike = None) -> BoundProcess:
        dev = resolve_device(device)
        n = topo.num_nodes
        if isinstance(topo, SparseTopology):
            union, masks, denom = self._union_sparse(n)
        else:
            union, masks, denom = self._union_dense(n)
        masks_t = torch.from_numpy(masks).to(dev)
        ones, zeros = _ones_zeros(n, dev)
        period, k = self.period, self.num_graphs

        def transition(state, round_idx, u):
            del u
            g = (int(round_idx) // period) % k
            return state, GraphEvent(live=masks_t[g], alive=ones,
                                     rejoined=zeros)

        return BoundProcess(
            process=self, topo=union, state0=(), transition=transition,
            device=dev,
            stationary_live_frac=float(masks.mean(axis=0).sum() / denom))

    def stationary_live_frac(self) -> Optional[float]:
        """None: the live fraction is a property of the BINDING (the union
        layout defines the denominator); read it off
        `BoundProcess.stationary_live_frac` after `bind(topo)`."""
        return None


@dataclasses.dataclass(frozen=True)
class ScriptedGraph(GraphProcess):
    """Mask-table replay: round r realizes row ``tables[r]`` of a recorded
    live-mask schedule, either ``[T, num_pairs]`` {0,1} coins over the
    canonical ascending ``(lo, hi)`` pair enumeration or ``[T, N, N]``
    {0,1} symmetric adjacency matrices (read down to per-pair coins at the
    static topology's pair coordinates).  Past the table end the
    ``past_end`` rule applies (``"wrap"`` / ``"clamp"``)."""

    tables: Any  # [T, num_pairs] pair coins or [T, N, N] adjacency, {0,1}
    past_end: str = "wrap"

    name = "scripted"
    needs_rng = False

    def __post_init__(self):
        if self.past_end not in PAST_END:
            raise ValueError(f"past_end must be one of {PAST_END}, "
                             f"got {self.past_end!r}")
        tab = np.asarray(self.tables, np.float32)
        if tab.ndim not in (2, 3) or tab.shape[0] < 1:
            raise ValueError(f"tables must be [T >= 1, num_pairs] or "
                             f"[T >= 1, N, N], got shape {tab.shape}")
        if tab.ndim == 3 and tab.shape[1] != tab.shape[2]:
            raise ValueError(f"adjacency tables must be square per round, "
                             f"got shape {tab.shape}")
        if not np.isin(tab, (0.0, 1.0)).all():
            raise ValueError("scripted masks must be {0, 1}")

    def _coins(self, topo) -> np.ndarray:
        """The [T, num_pairs] coin table in canonical pair order."""
        tab = np.asarray(self.tables, np.float32)
        m = _num_pairs(topo)
        if tab.ndim == 2:
            if tab.shape[1] != m:
                raise ValueError(
                    f"pair-coin tables cover {tab.shape[1]} pairs, the "
                    f"bound topology has {m} (canonical ascending (lo, hi) "
                    f"order)")
            return tab
        if tab.shape[1] != topo.num_nodes:
            raise ValueError(f"adjacency tables cover {tab.shape[1]} nodes, "
                             f"world has {topo.num_nodes}")
        asym = np.abs(tab - np.transpose(tab, (0, 2, 1)))
        if asym.max() > 0:
            raise ValueError("adjacency tables must be symmetric (an "
                             "undirected edge is up or down for both "
                             "endpoints)")
        lo, hi = _pair_coords(topo)
        return tab[:, lo, hi]

    def make_transition(self, topo, dev):
        _, to_live = _pair_layout(topo, dev)
        coins = torch.from_numpy(np.ascontiguousarray(self._coins(topo))
                                 ).to(dev)
        t_len, past_end = int(coins.shape[0]), self.past_end
        ones, zeros = _ones_zeros(topo.num_nodes, dev)

        def transition(state, round_idx, u):
            del u
            up = coins[past_end_index(round_idx, t_len, past_end)]
            return state, GraphEvent(live=to_live(up), alive=ones,
                                     rejoined=zeros)

        return transition


@dataclasses.dataclass(frozen=True)
class EnergyChurn(GraphProcess):
    """Drift-adaptive churn: compute drains a battery, dead devices
    recharge.

    Each node starts with ``capacity`` seconds of energy.  Every round an
    alive node drains its REALIZED compute seconds (the event clock's
    ``last_cost``, one round delayed); at zero it churns out.  A dead node
    recharges ``recharge`` seconds per round and rejoins once its energy
    reaches ``rejoin_at``.  Deterministic given the observation stream;
    requires ``World(timing=...)``."""

    capacity: float = 32.0
    recharge: float = 4.0
    rejoin_at: float = 16.0

    name = "energy_churn"
    needs_rng = False
    observes = True

    def __post_init__(self):
        if not self.capacity > 0:
            raise ValueError(f"capacity must be > 0, got {self.capacity}")
        if not self.recharge > 0:
            raise ValueError(f"recharge must be > 0 (a device that never "
                             f"recharges never rejoins), got {self.recharge}")
        if not 0.0 < self.rejoin_at <= self.capacity:
            raise ValueError(f"rejoin_at must be in (0, capacity], got "
                             f"{self.rejoin_at}")

    def init_state(self, topo, dev):
        n = topo.num_nodes
        return (torch.full((n,), np.float32(self.capacity),
                           dtype=torch.float32, device=dev),  # energy
                torch.ones((n,), dtype=torch.float32, device=dev))  # alive

    def make_transition(self, topo, dev):
        _, _, from_alive = _live_layout(topo, dev)
        cap = _f32(self.capacity, dev)
        rech = _f32(self.recharge, dev)
        rejoin_at = _f32(self.rejoin_at, dev)
        zero = _f32(0.0, dev)

        def transition(state, round_idx, u, obs):
            del round_idx, u
            energy, alive = state
            e = torch.clamp(energy - alive * obs + (1.0 - alive) * rech,
                            zero, cap)
            new_alive = torch.where(alive > 0, e > 0,
                                    e >= rejoin_at).to(torch.float32)
            rejoined = (1.0 - alive) * new_alive
            return (e, new_alive), GraphEvent(live=from_alive(new_alive),
                                              alive=new_alive,
                                              rejoined=rejoined)

        return transition


# ---------------------------------------------------------------- registry

PROCESSES: Dict[str, Callable[..., GraphProcess]] = {
    "static": StaticGraph,
    "edge_dropout": EdgeDropout,
    "gilbert_elliott": GilbertElliott,
    "node_churn": NodeChurn,
    "periodic_rewiring": PeriodicRewiring,
    "scripted": ScriptedGraph,
    "energy_churn": EnergyChurn,
}


def make_process(name: str, **kwargs) -> GraphProcess:
    """Build a catalog process by name (kwargs go to its constructor)."""
    try:
        cls = PROCESSES[name]
    except KeyError:
        raise ValueError(
            f"unknown graph process {name!r}; available: {sorted(PROCESSES)}"
        ) from None
    return cls(**kwargs)
