"""Telemetry channels: declarative per-node / per-edge accumulators that
ride the engine's round state.

The round computes per-node step budgets, per-edge fired gates, delivery
masks and event-clock landing times, and without this module throws them
away.  A :class:`Telemetry` selects named CHANNELS from the catalog below;
`Experiment` binds it once into a :class:`BoundTelemetry` whose
accumulator dict (`state0`) is one more round-carried state, threaded like
`TimingState`, and whose per-round channel snapshot is one more extras
group.  The channels draw from no generator (pure arithmetic over
quantities the round already computes), so with ``telemetry=None`` the
engine is bitwise a build without this module, and with every channel on
params, bytes and the clock are bitwise unchanged.

Channel catalog (`CHANNELS`):

  ================  ======  ========  =======================================
  name              axis    needs     meaning (cumulative unless noted)
  ================  ======  ========  =======================================
  node_steps        node    —         local SGD steps actually trained
  node_compute      node    timing    realized compute seconds (Σ budget·dt)
  node_acc          node    —         per-node test accuracy (eval rounds)
  edge_trigger      edge    comm      payloads FIRED on the directed edge
  edge_bytes        edge    comm      exact bytes on wire (payload × fired)
  edge_staleness    edge    comm      rounds since the edge last DELIVERED
                                      (instantaneous age; grows on silence,
                                      resets to 0 on delivery)
  edge_latency      edge    timing    this round's landing time in seconds
                                      (sender compute + link transfer;
                                      instantaneous)
  consensus         node    —         ‖w_i − w̄‖₂ after the round (distance
                                      to the node-mean parameter vector;
                                      probed at eval rounds)
  drift             edge    —         ‖w_src − w_dst‖₂ after the round (the
                                      paper's pairwise divergence, per
                                      directed edge; probed at eval rounds)
  ================  ======  ========  =======================================

Per-EDGE channels are materialized in the canonical `(dst, src)`-sorted
directed-edge order both layouts share (`repro_torch.timing` binds its
transfer tables in the same order).  In the round they live in the
layout's own shape (the [N, max_deg] receiver panel or the flat [E] list)
and :meth:`BoundTelemetry.materialize` converts them on the host, so
`RoundMetrics.detail` does not depend on the layout.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

#: bytes of one [rows, D] fp32 pair difference the drift probe forms at
#: once (its two gathers and their difference are each this size), so a
#: large world's probe does not hold every pair's rows at once
DRIFT_CHUNK_BYTES = 1 << 28


@dataclasses.dataclass(frozen=True)
class ChannelSpec:
    """One catalog entry: which axis it indexes and which optional engine
    subsystems must be present for the quantity to exist at all."""

    axis: str                 # "node" | "edge"
    needs: Tuple[str, ...]    # subset of ("comm", "timing")
    doc: str


CHANNELS: Dict[str, ChannelSpec] = {
    "node_steps": ChannelSpec("node", (), "cumulative trained local steps"),
    "node_compute": ChannelSpec(
        "node", ("timing",), "cumulative realized compute seconds"),
    "node_acc": ChannelSpec(
        "node", (), "per-node test accuracy at eval rounds"),
    "edge_trigger": ChannelSpec(
        "edge", ("comm",), "cumulative fired payload count"),
    "edge_bytes": ChannelSpec(
        "edge", ("comm",), "cumulative exact bytes on wire"),
    "edge_staleness": ChannelSpec(
        "edge", ("comm",), "rounds since the edge last delivered"),
    "edge_latency": ChannelSpec(
        "edge", ("timing",), "this round's landing time in seconds"),
    "consensus": ChannelSpec(
        "node", (), "distance to the node-mean parameter vector"),
    "drift": ChannelSpec(
        "edge", (), "pairwise parameter distance per directed edge"),
}

_NEED_HINT = {
    "comm": "a comm transport (Experiment(comm=CommConfig(...)))",
    "timing": ("an event clock (World(timing=repro_torch.timing."
               "Timing(...)))"),
}


@dataclasses.dataclass(frozen=True)
class Telemetry:
    """Opt-in observability config, selected via ``World(telemetry=...)``.

    `channels` is a sequence of catalog names (strict: a channel whose
    required subsystem the experiment lacks raises at construction), or one
    of two aliases — ``"auto"`` (default: every channel the experiment can
    support) and ``"all"`` (the full catalog, strict).

    `ledger` is an optional path: the run writes a schema-validated JSONL
    ledger there (manifest + one record per eval round + a summary with
    wall seconds and rounds per second — see repro_torch.obs.ledger).

    `profile_dir` optionally wraps `run()` in a `torch.profiler` capture
    (CPU activity, and CUDA on a card) that writes a Chrome trace into the
    directory; channel collection itself never needs it.
    """

    channels: Union[str, Tuple[str, ...]] = "auto"
    ledger: Optional[str] = None
    profile_dir: Optional[str] = None

    def __post_init__(self):
        ch = self.channels
        if isinstance(ch, str):
            if ch not in ("auto", "all"):
                raise ValueError(
                    f"unknown channel alias {ch!r}; pass 'auto', 'all', or "
                    f"a sequence of names from {sorted(CHANNELS)}")
            return
        ch = tuple(ch)
        unknown = [c for c in ch if c not in CHANNELS]
        if unknown:
            raise ValueError(
                f"unknown telemetry channel(s) {unknown}; "
                f"available: {sorted(CHANNELS)}")
        object.__setattr__(self, "channels", ch)

    def resolve(self, *, has_comm: bool, has_timing: bool) -> Tuple[str, ...]:
        """The selected channel names, catalog-ordered; strict selections
        raise if a required subsystem is missing."""
        have = set()
        if has_comm:
            have.add("comm")
        if has_timing:
            have.add("timing")
        if self.channels == "auto":
            return tuple(c for c, spec in CHANNELS.items()
                         if set(spec.needs) <= have)
        names = (tuple(CHANNELS) if self.channels == "all"
                 else tuple(self.channels))
        for c in names:
            missing = [n for n in CHANNELS[c].needs if n not in have]
            if missing:
                raise ValueError(
                    f"telemetry channel {c!r} needs "
                    + " and ".join(_NEED_HINT[n] for n in missing)
                    + "; drop the channel or add the subsystem "
                    "(channels='auto' selects only what the experiment "
                    "supports)")
        # catalog order keeps ledgers/details stable across selections
        return tuple(c for c in CHANNELS if c in names)

    def bind(self, exp) -> Optional["BoundTelemetry"]:
        """Resolve the channels against `exp` and build the index tensors
        on its device; None when the selection is empty (ledger-only use:
        the round then carries no telemetry state at all)."""
        names = self.resolve(has_comm=exp.transport is not None,
                             has_timing=exp.bound_timing is not None)
        if not names:
            return None
        return BoundTelemetry(exp, names)


class BoundTelemetry:
    """A Telemetry bound to one experiment: the round-carried accumulator
    dict (`state0`), the per-round channel arithmetic (`step`, called from
    the round body on both layouts), the eval-round parameter probes
    (`eval_probes`) and the host-side canonical materialization
    (`materialize`)."""

    def __init__(self, exp, names: Tuple[str, ...]):
        self.channels = names
        self.layout = exp.layout
        self.n = int(exp.n)
        self.payload_bytes = (float(exp.transport.payload_bytes)
                              if exp.transport is not None else None)
        topo = exp.topo
        if self.layout == "sparse":
            src = np.asarray(topo.edge_src, np.int64)
            dst = np.asarray(topo.edge_dst, np.int64)
            self._panel_dst = self._panel_slot = None
            self._edge_src = exp.edge_src
        else:
            # canonical (dst, src)-sorted directed edges: np.nonzero walks
            # the adjacency row-major, so row r's hits come out
            # sender-ascending, exactly receiver r's padded slots 0..deg-1
            dst, src = np.nonzero(np.asarray(topo.adjacency) > 0)
            deg = np.asarray(topo.neighbor_mask.sum(axis=1), np.int64)
            self._panel_dst = dst
            self._panel_slot = np.concatenate(
                [np.arange(d, dtype=np.int64) for d in deg]) \
                if len(dst) else np.zeros((0,), np.int64)
            # the experiment's padded panel indices (max(idx, 0)) and mask
            self._nbr_idx, self._nbr_valid = exp.nbr_idx, exp.nbr_valid
        self.edge_src = src.astype(np.int64)
        self.edge_dst = dst.astype(np.int64)
        self.num_directed = int(len(src))
        if exp.bound_timing is not None:
            self._transfer_e = exp.bound_timing.transfer_e
            self._transfer_panel = exp.bound_timing.transfer_panel
        else:
            self._transfer_e = self._transfer_panel = None
        # the drift probe gathers canonical [E] endpoint rows directly,
        # never the [N, max_deg, D] panel, and only over the E/2 undirected
        # pairs: the graph is symmetric, so ‖w_src − w_dst‖ is shared by
        # both directions and scattered back
        pairs = {}
        for e, (s, t) in enumerate(zip(src.tolist(), dst.tolist())):
            pairs.setdefault((min(s, t), max(s, t)), []).append(e)
        pair_lo = np.array([p[0] for p in pairs], np.int64)
        pair_hi = np.array([p[1] for p in pairs], np.int64)
        pair_of_edge = np.zeros((self.num_directed,), np.int64)
        for i, es in enumerate(pairs.values()):
            for e in es:
                pair_of_edge[e] = i
        dev = exp.device
        self._pair_lo = torch.from_numpy(pair_lo).to(dev)
        self._pair_hi = torch.from_numpy(pair_hi).to(dev)
        self._pair_of_edge = torch.from_numpy(pair_of_edge).to(dev)

        self.has_probes = bool({"consensus", "drift"} & set(names))
        self.needs_fired = bool(
            {"edge_trigger", "edge_bytes"} & set(names))
        self.needs_delivered = "edge_staleness" in names

        edge_shape = ((self.num_directed,) if self.layout == "sparse"
                      else tuple(np.asarray(topo.neighbor_mask).shape))

        def zeros(shape):
            return torch.zeros(shape, dtype=torch.float32, device=dev)

        state = {"rounds": zeros(())}
        if "node_steps" in names:
            state["node_steps"] = zeros((self.n,))
        if "node_compute" in names:
            state["node_secs"] = zeros((self.n,))
        if self.needs_fired:
            state["edge_sent"] = zeros(edge_shape)
        if self.needs_delivered:
            state["edge_age"] = zeros(edge_shape)
        self.state0 = state

    # -- in the round ------------------------------------------------------
    def step(self, state, *, budgets, t_cost, fired, delivered):
        """One round of channel arithmetic: budgets [N] int, t_cost [N]
        seconds or None, fired / delivered the layout's receiver-side edge
        masks or None.  Counts are small integers summed in fp32 (exact
        below 2^24).  Draws nothing.  Returns (new_state, snapshot); every
        tensor is new, never updated in place, so a kept snapshot does not
        alias the next round's accumulator.

        The params-reading probes (consensus / drift) do not run here:
        they are instantaneous norms read only at eval rounds, so the
        runner calls :meth:`eval_probes` there."""
        new = {"rounds": state["rounds"] + 1.0}
        out = {}
        if "node_steps" in state:
            new["node_steps"] = (state["node_steps"]
                                 + budgets.to(torch.float32))
            out["node_steps"] = new["node_steps"]
        if "node_secs" in state:
            new["node_secs"] = state["node_secs"] + t_cost
            out["node_secs"] = new["node_secs"]
        if "edge_sent" in state:
            new["edge_sent"] = state["edge_sent"] + fired
            out["edge_sent"] = new["edge_sent"]
        if "edge_age" in state:
            # +1 per silent round, reset on delivery; padding slots of the
            # dense panel grow too but are dropped by materialize()
            new["edge_age"] = (state["edge_age"] + 1.0) * (1.0 - delivered)
            out["edge_age"] = new["edge_age"]
        if "edge_latency" in self.channels:
            if self.layout == "sparse":
                out["edge_landing"] = (t_cost[self._edge_src]
                                       + self._transfer_e)
            else:
                out["edge_landing"] = (t_cost[self._nbr_idx]
                                       + self._transfer_panel) \
                    * self._nbr_valid
        return new, out

    @torch.no_grad()
    def eval_probes(self, full_mat) -> Dict[str, torch.Tensor]:
        """The params-reading probes (consensus / drift) from the [N, D]
        flattened post-round parameter matrix.  Instantaneous, with no
        carried state, and read only at eval rounds.  Drift walks the
        undirected pairs in chunks of DRIFT_CHUNK_BYTES / (4·D) rows (a
        function of D alone: both layouts make the same walk, so dense and
        sparse agree bitwise)."""
        out: Dict[str, torch.Tensor] = {}
        if "consensus" in self.channels:
            mean = torch.mean(full_mat, dim=0)
            diff = full_mat - mean[None, :]
            out["consensus"] = torch.sqrt(torch.sum(diff * diff, dim=1))
            del diff
        if "drift" in self.channels:
            p = int(self._pair_lo.shape[0])
            d = max(int(full_mat.shape[1]), 1)
            rows = max(1, DRIFT_CHUNK_BYTES // (4 * d))
            half = torch.empty((p,), dtype=torch.float32,
                               device=full_mat.device)
            for a in range(0, p, rows):
                b = min(a + rows, p)
                diff = full_mat[self._pair_lo[a:b]] \
                    - full_mat[self._pair_hi[a:b]]
                half[a:b] = torch.sqrt(torch.sum(diff * diff, dim=1))
                del diff
            out["drift"] = half[self._pair_of_edge]
        return out

    # -- on the host -------------------------------------------------------
    def _edge(self, a) -> np.ndarray:
        """Layout-native edge array -> canonical (dst, src)-sorted [E]."""
        a = np.asarray(a)
        if self.layout == "sparse":
            return a
        return a[self._panel_dst, self._panel_slot]

    def materialize(self, snapshot, acc_per_node=None,
                    probes=None) -> Dict[str, np.ndarray]:
        """One round's host snapshot -> {channel: canonical numpy array}:
        node channels [N], edge channels [E] in the canonical (dst, src)
        order (`edge_src` / `edge_dst` name the endpoints).  `edge_bytes`
        is the exact payload_bytes × fired-count product, computed here in
        float64 so it survives past fp32's 2^24.  `probes` is the eval
        round's :meth:`eval_probes` output on the host."""
        detail: Dict[str, np.ndarray] = {}
        for ch in self.channels:
            if ch == "node_steps":
                detail[ch] = np.asarray(snapshot["node_steps"])
            elif ch == "node_compute":
                detail[ch] = np.asarray(snapshot["node_secs"])
            elif ch == "node_acc":
                if acc_per_node is not None:
                    detail[ch] = np.asarray(acc_per_node)
            elif ch == "edge_trigger":
                detail[ch] = self._edge(snapshot["edge_sent"])
            elif ch == "edge_bytes":
                detail[ch] = (self._edge(snapshot["edge_sent"])
                              .astype(np.float64) * self.payload_bytes)
            elif ch == "edge_staleness":
                detail[ch] = self._edge(snapshot["edge_age"])
            elif ch == "edge_latency":
                detail[ch] = self._edge(snapshot["edge_landing"])
            elif ch in ("consensus", "drift"):
                # drift is already flat canonical [E] on both layouts
                if probes is not None:
                    detail[ch] = np.asarray(probes[ch])
        return detail


def available_channels() -> Tuple[str, ...]:
    """The catalog names, in the stable order details/ledgers use."""
    return tuple(CHANNELS)


def channels_for(names: Sequence[str]) -> Dict[str, ChannelSpec]:
    """Catalog specs for a selection (unknown names raise, same message as
    Telemetry validation)."""
    t = Telemetry(channels=tuple(names))
    return {c: CHANNELS[c] for c in t.channels}
