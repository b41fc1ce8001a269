"""Metrics of a decentralized-learning run.

  * `RoundMetrics`, one eval round: every node's test accuracy and loss,
    with a transport the bytes on the wire and the triggered fraction,
    with a dynamics process the live-edge fraction, and with an event
    clock the simulated time and the arrived fraction, and with telemetry
    the selected channels (`detail`, see `repro_torch.obs`);
  * `characteristic_time` (paper Table IV): rounds to reach a fraction of
    the centralized benchmark's accuracy;
  * `comm_bytes_per_round` (paper §VI-A.3): bytes moved per round per
    method;
  * `accuracy_table`: the final-round summary of Table II.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np


@dataclasses.dataclass
class RoundMetrics:
    round: int
    acc_per_node: np.ndarray   # [N]
    loss_per_node: np.ndarray  # [N]
    # Transport accounting (None without a CommConfig): cumulative bytes put
    # on the wire up to and including this round, and the running mean
    # fraction of LIVE directed edges that carried a payload per round
    # (without a dynamics process every edge of the static layout is live).
    bytes_on_wire: Optional[float] = None
    triggered_frac: Optional[float] = None
    # Dynamics accounting (None without a GraphProcess): the running mean
    # fraction of the static layout's directed edges that were LIVE per
    # round.  Bytes are only accounted on live edges.
    live_edge_frac: Optional[float] = None
    # Event-clock accounting (None without a Timing): the ABSOLUTE simulated
    # seconds at the end of this round ((round+1)·d under a deadline d, the
    # cumulative synchronous makespan otherwise), and the running mean
    # fraction of live directed edges whose payload ARRIVED by the deadline
    # (1.0 in synchronous mode).  A late payload still burns the sender's
    # bytes but is not aggregated.
    sim_time: Optional[float] = None
    arrived_frac: Optional[float] = None
    # Telemetry detail (None without a repro_torch.obs Telemetry): the
    # selected channels materialized at this eval round — node channels as
    # [N] arrays, edge channels as [E] arrays in the canonical
    # (dst, src)-sorted directed-edge order shared by both layouts.
    # Cumulative channels (steps / compute / bytes / trigger) cover every
    # round up to and including this one, mirroring `bytes_on_wire`.
    detail: Optional[Dict[str, np.ndarray]] = None

    @property
    def acc_mean(self) -> float:
        return float(self.acc_per_node.mean())

    @property
    def acc_std(self) -> float:
        return float(self.acc_per_node.std())

    @property
    def loss_mean(self) -> float:
        return float(self.loss_per_node.mean())


def characteristic_time(history: Sequence[RoundMetrics],
                        centralized_acc: float,
                        thresholds=(0.5, 0.8, 0.9, 0.95)
                        ) -> Dict[float, Optional[int]]:
    """Paper Table IV: the first round at which the node-average accuracy
    reaches `thr * centralized_acc`, per threshold.

    A threshold never reached within the history maps to None ("did not
    converge", not 0).  `centralized_acc <= 0` raises ValueError (every
    target would be <= 0 and round 0 would reach them all vacuously), and
    so does an empty history (there is no round to report)."""
    if len(history) == 0:
        raise ValueError(
            "characteristic_time got an empty history; run the experiment "
            "(or pass its eval history) before computing Table IV")
    if not centralized_acc > 0:
        raise ValueError(
            f"centralized_acc must be > 0 (the centralized benchmark "
            f"accuracy the thresholds are fractions of), got "
            f"{centralized_acc}")
    out: Dict[float, Optional[int]] = {}
    for thr in thresholds:
        target = thr * centralized_acc
        out[thr] = next((m.round for m in history if m.acc_mean >= target),
                        None)
    return out


def comm_bytes_per_round(method: str, topo, model_bytes: int,
                         live_frac: float = 1.0) -> int:
    """Total bytes moved in the system per always-send round.

    `topo` is a `Topology` or a `SparseTopology` (its node and undirected
    edge counts); `model_bytes` the per-edge payload (with a codec, its
    `payload_bytes`); `live_frac` the expected fraction of live links
    (in [0, 1], else ValueError; a process's `stationary_live_frac()`, or
    for fedavg under churn the stationary aliveness).  Model-exchange
    methods ship one model per directed edge; CFA-GE also ships the
    aggregated model back out and the neighbours' gradients back in (4x);
    FedAvg one model up and one down per client; ISOL and Centralized
    nothing."""
    if not 0.0 <= live_frac <= 1.0:
        raise ValueError(f"live_frac must be in [0, 1], got {live_frac}")
    directed_edges = 2 * topo.num_edges
    m = method.lower()
    if m in ("isol", "centralized", "none"):
        return 0
    if m in ("fed", "fedavg"):
        return int(round(2 * topo.num_nodes * model_bytes * live_frac))
    if m in ("cfa-ge", "cfage"):
        return int(round(directed_edges * model_bytes * 2 * 2 * live_frac))
    # decavg / dechetero / cfa / decdiff / decdiff+vt: parameters only
    return int(round(directed_edges * model_bytes * live_frac))


def accuracy_table(histories: Dict[str, List[RoundMetrics]]
                   ) -> Dict[str, Dict[str, float]]:
    """Final-round summary akin to the paper's Table II; a method with an
    empty history raises ValueError."""
    table = {}
    for method, hist in histories.items():
        if len(hist) == 0:
            raise ValueError(
                f"accuracy_table: method {method!r} has an empty history "
                f"(no eval rounds); run it before tabulating")
        last = hist[-1]
        table[method] = {"acc_mean": last.acc_mean, "acc_std": last.acc_std,
                         "loss_mean": last.loss_mean, "round": last.round}
    return table
