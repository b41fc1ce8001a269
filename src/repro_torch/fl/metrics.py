"""Per-eval-round metrics of a decentralized-learning run.

The fields the port fills: the eval round, every node's test accuracy and
loss, and with a transport the bytes on the wire and the triggered
fraction.  The JAX package's dynamics, timing and telemetry fields arrive
with those subsystems (ROADMAP A.7-A.9).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class RoundMetrics:
    round: int
    acc_per_node: np.ndarray   # [N]
    loss_per_node: np.ndarray  # [N]
    # Transport accounting (None without a CommConfig): cumulative bytes put
    # on the wire up to and including this round, and the running mean
    # fraction of directed edges that carried a payload per round.
    bytes_on_wire: Optional[float] = None
    triggered_frac: Optional[float] = None

    @property
    def acc_mean(self) -> float:
        return float(self.acc_per_node.mean())

    @property
    def acc_std(self) -> float:
        return float(self.acc_per_node.std())

    @property
    def loss_mean(self) -> float:
        return float(self.loss_per_node.mean())
