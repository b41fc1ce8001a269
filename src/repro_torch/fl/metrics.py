"""Per-eval-round metrics of a decentralized-learning run.

The fields this slice fills: the eval round and every node's test accuracy
and loss.  The JAX package's comm, dynamics, timing and telemetry fields
arrive with those subsystems (ROADMAP A.5-A.9).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class RoundMetrics:
    round: int
    acc_per_node: np.ndarray   # [N]
    loss_per_node: np.ndarray  # [N]

    @property
    def acc_mean(self) -> float:
        return float(self.acc_per_node.mean())

    @property
    def acc_std(self) -> float:
        return float(self.acc_per_node.std())

    @property
    def loss_mean(self) -> float:
        return float(self.loss_per_node.mean())
