"""Local training, evaluation and per-round metrics."""
from repro_torch.comm import CommConfig  # noqa: F401
from repro_torch.fl.metrics import (  # noqa: F401
    RoundMetrics,
    characteristic_time,
    comm_bytes_per_round,
)
from repro_torch.fl.trainer import centralized_train  # noqa: F401
