"""Core library: the paper's contribution as composable PyTorch modules.

  * :mod:`repro_torch.core.decdiff`          — DecDiff aggregation (Eq. 5-6)
  * :mod:`repro_torch.core.virtual_teacher`  — Virtual-Teacher KL loss (Eq. 7-8)
  * :mod:`repro_torch.core.aggregation`      — baseline aggregators
    (DecAvg / CFA / CFA-GE / FedAvg / isolation)
"""
from repro_torch.core.aggregation import (  # noqa: F401
    AGGREGATORS,
    cfa_aggregate,
    cfa_ge_gradient_step,
    decavg_aggregate,
    fedavg_aggregate,
    get_aggregator,
    isolation_aggregate,
)
from repro_torch.core.decdiff import (  # noqa: F401
    decdiff_aggregate,
    decdiff_aggregate_stacked,
    decdiff_step,
    neighborhood_average,
)
from repro_torch.core.virtual_teacher import (  # noqa: F401
    cross_entropy_loss,
    make_loss_fn,
    teacher_entropy,
    vt_kl_loss,
)
