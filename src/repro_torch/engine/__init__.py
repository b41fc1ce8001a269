"""repro_torch.engine — the Experiment front door over method strategies."""
from repro_torch.engine.backends import BACKENDS, build_round  # noqa: F401
from repro_torch.engine.experiment import (  # noqa: F401
    Experiment,
    Schedule,
    TrainConfig,
    World,
)
from repro_torch.engine.strategies import (  # noqa: F401
    AggregationStrategy,
    Capabilities,
    CFAGEStrategy,
    CFAStrategy,
    DecAvgStrategy,
    DecDiffStrategy,
    FedAvgStrategy,
    IsolationStrategy,
    MethodSpec,
    available_methods,
    get_method,
    register_method,
)
