"""Node-batched paper-scale models."""
from repro_torch.models.api import (  # noqa: F401
    SMALL_MODELS,
    SmallModel,
    make_small_model,
)
