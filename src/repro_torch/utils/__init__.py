"""Tree helpers for nested-dict parameters."""
from repro_torch.utils import pytree  # noqa: F401
