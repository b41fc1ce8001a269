"""Large-architecture LMs of six families over nested-dict params."""
from repro_torch.models.lm.api import LM, build_lm  # noqa: F401
from repro_torch.models.lm.config import ArchConfig  # noqa: F401
