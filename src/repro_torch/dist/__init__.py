"""The LM-scale DFL round (`dfl_step`: the vmap form and the pod round
over a `torch.distributed` mesh), the mesh axis names (`sharding`) and the
sharding hints of the model code (`constraints`, the identity on one
device)."""
from repro_torch.dist.constraints import (  # noqa: F401
    constrain_batch,
    constrain_expert_sharded,
    constrain_logits,
    constrain_residual,
    gather_weights,
)
