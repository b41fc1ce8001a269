"""The LM-scale DFL round (`dfl_step`: the vmap form and the pod round
over a `torch.distributed` mesh) and the mesh axis names (`sharding`)."""
