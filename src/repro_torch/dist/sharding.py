"""Mesh axis names of the port's multi-device backend.

`NODE_AXIS` is the mesh dimension that carries the DFL node axis: one
block of N / P nodes per pod (`Experiment(backend="shard_map", mesh=...)`
and `build_dfl_round_shardmap`).  The rest of the JAX package's
`dist/sharding.py` (the per-leaf partition-spec inference over "data" and
"model") is not ported yet (ROADMAP A.11.3)."""

NODE_AXIS = "pod"
