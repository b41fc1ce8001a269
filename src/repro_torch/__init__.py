"""repro_torch — the PyTorch/CUDA port of the `repro` DFL engine.

    from repro_torch import Experiment, World

    world = World.synthetic("synth-mnist", nodes=16,
                            topology="barabasi_albert", m=2)
    history = Experiment(world, "decdiff+vt").run()

`World(dynamics=...)` takes a `repro_torch.dynamics` process (edge
dropout, bursty links, churn, rewiring, scripted, energy churn) and
`World(timing=...)` a `repro_torch.timing.Timing` event clock, with
`Schedule(deadline=...)` for deadline ticks, and `World(telemetry=...)` a
`repro_torch.obs.Telemetry` (per-node / per-edge channels in
`RoundMetrics.detail`, a JSONL run ledger, `export_trace`);
`run(verbose=True)` logs one line per eval round.  `Experiment(...,
backend="shard_map")` runs the same rounds over the "pod" dimension of a
`torch.distributed` mesh (one rank per pod, `mesh=`), bitwise the `vmap`
backend.

Runs on the CUDA card by default (`device=None` means "cuda" and raises on
a host without CUDA); pass `device="cpu"` for the plain PyTorch path.  The
port imports neither `jax` nor the `repro` package.  Its kernels live in
`csrc/` and are compiled with nvcc on first use (`kernels/_build.py`).
"""
from repro_torch.comm.transport import DENSE_CTX, PodContext  # noqa: F401
from repro_torch.device import resolve_device  # noqa: F401
from repro_torch.dynamics import GraphProcess, make_process  # noqa: F401
from repro_torch.engine import (  # noqa: F401
    Experiment,
    Schedule,
    TrainConfig,
    World,
)
from repro_torch.graphs.partition import (  # noqa: F401
    map_graph_to_pods,
    pod_adjacency,
)
from repro_torch.obs import Telemetry  # noqa: F401
from repro_torch.timing import Timing  # noqa: F401
