"""repro_torch — the PyTorch/CUDA port of the `repro` DFL engine.

    from repro_torch import Experiment, World

    world = World.synthetic("synth-mnist", nodes=16,
                            topology="barabasi_albert", m=2)
    history = Experiment(world, "decdiff+vt").run()

Runs on the CUDA card by default (`device=None` means "cuda" and raises on
a host without CUDA); pass `device="cpu"` for the plain PyTorch path.  The
port imports neither `jax` nor the `repro` package.  Its kernels live in
`csrc/` and are compiled with nvcc on first use (`kernels/_build.py`).
"""
from repro_torch.device import resolve_device  # noqa: F401
from repro_torch.engine import (  # noqa: F401
    Experiment,
    Schedule,
    TrainConfig,
    World,
)
