"""Device resolution for every entry point of the port.

`device=None` means the CUDA card.  A host without CUDA raises instead of
falling back to the CPU: a run that silently lands on the CPU would report
CPU numbers under the card's name.  Callers that want the CPU (the tests)
ask for it explicitly with `device="cpu"`.
"""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """`None` -> "cuda"; raise if the resolved device is CUDA and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested (device=None means 'cuda') but "
            f"CUDA is not available on this host; pass device='cpu' to run "
            f"the plain PyTorch path on the CPU")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
