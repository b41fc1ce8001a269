"""Checkpointing: tensor-tree save / restore with a JSON manifest.

The PyTorch counterpart of the JAX package's `repro.checkpoint.ckpt`, in
its on-disk format, so that a checkpoint written by either package
restores in the other:

  * ``<dir>/step_<N:08d>/arrays.npz``: one ``<key>.npy`` member per leaf,
    the key being the '/'-joined tree path (dict keys, sequence indices as
    ``[i]``), in `jax.tree_util.tree_flatten_with_path` order (dict keys
    sorted at every level, depth first);
  * ``manifest.json``: ``step``, ``keys`` (shape and dtype name of every
    leaf), ``metadata`` and ``sharding`` (the intended partition specs,
    recorded for a loader on a mesh).

The write is atomic: a temporary directory beside the final one, then a
rename.  numpy has no bfloat16, and the port does not use `ml_dtypes`: a
bf16 leaf is written as its raw 2-byte pattern under the npy header
``'<V2'`` (the header numpy writes for the reference's ml_dtypes bf16
arrays) and read back by the manifest's dtype name.  Leaves go to the host
one at a time, so a checkpoint of a card's state needs host memory for one
leaf, not for the tree.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
import zipfile
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device

_SEP = "/"
_BF16_DESCR = "<V2"

# manifest dtype name (numpy's) -> torch dtype
_TORCH_DTYPES = {
    "bool": torch.bool, "int8": torch.int8, "uint8": torch.uint8,
    "int16": torch.int16, "int32": torch.int32, "int64": torch.int64,
    "float16": torch.float16, "float32": torch.float32,
    "float64": torch.float64, "bfloat16": torch.bfloat16,
}
_DTYPE_NAMES = {v: k for k, v in _TORCH_DTYPES.items()}


def _flatten_with_paths(tree, prefix=()):
    """[(key, leaf)] in `jax.tree_util.tree_flatten_with_path` order."""
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        items = [(f"[{i}]", v) for i, v in enumerate(tree)]
    else:
        return [(_SEP.join(prefix), tree)]
    out = []
    for part, sub in items:
        out.extend(_flatten_with_paths(sub, prefix + (part,)))
    return out


def _dtype_name(t: torch.Tensor) -> str:
    if t.dtype not in _DTYPE_NAMES:
        raise ValueError(f"no checkpoint dtype for {t.dtype}")
    return _DTYPE_NAMES[t.dtype]


def _host_array(t: torch.Tensor) -> np.ndarray:
    """One leaf as a C-ordered numpy array on the host; a bf16 leaf as its
    bit pattern (int16)."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.contiguous().cpu().numpy()


def _write_member(zf: zipfile.ZipFile, key: str, arr: np.ndarray,
                  name: str):
    """`key.npy` into the open archive, as `np.savez` writes it."""
    with zf.open(key + ".npy", "w", force_zip64=True) as f:
        if name != "bfloat16":
            np.lib.format.write_array(f, arr, allow_pickle=False)
            return
        np.lib.format.write_array_header_1_0(f, {
            "descr": _BF16_DESCR, "fortran_order": False,
            "shape": tuple(arr.shape)})
        f.write(np.ascontiguousarray(arr, dtype="<i2").reshape(-1).data)


def _insert(tree: dict, parts, value):
    head, rest = parts[0], parts[1:]
    if head.startswith("[") and head.endswith("]"):
        head = int(head[1:-1])
    if not rest:
        tree[head] = value
        return
    _insert(tree.setdefault(head, {}), rest, value)


def _listify(tree):
    """Convert dicts whose keys are all ints 0..n-1 back into lists."""
    if isinstance(tree, dict):
        conv = {k: _listify(v) for k, v in tree.items()}
        if conv and all(isinstance(k, int) for k in conv):
            return [conv[i] for i in sorted(conv)]
        return conv
    return tree


def save_checkpoint(directory: str, step: int, tree: Any,
                    metadata: Optional[Dict] = None,
                    shardings: Optional[Dict[str, str]] = None) -> str:
    """Save `tree` (nested dicts / lists of tensors) under
    directory/step_<step>.  Returns the checkpoint path."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    flat = _flatten_with_paths(tree)
    tmp = tempfile.mkdtemp(dir=directory, prefix=".tmp_ckpt_")
    try:
        keys = {}
        with zipfile.ZipFile(os.path.join(tmp, "arrays.npz"), mode="w",
                             compression=zipfile.ZIP_STORED,
                             allowZip64=True) as zf:
            for key, leaf in flat:
                name = _dtype_name(leaf)
                arr = _host_array(leaf)
                _write_member(zf, key, arr, name)
                keys[key] = {"shape": list(arr.shape), "dtype": name}
                del arr
        manifest = {"step": step, "keys": keys, "metadata": metadata or {},
                    "sharding": shardings or {}}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=2)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
    finally:
        if os.path.exists(tmp):
            shutil.rmtree(tmp, ignore_errors=True)
    return final


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [
        int(d.split("_")[1])
        for d in os.listdir(directory)
        if d.startswith("step_") and d.split("_")[1].isdigit()
    ]
    return max(steps) if steps else None


def _leaf_tensor(arr: np.ndarray, name: str, dev) -> torch.Tensor:
    if name not in _TORCH_DTYPES:
        raise ValueError(f"unknown checkpoint dtype {name!r}")
    arr = np.require(arr, requirements="C")
    if name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).to(dev).view(
            torch.bfloat16)
    return torch.from_numpy(arr).to(dev).to(_TORCH_DTYPES[name])


def restore_checkpoint(directory: str, step: Optional[int] = None,
                       device: DeviceLike = None) -> Tuple[Any, Dict]:
    """Restore (tree of tensors on `device`, manifest); step=None -> the
    latest, device=None -> the card."""
    dev = resolve_device(device)
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    tree: dict = {}
    with np.load(os.path.join(path, "arrays.npz")) as arrays:
        for key in arrays.files:
            _insert(tree, key.split(_SEP),
                    _leaf_tensor(arrays[key], manifest["keys"][key]["dtype"],
                                 dev))
    return _listify(tree), manifest
