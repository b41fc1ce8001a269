"""Synthetic stand-ins for MNIST / Fashion-MNIST / EMNIST (a numpy copy of
the JAX package's `data/synth.py`, so both packages build the same data).

The paper's datasets are not bundled and runs assume no network, so we
generate *class-prototype* image
datasets with the same tensor shapes and class counts:

  synth-mnist    28x28 grayscale, 10 classes, 60k train / 10k test
  synth-fashion  28x28 grayscale, 10 classes, 60k train / 10k test
  synth-emnist   28x28 grayscale, 26 classes, 20.8k train / 3.28k test

Generation: each class c gets K random smooth prototypes (low-frequency
random fields, mimicking stroke-like structure).  A sample is a random convex
mixture of its class's prototypes plus per-sample smooth deformation noise and
pixel noise, then clipped to [0, 1].  Difficulty is controlled by the noise
scale and prototype separation; defaults are tuned so an MLP reaches >95% when
trained centrally but single-node non-IID shards overfit badly — matching the
regime the paper studies (large Centralized-vs-ISOL gap).

All generation is deterministic in (name, seed) and runs on the host in
numpy.
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Dict, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class SynthSpec:
    num_classes: int
    train_size: int
    test_size: int
    image_hw: Tuple[int, int] = (28, 28)
    prototypes_per_class: int = 4
    pixel_noise: float = 0.18
    deform_noise: float = 0.35
    mix_alpha: float = 0.8  # Dirichlet concentration over prototypes


DATASETS: Dict[str, SynthSpec] = {
    # shapes match the real datasets; sizes can be scaled down via `scale`.
    "synth-mnist": SynthSpec(num_classes=10, train_size=60_000, test_size=10_000,
                             pixel_noise=0.15, deform_noise=0.30),
    "synth-fashion": SynthSpec(num_classes=10, train_size=60_000, test_size=10_000,
                               pixel_noise=0.22, deform_noise=0.45),
    "synth-emnist": SynthSpec(num_classes=26, train_size=20_800, test_size=3_280,
                              pixel_noise=0.20, deform_noise=0.40),
}


@dataclasses.dataclass
class SynthDataset:
    name: str
    x_train: np.ndarray  # [N, H, W] float32 in [0,1]
    y_train: np.ndarray  # [N] int32
    x_test: np.ndarray
    y_test: np.ndarray
    num_classes: int

    @property
    def input_shape(self):
        return self.x_train.shape[1:]


def _smooth_field(rng: np.random.Generator, hw, low: int = 7) -> np.ndarray:
    """Low-frequency random field: upsampled coarse noise (stroke-ish blobs)."""
    h, w = hw
    coarse = rng.standard_normal((low, low)).astype(np.float32)
    # bilinear upsample coarse -> (h, w)
    yi = np.linspace(0, low - 1, h)
    xi = np.linspace(0, low - 1, w)
    y0 = np.floor(yi).astype(int)
    x0 = np.floor(xi).astype(int)
    y1 = np.minimum(y0 + 1, low - 1)
    x1 = np.minimum(x0 + 1, low - 1)
    fy = (yi - y0)[:, None]
    fx = (xi - x0)[None, :]
    f = (
        coarse[np.ix_(y0, x0)] * (1 - fy) * (1 - fx)
        + coarse[np.ix_(y1, x0)] * fy * (1 - fx)
        + coarse[np.ix_(y0, x1)] * (1 - fy) * fx
        + coarse[np.ix_(y1, x1)] * fy * fx
    )
    return f.astype(np.float32)


def _normalize01(a: np.ndarray) -> np.ndarray:
    lo, hi = a.min(), a.max()
    return (a - lo) / max(hi - lo, 1e-6)


def _generate_split(rng: np.random.Generator, protos: np.ndarray, n: int,
                    spec: SynthSpec) -> Tuple[np.ndarray, np.ndarray]:
    c, k, h, w = protos.shape
    labels = rng.integers(0, c, size=n).astype(np.int32)
    mix = rng.dirichlet(np.full(k, spec.mix_alpha), size=n).astype(np.float32)
    base = np.einsum("nk,nkhw->nhw", mix, protos[labels])
    # per-sample smooth deformation + pixel noise, vectorized in chunks
    imgs = np.empty((n, h, w), np.float32)
    chunk = 4096
    for s in range(0, n, chunk):
        e = min(s + chunk, n)
        m = e - s
        deform = rng.standard_normal((m, 7, 7)).astype(np.float32)
        # cheap upsample via kron-ish repeat + crop
        reps = (h + 6) // 7
        deform_up = np.kron(deform, np.ones((1, reps, reps), np.float32))[:, :h, :w]
        noise = rng.standard_normal((m, h, w)).astype(np.float32)
        imgs[s:e] = base[s:e] + spec.deform_noise * deform_up + spec.pixel_noise * noise
    imgs = np.clip((imgs - imgs.min()) / max(imgs.max() - imgs.min(), 1e-6), 0, 1)
    return imgs, labels


def make_dataset(name: str, seed: int = 0, scale: float = 1.0) -> SynthDataset:
    """Build a deterministic synthetic dataset.  `scale` shrinks train/test
    sizes proportionally (benchmarks use scale < 1 to fit the CPU budget)."""
    spec = DATASETS[name]
    # NB: not Python's hash() — string hashing is randomized per process
    # (PYTHONHASHSEED), which silently broke the determinism contract.
    rng = np.random.default_rng([zlib.crc32(name.encode()), seed])
    h, w = spec.image_hw
    protos = np.stack([
        np.stack([
            _normalize01(_smooth_field(rng, (h, w)))
            for _ in range(spec.prototypes_per_class)
        ])
        for _ in range(spec.num_classes)
    ])  # [C, K, H, W]
    n_train = max(int(spec.train_size * scale), spec.num_classes * 8)
    n_test = max(int(spec.test_size * scale), spec.num_classes * 4)
    x_tr, y_tr = _generate_split(rng, protos, n_train, spec)
    x_te, y_te = _generate_split(rng, protos, n_test, spec)
    # Standardize with train statistics (the paper's pipeline normalizes via
    # torchvision; without this the shared DC component dominates and SGD
    # stalls — empirically verified).
    mean, std = x_tr.mean(), x_tr.std() + 1e-6
    x_tr = (x_tr - mean) / std
    x_te = (x_te - mean) / std
    return SynthDataset(name=name, x_train=x_tr, y_train=y_tr,
                        x_test=x_te, y_test=y_te, num_classes=spec.num_classes)
