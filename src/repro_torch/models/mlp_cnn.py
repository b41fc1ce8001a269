"""The paper's local model architectures (Table I), node-batched.

  MNIST    : MLP  FC 512-256-128 (+ output head), ReLU
  Fashion  : CNN  Conv 32, 64 (3x3) -> FC 9216-128 (+ head), ReLU
  EMNIST   : CNN  Conv 32, 64 (3x3), MaxPool(2), Dropout(.25),
                  FC 9216-128, Dropout(.5), FC 128 -> classes

Initialization is uniform in ±1/sqrt(fan_in) (PyTorch default-like); every
node draws its own init from its own generator (model heterogeneity).  The
forward pass runs all N nodes at once: the dense layers as batched
products of the stacked [N, in, out] weights, the convolutions as one
plain convolution per node (`_NodeConv`).

Conv weights are stored HWIO ([N, 3, 3, cin, cout], the JAX package's
layout) and turned into OIHW only inside the forward pass; the pooled
activations flatten in H, W, C order, as the reference's NHWC reshape
does, so `fc0`'s 9216 rows line up with the reference's.  On the card the
convolutions run with TF32 off and cuDNN's deterministic algorithms, in
scope, forward and backward alike (`_NodeConv`), and no global flag is
touched.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F

from repro_torch.models.api import SmallModel, register_small_model


def _linear_init(gen: torch.Generator, fan_in: int, fan_out: int):
    bound = 1.0 / math.sqrt(fan_in)
    w = torch.empty(fan_in, fan_out).uniform_(-bound, bound, generator=gen)
    b = torch.empty(fan_out).uniform_(-bound, bound, generator=gen)
    return {"w": w, "b": b}


def _conv_init(gen: torch.Generator, kh: int, kw: int, cin: int, cout: int):
    bound = 1.0 / math.sqrt(kh * kw * cin)
    w = torch.empty(kh, kw, cin, cout).uniform_(-bound, bound, generator=gen)
    b = torch.empty(cout).uniform_(-bound, bound, generator=gen)
    return {"w": w, "b": b}


def _conv_flags():
    """cuDNN in fp32 (no TF32) with deterministic algorithms: the port's
    bitwise oracles (fused = loop, dense = sparse) and its 1e-4 card-vs-CPU
    agreement rest on both."""
    return torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                      deterministic=True, allow_tf32=False)


class _NodeConv(torch.autograd.Function):
    """Every node's VALID, stride-1 convolution with its own weights: one
    plain convolution per node (on an H100, cuDNN runs the paper's 50-node
    shapes several times faster so than as one grouped convolution over
    the node axis), forward AND backward under `_conv_flags` (autograd runs the backward after the
    forward's scope has closed, so a context around the forward alone would
    not cover it).  x [N or 1, B, cin, H, W] (1: one input shared by every
    node), w [N, cout, cin, kh, kw] -> [N, B, cout, H-kh+1, W-kw+1]."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        shared = x.shape[0] == 1
        with _conv_flags():
            return torch.stack([F.conv2d(x[0 if shared else i], w[i])
                                for i in range(w.shape[0])])

    @staticmethod
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        shared = x.shape[0] == 1
        need_x, need_w = ctx.needs_input_grad[:2]
        gy = gy.contiguous()
        gxs, gws = [], []
        with _conv_flags():
            for i in range(w.shape[0]):
                gx, gw, _ = torch.ops.aten.convolution_backward(
                    gy[i], x[0 if shared else i], w[i], None, [1, 1], [0, 0],
                    [1, 1], False, [0, 0], 1, [need_x, need_w, False])
                gxs.append(gx)
                gws.append(gw)
        gx = gw = None
        if need_x:
            gx = torch.stack(gxs)
            if shared:
                gx = torch.sum(gx, dim=0, keepdim=True)
        if need_w:
            gw = torch.stack(gws)
        return gx, gw


def _conv2d(x, p):
    """x [N or 1, B, cin, H, W], p leaves w [N, kh, kw, cin, cout] (HWIO),
    b [N, cout] -> [N, B, cout, H-kh+1, W-kw+1]."""
    w_oihw = p["w"].permute(0, 4, 3, 1, 2)
    y = _NodeConv.apply(x, w_oihw.contiguous())
    return y + p["b"][:, None, :, None, None]


def _maxpool2(x):
    return F.max_pool2d(x, kernel_size=2, stride=2)


def _dropout(x, rate: float, keep, train: bool):
    if not train or keep is None:
        return x
    mask = keep(tuple(x.shape), 1.0 - rate)
    return torch.where(mask, x / (1.0 - rate), x.new_zeros(()))


@register_small_model("mlp")
def make_mlp(num_classes: int = 10, input_dim: int = 784,
             hidden: Sequence[int] = (512, 256, 128)) -> SmallModel:
    dims = [input_dim, *hidden, num_classes]

    def init(gen: torch.Generator):
        return {f"fc{i}": _linear_init(gen, dims[i], dims[i + 1])
                for i in range(len(dims) - 1)}

    def apply(params, x, *, train=False, keep=None):
        del train, keep  # no dropout
        # x [N, B, ...] per-node batches, or [1, B, ...] one shared batch
        h = x.reshape(x.shape[0], x.shape[1], input_dim)
        for i in range(len(dims) - 1):
            p = params[f"fc{i}"]
            h = torch.matmul(h, p["w"]) + p["b"][:, None, :]
            if i < len(dims) - 2:
                h = torch.relu(h)
        return h

    return SmallModel("mlp", init, apply, num_classes)


@register_small_model("cnn")
def make_cnn(num_classes: int = 10, in_hw=(28, 28),
             use_pool_dropout: bool = False) -> SmallModel:
    """Fashion CNN (use_pool_dropout=False) / EMNIST CNN (True).

    Conv 3x3 VALID twice: 28 -> 26 -> 24, then a 2x2 max pool to 12 in
    both variants (the reference's reading of the paper's FC 9216): flatten
    12*12*64 = 9216 -> 128 -> classes.  The EMNIST variant adds dropout
    0.25 after the pool and 0.5 after fc0."""
    h, w = in_hw
    ph, pw = (h - 4) // 2, (w - 4) // 2
    flat = ph * pw * 64  # 9216 for 28x28

    def init(gen: torch.Generator):
        return {
            "conv0": _conv_init(gen, 3, 3, 1, 32),
            "conv1": _conv_init(gen, 3, 3, 32, 64),
            "fc0": _linear_init(gen, flat, 128),
            "fc1": _linear_init(gen, 128, num_classes),
        }

    def apply(params, x, *, train=False, keep=None):
        # x [N, B, H, W] per-node batches, or [1, B, H, W] shared by all N
        n = params["conv0"]["w"].shape[0]
        b = x.shape[1]
        z = x.reshape(x.shape[0], b, 1, h, w)
        z = torch.relu(_conv2d(z, params["conv0"]))
        z = torch.relu(_conv2d(z, params["conv1"]))
        z = _maxpool2(z.reshape(n * b, 64, h - 4, w - 4))
        # [N·B, 64, ph, pw] -> per node NHWC [N, B, ph, pw, 64]
        z = z.reshape(n, b, 64, ph, pw).permute(0, 1, 3, 4, 2)
        if use_pool_dropout:
            z = _dropout(z, 0.25, keep, train)
        z = z.reshape(n, b, flat)
        z = torch.relu(torch.matmul(z, params["fc0"]["w"])
                       + params["fc0"]["b"][:, None, :])
        if use_pool_dropout:
            z = _dropout(z, 0.5, keep, train)
        return torch.matmul(z, params["fc1"]["w"]) \
            + params["fc1"]["b"][:, None, :]

    return SmallModel("cnn", init, apply, num_classes)


def model_for_dataset(dataset_name: str, num_classes: int) -> SmallModel:
    """Paper Table I mapping."""
    if "mnist" in dataset_name and "fashion" not in dataset_name \
            and "emnist" not in dataset_name:
        return make_mlp(num_classes=num_classes)
    if "fashion" in dataset_name:
        return make_cnn(num_classes=num_classes, use_pool_dropout=False)
    if "emnist" in dataset_name:
        return make_cnn(num_classes=num_classes, use_pool_dropout=True)
    raise ValueError(f"no paper model mapping for dataset {dataset_name!r}")
