#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA card.

    python3 chip_smoke.py [--profile]

Run from the root of a checkout on a machine with a CUDA card and nvcc.
It imports the port only (no JAX), and:

  1. prints the card's name and power limit (nvidia-smi);
  2. builds every CUDA kernel of the port from `src/repro_torch/csrc`
     (one nvcc per source, all at once);
  3. drives the main path once — `Experiment(World.synthetic("synth-mnist",
     nodes=16, topology="barabasi_albert", m=2, scale=1.0), "decdiff+vt")`,
     the paper's MNIST MLP 784-512-256-128-10 at full width, 3 rounds in
     the default fused mode, after one warm round — with every kernel
     launch count set to 0 just before and read just after; a kernel of the
     path that was never launched fails the run;
  4. checks what comes out: per-node accuracies of shape [16] in [0, 1],
     finite train losses and params, and a small world run on the card
     that agrees with the same run on the CPU (the plain path, which the
     CPU tests hold against the JAX reference);
  5. holds each kernel against its plain PyTorch version on the card at
     the main path's shapes (the reduce is bitwise, `torch.equal`), and
     times kernel, plain version and one PyTorch library call with CUDA
     events (median of 20) beside the HBM bound;
  6. prints one JSON line listing the kernels, then, as its last line,
     `{"ok": true, "device": {...}}`.

With `--profile` it also traces one more round (eval included) under
`torch.profiler` and prints the device time by kernel and the device's
busy share of the round's wall time.

Any failure exits non-zero before the last line is printed.  Without a
CUDA card, or without the port beside this script, it exits 2.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA data sheet
FP32_FLOPS = 67e12          # H100 SXM fp32 outside the tensor cores
ROUNDS = 3
REPS = 20


class SmokeFailure(Exception):
    pass


def check(cond, what):
    if not cond:
        raise SmokeFailure(what)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def median_ms(torch, fn, reps=REPS):
    """Median over `reps` single calls, each bracketed by CUDA events."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def segment_bound_ms(b, k, d):
    """Least time for the reduce: each input read once, each output
    written once, over HBM bandwidth; or its fp32 flops over the peak."""
    nbytes = 4 * (b * k * d + b * k + b * d + b)
    flops = 2 * b * k * d + b * k
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                      else "operations")


def kernel_vs_plain(torch, ops, plain, vals, w, label):
    """Hold the kernel against its plain version and time both."""
    b, k, d = vals.shape
    sums, tot = ops.segment_neighbor_avg(vals, w)
    torch.cuda.synchronize()
    ps, pt = plain(vals, w)
    equal = bool(torch.equal(sums, ps) and torch.equal(tot, pt))
    err = max(float((sums - ps).abs().max()), float((tot - pt).abs().max()))
    ms = median_ms(torch, lambda: ops.segment_neighbor_avg(vals, w))
    plain_ms = median_ms(torch, lambda: plain(vals, w))
    lib_ms = median_ms(torch, lambda: torch.einsum("bk,bkd->bd", w, vals))
    bound_ms, bound_by = segment_bound_ms(b, k, d)
    print(f"segment_neighbor_avg {label} [B={b}, K={k}, D={d}]: "
          f"torch.equal(kernel, plain)={equal} max_abs_err={err:g} "
          f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"einsum {lib_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}), "
          f"kernel at {100 * bound_ms / ms:.1f}% of bound")
    check(equal, f"segment_neighbor_avg {label}: kernel != plain "
                 f"(max_abs_err {err:g})")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=bound_ms, bound_by=bound_by, max_abs_err=err,
                shape=[b, k, d])


def small_world_agrees(torch, dev):
    """The same small run on the card and on the CPU (same world, same
    init, no random draws in the rounds) must agree."""
    from repro_torch.engine import Experiment, World
    from repro_torch.models.mlp_cnn import make_mlp
    from repro_torch.utils.pytree import tree_leaves

    runs = []
    for where in (dev, torch.device("cpu")):
        world = World.synthetic("synth-mnist", nodes=16,
                                topology="barabasi_albert", m=2, scale=0.03,
                                model=make_mlp(hidden=(64, 32)),
                                device=where)
        exp = Experiment(world, "decdiff+vt", steps_per_round=2,
                         batch_size=32, device=where)
        hist = exp.run(rounds=3, eval_every=1)
        runs.append((hist, [p.cpu() for p in tree_leaves(exp.params)],
                     len(world.x_test)))
    (hc, pc, n_test), (hh, ph, _) = runs
    used = (n_test // min(128, n_test)) * min(128, n_test)
    perr = max(float((a - b).abs().max()) for a, b in zip(pc, ph))
    aerr = max(float(abs(a.acc_per_node - b.acc_per_node).max()) * used
               for a, b in zip(hc, hh))
    print(f"small world (16 nodes, MLP 784-64-32-10, 3 rounds) card vs "
          f"cpu: max |param diff| {perr:.3g}, max accuracy diff "
          f"{aerr:.3g} test samples")
    check(perr <= 1e-4, f"card and cpu params differ by {perr}")
    check(aerr <= 1.0 + 1e-6, f"card and cpu accuracy differ by {aerr} "
                              f"samples")


def profile_round(torch, exp):
    """One fused round, eval included, under torch.profiler: device time
    by kernel name and the device's busy share of the wall time."""
    from torch.profiler import ProfilerActivity, profile

    exp.run(rounds=1, eval_every=1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        exp.run(rounds=1, eval_every=1)
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    check(dev, "the profiler saw no device activity")
    by_name = {}
    spans = sorted((e.time_range.start, e.time_range.end) for e in dev)
    for e in dev:
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + e.time_range.elapsed_us())
    busy, end = 0.0, -math.inf
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    total = sum(t for _, t in by_name.values())
    print(f"profile of one round (eval included): wall {wall_us / 1e3:.3f} "
          f"ms, device busy {busy / 1e3:.3f} ms "
          f"({100 * busy / wall_us:.1f}% of wall), {len(dev)} device "
          f"events over {len(by_name)} kernels")
    for name, (n, t) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[
            :15]:
        print(f"  {t / 1e3:9.3f} ms {100 * t / total:5.1f}%  x{n:<5d} "
              f"{name[:110]}")


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card available", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "__init__.py").is_file():
        print(f"chip_smoke: the port is not beside this script "
              f"({SRC / 'repro_torch'} missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.engine import Experiment, Schedule, World
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels.segment_avg import segment_avg_plain
    from repro_torch.utils.pytree import tree_flatten_stacked, tree_leaves

    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}, "
          f"{torch.cuda.device_count()} device(s)")

    # -- build every kernel of the port, all nvcc processes at once ------
    t0 = time.perf_counter()
    libs = _build.build(["segment_avg"])
    print(f"built {sorted(libs)} in {time.perf_counter() - t0:.1f} s "
          f"({_build.BUILD_DIR})")

    # -- the main path -----------------------------------------------------
    t0 = time.perf_counter()
    world = World.synthetic("synth-mnist", nodes=16,
                            topology="barabasi_albert", m=2, scale=1.0)
    exp = Experiment(world, "decdiff+vt",
                     schedule=Schedule(rounds=ROUNDS, eval_every=1))
    n_params = tree_flatten_stacked(exp.params)[0].shape[1]
    print(f"world + experiment built in {time.perf_counter() - t0:.1f} s: "
          f"{exp.n} nodes, {n_params} params per node, "
          f"{len(world.x_test)} test images, degrees "
          f"{world.topo.degrees.tolist()}, max degree "
          f"{world.topo.max_degree}")
    check(n_params == 567434, f"MLP has {n_params} params, not 567434")
    # the reduce's inputs at the main path's shape, before any round
    table0 = tree_flatten_stacked(exp.params)[0]
    vals_main = table0[exp.nbr_idx].contiguous()
    w_main = (exp.nbr_weight * exp.nbr_valid).contiguous()

    exp.run(rounds=1, eval_every=1)  # warm round
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    history = exp.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    losses = exp.train_loss_history[-ROUNDS:]
    print(f"main path: {ROUNDS} rounds (fused, eval every round) in "
          f"{wall:.3f} s = {1e3 * wall / ROUNDS:.2f} ms per round")
    for m, loss in zip(history, losses):
        print(f"  round {m.round}: mean acc {m.acc_mean:.4f}, "
              f"train loss {loss:.5f}")
    print(f"kernel launches in the main-path run: {launches}")
    check(launches["segment_neighbor_avg"] >= ROUNDS,
          f"segment_neighbor_avg launched {launches} times in {ROUNDS} "
          f"rounds")
    check([m.round for m in history] == list(range(ROUNDS)),
          f"eval rounds {[m.round for m in history]}")
    for m in history:
        check(m.acc_per_node.shape == (16,), "acc shape")
        check(((m.acc_per_node >= 0) & (m.acc_per_node <= 1)).all(),
              "accuracy outside [0, 1]")
        check(all(math.isfinite(x) for x in m.loss_per_node), "eval loss")
    check(len(losses) == ROUNDS and all(math.isfinite(x) for x in losses),
          f"train losses {losses}")
    check(all(bool(torch.isfinite(p).all()) for p in tree_leaves(exp.params)),
          "non-finite params")
    small_world_agrees(torch, dev)

    # -- each kernel against its plain version, at the main path's shapes
    main = kernel_vs_plain(torch, ops, segment_avg_plain, vals_main, w_main,
                           "main path (16-node BA m=2, real weights)")
    from repro_torch.graphs.topology import barabasi_albert
    topo64 = barabasi_albert(64, m=2, seed=0)
    gen = torch.Generator(device=dev).manual_seed(0)
    k64 = topo64.max_degree
    vals64 = torch.randn((64, k64, n_params), generator=gen, device=dev)
    w64 = torch.from_numpy(topo64.neighbor_mask.astype("float32")).to(dev) \
        * torch.rand((64, k64), generator=gen, device=dev)
    kernel_vs_plain(torch, ops, segment_avg_plain, vals64, w64.contiguous(),
                    "64-node BA m=2")
    del vals64, vals_main
    if "--profile" in sys.argv[1:]:
        profile_round(torch, exp)

    kernels = [dict(
        name="segment_neighbor_avg", route="cuda",
        source="src/repro_torch/csrc/segment_avg.cu",
        replaces="src/repro/kernels/segment_avg.py:62",
        launches=launches["segment_neighbor_avg"],
        max_abs_err=main["max_abs_err"], ms=main["ms"],
        plain_ms=main["plain_ms"], bound_ms=main["bound_ms"],
        bound_by=main["bound_by"], library_ms=main["library_ms"],
        shape=main["shape"])]
    print(f"chip_smoke finished in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        sys.exit(1)
