#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA card.

    python3 chip_smoke.py [--profile]

Run from the root of a checkout on a machine with a CUDA card and nvcc.
It imports the port only (no JAX), and:

  1. prints the card's name and power limit (nvidia-smi);
  2. builds every CUDA kernel of the port from `src/repro_torch/csrc`
     (one nvcc per source, all at once);
  3. drives three paths on `World.synthetic("synth-mnist", nodes=16,
     topology="barabasi_albert", m=2, scale=1.0)` with the paper's MNIST
     MLP 784-512-256-128-10 at full width, each `decdiff+vt` for 3 rounds
     in the default fused mode after one warm round, with every kernel
     launch count set to 0 just before the 3 rounds and read just after:
       a. no transport (the main path of the first slice);
       b. the per-edge transport, `CommConfig(codec="int8",
          policy="adaptive", target_trigger=0.95)` — `gather_rows` must
          launch once per round and the segment reduce at least once;
       c. the per-node transport, `CommConfig(codec="int8")`, always send;
     a kernel of a path that was never launched fails the run; then the
     three paths run again in turns (a, b, c, c, b, a) for their ms per
     round;
  4. checks what comes out: per-node accuracies of shape [16] in [0, 1],
     finite train losses and params, bytes on the wire equal to the
     payload formula (567,438 bytes per fired edge) and a triggered
     fraction in (0, 1]; and a small world run on the card that agrees
     with the same run on the CPU (the plain path, which the CPU tests
     hold against the JAX reference), without and with the per-edge
     transport (params to 1e-4, accuracy to one test sample, bytes
     exactly);
  5. holds each kernel against its plain PyTorch version on the card at
     the main path's shapes and at a 64-node BA m=2 shape (both kernels
     bitwise, `torch.equal`), and times kernel, plain version and one
     PyTorch library call with CUDA events (median of 20) beside the HBM
     bound;
  6. prints one JSON line listing the kernels, then the card's name and
     power limit, then, as its last line, `{"ok": true, "device": {...}}`.

With `--profile` it also traces one more round (eval included) of paths
a and b under `torch.profiler` and prints the device time by kernel and
the device's busy share of the round's wall time.

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


def gather_bound_ms(tbl_rows, idx, d):
    """Least time for the gather: the distinct rows the index names read
    once, every output row written once, the indices read once, over HBM
    bandwidth (a copy does no float operation).  Also the bound that
    counts every slot's read."""
    k = int(idx.numel())
    distinct = int(idx.unique().numel())
    need = 4 * distinct * d + 4 * k * d + 8 * k
    every = 4 * k * d + 4 * k * d + 8 * k
    return (1e3 * need / HBM_BYTES_PER_S, 1e3 * every / HBM_BYTES_PER_S,
            distinct, need)


def gather_vs_plain(torch, ops, plain, tbl, idx, label):
    """Hold the gather kernel against its plain version (bitwise) and time
    kernel, plain version and `torch.index_select`."""
    m, d = tbl.shape
    out = ops.gather_rows(tbl, idx)
    torch.cuda.synchronize()
    ref = plain(tbl, idx)
    equal = bool(torch.equal(out, ref))
    err = float((out - ref).abs().max()) if out.numel() else 0.0
    del out, ref
    ms = median_ms(torch, lambda: ops.gather_rows(tbl, idx))
    plain_ms = median_ms(torch, lambda: plain(tbl, idx))
    lib_ms = median_ms(torch, lambda: torch.index_select(tbl, 0, idx))
    bound_ms, every_ms, distinct, need = gather_bound_ms(m, idx, d)
    print(f"gather_rows {label} [M={m}, K={idx.numel()}, D={d}, "
          f"{distinct} distinct rows]: torch.equal(kernel, plain)={equal} "
          f"max_abs_err={err:g} kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"index_select {lib_ms:.4f} ms, bound {bound_ms:.4f} ms (bytes, "
          f"{need / 1e6:.1f} MB; kernel at {100 * bound_ms / ms:.1f}%), "
          f"every-slot bound {every_ms:.4f} ms (kernel at "
          f"{100 * every_ms / ms:.1f}%)")
    check(equal, f"gather_rows {label}: kernel != plain (max_abs_err {err:g})")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=bound_ms, bound_by="bytes", max_abs_err=err,
                every_slot_bound_ms=every_ms, shape=[m, int(idx.numel()), d])


def small_world_agrees(torch, dev, comm=None, label="no transport"):
    """The same small run on the card and on the CPU (same world, same
    init, no random draws in the rounds) must agree; with a transport the
    bytes on the wire must be equal."""
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
                         batch_size=32, device=where, comm=comm)
        hist = exp.run(rounds=3, eval_every=1)
        runs.append((hist, [p.cpu() for p in tree_leaves(exp.params)],
                     len(world.x_test), list(exp.trig_history)))
    (hc, pc, n_test, tc), (hh, ph, _, th) = runs
    used = (n_test // min(128, n_test)) * min(128, n_test)
    perr = max(float((a - b).abs().max()) for a, b in zip(pc, ph))
    aerr = max(float(abs(a.acc_per_node - b.acc_per_node).max()) * used
               for a, b in zip(hc, hh))
    bytes_c = [m.bytes_on_wire for m in hc]
    bytes_h = [m.bytes_on_wire for m in hh]
    print(f"small world (16 nodes, MLP 784-64-32-10, 3 rounds, {label}) "
          f"card vs cpu: max |param diff| {perr:.3g}, max accuracy diff "
          f"{aerr:.3g} test samples, bytes on the wire card {bytes_c} cpu "
          f"{bytes_h}, triggered card {tc} cpu {th}")
    check(perr <= 1e-4, f"card and cpu params differ by {perr} ({label})")
    check(aerr <= 1.0 + 1e-6, f"card and cpu accuracy differ by {aerr} "
                              f"samples ({label})")
    check(bytes_c == bytes_h and tc == th,
          f"card and cpu bytes on the wire differ ({label}): {bytes_c} vs "
          f"{bytes_h}, triggered {tc} vs {th}")


def check_history(torch, exp, history, losses, label):
    from repro_torch.utils.pytree import tree_leaves

    check([m.round for m in history] == list(range(ROUNDS)),
          f"{label}: eval rounds {[m.round for m in history]}")
    for m in history:
        check(m.acc_per_node.shape == (16,), f"{label}: acc shape")
        check(((m.acc_per_node >= 0) & (m.acc_per_node <= 1)).all(),
              f"{label}: accuracy outside [0, 1]")
        check(all(math.isfinite(x) for x in m.loss_per_node),
              f"{label}: eval loss")
    check(len(losses) == ROUNDS and all(math.isfinite(x) for x in losses),
          f"{label}: train losses {losses}")
    check(all(bool(torch.isfinite(p).all()) for p in tree_leaves(exp.params)),
          f"{label}: non-finite params")


def drive(torch, ops, exp, label):
    """One warm round, then ROUNDS fused rounds with every launch count set
    to 0 just before and read just after.  Returns the history, the
    launches, the ms per round and the transport's byte and trigger
    deltas over the measured rounds."""
    exp.run(rounds=1, eval_every=1)  # warm round
    torch.cuda.synchronize()
    bytes0 = exp.comm_bytes_total
    ntrig = len(exp.trig_history)
    ops.reset_launches()
    t0 = time.perf_counter()
    history = exp.run(rounds=ROUNDS, eval_every=1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    losses = exp.train_loss_history[-ROUNDS:]
    ms_round = 1e3 * wall / ROUNDS
    print(f"{label}: {ROUNDS} rounds (fused, eval every round) in "
          f"{wall:.3f} s = {ms_round:.2f} ms per round; kernel launches "
          f"{launches}")
    for m, loss in zip(history, losses):
        extra = ("" if m.bytes_on_wire is None else
                 f", bytes on the wire {m.bytes_on_wire:.0f}, triggered "
                 f"{m.triggered_frac:.4f}")
        print(f"  round {m.round}: mean acc {m.acc_mean:.4f}, "
              f"train loss {loss:.5f}{extra}")
    check_history(torch, exp, history, losses, label)
    return (history, launches, ms_round, exp.comm_bytes_total - bytes0,
            exp.trig_history[ntrig:])


def profile_round(torch, exp, label):
    """One fused round, eval included, under torch.profiler: device time
    by kernel name and the device's busy share of the wall time."""
    from torch.profiler import ProfilerActivity, profile

    exp.run(rounds=1, eval_every=1)
    torch.cuda.synchronize()
    # the first trace of a process also pays the profiler's start-up: trace
    # twice and keep the second
    for _ in range(2):
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
    print(f"profile of one {label} round (eval included): wall "
          f"{wall_us / 1e3:.3f} ms, device busy {busy / 1e3:.3f} ms "
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

    from repro_torch.comm import CommConfig, EdgeGossipTransport
    from repro_torch.engine import Experiment, Schedule, World
    from repro_torch.graphs.topology import barabasi_albert
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels.gather_rows import gather_rows_plain
    from repro_torch.kernels.segment_avg import segment_avg_plain
    from repro_torch.utils.pytree import tree_flatten_stacked

    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}, "
          f"{torch.cuda.device_count()} device(s)")

    # -- build every kernel of the port, all nvcc processes at once ------
    t0 = time.perf_counter()
    libs = _build.build(sorted(p.stem for p in _build.CSRC_DIR.glob("*.cu")))
    check(sorted(libs) == ["gather_rows", "segment_avg"],
          f"kernel sources {sorted(libs)}")
    print(f"built {sorted(libs)} in {time.perf_counter() - t0:.1f} s "
          f"({_build.BUILD_DIR})")

    # -- the world of every full-width path --------------------------------
    t0 = time.perf_counter()
    world = World.synthetic("synth-mnist", nodes=16,
                            topology="barabasi_albert", m=2, scale=1.0)
    sched = Schedule(rounds=ROUNDS, eval_every=1)
    exp = Experiment(world, "decdiff+vt", schedule=sched)
    n_params = tree_flatten_stacked(exp.params)[0].shape[1]
    n_dir = int(world.topo.neighbor_mask.sum())
    print(f"world + experiment built in {time.perf_counter() - t0:.1f} s: "
          f"{exp.n} nodes, {n_params} params per node, "
          f"{len(world.x_test)} test images, degrees "
          f"{world.topo.degrees.tolist()}, max degree "
          f"{world.topo.max_degree}, {n_dir} directed edges")
    check(n_params == 567434, f"MLP has {n_params} params, not 567434")
    # the reduce's inputs at the main path's shape, before any round
    table0 = tree_flatten_stacked(exp.params)[0]
    vals_main = table0[exp.nbr_idx].contiguous()
    w_main = (exp.nbr_weight * exp.nbr_valid).contiguous()

    # -- path a: no transport ----------------------------------------------
    _, l_plain, ms_plain, _, _ = drive(torch, ops, exp, "path a (no transport)")
    check(l_plain["segment_neighbor_avg"] >= ROUNDS,
          f"segment_neighbor_avg launched {l_plain} in {ROUNDS} rounds")

    # -- path b: the per-edge transport ------------------------------------
    exp_e = Experiment(world, "decdiff+vt", schedule=sched,
                       comm=CommConfig(codec="int8", policy="adaptive",
                                       target_trigger=0.95))
    payload = exp_e.transport.payload_bytes
    check(payload == n_params + 4, f"int8 payload {payload} bytes")
    hist_e, l_edge, ms_edge, bytes_e, trig_e = drive(
        torch, ops, exp_e, "path b (per-edge int8 adaptive 0.95)")
    check(l_edge["gather_rows"] == ROUNDS,
          f"gather_rows launched {l_edge['gather_rows']} times in {ROUNDS} "
          f"rounds")
    check(l_edge["segment_neighbor_avg"] >= ROUNDS,
          f"segment_neighbor_avg launched {l_edge} in {ROUNDS} rounds")
    sent_e = [t * n_dir for t in trig_e]
    check(len(sent_e) == ROUNDS and all(abs(x - round(x)) < 1e-3
                                        for x in sent_e),
          f"fired edges per round {sent_e}")
    fired = sum(round(x) for x in sent_e)
    print(f"path b: fired edges per round {[round(x) for x in sent_e]}, "
          f"bytes on the wire {bytes_e:.0f} = {payload} x {fired}")
    check(bytes_e == payload * fired and bytes_e <= n_dir * payload * ROUNDS,
          f"per-edge bytes {bytes_e} != {payload} x {fired}")
    check(all(0.0 < m.triggered_frac <= 1.0 for m in hist_e),
          f"triggered fractions {[m.triggered_frac for m in hist_e]}")

    # -- path c: the per-node transport, always send -----------------------
    exp_n = Experiment(world, "decdiff+vt", schedule=sched,
                       comm=CommConfig(codec="int8"))
    hist_n, l_node, ms_node, bytes_n, trig_n = drive(
        torch, ops, exp_n, "path c (per-node int8, always send)")
    check(l_node["segment_neighbor_avg"] >= ROUNDS and
          l_node["gather_rows"] == 0, f"per-node launches {l_node}")
    # threshold 0: every gate fires, Σ_i gate_i·outdeg_i = directed edges
    check(trig_n == [1.0] * ROUNDS and bytes_n == payload * n_dir * ROUNDS,
          f"per-node bytes {bytes_n} != {payload} x {n_dir} x {ROUNDS} "
          f"(triggered {trig_n})")
    check(all(m.triggered_frac == 1.0 for m in hist_n), "per-node trigger")
    print(f"ms per round: no transport {ms_plain:.2f}, per-edge "
          f"{ms_edge:.2f}, per-node {ms_node:.2f}")
    # the host's load moves a round's wall time from call to call: compare
    # the paths in turns (a, b, c, c, b, a) within this call
    turns = {"a": [], "b": [], "c": []}
    for key in "abccba":
        e = {"a": exp, "b": exp_e, "c": exp_n}[key]
        t0 = time.perf_counter()
        e.run(rounds=ROUNDS, eval_every=1)
        torch.cuda.synchronize()
        turns[key].append(1e3 * (time.perf_counter() - t0) / ROUNDS)
    print("ms per round in turns a, b, c, c, b, a: " + ", ".join(
        f"{k} {statistics.median(v):.2f} ({', '.join(f'{x:.2f}' for x in v)})"
        for k, v in turns.items()))

    # -- the small world, card vs cpu ----------------------------------------
    small_world_agrees(torch, dev)
    small_world_agrees(torch, dev, CommConfig(
        codec="int8", policy="adaptive", target_trigger=0.95,
        stochastic=False), "per-edge int8 adaptive 0.95, deterministic")

    # -- each kernel against its plain version, at the main path's shapes
    seg = kernel_vs_plain(torch, ops, segment_avg_plain, vals_main, w_main,
                          "main path (16-node BA m=2, real weights)")
    table_e = exp_e.comm_state.last_sent.reshape(-1, n_params)
    gat = gather_vs_plain(torch, ops, gather_rows_plain, table_e,
                          exp_e.transport.flat_idx,
                          "per-edge path (real per-link table after "
                          f"{ROUNDS + 1} rounds)")
    del vals_main, table_e
    topo64 = barabasi_albert(64, m=2, seed=0)
    gen = torch.Generator(device=dev).manual_seed(0)
    k64 = topo64.max_degree
    vals64 = torch.randn((64, k64, n_params), generator=gen, device=dev)
    w64 = torch.from_numpy(topo64.neighbor_mask.astype("float32")).to(dev) \
        * torch.rand((64, k64), generator=gen, device=dev)
    kernel_vs_plain(torch, ops, segment_avg_plain, vals64, w64.contiguous(),
                    "64-node BA m=2")
    del vals64
    tr64 = EdgeGossipTransport(CommConfig(per_edge=True),
                               {"w": torch.zeros((64, 1), device=dev)},
                               topo64.neighbor_idx, topo64.neighbor_mask)
    tbl64 = torch.randn((64 * k64, n_params), generator=gen, device=dev)
    gather_vs_plain(torch, ops, gather_rows_plain, tbl64, tr64.flat_idx,
                    "64-node BA m=2, random rows")
    del tbl64
    if "--profile" in sys.argv[1:]:
        profile_round(torch, exp, "no-transport")
        profile_round(torch, exp_e, "per-edge transport")

    by_path = {"a": l_plain, "b": l_edge, "c": l_node}
    def launches(name):
        return sum(p[name] for p in by_path.values())

    kernels = [
        dict(name="segment_neighbor_avg", route="cuda",
             source="src/repro_torch/csrc/segment_avg.cu",
             replaces="src/repro/kernels/segment_avg.py:62",
             launches=launches("segment_neighbor_avg"),
             launches_by_path={k: p["segment_neighbor_avg"]
                               for k, p in by_path.items()},
             max_abs_err=seg["max_abs_err"], ms=seg["ms"],
             plain_ms=seg["plain_ms"], bound_ms=seg["bound_ms"],
             bound_by=seg["bound_by"], library_ms=seg["library_ms"],
             shape=seg["shape"]),
        dict(name="gather_rows", route="cuda",
             source="src/repro_torch/csrc/gather_rows.cu",
             replaces="src/repro/kernels/gather_rows.py:39",
             launches=launches("gather_rows"),
             launches_by_path={k: p["gather_rows"]
                               for k, p in by_path.items()},
             max_abs_err=gat["max_abs_err"], ms=gat["ms"],
             plain_ms=gat["plain_ms"], bound_ms=gat["bound_ms"],
             bound_by=gat["bound_by"], library_ms=gat["library_ms"],
             every_slot_bound_ms=gat["every_slot_bound_ms"],
             shape=gat["shape"]),
    ]
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
