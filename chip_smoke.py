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
     on each, the VT loss's forward and backward kernels launch once per
     local step; a kernel of a path that was never launched fails the
     run; then the three paths run again in turns (a, b, c, c, b, a) for
     their ms per round;
  4. checks what comes out: per-node accuracies of shape [16] in [0, 1],
     finite train losses and params, bytes on the wire equal to the
     payload formula (567,438 bytes per fired edge) and a triggered
     fraction in (0, 1]; and a small world run on the card that agrees
     with the same run on the CPU (the plain path, which the CPU tests
     hold against the JAX reference), without and with the per-edge
     transport (params to 1e-4, accuracy to one test sample, bytes
     exactly);
  5. drives path d, the LM DFL pod round: `build_dfl_round_shardmap` in
     its one-pod form with the fused int8 gossip
     (`Int8Codec(stochastic=False)`), `build_lm(get_config("qwen1.5-0.5b"))`
     at full width (463,987,712 bf16 params per node), a 4-node ring,
     `sgd_momentum(lr=3e-3, momentum=0.9)`, the VT loss (β = 0.98), batch
     4 and seq 128 from `synthetic_token_batch`: one warm round, then 3
     measured rounds with the counts set to 0 just before and read just
     after — `dequant_neighbor_avg_rows` must launch once per round and the
     VT loss's forward and backward once per node-step; it prints ms per
     round, the peak device memory and the (finite) losses; then a reduced
     fp32 round (2 layers, d_model 64, vocab 256, 4 nodes, 2 rounds) on the
     card agrees with the CPU (params to 1e-4, loss to 1e-5);
  6. holds each kernel against its plain PyTorch version on the card at
     the main paths' shapes (and more), and times kernel, plain version and
     one PyTorch library call with CUDA events (median of 20) beside the
     bound: the segment reduce and the gather bitwise at paths a and b's
     shapes and at a 64-node BA m=2 shape; `dequant_neighbor_avg_rows`
     bitwise on path d's real int8 payload [4, 463987712] and at an odd D
     with 8 receivers and one zero row; the Eq. 5 kernels on path d's real
     flat block [4, 463987712] and its neighbourhood average (pass B
     bitwise for the kernel's scale, the norms within a stated tolerance);
     the VT loss forward and backward within a stated tolerance on path
     d's real logits [512, 151936] (bf16 and fp32) and at the MLP's
     [512, 10] and [32, 10];
  7. drives path e, dense serving at full width, after path d's state is
     freed: the reference's `decode_32k` serve step (`launch/dryrun.py`)
     with the request flow of `examples/serve_decode.py`, through
     `launch/serve.py:generate` — `build_lm(get_config("qwen1.5-0.5b"))`
     (463,987,712 bf16 params drawn on the card), `lm.init_cache(8, 32768)`
     (25.8 GB of bf16 k and v; the batch cut from 128 to 8) with its ring
     filled to a near-full 32k context (N(0, 1) k and v at positions
     0..32719, in place of a prefill's), 16 prompt tokens per sequence
     through `build_serve_step`, then 32 greedy decode steps, which fill
     the last slots, with the counts set to 0 just before and read just
     after: `decode_attention_fused` must launch 24 x 48 times.  It prints
     ms per decode step (median of 32, min and max), tokens per second,
     the peak device memory and the first sequence's tokens; checks finite
     logits of shape [8, 1, 151936], the ring's slot positions (0..32767)
     and length; and a
     reduced decode (fp32, qwen1.5-0.5b and qwen3-32b's G = 8) on the card
     agrees with the CPU (logits 1e-4, equal tokens) and with the port's
     teacher-forced forward on the card (1e-4).  Then the decode kernel
     against its plain version (a stated tolerance) on path e's real
     layer-0 cache with a real query, a full synthetic window [8, 32768,
     16, 64] bf16, qwen2.5-14b's GQA shape (q [8, 40, 128], k / v [8,
     32768, 8, 128]) and an odd B = 3, W = 1000 with a sliding window;
  8. prints one JSON line listing the kernels, then the card's name and
     power limit, then, as its last line, `{"ok": true, "device": {...}}`.

Paths a-d also run the Eq. 5 step through the `decdiff_update` kernels:
one launch per round each.  With `--profile` it also traces one more
round (eval included) of paths a and b, one round of path d and one decode
step of path e under `torch.profiler` and prints the device time by kernel
and the device's busy share of the wall time.

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
LM_ARCH = "qwen1.5-0.5b"
LM_PARAMS = 463_987_712     # per node, bf16
LM_NODES, LM_BATCH, LM_SEQ, LM_BETA = 4, 4, 128, 0.98
SERVE_BATCH, SERVE_WINDOW, SERVE_PROMPT, SERVE_STEPS = 8, 32768, 16, 32
LM_LAYERS = 24


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


def profile_round(torch, run, label):
    """One call of `run` (one round) under torch.profiler: device time by
    kernel name and the device's busy share of the wall time.  Returns
    ({kernel name: (count, device us)}, the profiler)."""
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    # the first trace of a process also pays the profiler's start-up: trace
    # twice and keep the second
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall_us = 1e6 * (time.perf_counter() - t0)
    on_dev = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    # the round's record_function ranges appear on the device timeline as
    # spans, not kernels: kept apart
    ranges = [e for e in on_dev if e.name.startswith("dfl_round.")]
    dev = [e for e in on_dev if not e.name.startswith("dfl_round.")]
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
    print(f"profile of one {label} round: wall {wall_us / 1e3:.3f} ms, "
          f"device busy {busy / 1e3:.3f} ms ({100 * busy / wall_us:.1f}% of "
          f"wall), {len(dev)} device events over {len(by_name)} kernels")
    for name, (n, t) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[
            :15]:
        print(f"  {t / 1e3:9.3f} ms {100 * t / total:5.1f}%  x{n:<5d} "
              f"{name[:110]}")
    for r in ranges:
        lo, hi = r.time_range.start, r.time_range.end
        inside = sum(e.time_range.elapsed_us() for e in dev
                     if lo <= e.time_range.start < hi)
        host = sum(e.cpu_time_total for e in prof.events()
                   if e.name == r.name
                   and e.device_type == torch.autograd.DeviceType.CPU)
        print(f"  range {r.name}: host {host / 1e3:.3f} ms, device span "
              f"{(hi - lo) / 1e3:.3f} ms, kernels in it {inside / 1e3:.3f} ms")
    return by_name, prof


# kernel-name families of path d's profile, matched in this order
LM_FAMILIES = (
    ("vt_kl_loss kernels", ("vt_fwd_kernel", "vt_bwd_kernel")),
    ("dequant_avg_rows kernel", ("dequant_avg_rows_kernel",)),
    ("decode_attention kernels", ("decode_split_kernel",
                                  "decode_combine_kernel")),
    ("decdiff_update kernels", ("sumsq_rows_kernel", "scale_rows_kernel",
                                "step_rows_kernel")),
    ("GEMM (cuBLAS/CUTLASS)", ("gemm", "xmma", "cutlass", "sm90_", "sm80_",
                               "cublas", "nvjet")),
    ("reductions", ("reduce_kernel",)),
    ("elementwise and copies", ("elementwise", "copy", "fill", "cat",
                                "index")),
)


def print_families(by_name, label):
    sums = {}
    for name, (_, t) in by_name.items():
        low = name.lower()
        fam = next((f for f, keys in LM_FAMILIES
                    if any(k.lower() in low for k in keys)), "other")
        sums[fam] = sums.get(fam, 0.0) + t
    total = sum(sums.values())
    print(f"{label} device time by family: " + ", ".join(
        f"{f} {t / 1e3:.3f} ms ({100 * t / total:.1f}%)"
        for f, t in sorted(sums.items(), key=lambda kv: -kv[1])))


def path_d(torch, ops, dev, profile):
    """The LM DFL pod round at full qwen1.5-0.5b width (see the module
    docstring).  Returns what the kernel phases need: the launches, the
    round times, the peak memory, and the kernels' real inputs (the final
    int8 payload with its weights, and node 0's logits and labels)."""
    from repro_torch.comm.codecs import Int8Codec
    from repro_torch.configs import get_config
    from repro_torch.dist.dfl_step import _normalized, build_dfl_round_shardmap
    from repro_torch.launch.train import (
        init_nodes,
        make_batches,
        ring_adjacency,
    )
    from repro_torch.models.lm import build_lm
    from repro_torch.optim.sgd import sgd_momentum
    from repro_torch.utils.pytree import (
        tree_flatten_stacked,
        tree_leaves,
        tree_map,
    )

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    lm = build_lm(get_config(LM_ARCH))
    params = init_nodes(lm, LM_NODES, dev)
    d = sum(t[0].numel() for t in tree_leaves(params))
    check(d == LM_PARAMS, f"{LM_ARCH} has {d} params per node")
    check(all(t.dtype == torch.bfloat16 for t in tree_leaves(params)),
          "full-width params are not bf16")
    opt = sgd_momentum(lr=3e-3, momentum=0.9)
    state = opt.init(params)
    codec = Int8Codec(stochastic=False)
    adj = ring_adjacency(LM_NODES)
    rnd = build_dfl_round_shardmap(lm, opt, adj, loss_kind="vt",
                                   beta=LM_BETA, codec=codec)
    batches = list(make_batches(lm, LM_NODES, LM_BATCH, LM_SEQ, 1 + ROUNDS,
                                dev))
    torch.cuda.synchronize()
    print(f"path d set-up in {time.perf_counter() - t0:.1f} s: {LM_ARCH} "
          f"full width, {LM_NODES} nodes x {d} bf16 params, "
          f"{len(tree_leaves(params))} leaves per node, batch {LM_BATCH} x "
          f"seq {LM_SEQ} per node")
    t0 = time.perf_counter()
    params, state, loss = rnd(params, state, 0, batches[0])  # warm round
    warm = float(loss)
    torch.cuda.synchronize()
    print(f"path d warm round: {1e3 * (time.perf_counter() - t0):.1f} ms, "
          f"loss {warm:.5f}")
    ops.reset_launches()
    alloc0 = torch.cuda.memory_stats()
    ms, losses = [], []
    for r in range(1, ROUNDS + 1):
        t0 = time.perf_counter()
        params, state, loss = rnd(params, state, r, batches[r])
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
        losses.append(float(loss))
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    alloc1 = torch.cuda.memory_stats()
    print("path d caching allocator over the measured rounds: " + ", ".join(
        f"{k} +{alloc1.get(k, 0) - alloc0.get(k, 0)}"
        for k in ("num_device_alloc", "num_device_free", "num_alloc_retries",
                  "num_sync_all_streams")))
    print(f"path d (LM DFL pod round, fused int8): {ROUNDS} rounds, ms per "
          f"round {', '.join(f'{x:.2f}' for x in ms)} (median "
          f"{statistics.median(ms):.2f}); losses "
          f"{', '.join(f'{x:.5f}' for x in losses)}; peak device memory "
          f"{peak / 2**30:.2f} GiB ({peak} B); kernel launches {launches}")
    check(all(math.isfinite(x) for x in [warm] + losses),
          f"path d losses {losses}")
    check(launches["dequant_neighbor_avg_rows"] == ROUNDS,
          f"dequant_neighbor_avg_rows launched "
          f"{launches['dequant_neighbor_avg_rows']} times in {ROUNDS} rounds")
    check(launches["decdiff_update"] == ROUNDS,
          f"decdiff_update launched {launches['decdiff_update']} times in "
          f"{ROUNDS} rounds")
    check(launches["vt_kl_loss_fwd"] == launches["vt_kl_loss_bwd"]
          == LM_NODES * ROUNDS,
          f"vt_kl_loss launches {launches} in {LM_NODES * ROUNDS} "
          f"node-steps")
    check(all(bool(torch.isfinite(t).all()) for t in tree_leaves(params)),
          "path d: non-finite params")
    if profile:
        box = [params, state]

        def one_round():
            box[0], box[1], _ = rnd(box[0], box[1], ROUNDS, batches[-1])

        by_name, prof = profile_round(torch, one_round, "path d (LM pod)")
        print_families(by_name, "path d")
        averages = prof.key_averages()
        print("  host time by op (self, top 12; the backward runs on "
              "autograd's device thread while the range's own thread "
              "waits):")
        for e in sorted(averages, key=lambda e: -e.self_cpu_time_total)[:12]:
            print(f"  {e.self_cpu_time_total / 1e3:9.3f} ms  x{e.count:<6d} "
                  f"{e.key[:100]}")
        params, state = box
    # the kernels' real inputs at this path's shapes
    node0 = tree_map(lambda t: t[0], params)
    with torch.no_grad():
        logits, _ = lm.forward(node0, {k: v[0] for k, v in
                                       batches[-1].items()})
    w, _ = tree_flatten_stacked(params)
    payload, _ = codec.encode(w)
    wn, row = _normalized(torch.from_numpy(adj).to(dev), None)
    return dict(launches=launches, ms=ms, losses=losses, peak=peak,
                q=payload["q"], scale=payload["scale"], wn=wn.contiguous(),
                w=w, row=row.contiguous(),
                logits=logits.reshape(-1, logits.shape[-1]).contiguous(),
                labels=batches[-1]["labels"][0].reshape(-1).contiguous())


def small_lm_agrees(torch, dev):
    """Two fused int8 one-pod rounds of qwen1.5-0.5b reduced to 2 layers,
    d_model 64, vocab 256 (fp32), 4-node ring, on the card and on the CPU
    (the plain versions, which the CPU tests hold against the JAX
    reference): params within 1e-4, loss within 1e-5."""
    from repro_torch.comm.codecs import Int8Codec
    from repro_torch.configs import get_config
    from repro_torch.dist.dfl_step import build_dfl_round_shardmap
    from repro_torch.launch.train import (
        init_nodes,
        make_batches,
        ring_adjacency,
    )
    from repro_torch.models.lm import build_lm
    from repro_torch.optim.sgd import sgd_momentum
    from repro_torch.utils.pytree import tree_leaves, tree_map

    lm = build_lm(get_config(LM_ARCH).reduced(n_layers=2, d_model=64,
                                              vocab=256))
    opt = sgd_momentum(lr=3e-3, momentum=0.9)
    rnd = build_dfl_round_shardmap(lm, opt, ring_adjacency(LM_NODES),
                                   loss_kind="vt", beta=LM_BETA,
                                   codec=Int8Codec(stochastic=False))
    p0 = init_nodes(lm, LM_NODES, "cpu")
    runs = []
    for where in (dev, torch.device("cpu")):
        params = tree_map(lambda t: t.to(where, copy=True), p0)
        state = opt.init(params)
        losses = []
        for r, b in enumerate(make_batches(lm, LM_NODES, 2, 16, 2, where)):
            params, state, loss = rnd(params, state, r, b)
            losses.append(float(loss))
        runs.append(([t.cpu() for t in tree_leaves(params)], losses))
    (pc, lc), (ph, lh) = runs
    perr = max(float((a - b).abs().max()) for a, b in zip(pc, ph))
    lerr = max(abs(a - b) for a, b in zip(lc, lh))
    print(f"small LM round (qwen1.5-0.5b reduced: 2 layers, d_model 64, "
          f"vocab 256, fp32; 4 nodes, 2 fused int8 rounds) card vs cpu: max "
          f"|param diff| {perr:.3g}, max |loss diff| {lerr:.3g} (losses card "
          f"{lc}, cpu {lh})")
    check(perr <= 1e-4, f"small LM round: card and cpu params differ by "
                        f"{perr}")
    check(lerr <= 1e-5, f"small LM round: card and cpu losses differ by "
                        f"{lerr}")


def dequant_vs_plain(torch, ops, q, scale, wn, label):
    """Hold `dequant_neighbor_avg_rows` against its plain version (bitwise)
    and time the kernel, the plain version and `ws @ q.float()`."""
    from repro_torch.kernels import dequant_avg as dq

    n, d = q.shape
    r = wn.shape[0]
    out = ops.dequant_neighbor_avg_rows(q, scale, wn)
    torch.cuda.synchronize()
    ws = (wn * scale[None, :]).contiguous()
    ref = dq.dequant_avg_rows_plain(q, ws)
    equal = bool(torch.equal(out, ref))
    err = float((out - ref).abs().max())
    zero_rows = int((wn.abs().sum(1) == 0).sum())
    zeros_ok = bool((out[wn.abs().sum(1) == 0] == 0).all())
    del out, ref
    ms = median_ms(torch, lambda: dq.dequant_avg_rows_cuda(q, ws))
    plain_ms = median_ms(torch, lambda: dq.dequant_avg_rows_plain(q, ws))
    lib_ms = median_ms(torch, lambda: ws @ q.float())
    nbytes = n * d + 4 * (r * n + r * d)
    flops = 2 * r * n * d
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS
    bound_ms = 1e3 * max(t_bytes, t_ops)
    bound_by = "bytes" if t_bytes >= t_ops else "operations"
    print(f"dequant_neighbor_avg_rows {label} [N={n}, R={r}, D={d}, "
          f"{zero_rows} zero weight rows]: torch.equal(kernel, plain)="
          f"{equal} max_abs_err={err:g} kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, ws @ q.float() {lib_ms:.4f} ms, bound "
          f"{bound_ms:.4f} ms ({bound_by}, {nbytes / 1e9:.3f} GB), kernel at "
          f"{100 * bound_ms / ms:.1f}% of bound")
    check(equal, f"dequant_neighbor_avg_rows {label}: kernel != plain "
                 f"(max_abs_err {err:g})")
    check(zeros_ok, f"dequant_neighbor_avg_rows {label}: a zero weight row "
                    f"did not average to zero")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=bound_ms, bound_by=bound_by, max_abs_err=err,
                shape=[n, r, d])


def vt_vs_plain(torch, ops, z, y, label, beta=LM_BETA):
    """Hold the VT loss kernels against their plain versions and time
    kernel, plain version and `F.cross_entropy` with label smoothing
    ε = V(1-β)/(V-1), which puts β on the label and (1-β)/(V-1) elsewhere
    (the same teacher), forward and backward.  Tolerance (the kernels sum
    in another order): per-row KL within 1e-5·|KL| + 1e-5·log V; each
    gradient entry within 1e-5·|ref| (fp32) or one bf16 rounding,
    2^-7·|ref| (bf16), plus min(1e-5·(p + p_t), 1e-6)·|g|: the fp32
    rounding of the two terms whose difference it is, at most 1e-6·|g|.
    The gradient's tolerance is checked to reject the plain backward with
    the teacher's tail a = (1-β)/(V-1) dropped from the wrong classes."""
    import torch.nn.functional as F

    from repro_torch.core.virtual_teacher import teacher_entropy
    from repro_torch.kernels import vt_kl_loss as vt

    b, v = z.shape
    h = float(teacher_entropy(beta, v))
    g = torch.full((b,), 1.0 / b, dtype=torch.float32, device=z.device)
    zr = z.detach().clone().requires_grad_(True)
    kl = ops.vt_kl_loss(zr, y, beta, -h)
    (dz,) = torch.autograd.grad(kl, zr, g)
    torch.cuda.synchronize()
    pk, pm, ps = vt.vt_forward_plain(z, y, beta, -h)
    pdz = vt.vt_backward_plain(z, y, pm, ps, g, beta)
    kl = kl.detach()
    fwd_err = float((kl - pk).abs().max())
    fwd_ok = bool(((kl - pk).abs() <= 1e-5 * pk.abs()
                   + 1e-5 * math.log(v)).all())
    rtol = 2.0 ** -7 if z.dtype == torch.bfloat16 else 1e-5
    a = vt.teacher_tail(beta, v)
    rows = torch.arange(b, device=z.device)
    terms = torch.exp(z.float() - pm[:, None]) / ps[:, None] + a  # p + p_t
    terms[rows, y] += beta - a
    tol = rtol * pdz.float().abs() + torch.clamp(
        1e-5 * terms, max=1e-6) * g.abs()[:, None]
    del terms
    diff = (dz.float() - pdz.float()).abs()
    bwd_err = float(diff.max())
    bwd_ok = bool((diff <= tol).all())
    no_tail = pdz.float() + a * g[:, None]  # a backward that leaves p_t
    no_tail[rows, y] -= a * g               # out of the wrong classes
    tail_caught = not bool(((no_tail.to(z.dtype).float() - pdz.float()).abs()
                            <= tol).all())
    del tol, no_tail
    eps = v * (1.0 - beta) / (v - 1)
    ce_minus_h = float(F.cross_entropy(z, y, label_smoothing=eps)) - h
    del dz, pdz, diff
    km, ks = vt.vt_forward_cuda(z, y, beta, -h)[1:]
    fwd_ms = median_ms(torch, lambda: vt.vt_forward_cuda(z, y, beta, -h))
    bwd_ms = median_ms(torch, lambda: vt.vt_backward_cuda(z, y, km, ks, g,
                                                          beta))
    fwd_plain = median_ms(torch, lambda: vt.vt_forward_plain(z, y, beta, -h))
    bwd_plain = median_ms(torch, lambda: vt.vt_backward_plain(z, y, pm, ps,
                                                              g, beta))
    fwd_lib = median_ms(torch, lambda: F.cross_entropy(
        z, y, label_smoothing=eps))
    zl = z.detach().clone().requires_grad_(True)
    lib_loss = F.cross_entropy(zl, y, label_smoothing=eps)
    bwd_lib = median_ms(torch, lambda: torch.autograd.grad(
        lib_loss, zl, retain_graph=True))
    del zl, lib_loss
    elt = z.element_size()
    small = 8 * b + 12 * b  # labels in, three fp32 row stats out / in
    out = {}
    for kind, nbytes, ops_per, ms, plain_ms, lib_ms, err in [
            ("fwd", b * v * elt + small, 4, fwd_ms, fwd_plain, fwd_lib,
             fwd_err),
            ("bwd", 2 * b * v * elt + small + 4 * b, 5, bwd_ms, bwd_plain,
             bwd_lib, bwd_err)]:
        t_bytes = nbytes / HBM_BYTES_PER_S
        t_ops = ops_per * b * v / FP32_FLOPS
        out[kind] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                         bound_ms=1e3 * max(t_bytes, t_ops),
                         bound_by="bytes" if t_bytes >= t_ops
                         else "operations",
                         max_abs_err=err, shape=[b, v], dtype=str(z.dtype))
        print(f"vt_kl_loss_{kind} {label} [B={b}, V={v}, {z.dtype}]: "
              f"max_abs_err={err:g} kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, F.cross_entropy(label_smoothing) "
              f"{'backward ' if kind == 'bwd' else ''}{lib_ms:.4f} ms, bound "
              f"{out[kind]['bound_ms']:.4f} ms ({out[kind]['bound_by']}), "
              f"kernel at {100 * out[kind]['bound_ms'] / ms:.1f}% of bound")
    print(f"  mean KL {float(kl.mean()):.6f}, plain {float(pk.mean()):.6f}, "
          f"cross_entropy(label_smoothing) - H(p_t) {ce_minus_h:.6f}")
    check(fwd_ok, f"vt_kl_loss_fwd {label}: kernel and plain differ by "
                  f"{fwd_err:g}")
    check(bwd_ok, f"vt_kl_loss_bwd {label}: kernel and plain differ by "
                  f"{bwd_err:g}")
    check(tail_caught, f"vt_kl_loss_bwd {label}: the tolerance passes a "
                       f"backward without the teacher's tail")
    return out


def eq5_vs_plain(torch, w, avg, row, label, s=1.0):
    """Hold the Eq. 5 kernels against their plain versions on one [R, D]
    block and time each pass.  Pass B must equal the plain step bitwise
    for the kernel's own scale; the per-row Σ(a − x)² within rtol 1e-5 of
    the plain sum (the kernel adds 4096-column block partials in index
    order, the plain sum in PyTorch's order; at D ~ 4.6e8 their fp32
    rounding differs by ~1e-7 relative).  Library: `vector_norm(a − x)`,
    then `x + scale[:, None] * (a − x)`."""
    from repro_torch.kernels import decdiff_update as dd

    r, d = w.shape
    scale, sq = dd.norms_cuda([w], [avg], row, s)
    torch.cuda.synchronize()
    sq_p = dd.sumsq_rows_plain([w], [avg])
    norm_err = float((sq - sq_p).abs().max())
    norm_ok = bool(((sq - sq_p).abs() <= 1e-5 * sq_p.abs()).all())
    out = dd.step_cuda(w, avg, scale)
    torch.cuda.synchronize()
    ref = dd.step_rows_plain(w, avg, scale)
    equal = bool(torch.equal(out, ref))
    step_err = float((out - ref).abs().max())
    gated = (row <= 0)
    gated_ok = bool(torch.equal(out[gated], w[gated]))
    del out, ref
    a_ms = median_ms(torch, lambda: dd.norms_cuda([w], [avg], row, s))
    a_plain = median_ms(torch, lambda: dd.sumsq_rows_plain([w], [avg]))
    a_lib = median_ms(torch, lambda: torch.linalg.vector_norm(avg - w, dim=1))
    b_ms = median_ms(torch, lambda: dd.step_cuda(w, avg, scale))
    b_plain = median_ms(torch, lambda: dd.step_rows_plain(w, avg, scale))
    b_lib = median_ms(torch, lambda: w + scale[:, None] * (avg - w))
    elt = w.element_size()
    res = {}
    for kind, nbytes, flops, ms, plain_ms, lib_ms, err in [
            ("sumsq", r * d * (elt + 4) + 4 * r * 3, 3 * r * d, a_ms, a_plain,
             a_lib, norm_err),
            ("step", r * d * (2 * elt + 4) + 4 * r, 3 * r * d, b_ms, b_plain,
             b_lib, step_err)]:
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS
        res[kind] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                         bound_ms=1e3 * max(t_bytes, t_ops),
                         bound_by="bytes" if t_bytes >= t_ops
                         else "operations", max_abs_err=err, shape=[r, d],
                         dtype=str(w.dtype))
        print(f"decdiff_update {kind} {label} [R={r}, D={d}, {w.dtype}]: "
              f"max_abs_err={err:g} kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, library {lib_ms:.4f} ms, bound "
              f"{res[kind]['bound_ms']:.4f} ms ({res[kind]['bound_by']}, "
              f"{nbytes / 1e9:.3f} GB), kernel at "
              f"{100 * res[kind]['bound_ms'] / ms:.1f}% of bound")
    print(f"  Σ(a-x)² per row kernel {sq.tolist()}, plain {sq_p.tolist()}; "
          f"scale {scale.tolist()}; pass B torch.equal(kernel, plain)="
          f"{equal}")
    check(norm_ok, f"decdiff_update {label}: norms differ by {norm_err:g}")
    check(equal, f"decdiff_update {label}: pass B != plain step "
                 f"(max_abs_err {step_err:g})")
    check(gated_ok, f"decdiff_update {label}: a gated row moved")
    return res


def decode_bound_ms(q, k, n_live, out_elems):
    """Least time for one decode attention over the `n_live` slots that
    this run's mask keeps: q, slot_pos, pos and the live slots' k and v
    read once (a masked slot need not be read), the fp32 output written
    once, over HBM bandwidth; or its 4·B·H·n_live·hd fp32 flops over the
    fp32 peak."""
    b, w, kk, hd = k.shape
    h = q.shape[1]
    nbytes = (q.numel() * q.element_size()
              + 2 * b * n_live * kk * hd * k.element_size()
              + 4 * w + 4 + 4 * out_elems)
    flops = 4 * b * h * n_live * hd
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations", nbytes)


def decode_vs_plain(torch, ops, q, k, v, sp, pos, label, window=0):
    """Hold `decode_attention_fused` against its plain version and time
    kernel, plain version and `F.scaled_dot_product_attention` (q in the
    cache's dtype, enable_gqa, a boolean mask of the live slots).
    Tolerance: |kernel − plain| ≤ 2e-5·|plain| + 2e-5·max|v| — the output
    is a convex combination of v's rows, and the two sum the softmax and
    the combine in another order."""
    import torch.nn.functional as F

    from repro_torch.kernels import decode_attention as da

    b, h, hd = q.shape
    w, kk = k.shape[1], k.shape[2]
    out = ops.decode_attention_fused(q, k, v, sp, pos, window=window)
    torch.cuda.synchronize()
    ref = da.decode_attention_plain(q, k, v, sp, pos, window)
    vmax = float(v.abs().max())
    diff = (out - ref).abs()
    err = float(diff.max())
    ok = bool((diff <= 2e-5 * ref.abs() + 2e-5 * max(vmax, 1.0)).all()) \
        and bool(torch.isfinite(out).all())
    live = (sp >= 0) & (sp <= pos)
    if window > 0:
        live = live & (sp > pos - window)
    qs = q.to(k.dtype)[:, :, None, :]
    ks, vs = k.transpose(1, 2), v.transpose(1, 2)
    mask = live[None, None, None, :]
    lib = F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask,
                                         enable_gqa=h != kk)
    lib_err = float((lib[:, :, 0].float() - ref).abs().max())
    del out, ref, diff, lib
    ms = median_ms(torch, lambda: da.decode_attention_cuda(q, k, v, sp, pos,
                                                           window))
    plain_ms = median_ms(torch, lambda: da.decode_attention_plain(
        q, k, v, sp, pos, window))
    lib_ms = median_ms(torch, lambda: F.scaled_dot_product_attention(
        qs, ks, vs, attn_mask=mask, enable_gqa=h != kk))
    n_live = int(live.sum())
    bound_ms, bound_by, nbytes = decode_bound_ms(q, k, n_live, b * h * hd)
    s, sps = da.splits(q.device, b, kk, w)
    print(f"decode_attention {label} [B={b}, H={h}, W={w}, K={kk}, hd={hd}, "
          f"q {q.dtype}, k/v {k.dtype}, {n_live} live slots, "
          f"{s} splits of {sps}]: max_abs_err={err:g} (max|v| {vmax:g}) "
          f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} "
          f"ms (|sdpa - plain| {lib_err:.3g}), bound {bound_ms:.4f} ms "
          f"({bound_by}, {nbytes / 1e9:.3f} GB), kernel at "
          f"{100 * bound_ms / ms:.1f}% of bound")
    check(ok, f"decode_attention {label}: kernel and plain differ by {err:g}")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=bound_ms, bound_by=bound_by, max_abs_err=err,
                shape=[b, h, w, kk, hd], dtype=str(k.dtype))


def path_e(torch, ops, dev, profile):
    """Dense serving at full qwen1.5-0.5b width (see the module docstring).
    Returns the launches, the step times, the peak memory and the kernel
    check's real inputs (layer 0's cache and a real query)."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.dist.dfl_step import build_serve_step
    from repro_torch.launch.serve import generate
    from repro_torch.models.lm import build_lm
    from repro_torch.models.lm.layers import _project_qkv, apply_norm, embed
    from repro_torch.utils.pytree import tree_leaves, tree_map

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    lm = build_lm(get_config(LM_ARCH))
    cfg = lm.cfg
    params = lm.init(torch.Generator(device=dev).manual_seed(0))
    n = sum(t.numel() for t in tree_leaves(params))
    check(n == LM_PARAMS and cfg.n_layers == LM_LAYERS,
          f"{LM_ARCH} has {n} params, {cfg.n_layers} layers")
    check(all(t.dtype == torch.bfloat16 and t.device == dev
              for t in tree_leaves(params)), "serving params not bf16 on card")
    cache = lm.init_cache(SERVE_BATCH, SERVE_WINDOW)
    kv_bytes = 2 * cache["k"].numel() * cache["k"].element_size()
    check(tuple(cache["k"].shape) == (LM_LAYERS, SERVE_BATCH, SERVE_WINDOW,
                                      cfg.n_kv_heads, cfg.head_dim)
          and cache["k"].dtype == torch.bfloat16 and cache["k"].device == dev,
          f"cache {tuple(cache['k'].shape)} {cache['k'].dtype}")
    # a near-full 32k context, as decode_32k means: positions 0..F-1 hold
    # N(0, 1) k and v (a stand-in for a prefill's, as the weights are
    # random too), so the prompt and the decode steps fill the last slots
    fill = SERVE_WINDOW - SERVE_PROMPT - SERVE_STEPS
    g = torch.Generator(device=dev).manual_seed(1)
    for name in ("k", "v"):
        for layer in range(cfg.n_layers):
            cache[name][layer, :, :fill].normal_(generator=g)
    cache["slot_pos"][:, :fill] = torch.arange(fill, dtype=torch.int32,
                                               device=dev)
    cache["length"].fill_(fill)
    prompts = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (SERVE_BATCH, SERVE_PROMPT))).to(dev)
    step = build_serve_step(lm)
    torch.cuda.synchronize()
    print(f"path e set-up in {time.perf_counter() - t0:.1f} s: {LM_ARCH} "
          f"full width ({n} bf16 params, {cfg.n_layers} layers, "
          f"{cfg.n_heads} heads, {cfg.n_kv_heads} KV heads, hd "
          f"{cfg.head_dim}), cache batch {SERVE_BATCH} x {SERVE_WINDOW} slots "
          f"= {kv_bytes} B of bf16 k and v, positions 0..{fill - 1} "
          f"filled")
    ops.reset_launches()
    t0 = time.perf_counter()
    tokens, logits, cache, secs = generate(step, params, cache, prompts,
                                           SERVE_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    ms = [1e3 * x for x in secs]
    tok_s = SERVE_BATCH * SERVE_STEPS / sum(secs)
    n_steps = SERVE_PROMPT + SERVE_STEPS
    print(f"path e (dense serving, decode_32k at batch {SERVE_BATCH}, "
          f"context {fill}..{SERVE_WINDOW - 1}): "
          f"{SERVE_PROMPT} prompt + {SERVE_STEPS} decode steps in "
          f"{wall:.3f} s; ms per decode step median "
          f"{statistics.median(ms):.3f} (min {min(ms):.3f}, max "
          f"{max(ms):.3f}; all {', '.join(f'{x:.3f}' for x in ms)}); "
          f"{tok_s:.1f} tokens per second; peak device memory "
          f"{peak / 2**30:.2f} GiB ({peak} B); kernel launches {launches}")
    print(f"path e first sequence's tokens: {tokens[0].tolist()}")
    check(launches["decode_attention_fused"] == LM_LAYERS * n_steps,
          f"decode_attention_fused launched "
          f"{launches['decode_attention_fused']} times, not "
          f"{LM_LAYERS} x {n_steps}")
    check(tuple(logits.shape) == (SERVE_BATCH, 1, cfg.vocab)
          and bool(torch.isfinite(logits.float()).all()),
          f"path e logits {tuple(logits.shape)} not finite")
    check(tuple(tokens.shape) == (SERVE_BATCH, SERVE_STEPS + 1) and bool(
        ((tokens >= 0) & (tokens < cfg.vocab)).all()), "path e tokens")
    check(int(cache["length"]) == SERVE_WINDOW,
          f"length {int(cache['length'])}")
    want_sp = torch.arange(SERVE_WINDOW, dtype=torch.int32, device=dev)
    check(bool((cache["slot_pos"] == want_sp).all()), "path e slot_pos")
    if profile:
        box = [cache, tokens[:, -1:]]

        def one_step():
            out, box[0] = step(params, box[0], box[1])
            box[1] = torch.argmax(out[:, -1:], dim=-1)

        by_name, _ = profile_round(torch, one_step, "path e decode step")
        print_families(by_name, "path e")
    # a real query for layer 0 at the last written position
    pos = cache["length"] - 1
    lp = tree_map(lambda t: t[0], params["layers"])
    with torch.inference_mode():
        x = apply_norm(cfg, embed(cfg, params["embed"], tokens[:, -2:-1]),
                       lp["ln1"])
        q, _, _ = _project_qkv(cfg, lp["attn"], x, pos.reshape(1))
    return dict(launches=launches, ms=ms, tok_s=tok_s, peak=peak,
                q=q[:, 0].clone(), k=cache["k"][0], v=cache["v"][0],
                sp=cache["slot_pos"][0], pos=pos.clone(),
                tokens=tokens[0].tolist())


def small_serve_agrees(torch, dev):
    """8 tokens of qwen1.5-0.5b and qwen3-32b (G = 8, hd 128) reduced, fp32,
    decoded on the card and on the CPU (the plain versions, which the CPU
    tests hold against the JAX reference): logits within 1e-4, equal
    greedy tokens; and the card's decode logits within 1e-4 of its own
    teacher-forced forward."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.dist.dfl_step import build_serve_step
    from repro_torch.models.lm import build_lm
    from repro_torch.utils.pytree import tree_map

    for arch, over in [("qwen1.5-0.5b", dict(n_kv_heads=4)),
                       ("qwen3-32b", dict(n_heads=16, n_kv_heads=2,
                                          head_dim=128))]:
        lm = build_lm(get_config(arch).reduced(**over))
        p0 = lm.init(torch.Generator().manual_seed(0), device="cpu")
        tokens = torch.from_numpy(
            np.random.default_rng(0).integers(0, lm.cfg.vocab, (3, 8)))
        step = build_serve_step(lm)
        runs = []
        for where in (dev, torch.device("cpu")):
            params = tree_map(lambda t: t.to(where), p0)
            cache = lm.init_cache(3, 8, device=where)
            got = []
            for t in range(8):
                out, cache = step(params, cache, tokens[:, t:t + 1].to(where))
                got.append(out[:, 0])
            runs.append((torch.stack(got, 1), params))
        (lc, pc), (lh, _) = runs
        with torch.no_grad():
            full, _ = lm.forward(pc, {"tokens": tokens.to(dev)})
        err = float((lc.cpu() - lh).abs().max())
        ferr = float((lc - full).abs().max())
        same = bool(torch.equal(lc.argmax(-1).cpu(), lh.argmax(-1)))
        print(f"small decode ({arch} reduced: {lm.cfg.n_layers} layers, "
              f"{lm.cfg.n_heads} heads / {lm.cfg.n_kv_heads} KV heads, hd "
              f"{lm.cfg.head_dim}, fp32; 3 x 8 tokens) card vs cpu max "
              f"|logit diff| {err:.3g}, greedy tokens equal {same}; card "
              f"decode vs card teacher-forced forward {ferr:.3g}")
        check(err <= 1e-4 and same, f"small decode {arch}: card and cpu "
                                    f"differ by {err}")
        check(ferr <= 1e-4, f"small decode {arch}: decode and forward differ "
                            f"by {ferr}")


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
    check(sorted(libs) == ["decdiff_update", "decode_attention",
                           "dequant_avg_rows", "gather_rows", "segment_avg",
                           "vt_kl_loss"], f"kernel sources {sorted(libs)}")
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
    vt_per_path = ROUNDS * exp.train.steps_per_round  # one per local step
    check(l_plain["vt_kl_loss_fwd"] == l_plain["vt_kl_loss_bwd"]
          == vt_per_path, f"path a: vt_kl_loss launches {l_plain}")
    check(l_plain["decdiff_update"] == ROUNDS,
          f"path a: decdiff_update launches {l_plain}")

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
    check(l_edge["vt_kl_loss_fwd"] == l_edge["vt_kl_loss_bwd"]
          == vt_per_path, f"path b: vt_kl_loss launches {l_edge}")
    check(l_edge["decdiff_update"] == ROUNDS,
          f"path b: decdiff_update launches {l_edge}")
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
          l_node["gather_rows"] == 0 and
          l_node["vt_kl_loss_fwd"] == l_node["vt_kl_loss_bwd"]
          == vt_per_path and l_node["decdiff_update"] == ROUNDS,
          f"per-node launches {l_node}")
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
    profile = "--profile" in sys.argv[1:]
    if profile:
        profile_round(torch, lambda: exp.run(rounds=1, eval_every=1),
                      "no-transport (eval included)")
        profile_round(torch, lambda: exp_e.run(rounds=1, eval_every=1),
                      "per-edge transport (eval included)")
    exp_beta = exp.train.beta
    del exp, exp_e, exp_n, world, table0

    # -- path d: the LM DFL pod round at full width ------------------------
    lmd = path_d(torch, ops, dev, profile)
    small_lm_agrees(torch, dev)
    dq = dequant_vs_plain(torch, ops, lmd["q"], lmd["scale"], lmd["wn"],
                          "path d (real int8 payload of the 4 nodes)")
    avg = ops.dequant_neighbor_avg_rows(lmd.pop("q"), lmd["scale"], lmd["wn"])
    eq5 = eq5_vs_plain(torch, lmd.pop("w"), avg, lmd["row"],
                       "path d (real flat block and its average)")
    del avg
    torch.cuda.empty_cache()
    gen = torch.Generator(device=dev).manual_seed(1)
    q8 = torch.randint(-127, 128, (8, 1_000_003), generator=gen, device=dev,
                       dtype=torch.int8)
    wn8 = torch.rand((8, 8), generator=gen, device=dev)
    wn8.fill_diagonal_(0.0)
    wn8[3] = 0.0
    wn8 = (wn8 / torch.clamp(wn8.sum(1, keepdim=True), min=1e-30)
           ).contiguous()
    dequant_vs_plain(torch, ops, q8, torch.rand(8, generator=gen,
                                                device=dev) * 0.05, wn8,
                     "odd D, 8 receivers, one zero row")
    vt_main = vt_vs_plain(torch, ops, lmd["logits"], lmd["labels"],
                          "path d (node 0's real logits)")
    vt_vs_plain(torch, ops, lmd["logits"].float(), lmd["labels"],
                "path d logits in fp32")
    for b in (16 * 32, 32):  # the MLP's [N·B, 10] and one node's batch
        z = torch.randn((b, 10), generator=gen, device=dev) * 3
        y = torch.randint(0, 10, (b,), generator=gen, device=dev)
        y[0], y[-1] = 0, 9
        vt_vs_plain(torch, ops, z, y, f"MLP classes [{b}, 10]",
                    beta=exp_beta)

    # -- path e: dense serving at full width, after path d's state is gone
    torch.cuda.empty_cache()
    lme = path_e(torch, ops, dev, profile)
    small_serve_agrees(torch, dev)
    da_main = decode_vs_plain(torch, ops, lme.pop("q"), lme.pop("k"),
                              lme.pop("v"), lme.pop("sp"), lme.pop("pos"),
                              "path e (real layer-0 cache, real query)")
    torch.cuda.empty_cache()
    gen = torch.Generator(device=dev).manual_seed(2)
    for label, (b, h, w, kk, hd), filled, window in [
            ("full synthetic window", (8, 16, SERVE_WINDOW, 16, 64),
             SERVE_WINDOW, 0),
            ("qwen2.5-14b GQA", (8, 40, SERVE_WINDOW, 8, 128), SERVE_WINDOW,
             0),
            ("odd B and W, sliding window 700", (3, 16, 1000, 16, 64), 997,
             700)]:
        q = torch.randn((b, h, hd), generator=gen, device=dev)
        k = torch.randn((b, w, kk, hd), generator=gen, device=dev).to(
            torch.bfloat16)
        v = torch.randn((b, w, kk, hd), generator=gen, device=dev).to(
            torch.bfloat16)
        sp = torch.arange(w, dtype=torch.int32, device=dev)
        sp[filled:] = -1
        pos = torch.tensor(filled - 1, dtype=torch.int32, device=dev)
        decode_vs_plain(torch, ops, q, k, v, sp, pos, label, window)
        del q, k, v
    torch.cuda.empty_cache()

    by_path = {"a": l_plain, "b": l_edge, "c": l_node, "d": lmd["launches"],
               "e": lme["launches"]}

    def launches(name):
        return sum(p[name] for p in by_path.values())

    def entry(name, route_name, replaces, m, counter=None, **extra):
        counter = counter or name
        return dict(name=name, route="cuda",
                    source=f"src/repro_torch/csrc/{route_name}.cu",
                    replaces=replaces, launches=launches(counter),
                    launches_by_path={k: p[counter]
                                      for k, p in by_path.items()},
                    max_abs_err=m["max_abs_err"], ms=m["ms"],
                    plain_ms=m["plain_ms"], bound_ms=m["bound_ms"],
                    bound_by=m["bound_by"], library_ms=m["library_ms"],
                    shape=m["shape"], **extra)

    kernels = [
        entry("segment_neighbor_avg", "segment_avg",
              "src/repro/kernels/segment_avg.py:62", seg),
        entry("gather_rows", "gather_rows",
              "src/repro/kernels/gather_rows.py:39", gat,
              every_slot_bound_ms=gat["every_slot_bound_ms"]),
        entry("dequant_neighbor_avg_rows", "dequant_avg_rows",
              "src/repro/kernels/dequant_avg.py:79", dq),
        entry("vt_kl_loss_fwd", "vt_kl_loss",
              "src/repro/kernels/vt_kl_loss.py:94", vt_main["fwd"],
              also_replaces="src/repro/kernels/vt_kl_loss.py:108",
              dtype=vt_main["fwd"]["dtype"]),
        entry("vt_kl_loss_bwd", "vt_kl_loss",
              "src/repro/kernels/vt_kl_loss.py:127", vt_main["bwd"],
              dtype=vt_main["bwd"]["dtype"]),
        entry("decdiff_update_sumsq", "decdiff_update",
              "src/repro/kernels/decdiff_update.py:42", eq5["sumsq"],
              counter="decdiff_update", dtype=eq5["sumsq"]["dtype"]),
        entry("decdiff_update_step", "decdiff_update",
              "src/repro/kernels/decdiff_update.py:60", eq5["step"],
              counter="decdiff_update", dtype=eq5["step"]["dtype"]),
        entry("decode_attention_fused", "decode_attention",
              "src/repro/kernels/decode_attention.py:92", da_main,
              dtype=da_main["dtype"]),
    ]
    print(f"path d: ms per round {lmd['ms']}, peak device memory "
          f"{lmd['peak']} B, losses {lmd['losses']}")
    print(f"path e: ms per decode step median "
          f"{statistics.median(lme['ms']):.3f} (min {min(lme['ms']):.3f}, "
          f"max {max(lme['ms']):.3f}), {lme['tok_s']:.1f} tokens per second, "
          f"peak device memory {lme['peak']} B, decode_attention_fused "
          f"launches {lme['launches']['decode_attention_fused']}")
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
