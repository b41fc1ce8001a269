"""Event-triggered, compressed DecDiff gossip — the comm layer end to end.

Runs DecDiff+VT on a seeded 8-node Barabási–Albert world under different
gossip transports and prints the accuracy-vs-bytes tradeoff, e.g.:

    python examples_torch/compressed_gossip.py --rounds 15
    python examples_torch/compressed_gossip.py \
        --codec int8 --threshold 1.0 --verbose
    python examples_torch/compressed_gossip.py \
        --codec int8 --adaptive 0.9   # per-edge drift-rate control

With no --codec it sweeps the default frontier (fp32 dense reference, bf16,
int8 with fixed-threshold and adaptive per-edge triggering, top-k).  The
PyTorch port's counterpart of `examples/compressed_gossip.py`, with its
own copy of the smoke world and the trigger label of
`benchmarks/bench_comm.py` (it writes no file).  It runs on the CUDA card
unless `--device cpu` is given.  Int8's stochastic rounding draws from
the experiment's torch generator, so its points are not the JAX package's
bit for bit; `stochastic=False` makes every point deterministic.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.comm import CommConfig  # noqa: E402
from repro_torch.data import make_dataset, zipf_allocation  # noqa: E402
from repro_torch.data.allocation import split_by_allocation  # noqa: E402
from repro_torch.engine import Experiment, Schedule, World  # noqa: E402
from repro_torch.graphs import make_topology  # noqa: E402
from repro_torch.models.mlp_cnn import make_mlp  # noqa: E402


def smoke_world(seed=0, graph="ba"):
    """The seeded smoke config of the comm benchmark: an 8-node graph
    (graph="ba": Barabási–Albert scale-free m=2; graph="er": Erdős–Rényi
    p=0.4), Zipf non-IID synth-mnist, small MLP.  Returns (dataset,
    topology, xs, ys, model)."""
    ds = make_dataset("synth-mnist", seed=seed, scale=0.03)
    if graph == "ba":
        topo = make_topology("barabasi_albert", n=8, m=2, seed=1)
    elif graph == "er":
        topo = make_topology("erdos_renyi", n=8, p=0.4, seed=1)
    else:
        raise ValueError(f"unknown smoke graph {graph!r}")
    alloc = zipf_allocation(ds.y_train, 8, seed=1, min_per_class=1)
    xs, ys = split_by_allocation(ds.x_train, ds.y_train, alloc)
    model = make_mlp(num_classes=10, hidden=(64, 32))
    return ds, topo, xs, ys, model


def trigger_label(policy: str, threshold=0.0, target=None) -> str:
    """One rendering of a trigger config for every table row."""
    return (f"adaptive({target})" if policy == "adaptive"
            else f"thr={threshold}")


def default_sweep(target=0.9, topk_ratio=0.05, **common):
    """The six points of the default frontier; `common` goes to every
    CommConfig (e.g. stochastic=False)."""
    return [
        CommConfig(codec="fp32", **common),
        CommConfig(codec="bf16", **common),
        CommConfig(codec="int8", **common),
        CommConfig(codec="int8", trigger_threshold=1.0, **common),
        CommConfig(codec="int8", policy="adaptive", target_trigger=target,
                   **common),
        CommConfig(codec="topk", topk_ratio=topk_ratio, **common),
    ]


def run_one(world, comm, rounds, verbose=False, device=None, params=None):
    """DecDiff+VT under `comm` for `rounds` rounds; `params`, when given,
    is the node-stacked init to start from instead of the seed's."""
    ds, topo, xs, ys, model = world
    exp = Experiment(
        World(model=model, topo=topo, xs=xs, ys=ys,
              x_test=ds.x_test, y_test=ds.y_test, device=device),
        "decdiff+vt", comm=comm,
        schedule=Schedule(rounds=rounds, eval_every=5),
        steps_per_round=4, batch_size=32, lr=0.1, momentum=0.9, seed=0,
        device=device)
    if params is not None:
        exp.params = params
        exp.opt_state = exp.optimizer.init(exp.params)
        exp.comm_state = exp.transport.init_state(exp.params)
    hist = exp.run(verbose=verbose)
    return exp, hist


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=15)
    ap.add_argument("--codec", choices=["fp32", "bf16", "int8", "topk"])
    ap.add_argument("--threshold", type=float, default=0.0)
    ap.add_argument("--adaptive", type=float, metavar="TARGET",
                    help="per-edge adaptive thresholds converging each "
                         "link's trigger rate to TARGET (overrides "
                         "--threshold)")
    ap.add_argument("--topk-ratio", type=float, default=0.05)
    ap.add_argument("--verbose", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    world = smoke_world()
    if args.codec:
        kw = ({"policy": "adaptive", "target_trigger": args.adaptive}
              if args.adaptive is not None
              else {"trigger_threshold": args.threshold})
        sweep = [CommConfig(codec=args.codec, topk_ratio=args.topk_ratio,
                            **kw)]
    else:
        target = 0.9 if args.adaptive is None else args.adaptive
        sweep = default_sweep(target, args.topk_ratio)

    print(f"{'codec':>6} {'trigger':>14} | {'final acc':>9} | {'wire MB':>8} "
          f"| {'trig':>5} | reduction")
    rows = []
    dense_bytes = None
    for comm in sweep:
        sim, hist = run_one(world, comm, args.rounds, verbose=args.verbose,
                            device=args.device)
        if dense_bytes is None and comm.codec == "fp32" \
                and comm.policy == "fixed" and comm.trigger_threshold == 0.0:
            dense_bytes = sim.comm_bytes_total
        red = ("-" if dense_bytes is None
               else f"{dense_bytes / max(sim.comm_bytes_total, 1):.1f}x")
        trig = trigger_label(comm.policy, comm.trigger_threshold,
                             comm.target_trigger)
        print(f"{comm.codec:>6} {trig:>14} | "
              f"{hist[-1].acc_mean:>9.4f} | "
              f"{sim.comm_bytes_total / 1e6:>8.2f} | "
              f"{hist[-1].triggered_frac:>5.2f} | {red}")
        rows.append(dict(comm=comm, trigger=trig, history=hist,
                         bytes=sim.comm_bytes_total,
                         payload_bytes=sim.transport.payload_bytes,
                         directed_edges=2 * sim.topo.num_edges,
                         reduction=red))
    return rows


if __name__ == "__main__":
    main()
