"""Paper-style experiment driver: every method on one world instance.

Reduced rendition of the paper's §V setup (ER graph, truncated-Zipf non-IID
split, SGD+momentum, per-node random init), producing a Table II-like summary
and a Table IV-like characteristic-time summary.  Each method runs through
`repro_torch.engine.Experiment` (via `run_method`) with the fused schedule
(every round and eval kept on the device, read back once at the end).
The PyTorch port's counterpart of `examples/decentralized_mnist.py`, with
its own copy of the benchmark helpers it calls (the world, the method
runner, the Centralized baseline, the two tables).  It writes no file:
the results are printed and returned.  It runs on the CUDA card unless
`--device cpu` is given.

    python examples_torch/decentralized_mnist.py [--rounds 60]
"""
import argparse
import dataclasses
import os
import sys
import time
from typing import Dict

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.data import make_dataset, zipf_allocation  # noqa: E402
from repro_torch.data.allocation import (  # noqa: E402
    allocation_gini,
    split_by_allocation,
)
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.engine import Experiment, Schedule, World  # noqa: E402
from repro_torch.fl.metrics import comm_bytes_per_round  # noqa: E402
from repro_torch.fl.trainer import centralized_train  # noqa: E402
from repro_torch.graphs import make_topology  # noqa: E402
from repro_torch.models.mlp_cnn import model_for_dataset  # noqa: E402
from repro_torch.optim import make_optimizer  # noqa: E402
from repro_torch.utils.pytree import tree_bytes  # noqa: E402

# Table II's roster, in the paper's layout order
METHODS = ["isol", "fedavg", "dechetero", "cfa", "cfa-ge", "decdiff",
           "decdiff+vt"]
# Table IV: fractions of the Centralized accuracy
THRESHOLDS = (0.5, 0.8, 0.9, 0.95)


@dataclasses.dataclass
class WorldConfig:
    dataset: str = "synth-mnist"
    num_nodes: int = 30
    er_p: float = 0.2
    data_scale: float = 0.08
    seed: int = 0
    lr: float = 0.1
    momentum: float = 0.9
    batch_size: int = 32
    steps_per_round: int = 4
    beta: float = 0.95
    rounds: int = 60
    eval_every: int = 5
    topology: str = "erdos_renyi"


def build_world(wc: WorldConfig):
    """(dataset, topology, xs, ys, model, Gini) of one seeded world."""
    ds = make_dataset(wc.dataset, seed=wc.seed, scale=wc.data_scale)
    if wc.topology == "erdos_renyi":
        topo = make_topology("erdos_renyi", n=wc.num_nodes, p=wc.er_p,
                             seed=wc.seed)
    else:
        topo = make_topology(wc.topology, n=wc.num_nodes, seed=wc.seed)
    alloc = zipf_allocation(ds.y_train, wc.num_nodes, seed=wc.seed,
                            min_per_class=1)
    xs, ys = split_by_allocation(ds.x_train, ds.y_train, alloc)
    gini = allocation_gini(alloc, ds.y_train)
    model = model_for_dataset(wc.dataset, ds.num_classes)
    return ds, topo, xs, ys, model, gini


def run_method(wc: WorldConfig, method: str, world=None, verbose=False,
               comm=None, mode="fused", device=None, params=None) -> Dict:
    """One method's run as a result dict (Table II's row and the history
    Table IV reads); `params`, when given, is the node-stacked init to
    start from instead of the seed's."""
    ds, topo, xs, ys, model, gini = world or build_world(wc)
    exp = Experiment(
        World(model=model, topo=topo, xs=xs, ys=ys,
              x_test=ds.x_test, y_test=ds.y_test, device=device),
        method, comm=comm,
        schedule=Schedule(rounds=wc.rounds, eval_every=wc.eval_every,
                          mode=mode),
        steps_per_round=wc.steps_per_round, batch_size=wc.batch_size,
        lr=wc.lr, momentum=wc.momentum, beta=wc.beta, seed=wc.seed,
        device=device)
    if params is not None:
        exp.params = params
        exp.opt_state = exp.optimizer.init(exp.params)
        if exp.transport is not None:
            exp.comm_state = exp.transport.init_state(exp.params)
    t0 = time.time()
    hist = exp.run(verbose=verbose)
    wall = time.time() - t0
    model_bytes = tree_bytes(model.init(torch.Generator().manual_seed(0)))
    return {
        "method": method,
        "dataset": wc.dataset,
        "gini": gini,
        "rounds": wc.rounds,
        "wall_s": wall,
        "acc_mean": hist[-1].acc_mean,
        "acc_std": hist[-1].acc_std,
        "loss_mean": hist[-1].loss_mean,
        "acc_per_node": hist[-1].acc_per_node.tolist(),
        "history": [
            {"round": m.round, "acc_mean": m.acc_mean, "acc_std": m.acc_std,
             "loss_mean": m.loss_mean}
            for m in hist
        ],
        "comm_bytes_per_round": comm_bytes_per_round(method, topo,
                                                     model_bytes),
    }


def run_centralized(wc: WorldConfig, world=None, device=None) -> Dict:
    """The Centralized baseline: every node's data on one server."""
    ds, topo, xs, ys, model, gini = world or build_world(wc)
    opt = make_optimizer(lr=wc.lr / 2, momentum=wc.momentum)
    epochs = max(2, wc.rounds * wc.steps_per_round * wc.batch_size
                 // max(len(ds.x_train), 1))
    t0 = time.time()
    _, hist = centralized_train(model, opt, ds.x_train, ds.y_train,
                                ds.x_test, ds.y_test, epochs=min(epochs, 20),
                                batch_size=64, seed=wc.seed,
                                eval_every=max(1, min(epochs, 20) // 4),
                                device=device)
    return {
        "method": "centralized", "dataset": wc.dataset, "gini": gini,
        "acc_mean": hist[-1]["acc"], "acc_std": 0.0,
        "loss_mean": hist[-1]["loss"], "wall_s": time.time() - t0,
        "history": hist, "comm_bytes_per_round": 0,
    }


def run(datasets=("synth-mnist",), rounds=60, num_nodes=30, data_scale=0.08,
        verbose=True, device=None):
    """Centralized, then every method of METHODS, on one world per
    dataset: {dataset: {"_world": ..., method: result dict}}."""
    all_results = {}
    for dataset in datasets:
        wc = WorldConfig(dataset=dataset, rounds=rounds, num_nodes=num_nodes,
                         data_scale=data_scale)
        world = build_world(wc)
        results = {"_world": {"gini": world[5], "nodes": num_nodes,
                              "rounds": rounds, "dataset": dataset,
                              "data_scale": data_scale}}
        results["centralized"] = run_centralized(wc, world=world,
                                                 device=device)
        if verbose:
            print(f"[{dataset}] centralized "
                  f"acc={results['centralized']['acc_mean']:.4f}")
        for method in METHODS:
            results[method] = run_method(wc, method, world=world,
                                         device=device)
            if verbose:
                r = results[method]
                print(f"[{dataset}] {method:12s} acc={r['acc_mean']:.4f} "
                      f"±{r['acc_std']:.4f}  ({r['wall_s']:.0f}s)")
        all_results[dataset] = results
    return all_results


def format_table(all_results) -> str:
    """Table II as markdown."""
    lines = ["| dataset | method | avg acc | ±std | node-wise IQR |",
             "|---|---|---|---|---|"]
    for dataset, results in all_results.items():
        for method, r in results.items():
            if method.startswith("_"):
                continue
            iqr = ""
            if "acc_per_node" in r:
                q = np.percentile(r["acc_per_node"], [25, 75])
                iqr = f"{q[1] - q[0]:.3f}"
            lines.append(f"| {dataset} | {method} | {r['acc_mean']:.4f} | "
                         f"{r.get('acc_std', 0):.4f} | {iqr} |")
    return "\n".join(lines)


def characteristic_times(all_results):
    """Table IV: per method, the first eval round whose node-average
    accuracy reaches each fraction of the Centralized accuracy (None:
    never)."""
    out = {}
    for dataset, results in all_results.items():
        cacc = results["centralized"]["acc_mean"]
        table = {}
        for method, r in results.items():
            if method.startswith("_") or method == "centralized":
                continue
            row = {}
            for thr in THRESHOLDS:
                target = thr * cacc
                hit = None
                for h in r["history"]:
                    if h["acc_mean"] >= target:
                        hit = h["round"]
                        break
                row[thr] = hit
            table[method] = row
        out[dataset] = {"centralized_acc": cacc, "times": table}
    return out


def format_char_times(ct) -> str:
    """Table IV as markdown."""
    lines = ["| dataset | method | 50% | 80% | 90% | 95% |",
             "|---|---|---|---|---|---|"]
    for dataset, block in ct.items():
        for method, row in block["times"].items():
            cells = " | ".join("-" if row[t] is None else str(row[t])
                               for t in THRESHOLDS)
            lines.append(f"| {dataset} | {method} | {cells} |")
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=60)
    ap.add_argument("--nodes", type=int, default=20)
    ap.add_argument("--dataset", default="synth-mnist")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    res = run(datasets=(args.dataset,), rounds=args.rounds,
              num_nodes=args.nodes, data_scale=0.05, device=device)
    ct = characteristic_times(res)
    print("\n=== Table II (accuracy) ===")
    print(format_table(res))
    print("\n=== Table IV (characteristic time) ===")
    print(format_char_times(ct))
    return res, ct


if __name__ == "__main__":
    main()
