"""Quickstart: coordination-free decentralized learning in ~40 lines.

16 devices on an Erdős–Rényi graph, non-IID synthetic MNIST, heterogeneous
model initialization — train with the paper's DecDiff+VT and compare the
final node-average accuracy against isolated training.  The schedule runs
fused: every round and eval stays on the device and the results are read
back in one copy at the end (one launch sequence per round, not one
compiled program; `Schedule(mode="loop")` reads each eval back as it
happens, bitwise the same).  The PyTorch port's counterpart of
`examples/quickstart.py`; it runs on the CUDA card unless `--device cpu`
is given.

    python examples_torch/quickstart.py [--rounds 30 --nodes 16]
    python examples_torch/quickstart.py --device cpu

(`World.synthetic(...)` collapses step 1 into one call; it is spelled out
here to show what a World is made of.)
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.data import make_dataset, zipf_allocation  # noqa: E402
from repro_torch.data.allocation import (  # noqa: E402
    allocation_gini,
    split_by_allocation,
)
from repro_torch.engine import Experiment, Schedule, World  # noqa: E402
from repro_torch.graphs import make_topology  # noqa: E402
from repro_torch.models.mlp_cnn import model_for_dataset  # noqa: E402

METHODS = ("isol", "decdiff+vt")


def build_world(nodes, device=None):
    """Step 1: data, non-IID allocation, communication graph, paper model.
    Returns (World, the printed graph line)."""
    ds = make_dataset("synth-mnist", seed=0, scale=0.05)
    topo = make_topology("erdos_renyi", n=nodes, p=0.25, seed=0)
    alloc = zipf_allocation(ds.y_train, topo.num_nodes, seed=0,
                            min_per_class=1)
    xs, ys = split_by_allocation(ds.x_train, ds.y_train, alloc)
    line = (f"graph: {topo.name}  (connected={topo.connected})  "
            f"label-skew Gini={allocation_gini(alloc, ds.y_train):.2f}")
    world = World(model=model_for_dataset("synth-mnist", ds.num_classes),
                  topo=topo, xs=xs, ys=ys,
                  x_test=ds.x_test, y_test=ds.y_test, device=device)
    return world, line


def experiment(world, method, rounds, eval_every):
    """Step 2's spec for one method (each node draws its OWN init)."""
    return Experiment(world, method,
                      schedule=Schedule(rounds=rounds, eval_every=eval_every,
                                        mode="fused"),
                      steps_per_round=4, batch_size=32, lr=0.1,
                      momentum=0.9, beta=0.95, device=world.device)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=30)
    ap.add_argument("--nodes", type=int, default=16)
    ap.add_argument("--eval-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    # 1. world: data, non-IID allocation, communication graph, paper model
    world, line = build_world(args.nodes, args.device)
    print(line)

    # 2. run DecDiff+VT (Alg. 1) vs isolation
    histories = {}
    for method in METHODS:
        exp = experiment(world, method, args.rounds, args.eval_every)
        hist = exp.run(verbose=True)
        print(f"--> {method}: final node-average accuracy "
              f"{hist[-1].acc_mean:.3f} ± {hist[-1].acc_std:.3f}\n")
        histories[method] = hist
    return histories


if __name__ == "__main__":
    main()
