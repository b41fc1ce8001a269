"""Multi-pod DFL training — the same Experiment spec on the pod mesh.

The `Experiment` that runs every node in one process lowers unchanged to
the shard_map backend: each pod (the mesh's "pod" dimension, one
`torch.distributed` rank) owns a block of nodes' params, optimizer state
and data shards, and the DecDiff gossip exchange is an all-gather over
the pods.  The two backends are bitwise equal, so this script is about
EXECUTION, not math: run it as one process (one pod) or under `torchrun`
to watch the same seeded world split over real ranks.  The PyTorch
port's counterpart of `examples/multipod_dfl_train.py`; it runs on the
CUDA card unless `--device cpu` is given.

    python examples_torch/multipod_dfl_train.py --nodes 8
    torchrun --nproc-per-node 2 examples_torch/multipod_dfl_train.py \
        --nodes 8 --device cpu        # two pods over gloo
    torchrun --nproc-per-node 2 examples_torch/multipod_dfl_train.py \
        --nodes 8                     # two pods over NCCL, one card each

Under `torchrun` the script starts the process group itself (gloo on the
CPU, NCCL on CUDA, rank r on cuda:LOCAL_RANK) and ends it; when the caller
has already started one, it runs on that group and leaves it open.  Only
rank 0 prints.  For the LM architectures the same round shape runs
through `repro_torch.dist.dfl_step.build_dfl_round_shardmap`, where the
all-gather carries the encoded int8 payload and the dequantize + average
is the `dequant_neighbor_avg_rows` kernel; that path is not this
example's.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from repro_torch.engine import Experiment, Schedule, World  # noqa: E402
from repro_torch.utils.pytree import tree_index, tree_l2_dist  # noqa: E402


def start_group(device):
    """Start the default process group from torchrun's environment when
    there is one and no group yet; returns whether this call started it."""
    if "WORLD_SIZE" not in os.environ or dist.is_initialized():
        return False
    cuda = device is None or torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    dist.init_process_group("nccl" if cuda else "gloo")
    return True


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--nodes", type=int, default=8)
    ap.add_argument("--rounds", type=int, default=20)
    ap.add_argument("--eval-every", type=int, default=5)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    started = start_group(args.device)
    try:
        world = World.synthetic(dataset="synth-mnist", nodes=args.nodes,
                                topology="ring", seed=0, scale=0.03,
                                device=args.device)
        exp = Experiment(world, "decdiff+vt", backend="shard_map",
                         schedule=Schedule(rounds=args.rounds,
                                           eval_every=args.eval_every,
                                           mode="fused"),
                         steps_per_round=4, batch_size=32, lr=0.1,
                         momentum=0.9, device=world.device)
        ranks = dist.get_world_size() if dist.is_initialized() else 1
        if exp.is_writer:
            print(f"{ranks} device(s) -> {exp.n_pods}-pod mesh, "
                  f"{args.nodes // exp.n_pods} nodes per pod (heterogeneous "
                  f"init, ring gossip)")

        # `params` gathers every pod's block: every rank reads it
        d0 = float(tree_l2_dist(tree_index(exp.params, 0),
                                tree_index(exp.params, 1)))
        hist = exp.run(verbose=True)
        params = exp.params
        d1 = float(tree_l2_dist(tree_index(params, 0),
                                tree_index(params, 1)))
        if exp.is_writer:
            print(f"\nnode0-node1 model distance: init {d0:.2f} -> final "
                  f"{d1:.2f} ({'converging' if d1 < d0 else 'diverging'}) "
                  f"— DecDiff pulls heterogeneously-initialized nodes "
                  f"together without a server, final acc "
                  f"{hist[-1].acc_mean:.3f} ± {hist[-1].acc_std:.3f}")
        return dict(history=hist, init_dist=d0, final_dist=d1,
                    n_pods=exp.n_pods, params=params)
    finally:
        if started:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
