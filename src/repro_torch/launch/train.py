"""End-to-end LM training from the command line.

Two modes, as the JAX package's `repro.launch.train`:
  * ``--mode dfl`` (default): P-node decentralized federated training of an
    assigned architecture with DecDiff gossip between nodes on a ring each
    round (`build_dfl_round`) — the paper's Algorithm 1 at LM scale;
  * ``--mode single``: plain single-replica training (the "centralized"
    reference at the systems level).

Runs on the CUDA card unless `--device cpu` is given.  Synthetic token
streams (`repro_torch.data.tokens`) stand in for the data pipeline, as in
the reference, so the families whose batch is tokens alone train here:
dense, MoE (its router auxiliary in the loss), SSM and hybrid.  The VLM's
image embeddings and the enc-dec's encoder frames are not in the
reference's trainer either; those two families raise.  With `--ckpt-dir D`
the final params and optimizer state are saved as the reference saves
them, to `D/step_<steps>` (`repro_torch.checkpoint`, the reference's
format); `run(argv)` returns them beside the losses.

Example (CPU, reduced preset):
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \\
      --preset reduced --steps 20 --nodes 2 --device cpu --log-every 5
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.checkpoint import save_checkpoint
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.data.tokens import synthetic_token_batch
from repro_torch.device import resolve_device
from repro_torch.dist.dfl_step import build_dfl_round, build_train_step
from repro_torch.models.lm import build_lm
from repro_torch.optim.sgd import sgd_momentum
from repro_torch.utils.pytree import tree_leaves, tree_map


def make_batches(lm, nodes, batch, seq, steps, device, seed=0):
    """The reference's deterministic synthetic token stream per node (the
    same numpy draws), as int64 tensors on `device`."""
    for step in range(steps):
        bs = [synthetic_token_batch(batch, seq, lm.cfg.vocab,
                                    seed=seed + step * 131 + node)
              for node in range(max(nodes, 1))]
        stack = (lambda k: bs[0][k]) if nodes == 0 else (
            lambda k: np.stack([b[k] for b in bs]))
        yield {k: torch.from_numpy(stack(k).astype(np.int64)).to(device)
               for k in bs[0]}


def init_nodes(lm, nodes: int, device, seed: int = 0):
    """Heterogeneous init: node i draws its params from a generator on
    `device` seeded with seed + i; leaves stacked [nodes, ...]."""
    per_node = []
    for i in range(nodes):
        gen = torch.Generator(device=device).manual_seed(seed + i)
        per_node.append(lm.init(gen, device=device))
    return tree_map(lambda *xs: torch.stack(xs), *per_node)


def ring_adjacency(nodes: int) -> np.ndarray:
    """Row-normalized ring: each node hears its two neighbours."""
    adj = np.zeros((nodes, nodes), np.float32)
    for i in range(nodes):
        adj[i, (i + 1) % nodes] = adj[i, (i - 1) % nodes] = 1.0
    adj /= np.maximum(adj.sum(1, keepdims=True), 1)
    return adj


def run(argv=None):
    """The command line's run: (losses, final params, final opt_state)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="qwen1.5-0.5b")
    ap.add_argument("--preset", choices=["reduced", "full"], default="reduced")
    ap.add_argument("--mode", choices=["dfl", "single"], default="dfl")
    ap.add_argument("--nodes", type=int, default=2, help="DFL nodes (pods)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--beta", type=float, default=0.98, help="VT confidence")
    ap.add_argument("--loss", choices=["vt", "ce"], default="vt")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.preset == "reduced":
        cfg = cfg.reduced(n_layers=4, d_model=256, vocab=2048)
    lm = build_lm(cfg)
    extra = set(lm.input_specs(1, args.seq)) - {"tokens", "labels"}
    if extra:
        raise ValueError(f"--arch {args.arch}: the {cfg.family!r} family's "
                         f"batch also needs {sorted(extra)}, which the "
                         f"synthetic token stream does not give")
    opt = sgd_momentum(lr=args.lr, momentum=0.9)

    if args.mode == "single":
        params = init_nodes(lm, 1, dev)
        params = tree_map(lambda t: t[0], params)
        step_fn = build_train_step(lm, opt, loss_kind=args.loss,
                                   beta=args.beta)
        stream = make_batches(lm, 0, args.batch, args.seq, args.steps, dev)
    else:
        params = init_nodes(lm, args.nodes, dev)
        step_fn = build_dfl_round(lm, opt, ring_adjacency(args.nodes),
                                  loss_kind=args.loss, beta=args.beta)
        stream = make_batches(lm, args.nodes, args.batch, args.seq,
                              args.steps, dev)
    opt_state = opt.init(params)

    n_params = sum(t.numel() for t in tree_leaves(params))
    print(f"arch={args.arch} preset={args.preset} mode={args.mode} "
          f"params={n_params / 1e6:.1f}M loss={args.loss} device={dev}")

    t0 = time.time()
    losses = []
    for step, batch in enumerate(stream):
        params, opt_state, loss = step_fn(params, opt_state, step, batch)
        losses.append(float(loss))
        if step % args.log_every == 0 or step == args.steps - 1:
            rate = (step + 1) / (time.time() - t0)
            print(f"step {step:5d}  loss {losses[-1]:.4f}  {rate:.2f} it/s",
                  flush=True)
    if args.ckpt_dir:
        path = save_checkpoint(args.ckpt_dir, args.steps,
                               {"params": params, "opt": opt_state},
                               metadata={"arch": args.arch,
                                         "mode": args.mode})
        print("checkpoint:", path)
    assert np.isfinite(losses[-1]), "training diverged"
    print(f"final loss {losses[-1]:.4f} (start {losses[0]:.4f})")
    return losses, params, opt_state


def main(argv=None):
    """`run`, returning the losses."""
    return run(argv)[0]


if __name__ == "__main__":
    main()
