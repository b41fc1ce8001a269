"""`build_round(experiment)`: Algorithm 1's round for the `vmap` backend.

One round is (local SGD steps -> neighbour exchange -> aggregation) over
every node at once, on the experiment's device, with no host
synchronisation.  This is the JAX package's round body on its dense
context with no transport, no dynamics, no event clock and no telemetry:

    round_fn(params, opt, round_idx) -> (params, opt, train_loss)

`train_loss` is a 0-d device tensor: the mean over local steps of the mean
over nodes of each step's loss, as in the reference.  Heterogeneous step
budgets and participation masks draw from the experiment's
`torch.Generator`, never from the global RNG; at the defaults
(`hetero_steps_min=0`, `participation=1.0`) a round draws nothing.  The
`shard_map` backend is ROADMAP A.10.
"""
from __future__ import annotations

import torch

from repro_torch.engine.neighborhood import DenseNeighborhood
from repro_torch.utils.pytree import tree_flatten_stacked, tree_map

BACKENDS = ("vmap", "shard_map")


def _make_local_training(exp):
    """B local SGD(momentum) minibatch steps (Alg. 1 l.4-9) for every node.
    With `hetero_steps_min > 0` each node draws a budget in
    [min, steps_per_round]; a node past its budget keeps its params and
    momentum (the reference's masked update)."""
    cfg, n = exp.train, exp.n
    x, y, counts = exp.x_pad, exp.y_pad, exp.counts
    batcher, train_step = exp.batcher, exp._train_step

    def local_training(params, opt, round_idx):
        budgets = None
        if cfg.hetero_steps_min > 0:
            budgets = torch.randint(cfg.hetero_steps_min,
                                    cfg.steps_per_round + 1, (n,),
                                    generator=exp.gen, device=exp.device)
        losses = []
        for b in range(cfg.steps_per_round):
            step = round_idx * cfg.steps_per_round + b
            xb, yb = batcher.take(x, y, counts, step)
            if budgets is None:
                params, opt, loss = train_step(params, opt, xb, yb)
            else:
                active = (b < budgets).to(torch.float32)
                old_params = tree_map(torch.clone, params)
                old_opt = tree_map(torch.clone, opt)
                params, opt, loss = train_step(params, opt, xb, yb)
                _mix_(params, old_params, active)
                _mix_(opt, old_opt, active)
            losses.append(torch.mean(loss))
        return params, opt, torch.mean(torch.stack(losses))

    return local_training


@torch.no_grad()
def _mix_(new_tree, old_tree, active):
    """In place: new <- active*new + (1-active)*old, per node row."""
    def mix(nw, od):
        a = active.reshape(active.shape + (1,) * (nw.dim() - 1))
        nw.copy_(a * nw + (1 - a) * od)
        return nw

    tree_map(mix, new_tree, old_tree)


def _make_delivery_mask(exp):
    """Per-edge Bernoulli link failures over the [N, max_deg] layout."""
    cfg, nbr_valid = exp.train, exp.nbr_valid

    def delivery_mask():
        if cfg.participation >= 1.0:
            return nbr_valid
        u = torch.rand(nbr_valid.shape, generator=exp.gen, device=exp.device)
        return nbr_valid * (u < cfg.participation).to(torch.float32)

    return delivery_mask


def build_round(exp):
    """Lower `exp` to its `vmap`-backend round function (module docstring);
    `Experiment` refuses the other backends before it gets here."""
    strategy = exp.strategy
    caps = strategy.capabilities
    nbr_idx, nbr_weight = exp.nbr_idx, exp.nbr_weight
    local_training = _make_local_training(exp)
    delivery_mask = _make_delivery_mask(exp)

    def round_fn(params, opt, round_idx: int):
        params, opt, train_loss = local_training(params, opt, round_idx)
        link = delivery_mask()
        if caps.kind == "gossip":
            with torch.no_grad():
                local_mat, unflatten = tree_flatten_stacked(params)
                # every sender broadcasts (no transport): the delivered
                # weights are ω·|D| times the link mask
                nb = DenseNeighborhood(local_mat, nbr_idx, nbr_weight * link,
                                       local_mat, unflatten)
                params = strategy.flat_aggregate(exp, exp.agg_state, nb)
        # kind == "none": isolation — no communication at all.
        return params, opt, train_loss

    return round_fn
