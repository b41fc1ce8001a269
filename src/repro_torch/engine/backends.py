"""`build_round(experiment)`: Algorithm 1's round for the `vmap` backend.

One round is (local SGD steps -> neighbour exchange -> aggregation) over
every node at once, on the experiment's device, with no host
synchronisation.  This is the JAX package's round body on its dense
context, with or without the `repro_torch.comm` gossip transport, and with
no dynamics, no event clock and no telemetry.  By the strategy's declared
kind: gossip aggregates over the delivered neighbours (then, for CFA-GE,
walks the neighbour slots for the gradient exchange); "server" (FedAvg)
averages the full stack; "none" keeps the local models:

    round_fn(params, opt, comm_state, round_idx)
        -> (params, opt, comm_state, train_loss, sent_edges, trig)

`train_loss` is a 0-d device tensor: the mean over local steps of the mean
over nodes of each step's loss, as in the reference.  With a transport,
`sent_edges` (the round's fired directed edges: Σ_i gate_i·outdeg_i per
node, Σ_ij gate_ij per edge) and `trig` (their fraction of the directed
edges) are 0-d device tensors too; without one, `comm_state`, `sent_edges`
and `trig` are None.

Random draws come from the experiment's `torch.Generator`, never from the
global RNG, in the reference's order: heterogeneous step budgets, the
participation mask, then the codec's uniforms — each only when it is
used (`hetero_steps_min > 0`, `participation < 1`, a stochastic int8
codec), so the defaults and `CommConfig()` draw nothing.  Every kind draws
the link mask, so the later draws do not depend on the method.  The
`shard_map` backend is ROADMAP A.10.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.comm.transport import EdgeGossipTransport
from repro_torch.comm.trigger import edge_delivery
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


def _make_gradient_exchange(exp):
    """CFA-GE's second phase: each neighbour j evaluates the gradient of
    its local loss F_j at OUR aggregated model on one minibatch of ITS
    data, and we descend along their ω·|D|·mask-weighted mean.

    The walk goes over the slots d = 0..max_deg-1 in order; slot d's
    minibatch of neighbour j is the Batcher's step `round_idx·max_deg + d`
    (int32 arithmetic, modulo max(|D_j|, 1)).  The gradient accumulators
    and the totals start at +0 and add in slot order, so a padded slot
    (neighbour 0, weight 0) adds exactly +0.  A node whose total is 0
    keeps its model."""
    cfg, n = exp.train, exp.n
    batcher, counts = exp.batcher, exp.counts
    nbr_idx, nbr_weight = exp.nbr_idx, exp.nbr_weight
    x_pad, y_pad = exp.x_pad, exp.y_pad
    max_deg = int(nbr_idx.shape[1])
    grad_fn = exp._grad_fn
    lr_ge = cfg.ge_lr if cfg.ge_lr is not None else cfg.lr

    def gradient_exchange(params, mask, round_idx: int):
        acc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                             device=p.device), params)
        tot = torch.zeros((n,), dtype=torch.float32, device=exp.device)
        for d in range(max_deg):
            j = nbr_idx[:, d]  # [N] neighbour ids in slot d
            bidx = batcher.indices(counts[j], round_idx * max_deg + d)
            g = grad_fn(params, x_pad[j[:, None], bidx],
                        y_pad[j[:, None], bidx])  # grad of F_j at w_i
            w_d = nbr_weight[:, d] * mask[:, d]

            def add(a, gi):
                wb = w_d.reshape((n,) + (1,) * (gi.dim() - 1))
                return a + wb * gi.to(torch.float32)

            acc = tree_map(add, acc, g)
            tot = tot + w_d
        safe = torch.clamp(tot, min=1e-9)
        step = lr_ge * (tot > 0).to(torch.float32) * (1.0 / safe)

        def apply(p, a):
            sb = step.reshape((n,) + (1,) * (a.dim() - 1))
            return (p.to(torch.float32) - sb * a).to(p.dtype)

        return tree_map(apply, params, acc)

    return gradient_exchange


def build_round(exp):
    """Lower `exp` to its `vmap`-backend round function (module docstring);
    `Experiment` refuses the other backends before it gets here."""
    strategy, agg_state = exp.strategy, exp.agg_state
    caps = strategy.capabilities
    transport = exp.transport
    per_edge = isinstance(transport, EdgeGossipTransport)
    wire = exp.wire
    nbr_idx, nbr_weight = exp.nbr_idx, exp.nbr_weight
    degrees = torch.sum(exp.nbr_valid, dim=1)
    # trig = fired / directed edges.  The reference divides by a constant,
    # which XLA folds into a multiply by the constant's float32 reciprocal;
    # the port multiplies by the same reciprocal, so the fractions agree
    # bit for bit.
    inv_edges = torch.tensor(
        np.float32(1.0) / np.float32(exp.topo.neighbor_mask.sum()),
        device=exp.device)
    # Gossip aggregation lowers to the strategy's flat form whenever it has
    # one: one weighted neighbour reduce over a DenseNeighborhood, over the
    # [N, D] table or over the per-edge transport's pre-gathered panel (the
    # same kernel, so per-edge fp32 at threshold 0 stays bitwise equal to
    # the per-node round).  Strategies without a flat form take the
    # padded-gather exchange/aggregate pair.
    use_flat = (caps.kind == "gossip"
                and strategy.flat_aggregate is not None)
    local_training = _make_local_training(exp)
    delivery_mask = _make_delivery_mask(exp)
    gradient_exchange = (_make_gradient_exchange(exp)
                         if caps.grad_exchange else None)

    def over_table(params, table_mat, mask):
        """Aggregate over a full [N, D] table of sender models, slot
        weights ω·|D| times the [N, max_deg] {0,1} mask."""
        local_mat, unflatten = tree_flatten_stacked(params)
        if use_flat:
            nb = DenseNeighborhood(table_mat, nbr_idx, nbr_weight * mask,
                                   local_mat, unflatten)
            return strategy.flat_aggregate(exp, agg_state, nb)
        gathered = strategy.exchange(exp, unflatten(table_mat), nbr_idx)
        return strategy.aggregate(exp, agg_state, params, gathered, mask)

    def over_panel(params, panel, mask):
        """Aggregate over the per-edge transport's [N, max_deg, D] panel."""
        local_mat, unflatten = tree_flatten_stacked(params)
        if use_flat:
            nb = DenseNeighborhood(None, None, nbr_weight * mask, local_mat,
                                   unflatten, panel=panel)
            return strategy.flat_aggregate(exp, agg_state, nb)
        n, e, d = panel.shape
        gathered = tree_map(lambda l: l.reshape((n, e) + l.shape[1:]),
                            unflatten(panel.reshape(n * e, d)))
        return strategy.aggregate(exp, agg_state, params, gathered, mask)

    def round_fn(params, opt, comm_state, round_idx: int):
        params, opt, train_loss = local_training(params, opt, round_idx)
        link = delivery_mask()
        sent_edges = trig = None
        with torch.no_grad():
            if transport is None:
                if caps.kind == "server":
                    # the server averages the full stack, every client
                    # weighted by |D_i| (no dynamics: all are live)
                    params = strategy.aggregate(exp, agg_state, params,
                                                params, None)
                elif caps.kind == "gossip":
                    # every sender broadcasts: the delivered weights are
                    # ω·|D| times the link mask
                    table = tree_flatten_stacked(params)[0]
                    params = over_table(params, table, link)
                    if gradient_exchange is not None:
                        params = gradient_exchange(params, link, round_idx)
                # kind == "none": isolation — no communication at all.
            elif per_edge:
                # per-EDGE transport: the link mask feeds the exchange
                # (link-layer ack through the layout swap); it hands back
                # the receiver-layout panel (fresh or per-link stale cache)
                # and the aggregation mask.
                gen = exp.gen if transport.wants_rng else None
                panel, mask, gate, comm_state = transport.exchange(
                    params, comm_state, link, gen, wire=wire)
                params = over_panel(params, panel, mask)
                # unicast accounting: one payload per FIRED edge; failed
                # links still burn the sender's bytes.
                sent_edges = torch.sum(gate)
                trig = sent_edges * inv_edges
            else:
                # per-NODE transport: a node encodes once and broadcasts.
                # "stale" aggregates a silent neighbour's cached model,
                # masking only edges that never DELIVERED; "drop" masks
                # every silent or undelivered edge like a failed link.
                gen = exp.gen if transport.wants_rng else None
                decoded, gate, comm_state = transport.exchange(
                    params, comm_state, gen, wire=wire)
                delivered = edge_delivery(gate, link, nbr_idx)
                comm_state = transport.note_delivery(comm_state, delivered)
                if transport.config.on_silence == "drop":
                    mask = delivered
                else:
                    mask = link * comm_state.ever_recv
                params = over_table(params, decoded, mask)
                # broadcast accounting: a transmitting node pays one
                # payload per outgoing edge.
                sent_edges = torch.sum(gate * degrees)
                trig = sent_edges * inv_edges
        return params, opt, comm_state, train_loss, sent_edges, trig

    return round_fn
