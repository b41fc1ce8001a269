"""`build_round(experiment)`: Algorithm 1's round for the `vmap` backend.

One round is (local SGD steps -> neighbour exchange -> aggregation) over
every node at once, on the experiment's device, with no host
synchronisation.  This is the JAX package's round body on its dense
context, on either node-axis layout (the padded [N, max_deg] panels or the
sparse CSR edge list), with or without the `repro_torch.comm` gossip
transport, and with no dynamics, no event clock and no telemetry.  By the
strategy's declared kind: gossip aggregates over the delivered neighbours
(then, for CFA-GE, walks the neighbour slots for the gradient exchange);
"server" (FedAvg) averages the full stack; "none" keeps the local models:

    round_fn(params, opt, comm_state, round_idx)
        -> (params, opt, comm_state, train_loss, sent_edges, trig)

`train_loss` is a 0-d device tensor: the mean over local steps of the mean
over nodes of each step's loss, as in the reference.  With a transport,
`sent_edges` (the round's fired directed edges: Σ_i gate_i·outdeg_i per
node, Σ_ij gate_ij per edge) and `trig` (their fraction of the directed
edges) are 0-d device tensors too; without one, `comm_state`, `sent_edges`
and `trig` are None.

Random draws come from the experiment's `torch.Generator`, never from the
global RNG, in the reference's order: heterogeneous step budgets, each
local step's dropout keep masks, the participation mask, then the codec's
uniforms (and CFA-GE's walk draws its gradient calls' keep masks last) —
each only when it is used (`hetero_steps_min > 0`, a model with dropout,
`participation < 1`, a stochastic int8 codec), so the defaults, the MLP,
the Fashion CNN and `CommConfig()` draw nothing.  Local steps and the
gradient walk run the model with `train=True`, evaluation with
`train=False`.  Every kind draws the link mask, so the later draws do not
depend on the method.  The dense layout draws the [N, max_deg] panel, the
sparse one one uniform per directed edge, so the two layouts are bitwise
equal only at participation == 1, as in the reference.  The `shard_map`
backend is ROADMAP A.10.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.comm.transport import (EdgeGossipTransport,
                                        SparseEdgeGossipTransport)
from repro_torch.comm.trigger import edge_delivery
from repro_torch.engine.neighborhood import (DenseNeighborhood,
                                             SparseNeighborhood)
from repro_torch.utils.pytree import tree_flatten_stacked, tree_map

BACKENDS = ("vmap", "shard_map")

#: directed edges per call of the gradient function in CFA-GE's exchange:
#: both layouts walk the same edge list in calls of exactly
#: min(E, GE_CHUNK) rows (see `_make_gradient_exchange`).
GE_CHUNK = 1024


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
                params, opt, loss = train_step(params, opt, xb, yb, step)
            else:
                active = (b < budgets).to(torch.float32)
                old_params = tree_map(torch.clone, params)
                old_opt = tree_map(torch.clone, opt)
                params, opt, loss = train_step(params, opt, xb, yb, step)
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


def _make_edge_link_mask(exp):
    """The sparse layout's link draw: one uniform per directed edge, the
    [E] {0,1} mask of the links that deliver (no draw at participation
    1)."""
    cfg, e_dir = exp.train, exp.sparse_plan.num_directed
    every = torch.ones((e_dir,), dtype=torch.float32, device=exp.device)

    def edge_link_mask():
        if cfg.participation >= 1.0:
            return every
        u = torch.rand((e_dir,), generator=exp.gen, device=exp.device)
        return (u < cfg.participation).to(torch.float32)

    return edge_link_mask


def _make_gradient_exchange(exp):
    """CFA-GE's second phase: each neighbour j evaluates the gradient of
    its local loss F_j at OUR aggregated model on one minibatch of ITS
    data, and we descend along their ω·|D|·mask-weighted mean.

    Both layouts walk one list, the directed edges (receiver i, sender j,
    i's slot k of j) ordered by (k, i): slot k of a receiver is its k-th
    CSR in-edge, senders ascending, in the dense panel and in a sparse
    bucket alike.  Edge (i, j, k) reads j's minibatch at the Batcher's step
    `round_idx·max_deg + k` (int32 arithmetic, modulo max(|D_j|, 1)), and
    i's gradient accumulator and total start at +0 and add its slots in
    ascending k, as the reference's slot walk does; the reference's
    padding slots (weight 0, finite gradients) add an exact +0, so they
    are left out.  The gradients are evaluated in calls of exactly
    min(E, GE_CHUNK) edges, the last padded with copies of edge 0 (sliced
    away): the two layouts make the same calls on the same rows, so they
    are bitwise equal wherever their weights are (participation == 1),
    and a round costs E row-gradients plus the last call's padding.  A
    node whose total is 0 keeps its model.

    Returns exchange(params, link, round_idx), `link` the layout's link
    mask: the dense [N, max_deg] panel or the sparse [E] list."""
    cfg, n, topo, dev = exp.train, exp.n, exp.topo, exp.device
    batcher, counts = exp.batcher, exp.counts
    x_pad, y_pad = exp.x_pad, exp.y_pad
    max_deg = int(topo.max_degree)
    grad_fn = exp._grad_fn
    lr_ge = cfg.ge_lr if cfg.ge_lr is not None else cfg.lr
    sparse = exp.layout == "sparse"
    if sparse:
        recv = topo.edge_dst.astype(np.int64)
        src = topo.edge_src.astype(np.int64)
        pos = np.arange(recv.shape[0], dtype=np.int64)  # CSR position
        slot = pos - topo.row_offsets[recv]
        # ω_e·|D_src|, the sparse plan's weights
        d_src = exp.counts.cpu().numpy()[topo.edge_src].astype(np.float32)
        weight = torch.from_numpy(topo.edge_weight * d_src).to(dev)
    else:
        weight = exp.nbr_weight.reshape(-1)
        recv, slot = np.nonzero(topo.neighbor_mask)
        src = np.maximum(topo.neighbor_idx, 0)[recv, slot]
        pos = recv * max_deg + slot  # into the flattened [N, max_deg] panel
    order = np.lexsort((recv, slot))
    recv, src, slot, pos = (np.asarray(a, np.int64)[order]
                            for a in (recv, src, slot, pos))
    e = int(recv.shape[0])
    chunk = max(min(e, GE_CHUNK), 1)
    recv_t, src_t, slot_t, pos_t = (torch.from_numpy(a).to(dev)
                                    for a in (recv, src, slot, pos))
    # per call: its receivers, senders, the senders' |D| and the slots
    # [chunk], and its runs of one slot (rows in the call, receivers, the
    # edges' slice of the round's weights)
    calls = []
    for c0 in range(0, e, chunk):
        c1 = min(c0 + chunk, e)
        cuts = [c0] + [q for q in range(c0 + 1, c1)
                       if slot[q] != slot[q - 1]] + [c1]
        ids = torch.from_numpy(np.concatenate([
            np.arange(c0, c1), np.zeros(c0 + chunk - c1, np.int64)])).to(dev)
        j = src_t[ids]
        runs = [(a - c0, b - c0, recv_t[a:b], slice(a, b))
                for a, b in zip(cuts[:-1], cuts[1:])]
        calls.append((recv_t[ids], j, counts[j], slot_t[ids], runs))

    def gradient_exchange(params, link, round_idx: int):
        w_e = weight[pos_t] * link.reshape(-1)[pos_t]
        p_mat, unflatten = tree_flatten_stacked(params)
        acc = torch.zeros_like(p_mat)
        tot = torch.zeros((n,), dtype=torch.float32, device=dev)
        for i, j, cnt, slots, runs in calls:
            bidx = batcher.indices(cnt, round_idx * max_deg + slots)
            # grad of F_j at w_i, one row per edge
            g = tree_flatten_stacked(grad_fn(
                tree_map(lambda p: p[i], params), x_pad[j[:, None], bidx],
                y_pad[j[:, None], bidx]))[0]
            for a, b, rows, edges in runs:  # each receiver at most once
                w_k = w_e[edges]
                acc[rows] = acc[rows] + w_k[:, None] * g[a:b]
                tot[rows] = tot[rows] + w_k
            del g
        safe = torch.clamp(tot, min=1e-9)
        step = lr_ge * (tot > 0).to(torch.float32) * (1.0 / safe)
        return unflatten(p_mat - step[:, None] * acc)

    return gradient_exchange


def build_round(exp):
    """Lower `exp` to its `vmap`-backend round function (module docstring);
    `Experiment` refuses the other backends before it gets here."""
    strategy, agg_state = exp.strategy, exp.agg_state
    caps = strategy.capabilities
    transport = exp.transport
    per_edge = isinstance(transport, (EdgeGossipTransport,
                                      SparseEdgeGossipTransport))
    wire = exp.wire
    sparse = exp.layout == "sparse"
    if sparse:
        plan = exp.sparse_plan
        degrees = plan.degrees
        edge_src = exp.edge_src
        link_draw = _make_edge_link_mask(exp)
    else:
        nbr_idx, nbr_weight = exp.nbr_idx, exp.nbr_weight
        degrees = torch.sum(exp.nbr_valid, dim=1)
        link_draw = _make_delivery_mask(exp)
    n_directed = exp._total_directed
    # trig = fired / directed edges.  The reference divides by a constant,
    # which XLA folds into a multiply by the constant's float32 reciprocal;
    # the port multiplies by the same reciprocal, so the fractions agree
    # bit for bit, in either layout.
    inv_edges = torch.tensor(np.float32(1.0) / np.float32(n_directed),
                             device=exp.device)
    # Gossip aggregation lowers to the strategy's flat form whenever it has
    # one: one weighted neighbour reduce over the layout's Neighborhood
    # view, over the [N, D] table or over the per-edge transport's
    # per-link reconstructions (the same kernel, so per-edge fp32 at
    # threshold 0 stays bitwise equal to the per-node round).  Strategies
    # without a flat form take the padded-gather exchange/aggregate pair,
    # which exists on the dense layout only (`Experiment` refuses sparse).
    use_flat = (caps.kind == "gossip"
                and strategy.flat_aggregate is not None)
    local_training = _make_local_training(exp)
    gradient_exchange = (_make_gradient_exchange(exp)
                         if caps.grad_exchange else None)

    def over_table(params, table_mat, mask):
        """Aggregate over a full [N, D] table of sender models, weights
        ω·|D| times the {0,1} `mask`: the dense [N, max_deg] panel or the
        sparse [E] list, each an exact product of {0,1} factors, so both
        layouts compose the same weights."""
        local_mat, unflatten = tree_flatten_stacked(params)
        if sparse:
            nb = SparseNeighborhood(plan, table_mat, local_mat, unflatten,
                                    mask)
            return strategy.flat_aggregate(exp, agg_state, nb)
        if use_flat:
            nb = DenseNeighborhood(table_mat, nbr_idx, nbr_weight * mask,
                                   local_mat, unflatten)
            return strategy.flat_aggregate(exp, agg_state, nb)
        gathered = strategy.exchange(exp, unflatten(table_mat), nbr_idx)
        return strategy.aggregate(exp, agg_state, params, gathered, mask)

    def over_links(params, links, mask):
        """Aggregate over the per-edge transport's per-link
        reconstructions: the dense [N, max_deg, D] panel with its
        [N, max_deg] mask, or the sparse [E, D] bank with its [E] mask."""
        local_mat, unflatten = tree_flatten_stacked(params)
        if sparse:
            nb = SparseNeighborhood(plan, None, local_mat, unflatten, mask,
                                    edge_table=links)
            return strategy.flat_aggregate(exp, agg_state, nb)
        if use_flat:
            nb = DenseNeighborhood(None, None, nbr_weight * mask, local_mat,
                                   unflatten, panel=links)
            return strategy.flat_aggregate(exp, agg_state, nb)
        n, e, d = links.shape
        gathered = tree_map(lambda l: l.reshape((n, e) + l.shape[1:]),
                            unflatten(links.reshape(n * e, d)))
        return strategy.aggregate(exp, agg_state, params, gathered, mask)

    def round_fn(params, opt, comm_state, round_idx: int):
        params, opt, train_loss = local_training(params, opt, round_idx)
        # the link mask: [N, max_deg] dense, [E] sparse
        link = link_draw()
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
                # (link-layer ack); it hands back the receivers' per-link
                # reconstructions (fresh or per-link stale cache) and the
                # aggregation mask.  Sparse: an edge id is both ends'
                # address of its link, so the [E] link mask goes in as it
                # is and the [E, D] bank comes back, no reverse gather.
                gen = exp.gen if transport.wants_rng else None
                links, mask, gate, comm_state = transport.exchange(
                    params, comm_state, link, gen, wire=wire)
                params = over_links(params, links, mask)
                del links
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
                delivered = (gate[edge_src] * link if sparse
                             else edge_delivery(gate, link, nbr_idx))
                comm_state = transport.note_delivery(comm_state, delivered)
                if transport.config.on_silence == "drop":
                    mask = delivered
                else:
                    mask = link * comm_state.ever_recv
                params = over_table(params, decoded, mask)
                # broadcast accounting: a transmitting node pays one
                # payload per outgoing edge (Σ gate_i·deg_i; the graphs
                # are symmetric, so in- and out-degree are equal).
                sent_edges = torch.sum(gate * degrees)
                trig = sent_edges * inv_edges
        return params, opt, comm_state, train_loss, sent_edges, trig

    return round_fn
