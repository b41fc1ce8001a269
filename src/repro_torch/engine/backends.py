"""`build_round(experiment)`: Algorithm 1's round, one body, two backends.

One round is (local SGD steps -> neighbour exchange -> aggregation) over
the caller's block of nodes, on the experiment's device, with no host
synchronisation.  The body is written once against a
`repro_torch.comm.PodContext` (a row slice and an all-gather), as the JAX
package's is, and the two backends differ only in the context they bind:

  * ``vmap``      — the dense context: one block of all N rows, both maps
    the identity;
  * ``shard_map`` — one block of R = N / P rows per pod of the
    experiment's mesh (`torch.distributed`, one rank per pod): the
    context's gather is a tiled all-gather over the mesh's "pod"
    dimension carrying the transport's encoded payload by default
    (`Experiment(wire=...)`), and receiver-facing transport caches are
    replicated, so the per-edge reverse-slot gather and CFA-GE's walk read
    them without further collectives.  The round's loss is the mean of
    the pods' means.

Either layout runs (the padded [N, max_deg] panels or the sparse CSR edge
list, whose plan holds one slab of width buckets per pod), with or without
the `repro_torch.comm` gossip transport, a `repro_torch.dynamics` process,
a `repro_torch.timing` event clock and `repro_torch.obs` telemetry.  By the
strategy's declared kind: gossip aggregates over the delivered neighbours
(then, for CFA-GE, walks the neighbour slots for the gradient exchange);
"server" (FedAvg) averages the gathered full stack; "none" keeps the local
models:

    round_fn(params, opt, comm_state, dyn_state, time_state, obs_state,
             round_idx)
        -> (params, opt, comm_state, dyn_state, time_state, obs_state,
            train_loss, extras)

with params and optimizer state the block's rows and the transport state
split by its `state_specs`.  `train_loss` is a 0-d device tensor: the mean
over local steps of the mean over the block's nodes of each step's loss
(averaged over pods).  The states are None where the experiment has no
such subsystem, and `extras` holds 0-d device tensors in the reference's
order: (sent_edges, trig) with a transport (the round's fired directed
edges, Σ_i gate_i·outdeg_i per node, Σ_ij gate_ij per edge, and their
fraction of the live directed edges), then (live_edges,) with dynamics,
then (sim_time, arrived_edges) with a clock, then the telemetry's channel
snapshot (a dict of device tensors) last.  Each transport branch also
hands the telemetry its fired and delivered edge masks in the receiver
orientation (the dense [N, max_deg] panel or the sparse [E] list): the
quantities the byte accounting sums, so the channels agree with
`sent_edges` exactly; a late payload counts as fired and not delivered.
The channels draw nothing and write no other state.  Dynamics, timing
and telemetry state are replicated: every pod advances them identically.

With dynamics the round starts by realizing its graph (one draw from the
generator for a random process, then the process's transition): a dead
node runs zero local steps and its params and optimizer state freeze
(a select, so a NaN FedAvg average of an all-dead round stays out), the
link mask is intersected with the live edges, transports fire and pay
only on live edges, a rejoined node's per-link state is reset before the
exchange, and FedAvg's weights are intersected with aliveness.  With a
clock the round is priced in simulated seconds: under a deadline d node
i trains at most floor(d / dt_i) steps, a payload on (j -> i) arrives iff
t_cost_j + transfer_ji <= d (a late payload is a failed link whose bytes
are still paid), and the tick is d; without one the tick is the makespan
(the slowest node, stretched to the slowest live landing).  The clock
draws nothing, so `Timing()` and `StaticGraph()` are bitwise no-ops.

Random draws come from the experiment's `torch.Generator`, never from the
global RNG, in the reference's order: the dynamics process's uniforms,
heterogeneous step budgets, each local step's dropout keep masks, the
participation mask, then the codec's uniforms (and CFA-GE's walk draws
its gradient calls' keep masks last) — each only when it is used (a
random process, `hetero_steps_min > 0`, a model with dropout,
`participation < 1`, a stochastic int8 codec), so the defaults, the MLP,
the Fashion CNN and `CommConfig()` draw nothing.  Every draw is made over
the full node (or edge) axis, on every pod alike from its identically
seeded generator, and then sliced to the block: a block draws exactly the
values the dense context draws, which is what makes the two backends
bitwise equal.  Local steps and the gradient walk run the model with
`train=True`, evaluation with `train=False`.  Every kind draws the link
mask, so the later draws do not depend on the method.  The dense layout
draws the [N, max_deg] panel, the sparse one one uniform per directed
edge, so the two layouts are bitwise equal only at participation == 1, as
in the reference.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.comm.transport import (DENSE_CTX, EdgeGossipTransport,
                                        SparseEdgeGossipTransport, pod_mean)
from repro_torch.comm.trigger import edge_delivery
from repro_torch.engine.neighborhood import (DenseNeighborhood,
                                             SparseNeighborhood)
from repro_torch.timing import TimingState
from repro_torch.utils.pytree import tree_flatten_stacked, tree_map

BACKENDS = ("vmap", "shard_map")

#: directed edges per call of the gradient function in CFA-GE's exchange:
#: both layouts walk the same edge list in calls of min(E, GE_CHUNK)
#: edges (see `_make_gradient_exchange`).
GE_CHUNK = 1024


def rows_keep(keep, full: int, pick):
    """A dropout keep-mask source for a call on some rows of a full call:
    it draws the full call's masks ([full, ...], so the generator advances
    exactly as the full call's draw does) and returns the rows `pick` (a
    slice or an index tensor)."""
    def sub(shape, p):
        return keep((full,) + tuple(shape[1:]), p)[pick]

    return sub


def _make_local_training(exp, ctx=DENSE_CTX):
    """B local SGD(momentum) minibatch steps (Alg. 1 l.4-9) for the
    block's nodes (`exp.x_pad` / `exp.y_pad` hold the block's rows).
    With `hetero_steps_min > 0` each node draws a budget in
    [min, steps_per_round]; `cap` ([N] int64, the event clock's deadline
    cap floor(d / dt_i)) lowers it and `alive` ([N] {0,1}) zeroes a dead
    node's.  A node past its budget keeps its params and momentum (the
    reference's masked update).  Budgets are drawn and capped over the
    full node axis, then sliced to the block, and returned full (every
    node's `steps_per_round` when nothing limits them), from which the
    clock prices each node's round at budget_i·dt_i seconds."""
    cfg, n = exp.train, exp.n
    x, y, counts = exp.x_pad, exp.y_pad, ctx.rows(exp.counts)
    batcher, train_step = exp.batcher, exp._train_step

    def local_training(params, opt, round_idx, alive=None, cap=None):
        budgets_full = budgets = None
        if cfg.hetero_steps_min > 0:
            budgets_full = torch.randint(cfg.hetero_steps_min,
                                         cfg.steps_per_round + 1, (n,),
                                         generator=exp.gen,
                                         device=exp.device)
        if cap is not None or alive is not None:
            if budgets_full is None:
                budgets_full = torch.full((n,), cfg.steps_per_round,
                                          dtype=torch.int64,
                                          device=exp.device)
            if cap is not None:
                budgets_full = torch.minimum(budgets_full, cap)
            if alive is not None:
                budgets_full = budgets_full * alive.to(budgets_full.dtype)
        if budgets_full is not None:
            budgets = ctx.rows(budgets_full)
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
        if budgets_full is None:
            budgets_full = torch.full((n,), cfg.steps_per_round,
                                      dtype=torch.int64, device=exp.device)
        return params, opt, torch.mean(torch.stack(losses)), budgets_full

    return local_training


@torch.no_grad()
def _mix_(new_tree, old_tree, active):
    """In place: new <- active*new + (1-active)*old, per node row."""
    def mix(nw, od):
        a = active.reshape(active.shape + (1,) * (nw.dim() - 1))
        nw.copy_(a * nw + (1 - a) * od)
        return nw

    tree_map(mix, new_tree, old_tree)


def _freeze_dead(new_params, old_params, alive):
    """Per-node select: rows with alive == 0 keep their old value
    bit-exactly.  A select, not `_mix_`'s arithmetic: in a round where
    every FedAvg client is dead the server's average is 0/0 = NaN, and
    only a select keeps it out of the frozen rows."""
    def sel(nw, od):
        a = alive.reshape(alive.shape + (1,) * (nw.dim() - 1)) > 0
        return torch.where(a, nw, od)

    return tree_map(sel, new_params, old_params)


def _and_masks(*ms):
    """Product of the non-None {0,1} float masks (None = all ones); None
    if every factor is absent.  Exact {0,1} products, so the order of the
    factors cannot change a bit."""
    out = None
    for m in ms:
        if m is not None:
            out = m if out is None else out * m
    return out


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


def _make_gradient_exchange(exp, ctx=DENSE_CTX):
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
    are left out.  The walk runs in calls of min(E, GE_CHUNK) edges, each
    restricted to the edges whose receiver is in the caller's block (all
    N rows under `DENSE_CTX`; the senders' data is read from the
    replicated full arrays, `exp.x_walk` / `exp.y_walk`): each call's
    gradients are evaluated on those rows only and its dropout masks are
    drawn for all `chunk` rows (`rows_keep`), so every block draws as a
    full call does, and a call with no row in the block still draws them
    through a one-row call whose result is dropped.  The layouts make the
    same calls on the same rows, so they are bitwise equal wherever their
    weights are (participation == 1).  A node whose total is 0 keeps its
    model.

    Returns exchange(params, link, round_idx), `params` the block's
    rows and `link` the layout's full link mask: the dense [N, max_deg]
    panel or the sparse [E] list."""
    cfg, n, topo, dev = exp.train, exp.n, exp.topo, exp.device
    batcher, counts = exp.batcher, exp.counts
    x_full, y_full = exp.x_walk, exp.y_walk
    max_deg = int(topo.max_degree)
    grad_fn = exp._grad_fn
    keep = grad_fn.keywords["keep"]
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
    block = np.asarray(ctx.rows(np.arange(n)))
    i0, r = int(block[0]), int(block.shape[0])
    pos_t = torch.from_numpy(pos).to(dev)
    # per call: its receivers (block rows), senders, the senders' |D|, the
    # slots, its mask source, and its runs of one slot (rows in the call,
    # receivers, the edges' ids into the round's weights)
    calls = []
    for c0 in range(0, e, chunk):
        c1 = min(c0 + chunk, e)
        sel = np.nonzero((recv[c0:c1] >= i0) & (recv[c0:c1] < i0 + r))[0]
        pick = sel if sel.size else np.zeros(1, np.int64)
        ids = c0 + pick
        cuts = [0] + [q for q in range(1, sel.size)
                      if slot[ids[q]] != slot[ids[q - 1]]] + [sel.size]
        runs = [(a, b, torch.from_numpy(recv[ids[a:b]] - i0).to(dev),
                 torch.from_numpy(ids[a:b]).to(dev))
                for a, b in zip(cuts[:-1], cuts[1:]) if b > a]
        i_loc = torch.from_numpy(recv[ids] - i0 if sel.size
                                 else np.zeros(1, np.int64)).to(dev)
        j = torch.from_numpy(src[ids]).to(dev)
        calls.append((i_loc, j, counts[j],
                      torch.from_numpy(slot[ids]).to(dev),
                      rows_keep(keep, chunk,
                                torch.from_numpy(pick).to(dev)), runs))

    def gradient_exchange(params, link, round_idx: int):
        w_e = weight[pos_t] * link.reshape(-1)[pos_t]
        p_mat, unflatten = tree_flatten_stacked(params)
        acc = torch.zeros_like(p_mat)
        tot = torch.zeros((r,), dtype=torch.float32, device=dev)
        for i, j, cnt, slots, call_keep, runs in calls:
            bidx = batcher.indices(cnt, round_idx * max_deg + slots)
            # grad of F_j at w_i, one row per edge
            g = tree_flatten_stacked(grad_fn.func(
                tree_map(lambda p: p[i], params), x_full[j[:, None], bidx],
                y_full[j[:, None], bidx], keep=call_keep))[0]
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
    """Lower `exp` to its round function (module docstring)."""
    if exp.backend == "vmap":
        return _build_vmap_round(exp)
    if exp.backend == "shard_map":
        return _build_shardmap_round(exp)
    raise ValueError(
        f"unknown backend {exp.backend!r}; available: {BACKENDS}")


def _build_vmap_round(exp):
    """The dense lowering: the round body under the identity context."""
    return _make_round_body(exp, DENSE_CTX)


def _build_shardmap_round(exp):
    """The round body over the experiment's pod context (`exp.pod_ctx`,
    one block of R = N / P rows of the mesh's "pod" dimension): each rank
    holds its nodes' params, optimizer state, data rows and
    sender-private transport rows, and only the exchange's gather crosses
    pods.  The loss is the mean of the pods' means (`pod_mean`), so every
    rank holds the same value."""
    return _make_round_body(exp, exp.pod_ctx)


def _make_round_body(exp, ctx):
    """The one round body over the PodContext `ctx` (module docstring)."""
    strategy = exp.strategy
    rows = ctx.rows
    pod = ctx.pod if ctx.pod is not None else 0
    caps = strategy.capabilities
    transport = exp.transport
    per_edge = isinstance(transport, (EdgeGossipTransport,
                                      SparseEdgeGossipTransport))
    wire = exp.wire
    sparse = exp.layout == "sparse"
    dev = exp.device
    if sparse:
        plan = exp.sparse_plan
        degrees = plan.degrees
        edge_src, edge_dst = exp.edge_src, exp.edge_dst
        link_draw = _make_edge_link_mask(exp)
    else:
        nbr_idx, nbr_weight = exp.nbr_idx, exp.nbr_weight
        nbr_valid = exp.nbr_valid
        degrees = torch.sum(nbr_valid, dim=1)
        link_draw = _make_delivery_mask(exp)
    n_directed = exp._total_directed
    # trig = fired / directed edges.  The reference divides by a constant,
    # which XLA folds into a multiply by the constant's float32 reciprocal;
    # the port multiplies by the same reciprocal, so the fractions agree
    # bit for bit, in either layout.  Under dynamics the divisor is the
    # round's live-edge count, a true division in both packages — except
    # for StaticGraph, whose live mask is a constant the reference folds
    # the same way.
    inv_edges = torch.tensor(np.float32(1.0) / np.float32(n_directed),
                             device=dev)
    bound_dyn, bt, tele = exp.bound_dyn, exp.bound_timing, exp.bound_obs
    has_dyn, has_time = bound_dyn is not None, bt is not None
    has_obs = tele is not None
    live_varies = has_dyn and bound_dyn.name != "static"
    deadline = (torch.tensor(np.float32(exp.deadline), device=dev)
                if exp.deadline is not None else None)
    steps_f = torch.tensor(np.float32(exp.train.steps_per_round), device=dev)
    # does the round exchange payloads over the graph?  The synchronous
    # clock's tick then waits for the slowest live link's landing too.
    exchanges = transport is not None or caps.kind == "gossip"
    # Gossip aggregation lowers to the strategy's flat form whenever it has
    # one: one weighted neighbour reduce over the layout's Neighborhood
    # view, over the [N, D] table or over the per-edge transport's
    # per-link reconstructions (the same kernel, so per-edge fp32 at
    # threshold 0 stays bitwise equal to the per-node round).  Strategies
    # without a flat form take the padded-gather exchange/aggregate pair,
    # which exists on the dense layout only (`Experiment` refuses sparse).
    use_flat = (caps.kind == "gossip"
                and strategy.flat_aggregate is not None)
    local_training = _make_local_training(exp, ctx)
    gradient_exchange = (_make_gradient_exchange(exp, ctx)
                         if caps.grad_exchange else None)
    # a gossip strategy aggregates its block's rows of the per-node
    # tensors; a server strategy averages the full stack
    agg_state = (tree_map(rows, exp.agg_state) if caps.kind == "gossip"
                 else exp.agg_state)
    if not sparse:
        nbr_idx_r, nbr_weight_r = rows(nbr_idx), rows(nbr_weight)

    def over_table(params, table_mat, mask):
        """Aggregate the block over a full [N, D] table of sender models,
        weights ω·|D| times the full {0,1} `mask`: the dense [N, max_deg]
        panel or the sparse [E] list, each an exact product of {0,1}
        factors, so both layouts compose the same weights."""
        local_mat, unflatten = tree_flatten_stacked(params)
        if sparse:
            nb = SparseNeighborhood(plan, table_mat, local_mat, unflatten,
                                    mask, pod=pod)
            return strategy.flat_aggregate(exp, agg_state, nb)
        if use_flat:
            nb = DenseNeighborhood(table_mat, nbr_idx_r,
                                   nbr_weight_r * rows(mask), local_mat,
                                   unflatten)
            return strategy.flat_aggregate(exp, agg_state, nb)
        gathered = strategy.exchange(exp, unflatten(table_mat), nbr_idx_r)
        return strategy.aggregate(exp, agg_state, params, gathered,
                                  rows(mask))

    def over_links(params, links, mask):
        """Aggregate over the per-edge transport's per-link
        reconstructions: the block's dense [R, max_deg, D] panel with its
        [R, max_deg] mask, or the full sparse [E, D] bank with its [E]
        mask."""
        local_mat, unflatten = tree_flatten_stacked(params)
        if sparse:
            nb = SparseNeighborhood(plan, None, local_mat, unflatten, mask,
                                    edge_table=links, pod=pod)
            return strategy.flat_aggregate(exp, agg_state, nb)
        if use_flat:
            nb = DenseNeighborhood(None, None, nbr_weight_r * mask,
                                   local_mat, unflatten, panel=links)
            return strategy.flat_aggregate(exp, agg_state, nb)
        r, e, d = links.shape
        gathered = tree_map(lambda l: l.reshape((r, e) + l.shape[1:]),
                            unflatten(links.reshape(r * e, d)))
        return strategy.aggregate(exp, agg_state, params, gathered, mask)

    def fired_frac(sent, live_total):
        if live_varies:
            return sent / torch.clamp(live_total, min=1.0)
        return sent * inv_edges

    def round_fn(params, opt, comm_state, dyn_state, time_state, obs_state,
                 round_idx: int):
        # -- the dynamics prelude: realize this round's graph.  A random
        # process draws its uniforms first, before anything else in the
        # round, as the reference splits its key first.
        ev = alive = None
        if has_dyn:
            u = bound_dyn.draw(exp.gen) if bound_dyn.needs_rng else None
            if bound_dyn.observes:
                dyn_state, ev = bound_dyn.transition(
                    dyn_state, round_idx, u, time_state.last_cost)
            else:
                dyn_state, ev = bound_dyn.transition(dyn_state, round_idx, u)
            alive = ev.alive
        # -- the clock prelude: per-node step times and the deadline cap
        # floor(d / dt_i) (stragglers train fewer steps); no draws.
        dt = cap = None
        if has_time:
            dt = bt.step_time(round_idx)
            if deadline is not None:
                cap = torch.minimum(torch.floor(deadline / dt),
                                    steps_f).to(torch.int64)
        # -- Alg. 1 l.4-9: local SGD (dead nodes run zero steps)
        params, opt, train_loss, budgets = local_training(
            params, opt, round_idx, alive=alive, cap=cap)
        train_loss = pod_mean(ctx, train_loss)
        # realized per-node compute seconds (0 for a dead node)
        t_cost = budgets.to(torch.float32) * dt if has_time else None
        # -- the link mask ([N, max_deg] dense, [E] sparse): participation
        # draws, the live graph and, under a deadline, arrival: a payload
        # on edge (j -> i) lands at t_cost_j + transfer_ji and is delivered
        # iff that is <= d.  A late payload is exactly a failed link.
        link = link_draw()
        live = ev.live if has_dyn else None
        arr = None
        if deadline is not None:
            if sparse:
                arr = (t_cost[edge_src] + bt.transfer_e
                       <= deadline).to(torch.float32)
            else:
                arr = (t_cost[nbr_idx] + bt.transfer_panel
                       <= deadline).to(torch.float32) * nbr_valid
        link = _and_masks(link, live, arr)
        live_total = torch.sum(live) if has_dyn else None
        old_params = params
        extras = []
        # the telemetry's receiver-side fired / delivered edge masks
        obs_fired = obs_deliv = None
        with torch.no_grad():
            if transport is None:
                if caps.kind == "server":
                    # the server averages the gathered full stack, every
                    # client weighted by |D_i| times its aliveness: an
                    # offline client's frozen params carry zero weight
                    full = tree_map(ctx.gather, params)
                    params = strategy.aggregate(exp, agg_state, params,
                                                full, alive)
                    del full
                elif caps.kind == "gossip":
                    # every sender broadcasts: the delivered weights are
                    # ω·|D| times the link mask
                    table = ctx.gather(tree_flatten_stacked(params)[0])
                    params = over_table(params, table, link)
                    del table
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
                # Under dynamics a dead edge cannot fire, and every link
                # incident to a rejoined node returns to bootstrap first.
                reset = None
                if has_dyn:
                    rj = ev.rejoined
                    reset = (torch.maximum(rj[edge_src], rj[edge_dst])
                             if sparse else
                             torch.maximum(rj[:, None], rj[nbr_idx])
                             * nbr_valid)
                gen = exp.gen if transport.wants_rng else None
                links, mask, gate, comm_state = transport.exchange(
                    params, comm_state, link, gen, live=live, reset=reset,
                    ctx=ctx, wire=wire)
                params = over_links(params, links, mask)
                del links
                if has_obs:
                    # dense: the sender-layout gate seen from the receiver
                    obs_fired = (gate if sparse
                                 else transport.recv_layout(gate))
                    obs_deliv = obs_fired * link
                # unicast accounting: one payload per FIRED edge; failed
                # and late links still burn the sender's bytes.
                sent = torch.sum(gate)
                extras += [sent, fired_frac(sent, live_total)]
            else:
                # per-NODE transport: a node encodes once and broadcasts.
                # A rejoined node's row returns to bootstrap first; dead
                # senders are vetoed.  "stale" aggregates a silent
                # neighbour's cached model, masking only edges that never
                # DELIVERED; "drop" masks every silent or undelivered edge
                # like a failed link.
                send_mask = None
                if has_dyn:
                    comm_state = transport.reset_rows(
                        comm_state, ev.rejoined, ctx=ctx)
                    send_mask = rows(alive)
                gen = exp.gen if transport.wants_rng else None
                decoded, gate, comm_state = transport.exchange(
                    params, comm_state, gen, send_mask=send_mask, ctx=ctx,
                    wire=wire)
                delivered = (gate[edge_src] * link if sparse
                             else edge_delivery(gate, link, nbr_idx))
                comm_state = transport.note_delivery(comm_state, delivered)
                if has_obs:
                    if sparse:
                        obs_fired = (gate[edge_src] * live if has_dyn
                                     else gate[edge_src])
                    else:
                        obs_fired = gate[nbr_idx] * (live if has_dyn
                                                     else nbr_valid)
                    obs_deliv = delivered
                if transport.config.on_silence == "drop":
                    mask = delivered
                else:
                    mask = link * comm_state.ever_recv
                params = over_table(params, decoded, mask)
                del decoded
                # broadcast accounting: a transmitting node pays one
                # payload per outgoing edge, its LIVE ones under dynamics
                # (the graphs are symmetric: in- and out-degree are equal)
                if not has_dyn:
                    sent = torch.sum(gate * degrees)
                elif sparse:
                    sent = torch.sum(gate[edge_src] * live)
                else:
                    sent = torch.sum(gate * torch.sum(live, dim=1))
                extras += [sent, fired_frac(sent, live_total)]
            # -- the dynamics epilogue: freeze the dead, count the live
            if has_dyn:
                params = _freeze_dead(params, old_params, rows(alive))
                extras.append(live_total)
        # -- the clock epilogue.  A deadline tick is exactly d; the
        # synchronous tick is the makespan: the slowest node's compute,
        # stretched to the slowest LIVE link's landing when the round
        # exchanges payloads.  `t` accumulates in float32 on the device.
        if has_time:
            if deadline is not None:
                tick = deadline
            else:
                tick = torch.max(t_cost)
                if exchanges:
                    if sparse:
                        land = t_cost[edge_src] + bt.transfer_e
                        lv = live
                    else:
                        land = t_cost[nbr_idx] + bt.transfer_panel
                        lv = live if has_dyn else nbr_valid
                    if lv is not None:
                        land = lv * land
                    tick = torch.maximum(tick, torch.max(land))
            sim_t = time_state.t + tick
            if deadline is not None:
                arrived = torch.sum(_and_masks(arr, live))
            elif has_dyn:
                arrived = live_total  # every live payload arrives
            else:
                arrived = torch.tensor(np.float32(n_directed), device=dev)
            time_state = TimingState(t=sim_t, last_cost=t_cost)
            extras += [sim_t, arrived]
        # -- the telemetry epilogue: channel arithmetic on the carried dict
        if has_obs:
            obs_state, snap = tele.step(obs_state, budgets=budgets,
                                        t_cost=t_cost, fired=obs_fired,
                                        delivered=obs_deliv)
            extras.append(snap)
        return (params, opt, comm_state, dyn_state, time_state, obs_state,
                train_loss, tuple(extras))

    return round_fn
