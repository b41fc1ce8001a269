"""Gossip transport: codecs x event trigger x exact bytes-on-wire accounting,
on the dense padded-neighbour layout (the JAX package's
`repro.comm.transport` on its dense context).

Sits between local training and aggregation.  Each round every node:

  1. measures its drift ||w_i - w^last_sent|| and decides whether to
     transmit (trigger module; threshold 0 = always send),
  2. if transmitting, encodes its payload — delta codecs (int8, top-k)
     compress the drift plus the carried error-feedback residual, dense
     codecs (fp32, bf16) the model itself,
  3. receivers decode first and aggregate second, so DecDiff's Eq. 5-6
     act on the reconstructed models ŵ_j.

`GossipTransport` — per-NODE state: one `last_sent[j]` [N, D] doubles as
sender j's trigger reference and every receiver's cached copy of j, one
residual per node; a node encodes once and broadcasts on all its edges.

`EdgeGossipTransport` — per-EDGE state in the padded-neighbour layout
`[N, max_deg, ...]`: each directed link (i -> nbr_idx[i, d]) keeps its own
reference, residual, threshold and drift EMA, and state advances only on
links that delivered, so a failed link leaves every other link's state
bit-identical.  Receivers read sender j's slot toward them through the
reverse-slot map, one row gather over the flattened [N·max_deg, D] table
(`repro_torch.kernels.ops.gather_rows`, the CUDA kernel on the card).

`SparseEdgeGossipTransport` — the same per-edge state over the sparse
layout's flat CSR edge list, `[E, ...]`: a directed edge id is both the
sender's and the receiver's address of its link, so there is no layout
swap and no reverse gather.  The per-node `GossipTransport` takes either
layout for its per-edge delivery history.

Every tensor lives on the device of the params the transport was built
with; the exchange syncs nothing.  Randomness comes from the
`torch.Generator` passed to `exchange` (only when `wants_rng`: a
stochastic int8 codec): the per-node transport draws one uniform row per
node, the per-edge transports one row per canonical CSR directed edge (the
dense one indexes those rows by `edge_id`, the sparse one by identity), so
stochastic int8 is bitwise equal across the two layouts.

Every exchange runs for the caller's block of sender rows under a
:class:`PodContext`: `rows` slices a replicated [N, ...] quantity to the
block, `gather` assembles the full [N, ...] axis from every pod's block
(`DENSE_CTX`: one block of all N rows, both the identity).  Sender-private
state (residuals, per-edge thresholds and drift EMAs) holds the block's
rows; receiver-facing caches (`last_sent`, the ever-sent / ever-delivered
flags) are replicated and advanced identically on every pod from the
gathered wire (`state_specs` says which is which).  `wire` ("encoded" |
"decoded") is what the gather carries: the codec payload, decoded after
the gather, or the decoded rows.  Decoding is deterministic, so the two
wires are bitwise equal.  Random draws are made over the full node (or
edge) axis on every pod from the same generator and then sliced to the
block, so a block draws exactly the values the dense context draws.

Accounting is exact and static: `payload_bytes` is the serialized size of
one payload (`codec.payload_bytes_for`); bytes per round = payload_bytes x
fired edges — per node Σ_i gate_i·outdeg_i, per edge Σ_ij gate_ij.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.comm.codecs import Codec, make_codec
from repro_torch.comm.trigger import (
    adaptive_threshold_update,
    drift_gate,
    edge_drift_gate,
)
from repro_torch.kernels.ops import gather_rows
from repro_torch.utils.pytree import tree_flatten_stacked

POLICIES = ("fixed", "adaptive")
WIRES = ("encoded", "decoded")


class PodContext(NamedTuple):
    """Where the caller's block of sender rows sits in the full node axis.

    ``rows``   maps a replicated [N, ...] quantity to the caller's [R, ...]
               block (identity when the caller holds all rows);
    ``gather`` maps the caller's [R, ...] block to the full [N, ...] axis
               (the pod backend's tiled all-gather over the mesh's "pod"
               dimension; identity on the dense path);
    ``pod``    the caller's block index along the pod dimension (None on
               the single-block path).
    """

    rows: Callable
    gather: Callable
    pod: Optional[int] = None


def _identity(a):
    return a


#: The dense (single-block) context: R == N, nothing moves.
DENSE_CTX = PodContext(rows=_identity, gather=_identity)


def _gather_into(out: torch.Tensor, inp: torch.Tensor, group) -> None:
    # torch 2.13 renamed all_gather_into_tensor (which now warns)
    fn = getattr(dist, "all_gather_single", None) \
        or dist.all_gather_into_tensor
    fn(out, inp, group=group)


def all_gather_rows(a: torch.Tensor, group, n_pods: int) -> torch.Tensor:
    """Tiled all-gather over the pod group: every pod's [R, ...] block,
    concatenated in pod order -> [P·R, ...].  The block moves as bytes (a
    uint8 view of its last dimension), so every dtype — int8 payloads,
    bf16 casts, fp32 rows, int64 indices — takes one path.  Over gloo a
    CUDA block is staged through host memory (the gloo lane of several
    ranks on one card: its times are not a multi-GPU number)."""
    if a.dim() == 0:
        raise ValueError("all_gather_rows gathers [R, ...] blocks, not "
                         "scalars")
    a = a.contiguous()
    raw = a.view(torch.uint8)
    host = a.is_cuda and dist.get_backend(group) == "gloo"
    src = raw.cpu() if host else raw
    out = torch.empty((n_pods * src.shape[0],) + tuple(src.shape[1:]),
                      dtype=torch.uint8, device=src.device)
    _gather_into(out, src, group)
    if host:
        out = out.to(a.device)
    return out.view(a.dtype).reshape((n_pods * a.shape[0],)
                                     + tuple(a.shape[1:]))


def pod_context(n: int, n_pods: int, pod: int, group) -> PodContext:
    """The context of block `pod` of `n_pods` equal blocks of the n-node
    axis: rows are a slice, the gather is `all_gather_rows` over `group`
    (the identity for a one-pod mesh without a group)."""
    if n % n_pods:
        raise ValueError(f"{n} DFL nodes do not tile the {n_pods}-pod axis")
    per_pod = n // n_pods
    i0 = pod * per_pod

    def rows(a):
        return a[i0:i0 + per_pod]

    if group is None:
        if n_pods != 1:
            raise ValueError(f"a {n_pods}-pod context needs a process "
                             f"group")
        gather = _identity
    else:
        def gather(a):
            return all_gather_rows(a, group, n_pods)

    return PodContext(rows=rows, gather=gather, pod=pod)


def pod_mean(ctx: PodContext, loss: torch.Tensor) -> torch.Tensor:
    """The mean over the pods of each pod's scalar `loss`, gathered in pod
    order, so every rank holds the same value (the loss itself when the
    context is one block)."""
    return torch.mean(ctx.gather(loss.reshape(1)))


def _gather_tree(ctx: PodContext, payload):
    """`ctx.gather` over every leaf of a codec payload dict."""
    return {k: ctx.gather(v) for k, v in payload.items()}


@dataclasses.dataclass(frozen=True)
class CommConfig:
    """Transport knobs, carried on Experiment(comm=...).

    codec: "fp32" | "bf16" | "int8" | "topk".
    trigger_threshold: L2 drift below which a sender stays silent (0 =
      always send).  Used by the "fixed" policy.
    policy: "fixed" (one scalar threshold) or "adaptive" (per-edge
      drift-rate-controlled thresholds; implies per-edge state).
    per_edge: keep transport state per directed link instead of per node.
    target_trigger: the adaptive policy's per-edge long-run triggered
      fraction, in (0, 1].
    drift_ema_beta: decay of the per-edge drift EMA.
    threshold_rate: adaptive controller gain.
    topk_ratio / topk_momentum: the top-k codec's knobs.
    stochastic: int8 rounding mode (True = unbiased stochastic rounding).
    on_silence: what receivers aggregate for a neighbour that did not fire:
      "stale" (its cached last-transmitted model) or "drop" (mask it out
      like a failed link).  Exogenous link failures always drop.
    """

    codec: str = "fp32"
    trigger_threshold: float = 0.0
    policy: str = "fixed"
    per_edge: bool = False
    target_trigger: float = 0.5
    drift_ema_beta: float = 0.9
    threshold_rate: float = 0.5
    topk_ratio: float = 0.01
    topk_momentum: float = 0.0
    stochastic: bool = True
    on_silence: str = "stale"

    def __post_init__(self):
        if self.on_silence not in ("stale", "drop"):
            raise ValueError(f"on_silence must be 'stale' or 'drop', "
                             f"got {self.on_silence!r}")
        if self.policy not in POLICIES:
            raise ValueError(f"policy must be one of {POLICIES}, "
                             f"got {self.policy!r}")
        if self.policy == "adaptive" and not (0.0 < self.target_trigger <= 1.0):
            raise ValueError(f"target_trigger must be in (0, 1], "
                             f"got {self.target_trigger}")

    @property
    def use_per_edge(self) -> bool:
        """Per-edge state is explicit (`per_edge`) or implied by the
        adaptive policy (per-edge thresholds need per-edge references)."""
        return self.per_edge or self.policy == "adaptive"

    def make_codec(self) -> Codec:
        kwargs = {}
        if self.codec == "topk":
            kwargs["ratio"] = self.topk_ratio
            if self.topk_momentum > 0:
                kwargs["momentum"] = self.topk_momentum
        if self.codec == "int8":
            kwargs["stochastic"] = self.stochastic
        return make_codec(self.codec, **kwargs)


class CommState(NamedTuple):
    """Per-node transport state.  `ever_recv` is the per-EDGE delivery
    history in the engine's layout, [N, max_deg] padded or [E] over the CSR
    edge list (None without an edge layout): the `on_silence="stale"` mask
    consults it, so a receiver never aggregates a cache that no payload
    ever filled."""

    last_sent: torch.Tensor            # [N, D] last reconstruction on the wire
    residual: Optional[torch.Tensor]   # [N, ...] EF residual (None if stateless)
    ever_sent: torch.Tensor            # [N] {0,1}: has node i transmitted yet?
    ever_recv: Optional[torch.Tensor] = None  # [N, max_deg] or [E] {0,1}


class EdgeCommState(NamedTuple):
    """Per-EDGE transport state, `[N, max_deg, ...]`: slot d of node i is
    the directed link i -> nbr_idx[i, d]; padding slots never fire."""

    last_sent: torch.Tensor            # [N, E, D] per-link reconstruction ref
    residual: Optional[torch.Tensor]   # [N, E, ...] per-link EF residual
    threshold: torch.Tensor            # [N, E] per-link trigger thresholds
    drift_ema: torch.Tensor            # [N, E] per-link drift EMA (adaptive)
    ever_delivered: torch.Tensor       # [N, E] {0,1}: link ever delivered?


def _check_wire(wire: str):
    if wire not in WIRES:
        raise ValueError(f"wire must be one of {WIRES}, got {wire!r}")


def _wants_rng(codec: Codec) -> bool:
    return codec.needs_rng and getattr(codec, "stochastic", True)


def reverse_slot_map(nbr_idx: np.ndarray) -> np.ndarray:
    """rev[r, e] = the slot d with nbr_idx[j, d] == r for j = nbr_idx[r, e]
    (0 on padding slots, where nbr_idx < 0).  Raises if the layout is not
    symmetric: per-edge state needs an undirected graph."""
    idx = np.asarray(nbr_idx, np.int64)
    n, e = idx.shape
    rev = np.zeros((n, e), np.int64)
    for r in range(n):
        for s in range(e):
            j = idx[r, s]
            if j < 0:
                continue
            (slots,) = np.nonzero(idx[j] == r)
            if slots.size == 0:
                raise ValueError(
                    f"neighbour layout not symmetric: {r} lists {j} but "
                    f"{j} does not list {r} — per-edge state needs an "
                    f"undirected graph")
            rev[r, s] = int(slots[0])
    return rev


class GossipTransport:
    """Flatten -> trigger -> encode -> decode, with per-node state.

    Pass `nbr_idx` / `nbr_valid` (the padded [N, max_deg] panels) on the
    dense layout, or `edge_src` / `edge_dst` (the CSR directed edge list)
    on the sparse one, to give the transport its per-edge delivery history
    (`CommState.ever_recv`); without either `ever_recv` stays None."""

    def __init__(self, config: CommConfig, stacked_params, *,
                 nbr_idx=None, nbr_valid=None, edge_src=None, edge_dst=None):
        self.config = config
        self.codec = config.make_codec()
        mat, _ = tree_flatten_stacked(stacked_params)
        self.n, self.d = int(mat.shape[0]), int(mat.shape[1])
        self.device = mat.device
        # exact serialized payload size for ONE node's transmission
        self.payload_bytes = self.codec.payload_bytes_for(self.d)
        self.wants_rng = _wants_rng(self.codec)
        self._recv_idx = self._recv_valid = None
        self._edge_src = self._edge_dst = None
        self._recv_shape = None
        if nbr_idx is not None:
            idx = np.maximum(np.asarray(nbr_idx, np.int64), 0)
            self._recv_idx = torch.from_numpy(idx).to(self.device)
            self._recv_valid = torch.from_numpy(
                np.asarray(nbr_valid, np.float32)).to(self.device)
            self._recv_shape = tuple(idx.shape)
        elif edge_src is not None:
            self._edge_src = torch.from_numpy(
                np.asarray(edge_src, np.int64)).to(self.device)
            self._edge_dst = torch.from_numpy(
                np.asarray(edge_dst, np.int64)).to(self.device)
            self._recv_shape = tuple(self._edge_src.shape)

    def init_state(self, stacked_params) -> CommState:
        mat, _ = tree_flatten_stacked(stacked_params)
        ever_recv = (torch.zeros(self._recv_shape, dtype=torch.float32,
                                 device=self.device)
                     if self._recv_shape is not None else None)
        # zero reference: the first transmission carries the full model
        # through the codec, so receivers need no out-of-band bootstrap.
        return CommState(
            last_sent=torch.zeros_like(mat),
            residual=self.codec.init_residual(mat),
            ever_sent=torch.zeros((self.n,), dtype=torch.float32,
                                  device=self.device),
            ever_recv=ever_recv)

    def state_specs(self, shard, rep) -> CommState:
        """The layout of init_state's fields over the pod backend:
        replicated receiver-facing caches, sharded sender-private residual
        rows (`shard` / `rep` are the caller's markers)."""
        return CommState(
            last_sent=rep,
            residual=shard if self.codec.has_residual else None,
            ever_sent=rep,
            ever_recv=rep if self._recv_shape is not None else None)

    def note_delivery(self, state: CommState, delivered) -> CommState:
        """Fold one round's realized deliveries ([N, max_deg] or [E] {0,1}
        in the bound layout: trigger AND link) into the per-edge delivery
        history."""
        if state.ever_recv is None:
            return state
        return state._replace(
            ever_recv=torch.maximum(state.ever_recv, delivered))

    def reset_rows(self, state: CommState, reset,
                   ctx: PodContext = DENSE_CTX) -> CommState:
        """Rows where `reset` ([N] {0,1}) > 0 return to the zero bootstrap
        (reference, residual, ever_sent cleared; every edge incident to a
        reset node loses its delivery history).  Other rows stay
        bit-identical.  The residual holds the block's rows."""
        r = reset > 0
        residual = state.residual
        if residual is not None:
            rr = ctx.rows(reset) > 0
            rb = rr.reshape(rr.shape + (1,) * (residual.dim() - 1))
            residual = torch.where(rb, 0.0, residual)
        ever_recv = state.ever_recv
        if ever_recv is not None:
            if self._recv_idx is not None:
                clear = torch.maximum(reset[:, None],
                                      reset[self._recv_idx]) \
                    * self._recv_valid
            else:
                clear = torch.maximum(reset[self._edge_src],
                                      reset[self._edge_dst])
            ever_recv = torch.where(clear > 0, 0.0, ever_recv)
        return CommState(
            last_sent=torch.where(r[:, None], 0.0, state.last_sent),
            residual=residual,
            ever_sent=torch.where(r, 0.0, state.ever_sent),
            ever_recv=ever_recv)

    def exchange(self, stacked_params, state: CommState,
                 rng: Optional[torch.Generator] = None, send_mask=None, *,
                 ctx: PodContext = DENSE_CTX, wire: str = "encoded"):
        """One transport round for the caller's block of sender rows.

        stacked_params: the block's models, leaves [R, ...]; rng: the
        generator the codec draws from (required iff `wants_rng`; one
        uniform row per node over the full axis, sliced to the block);
        send_mask: optional [R] {0,1} sender veto; ctx: the block's
        PodContext; wire: what its gather carries (module docstring).

        Returns (decoded [N, D], gate_full [N], new_state): for each sender
        the flat model its neighbours reconstruct this round (a silent
        node's row holds its previous reconstruction), who transmitted,
        and the threaded CommState (`ever_recv` is folded in afterwards by
        `note_delivery`, since only the engine knows the link mask).  The
        reference returns `decoded` as a params tree; its only caller
        flattens it again, so the port hands over the flat matrix."""
        _check_wire(wire)
        codec = self.codec
        w, _ = tree_flatten_stacked(stacked_params)
        r = int(w.shape[0])
        if self.wants_rng and rng is None:
            raise ValueError(f"codec {codec.name!r} needs a torch.Generator")
        last_full = state.last_sent
        last = ctx.rows(last_full)
        gate, _ = drift_gate(w, last, self.config.trigger_threshold)
        if send_mask is not None:
            gate = gate * send_mask
        x = w - last if codec.is_delta else w
        u = (ctx.rows(torch.rand((self.n, self.d), generator=rng,
                                 device=self.device))
             if self.wants_rng else None)
        payload, new_res = codec.encode(x, rng=u, residual=state.residual)
        if wire == "encoded":
            dec_full = codec.decode(_gather_tree(ctx, payload),
                                    out_size=self.d)
        else:
            dec_full = ctx.gather(codec.decode(payload, out_size=self.d))
        del payload
        gate_full = ctx.gather(gate)
        recon = last_full + dec_full if codec.is_delta else dec_full
        new_last = torch.where(gate_full[:, None] > 0, recon, last_full)
        if codec.has_residual:
            # a silent node keeps accumulating: its un-flushed residual
            # stays put until the trigger fires again.
            keep = gate.reshape((r,) + (1,) * (new_res.dim() - 1)) > 0
            new_res = torch.where(keep, new_res, state.residual)
        new_state = CommState(
            last_sent=new_last, residual=new_res,
            ever_sent=torch.maximum(state.ever_sent, gate_full),
            ever_recv=state.ever_recv)
        return new_last, gate_full, new_state


class EdgeGossipTransport:
    """Per-edge transport: one (reference, residual, threshold) per link.

    Construction takes the padded-neighbour layout (`nbr_idx` [N, E] int
    with -1 padding, `nbr_valid` [N, E] {0,1}) and builds, once, in numpy:
    the reverse-slot map `rev_slot` (receiver r hearing neighbour j at slot
    e reads j's state at slot rev_slot[r, e]), the canonical CSR edge id
    `edge_id` of every sender slot, and the flat gather index
    `flat_idx = nbr_idx·E + rev_slot` into the [N·E, D] per-link table,
    range-checked here so the per-round gather needs no check."""

    def __init__(self, config: CommConfig, stacked_params,
                 nbr_idx: np.ndarray, nbr_valid: np.ndarray):
        self.config = config
        self.codec = config.make_codec()
        mat, _ = tree_flatten_stacked(stacked_params)
        self.n, self.d = int(mat.shape[0]), int(mat.shape[1])
        self.device = dev = mat.device
        self.e = int(nbr_idx.shape[1])
        self.payload_bytes = self.codec.payload_bytes_for(self.d)
        self.wants_rng = _wants_rng(self.codec)

        idx = np.asarray(nbr_idx, np.int64)
        valid = np.asarray(nbr_valid, np.float32)
        rev = reverse_slot_map(idx)
        idx0 = np.maximum(idx, 0)
        self.nbr_idx = torch.from_numpy(idx0).to(dev)
        self.nbr_valid = torch.from_numpy(valid).to(dev)
        self.rev_slot = torch.from_numpy(rev).to(dev)
        self.num_edges = float(valid.sum())  # directed edge count
        # canonical CSR directed-edge id of the link (i -> j) at sender slot
        # (i, d): receiver j's row offset plus i's position among j's
        # senders (the padded lists are sorted, so rev IS that position).
        # Padding slots alias edge 0; their draws never gate an update.
        deg = valid.sum(axis=1).astype(np.int64)
        offsets = np.concatenate([np.zeros(1, np.int64), np.cumsum(deg)])
        self.num_directed = int(deg.sum())
        self.edge_id = torch.from_numpy(offsets[idx0] + rev).to(dev)
        flat = (idx0 * self.e + rev).reshape(-1)
        if flat.size and not (0 <= flat.min() and flat.max() < self.n * self.e):
            raise ValueError("reverse-slot gather index out of range")
        self.flat_idx = torch.from_numpy(flat).to(dev)
        # the threshold an edge (re)starts from: the scalar for the fixed
        # policy, the always-send bootstrap for the adaptive one
        self.thr0 = (config.trigger_threshold if config.policy == "fixed"
                     else 0.0)

    def init_state(self, stacked_params) -> EdgeCommState:
        shape = (self.n, self.e)
        zeros = torch.zeros(shape + (self.d,), dtype=torch.float32,
                            device=self.device)
        return EdgeCommState(
            last_sent=zeros,
            residual=self.codec.init_residual(zeros),
            threshold=torch.full(shape, self.thr0, dtype=torch.float32,
                                 device=self.device),
            drift_ema=torch.zeros(shape, dtype=torch.float32,
                                  device=self.device),
            ever_delivered=torch.zeros(shape, dtype=torch.float32,
                                       device=self.device))

    def state_specs(self, shard, rep) -> EdgeCommState:
        """The layout of init_state's fields over the pod backend:
        replicated receiver-facing caches (the per-link references the
        reverse-slot gather reads, the delivery history), sharded
        sender-private controller rows."""
        return EdgeCommState(
            last_sent=rep,
            residual=shard if self.codec.has_residual else None,
            threshold=shard,
            drift_ema=shard,
            ever_delivered=rep)

    def reset_edges(self, state: EdgeCommState, reset,
                    ctx: PodContext = DENSE_CTX) -> EdgeCommState:
        """Per-link state on edges where `reset` [N, E] > 0 returns to its
        init_state values (a rejoined endpoint is a fresh device); other
        edges stay bit-identical.  The controller rows are the block's."""
        r = reset > 0
        rr = ctx.rows(reset) > 0
        residual = state.residual
        if residual is not None:
            rb = rr.reshape(rr.shape + (1,) * (residual.dim() - 2))
            residual = torch.where(rb, 0.0, residual)
        return EdgeCommState(
            last_sent=torch.where(r[:, :, None], 0.0, state.last_sent),
            residual=residual,
            threshold=torch.where(rr, self.thr0, state.threshold),
            drift_ema=torch.where(rr, 0.0, state.drift_ema),
            ever_delivered=torch.where(r, 0.0, state.ever_delivered))

    def _swap_layout(self, arr):
        """Swap an [N, E, ...] array between the sender and receiver edge
        layouts (an involution on valid slots): entry (i, e) reads the
        other endpoint's slot for the same link, nbr_idx[i, e] at
        rev_slot[i, e]."""
        return arr[self.nbr_idx, self.rev_slot]

    def recv_layout(self, arr):
        """Receiver-layout view of a sender-layout [N, E] panel, zeroed on
        padding slots: entry (r, e) is the sender's value for the link
        (nbr_idx[r, e] -> r)."""
        return self._swap_layout(arr) * self.nbr_valid

    def _gather_receiver_rows(self, new_last, rows):
        """The reverse-slot gather: the block's receiver r's slot e reads
        sender nbr_idx[r, e]'s reference at slot rev_slot[r, e] out of the
        flattened, replicated [N·E, D] per-link table -> [R, E, D]."""
        tbl = new_last.reshape(self.n * self.e, self.d)
        idx = rows(self.flat_idx.reshape(self.n, self.e))
        r = int(idx.shape[0])
        return gather_rows(tbl, idx.reshape(-1)).reshape(r, self.e, self.d)

    def exchange(self, stacked_params, state: EdgeCommState, link_mask,
                 rng: Optional[torch.Generator] = None, live=None,
                 reset=None, *, ctx: PodContext = DENSE_CTX,
                 wire: str = "encoded"):
        """One per-edge transport round for the caller's block of rows.

        stacked_params: the block's models, leaves [R, ...].  link_mask:
        FULL [N, E] receiver-layout exogenous link mask (1 = the
        (nbr_idx[r, e] -> r) link is up; validity included): the
        link-layer ack reaches the sender through the layout swap, which
        crosses rows.  rng: the generator the codec draws from (iff
        `wants_rng`).  live: optional FULL [N, E] symmetric live-edge mask
        — a dead edge cannot fire, costs nothing and freezes its
        controller.  reset: optional FULL [N, E] edges returned to
        bootstrap before the drift is measured.  ctx / wire: see the
        module docstring.

        Returns (gathered [R, E, D], agg_mask [R, E], gate_full [N, E],
        new_state): slot e of block row r holds r's current reconstruction
        of neighbour nbr_idx[r, e] (fresh if delivered this round, the
        per-link cache otherwise), the receiver-layout aggregation mask per
        `on_silence`, the sender-layout fired edges (replicated), and the
        threaded state.  The reference returns `gathered` as a params tree
        with leaves [R, E, ...]; the port hands over the flat panel its
        only caller reduces."""
        _check_wire(wire)
        codec, cfg = self.codec, self.config
        rows = ctx.rows
        w, _ = tree_flatten_stacked(stacked_params)
        r = int(w.shape[0])
        if reset is not None:
            state = self.reset_edges(state, reset, ctx=ctx)
        valid_full = (self.nbr_valid if live is None
                      else self.nbr_valid * live)
        valid = rows(valid_full)
        last_full = state.last_sent
        last = rows(last_full)
        gate, drift = edge_drift_gate(w, last, state.threshold, valid)
        # link-layer ack: a payload advances its edge's state only if the
        # edge fired AND the link stayed up (sender layout; the swap
        # crosses rows, so it runs on the full mask).
        sender_link_full = self._swap_layout(link_mask)
        delivered = gate * rows(sender_link_full)

        x = (w[:, None, :] - last if codec.is_delta
             else w[:, None, :].expand(last.shape))
        if self.wants_rng:
            if rng is None:
                raise ValueError(
                    f"codec {codec.name!r} needs a torch.Generator")
            # one uniform row per CANONICAL directed edge, indexed by slot
            u = torch.rand((max(self.num_directed, 1), self.d),
                           generator=rng,
                           device=self.device)[rows(self.edge_id)]
        else:
            u = None
        payload, enc_res = codec.encode(x, rng=u, residual=state.residual)
        del x, u
        if wire == "encoded":
            dec_full = codec.decode(_gather_tree(ctx, payload),
                                    out_size=self.d)
        else:
            dec_full = ctx.gather(codec.decode(payload, out_size=self.d))
        del payload
        gate_full = ctx.gather(gate)
        delivered_full = gate_full * sender_link_full

        recon = last_full + dec_full if codec.is_delta else dec_full
        del dec_full
        new_last = torch.where(delivered_full[:, :, None] > 0, recon,
                               last_full)
        del recon
        if codec.has_residual:
            # the EF residual tracks DELIVERED information only: a dropped
            # or silent link keeps its residual bit-identical.
            keep = delivered.reshape(
                (r, self.e) + (1,) * (enc_res.dim() - 2)) > 0
            new_res = torch.where(keep, enc_res, state.residual)
        else:
            new_res = None

        if cfg.policy == "adaptive":
            new_thr, new_ema = adaptive_threshold_update(
                state.threshold, state.drift_ema, drift, gate, valid,
                target=cfg.target_trigger, ema_beta=cfg.drift_ema_beta,
                rate=cfg.threshold_rate)
        else:
            new_thr, new_ema = state.threshold, state.drift_ema
        ever = torch.maximum(state.ever_delivered, delivered_full)
        new_state = EdgeCommState(last_sent=new_last, residual=new_res,
                                  threshold=new_thr, drift_ema=new_ema,
                                  ever_delivered=ever)

        # receiver view: slot e of block row r is sender j's edge state
        # toward r, the reverse-slot gather out of the replicated table
        gathered = self._gather_receiver_rows(new_last, rows)
        if cfg.on_silence == "drop":
            agg_mask = rows(link_mask * self._swap_layout(gate_full))
        else:
            # stale: aggregate the per-link cache, masking only links that
            # never delivered; exogenous failures still drop.
            agg_mask = rows(link_mask * self._swap_layout(ever))
        return gathered, agg_mask, gate_full, new_state


class SparseEdgeCommState(NamedTuple):
    """Per-edge transport state over the flat [E] CSR edge list: entry e is
    the directed link edge_src[e] -> edge_dst[e] of a
    :class:`~repro_torch.graphs.SparseTopology` — the dense layout's
    [N, max_deg] panels with the padding removed."""

    last_sent: torch.Tensor            # [E, D] per-link reconstruction ref
    residual: Optional[torch.Tensor]   # [E, ...] per-link EF residual
    threshold: torch.Tensor            # [E] per-link trigger thresholds
    drift_ema: torch.Tensor            # [E] per-link drift EMA (adaptive)
    ever_delivered: torch.Tensor       # [E] {0,1}: link ever delivered?


class SparseEdgeGossipTransport:
    """Per-edge transport over a flat CSR edge list, with no layout swap.

    The dense :class:`EdgeGossipTransport` keys state by (sender, slot) and
    needs two index maps per round: the reverse-slot swap (sender acks
    from the receiver-layout link mask) and the reverse-slot gather
    (receivers read each sender's per-link reference).  In the CSR edge
    list a directed edge id is both the sender's and the receiver's
    address of one link: its gate, delivery, aggregation mask and
    reconstruction all live at position e, and receiver i's neighbour
    models are `last_sent[row_offsets[i]:row_offsets[i+1]]`, the CSR row
    the SparseNeighborhood buckets enumerate (`WidthBucket.epos`).  Under
    a dynamics process the exchange takes the dense twin's `live` and
    `reset` options over the [E] list, and `reset_edges` returns a
    rejoined node's links to bootstrap.

    Bitwise equal to the dense twin by construction: the same elementwise
    gate, controller and codec per link, the uniforms drawn as the same
    [E, D] block of canonical-edge rows, and every mask a product of exact
    {0,1} floats."""

    def __init__(self, config: CommConfig, stacked_params, st):
        self.config = config
        self.codec = config.make_codec()
        mat, _ = tree_flatten_stacked(stacked_params)
        self.d = int(mat.shape[1])
        self.device = dev = mat.device
        self.e_dir = int(st.num_directed)
        self.payload_bytes = self.codec.payload_bytes_for(self.d)
        self.wants_rng = _wants_rng(self.codec)
        self.edge_src = torch.from_numpy(
            st.edge_src.astype(np.int64)).to(dev)
        self.num_edges = float(self.e_dir)  # directed edge count
        # the threshold an edge (re)starts from, as EdgeGossipTransport.thr0
        self.thr0 = (config.trigger_threshold if config.policy == "fixed"
                     else 0.0)

    def init_state(self, stacked_params) -> SparseEdgeCommState:
        zeros = torch.zeros((self.e_dir, self.d), dtype=torch.float32,
                            device=self.device)
        vec = torch.zeros((self.e_dir,), dtype=torch.float32,
                          device=self.device)
        return SparseEdgeCommState(
            last_sent=zeros,
            residual=self.codec.init_residual(zeros),
            threshold=torch.full((self.e_dir,), self.thr0,
                                 dtype=torch.float32, device=self.device),
            drift_ema=vec, ever_delivered=vec.clone())

    def state_specs(self, shard, rep) -> SparseEdgeCommState:
        """All replicated: the edge axis does not tile the node-axis pod
        mesh, and every pod recomputes the full-edge update from the
        gathered model rows deterministically."""
        del shard
        return SparseEdgeCommState(
            last_sent=rep,
            residual=rep if self.codec.has_residual else None,
            threshold=rep, drift_ema=rep, ever_delivered=rep)

    def reset_edges(self, state: SparseEdgeCommState,
                    reset) -> SparseEdgeCommState:
        """Edges where `reset` [E] > 0 return to their init_state values
        (reference, residual, threshold, drift EMA and delivery history),
        as EdgeGossipTransport.reset_edges; other edges stay
        bit-identical.  The engine raises `reset` on both directed records
        of every link incident to a rejoined node."""
        r = reset > 0
        residual = state.residual
        if residual is not None:
            rb = r.reshape(r.shape + (1,) * (residual.dim() - 1))
            residual = torch.where(rb, 0.0, residual)
        return SparseEdgeCommState(
            last_sent=torch.where(r[:, None], 0.0, state.last_sent),
            residual=residual,
            threshold=torch.where(r, self.thr0, state.threshold),
            drift_ema=torch.where(r, 0.0, state.drift_ema),
            ever_delivered=torch.where(r, 0.0, state.ever_delivered))

    def exchange(self, stacked_params, state: SparseEdgeCommState, link_mask,
                 rng: Optional[torch.Generator] = None, live=None,
                 reset=None, *, ctx: PodContext = DENSE_CTX,
                 wire: str = "encoded"):
        """One per-edge transport round over the flat edge list.

        The block's model rows [R, D] are gathered to the full [N, D]
        first (`ctx.gather`, the only movement between pods); the state is
        replicated and every pod runs the full-edge update, so `wire` does
        not change what crosses pods here (accepted for the dense
        transport's signature).

        link_mask: [E] {0,1} per-directed-edge link mask (the engine folds
        the participation draws, and under dynamics the live and arrival
        masks, into it).  rng: the generator the codec draws from (iff
        `wants_rng`): one uniform row per canonical edge, the rows the
        dense per-edge transport indexes by `edge_id`.  live: optional [E]
        {0,1} live-edge mask: a dead edge cannot fire, costs nothing and
        freezes its controller (unlike a `link_mask` failure, which the
        sender pays for).  reset: optional [E] {0,1} edges returned to
        bootstrap before the drift is measured (`reset_edges`).

        Returns (edge_table [E, D], agg_mask [E], gate [E], new_state):
        entry e of the table is what edge e's receiver holds for its sender
        (fresh if delivered this round, the per-link cache otherwise) —
        feed it to SparseNeighborhood(edge_table=...) —, the receiver's
        aggregation mask per `on_silence`, the fired edges, and the
        threaded state."""
        _check_wire(wire)
        codec, cfg = self.codec, self.config
        w = ctx.gather(tree_flatten_stacked(stacked_params)[0])
        if reset is not None:
            state = self.reset_edges(state, reset)
        valid = (torch.ones((self.e_dir,), dtype=torch.float32,
                            device=self.device) if live is None else live)
        last = state.last_sent
        # each [E, D] temporary below is freed as soon as it is used: at
        # full width one is 2.3 GB (1,016 edges x 567,434 params)
        x = w[self.edge_src]  # [E, D] each edge's sender row, a new tensor
        # the dense layout's elementwise gate, on [E, 1] panels
        g2, d2 = edge_drift_gate(x, last[:, None, :],
                                 state.threshold[:, None], valid[:, None])
        gate, drift = g2[:, 0], d2[:, 0]
        # link-layer ack: the edge id is the sender's address too, so the
        # dense layout's reverse-slot swap is the identity here
        delivered = gate * link_mask
        if codec.is_delta:
            x.sub_(last)
        if self.wants_rng:
            if rng is None:
                raise ValueError(
                    f"codec {codec.name!r} needs a torch.Generator")
            u = torch.rand((max(self.e_dir, 1), self.d), generator=rng,
                           device=self.device)[:self.e_dir]
        else:
            u = None
        payload, enc_res = codec.encode(x, rng=u, residual=state.residual)
        del x, u
        dec = codec.decode(payload, out_size=self.d)
        del payload
        recon = last + dec if codec.is_delta else dec
        del dec
        new_last = torch.where(delivered[:, None] > 0, recon, last)
        del recon
        if codec.has_residual:
            # the EF residual tracks DELIVERED information only
            keep = delivered.reshape(
                (self.e_dir,) + (1,) * (enc_res.dim() - 1)) > 0
            new_res = torch.where(keep, enc_res, state.residual)
        else:
            new_res = None
        del enc_res

        if cfg.policy == "adaptive":
            new_thr, new_ema = adaptive_threshold_update(
                state.threshold, state.drift_ema, drift, gate, valid,
                target=cfg.target_trigger, ema_beta=cfg.drift_ema_beta,
                rate=cfg.threshold_rate)
        else:
            new_thr, new_ema = state.threshold, state.drift_ema
        ever = torch.maximum(state.ever_delivered, delivered)
        new_state = SparseEdgeCommState(
            last_sent=new_last, residual=new_res, threshold=new_thr,
            drift_ema=new_ema, ever_delivered=ever)
        if cfg.on_silence == "drop":
            agg_mask = link_mask * gate
        else:
            agg_mask = link_mask * ever
        return new_last, agg_mask, gate, new_state


def codec_roundtrip_stacked(codec: Codec, stacked,
                            rng: Optional[torch.Generator] = None):
    """Reference-free encode->decode of stacked [N, ...] models: delta
    codecs compress against the implicit zero reference.  Returns the
    decoded stacked params tree."""
    w, unflatten = tree_flatten_stacked(stacked)
    wants = _wants_rng(codec) and rng is not None
    payload, _ = codec.encode(w, rng=rng if wants else None)
    return unflatten(codec.decode(payload, out_size=int(w.shape[1])))
