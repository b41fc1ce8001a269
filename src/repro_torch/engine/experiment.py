"""`Experiment`: the front door for decentralized-learning runs.

    Experiment(World.synthetic(...), "decdiff+vt").run()

packages the paper's procedure — heterogeneous per-node init, B local
SGD(momentum) steps, neighbour exchange, method aggregation, periodic
evaluation — behind one object, as the JAX package's `repro.engine` does.
Two backends run one round body: `vmap` (every node in one process) and
`shard_map` (one block of N / P nodes per pod of a `torch.distributed`
mesh with a "pod" dimension, `mesh=`; the default mesh is one pod per
rank of the default process group, or one pod without a group), bitwise
equal to each other.  Both run on both node-axis layouts — the dense
padded [N, max_deg] panels (the small-N oracle) and the sparse CSR edge
list (O(N + E) state, past the dense layout's 4096-node guard) — with or
without the gossip transport (`comm=CommConfig(...)`: codecs, event
triggers, per-node or per-edge state, exact bytes on the wire; `wire=`
names what the pod backend's all-gather carries).  The layout follows the
topology's type (`Topology` or `SparseTopology`) unless `layout=` says
otherwise; the two are bitwise equal at participation 1.  Every method of
the roster runs, the FedAvg server and CFA-GE's gradient exchange
included, over either Table I model: the MLP (MNIST) or the CNN (Fashion,
and EMNIST with dropout, whose keep masks come from the experiment's
generator).  `World(dynamics=...)` makes the graph time-varying (a
`repro_torch.dynamics.GraphProcess`: edge dropout, bursty links, churn,
rewiring, scripted replay, energy churn), `World(timing=...)` prices each
round in simulated seconds (`repro_torch.timing.Timing`), and
`Schedule(deadline=d)` turns the rounds into deadline ticks.
`World(telemetry=...)` (a `repro_torch.obs.Telemetry`) records per-node and
per-edge channels into `RoundMetrics.detail`, keeps one host snapshot per
round in `obs_history` (what `repro_torch.obs.export_trace` reads), writes
a JSONL run ledger, and can wrap a run in `torch.profiler`;
`run(verbose=True)` logs one line per eval round.

On the pod backend each rank holds its block's params, optimizer state,
data rows and sender-private transport rows; `params`, `opt_state` and
`comm_state` read as the full node axis on every rank (the blocks
gathered: a collective, so every rank reads them together) and take the
full node axis when set.  Histories (accuracy, bytes, trigger, live,
simulated time, telemetry detail) are identical on every rank: evaluation
runs on the block's rows and the [N] results are gathered.  Only rank 0
writes the run ledger, the profiler trace and the verbose line.

Devices: every entry point takes `device=None`, which means "cuda" and
raises on a host without CUDA; tests pass `device="cpu"`.  A World records
its device and an Experiment runs on the same one.

Schedule modes: "loop" reads each round's accounting (bytes and trigger,
live edges, simulated time and arrivals, the telemetry snapshot and, at
eval rounds, its probes) and each eval back to the host as it happens;
"fused" (the default) runs the same rounds and evals with every result
kept on the device, and reads the accounting back in one copy at the end,
then accounts it round by round in the same order.  Both modes run the same
operations in the same order, so they are bitwise equal, bytes on the wire
and simulated seconds included.

Mutable run state (params, optimizer and transport state, the generator,
the byte counters) lives on the instance, so `run()` can be called
repeatedly and continues where the last call stopped (round indices
restart, as in the reference).
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import os
import time as _time
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.comm.transport import (DENSE_CTX, WIRES, CommConfig,
                                        EdgeGossipTransport, GossipTransport,
                                        SparseEdgeGossipTransport,
                                        pod_context)
from repro_torch.core.virtual_teacher import make_loss_fn
from repro_torch.data.allocation import pad_node_datasets
from repro_torch.data.pipeline import Batcher
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.dist.sharding import NODE_AXIS
from repro_torch.dynamics import GraphProcess
from repro_torch.engine import backends
from repro_torch.engine.neighborhood import build_sparse_plan
from repro_torch.engine.strategies import (MethodSpec, available_methods,
                                           get_method)
from repro_torch.fl.metrics import RoundMetrics
from repro_torch.fl.trainer import (generator_keep, make_eval_fn,
                                    make_grad_fn, make_train_step)
from repro_torch.graphs.sparse import SparseTopology
from repro_torch.graphs.topology import Topology
from repro_torch.launch.mesh import OnePodMesh, pod_axis
from repro_torch.models.api import SmallModel
from repro_torch.obs import (RunLedger, Telemetry, log_round, round_record,
                             run_manifest)
from repro_torch.optim.sgd import sgd_momentum
from repro_torch.timing import Timing
from repro_torch.utils.pytree import tree_flatten_stacked, tree_map

SCHEDULE_MODES = ("fused", "loop")
LAYOUTS = ("dense", "sparse")


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Local-training and aggregation hyper-parameters (Alg. 1 knobs)."""

    steps_per_round: int = 4   # B in Alg. 1 (minibatch steps between exchanges)
    batch_size: int = 32
    lr: float = 1e-3
    momentum: float = 0.9
    beta: float = 0.95         # VT confidence (Eq. 7)
    s: float = 1.0             # DecDiff damping (Eq. 5)
    participation: float = 1.0  # per-neighbour delivery probability per round
    seed: int = 0
    eval_batch: int = 128
    # per-node local steps per round drawn from [min, steps_per_round];
    # 0 disables (homogeneous)
    hetero_steps_min: int = 0
    ge_lr: Optional[float] = None  # CFA-GE gradient-apply LR (default: lr)


@dataclasses.dataclass(frozen=True)
class Schedule:
    """How many rounds, how often to eval, and how the rounds execute.

    `deadline` (simulated seconds; requires `World(timing=...)`) turns each
    round into a DEADLINE TICK: a node trains as many local steps as fit
    (at most `steps_per_round`; stragglers train fewer), and a payload is
    aggregated only if `send_time + latency + bytes / bandwidth <=
    deadline`; late arrivals fall into the stale / drop silence paths.
    `deadline=None` keeps the schedule synchronous: every round waits for
    the slowest node and link, and the clock reports the makespan."""

    rounds: int = 100
    eval_every: int = 5
    mode: str = "fused"  # "fused" (read back once) | "loop" (per eval)
    deadline: Optional[float] = None  # simulated seconds per round tick

    def __post_init__(self):
        if self.mode not in SCHEDULE_MODES:
            raise ValueError(f"schedule mode must be one of {SCHEDULE_MODES}, "
                             f"got {self.mode!r}")
        if self.deadline is not None and not self.deadline > 0:
            raise ValueError(f"deadline must be > 0 simulated seconds, "
                             f"got {self.deadline}")

    @staticmethod
    def eval_rounds(rounds: int, eval_every: int):
        """After round 0, every `eval_every` rounds, and after the last."""
        return [r for r in range(rounds)
                if r % eval_every == 0 or r == rounds - 1]


@dataclasses.dataclass
class World:
    """The physical problem: who talks to whom, over what data.

    `topo` is a dense `Topology` (the padded [N, max_deg] layout) or a
    `SparseTopology` (the CSR edge list; an Experiment over it takes the
    sparse layout).  The data stay host-side numpy arrays (per-node train
    shards and the shared test set) until an Experiment moves them to
    `device`.  `dynamics` (a `GraphProcess`) makes "who talks to whom"
    time-varying: `topo` then holds the POSSIBLE links and the process
    decides which exist each round; `timing` (a `Timing`) prices each round
    in simulated seconds; `telemetry` (a `Telemetry`) selects the channels,
    the ledger and the profile directory of `repro_torch.obs`."""

    model: SmallModel
    topo: "Topology | SparseTopology"
    xs: List[np.ndarray]       # per-node train inputs
    ys: List[np.ndarray]       # per-node train labels
    x_test: np.ndarray
    y_test: np.ndarray
    device: DeviceLike = None
    dynamics: Optional[GraphProcess] = None
    timing: Optional[Timing] = None
    telemetry: Optional[Telemetry] = None

    def __post_init__(self):
        self.device = resolve_device(self.device)

    @classmethod
    def synthetic(cls, dataset: str = "synth-mnist", nodes: int = 16,
                  topology: str = "erdos_renyi", seed: int = 0,
                  scale: float = 0.05, min_per_class: int = 1,
                  model: Optional[SmallModel] = None,
                  dynamics=None, timing=None, telemetry=None,
                  device: DeviceLike = None, **topo_kwargs):
        """The paper's synthetic worlds in one call: seeded dataset,
        complex-network topology (extra kwargs go to the graph builder,
        e.g. p=0.25 for ER, m=2 for BA), truncated-Zipf non-IID split."""
        import inspect

        from repro_torch.data.allocation import (split_by_allocation,
                                                 zipf_allocation)
        from repro_torch.data.synth import make_dataset
        from repro_torch.graphs.topology import (TOPOLOGY_BUILDERS,
                                                 make_topology)
        from repro_torch.models.mlp_cnn import model_for_dataset

        device = resolve_device(device)
        ds = make_dataset(dataset, seed=seed, scale=scale)
        builder = TOPOLOGY_BUILDERS.get(topology)
        if builder is not None and \
                "seed" in inspect.signature(builder).parameters:
            topo_kwargs.setdefault("seed", seed)
        topo = make_topology(topology, n=nodes, **topo_kwargs)
        alloc = zipf_allocation(ds.y_train, nodes, seed=seed,
                                min_per_class=min_per_class)
        xs, ys = split_by_allocation(ds.x_train, ds.y_train, alloc)
        model = model or model_for_dataset(dataset, ds.num_classes)
        return cls(model=model, topo=topo, xs=xs, ys=ys, x_test=ds.x_test,
                   y_test=ds.y_test, device=device, dynamics=dynamics,
                   timing=timing, telemetry=telemetry)


def _default_mesh(n: int, device: torch.device):
    """The pod mesh of the default process group, one pod per rank (N must
    tile it); without a process group, the one-pod mesh whose gather is
    the identity (what the JAX package's one-device mesh runs)."""
    if not (dist.is_available() and dist.is_initialized()):
        return OnePodMesh()
    from torch.distributed.device_mesh import init_device_mesh

    p = dist.get_world_size()
    if n % p:
        raise ValueError(f"{n} DFL nodes do not tile the {p}-pod axis")
    return init_device_mesh(device.type, (p,), mesh_dim_names=(NODE_AXIS,))


def _node_seed(*entropy: int) -> int:
    return int(np.random.SeedSequence(list(entropy)).generate_state(
        1, dtype=np.uint64)[0])


class Experiment:
    """One method over one world — see module docstring."""

    def __init__(self, world: World, method: str = "decdiff+vt", *,
                 comm: Optional[CommConfig] = None, backend: str = "vmap",
                 wire: str = "encoded",
                 schedule: Optional[Schedule] = None,
                 train: Optional[TrainConfig] = None, mesh=None,
                 layout: Optional[str] = None, device: DeviceLike = None,
                 **train_overrides):
        self.device = resolve_device(device)
        if world.device != self.device:
            raise ValueError(f"world lives on {world.device} but the "
                             f"experiment runs on {self.device}; build both "
                             f"with the same device")
        if backend not in backends.BACKENDS:
            raise ValueError(f"unknown backend {backend!r}; "
                             f"available: {backends.BACKENDS}")
        if layout is not None and layout not in LAYOUTS:
            raise ValueError(f"unknown layout {layout!r}; "
                             f"available: {LAYOUTS}")
        if wire not in WIRES:
            raise ValueError(f"unknown wire {wire!r}; available: {WIRES}")
        self.method: MethodSpec = get_method(method)
        self.strategy = self.method.strategy
        if comm is not None:
            if not isinstance(comm, CommConfig):
                raise TypeError(f"comm must be a repro_torch.comm.CommConfig, "
                                f"got {type(comm).__name__}")
            if not self.strategy.supports_transport:
                roster = [m for m in available_methods()
                          if get_method(m).strategy.supports_transport]
                raise ValueError(
                    f"comm transport models neighbour model-gossip only; "
                    f"method {method!r} is unsupported "
                    f"(transport-capable methods: {roster})")
        self.world = world
        self.backend = backend
        self.wire = wire
        self.schedule = schedule or Schedule()
        train = train or TrainConfig()
        if train_overrides:
            train = dataclasses.replace(train, **train_overrides)
        self.train = train

        model, topo = world.model, world.topo
        if not (topo.num_nodes == len(world.xs) == len(world.ys)):
            raise ValueError(
                f"world has {topo.num_nodes} nodes but "
                f"{len(world.xs)}/{len(world.ys)} data shards")
        # --- node-axis layout: it follows the topology's type unless
        # overridden.  Dense over a SparseTopology densifies it (refused
        # above 4096 nodes); sparse over a Topology converts it, so one
        # world runs both layouts.  A gossip strategy without a flat form
        # has only the padded-gather lowering, which is dense-only.
        if layout is None:
            layout = "sparse" if isinstance(topo, SparseTopology) else "dense"
        caps = self.strategy.capabilities
        allowed = tuple(
            lo for lo in caps.layouts
            if not (lo == "sparse" and caps.kind == "gossip"
                    and self.strategy.flat_aggregate is None))
        if layout not in allowed:
            why = ("declares no flat_aggregate form, so only the dense "
                   "padded-gather lowering exists"
                   if layout in caps.layouts else
                   "declares it unsupported in its Capabilities record")
            raise ValueError(
                f"method {method!r}: strategy "
                f"{type(self.strategy).__name__} {why}; supported layouts: "
                f"{allowed}")
        if layout == "dense" and isinstance(topo, SparseTopology):
            topo = topo.to_topology()
        elif layout == "sparse" and not isinstance(topo, SparseTopology):
            topo = SparseTopology.from_topology(topo)
        self.layout = layout
        dev = self.device
        # --- dynamics: bind the graph process before anything derives from
        # the topology, since rewiring replaces it with the family's union
        self.dynamics = world.dynamics
        self.bound_dyn = None
        if world.dynamics is not None:
            if not isinstance(world.dynamics, GraphProcess):
                raise TypeError(
                    f"World.dynamics must be a repro_torch.dynamics."
                    f"GraphProcess, got {type(world.dynamics).__name__}")
            self.bound_dyn = world.dynamics.bind(topo, dev)
            topo = self.bound_dyn.topo
        self.model = model
        self.topo = topo
        self.n = topo.num_nodes
        # --- the pod backend: the mesh, this rank's pod and its context
        # (one block of N / P rows); the vmap backend's is the dense one
        self.mesh = (mesh if mesh is not None else
                     _default_mesh(self.n, dev) if backend == "shard_map"
                     else None)
        self.n_pods, self.pod = 1, 0
        self.pod_ctx = DENSE_CTX
        if backend == "shard_map":
            self.n_pods, self.pod, group = pod_axis(self.mesh)
            self.pod_ctx = pod_context(self.n, self.n_pods, self.pod, group)
        rows = self.pod_ctx.rows
        self.is_writer = not (backend == "shard_map" and dist.is_available()
                              and dist.is_initialized()
                              and dist.get_rank() != 0)

        # data: the block's rows for local training; CFA-GE's walk reads
        # every sender's data (the full arrays, replicated)
        x_pad, y_pad, counts = pad_node_datasets(world.xs, world.ys)
        self.x_pad = torch.from_numpy(
            np.ascontiguousarray(rows(x_pad))).to(dev)
        self.y_pad = torch.from_numpy(rows(y_pad).astype(np.int64)).to(dev)
        self.x_walk = self.y_walk = None
        if self.strategy.capabilities.grad_exchange:
            if self.n_pods == 1:
                self.x_walk, self.y_walk = self.x_pad, self.y_pad
            else:
                self.x_walk = torch.from_numpy(
                    np.ascontiguousarray(x_pad)).to(dev)
                self.y_walk = torch.from_numpy(
                    y_pad.astype(np.int64)).to(dev)
        self.counts = torch.from_numpy(counts.astype(np.int64)).to(dev)
        self.x_test = torch.from_numpy(
            np.ascontiguousarray(world.x_test)).to(dev)
        self.y_test = torch.from_numpy(
            world.y_test.astype(np.int64)).to(dev)

        # --- graph tensors: the padded dense layout or the sparse plan ---
        if layout == "sparse":
            self.nbr_idx = self.nbr_valid = self.nbr_weight = None
            self.sparse_plan = build_sparse_plan(topo, counts, self.n_pods,
                                                 dev)
            self.edge_src = torch.from_numpy(
                topo.edge_src.astype(np.int64)).to(dev)
            self.edge_dst = torch.from_numpy(
                topo.edge_dst.astype(np.int64)).to(dev)
            self._total_directed = float(topo.num_directed)
        else:
            self.sparse_plan = self.edge_src = self.edge_dst = None
            idx = topo.neighbor_idx.astype(np.int64)
            self.nbr_idx = torch.from_numpy(np.maximum(idx, 0)).to(dev)
            self.nbr_valid = torch.from_numpy(
                topo.neighbor_mask.astype(np.float32)).to(dev)
            # combined ω_ij·|D_j| weights (aggregators normalize
            # internally, which realizes p_ij = |D_j| / Σ_{N_i} |D_j| of
            # Eqs. 4/6/9)
            omega = topo.neighbor_weights()
            dj = counts[np.maximum(idx, 0)].astype(np.float32)
            self.nbr_weight = torch.from_numpy(
                omega * dj * topo.neighbor_mask).to(dev)
            self._total_directed = float(topo.neighbor_mask.sum())

        # the round's own draws (hetero budgets, dropout keep masks,
        # participation masks, the codec's uniforms)
        self.gen = torch.Generator(device=dev).manual_seed(
            _node_seed(train.seed, 23))
        self.optimizer = sgd_momentum(lr=train.lr, momentum=train.momentum)
        self.loss_fn = make_loss_fn(self.method.loss, beta=train.beta)
        self.batcher = Batcher(batch_size=train.batch_size)
        # local steps and CFA-GE's gradients train the model (dropout on):
        # one keep-mask draw per dropout layer per call, over every row of
        # the full node axis (the block's rows taken on the pod backend)
        keep = generator_keep(self.gen, dev)
        step_keep = keep
        if self.n_pods > 1:
            block = rows(np.arange(self.n))
            step_keep = backends.rows_keep(
                keep, self.n, slice(int(block[0]), int(block[-1]) + 1))
        self._train_step = functools.partial(
            make_train_step(model, self.optimizer, self.loss_fn),
            keep=step_keep)
        self._grad_fn = functools.partial(make_grad_fn(model, self.loss_fn),
                                          keep=keep)
        self._eval = make_eval_fn(
            model, batch_size=min(train.eval_batch, len(world.x_test)))

        # --- init: one generator per node (heterogeneous), or one shared
        # seed when the method coordinates.  Drawn on the CPU so a seed
        # gives the same init on every device.
        per_node = []
        for i in range(self.n):
            seed = (_node_seed(train.seed + 1) if self.method.common_init
                    else _node_seed(train.seed, 17, i))
            per_node.append(model.init(torch.Generator().manual_seed(seed)))
        # the full stack once (the transports size themselves from it),
        # then the block's rows
        params = tree_map(lambda *ls: torch.stack(ls).to(dev),
                          per_node[0], *per_node[1:])
        del per_node
        self._params = self._block_nodes(params)
        self._opt_state = self.optimizer.init(self._params)

        # --- gossip transport (capability-gated above) ---
        self.comm = comm
        self.transport = None
        self._comm_state = None
        self.comm_bytes_total = 0.0
        self._trig_sum = 0.0
        self._comm_rounds = 0
        self.trig_history: List[float] = []  # per-round triggered fraction
        if comm is not None:
            if comm.use_per_edge and layout == "sparse":
                self.transport = SparseEdgeGossipTransport(
                    comm, params, topo)
            elif comm.use_per_edge:
                self.transport = EdgeGossipTransport(
                    comm, params, topo.neighbor_idx, topo.neighbor_mask)
            elif layout == "sparse":
                self.transport = GossipTransport(
                    comm, params, edge_src=topo.edge_src,
                    edge_dst=topo.edge_dst)
            else:
                self.transport = GossipTransport(
                    comm, params, nbr_idx=topo.neighbor_idx,
                    nbr_valid=topo.neighbor_mask)
            self.comm_state = self.transport.init_state(params)
        del params

        # --- dynamics state and live-edge accounting
        self.dyn_state = (self.bound_dyn.state0
                          if self.bound_dyn is not None else None)
        self._live_sum = 0.0
        self._live_rounds = 0
        self.live_history: List[float] = []  # per-round live-edge fraction

        # --- the event clock: bind the time models once, priced from the
        # transport's exact bytes on the wire (the dense fp32 model size
        # without one)
        self.timing = world.timing
        self.bound_timing = None
        self.time_state = None
        self.deadline = self.schedule.deadline
        if world.timing is not None:
            if not isinstance(world.timing, Timing):
                raise TypeError(
                    f"World.timing must be a repro_torch.timing.Timing, "
                    f"got {type(world.timing).__name__}")
            if self.transport is not None:
                payload = float(self.transport.payload_bytes)
            else:
                payload = 4.0 * float(
                    tree_flatten_stacked(self._params)[0].shape[1])
            self.bound_timing = world.timing.bind(topo, payload, dev)
            self.time_state = self.bound_timing.state0
        elif self.deadline is not None:
            raise ValueError(
                "Schedule(deadline=...) prices rounds in simulated seconds "
                "and needs World(timing=...) to define them")
        if (self.bound_dyn is not None and self.bound_dyn.observes
                and self.bound_timing is None):
            raise ValueError(
                f"dynamics process {self.bound_dyn.name!r} observes the "
                f"event clock's per-node compute cost; give the world a "
                f"repro_torch.timing.Timing (World(timing=...))")
        self.sim_time = 0.0
        self.sim_time_history: List[float] = []  # absolute seconds per round
        self._arrived_sum = 0.0
        self._arrived_rounds = 0
        self.arrived_history: List[float] = []  # per-round arrived fraction

        # --- telemetry: bind the channel selection once, after the clock;
        # the accumulator dict is one more round-carried state and the
        # per-round snapshot one more extras group.  The ledger (when
        # configured) opens here with the run manifest.
        self.telemetry = world.telemetry
        self.bound_obs = None
        self.obs_state = None
        # host channel snapshots, one per round (every round, not only the
        # eval rounds: the trace exporter diffs the cumulative channels)
        self.obs_history: List[Dict[str, np.ndarray]] = []
        self.ledger = None
        if world.telemetry is not None:
            if not isinstance(world.telemetry, Telemetry):
                raise TypeError(
                    f"World.telemetry must be a repro_torch.obs.Telemetry, "
                    f"got {type(world.telemetry).__name__}")
            self.bound_obs = world.telemetry.bind(self)
            if self.bound_obs is not None:
                self.obs_state = self.bound_obs.state0
            if world.telemetry.ledger is not None and self.is_writer:
                self.ledger = RunLedger(world.telemetry.ledger)
                self.ledger.write_manifest(run_manifest(self))

        self.agg_state = self.strategy.init_state(self)
        self._round = backends.build_round(self)
        self.train_loss_history: List[float] = []  # one entry per round

    # ------------------------------------------------------------------
    # the node axis: the block held here, the full axis read and written
    def _gather_nodes(self, tree):
        if self.n_pods == 1:
            return tree
        return tree_map(self.pod_ctx.gather, tree)

    def _block_nodes(self, tree):
        if self.n_pods == 1:
            return tree
        return tree_map(lambda t: self.pod_ctx.rows(t).clone(), tree)

    def _comm_fields(self, state, fn):
        """`fn` over the sender-private (sharded) fields of a transport
        state, per the transport's `state_specs`."""
        if state is None or self.n_pods == 1:
            return state
        specs = self.transport.state_specs("shard", "rep")
        return type(state)(*[fn(v) if spec == "shard" else v
                             for v, spec in zip(state, specs)])

    @property
    def params(self):
        """Node-stacked params, leaves [N, ...] (on the pod backend the
        pods' blocks gathered; set with the full node axis)."""
        return self._gather_nodes(self._params)

    @params.setter
    def params(self, value):
        self._params = self._block_nodes(value)

    @property
    def opt_state(self):
        """The optimizer state over the full node axis (as `params`)."""
        return self._gather_nodes(self._opt_state)

    @opt_state.setter
    def opt_state(self, value):
        self._opt_state = self._block_nodes(value)

    @property
    def comm_state(self):
        """The transport state over the full node axis: its sharded fields
        gathered, its replicated ones as held (as `params`)."""
        return self._comm_fields(self._comm_state, self.pod_ctx.gather)

    @comm_state.setter
    def comm_state(self, value):
        self._comm_state = self._comm_fields(
            value, lambda t: self.pod_ctx.rows(t).clone())

    def _eval_nodes(self):
        """(accuracy [N], loss [N]) on the device: the block evaluated,
        the results gathered."""
        acc, loss = self._eval(self._params, self.x_test, self.y_test)
        if self.n_pods > 1:
            acc, loss = self.pod_ctx.gather(acc), self.pod_ctx.gather(loss)
        return acc, loss

    def evaluate(self) -> RoundMetrics:
        acc, loss = self._eval_nodes()
        return RoundMetrics(round=-1, acc_per_node=acc.cpu().numpy(),
                            loss_per_node=loss.cpu().numpy())

    def _account_comm(self, sent_edges: float, trig: float):
        """The same float accounting, in round order, in both modes; the
        byte multiply stays in Python so exact accounting survives past
        f32's 2^24 integers."""
        self.comm_bytes_total += self.transport.payload_bytes * float(
            sent_edges)
        self._trig_sum += float(trig)
        self._comm_rounds += 1
        self.trig_history.append(float(trig))

    def _account_live(self, live_edges: float):
        """The round's realized fraction of the static layout's directed
        edges that were live."""
        frac = float(live_edges) / max(self._total_directed, 1.0)
        self._live_sum += frac
        self._live_rounds += 1
        self.live_history.append(frac)

    def _account_time(self, sim_t: float, arrived_edges: float):
        """`sim_t` is the ABSOLUTE simulated time at the end of the round;
        `arrived_edges` counts the live directed edges whose payload made
        the deadline (all of them in synchronous mode), as a fraction of
        the round's live edges under a dynamics process, of the static
        layout's otherwise."""
        self.sim_time = float(sim_t)
        self.sim_time_history.append(self.sim_time)
        denom = (self.live_history[-1] * self._total_directed
                 if self.bound_dyn is not None else self._total_directed)
        frac = float(arrived_edges) / max(denom, 1.0)
        self._arrived_sum += frac
        self._arrived_rounds += 1
        self.arrived_history.append(frac)

    def _account_obs(self, snapshot):
        """Keep the round's channel snapshot on the host (numpy, the
        layout's own shapes): `RoundMetrics.detail` and the trace exporter
        materialize from these."""
        self.obs_history.append({
            k: v.cpu().numpy() if isinstance(v, torch.Tensor) else v
            for k, v in snapshot.items()})

    def _account_extras(self, extras):
        """Route one round's extras group by group, in the reference's
        order: (sent, trig) with a transport, (live,) with dynamics,
        (sim_t, arrived) with an event clock, (snapshot,) with telemetry."""
        extras = list(extras)
        if self.transport is not None:
            self._account_comm(extras.pop(0), extras.pop(0))
        if self.bound_dyn is not None:
            self._account_live(extras.pop(0))
        if self.bound_timing is not None:
            self._account_time(extras.pop(0), extras.pop(0))
        if self.bound_obs is not None:
            self._account_obs(extras.pop(0))
        assert not extras

    def _probes(self):
        """The telemetry's parameter probes (consensus / drift) on the
        device, or None; called at eval rounds only."""
        if self.bound_obs is None or not self.bound_obs.has_probes:
            return None
        return self.bound_obs.eval_probes(
            tree_flatten_stacked(self.params)[0])

    def _finish_metrics(self, m: RoundMetrics, history, verbose,
                        probes=None):
        """Fill the eval round's accounting and telemetry detail, append
        it to `history`, write its ledger record and log its line."""
        if self.transport is not None:
            m.bytes_on_wire = self.comm_bytes_total
            m.triggered_frac = self._trig_sum / max(self._comm_rounds, 1)
        if self.bound_dyn is not None:
            m.live_edge_frac = self._live_sum / max(self._live_rounds, 1)
        if self.bound_timing is not None:
            m.sim_time = self.sim_time
            m.arrived_frac = self._arrived_sum / max(self._arrived_rounds, 1)
        if self.bound_obs is not None and self.obs_history:
            m.detail = self.bound_obs.materialize(
                self.obs_history[-1], acc_per_node=m.acc_per_node,
                probes=probes)
        history.append(m)
        if self.ledger is not None:
            self.ledger.write(round_record(m))
        if verbose and self.is_writer:
            log_round(self.method.name, m)

    @contextlib.contextmanager
    def _profiled(self, out_dir: str):
        """`Telemetry(profile_dir=...)`: torch.profiler around the run (CPU
        activity, and CUDA on a card), its Chrome trace written into
        `out_dir` as one new file per run."""
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        os.makedirs(out_dir, exist_ok=True)
        with profile(activities=acts) as prof:
            yield
        prof.export_chrome_trace(os.path.join(
            out_dir, f"run-{os.getpid()}-{_time.time_ns()}.pt.trace.json"))

    def run(self, rounds: Optional[int] = None,
            eval_every: Optional[int] = None, verbose: bool = False,
            mode: Optional[str] = None) -> List[RoundMetrics]:
        """Run the schedule; returns the eval history (round 0 = after the
        first round's local training and exchange).  The per-round train
        losses are appended to `train_loss_history`; with a transport the
        triggered fractions to `trig_history`, with dynamics the live-edge
        fractions to `live_history`, with an event clock the simulated
        seconds and arrived fractions to `sim_time_history` and
        `arrived_history`, and with telemetry the host channel snapshots
        to `obs_history`.

        `verbose=True` logs one line per eval round through the
        ``repro_torch.obs.round`` logger (the reference's text); a
        telemetry ledger gets one record per eval round and a summary
        (wall seconds, rounds per second); `Telemetry(profile_dir=...)`
        wraps the run in `torch.profiler`."""
        rounds = self.schedule.rounds if rounds is None else rounds
        eval_every = (self.schedule.eval_every if eval_every is None
                      else eval_every)
        mode = self.schedule.mode if mode is None else mode
        if mode not in SCHEDULE_MODES:
            raise ValueError(f"schedule mode must be one of {SCHEDULE_MODES}, "
                             f"got {mode!r}")
        profile = contextlib.nullcontext()
        if (self.telemetry is not None and self.telemetry.profile_dir
                and self.is_writer):
            profile = self._profiled(self.telemetry.profile_dir)
        t0 = _time.perf_counter()
        with profile:
            history = self._run(rounds, eval_every, verbose, mode)
        if self.ledger is not None:
            wall = _time.perf_counter() - t0
            self.ledger.write({"kind": "summary", "mode": mode,
                               "rounds": int(rounds), "wall_s": wall,
                               "rounds_per_sec": rounds / max(wall, 1e-9)})
        return history

    def _run(self, rounds, eval_every, verbose, mode) -> List[RoundMetrics]:
        evals = set(Schedule.eval_rounds(rounds, eval_every))
        history: List[RoundMetrics] = []
        pending = []  # fused: (round, acc, loss, probes) kept on the device
        losses, extras_out = [], []
        for r in range(rounds):
            (self._params, self._opt_state, self._comm_state,
             self.dyn_state, self.time_state, self.obs_state, loss,
             extras) = self._round(
                 self._params, self._opt_state, self._comm_state,
                 self.dyn_state, self.time_state, self.obs_state, r)
            losses.append(loss)
            if mode == "loop":
                if extras:
                    self._account_extras(extras)
                if r in evals:
                    m = self.evaluate()
                    m.round = r
                    probes = self._probes()
                    if probes is not None:
                        probes = {k: v.cpu().numpy()
                                  for k, v in probes.items()}
                    self._finish_metrics(m, history, verbose, probes)
            else:
                if extras:
                    extras_out.append(extras)
                if r in evals:
                    acc, eloss = self._eval_nodes()
                    pending.append((r, acc, eloss, self._probes()))
        if mode == "fused" and rounds:
            # one read-back of the accounting the rounds left on the device
            # (every round's extras, the telemetry snapshot included, and
            # every eval round's probes), then the host-side accounting in
            # round order
            acc_r = loss_r = None
            if pending:
                acc_r = torch.stack([p[1] for p in pending]).cpu().numpy()
                loss_r = torch.stack([p[2] for p in pending]).cpu().numpy()
            probes_d = [p[3] for p in pending if p[3] is not None]
            host = iter(_read_back(extras_out + probes_d))
            extras_r = [next(host) for _ in extras_out]
            at = {p[0]: i for i, p in enumerate(pending)}
            for r in range(rounds):
                if extras_r:
                    self._account_extras(extras_r[r])
                if r in at:
                    i = at[r]
                    self._finish_metrics(
                        RoundMetrics(round=r, acc_per_node=acc_r[i],
                                     loss_per_node=loss_r[i]),
                        history, verbose,
                        next(host) if pending[i][3] is not None else None)
        if losses:
            self.train_loss_history.extend(
                torch.stack(losses).cpu().tolist())
        return history


def _read_back(groups):
    """Copy a list of groups (each a tuple of 0-d tensors and dicts of
    tensors, or one dict) from the device in one read-back; returns the
    same structure on the host: python floats for the 0-d tensors, numpy
    arrays in the dicts."""
    flat = []
    for g in groups:
        for item in (g.values() if isinstance(g, dict) else g):
            if isinstance(item, dict):
                flat.extend(item.values())
            else:
                flat.append(item)
    if not flat:  # only empty snapshots: nothing on the device
        return list(groups)
    buf = torch.cat([t.reshape(-1) for t in flat]).cpu().numpy()
    pos = 0

    def take(t):
        nonlocal pos
        n = t.numel()
        a = buf[pos:pos + n].reshape(tuple(t.shape))
        pos += n
        return a

    out = []
    for g in groups:
        if isinstance(g, dict):
            out.append({k: take(v) for k, v in g.items()})
            continue
        host = []
        for item in g:
            if isinstance(item, dict):
                host.append({k: take(v) for k, v in item.items()})
            else:
                host.append(float(take(item)))
        out.append(host)
    return out
