"""`Experiment`: the front door for decentralized-learning runs.

    Experiment(World.synthetic(...), "decdiff+vt").run()

packages the paper's procedure — heterogeneous per-node init, B local
SGD(momentum) steps, neighbour exchange, method aggregation, periodic
evaluation — behind one object, as the JAX package's `repro.engine` does.
This slice runs the dense node-axis layout on the `vmap` backend with no
transport.  Options that are not ported yet raise NotImplementedError
naming the ROADMAP item that ports them: `comm=` (A.5),
`layout="sparse"` (A.6), `dynamics=` (A.7), `timing=` and
`Schedule(deadline=)` (A.8), `telemetry=` (A.9), `backend="shard_map"`
(A.10), the CNN (A.2), and the `fedavg` / `cfa-ge` methods (A.3).

Devices: every entry point takes `device=None`, which means "cuda" and
raises on a host without CUDA; tests pass `device="cpu"`.  A World records
its device and an Experiment runs on the same one.

Schedule modes: "loop" reads each eval back to the host as it happens;
"fused" (the default) runs the same rounds and evals with every result
kept on the device, stacked, and read back once at the end.  Both modes
run the same operations in the same order, so they are bitwise equal.

Mutable run state (params, optimizer state, the generator) lives on the
instance, so `run()` can be called repeatedly and continues where the last
call stopped (round indices restart, as in the reference).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from repro_torch.core.virtual_teacher import make_loss_fn
from repro_torch.data.allocation import pad_node_datasets
from repro_torch.data.pipeline import Batcher
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.engine import backends
from repro_torch.engine.strategies import MethodSpec, get_method
from repro_torch.fl.metrics import RoundMetrics
from repro_torch.fl.trainer import make_eval_fn, make_train_step
from repro_torch.graphs.topology import Topology
from repro_torch.models.api import SmallModel
from repro_torch.optim.sgd import sgd_momentum
from repro_torch.utils.pytree import tree_map

SCHEDULE_MODES = ("fused", "loop")
LAYOUTS = ("dense", "sparse")


def _not_ported(what: str, item: str):
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet (ROADMAP {item})")


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


@dataclasses.dataclass(frozen=True)
class Schedule:
    """How many rounds, how often to eval, and how the rounds execute."""

    rounds: int = 100
    eval_every: int = 5
    mode: str = "fused"  # "fused" (read back once) | "loop" (per eval)
    deadline: Optional[float] = None  # event-clock ticks: ROADMAP A.8

    def __post_init__(self):
        if self.mode not in SCHEDULE_MODES:
            raise ValueError(f"schedule mode must be one of {SCHEDULE_MODES}, "
                             f"got {self.mode!r}")
        if self.deadline is not None:
            raise _not_ported("Schedule(deadline=...)", "A.8")

    @staticmethod
    def eval_rounds(rounds: int, eval_every: int):
        """After round 0, every `eval_every` rounds, and after the last."""
        return [r for r in range(rounds)
                if r % eval_every == 0 or r == rounds - 1]


@dataclasses.dataclass
class World:
    """The physical problem: who talks to whom, over what data.

    The data stay host-side numpy arrays (per-node train shards and the
    shared test set) until an Experiment moves them to `device`."""

    model: SmallModel
    topo: Topology
    xs: List[np.ndarray]       # per-node train inputs
    ys: List[np.ndarray]       # per-node train labels
    x_test: np.ndarray
    y_test: np.ndarray
    device: DeviceLike = None
    dynamics: object = None
    timing: object = None
    telemetry: object = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        for name, item in (("dynamics", "A.7"), ("timing", "A.8"),
                           ("telemetry", "A.9")):
            if getattr(self, name) is not None:
                raise _not_ported(f"World({name}=...)", item)

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


def _node_seed(*entropy: int) -> int:
    return int(np.random.SeedSequence(list(entropy)).generate_state(
        1, dtype=np.uint64)[0])


class Experiment:
    """One method over one world — see module docstring."""

    def __init__(self, world: World, method: str = "decdiff+vt", *,
                 comm=None, backend: str = "vmap",
                 schedule: Optional[Schedule] = None,
                 train: Optional[TrainConfig] = None,
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
        if backend != "vmap":
            raise _not_ported(f"backend={backend!r}", "A.10")
        if layout is not None and layout not in LAYOUTS:
            raise ValueError(f"unknown layout {layout!r}; "
                             f"available: {LAYOUTS}")
        if layout == "sparse":
            raise _not_ported("layout='sparse'", "A.6")
        if comm is not None:
            raise _not_ported("comm= (the gossip transport)", "A.5")
        self.method: MethodSpec = get_method(method)
        self.strategy = self.method.strategy
        if self.strategy.pending is not None:
            raise _not_ported(f"method {method!r}", self.strategy.pending)
        self.world = world
        self.backend = backend
        self.layout = "dense"
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
        self.model = model
        self.topo = topo
        self.n = topo.num_nodes
        dev = self.device

        x_pad, y_pad, counts = pad_node_datasets(world.xs, world.ys)
        self.x_pad = torch.from_numpy(np.ascontiguousarray(x_pad)).to(dev)
        self.y_pad = torch.from_numpy(y_pad.astype(np.int64)).to(dev)
        self.counts = torch.from_numpy(counts.astype(np.int64)).to(dev)
        self.x_test = torch.from_numpy(
            np.ascontiguousarray(world.x_test)).to(dev)
        self.y_test = torch.from_numpy(
            world.y_test.astype(np.int64)).to(dev)

        # --- graph tensors, padded dense layout ---
        idx = topo.neighbor_idx.astype(np.int64)
        self.nbr_idx = torch.from_numpy(np.maximum(idx, 0)).to(dev)
        self.nbr_valid = torch.from_numpy(
            topo.neighbor_mask.astype(np.float32)).to(dev)
        # combined ω_ij·|D_j| weights (aggregators normalize internally,
        # which realizes p_ij = |D_j| / Σ_{N_i} |D_j| of Eqs. 4/6/9)
        omega = topo.neighbor_weights()
        dj = counts[np.maximum(idx, 0)].astype(np.float32)
        self.nbr_weight = torch.from_numpy(
            omega * dj * topo.neighbor_mask).to(dev)

        self.optimizer = sgd_momentum(lr=train.lr, momentum=train.momentum)
        self.loss_fn = make_loss_fn(self.method.loss, beta=train.beta)
        self.batcher = Batcher(batch_size=train.batch_size)
        self._train_step = make_train_step(model, self.optimizer,
                                           self.loss_fn)
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
        self.params = tree_map(lambda *ls: torch.stack(ls).to(dev),
                               per_node[0], *per_node[1:])
        self.opt_state = self.optimizer.init(self.params)
        # the round's own draws (hetero budgets, participation masks)
        self.gen = torch.Generator(device=dev).manual_seed(
            _node_seed(train.seed, 23))

        self.agg_state = self.strategy.init_state(self)
        self._round = backends.build_round(self)
        self.train_loss_history: List[float] = []  # one entry per round

    # ------------------------------------------------------------------
    def evaluate(self) -> RoundMetrics:
        acc, loss = self._eval(self.params, self.x_test, self.y_test)
        return RoundMetrics(round=-1, acc_per_node=acc.cpu().numpy(),
                            loss_per_node=loss.cpu().numpy())

    def run(self, rounds: Optional[int] = None,
            eval_every: Optional[int] = None,
            mode: Optional[str] = None) -> List[RoundMetrics]:
        """Run the schedule; returns the eval history (round 0 = after the
        first round's local training and exchange).  The per-round train
        losses are appended to `train_loss_history`."""
        rounds = self.schedule.rounds if rounds is None else rounds
        eval_every = (self.schedule.eval_every if eval_every is None
                      else eval_every)
        mode = self.schedule.mode if mode is None else mode
        if mode not in SCHEDULE_MODES:
            raise ValueError(f"schedule mode must be one of {SCHEDULE_MODES}, "
                             f"got {mode!r}")
        evals = set(Schedule.eval_rounds(rounds, eval_every))
        history: List[RoundMetrics] = []
        pending = []  # fused: (round, acc, loss) kept on the device
        losses = []
        for r in range(rounds):
            self.params, self.opt_state, loss = self._round(
                self.params, self.opt_state, r)
            losses.append(loss)
            if r in evals:
                if mode == "loop":
                    m = self.evaluate()
                    m.round = r
                    history.append(m)
                else:
                    acc, eloss = self._eval(self.params, self.x_test,
                                            self.y_test)
                    pending.append((r, acc, eloss))
        if pending:
            acc_r = torch.stack([a for _, a, _ in pending]).cpu().numpy()
            loss_r = torch.stack([lo for _, _, lo in pending]).cpu().numpy()
            history = [RoundMetrics(round=r, acc_per_node=acc_r[i],
                                    loss_per_node=loss_r[i])
                       for i, (r, _, _) in enumerate(pending)]
        if losses:
            self.train_loss_history.extend(
                torch.stack(losses).cpu().tolist())
        return history
