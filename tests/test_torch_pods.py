"""The pod backend (ROADMAP A.10) on the CPU, over `torch.distributed`.

`Experiment(backend="shard_map")` and `build_dfl_round_shardmap` run one
block of N / P nodes per rank of a gloo process group, and their all-gather
crosses the ranks.  Each world size's whole matrix runs inside ONE
`torch.multiprocessing.spawn` (the workers' startup is paid once), with a
`FileStore` rendezvous in the test's own temporary directory (so the
suite's parallel workers never share one).  The spawned workers import
neither `jax` nor `repro`; they write their results into that directory
and this process compares them:

  * with the port's own `vmap` backend, bitwise: final params, transport
    state, bytes on the wire, trigger and live histories and accuracies —
    over tests/test_exchange_unified.py's 6 method / transport
    configurations x 4 dynamics on an 8-node ring at P = 4 (dense) and
    P = 2 (sparse), one fused run at P = 2 with a deadline and
    `Telemetry("all")` (clock, arrivals and every channel too), and at
    P = 1 without a process group (the one-pod mesh) the matrix on the
    dense layout and every configuration under churn on the sparse one;
  * with the JAX package's `vmap` lane, from the reference's init: a
    handful of those configurations within ROADMAP C.1's tolerance (1e-6
    without a transport, 1e-4 plus one int8 grain with one), accuracies,
    bytes and triggers exactly;
  * `map_graph_to_pods` / `pod_adjacency` against the reference's on BA,
    ER and ring graphs at P = 1-4, with the same errors;
  * the LM pod round at P = 2 and 4 on a reduced qwen1.5-0.5b (fused
    int8, unfused int8, bf16 gossip, fp32; 2 rounds): bitwise the port's
    one-pod form, and within 1e-4 (params) and 1e-5 (loss) of the
    reference's `build_dfl_round`.

The training loss is the mean of the pods' means, which need not be the
vmap mean bit for bit: it is held to fp32 tolerance (1e-6).  torch runs on
one thread in the workers and on two here.
"""
import dataclasses
import os
import pickle
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.comm import CommConfig  # noqa: E402
from repro_torch.engine import Experiment, Schedule, World  # noqa: E402
from repro_torch.utils.pytree import tree_leaves, tree_map  # noqa: E402

torch.set_num_threads(min(2, torch.get_num_threads()))

TINY = dict(steps_per_round=2, batch_size=16, lr=0.1, momentum=0.9, seed=3)
NODES = 8
ROUNDS = 3
# (label, method, CommConfig kwargs or None): one entry per declared
# capability, as tests/test_exchange_unified.py
CONFIGS = [
    ("plain", "decdiff+vt", None),
    ("server", "fedavg", None),
    ("per-node-int8", "decdiff+vt",
     dict(codec="int8", trigger_threshold=1.0)),
    ("per-edge-topk", "decdiff+vt",
     dict(codec="topk", topk_ratio=0.25, per_edge=True,
          trigger_threshold=0.5)),
    ("per-edge-adaptive", "dechetero",
     dict(codec="int8", policy="adaptive", target_trigger=0.6)),
    ("cfa-ge", "cfa-ge", None),
]
DYNAMICS = ["static", "dropout", "gilbert-elliott", "churn"]
MATRIX = [(c[0], d) for c in CONFIGS for d in DYNAMICS]
# the reference's lane, from its init: deterministic codecs, no dynamics
REFERENCE = [
    ("plain", "decdiff+vt", None),
    ("server", "fedavg", None),
    ("cfa-ge", "cfa-ge", None),
    ("per-node-int8", "decdiff+vt",
     dict(codec="int8", trigger_threshold=1.0, stochastic=False)),
    ("per-edge-adaptive", "dechetero",
     dict(codec="int8", policy="adaptive", target_trigger=0.6,
          stochastic=False)),
]
LM_FORMS = ["fused-int8", "unfused-int8", "bf16", "fp32"]
LM_NODES, LM_BATCH, LM_SEQ, LM_ROUNDS = 4, 2, 16, 2


# -------------------------------------------------------- shared helpers
# (module-level and free of jax: the spawned workers import this module)

def _dynamics(label):
    from repro_torch.dynamics import EdgeDropout, GilbertElliott, NodeChurn

    return {"static": None, "dropout": EdgeDropout(p=0.3),
            "gilbert-elliott": GilbertElliott(p_gb=0.25, p_bg=0.4),
            "churn": NodeChurn(p_leave=0.3, p_rejoin=0.6)}[label]


def _world(arrays, dyn=None, timing=None, telemetry=None):
    from repro_torch.models.mlp_cnn import make_mlp

    world = convert.world_from_arrays(model=make_mlp(hidden=(32,)),
                                      device="cpu", **arrays)
    return dataclasses.replace(world, dynamics=dyn, timing=timing,
                               telemetry=telemetry)


def _config(label):
    return {c[0]: c[1:] for c in CONFIGS + REFERENCE}[label]


def _run_exp(arrays, spec, backend):
    """One experiment of the matrix; returns its full-axis results (every
    rank of the pod backend computes the same ones)."""
    from repro_torch.obs import Telemetry
    from repro_torch.timing import LognormalLink, LognormalStep, Timing

    method, comm = (spec["method"], spec["comm"])
    timing = telemetry = None
    deadline = None
    mode = "loop"
    if spec.get("timed"):
        timing = Timing(node=LognormalStep(sigma=0.5, seed=7),
                        link=LognormalLink(seed=9))
        telemetry, deadline, mode = Telemetry("all"), 4.0, "fused"
    world = _world(arrays, _dynamics(spec["dyn"]), timing, telemetry)
    exp = Experiment(world, method, backend=backend, layout=spec["layout"],
                     comm=None if comm is None else CommConfig(**comm),
                     schedule=Schedule(rounds=ROUNDS, eval_every=1,
                                       mode=mode, deadline=deadline),
                     device="cpu", **TINY)
    if spec.get("params0") is not None:
        # the reference's init carried over (full node axis)
        exp.params = convert.params_from_numpy(spec["params0"], "cpu")
        exp.opt_state = exp.optimizer.init(exp.params)
        if exp.transport is not None:
            exp.comm_state = exp.transport.init_state(exp.params)
    hist = exp.run()
    cs = exp.comm_state
    out = dict(
        n_pods=exp.n_pods,
        params=convert.params_to_numpy(exp.params),
        comm=None if cs is None else [None if v is None else v.numpy()
                                      for v in cs],
        bytes=exp.comm_bytes_total, trig=list(exp.trig_history),
        live=list(exp.live_history), loss=list(exp.train_loss_history),
        acc=[m.acc_per_node for m in hist],
        sim=list(exp.sim_time_history), arrived=list(exp.arrived_history),
        obs=list(exp.obs_history),
        detail=[m.detail for m in hist])
    return out


def _lm_setup():
    from repro_torch.configs import get_config
    from repro_torch.launch.train import ring_adjacency
    from repro_torch.models.lm import build_lm
    from repro_torch.optim.sgd import sgd_momentum

    lm = build_lm(get_config("qwen1.5-0.5b").reduced(
        n_layers=2, d_model=64, vocab=256))
    return lm, sgd_momentum(lr=3e-3), ring_adjacency(LM_NODES)


def _lm_kwargs(form):
    from repro_torch.comm.codecs import Int8Codec

    return {"fused-int8": dict(codec=Int8Codec(stochastic=False)),
            "unfused-int8": dict(codec=Int8Codec(stochastic=False),
                                 fuse_dequant=False),
            "bf16": dict(gossip_dtype=torch.bfloat16), "fp32": {}}[form]


def _run_lm(lm_in, form, mesh, rows):
    """The LM pod round over `mesh` on the nodes `rows` (a slice) from the
    carried init; returns (the block's params, the losses)."""
    from repro_torch.dist.dfl_step import build_dfl_round_shardmap

    lm, opt, adj = _lm_setup()
    params = tree_map(lambda t: t[rows].clone(), convert.params_from_numpy(
        lm_in["params0"], device="cpu", dtypes=lm_in["dtypes"]))
    state = opt.init(params)
    rnd = build_dfl_round_shardmap(lm, opt, adj, mesh, **_lm_kwargs(form))
    losses = []
    for r, b in enumerate(lm_in["batches"]):
        params, state, loss = rnd(params, state, r, {
            k: torch.from_numpy(v[rows].astype(np.int64))
            for k, v in b.items()})
        losses.append(float(loss))
    return convert.params_to_numpy(params), losses


def _pod_worker(rank, world_size, tmp):
    """One rank: every job of the world size's matrix, results pickled to
    `tmp/rank<r>.pkl`."""
    import sys

    torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(tmp, "store"), world_size)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=world_size)
    try:
        with open(os.path.join(tmp, "jobs.pkl"), "rb") as f:
            jobs = pickle.load(f)
        out = {}
        for key, job in jobs["exp"].items():
            out[key] = _run_exp(jobs["arrays"], job, "shard_map")
        if jobs.get("lm") is not None:
            from torch.distributed.device_mesh import init_device_mesh

            mesh = init_device_mesh("cpu", (world_size,),
                                    mesh_dim_names=("pod",))
            r = LM_NODES // world_size
            for form in LM_FORMS:
                out[("lm", form)] = _run_lm(
                    jobs["lm"], form, mesh, slice(rank * r, (rank + 1) * r))
        out["imported"] = sorted(k for k in sys.modules
                                 if k.split(".")[0] in ("jax", "repro"))
        with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def _spawn(world_size, jobs, tmp):
    with open(os.path.join(tmp, "jobs.pkl"), "wb") as f:
        pickle.dump(jobs, f)
    mp.spawn(_pod_worker, args=(world_size, tmp), nprocs=world_size,
             join=True)
    out = []
    for r in range(world_size):
        with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


# ------------------------------------------------------------- fixtures

@pytest.fixture(scope="module")
def arrays():
    """The 8-node ring over reduced synth-mnist (tests/test_exchange_
    unified.py's world), as arrays."""
    w = World.synthetic(dataset="synth-mnist", nodes=NODES,
                        topology="ring", seed=3, scale=0.02, device="cpu")
    return dict(adjacency=w.topo.adjacency, weights=w.topo.weights,
                xs=w.xs, ys=w.ys, x_test=w.x_test, y_test=w.y_test)


def _spec(label, dyn, layout, **kw):
    method, comm = _config(label)
    return dict(method=method, comm=comm, dyn=dyn, layout=layout, **kw)


@pytest.fixture(scope="module")
def reference_init(arrays):
    """The JAX package's vmap runs of REFERENCE on the same world, and its
    init (None when the container has no JAX)."""
    try:
        import jax
    except ImportError:
        return None
    from repro.comm import CommConfig as JCommConfig
    from repro.engine import Experiment as JExperiment
    from repro.engine import World as JWorld
    from repro.models.mlp_cnn import make_mlp as jmake_mlp

    jw = JWorld.synthetic(dataset="synth-mnist", nodes=NODES,
                          topology="ring", seed=3, scale=0.02,
                          model=jmake_mlp(num_classes=10, hidden=(32,)))
    runs = {}
    for label, method, comm in REFERENCE:
        je = JExperiment(jw, method,
                         comm=None if comm is None else JCommConfig(**comm),
                         **TINY)
        params0 = jax.tree.map(np.asarray, je.params)
        hist = je.run(rounds=ROUNDS, eval_every=1, mode="loop")
        runs[label] = dict(params0=params0,
                           params=jax.tree.map(np.asarray, je.params),
                           acc=[m.acc_per_node for m in hist],
                           bytes=[m.bytes_on_wire for m in hist],
                           trig=list(je.trig_history))
    jarrays = dict(adjacency=jw.topo.adjacency, weights=jw.topo.weights,
                   xs=jw.xs, ys=jw.ys, x_test=jw.x_test, y_test=jw.y_test)
    return runs, jarrays


@pytest.fixture(scope="module")
def lm_reference():
    """The reference's LM init, batches and `build_dfl_round` results per
    form (None without JAX)."""
    try:
        import jax
        import jax.numpy as jnp
    except ImportError:
        return None
    from repro.comm.codecs import Int8Codec as JInt8
    from repro.configs import get_config as jget
    from repro.data.tokens import synthetic_token_batch
    from repro.dist.dfl_step import build_dfl_round as jround
    from repro.models.lm import build_lm as jbuild
    from repro.optim.sgd import sgd_momentum as jsgd
    from repro_torch.launch.train import ring_adjacency

    jlm = jbuild(jget("qwen1.5-0.5b").reduced(n_layers=2, d_model=64,
                                              vocab=256))
    keys = jax.random.split(jax.random.PRNGKey(0), LM_NODES)
    jp0 = jax.vmap(jlm.init)(keys)
    batches = []
    for r in range(LM_ROUNDS):
        bs = [synthetic_token_batch(LM_BATCH, LM_SEQ, 256, seed=r * 131 + i)
              for i in range(LM_NODES)]
        batches.append({k: np.stack([b[k] for b in bs]) for k in bs[0]})
    kw = {"fused-int8": dict(codec=JInt8(stochastic=False)),
          "unfused-int8": dict(codec=JInt8(stochastic=False)),
          "bf16": dict(gossip_dtype=jnp.bfloat16), "fp32": {}}
    want = {}
    for form in LM_FORMS:
        opt = jsgd(lr=3e-3)
        rnd = jax.jit(jround(jlm, opt, jnp.asarray(ring_adjacency(LM_NODES)),
                             **kw[form]))
        p, s = jp0, jax.vmap(opt.init)(jp0)
        losses = []
        for r, b in enumerate(batches):
            p, s, loss = rnd(p, s, jnp.int32(r),
                             {k: jnp.asarray(v) for k, v in b.items()})
            losses.append(float(loss))
        want[form] = (jax.tree.map(lambda x: np.asarray(x, np.float32), p),
                      losses)
    lm_in = dict(params0=jax.tree.map(lambda x: np.asarray(x, np.float32),
                                      jp0),
                 dtypes=jax.tree.map(lambda x: str(x.dtype), jp0),
                 batches=batches)
    return lm_in, want


@pytest.fixture(scope="module")
def pods4(arrays, reference_init, lm_reference, tmp_path_factory):
    """P = 4, dense: the matrix, the reference's handful from its init,
    and the LM pod round at one node a pod."""
    jobs = {"arrays": arrays,
            "exp": {m: _spec(*m, "dense") for m in MATRIX}}
    if lm_reference is not None:
        jobs["lm"] = lm_reference[0]
    if reference_init is not None:
        runs, _ = reference_init
        for label, _, _ in REFERENCE:
            jobs["exp"][("ref", label)] = _spec(
                label, "static", "dense", params0=runs[label]["params0"])
    return _spawn(4, jobs, str(tmp_path_factory.mktemp("pods4")))


@pytest.fixture(scope="module")
def pods2(arrays, lm_reference, tmp_path_factory):
    """P = 2: the matrix on the sparse layout, the fused deadline run with
    every channel, and the LM pod round."""
    jobs = {"arrays": arrays,
            "exp": {m: _spec(*m, "sparse") for m in MATRIX}}
    jobs["exp"]["timed"] = _spec("per-edge-adaptive", "dropout", "dense",
                                 timed=True)
    if lm_reference is not None:
        jobs["lm"] = lm_reference[0]
    return _spawn(2, jobs, str(tmp_path_factory.mktemp("pods2")))


# ---------------------------------------------------------------- checks

def _assert_bitwise(got, want, timed=False):
    for layer in want["params"]:
        for leaf in want["params"][layer]:
            np.testing.assert_array_equal(got["params"][layer][leaf],
                                          want["params"][layer][leaf])
    if want["comm"] is None:
        assert got["comm"] is None
    else:
        for a, b in zip(got["comm"], want["comm"]):
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_array_equal(a, b)
    assert got["bytes"] == want["bytes"]
    assert got["trig"] == want["trig"]
    assert got["live"] == want["live"]
    for a, b in zip(got["acc"], want["acc"]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=0, atol=1e-6)
    if timed:
        assert got["sim"] == want["sim"]
        assert got["arrived"] == want["arrived"]
        assert len(got["obs"]) == len(want["obs"]) == ROUNDS
        for a, b in zip(got["obs"] + got["detail"],
                        want["obs"] + want["detail"]):
            assert sorted(a) == sorted(b)
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])


def _ranks_agree(ranks, key):
    """Every rank reads the same full-axis results."""
    for other in ranks[1:]:
        _assert_bitwise(other[key], ranks[0][key],
                        timed=bool(ranks[0][key]["obs"]))
        assert other[key]["loss"] == ranks[0][key]["loss"]


def test_workers_import_neither_jax_nor_repro(pods2, pods4):
    for rank in pods2 + pods4:
        assert rank["imported"] == []


@pytest.mark.parametrize("label,dyn", MATRIX,
                         ids=[f"{c}-{d}" for c, d in MATRIX])
def test_four_pods_dense_bitwise_vmap(arrays, pods4, label, dyn):
    spec = _spec(label, dyn, "dense")
    want = _run_exp(arrays, spec, "vmap")
    assert pods4[0][(label, dyn)]["n_pods"] == 4  # a real pod axis
    _assert_bitwise(pods4[0][(label, dyn)], want)
    _ranks_agree(pods4, (label, dyn))


@pytest.mark.parametrize("label,dyn", MATRIX,
                         ids=[f"{c}-{d}" for c, d in MATRIX])
def test_two_pods_sparse_bitwise_vmap(arrays, pods2, label, dyn):
    spec = _spec(label, dyn, "sparse")
    want = _run_exp(arrays, spec, "vmap")
    assert pods2[0][(label, dyn)]["n_pods"] == 2
    _assert_bitwise(pods2[0][(label, dyn)], want)
    _ranks_agree(pods2, (label, dyn))


def test_two_pods_fused_deadline_with_every_channel(arrays, pods2):
    """The fused schedule, a 4 s deadline under a lognormal clock, per-edge
    int8 under edge dropout and Telemetry("all"): the clock, arrivals,
    every channel snapshot and eval detail bitwise vmap's."""
    spec = _spec("per-edge-adaptive", "dropout", "dense", timed=True)
    want = _run_exp(arrays, spec, "vmap")
    got = pods2[0]["timed"]
    _assert_bitwise(got, want, timed=True)
    assert 0 < min(want["arrived"]) and max(want["arrived"]) <= 1
    assert "edge_bytes" in got["detail"][-1]
    _ranks_agree(pods2, "timed")


ONE_POD = ([(c, d, "dense") for c, d in MATRIX]
           + [(c[0], "churn", "sparse") for c in CONFIGS])


@pytest.mark.parametrize("label,dyn,layout", ONE_POD,
                         ids=[f"{c}-{d}-{lo}" for c, d, lo in ONE_POD])
def test_one_pod_without_a_group_bitwise_vmap(arrays, label, dyn, layout):
    """No process group: the default mesh is the one-pod mesh, whose
    gather is the identity (the matrix dense, churn on sparse)."""
    spec = _spec(label, dyn, layout)
    got = _run_exp(arrays, spec, "shard_map")
    want = _run_exp(arrays, spec, "vmap")
    assert got["n_pods"] == 1
    assert got["loss"] == want["loss"]
    _assert_bitwise(got, want)


def _grain(comm, params):
    if comm is None:
        return 0.0
    return max(float(np.abs(params[k][kk]).max())
               for k in params for kk in params[k]) / 127.0


@pytest.mark.parametrize("label", [c[0] for c in REFERENCE])
def test_four_pods_match_the_reference_vmap_lane(arrays, reference_init,
                                                 pods4, label):
    if reference_init is None:
        pytest.skip("the reference lane needs jax")
    runs, jarrays = reference_init
    # the pod runs use the port's own world: the reference's, array for
    # array (ring and synth-mnist use no random stream of JAX's)
    for k in ("adjacency", "weights", "x_test", "y_test"):
        np.testing.assert_array_equal(arrays[k], jarrays[k])
    for k in ("xs", "ys"):
        for a, b in zip(arrays[k], jarrays[k], strict=True):
            np.testing.assert_array_equal(a, b)
    want = runs[label]
    got = pods4[0][("ref", label)]
    bound = (1e-6 if _config(label)[1] is None
             else 1e-4 + _grain(_config(label)[1], want["params"]))
    for layer in want["params"]:
        for leaf in want["params"][layer]:
            np.testing.assert_allclose(got["params"][layer][leaf],
                                       want["params"][layer][leaf],
                                       rtol=0, atol=bound)
    for a, b in zip(got["acc"], want["acc"]):
        np.testing.assert_array_equal(a, b)
    assert got["trig"] == want["trig"]
    if _config(label)[1] is not None:
        assert got["bytes"] == want["bytes"][-1] > 0


@pytest.mark.parametrize("n_pods", [2, 4])
@pytest.mark.parametrize("form", LM_FORMS)
def test_lm_pod_round(request, lm_reference, form, n_pods):
    """Two pods of two nodes, and four of one: bitwise the port's one-pod
    form, and within 1e-4 (params) / 1e-5 (loss) of the reference's
    `build_dfl_round`."""
    if lm_reference is None:
        pytest.skip("the LM round's init comes from the reference")
    ranks = request.getfixturevalue(f"pods{n_pods}")
    lm_in, want = lm_reference
    one_p, one_l = _run_lm(lm_in, form, None, slice(0, LM_NODES))
    blocks = [rank[("lm", form)] for rank in ranks]
    losses = blocks[0][1]
    assert all(b[1] == losses for b in blocks)  # every rank: the pods' mean
    np.testing.assert_allclose(losses, one_l, rtol=0, atol=1e-6)
    np.testing.assert_allclose(losses, want[form][1], rtol=0, atol=1e-5)
    leaves = [tree_leaves(b[0]) for b in blocks]
    for i, (full, ref) in enumerate(zip(tree_leaves(one_p),
                                        tree_leaves(want[form][0]))):
        pods = np.concatenate([lv[i] for lv in leaves])
        np.testing.assert_array_equal(pods, full)
        np.testing.assert_allclose(pods.astype(np.float32), ref, rtol=0,
                                   atol=1e-4)


# ------------------------------------------------------------ partitions

PARTITION_GRAPHS = {
    "barabasi_albert": dict(n=13, m=2, seed=3),
    "erdos_renyi": dict(n=13, p=0.3, seed=5),
    "ring": dict(n=13),
}


def _topologies(kind):
    """The reference's graph, and the port's Topology over its arrays (the
    BA sampler differs without networkx, so the arrays are carried)."""
    pytest.importorskip("jax")
    from repro.graphs.topology import make_topology as jmake
    from repro_torch.graphs.topology import Topology

    jt = jmake(kind, **PARTITION_GRAPHS[kind])
    return jt, Topology(**{f.name: getattr(jt, f.name)
                           for f in dataclasses.fields(Topology)})


@pytest.mark.parametrize("pods", [1, 2, 3, 4])
@pytest.mark.parametrize("kind", sorted(PARTITION_GRAPHS))
def test_partition_matches_the_reference(kind, pods):
    """`map_graph_to_pods` gives the reference's groups (±1 sizes, BFS from
    the highest-degree node) and `pod_adjacency` its float32 cut weights,
    bitwise."""
    from repro.graphs.partition import map_graph_to_pods as jmap
    from repro.graphs.partition import pod_adjacency as jadj
    from repro_torch.graphs import map_graph_to_pods, pod_adjacency

    jt, tt = _topologies(kind)
    groups = map_graph_to_pods(tt, pods)
    assert groups == jmap(jt, pods)
    assert sorted(len(g) for g in groups)[-1] - min(len(g) for g in groups) \
        <= 1
    want = jadj(jt, jmap(jt, pods))
    got = pod_adjacency(tt, groups)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_partition_errors_match_the_reference():
    from repro.graphs.partition import map_graph_to_pods as jmap
    from repro_torch.graphs import map_graph_to_pods

    jt, tt = _topologies("ring")
    for pods in (0, 14):
        with pytest.raises(ValueError) as want:
            jmap(jt, pods)
        with pytest.raises(ValueError) as got:
            map_graph_to_pods(tt, pods)
        assert str(got.value) == str(want.value)


# ---------------------------------------------------------------- errors

def test_mesh_errors_match_the_reference():
    """A mesh without a pod dimension, and a node count that does not tile
    the pods, raise the reference's messages."""
    from repro_torch.dist.dfl_step import build_dfl_round
    from repro_torch.dist.dfl_step import build_dfl_round_shardmap
    from repro_torch.launch.mesh import OnePodMesh, pod_axis

    world = World.synthetic(dataset="synth-mnist", nodes=6, topology="ring",
                            seed=3, scale=0.02, device="cpu")
    with pytest.raises(ValueError, match="needs a mesh with a 'pod' axis"):
        Experiment(world, backend="shard_map", device="cpu",
                   mesh=types.SimpleNamespace(mesh_dim_names=("data",)))
    with pytest.raises(ValueError, match="needs a mesh with a 'pod' axis"):
        pod_axis(None)
    four = types.SimpleNamespace(
        mesh_dim_names=("pod",), size=lambda dim: 4,
        get_local_rank=lambda dim: 0, get_group=lambda dim: None)
    with pytest.raises(ValueError,
                       match="6 DFL nodes do not tile the 4-pod axis"):
        Experiment(world, backend="shard_map", device="cpu", mesh=four)
    assert pod_axis(OnePodMesh()) == (1, 0, None)
    # the LM round: no pod dimension gives the vmap form
    lm, opt, adj = _lm_setup()
    flat = build_dfl_round_shardmap(
        lm, opt, adj, types.SimpleNamespace(mesh_dim_names=("data",)))
    assert flat.__code__ is build_dfl_round(lm, opt, adj).__code__
    three = types.SimpleNamespace(
        mesh_dim_names=("pod",), size=lambda dim: 3,
        get_local_rank=lambda dim: 0, get_group=lambda dim: None)
    with pytest.raises(ValueError,
                       match="4 DFL nodes do not tile the 3-pod axis"):
        build_dfl_round_shardmap(lm, opt, adj, three)


def test_default_mesh_with_a_group_is_one_pod_per_rank(tmp_path):
    """With a process group the default mesh has one pod per rank, and N
    must tile it."""
    from repro_torch.engine.experiment import _default_mesh

    store = dist.FileStore(str(tmp_path / "store"), 1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    try:
        mesh = _default_mesh(6, torch.device("cpu"))
        assert mesh.mesh_dim_names == ("pod",)
        assert mesh.size(0) == 1
    finally:
        dist.destroy_process_group()
