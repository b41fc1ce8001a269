"""The event clock (`repro_torch.timing`) against the JAX package, on the CPU.

  (a) every node model's and link model's bound tables, and the dense
      `transfer_panel`, bitwise the reference's (numpy draws seeded at bind
      time, copied draw for draw), on dense and sparse bindings of one
      graph; `past_end_index`, the registries and the validation errors;
  (b) the clock inside `Experiment`, in-port oracles, all bitwise: the
      degenerate `Timing()` equals `timing=None` (both layouts, loop and
      fused, with and without a transport); under `Schedule(deadline=d)`
      the simulated time after round r is exactly (r+1)·d, and the
      synchronous tick is the makespan recomputed here in float32; a
      payload that misses every deadline is never received, in `stale`
      and in `drop` mode (the run equals the one whose graph lacks that
      link, bytes apart: a late payload still burns the sender's bytes);
  (c) `BENCH_time.json`'s synchronous clock: `bench_time.py`'s 16-node BA
      world with its links and `LognormalStep(1.0, 0.5, seed=7)`, fp32
      per node, no deadline — the port's simulated seconds after rounds
      0, 5 and 10 equal the committed history's (the training does not
      move the clock).

The engine runs against JAX under timing are in
tests/test_torch_dynamics.py, next to the processes they drive.
"""
import json
import os
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import repro.timing as jt  # noqa: E402
import repro_torch.timing as tt  # noqa: E402
from repro.graphs.sparse import SparseTopology as JSparse  # noqa: E402
from repro.graphs.topology import make_topology as jmake_topology  # noqa: E402
from repro_torch.comm import CommConfig  # noqa: E402
from repro_torch.dynamics import ScriptedGraph  # noqa: E402
from repro_torch.engine import Experiment, Schedule, World  # noqa: E402
from repro_torch.graphs.sparse import SparseTopology  # noqa: E402
from repro_torch.graphs.topology import _from_adjacency  # noqa: E402
from repro_torch.models.mlp_cnn import make_mlp  # noqa: E402
from repro_torch.utils.pytree import tree_leaves  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# benchmarks/bench_time.py's links
LINK = dict(latency_median=0.05, latency_sigma=0.5, bandwidth_median=1e5,
            bandwidth_sigma=0.5, seed=11)
SMALL = dict(nodes=16, topology="barabasi_albert", m=2, scale=0.03)
TRAIN = dict(steps_per_round=2, batch_size=32)


def _graphs():
    """(reference topo, port topo) pairs: dense and sparse of two graphs."""
    out = []
    for name, kw in (("barabasi_albert", dict(n=16, m=2, seed=0)),
                     ("erdos_renyi", dict(n=12, p=0.3, seed=3))):
        jtop = jmake_topology(name, **kw)
        ttop = _from_adjacency(jtop.name, jtop.adjacency)
        out.append((f"{name}-dense", jtop, ttop))
        out.append((f"{name}-sparse", JSparse.from_topology(jtop),
                    SparseTopology.from_topology(ttop)))
    return out


GRAPHS = _graphs()


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads: the suite runs several worker processes at
    once, and every worker spinning a thread per core slows them all."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)

NODE_MODELS = [
    ("constant", dict(dt=0.7)),
    ("lognormal", dict(median=1.0, sigma=0.5, seed=7)),
    ("lognormal", dict(median=2.5, sigma=0.0, seed=1)),
    ("straggler", dict(dt=1.0, frac=0.1, factor=8.0, seed=5)),
    ("straggler", dict(dt=0.5, frac=0.0)),
]

LINK_MODELS = [
    ("constant", dict()),
    ("constant", dict(latency=0.02, bandwidth=3e5)),
    ("lognormal", dict()),
    ("lognormal", LINK),
    ("table", dict(latency=0.1, bandwidth=2e5)),
]

# ------------------------------------------------------------- (a) tables


@pytest.mark.parametrize("name,kw", NODE_MODELS)
def test_node_model_tables_bitwise(name, kw):
    for n in (16, 5):
        jf = jt.make_node_model(name, **kw).bind(n)
        tf = tt.make_node_model(name, **kw).bind(n, "cpu")
        for r in (0, 3):
            j, t = np.asarray(jf(r)), tf(r).numpy()
            assert t.dtype == np.float32 and t.shape == (n,)
            np.testing.assert_array_equal(t, j)
    strag = dict(kw) if name == "straggler" else None
    if strag is not None:
        np.testing.assert_array_equal(tt.StragglerStep(**strag).slow_nodes(20),
                                      jt.StragglerStep(**strag).slow_nodes(20))


@pytest.mark.parametrize("past_end", tt.PAST_END)
def test_trace_step_past_end_bitwise(past_end):
    table = np.random.default_rng(2).uniform(0.5, 3.0, (3, 6))
    jf = jt.TraceStep(table=table, past_end=past_end).bind(6)
    tf = tt.TraceStep(table=table, past_end=past_end).bind(6, "cpu")
    for r in range(8):
        assert tt.past_end_index(r, 3, past_end) == int(
            jt.past_end_index(r, 3, past_end))
        np.testing.assert_array_equal(tf(r).numpy(), np.asarray(jf(r)))


@pytest.mark.parametrize("name,kw", LINK_MODELS)
@pytest.mark.parametrize("graph", [g[0] for g in GRAPHS])
def test_link_tables_and_panel_bitwise(graph, name, kw):
    _, jtop, ttop = next(g for g in GRAPHS if g[0] == graph)
    payload = 210600.0
    jb = jt.Timing(node=jt.LognormalStep(seed=7),
                   link=jt.make_link_model(name, **kw)).bind(jtop, payload)
    tb = tt.Timing(node=tt.LognormalStep(seed=7),
                   link=tt.make_link_model(name, **kw)).bind(ttop, payload,
                                                             "cpu")
    assert tb.payload_bytes == jb.payload_bytes
    assert tb.is_dense == jb.is_dense == graph.endswith("dense")
    np.testing.assert_array_equal(tb.transfer_e.numpy(),
                                  np.asarray(jb.transfer_e))
    if tb.is_dense:
        np.testing.assert_array_equal(tb.transfer_panel.numpy(),
                                      np.asarray(jb.transfer_panel))
    np.testing.assert_array_equal(tb.step_time(4).numpy(),
                                  np.asarray(jb.step_time(4)))
    assert float(tb.state0.t) == 0.0 and tb.state0.t.dtype == torch.float32
    np.testing.assert_array_equal(tb.state0.last_cost.numpy(),
                                  np.asarray(jb.state0.last_cost))


def test_table_link_arrays_bitwise():
    for graph, jtop, ttop in GRAPHS:
        e = int(jtop.adjacency.sum()) if graph.endswith("dense") \
            else jtop.num_directed
        rng = np.random.default_rng(9)
        lat, bw = rng.uniform(0, 0.2, e), rng.uniform(1e4, 1e6, e)
        j = jt.TableLink(latency=lat, bandwidth=bw).bind(jtop, 1234.0)
        t = tt.TableLink(latency=lat, bandwidth=bw).bind(ttop, 1234.0)
        np.testing.assert_array_equal(t, j)


def _err(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - the type is what is compared
        return type(e).__name__, str(e)
    return None


def test_validation_errors_match_the_reference():
    _, jtop, ttop = GRAPHS[0]
    cases = [
        ("ConstantStep", dict(dt=0.0)),
        ("LognormalStep", dict(median=-1.0)),
        ("LognormalStep", dict(sigma=-0.1)),
        ("StragglerStep", dict(frac=1.5)),
        ("StragglerStep", dict(factor=0.0)),
        ("TraceStep", dict(table=np.zeros((2, 2)))),
        ("TraceStep", dict(table=np.ones(3))),
        ("TraceStep", dict(table=np.ones((1, 2)), past_end="loop")),
        ("LognormalLink", dict(bandwidth_median=0.0)),
        ("LognormalLink", dict(latency_sigma=-1.0)),
    ]
    for cls, kw in cases:
        got = _err(lambda: getattr(tt, cls)(**kw))
        assert got is not None and got == _err(
            lambda: getattr(jt, cls)(**kw)), (cls, kw, got)
    binds = [
        (lambda m: m.TraceStep(table=np.ones((2, 2))).bind(3)),
        (lambda m: m.ConstantLink(latency=-1.0).bind(
            jtop if m is jt else ttop, 4.0)),
        (lambda m: m.ConstantLink(bandwidth=0.0).bind(
            jtop if m is jt else ttop, 4.0)),
        (lambda m: m.TableLink(latency=np.zeros(3)).bind(
            jtop if m is jt else ttop, 4.0)),
        (lambda m: m.make_node_model("warp")),
        (lambda m: m.make_link_model("warp")),
        (lambda m: m.Timing(node=m.ConstantLink()).bind(
            jtop if m is jt else ttop, 4.0)),
        (lambda m: m.Timing(link=m.ConstantStep()).bind(
            jtop if m is jt else ttop, 4.0)),
    ]
    for fn in binds:
        got = _err(lambda: fn(tt))
        assert got is not None and got == _err(lambda: fn(jt)), got
    assert sorted(tt.NODE_MODELS) == sorted(jt.NODE_MODELS)
    assert sorted(tt.LINK_MODELS) == sorted(jt.LINK_MODELS)
    assert tt.PAST_END == jt.PAST_END


# ------------------------------------------------------------ (b) oracles

def _world(**kw):
    return World.synthetic("synth-mnist", model=make_mlp(hidden=(64, 32)),
                           device="cpu", **SMALL, **kw)


def _run(world, comm=None, layout=None, mode="loop", deadline=None,
         rounds=3, method="decdiff+vt"):
    exp = Experiment(world, method, device="cpu", comm=comm, layout=layout,
                     schedule=Schedule(rounds=rounds, eval_every=1, mode=mode,
                                       deadline=deadline), **TRAIN)
    return exp, exp.run()


def _same_run(a, b, bytes_too=True):
    (ea, ha), (eb, hb) = a, b
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(ea.params),
                                                 tree_leaves(eb.params)))
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(ea.opt_state),
                                                 tree_leaves(eb.opt_state)))
    assert ea.train_loss_history == eb.train_loss_history
    for ma, mb in zip(ha, hb):
        np.testing.assert_array_equal(ma.acc_per_node, mb.acc_per_node)
        if bytes_too:
            assert ma.bytes_on_wire == mb.bytes_on_wire
            assert ma.triggered_frac == mb.triggered_frac


EDGE_INT8 = CommConfig(codec="int8", policy="adaptive", target_trigger=0.95,
                       stochastic=False)


@pytest.mark.parametrize("comm", [None, EDGE_INT8], ids=["none", "edge"])
@pytest.mark.parametrize("mode", ["loop", "fused"])
@pytest.mark.parametrize("layout", ["dense", "sparse"])
def test_degenerate_timing_is_no_timing(layout, mode, comm):
    base = _run(_world(), comm, layout, mode)
    timed = _run(_world(timing=tt.Timing()), comm, layout, mode)
    _same_run(base, timed)
    exp, hist = timed
    # unit steps, instant links: the synchronous tick is steps_per_round
    assert exp.sim_time_history == [2.0, 4.0, 6.0]
    assert [m.sim_time for m in hist] == [2.0, 4.0, 6.0]
    assert exp.arrived_history == [1.0] * 3
    assert base[0].sim_time_history == [] and hist[0].arrived_frac == 1.0


def _makespans(exp, bound):
    """The synchronous ticks recomputed in numpy float32: the slowest
    node's compute, then the slowest landing t_cost[src] + transfer."""
    dt = bound.step_time(0).numpy()
    t_cost = (np.float32(exp.train.steps_per_round) * dt).astype(np.float32)
    e_src = (exp.topo.edge_src if exp.layout == "sparse"
             else np.nonzero(exp.topo.adjacency)[1])
    land = (t_cost[e_src] + bound.transfer_e.numpy()).astype(np.float32)
    tick = np.float32(max(t_cost.max(), land.max()))
    t, out = np.float32(0.0), []
    for _ in range(3):
        t = np.float32(t + tick)
        out.append(float(t))
    return out


@pytest.mark.parametrize("layout", ["dense", "sparse"])
def test_deadline_ticks_and_synchronous_makespan(layout):
    timing = tt.Timing(tt.LognormalStep(1.0, 0.5, seed=7),
                       tt.LognormalLink(**LINK))
    sync, _ = _run(_world(timing=timing), EDGE_INT8, layout)
    assert sync.sim_time_history == _makespans(sync, sync.bound_timing)
    for mode in ("loop", "fused"):
        exp, hist = _run(_world(timing=timing), EDGE_INT8, layout, mode,
                         deadline=2.5)
        assert exp.sim_time_history == [2.5, 5.0, 7.5]
        assert [m.sim_time for m in hist] == [2.5, 5.0, 7.5]
        assert all(0.0 < a < 1.0 for a in exp.arrived_history)


def _late_link_world(layout_pairs, timing=True):
    """The small world whose links on `layout_pairs` (undirected pairs,
    canonical order) never land by the deadline: latency 1e9 s there,
    instant elsewhere, unit steps."""
    world = _world()
    topo = world.topo
    dst, src = np.nonzero(topo.adjacency)  # (dst, src)-sorted
    lo, hi = np.minimum(src, dst), np.maximum(src, dst)
    iu, ju = np.nonzero(np.triu(topo.adjacency, 1))
    slow = np.zeros(src.shape, bool)
    for p in layout_pairs:
        slow |= (lo == iu[p]) & (hi == ju[p])
    if timing:
        world.timing = tt.Timing(tt.ConstantStep(1.0),
                                 tt.TableLink(latency=np.where(slow, 1e9, 0.0)))
    return world, int(iu.shape[0]), int(slow.sum())


@pytest.mark.parametrize("on_silence", ["stale", "drop"])
@pytest.mark.parametrize("layout", ["dense", "sparse"])
def test_late_payload_is_never_received(layout, on_silence):
    comm = CommConfig(codec="int8", stochastic=False, on_silence=on_silence)
    late_pairs = [0, 3, 7]
    world, m, n_late = _late_link_world(late_pairs)
    late = _run(world, comm, layout, deadline=10.0)
    # the same world without those links: a ScriptedGraph holding the
    # pairs down every round, and no clock
    coins = np.ones((1, m), np.float32)
    coins[0, late_pairs] = 0.0
    gone_world, _, _ = _late_link_world(late_pairs, timing=False)
    gone_world.dynamics = ScriptedGraph(coins)
    gone = _run(gone_world, comm, layout)
    _same_run(late, gone, bytes_too=False)
    exp = late[0]
    n_dir = exp._total_directed
    assert exp.arrived_history == [(n_dir - n_late) / n_dir] * 3
    # the late links' receivers never recorded a delivery ...
    ever = exp.comm_state.ever_recv
    if layout == "dense":
        t_slow = (exp.bound_timing.transfer_panel > 1.0)
    else:
        t_slow = (exp.bound_timing.transfer_e > 1.0)
    assert int(t_slow.sum()) == n_late
    assert float(ever[t_slow].sum()) == 0.0
    assert float(ever[~t_slow & (ever >= 0)].sum()) > 0
    # ... while their senders paid for them: always send, every edge
    payload = exp.transport.payload_bytes
    assert late[1][-1].bytes_on_wire == payload * n_dir * 3
    assert gone[1][-1].bytes_on_wire == payload * (n_dir - n_late) * 3


# ----------------------------------------------- (c) BENCH_time's clock

def test_bench_time_synchronous_clock():
    from repro_torch.timing import LognormalLink, LognormalStep, Timing

    with open(os.path.join(ROOT, "BENCH_time.json")) as f:
        row = json.load(f)["rows"][0]
    assert (row["world"], row["config"], row["deadline"]) == \
        ("ba", "sync-fp32", None)
    world = World.synthetic(
        dataset="synth-mnist", nodes=16, seed=0, scale=0.03,
        model=make_mlp(num_classes=10, hidden=(64, 32)),
        timing=Timing(node=LognormalStep(median=1.0, sigma=0.5, seed=7),
                      link=LognormalLink(**LINK)),
        topology="barabasi_albert", m=2, device="cpu")
    exp = Experiment(world, "decdiff+vt", comm=CommConfig(codec="fp32"),
                     schedule=Schedule(rounds=11, eval_every=5),
                     steps_per_round=4, batch_size=32, lr=0.1, momentum=0.9,
                     seed=0, device="cpu")
    assert exp.transport.payload_bytes == row["payload_bytes"]
    hist = exp.run()
    assert [m.round for m in hist] == [0, 5, 10]
    want = [t for t, _ in row["history"][:3]]
    # the committed times are float32 values printed as float64
    assert [np.float32(m.sim_time) for m in hist] == \
        [np.float32(t) for t in want]
    assert all(m.arrived_frac == 1.0 for m in hist)


def test_experiment_refusals():
    with pytest.raises(ValueError, match="needs World\\(timing"):
        Experiment(_world(), "decdiff+vt", device="cpu",
                   schedule=Schedule(deadline=1.0), **TRAIN)
    with pytest.raises(ValueError, match="deadline"):
        Schedule(deadline=-1.0)
    world = _world()
    world.timing = tt.ConstantStep()
    with pytest.raises(TypeError, match="repro_torch.timing.Timing"):
        Experiment(world, "decdiff+vt", device="cpu", **TRAIN)
    with pytest.raises(TypeError, match="repro_torch.obs.Telemetry"):
        Experiment(_world(telemetry=object()), "decdiff+vt", device="cpu",
                   **TRAIN)
    # the pod backend (A.10) is ported: without a process group it runs
    # one pod, and a mesh without a pod dimension is refused
    with pytest.raises(ValueError, match="needs a mesh with a 'pod' axis"):
        Experiment(_world(), "decdiff+vt", device="cpu",
                   backend="shard_map", **TRAIN,
                   mesh=types.SimpleNamespace(mesh_dim_names=()))
