"""Time-varying graphs (`repro_torch.dynamics`) against the JAX package, on
the CPU.

  (a) transition by transition: `edge_dropout`, `gilbert_elliott` and
      `node_churn` fed the reference's own `jax.random.uniform(key, shape)`
      give `live`, `alive`, `rejoined` and the state bitwise equal over 6
      rounds, dense [N, max_deg] and sparse [E]; `static`,
      `periodic_rewiring` (union layout and phase schedule), `scripted`
      (pair-coin and adjacency tables, `wrap` / `clamp`) and
      `energy_churn` (one observation stream) are deterministic and
      bitwise equal outright; the closed-form stationary fractions, the
      registry and the validation errors match;
  (b) `Experiment` against JAX, 3–4 loop rounds on the 16-node BA world of
      tests/test_torch_roster.py (MLP 784-64-32-10, 2 local steps of batch
      32), from the reference's init: `ScriptedGraph` with one recorded
      pair-coin table under {no transport, per-node int8 with a 0.8
      trigger, per-edge int8 adaptive 0.95} x {dense, sparse} (the sparse
      layout's per-edge transport is `SparseEdgeGossipTransport`), and
      `EnergyChurn` under `Timing(LognormalStep, LognormalLink)` with and
      without a deadline for `decdiff+vt`, `fedavg` and `cfa-ge` (its
      deaths and rejoins are a function of the numpy-seeded step times, so
      both packages realize the same sequence; at least one node dies and
      rejoins, asserted).  Tolerances as tests/test_torch_roster.py set
      them: params within 1e-6 without a transport, 1e-4 plus one int8
      grain with one; accuracies within one test sample; bytes, triggered,
      live and arrived fractions and simulated seconds exactly equal;
  (c) in-port oracles, bitwise: `StaticGraph()` equals `dynamics=None`;
      fused equals loop, and dense equals sparse, under every process; a
      dead node's params and optimizer state freeze and it pays no bytes;
      a rejoin resets only the rejoined rows and their incident edges
      (per-node, dense per-edge and sparse per-edge, the last also against
      the reference's `reset_edges`).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import repro.dynamics as jd  # noqa: E402
import repro.timing as jt  # noqa: E402
import repro_torch.dynamics as td  # noqa: E402
import repro_torch.timing as tt  # noqa: E402
from repro.graphs.sparse import SparseTopology as JSparse  # noqa: E402
from repro.graphs.topology import make_topology as jmake_topology  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.comm import (CommConfig, EdgeGossipTransport,  # noqa: E402
                              GossipTransport, SparseEdgeGossipTransport)
from repro_torch.engine import Experiment, Schedule, World  # noqa: E402
from repro_torch.graphs.sparse import SparseTopology  # noqa: E402
from repro_torch.graphs.topology import _from_adjacency  # noqa: E402
from repro_torch.models.mlp_cnn import make_mlp  # noqa: E402
from repro_torch.utils.pytree import tree_leaves  # noqa: E402

WORLD = dict(nodes=16, topology="barabasi_albert", m=2, scale=0.03)
TRAIN = dict(steps_per_round=2, batch_size=32)
# benchmarks/bench_time.py's links at 10x the bandwidth
LINK = dict(latency_median=0.05, latency_sigma=0.5, bandwidth_median=1e6,
            bandwidth_sigma=0.5, seed=11)
NODE = dict(median=1.0, sigma=0.5, seed=7)
ENERGY = dict(capacity=3.0, recharge=4.0, rejoin_at=2.0)
DEADLINE = 2.5


def _graphs():
    jtop = jmake_topology("barabasi_albert", n=16, m=2, seed=0)
    ttop = _from_adjacency(jtop.name, jtop.adjacency)
    return {"dense": (jtop, ttop),
            "sparse": (JSparse.from_topology(jtop),
                       SparseTopology.from_topology(ttop))}


GRAPHS = _graphs()


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads: the suite runs several worker processes at
    once, and every worker spinning a thread per core slows them all."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _np(t):
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _same_event(jev, tev):
    for f in ("live", "alive", "rejoined"):
        a, b = _np(getattr(tev, f)), np.asarray(getattr(jev, f))
        assert a.dtype == np.float32 and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)


def _same_state(js, ts):
    jl = jax.tree.leaves(js)
    tl = list(ts) if isinstance(ts, tuple) else [ts]
    assert len(jl) == len(tl)
    for a, b in zip(tl, jl):
        np.testing.assert_array_equal(_np(a), np.asarray(b))


# ------------------------------------------------------ (a) transitions

RANDOM = [("edge_dropout", dict(p=0.3)),
          ("gilbert_elliott", dict(p_gb=0.2, p_bg=0.3)),
          ("node_churn", dict(p_leave=0.3, p_rejoin=0.5))]


@pytest.mark.parametrize("layout", ["dense", "sparse"])
@pytest.mark.parametrize("name,kw", RANDOM, ids=[r[0] for r in RANDOM])
def test_random_transitions_fed_the_reference_uniforms(name, kw, layout):
    jtop, ttop = GRAPHS[layout]
    jb = jd.make_process(name, **kw).bind(jtop)
    tb = td.make_process(name, **kw).bind(ttop, "cpu")
    assert tb.needs_rng and not tb.observes
    m = int(np.triu(jtop.adjacency if layout == "dense"
                    else jtop.to_topology().adjacency, 1).sum())
    assert tb.draw_shape == ((16,) if name == "node_churn" else (m,))
    js, ts = jb.state0, tb.state0
    _same_state(js, ts)
    rejoins = 0
    for r in range(6):
        key = jax.random.PRNGKey(100 + r)
        u = np.asarray(jax.random.uniform(key, tb.draw_shape, jnp.float32))
        js, jev = jb.step(js, jnp.int32(r), key)
        ts, tev = tb.transition(ts, r, torch.tensor(u))
        _same_event(jev, tev)
        _same_state(js, ts)
        rejoins += int(tev.rejoined.sum())
    if name == "node_churn":
        assert rejoins > 0
    # the port's own draw: one torch.rand of that shape from the generator
    g1, g2 = (torch.Generator().manual_seed(3) for _ in range(2))
    assert torch.equal(tb.draw(g1), torch.rand(tb.draw_shape, generator=g2))


@pytest.mark.parametrize("layout", ["dense", "sparse"])
def test_deterministic_processes_bitwise(layout):
    jtop, ttop = GRAPHS[layout]
    dense_j = GRAPHS["dense"][0]
    m = int(np.triu(dense_j.adjacency, 1).sum())
    rng = np.random.default_rng(4)
    coins = rng.integers(0, 2, (3, m)).astype(np.float32)
    adj = np.zeros((4, 16, 16), np.float32)
    for t in range(4):
        a = np.triu(rng.integers(0, 2, (16, 16)), 1)
        adj[t] = a + a.T
    obs = rng.uniform(0.0, 2.5, (8, 16)).astype(np.float32)
    cases = [("static", dict()),
             ("scripted", dict(tables=coins, past_end="wrap")),
             ("scripted", dict(tables=coins, past_end="clamp")),
             ("scripted", dict(tables=adj, past_end="wrap")),
             ("energy_churn", ENERGY),
             ("periodic_rewiring", dict(period=2, num_graphs=3)),
             ("periodic_rewiring", dict(period=1, num_graphs=4,
                                        topology="erdos_renyi",
                                        topo_kwargs=dict(p=0.3)))]
    for name, kw in cases:
        jb = jd.make_process(name, **kw).bind(jtop)
        tb = td.make_process(name, **kw).bind(ttop, "cpu")
        assert not tb.needs_rng and tb.draw(None) is None
        assert tb.stationary_live_frac == jb.stationary_live_frac
        if name == "periodic_rewiring":  # the union layout
            arrays = (("edge_src", "edge_dst", "edge_weight", "row_offsets")
                      if layout == "sparse" else
                      ("adjacency", "weights", "neighbor_idx",
                       "neighbor_mask"))
            for a in arrays:
                np.testing.assert_array_equal(getattr(tb.topo, a),
                                              getattr(jb.topo, a))
            assert tb.topo.name == jb.topo.name
        js, ts = jb.state0, tb.state0
        rejoined = 0
        for r in range(8):
            if tb.observes:
                js, jev = jb.step(js, jnp.int32(r), None, jnp.asarray(obs[r]))
                ts, tev = tb.transition(ts, r, None, torch.from_numpy(obs[r]))
            else:
                js, jev = jb.step(js, jnp.int32(r), None)
                ts, tev = tb.transition(ts, r, None)
            _same_event(jev, tev)
            _same_state(js, ts)
            rejoined += int(tev.rejoined.sum())
        if name == "energy_churn":
            assert rejoined > 0


def test_closed_forms_registry_and_errors():
    assert sorted(td.PROCESSES) == sorted(jd.PROCESSES)
    for name, kw in RANDOM + [("static", {})]:
        assert td.make_process(name, **kw).stationary_live_frac() == \
            jd.make_process(name, **kw).stationary_live_frac()
    nc = dict(p_leave=0.1, p_rejoin=0.4)
    assert td.NodeChurn(**nc).stationary_alive_frac() == \
        jd.NodeChurn(**nc).stationary_alive_frac()
    assert td.PeriodicRewiring().stationary_live_frac() is None

    def err(mod, fn):
        try:
            fn(mod)
        except Exception as e:  # noqa: BLE001 - the type is compared
            return type(e).__name__, str(e)
        return None

    ring_j = jmake_topology("ring", n=3)
    ring_t = _from_adjacency(ring_j.name, ring_j.adjacency)
    ring = {jd: (ring_j,), td: (ring_t, "cpu")}
    asym = np.zeros((1, 3, 3), np.float32)
    asym[0, 0, 1] = 1.0
    fns = [
        lambda m: m.make_process("wormhole"),
        lambda m: m.EdgeDropout(p=1.5),
        lambda m: m.GilbertElliott(p_gb=1.2),
        lambda m: m.GilbertElliott(p_bg=0.0),
        lambda m: m.NodeChurn(p_leave=1.0),
        lambda m: m.NodeChurn(p_rejoin=0.0),
        lambda m: m.PeriodicRewiring(period=0),
        lambda m: m.PeriodicRewiring(num_graphs=0),
        lambda m: m.ScriptedGraph(tables=np.ones((1, 2, 2)), past_end="loop"),
        lambda m: m.ScriptedGraph(tables=np.full((1, 2, 2), 0.5)),
        lambda m: m.ScriptedGraph(tables=np.ones((1, 2, 3))),
        lambda m: m.ScriptedGraph(tables=np.ones(3)),
        lambda m: m.ScriptedGraph(tables=asym).bind(*ring[m]),
        lambda m: m.ScriptedGraph(tables=np.ones((1, 5))).bind(*ring[m]),
        lambda m: m.ScriptedGraph(tables=np.ones((1, 4, 4))).bind(*ring[m]),
        lambda m: m.EnergyChurn(capacity=0.0),
        lambda m: m.EnergyChurn(recharge=0.0),
        lambda m: m.EnergyChurn(capacity=4.0, rejoin_at=5.0),
    ]
    for fn in fns:
        got = err(td, fn)
        assert got is not None and got == err(jd, fn), got


# ------------------------------------------------ (b) engine against JAX

@pytest.fixture(scope="module")
def jworld():
    from repro.engine import World as JWorld
    from repro.models.mlp_cnn import make_mlp as jmake_mlp

    return JWorld.synthetic("synth-mnist", model=jmake_mlp(hidden=(64, 32)),
                            **WORLD)


def _coins(jworld):
    m = int(np.triu(jworld.topo.adjacency, 1).sum())
    return np.random.default_rng(5).integers(0, 2, (3, m)).astype(np.float32)


def _both(jworld, method, cfg, layout, dyn, timing=None, deadline=None,
          rounds=3):
    """(reference Experiment, its history, port Experiment, its history)
    from the reference's init; `dyn` / `timing` are (name, kwargs) pairs
    built in each package."""
    from repro.comm import CommConfig as JCommConfig
    from repro.engine import Experiment as JExperiment
    from repro.engine import Schedule as JSchedule

    def build(dmod, tmod):
        d = dmod.make_process(dyn[0], **dyn[1])
        t = None if timing is None else tmod.Timing(
            tmod.LognormalStep(**timing[0]), tmod.LognormalLink(**timing[1]))
        return d, t

    jdyn, jtim = build(jd, jt)
    je = JExperiment(dataclasses.replace(jworld, dynamics=jdyn, timing=jtim),
                     method, layout=layout,
                     comm=None if cfg is None else JCommConfig(**cfg),
                     schedule=JSchedule(rounds=rounds, deadline=deadline),
                     **TRAIN)
    params0 = jax.tree.map(np.asarray, je.params)
    jhist = je.run(rounds=rounds, eval_every=1, mode="loop")
    tdyn, ttim = build(td, tt)
    tworld = convert.world_from_arrays(
        model=make_mlp(hidden=(64, 32)), adjacency=jworld.topo.adjacency,
        weights=jworld.topo.weights, xs=jworld.xs, ys=jworld.ys,
        x_test=jworld.x_test, y_test=jworld.y_test, device="cpu")
    tworld.dynamics, tworld.timing = tdyn, ttim
    exp = Experiment(tworld, method, device="cpu", layout=layout,
                     comm=None if cfg is None else CommConfig(**cfg),
                     schedule=Schedule(rounds=rounds, deadline=deadline),
                     **TRAIN)
    exp.params = convert.params_from_numpy(params0, "cpu")
    exp.opt_state = exp.optimizer.init(exp.params)
    if exp.transport is not None:
        exp.comm_state = exp.transport.init_state(exp.params)
    return je, jhist, exp, exp.run(rounds=rounds, eval_every=1, mode="loop")


def _check_against_jax(je, jhist, exp, thist, cfg, n_test):
    jparams = jax.tree.map(np.asarray, je.params)
    tparams = convert.params_to_numpy(exp.params)
    top = max(float(np.abs(jparams[k][kk]).max())
              for k in jparams for kk in jparams[k])
    bound = 1e-6 if cfg is None else 1e-4 + top / 127.0
    for layer in jparams:
        for leaf in jparams[layer]:
            np.testing.assert_allclose(tparams[layer][leaf],
                                       jparams[layer][leaf], rtol=0,
                                       atol=bound)
    assert [m.round for m in thist] == [m.round for m in jhist]
    used = (n_test // min(128, n_test)) * min(128, n_test)
    for jm, tm in zip(jhist, thist):
        assert np.abs(tm.acc_per_node - jm.acc_per_node).max() * used \
            <= 1.0 + 1e-6
        for f in ("bytes_on_wire", "triggered_frac", "live_edge_frac",
                  "sim_time", "arrived_frac"):
            assert getattr(tm, f) == getattr(jm, f), f
    assert exp.trig_history == list(je.trig_history)
    assert exp.live_history == je.live_history
    assert exp.sim_time_history == je.sim_time_history
    assert exp.arrived_history == je.arrived_history


SCRIPTED_COMMS = {
    "none": None,
    "int8-node-trigger": dict(codec="int8", stochastic=False,
                              trigger_threshold=0.8),
    "int8-edge-adaptive": dict(codec="int8", policy="adaptive",
                               target_trigger=0.95, stochastic=False),
}


@pytest.mark.parametrize("layout", ["dense", "sparse"])
@pytest.mark.parametrize("comm", sorted(SCRIPTED_COMMS))
def test_scripted_graph_matches_jax(jworld, comm, layout):
    cfg = SCRIPTED_COMMS[comm]
    je, jhist, exp, thist = _both(
        jworld, "decdiff+vt", cfg, layout,
        ("scripted", dict(tables=_coins(jworld))))
    assert 0.0 < min(exp.live_history) < 1.0
    if cfg is not None:
        assert thist[-1].bytes_on_wire > 0
    _check_against_jax(je, jhist, exp, thist, cfg, len(jworld.x_test))


def _alive_recorder(exp):
    """Record each round's [N] aliveness as the engine realizes it."""
    bound, seen = exp.bound_dyn, []
    inner = bound.transition

    def transition(*args):
        state, ev = inner(*args)
        seen.append(ev.alive.clone())
        return state, ev

    object.__setattr__(bound, "transition", transition)
    return seen


@pytest.mark.parametrize("deadline", [None, DEADLINE], ids=["sync", "dl"])
@pytest.mark.parametrize("method", ["decdiff+vt", "fedavg", "cfa-ge"])
def test_energy_churn_with_clock_matches_jax(jworld, method, deadline):
    je, jhist, exp, thist = _both(
        jworld, method, None, "dense", ("energy_churn", ENERGY),
        timing=(NODE, LINK), deadline=deadline, rounds=4)
    _check_against_jax(je, jhist, exp, thist, None, len(jworld.x_test))
    # the realized churn: someone dies, and someone comes back
    exp2 = Experiment(exp.world, method, device="cpu",
                      schedule=Schedule(rounds=4, deadline=deadline),
                      **TRAIN)
    alive = _alive_recorder(exp2)
    exp2.run(rounds=4, eval_every=4, mode="loop")
    alive = torch.stack(alive)
    assert (alive == 0).any()
    assert ((alive[:-1] == 0) & (alive[1:] == 1)).any()
    if deadline is not None:
        assert exp.sim_time_history == [2.5, 5.0, 7.5, 10.0]
        assert any(0.0 < a < 1.0 for a in exp.arrived_history)


# --------------------------------------------------- (c) in-port oracles

def _world(**kw):
    return World.synthetic("synth-mnist", model=make_mlp(hidden=(64, 32)),
                           device="cpu", **WORLD, **kw)


def _run(world, comm=None, layout=None, mode="loop", deadline=None,
         rounds=3, method="decdiff+vt"):
    exp = Experiment(world, method, device="cpu", comm=comm, layout=layout,
                     schedule=Schedule(rounds=rounds, eval_every=1, mode=mode,
                                       deadline=deadline), **TRAIN)
    return exp, exp.run()


FIELDS = ("bytes_on_wire", "triggered_frac", "live_edge_frac", "sim_time",
          "arrived_frac")


def _same_run(a, b, fields=FIELDS):
    (ea, ha), (eb, hb) = a, b
    for x, y in zip(tree_leaves(ea.params) + tree_leaves(ea.opt_state),
                    tree_leaves(eb.params) + tree_leaves(eb.opt_state)):
        assert torch.equal(x, y)
    assert ea.train_loss_history == eb.train_loss_history
    assert len(ha) == len(hb)
    for ma, mb in zip(ha, hb):
        np.testing.assert_array_equal(ma.acc_per_node, mb.acc_per_node)
        for f in fields:
            assert getattr(ma, f) == getattr(mb, f), f
    assert ea.trig_history == eb.trig_history


EDGE = CommConfig(codec="int8", policy="adaptive", target_trigger=0.95,
                  stochastic=False)
NODE_T = CommConfig(codec="int8", stochastic=False, trigger_threshold=0.8)


@pytest.mark.parametrize("comm", [None, EDGE, NODE_T],
                         ids=["none", "edge", "node"])
@pytest.mark.parametrize("mode", ["loop", "fused"])
@pytest.mark.parametrize("layout", ["dense", "sparse"])
def test_static_graph_is_no_dynamics(layout, mode, comm):
    base = _run(_world(), comm, layout, mode)
    static = _run(_world(dynamics=td.StaticGraph()), comm, layout, mode)
    _same_run(base, static, FIELDS[:2])
    assert static[0].live_history == [1.0] * 3
    assert all(m.live_edge_frac == 1.0 for m in static[1])


PROCESSES = [
    ("static", dict()),
    ("edge_dropout", dict(p=0.3)),
    ("gilbert_elliott", dict(p_gb=0.3, p_bg=0.3)),
    ("node_churn", dict(p_leave=0.3, p_rejoin=0.5)),
    ("periodic_rewiring", dict(period=1, num_graphs=3)),
    ("scripted", dict(tables=np.random.default_rng(6).integers(
        0, 2, (2, 28)).astype(np.float32))),
    ("energy_churn", ENERGY),
]


def _process_world(name, kw):
    world = _world()
    if name == "scripted":  # this world's pair count
        m = int(np.triu(world.topo.adjacency, 1).sum())
        kw = dict(tables=np.random.default_rng(6).integers(
            0, 2, (2, m)).astype(np.float32))
    world.dynamics = td.make_process(name, **kw)
    world.timing = tt.Timing(tt.LognormalStep(**NODE),
                             tt.LognormalLink(**LINK))
    return world


@pytest.mark.parametrize("name,kw", PROCESSES, ids=[p[0] for p in PROCESSES])
def test_fused_equals_loop_and_dense_equals_sparse(name, kw):
    runs = {}
    for layout, mode in (("dense", "loop"), ("dense", "fused"),
                         ("sparse", "fused")):
        runs[layout, mode] = _run(_process_world(name, kw), EDGE, layout,
                                  mode, deadline=DEADLINE)
    ref = runs["dense", "loop"]
    for key, other in runs.items():
        _same_run(ref, other)
        assert other[0].live_history == ref[0].live_history
        assert other[0].sim_time_history == [2.5, 5.0, 7.5]
        assert other[0].arrived_history == ref[0].arrived_history
    if name != "static":
        assert min(ref[0].live_history) < 1.0


@pytest.mark.parametrize("transport", ["node", "edge"])
@pytest.mark.parametrize("layout", ["dense", "sparse"])
def test_dead_nodes_freeze_and_pay_nothing(layout, transport):
    comm = (CommConfig(codec="int8", stochastic=False) if transport == "node"
            else CommConfig(codec="int8", per_edge=True, stochastic=False))
    world = _world(dynamics=td.NodeChurn(p_leave=0.4, p_rejoin=0.5))
    exp = Experiment(world, "decdiff+vt", device="cpu", comm=comm,
                     layout=layout, **TRAIN)
    alive = _alive_recorder(exp)
    payload = exp.transport.payload_bytes
    dead_seen = 0
    for r in range(4):
        before = [t.clone() for t in tree_leaves(exp.params)
                  + tree_leaves(exp.opt_state)]
        (exp.params, exp.opt_state, exp.comm_state, exp.dyn_state, _, _, _,
         (sent, trig, live)) = exp._round(exp.params, exp.opt_state,
                                          exp.comm_state, exp.dyn_state,
                                          None, None, r)
        dead = alive[-1] == 0
        dead_seen += int(dead.sum())
        for b, a in zip(before, tree_leaves(exp.params)
                        + tree_leaves(exp.opt_state)):
            assert torch.equal(a[dead], b[dead])
            if (~dead).any():
                assert not torch.equal(a[~dead], b[~dead])
        # threshold 0: every live sender fires on every live edge, and a
        # dead node has none
        assert float(sent) == float(live)
        assert float(trig) == (1.0 if float(live) > 0 else 0.0)
        assert payload * float(sent) <= payload * exp._total_directed
    assert dead_seen > 0


def _rand_like(t, gen):
    return torch.rand(t.shape, generator=gen) + 0.5


def test_rejoin_resets_only_incident_state():
    from repro.comm import CommConfig as JCommConfig
    from repro.comm import SparseEdgeGossipTransport as JSparseEdge

    _, ttop = GRAPHS["dense"]
    jst, st = GRAPHS["sparse"]
    gen = torch.Generator().manual_seed(0)
    params = {"w": torch.randn((16, 5), generator=gen)}
    rj = torch.zeros(16)
    rj[[2, 9]] = 1.0
    cfg = CommConfig(codec="int8", policy="adaptive", target_trigger=0.5)
    idx = torch.from_numpy(np.maximum(ttop.neighbor_idx, 0))
    valid = torch.from_numpy(ttop.neighbor_mask.astype(np.float32))
    src = torch.from_numpy(st.edge_src.astype(np.int64))
    dst = torch.from_numpy(st.edge_dst.astype(np.int64))
    incident_d = (torch.maximum(rj[:, None], rj[idx]) * valid) > 0
    incident_s = torch.maximum(rj[src], rj[dst]) > 0

    # per node, both layouts: reset rows and every incident delivery
    for kw, incident in ((dict(nbr_idx=ttop.neighbor_idx,
                               nbr_valid=ttop.neighbor_mask), incident_d),
                         (dict(edge_src=st.edge_src, edge_dst=st.edge_dst),
                          incident_s)):
        tr = GossipTransport(cfg, params, **kw)
        s0 = tr.init_state(params)
        s = s0._replace(**{f: _rand_like(getattr(s0, f), gen)
                           for f in s0._fields if getattr(s0, f) is not None})
        out = tr.reset_rows(s, rj)
        r = rj > 0
        for f in ("last_sent", "residual", "ever_sent"):
            assert (getattr(out, f)[r] == 0).all()
            assert torch.equal(getattr(out, f)[~r], getattr(s, f)[~r])
        assert (out.ever_recv[incident] == 0).all()
        assert torch.equal(out.ever_recv[~incident], s.ever_recv[~incident])

    # per edge: dense [N, max_deg] and sparse [E] reset the same links
    tr_d = EdgeGossipTransport(cfg, params, ttop.neighbor_idx,
                               ttop.neighbor_mask)
    tr_s = SparseEdgeGossipTransport(cfg, params, st)
    s0 = tr_d.init_state(params)
    sd = s0._replace(**{f: _rand_like(getattr(s0, f), gen)
                        for f in s0._fields})
    # the sparse state is the dense one's valid sender slots in CSR order
    e_id = tr_d.edge_id[valid > 0]
    order = torch.argsort(e_id)
    ss = tr_s.init_state(params)._replace(**{
        f: getattr(sd, f)[valid > 0][order] for f in s0._fields})
    out_d = tr_d.reset_edges(sd, incident_d.float())
    out_s = tr_s.reset_edges(ss, incident_s.float())
    for f in s0._fields:
        a = getattr(out_d, f)
        assert torch.equal(a[valid > 0][order], getattr(out_s, f)), f
        assert torch.equal(a[~incident_d], getattr(sd, f)[~incident_d])
        assert torch.equal(getattr(out_s, f)[~incident_s],
                           getattr(ss, f)[~incident_s])
    assert (out_s.last_sent[incident_s] == 0).all()
    assert (out_s.threshold[incident_s] == tr_s.thr0).all()
    # ... and as the reference's sparse transport resets them
    jtr = JSparseEdge(JCommConfig(codec="int8", policy="adaptive",
                                  target_trigger=0.5),
                      {"w": jnp.asarray(params["w"].numpy())}, jst)
    jout = jtr.reset_edges(jtr.init_state({"w": jnp.zeros((16, 5))})._replace(
        **{f: jnp.asarray(getattr(ss, f).numpy()) for f in s0._fields}),
        jnp.asarray(incident_s.float().numpy()))
    for f in s0._fields:
        np.testing.assert_array_equal(getattr(out_s, f).numpy(),
                                      np.asarray(getattr(jout, f)))


def test_experiment_refusals():
    world = _world()
    world.dynamics = td.EdgeDropout
    with pytest.raises(TypeError, match="GraphProcess"):
        Experiment(world, "decdiff+vt", device="cpu", **TRAIN)
    with pytest.raises(ValueError, match="observes the event clock"):
        Experiment(_world(dynamics=td.EnergyChurn()), "decdiff+vt",
                   device="cpu", **TRAIN)
