"""The sparse CSR layout and the two int8 single-path kernels, on the CPU.

Against the JAX package (inputs from numpy seeds; the Pallas kernels run
in interpret mode, as the JAX package's own tests run them):

  (a) `graphs/sparse.py`: every builder gives the reference's arrays, and
      the dense round trip and the 4096-node guard behave alike;
  (b) `build_sparse_plan`: the same widths and bitwise equal slot tables;
      every real row sits in exactly one bucket;
  (c) `SparseNeighborhood` against `DenseNeighborhood` (bitwise in the
      port) and against the JAX view (1e-6 + 1e-5·Σ|w·v|);
  (d) `Experiment` dense against sparse, bitwise in the port, over the
      reference's method and transport matrix (tests/test_sparse_engine.py
      and tests/test_sparse_parity.py, without dynamics), the per-edge
      controller state included, and CFA-GE's gradient walk cut into
      small calls (bitwise across layouts, one row-gradient per edge, and
      against JAX's sparse walk);
  (e) the port's sparse layout against the JAX package's, with the
      reference's init carried across: params within 1e-4 and accuracy
      within one test sample without a transport; with one, bytes and
      trigger history exact and params within 1e-4 plus one int8 grain
      (ROADMAP C.1: a flipped quantizer step spreads through the gossip);
  (f) `dequant_segment_neighbor_avg` (B.5) against the JAX wrapper within
      1e-6 + 1e-5·Σ|w·s·q|, and bitwise invariant in the port to row
      blocking and to zero-weight K padding with any int8 in those slots;
  (g) `dequant_neighbor_avg` (B.7) against the JAX wrapper over the
      reference's sweep (rtol 1e-5, atol 1e-6), against `neighbor_avg` of
      the decoded codec payload, and bitwise row 0 of
      `dequant_neighbor_avg_rows`.

Tolerances against JAX are fp32 reorderings: XLA contracts with dots that
sum in another order than the port's ordered loops.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp

from repro_torch import convert
from repro_torch.comm import CommConfig, SparseEdgeGossipTransport
from repro_torch.engine import Experiment, Schedule, World
from repro_torch.engine.neighborhood import (DenseNeighborhood,
                                             SparseNeighborhood,
                                             _bucket_width,
                                             build_sparse_plan)
from repro_torch.graphs import sparse as tsparse
from repro_torch.graphs.sparse import (SparseTopology, rev_edge_permutation,
                                       sparse_barabasi_albert,
                                       sparse_erdos_renyi, sparse_ring,
                                       sparse_star)
from repro_torch.kernels import ops
from repro_torch.models.mlp_cnn import make_mlp
from repro_torch.utils.pytree import tree_leaves

RTOL, ATOL = 1e-5, 1e-6

# ------------------------------------------------------------ (a) graphs

BUILDERS = [
    ("erdos_renyi", dict(n=40, p=0.2, seed=3)),
    ("erdos_renyi", dict(n=30, p=0.05, seed=1, ensure_connected=False)),
    ("barabasi_albert", dict(n=50, m=2, seed=0)),
    ("barabasi_albert", dict(n=24, m=1, seed=2)),
    ("barabasi_albert", dict(n=10000, m=2, seed=0)),
    ("watts_strogatz", dict(n=30, k=4, p=0.3, seed=7)),
    ("ring", dict(n=9)),
    ("star", dict(n=17)),
    ("complete", dict(n=6)),
    ("grid2d", dict(rows=4, cols=5)),
]

ARRAYS = ("edge_src", "edge_dst", "edge_weight", "row_offsets")


def _assert_same_sparse(t, j):
    assert (t.name, t.num_nodes, t.connected) == (j.name, j.num_nodes,
                                                  j.connected)
    for name in ARRAYS:
        a, b = getattr(t, name), getattr(j, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name,kw", BUILDERS,
                         ids=[f"{n}-{i}" for i, (n, _) in
                              enumerate(BUILDERS)])
def test_sparse_builders_are_copies(name, kw):
    from repro.graphs.sparse import make_sparse_topology as jmake

    t, j = tsparse.make_sparse_topology(name, **kw), jmake(name, **kw)
    _assert_same_sparse(t, j)
    from repro.graphs.sparse import rev_edge_permutation as jrev
    from repro.graphs.sparse import undirected_pair_ids as jpairs

    np.testing.assert_array_equal(rev_edge_permutation(t), jrev(j))
    tp, tn = tsparse.undirected_pair_ids(t)
    jp, jn = jpairs(j)
    np.testing.assert_array_equal(tp, jp)
    assert tn == jn


def test_dense_round_trip_matches_reference():
    from repro.graphs import make_topology as jmake_topology
    from repro.graphs.sparse import SparseTopology as JSparse

    from repro_torch.graphs.topology import _from_adjacency

    jt = jmake_topology("barabasi_albert", n=20, m=2, seed=4)
    tt = dataclasses.replace(_from_adjacency(jt.name, jt.adjacency),
                             weights=np.asarray(jt.weights, np.float32))
    ts, js = SparseTopology.from_topology(tt), JSparse.from_topology(jt)
    _assert_same_sparse(ts, js)
    back, jback = ts.to_topology(), js.to_topology()
    for name in ("adjacency", "weights", "neighbor_idx", "neighbor_mask"):
        np.testing.assert_array_equal(getattr(back, name),
                                      getattr(jback, name))
        np.testing.assert_array_equal(getattr(back, name),
                                      getattr(tt, name))
    assert back.max_degree == jback.max_degree == jt.max_degree


def test_densify_guard_refuses_above_4096_nodes():
    from repro.graphs.sparse import sparse_ring as jring

    for mod_ring in (sparse_ring, jring):
        assert mod_ring(4096).to_topology().num_nodes == 4096
        with pytest.raises(ValueError, match="refusing to densify"):
            mod_ring(4097).to_topology()


# -------------------------------------------------------------- (b) plan

PLAN_GRAPHS = {
    "ba16": lambda: sparse_barabasi_albert(n=16, m=2, seed=0),
    "ba40-m1": lambda: sparse_barabasi_albert(n=40, m=1, seed=2),
    "star17": lambda: sparse_star(17),
    "ring12": lambda: sparse_ring(12),
}


def _counts(n, seed=0):
    return np.random.default_rng(seed).integers(1, 50, n).astype(np.int64)


def test_bucket_width_matches_reference():
    from repro.engine.neighborhood import _bucket_width as jbw

    for d in (0, 1, 7, 8, 9, 16, 17, 100, 204, 4095):
        assert _bucket_width(d) == jbw(d)


@pytest.mark.parametrize("graph,n_pods", [
    (g, p) for g in sorted(PLAN_GRAPHS) for p in (1, 2, 4)
    if PLAN_GRAPHS[g]().num_nodes % p == 0])
def test_plan_tables_match_reference_bitwise(graph, n_pods):
    from repro.engine.neighborhood import build_sparse_plan as jplan

    st = PLAN_GRAPHS[graph]()
    counts = _counts(st.num_nodes)
    tp, jp = build_sparse_plan(st, counts, n_pods), jplan(st, counts, n_pods)
    assert tp.widths == jp.widths
    assert (tp.num_directed, tp.per_pod, tp.n_pods) == (
        jp.num_directed, jp.per_pod, jp.n_pods)
    np.testing.assert_array_equal(tp.degrees.numpy(), np.asarray(jp.degrees))
    for wd in tp.widths:
        for name in ("rows_local", "src", "wgt", "epos"):
            a = getattr(tp.buckets[wd], name).numpy()
            b = np.asarray(getattr(jp.buckets[wd], name))
            assert a.shape == b.shape, (wd, name)
            np.testing.assert_array_equal(a, b.astype(a.dtype))
    # every real row is in exactly one bucket (the trash row takes the
    # pods' dummy rows, and only those)
    for p in range(n_pods):
        rows = np.concatenate([tp.buckets[wd].rows_local[p].numpy()
                               for wd in tp.widths])
        real = np.sort(rows[rows != tp.per_pod])
        np.testing.assert_array_equal(real, np.arange(tp.per_pod))


# --------------------------------------------------- (c) neighbourhoods

def _views(st, seed, d=37, participation=1.0, gate=False, edge=False):
    """A dense and a sparse port view over the same composed weights, plus
    the JAX sparse view's inputs."""
    rng = np.random.default_rng(seed)
    n, e = st.num_nodes, st.num_directed
    counts = _counts(n, seed)
    table = rng.standard_normal((n, d)).astype(np.float32)
    local = rng.standard_normal((n, d)).astype(np.float32)
    gate_vec = ((rng.random(n) < 0.7).astype(np.float32) if gate else None)
    link_u = (rng.random(e).astype(np.float32) if participation < 1.0
              else None)
    edge_table = (rng.standard_normal((e, d)).astype(np.float32) if edge
                  else None)
    edge_mask = ((rng.random(e) < 0.8).astype(np.float32) if edge else None)
    # the dense equivalent: slot k of row i is CSR edge off[i] + k
    topo = st.to_topology()
    off = st.row_offsets
    idx = np.maximum(topo.neighbor_idx, 0)
    deg = np.diff(off)
    k = np.arange(topo.max_degree)[None, :]
    pos = np.where(k < deg[:, None], off[:-1, None] + k, 0)
    valid = topo.neighbor_mask.astype(np.float32)
    w = topo.neighbor_weights() * counts[idx].astype(np.float32) * valid
    mask = valid.copy()
    if gate_vec is not None:
        mask = mask * gate_vec[idx]
    if link_u is not None:
        mask = mask * (link_u[pos] < participation).astype(np.float32)
    if edge_mask is not None:
        mask = mask * edge_mask[pos]
    t = torch.from_numpy
    ident = (lambda x: x)
    if edge:
        panel = t(edge_table[pos] * valid[:, :, None])
        dense = DenseNeighborhood(None, None, t(w * mask), t(local), ident,
                                  panel=panel.contiguous())
    else:
        dense = DenseNeighborhood(t(table), t(idx.astype(np.int64)),
                                  t(w * mask), t(local), ident)
    plan = build_sparse_plan(st, counts)
    # the port's view takes the factors composed into one [E] mask, as
    # the round body builds it; the JAX view takes them one by one
    e_mask = np.ones(e, np.float32)
    if gate_vec is not None:
        e_mask = e_mask * gate_vec[st.edge_src]
    if link_u is not None:
        e_mask = e_mask * (link_u < participation).astype(np.float32)
    if edge_mask is not None:
        e_mask = e_mask * edge_mask
    sparse = SparseNeighborhood(
        plan, None if edge else t(table), t(local), ident, t(e_mask),
        edge_table=None if edge_table is None else t(edge_table))
    jargs = dict(counts=counts, table=table, local=local, gate_vec=gate_vec,
                 link_u=link_u, participation=participation,
                 edge_table=edge_table, edge_mask=edge_mask)
    return dense, sparse, jargs


def _jax_view(st, a):
    from repro.engine.neighborhood import SparseNeighborhood as JView
    from repro.engine.neighborhood import build_sparse_plan as jplan

    def opt(x):
        return None if x is None else jnp.asarray(x)

    return JView(jplan(st, a["counts"], 1), jnp.int32(0), opt(a["table"]),
                 jnp.asarray(a["local"]), lambda x: x, opt(a["gate_vec"]),
                 opt(a["link_u"]), a["participation"],
                 edge_table=opt(a["edge_table"]),
                 edge_mask=opt(a["edge_mask"]))


VIEW_CASES = {
    "plain": dict(),
    "gated": dict(gate=True),
    "participation": dict(participation=0.6, gate=True),
    "edge-bank": dict(edge=True),
}


@pytest.mark.parametrize("case", sorted(VIEW_CASES))
@pytest.mark.parametrize("graph", ["ba16", "star17", "ba40-m1"])
def test_sparse_view_equals_dense_view_bitwise(graph, case):
    dense, sparse, _ = _views(PLAN_GRAPHS[graph](), 5,
                              **VIEW_CASES[case])
    for fn in ("reduce", "reduce_delta"):
        (ds, dt), (ss, stt) = getattr(dense, fn)(), getattr(sparse, fn)()
        assert torch.equal(ds, ss) and torch.equal(dt, stt), fn
    assert torch.equal(dense.n_active(), sparse.n_active())


@pytest.mark.parametrize("case", sorted(VIEW_CASES))
def test_sparse_view_matches_jax(case):
    st = PLAN_GRAPHS["ba40-m1"]()
    _, sparse, a = _views(st, 6, **VIEW_CASES[case])
    jview = _jax_view(st, a)
    vals = a["edge_table"] if a["edge_table"] is not None else \
        a["table"][st.edge_src]
    for fn in ("reduce", "reduce_delta"):
        (ts, tt), (js, jt) = getattr(sparse, fn)(), getattr(jview, fn)()
        # Σ|w|·|v| per receiver bounds the reorder error of its sums
        v = np.abs(vals) + (np.abs(a["local"][st.edge_dst])
                            if fn == "reduce_delta" else 0)
        w = st.edge_weight * a["counts"][st.edge_src]
        scale = np.zeros_like(a["local"])
        np.add.at(scale, st.edge_dst, w[:, None] * v)
        err = np.abs(ts.numpy() - np.asarray(js))
        assert (err <= ATOL + RTOL * scale).all(), (fn, err.max())
        np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=RTOL,
                                   atol=ATOL)
    np.testing.assert_array_equal(sparse.n_active().numpy(),
                                  np.asarray(jview.n_active()))


# ------------------------------------------- (d) dense vs sparse, bitwise

TINY = dict(steps_per_round=1, batch_size=4, lr=0.1, eval_batch=32, seed=3)
PARITY = dict(steps_per_round=1, batch_size=8, lr=0.1, momentum=0.9, seed=3)


def _tiny_world(st, seed=0, dim=16, per_node=4, classes=10):
    """tests/test_sparse_engine.py's node-axis world over `st`."""
    rng = np.random.default_rng(seed)
    n = st.num_nodes
    xs = [rng.normal(size=(per_node, dim)).astype(np.float32)
          for _ in range(n)]
    ys = [rng.integers(0, classes, size=per_node).astype(np.int32)
          for _ in range(n)]
    return World(model=make_mlp(num_classes=classes, input_dim=dim,
                                hidden=(16,)),
                 topo=st, xs=xs, ys=ys,
                 x_test=rng.normal(size=(32, dim)).astype(np.float32),
                 y_test=rng.integers(0, classes, size=32).astype(np.int32),
                 device="cpu")


@pytest.fixture(scope="module")
def ba_world():
    return _tiny_world(sparse_barabasi_albert(n=16, m=2, seed=0))


@pytest.fixture(scope="module")
def parity_world():
    """tests/test_sparse_parity.py's world."""
    return World.synthetic("synth-mnist", nodes=16,
                           topology="barabasi_albert", m=2, seed=5,
                           scale=0.02, model=make_mlp(hidden=(16,)),
                           device="cpu")


def _run(world, method, layout, comm=None, rounds=3, mode="loop",
         train=TINY, **kw):
    exp = Experiment(world, method, comm=comm, layout=layout, device="cpu",
                     schedule=Schedule(rounds=rounds, eval_every=rounds,
                                       mode=mode), **{**train, **kw})
    hist = exp.run()
    return exp, hist


def _assert_bit_equal(a, b):
    (ea, ha), (eb, hb) = a, b
    for x, y in zip(tree_leaves(ea.params), tree_leaves(eb.params)):
        assert torch.equal(x, y)
    assert ea.comm_bytes_total == eb.comm_bytes_total
    assert ea.trig_history == eb.trig_history
    assert ea.train_loss_history == eb.train_loss_history
    for ma, mb in zip(ha, hb):
        np.testing.assert_array_equal(ma.acc_per_node, mb.acc_per_node)


@pytest.mark.parametrize("method", ["decavg", "cfa", "decdiff+vt", "fedavg",
                                    "isol"])
def test_engine_methods_sparse_equals_dense(ba_world, method):
    _assert_bit_equal(_run(ba_world, method, "dense"),
                      _run(ba_world, method, "sparse"))


@pytest.mark.parametrize("method", ["decavg", "dechetero", "cfa", "cfa-ge",
                                    "decdiff", "decdiff+vt", "fedavg",
                                    "isol"])
def test_parity_methods_sparse_equals_dense(parity_world, method):
    _assert_bit_equal(_run(parity_world, method, "dense", train=PARITY),
                      _run(parity_world, method, "sparse", train=PARITY))


@pytest.mark.parametrize("st", [
    sparse_erdos_renyi(n=24, p=0.25, seed=1),
    sparse_barabasi_albert(n=24, m=1, seed=2),
    sparse_star(17),
], ids=["er24", "ba24-m1", "star17"])
def test_graphs_sparse_equals_dense(st):
    world = _tiny_world(st, seed=1)
    _assert_bit_equal(_run(world, "decdiff", "dense"),
                      _run(world, "decdiff", "sparse"))


ENGINE_COMMS = {
    "int8": CommConfig(codec="int8", trigger_threshold=0.0),
    "fp32-trig-stale": CommConfig(codec="fp32", trigger_threshold=0.05,
                                  on_silence="stale"),
    "fp32-trig-drop": CommConfig(codec="fp32", trigger_threshold=0.05,
                                 on_silence="drop"),
}
ADAPTIVE = CommConfig(codec="int8", policy="adaptive", target_trigger=0.6,
                      per_edge=True)
PARITY_COMMS = {
    "per-node-int8": CommConfig(codec="int8", trigger_threshold=0.5),
    "per-edge-fp32-thr": CommConfig(codec="fp32", per_edge=True,
                                    trigger_threshold=0.5),
    "per-edge-adaptive-int8": ADAPTIVE,
}


@pytest.mark.parametrize("case", sorted(ENGINE_COMMS))
def test_engine_transports_sparse_equal_dense(ba_world, case):
    comm = ENGINE_COMMS[case]
    dense = _run(ba_world, "decdiff", "dense", comm=comm)
    assert dense[0].comm_bytes_total > 0
    _assert_bit_equal(dense, _run(ba_world, "decdiff", "sparse", comm=comm))


@pytest.mark.parametrize("case", sorted(PARITY_COMMS))
def test_parity_transports_sparse_equal_dense(parity_world, case):
    comm = PARITY_COMMS[case]
    dense = _run(parity_world, "decdiff+vt", "dense", comm=comm,
                 train=PARITY)
    assert dense[0].comm_bytes_total > 0
    _assert_bit_equal(dense, _run(parity_world, "decdiff+vt", "sparse",
                                  comm=comm, train=PARITY))


def test_per_edge_controller_state_matches_dense(parity_world):
    """The sparse [E] banks hold exactly the dense [N, max_deg] panels'
    valid entries: dense slot d of row i is the out-link i -> nbr_idx[i, d],
    whose CSR id is rev_edge_permutation(st)[off[i] + d]."""
    dense, _ = _run(parity_world, "decdiff+vt", "dense", comm=ADAPTIVE,
                    train=PARITY)
    sparse, _ = _run(parity_world, "decdiff+vt", "sparse", comm=ADAPTIVE,
                     train=PARITY)
    assert isinstance(sparse.transport, SparseEdgeGossipTransport)
    st = sparse.topo
    off = st.row_offsets
    rev = rev_edge_permutation(st)
    ds, ss = dense.comm_state, sparse.comm_state
    for name in ("last_sent", "residual", "threshold", "drift_ema",
                 "ever_delivered"):
        panel, flat = getattr(ds, name).numpy(), getattr(ss, name).numpy()
        for i in range(st.num_nodes):
            deg = off[i + 1] - off[i]
            assert np.array_equal(panel[i, :deg], flat[rev[off[i]:off[i + 1]]]
                                  ), (name, i)


def test_stochastic_int8_sparse_equals_dense(ba_world):
    """The per-edge transports draw one uniform row per canonical edge, so
    stochastic rounding is bitwise equal across the layouts too."""
    comm = CommConfig(codec="int8", policy="adaptive", target_trigger=0.8)
    _assert_bit_equal(_run(ba_world, "decdiff+vt", "dense", comm=comm),
                      _run(ba_world, "decdiff+vt", "sparse", comm=comm))


@pytest.mark.parametrize("comm", [None, ADAPTIVE,
                                  CommConfig(codec="int8")],
                         ids=["plain", "per-edge", "per-node"])
def test_sparse_fused_equals_loop(ba_world, comm):
    _assert_bit_equal(_run(ba_world, "decdiff+vt", "sparse", comm=comm),
                      _run(ba_world, "decdiff+vt", "sparse", comm=comm,
                           mode="fused"))


@pytest.mark.parametrize("method", ["decdiff", "cfa-ge"])
def test_sparse_participation_runs_finite(ba_world, method):
    """participation < 1 draws the [N, max_deg] panel on the dense layout
    and one uniform per directed edge on the sparse one: a liveness pin,
    not an equality pin, as in the reference."""
    exp, hist = _run(ba_world, method, "sparse", participation=0.5)
    assert all(torch.isfinite(p).all() for p in tree_leaves(exp.params))
    assert np.isfinite(hist[-1].acc_per_node).all()


def test_layout_follows_the_topology_and_the_guard():
    st = sparse_ring(12)
    world = _tiny_world(st)
    exp = Experiment(world, "decdiff", device="cpu", **TINY)
    assert exp.layout == "sparse" and exp.nbr_idx is None
    assert exp.sparse_plan.num_directed == st.num_directed == 24
    dense = Experiment(world, "decdiff", layout="dense", device="cpu",
                       **TINY)
    assert dense.layout == "dense" and dense.topo.max_degree == 2
    big = _tiny_world(sparse_ring(4100), per_node=1)
    with pytest.raises(ValueError, match="refusing to densify"):
        Experiment(big, "decdiff", layout="dense", device="cpu", **TINY)


def test_gossip_strategy_without_flat_form_is_dense_only(ba_world):
    from repro_torch.engine import strategies

    class NoFlat(strategies.DecAvgStrategy):
        flat_aggregate = None

    strategies.register_method("decavg-noflat-sparse-test", NoFlat(),
                               overwrite=True)
    try:
        with pytest.raises(ValueError, match="no flat_aggregate"):
            Experiment(ba_world, "decavg-noflat-sparse-test",
                       layout="sparse", device="cpu", **TINY)
        _run(ba_world, "decavg-noflat-sparse-test", "dense")
    finally:
        strategies._REGISTRY.pop("decavg-noflat-sparse-test")


# ---------------------------------------------- (e) port vs JAX, sparse

WORLD = dict(nodes=16, topology="barabasi_albert", m=2, scale=0.03)
TRAIN = dict(steps_per_round=2, batch_size=32)
JAX_CASES = {
    "no-transport": (None, 3),
    "per-edge-adaptive-int8": (dict(codec="int8", policy="adaptive",
                                    target_trigger=0.95, stochastic=False),
                               3),
    "per-node-int8-thr": (dict(codec="int8", stochastic=False,
                               trigger_threshold=0.8), 3),
}


@pytest.fixture(scope="module")
def jworld():
    from repro.engine import World as JWorld
    from repro.models.mlp_cnn import make_mlp as jmake_mlp

    return JWorld.synthetic("synth-mnist", model=jmake_mlp(hidden=(64, 32)),
                            **WORLD)


@pytest.fixture(scope="module")
def jax_sparse_runs(jworld):
    from repro.comm import CommConfig as JCommConfig
    from repro.engine import Experiment as JExperiment

    out = {}
    for name, (cfg, rounds) in JAX_CASES.items():
        je = JExperiment(jworld, "decdiff+vt", layout="sparse",
                         comm=None if cfg is None else JCommConfig(**cfg),
                         **TRAIN)
        params0 = jax.tree.map(np.asarray, je.params)
        hist = je.run(rounds=rounds, eval_every=1, mode="loop")
        out[name] = (params0, hist, jax.tree.map(np.asarray, je.params),
                     list(je.trig_history), je.comm_bytes_total)
    return out


@pytest.fixture(scope="module")
def port_sparse_runs(jworld, jax_sparse_runs):
    world = convert.world_from_arrays(
        model=make_mlp(hidden=(64, 32)), adjacency=jworld.topo.adjacency,
        weights=jworld.topo.weights, xs=jworld.xs, ys=jworld.ys,
        x_test=jworld.x_test, y_test=jworld.y_test, device="cpu")
    out = {}
    for name, (cfg, rounds) in JAX_CASES.items():
        exp = Experiment(world, "decdiff+vt", layout="sparse", device="cpu",
                         comm=None if cfg is None else CommConfig(**cfg),
                         **TRAIN)
        exp.params = convert.params_from_numpy(jax_sparse_runs[name][0],
                                               "cpu")
        exp.opt_state = exp.optimizer.init(exp.params)
        if exp.transport is not None:
            exp.comm_state = exp.transport.init_state(exp.params)
        out[name] = (exp, exp.run(rounds=rounds, eval_every=1, mode="loop"))
    return out


@pytest.mark.parametrize("case", sorted(JAX_CASES))
def test_sparse_params_match_jax(jax_sparse_runs, port_sparse_runs, case):
    jparams = jax_sparse_runs[case][2]
    exp = port_sparse_runs[case][0]
    assert exp.layout == "sparse"
    tparams = convert.params_to_numpy(exp.params)
    # one int8 grain of the largest payload with a transport (ROADMAP C.1)
    grain = 0.0 if JAX_CASES[case][0] is None else max(
        float(np.abs(jparams[k][kk]).max()) for k in jparams
        for kk in jparams[k]) / 127.0
    for layer in jparams:
        for leaf in jparams[layer]:
            np.testing.assert_allclose(tparams[layer][leaf],
                                       jparams[layer][leaf], rtol=0,
                                       atol=1e-4 + grain)


@pytest.mark.parametrize("case", sorted(JAX_CASES))
def test_sparse_accuracy_bytes_and_trigger_match_jax(
        jworld, jax_sparse_runs, port_sparse_runs, case):
    _, jhist, _, jtrig, jbytes = jax_sparse_runs[case]
    exp, thist = port_sparse_runs[case]
    n_test = len(jworld.x_test)
    used = (n_test // min(128, n_test)) * min(128, n_test)
    assert [m.round for m in thist] == [m.round for m in jhist]
    for jm, tm in zip(jhist, thist):
        assert (np.abs(tm.acc_per_node - jm.acc_per_node) * used).max() \
            <= 1.0 + 1e-6
        assert tm.bytes_on_wire == jm.bytes_on_wire
        assert tm.triggered_frac == jm.triggered_frac
    assert exp.trig_history == jtrig
    assert exp.comm_bytes_total == jbytes


# ------------------------------------------------- CFA-GE's edge walk

@pytest.mark.parametrize("chunk", [5, 16])
def test_cfa_ge_in_small_calls_sparse_equals_dense(parity_world, monkeypatch,
                                                   chunk):
    """CFA-GE's gradient walk split into many calls of `chunk` edges (runs
    of one slot cut across calls, the last call shorter): both layouts make
    the same calls and stay bitwise equal, and the result agrees with the
    walk in one call to 1e-6 (the CPU's GEMMs may block a call of another
    row count differently)."""
    from repro_torch.engine import backends

    whole = _run(parity_world, "cfa-ge", "dense", train=PARITY)
    monkeypatch.setattr(backends, "GE_CHUNK", chunk)
    dense = _run(parity_world, "cfa-ge", "dense", train=PARITY)
    _assert_bit_equal(dense, _run(parity_world, "cfa-ge", "sparse",
                                  train=PARITY))
    for a, b in zip(tree_leaves(dense[0].params),
                    tree_leaves(whole[0].params)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-6)


@pytest.mark.parametrize("layout", ["dense", "sparse"])
def test_cfa_ge_walk_evaluates_each_edge_once(parity_world, monkeypatch,
                                              layout):
    """The walk costs E row-gradients, in calls of min(E, GE_CHUNK) rows
    (the last holds the rest), whatever the layout (the reference's walk
    costs N·max_deg on the dense layout and Σ B·width over the sparse
    buckets)."""
    from repro_torch.engine import backends

    monkeypatch.setattr(backends, "GE_CHUNK", 7)
    exp = Experiment(parity_world, "cfa-ge", layout=layout, device="cpu",
                     **PARITY)
    rows = []
    grad_fn = exp._grad_fn

    def counting(params, x, y, keep):
        rows.append(int(x.shape[0]))
        return grad_fn.func(params, x, y, keep=keep)

    exp._grad_fn = functools.partial(counting,
                                     keep=grad_fn.keywords["keep"])
    link = (exp.nbr_valid if layout == "dense" else
            torch.ones(exp.sparse_plan.num_directed))
    backends._make_gradient_exchange(exp)(exp.params, link, 2)
    e = int(exp._total_directed)
    assert rows == [7] * (e // 7) + ([e % 7] if e % 7 else [])


def test_batcher_per_row_steps_equal_scalar_steps():
    """Batcher.indices with an [N] step tensor gives row r the indices of
    the scalar step steps[r], across the int32 wrap of step·bs."""
    from repro_torch.data.pipeline import Batcher

    bt = Batcher(batch_size=32)
    counts = torch.tensor([1, 7, 0, 500, 33, 4096], dtype=torch.int64)
    steps = torch.tensor([0, 3, 9, 67108863, 67108864, 2 ** 40 + 5])
    got = bt.indices(counts, steps)
    for r in range(counts.shape[0]):
        assert torch.equal(got[r], bt.indices(counts[r:r + 1],
                                              int(steps[r]))[0])


def test_sparse_cfa_ge_in_small_calls_matches_jax(jworld, monkeypatch):
    """The port's sparse CFA-GE walk in calls of 5 edges against the JAX
    package's sparse bucket walk, with the reference's init carried
    across, for 3 rounds: params within 1e-4 and accuracies within one
    test sample."""
    from repro.engine import Experiment as JExperiment
    from repro_torch.engine import backends

    je = JExperiment(jworld, "cfa-ge", layout="sparse", **TRAIN)
    params0 = jax.tree.map(np.asarray, je.params)
    jhist = je.run(rounds=3, eval_every=1, mode="loop")
    monkeypatch.setattr(backends, "GE_CHUNK", 5)
    world = convert.world_from_arrays(
        model=make_mlp(hidden=(64, 32)), adjacency=jworld.topo.adjacency,
        weights=jworld.topo.weights, xs=jworld.xs, ys=jworld.ys,
        x_test=jworld.x_test, y_test=jworld.y_test, device="cpu")
    exp = Experiment(world, "cfa-ge", layout="sparse", device="cpu", **TRAIN)
    exp.params = convert.params_from_numpy(params0, "cpu")
    exp.opt_state = exp.optimizer.init(exp.params)
    thist = exp.run(rounds=3, eval_every=1, mode="loop")
    jparams = jax.tree.map(np.asarray, je.params)
    tparams = convert.params_to_numpy(exp.params)
    for layer in jparams:
        for leaf in jparams[layer]:
            np.testing.assert_allclose(tparams[layer][leaf],
                                       jparams[layer][leaf], rtol=0,
                                       atol=1e-4)
    n_test = len(jworld.x_test)
    used = (n_test // min(128, n_test)) * min(128, n_test)
    for jm, tm in zip(jhist, thist):
        assert (np.abs(tm.acc_per_node - jm.acc_per_node) * used).max() \
            <= 1.0 + 1e-6


# ---------------------------------------------------- (f) B.5 dequant reduce

def _int8_panel(b, k, d, seed=0, zero_frac=0.3):
    rng = np.random.default_rng([seed, b, k, d])
    q = rng.integers(-127, 128, (b, k, d)).astype(np.int8)
    scales = rng.uniform(0.01, 0.1, (b, k)).astype(np.float32)
    w = rng.uniform(0.0, 2.0, (b, k)).astype(np.float32)
    w[rng.random((b, k)) < zero_frac] = 0.0
    return q, scales, w


@pytest.mark.parametrize("b,k,d", [(8, 8, 96), (1, 1, 7), (13, 10, 2051),
                                   (5, 3, 256)])
def test_dequant_segment_matches_jax(b, k, d):
    from repro.kernels.ops import dequant_segment_neighbor_avg as jfn

    q, scales, w = _int8_panel(b, k, d)
    got = ops.dequant_segment_neighbor_avg(
        torch.from_numpy(q), torch.from_numpy(scales), torch.from_numpy(w))
    want = np.asarray(jfn(jnp.asarray(q), jnp.asarray(scales),
                          jnp.asarray(w)))
    assert got.shape == (b, d) and got.dtype == torch.float32
    scale = np.einsum("bk,bkd->bd", np.abs(w * scales),
                      np.abs(q.astype(np.float32)))
    err = np.abs(got.numpy() - want)
    assert (err <= ATOL + RTOL * scale).all(), err.max()


def test_dequant_segment_plain_is_the_ordered_loop():
    from repro_torch.kernels.segment_avg import dequant_segment_avg_plain

    q, scales, w = map(torch.from_numpy, _int8_panel(6, 5, 33, seed=2))
    ws = w * scales
    acc = torch.zeros((6, 33))
    for j in range(5):
        acc = acc + ws[:, j, None] * q[:, j].float()
    assert torch.equal(dequant_segment_avg_plain(q, ws.contiguous()), acc)
    assert torch.equal(ops.dequant_segment_neighbor_avg(q, scales, w), acc)


def test_dequant_segment_row_blocking_is_bitwise_neutral():
    q, scales, w = map(torch.from_numpy, _int8_panel(21, 8, 100, seed=3))
    full = ops.dequant_segment_neighbor_avg(q, scales, w)
    for lo, hi in [(0, 1), (4, 5), (1, 21), (0, 10), (10, 21)]:
        part = ops.dequant_segment_neighbor_avg(q[lo:hi].contiguous(),
                                                scales[lo:hi], w[lo:hi])
        assert torch.equal(part, full[lo:hi])


@pytest.mark.parametrize("garbage", [127, -127, 0, "random"])
def test_dequant_segment_k_padding_is_bitwise_neutral(garbage):
    q, scales, w = map(torch.from_numpy, _int8_panel(8, 5, 64, seed=4))
    full = ops.dequant_segment_neighbor_avg(q, scales, w)
    rng = np.random.default_rng(7)
    pad = (torch.from_numpy(rng.integers(-128, 128, (8, 11, 64)).astype(
        np.int8)) if garbage == "random"
        else torch.full((8, 11, 64), garbage, dtype=torch.int8))
    qp = torch.cat([q, pad], dim=1)
    sp = torch.cat([scales, torch.from_numpy(
        rng.uniform(0.0, 1e3, (8, 11)).astype(np.float32))], dim=1)
    wp = torch.cat([w, torch.zeros((8, 11))], dim=1)
    assert torch.equal(ops.dequant_segment_neighbor_avg(qp, sp, wp), full)


def test_dequant_segment_on_bucket_panels_of_real_payloads():
    """The route the card check takes: a world's int8 payloads gathered per
    width bucket, against the fp32 route's sums over the decoded rows."""
    from repro_torch.comm.codecs import Int8Codec

    st = sparse_barabasi_albert(n=40, m=2, seed=1)
    plan = build_sparse_plan(st, _counts(40))
    rng = np.random.default_rng(8)
    mat = torch.from_numpy(rng.standard_normal((40, 301)).astype(np.float32))
    payload, _ = Int8Codec(stochastic=False).encode(mat)
    dec = payload["q"].float() * payload["scale"][:, None]
    for wd in plan.widths:
        bk = plan.buckets[wd]
        src, wgt = bk.src[0], bk.wgt[0]
        got = ops.dequant_segment_neighbor_avg(
            payload["q"][src], payload["scale"][src], wgt)
        want, _ = ops.segment_neighbor_avg(dec[src], wgt)
        scale = torch.einsum("bk,bkd->bd", wgt.abs(), dec[src].abs())
        assert ((got - want).abs() <= ATOL + RTOL * scale).all()


# ----------------------------------------------- (g) B.7 dequant average

@pytest.mark.parametrize("n,d", [(1, 10), (3, 100), (16, 5000), (50, 2048)])
def test_dequant_neighbor_avg_matches_jax_sweep(n, d):
    from repro.kernels import dequant_neighbor_avg as jfn

    from repro_torch.kernels.ref import dequant_neighbor_avg_ref

    rng = np.random.default_rng(n * d + 1)
    q = rng.integers(-127, 128, (n, d)).astype(np.int8)
    sc = (rng.random(n) * 0.02 + 1e-4).astype(np.float32)
    w = (rng.random(n) + 0.1).astype(np.float32)
    got = ops.dequant_neighbor_avg(torch.from_numpy(q), torch.from_numpy(sc),
                                   torch.from_numpy(w))
    want = np.asarray(jfn(jnp.asarray(q), jnp.asarray(sc), jnp.asarray(w)))
    assert got.shape == (d,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    oracle = dequant_neighbor_avg_ref(torch.from_numpy(q),
                                      torch.from_numpy(sc),
                                      torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), oracle.numpy(), rtol=RTOL,
                               atol=ATOL)


def test_dequant_neighbor_avg_fuses_codec_payload():
    """The fused average of a real int8 codec payload equals
    `neighbor_avg` of the decoded models (another association of w·s·q,
    so within fp32 rounding)."""
    from repro_torch.comm.codecs import Int8Codec

    rng = np.random.default_rng(9)
    vecs = torch.from_numpy(rng.standard_normal((6, 4096)).astype(np.float32))
    codec = Int8Codec(stochastic=False)
    payload, _ = codec.encode(vecs)
    w = torch.from_numpy((rng.random(6) + 0.1).astype(np.float32))
    got = ops.dequant_neighbor_avg(payload["q"], payload["scale"], w)
    want = ops.neighbor_avg(codec.decode(payload), w)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("n,d", [(5, 4096), (4, 2051), (1, 3)])
def test_dequant_neighbor_avg_is_row_of_the_block_bitwise(n, d):
    rng = np.random.default_rng([n, d])
    q = torch.from_numpy(rng.integers(-127, 128, (n, d)).astype(np.int8))
    sc = torch.from_numpy((rng.random(n) * 0.01 + 1e-4).astype(np.float32))
    w = torch.from_numpy((rng.random(n) + 0.1).astype(np.float32))
    wn = (w / torch.sum(w))[None, :]
    rows = ops.dequant_neighbor_avg_rows(q, sc, torch.cat([wn, 0 * wn]))
    assert torch.equal(ops.dequant_neighbor_avg(q, sc, w), rows[0])


# ------------------------------------------------------ wrappers

@pytest.mark.parametrize("bad", ["rank", "dtype", "shape", "strided"])
def test_new_wrappers_reject_bad_inputs(bad):
    q, scales, w = map(torch.from_numpy, _int8_panel(4, 3, 9))
    q2, s2, w2 = q[:, 0].contiguous(), scales[:, 0], w[:, 0]
    if bad == "rank":
        seg, avg = (q2, scales, w), (q, s2, w2)
    elif bad == "dtype":
        seg, avg = (q.float(), scales, w), (q2.float(), s2, w2)
    elif bad == "shape":
        seg, avg = (q, scales[:, :2], w), (q2, s2[:3], w2)
    else:
        seg = (q.transpose(0, 1), scales.t(), w.t())
        avg = (torch.from_numpy(np.zeros((9, 4), np.int8)).t(), s2, w2)
    with pytest.raises((TypeError, ValueError)):
        ops.dequant_segment_neighbor_avg(*seg)
    with pytest.raises((TypeError, ValueError)):
        ops.dequant_neighbor_avg(*avg)


def test_new_wrappers_count_no_launch_on_the_cpu():
    ops.reset_launches()
    q, scales, w = map(torch.from_numpy, _int8_panel(4, 3, 9))
    ops.dequant_segment_neighbor_avg(q, scales, w)
    ops.dequant_neighbor_avg(q[:, 0].contiguous(), scales[:, 0], w[:, 0])
    assert ops.LAUNCHES["dequant_segment_neighbor_avg"] == 0
    assert ops.LAUNCHES["dequant_neighbor_avg"] == 0
    assert not any(ops.LAUNCHES.values())


@pytest.mark.parametrize("module,loader,fn,n_ptr,n_int", [
    ("segment_avg", "_dequant_library", "dequant_segment_avg_f32", 3, 3),
    ("dequant_avg", "_single_library", "dequant_avg_f32", 3, 2),
])
def test_new_ctypes_bindings_declare_their_arguments(monkeypatch, module,
                                                     loader, fn, n_ptr,
                                                     n_int):
    """Every pointer and 64-bit size is declared: ctypes would pass 32-bit
    ints otherwise and cut the device pointers."""
    import ctypes
    import importlib
    import types

    from repro_torch.kernels import _build

    seen = []
    fake = types.SimpleNamespace(**{fn: types.SimpleNamespace(
        argtypes=None, restype=None)})
    monkeypatch.setattr(_build, "load",
                        lambda name: seen.append(name) or fake)
    lib = getattr(importlib.import_module(f"repro_torch.kernels.{module}"),
                  loader)()
    args = getattr(lib, fn).argtypes
    assert args == [ctypes.c_void_p] * n_ptr + [ctypes.c_int64] * n_int + [
        ctypes.c_void_p]
    assert getattr(lib, fn).restype is ctypes.c_int
    assert seen == [fn.rsplit("_f32", 1)[0]]
