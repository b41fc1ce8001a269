"""The transport slice end to end against the reference, on the CPU.

`repro.engine.Experiment` runs `decdiff+vt` with `comm=CommConfig(...)` on
the 16-node Barabási–Albert synth-mnist world of
tests/test_torch_experiment.py (scale 0.03, MLP 784-64-32-10, 2 local
steps of batch 32 per round); its initial params, topology and data are
carried into `repro_torch`, and both run in loop mode.  Int8 rounding is
deterministic, the MLP has no dropout and participation is 1, so neither
side draws a random number during the rounds.  Cases:

  * per-node int8, always send (3 rounds);
  * per-edge adaptive int8, target 0.95 (3 rounds);
  * per-node int8 at a fixed threshold of 0.8 (4 rounds): some rounds
    leave nodes silent, so the stale caches and the trigger count;
  * per-edge int8 at a fixed threshold of 0.8 with on_silence="drop"
    (4 rounds).

Tolerances: per-node params within atol 1e-4 and per-node accuracy within
one test sample, as the slice without a transport; `bytes_on_wire`,
`triggered_frac` and `trig_history` exactly equal (they count fired edges,
which the same gates give exactly).  Inside the port the oracles are
bitwise: `CommConfig()` equals no transport, per-edge fp32 at threshold 0
equals per-node fp32 at threshold 0, fused equals loop (bytes included),
and the two wires are one computation.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro_torch import convert
from repro_torch.comm import CommConfig
from repro_torch.engine import Experiment
from repro_torch.engine import strategies
from repro_torch.engine.strategies import (AggregationStrategy,
                                           DecAvgStrategy, MethodSpec)
from repro_torch.models.mlp_cnn import make_mlp
from repro_torch.utils.pytree import tree_leaves, tree_map

WORLD = dict(nodes=16, topology="barabasi_albert", m=2, scale=0.03)
TRAIN = dict(steps_per_round=2, batch_size=32)

CASES = {
    "per-node-int8": (dict(codec="int8", stochastic=False), 3),
    "per-edge-adaptive-int8": (dict(codec="int8", policy="adaptive",
                                    target_trigger=0.95, stochastic=False),
                               3),
    "per-node-int8-thr": (dict(codec="int8", stochastic=False,
                               trigger_threshold=0.8), 4),
    "per-edge-int8-thr-drop": (dict(codec="int8", per_edge=True,
                                    stochastic=False, trigger_threshold=0.8,
                                    on_silence="drop"), 4),
}


@pytest.fixture(scope="module")
def jworld():
    from repro.engine import World as JWorld
    from repro.models.mlp_cnn import make_mlp as jmake_mlp

    return JWorld.synthetic("synth-mnist", model=jmake_mlp(hidden=(64, 32)),
                            **WORLD)


@pytest.fixture(scope="module")
def references(jworld):
    """Each case run once by the JAX package: init params, eval history,
    final params, trigger history."""
    from repro.comm import CommConfig as JCommConfig
    from repro.engine import Experiment as JExperiment

    out = {}
    for name, (cfg, rounds) in CASES.items():
        je = JExperiment(jworld, "decdiff+vt", comm=JCommConfig(**cfg),
                         **TRAIN)
        params0 = jax.tree.map(np.asarray, je.params)
        hist = je.run(rounds=rounds, eval_every=1, mode="loop")
        out[name] = (params0, hist, jax.tree.map(np.asarray, je.params),
                     list(je.trig_history))
    return out


def _carried_world(jw):
    return convert.world_from_arrays(
        model=make_mlp(hidden=(64, 32)), adjacency=jw.topo.adjacency,
        weights=jw.topo.weights, xs=jw.xs, ys=jw.ys, x_test=jw.x_test,
        y_test=jw.y_test, device="cpu")


@pytest.fixture(scope="module")
def tworld(jworld):
    return _carried_world(jworld)


def _experiment(tworld, params0, method="decdiff+vt", **kw):
    exp = Experiment(tworld, method, device="cpu", **TRAIN, **kw)
    exp.params = convert.params_from_numpy(params0, "cpu")
    exp.opt_state = exp.optimizer.init(exp.params)
    if exp.transport is not None:
        exp.comm_state = exp.transport.init_state(exp.params)
    return exp


@pytest.fixture(scope="module")
def port_runs(references, tworld):
    out = {}
    for name, (cfg, rounds) in CASES.items():
        exp = _experiment(tworld, references[name][0],
                          comm=CommConfig(**cfg))
        out[name] = (exp, exp.run(rounds=rounds, eval_every=1, mode="loop"))
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_params_match_reference(references, port_runs, case):
    jparams = references[case][2]
    tparams = convert.params_to_numpy(port_runs[case][0].params)
    for layer in jparams:
        for leaf in jparams[layer]:
            np.testing.assert_allclose(tparams[layer][leaf],
                                       jparams[layer][leaf], rtol=0,
                                       atol=1e-4)


@pytest.mark.parametrize("case", sorted(CASES))
def test_accuracy_matches_reference_to_one_sample(jworld, references,
                                                  port_runs, case):
    jhist = references[case][1]
    thist = port_runs[case][1]
    n_test = len(jworld.x_test)
    used = (n_test // min(128, n_test)) * min(128, n_test)
    assert [m.round for m in thist] == [m.round for m in jhist]
    for jm, tm in zip(jhist, thist):
        diff = np.abs(tm.acc_per_node - jm.acc_per_node) * used
        assert diff.max() <= 1.0 + 1e-6


@pytest.mark.parametrize("case", sorted(CASES))
def test_bytes_and_trigger_match_reference_exactly(references, port_runs,
                                                   case):
    _, jhist, _, jtrig = references[case]
    exp, thist = port_runs[case]
    assert exp.trig_history == jtrig
    for jm, tm in zip(jhist, thist):
        assert tm.bytes_on_wire == jm.bytes_on_wire
        assert tm.triggered_frac == jm.triggered_frac
    assert thist[-1].bytes_on_wire > 0


def test_threshold_cases_leave_edges_silent(references):
    """The fixed-threshold cases exercise the trigger: some round fires
    fewer than all edges."""
    for case in ("per-node-int8-thr", "per-edge-int8-thr-drop"):
        assert min(references[case][3]) < 1.0, case


# ------------------------------------------------------ port-internal oracles

def _run(tworld, params0, rounds=3, mode="loop", **kw):
    exp = _experiment(tworld, params0, **kw)
    return exp, exp.run(rounds=rounds, eval_every=1, mode=mode)


def _same_run(a, b, bytes_too=True):
    (ea, ha), (eb, hb) = a, b
    for x, y in zip(tree_leaves(ea.params), tree_leaves(eb.params)):
        assert torch.equal(x, y)
    assert ea.train_loss_history == eb.train_loss_history
    assert [m.round for m in ha] == [m.round for m in hb]
    for ma, mb in zip(ha, hb):
        np.testing.assert_array_equal(ma.acc_per_node, mb.acc_per_node)
        np.testing.assert_array_equal(ma.loss_per_node, mb.loss_per_node)
        if bytes_too:
            assert ma.bytes_on_wire == mb.bytes_on_wire
            assert ma.triggered_frac == mb.triggered_frac


def test_default_comm_equals_no_transport_bitwise(references, tworld):
    params0 = references["per-node-int8"][0]
    _same_run(_run(tworld, params0), _run(tworld, params0,
                                          comm=CommConfig()),
              bytes_too=False)


def test_per_edge_fp32_thr0_equals_per_node_bitwise(references, tworld):
    params0 = references["per-node-int8"][0]
    node = _run(tworld, params0, comm=CommConfig())
    edge = _run(tworld, params0, comm=CommConfig(per_edge=True))
    _same_run(node, edge)
    assert edge[0].trig_history == [1.0, 1.0, 1.0]
    assert edge[0].comm_bytes_total == node[0].comm_bytes_total > 0


@pytest.mark.parametrize("cfg", [
    dict(codec="int8", stochastic=False, trigger_threshold=0.8),
    dict(codec="int8", policy="adaptive", target_trigger=0.95),
    dict(codec="int8"),
    dict(codec="topk", topk_ratio=0.05, topk_momentum=0.5, per_edge=True,
         trigger_threshold=0.8, on_silence="drop"),
], ids=["per-node-thr", "per-edge-adaptive-stochastic",
        "per-node-stochastic", "per-edge-topk-momentum-drop"])
def test_fused_equals_loop_bitwise_bytes_included(references, tworld, cfg):
    """The rounds draw the codec's uniforms from the experiment's
    generator, so the stochastic cases check the draw order too."""
    params0 = references["per-node-int8"][0]
    kw = dict(comm=CommConfig(**cfg), participation=0.8)
    loop = _run(tworld, params0, rounds=4, mode="loop", **kw)
    fused = _run(tworld, params0, rounds=4, mode="fused", **kw)
    _same_run(loop, fused)
    assert loop[0].trig_history == fused[0].trig_history
    assert loop[0].comm_bytes_total == fused[0].comm_bytes_total > 0


@pytest.mark.parametrize("per_edge", [False, True], ids=["node", "edge"])
def test_wires_are_bitwise_equal(references, tworld, per_edge):
    params0 = references["per-node-int8"][0]
    cfg = CommConfig(codec="int8", stochastic=False, per_edge=per_edge)
    _same_run(_run(tworld, params0, comm=cfg, wire="encoded"),
              _run(tworld, params0, comm=cfg, wire="decoded"))


def test_unknown_wire_and_non_config_comm_are_rejected(tworld):
    with pytest.raises(ValueError, match="wire"):
        Experiment(tworld, device="cpu", wire="nope")
    with pytest.raises(TypeError, match="CommConfig"):
        Experiment(tworld, device="cpu", comm=object())


@pytest.mark.parametrize("method", ["isol", "fedavg", "cfa-ge"])
def test_non_transport_methods_are_rejected(tworld, method):
    """As the reference: the transport models neighbour model-gossip only,
    and the error names the transport-capable roster."""
    with pytest.raises(ValueError, match="transport-capable methods") as e:
        Experiment(tworld, method, comm=CommConfig(), device="cpu")
    roster = str(e.value).split("transport-capable methods:")[1]
    assert "'decdiff+vt'" in roster
    assert "'cfa-ge'" not in roster and "'fedavg'" not in roster


@pytest.mark.parametrize("method", ["decavg", "cfa", "dechetero+vt"])
def test_other_transport_methods_run_finite(references, tworld, method):
    params0 = references["per-node-int8"][0]
    for cfg in (CommConfig(codec="bf16"),
                CommConfig(codec="int8", policy="adaptive")):
        exp, hist = _run(tworld, params0, rounds=2, method=method, comm=cfg)
        assert all(np.isfinite(m.acc_per_node).all() for m in hist)
        assert all(torch.isfinite(p).all() for p in tree_leaves(exp.params))
        assert hist[-1].bytes_on_wire > 0


class _PaddedDecAvg(AggregationStrategy):
    """DecAvg through the padded-gather form only (no flat_aggregate)."""

    name = "padded-decavg"

    def aggregate(self, exp, state, params, gathered, mask):
        w = state["weights"] * mask
        sw = state["counts"]
        total = torch.sum(w, dim=1) + sw

        def one(p, g):
            wb = w.reshape(w.shape + (1,) * (g.dim() - 2))
            sums = torch.sum(wb * g, dim=1)
            shape = (-1,) + (1,) * (p.dim() - 1)
            return (sw / total).reshape(shape) * p + sums / total.reshape(
                shape)

        return tree_map(one, params, gathered)


@pytest.mark.parametrize("cfg", [None, dict(codec="int8", stochastic=False),
                                 dict(codec="int8", policy="adaptive",
                                      stochastic=False)],
                         ids=["no-transport", "per-node", "per-edge"])
def test_padded_gather_fallback_matches_flat_form(references, tworld, cfg,
                                                 monkeypatch):
    """A strategy without a flat form takes the padded-gather path on every
    transport, and agrees with the flat DecAvg to fp32 rounding (rtol
    1e-5, atol 1e-6: the padded sum is ordered differently from the
    kernel's)."""
    monkeypatch.setitem(strategies._REGISTRY, "padded-decavg",
                        MethodSpec("padded-decavg", _PaddedDecAvg()))
    assert _PaddedDecAvg.flat_aggregate is None
    assert DecAvgStrategy.flat_aggregate is not None
    params0 = references["per-node-int8"][0]
    comm = CommConfig(**cfg) if cfg else None
    padded, _ = _run(tworld, params0, rounds=2, method="padded-decavg",
                     comm=comm)
    flat, _ = _run(tworld, params0, rounds=2, method="dechetero", comm=comm)
    for a, b in zip(tree_leaves(padded.params), tree_leaves(flat.params)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-6)
    if comm is not None:
        assert padded.comm_bytes_total == flat.comm_bytes_total
