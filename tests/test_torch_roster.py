"""The whole method roster against the reference, on the CPU.

Every registered method runs 3 rounds in loop mode on the 16-node
Barabási–Albert synth-mnist world of tests/test_torch_experiment.py
(scale 0.03, MLP 784-64-32-10, 2 local steps of batch 32 per round), once
in the JAX package and once in the port from the reference's init, graph
and data.  Nothing in these runs draws a random number (deterministic
codecs, participation 1, no dropout).

The bf16 and top-k cases are in tests/test_torch_roster_codecs.py, which
imports this file's helpers (two files, so that the suite's workers share
the JAX runs).

Tolerances:
  * no transport, all 12 methods: per-node params within 1e-6 (the runs
    differ only in the fp32 order of XLA's and PyTorch's sums; a probe of
    all 12 found at most 7.5e-8), accuracies equal;
  * with a transport, every transport-capable method under int8 per node
    (always send, and with a 0.8 drift trigger), int8 per edge (adaptive,
    target 0.95), bf16 per edge at threshold 0.3 and top-k 5% per edge
    with momentum 0.5: bytes on the wire, the triggered fraction and
    accuracies exactly equal, and params within 1e-4 plus one grain of
    the codec, because an fp32 rounding difference can flip a quantizer
    decision and the flip then spreads through the gossip (ROADMAP C.1):
      - int8: the largest |param| / 127, one quantization step of the
        largest payload;
      - bf16: the largest |param| · 2^-7, one bf16 rounding step there;
      - top-k: the largest |param|: the transport's reference starts at
        zero, so an unsent coordinate's whole value rides in the error
        feedback residual, and a near-tie that flips which of two
        coordinates is selected moves at most one such value.
    Measured with this file's runs: no transport 7.5e-8 at most;
    int8 3.2e-4 against a 1.0e-3 grain; bf16 1.2e-4 against 1.0e-3;
    top-k 2.6e-3 (decdiff+vt, the round-3 near-tie).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro_torch import convert
from repro_torch.comm import CommConfig
from repro_torch.engine import Experiment
from repro_torch.engine.strategies import available_methods, get_method
from repro_torch.models.mlp_cnn import make_mlp

WORLD = dict(nodes=16, topology="barabasi_albert", m=2, scale=0.03)
TRAIN = dict(steps_per_round=2, batch_size=32)
METHODS = tuple(available_methods())
TRANSPORT_METHODS = tuple(m for m in METHODS
                          if get_method(m).strategy.supports_transport)
CODECS = {
    "int8-node": dict(codec="int8", stochastic=False),
    "int8-node-trigger": dict(codec="int8", stochastic=False,
                              trigger_threshold=0.8),
    "int8-edge-adaptive": dict(codec="int8", policy="adaptive",
                               target_trigger=0.95, stochastic=False),
}


def test_roster_is_the_reference_roster():
    assert len(METHODS) == 12
    assert len(TRANSPORT_METHODS) == 8
    assert "cfa-ge" not in TRANSPORT_METHODS
    assert "fedavg" not in TRANSPORT_METHODS


@pytest.fixture(scope="module")
def jworld():
    from repro.engine import World as JWorld
    from repro.models.mlp_cnn import make_mlp as jmake_mlp

    return JWorld.synthetic("synth-mnist", model=jmake_mlp(hidden=(64, 32)),
                            **WORLD)


@pytest.fixture(scope="module")
def tworld(jworld):
    return convert.world_from_arrays(
        model=make_mlp(hidden=(64, 32)), adjacency=jworld.topo.adjacency,
        weights=jworld.topo.weights, xs=jworld.xs, ys=jworld.ys,
        x_test=jworld.x_test, y_test=jworld.y_test, device="cpu")


def _both(jworld, tworld, method, cfg):
    """The reference's (final params, history, trigger history) and the
    port's, from the reference's init, 3 loop rounds; `cfg` the
    CommConfig fields, or None for no transport."""
    from repro.comm import CommConfig as JCommConfig
    from repro.engine import Experiment as JExperiment

    je = JExperiment(jworld, method,
                     comm=None if cfg is None else JCommConfig(**cfg),
                     **TRAIN)
    params0 = jax.tree.map(np.asarray, je.params)
    jhist = je.run(rounds=3, eval_every=1, mode="loop")
    exp = Experiment(tworld, method, device="cpu",
                     comm=None if cfg is None else CommConfig(**cfg), **TRAIN)
    exp.params = convert.params_from_numpy(params0, "cpu")
    exp.opt_state = exp.optimizer.init(exp.params)
    if exp.transport is not None:
        exp.comm_state = exp.transport.init_state(exp.params)
    thist = exp.run(rounds=3, eval_every=1, mode="loop")
    return (jax.tree.map(np.asarray, je.params), jhist,
            list(je.trig_history), convert.params_to_numpy(exp.params),
            thist, list(exp.trig_history))


def _grain(cfg, jparams):
    top = max(float(np.abs(jparams[k][kk]).max())
              for k in jparams for kk in jparams[k])
    if cfg is None:
        return 0.0
    return {"int8": top / 127.0, "bf16": top * 2.0 ** -7,
            "topk": top}[cfg["codec"]]


def _check(jworld, tworld, method, cfg, atol):
    jparams, jhist, jtrig, tparams, thist, ttrig = _both(jworld, tworld,
                                                         method, cfg)
    bound = atol + _grain(cfg, jparams)
    for layer in jparams:
        for leaf in jparams[layer]:
            np.testing.assert_allclose(tparams[layer][leaf],
                                       jparams[layer][leaf], rtol=0,
                                       atol=bound)
    assert [m.round for m in thist] == [m.round for m in jhist] == [0, 1, 2]
    for jm, tm in zip(jhist, thist):
        np.testing.assert_array_equal(tm.acc_per_node, jm.acc_per_node)
        assert tm.bytes_on_wire == jm.bytes_on_wire
        assert tm.triggered_frac == jm.triggered_frac
    assert ttrig == jtrig
    if cfg is not None:
        assert thist[-1].bytes_on_wire > 0


@pytest.mark.parametrize("method", METHODS)
def test_method_matches_jax_without_transport(jworld, tworld, method):
    _check(jworld, tworld, method, None, 1e-6)


@pytest.mark.parametrize("case", sorted(CODECS))
@pytest.mark.parametrize("method", TRANSPORT_METHODS)
def test_method_matches_jax_with_transport(jworld, tworld, method, case):
    _check(jworld, tworld, method, CODECS[case], 1e-4)
