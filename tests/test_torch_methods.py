"""The paper's FED and CFA-GE baselines through `Experiment.run`, against
the reference, on the CPU.

`repro.engine.Experiment` runs `fedavg`, `fedavg+vt` and `cfa-ge` (once
more with `ge_lr` set) on the 16-node Barabási–Albert synth-mnist world of
`tests/test_torch_experiment.py` (scale 0.03, MLP 784-64-32-10, 2 local
steps of batch 32 per round).  Its initial params, topology and data are
carried into `repro_torch`, and both run 3 rounds in loop mode.  The MLP
has no dropout and participation is 1, so neither side draws a random
number during the rounds (CFA-GE's per-slot dropout keys consume nothing).

Tolerances: per-node params agree to atol=1e-4 and per-node eval accuracy
to one test sample, as for `decdiff+vt`; gradients at 1e-5 relative plus
1e-6 absolute.  Inside the port, fused and loop schedules are bitwise
equal, and FedAvg leaves every node's params bitwise equal.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro_torch import convert
from repro_torch.comm import CommConfig
from repro_torch.engine import Experiment
from repro_torch.engine.strategies import (AggregationStrategy,
                                           DecDiffStrategy, _REGISTRY,
                                           register_method)
from repro_torch.models.mlp_cnn import make_mlp
from repro_torch.utils.pytree import tree_leaves

WORLD = dict(nodes=16, topology="barabasi_albert", m=2, scale=0.03)
TRAIN = dict(steps_per_round=2, batch_size=32)
CASES = {"fedavg": ("fedavg", {}), "fedavg+vt": ("fedavg+vt", {}),
         "cfa-ge": ("cfa-ge", {}),
         "cfa-ge-ge_lr": ("cfa-ge", dict(ge_lr=0.05))}


@pytest.fixture(scope="module")
def jworld():
    from repro.engine import World as JWorld
    from repro.models.mlp_cnn import make_mlp as jmake_mlp

    return JWorld.synthetic("synth-mnist", model=jmake_mlp(hidden=(64, 32)),
                            **WORLD)


@pytest.fixture(scope="module", params=list(CASES))
def reference(request, jworld):
    from repro.engine import Experiment as JExperiment

    method, kw = CASES[request.param]
    je = JExperiment(jworld, method, **TRAIN, **kw)
    params0 = jax.tree.map(np.asarray, je.params)
    hist = je.run(rounds=3, eval_every=1, mode="loop")
    return request.param, params0, hist, jax.tree.map(np.asarray, je.params)


def _carried_world(jw):
    return convert.world_from_arrays(
        model=make_mlp(hidden=(64, 32)), adjacency=jw.topo.adjacency,
        weights=jw.topo.weights, xs=jw.xs, ys=jw.ys, x_test=jw.x_test,
        y_test=jw.y_test, device="cpu")


def _carried_experiment(jw, params0, method, **kw):
    exp = Experiment(_carried_world(jw), method, device="cpu", **TRAIN, **kw)
    exp.params = convert.params_from_numpy(params0, "cpu")
    exp.opt_state = exp.optimizer.init(exp.params)
    return exp


def _run(jw, reference, mode="loop"):
    case, params0, _, _ = reference
    method, kw = CASES[case]
    exp = _carried_experiment(jw, params0, method, **kw)
    return exp, exp.run(rounds=3, eval_every=1, mode=mode)


def test_three_rounds_match_reference(jworld, reference):
    case, _, jhist, jparams = reference
    exp, thist = _run(jworld, reference)
    tparams = convert.params_to_numpy(exp.params)
    for layer in jparams:
        for leaf in jparams[layer]:
            np.testing.assert_allclose(tparams[layer][leaf],
                                       jparams[layer][leaf], rtol=0,
                                       atol=1e-4)
    used = (len(jworld.x_test) // min(128, len(jworld.x_test))) * min(
        128, len(jworld.x_test))
    assert [m.round for m in thist] == [m.round for m in jhist] == [0, 1, 2]
    for jm, tm in zip(jhist, thist):
        assert np.abs(tm.acc_per_node - jm.acc_per_node).max() * used \
            <= 1.0 + 1e-6
        np.testing.assert_allclose(tm.loss_per_node, jm.loss_per_node,
                                   rtol=1e-4, atol=1e-4)
    assert len(exp.train_loss_history) == 3
    assert np.isfinite(exp.train_loss_history).all()
    if case.startswith("fedavg"):
        # the server's average lands in every row, in both packages: after
        # every round each node evaluates alike, and the final rows agree
        for hist in (jhist, thist):
            for m in hist:
                assert (m.acc_per_node == m.acc_per_node[0]).all()
                assert (m.loss_per_node == m.loss_per_node[0]).all()
        for params in (jparams, tparams):
            for layer in params:
                for leaf in params[layer]:
                    rows = np.asarray(params[layer][leaf])
                    assert (rows == rows[:1]).all()


def test_fused_equals_loop_bitwise(jworld, reference):
    loop_exp, loop_hist = _run(jworld, reference, "loop")
    exp, hist = _run(jworld, reference, "fused")
    for a, b in zip(tree_leaves(exp.params), tree_leaves(loop_exp.params)):
        assert torch.equal(a, b)
    assert exp.train_loss_history == loop_exp.train_loss_history
    for a, b in zip(hist, loop_hist):
        assert a.round == b.round
        np.testing.assert_array_equal(a.acc_per_node, b.acc_per_node)
        np.testing.assert_array_equal(a.loss_per_node, b.loss_per_node)


@pytest.mark.parametrize("method", ["fedavg", "fedavg+vt"])
def test_fedavg_rows_are_copies_and_diverge_after_a_local_step(jworld,
                                                               method):
    """Each node's row is its own storage after a server round: the next
    local step (in-place SGD) moves the rows apart, as each node trains on
    its own data."""
    exp = Experiment(_carried_world(jworld), method, device="cpu", **TRAIN)
    exp.run(rounds=1, eval_every=1)
    for t in tree_leaves(exp.params):
        assert t.stride()[0] != 0
        assert all(torch.equal(t[0], t[i]) for i in range(1, exp.n))
    xb, yb = exp.batcher.take(exp.x_pad, exp.y_pad, exp.counts, 0)
    exp._train_step(exp.params, exp.opt_state, xb, yb)
    for t in tree_leaves(exp.params):
        assert not torch.equal(t[0], t[1])


def test_common_init_gives_every_node_one_model(jworld):
    exp = Experiment(_carried_world(jworld), "fedavg", device="cpu", **TRAIN)
    for t in tree_leaves(exp.params):
        assert all(torch.equal(t[0], t[i]) for i in range(1, exp.n))


@pytest.mark.parametrize("mask", ["silent", "ge_lr=0"])
def test_gradient_exchange_without_weight_keeps_the_models(jworld, mask):
    """A node whose delivered total is 0 keeps its model, and so does a
    zero exchange rate: padded and silent slots add exactly +0."""
    from repro_torch.engine.backends import _make_gradient_exchange

    kw = dict(ge_lr=0.0) if mask == "ge_lr=0" else {}
    exp = Experiment(_carried_world(jworld), "cfa-ge", device="cpu",
                     **TRAIN, **kw)
    link = exp.nbr_valid * (0.0 if mask == "silent" else 1.0)
    out = _make_gradient_exchange(exp)(exp.params, link, 5)
    for a, b in zip(tree_leaves(out), tree_leaves(exp.params)):
        assert torch.equal(a, b)


def test_grad_fn_matches_jax_per_node(jworld):
    from repro.core.virtual_teacher import make_loss_fn as jloss
    from repro.fl.trainer import make_grad_fn as jgrad
    from repro.models.mlp_cnn import make_mlp as jmake_mlp
    from repro_torch.core.virtual_teacher import make_loss_fn
    from repro_torch.fl.trainer import make_grad_fn

    jm = jmake_mlp(hidden=(64, 32))
    jp = jax.vmap(jm.init)(jax.random.split(jax.random.PRNGKey(4), 3))
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 8, 784)).astype(np.float32)
    y = rng.integers(0, 10, (3, 8))
    for kind in ("ce", "vt"):
        jg = jax.vmap(jgrad(jm, jloss(kind, beta=0.95)),
                      in_axes=(0, 0, 0, None))(jp, x, y, None)
        tg = make_grad_fn(make_mlp(hidden=(64, 32)),
                          make_loss_fn(kind, beta=0.95))(
            convert.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu"),
            torch.from_numpy(x), torch.from_numpy(y))
        for a, b in zip(tree_leaves(tg), jax.tree.leaves(jg)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                       atol=1e-6)


@pytest.mark.parametrize("method", ["cfa-ge", "fedavg"])
def test_transport_is_refused_with_the_capable_roster(jworld, method):
    with pytest.raises(ValueError, match="model-gossip only") as ei:
        Experiment(_carried_world(jworld), method, comm=CommConfig(),
                   device="cpu")
    roster = str(ei.value).split("transport-capable")[1]
    for m in ("'decdiff'", "'decdiff+vt'", "'dechetero'", "'cfa'"):
        assert m in roster
    assert "'cfa-ge'" not in roster and "'fedavg'" not in roster


class _PaddedOnlyDecDiff(AggregationStrategy):
    """DecDiff through the padded-gather form only (no flat form)."""

    name = "decdiff-padded-test"

    def aggregate(self, exp, state, params, gathered, mask):
        return DecDiffStrategy().aggregate(exp, state, params, gathered, mask)


def test_strategy_without_flat_form_runs_the_padded_gather(jworld):
    """A gossip strategy with only `aggregate` runs the engine through the
    padded-gather exchange, and agrees with the flat form's run."""
    register_method("decdiff-padded-test", _PaddedOnlyDecDiff(), loss="vt")
    try:
        runs = []
        for method in ("decdiff-padded-test", "decdiff+vt"):
            exp = Experiment(_carried_world(jworld), method, device="cpu",
                             **TRAIN)
            runs.append((exp.run(rounds=2, eval_every=1), exp.params))
    finally:
        del _REGISTRY["decdiff-padded-test"]
    (hp, pp), (hf, pf) = runs
    for a, b in zip(tree_leaves(pp), tree_leaves(pf)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-5)
    for a, b in zip(hp, hf):
        np.testing.assert_allclose(a.loss_per_node, b.loss_per_node,
                                   rtol=1e-4, atol=1e-5)
