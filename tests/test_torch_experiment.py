"""The whole slice against the reference, on the CPU.

`repro.engine.Experiment` runs `decdiff+vt` on a 16-node Barabási–Albert
synth-mnist world (scale 0.03, MLP 784-64-32-10, 2 local steps of batch 32
per round).  Its initial params, topology and data are carried into
`repro_torch`, and both run 3 rounds in loop mode.  The MLP has no dropout
and participation is 1, so neither side draws a random number during the
rounds and the runs are comparable step for step.

Tolerances: per-node params agree to atol=1e-4 (after 6 SGD steps and 3
DecDiff exchanges of fp32 arithmetic ordered differently by XLA and
PyTorch); per-node eval accuracy agrees to one test sample.  Inside the
port, fused and loop schedules are bitwise equal.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro_torch import convert
from repro_torch.engine import Experiment, Schedule, World
from repro_torch.models.mlp_cnn import make_mlp
from repro_torch.utils.pytree import tree_leaves

WORLD = dict(nodes=16, topology="barabasi_albert", m=2, scale=0.03)
TRAIN = dict(steps_per_round=2, batch_size=32)


@pytest.fixture(scope="module")
def reference():
    from repro.engine import Experiment as JExperiment
    from repro.engine import World as JWorld
    from repro.models.mlp_cnn import make_mlp as jmake_mlp

    jw = JWorld.synthetic("synth-mnist", model=jmake_mlp(hidden=(64, 32)),
                          **WORLD)
    je = JExperiment(jw, "decdiff+vt", **TRAIN)
    params0 = jax.tree.map(np.asarray, je.params)
    hist = je.run(rounds=3, eval_every=1, mode="loop")
    return jw, params0, hist, jax.tree.map(np.asarray, je.params)


def _carried_world(jw):
    return convert.world_from_arrays(
        model=make_mlp(hidden=(64, 32)), adjacency=jw.topo.adjacency,
        weights=jw.topo.weights, xs=jw.xs, ys=jw.ys, x_test=jw.x_test,
        y_test=jw.y_test, device="cpu")


def _carried_experiment(jw, params0, **kw):
    exp = Experiment(_carried_world(jw), "decdiff+vt", device="cpu",
                     **TRAIN, **kw)
    exp.params = convert.params_from_numpy(params0, "cpu")
    exp.opt_state = exp.optimizer.init(exp.params)
    return exp


@pytest.fixture(scope="module")
def port_loop(reference):
    jw, params0, _, _ = reference
    exp = _carried_experiment(jw, params0)
    hist = exp.run(rounds=3, eval_every=1, mode="loop")
    return exp, hist


def test_params_match_reference_after_three_rounds(reference, port_loop):
    _, _, _, jparams = reference
    exp, _ = port_loop
    tparams = convert.params_to_numpy(exp.params)
    for layer in jparams:
        for leaf in jparams[layer]:
            np.testing.assert_allclose(tparams[layer][leaf],
                                       jparams[layer][leaf], rtol=0,
                                       atol=1e-4)


def test_accuracy_matches_reference_to_one_sample(reference, port_loop):
    jw, _, jhist, _ = reference
    _, thist = port_loop
    used = (len(jw.x_test) // min(128, len(jw.x_test))) * min(
        128, len(jw.x_test))
    assert [m.round for m in thist] == [m.round for m in jhist] == [0, 1, 2]
    for jm, tm in zip(jhist, thist):
        diff = np.abs(tm.acc_per_node - jm.acc_per_node) * used
        assert diff.max() <= 1.0 + 1e-6
        np.testing.assert_allclose(tm.loss_per_node, jm.loss_per_node,
                                   rtol=1e-4, atol=1e-4)


def test_train_loss_is_recorded_and_finite(port_loop):
    exp, _ = port_loop
    assert len(exp.train_loss_history) == 3
    assert np.isfinite(exp.train_loss_history).all()


def test_fused_equals_loop_bitwise(reference, port_loop):
    jw, params0, _, _ = reference
    loop_exp, loop_hist = port_loop
    exp = _carried_experiment(jw, params0)
    hist = exp.run(rounds=3, eval_every=1, mode="fused")
    for a, b in zip(tree_leaves(exp.params), tree_leaves(loop_exp.params)):
        assert torch.equal(a, b)
    assert exp.train_loss_history == loop_exp.train_loss_history
    for a, b in zip(hist, loop_hist):
        assert a.round == b.round
        np.testing.assert_array_equal(a.acc_per_node, b.acc_per_node)
        np.testing.assert_array_equal(a.loss_per_node, b.loss_per_node)


@pytest.mark.parametrize("kw", [dict(hetero_steps_min=1),
                                dict(participation=0.5)],
                         ids=["hetero-steps", "participation"])
def test_generator_paths_keep_fused_equal_to_loop(reference, kw):
    """The rounds' own draws come from the experiment's generator, so the
    two schedule modes stay bitwise equal when they draw."""
    jw, params0, _, _ = reference
    runs = []
    for mode in ("loop", "fused"):
        exp = _carried_experiment(jw, params0, **kw)
        runs.append((exp.run(rounds=3, eval_every=2, mode=mode), exp))
    (h0, e0), (h1, e1) = runs
    for a, b in zip(tree_leaves(e0.params), tree_leaves(e1.params)):
        assert torch.equal(a, b)
    assert [m.round for m in h0] == [m.round for m in h1] == [0, 2]
    assert np.isfinite(e1.train_loss_history).all()


def test_synthetic_world_matches_reference(reference):
    jw, _, _, _ = reference
    tw = World.synthetic("synth-mnist", model=make_mlp(hidden=(64, 32)),
                         device="cpu", **WORLD)
    np.testing.assert_array_equal(tw.topo.adjacency, jw.topo.adjacency)
    np.testing.assert_array_equal(tw.x_test, jw.x_test)
    for a, b in zip(tw.xs, jw.xs):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tw.ys, jw.ys):
        np.testing.assert_array_equal(a, b)


def test_run_continues_from_current_state(reference):
    jw, params0, _, _ = reference
    exp = _carried_experiment(jw, params0,
                              schedule=Schedule(rounds=2, eval_every=1))
    first = exp.run()
    after_first = [p.clone() for p in tree_leaves(exp.params)]
    second = exp.run()
    assert [m.round for m in first] == [m.round for m in second] == [0, 1]
    assert len(exp.train_loss_history) == 4
    assert not all(torch.equal(a, b)
                   for a, b in zip(after_first, tree_leaves(exp.params)))


@pytest.mark.parametrize("method", ["isol", "decavg", "dechetero+vt",
                                    "cfa", "decdiff"])
def test_other_methods_run_finite(reference, method):
    jw, _, _, _ = reference
    exp = Experiment(_carried_world(jw), method, device="cpu", **TRAIN)
    hist = exp.run(rounds=2, eval_every=1)
    assert all(np.isfinite(m.acc_per_node).all() for m in hist)
    assert all(torch.isfinite(p).all() for p in tree_leaves(exp.params))


# ----------------------------------------------------------- entry points

def test_device_none_raises_without_cuda(reference):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: device=None resolves to the card")
    jw, _, _, _ = reference
    world = _carried_world(jw)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Experiment(world)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        World.synthetic("synth-mnist", nodes=4, scale=0.005)


@pytest.mark.parametrize("case,item", [
    ("comm", "A.5"), ("sparse", "A.6"), ("dynamics", "A.7"),
    ("timing", "A.8"), ("deadline", "A.8"), ("telemetry", "A.9"),
    ("shard_map", "A.10"), ("cnn", "A.2"), ("fedavg", "A.3"),
    ("cfa-ge", "A.3")])
def test_unported_options_name_their_roadmap_item(reference, case, item):
    jw, _, _, _ = reference
    world = _carried_world(jw)
    calls = {
        "comm": lambda: Experiment(world, comm=object(), device="cpu"),
        "sparse": lambda: Experiment(world, layout="sparse", device="cpu"),
        "dynamics": lambda: World.synthetic(nodes=4, scale=0.005,
                                            dynamics=object(), device="cpu"),
        "timing": lambda: World.synthetic(nodes=4, scale=0.005,
                                          timing=object(), device="cpu"),
        "deadline": lambda: Schedule(deadline=1.0),
        "telemetry": lambda: World.synthetic(nodes=4, scale=0.005,
                                             telemetry=object(),
                                             device="cpu"),
        "shard_map": lambda: Experiment(world, backend="shard_map",
                                        device="cpu"),
        "cnn": lambda: World.synthetic("synth-fashion", nodes=4, scale=0.005,
                                       device="cpu"),
        "fedavg": lambda: Experiment(world, "fedavg", device="cpu"),
        "cfa-ge": lambda: Experiment(world, "cfa-ge", device="cpu"),
    }
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        calls[case]()
