"""The Table II roster on the Table I CNN against the reference, on the CPU.

`repro.engine.Experiment` runs each of the seven Table II methods of
`benchmarks/bench_accuracy.py` (isol, fedavg, dechetero, cfa, cfa-ge,
decdiff, decdiff+vt) on a 6-node Erdős–Rényi synth-fashion world (p 0.5,
scale 0.004: 240 train and 40 test images) with the full-width Fashion
CNN, 2 local steps of batch 32 per round, 3 rounds in loop mode.  Its
initial params, graph and data are carried into `repro_torch`.  The
Fashion CNN has no dropout and participation is 1, so neither side draws a
random number during the rounds.  The reference's `lax.scan`s run unrolled
(XLA's CPU convolution is ~25x slower inside a while loop; unrolling
changes no operation).

Tolerances: per-node params within atol 1e-4 and per-node accuracy within
one test sample (eval loss within 1e-4), as the MLP slice.  Inside the
port: fused equals loop bitwise, and the sparse layout equals the dense
one bitwise.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro_torch import convert
from repro_torch.engine import Experiment
from repro_torch.models.mlp_cnn import model_for_dataset
from repro_torch.utils.pytree import tree_leaves

WORLD = dict(nodes=6, topology="erdos_renyi", p=0.5, scale=0.004)
TRAIN = dict(steps_per_round=2, batch_size=32)
METHODS = ("isol", "fedavg", "dechetero", "cfa", "cfa-ge", "decdiff",
           "decdiff+vt")



@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads: the suite runs several worker processes at
    once, and the CNN's CPU convolutions slow down many-fold when every
    worker spins a thread per core."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)

@pytest.fixture(scope="module")
def unrolled():
    scan = jax.lax.scan

    def unrolled_scan(f, init, xs=None, length=None, **kw):
        kw["unroll"] = True
        return scan(f, init, xs, length, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.lax, "scan", unrolled_scan)
        yield


def _reference(dataset, world_kw, train, methods):
    """Each method run by the JAX package: (world, {method: (init params,
    eval history, final params)})."""
    from repro.engine import Experiment as JExperiment
    from repro.engine import World as JWorld

    jw = JWorld.synthetic(dataset, **world_kw)
    out = {}
    for method in methods:
        je = JExperiment(jw, method, **train)
        params0 = jax.tree.map(np.asarray, je.params)
        hist = je.run(rounds=3, eval_every=1, mode="loop")
        out[method] = (params0, hist, jax.tree.map(np.asarray, je.params))
    return jw, out


@pytest.fixture(scope="module")
def reference(unrolled):
    return _reference("synth-fashion", WORLD, TRAIN, METHODS)


def _carried_world(jw, dataset):
    return convert.world_from_arrays(
        model=model_for_dataset(dataset, jw.model.num_classes),
        adjacency=jw.topo.adjacency, weights=jw.topo.weights, xs=jw.xs,
        ys=jw.ys, x_test=jw.x_test, y_test=jw.y_test, device="cpu")


@pytest.fixture(scope="module")
def tworld(reference):
    return _carried_world(reference[0], "synth-fashion")


def _run(world, method, params0, mode="loop", train=TRAIN, **kw):
    exp = Experiment(world, method, device="cpu", **train, **kw)
    exp.params = convert.params_from_numpy(params0, "cpu")
    exp.opt_state = exp.optimizer.init(exp.params)
    return exp, exp.run(rounds=3, eval_every=1, mode=mode)


@pytest.fixture(scope="module")
def port_loop(reference, tworld):
    return {m: _run(tworld, m, reference[1][m][0]) for m in METHODS}


def _used(jw):
    n = len(jw.x_test)
    return (n // min(128, n)) * min(128, n)


def _same(a, b):
    (ea, ha), (eb, hb) = a, b
    for x, y in zip(tree_leaves(ea.params), tree_leaves(eb.params)):
        assert torch.equal(x, y)
    assert ea.train_loss_history == eb.train_loss_history
    assert [m.round for m in ha] == [m.round for m in hb] == [0, 1, 2]
    for ma, mb in zip(ha, hb):
        np.testing.assert_array_equal(ma.acc_per_node, mb.acc_per_node)
        np.testing.assert_array_equal(ma.loss_per_node, mb.loss_per_node)


@pytest.mark.parametrize("method", METHODS)
def test_table2_method_matches_jax(reference, port_loop, method):
    jw, runs = reference
    _, jhist, jparams = runs[method]
    exp, thist = port_loop[method]
    tparams = convert.params_to_numpy(exp.params)
    for layer in jparams:
        for leaf in jparams[layer]:
            np.testing.assert_allclose(tparams[layer][leaf],
                                       jparams[layer][leaf], rtol=0,
                                       atol=1e-4)
    assert [m.round for m in thist] == [m.round for m in jhist] == [0, 1, 2]
    for jm, tm in zip(jhist, thist):
        assert (np.abs(tm.acc_per_node - jm.acc_per_node)
                * _used(jw)).max() <= 1.0 + 1e-6
        np.testing.assert_allclose(tm.loss_per_node, jm.loss_per_node,
                                   rtol=0, atol=1e-4)


@pytest.mark.parametrize("method", METHODS)
def test_table2_method_fused_equals_loop(reference, tworld, port_loop,
                                         method):
    _same(_run(tworld, method, reference[1][method][0], mode="fused"),
          port_loop[method])


@pytest.mark.parametrize("method", METHODS)
def test_table2_method_sparse_equals_dense(reference, tworld, port_loop,
                                           method):
    run = _run(tworld, method, reference[1][method][0], layout="sparse")
    assert run[0].layout == "sparse"
    _same(run, port_loop[method])


def test_cnn_without_dropout_draws_nothing(reference, tworld):
    """The Fashion CNN has no dropout: a run leaves the experiment's
    generator where it started, so the MLP's and the Fashion CNN's draws
    (none, by default) do not move."""
    exp = Experiment(tworld, "decdiff+vt", device="cpu", **TRAIN)
    state = exp.gen.get_state().clone()
    exp.run(rounds=2, eval_every=1)
    assert torch.equal(exp.gen.get_state(), state)


def test_synthetic_cnn_world_matches_reference(reference):
    """`World.synthetic("synth-fashion")` builds the same data and graph as
    the reference's, and the Table I CNN."""
    from repro_torch.engine import World

    jw = reference[0]
    tw = World.synthetic("synth-fashion", device="cpu", **WORLD)
    assert tw.model.name == "cnn" and tw.model.num_classes == 10
    np.testing.assert_array_equal(tw.topo.adjacency, jw.topo.adjacency)
    np.testing.assert_array_equal(tw.x_test, jw.x_test)
    for a, b in zip(tw.xs, jw.xs):
        np.testing.assert_array_equal(a, b)
