"""The EMNIST CNN's dropout in the engine against the reference, on the
CPU.

`repro.engine.Experiment` runs `decdiff+vt` on a 6-node Erdős–Rényi
synth-emnist world (p 0.5, scale 0.02: 416 train and 104 test images,
26 classes) with the full-width EMNIST CNN (dropout 0.25 after the pool,
0.5 after fc0), 4 local steps of batch 32 at lr 0.1 per round, 3 rounds
in loop mode; its initial params, graph and data are carried into
`repro_torch`.

EMNIST's CNN has dropout, whose keep masks come from JAX's stream in the
reference and from the experiment's `torch.Generator` in the port, so the
two runs are compared in distribution: every keep mask the port draws
keeps a fraction within 4 binomial sigmas of its keep probability, and
the port's final mean accuracy lies within 0.04 (~4 of the 104 test
images) of the reference's: after 12 steps the models sit a little above
chance (1/26), and two independent streams of keep masks move each
node's accuracy by a few test images, which the mean over 6 nodes
shrinks.  Inside the port fused equals loop bitwise with dropout on, in
the local steps and in CFA-GE's gradient walk.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro_torch import convert
from repro_torch.engine import Experiment
from repro_torch.models.mlp_cnn import model_for_dataset
from repro_torch.utils.pytree import tree_leaves

EMNIST = dict(nodes=6, topology="erdos_renyi", p=0.5, scale=0.02)
EMNIST_TRAIN = dict(steps_per_round=4, batch_size=32, lr=0.1)



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
def emnist_reference():
    """`decdiff+vt` run by the JAX package, its `lax.scan`s unrolled (as in
    tests/test_torch_cnn_experiment.py): (world, init params, history)."""
    from repro.engine import Experiment as JExperiment
    from repro.engine import World as JWorld

    scan = jax.lax.scan

    def unrolled(f, init, xs=None, length=None, **kw):
        kw["unroll"] = True
        return scan(f, init, xs, length, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.lax, "scan", unrolled)
        jw = JWorld.synthetic("synth-emnist", **EMNIST)
        je = JExperiment(jw, "decdiff+vt", **EMNIST_TRAIN)
        params0 = jax.tree.map(np.asarray, je.params)
        hist = je.run(rounds=3, eval_every=1, mode="loop")
    return jw, params0, hist


def _run(world, method, params0, mode="loop", train=EMNIST_TRAIN):
    exp = Experiment(world, method, device="cpu", **train)
    exp.params = convert.params_from_numpy(params0, "cpu")
    exp.opt_state = exp.optimizer.init(exp.params)
    return exp, exp.run(rounds=3, eval_every=1, mode=mode)


def _same(a, b):
    (ea, ha), (eb, hb) = a, b
    for x, y in zip(tree_leaves(ea.params), tree_leaves(eb.params)):
        assert torch.equal(x, y)
    assert ea.train_loss_history == eb.train_loss_history
    for ma, mb in zip(ha, hb):
        np.testing.assert_array_equal(ma.acc_per_node, mb.acc_per_node)
        np.testing.assert_array_equal(ma.loss_per_node, mb.loss_per_node)


@pytest.fixture(scope="module")
def eworld(emnist_reference):
    jw = emnist_reference[0]
    return convert.world_from_arrays(
        model=model_for_dataset("synth-emnist", 26),
        adjacency=jw.topo.adjacency, weights=jw.topo.weights, xs=jw.xs,
        ys=jw.ys, x_test=jw.x_test, y_test=jw.y_test, device="cpu")


def _recording(exp):
    """Wrap the experiment's keep source to record every (p, mask) drawn
    in the local steps (the round is rebuilt over the wrapped step)."""
    from repro_torch.engine import backends

    drawn = []
    inner = exp._train_step.keywords["keep"]

    def keep(shape, p):
        mask = inner(shape, p)
        drawn.append((p, mask))
        return mask

    exp._train_step = functools.partial(exp._train_step.func, keep=keep)
    exp._round = backends.build_round(exp)
    return drawn


def test_emnist_dropout_in_distribution(emnist_reference, eworld):
    _, params0, jhist = emnist_reference
    exp = Experiment(eworld, "decdiff+vt", device="cpu", **EMNIST_TRAIN)
    exp.params = convert.params_from_numpy(params0, "cpu")
    exp.opt_state = exp.optimizer.init(exp.params)
    drawn = _recording(exp)
    hist = exp.run(rounds=3, eval_every=1, mode="loop")
    # one draw per dropout layer per local step, over the full node axis
    assert [p for p, _ in drawn] == [0.75, 0.5] * 12
    for p, mask in drawn:
        assert mask.dtype == torch.bool and mask.shape[:2] == (6, 32)
        n = mask.numel()
        frac = float(mask.float().mean())
        assert abs(frac - p) <= 4 * np.sqrt(p * (1 - p) / n)
    assert all(torch.isfinite(t).all() for t in tree_leaves(exp.params))
    assert abs(hist[-1].acc_mean - jhist[-1].acc_mean) <= 0.04


@pytest.mark.parametrize("method", ["decdiff+vt", "cfa-ge"])
def test_emnist_dropout_fused_equals_loop(emnist_reference, eworld, method):
    params0 = emnist_reference[1]
    runs = [_run(eworld, method, params0, mode=mode)
            for mode in ("loop", "fused")]
    _same(*runs)
    # the keep masks come from the experiment's generator: another seed
    # of it (the init is the same carried one) gives other params
    other = _run(eworld, method, params0, train=dict(EMNIST_TRAIN, seed=1))
    assert not all(torch.equal(a, b) for a, b in zip(
        tree_leaves(other[0].params), tree_leaves(runs[0][0].params)))
