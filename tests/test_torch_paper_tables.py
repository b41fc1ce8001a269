"""The modules of the paper's Table II / IV path against the reference, on
the CPU: the Table I CNN, the optimizers and schedules, the virtual
teacher's soft labels, the host-side minibatches, the model registry, the
tree byte count, the Table II / IV metrics and the centralized baseline.

Inputs are made with numpy from a fixed seed and handed to both packages.
Tolerances: pure copies (minibatches, the byte and size counts, the
metrics over shared histories, the registry) match exactly; the CNN's
forward and per-node gradients, the optimizers' steps and the soft labels
compare at rtol 1e-5, atol 1e-6 (XLA and PyTorch order and fuse the
convolutions' and products' fp32 sums differently); the centralized run,
many SGD steps of the full-width CNN, agrees to 1e-4 in params and eval
loss and to one test sample in accuracy.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp

from repro_torch import convert
from repro_torch.utils import pytree as tpytree

RTOL, ATOL = 1e-5, 1e-6


def _close(a, b, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                               atol=atol)


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads: the suite runs several worker processes at
    once, and the CNN's CPU convolutions slow down many-fold when every
    worker spins a thread per core."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture
def unrolled_scans(monkeypatch):
    """Run the reference's `lax.scan`s unrolled: XLA's CPU convolution is
    ~25x slower inside a while loop, and unrolling changes no operation."""
    scan = jax.lax.scan

    def unrolled(f, init, xs=None, length=None, **kw):
        kw["unroll"] = True
        return scan(f, init, xs, length, **kw)

    monkeypatch.setattr(jax.lax, "scan", unrolled)


# ------------------------------------------------------------------ CNN

VARIANTS = {"fashion": (10, False), "emnist": (26, True)}


def _cnn_pair(variant, n=3, seed=0):
    from repro.models.mlp_cnn import make_cnn as jcnn
    from repro_torch.models.mlp_cnn import make_cnn as tcnn

    classes, drop = VARIANTS[variant]
    jm = jcnn(num_classes=classes, use_pool_dropout=drop)
    tm = tcnn(num_classes=classes, use_pool_dropout=drop)
    jp = jax.jit(jax.vmap(jm.init))(
        jax.random.split(jax.random.PRNGKey(seed), n))
    npp = jax.tree.map(np.asarray, jp)
    return jm, tm, jp, convert.params_from_numpy(npp, "cpu")


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_cnn_forward_and_grads_match_jax(variant):
    """Training forward and per-node gradients at full Table I width on
    28x28 inputs; the EMNIST variant with the reference's own keep masks
    (`jax.random.bernoulli` under each node's dropout key) injected."""
    jm, tm, jp, tp = _cnn_pair(variant)
    n, b = 3, 5
    drop = VARIANTS[variant][1]
    rng = np.random.default_rng(1)
    x = rng.standard_normal((n, b, 28, 28)).astype(np.float32)
    y = rng.integers(0, jm.num_classes, (n, b))
    keys = jax.random.split(jax.random.PRNGKey(2), n)

    def jloss(p, x, y, k):
        lg = jm.apply(p, x, train=True, rng=k)
        return -jnp.mean(jax.nn.log_softmax(lg)[jnp.arange(b), y]), lg

    (_, jlogits), jgrads = jax.jit(jax.vmap(jax.value_and_grad(
        jloss, has_aux=True)))(jp, x, y, keys)
    masks = []
    if drop:
        pairs = [jax.random.split(k) for k in keys]
        masks = [torch.from_numpy(np.stack([np.asarray(
            jax.random.bernoulli(pr[i], keep_p, shape)) for pr in pairs]))
            for i, (keep_p, shape) in enumerate([(0.75, (b, 12, 12, 64)),
                                                 (0.5, (b, 128))])]
    drawn = []

    def keep(shape, p):
        m = masks[len(drawn)]
        drawn.append(p)
        assert tuple(m.shape) == tuple(shape)
        return m

    leaves = [t.detach().requires_grad_(True)
              for t in tpytree.tree_leaves(tp)]
    logits = tm.apply(tpytree.tree_unflatten_like(tp, leaves),
                      torch.from_numpy(x), train=True, keep=keep)
    loss = -torch.log_softmax(logits, -1).gather(
        -1, torch.from_numpy(y)[..., None])[..., 0].mean(-1)
    grads = torch.autograd.grad(loss.sum(), leaves)
    assert drawn == ([0.75, 0.5] if drop else [])
    _close(logits.detach().numpy(), jlogits)
    for g, jg in zip(grads, jax.tree.leaves(jgrads)):
        _close(g.numpy(), jg)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_cnn_eval_on_a_shared_batch_matches_jax(variant):
    """Evaluation feeds one batch [1, B, 28, 28] to every node, with no
    dropout even when a keep source is given."""
    jm, tm, jp, tp = _cnn_pair(variant, n=4, seed=3)
    x = np.random.default_rng(4).standard_normal((7, 28, 28)).astype(
        np.float32)
    jl = jax.jit(jax.vmap(lambda p: jm.apply(p, x)))(jp)

    def refuse(shape, p):
        raise AssertionError("evaluation drew a keep mask")

    tl = tm.apply(tp, torch.from_numpy(x)[None], keep=refuse)
    assert tuple(tl.shape) == (4, 7, jm.num_classes)
    _close(tl.numpy(), jl)


@pytest.mark.parametrize("classes,count", [(10, 1_199_882), (26, 1_201_946)])
def test_cnn_init_layout_and_size(classes, count):
    """HWIO conv weights and [in, out] dense weights, in the reference's
    shapes and flat order, uniform within ±1/sqrt(fan_in)."""
    from repro.models.mlp_cnn import make_cnn as jcnn
    from repro_torch.models.mlp_cnn import make_cnn

    model = make_cnn(num_classes=classes, use_pool_dropout=classes == 26)
    p = model.init(torch.Generator().manual_seed(0))
    jp = jax.eval_shape(jcnn(num_classes=classes).init,
                        jax.random.PRNGKey(0))
    assert [tuple(t.shape) for t in tpytree.tree_leaves(p)] == [
        a.shape for a in jax.tree.leaves(jp)]
    assert tpytree.tree_size(p) == count
    for name, fan_in in [("conv0", 9), ("conv1", 288), ("fc0", 9216),
                         ("fc1", 128)]:
        for leaf in p[name].values():
            assert float(leaf.abs().max()) <= 1.0 / np.sqrt(fan_in)


@pytest.mark.parametrize("dataset,model,drop", [
    ("synth-mnist", "mlp", None), ("synth-fashion", "cnn", False),
    ("synth-emnist", "cnn", True)])
def test_model_for_dataset_is_table_one(dataset, model, drop):
    from repro.models.mlp_cnn import model_for_dataset as jmodel
    from repro_torch.models.mlp_cnn import model_for_dataset

    classes = 26 if "emnist" in dataset else 10
    m = model_for_dataset(dataset, classes)
    jm = jmodel(dataset, classes)
    assert (m.name, m.num_classes) == (jm.name, jm.num_classes) == (
        model, classes)
    with pytest.raises(ValueError, match="no paper model"):
        model_for_dataset("cifar", 10)


# ------------------------------------------------------------ registry

@pytest.mark.parametrize("name,kw", [("mlp", dict(hidden=(32, 16))),
                                     ("cnn", dict(num_classes=26))])
def test_make_small_model_matches_jax(name, kw):
    from repro.models.api import make_small_model as jmake
    from repro_torch.models.api import SMALL_MODELS, make_small_model

    m, jm = make_small_model(name, **kw), jmake(name, **kw)
    assert (m.name, m.num_classes) == (jm.name, jm.num_classes)
    p = m.init(torch.Generator().manual_seed(0))
    assert [tuple(t.shape) for t in tpytree.tree_leaves(p)] == [
        a.shape for a in jax.tree.leaves(jm.init(jax.random.PRNGKey(0)))]
    assert sorted(SMALL_MODELS) == ["cnn", "mlp"]


def test_make_small_model_rejects_an_unknown_name():
    from repro_torch.models.api import make_small_model

    with pytest.raises(ValueError, match=r"unknown small model 'vit'; "
                                         r"available: \['cnn', 'mlp'\]"):
        make_small_model("vit")


# ------------------------------------------------------------ optimizers

def _trees(seed, shapes=((3, 5, 4), (3, 7))):
    rng = np.random.default_rng(seed)
    return [{"a": {"w": rng.standard_normal(shapes[0]).astype(np.float32)},
             "b": rng.standard_normal(shapes[1]).astype(np.float32)}
            for _ in range(6)]


def _run_both(jopt, topt, steps=5, seed=0):
    """`steps` updates from the same params and gradients in both
    packages; the port's in place."""
    trees = _trees(seed)
    jp, tp = trees[0], convert.params_from_numpy(trees[0], "cpu")
    js, ts = jopt.init(jp), topt.init(tp)
    for k in range(steps):
        g = trees[1 + k % 5]
        jp, js = jopt.update(g, js, jp, jnp.int32(k))
        tp2, ts = topt.update(convert.params_from_numpy(g, "cpu"), ts, tp, k)
        assert tp2 is tp
    return jp, js, tp, ts


def test_schedules_match_jax():
    from repro.optim.sgd import constant_schedule as jconst
    from repro.optim.sgd import cosine_schedule as jcos
    from repro_torch.optim.sgd import constant_schedule, cosine_schedule

    for step in (0, 1, 7, 10, 11, 50, 99, 100, 150):
        assert constant_schedule(0.1)(step) == float(jconst(0.1)(step))
        for args in [(0.3, 10, 100), (1e-3, 0, 40, 0.0), (0.05, 25, 20)]:
            _close(cosine_schedule(*args)(step),
                   jcos(*args)(jnp.int32(step)), rtol=1e-6, atol=0)


@pytest.mark.parametrize("kw", [
    dict(), dict(nesterov=True), dict(weight_decay=0.01),
    dict(nesterov=True, weight_decay=0.05), "cosine"],
    ids=["heavy-ball", "nesterov", "weight-decay", "nesterov-decay",
         "cosine-schedule"])
def test_sgd_momentum_variants_match_jax(kw):
    from repro.optim.sgd import cosine_schedule as jcos
    from repro.optim.sgd import sgd_momentum as jsgd
    from repro_torch.optim.sgd import cosine_schedule, sgd_momentum

    if kw == "cosine":
        jo = jsgd(lr=jcos(0.1, 2, 5), momentum=0.5)
        to = sgd_momentum(lr=cosine_schedule(0.1, 2, 5), momentum=0.5)
    else:
        jo, to = jsgd(lr=0.05, **kw), sgd_momentum(lr=0.05, **kw)
    jp, js, tp, ts = _run_both(jo, to)
    for a, b in zip(tpytree.tree_leaves(tp), jax.tree.leaves(jp)):
        _close(a.numpy(), b)
    for a, b in zip(tpytree.tree_leaves(ts), jax.tree.leaves(js)):
        _close(a.numpy(), b)


@pytest.mark.parametrize("schedule", ["constant", "cosine"])
def test_adamw_matches_jax(schedule):
    from repro.optim.sgd import adamw as jadamw
    from repro.optim.sgd import cosine_schedule as jcos
    from repro_torch.optim.sgd import adamw, cosine_schedule

    lr, jlr = ((1e-2, 1e-2) if schedule == "constant" else
               (cosine_schedule(1e-2, 2, 6), jcos(1e-2, 2, 6)))
    jp, js, tp, ts = _run_both(jadamw(lr=jlr, weight_decay=0.1),
                               adamw(lr=lr, weight_decay=0.1), steps=6)
    for a, b in zip(tpytree.tree_leaves(tp), jax.tree.leaves(jp)):
        _close(a.numpy(), b)
    for key in ("m", "v"):
        for a, b in zip(tpytree.tree_leaves(ts[key]),
                        jax.tree.leaves(js[key])):
            _close(a.numpy(), b)


@pytest.mark.parametrize("kw", [
    dict(), dict(name="sgd", lr=0.1, momentum=0.5, weight_decay=1e-3),
    dict(lr=0.2, schedule="cosine", warmup=2, total_steps=6),
    dict(name="adamw", lr=1e-2, weight_decay=0.05, schedule="cosine",
         warmup=1, total_steps=4)],
    ids=["default", "sgd-decay", "sgdm-cosine", "adamw-cosine"])
def test_make_optimizer_matches_jax(kw):
    from repro.optim.sgd import make_optimizer as jmake
    from repro_torch.optim.sgd import OptimizerConfig, make_optimizer

    jp, _, tp, _ = _run_both(jmake(**kw), make_optimizer(**kw), steps=5)
    for a, b in zip(tpytree.tree_leaves(tp), jax.tree.leaves(jp)):
        _close(a.numpy(), b)
    base = OptimizerConfig(lr=0.3)
    assert make_optimizer(base, momentum=0.0).init is not None
    with pytest.raises(ValueError, match="unknown optimizer 'lion'"):
        make_optimizer(name="lion")


def test_constant_rate_update_is_unchanged_bitwise():
    """A float rate takes the path the MLP and LM rounds always took: the
    same in-place ops, bitwise, whatever step is passed."""
    from repro_torch.optim.sgd import sgd_momentum

    trees = _trees(9)
    outs = []
    for step in (None, 0, 123):
        opt = sgd_momentum(lr=1e-3, momentum=0.9)
        p = convert.params_from_numpy(trees[0], "cpu")
        s = opt.init(p)
        opt.update(convert.params_from_numpy(trees[1], "cpu"), s, p, step)
        outs.append(tpytree.tree_leaves(p))
    g = convert.params_from_numpy(trees[1], "cpu")
    hand = convert.params_from_numpy(trees[0], "cpu")
    for p, gl in zip(tpytree.tree_leaves(hand), tpytree.tree_leaves(g)):
        v = torch.zeros_like(p).mul_(0.9).add_(gl)
        p.sub_(1e-3 * v)
    for out in outs:
        for a, b in zip(out, tpytree.tree_leaves(hand)):
            assert torch.equal(a, b)


# ------------------------------------------- small functions, bitwise

@pytest.mark.parametrize("beta,classes", [(0.95, 10), (0.9, 26), (1.0, 10)])
def test_soft_labels_match_jax(beta, classes):
    from repro.core.virtual_teacher import soft_labels as jsoft
    from repro_torch.core.virtual_teacher import soft_labels

    y = np.random.default_rng(5).integers(0, classes, (4, 9))
    t = soft_labels(torch.from_numpy(y), classes, beta)
    assert t.dtype == torch.float32 and tuple(t.shape) == (4, 9, classes)
    _close(t.numpy(), jsoft(jnp.asarray(y), classes, beta), atol=0)
    _close(t.sum(-1).numpy(), np.ones((4, 9)), rtol=1e-6, atol=0)


@pytest.mark.parametrize("n,bs,drop", [(103, 16, True), (103, 16, False),
                                       (64, 64, True), (10, 32, True)])
def test_minibatches_are_the_reference_batches(n, bs, drop):
    from repro.data.pipeline import minibatches as jbatches
    from repro_torch.data.pipeline import minibatches

    rng = np.random.default_rng(6)
    x = rng.standard_normal((n, 3, 2)).astype(np.float32)
    y = rng.integers(0, 10, n)
    ours = list(minibatches(x, y, bs, rng=np.random.default_rng(11),
                            drop_remainder=drop))
    ref = list(jbatches(x, y, bs, rng=np.random.default_rng(11),
                        drop_remainder=drop))
    assert len(ours) == len(ref) == (n // bs if drop else -(-n // bs))
    for (a, b), (c, d) in zip(ours, ref):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)


def test_tree_size_and_bytes_match_jax():
    from repro.models.mlp_cnn import make_cnn as jcnn
    from repro.utils.pytree import tree_bytes as jbytes
    from repro.utils.pytree import tree_size as jsize
    from repro_torch.models.mlp_cnn import make_cnn

    p = make_cnn().init(torch.Generator().manual_seed(0))
    jp = jcnn().init(jax.random.PRNGKey(0))
    assert tpytree.tree_size(p) == jsize(jp) == 1_199_882
    assert tpytree.tree_bytes(p) == jbytes(jp) == 4 * 1_199_882
    mixed = {"a": torch.zeros(3, 4, dtype=torch.bfloat16),
             "b": torch.zeros(5, dtype=torch.int8)}
    jmixed = {"a": jnp.zeros((3, 4), jnp.bfloat16),
              "b": jnp.zeros(5, jnp.int8)}
    assert tpytree.tree_bytes(mixed) == jbytes(jmixed) == 29


# --------------------------------------------------- Table II / IV metrics

def _histories(seed=7):
    """Four methods' eval histories as numpy (rounds, per-node accuracies
    and losses): one climbing past every threshold, one stalling below
    the top ones, one flat, one of a single round."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, rounds, lo, hi in [("decdiff+vt", 8, 0.1, 0.9),
                                 ("cfa", 8, 0.1, 0.62), ("isol", 5, 0.3, 0.3),
                                 ("fedavg", 1, 0.5, 0.5)]:
        means = np.linspace(lo, hi, rounds)
        out[name] = [(r * 5, np.clip(means[r] + 0.02 * rng.standard_normal(
            6), 0, 1).astype(np.float32), rng.random(6).astype(np.float32))
            for r in range(rounds)]
    return out


def _as(cls, hist):
    return [cls(round=r, acc_per_node=a, loss_per_node=l)
            for r, a, l in hist]


@pytest.mark.parametrize("thresholds", [(0.5, 0.8, 0.9, 0.95),
                                        (0.1, 0.99, 1.2)])
def test_characteristic_time_matches_jax(thresholds):
    from repro.fl.metrics import RoundMetrics as JRM
    from repro.fl.metrics import characteristic_time as jct
    from repro_torch.fl.metrics import RoundMetrics, characteristic_time

    for name, hist in _histories().items():
        for central in (0.7, 0.93):
            ours = characteristic_time(_as(RoundMetrics, hist), central,
                                       thresholds)
            assert ours == jct(_as(JRM, hist), central, thresholds), name
    climbing = characteristic_time(
        _as(RoundMetrics, _histories()["decdiff+vt"]), 1.0)
    assert climbing[0.5] is not None and climbing[0.95] is None


def test_characteristic_time_edge_cases():
    from repro_torch.fl.metrics import RoundMetrics, characteristic_time

    hist = _as(RoundMetrics, _histories()["cfa"])
    with pytest.raises(ValueError, match="empty history"):
        characteristic_time([], 0.9)
    for bad in (0.0, -0.1, float("nan")):
        with pytest.raises(ValueError, match="centralized_acc must be > 0"):
            characteristic_time(hist, bad)


def test_comm_bytes_per_round_matches_jax():
    from repro.fl.metrics import comm_bytes_per_round as jbytes
    from repro.graphs.topology import erdos_renyi as jer
    from repro_torch.fl.metrics import comm_bytes_per_round
    from repro_torch.graphs.sparse import SparseTopology
    from repro_torch.engine.strategies import available_methods
    from repro_torch.graphs.topology import erdos_renyi

    topo, jtopo = erdos_renyi(20, p=0.3, seed=1), jer(20, p=0.3, seed=1)
    sparse = SparseTopology.from_topology(topo)
    for method in list(available_methods()) + ["centralized", "none", "FED",
                                               "CFAGE"]:
        for live in (1.0, 0.5, 0.0):
            want = jbytes(method, jtopo, 4 * 1_199_882, live)
            assert comm_bytes_per_round(method, topo, 4 * 1_199_882,
                                        live) == want
            assert comm_bytes_per_round(method, sparse, 4 * 1_199_882,
                                        live) == want
    e = 2 * topo.num_edges
    assert comm_bytes_per_round("decdiff+vt", topo, 100) == e * 100
    assert comm_bytes_per_round("cfa-ge", topo, 100) == 4 * e * 100
    assert comm_bytes_per_round("fedavg", topo, 100) == 2 * 20 * 100
    assert comm_bytes_per_round("isol", topo, 100) == 0
    for bad in (-0.01, 1.5):
        with pytest.raises(ValueError, match=r"live_frac must be in \[0, 1\]"):
            comm_bytes_per_round("cfa", topo, 100, bad)


def test_accuracy_table_matches_jax():
    from repro.fl.metrics import RoundMetrics as JRM
    from repro.fl.metrics import accuracy_table as jtable
    from repro_torch.fl.metrics import RoundMetrics, accuracy_table

    hists = _histories()
    ours = accuracy_table({m: _as(RoundMetrics, h) for m, h in hists.items()})
    ref = jtable({m: _as(JRM, h) for m, h in hists.items()})
    assert ours == ref
    assert list(ours) == list(hists)
    assert ours["cfa"]["round"] == 35
    with pytest.raises(ValueError, match="method 'cfa' has an empty"):
        accuracy_table({"isol": _as(RoundMetrics, hists["isol"]),
                        "cfa": []})


# ------------------------------------------------------ centralized

@pytest.mark.usefixtures("unrolled_scans")
def test_centralized_train_matches_jax():
    """Two epochs of the Fashion CNN at full width on a small split (300
    images, batch 64, lr 0.05, momentum 0.9: run_centralized's settings),
    the reference's init carried across: the same batches
    (`minibatches` under `default_rng(seed)`), eval loss within 1e-4,
    accuracy within one test sample, params within 1e-4."""
    from repro.fl.trainer import centralized_train as jcentral
    from repro.models.mlp_cnn import make_cnn as jcnn
    from repro.optim.sgd import make_optimizer as jmake
    from repro_torch.data.synth import make_dataset
    from repro_torch.fl.trainer import centralized_train
    from repro_torch.models.mlp_cnn import make_cnn
    from repro_torch.optim.sgd import make_optimizer

    ds = make_dataset("synth-fashion", seed=0, scale=0.005)
    args = (ds.x_train, ds.y_train, ds.x_test, ds.y_test)
    kw = dict(epochs=2, batch_size=64, seed=3, eval_every=1)
    jm = jcnn()
    jparams, jhist = jcentral(jm, jmake(lr=0.05, momentum=0.9), *args, **kw)
    init = jax.tree.map(lambda a: torch.from_numpy(np.array(a)),
                        jm.init(jax.random.PRNGKey(3)))
    params, hist = centralized_train(make_cnn(), make_optimizer(
        lr=0.05, momentum=0.9), *args, init_params=init, device="cpu", **kw)
    n_test = len(ds.x_test)
    assert [h["epoch"] for h in hist] == [h["epoch"] for h in jhist] == [0, 1]
    for h, jh in zip(hist, jhist):
        assert abs(h["acc"] - jh["acc"]) * n_test <= 1.0 + 1e-6
        assert abs(h["loss"] - jh["loss"]) <= 1e-4
    for a, b in zip(tpytree.tree_leaves(params), jax.tree.leaves(jparams)):
        assert tuple(a.shape) == b.shape
        _close(a.numpy(), b, rtol=0, atol=1e-4)


def test_centralized_train_defaults_and_dropout_stream():
    """Without `init_params` the init comes from `seed`; the EMNIST CNN's
    dropout draws from the `seed + 1` generator, so a rerun is bitwise."""
    from repro_torch.data.synth import make_dataset
    from repro_torch.fl.trainer import centralized_train
    from repro_torch.models.mlp_cnn import model_for_dataset
    from repro_torch.optim.sgd import make_optimizer

    ds = make_dataset("synth-emnist", seed=0, scale=0.01)
    runs = [centralized_train(model_for_dataset("synth-emnist", 26),
                              make_optimizer(lr=0.05), ds.x_train, ds.y_train,
                              ds.x_test, ds.y_test, epochs=1, batch_size=64,
                              loss="vt", device="cpu") for _ in range(2)]
    (p0, h0), (p1, h1) = runs
    assert h0 == h1 and len(h0) == 1 and 0.0 <= h0[0]["acc"] <= 1.0
    assert all(torch.equal(a, b) for a, b in zip(tpytree.tree_leaves(p0),
                                                 tpytree.tree_leaves(p1)))
    assert tuple(p0["fc1"]["w"].shape) == (128, 26)
