"""Each ported module against its JAX counterpart, on the CPU.

Inputs are made with numpy from a fixed seed and handed to both packages.
Tolerances: modules that do the same float32 operations in the same order
(data builders, the batcher, the flat order, the param conversion) must
match exactly; products, reductions and autograd may be ordered or fused
differently by XLA and PyTorch, so those compare at rtol=1e-5,
atol=1e-6.
"""
import os
import subprocess
import sys
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp

from repro_torch import convert
from repro_torch.utils import pytree as tpytree

RTOL, ATOL = 1e-5, 1e-6
SRC = os.path.join(os.path.dirname(__file__), "..", "src")
EXAMPLES = os.path.join(os.path.dirname(__file__), "..", "examples_torch")


def _mlp_pair(hidden=(64, 32), n=4, seed=0):
    """JAX and port MLPs with the same stacked params (JAX-initialized)."""
    from repro.models.mlp_cnn import make_mlp as jmlp
    from repro_torch.models.mlp_cnn import make_mlp as tmlp

    jm, tm = jmlp(hidden=hidden), tmlp(hidden=hidden)
    keys = jax.random.split(jax.random.PRNGKey(seed), n)
    jp = jax.vmap(jm.init)(keys)
    npp = jax.tree.map(np.asarray, jp)
    return jm, tm, jp, convert.params_from_numpy(npp, "cpu"), npp


# ----------------------------------------------------------- flat order

def test_flat_order_matches_jax_tree_flatten():
    from repro.utils.pytree import tree_flatten_stacked as jflat

    _, _, jp, tp, _ = _mlp_pair(hidden=(16, 8, 4))
    jm_, _ = jflat(jp)
    tm_, unflat = tpytree.tree_flatten_stacked(tp)
    np.testing.assert_array_equal(tm_.numpy(), np.asarray(jm_))
    # sorted keys, depth first: fc0.b, fc0.w, fc1.b, ... as jax orders them
    assert [tuple(t.shape) for t in tpytree.tree_leaves(tp)] == [
        a.shape for a in jax.tree.leaves(jp)]
    first, second = tpytree.tree_leaves(tp)[:2]
    assert first is tp["fc0"]["b"] and second is tp["fc0"]["w"]
    back = unflat(tm_)
    for a, b in zip(tpytree.tree_leaves(back), tpytree.tree_leaves(tp)):
        assert torch.equal(a, b)


def test_flat_vector_round_trip():
    _, _, _, tp, _ = _mlp_pair()
    vec, unflat = tpytree.tree_flatten_to_vector(tp)
    assert vec.shape == (sum(t.numel() for t in tpytree.tree_leaves(tp)),)
    for a, b in zip(tpytree.tree_leaves(unflat(vec)), tpytree.tree_leaves(tp)):
        assert torch.equal(a, b)


def test_convert_round_trip_is_lossless():
    _, _, _, tp, npp = _mlp_pair()
    back = convert.params_to_numpy(tp)
    for k in npp:
        for kk in npp[k]:
            np.testing.assert_array_equal(back[k][kk], npp[k][kk])
            assert back[k][kk].dtype == npp[k][kk].dtype


# ----------------------------------------------------------- data

def test_dataset_and_allocation_are_copies():
    from repro.data.allocation import pad_node_datasets as jpad
    from repro.data.allocation import zipf_allocation as jzipf
    from repro.data.synth import make_dataset as jmake
    from repro_torch.data.allocation import pad_node_datasets, zipf_allocation
    from repro_torch.data.synth import make_dataset

    jd, td = jmake("synth-mnist", seed=3, scale=0.01), \
        make_dataset("synth-mnist", seed=3, scale=0.01)
    for f in ("x_train", "y_train", "x_test", "y_test"):
        np.testing.assert_array_equal(getattr(td, f), getattr(jd, f))
    ja, ta = jzipf(jd.y_train, 6, seed=1), zipf_allocation(td.y_train, 6,
                                                           seed=1)
    for a, b in zip(ja, ta):
        np.testing.assert_array_equal(a, b)
    xs = [td.x_train[ix] for ix in ta]
    ys = [td.y_train[ix] for ix in ta]
    for a, b in zip(jpad(xs, ys), pad_node_datasets(xs, ys)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name,kw,have_nx", [
    ("barabasi_albert", {"m": 2}, True), ("barabasi_albert", {"m": 2}, False),
    ("erdos_renyi", {"p": 0.3}, True), ("ring", {}, True), ("star", {}, True)])
def test_topology_builders_are_copies(monkeypatch, name, kw, have_nx):
    """Both BA branches: networkx and the fallback sampler (what runs on
    a host without networkx)."""
    import repro.graphs.topology as jt
    import repro_torch.graphs.topology as tt

    if not have_nx:
        monkeypatch.setattr(jt, "_HAVE_NX", False)
        monkeypatch.setattr(tt, "_HAVE_NX", False)
    a, b = jt.make_topology(name, n=12, **kw), tt.make_topology(name, n=12,
                                                                **kw)
    for f in ("adjacency", "weights", "neighbor_idx", "neighbor_mask"):
        np.testing.assert_array_equal(getattr(b, f), getattr(a, f))
    np.testing.assert_array_equal(b.neighbor_weights(), a.neighbor_weights())


@pytest.mark.parametrize("step", [0, 7, 8474, 9000, 70000])
def test_batcher_take_matches_jax_past_int32_wrap(step):
    from repro.data.pipeline import Batcher as JBatcher
    from repro_torch.data.pipeline import Batcher

    rng = np.random.default_rng(step)
    n, m = 5, 97
    x = rng.standard_normal((n, m, 3)).astype(np.float32)
    y = rng.integers(0, 10, (n, m)).astype(np.int32)
    counts = np.array([97, 1, 50, 13, 64], np.int32)
    jb, tb = JBatcher(batch_size=32), Batcher(batch_size=32)
    jx, jy = jax.vmap(jb.take, in_axes=(0, 0, 0, None))(
        x, y, counts, jnp.int32(step))
    tx, ty = tb.take(torch.from_numpy(x), torch.from_numpy(y.astype(np.int64)),
                     torch.from_numpy(counts), step)
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))


# ----------------------------------------------------------- model + loss

def test_mlp_forward_matches_jax():
    jm, tm, jp, tp, _ = _mlp_pair(hidden=(64, 32), n=3)
    x = np.random.default_rng(1).standard_normal((3, 7, 28, 28)).astype(
        np.float32)
    jl = jax.vmap(lambda p, xx: jm.apply(p, xx))(jp, x)
    tl = tm.apply(tp, torch.from_numpy(x))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=RTOL,
                               atol=ATOL)
    # one batch shared by every node (evaluation)
    shared = tm.apply(tp, torch.from_numpy(x[0])[None])
    jshared = jax.vmap(lambda p: jm.apply(p, x[0]))(jp)
    np.testing.assert_allclose(shared.numpy(), np.asarray(jshared),
                               rtol=RTOL, atol=ATOL)


def test_mlp_init_shapes_and_bounds():
    from repro_torch.models.mlp_cnn import make_mlp

    m = make_mlp()
    p = m.init(torch.Generator().manual_seed(0))
    sizes = [l.numel() for l in tpytree.tree_leaves(p)]
    assert sum(sizes) == 567434
    assert p["fc0"]["w"].shape == (784, 512)
    assert float(p["fc0"]["w"].abs().max()) <= 1 / 28


@pytest.mark.parametrize("beta", [0.95, 0.9, 1.0])
def test_vt_kl_loss_and_gradient_match_jax(beta):
    from repro.core.virtual_teacher import teacher_entropy as jent
    from repro.core.virtual_teacher import vt_kl_loss as jvt
    from repro_torch.core.virtual_teacher import teacher_entropy, vt_kl_loss

    rng = np.random.default_rng(2)
    z = (3 * rng.standard_normal((16, 10))).astype(np.float32)
    y = rng.integers(0, 10, 16).astype(np.int32)
    jl, jg = jax.value_and_grad(lambda zz: jvt(zz, y, beta=beta))(z)
    tz = torch.from_numpy(z).requires_grad_(True)
    tl = vt_kl_loss(tz, torch.from_numpy(y), beta=beta)
    (tg,) = torch.autograd.grad(tl, tz)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=RTOL,
                               atol=ATOL)
    assert float(teacher_entropy(beta, 10)) == float(jent(beta, 10))
    # node-batched: one loss per node
    zn = torch.from_numpy(z.reshape(2, 8, 10))
    per_node = vt_kl_loss(zn, torch.from_numpy(y.reshape(2, 8)), beta=beta)
    assert per_node.shape == (2,)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_vt_kl_loss_fused_matches_jax(dtype):
    """`kernels.ops.vt_kl_loss_fused` (the reference's name, int32 labels
    accepted) against the reference's Pallas entry point run on the CPU,
    with its gradient; the package exports the reference's names."""
    import repro.kernels as jkernels
    from repro.kernels.ops import vt_kl_loss_fused as jvt

    import repro_torch.kernels as tkernels
    from repro_torch.kernels.ops import vt_kl_loss_fused

    rng = np.random.default_rng(4)
    z = (3 * rng.standard_normal((12, 26))).astype(np.float32)
    y = rng.integers(0, 26, 12).astype(np.int32)
    jz = jnp.asarray(z, dtype)
    jl, jg = jax.value_and_grad(lambda zz: jvt(zz, y, 0.9))(jz)
    tz = torch.from_numpy(z).to(getattr(torch, dtype)).requires_grad_(True)
    tl = vt_kl_loss_fused(tz, torch.from_numpy(y), 0.9)
    (tg,) = torch.autograd.grad(tl, tz)
    assert tl.shape == () and tg.dtype == tz.dtype
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=RTOL,
                               atol=ATOL)
    tol = 1e-6 if dtype == "float32" else 2.0 ** -7
    np.testing.assert_allclose(tg.float().numpy(),
                               np.asarray(jg.astype(jnp.float32)), rtol=tol,
                               atol=tol)
    with pytest.raises(ValueError, match=r"logits \[B, V\]"):
        vt_kl_loss_fused(tz.detach()[None], torch.from_numpy(y)[None])
    for name in ("decdiff_update_tree", "decode_attention_fused",
                 "dequant_neighbor_avg", "dequant_neighbor_avg_rows",
                 "vt_kl_loss_fused"):
        assert hasattr(jkernels, name) and hasattr(tkernels, name), name
    # the port's package keeps its kernel modules under their own names
    # (in the reference's, the function or the module, by import order)
    for name in ("decdiff_update", "gather_rows", "neighbor_avg"):
        assert getattr(tkernels, name).__name__ == \
            f"repro_torch.kernels.{name}"
        assert callable(getattr(tkernels.ops, name))


def _shapes(tree):
    return {k: _shapes(v) if isinstance(v, dict) else tuple(v.shape)
            for k, v in tree.items()}


@pytest.mark.parametrize("arch,fns", [
    ("qwen1.5-0.5b", [("dense", "init_layer")]),
    ("arctic-480b", [("moe", "init_layer_moe")]),
    ("whisper-large-v3", [("encdec", "init_enc_layer"),
                          ("encdec", "init_dec_layer")]),
])
def test_layer_inits_have_the_reference_names_and_shapes(arch, fns):
    """One layer's init under the reference's name: the reference's keys
    and shapes, and stacked over `stack=` the layers the whole model's
    init holds."""
    import importlib

    from repro.configs import get_config as jget
    from repro_torch.configs import get_config
    from repro_torch.models.lm import build_lm

    cfg = get_config(arch).reduced()
    whole = build_lm(cfg).init(torch.Generator().manual_seed(0),
                               device="cpu")
    for module, name in fns:
        jfn = getattr(importlib.import_module(f"repro.models.lm.{module}"),
                      name)
        tfn = getattr(importlib.import_module(
            f"repro_torch.models.lm.{module}"), name)
        jcfg = jget(arch).reduced()
        jshapes = jax.tree.map(lambda a: tuple(a.shape),
                               jfn(jax.random.PRNGKey(0), jcfg))
        one = tfn(torch.Generator().manual_seed(0), cfg, device="cpu")
        assert _shapes(one) == jshapes
        n = cfg.n_enc_layers if name == "init_enc_layer" else cfg.n_layers
        stacked = tfn(torch.Generator().manual_seed(0), cfg, stack=(n,),
                      device="cpu")
        key = {"init_enc_layer": "enc_layers",
               "init_dec_layer": "dec_layers"}.get(name, "layers")
        assert _shapes(stacked) == _shapes(whole[key])


def test_mesh_names_of_the_reference():
    from repro.dist.constraints import current_mesh as jcurrent
    from repro.launch.mesh import HW as JHW
    from repro_torch.dist.constraints import current_mesh
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import HW

    assert current_mesh() is None and jcurrent() is None  # no mesh here
    # the inter-chip rate is the TPU's ICI there, the H100's NVLink here
    assert set(JHW) - {"ici_bw"} | {"link_bw"} == set(HW)
    assert dryrun.HW is HW
    assert HW["hbm_bytes"] == 80e9  # the H100's, not the TPU's


def test_cross_entropy_matches_jax():
    from repro.core.virtual_teacher import cross_entropy_loss as jce
    from repro_torch.core.virtual_teacher import cross_entropy_loss

    rng = np.random.default_rng(3)
    z = rng.standard_normal((9, 10)).astype(np.float32)
    y = rng.integers(0, 10, 9).astype(np.int32)
    np.testing.assert_allclose(
        float(cross_entropy_loss(torch.from_numpy(z), torch.from_numpy(y))),
        float(jce(z, y)), rtol=RTOL, atol=ATOL)


def test_sgd_momentum_update_matches_jax():
    from repro.optim.sgd import sgd_momentum as jsgd
    from repro_torch.optim.sgd import sgd_momentum

    rng = np.random.default_rng(4)
    p = {"a": {"w": rng.standard_normal((3, 5, 4)).astype(np.float32)}}
    g = {"a": {"w": rng.standard_normal((3, 5, 4)).astype(np.float32)}}
    v = {"a": {"w": rng.standard_normal((3, 5, 4)).astype(np.float32)}}
    jo = jsgd(lr=1e-3, momentum=0.9)
    jp, js = jo.update(g, {"momentum": v}, p, jnp.int32(0))
    to = sgd_momentum(lr=1e-3, momentum=0.9)
    tp = convert.params_from_numpy(p, "cpu")
    ts = {"momentum": convert.params_from_numpy(v, "cpu")}
    tp2, ts2 = to.update(convert.params_from_numpy(g, "cpu"), ts, tp)
    assert tp2 is tp  # in place, as documented
    np.testing.assert_allclose(tp["a"]["w"].numpy(), np.asarray(jp["a"]["w"]),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(ts["momentum"]["a"]["w"].numpy(),
                               np.asarray(js["momentum"]["a"]["w"]),
                               rtol=RTOL, atol=ATOL)


def test_eval_fn_matches_jax_and_drops_remainder():
    from repro.fl.trainer import make_eval_fn as jeval
    from repro_torch.fl.trainer import make_eval_fn

    jm, tm, jp, tp, _ = _mlp_pair(hidden=(64, 32), n=3, seed=5)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((70, 28, 28)).astype(np.float32)
    y = rng.integers(0, 10, 70).astype(np.int32)
    jacc, jloss = jax.vmap(jeval(jm, batch_size=32),
                           in_axes=(0, None, None))(jp, x, y)
    tacc, tloss = make_eval_fn(tm, batch_size=32)(
        tp, torch.from_numpy(x), torch.from_numpy(y.astype(np.int64)))
    np.testing.assert_array_equal(tacc.numpy(), np.asarray(jacc))
    np.testing.assert_allclose(tloss.numpy(), np.asarray(jloss), rtol=RTOL,
                               atol=ATOL)


def test_train_step_matches_jax():
    from repro.core.virtual_teacher import make_loss_fn as jloss
    from repro.fl.trainer import make_train_step as jstep
    from repro.optim.sgd import sgd_momentum as jsgd
    from repro_torch.core.virtual_teacher import make_loss_fn
    from repro_torch.fl.trainer import make_train_step
    from repro_torch.optim.sgd import sgd_momentum

    jm, tm, jp, tp, _ = _mlp_pair(hidden=(64, 32), n=3, seed=6)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((3, 8, 28, 28)).astype(np.float32)
    y = rng.integers(0, 10, (3, 8)).astype(np.int32)
    jo = jsgd(lr=1e-3, momentum=0.9)
    js = jax.vmap(jstep(jm, jo, jloss("vt")),
                  in_axes=(0, 0, 0, 0, None, 0))
    jp2, _, jl = js(jp, jax.vmap(jo.init)(jp), x, y, jnp.int32(0),
                    jax.random.split(jax.random.PRNGKey(0), 3))
    to = sgd_momentum(lr=1e-3, momentum=0.9)
    tp2, _, tl = make_train_step(tm, to, make_loss_fn("vt"))(
        tp, to.init(tp), torch.from_numpy(x),
        torch.from_numpy(y.astype(np.int64)))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=RTOL,
                               atol=ATOL)
    for a, b in zip(tpytree.tree_leaves(tp2), jax.tree.leaves(jp2)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL,
                                   atol=ATOL)


# ----------------------------------------------------------- aggregation

def _neighborhoods(seed=7, n=6, k=4, hidden=(16, 8)):
    """The same table, neighbour ids and weights in both packages, with
    masked slots and one receiver (row 2) whose delivered total is 0."""
    from repro.engine.neighborhood import DenseNeighborhood as JNb
    from repro.utils.pytree import tree_flatten_stacked as jflat
    from repro_torch.engine.neighborhood import DenseNeighborhood as TNb

    _, _, jp, tp, _ = _mlp_pair(hidden=hidden, n=n, seed=seed)
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, n, (n, k)).astype(np.int32)
    w = rng.uniform(1, 40, (n, k)).astype(np.float32)
    w[rng.random((n, k)) < 0.3] = 0.0
    w[2] = 0.0
    jmat, junflat = jflat(jp)
    tmat, tunflat = tpytree.tree_flatten_stacked(tp)
    jnb = JNb(jmat, jnp.asarray(idx), jnp.asarray(w), jmat, junflat)
    tnb = TNb(tmat, torch.from_numpy(idx.astype(np.int64)),
              torch.from_numpy(w), tmat, tunflat)
    counts = rng.integers(5, 50, n).astype(np.float32)
    return jnb, tnb, counts, jmat


@pytest.mark.parametrize("method", ["decdiff", "decavg", "cfa"])
def test_flat_aggregate_matches_jax(method):
    from repro.engine.strategies import get_method as jget
    from repro_torch.engine.strategies import get_method

    jnb, tnb, counts, jmat = _neighborhoods()
    exp = types.SimpleNamespace(train=types.SimpleNamespace(s=1.0))
    jout = jget(method).strategy.flat_aggregate(
        exp, {"counts": jnp.asarray(counts)}, jnb)
    tout = get_method(method).strategy.flat_aggregate(
        exp, {"counts": torch.from_numpy(counts)}, tnb)
    for a, b in zip(tpytree.tree_leaves(tout), jax.tree.leaves(jout)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL,
                                   atol=ATOL)
    if method != "decavg":  # a receiver with tot = 0 keeps its model
        flat, _ = tpytree.tree_flatten_stacked(tout)
        np.testing.assert_array_equal(flat[2].numpy(), np.asarray(jmat[2]))


def test_neighborhood_primitives_match_jax():
    jnb, tnb, _, _ = _neighborhoods(seed=8)
    for jf, tf in [(jnb.reduce(), tnb.reduce()),
                   (jnb.reduce_delta(), tnb.reduce_delta())]:
        for a, b in zip(tf, jf):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL,
                                       atol=ATOL)
    np.testing.assert_array_equal(tnb.n_active().numpy(),
                                  np.asarray(jnb.n_active()))


def test_registry_mirrors_jax_roster():
    from repro.engine.strategies import available_methods as javail
    from repro_torch.engine.strategies import available_methods

    assert available_methods() == javail()


# ----------------------------------------------------------- independence

def test_port_imports_neither_jax_nor_repro():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'repro', 'ml_dtypes'))\n"
        "assert not bad, bad\n"
        "for m in ('repro_torch.comm.codecs', 'repro_torch.comm.trigger', "
        "'repro_torch.comm.transport', 'repro_torch.kernels.gather_rows', "
        "'repro_torch.kernels.dequant_avg', 'repro_torch.kernels.vt_kl_loss', "
        "'repro_torch.models.lm.dense', 'repro_torch.dist.dfl_step', "
        "'repro_torch.launch.train', 'repro_torch.configs.qwen1_5_0_5b', "
        "'repro_torch.data.tokens', 'repro_torch.kernels.decode_attention', "
        "'repro_torch.kernels.decdiff_update', 'repro_torch.launch.serve', "
        "'repro_torch.kernels.neighbor_avg', 'repro_torch.kernels.ref', "
        "'repro_torch.core.decdiff', 'repro_torch.core.aggregation', "
        "'repro_torch.models.mlp_cnn', 'repro_torch.models.api', "
        "'repro_torch.optim.sgd', 'repro_torch.fl.metrics', "
        "'repro_torch.fl.trainer', 'repro_torch.data.pipeline', "
        "'repro_torch.dynamics.processes', 'repro_torch.timing.models', "
        "'repro_torch.obs.channels', 'repro_torch.obs.ledger', "
        "'repro_torch.obs.trace', 'repro_torch.dist.sharding', "
        "'repro_torch.graphs.partition', 'repro_torch.launch.mesh', "
        "'repro_torch.checkpoint.ckpt', 'repro_torch.launch.dryrun'):\n"
        "    assert m in sys.modules, m\n"
        "import torch.distributed as dist\n"
        "assert not dist.is_initialized()  # no import starts a group\n"
        "import importlib.util\n"
        "for f in sorted(os.listdir(EXAMPLES)):\n"
        "    spec = importlib.util.spec_from_file_location(\n"
        "        'examples_torch_' + f[:-3], os.path.join(EXAMPLES, f))\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'repro', 'ml_dtypes', 'benchmarks'))\n"
        "assert not bad, bad  # the examples import none of them either\n"
        "assert not dist.is_initialized()\n"
        "print('ok', len([k for k in sys.modules "
        "if k.startswith('repro_torch')]), len(os.listdir(EXAMPLES)))\n")
    examples = os.path.abspath(EXAMPLES)
    assert sorted(os.listdir(examples)) == [
        "compressed_gossip.py", "decentralized_mnist.py",
        "multipod_dfl_train.py", "quickstart.py", "serve_decode.py"]
    # the repository root on the path too: a `benchmarks` import would
    # resolve there and be caught
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.abspath(SRC), os.path.abspath(os.path.join(SRC, ".."))]))
    out = subprocess.run([sys.executable, "-c",
                          f"import os\nEXAMPLES = {examples!r}\n" + code],
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")
    assert int(out.stdout.split()[1]) >= 75  # every submodule imported
    assert int(out.stdout.split()[2]) == 5  # and every example


# ---------------------------------------------------------- public names

# Top-level public names of `src/repro` with no counterpart of the same
# name in the port's mirrored module, each with its reason.  Any other
# missing name fails the test below.
NOT_PORTED = {
    # the Pallas kernel bodies and their TPU tile constants: the port's
    # kernels are the CUDA sources in src/repro_torch/csrc/, behind ops.py
    "kernels/decdiff_update.py": {"BLOCK_ROWS", "LANES", "scaled_step_blocks",
                                  "sumsq_diff_blocks"},
    "kernels/decode_attention.py": {"B_BLK", "W_BLK",
                                    "decode_attention_blocks"},
    "kernels/dequant_avg.py": {"COLS", "dequant_avg_blocks",
                               "dequant_avg_rows_blocks"},
    "kernels/gather_rows.py": {"COLS", "gather_rows_blocks"},
    "kernels/neighbor_avg.py": {"COLS", "neighbor_avg_blocks"},
    "kernels/segment_avg.py": {"COLS", "ROWS", "dequant_segment_avg_chunk",
                               "segment_avg_chunk"},
    "kernels/vt_kl_loss.py": {"NEG", "ROWS", "VCOLS", "row_max", "row_stats",
                              "vt_backward"},
    # functions the reference's package binds over its kernel modules of
    # the same names; the port keeps the modules there (`ops.<name>`)
    "kernels/__init__.py": {"decdiff_update", "gather_rows", "neighbor_avg"},
    # NamedShardings for jit; the port places specs with `placements` /
    # `distribute_tree` on a DeviceMesh (ROADMAP A.11.3)
    "dist/sharding.py": {"named"},
    # XLA cost-analysis calibration; the port's dry run counts every layer
    # at dispatch (ROADMAP A.11.4)
    "launch/dryrun.py": {"calibrated_metrics", "lower_combo"},
}
# modules of `src/repro` with no counterpart file, each with its reason
NOT_PORTED_MODULES = {
    # parses XLA's post-SPMD HLO text, which the port never produces
    # (ROADMAP A.11.4)
    "launch/hlo_analysis.py",
}


def _public_names(path):
    """Top-level public names of a module: functions, classes and
    assigned names, and in a package's `__init__` the imported ones."""
    import ast

    tree = ast.parse(open(path).read())
    names = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets
                         if isinstance(t, ast.Name))
        elif isinstance(node, ast.AnnAssign) and \
                isinstance(node.target, ast.Name):
            names.add(node.target.id)
        elif isinstance(node, ast.ImportFrom) and \
                os.path.basename(path) == "__init__.py":
            names.update(a.asname or a.name for a in node.names)
    return {n for n in names if not n.startswith("_")}


def test_public_names_are_mirrored():
    """Every public top-level name of every `src/repro` module exists in
    the port's module of the same path, or is listed in NOT_PORTED with
    its reason; the lists hold nothing the port has since gained."""
    ref_root = os.path.join(SRC, "repro")
    port_root = os.path.join(SRC, "repro_torch")
    missing, missing_modules = {}, set()
    for dirpath, _, files in os.walk(ref_root):
        for f in files:
            if not f.endswith(".py"):
                continue
            rel = os.path.relpath(os.path.join(dirpath, f), ref_root)
            rel = rel.replace(os.sep, "/")
            port = os.path.join(port_root, rel)
            if not os.path.exists(port):
                missing_modules.add(rel)
                continue
            gap = _public_names(os.path.join(dirpath, f)) \
                - _public_names(port)
            if gap:
                missing[rel] = gap
    assert missing_modules == NOT_PORTED_MODULES
    assert missing == NOT_PORTED
