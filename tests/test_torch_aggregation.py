"""The port's Eq. 6 average, `core/decdiff.py`, `core/aggregation.py`, the
strategies' padded-gather forms and `kernels/ref.py` against the JAX
package, on the CPU.

Inputs are made with numpy from fixed seeds and handed to both packages.
The port's `ops.neighbor_avg` takes its kernel's plain version here (the
tensors lie on the CPU) and is held against the reference's
`repro.kernels.ops.neighbor_avg`, which runs its Pallas kernel in
interpret mode on the CPU, and against both packages' `neighbor_avg_ref`.

Tolerances: a reordered fp32 sum errs in proportion to its terms, so the
average is held per column to 1e-6 + 1e-5·Σ_n|w_n·x_nd| (w normalized);
the aggregators, which add a norm, a scale or an update on top, to 1e-6
absolute plus 1e-5 relative.
"""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp

from repro_torch import convert
from repro_torch.kernels import ops
from repro_torch.utils import pytree as tpytree

RTOL, ATOL = 1e-5, 1e-6


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def _close_trees(tgot, jwant):
    tl, jl = tpytree.tree_leaves(tgot), jax.tree.leaves(jwant)
    assert len(tl) == len(jl)
    for a, b in zip(tl, jl):
        assert tuple(a.shape) == tuple(b.shape)
        _close(a.detach().numpy(), b)


def _avg_tol(x, w):
    wn = w / w.sum(dtype=np.float32)
    return 1e-6 + 1e-5 * np.abs(wn[:, None] * x).sum(0)


# ----------------------------------------------------------- the kernel

@pytest.mark.parametrize("n", [1, 3, 16])
@pytest.mark.parametrize("d", [7, 2048, 5000])
def test_neighbor_avg_matches_jax_kernel_and_refs(n, d):
    from repro.kernels import ops as jops
    from repro.kernels.ref import neighbor_avg_ref as jref
    from repro_torch.kernels.ref import neighbor_avg_ref

    rng = np.random.default_rng([n, d])
    x = rng.standard_normal((n, d)).astype(np.float32)
    w = rng.uniform(0.1, 40.0, n).astype(np.float32)
    before = dict(ops.LAUNCHES)
    got = ops.neighbor_avg(torch.from_numpy(x), torch.from_numpy(w)).numpy()
    assert ops.LAUNCHES == before  # the plain version launches nothing
    assert got.shape == (d,) and got.dtype == np.float32
    tol = _avg_tol(x, w)
    for want in (np.asarray(jops.neighbor_avg(jnp.asarray(x), jnp.asarray(w))),
                 np.asarray(jref(jnp.asarray(x), jnp.asarray(w))),
                 neighbor_avg_ref(torch.from_numpy(x),
                                  torch.from_numpy(w)).numpy()):
        assert want.shape == (d,)
        assert (np.abs(got - want) <= tol).all(), np.abs(got - want).max()


@pytest.mark.parametrize("n,d,zero", [(1100, 96, True), (16, 567, False),
                                      (10, 1001, True), (2, 2048, False)])
def test_neighbor_avg_normalizes_in_n_order_like_jax(n, d, zero):
    """`ops.neighbor_avg` hands the raw weights to the kernel's plain
    version, which sums them in n order from +0 and divides in IEEE (as the
    kernel does on the card, so the two stay bitwise equal): within the
    tolerance above of the reference's `w / jnp.sum(w)` and its Pallas
    kernel (interpreted), also past one 1024-sender chunk and with a zero
    weight; and bitwise the plain loop over those normalized weights."""
    from repro.kernels import ops as jops
    from repro_torch.kernels.neighbor_avg import neighbor_avg_plain

    rng = np.random.default_rng([n, d, 7])
    x = rng.standard_normal((n, d)).astype(np.float32)
    w = rng.uniform(0.1, 40.0, n).astype(np.float32)
    if zero:
        w[n // 2] = 0.0
    total = np.float32(0.0)
    for wi in w:  # the ordered sum, in float32
        total = np.float32(total + wi)
    got = ops.neighbor_avg(torch.from_numpy(x), torch.from_numpy(w))
    wn = torch.from_numpy(w) / torch.tensor(total)
    assert torch.equal(got, neighbor_avg_plain(torch.from_numpy(x), wn))
    assert torch.equal(got, ops.neighbor_avg_normalized(torch.from_numpy(x),
                                                        wn))
    want = np.asarray(jops.neighbor_avg(jnp.asarray(x), jnp.asarray(w)))
    assert (np.abs(got.numpy() - want) <= _avg_tol(x, w)).all(), \
        np.abs(got.numpy() - want).max()


def test_neighbor_avg_zero_total_is_the_reference_division():
    """Weights that sum to 0 give w / 0, as the reference's w / sum(w)
    does: NaN (0 / 0) where the reference has NaN."""
    from repro.kernels import ops as jops

    x = np.random.default_rng(5).standard_normal((3, 2048)).astype(
        np.float32)
    w = np.zeros(3, np.float32)
    got = ops.neighbor_avg(torch.from_numpy(x), torch.from_numpy(w)).numpy()
    want = np.asarray(jops.neighbor_avg(jnp.asarray(x), jnp.asarray(w)))
    assert np.isnan(want).all() and np.isnan(got).all()


def test_neighbor_avg_normalized_zero_weights_and_validation():
    x = torch.randn(4, 9)
    assert torch.equal(ops.neighbor_avg_normalized(x, torch.zeros(4)),
                       torch.zeros(9))
    wn = torch.tensor([0.5, 0.0, 0.25, 0.25])
    # the plain version's own order: +0, then w0·x0, w1·x1, ...
    want = torch.zeros(9)
    for i in range(4):
        want = want + wn[i] * x[i]
    assert torch.equal(ops.neighbor_avg_normalized(x, wn), want)
    with pytest.raises(ValueError, match=r"\[N, D\]"):
        ops.neighbor_avg(x, torch.ones(3))
    with pytest.raises(TypeError, match="float32"):
        ops.neighbor_avg_normalized(x.double(), torch.ones(4,
                                                           dtype=torch.float64))
    with pytest.raises(ValueError, match="contiguous"):
        ops.neighbor_avg_normalized(torch.randn(9, 4).t(), torch.ones(4))
    assert ops.neighbor_avg(torch.zeros(0, 5), torch.zeros(0)).shape == (5,)


def test_port_refs_match_jax_refs():
    from repro.kernels import ref as jref
    from repro_torch.kernels import ref as tref

    rng = np.random.default_rng(3)
    w = rng.standard_normal(300).astype(np.float32)
    wb = rng.standard_normal(300).astype(np.float32)
    _close(tref.decdiff_update_ref(torch.from_numpy(w), torch.from_numpy(wb),
                                   1.5).numpy(),
           jref.decdiff_update_ref(jnp.asarray(w), jnp.asarray(wb), 1.5))
    z = (3 * rng.standard_normal((12, 10))).astype(np.float32)
    y = rng.integers(0, 10, 12)
    _close(tref.vt_kl_loss_ref(torch.from_numpy(z), torch.from_numpy(y),
                               0.9).numpy(),
           jref.vt_kl_loss_ref(jnp.asarray(z), jnp.asarray(y), 0.9))
    _close(tref.vt_kl_grad_ref(torch.from_numpy(z), torch.from_numpy(y),
                               0.9).numpy(),
           jref.vt_kl_grad_ref(jnp.asarray(z), jnp.asarray(y), 0.9))
    q = rng.standard_normal((2, 8, 16)).astype(np.float32)
    k = rng.standard_normal((2, 11, 4, 16)).astype(np.float32)
    v = rng.standard_normal((2, 11, 4, 16)).astype(np.float32)
    sp = np.arange(11, dtype=np.int32)
    sp[9:] = -1
    _close(tref.decode_attention_ref(*map(torch.from_numpy, (q, k, v, sp)),
                                     6).numpy(),
           jref.decode_attention_ref(*map(jnp.asarray, (q, k, v, sp)), 6))
    x = rng.standard_normal((5, 33)).astype(np.float32)
    wn = rng.uniform(0.1, 2.0, 5).astype(np.float32)
    _close(tref.neighbor_avg_ref(torch.from_numpy(x),
                                 torch.from_numpy(wn)).numpy(),
           jref.neighbor_avg_ref(jnp.asarray(x), jnp.asarray(wn)))
    qi = rng.integers(-127, 128, (5, 33)).astype(np.int8)
    sc = rng.uniform(0.01, 0.1, 5).astype(np.float32)
    _close(tref.dequant_neighbor_avg_ref(*map(torch.from_numpy,
                                              (qi, sc, wn))).numpy(),
           jref.dequant_neighbor_avg_ref(*map(jnp.asarray, (qi, sc, wn))))
    wr = rng.uniform(0.0, 1.0, (3, 5)).astype(np.float32)
    _close(tref.dequant_neighbor_avg_rows_ref(*map(torch.from_numpy,
                                                   (qi, sc, wr))).numpy(),
           jref.dequant_neighbor_avg_rows_ref(*map(jnp.asarray,
                                                   (qi, sc, wr))))


# ----------------------------------------------------------- MLP trees

def _trees(k=5, seed=0, hidden=(16, 8)):
    """A local MLP model and k neighbour models (JAX-initialized), as numpy,
    JAX and port trees: (local, stacked [k, ...]) for each."""
    from repro.models.mlp_cnn import make_mlp as jmlp

    jm = jmlp(hidden=hidden)
    keys = jax.random.split(jax.random.PRNGKey(seed), k + 1)
    stacked = jax.tree.map(np.asarray, jax.vmap(jm.init)(keys))
    local = jax.tree.map(lambda a: a[0], stacked)
    nbrs = jax.tree.map(lambda a: a[1:], stacked)
    return ((jax.tree.map(jnp.asarray, local), jax.tree.map(jnp.asarray, nbrs)),
            (convert.params_from_numpy(local, "cpu"),
             convert.params_from_numpy(nbrs, "cpu")))


def _weights(k=5, seed=0):
    rng = np.random.default_rng(seed)
    w = rng.uniform(1.0, 40.0, k).astype(np.float32)
    mask = (rng.random(k) < 0.6).astype(np.float32)
    mask[0] = 1.0
    mask[-1] = 0.0
    return w, mask


MASKS = {"none": lambda m: None, "masked": lambda m: m,
         "all-zero": lambda m: np.zeros_like(m)}


@pytest.mark.parametrize("mask_kind", list(MASKS))
def test_decdiff_aggregate_stacked_matches_jax(mask_kind):
    from repro.core.decdiff import decdiff_aggregate_stacked as jagg
    from repro_torch.core.decdiff import decdiff_aggregate_stacked

    (jl, jn), (tl, tn) = _trees()
    w, m = _weights()
    mask = MASKS[mask_kind](m)
    jout = jagg(jl, jn, jnp.asarray(w), mask=None if mask is None
                else jnp.asarray(mask), s=1.3)
    tout = decdiff_aggregate_stacked(tl, tn, torch.from_numpy(w),
                                     mask=None if mask is None
                                     else torch.from_numpy(mask), s=1.3)
    _close_trees(tout, jout)
    if mask_kind == "all-zero":  # heard from nobody: the local model
        for a, b in zip(tpytree.tree_leaves(tout), tpytree.tree_leaves(tl)):
            assert torch.equal(a, b)


def test_neighborhood_average_step_and_aggregate_match_jax():
    from repro.core import decdiff as jd
    from repro_torch.core import decdiff as td

    (jl, jn), (tl, tn) = _trees(k=4, seed=1)
    w, _ = _weights(k=4, seed=1)
    jlist = [jax.tree.map(lambda a, i=i: a[i], jn) for i in range(4)]
    tlist = [tpytree.tree_map(lambda a, i=i: a[i], tn) for i in range(4)]
    javg = jd.neighborhood_average(jlist, jnp.asarray(w))
    tavg = td.neighborhood_average(tlist, w)
    _close_trees(tavg, javg)
    _close_trees(td.decdiff_step(tl, tavg, s=2.0),
                 jd.decdiff_step(jl, javg, s=2.0))
    _close_trees(td.decdiff_aggregate(tl, tlist, w),
                 jd.decdiff_aggregate(jl, jlist, jnp.asarray(w)))
    assert td.decdiff_aggregate(tl, [], []) is tl
    assert td.DEFAULT_S == jd.DEFAULT_S


@pytest.mark.parametrize("case", ["default", "self-weight", "masked",
                                  "self-weight-all-zero"])
def test_decavg_aggregate_matches_jax(case):
    from repro.core.aggregation import decavg_aggregate as jagg
    from repro_torch.core.aggregation import decavg_aggregate

    (jl, jn), (tl, tn) = _trees(seed=2)
    w, m = _weights(seed=2)
    mask = {"default": None, "self-weight": None, "masked": m,
            "self-weight-all-zero": np.zeros_like(m)}[case]
    sw = 17.0 if case.startswith("self-weight") else None
    jout = jagg(jl, jn, jnp.asarray(w), mask=mask, self_weight=sw)
    tout = decavg_aggregate(tl, tn, torch.from_numpy(w), mask=mask,
                            self_weight=sw)
    _close_trees(tout, jout)
    if case == "self-weight-all-zero":
        _close_trees(tout, jl)


@pytest.mark.parametrize("case", ["default", "eps", "masked", "all-zero"])
def test_cfa_aggregate_matches_jax(case):
    from repro.core.aggregation import cfa_aggregate as jagg
    from repro_torch.core.aggregation import cfa_aggregate

    (jl, jn), (tl, tn) = _trees(seed=3)
    w, m = _weights(seed=3)
    mask = {"default": None, "eps": m, "masked": m,
            "all-zero": np.zeros_like(m)}[case]
    eps = 0.3 if case == "eps" else None
    jout = jagg(jl, jn, jnp.asarray(w), mask=mask, eps=eps)
    tout = cfa_aggregate(tl, tn, torch.from_numpy(w), mask=mask, eps=eps)
    _close_trees(tout, jout)
    if case == "all-zero":
        for a, b in zip(tpytree.tree_leaves(tout), tpytree.tree_leaves(tl)):
            assert torch.equal(a, b)


@pytest.mark.parametrize("mask_kind", list(MASKS))
def test_cfa_ge_gradient_step_matches_jax(mask_kind):
    from repro.core.aggregation import cfa_ge_gradient_step as jstep
    from repro_torch.core.aggregation import cfa_ge_gradient_step

    (jl, jg), (tl, tg) = _trees(seed=4)
    w, m = _weights(seed=4)
    mask = MASKS[mask_kind](m)
    jout = jstep(jl, jg, jnp.asarray(w), mask=mask, lr=0.05)
    tout = cfa_ge_gradient_step(tl, tg, torch.from_numpy(w), mask=mask,
                                lr=0.05)
    _close_trees(tout, jout)


def test_fedavg_and_isolation_match_jax():
    from repro.core.aggregation import fedavg_aggregate as jfed
    from repro.core.aggregation import isolation_aggregate as jiso
    from repro_torch.core.aggregation import (fedavg_aggregate,
                                              isolation_aggregate)

    (jl, jn), (tl, tn) = _trees(k=16, seed=5)
    counts = np.random.default_rng(5).integers(3, 90, 16).astype(np.float32)
    tavg = fedavg_aggregate(tn, torch.from_numpy(counts))
    _close_trees(tavg, jfed(jn, jnp.asarray(counts)))
    assert tavg["fc0"]["w"].shape == tl["fc0"]["w"].shape
    assert isolation_aggregate(tl, tn, counts) is tl
    _close_trees(isolation_aggregate(tl, tn, counts), jiso(jl, jn, counts))


def test_aggregator_registry_mirrors_jax():
    from repro.core import aggregation as ja
    from repro_torch import core
    from repro_torch.core import aggregation as ta

    assert sorted(ta.AGGREGATORS) == sorted(ja.AGGREGATORS)
    assert ta.get_aggregator("cfa") is ta.cfa_aggregate
    assert core.get_aggregator("decdiff") is core.decdiff_aggregate_stacked
    for mod in (ja, ta):
        with pytest.raises(ValueError) as ei:
            mod.get_aggregator("nope")
        assert str(ei.value) == ("unknown aggregator 'nope'; available: "
                                 "['cfa', 'decavg', 'decdiff', 'none']")


# ------------------------------------------- the strategies' padded forms

def _padded_inputs(seed=7, n=6, k=4, hidden=(16, 8)):
    """The same params, gathered slots, weights and mask in both packages,
    with masked slots and one receiver (row 2) that heard from nobody."""
    from repro.models.mlp_cnn import make_mlp as jmlp

    jm = jmlp(hidden=hidden)
    jp = jax.vmap(jm.init)(jax.random.split(jax.random.PRNGKey(seed), n))
    npp = jax.tree.map(np.asarray, jp)
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, n, (n, k))
    w = rng.uniform(1, 40, (n, k)).astype(np.float32)
    mask = (rng.random((n, k)) < 0.7).astype(np.float32)
    mask[2] = 0.0
    counts = rng.integers(5, 50, n).astype(np.float32)
    tp = convert.params_from_numpy(npp, "cpu")
    tidx = torch.from_numpy(idx)
    return (jp, jax.tree.map(lambda a: a[idx], jp), w, mask, counts,
            tp, tpytree.tree_map(lambda a: a[tidx], tp), tidx)


@pytest.mark.parametrize("method", ["decdiff", "decavg", "cfa", "isol"])
def test_padded_gather_forms_match_jax(method):
    from repro.engine.strategies import get_method as jget
    from repro_torch.engine.strategies import get_method

    jp, jg, w, mask, counts, tp, tg, _ = _padded_inputs()
    exp = types.SimpleNamespace(train=types.SimpleNamespace(s=1.0))
    jout = jget(method).strategy.aggregate(
        exp, {"counts": jnp.asarray(counts), "weights": jnp.asarray(w)}, jp,
        jg, jnp.asarray(mask))
    tstate = {"counts": torch.from_numpy(counts),
              "weights": torch.from_numpy(w)}
    tout = get_method(method).strategy.aggregate(exp, tstate, tp, tg,
                                                 torch.from_numpy(mask))
    _close_trees(tout, jout)
    if method in ("decdiff", "cfa", "isol"):  # row 2 keeps its model
        for a, b in zip(tpytree.tree_leaves(tout), tpytree.tree_leaves(tp)):
            assert torch.equal(a[2], b[2])


@pytest.mark.parametrize("method", ["decdiff", "decavg", "cfa"])
def test_padded_gather_forms_match_flat_forms(method):
    """Inside the port the two forms compute the same update (normalize
    then contract, or contract then normalize) within fp32 rounding."""
    from repro_torch.engine.neighborhood import DenseNeighborhood
    from repro_torch.engine.strategies import get_method

    _, _, w, mask, counts, tp, tg, idx = _padded_inputs(seed=8)
    exp = types.SimpleNamespace(train=types.SimpleNamespace(s=1.0))
    state = {"counts": torch.from_numpy(counts),
             "weights": torch.from_numpy(w)}
    strat = get_method(method).strategy
    padded = strat.aggregate(exp, state, tp, tg, torch.from_numpy(mask))
    mat, unflatten = tpytree.tree_flatten_stacked(tp)
    nb = DenseNeighborhood(mat, idx, torch.from_numpy(w * mask), mat,
                           unflatten)
    flat = strat.flat_aggregate(exp, state, nb)
    for a, b in zip(tpytree.tree_leaves(padded), tpytree.tree_leaves(flat)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.parametrize("alive", [False, True])
def test_fedavg_strategy_matches_jax_and_copies_every_row(alive):
    from repro.engine.strategies import get_method as jget
    from repro_torch.engine.strategies import get_method

    jp, _, _, _, counts, tp, _, _ = _padded_inputs(seed=9)
    live = np.array([1, 1, 0, 1, 1, 0], np.float32) if alive else None
    jout = jget("fedavg").strategy.aggregate(
        None, {"counts": jnp.asarray(counts)}, jp, jp,
        None if live is None else jnp.asarray(live))
    tout = get_method("fedavg").strategy.aggregate(
        None, {"counts": torch.from_numpy(counts)}, tp, tp,
        None if live is None else torch.from_numpy(live))
    _close_trees(tout, jout)
    for t in tpytree.tree_leaves(tout):
        assert t.stride()[0] != 0 and t.is_contiguous()
        assert all(torch.equal(t[0], t[i]) for i in range(1, t.shape[0]))
        t[0].add_(1.0)  # one row's storage is not another's
        assert not torch.equal(t[0], t[1])
