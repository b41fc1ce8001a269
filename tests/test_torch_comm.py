"""The port's gossip transport (`repro_torch.comm`) against the JAX
package's `repro.comm`, on the CPU.

Inputs are made with numpy from fixed seeds and handed to both packages.
Tolerances:
  * codecs: fp32, bf16 and deterministic int8 (`q`, `scale`, the decoded
    vector and the error-feedback residual) are exact — the same float32
    operations in the same order; top-k is exact on inputs whose magnitudes
    are distinct (`torch.topk` and `lax.top_k` may break ties
    differently); `payload_bytes_for` is an integer and must be equal;
  * trigger functions: gates and delivery masks exact, drifts, thresholds
    and EMAs within rtol 1e-6 (an L2 norm is a reduction that XLA and
    PyTorch may order differently);
  * transports: the reverse-slot map and edge ids exact; one exchange with
    a failing link gives the same gates, masks, reconstructions, residuals
    and references exactly (the drift only gates; the codec arithmetic is
    the same), and thresholds and EMAs within 1e-6 of the largest value of
    their panel (they come from the drift, and the adaptive step
    thr + rate·ema·(gate - target) can cancel).
Stochastic int8 rounding cannot match JAX's random stream, so it is held
to its contract (unbiased, error feedback closes) in distribution.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp

from repro import comm as jcomm
from repro_torch import comm as tcomm
from repro_torch.utils.pytree import tree_flatten_stacked

RTOL = 1e-6


def _np(x):
    return np.asarray(x)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _vecs(shape, seed=0, scale=1.0):
    rng = np.random.default_rng([seed, *shape])
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _jax_encode(codec, x, residual=None):
    """The reference encode vmapped over every leading axis of x."""
    fn = (lambda v: codec.encode(v)) if residual is None else (
        lambda v, r: codec.encode(v, residual=r))
    for _ in range(x.ndim - 1):
        fn = jax.vmap(fn)
    args = (jnp.asarray(x),) if residual is None else (
        jnp.asarray(x), jnp.asarray(residual))
    return fn(*args)


def _jax_decode(codec, payload, d, lead):
    fn = lambda p: codec.decode(p, out_size=d)  # noqa: E731
    for _ in range(lead):
        fn = jax.vmap(fn)
    return fn(payload)


# ---------------------------------------------------------------- codecs

CODEC_CASES = [
    ("fp32", {}), ("bf16", {}), ("int8", {"stochastic": False}),
    ("topk", {"ratio": 0.05}), ("topk", {"ratio": 0.05, "momentum": 0.5}),
]
CODEC_IDS = ["fp32", "bf16", "int8-det", "topk", "topk-momentum"]


@pytest.mark.parametrize("with_residual", [False, True],
                         ids=["no-res", "res"])
@pytest.mark.parametrize("name,kw", CODEC_CASES, ids=CODEC_IDS)
def test_codec_matches_reference(name, kw, with_residual):
    jc, tc = jcomm.make_codec(name, **kw), tcomm.make_codec(name, **kw)
    x = _vecs((3, 4, 257), seed=1, scale=0.3)
    res = None
    if with_residual and tc.has_residual:
        res = _np(_vecs(tuple(tc.init_residual(_t(x)).shape), seed=2,
                        scale=0.05))
        if tc.name == "topk" and tc.momentum > 0:
            res[..., 1, :] = np.abs(res[..., 1, :])  # scores are >= 0
    jp, jres = _jax_encode(jc, x, res)
    tp, tres = tc.encode(_t(x), residual=None if res is None else _t(res))
    assert sorted(tp) == sorted(jp)
    for key in jp:
        assert tp[key].dtype == getattr(torch, str(_np(jp[key]).dtype)) or (
            key == "w" and name == "bf16" and tp[key].dtype == torch.bfloat16)
        np.testing.assert_array_equal(tp[key].float().numpy(),
                                      _np(jp[key]).astype(np.float32))
    np.testing.assert_array_equal(
        tc.decode(tp, out_size=257).numpy(),
        _np(_jax_decode(jc, jp, 257, lead=2)))
    if res is None or not tc.has_residual:
        assert (tres is None) == (jres is None)
    else:
        np.testing.assert_array_equal(tres.numpy(), _np(jres))
    assert tc.bytes_on_wire(tp) == jc.bytes_on_wire(jp)


@pytest.mark.parametrize("size", [1, 7, 100, 4096, 52654, 567434])
@pytest.mark.parametrize("name,kw", CODEC_CASES + [("topk", {"ratio": 0.01})],
                         ids=CODEC_IDS + ["topk-1pct"])
def test_payload_bytes_for_equals_reference(name, kw, size):
    tb = tcomm.make_codec(name, **kw).payload_bytes_for(size)
    jb = jcomm.make_codec(name, **kw).payload_bytes_for(size)
    assert isinstance(tb, int) and tb == jb
    want = {"fp32": 4 * size, "bf16": 2 * size, "int8": size + 4}.get(
        name, 8 * max(1, round(kw.get("ratio", 0.01) * size)) + 4)
    assert tb == want


@pytest.mark.parametrize("name,kw", CODEC_CASES, ids=CODEC_IDS)
def test_payload_nbytes_is_the_serialized_length(name, kw):
    codec = tcomm.make_codec(name, **kw)
    payload, _ = codec.encode(_t(_vecs((321,), seed=3)))
    serialized = b"".join(t.reshape(-1).view(torch.uint8).numpy().tobytes()
                          for t in payload.values())
    assert len(serialized) == tcomm.payload_nbytes(payload) \
        == codec.payload_bytes_for(321)


def test_int8_deterministic_rounds_half_up():
    """stochastic=False is floor(y + 0.5), as the reference."""
    codec = tcomm.make_codec("int8", stochastic=False)
    v = torch.tensor([127.0, 0.5, -0.5, 1.5, -1.5, 2.49])
    p, _ = codec.encode(v)
    assert p["scale"].item() == 1.0
    assert p["q"].tolist() == [127, 1, 0, 2, -1, 2]


def test_int8_stochastic_rounding_unbiased_and_error_feedback_exact():
    """E[decode(encode(x))] == x, drawn from an explicit generator; the
    residual carries the rest: residual' + decode == x + residual to float32
    rounding."""
    codec = tcomm.make_codec("int8", stochastic=True)
    v = _t(_vecs((256,), seed=7))
    batch = v.expand(512, 256).contiguous()
    gen = torch.Generator().manual_seed(0)
    p, _ = codec.encode(batch, rng=gen)
    mean = codec.decode(p).mean(dim=0)
    grain = float(v.abs().max()) / 127.0
    assert float((mean - v).abs().max()) < 0.2 * grain
    # the draws differ per row (one uniform row per vector)
    assert not torch.equal(p["q"][0], p["q"][1])
    # the same seed gives the same draws; the global RNG is untouched
    state = torch.random.get_rng_state()
    p2, _ = codec.encode(batch, rng=torch.Generator().manual_seed(0))
    assert torch.equal(p2["q"], p["q"])
    assert torch.equal(torch.random.get_rng_state(), state)
    res = _t(_vecs((4, 256), seed=8, scale=0.01))
    x = batch[:4]
    p3, new_res = codec.encode(x, rng=gen, residual=res)
    np.testing.assert_allclose((new_res + codec.decode(p3)).numpy(),
                               (x + res).numpy(), rtol=0, atol=1e-6)


def test_int8_explicit_uniforms_must_match_the_input():
    codec = tcomm.make_codec("int8")
    x = torch.zeros((2, 5))
    with pytest.raises(ValueError):
        codec.encode(x, rng=torch.zeros((2, 4)))


def test_codec_roundtrip_stacked_matches_reference():
    params = {"a": _vecs((5, 3, 4), seed=9), "b": _vecs((5, 7), seed=10)}
    for name, kw in CODEC_CASES[:3]:
        jout = jcomm.codec_roundtrip_stacked(
            jcomm.make_codec(name, **kw), jax.tree.map(jnp.asarray, params))
        tout = tcomm.codec_roundtrip_stacked(
            tcomm.make_codec(name, **kw), {k: _t(v) for k, v in
                                           params.items()})
        for k in params:
            np.testing.assert_array_equal(tout[k].numpy(), _np(jout[k]))


def test_make_codec_and_config_validation():
    with pytest.raises(ValueError):
        tcomm.make_codec("nope")
    with pytest.raises(ValueError):
        tcomm.CommConfig(policy="nope")
    with pytest.raises(ValueError):
        tcomm.CommConfig(policy="adaptive", target_trigger=0.0)
    with pytest.raises(ValueError):
        tcomm.CommConfig(on_silence="nope")
    assert tcomm.CommConfig(policy="adaptive").use_per_edge
    assert tcomm.CommConfig(per_edge=True).use_per_edge
    assert not tcomm.CommConfig().use_per_edge
    for kw in [{}, {"codec": "int8", "stochastic": False},
               {"codec": "topk", "topk_ratio": 0.1, "topk_momentum": 0.3}]:
        tc = tcomm.CommConfig(**kw).make_codec()
        jc = jcomm.CommConfig(**kw).make_codec()
        assert type(tc).__name__ == type(jc).__name__
        assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert dataclasses.asdict(tcomm.CommConfig()) == dataclasses.asdict(
        jcomm.CommConfig())
    assert tcomm.WIRES == jcomm.WIRES


# --------------------------------------------------------------- trigger

def test_drift_gates_match_reference():
    w = _vecs((9, 60), seed=11)
    last = w + _vecs((9, 60), seed=12, scale=0.2)
    jg, jd = jcomm.drift_gate(jnp.asarray(w), jnp.asarray(last), 1.5)
    tg, td = tcomm.drift_gate(_t(w), _t(last), 1.5)
    np.testing.assert_array_equal(tg.numpy(), _np(jg))
    np.testing.assert_allclose(td.numpy(), _np(jd), rtol=RTOL)
    assert 0 < float(tg.sum()) < 9  # the threshold splits the nodes
    g0, _ = tcomm.drift_gate(_t(w), _t(w), 0.0)
    assert bool((g0 == 1).all())  # threshold 0 = always send

    elast = w[:, None, :] + _vecs((9, 4, 60), seed=13, scale=0.2)
    thr = np.random.default_rng(14).uniform(1.0, 2.0, (9, 4)).astype(
        np.float32)
    valid = (np.random.default_rng(15).random((9, 4)) < 0.7).astype(
        np.float32)
    jg, jd = jcomm.edge_drift_gate(jnp.asarray(w), jnp.asarray(elast),
                                   jnp.asarray(thr), jnp.asarray(valid))
    tg, td = tcomm.edge_drift_gate(_t(w), _t(elast), _t(thr), _t(valid))
    np.testing.assert_array_equal(tg.numpy(), _np(jg))
    np.testing.assert_allclose(td.numpy(), _np(jd), rtol=RTOL)


def test_adaptive_threshold_update_matches_reference():
    rng = np.random.default_rng(16)
    shape = (7, 5)
    thr = rng.uniform(0.0, 2.0, shape).astype(np.float32)
    ema = rng.uniform(0.0, 1.0, shape).astype(np.float32)
    ema[rng.random(shape) < 0.3] = 0.0  # unseeded EMAs take the drift
    drift = rng.uniform(0.0, 3.0, shape).astype(np.float32)
    drift[0, 0] = 0.0  # EMA_FLOOR keeps a zero-drift edge live
    gate = (rng.random(shape) < 0.5).astype(np.float32)
    valid = (rng.random(shape) < 0.8).astype(np.float32)
    kw = dict(target=0.7, ema_beta=0.9, rate=0.5)
    jt, je = jcomm.adaptive_threshold_update(*map(jnp.asarray, (
        thr, ema, drift, gate, valid)), **kw)
    tt, te = tcomm.adaptive_threshold_update(*map(_t, (
        thr, ema, drift, gate, valid)), **kw)
    np.testing.assert_allclose(tt.numpy(), _np(jt), rtol=RTOL, atol=1e-12)
    np.testing.assert_allclose(te.numpy(), _np(je), rtol=RTOL, atol=1e-12)
    frozen = valid == 0
    np.testing.assert_array_equal(tt.numpy()[frozen], thr[frozen])
    assert tcomm.trigger.EMA_FLOOR == jcomm.trigger.EMA_FLOOR


def test_edge_delivery_matches_reference():
    rng = np.random.default_rng(17)
    gate = (rng.random(6) < 0.5).astype(np.float32)
    link = (rng.random((6, 3)) < 0.8).astype(np.float32)
    idx = rng.integers(0, 6, (6, 3))
    j = jcomm.edge_delivery(jnp.asarray(gate), jnp.asarray(link),
                            jnp.asarray(idx.astype(np.int32)))
    t = tcomm.edge_delivery(_t(gate), _t(link), _t(idx))
    np.testing.assert_array_equal(t.numpy(), _np(j))


# ------------------------------------------------------------ transports

def _ring4():
    from repro_torch.graphs.topology import make_topology

    topo = make_topology("ring", n=4)
    return topo.neighbor_idx, topo.neighbor_mask


def _ba16():
    from repro_torch.graphs.topology import make_topology

    topo = make_topology("barabasi_albert", n=16, m=2, seed=0)
    return topo.neighbor_idx, topo.neighbor_mask


GRAPHS = {"ring4": _ring4, "ba16": _ba16}


def _models(n, d=96, seed=0):
    return {"w": _vecs((n, d), seed=seed), "b": _vecs((n, 3), seed=seed + 50)}


def _both(params):
    return (jax.tree.map(jnp.asarray, params),
            {k: _t(v) for k, v in params.items()})


def _flat_ref(tree):
    from repro.utils.pytree import tree_flatten_stacked as jflat

    return _np(jflat(tree)[0])


@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_reverse_slots_and_edge_ids_match_reference(graph):
    nbr_idx, nbr_mask = GRAPHS[graph]()
    n = nbr_idx.shape[0]
    jp, tp = _both(_models(n, d=8))
    cfg = dict(codec="int8", per_edge=True, stochastic=False)
    jt = jcomm.EdgeGossipTransport(jcomm.CommConfig(**cfg), jp, nbr_idx,
                                   nbr_mask)
    tt = tcomm.EdgeGossipTransport(tcomm.CommConfig(**cfg), tp, nbr_idx,
                                   nbr_mask)
    np.testing.assert_array_equal(tt.rev_slot.numpy(), _np(jt.rev_slot))
    np.testing.assert_array_equal(tt.edge_id.numpy(), _np(jt.edge_id))
    assert tt.num_directed == jt.num_directed
    assert tt.num_edges == jt.num_edges
    assert tt.payload_bytes == jt.payload_bytes
    e = nbr_idx.shape[1]
    np.testing.assert_array_equal(
        tt.flat_idx.numpy(),
        (np.maximum(nbr_idx, 0) * e + _np(jt.rev_slot)).reshape(-1))
    # the reverse slots invert the neighbour map on every valid edge
    rev = tt.rev_slot.numpy()
    for r in range(n):
        for s in range(e):
            if nbr_mask[r, s]:
                assert nbr_idx[nbr_idx[r, s], rev[r, s]] == r
    # valid slots enumerate the directed edges once each
    ids = tt.edge_id.numpy()[nbr_mask > 0]
    assert sorted(ids.tolist()) == list(range(tt.num_directed))


def test_asymmetric_layout_is_rejected():
    idx = np.array([[1], [-1]])
    with pytest.raises(ValueError, match="not symmetric"):
        tcomm.transport.reverse_slot_map(idx)


def _failing_link(nbr_idx, receiver=0):
    """A receiver-layout link mask with receiver 0's first slot down."""
    link = (nbr_idx >= 0).astype(np.float32)
    link[receiver, 0] = 0.0
    return link


def _state_equal(ts, js):
    for name, tv in ts._asdict().items():
        jv = getattr(js, name)
        if tv is None:
            assert jv is None, name
        elif name in ("threshold", "drift_ema"):
            # thr + step can cancel: a one-ulp difference in a large term
            # is a large relative one in a small result, so the tolerance
            # is taken against the largest value of the panel
            scale = max(1.0, float(np.abs(_np(jv)).max()))
            np.testing.assert_allclose(tv.numpy(), _np(jv), rtol=RTOL,
                                       atol=RTOL * scale, err_msg=name)
        else:
            np.testing.assert_array_equal(tv.numpy(), _np(jv), err_msg=name)


EDGE_CONFIGS = {
    "int8-adaptive": dict(codec="int8", policy="adaptive",
                          target_trigger=0.5, stochastic=False),
    "int8-fixed-drop": dict(codec="int8", per_edge=True, stochastic=False,
                            trigger_threshold=2.2, on_silence="drop"),
    "topk-momentum": dict(codec="topk", per_edge=True, topk_ratio=0.1,
                          topk_momentum=0.5),
    "fp32-fixed": dict(codec="fp32", per_edge=True, trigger_threshold=2.2),
}


@pytest.mark.parametrize("graph", sorted(GRAPHS))
@pytest.mark.parametrize("cfg", sorted(EDGE_CONFIGS))
def test_per_edge_exchange_with_failing_link_matches_reference(cfg, graph):
    """Two exchanges (a clean one, then one with receiver 0's first link
    down and drifted models): gathered panel, aggregation mask, gates and
    the new per-link state against the reference's."""
    nbr_idx, nbr_mask = GRAPHS[graph]()
    n = nbr_idx.shape[0]
    p1, p2 = _models(n, seed=20), _models(n, seed=20)
    drift = _vecs((n, 96), seed=21, scale=0.3)
    drift[::3] *= 0.05  # some edges stay below a fixed threshold
    p2["w"] = p2["w"] + drift
    jcfg, tcfg = (jcomm.CommConfig(**EDGE_CONFIGS[cfg]),
                  tcomm.CommConfig(**EDGE_CONFIGS[cfg]))
    (jp1, tp1), (jp2, tp2) = _both(p1), _both(p2)
    jt = jcomm.EdgeGossipTransport(jcfg, jp1, nbr_idx, nbr_mask)
    tt = tcomm.EdgeGossipTransport(tcfg, tp1, nbr_idx, nbr_mask)
    js, ts = jt.init_state(jp1), tt.init_state(tp1)
    full = (nbr_idx >= 0).astype(np.float32)
    failed = _failing_link(nbr_idx)
    for jp, tp, link in [(jp1, tp1, full), (jp2, tp2, failed)]:
        jg, jm, jgate, js = jt.exchange(jp, js, jnp.asarray(link))
        tg, tm, tgate, ts = tt.exchange(tp, ts, _t(link))
        jpanel = np.concatenate(
            [_np(l).reshape(n, nbr_idx.shape[1], -1)
             for l in jax.tree.leaves(jg)], axis=2)
        np.testing.assert_array_equal(tgate.numpy(), _np(jgate))
        np.testing.assert_array_equal(tm.numpy(), _np(jm))
        np.testing.assert_array_equal(tg.numpy(), jpanel)
        _state_equal(ts, js)
    assert 0 < float(tgate.sum()) <= float(nbr_mask.sum())


@pytest.mark.parametrize("cfg", [
    dict(codec="int8", stochastic=False, trigger_threshold=2.2),
    dict(codec="topk", topk_ratio=0.1, on_silence="drop"),
    dict(codec="bf16")], ids=["int8-fixed", "topk", "bf16"])
def test_per_node_exchange_with_failing_link_matches_reference(cfg):
    nbr_idx, nbr_mask = _ba16()
    n = nbr_idx.shape[0]
    p1, p2 = _models(n, seed=30), _models(n, seed=30)
    drift = _vecs((n, 96), seed=31, scale=0.3)
    drift[::3] *= 0.05
    p2["w"] = p2["w"] + drift
    (jp1, tp1), (jp2, tp2) = _both(p1), _both(p2)
    jt = jcomm.GossipTransport(jcomm.CommConfig(**cfg), jp1,
                               nbr_idx=nbr_idx, nbr_valid=nbr_mask)
    tt = tcomm.GossipTransport(tcomm.CommConfig(**cfg), tp1,
                               nbr_idx=nbr_idx, nbr_valid=nbr_mask)
    js, ts = jt.init_state(jp1), tt.init_state(tp1)
    full = nbr_mask.astype(np.float32)
    failed = _failing_link(nbr_idx)
    jidx = jnp.asarray(np.maximum(nbr_idx, 0).astype(np.int32))
    tidx = _t(np.maximum(nbr_idx, 0))
    for jp, tp, link in [(jp1, tp1, full), (jp2, tp2, failed)]:
        jdec, jgate, js = jt.exchange(jp, js)
        tdec, tgate, ts = tt.exchange(tp, ts)
        js = jt.note_delivery(js, jcomm.edge_delivery(jgate, jnp.asarray(
            link), jidx))
        ts = tt.note_delivery(ts, tcomm.edge_delivery(tgate, _t(link), tidx))
        np.testing.assert_array_equal(tgate.numpy(), _np(jgate))
        np.testing.assert_array_equal(tdec.numpy(), _flat_ref(jdec))
        _state_equal(ts, js)
    assert 0 < float(tgate.sum()) < n or cfg.get("trigger_threshold", 0) == 0
    assert float(ts.ever_recv[0, 0]) == 1.0  # delivered in the clean round


def test_resets_match_reference():
    nbr_idx, nbr_mask = _ba16()
    n, e = nbr_idx.shape
    p = _models(n, seed=40)
    jp, tp = _both(p)
    rng = np.random.default_rng(41)
    reset_e = ((rng.random((n, e)) < 0.3) * nbr_mask).astype(np.float32)
    reset_n = (rng.random(n) < 0.3).astype(np.float32)
    cfg = dict(codec="int8", policy="adaptive", stochastic=False)
    jt = jcomm.EdgeGossipTransport(jcomm.CommConfig(**cfg), jp, nbr_idx,
                                   nbr_mask)
    tt = tcomm.EdgeGossipTransport(tcomm.CommConfig(**cfg), tp, nbr_idx,
                                   nbr_mask)
    full = jnp.asarray(nbr_mask)
    _, _, _, js = jt.exchange(jp, jt.init_state(jp), full)
    _, _, _, ts = tt.exchange(tp, tt.init_state(tp), _t(nbr_mask))
    _state_equal(tt.reset_edges(ts, _t(reset_e)),
                 jt.reset_edges(js, jnp.asarray(reset_e)))
    # reset folded into the exchange, with a live mask
    live = nbr_mask.copy()
    live[1, :] = 0.0
    live[nbr_idx == 1] = 0.0
    jout = jt.exchange(jp, js, full, live=jnp.asarray(live),
                       reset=jnp.asarray(reset_e))
    tout = tt.exchange(tp, ts, _t(nbr_mask), live=_t(live),
                       reset=_t(reset_e))
    np.testing.assert_array_equal(tout[2].numpy(), _np(jout[2]))
    _state_equal(tout[3], jout[3])

    ncfg = dict(codec="int8", stochastic=False)
    jt = jcomm.GossipTransport(jcomm.CommConfig(**ncfg), jp,
                               nbr_idx=nbr_idx, nbr_valid=nbr_mask)
    tt = tcomm.GossipTransport(tcomm.CommConfig(**ncfg), tp,
                               nbr_idx=nbr_idx, nbr_valid=nbr_mask)
    _, jg, js = jt.exchange(jp, jt.init_state(jp))
    _, tg, ts = tt.exchange(tp, tt.init_state(tp))
    js = jt.note_delivery(js, jnp.asarray(nbr_mask))
    ts = tt.note_delivery(ts, _t(nbr_mask))
    _state_equal(tt.reset_rows(ts, _t(reset_n)),
                 jt.reset_rows(js, jnp.asarray(reset_n)))


def test_failing_link_leaves_sibling_state_bit_identical():
    """The per-edge isolation contract, in the port: dropping (1 -> 0)
    leaves every other link's residual and reference bitwise as in the
    clean run, and leaves (1 -> 0)'s own state at its pre-round value."""
    nbr_idx, nbr_mask = _ring4()
    tp1 = {"w": _t(_vecs((4, 96), seed=50))}
    tp2 = {"w": tp1["w"] + 0.1 * _t(_vecs((4, 96), seed=51))}
    cfg = tcomm.CommConfig(codec="int8", per_edge=True, stochastic=False)
    (slot,) = np.nonzero(nbr_idx[0] == 1)
    failed = nbr_mask.astype(np.float32).copy()
    failed[0, slot[0]] = 0.0
    runs = []
    for link in (nbr_mask.astype(np.float32), failed):
        tr = tcomm.EdgeGossipTransport(cfg, tp1, nbr_idx, nbr_mask)
        st = tr.init_state(tp1)
        _, _, _, st = tr.exchange(tp1, st, _t(nbr_mask))
        _, _, _, new = tr.exchange(tp2, st, _t(link))
        runs.append((st, new))
    (before, clean), (before2, broken) = runs
    assert torch.equal(before.residual, before2.residual)
    (d_fail,) = np.nonzero(nbr_idx[1] == 0)
    d_fail = int(d_fail[0])
    for i in range(4):
        for d in range(2):
            if (i, d) == (1, d_fail):
                continue
            assert torch.equal(clean.residual[i, d], broken.residual[i, d])
            assert torch.equal(clean.last_sent[i, d], broken.last_sent[i, d])
    assert torch.equal(broken.residual[1, d_fail],
                       before.residual[1, d_fail])
    assert torch.equal(broken.last_sent[1, d_fail],
                       before.last_sent[1, d_fail])
    assert not torch.equal(clean.last_sent[1, d_fail],
                           broken.last_sent[1, d_fail])


def test_stochastic_per_edge_draws_one_row_per_directed_edge():
    """The per-edge int8 stream is one uniform row per canonical directed
    edge, indexed by edge_id: the same generator state gives the same
    payloads on every slot of the same edge and a run is reproducible."""
    nbr_idx, nbr_mask = _ba16()
    tp = {"w": _t(_vecs((16, 40), seed=60))}
    tr = tcomm.EdgeGossipTransport(
        tcomm.CommConfig(codec="int8", per_edge=True), tp, nbr_idx, nbr_mask)
    assert tr.wants_rng
    link = _t(nbr_mask)
    with pytest.raises(ValueError, match="Generator"):
        tr.exchange(tp, tr.init_state(tp), link)
    outs = []
    for _ in range(2):
        gen = torch.Generator().manual_seed(3)
        outs.append(tr.exchange(tp, tr.init_state(tp), link, gen))
    assert torch.equal(outs[0][0], outs[1][0])
    # what was drawn: exactly num_directed rows of D uniforms
    gen = torch.Generator().manual_seed(3)
    u = torch.rand((tr.num_directed, 40), generator=gen)[tr.edge_id]
    codec = tr.codec
    p, _ = codec.encode(tp["w"][:, None, :].expand(16, tr.e, 40), rng=u,
                        residual=torch.zeros((16, tr.e, 40)))
    valid = tr.nbr_valid > 0
    ref = codec.decode(p)[valid]
    got = outs[0][3].last_sent[valid]
    assert torch.equal(got, ref)


def test_wires_are_one_computation_and_validated():
    nbr_idx, nbr_mask = _ring4()
    tp = {"w": _t(_vecs((4, 30), seed=70))}
    tr = tcomm.EdgeGossipTransport(
        tcomm.CommConfig(codec="int8", per_edge=True, stochastic=False), tp,
        nbr_idx, nbr_mask)
    st = tr.init_state(tp)
    a = tr.exchange(tp, st, _t(nbr_mask), wire="encoded")
    b = tr.exchange(tp, st, _t(nbr_mask), wire="decoded")
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    with pytest.raises(ValueError, match="wire"):
        tr.exchange(tp, st, _t(nbr_mask), wire="nope")
    nt = tcomm.GossipTransport(tcomm.CommConfig(), tp)
    with pytest.raises(ValueError, match="wire"):
        nt.exchange(tp, nt.init_state(tp), wire="nope")
    assert nt.init_state(tp).ever_recv is None


def test_transport_capability_roster_matches_reference():
    from repro.engine.strategies import _REGISTRY as JREG
    from repro_torch.engine.strategies import available_methods, get_method

    ported = [m for m in available_methods()
              if get_method(m).strategy.supports_transport]
    ref = sorted(m for m, s in JREG.items()
                 if s.strategy.capabilities.transport)
    assert ported == ref
    assert "cfa-ge" not in ported and "fedavg" not in ported \
        and "isol" not in ported


def test_flat_state_matches_tree_flatten():
    """The transports see the same flat model rows as the reference."""
    p = _models(3, d=5)
    jp, tp = _both(p)
    np.testing.assert_array_equal(tree_flatten_stacked(tp)[0].numpy(),
                                  _flat_ref(jp))
