"""The port's LM DFL round against the JAX package, on the CPU.

The reference is `repro.dist.dfl_step.build_dfl_round_shardmap` on a
(1, 1, 1) ("pod", "data", "model") mesh: one pod holds every node, with
the fused int8 branch running its Pallas kernel in interpret mode.  Its
initial params are carried across with `repro_torch.convert`, the tokens
are the same numpy stream, and both sides run qwen1.5-0.5b reduced to 2
layers, d_model 64, vocab 256 (fp32) on a 4-node ring, batch 2, seq 16,
for 2 rounds.  No side draws a random number in a round (the int8 codec
is deterministic), so the runs are comparable step for step.

Tolerances: params within atol=1e-4 and the mean loss within 1e-5 after 2
rounds (fp32 forward and backward ordered differently by XLA and PyTorch,
and an int8 grain that may flip where a value lands on a rounding edge);
single operations (the optimizer, one gossip) within 1e-6.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp

from repro_torch import convert
from repro_torch.utils.pytree import tree_leaves, tree_map

NODES, BATCH, SEQ, ROUNDS = 4, 2, 16, 2
PARAM_ATOL, LOSS_ATOL = 1e-4, 1e-5


def _ring(n=NODES):
    from repro_torch.launch.train import ring_adjacency

    return ring_adjacency(n)


def _lms():
    from repro.configs import get_config as jget
    from repro.models.lm import build_lm as jbuild
    from repro_torch.configs import get_config
    from repro_torch.models.lm import build_lm

    over = dict(n_layers=2, d_model=64, vocab=256)
    return (jbuild(jget("qwen1.5-0.5b").reduced(**over)),
            build_lm(get_config("qwen1.5-0.5b").reduced(**over)))


def _carry(jtree):
    npp = jax.tree.map(lambda x: np.asarray(x, np.float32), jtree)
    names = jax.tree.map(lambda x: str(x.dtype), jtree)
    return convert.params_from_numpy(npp, device="cpu", dtypes=names)


def _batches(vocab, rounds=ROUNDS):
    from repro.data.tokens import synthetic_token_batch

    out = []
    for r in range(rounds):
        bs = [synthetic_token_batch(BATCH, SEQ, vocab, seed=r * 131 + i)
              for i in range(NODES)]
        out.append({k: np.stack([b[k] for b in bs]) for k in bs[0]})
    return out


def _assert_params_close(tparams, jparams, atol=PARAM_ATOL):
    tl, jl = tree_leaves(tparams), jax.tree.leaves(jparams)
    assert len(tl) == len(jl)
    for a, b in zip(tl, jl):
        assert str(a.dtype).replace("torch.", "") == str(b.dtype)
        np.testing.assert_allclose(a.float().numpy(),
                                   np.asarray(b, np.float32), rtol=0,
                                   atol=atol)


def test_sgd_momentum_on_bf16_leaves_matches_jax():
    """fp32 momentum, the step taken in fp32 and rounded once to each
    leaf's dtype, over a tree that mixes bf16 and fp32 leaves."""
    from repro.optim.sgd import sgd_momentum as jsgd
    from repro_torch.optim.sgd import sgd_momentum

    rng = np.random.default_rng(0)
    shapes = {"a": (3, 5), "b": {"c": (7,), "d": (2, 2, 4)}}
    dtypes = {"a": "bfloat16", "b": {"c": "float32", "d": "bfloat16"}}
    p0 = jax.tree.map(lambda s, d: jnp.asarray(
        rng.standard_normal(s).astype(np.float32)).astype(d), shapes, dtypes,
        is_leaf=lambda x: isinstance(x, tuple))
    jo, to = jsgd(lr=3e-3, momentum=0.9), sgd_momentum(lr=3e-3, momentum=0.9)
    jp, js = p0, jo.init(p0)
    tp = _carry(p0)
    ts = to.init(tp)
    assert all(v.dtype == torch.float32 for v in tree_leaves(ts))
    for step in range(3):
        g = jax.tree.map(lambda x: jnp.asarray(rng.standard_normal(
            x.shape).astype(np.float32) * 5).astype(x.dtype), p0)
        jp, js = jo.update(g, js, jp, jnp.int32(step))
        tp, ts = to.update(_carry(g), ts, tp)
    _assert_params_close(tp, jp, atol=0)
    _assert_params_close(ts["momentum"], js["momentum"], atol=1e-6)


@pytest.mark.parametrize("exchange", ["fp32", "bf16", "int8"])
def test_decdiff_gossip_with_a_silenced_node_matches_jax(exchange):
    """Node 2 hears nobody (keeps its model exactly) and nobody hears it."""
    from repro.comm.codecs import Int8Codec as JInt8
    from repro.dist.dfl_step import decdiff_gossip as jgossip
    from repro_torch.comm.codecs import Int8Codec
    from repro_torch.dist.dfl_step import decdiff_gossip

    rng = np.random.default_rng(1)
    stacked = {"w": rng.standard_normal((NODES, 6, 5)).astype(np.float32),
               "b": rng.standard_normal((NODES, 9)).astype(np.float32)}
    adj = _ring()
    mask = np.ones((NODES, NODES), np.float32)
    mask[2, :] = mask[:, 2] = 0.0
    kw, tkw = {}, {}
    if exchange == "bf16":
        kw, tkw = dict(gossip_dtype=jnp.bfloat16), dict(
            gossip_dtype=torch.bfloat16)
    elif exchange == "int8":
        kw, tkw = dict(codec=JInt8(stochastic=False)), dict(
            codec=Int8Codec(stochastic=False))
    want = jgossip(jax.tree.map(jnp.asarray, stacked), jnp.asarray(adj),
                   mask=jnp.asarray(mask), **kw)
    got = decdiff_gossip(convert.params_from_numpy(stacked, device="cpu"),
                         torch.from_numpy(adj), mask=torch.from_numpy(mask),
                         **tkw)
    _assert_params_close(got, want, atol=1e-6)
    for name in stacked:
        np.testing.assert_array_equal(got[name][2].numpy(), stacked[name][2])


ROUND_CASES = {
    # the port's round form, its kwargs, the reference's kwargs
    "vmap-none": ("vmap", {}, {}),
    "vmap-bf16": ("vmap", {"gossip_dtype": "bf16"}, {"gossip_dtype": "bf16"}),
    "vmap-int8": ("vmap", {"codec": "int8"},
                  {"codec": "int8", "fuse_dequant": False}),
    "onepod-int8-fused": ("onepod", {"codec": "int8", "fuse_dequant": True},
                          {"codec": "int8", "fuse_dequant": True}),
    "onepod-int8-unfused": ("onepod",
                            {"codec": "int8", "fuse_dequant": False},
                            {"codec": "int8", "fuse_dequant": False}),
}


def _kwargs(kw, torch_side):
    from repro.comm.codecs import Int8Codec as JInt8
    from repro_torch.comm.codecs import Int8Codec

    out = dict(kw)
    if "codec" in out:
        out["codec"] = (Int8Codec if torch_side else JInt8)(stochastic=False)
    if "gossip_dtype" in out:
        out["gossip_dtype"] = torch.bfloat16 if torch_side else jnp.bfloat16
    return out


@pytest.mark.parametrize("case", sorted(ROUND_CASES))
def test_dfl_round_matches_jax_one_pod_shardmap(case):
    from repro.dist.dfl_step import build_dfl_round_shardmap as jbuild
    from repro.optim.sgd import sgd_momentum as jsgd
    from repro_torch.dist.dfl_step import (
        build_dfl_round,
        build_dfl_round_shardmap,
    )
    from repro_torch.kernels import ops
    from repro_torch.optim.sgd import sgd_momentum

    form, tkw, jkw = ROUND_CASES[case]
    jlm, tlm = _lms()
    adj = _ring()
    mesh = jax.make_mesh((1, 1, 1), ("pod", "data", "model"))
    jopt, topt = jsgd(lr=3e-3, momentum=0.9), sgd_momentum(lr=3e-3,
                                                           momentum=0.9)
    jround = jax.jit(jbuild(jlm, jopt, adj, mesh, **_kwargs(jkw, False)))
    make_round = (build_dfl_round if form == "vmap"
                  else build_dfl_round_shardmap)
    tround = make_round(tlm, topt, adj, **_kwargs(tkw, True))

    keys = jax.random.split(jax.random.PRNGKey(0), NODES)
    jp = jax.vmap(jlm.init)(keys)
    js = jax.vmap(jopt.init)(jp)
    tp = _carry(jp)
    ts = topt.init(tp)
    ops.reset_launches()
    for r, batch in enumerate(_batches(tlm.cfg.vocab)):
        jp, js, jloss = jround(jp, js, jnp.int32(r),
                               {k: jnp.asarray(v) for k, v in batch.items()})
        tp, ts, tloss = tround(
            tp, ts, r, {k: torch.from_numpy(v.astype(np.int64))
                        for k, v in batch.items()})
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=0,
                                   atol=LOSS_ATOL)
    _assert_params_close(tp, jp)
    _assert_params_close(ts["momentum"], js["momentum"])
    assert not any(ops.LAUNCHES.values())  # the CPU takes the plain versions


def test_fused_round_reduces_the_int8_payload_through_the_wrapper(
        monkeypatch):
    """The fused one-pod round calls `ops.dequant_neighbor_avg_rows` once
    per round on the [N, D] int8 payload and the [N, N] weights; the
    unfused one never does."""
    from repro_torch.comm.codecs import Int8Codec
    from repro_torch.dist import dfl_step
    from repro_torch.kernels import ops
    from repro_torch.launch.train import init_nodes
    from repro_torch.optim.sgd import sgd_momentum

    calls = []
    real = ops.dequant_neighbor_avg_rows

    def spy(q, scale, wn):
        calls.append((q.dtype, tuple(q.shape), tuple(scale.shape),
                      tuple(wn.shape)))
        return real(q, scale, wn)

    monkeypatch.setattr(ops, "dequant_neighbor_avg_rows", spy)
    _, tlm = _lms()
    opt = sgd_momentum(lr=3e-3)
    d = sum(t[0].numel() for t in tree_leaves(init_nodes(tlm, 1, "cpu")))
    batches = _batches(tlm.cfg.vocab, rounds=2)
    for fuse, expect in [(True, 2), (False, 0)]:
        calls.clear()
        params = init_nodes(tlm, NODES, "cpu")
        state = opt.init(params)
        rnd = dfl_step.build_dfl_round_shardmap(
            tlm, opt, _ring(), codec=Int8Codec(stochastic=False),
            fuse_dequant=fuse)
        for r, b in enumerate(batches):
            params, state, loss = rnd(
                params, state, r, {k: torch.from_numpy(v.astype(np.int64))
                                   for k, v in b.items()})
            assert np.isfinite(float(loss))
        assert len(calls) == expect
        assert all(c == (torch.int8, (NODES, d), (NODES,), (NODES, NODES))
                   for c in calls)


def test_round_mask_overrides_the_built_mask():
    """A runtime mask that silences every link leaves every node with its
    post-step model: the gossip is the identity."""
    from repro_torch.comm.codecs import Int8Codec
    from repro_torch.dist.dfl_step import (
        _local_steps,
        _make_node_step,
        build_dfl_round_shardmap,
    )
    from repro_torch.launch.train import init_nodes
    from repro_torch.optim.sgd import sgd_momentum

    _, tlm = _lms()
    opt = sgd_momentum(lr=3e-3)
    batch = {k: torch.from_numpy(v.astype(np.int64))
             for k, v in _batches(tlm.cfg.vocab, rounds=1)[0].items()}
    p0 = init_nodes(tlm, NODES, "cpu", seed=3)
    ref = tree_map(torch.clone, p0)
    ref_state = opt.init(ref)
    _local_steps(_make_node_step(tlm, opt, "vt", 0.98), ref, ref_state, 0,
                 batch)
    rnd = build_dfl_round_shardmap(tlm, opt, _ring(),
                                   codec=Int8Codec(stochastic=False))
    out, _, _ = rnd(p0, opt.init(p0), 0, batch,
                    mask=np.zeros((NODES, NODES), np.float32))
    for a, b in zip(tree_leaves(out), tree_leaves(ref)):
        assert torch.equal(a, b)


def test_multi_pod_and_unported_options_name_their_roadmap_item():
    from repro_torch.dist.dfl_step import build_dfl_round_shardmap
    from repro_torch.launch import train
    from repro_torch.optim.sgd import sgd_momentum

    _, tlm = _lms()
    with pytest.raises(NotImplementedError, match="A.10"):
        build_dfl_round_shardmap(tlm, sgd_momentum(), _ring(), pods=2)
    with pytest.raises(NotImplementedError, match="A.11"):
        train.main(["--steps", "1", "--device", "cpu", "--ckpt-dir", "x"])
    from repro_torch.launch import serve
    with pytest.raises(NotImplementedError, match="A.11"):
        serve.main(["--arch", "whisper-large-v3", "--device", "cpu"])


def test_flatten_stacked_restores_bf16_leaves_as_jax():
    """The flat [N, D] fp32 view of a mixed bf16/fp32 tree, and the
    unflatten of a perturbed matrix (round to nearest into bf16), equal the
    reference's `tree_flatten_stacked` bit for bit."""
    from repro.utils.pytree import tree_flatten_stacked as jflat
    from repro_torch.utils.pytree import tree_flatten_stacked

    rng = np.random.default_rng(3)
    jtree = {"w": jnp.asarray(rng.standard_normal((3, 4, 5)),
                              jnp.bfloat16),
             "b": jnp.asarray(rng.standard_normal((3, 7)), jnp.float32)}
    jmat, junflat = jflat(jtree)
    tmat, tunflat = tree_flatten_stacked(_carry(jtree))
    np.testing.assert_array_equal(tmat.numpy(), np.asarray(jmat))
    noisy = np.asarray(jmat) * np.float32(1.0 + 1e-3) + np.float32(1e-4)
    want = junflat(jnp.asarray(noisy))
    got = tunflat(torch.from_numpy(noisy))
    _assert_params_close(got, want, atol=0)


def test_bf16_params_round_trip_through_numpy():
    """numpy has no bf16: a bf16 tree crosses as float32 plus dtype names,
    exactly."""
    rng = np.random.default_rng(2)
    t = {"a": torch.from_numpy(rng.standard_normal((3, 4)).astype(
        np.float32)).to(torch.bfloat16),
        "b": {"c": torch.from_numpy(rng.standard_normal(5).astype(
            np.float32))}}
    arrays, names = convert.params_to_numpy(t), convert.dtype_names(t)
    assert arrays["a"].dtype == np.float32 and names == {
        "a": "bfloat16", "b": {"c": "float32"}}
    back = convert.params_from_numpy(arrays, device="cpu", dtypes=names)
    assert back["a"].dtype == torch.bfloat16
    assert torch.equal(back["a"], t["a"]) and torch.equal(back["b"]["c"],
                                                          t["b"]["c"])


@pytest.mark.parametrize("mode,loss", [("dfl", "vt"), ("single", "ce")])
def test_train_entry_point_runs_reduced(mode, loss):
    """`python -m repro_torch.launch.train` on the reduced preset (4
    layers, d_model 256, vocab 2048) for 3 steps: finite losses.  seq 128
    is above the preset's 64-token plain-attention limit, so the chunked
    attention runs."""
    from repro_torch.launch import train

    losses = train.main(["--steps", "3", "--device", "cpu", "--nodes", "2",
                         "--batch", "2", "--mode", mode, "--loss", loss,
                         "--log-every", "1"])
    assert len(losses) == 3 and np.isfinite(losses).all()


def test_eq5_step_is_the_old_formula_and_goes_through_the_wrapper(
        monkeypatch):
    """`_decdiff_step_from_avg` on an LM's bf16 leaves (a node silenced:
    row 0) is the formula of the round before the kernel, bit for bit, and
    reaches Eq. 5 through `ops.decdiff_rows` once per call."""
    from repro_torch.dist import dfl_step
    from repro_torch.kernels import ops
    from repro_torch.launch.train import init_nodes

    _, tlm = _lms()
    local = tree_map(lambda t: t.to(torch.bfloat16),
                     init_nodes(tlm, 3, "cpu"))
    rng = np.random.default_rng(9)
    avg = tree_map(lambda t: t.float() + torch.from_numpy(
        rng.standard_normal(tuple(t.shape)).astype(np.float32) * 0.01),
        local)
    row = torch.tensor([0.0, 1.0, 0.5])
    calls = []
    real = ops.decdiff_rows
    monkeypatch.setattr(ops, "decdiff_rows",
                        lambda *a: calls.append(1) or real(*a))
    got = dfl_step._decdiff_step_from_avg(local, avg, row, 1.0)
    assert len(calls) == 1
    xs, avs = tree_leaves(local), tree_leaves(avg)
    diff = [a - x.float() for x, a in zip(xs, avs)]
    sq = sum(torch.sum(torch.square(d), dim=tuple(range(1, d.dim())))
             for d in diff)
    scale = torch.where(row > 0, 1.0 / (torch.sqrt(sq) + 1.0), 0.0)
    for g, x, d in zip(tree_leaves(got), xs, diff):
        sc = scale.reshape(scale.shape + (1,) * (d.dim() - 1))
        assert g.dtype == torch.bfloat16
        assert torch.equal(g, (x.float() + sc * d).to(x.dtype))
        assert torch.equal(g[0], x[0])
