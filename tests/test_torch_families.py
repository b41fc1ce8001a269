"""The port's five LM families beside the dense one (VLM, MoE, SSM, hybrid,
enc-dec) against the JAX package, on the CPU.

For each family's reduced preset (llava-next-mistral-7b, mixtral-8x7b,
arctic-480b, mamba2-2.7b, zamba2-2.7b, whisper-large-v3; fp32) the
reference's params, batches and decode caches are carried across with
`repro_torch.convert`, so both packages compute on the same numbers: the
forward's logits and router aux, both losses and their gradients, one
`build_train_step`, and 8 decode steps from the same cache (enc-dec after
`prep_decode_cache`; mixtral's sliding window and the hybrid's rings small
enough to wrap).  Then both MoE dispatches, `input_specs`, the layers the
families add (`attention(kv_override=)`, `cross_kv`), and the reference's
own oracles mirrored on the port (tests/test_model_correctness.py): decode
= prefill, the chunked SSD = its recurrence, the capacity dispatch = the
dense computation.

Tolerances: 1e-4 (rtol and atol) for logits, aux, params after a step and
decode logits, as tests/test_torch_lm.py and test_torch_serve.py hold
whole fp32 forwards: XLA and PyTorch order each fp32 sum differently, and
a forward stacks some 20-40 of them; gradients 1e-4 relative with 1e-6
absolute; the losses 1e-5.  `torch.topk` breaks ties in no promised order
where `lax.top_k` takes the lower index: random fp32 routers tie with
probability 0, so the two route alike.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp

from repro_torch import convert
from repro_torch.utils.pytree import tree_leaves, tree_unflatten_like

TOL = dict(rtol=1e-4, atol=1e-4)
#: one registered config per family, and each family's extra overrides
FAMILY_ARCHS = {
    "llava-next-mistral-7b": {},
    "mixtral-8x7b": dict(sliding_window=4),  # 8 decode steps wrap the ring
    "arctic-480b": {},
    "mamba2-2.7b": {},
    "zamba2-2.7b": {},
    "whisper-large-v3": {},
}
B, S = 2, 32


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads: the suite runs several worker processes at
    once, and every worker spinning a thread per core slows them all."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _pair(arch, seed=0, **overrides):
    """(reference LM, port LM, reference params, port params)."""
    from repro.configs import get_config as jget
    from repro.models.lm import build_lm as jbuild
    from repro_torch.configs import get_config
    from repro_torch.models.lm import build_lm

    over = dict(FAMILY_ARCHS.get(arch, {}), **overrides)
    jlm = jbuild(jget(arch).reduced(**over))
    tlm = build_lm(get_config(arch).reduced(**over))
    jp = jax.jit(jlm.init)(jax.random.PRNGKey(seed))
    npp = jax.tree.map(lambda x: np.asarray(x, np.float32), jp)
    names = jax.tree.map(lambda x: str(x.dtype), jp)
    return jlm, tlm, jp, convert.params_from_numpy(npp, device="cpu",
                                                   dtypes=names)


def _batch(lm, seed=0, b=B, s=S):
    """numpy arrays by `input_specs`, as tests/test_models_smoke.py draws
    them: int32 tokens and labels, embeddings N(0, 1) · 0.05."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, (shape, dtype) in lm.input_specs(b, s).items():
        if dtype == torch.int32:
            out[k] = rng.integers(0, lm.cfg.vocab, shape).astype(np.int32)
        else:
            out[k] = (rng.standard_normal(shape) * 0.05).astype(np.float32)
    return out


def _both(batch):
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(v) for k, v in batch.items()})


def _close(a, b, rtol=1e-4, atol=1e-4):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else a
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), rtol=rtol,
                               atol=atol)


# ------------------------------------------------------------- forward


@functools.lru_cache(maxsize=None)
def _reference(arch):
    """The reference's side of the forward and train-step tests, computed
    once per family in one compiled call: (params as numpy, the batch,
    logits, aux, {kind: (total, loss, grads)}, (loss, params) after one
    `build_train_step`)."""
    from repro.dist.dfl_step import build_train_step as jstep
    from repro.optim.sgd import sgd_momentum as jsgd

    jlm, tlm, jp, _ = _pair(arch, seed=1)
    batch = _batch(tlm, seed=1)
    jb = _both(batch)[0]
    jopt = jsgd(lr=0.05, momentum=0.9)

    def everything(p):
        logits, aux = jlm.forward(p, jb)
        losses = {kind: jax.value_and_grad(
            lambda q: jlm.loss(q, jb, loss_kind=kind, beta=0.98),
            has_aux=True)(p) for kind in ("vt", "ce")}
        new, _, loss = jstep(jlm, jopt)(p, jopt.init(p), jnp.int32(0), jb)
        return logits, aux, losses, (loss, new)

    out = jax.tree.map(np.asarray, jax.jit(everything)(jp))
    return (jax.tree.map(lambda x: np.asarray(x, np.float32), jp),
            jax.tree.map(lambda x: str(x.dtype), jp), batch) + tuple(out)


def _port(arch):
    """The port's LM and a fresh copy of `_reference`'s params."""
    from repro_torch.configs import get_config
    from repro_torch.models.lm import build_lm

    npp, names = _reference(arch)[:2]
    tlm = build_lm(get_config(arch).reduced(**FAMILY_ARCHS[arch]))
    return tlm, convert.params_from_numpy(npp, device="cpu", dtypes=names)


@pytest.mark.parametrize("arch", sorted(FAMILY_ARCHS))
def test_family_forward_and_losses_match_jax(arch):
    """Logits and the router aux (0 but for MoE), then the total loss of
    both kinds and its gradient in every leaf."""
    _, _, batch, jlogits, jaux, jlosses, _ = _reference(arch)
    tlm, tp = _port(arch)
    tb = _both(batch)[1]
    tlogits, taux = tlm.forward(tp, tb)
    assert tuple(tlogits.shape) == tuple(jlogits.shape)
    _close(tlogits, jlogits, **TOL)
    _close(float(taux), float(jaux), **TOL)
    assert (float(taux) > 0) == (tlm.cfg.family == "moe")
    for kind in ("vt", "ce"):
        (jtotal, jm), jg = jlosses[kind]
        leaves = [t.clone().requires_grad_(True) for t in tree_leaves(tp)]
        ttotal, tm = tlm.loss(tree_unflatten_like(tp, leaves), tb,
                              loss_kind=kind, beta=0.98)
        tg = torch.autograd.grad(ttotal, leaves)
        _close(float(ttotal.detach()), float(jtotal), 1e-5, 1e-5)
        _close(float(tm["loss"]), float(jm["loss"]), 1e-5, 1e-5)
        for a, b in zip(tg, jax.tree.leaves(jg)):
            _close(a, b, 1e-4, 1e-6)


@pytest.mark.parametrize("arch", sorted(FAMILY_ARCHS))
def test_family_train_step_matches_jax(arch):
    """One `build_train_step` (SGD with momentum, the VT loss): the loss
    and every param after the step.  The port updates in place."""
    from repro_torch.dist.dfl_step import build_train_step
    from repro_torch.optim.sgd import sgd_momentum

    batch, (jloss, jnew) = _reference(arch)[2], _reference(arch)[-1]
    tlm, tp = _port(arch)
    topt = sgd_momentum(lr=0.05, momentum=0.9)
    tnew, _, tloss = build_train_step(tlm, topt)(tp, topt.init(tp), 0,
                                                 _both(batch)[1])
    _close(float(tloss), float(jloss), 1e-5, 1e-5)
    for a, b in zip(tree_leaves(tnew), jax.tree.leaves(jnew)):
        _close(a, b, **TOL)


# ------------------------------------------------------------- decode


def _carry_cache(jcache):
    return convert.cache_from_numpy(
        jax.tree.map(lambda x: np.asarray(x, np.float32)
                     if x.dtype != jnp.int32 else np.asarray(x), jcache),
        device="cpu")


@pytest.mark.parametrize("arch", sorted(FAMILY_ARCHS))
def test_family_decode_matches_jax(arch):
    """8 greedy-fed decode steps from the same cache: logits within 1e-4,
    equal greedy tokens, and the whole decode state after each step.  The
    dense-like rings hold 8 slots; mixtral's window of 4 and the hybrid's
    rings of 5 wrap; whisper decodes against 6 encoder frames."""
    jlm, tlm, jp, tp = _pair(arch, seed=2)
    rng = np.random.default_rng(2)
    window = 5 if tlm.cfg.family == "hybrid" else 8
    jc = jlm.init_cache(B, window)
    if jlm.prep_decode_cache is not None:
        enc = (rng.standard_normal((B, 6, tlm.cfg.d_model)) * 0.05
               ).astype(np.float32)
        jc = jlm.prep_decode_cache(jp, jc, jnp.asarray(enc))
        tc = tlm.prep_decode_cache(tp, tlm.init_cache(B, window,
                                                      device="cpu"),
                                   torch.from_numpy(enc))
        for k in ("cross_k", "cross_v"):
            _close(tc[k], jc[k], 1e-5, 1e-5)
    tc = _carry_cache(jc)
    assert sorted(tc) == sorted(jc)
    jtok = jnp.asarray(rng.integers(0, tlm.cfg.vocab, (B, 1)), jnp.int32)
    ttok = torch.from_numpy(np.array(jtok))
    jdecode = jax.jit(jlm.decode_step)
    for _ in range(8):
        jlog, jc = jdecode(jp, jc, jtok)
        tlog, tc = tlm.decode_step(tp, tc, ttok)
        _close(tlog, jlog, **TOL)
        jtok = jnp.argmax(jlog[:, -1:], axis=-1).astype(jnp.int32)
        ttok = torch.argmax(tlog[:, -1:], dim=-1)
        np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    for k in jc:
        _close(tc[k].float(), np.asarray(jc[k], np.float32), 1e-4, 1e-5)
    assert int(tc["length"]) == 8


def test_cache_round_trips_every_family():
    """`cache_from_numpy` and `params_to_numpy` are inverse for every
    family's decode state, bf16 k / v included, the SSM's state fp32."""
    from repro_torch.configs import get_config
    from repro_torch.models.lm import build_lm

    for arch in FAMILY_ARCHS:
        lm = build_lm(get_config(arch).reduced(
            param_dtype="bfloat16", activation_dtype="bfloat16"))
        cache = lm.init_cache(2, 8, device="cpu")
        gen = torch.Generator().manual_seed(0)
        for k, t in cache.items():
            if t.is_floating_point():
                t.copy_(torch.randn(t.shape, generator=gen))
        back = convert.cache_from_numpy(convert.params_to_numpy(cache),
                                        device="cpu", kv_dtype="bfloat16")
        assert sorted(back) == sorted(cache)
        for k in cache:
            assert back[k].dtype == cache[k].dtype, k
            assert torch.equal(back[k], cache[k]), k
        if "state" in cache:
            assert cache["state"].dtype == torch.float32


# ------------------------------------------------------------- pieces


@pytest.mark.parametrize("dispatch", ["global", "batch_local"])
def test_moe_dispatch_matches_jax(dispatch):
    """`moe_ffn` under both dispatches at a capacity that drops tokens
    (capacity_factor 0.5: some assignments fall past their expert's
    buffer): output and aux, and the gradient of both in the input and
    every weight."""
    from repro.models.lm import moe as jm
    from repro_torch.models.lm import moe as tm

    jlm, tlm, jp, tp = _pair("mixtral-8x7b", moe_dispatch=dispatch,
                             capacity_factor=0.5)
    jcfg, tcfg = jlm.cfg, tlm.cfg
    jpm = jax.tree.map(lambda x: x[0], jp["layers"]["moe"])
    tpm = {k: v[0] for k, v in tp["layers"]["moe"].items()}
    x = (np.random.default_rng(4).standard_normal((3, 16, tcfg.d_model))
         * 0.5).astype(np.float32)

    def jf(p, xx):
        out, aux = jm.moe_ffn(jcfg, p, xx)
        return jnp.sum(out * jnp.cos(xx)) + 3.0 * aux, (out, aux)

    (_, (jout, jaux)), (jgp, jgx) = jax.jit(jax.value_and_grad(
        jf, argnums=(0, 1), has_aux=True))(jpm, jnp.asarray(x))
    leaves = [t.clone().requires_grad_(True) for t in tree_leaves(tpm)]
    tx = torch.from_numpy(x).requires_grad_(True)
    tout, taux = tm.moe_ffn(tcfg, tree_unflatten_like(tpm, leaves), tx)
    obj = torch.sum(tout * torch.cos(tx)) + 3.0 * taux
    grads = torch.autograd.grad(obj, leaves + [tx])
    _close(tout, jout, **TOL)
    _close(float(taux), float(jaux), 1e-6, 1e-6)
    for a, b in zip(grads, jax.tree.leaves(jgp) + [jgx]):
        _close(a, b, 1e-4, 1e-6)
    # the capacity dropped some assignments: not every token got k experts
    cap = tm._capacity(tcfg, 3 * 16 if dispatch == "global" else 16)
    assert cap < 3 * 16 * tcfg.top_k / tcfg.n_experts * 2


@pytest.mark.parametrize("arch", [
    "qwen3-32b", "qwen1.5-0.5b", "whisper-large-v3", "mixtral-8x7b",
    "arctic-480b", "qwen2.5-14b", "zamba2-2.7b", "mamba2-2.7b",
    "deepseek-7b", "llava-next-mistral-7b"])
def test_input_specs_match_jax(arch):
    from repro.configs import get_config as jget
    from repro.models.lm import build_lm as jbuild
    from repro_torch.configs import get_config
    from repro_torch.models.lm import build_lm

    for cfg_j, cfg_t in [(jget(arch), get_config(arch)),
                         (jget(arch).reduced(), get_config(arch).reduced())]:
        jl, tl = jbuild(cfg_j), build_lm(cfg_t)
        for b, s in [(2, 64), (1, 7), (3, 4096)]:
            js, ts = jl.input_specs(b, s), tl.input_specs(b, s)
            assert sorted(js) == sorted(ts)
            for k in js:
                assert tuple(js[k].shape) == ts[k][0], (k, b, s)
                assert str(js[k].dtype) == str(ts[k][1]).replace(
                    "torch.", ""), k


@pytest.mark.parametrize("over", [dict(), dict(qk_norm=True),
                                  dict(full_attn_max_seq=8)])
def test_cross_attention_matches_jax(over):
    """`cross_kv` (qk-norm on k, no RoPE) and `attention(kv_override=)`
    (RoPE on q alone, non-causal), on the plain and the chunked path."""
    from repro.models.lm import layers as jl
    from repro_torch.models.lm import layers as tl

    from repro.configs import get_config as jget
    from repro_torch.configs import get_config

    jcfg = jget("whisper-large-v3").reduced(n_kv_heads=2, **over)
    tcfg = get_config("whisper-large-v3").reduced(n_kv_heads=2, **over)
    jpa = jl.init_attention(jax.random.PRNGKey(6), jcfg)
    tpa = jax.tree.map(lambda x: torch.from_numpy(np.array(x)), jpa)
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((2, 16, tcfg.d_model)) * 0.5).astype(np.float32)
    enc = (rng.standard_normal((2, 32, tcfg.d_model)) * 0.5).astype(
        np.float32)
    jk, jv = jl.cross_kv(jcfg, jpa, jnp.asarray(enc))
    tk, tv = tl.cross_kv(tcfg, tpa, torch.from_numpy(enc))
    _close(tk, jk, 1e-5, 1e-5)
    _close(tv, jv, 1e-5, 1e-5)
    pos = np.arange(3, 19, dtype=np.int32)
    kpos = np.arange(32, dtype=np.int32)
    jout = jl.attention(jcfg, jpa, jnp.asarray(x), jnp.asarray(pos),
                        causal=False, kv_override=(jk, jv, jnp.asarray(kpos)))
    tout = tl.attention(tcfg, tpa, torch.from_numpy(x), torch.from_numpy(pos),
                        causal=False, kv_override=(tk, tv,
                                                   torch.from_numpy(kpos)))
    _close(tout, jout, 1e-5, 1e-5)
    for causal, rope in [(False, True), (True, False)]:
        _close(tl.attention(tcfg, tpa, torch.from_numpy(x), causal=causal,
                            rope=rope),
               jl.attention(jcfg, jpa, jnp.asarray(x), causal=causal,
                            rope=rope), 1e-5, 1e-5)


def test_constraints_are_the_identity():
    from repro_torch import dist

    x = torch.randn(2, 3, 4)
    tree = {"a": x, "b": {"c": x[0]}}
    assert dist.constrain_batch(x) is x
    assert dist.constrain_residual(x, "batch_seq") is x
    assert dist.constrain_logits(x) is x
    assert dist.constrain_expert_sharded(x) is x
    assert dist.gather_weights(tree) is tree


# ---------------------------------------- the reference's oracles, mirrored


@pytest.mark.parametrize("arch", ["deepseek-7b", "qwen3-32b", "mixtral-8x7b",
                                  "mamba2-2.7b", "zamba2-2.7b"])
def test_decode_matches_prefill(arch):
    """tests/test_model_correctness.py:24 on the port: feeding tokens one
    by one through the cache reproduces the teacher-forced logits
    (ssm_chunk 4; MoE at capacity_factor 4, so no token drops), within the
    reference's 2e-2."""
    from repro_torch.configs import get_config
    from repro_torch.models.lm import build_lm

    cfg = get_config(arch).reduced(ssm_chunk=4)
    if cfg.n_experts:
        cfg = dataclasses.replace(cfg, capacity_factor=4.0)
    lm = build_lm(cfg)
    params = lm.init(torch.Generator().manual_seed(0), device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 8)))
    with torch.no_grad():
        full, _ = lm.forward(params, {"tokens": tokens, "labels": tokens})
        cache = lm.init_cache(2, 8, device="cpu")
        got = []
        for t in range(8):
            logits, cache = lm.decode_step(params, cache, tokens[:, t:t + 1])
            got.append(logits[:, 0])
    _close(torch.stack(got, 1), full.numpy(), 2e-2, 2e-2)


def test_ssd_chunked_matches_recurrence():
    """tests/test_model_correctness.py:47 on the port: the chunk-parallel
    SSD equals h_t = exp(a_t) h_{t-1} + B_t x_t, y_t = C_t · h_t, with the
    final state."""
    from repro_torch.configs import get_config
    from repro_torch.models.lm.ssm import ssd_chunked

    rng = np.random.default_rng(0)
    b, s, h, p, n = 2, 16, 3, 4, 5
    cfg = get_config("mamba2-2.7b").reduced(ssm_chunk=4)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    bm = rng.standard_normal((b, s, h, n)).astype(np.float32)
    cm = rng.standard_normal((b, s, h, n)).astype(np.float32)
    a = -(rng.random((b, s, h)) * 0.5).astype(np.float32)
    t = torch.from_numpy
    y, state = ssd_chunked(cfg, t(x), t(bm), t(cm), t(a))
    hstate = np.zeros((b, h, p, n), np.float32)
    ys = []
    for i in range(s):
        hstate = hstate * np.exp(a[:, i])[:, :, None, None] + np.einsum(
            "bhp,bhn->bhpn", x[:, i], bm[:, i])
        ys.append(np.einsum("bhn,bhpn->bhp", cm[:, i], hstate))
    _close(y, np.stack(ys, axis=1), 1e-4, 1e-4)
    _close(state, hstate, 1e-4, 1e-4)


def test_ssd_gradient_is_finite_past_the_exponents_range():
    """A chunk whose summed decay passes fp32's exp range (63 steps of
    a = -2): the port's forward is the reference's, bitwise, and its
    gradient finite, where the reference's exp-then-mask turns it NaN
    (`ssd_chunked`'s docstring); at a decay inside the range the two
    gradients agree."""
    from repro.configs import get_config as jget
    from repro.models.lm.ssm import ssd_chunked as jssd
    from repro_torch.configs import get_config
    from repro_torch.models.lm.ssm import ssd_chunked

    rng = np.random.default_rng(3)
    b, s, h, p, n = 1, 64, 2, 4, 3
    jcfg = jget("mamba2-2.7b").reduced(ssm_chunk=64)
    cfg = get_config("mamba2-2.7b").reduced(ssm_chunk=64)
    x, bm, cm = (rng.standard_normal((b, s, h, d)).astype(np.float32)
                 for d in (p, n, n))
    for rate, jax_finite in [(2.0, False), (0.05, True)]:
        a = np.full((b, s, h), -rate, np.float32)
        jy, jg = jax.value_and_grad(
            lambda aa: jnp.sum(jssd(jcfg, x, bm, cm, aa)[0] * jnp.cos(
                jnp.asarray(x))))(jnp.asarray(a))
        ta = torch.from_numpy(a).requires_grad_(True)
        y, _ = ssd_chunked(cfg, torch.from_numpy(x), torch.from_numpy(bm),
                           torch.from_numpy(cm), ta)
        (tg,) = torch.autograd.grad(torch.sum(y * torch.cos(
            torch.from_numpy(x))), ta)
        np.testing.assert_allclose(float(y.detach().mul(torch.cos(
            torch.from_numpy(x))).sum()), float(jy), rtol=1e-5, atol=1e-5)
        assert bool(torch.isfinite(tg).all())
        assert bool(jnp.isfinite(jg).all()) == jax_finite
        if jax_finite:
            _close(tg, jg, **TOL)


def test_moe_capacity_dispatch_matches_dense_computation():
    """tests/test_model_correctness.py:91 on the port: at a capacity that
    drops nothing, the sorted dispatch equals the all-experts weighted
    combination, for both dispatches."""
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.models.lm.moe import init_moe_ffn, moe_ffn

    for dispatch in ("global", "batch_local"):
        cfg = get_config("mixtral-8x7b").reduced(capacity_factor=8.0,
                                                 moe_dispatch=dispatch)
        p = init_moe_ffn(torch.Generator().manual_seed(0), cfg)
        x = torch.from_numpy((np.random.default_rng(1).standard_normal(
            (2, 8, cfg.d_model)) * 0.3).astype(np.float32))
        with torch.no_grad():
            out, aux = moe_ffn(cfg, p, x)
            xf = x.reshape(-1, cfg.d_model)
            probs = torch.softmax(xf @ p["router"], dim=-1)
            top_w, top_i = torch.topk(probs, cfg.top_k, dim=-1)
            top_w = top_w / top_w.sum(-1, keepdim=True)
            want = torch.zeros_like(xf)
            for t in range(xf.shape[0]):
                for j in range(cfg.top_k):
                    e = int(top_i[t, j])
                    h = F.silu(xf[t] @ p["wg"][e]) * (xf[t] @ p["wu"][e])
                    want[t] += top_w[t, j] * (h @ p["wd"][e])
        _close(out.reshape(-1, cfg.d_model), want.numpy(), 2e-3, 2e-3)
        assert float(aux) > 0


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "mamba2-2.7b",
                                  "zamba2-2.7b"])
def test_train_entry_point_runs_token_families(arch, capsys):
    """`launch/train.py` trains the families whose batch is tokens alone
    (the reference's `make_batches`): a 2-node DFL round and a single
    replica, finite losses."""
    from repro_torch.launch import train

    for mode in ("dfl", "single"):
        losses = train.main(["--arch", arch, "--mode", mode, "--steps", "2",
                             "--nodes", "2", "--batch", "2", "--seq", "32",
                             "--device", "cpu", "--log-every", "1"])
        assert len(losses) == 2 and np.isfinite(losses).all()
    assert f"arch={arch} preset=reduced" in capsys.readouterr().out


def test_bf16_decode_and_prefill_round_apart_in_both_packages():
    """Why path n holds decode = forward with fp32 activations: at 8
    mamba2 layers in bf16 the reference's own decode and prefill already
    differ by more than tests/test_torch_serve.py's 2e-2 of the largest
    logit (the SSD forward rounds x·dt and each chunk's output to bf16,
    the recurrent step keeps them fp32), and the port's do too; in fp32
    both agree within 1e-4."""
    from repro.configs import get_config as jget
    from repro.models.lm import build_lm as jbuild
    from repro_torch.configs import get_config
    from repro_torch.models.lm import build_lm

    toks = np.random.default_rng(0).integers(0, 512, (2, 16))
    for dtype, lo, hi in [("bfloat16", 2e-2, np.inf), ("float32", 0, 1e-4)]:
        over = dict(n_layers=8, param_dtype=dtype, activation_dtype=dtype)
        jlm = jbuild(jget("mamba2-2.7b").reduced(**over))
        jp = jax.jit(jlm.init)(jax.random.PRNGKey(0))
        jt = jnp.asarray(toks, jnp.int32)
        full = np.asarray(jax.jit(jlm.forward)(jp, {"tokens": jt})[0][:, -1],
                          np.float32)
        jc, step = jlm.init_cache(2, 16), jax.jit(jlm.decode_step)
        for t in range(16):
            jlog, jc = step(jp, jc, jt[:, t:t + 1])
        jgap = np.abs(np.asarray(jlog[:, 0], np.float32) - full).max() \
            / np.abs(full).max()
        tlm = build_lm(get_config("mamba2-2.7b").reduced(**over))
        npp = jax.tree.map(lambda x: np.asarray(x, np.float32), jp)
        tp = convert.params_from_numpy(
            npp, device="cpu", dtypes=jax.tree.map(lambda x: str(x.dtype),
                                                   jp))
        tt = torch.from_numpy(toks)
        with torch.no_grad():
            tfull = tlm.forward(tp, {"tokens": tt})[0][:, -1].float()
            tc = tlm.init_cache(2, 16, device="cpu")
            for t in range(16):
                tlog, tc = tlm.decode_step(tp, tc, tt[:, t:t + 1])
        tgap = float((tlog[:, 0].float() - tfull).abs().max()
                     / tfull.abs().max())
        assert lo < jgap < hi and lo < tgap < hi, (dtype, jgap, tgap)


@pytest.mark.parametrize("arch", [
    "qwen3-32b", "qwen1.5-0.5b", "whisper-large-v3", "mixtral-8x7b",
    "arctic-480b", "qwen2.5-14b", "zamba2-2.7b", "mamba2-2.7b",
    "deepseek-7b", "llava-next-mistral-7b"])
def test_smoke_every_arch(arch):
    """tests/test_models_smoke.py on the port, for every registered
    architecture's reduced preset: a forward of the `input_specs` batch
    (finite logits of the text positions), one train step that moves the
    params, and three greedy decode steps (whisper after
    `prep_decode_cache`)."""
    from repro_torch.configs import get_config
    from repro_torch.dist.dfl_step import build_train_step
    from repro_torch.models.lm import build_lm
    from repro_torch.optim.sgd import sgd_momentum

    lm = build_lm(get_config(arch).reduced())
    params = lm.init(torch.Generator().manual_seed(0), device="cpu")
    batch = _both(_batch(lm, b=2, s=64))[1]
    with torch.no_grad():
        logits, _ = lm.forward(params, batch)
    assert tuple(logits.shape) == (2, batch["tokens"].shape[1],
                                   lm.cfg.vocab)
    assert bool(torch.isfinite(logits).all())
    before = [t.clone() for t in tree_leaves(params)]
    opt = sgd_momentum(lr=1e-2, momentum=0.9)
    params, _, loss = build_train_step(lm, opt)(params, opt.init(params), 0,
                                                batch)
    assert np.isfinite(float(loss))
    assert any(not torch.equal(a, b)
               for a, b in zip(before, tree_leaves(params)))
    cache = lm.init_cache(2, 32, device="cpu")
    if lm.prep_decode_cache is not None:
        enc = torch.from_numpy((np.random.default_rng(0).standard_normal(
            (2, 16, lm.cfg.d_model)) * 0.05).astype(np.float32))
        cache = lm.prep_decode_cache(params, cache, enc)
    tok = torch.zeros((2, 1), dtype=torch.int64)
    with torch.inference_mode():
        for _ in range(3):
            out, cache = lm.decode_step(params, cache, tok)
            tok = torch.argmax(out[:, -1:], dim=-1)
    assert tuple(out.shape) == (2, 1, lm.cfg.vocab)
    assert bool(torch.isfinite(out).all()) and int(cache["length"]) == 3
