"""The port's LM (configs, layers, the dense forward, the LM loss and the
token stream) against the JAX package, on the CPU.

Inputs come from numpy seeds; the reference's params are drawn by JAX and
carried across with `repro_torch.convert`, so both packages compute on the
same numbers.  Everything here is fp32 (the reduced presets' dtypes).

Tolerances: rtol=1e-5, atol=1e-5 for single layers (norms, RoPE,
attention, MLP) and rtol=1e-4, atol=1e-4 for whole 2-layer forwards and
their gradients — XLA and PyTorch order the fp32 sums of each product and
reduction differently, and a forward stacks some 20 of them.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp

from repro_torch import convert
from repro_torch.utils.pytree import tree_leaves

RTOL, ATOL = 1e-5, 1e-5
FWD_RTOL, FWD_ATOL = 1e-4, 1e-4
DENSE_ARCHS = ["deepseek-7b", "qwen1.5-0.5b", "qwen2.5-14b", "qwen3-32b"]


def _configs(arch, **overrides):
    from repro.configs import get_config as jget
    from repro_torch.configs import get_config

    return (jget(arch).reduced(**overrides),
            get_config(arch).reduced(**overrides))


def _carry(jparams):
    """Reference params -> (numpy tree, port tree on the CPU)."""
    npp = jax.tree.map(lambda x: np.asarray(x, np.float32), jparams)
    names = jax.tree.map(lambda x: str(x.dtype), jparams)
    return npp, convert.params_from_numpy(npp, device="cpu", dtypes=names)


def _close(a, b, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), rtol=rtol,
                               atol=atol)


# ------------------------------------------------------------- configs


@pytest.mark.parametrize("arch", [
    "qwen3-32b", "qwen1.5-0.5b", "whisper-large-v3", "mixtral-8x7b",
    "arctic-480b", "qwen2.5-14b", "zamba2-2.7b", "mamba2-2.7b",
    "deepseek-7b", "llava-next-mistral-7b"])
def test_config_mirrors_jax(arch):
    from repro.configs import ARCH_IDS as JIDS
    from repro.configs import get_config as jget
    from repro_torch.configs import ARCH_IDS, get_config

    assert ARCH_IDS == JIDS
    for j, t in [(jget(arch), get_config(arch)),
                 (jget(arch).reduced(), get_config(arch).reduced()),
                 (jget(arch).reduced(n_layers=4, d_model=256, vocab=2048),
                  get_config(arch).reduced(n_layers=4, d_model=256,
                                           vocab=2048))]:
        assert dataclasses.asdict(j) == dataclasses.asdict(t)
        assert (j.q_dim, j.kv_dim, j.head_dim, j.param_count()) == \
            (t.q_dim, t.kv_dim, t.head_dim, t.param_count())
    assert get_config(arch).pdtype == torch.bfloat16


@pytest.mark.parametrize("arch", [
    "qwen1.5-0.5b", "llava-next-mistral-7b", "mixtral-8x7b", "arctic-480b",
    "mamba2-2.7b", "zamba2-2.7b", "whisper-large-v3"])
def test_build_lm_builds_every_family(arch):
    """Every family builds, draws its params on the CPU in the reference's
    layout (leaf paths and shapes) and starts a decode state at length 0;
    only the enc-dec family has an encoder to prepare."""
    from repro.configs import get_config as jget
    from repro.models.lm import build_lm as jbuild
    from repro_torch.configs import get_config
    from repro_torch.models.lm import build_lm

    lm = build_lm(get_config(arch).reduced())
    jshapes = jax.eval_shape(jbuild(jget(arch).reduced()).init,
                             jax.random.PRNGKey(0))
    params = lm.init(torch.Generator().manual_seed(0), device="cpu")
    assert [tuple(j.shape) for j in jax.tree.leaves(jshapes)] == \
        [tuple(t.shape) for t in tree_leaves(params)]
    assert [str(j.dtype) for j in jax.tree.leaves(jshapes)] == \
        [str(t.dtype).replace("torch.", "") for t in tree_leaves(params)]
    assert (lm.prep_decode_cache is not None) == (lm.cfg.family == "encdec")
    cache = lm.init_cache(1, 8, device="cpu")
    assert int(cache["length"]) == 0
    assert all(t.device.type == "cpu" for t in cache.values())


def test_lm_init_defaults_to_the_card(monkeypatch):
    """`lm.init(gen)` without a device means the card: on a host without
    CUDA it raises rather than building the model on the CPU."""
    from repro_torch.configs import get_config
    from repro_torch.models.lm import build_lm

    lm = build_lm(get_config("qwen1.5-0.5b").reduced(n_layers=1, d_model=16,
                                                     vocab=32))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        lm.init(torch.Generator())
    params = lm.init(torch.Generator().manual_seed(0), device="cpu")
    assert all(t.device.type == "cpu" for t in tree_leaves(params))


def test_full_width_layout_matches_jax():
    """The flat order and size of a full-width qwen1.5-0.5b node: the int8
    payload and the Eq. 5 norm depend on them.  Shapes only (the port's
    init on the meta device, the reference's `eval_shape`)."""
    from repro.configs import get_config as jget
    from repro.models.lm import build_lm as jbuild
    from repro_torch.configs import get_config
    from repro_torch.models.lm import build_lm

    jshapes = jax.eval_shape(jbuild(jget("qwen1.5-0.5b")).init,
                             jax.random.PRNGKey(0))
    tp = build_lm(get_config("qwen1.5-0.5b")).init(torch.Generator(),
                                                    device="meta")
    jpaths = [jax.tree_util.keystr(p) for p, _ in
              jax.tree_util.tree_flatten_with_path(jshapes)[0]]
    assert len(jpaths) == len(tree_leaves(tp)) == 14
    assert jpaths[:3] == ["['embed']['table']", "['final_norm']['scale']",
                          "['layers']['attn']['wk']['b']"]
    for j, t in zip(jax.tree.leaves(jshapes), tree_leaves(tp)):
        assert tuple(j.shape) == tuple(t.shape)
        assert str(j.dtype) == "bfloat16" and t.dtype == torch.bfloat16
    assert sum(t.numel() for t in tree_leaves(tp)) == 463_987_712


# ------------------------------------------------------------- layers


def test_norms_match_jax():
    from repro.models.lm import layers as jl
    from repro_torch.models.lm import layers as tl

    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32) * 3
    scale = rng.uniform(0.5, 1.5, 64).astype(np.float32)
    bias = rng.standard_normal(64).astype(np.float32)
    t = torch.from_numpy
    _close(tl.rms_norm(t(x), t(scale)), jl.rms_norm(x, scale))
    _close(tl.layer_norm(t(x), t(scale), t(bias)),
           jl.layer_norm(x, scale, bias))
    # bf16 in, bf16 out (fp32 inside)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    got = tl.rms_norm(xb, t(scale))
    want = jl.rms_norm(jnp.asarray(x, jnp.bfloat16), scale)
    assert got.dtype == torch.bfloat16
    _close(got.float(), np.asarray(want, np.float32), rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_apply_rope_matches_jax(theta):
    from repro.models.lm import layers as jl
    from repro_torch.models.lm import layers as tl

    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 9, 3, 64)).astype(np.float32)
    pos = np.arange(9, dtype=np.int32) + 5
    _close(tl.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta),
           jl.apply_rope(x, pos, theta))


ATTN_CASES = {
    "mha": ("deepseek-7b", dict(n_kv_heads=4), 16),
    "gqa_qkv_bias": ("qwen2.5-14b", {}, 16),
    "gqa_qk_norm": ("qwen3-32b", {}, 16),
    "sliding_window": ("qwen1.5-0.5b", dict(sliding_window=5), 16),
    "chunked": ("qwen3-32b", dict(full_attn_max_seq=16, attn_chunk_q=8,
                                  attn_chunk_kv=16), 48),
    "chunked_window": ("deepseek-7b", dict(full_attn_max_seq=16,
                                           attn_chunk_q=8, attn_chunk_kv=8,
                                           sliding_window=11), 32),
}


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_attention_matches_jax(case):
    from repro.models.lm import layers as jl
    from repro_torch.models.lm import layers as tl

    arch, over, seq = ATTN_CASES[case]
    jcfg, tcfg = _configs(arch, d_model=64, **over)
    jp = jl.init_attention(jax.random.PRNGKey(3), jcfg)
    if jcfg.qkv_bias:  # make the zero-initialised biases matter
        jp = jax.tree_util.tree_map_with_path(
            lambda p, v: v + 0.1 * jnp.arange(v.size, dtype=v.dtype
                                              ).reshape(v.shape) / v.size
            if "'b'" in jax.tree_util.keystr(p) else v, jp)
    _, tp = _carry(jp)
    x = np.random.default_rng(4).standard_normal((2, seq, 64)).astype(
        np.float32)
    _close(tl.attention(tcfg, tp, torch.from_numpy(x)),
           jl.attention(jcfg, jp, x))


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_mlp_matches_jax(act):
    from repro.models.lm import layers as jl
    from repro_torch.models.lm import layers as tl

    jcfg, tcfg = _configs("deepseek-7b", d_model=64, d_ff=96, act=act)
    jp = jl.init_mlp(jax.random.PRNGKey(5), jcfg)
    _, tp = _carry(jp)
    x = np.random.default_rng(6).standard_normal((2, 7, 64)).astype(
        np.float32)
    _close(tl.mlp(tcfg, tp, torch.from_numpy(x)), jl.mlp(jcfg, jp, x))


def _dense_pair(arch, seed=0, **over):
    from repro.models.lm import build_lm as jbuild
    from repro_torch.models.lm import build_lm

    jcfg, tcfg = _configs(arch, n_layers=2, d_model=64, vocab=256, **over)
    jlm, tlm = jbuild(jcfg), build_lm(tcfg)
    jp = jlm.init(jax.random.PRNGKey(seed))
    _, tp = _carry(jp)
    return jlm, tlm, jp, tp


def _tokens(vocab, b=2, s=16, seed=0):
    from repro.data.tokens import synthetic_token_batch

    return synthetic_token_batch(b, s, vocab, seed=seed)


@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_forward_dense_matches_jax(arch):
    jlm, tlm, jp, tp = _dense_pair(arch)
    batch = _tokens(256)
    jlogits, _ = jlm.forward(jp, {k: jnp.asarray(v) for k, v in
                                  batch.items()})
    tlogits, aux = tlm.forward(tp, {k: torch.from_numpy(v.astype(np.int64))
                                    for k, v in batch.items()})
    assert aux == 0.0 and tuple(tlogits.shape) == (2, 16, 256)
    _close(tlogits.detach(), jlogits, FWD_RTOL, FWD_ATOL)


def test_forward_dense_untied_gelu_layernorm_remat():
    """The options no dense config combines: untied unembedding, GELU MLP,
    LayerNorm, and remat (which must change no number)."""
    from repro_torch.models.lm import build_lm

    jlm, tlm, jp, tp = _dense_pair("deepseek-7b", act="gelu",
                                   norm="layernorm", tie_embeddings=False)
    assert "unembed" in tp
    batch = _tokens(256, seed=2)
    jlogits, _ = jlm.forward(jp, {k: jnp.asarray(v) for k, v in
                                  batch.items()})
    tb = {k: torch.from_numpy(v.astype(np.int64)) for k, v in batch.items()}
    _close(tlm.forward(tp, tb)[0].detach(), jlogits, FWD_RTOL, FWD_ATOL)
    remat = build_lm(dataclasses.replace(tlm.cfg, remat=True))
    leaves = [t.clone().requires_grad_(True) for t in tree_leaves(tp)]
    leaves2 = [t.clone().requires_grad_(True) for t in tree_leaves(tp)]
    from repro_torch.utils.pytree import tree_unflatten_like
    l1, _ = tlm.loss(tree_unflatten_like(tp, leaves), tb)
    l2, _ = remat.loss(tree_unflatten_like(tp, leaves2), tb)
    g1 = torch.autograd.grad(l1, leaves)
    g2 = torch.autograd.grad(l2, leaves2)
    assert torch.equal(l1, l2)
    assert all(torch.equal(a, b) for a, b in zip(g1, g2))


@pytest.mark.parametrize("loss_kind", ["vt", "ce"])
def test_lm_loss_and_gradient_match_jax(loss_kind):
    jlm, tlm, jp, tp = _dense_pair("qwen1.5-0.5b", seed=1)
    batch = _tokens(256, seed=3)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (jtotal, jm), jg = jax.value_and_grad(
        lambda p: jlm.loss(p, jb, loss_kind=loss_kind, beta=0.98),
        has_aux=True)(jp)
    from repro_torch.utils.pytree import tree_unflatten_like
    leaves = [t.clone().requires_grad_(True) for t in tree_leaves(tp)]
    tb = {k: torch.from_numpy(v.astype(np.int64)) for k, v in batch.items()}
    ttotal, tm = tlm.loss(tree_unflatten_like(tp, leaves), tb,
                          loss_kind=loss_kind, beta=0.98)
    tg = torch.autograd.grad(ttotal, leaves)
    _close(float(ttotal.detach()), float(jtotal), 1e-5, 1e-5)
    _close(float(tm["loss"].detach()), float(jm["loss"]), 1e-5, 1e-5)
    for a, b in zip(tg, jax.tree.leaves(jg)):
        _close(a, b, FWD_RTOL, 1e-6)


def test_synthetic_token_batch_is_the_reference_stream():
    from repro.data.tokens import synthetic_token_batch as jtok
    from repro_torch.data.tokens import synthetic_token_batch

    for args in [(2, 16, 256, 0), (4, 128, 151936, 393)]:
        a, b = jtok(*args), synthetic_token_batch(*args)
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_step_gradient_is_the_same_bits_at_four_threads(dtype):
    """The embedding's backward sums the rows of repeated tokens in a fixed
    order (`F.embedding`), so ten gradients of one dense train step at four
    threads are the same bits; the tokens repeat as a Zipf law draws them
    (vocabulary 512).  The thread count is restored at the end."""
    from repro_torch.configs import get_config
    from repro_torch.models.lm import build_lm
    from repro_torch.utils.pytree import tree_unflatten_like

    lm = build_lm(get_config("qwen1.5-0.5b").reduced(
        param_dtype=dtype, activation_dtype=dtype))
    params = lm.init(torch.Generator().manual_seed(6), device="cpu")
    rng = np.random.default_rng(6)
    seq = (rng.zipf(1.3, size=(8, 65)) - 1) % lm.cfg.vocab
    batch = {"tokens": torch.from_numpy(seq[:, :-1].astype(np.int32)),
             "labels": torch.from_numpy(seq[:, 1:].astype(np.int32))}
    assert len(np.unique(seq)) < seq.size // 3  # tokens repeat

    def gradient():
        leaves = [t.detach().requires_grad_(True)
                  for t in tree_leaves(params)]
        total, _ = lm.loss(tree_unflatten_like(params, leaves), batch)
        return [total.detach()] + list(torch.autograd.grad(total, leaves))

    threads = torch.get_num_threads()
    torch.set_num_threads(4)
    try:
        runs = [gradient() for _ in range(10)]
    finally:
        torch.set_num_threads(threads)
    for run in runs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(run, runs[0]))
