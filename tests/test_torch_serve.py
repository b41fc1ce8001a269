"""The port's dense serving path (ring KV cache, decode attention, the
decode step, `build_serve_step`, `launch/serve.py`) against the JAX
package, on the CPU.

Inputs come from numpy seeds; the reference's params and decode cache are
carried across with `repro_torch.convert`, so both packages decode from the
same state.  On the CPU `ops.decode_attention_fused` runs its plain
version, which `tests/test_torch_kernels.py` holds against the Pallas
kernel (interpreted) and the reference's oracle.

Tolerances: 1e-5 for one layer in fp32, 1e-4 for whole decode paths in fp32
(XLA and PyTorch order every fp32 sum differently, and 8 steps stack some
20 products each), one bf16 rounding for one bf16 layer, and the
reference's own 2e-2 (`tests/test_model_correctness.py`) for bf16 decode
paths: absolute within one framework, relative to the largest value across
the two, whose bf16 teacher-forced forwards already differ by up to 0.035
at |logit| ~ 5 (the same at every position as the decode logits); across
the two, the decode gap may exceed that forward gap by at most 2e-2.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp

from repro_torch import convert
from repro_torch.utils.pytree import tree_leaves

BF16 = dict(param_dtype="bfloat16", activation_dtype="bfloat16")
#: (arch, reduced overrides): MHA with QKV bias, GQA (G = 2) with QKV bias,
#: GQA (G = 8) with qk-norm and head_dim 128
DECODE_ARCHS = {
    "qwen1.5-0.5b": dict(n_kv_heads=4),
    "qwen2.5-14b": {},
    "qwen3-32b": dict(n_heads=16, n_kv_heads=2, head_dim=128),
}


def _configs(arch, **overrides):
    from repro.configs import get_config as jget
    from repro_torch.configs import get_config

    return (jget(arch).reduced(**overrides),
            get_config(arch).reduced(**overrides))


def _biased(jp):
    """Make the zero-initialised QKV biases matter."""
    return jax.tree_util.tree_map_with_path(
        lambda p, v: v + (0.1 * jnp.arange(v.size, dtype=jnp.float32)
                          .reshape(v.shape) / v.size).astype(v.dtype)
        if "'b'" in jax.tree_util.keystr(p) else v, jp)


def _carry(jparams):
    npp = jax.tree.map(lambda x: np.asarray(x, np.float32), jparams)
    names = jax.tree.map(lambda x: str(x.dtype), jparams)
    return convert.params_from_numpy(npp, device="cpu", dtypes=names)


def _carry_cache(jcache):
    npc = jax.tree.map(lambda x: np.asarray(x.astype(jnp.float32)
                                            if x.dtype == jnp.bfloat16
                                            else x), jcache)
    return convert.cache_from_numpy(npc, device="cpu",
                                    kv_dtype=str(jcache["k"].dtype))


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


# ---------------------------------------------------------------- layer

LAYER_CASES = {
    # name: (dtype overrides, sliding window, ring filled up to, length)
    "fp32": ({}, None, 4, 4),
    "fp32_wrap_window": ({}, 5, 16, 16),
    "bf16": (BF16, None, 4, 4),
    "bf16_wrap": (BF16, None, 16, 16),
}


@pytest.mark.parametrize("case", sorted(LAYER_CASES))
def test_decode_attention_layer_matches_jax(case):
    """One token against a ring of 8 slots (GQA, QKV bias): the output, and
    the cache after the in-place write.  "wrap" rings hold positions 8..15
    and the token at 16 overwrites slot 0; "window" adds the sliding-window
    clause slot_pos > pos - 5."""
    from repro.models.lm import layers as jl
    from repro_torch.models.lm import layers as tl

    over, window, filled, length = LAYER_CASES[case]
    jcfg, tcfg = _configs("qwen2.5-14b", d_model=64, head_dim=16,
                          sliding_window=window, **over)
    jp = _biased(jl.init_attention(jax.random.PRNGKey(1), jcfg))
    tp = _carry(jp)
    rng = np.random.default_rng(len(case))
    b, w = 3, 8
    x = (rng.standard_normal((b, 1, 64)) * 0.3).astype(np.float32)
    kv = rng.standard_normal((2, b, w, 2, 16)).astype(np.float32)
    sp = np.array([p for p in range(filled - w, filled)], np.int32)
    sp = np.where(sp >= 0, sp, -1)[np.argsort(np.mod(np.arange(filled - w,
                                                               filled), w))]
    dt = jcfg.adtype
    jx = jnp.asarray(x, dt)
    jlc = {"k": jnp.asarray(kv[0], dt), "v": jnp.asarray(kv[1], dt),
           "slot_pos": jnp.asarray(sp)}
    jout, jnew = jl.decode_attention(jcfg, jp, jx, jlc,
                                     jnp.int32(length))
    tlc = {"k": torch.tensor(_f32(jlc["k"])).to(tcfg.adtype),
           "v": torch.tensor(_f32(jlc["v"])).to(tcfg.adtype),
           "slot_pos": torch.from_numpy(sp.copy())}
    k_before = tlc["k"].clone()
    tout, tnew = tl.decode_attention(tcfg, tp, torch.tensor(_f32(jx)).to(
        tcfg.adtype), tlc, torch.tensor(length, dtype=torch.int32))
    assert tnew is tlc and tout.dtype == tcfg.adtype
    assert tuple(tout.shape) == (b, 1, 64)
    slot = length % w
    np.testing.assert_array_equal(tlc["slot_pos"].numpy(),
                                  np.asarray(jnew["slot_pos"]))
    assert tlc["slot_pos"][slot] == length
    keep = [i for i in range(w) if i != slot]
    for name in ("k", "v"):  # untouched slots exactly, the new one close
        np.testing.assert_array_equal(_f32(tlc[name][:, keep]),
                                      _f32(jnew[name][:, keep]))
    assert torch.equal(tlc["k"][:, keep], k_before[:, keep])
    if jcfg.activation_dtype == "float32":
        tol = dict(rtol=1e-5, atol=1e-5)
    else:  # one bf16 rounding of the layer's output
        tol = dict(rtol=2.0 ** -7, atol=2.0 ** -7 * float(np.abs(
            _f32(jout)).max()))
    for name in ("k", "v"):
        np.testing.assert_allclose(_f32(tlc[name][:, slot]),
                                   _f32(jnew[name][:, slot]), **tol)
    np.testing.assert_allclose(_f32(tout), _f32(jout), **tol)


# ---------------------------------------------------------- decode path


def _decode_pair(arch, seq_len, **over):
    from repro.models.lm import build_lm as jbuild
    from repro_torch.models.lm import build_lm

    jcfg, tcfg = _configs(arch, **{**DECODE_ARCHS[arch], **over})
    jlm, tlm = jbuild(jcfg), build_lm(tcfg)
    jp = _biased(jlm.init(jax.random.PRNGKey(0)))
    jcache = jlm.init_cache(2, seq_len)
    return jlm, tlm, jp, _carry(jp), jcache, _carry_cache(jcache)


DECODE_CASES = [(arch, dt, {}) for arch in sorted(DECODE_ARCHS)
                for dt in ("fp32", "bf16")] + [
    ("qwen2.5-14b", "fp32", dict(decode_window=4))]


@pytest.mark.parametrize("arch,dt,over", DECODE_CASES,
                         ids=[f"{a}-{d}{'-ring4' if o else ''}"
                              for a, d, o in DECODE_CASES])
def test_decode_path_matches_jax(arch, dt, over):
    """8 tokens through `lm.decode_step` of both packages from the same
    params and cache (the decode_window=4 case wraps the ring twice):
    fp32 logits within 1e-4 with equal greedy tokens, bf16 logits and
    caches within the reference's 2e-2 taken relative to the largest
    value; the final slot positions are equal and the lengths are 8."""
    jlm, tlm, jp, tp, jcache, tcache = _decode_pair(
        arch, 8, **over, **(BF16 if dt == "bf16" else {}))
    tokens = np.random.default_rng(7).integers(0, 512, (2, 8)).astype(
        np.int32)
    step = jax.jit(jlm.decode_step)
    jl, tl = [], []
    for t in range(8):
        jlog, jcache = step(jp, jcache, jnp.asarray(tokens[:, t:t + 1]))
        tlog, tcache = tlm.decode_step(
            tp, tcache, torch.from_numpy(tokens[:, t:t + 1].astype(np.int64)))
        jl.append(_f32(jlog[:, 0]))
        tl.append(_f32(tlog[:, 0]))
    jl, tl = np.stack(jl, 1), np.stack(tl, 1)
    if dt == "fp32":
        tol = 1e-4
        np.testing.assert_allclose(tl, jl, rtol=tol, atol=tol)
        np.testing.assert_array_equal(tl.argmax(-1), jl.argmax(-1))
    else:
        # the two frameworks round the shared bf16 forward at other places:
        # their teacher-forced logits already differ by up to ~0.035 at
        # |logit| ~ 5, position for position as the decode logits do, so
        # the absolute 2e-2 is taken relative to the largest logit; and
        # the decode gap may exceed that forward gap by no more than the
        # absolute 2e-2
        tol = 2e-2
        jfull, _ = jlm.forward(jp, {"tokens": jnp.asarray(tokens)})
        with torch.no_grad():
            tfull, _ = tlm.forward(tp, {"tokens": torch.from_numpy(
                tokens.astype(np.int64))})
        fwd_gap = float(np.abs(_f32(tfull) - _f32(jfull)).max())
        dec_gap = float(np.abs(tl - jl).max())
        gaps = (f"bf16 decode gap {dec_gap:.4g}, teacher-forced forward gap "
                f"{fwd_gap:.4g} (~0.035 when written), max|logit| "
                f"{float(np.abs(jl).max()):.4g}")
        np.testing.assert_allclose(tl, jl, rtol=tol,
                                   atol=tol * float(np.abs(jl).max()),
                                   err_msg=gaps)
        assert dec_gap <= fwd_gap + tol, gaps
    got = convert.params_to_numpy(tcache)
    assert int(got["length"]) == int(jcache["length"]) == 8
    np.testing.assert_array_equal(got["slot_pos"],
                                  np.asarray(jcache["slot_pos"]))
    for name in ("k", "v"):
        want = _f32(jcache[name])
        np.testing.assert_allclose(
            got[name], want, rtol=tol,
            atol=tol * (1.0 if dt == "fp32" else float(np.abs(want).max())))


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
@pytest.mark.parametrize("arch", ["deepseek-7b", "qwen1.5-0.5b",
                                  "qwen2.5-14b", "qwen3-32b"])
def test_decode_equals_teacher_forced_forward(arch, dt):
    """Feeding tokens one by one through the cache reproduces the port's
    own teacher-forced forward logits: within 1e-4 in fp32, within the
    reference's 2e-2 in bf16 (`tests/test_model_correctness.py`)."""
    from repro_torch.configs import get_config
    from repro_torch.models.lm import build_lm

    lm = build_lm(get_config(arch).reduced(**DECODE_ARCHS.get(arch, {}),
                                           **(BF16 if dt == "bf16" else {})))
    params = lm.init(torch.Generator().manual_seed(0), device="cpu")
    tokens = torch.from_numpy(
        np.random.default_rng(1).integers(0, 512, (2, 8)))
    with torch.no_grad():
        full, _ = lm.forward(params, {"tokens": tokens})
    cache = lm.init_cache(2, 8, device="cpu")
    got = []
    for t in range(8):
        logits, cache = lm.decode_step(params, cache, tokens[:, t:t + 1])
        got.append(logits[:, 0])
    tol = 1e-4 if dt == "fp32" else 2e-2
    torch.testing.assert_close(torch.stack(got, 1).float(), full.float(),
                               rtol=tol, atol=tol)


# -------------------------------------------------------- entry points


def test_init_cache_matches_jax_and_defaults_to_the_card(monkeypatch):
    """The window rule and layout of the reference's `init_cache`, and no
    device meaning the card: without CUDA it raises."""
    from repro.configs import get_config as jget
    from repro.models.lm import build_lm as jbuild
    from repro_torch.configs import get_config
    from repro_torch.models.lm import build_lm

    for over, seq in [({}, 16), (dict(decode_window=6), 16),
                      (dict(sliding_window=5, decode_window=6), 16), (BF16, 3)]:
        jc = jbuild(jget("qwen3-32b").reduced(**over)).init_cache(2, seq)
        lm = build_lm(get_config("qwen3-32b").reduced(**over))
        tc = lm.init_cache(2, seq, device="cpu")
        assert sorted(tc) == sorted(jc)
        for name in tc:
            assert tuple(tc[name].shape) == tuple(jc[name].shape), name
            assert str(tc[name].dtype).replace("torch.", "") == str(
                jc[name].dtype), name
            np.testing.assert_array_equal(_f32(tc[name]), _f32(jc[name]))
    assert lm.prep_decode_cache is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        lm.init_cache(1, 8)


def test_decode_step_updates_the_cache_in_place():
    from repro_torch.configs import get_config
    from repro_torch.models.lm import build_lm

    lm = build_lm(get_config("qwen1.5-0.5b").reduced())
    params = lm.init(torch.Generator().manual_seed(0), device="cpu")
    cache = lm.init_cache(2, 4, device="cpu")
    k, length = cache["k"], cache["length"]
    saved = {n: t.clone() for n, t in cache.items()}
    _, out = lm.decode_step(params, cache, torch.tensor([[3], [5]]))
    assert out is cache and out["k"] is k
    assert int(length) == 0 and int(out["length"]) == 1  # a new tensor
    assert out["slot_pos"][:, 0].eq(0).all() and out["slot_pos"][:, 1:].eq(
        -1).all()
    assert out["k"][:, :, 0].abs().sum() > 0 and not out["k"][:, :, 1:].any()
    # a cloned cache decodes the same token again to the same logits
    a, _ = lm.decode_step(params, {n: t.clone() for n, t in saved.items()},
                          torch.tensor([[3], [5]]))
    b, _ = lm.decode_step(params, saved, torch.tensor([[3], [5]]))
    assert torch.equal(a, b)


def test_cache_round_trips_through_numpy():
    from repro_torch.configs import get_config
    from repro_torch.models.lm import build_lm

    lm = build_lm(get_config("qwen2.5-14b").reduced(**BF16))
    params = lm.init(torch.Generator().manual_seed(0), device="cpu")
    cache = lm.init_cache(2, 4, device="cpu")
    lm.decode_step(params, cache, torch.tensor([[1], [2]]))
    back = convert.cache_from_numpy(convert.params_to_numpy(cache),
                                    device="cpu", kv_dtype="bfloat16")
    for name in cache:
        assert back[name].dtype == cache[name].dtype
        assert torch.equal(back[name], cache[name])


def test_build_serve_step_is_the_decode_step():
    from repro_torch.configs import get_config
    from repro_torch.dist.dfl_step import build_serve_step
    from repro_torch.models.lm import build_lm

    lm = build_lm(get_config("qwen3-32b").reduced())
    params = lm.init(torch.Generator().manual_seed(2), device="cpu")
    step = build_serve_step(lm)
    c1 = lm.init_cache(2, 6, device="cpu")
    c2 = lm.init_cache(2, 6, device="cpu")
    for tok in ([[1], [2]], [[3], [4]], [[5], [6]]):
        tok = torch.tensor(tok)
        a, c1 = step(params, c1, tok)
        b, c2 = lm.decode_step(params, c2, tok)
        assert torch.equal(a, b)
    assert int(c1["length"]) == 3
    assert tuple(a.shape) == (2, 1, lm.cfg.vocab)


def test_serve_entry_point_runs_reduced(capsys):
    from repro_torch.launch import serve

    gen = serve.main(["--device", "cpu", "--batch", "2", "--prompt-len", "4",
                      "--new-tokens", "5"])
    assert gen.shape == (2, 5) and ((gen >= 0) & (gen < 512)).all()
    assert "decoded 5 tokens (4 decode steps)" in capsys.readouterr().out
    again = serve.main(["--device", "cpu", "--batch", "2", "--prompt-len",
                        "4", "--new-tokens", "5"])
    np.testing.assert_array_equal(gen, again)


def test_serve_names_its_roadmap_item_for_other_families():
    from repro_torch.launch import serve

    for arch in ("whisper-large-v3", "mixtral-8x7b"):
        with pytest.raises(NotImplementedError, match="A.11"):
            serve.main(["--device", "cpu", "--arch", arch])


def test_generate_is_greedy_decoding_of_the_step():
    """`serve.generate` takes the first token from the last prompt logits
    and each later one from the step before, by argmax."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import generate
    from repro_torch.models.lm import build_lm

    lm = build_lm(get_config("qwen1.5-0.5b").reduced())
    params = lm.init(torch.Generator().manual_seed(0), device="cpu")
    prompts = torch.tensor([[7, 8, 9], [1, 2, 3]])
    tokens, logits, cache, secs = generate(
        lm.decode_step, params, lm.init_cache(2, 6, device="cpu"), prompts, 2)
    assert tuple(tokens.shape) == (2, 3) and len(secs) == 2
    assert int(cache["length"]) == 5
    seq = torch.cat([prompts, tokens[:, :2]], dim=1)
    with torch.no_grad():
        full, _ = lm.forward(params, {"tokens": seq})
    assert torch.equal(tokens, full[:, 2:].argmax(-1))
    assert all(t.device.type == "cpu" for t in tree_leaves(cache))
