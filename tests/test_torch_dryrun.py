"""The fake-tensor dry run (ROADMAP A.11.4) and the names the dry run
needs, against the JAX package, on the CPU.

  * `launch/dryrun.py` at one reduced arch per kind — train on a single
    pod, the multi-pod DFL round, prefill, decode — on small meshes
    ((data = 2, model = 2); (pod = 2, data = 2, model = 2)): the record's
    fields, the argument bytes against the leaves' sizes divided as the
    specs say, the gossip bytes, the chip-count division where the step is
    not partitioned, and for the dense family on the single mesh the
    partitioned step's own per-device counts, temp and collectives;
  * `FlopCounterMode` and the bytes counter under fake tensors count what
    they count on real CPU tensors;
  * `model_flops_per_chip` equals the reference's for every arch and
    shape; the variants' `same_as`;
  * `lm_input_specs`; `sgd_momentum(momentum_dtype=)` and
    `adamw(state_dtype=)` in fp32 and bf16 over 3 steps (params to 1e-6;
    a bf16 state within one bf16 ulp, an fp32 one to 1e-6); each of the
    15 pytree helpers (`tree_random_like` by shape, dtype and scale).
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.comm_analysis import COLLECTIVE_OPS  # noqa: E402
from repro_torch.utils import pytree as tp  # noqa: E402

SMALL = {"single": (2, 2), "multi": (2, 2, 2)}


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _reduced(arch):
    from repro_torch.configs import get_config

    return get_config(arch).reduced()


# ------------------------------------------------------------- the record

@pytest.mark.parametrize("arch,shape_name,mesh,shape", [
    ("qwen1.5-0.5b", "train_4k", "single", (64, 8, "train")),
    ("mixtral-8x7b", "train_4k", "multi", (64, 8, "train")),
    ("llava-next-mistral-7b", "prefill_32k", "multi", (64, 8, "prefill")),
    ("zamba2-2.7b", "decode_32k", "single", (64, 8, "decode")),
    ("whisper-large-v3", "long_500k", "multi", (128, 1, "decode")),
])
def test_record_fields(tmp_path, arch, shape_name, mesh, shape):
    import torch.distributed as dist

    cfg = _reduced(arch)
    rec = dryrun.run_one(arch, shape_name, mesh, str(tmp_path), cfg=cfg,
                         shape=shape, mesh_dims=SMALL[mesh],
                         hbm_bytes=80e9)
    assert rec["ok"], rec.get("traceback")
    assert not dist.is_initialized()
    n_chips = int(np.prod(SMALL[mesh]))
    names = ("data", "model") if mesh == "single" else ("pod", "data",
                                                        "model")
    assert rec["mesh_shape"] == dict(zip(names, SMALL[mesh]))
    assert rec["n_chips"] == n_chips and rec["kind"] == shape[2]
    assert rec["param_count"] == cfg.param_count()
    assert rec["active_param_count"] == cfg.active_param_count()
    cost = rec["cost_analysis"]
    assert cost["flops"] > 0 and cost["bytes accessed"] > 0
    mem = rec["memory_analysis"]
    coll = rec["collectives"]
    r = rec["roofline"]
    part = mesh == "single" and cfg.family == "dense"
    assert rec["partitioned"] is part
    if part:  # the sharded step's own per-device counts
        assert "flops_global" not in cost and not mem["temp_is_upper_bound"]
        assert coll["intra_pod"] == coll["total"] > 0
        assert coll["gossip"] == 0.0
        assert coll["total"] == sum(v for k, v in coll.items()
                                    if k in COLLECTIVE_OPS)
        assert all(coll[k + "_count"] > 0 for k in COLLECTIVE_OPS
                   if k in coll)
        assert r["collective_s"] > 0 and "not_partitioned" not in rec
    else:
        assert cost["flops"] == cost["flops_global"] / n_chips
        assert cost["bytes accessed"] == \
            cost["bytes_accessed_global"] / n_chips
        assert mem["temp_is_upper_bound"]
        assert coll["intra_pod"] is None
        assert coll["gossip"] == coll["total"]
        assert "ROADMAP A.14" in rec["not_partitioned"]
        assert (coll["total"] > 0) == (shape[2] == "train"
                                       and mesh == "multi")
    assert mem["argument_size_in_bytes"] > 0
    assert mem["temp_size_in_bytes"] >= 0
    assert mem["temp_batch_per_device"] == {
        ("train", "single"): 4, ("train", "multi"): 2,
        ("prefill", "multi"): 2, ("decode", "single"): 4,
        ("decode", "multi"): 1}[shape[2], mesh]
    assert rec["bytes_per_device"] == (mem["argument_size_in_bytes"]
                                       + mem["temp_size_in_bytes"]
                                       + mem["output_size_in_bytes"])
    assert rec["fits_hbm"] is True and rec["hbm_bytes"] == 80e9
    assert r["compute_s"] == cost["flops"] / dryrun.HW["peak_flops_bf16"]
    assert r["memory_s"] == cost["bytes accessed"] / dryrun.HW["hbm_bw"]
    assert r["collective_s"] == coll["total"] / dryrun.HW["link_bw"]
    path = tmp_path / f"{arch}__{shape_name}__{mesh}.json"
    assert path.is_file()
    assert dryrun.run_one(arch, shape_name, mesh, str(tmp_path)) == \
        __import__("json").loads(path.read_text())  # reused, not traced


def test_argument_and_gossip_bytes_follow_the_specs(tmp_path):
    """Train on the multi mesh: the argument bytes are the params' and the
    momentum's shards plus the batch's, each leaf divided by the sizes of
    the axes its spec names; the gossip is the other pod's param shard."""
    from repro_torch.configs import get_config
    from repro_torch.dist.sharding import make_batch_specs, make_param_specs
    from repro_torch.models.lm import build_lm

    cfg = get_config("qwen1.5-0.5b").reduced()
    rec = dryrun.run_one("q", "x", "multi", str(tmp_path), cfg=cfg,
                         shape=(64, 8, "train"), mesh_dims=(2, 2, 2),
                         hbm_bytes=1.0)
    assert rec["ok"] and rec["fits_hbm"] is False
    sizes = {"pod": 2, "data": 2, "model": 2}
    mesh = type("M", (), {"shape": sizes})()
    lm = build_lm(cfg)
    one = lm.init(torch.Generator(), device="meta")
    params = tp.tree_map(lambda t: torch.empty((2,) + tuple(t.shape),
                                               dtype=t.dtype, device="meta"),
                         one)
    specs = make_param_specs(params, mesh, dfl_node_axis=True)

    def local(t, spec, itemsize):
        n = t.numel()
        for e in spec:
            for name in (e if isinstance(e, tuple) else (e,)):
                n //= sizes[name] if name else 1
        return n * itemsize

    p_bytes = sum(local(t, s, t.element_size()) for t, s in
                  zip(tp.tree_leaves(params), tp.tree_leaves(specs)))
    m_bytes = sum(local(t, s, 4) for t, s in
                  zip(tp.tree_leaves(params), tp.tree_leaves(specs)))
    batch = {k: ((2, 4) + tuple(s[1:]), d)
             for k, (s, d) in lm.input_specs(4, 64).items()}
    b_specs = make_batch_specs(batch, mesh, dfl_node_axis=True)
    b_bytes = sum(local(torch.empty(s, device="meta"), b_specs[k], 4)
                  for k, (s, _) in batch.items())
    mem = rec["memory_analysis"]
    assert mem["argument_size_in_bytes"] == p_bytes + m_bytes + b_bytes
    # one device's share: 8 sequences over 2 nodes, each node's 4 over data
    assert mem["temp_batch_per_device"] == 2
    assert rec["collectives"]["total"] == p_bytes  # (P - 1) = 1 shard
    assert mem["output_size_in_bytes"] == p_bytes + 4


def test_variants_that_only_steer_sharding_trace_their_twin(tmp_path):
    """Where the step is not partitioned, a variant that changes only the
    reference's sharding traces its twin's step; on a partitioned step
    only the shard_map form does (the others change the step)."""
    assert dryrun.same_as(dryrun.VARIANTS["zero3"]) == "baseline"
    assert dryrun.same_as(dryrun.VARIANTS["seqshard"]) == "baseline"
    assert dryrun.same_as(dryrun.VARIANTS["shardmap"]) == "baseline"
    assert dryrun.same_as(dryrun.VARIANTS["all"]) == "bf16probs"
    assert dryrun.same_as(
        dryrun.VARIANTS["shardmap+seqshard+gossipbf16"]) == "gossipbf16"
    assert dryrun.same_as(dryrun.VARIANTS["moelocal"]) is None
    assert dryrun.same_as(None) is None
    assert dryrun.same_as(dryrun.VARIANTS["zero3"], True) is None
    assert dryrun.same_as(dryrun.VARIANTS["shardmap"], True) == "baseline"
    assert dryrun.same_as(dryrun.VARIANTS["shardmap+seqshard"],
                          True) == "seqshard"
    rec = dryrun.run_one("q", "x", "multi", str(tmp_path),
                         variant="zero3",
                         variant_override=dryrun.VARIANTS["zero3"],
                         cfg=_reduced("qwen1.5-0.5b"),
                         shape=(64, 8, "train"), mesh_dims=(2, 2, 2))
    assert rec["ok"] and rec["same_as"] == "baseline"
    assert "cost_analysis" not in rec
    # on the single mesh zero3 gathers every weight: more all-gathered
    part = [dryrun.run_one("q", "x", "single", str(tmp_path), force=True,
                           variant=v, variant_override=dryrun.VARIANTS.get(v),
                           cfg=_reduced("qwen1.5-0.5b").reduced(vocab=2048),
                           shape=(32, 4, "train"), mesh_dims=(2, 2))
            for v in (None, "zero3")]
    assert all(r["ok"] and r["partitioned"] for r in part)
    assert part[1]["collectives"]["all-gather"] > \
        part[0]["collectives"]["all-gather"]
    # a variant that changes the step runs, and the gossip shrinks in bf16
    recs = [dryrun.run_one("q", "x", "multi", str(tmp_path), force=True,
                           variant=v, variant_override=dryrun.VARIANTS.get(v),
                           cfg=_reduced("qwen1.5-0.5b"),
                           shape=(64, 8, "train"), mesh_dims=(2, 2, 2))
            for v in (None, "gossipbf16")]
    assert all(r["ok"] for r in recs)
    assert recs[1]["collectives"]["total"] < recs[0]["collectives"]["total"]


def test_adapt_config_matches_the_reference():
    from repro.configs import get_config as jget
    from repro_torch.configs import get_config

    for arch in ("qwen1.5-0.5b", "mamba2-2.7b", "whisper-large-v3",
                 "mixtral-8x7b"):
        for shape in dryrun.SHAPES:
            t = dryrun._adapt_config(get_config(arch), shape,
                                     dryrun.VARIANTS["all"])
            j = jget(arch)
            assert t.decode_window == (
                dryrun.LONG_WINDOW if shape == "long_500k"
                and j.family in ("dense", "vlm", "encdec") else None)
            assert t.remat == (shape == "train_4k")
            assert t.zero3_gather and t.attn_probs_bf16


# ---------------------------------------------------------- the counters

def _count(step_fn, make_args, fake):
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    if fake:
        with FakeTensorMode(allow_non_fake_inputs=True):
            args = make_args()
            counted = dryrun._BytesAccessed()
            with FlopCounterMode(display=False) as flops, counted:
                step_fn(*args)
    else:
        args = make_args()
        counted = dryrun._BytesAccessed()
        with FlopCounterMode(display=False) as flops, counted:
            step_fn(*args)
    return flops.get_total_flops(), counted.total


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "mixtral-8x7b"])
def test_fake_counts_equal_real_counts(arch):
    from repro_torch.dist.dfl_step import build_train_step
    from repro_torch.models.lm import build_lm
    from repro_torch.optim.sgd import sgd_momentum

    cfg = _reduced(arch)
    lm = build_lm(cfg)
    opt = sgd_momentum(lr=1e-2)
    tokens = np.random.default_rng(0).integers(0, cfg.vocab, (2, 2, 16))

    def make_args():
        params = lm.init(torch.Generator().manual_seed(0), device="cpu")
        return (params, opt.init(params), 0,
                {"tokens": torch.from_numpy(tokens[0]),
                 "labels": torch.from_numpy(tokens[1])})

    step = build_train_step(lm, opt)
    real = _count(step, make_args, fake=False)
    fake = _count(step, make_args, fake=True)
    assert real == fake and real[0] > 0 and real[1] > 0


def test_model_flops_per_chip_matches_the_reference():
    jax.devices()  # the backend starts before the reference's module
    old = os.environ.get("XLA_FLAGS")  # import sets its 512-device flag
    try:
        from repro.launch.dryrun import model_flops_per_chip as jmf
    finally:
        if old is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = old
    from repro.configs import ARCH_IDS
    from repro.configs import get_config as jget
    from repro_torch.configs import get_config

    for arch in ARCH_IDS:
        for shape in dryrun.SHAPES:
            for n in (256, 512):
                assert dryrun.model_flops_per_chip(get_config(arch), shape,
                                                   n) == \
                    jmf(jget(arch), shape, n)


# ---------------------------------------------------------- small names

def test_lm_input_specs_match_the_reference():
    from repro.data.tokens import lm_input_specs as jspecs
    from repro_torch.data.tokens import lm_input_specs

    for dt, jdt in ((torch.int32, np.int32), (torch.int64, np.int64)):
        got = lm_input_specs(4, 128, dtype=dt)
        want = jspecs(4, 128, dtype=jdt)
        assert list(got) == list(want)
        for k in want:
            assert got[k] == ((4, 128), dt)
            assert tuple(want[k].shape) == got[k][0]
            assert str(want[k].dtype) == str(dt).split(".")[1]
    assert lm_input_specs(2, 8) == {"tokens": ((2, 8), torch.int32),
                                    "labels": ((2, 8), torch.int32)}


def _grads(rng, steps):
    return [{"a": rng.standard_normal((5, 7)).astype(np.float32),
             "b": {"c": rng.standard_normal(11).astype(np.float32)}}
            for _ in range(steps)]


@pytest.mark.parametrize("name", ["sgd", "sgd-nesterov-wd", "adamw"])
@pytest.mark.parametrize("state", ["float32", "bfloat16"])
def test_optimizer_state_dtype_matches_the_reference(name, state):
    from repro.optim import sgd as js
    from repro_torch.optim import sgd as ts

    rng = np.random.default_rng(7)
    p0 = {"a": rng.standard_normal((5, 7)).astype(np.float32),
          "b": {"c": rng.standard_normal(11).astype(np.float32)}}
    grads = _grads(rng, 3)
    tdt, jdt = getattr(torch, state), getattr(jnp, state)
    if name == "adamw":
        jopt = js.adamw(lr=1e-2, state_dtype=jdt)
        topt = ts.adamw(lr=1e-2, state_dtype=tdt)
    else:
        kw = (dict(nesterov=True, weight_decay=0.01)
              if name == "sgd-nesterov-wd" else {})
        jopt = js.sgd_momentum(lr=0.05, momentum=0.9, momentum_dtype=jdt,
                               **kw)
        topt = ts.sgd_momentum(lr=0.05, momentum=0.9, momentum_dtype=tdt,
                               **kw)
    jp = jax.tree.map(jnp.asarray, p0)
    jstate = jopt.init(jp)
    tparams = tp.tree_map(lambda a: torch.from_numpy(a.copy()), p0)
    tstate = topt.init(tparams)
    assert all(t.dtype == tdt for t in tp.tree_leaves(tstate))
    for i, g in enumerate(grads):
        jp, jstate = jopt.update(jax.tree.map(jnp.asarray, g), jstate, jp,
                                 jnp.int32(i))
        tparams, tstate = topt.update(
            tp.tree_map(torch.from_numpy, g), tstate, tparams, step=i)
    for a, b in zip(tp.tree_leaves(tparams), jax.tree.leaves(jp)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-6)
    for a, b in zip(tp.tree_leaves(tstate), jax.tree.leaves(jstate)):
        assert a.dtype == tdt and str(b.dtype) == state
        got = a.float().numpy()
        want = np.asarray(b, np.float32)
        if state == "bfloat16":  # one bf16 ulp: 2^-7 of the magnitude
            tol = np.maximum(np.abs(want), 1e-30) * 2.0 ** -7
            assert (np.abs(got - want) <= tol).all()
        else:
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_fp32_state_update_is_unchanged_in_place():
    """The fp32 path still updates the state tensors it is given."""
    from repro_torch.optim.sgd import adamw, sgd_momentum

    for opt in (sgd_momentum(lr=0.1), adamw(lr=0.1)):
        p = {"w": torch.ones(3)}
        st = opt.init(p)
        before = [t for t in tp.tree_leaves(st)]
        _, st2 = opt.update({"w": torch.ones(3)}, st, p, step=0)
        assert all(a is b for a, b in zip(before, tp.tree_leaves(st2)))
        assert all(bool((t != 0).all()) for t in before)


def _trees(rng):
    a = {"x": rng.standard_normal((3, 4)).astype(np.float32),
         "y": {"z": rng.standard_normal(5).astype(np.float32)}}
    b = {"x": rng.standard_normal((3, 4)).astype(np.float32),
         "y": {"z": rng.standard_normal(5).astype(np.float32)}}
    return a, b


def _close(t, j, rtol=1e-6):
    tl = tp.tree_leaves(t) if isinstance(t, dict) else [t]
    jl = jax.tree.leaves(j)
    assert len(tl) == len(jl)
    for a, b in zip(tl, jl):
        np.testing.assert_allclose(a.float().numpy(),
                                   np.asarray(b, np.float32), rtol=rtol,
                                   atol=1e-6)


@pytest.mark.parametrize("helper", [
    "tree_add", "tree_sub", "tree_scale", "tree_axpy", "tree_zeros_like",
    "tree_dot", "tree_sq_norm", "tree_l2_norm", "tree_l2_dist",
    "tree_weighted_sum", "tree_stack", "tree_unstack", "tree_index",
    "tree_cast"])
def test_pytree_helper_matches_the_reference(helper):
    from repro.utils import pytree as jp

    a, b = _trees(np.random.default_rng(11))
    ta, tb = (tp.tree_map(torch.from_numpy, t) for t in (a, b))
    ja, jb = (jax.tree.map(jnp.asarray, t) for t in (a, b))
    args = {
        "tree_add": ((ta, tb), (ja, jb)),
        "tree_sub": ((ta, tb), (ja, jb)),
        "tree_scale": ((ta, 0.3), (ja, 0.3)),
        "tree_axpy": ((-1.5, ta, tb), (-1.5, ja, jb)),
        "tree_zeros_like": ((ta,), (ja,)),
        "tree_dot": ((ta, tb), (ja, jb)),
        "tree_sq_norm": ((ta,), (ja,)),
        "tree_l2_norm": ((ta,), (ja,)),
        "tree_l2_dist": ((ta, tb), (ja, jb)),
        "tree_weighted_sum": (([ta, tb, ta], [0.2, 0.5, -1.0]),
                              ([ja, jb, ja], [0.2, 0.5, -1.0])),
        "tree_stack": (([ta, tb],), ([ja, jb],)),
        "tree_index": ((tp.tree_stack([ta, tb]), 1),
                       (jp.tree_stack([ja, jb]), 1)),
        "tree_unstack": ((tp.tree_stack([ta, tb]), 2),
                         (jp.tree_stack([ja, jb]), 2)),
        "tree_cast": ((ta, torch.bfloat16), (ja, jnp.bfloat16)),
    }[helper]
    got = getattr(tp, helper)(*args[0])
    want = getattr(jp, helper)(*args[1])
    if helper == "tree_unstack":
        assert len(got) == len(want) == 2
        for g, w in zip(got, want):
            _close(g, w)
        return
    if isinstance(got, torch.Tensor):
        assert got.dim() == 0 and got.dtype == torch.float32
    _close(got, want)
    if helper == "tree_cast":
        assert all(t.dtype == torch.bfloat16 for t in tp.tree_leaves(got))
        for g, w in zip(tp.tree_leaves(got), jax.tree.leaves(want)):
            assert torch.equal(g.view(torch.int16), torch.from_numpy(
                np.asarray(w).view(np.int16)))


def test_tree_random_like_by_shape_dtype_and_scale():
    from repro.utils import pytree as jp

    proto = {"w": torch.zeros((200, 300)), "b": {"c": torch.zeros(
        (1000,), dtype=torch.bfloat16)}}
    jproto = {"w": jnp.zeros((200, 300)), "b": {"c": jnp.zeros(
        (1000,), jnp.bfloat16)}}
    got = tp.tree_random_like(torch.Generator().manual_seed(0), proto,
                              scale=0.25)
    want = jp.tree_random_like(jax.random.PRNGKey(0), jproto, scale=0.25)
    for g, w in zip(tp.tree_leaves(got), jax.tree.leaves(want)):
        assert tuple(g.shape) == tuple(w.shape)
        assert str(g.dtype).split(".")[1] == str(w.dtype)
        sg, sw = float(g.float().std()), float(np.asarray(w,
                                                          np.float32).std())
        assert abs(sg - 0.25) < 0.03 and abs(sw - 0.25) < 0.03
    again = tp.tree_random_like(torch.Generator().manual_seed(0), proto,
                                scale=0.25)
    assert all(torch.equal(a, b) for a, b in zip(tp.tree_leaves(got),
                                                 tp.tree_leaves(again)))
