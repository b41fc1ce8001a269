"""The partitioned dense LM step on a (data, model) DeviceMesh, on the CPU.

`build_train_step`, `build_prefill_step` and `build_serve_step` with
`mesh=` run the dense family partitioned over `torch.distributed` ranks:
params, optimizer state, batch and cache placed as DTensors by the ported
specs, tensor parallelism over "model", the batch over "data",
vocab-parallel logits and loss.  The shape is qwen1.5-0.5b reduced to 2
layers, d_model 256 and vocab 2048 (at d_model 64 every leaf would sit
under the specs' small-leaf limit and replicate), batch 4 x 32.

  * against the JAX package: four gloo ranks as (data = 2, model = 2) hold
    one train step's loss and updated params within 1e-5 of the
    reference's step jitted with `in_shardings` from its specs on four
    host devices (a subprocess with `XLA_FLAGS=
    --xla_force_host_platform_device_count=4` and Auto axes);
  * against the port's unpartitioned step, on the same ranks: the train
    step (loss, params), prefill logits (1e-4 of the largest) and 4 decode
    steps (logits, equal tokens), also with `zero3_gather`,
    `residual_shard="batch_seq"` and `remat` (the layers replayed in the
    backward, as the dry run's train_4k), and a 128-token prefill through
    the chunked attention; a (1, 1) mesh is bitwise the unpartitioned
    step;
  * the plain split forms of B.3 (vocab-parallel statistics, their merge
    and the shard backward) and B.9 (partial scores, their sum, the
    softmax-combine) against their unsplit versions within
    1e-6 + 1e-5·Σ|terms|, at 2 and 16 shards;
  * two ranks as (data = 1, model = 2) over the host-staged backend
    (`dist/host_staging.py`, which path q runs on the card): the baseline
    steps against the unpartitioned step as above, and a coalesced
    all-reduce with MAX;
  * `launch/comm_analysis.py` against a hand count for one column- and
    one row-parallel linear on a fake (2, 2) group;
  * B.9's split plan: no batch size, W covered, shared memory in a block
    for the dense archs at model = 2 to 16;
  * `cuda`: the split kernels against their plain versions, a batch
    row's output bitwise that of the whole batch, and two calls bitwise
    (skip here).

All ranks run in ONE `torch.multiprocessing.spawn` per module, with a
`FileStore` in the test's temporary directory, as tests/test_torch_pods.py
does; they import neither `jax` nor `repro`.  torch runs on one thread in
the ranks and two here.
"""
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import decode_attention as _da  # noqa: E402
from repro_torch.kernels import vt_kl_loss as _vt  # noqa: E402
from repro_torch.utils.pytree import tree_leaves, tree_map  # noqa: E402

torch.set_num_threads(min(2, torch.get_num_threads()))

ARCH = "qwen1.5-0.5b"
REDUCE = {"vocab": 2048}
BATCH, SEQ, LONG_SEQ = 4, 32, 128
LR, DECODE_STEPS, CACHE_SLOTS = 0.1, 4, 16
VARIANTS = {"baseline": {}, "zero3": {"zero3_gather": True},
            "seqshard": {"residual_shard": "batch_seq"},
            "remat": {"remat": True}}
SRC = os.path.join(os.path.dirname(__file__), os.pardir, "src")


# -------------------------------------------------------- shared helpers
# (module-level and free of jax: the spawned ranks import this module)

def _lm(over=None):
    from repro_torch.configs import get_config
    from repro_torch.models.lm import build_lm

    return build_lm(get_config(ARCH).reduced(**REDUCE, **(over or {})))


def _inputs():
    """The params (numpy, from the port's seeded init) and the batches."""
    lm = _lm()
    params = lm.init(torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(0)
    v = lm.cfg.vocab
    return dict(
        params0=convert.params_to_numpy(params),
        batch={k: rng.integers(0, v, (BATCH, SEQ)).astype(np.int32)
               for k in ("tokens", "labels")},
        long={k: rng.integers(0, v, (BATCH, LONG_SEQ)).astype(np.int32)
              for k in ("tokens", "labels")})


def _steps(over, inputs, mesh):
    """One train step, prefill (and, on the baseline, the long prefill and
    DECODE_STEPS greedy decode steps) of the port, on `mesh` or whole."""
    from repro_torch.dist.dfl_step import (build_prefill_step,
                                           build_serve_step,
                                           build_train_step)
    from repro_torch.dist.sharding import (distribute_tree, full_tree,
                                           make_batch_specs,
                                           make_cache_specs,
                                           make_param_specs)
    from repro_torch.launch.comm_analysis import CollectiveCounter
    from repro_torch.optim.sgd import sgd_momentum

    lm = _lm(over)

    def params():
        p = convert.params_from_numpy(inputs["params0"], device="cpu")
        return p if mesh is None else distribute_tree(
            p, make_param_specs(p, mesh), mesh)

    def place(tree, specs_fn=make_batch_specs):
        tree = tree_map(torch.from_numpy, tree) if isinstance(
            next(iter(tree.values())), np.ndarray) else tree
        return tree if mesh is None else distribute_tree(
            tree, specs_fn(tree, mesh), mesh)

    out = {}
    opt = sgd_momentum(lr=LR, momentum=0.9)
    p = params()
    state, batch = opt.init(p), place(inputs["batch"])
    with CollectiveCounter() as counter:
        _, _, loss = build_train_step(lm, opt, mesh=mesh)(p, state, 0, batch)
    out["collectives"] = counter.summary()
    out["loss"] = float(loss)
    out["params"] = convert.params_to_numpy(full_tree(p))
    prefill = build_prefill_step(lm, mesh=mesh)
    out["prefill"] = full_tree(prefill(params(), place(
        inputs["batch"]))).numpy()
    if over:
        return out
    out["long"] = full_tree(prefill(params(), place(inputs["long"]))).numpy()
    serve = build_serve_step(lm, mesh=mesh)
    p = params()
    cache = place(lm.init_cache(BATCH, CACHE_SLOTS, device="cpu"),
                  make_cache_specs)
    tok = torch.from_numpy(inputs["batch"]["tokens"][:, :1].copy())
    logits, tokens = [], []
    for _ in range(DECODE_STEPS):
        lg, cache = serve(p, cache, place({"t": tok})["t"])
        lg = full_tree(lg)
        tok = torch.argmax(lg, dim=-1).to(torch.int32)
        logits.append(lg.numpy())
        tokens.append(tok.numpy())
    out["decode"], out["tokens"] = np.stack(logits), np.stack(tokens)
    return out


def _coalesced_values(rank):
    return [torch.tensor([1.0, -5.0]) * (rank + 1) * (-1) ** rank,
            torch.arange(3.0) * (10 - 9 * rank)]


def _coalesced_max(rank):
    """A coalesced all-reduce with MAX of two tensors of other sizes."""
    import warnings

    ts = _coalesced_values(rank)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the call's deprecation notice
        dist.all_reduce_coalesced(ts, op=dist.ReduceOp.MAX)
    return [t.numpy() for t in ts]


def _rank(rank, world_size, tmp):
    """One rank of the (data = 2, model = 2) mesh over gloo (every
    variant's steps), or of the (data = 1, model = 2) one over the
    host-staged backend (the baseline's); results pickled to
    `tmp/rank<r>.pkl`."""
    from repro_torch.dist import host_staging
    from repro_torch.launch.mesh import make_host_mesh

    torch.set_num_threads(1)
    staged = world_size == 2
    dist.init_process_group(
        host_staging.register() if staged else "gloo",
        store=dist.FileStore(os.path.join(tmp, "store"), world_size),
        rank=rank, world_size=world_size)
    try:
        with open(os.path.join(tmp, "inputs.pkl"), "rb") as f:
            inputs = pickle.load(f)
        mesh = make_host_mesh(data=world_size // 2, model=2,
                              device_type="cpu")
        out = {name: _steps(over, inputs, mesh)
               for name, over in VARIANTS.items()
               if not (staged and over)}
        if staged:
            out["coalesced_max"] = _coalesced_max(rank)
        out["imported"] = sorted(k for k in sys.modules
                                 if k.split(".")[0] in ("jax", "repro"))
        with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


# The reference's partitioned train step, in a process of its own with
# four host devices (argv: the inputs' pickle, the output's).
_REFERENCE = r"""
import pickle, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType
from repro.configs import get_config
from repro.dist.dfl_step import build_train_step
from repro.dist.sharding import make_batch_specs, make_param_specs, named
from repro.models.lm import build_lm
from repro.optim.sgd import sgd_momentum

with open(sys.argv[1], "rb") as f:
    job = pickle.load(f)
lm = build_lm(get_config(job["arch"]).reduced(**job["reduce"]))
opt = sgd_momentum(lr=job["lr"], momentum=0.9)
mesh = jax.make_mesh((2, 2), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)
params = jax.tree.map(jnp.asarray, job["params0"])
batch = {k: jnp.asarray(v) for k, v in job["batch"].items()}
with mesh:
    specs = named(make_param_specs(params, mesh), mesh)
    step = jax.jit(build_train_step(lm, opt), in_shardings=(
        specs, {"momentum": specs}, None,
        named(make_batch_specs(batch, mesh), mesh)))
    args = (params, opt.init(params), jnp.int32(0), batch)
    hlo = step.lower(*args).compile().as_text()
    p, _, loss = step(*args)
    shards = {len(x.sharding.device_set) for x in jax.tree.leaves(p)}
from repro.launch.hlo_analysis import collective_bytes
with open(sys.argv[2], "wb") as f:
    pickle.dump(dict(loss=float(loss), n_devices=len(jax.devices()),
                     shards=sorted(shards), collectives=collective_bytes(hlo),
                     params=jax.tree.map(lambda x: np.asarray(x, np.float32),
                                         p)), f)
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(inputs, the ranks' results, the reference's step or None, the
    port's unpartitioned steps by variant)."""
    tmp = str(tmp_path_factory.mktemp("partitioned"))
    inputs = _inputs()
    with open(os.path.join(tmp, "inputs.pkl"), "wb") as f:
        pickle.dump(inputs, f)
    ref = None
    try:
        import jax  # noqa: F401
        job = os.path.join(tmp, "job.pkl")
        with open(job, "wb") as f:
            pickle.dump(dict(arch=ARCH, reduce=REDUCE, lr=LR,
                             params0=inputs["params0"],
                             batch=inputs["batch"]), f)
        env = dict(os.environ, JAX_PLATFORMS="cpu",
                   XLA_FLAGS="--xla_force_host_platform_device_count=4",
                   PYTHONPATH=os.path.abspath(SRC))
        ref = subprocess.Popen(
            [sys.executable, "-c", _REFERENCE, job,
             os.path.join(tmp, "ref.pkl")], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    except ImportError:
        pass
    mp.spawn(_rank, args=(4, tmp), nprocs=4, join=True)
    ranks = []
    for r in range(4):
        with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
            ranks.append(pickle.load(f))
    staged = str(tmp_path_factory.mktemp("staged"))
    with open(os.path.join(staged, "inputs.pkl"), "wb") as f:
        pickle.dump(inputs, f)
    mp.spawn(_rank, args=(2, staged), nprocs=2, join=True)
    for r in range(2):
        with open(os.path.join(staged, f"rank{r}.pkl"), "rb") as f:
            ranks.append(pickle.load(f))
    whole = {name: _steps(over, inputs, None)
             for name, over in VARIANTS.items()}
    want = None
    if ref is not None:
        _, err = ref.communicate(timeout=300)
        assert ref.returncode == 0, err[-4000:]
        with open(os.path.join(tmp, "ref.pkl"), "rb") as f:
            want = pickle.load(f)
    return inputs, ranks, want, whole


def _max_err(a, b):
    return max(float(np.abs(x - y).max())
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


# ---------------------------------------------------- against the JAX package

def test_train_step_matches_the_references_partitioned_step(runs):
    _, ranks, want, _ = runs
    if want is None:
        pytest.skip("needs the JAX package")
    assert want["n_devices"] == 4 and 4 in want["shards"]
    for got in ranks[:4]:
        assert abs(got["baseline"]["loss"] - want["loss"]) <= 1e-5
        import jax

        errs = [float(np.abs(x - np.asarray(y)).max()) for x, y in zip(
            tree_leaves(got["baseline"]["params"]),
            jax.tree.leaves(want["params"]))]
        assert len(errs) == len(jax.tree.leaves(want["params"]))
        assert max(errs) <= 1e-5, errs


def test_collective_traffic_beside_the_references(runs):
    """The train step's per-device collectives under the reference's keys:
    the port's (`launch/comm_analysis.py` around the step on each rank;
    the dry run's fake group counts the same) and the reference's
    (`hlo_analysis.collective_bytes` of its compiled step).  The two
    partition differently (DTensor's redistributions against GSPMD's), so
    their traffic is printed side by side, not held equal; gloo on the CPU
    has no all-to-all, and DTensor moves a shard to another dim there by
    an all-gather."""
    from repro_torch.launch.comm_analysis import COLLECTIVE_OPS

    _, ranks, want, _ = runs
    got = [r["baseline"]["collectives"] for r in ranks[:4]]
    assert all(g == got[0] for g in got)  # every rank, the same traffic
    g = got[0]
    assert g["total"] == sum(g[k] for k in COLLECTIVE_OPS if k in g) > 0
    assert g["all-reduce_count"] > 0 and g["reduce-scatter_count"] > 0
    print(f"\nport (2, 2) train step: {g}")
    if want is not None:
        print(f"reference (2, 2) train step: {want['collectives']}")
        assert want["collectives"]["total"] > 0


# ------------------------------------------ against the unpartitioned port

@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_train_step_matches_the_unpartitioned_step(runs, variant):
    _, ranks, _, whole = runs
    for got in ranks:
        if variant not in got:  # the host-staged ranks run the baseline
            continue
        assert abs(got[variant]["loss"] - whole[variant]["loss"]) <= 1e-5
        assert _max_err(got[variant]["params"],
                        whole[variant]["params"]) <= 1e-5


@pytest.mark.parametrize("variant", sorted(VARIANTS) + ["long"])
def test_prefill_matches_the_unpartitioned_step(runs, variant):
    _, ranks, _, whole = runs
    key = "long" if variant == "long" else "prefill"
    name = "baseline" if variant == "long" else variant
    want = whole[name][key]
    for got in ranks:
        if name not in got:
            continue
        assert got[name][key].shape == want.shape
        assert np.abs(got[name][key] - want).max() <= \
            1e-4 * np.abs(want).max()


def test_decode_steps_match_the_unpartitioned_step(runs):
    _, ranks, _, whole = runs
    want = whole["baseline"]
    for got in ranks:
        g = got["baseline"]
        assert g["decode"].shape == (DECODE_STEPS, BATCH, 1,
                                     REDUCE["vocab"])
        assert np.abs(g["decode"] - want["decode"]).max() <= \
            1e-4 * np.abs(want["decode"]).max()
        np.testing.assert_array_equal(g["tokens"], want["tokens"])


def test_ranks_import_neither_jax_nor_repro(runs):
    _, ranks, _, _ = runs
    assert len(ranks) == 6 and all(r["imported"] == [] for r in ranks)


def test_host_staged_ranks_ran_the_baseline(runs):
    """The two ranks over the host-staged backend ran (1, 2)'s steps, held
    to the unpartitioned step by the tests above."""
    _, ranks, _, _ = runs
    assert [sorted(k for k in r if k not in ("imported", "coalesced_max"))
            for r in ranks[4:]] == [["baseline"]] * 2


def test_host_staged_coalesced_all_reduce_keeps_its_op(runs):
    """A coalesced MAX over the host-staged backend is the elementwise
    max of the ranks' tensors (not their sum)."""
    _, ranks, _, _ = runs
    want = [np.maximum(a.numpy(), b.numpy())
            for a, b in zip(_coalesced_values(0), _coalesced_values(1))]
    for r in ranks[4:]:
        for got, w in zip(r["coalesced_max"], want):
            np.testing.assert_array_equal(got, w)


def test_one_rank_mesh_is_bitwise_the_unpartitioned_step(tmp_path, runs):
    """A (1, 1) mesh in this process: every redistribution is the identity
    and the kernels' unsplit forms run, so the step is the same bits."""
    from repro_torch.launch.mesh import make_host_mesh

    inputs, _, _, whole = runs
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        got = _steps({}, inputs, make_host_mesh(device_type="cpu"))
    finally:
        dist.destroy_process_group()
    want = whole["baseline"]
    assert got["loss"] == want["loss"]
    assert _max_err(got["params"], want["params"]) == 0.0
    for key in ("prefill", "long", "decode", "tokens"):
        np.testing.assert_array_equal(got[key], want[key])


# ------------------------------------------------------- plain split forms

def _split_cols(z, n):
    return list(torch.chunk(z, n, dim=1))


@pytest.mark.parametrize("n", [2, 16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_vt_split_plain_matches_the_unsplit_loss(n, dtype):
    """B.3's vocab-parallel forms: each shard's partial statistics, merged
    as the all-reduces merge them, give the unsplit KL; each shard's
    backward gives its columns of the unsplit gradient."""
    g = torch.Generator().manual_seed(n)
    rows, vocab, beta = 24, 512, 0.98
    z = (torch.randn(rows, vocab, generator=g) * 3).to(dtype)
    labels = torch.randint(0, vocab, (rows,), generator=g)
    neg_h = -float(_vt_entropy(beta, vocab))
    kl, mx, sumexp = _vt.vt_forward_plain(z, labels, beta, neg_h)
    parts = [ops.vt_partial_stats(c.contiguous(), labels, i * vocab // n,
                                  vocab)
             for i, c in enumerate(_split_cols(z, n))]
    m, s, zs, zc = _vt.vt_combine(*(torch.stack(t) for t in zip(*parts)))
    got = _vt.vt_kl_from_stats(m, s, zs, zc, beta, neg_h, vocab)
    z32 = z.float()
    terms = z32.abs().sum(-1) + torch.log(sumexp).abs() + mx.abs() \
        + abs(neg_h)
    assert (torch.abs(got - kl) <= 1e-6 + 1e-5 * terms).all()
    assert torch.equal(m, mx)
    assert (torch.abs(s - sumexp) <= 1e-6 + 1e-5 * sumexp).all()
    assert torch.equal(zc, torch.gather(z32, 1, labels[:, None])[:, 0])
    gr = torch.rand(rows, generator=g)
    want = _vt.vt_backward_plain(z, labels, mx, sumexp, gr, beta).float()
    got = torch.cat([ops.vt_shard_backward(
        c.contiguous(), labels, i * vocab // n, m, s, gr, beta, vocab)
        for i, c in enumerate(_split_cols(z, n))], dim=1).float()
    tol = 1e-6 + 1e-5 * (torch.exp(z32 - mx[:, None]) / sumexp[:, None]
                         + beta) * gr[:, None]
    if dtype == torch.bfloat16:  # one rounding to bf16 of either side
        tol = tol + want.abs() * 2.0 ** -8
    assert (torch.abs(got - want) <= tol).all()


def _vt_entropy(beta, vocab):
    from repro_torch.core.virtual_teacher import teacher_entropy

    return teacher_entropy(beta, vocab)


def test_vt_split_forms_check_their_shard():
    z = torch.zeros(3, 8)
    labels = torch.zeros(3, dtype=torch.int64)
    with pytest.raises(ValueError, match="does not fit"):
        ops.vt_partial_stats(z, labels, 4, 10)
    with pytest.raises(TypeError):
        ops.vt_partial_stats(z, labels.int(), 0, 8)
    with pytest.raises(ValueError):
        ops.vt_shard_backward(z[:, :1].contiguous(), labels, 0, z[:, 0],
                              z[:, 0], z[:, 0], 0.9, 8)


@pytest.mark.parametrize("n", [2, 16])
@pytest.mark.parametrize("case", ["full", "ring-masked", "window"])
def test_decode_split_plain_matches_the_unsplit_attention(n, case):
    """B.9's split-hd forms at hd 64: the shards' partial scores summed
    over the shards, then each shard's softmax-combine, give the unsplit
    attention's columns of its output."""
    g = torch.Generator().manual_seed(n)
    b, h, kk, w, hd = 3, 8, 4, 40, 64
    q = torch.randn(b, h, hd, generator=g)
    k = torch.randn(b, w, kk, hd, generator=g)
    v = torch.randn(b, w, kk, hd, generator=g)
    slot_pos = torch.arange(w, dtype=torch.int32)
    pos = torch.tensor(w - 1, dtype=torch.int32)
    window = 0
    if case == "ring-masked":
        slot_pos[w // 2:] = -1
        pos = torch.tensor(w // 2 - 1, dtype=torch.int32)
    elif case == "window":
        window = 9
    want = _da.decode_attention_plain(q, k, v, slot_pos, pos, window)
    qs, ks, vs = (list(torch.chunk(t, n, dim=-1)) for t in (q, k, v))
    scale = 1.0 / hd ** 0.5
    parts = [ops.decode_scores_partial(a.contiguous(), c.contiguous(),
                                       scale) for a, c in zip(qs, ks)]
    scores = torch.stack(parts).sum(0)
    got = torch.cat([ops.decode_softmax_combine(scores, c.contiguous(),
                                                slot_pos, pos, window)
                     for c in vs], dim=-1)
    terms = torch.einsum("bkgw,bwkd->bkgd",
                         torch.ones(b, kk, h // kk, w), v.abs()).reshape(
                             b, h, hd)
    assert (torch.abs(got - want) <= 1e-6 + 1e-5 * terms).all()


def test_decode_split_forms_check_their_inputs():
    q = torch.zeros(2, 4, 8)
    k = torch.zeros(2, 5, 3, 8)
    with pytest.raises(ValueError, match="dividing H"):
        ops.decode_scores_partial(q, k, 1.0)
    with pytest.raises(ValueError):
        ops.decode_softmax_combine(torch.zeros(2, 4, 5), torch.zeros(
            2, 6, 2, 8), torch.zeros(5, dtype=torch.int32),
            torch.tensor(0, dtype=torch.int32))
    with pytest.raises(TypeError):
        ops.decode_softmax_combine(torch.zeros(2, 4, 5), torch.zeros(
            2, 5, 2, 8), torch.zeros(5, dtype=torch.int64),
            torch.tensor(0, dtype=torch.int32))


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "deepseek-7b",
                                  "qwen2.5-14b", "qwen3-32b",
                                  "mixtral-8x7b", "arctic-480b"])
@pytest.mark.parametrize("model", [2, 4, 8, 16])
def test_decode_split_plan_covers_w_and_fits_a_block(arch, model):
    """B.9's split plan takes no batch size (a row's output is then
    bitwise the same at any B); its scores blocks and combine splits cover
    W in whole stages with none empty, and each kernel's shared memory
    fits a block (227 KB) and the combine's columns its threads, for the
    dense and MoE archs' hd split over "model" (mixtral's G = 4 and
    arctic's G = 7 at hd 128), bf16 and fp32, from a W below one stage to
    2^19 slots, on 132 and 114 SMs."""
    import inspect

    from repro_torch.configs import get_config

    assert list(inspect.signature(_da.split_plan).parameters) == [
        "w", "kk", "g", "hdl", "kv_bytes", "sms"]
    cfg = get_config(arch)
    kk, g = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads
    hdl = cfg.head_dim // model
    assert kk * g <= _da.SPLIT_THREADS
    assert _da.combine_by_head(g, hdl) \
        or _da.combine_columns(kk, g, hdl)[2] <= _da.SPLIT_THREADS
    for kv_bytes in (2, 4):
        for w in (1, 5, 777, 4096, 32768, 32769, 1 << 19):
            for sms in (132, 114):
                p = _da.split_plan(w, kk, g, hdl, kv_bytes, sms)
                assert p.per_block % p.tile == 0 and p.per_split % p.chunk == 0
                assert p.blocks * p.per_block >= w \
                    > (p.blocks - 1) * p.per_block
                assert p.splits * p.per_split >= w \
                    > (p.splits - 1) * p.per_split
                assert max(p.scores_smem,
                           p.combine_smem) <= _da.SMEM_LIMIT, p


# ----------------------------------------------------------- comm_analysis

def test_comm_analysis_counts_a_column_and_a_row_parallel_linear():
    """On a fake (data = 2, model = 2) group, y = (x @ w1) @ w2 with x
    [8, 64] batch-split over data, w1 [64, 128] split over data by rows
    and over model by columns, w2 [128, 64] over model by rows and over
    data by columns: each is all-gathered over data and used as "model"
    splits it (column-, then row-parallel), and one all-reduce over model
    settles w2's partial sums.
    Each device's operand bytes, by hand: the all-gathers their inputs
    (w1's [32, 64] shard, w2's [64, 32] shard), the all-reduce its
    input ([4, 64] fp32)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.dist.constraints import use_mesh
    from repro_torch.launch.comm_analysis import (COLLECTIVE_OPS,
                                                  CollectiveCounter,
                                                  collective_bytes)
    from repro_torch.launch.dryrun import fake_mesh
    from repro_torch.models.lm.layers import linear

    with fake_mesh((2, 2), ("data", "model")) as mesh, \
            FakeTensorMode(allow_non_fake_inputs=True):
        x = distribute_tensor(torch.zeros(8, 64), mesh,
                              [Shard(0), Replicate()])
        w1 = distribute_tensor(torch.zeros(64, 128), mesh,
                               [Shard(0), Shard(1)])
        w2 = distribute_tensor(torch.zeros(128, 64), mesh,
                               [Shard(1), Shard(0)])

        def step():
            with use_mesh(mesh):
                return linear(linear(x, {"w": w1}), {"w": w2})

        got = collective_bytes(step)
        with CollectiveCounter() as counter:
            y = step()
        assert tuple(y.placements) == (Shard(0), Replicate())
    assert counter.summary() == got
    assert got == {"total": 32 * 64 * 4 + 64 * 32 * 4 + 4 * 64 * 4,
                   "all-gather": 32 * 64 * 4 + 64 * 32 * 4,
                   "all-gather_count": 2,
                   "all-reduce": 4 * 64 * 4, "all-reduce_count": 1}
    assert set(COLLECTIVE_OPS) >= {k for k in got if "_" not in k
                                   and k != "total"}


# ---------------------------------------------------------------- on a card

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(24, 512, 0), (24, 512, 256),
                                   (7, 75968, 75968), (5, 9496, 9496 * 3)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_vt_split_kernels_match_their_plain_versions(card, shape, dtype):
    rows, v, offset = shape
    vocab = max(2 * v, offset + v)
    g = torch.Generator().manual_seed(rows)
    z = (torch.randn(rows, v, generator=g) * 3).to(dtype)
    labels = torch.randint(0, vocab, (rows,), generator=g)
    labels[0] = offset  # one label in the shard at least
    want = _vt.vt_partial_plain(z, labels, offset)
    got = ops.vt_partial_stats(z.to(card), labels.to(card), offset, vocab)
    z32 = z.float()
    for a, b, tol in zip(got, want, (0.0, 1e-5, 1e-5, 0.0)):
        b_scale = 1e-6 + tol * (z32.abs().sum(-1) if b is want[2]
                                else b.abs())
        assert (torch.abs(a.cpu() - b) <= b_scale).all()
    gr = torch.rand(rows, generator=g)
    mx, s = want[0], want[1] * 1.5
    dz = ops.vt_shard_backward(z.to(card), labels.to(card), offset,
                               mx.to(card), s.to(card), gr.to(card), 0.98,
                               vocab)
    ref = _vt.vt_shard_backward_plain(z, labels, offset, mx, s, gr, 0.98,
                                      vocab).float()
    tol = 1e-6 + 1e-5 * ref.abs()
    if dtype == torch.bfloat16:
        tol = tol + ref.abs() * 2.0 ** -8
    assert (torch.abs(dz.cpu().float() - ref) <= tol).all()


def _split_inputs(shape, dtype, dev):
    """q [B, H, hd], k and v [B, W, K, hd] from a seeded generator, slot_pos
    with a third of W masked, and pos."""
    b, w, h, kk, hd = shape
    g = torch.Generator().manual_seed(w)
    q = torch.randn(b, h, hd, generator=g).to(dtype)
    k = torch.randn(b, w, kk, hd, generator=g).to(dtype)
    v = torch.randn(b, w, kk, hd, generator=g).to(dtype)
    slot_pos = torch.arange(w, dtype=torch.int32)
    slot_pos[w // 3:w // 2] = -1
    pos = torch.tensor(w - 2, dtype=torch.int32)
    return tuple(t.to(dev) for t in (q, k, v, slot_pos, pos))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [
    (8, 4096, 16, 16, 4), (3, 40, 8, 4, 32), (2, 1000, 64, 8, 64),
    (2, 1000, 40, 8, 64),  # qwen2.5-14b's G = 5 at hdl 64
    (3, 777, 16, 16, 32),  # a W that no stage or split divides
    (2, 5, 16, 16, 32),    # a W below one stage
    (4, 2048, 32, 32, 8), (4, 1500, 64, 8, 16),  # hdl 8 and 16
    (2, 1000, 64, 8, 8)])  # qwen3-32b's G = 8 at hdl 8
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_split_kernels_match_their_plain_versions(card, shape,
                                                         dtype):
    b, w, h, kk, hd = shape
    q, k, v, slot_pos, pos = _split_inputs(shape, dtype, "cpu")
    want = _da.scores_partial_plain(q, k, 0.125)
    got = ops.decode_scores_partial(q.to(card), k.to(card), 0.125).cpu()
    terms = 0.125 * torch.einsum("bkgd,bwkd->bkgw", q.float().abs().reshape(
        b, kk, h // kk, hd), k.float().abs()).reshape(b, h, w)
    assert (torch.abs(got - want) <= 1e-6 + 1e-5 * terms).all()
    masked = torch.full_like(slot_pos, -1)  # every slot: uniform weights
    for sp, window in ((slot_pos, 0), (slot_pos, 17), (masked, 0)):
        want = _da.softmax_combine_plain(got, v, sp, pos, window)
        out = ops.decode_softmax_combine(got.to(card), v.to(card),
                                         sp.to(card), pos.to(card),
                                         window).cpu()
        vt = v.float().abs().amax(dim=1).repeat_interleave(h // kk, 1)
        assert (torch.abs(out - want) <= 1e-6 + 1e-5 * vt).all()


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8, 4096, 16, 16, 4),
                                   (8, 3000, 64, 8, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_split_rows_are_bitwise_across_batch_sizes(card, shape,
                                                          dtype):
    """A batch row's scores and combine, computed alone, are bitwise that
    row of the whole batch's: the kernels' plan sees no B."""
    b = shape[0]
    q, k, v, slot_pos, pos = _split_inputs(shape, dtype, card)
    s = ops.decode_scores_partial(q, k, 0.125)
    out = ops.decode_softmax_combine(s, v, slot_pos, pos, 17)
    for r in (0, b - 1):
        one = slice(r, r + 1)
        s1 = ops.decode_scores_partial(q[one].contiguous(),
                                       k[one].contiguous(), 0.125)
        assert torch.equal(s1, s[one])
        o1 = ops.decode_softmax_combine(s[one].contiguous(),
                                        v[one].contiguous(), slot_pos, pos,
                                        17)
        assert torch.equal(o1, out[one])


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8, 4096, 16, 16, 4),
                                   (8, 3000, 64, 8, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_split_kernels_are_bitwise_repeatable(card, shape, dtype):
    """Two calls give the same bits: every sum runs in a fixed order."""
    q, k, v, slot_pos, pos = _split_inputs(shape, dtype, card)
    s = ops.decode_scores_partial(q, k, 0.125)
    out = ops.decode_softmax_combine(s, v, slot_pos, pos)
    assert torch.equal(ops.decode_scores_partial(q, k, 0.125), s)
    assert torch.equal(ops.decode_softmax_combine(s, v, slot_pos, pos), out)
