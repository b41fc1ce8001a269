"""The LM DFL round partitioned inside each pod on the multi mesh
(pod, data, model), on the CPU.

`build_dfl_round(..., mesh=)` on a (pod, data, model) DeviceMesh: each pod
holds N / P nodes, placed on its (data, model) sub-mesh by
`dist.sharding.place_node_block`; each node's local step runs partitioned
there, the DecDiff gossip runs over "pod" on the local shards, and Eq. 5's
norm is split (`ops.decdiff_rows_split`).  Prefill and decode run on the
same mesh with the batch over ("pod", "data").  The shape is qwen1.5-0.5b
reduced to 2 layers, d_model 256 and vocab 2048, two nodes on a ring,
each with a batch of 4 x 32.

  * against the JAX package: four gloo ranks as (pod = 2, data = 1,
    model = 2) hold one round's loss and gossiped params to the
    reference's `build_dfl_round` jitted with `in_shardings` from its
    `dfl_node_axis` specs on four host devices (a subprocess with
    `XLA_FLAGS=--xla_force_host_platform_device_count=4` and Auto axes):
    fp32 and bf16 exchanges within 1e-5, the deterministic int8 exchange
    within 1e-4 plus one int8 grain;
  * against the port's unpartitioned round and steps, on the same ranks:
    the three rounds as above, prefill logits (1e-4 of the largest) and
    4 decode steps (logits, equal tokens); a (1, 1, 1) mesh is bitwise
    the unpartitioned round (fp32 and bf16) and the one-pod fused
    `build_dfl_round_shardmap` (int8), and bitwise the unpartitioned
    prefill and decode;
  * the plain split B.2 (`ops.decdiff_rows_split`) against
    `decdiff_rows_plain` within 1e-6 + 1e-5·Σ|terms| on a tree with
    replicated and sharded leaves cut over a (data = 2, model = 2)
    sub-mesh, each replicated leaf counted by one rank only; the flat
    spans; `Int8Codec` with `reduce_amax` on shards is the whole
    vector's int8, column for column; the node-block specs are the
    reference's `dfl_node_axis` specs without "pod";
  * `cuda`: the split B.2 against its plain version (skip here).

All ranks run in ONE `torch.multiprocessing.spawn` per module, with a
`FileStore` in the test's temporary directory; they import neither `jax`
nor `repro`.  torch runs on one thread in the ranks and two here.
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
from repro_torch.comm.codecs import Int8Codec  # noqa: E402
from repro_torch.kernels import decdiff_update as _dd  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.utils.pytree import tree_leaves, tree_map  # noqa: E402

torch.set_num_threads(min(2, torch.get_num_threads()))

ARCH = "qwen1.5-0.5b"
REDUCE = {"vocab": 2048}
NODES, BATCH, SEQ = 2, 4, 32
LR, DECODE_STEPS, CACHE_SLOTS = 0.1, 4, 16
MESH = (2, 1, 2)  # (pod, data, model)
EXCHANGES = ("fp32", "bf16", "int8")
SRC = os.path.join(os.path.dirname(__file__), os.pardir, "src")


# -------------------------------------------------------- shared helpers
# (module-level and free of jax: the spawned ranks import this module)

def _lm():
    from repro_torch.configs import get_config
    from repro_torch.models.lm import build_lm

    return build_lm(get_config(ARCH).reduced(**REDUCE))


def _exchange(name):
    return {"fp32": {}, "bf16": {"gossip_dtype": torch.bfloat16},
            "int8": {"codec": Int8Codec(stochastic=False)}}[name]


def _adjacency():
    return np.array([[0.0, 1.0], [1.0, 0.0]], np.float32)  # a 2-ring


def _inputs():
    """Two nodes' params (numpy [N, ...], the port's seeded init) and
    their batches [N, B, S]."""
    lm = _lm()
    gen = torch.Generator().manual_seed(0)
    nodes = [lm.init(gen, device="cpu") for _ in range(NODES)]
    rng = np.random.default_rng(0)
    return dict(
        params0=convert.params_to_numpy(
            tree_map(lambda *xs: torch.stack(xs), *nodes)),
        batch={k: rng.integers(0, REDUCE["vocab"], (NODES, BATCH, SEQ))
               .astype(np.int32) for k in ("tokens", "labels")})


def _round(name, inputs, mesh, shardmap=False):
    """One DFL round of exchange `name`: on `mesh` the caller's pod block,
    placed on its sub-mesh, else all nodes; the loss and the block's
    params (numpy) and the collectives the round issued."""
    from repro_torch.dist.dfl_step import (build_dfl_round,
                                           build_dfl_round_shardmap)
    from repro_torch.dist.sharding import full_tree, place_node_block
    from repro_torch.launch.comm_analysis import CollectiveCounter
    from repro_torch.launch.mesh import pod_axis
    from repro_torch.optim.sgd import sgd_momentum

    lm = _lm()
    opt = sgd_momentum(lr=LR, momentum=0.9)
    params = convert.params_from_numpy(inputs["params0"], device="cpu")
    batch = {k: torch.from_numpy(v.copy())
             for k, v in inputs["batch"].items()}
    if mesh is not None:
        n_pods, pod, _ = pod_axis(mesh)
        r = NODES // n_pods
        params = place_node_block(tree_map(
            lambda t: t[pod * r:(pod + 1) * r].contiguous(), params), mesh)
        batch = place_node_block({k: v[pod * r:(pod + 1) * r].contiguous()
                                  for k, v in batch.items()}, mesh,
                                 batch=True)
    if shardmap:
        step = build_dfl_round_shardmap(lm, opt, _adjacency(),
                                        **_exchange(name))
    else:
        step = build_dfl_round(lm, opt, _adjacency(), mesh=mesh,
                               **_exchange(name))
    with CollectiveCounter() as counter:
        new, _, loss = step(params, opt.init(params), 0, batch)
    return dict(loss=float(loss), collectives=counter.summary(),
                params=convert.params_to_numpy(full_tree(new)))


def _serve(inputs, mesh):
    """Prefill of node 0's batch and DECODE_STEPS greedy decode steps
    from node 0's params, on `mesh` (params replicated over "pod", the
    batch over ("pod", "data"), the cache by its specs) or whole."""
    from repro_torch.dist.dfl_step import build_prefill_step, build_serve_step
    from repro_torch.dist.sharding import (NODE_AXIS, distribute_tree,
                                           full_tree, make_batch_specs,
                                           make_cache_specs,
                                           make_param_specs)

    lm = _lm()
    dp = (NODE_AXIS, "data")

    def place(tree, specs):
        return tree if mesh is None else distribute_tree(
            tree, specs(tree, mesh), mesh)

    def batch_specs(tree, m):
        return make_batch_specs(tree, m, dp_axes=dp)

    params = place(convert.params_from_numpy(
        tree_map(lambda a: a[0], inputs["params0"]), device="cpu"),
        make_param_specs)
    batch = place({k: torch.from_numpy(v[0].copy())
                   for k, v in inputs["batch"].items()}, batch_specs)
    out = {"prefill": full_tree(build_prefill_step(lm, mesh=mesh)(
        params, batch)).numpy()}
    serve = build_serve_step(lm, mesh=mesh)
    cache = place(lm.init_cache(BATCH, CACHE_SLOTS, device="cpu"),
                  make_cache_specs)
    tok = torch.from_numpy(inputs["batch"]["tokens"][0, :, :1].copy())
    logits, tokens = [], []
    for _ in range(DECODE_STEPS):
        lg, cache = serve(params, cache, place({"t": tok}, batch_specs)["t"])
        lg = full_tree(lg)
        tok = torch.argmax(lg, dim=-1).to(torch.int32)
        logits.append(lg.numpy())
        tokens.append(tok.numpy())
    out["decode"], out["tokens"] = np.stack(logits), np.stack(tokens)
    return out


def _rank(rank, world_size, tmp):
    """One rank of the (2, 1, 2) mesh over gloo: the three rounds, then
    prefill and decode; results pickled to `tmp/rank<r>.pkl`."""
    import warnings

    from repro_torch.launch.mesh import make_host_mesh, pod_axis

    torch.set_num_threads(1)
    warnings.filterwarnings("ignore")  # DTensor's two-step all-reduce note
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(tmp, "store"), world_size),
        rank=rank, world_size=world_size)
    try:
        with open(os.path.join(tmp, "inputs.pkl"), "rb") as f:
            inputs = pickle.load(f)
        mesh = make_host_mesh(pod=MESH[0], data=MESH[1], model=MESH[2],
                              device_type="cpu")
        out = {name: _round(name, inputs, mesh) for name in EXCHANGES}
        out["serve"] = _serve(inputs, mesh)
        out["pod"] = pod_axis(mesh)[1]
        out["imported"] = sorted(k for k in sys.modules
                                 if k.split(".")[0] in ("jax", "repro"))
        with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


# The reference's round jitted with its dfl_node_axis specs, in a process
# of its own with four host devices (argv: the inputs' pickle, the
# output's).
_REFERENCE = r"""
import pickle, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType
from repro.comm.codecs import Int8Codec
from repro.configs import get_config
from repro.dist.dfl_step import build_dfl_round
from repro.dist.sharding import make_batch_specs, make_param_specs, named
from repro.launch.hlo_analysis import collective_bytes
from repro.models.lm import build_lm
from repro.optim.sgd import sgd_momentum

with open(sys.argv[1], "rb") as f:
    job = pickle.load(f)
lm = build_lm(get_config(job["arch"]).reduced(**job["reduce"]))
opt = sgd_momentum(lr=job["lr"], momentum=0.9)
mesh = jax.make_mesh(tuple(job["mesh"]), ("pod", "data", "model"),
                     axis_types=(AxisType.Auto,) * 3)
params = jax.tree.map(jnp.asarray, job["params0"])
batch = {k: jnp.asarray(v) for k, v in job["batch"].items()}
kinds = {"fp32": {}, "bf16": {"gossip_dtype": jnp.bfloat16},
         "int8": {"codec": Int8Codec(stochastic=False)}}
out = {"n_devices": len(jax.devices())}
with mesh:
    specs = named(make_param_specs(params, mesh, dfl_node_axis=True), mesh)
    b_specs = named(make_batch_specs(batch, mesh, dfl_node_axis=True), mesh)
    for name, kw in kinds.items():
        step = jax.jit(build_dfl_round(lm, opt, jnp.asarray(job["adj"]),
                                       **kw),
                       in_shardings=(specs, {"momentum": specs}, None,
                                     b_specs))
        args = (params, opt.init(params), jnp.int32(0), batch)
        if name == "fp32":
            out["collectives"] = collective_bytes(
                step.lower(*args).compile().as_text())
        p, _, loss = step(*args)
        out[name] = dict(loss=float(loss), params=jax.tree.map(
            lambda x: np.asarray(x, np.float32), p),
            shards=sorted({len(x.sharding.device_set)
                           for x in jax.tree.leaves(p)}))
with open(sys.argv[2], "wb") as f:
    pickle.dump(out, f)
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(inputs, the ranks' results, the reference's rounds or None, the
    port's unpartitioned rounds and steps)."""
    tmp = str(tmp_path_factory.mktemp("multimesh"))
    inputs = _inputs()
    with open(os.path.join(tmp, "inputs.pkl"), "wb") as f:
        pickle.dump(inputs, f)
    ref = None
    try:
        import jax  # noqa: F401
        job = os.path.join(tmp, "job.pkl")
        with open(job, "wb") as f:
            pickle.dump(dict(arch=ARCH, reduce=REDUCE, lr=LR, mesh=MESH,
                             adj=_adjacency(), **inputs), f)
        env = dict(os.environ, JAX_PLATFORMS="cpu",
                   XLA_FLAGS="--xla_force_host_platform_device_count=4",
                   PYTHONPATH=os.path.abspath(SRC))
        ref = subprocess.Popen(
            [sys.executable, "-c", _REFERENCE, job,
             os.path.join(tmp, "ref.pkl")], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    except ImportError:
        pass
    world = int(np.prod(MESH))
    mp.spawn(_rank, args=(world, tmp), nprocs=world, join=True)
    ranks = []
    for r in range(world):
        with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
            ranks.append(pickle.load(f))
    whole = {name: _round(name, inputs, None) for name in EXCHANGES}
    whole["serve"] = _serve(inputs, None)
    want = None
    if ref is not None:
        _, err = ref.communicate(timeout=300)
        assert ref.returncode == 0, err[-4000:]
        with open(os.path.join(tmp, "ref.pkl"), "rb") as f:
            want = pickle.load(f)
    return inputs, ranks, want, whole


def _grain(params):
    """One int8 grain of the largest node: max|w| / 127."""
    return max(float(np.abs(a).max()) for a in tree_leaves(params)) / 127.0


def _block_err(got, want, pod):
    """max |got - want| over the leaves, `got` a pod's block [R, ...] and
    `want` all nodes [N, ...]."""
    r = NODES // MESH[0]
    return max(float(np.abs(g - np.asarray(w)[pod * r:(pod + 1) * r]).max())
               for g, w in zip(tree_leaves(got), tree_leaves(want)))


def _tolerance(name, params):
    return 1e-4 + _grain(params) if name == "int8" else 1e-5


# ---------------------------------------------------- against the JAX package

@pytest.mark.parametrize("name", EXCHANGES)
def test_round_matches_the_references_partitioned_round(runs, name):
    inputs, ranks, want, _ = runs
    if want is None:
        pytest.skip("needs the JAX package")
    import jax

    assert want["n_devices"] == 4 and 4 in want[name]["shards"]
    ref = want[name]
    assert len(tree_leaves(inputs["params0"])) == len(
        jax.tree.leaves(ref["params"]))
    for got in ranks:
        assert abs(got[name]["loss"] - ref["loss"]) <= 1e-5
        err = max(float(np.abs(g - np.asarray(w)[got["pod"]:got["pod"] + 1])
                        .max()) for g, w in zip(
                            tree_leaves(got[name]["params"]),
                            jax.tree.leaves(ref["params"])))
        assert err <= _tolerance(name, inputs["params0"]), err


def test_collective_traffic_beside_the_references(runs):
    """The fp32 round's per-device collectives under the reference's keys:
    the port's (`launch/comm_analysis.py` around the round on each rank)
    and the reference's (`hlo_analysis.collective_bytes` of its compiled
    round).  The two partition differently, so their traffic is printed
    side by side, not held equal."""
    _, ranks, want, _ = runs
    got = [r["fp32"]["collectives"] for r in ranks]
    assert all(g == got[0] for g in got)
    g = got[0]
    # the pod all-gathers of the models and the loss, the sub-mesh's
    # all-reduces (the norm's sums among them)
    assert g["all-gather_count"] > 0 and g["all-reduce_count"] > 0
    print(f"\nport (2, 1, 2) fp32 round: {g}")
    if want is not None:
        print(f"reference (2, 1, 2) fp32 round: {want['collectives']}")
        assert want["collectives"]["total"] > 0


# ------------------------------------------ against the unpartitioned port

@pytest.mark.parametrize("name", EXCHANGES)
def test_round_matches_the_unpartitioned_round(runs, name):
    inputs, ranks, _, whole = runs
    for got in ranks:
        assert abs(got[name]["loss"] - whole[name]["loss"]) <= 1e-5
        assert _block_err(got[name]["params"], whole[name]["params"],
                          got["pod"]) <= _tolerance(name, inputs["params0"])


def test_prefill_and_decode_match_the_unpartitioned_step(runs):
    _, ranks, _, whole = runs
    want = whole["serve"]
    for got in ranks:
        g = got["serve"]
        assert g["prefill"].shape == want["prefill"].shape
        assert np.abs(g["prefill"] - want["prefill"]).max() <= \
            1e-4 * np.abs(want["prefill"]).max()
        assert g["decode"].shape == (DECODE_STEPS, BATCH, 1, REDUCE["vocab"])
        assert np.abs(g["decode"] - want["decode"]).max() <= \
            1e-4 * np.abs(want["decode"]).max()
        np.testing.assert_array_equal(g["tokens"], want["tokens"])


def test_ranks_import_neither_jax_nor_repro(runs):
    _, ranks, _, _ = runs
    assert len(ranks) == 4 and all(r["imported"] == [] for r in ranks)
    assert sorted(r["pod"] for r in ranks) == [0, 0, 1, 1]


def test_one_rank_mesh_is_bitwise_the_unpartitioned_round(tmp_path, runs):
    """A (1, 1, 1) mesh in this process: every collective is over one
    rank, every rank counts every leaf, so the round is the same bits as
    the unpartitioned round (fp32, bf16) and as the one-pod fused round
    (int8), and prefill and decode those of the unpartitioned steps."""
    from repro_torch.launch.mesh import make_host_mesh

    inputs, _, _, whole = runs
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        mesh = make_host_mesh(pod=1, device_type="cpu")
        got = {name: _round(name, inputs, mesh) for name in EXCHANGES}
        serve = _serve(inputs, mesh)
    finally:
        dist.destroy_process_group()
    fused = _round("int8", inputs, None, shardmap=True)
    for name in EXCHANGES:
        want = fused if name == "int8" else whole[name]
        assert got[name]["loss"] == want["loss"]
        for a, b in zip(tree_leaves(got[name]["params"]),
                        tree_leaves(want["params"])):
            np.testing.assert_array_equal(a, b)
    for key in ("prefill", "decode", "tokens"):
        np.testing.assert_array_equal(serve[key], whole["serve"][key])


def test_round_on_a_mesh_refuses_other_codecs():
    from repro_torch.comm.codecs import TopKCodec
    from repro_torch.dist.dfl_step import _mesh_gossip

    with pytest.raises(NotImplementedError, match="topk"):
        _mesh_gossip(None, None, 1.0, None, TopKCodec())


# ------------------------------------------------------ plain split forms

SUB = {"data": 2, "model": 2}


def _sub_tree():
    """A node block [R = 2, ...] with leaves the specs shard over both
    axes, over one, and none (small and 1-D leaves replicate)."""
    g = torch.Generator().manual_seed(3)
    return {"w_big": torch.randn(2, 256, 512, generator=g),
            "w_col": torch.randn(2, 3, 65536, generator=g),
            "norm": torch.randn(2, 256, generator=g),
            "bias": torch.randn(2, 7, generator=g).bfloat16()}


def _shard(t, spec, coord):
    """Rank `coord`'s (data, model) shard of `t` under `spec`."""
    for axis, c in zip(("data", "model"), coord):
        if axis in spec:
            t = torch.chunk(t, SUB[axis], dim=spec.index(axis))[c]
    return t.contiguous()


def _sub_specs(tree):
    from repro_torch.dist.sharding import node_block_specs

    return node_block_specs(tree, type("M", (), {"shape": {
        "pod": 2, **SUB}})())


@pytest.mark.parametrize("gate", [None, "half"])
def test_split_norm_plain_matches_the_unsplit_norm(gate):
    """Each rank of a (data = 2, model = 2) sub-mesh holds its shards and
    counts the leaves it shards, and the replicated ones only at
    coordinate 0 of the axes they are replicated over; the all-reduce of
    the ranks' sums is the whole models' sum, and every shard's step is
    its part of the unsplit step."""
    from repro_torch.dist.dfl_step import _counted_here, _leaf_spans

    x = _sub_tree()
    g = torch.Generator().manual_seed(4)
    avg = {k: v.float() + 0.3 * torch.randn(v.shape, generator=g)
           for k, v in x.items()}
    gt = None if gate is None else torch.tensor([1.0, 0.0])
    specs = _sub_specs(x)
    names = list(x)
    assert specs["w_big"] == (None, "data", "model")
    assert specs["w_col"] == (None, None, "model")
    assert specs["norm"] == specs["bias"] == (None, None)
    want = _dd.decdiff_rows_plain([x[k] for k in names],
                                  [avg[k] for k in names], gt, 1.0)
    want_sq = _dd.sumsq_rows_plain([x[k] for k in names],
                                   [avg[k] for k in names])
    coords = [(d, m) for d in range(2) for m in range(2)]

    def rank_view(coord):
        from torch.distributed.tensor import Replicate, Shard

        xs = [_shard(x[k], specs[k], coord) for k in names]
        avs = [_shard(avg[k], specs[k], coord) for k in names]
        pl = [[Shard(specs[k].index(a)) if a in specs[k] else Replicate()
               for a in SUB] for k in names]
        counted = [_counted_here(p, coord) for p in pl]
        return xs, avs, _leaf_spans(counted, [t[0].numel() for t in xs])

    views = {c: rank_view(c) for c in coords}
    sums = {c: _dd.sumsq_spans_plain(*views[c]) for c in coords}
    total = sum(sums.values())
    terms = sum(torch.sum(torch.square(avg[k] - x[k].float()),
                          dim=tuple(range(1, x[k].dim()))) for k in names)
    assert (torch.abs(total - want_sq) <= 1e-6 + 1e-5 * terms).all()
    # each replicated leaf enters once: counted on every rank it would be
    # four times in the total
    replicated = [k for k in names if all(a not in specs[k] for a in SUB)]
    assert all(sum(sp[0] == names.index(k) for c in coords
                   for sp in views[c][2]) == 1 for k in replicated)
    for c in coords:
        xs, avs, spans = views[c]
        got = ops.decdiff_rows_split(xs, avs, gt, 1.0, spans,
                                     lambda t: total.clone())
        for k, out in zip(names, got):
            ref = _shard(want[names.index(k)], specs[k], c)
            scale = 1.0 / (torch.sqrt(want_sq) + 1.0)
            d = (avs[names.index(k)] - xs[names.index(k)].float()).abs()
            tol = 1e-6 + 1e-5 * (xs[names.index(k)].float().abs()
                                 + scale.reshape((-1,) + (1,) * (d.dim() - 1))
                                 * d)
            if out.dtype == torch.bfloat16:  # one rounding of either side
                tol = tol + ref.float().abs() * 2.0 ** -8
            assert (torch.abs(out.float() - ref.float()) <= tol).all(), k
            if gt is not None:
                assert torch.equal(out[1], xs[names.index(k)][1])


def test_split_norm_with_every_span_is_bitwise_the_unsplit_step():
    x = _sub_tree()
    avg = {k: v.float() * 0.5 for k, v in x.items()}
    xs, avs = list(x.values()), list(avg.values())
    spans = [(i, 0, t[0].numel()) for i, t in enumerate(xs)]
    for a, b in zip(ops.decdiff_rows(xs, avs, None, 1.0),
                    ops.decdiff_rows_split(xs, avs, None, 1.0, spans,
                                           lambda t: t)):
        assert torch.equal(a, b)


def test_split_norm_into_its_inputs_is_the_same_step():
    """`out=` the xs themselves (the fused round's flat copy): the same
    bits as the new tensors, written into the xs; out unlike xs raises."""
    x = _sub_tree()
    avg = {k: v.float() * 0.5 for k, v in x.items()}
    xs, avs = list(x.values()), list(avg.values())
    spans = [(i, 0, t[0].numel()) for i, t in enumerate(xs)]
    want = ops.decdiff_rows_split(xs, avs, None, 1.0, spans, lambda t: t)
    into = [t.clone() for t in xs]
    got = ops.decdiff_rows_split(into, avs, None, 1.0, spans, lambda t: t,
                                 out=into)
    assert all(g is i for g, i in zip(got, into))
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    with pytest.raises(ValueError, match="out"):
        ops.decdiff_rows_split(xs, avs, None, 1.0, spans, lambda t: t,
                               out=[t.float() for t in xs])


def test_flat_spans_join_adjacent_counted_leaves():
    from repro_torch.dist.dfl_step import _flat_spans, _leaf_spans

    counted, widths = [True, True, False, True, False, True], [3, 4, 5, 6,
                                                                7, 8]
    assert _flat_spans(counted, widths) == [(0, 0, 7), (0, 12, 18),
                                            (0, 25, 33)]
    assert _flat_spans([True] * 3, [2, 2, 2]) == [(0, 0, 6)]
    assert _flat_spans([False, False], [2, 2]) == []
    assert _leaf_spans(counted, widths) == [(0, 0, 3), (1, 0, 4), (3, 0, 6),
                                            (5, 0, 8)]
    # a rank that counts nothing sums zeros, and still takes the step
    x, a = torch.ones(2, 3), torch.zeros(2, 3)
    (out,) = ops.decdiff_rows_split([x], [a], None, 1.0, [],
                                    lambda t: t + 3.0)
    assert torch.allclose(out, x - x / (3.0 ** 0.5 + 1.0))


def test_split_norm_checks_its_spans():
    x = torch.zeros(2, 5)
    with pytest.raises(ValueError, match="span"):
        ops.decdiff_rows_split([x], [x], None, 1.0, [(0, 2, 6)], lambda t: t)
    with pytest.raises(ValueError, match="span"):
        ops.decdiff_rows_split([x], [x], None, 1.0, [(1, 0, 2)], lambda t: t)
    with pytest.raises(TypeError):
        ops.decdiff_rows_split([x.double()], [x], None, 1.0, [], lambda t: t)


@pytest.mark.parametrize("shards", [2, 3])
def test_int8_shards_with_a_shared_amax_are_the_whole_vectors(shards):
    """Each shard encoded with the all-reduced amax gives the whole
    vector's scale and, column for column, its int8 values."""
    g = torch.Generator().manual_seed(shards)
    w = torch.randn(3, 301, generator=g) * torch.tensor([[1.0], [5.0],
                                                         [0.0]])
    codec = Int8Codec(stochastic=False)
    whole, _ = codec.encode(w)
    parts = torch.tensor_split(w, shards, dim=1)
    amax = torch.stack([torch.amax(p.abs(), dim=-1) for p in parts]).amax(0)
    got = [codec.encode(p, reduce_amax=lambda _: amax)[0] for p in parts]
    assert all(torch.equal(p["scale"], whole["scale"]) for p in got)
    assert torch.equal(torch.cat([p["q"] for p in got], dim=1), whole["q"])


def test_node_block_specs_are_the_references_without_pod():
    """`node_block_specs` = the reference's `make_param_specs` /
    `make_batch_specs` with `dfl_node_axis=True` on the multi mesh, the
    "pod" entry dropped."""
    jax = pytest.importorskip("jax")
    from repro.dist import sharding as jax_sharding
    from repro_torch.dist.sharding import node_block_specs

    mesh = type("M", (), {"shape": {"pod": 2, "data": 2, "model": 2}})()
    lm = _lm()
    params = tree_map(lambda t: torch.empty((2,) + tuple(t.shape),
                                            dtype=t.dtype, device="meta"),
                      lm.init(torch.Generator(), device="meta"))
    batch = {k: torch.empty((2, 4, 32), dtype=torch.int32, device="meta")
             for k in ("tokens", "labels")}

    def no_pod(spec):
        return tuple(None if e == "pod" else e for e in spec)

    for tree, batch_kind, ref in (
            (params, False, jax_sharding.make_param_specs),
            (batch, True, jax_sharding.make_batch_specs)):
        np_tree = tree_map(lambda t: np.empty(t.shape, np.float32)
                           if t.dtype.is_floating_point
                           else np.empty(t.shape, np.int32), tree)
        want = ref(np_tree, mesh, dfl_node_axis=True)
        got = node_block_specs(tree, mesh, batch=batch_kind)
        w_leaves = jax.tree.leaves(
            want, is_leaf=lambda s: type(s).__name__ == "PartitionSpec")
        g_leaves = _spec_leaves(got)
        assert len(w_leaves) == len(g_leaves) > 0
        assert all(tuple(g) == no_pod(w) for g, w in zip(g_leaves,
                                                         w_leaves))


def _spec_leaves(tree):
    if isinstance(tree, dict):  # in sorted keys, as jax.tree.leaves
        return [s for k in sorted(tree) for s in _spec_leaves(tree[k])]
    return [tree]


# ---------------------------------------------------------------- on a card

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["leaves", "flat", "flat_in_place"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_split_norm_kernels_match_their_plain_version(card, layout, dtype):
    """The split B.2 on the card (pass A over spans, rows ld apart, the
    scale kernel twice, pass B) against its plain version: the norms
    within 1e-5 relative, the step bitwise for the kernel's scale."""
    g = torch.Generator().manual_seed(5)
    if layout == "leaves":
        xs = [torch.randn(3, 4099, generator=g).to(dtype),
              torch.randn(3, 64, 33, generator=g).to(dtype)]
        spans = [(0, 0, 4099), (1, 0, 64 * 33)]
    else:
        xs = [torch.randn(2, 70001, generator=g).to(dtype)]
        spans = [(0, 0, 4096), (0, 5001, 70001), (0, 4099, 4100)]
    avgs = [x.float() + torch.randn(x.shape, generator=g) for x in xs]
    gate = torch.ones(xs[0].shape[0])
    gate[-1] = 0.0
    extra = torch.full((xs[0].shape[0],), 2.5)
    want = _dd.decdiff_rows_split_plain(xs, avgs, gate, 1.0, spans,
                                        lambda t: t + extra)
    xd = [x.to(card) for x in xs]
    got = ops.decdiff_rows_split(xd, [a.to(card) for a in avgs],
                                 gate.to(card), 1.0, spans,
                                 lambda t: t + extra.to(card),
                                 out=xd if layout == "flat_in_place" else None)
    sq_p = _dd.sumsq_spans_plain(xs, avgs, spans) + extra
    scale_p = 1.0 / (torch.sqrt(sq_p) + 1.0)
    for o, w, x, a in zip(got, want, xs, avgs):
        o = o.cpu()
        d = (a - x.float()).abs()
        tol = 1e-5 * scale_p.reshape((-1,) + (1,) * (d.dim() - 1)) * d \
            + 1e-6
        if dtype == torch.bfloat16:
            tol = tol + w.float().abs() * 2.0 ** -8
        assert (torch.abs(o.float() - w.float()) <= tol).all()
        assert torch.equal(o[-1], x[-1])  # the gated row keeps its model
