"""The partitioned enc-dec and VLM steps on the (data, model) and (pod,
data, model) meshes, on the CPU.

`build_train_step`, `build_prefill_step`, `build_prep_cache_step`,
`build_serve_step` and `build_dfl_round(..., mesh=)` run whisper (the
enc-dec family) and llava (the VLM) partitioned over `torch.distributed`
ranks: params, optimizer state, batch and cache placed as DTensors by the
specs.  The encoder, the decoder and the VLM's trunk run on the dense
layers (heads over "model", vocab-parallel embedding and logits); the
cross K / V come out of column-parallel projections in the decoder q's
head layout; `build_prep_cache_step` returns the cross caches in the
cache specs' placements (B over "data", hd over "model"), and a decode
step's cross-attention reads them in place through the split-hd kernels
(their plain versions here).  The shapes are whisper-large-v3 reduced to
2 + 2 layers of 4 heads of 64 (MHA, as the real model), llava reduced to
2 layers (4 heads, 2 kv heads) with 16 image tokens, vocab 512; whisper's
batch is 4 x 32 decoder tokens after 96 encoder frames (the encoder's
attention in chunks), llava's 4 x 48 text tokens after its 16 image
tokens (16 is no shard edge of the 64 positions).

  * against the JAX package: four gloo ranks as (data = 2, model = 2) hold
    one train step's loss and params within 1e-5 and the forward's logits
    within 1e-4 of the largest of the reference's step jitted with its
    specs on four host devices (a subprocess with `XLA_FLAGS=
    --xla_force_host_platform_device_count=4` and Auto axes);
  * against the port's unpartitioned step, on the same ranks: train step,
    prefill, the cross caches (whisper) and 4 decode steps of both models,
    with `remat`, `zero3_gather` and `residual_shard="batch_seq"`; whisper
    with 3 heads (the heads do not divide "model": attention whole, the
    caches split over hd, as at the dry run's model = 16) and with a
    vocabulary of 511 (the logits whole); a (1, 1) mesh is bitwise the
    unpartitioned step, at two threads;
  * the multi mesh (pod = 2, data = 1, model = 2) on the same ranks: one
    DFL round of two whisper nodes (the batch carries `enc_embeds`)
    against the reference's `build_dfl_round` jitted with its
    `dfl_node_axis` specs (fp32 within 1e-5, the deterministic int8
    exchange within 1e-4 plus one int8 grain) and against the port's
    unpartitioned round; prefill with the batch over ("pod", "data") and
    4 decode steps with the tokens over "data", as the dry run places
    them, against the unpartitioned steps;
  * the specs of every whisper / llava leaf, node block and cache entry
    against the reference's; every registered arch's step builders take
    a mesh;
  * `cuda`: the split B.9 at whisper's shapes (hdl 32, K = 20, G = 1,
    1500 live slots) and llava's (hdl 64, K = 8, G = 4), and the split
    B.3 at shards of 25933 and 16000 columns, against their plain
    versions (skip here).

All ranks run in ONE `torch.multiprocessing.spawn`, with a `FileStore` in
the test's temporary directory; they import neither `jax` nor `repro`.
torch runs on one thread in the ranks and two here.
"""
import contextlib
import os
import pickle
import subprocess
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.comm.codecs import Int8Codec  # noqa: E402
from repro_torch.utils.pytree import tree_leaves, tree_map  # noqa: E402

torch.set_num_threads(min(2, torch.get_num_threads()))

ARCHS = {"whisper": ("whisper-large-v3", {"n_kv_heads": 4}),
         "llava": ("llava-next-mistral-7b", {})}
VOCAB, ODD_VOCAB = 512, 511
BATCH, SEQ = 4, 32                     # whisper's decoder tokens
ENC_LEN, TEXT = 96, 48                 # whisper's frames, llava's text
LR, DECODE_STEPS, CACHE_SLOTS = 0.1, 4, 16
VARIANTS = {"whisper": ("whisper", {}), "llava": ("llava", {}),
            "whisper+remat": ("whisper", {"remat": True}),
            "llava+remat": ("llava", {"remat": True}),
            "whisper+zero3": ("whisper", {"zero3_gather": True}),
            "llava+zero3": ("llava", {"zero3_gather": True}),
            "whisper+seqshard": ("whisper", {"residual_shard": "batch_seq"}),
            "llava+seqshard": ("llava", {"residual_shard": "batch_seq"}),
            "whisper+oddheads": ("whisper", {"n_heads": 3, "n_kv_heads": 3}),
            "whisper+oddvocab": ("whisper", {"vocab": ODD_VOCAB})}
OWN_PARAMS = ("whisper+oddheads", "whisper+oddvocab")
MULTI, NODES, EXCHANGES = (2, 1, 2), 2, ("fp32", "int8")
SRC = os.path.join(os.path.dirname(__file__), os.pardir, "src")


# -------------------------------------------------------- shared helpers
# (module-level and free of jax: the spawned ranks import this module)

def _lm(name, over=None):
    from repro_torch.configs import get_config
    from repro_torch.models.lm import build_lm

    arch, reduce = ARCHS[name]
    return build_lm(get_config(arch).reduced(**dict(reduce, **(over or {}))))


def _batch(rng, name, lead=()):
    """The model's batch (numpy): tokens and labels below the odd
    vocabulary, and whisper's encoder frames or llava's image
    embeddings."""
    cfg = _lm(name).cfg
    s = SEQ if name == "whisper" else TEXT
    out = {k: rng.integers(0, ODD_VOCAB, lead + (BATCH, s)).astype(np.int32)
           for k in ("tokens", "labels")}
    key, n = (("enc_embeds", ENC_LEN) if name == "whisper"
              else ("img_embeds", cfg.img_tokens))
    out[key] = rng.standard_normal(lead + (BATCH, n, cfg.d_model)).astype(
        np.float32)
    return out


def _inputs():
    """The params (numpy, from the port's seeded init: per model and per
    variant whose shapes differ, and two whisper nodes stacked) and the
    batches."""
    rng = np.random.default_rng(0)
    gen = torch.Generator().manual_seed(0)
    params = {name: convert.params_to_numpy(_lm(name).init(gen,
                                                           device="cpu"))
              for name in ARCHS}
    for variant in OWN_PARAMS:
        name, over = VARIANTS[variant]
        params[variant] = convert.params_to_numpy(
            _lm(name, over).init(gen, device="cpu"))
    nodes = [_lm("whisper").init(gen, device="cpu") for _ in range(NODES)]
    return dict(params=params, nodes0=convert.params_to_numpy(
        tree_map(lambda *xs: torch.stack(xs), *nodes)),
        batch={name: _batch(rng, name) for name in ARCHS},
        nodes_batch=_batch(rng, "whisper", (NODES,)))


def _params_of(inputs, variant):
    return inputs["params"][variant if variant in inputs["params"]
                            else VARIANTS[variant][0]]


def _steps(variant, inputs, mesh):
    """One train step (and its collectives), the forward's logits and
    DECODE_STEPS greedy decode steps (after the cross caches), on `mesh`
    or whole."""
    from repro_torch.dist.dfl_step import (build_prefill_step,
                                           build_train_step)
    from repro_torch.dist.sharding import (distribute_tree, full_tree,
                                           make_batch_specs,
                                           make_param_specs)
    from repro_torch.launch.comm_analysis import CollectiveCounter
    from repro_torch.optim.sgd import sgd_momentum

    name, over = VARIANTS[variant]
    lm = _lm(name, over)

    def params():
        p = convert.params_from_numpy(_params_of(inputs, variant),
                                      device="cpu")
        return p if mesh is None else distribute_tree(
            p, make_param_specs(p, mesh), mesh)

    def place(tree, specs_fn=make_batch_specs):
        tree = {k: torch.from_numpy(v.copy()) if isinstance(v, np.ndarray)
                else v for k, v in tree.items()}
        return tree if mesh is None else distribute_tree(
            tree, specs_fn(tree, mesh), mesh)

    opt = sgd_momentum(lr=LR, momentum=0.9)
    p = params()
    state = opt.init(p)
    batch = inputs["batch"][name]
    with CollectiveCounter() as counter:
        _, _, loss = build_train_step(lm, opt, mesh=mesh)(
            p, state, 0, place(batch))
    out = dict(collectives=counter.summary(), loss=float(loss),
               params=convert.params_to_numpy(full_tree(p)))
    logits = build_prefill_step(lm, mesh=mesh)(params(), place(batch))
    out["logits"] = full_tree(logits).numpy()
    out.update(_decode(lm, params(), batch, mesh, place))
    return out


def _decode(lm, params, batch, mesh, place):
    """The cross caches from the batch's frames (whisper), then
    DECODE_STEPS greedy steps from the batch's first tokens."""
    from repro_torch.dist.dfl_step import (build_prep_cache_step,
                                           build_serve_step)
    from repro_torch.dist.sharding import full_tree, make_cache_specs

    serve = build_serve_step(lm, mesh=mesh)
    cache = place(lm.init_cache(BATCH, CACHE_SLOTS, device="cpu"),
                  make_cache_specs)
    out = {}
    if lm.prep_decode_cache is not None:
        frames = place({"e": batch["enc_embeds"]})["e"]
        cache = build_prep_cache_step(lm, mesh=mesh)(params, cache, frames)
        out["cross"] = {k: full_tree(cache[k]).numpy()
                        for k in ("cross_k", "cross_v")}
        if mesh is not None:
            out["cross_placements"] = [tuple(cache[k].placements)
                                       for k in ("cross_k", "cross_v")]
    tok = torch.from_numpy(batch["tokens"][:, :1].copy())
    logits, tokens = [], []
    with _calls_of("decode_scores_partial") as split:
        for _ in range(DECODE_STEPS):
            lg, cache = serve(params, cache, place({"t": tok})["t"])
            lg = full_tree(lg)
            tok = torch.argmax(lg, dim=-1).to(torch.int32)
            logits.append(lg.numpy())
            tokens.append(tok.numpy())
    out.update(decode=np.stack(logits), tokens=np.stack(tokens),
               split_calls=split[0])
    return out


@contextlib.contextmanager
def _calls_of(name):
    """Count the calls of `ops.<name>` in the block (the plain versions
    count no launch on the CPU): a list of one count."""
    from repro_torch.kernels import ops

    real, count = getattr(ops, name), [0]

    def counted(*args, **kw):
        count[0] += 1
        return real(*args, **kw)

    setattr(ops, name, counted)
    try:
        yield count
    finally:
        setattr(ops, name, real)


def _exchange(name):
    return {"fp32": {}, "int8": {"codec": Int8Codec(stochastic=False)}}[name]


def _adjacency():
    return np.array([[0.0, 1.0], [1.0, 0.0]], np.float32)  # a 2-ring


def _round(name, inputs, mesh):
    """One DFL round of two whisper nodes: on the multi `mesh` the
    caller's pod block, placed on its sub-mesh, else both nodes."""
    from repro_torch.dist.dfl_step import build_dfl_round
    from repro_torch.dist.sharding import full_tree, place_node_block
    from repro_torch.launch.comm_analysis import CollectiveCounter
    from repro_torch.launch.mesh import pod_axis
    from repro_torch.optim.sgd import sgd_momentum

    lm = _lm("whisper")
    opt = sgd_momentum(lr=LR, momentum=0.9)
    params = convert.params_from_numpy(inputs["nodes0"], device="cpu")
    batch = {k: torch.from_numpy(v.copy())
             for k, v in inputs["nodes_batch"].items()}
    if mesh is not None:
        n_pods, pod, _ = pod_axis(mesh)
        r = NODES // n_pods
        params = place_node_block(tree_map(
            lambda t: t[pod * r:(pod + 1) * r].contiguous(), params), mesh)
        batch = place_node_block({k: v[pod * r:(pod + 1) * r].contiguous()
                                  for k, v in batch.items()}, mesh,
                                 batch=True)
    step = build_dfl_round(lm, opt, _adjacency(), mesh=mesh,
                           **_exchange(name))
    with CollectiveCounter() as counter:
        new, _, loss = step(params, opt.init(params), 0, batch)
    return dict(loss=float(loss), collectives=counter.summary(),
                params=convert.params_to_numpy(full_tree(new)))


def _serve_multi(name, inputs, mesh):
    """Prefill (the batch over ("pod", "data") on `mesh`), the cross
    caches and DECODE_STEPS decode steps with the tokens and frames over
    "data" (the dry run's placement), on the multi `mesh` or whole."""
    from repro_torch.dist.dfl_step import build_prefill_step
    from repro_torch.dist.sharding import (NODE_AXIS, distribute_tree,
                                           full_tree, make_batch_specs,
                                           make_param_specs)

    lm = _lm(name)

    def place(tree, specs=make_batch_specs, **kw):
        tree = {k: torch.from_numpy(v.copy()) if isinstance(v, np.ndarray)
                else v for k, v in tree.items()}
        return tree if mesh is None else distribute_tree(
            tree, specs(tree, mesh, **kw), mesh)

    params = convert.params_from_numpy(inputs["params"][name], device="cpu")
    if mesh is not None:
        params = distribute_tree(params, make_param_specs(params, mesh),
                                 mesh)
    batch = inputs["batch"][name]
    logits = build_prefill_step(lm, mesh=mesh)(params, place(
        batch, dp_axes=(NODE_AXIS, "data")))
    out = {"prefill": full_tree(logits).numpy()}
    out.update(_decode(lm, params, batch, mesh, place))
    return out


def _rank(rank, world_size, tmp):
    """One rank: the (data = 2, model = 2) mesh's steps, then the (pod =
    2, data = 1, model = 2) mesh's rounds and serving, over gloo; results
    pickled to `tmp/rank<r>.pkl`."""
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
        mesh = make_host_mesh(data=2, model=2, device_type="cpu")
        out = {"coord": tuple(mesh.get_coordinate())}
        out.update({v: _steps(v, inputs, mesh) for v in VARIANTS})
        multi = make_host_mesh(pod=MULTI[0], data=MULTI[1], model=MULTI[2],
                               device_type="cpu")
        out["rounds"] = {name: _round(name, inputs, multi)
                         for name in EXCHANGES}
        out["serve"] = {name: _serve_multi(name, inputs, multi)
                        for name in ARCHS}
        out["pod"] = pod_axis(multi)[1]
        out["imported"] = sorted(k for k in sys.modules
                                 if k.split(".")[0] in ("jax", "repro"))
        with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


# The reference's partitioned steps, in a process of its own with four
# host devices (argv: the job's pickle, the output's).
_REFERENCE = r"""
import pickle, sys
from concurrent.futures import ThreadPoolExecutor
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType
from repro.comm.codecs import Int8Codec
from repro.configs import get_config
from repro.dist.dfl_step import build_dfl_round, build_train_step
from repro.dist.sharding import make_batch_specs, make_param_specs, named
from repro.models.lm import build_lm
from repro.optim.sgd import sgd_momentum

with open(sys.argv[1], "rb") as f:
    job = pickle.load(f)
opt = sgd_momentum(lr=job["lr"], momentum=0.9)
auto = lambda n: dict(axis_types=(AxisType.Auto,) * n)
f32 = lambda t: jax.tree.map(lambda x: np.asarray(x, np.float32), t)
lowered = {}  # name: (lowered step, its args, kind)
mesh = jax.make_mesh((2, 2), ("data", "model"), **auto(2))
with mesh:
    for name, (arch, reduce, params0, batch0) in job["steps"].items():
        lm = build_lm(get_config(arch).reduced(**reduce))
        params = jax.tree.map(jnp.asarray, params0)
        batch = {k: jnp.asarray(v) for k, v in batch0.items()}
        specs = named(make_param_specs(params, mesh), mesh)
        shardings = (specs, {"momentum": specs}, None,
                     named(make_batch_specs(batch, mesh), mesh))
        step = build_train_step(lm, opt)

        def both(p, o, s, b, lm=lm, step=step):
            return lm.forward(p, b), step(p, o, s, b)

        args = (params, opt.init(params), jnp.int32(0), batch)
        lowered[name] = (jax.jit(both, in_shardings=shardings).lower(*args),
                         args, "train")
    arch, reduce = job["round_arch"]
    lm = build_lm(get_config(arch).reduced(**reduce))
mesh = jax.make_mesh(tuple(job["mesh"]), ("pod", "data", "model"), **auto(3))
params = jax.tree.map(jnp.asarray, job["nodes0"])
nodes_batch = {k: jnp.asarray(v) for k, v in job["nodes_batch"].items()}
kinds = {"fp32": {}, "int8": {"codec": Int8Codec(stochastic=False)}}
with mesh:
    specs = named(make_param_specs(params, mesh, dfl_node_axis=True), mesh)
    b_specs = named(make_batch_specs(nodes_batch, mesh, dfl_node_axis=True),
                    mesh)
    args = (params, opt.init(params), jnp.int32(0), nodes_batch)
    for name, kw in kinds.items():
        lowered["round_" + name] = (jax.jit(
            build_dfl_round(lm, opt, jnp.asarray(job["adj"]), **kw),
            in_shardings=(specs, {"momentum": specs}, None, b_specs)).lower(
                *args), args, "round")
with ThreadPoolExecutor(4) as pool:  # the compiles, side by side
    compiled = dict(zip(lowered, pool.map(lambda t: t[0].compile(),
                                          lowered.values())))
out = {"n_devices": len(jax.devices())}
for name, (_, args, kind) in lowered.items():
    fn = compiled[name]
    if kind == "round":
        p, _, loss = fn(*args)
        out[name] = dict(loss=float(loss), params=f32(p))
    else:
        (logits, _), (p, _, loss) = fn(*args)
        out[name] = dict(logits=f32(logits), loss=float(loss), params=f32(p),
                         shards=sorted({len(x.sharding.device_set)
                                        for x in jax.tree.leaves(p)}))
with open(sys.argv[2], "wb") as f:
    pickle.dump(out, f)
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(inputs, the ranks' results, the reference's or None, the port's
    unpartitioned results)."""
    t0 = time.time()
    tmp = str(tmp_path_factory.mktemp("encdec_mesh"))
    inputs = _inputs()
    with open(os.path.join(tmp, "inputs.pkl"), "wb") as f:
        pickle.dump(inputs, f)
    ref = None
    try:
        import jax  # noqa: F401
        job = os.path.join(tmp, "job.pkl")
        steps = {name: (arch, reduce, inputs["params"][name],
                        inputs["batch"][name])
                 for name, (arch, reduce) in ARCHS.items()}
        with open(job, "wb") as f:
            pickle.dump(dict(round_arch=ARCHS["whisper"], steps=steps,
                             lr=LR, mesh=MULTI, adj=_adjacency(),
                             nodes0=inputs["nodes0"],
                             nodes_batch=inputs["nodes_batch"]), f)
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
    whole = {v: _steps(v, inputs, None) for v in VARIANTS}
    whole["rounds"] = {name: _round(name, inputs, None) for name in EXCHANGES}
    whole["serve"] = {name: _serve_multi(name, inputs, None)
                      for name in ARCHS}
    want = None
    if ref is not None:
        _, err = ref.communicate(timeout=300)
        assert ref.returncode == 0, err[-4000:]
        with open(os.path.join(tmp, "ref.pkl"), "rb") as f:
            want = pickle.load(f)
    print(f"\nthe module's runs took {time.time() - t0:.1f} s")
    return inputs, ranks, want, whole


def _max_err(a, b):
    return max(float(np.abs(x - np.asarray(y)).max())
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


def _rel_err(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


# ---------------------------------------------------- against the JAX package

@pytest.mark.parametrize("name", sorted(ARCHS))
def test_train_step_matches_the_references_partitioned_step(runs, name):
    _, ranks, want, _ = runs
    if want is None:
        pytest.skip("needs the JAX package")
    import jax

    ref = want[name]
    assert want["n_devices"] == 4 and 4 in ref["shards"]
    for got in ranks:
        g = got[name]
        assert abs(g["loss"] - ref["loss"]) <= 1e-5
        assert _rel_err(g["logits"], ref["logits"]) <= 1e-4
        errs = [float(np.abs(x - np.asarray(y)).max()) for x, y in zip(
            tree_leaves(g["params"]), jax.tree.leaves(ref["params"]))]
        assert len(errs) == len(jax.tree.leaves(ref["params"]))
        assert max(errs) <= 1e-5, errs


def _grain(params):
    """One int8 grain of the largest node: max|w| / 127."""
    return max(float(np.abs(a).max()) for a in tree_leaves(params)) / 127.0


def _block_err(got, want, pod):
    r = NODES // MULTI[0]
    return max(float(np.abs(g - np.asarray(w)[pod * r:(pod + 1) * r]).max())
               for g, w in zip(tree_leaves(got), tree_leaves(want)))


@pytest.mark.parametrize("name", EXCHANGES)
def test_multi_mesh_round_matches_the_references(runs, name):
    """Two whisper nodes, each batch with its `enc_embeds` leaf placed
    over "data" beside the tokens."""
    inputs, ranks, want, whole = runs
    tol = 1e-4 + _grain(inputs["nodes0"]) if name == "int8" else 1e-5
    for got in ranks:
        r = got["rounds"][name]
        for other in ([whole["rounds"][name]] + (
                [want["round_" + name]] if want is not None else [])):
            assert abs(r["loss"] - other["loss"]) <= 1e-5
            assert _block_err(r["params"], other["params"], got["pod"]) \
                <= tol
        assert r["collectives"]["all-gather_count"] > 0


# ------------------------------------------ against the unpartitioned port

@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_steps_match_the_unpartitioned_step(runs, variant):
    _, ranks, _, whole = runs
    want = whole[variant]
    vocab = VARIANTS[variant][1].get("vocab", VOCAB)
    for got in ranks:
        g = got[variant]
        assert abs(g["loss"] - want["loss"]) <= 1e-5
        assert _max_err(g["params"], want["params"]) <= 1e-5
        assert _rel_err(g["logits"], want["logits"]) <= 1e-4
        assert g["decode"].shape == (DECODE_STEPS, BATCH, 1, vocab)
        assert _rel_err(g["decode"], want["decode"]) <= 1e-4
        np.testing.assert_array_equal(g["tokens"], want["tokens"])
        if "cross" in want:
            for k in want["cross"]:
                assert _rel_err(g["cross"][k], want["cross"][k]) <= 1e-5
        assert g["collectives"]["all-reduce_count"] > 0
        # the split-hd kernels once a layer and step for the ring, and for
        # whisper once more for the cross-attention; never whole
        per_layer = 2 if VARIANTS[variant][0] == "whisper" else 1
        assert g["split_calls"] == per_layer * 2 * DECODE_STEPS
        assert want["split_calls"] == 0


def test_cross_caches_lie_in_the_cache_specs_placements(runs):
    """`build_prep_cache_step` returns the cross caches [L, B, S_enc, K,
    hd] with B over "data" and hd over "model", where the specs put them
    and the decode step reads them, for heads that divide "model" and for
    heads that do not."""
    from torch.distributed.tensor import Shard

    _, ranks, _, _ = runs
    for got in ranks:
        for variant in VARIANTS:
            if VARIANTS[variant][0] == "whisper":
                assert got[variant]["cross_placements"] == \
                    [(Shard(1), Shard(4))] * 2
        assert got["whisper"]["cross"]["cross_k"].shape == (
            2, BATCH, ENC_LEN, 4, 64)


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_multi_mesh_prefill_and_decode_match_the_unpartitioned_step(runs,
                                                                    name):
    """Prefill's batch lies over "pod" and "data" (pod-major); the cross
    caches, decode's tokens and cache over "data" only."""
    _, ranks, _, whole = runs
    want = whole["serve"][name]
    for got in ranks:
        g = got["serve"][name]
        assert _rel_err(g["prefill"], want["prefill"]) <= 1e-4
        assert _rel_err(g["decode"], want["decode"]) <= 1e-4
        np.testing.assert_array_equal(g["tokens"], want["tokens"])


def test_ranks_import_neither_jax_nor_repro(runs):
    _, ranks, _, _ = runs
    assert len(ranks) == 4 and all(r["imported"] == [] for r in ranks)
    assert sorted(r["coord"] for r in ranks) == [(0, 0), (0, 1), (1, 0),
                                                 (1, 1)]


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_one_rank_mesh_is_bitwise_the_unpartitioned_step(tmp_path, runs,
                                                         name):
    """A (1, 1) mesh in this process, at the module's two threads: every
    redistribution and every collective is over one rank and the cross
    attention is the plain one ("model" splits nothing), so the steps,
    the cross caches and the decode steps are the same bits."""
    from repro_torch.launch.mesh import make_host_mesh

    inputs = runs[0]
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        want = _steps(name, inputs, None)
        got = _steps(name, inputs, make_host_mesh(device_type="cpu"))
    finally:
        dist.destroy_process_group()
    assert got["loss"] == want["loss"]
    assert _max_err(got["params"], want["params"]) == 0.0
    for key in ("logits", "decode", "tokens"):
        np.testing.assert_array_equal(got[key], want[key])
    assert got["split_calls"] == want["split_calls"] == 0
    for k in want.get("cross", {}):
        np.testing.assert_array_equal(got["cross"][k], want["cross"][k])


# ------------------------------------------------------------------- specs

def _spec_leaves(tree):
    if isinstance(tree, dict):  # in sorted keys, as jax.tree.leaves
        return [s for k in sorted(tree) for s in _spec_leaves(tree[k])]
    return [tuple(tree)]


def _ref_leaves(tree):
    import jax

    return [tuple(s) for s in jax.tree.leaves(
        tree, is_leaf=lambda s: type(s).__name__ == "PartitionSpec")]


@pytest.mark.parametrize("name", sorted(ARCHS))
@pytest.mark.parametrize("full", [False, True], ids=["reduced", "full"])
def test_specs_of_every_leaf_are_the_references(name, full):
    """`make_param_specs` (plain and `dfl_node_axis`), `node_block_specs`,
    `make_batch_specs` and `make_cache_specs` against the reference's,
    leaf by leaf, on the test's (2, 2) / (2, 1, 2) meshes and the
    production ones: the cross caches split B over "data" and hd over
    "model", as the rings."""
    pytest.importorskip("jax")
    from repro.dist import sharding as jax_sharding
    from repro_torch.configs import get_config
    from repro_torch.dist.sharding import (make_batch_specs,
                                           make_cache_specs,
                                           make_param_specs,
                                           node_block_specs)
    from repro_torch.models.lm import build_lm

    arch, reduce = ARCHS[name]
    cfg = get_config(arch)
    cfg = cfg.reduced(**reduce) if not full else cfg
    lm = build_lm(cfg)
    meta = lm.init(torch.Generator(), device="meta")
    nodes = tree_map(lambda t: torch.empty((2,) + tuple(t.shape),
                                           dtype=t.dtype, device="meta"),
                     meta)
    cache = lm.init_cache(16, CACHE_SLOTS * 4, device="meta")  # 16 | data
    batch = {k: torch.empty(s, dtype=d, device="meta")
             for k, (s, d) in lm.input_specs(16, 64 + cfg.img_tokens)
             .items()}
    as_np = lambda tree: tree_map(  # noqa: E731
        lambda t: np.empty(t.shape, np.int32 if not t.dtype.is_floating_point
                           else np.float32), tree)
    mesh = lambda **s: type("M", (), {"shape": s})()  # noqa: E731
    meshes = ((mesh(data=16, model=16), mesh(pod=2, data=16, model=16))
              if full else (mesh(data=2, model=2),
                            mesh(pod=2, data=1, model=2)))
    single, multi = meshes
    got = {"params": make_param_specs(meta, single),
           "nodes": make_param_specs(nodes, multi, dfl_node_axis=True),
           "cache": make_cache_specs(cache, single),
           "batch": make_batch_specs(batch, single)}
    want = {"params": jax_sharding.make_param_specs(as_np(meta), single),
            "nodes": jax_sharding.make_param_specs(as_np(nodes), multi,
                                                   dfl_node_axis=True),
            "cache": jax_sharding.make_cache_specs(as_np(cache), single),
            "batch": jax_sharding.make_batch_specs(as_np(batch), single)}
    for key in got:
        g, w = _spec_leaves(got[key]), _ref_leaves(want[key])
        assert len(g) == len(w) > 0 and g == w, key
    block = _spec_leaves(node_block_specs(nodes, multi))
    assert block == [tuple(None if e == "pod" else e for e in w)
                     for w in _ref_leaves(want["nodes"])]
    if name == "whisper":
        for k in ("cross_k", "cross_v", "k", "v"):
            assert tuple(got["cache"][k]) == (None, "data", None, None,
                                              "model")


@pytest.mark.parametrize("arch", [
    "qwen1.5-0.5b", "deepseek-7b", "qwen2.5-14b", "qwen3-32b",
    "mixtral-8x7b", "arctic-480b", "mamba2-2.7b", "zamba2-2.7b",
    "whisper-large-v3", "llava-next-mistral-7b"])
def test_every_step_builder_takes_a_mesh(arch):
    """No family is refused a mesh: each step builder returns its step
    (built, not run), and the cross caches' builder is the enc-dec
    family's alone."""
    from repro_torch.configs import get_config
    from repro_torch.dist.dfl_step import (build_prefill_step,
                                           build_prep_cache_step,
                                           build_serve_step,
                                           build_train_step)
    from repro_torch.models.lm import build_lm
    from repro_torch.optim.sgd import sgd_momentum

    lm = build_lm(get_config(arch).reduced())
    mesh = object()
    opt = sgd_momentum(lr=LR, momentum=0.9)
    for step in (build_train_step(lm, opt, mesh=mesh),
                 build_prefill_step(lm, mesh=mesh),
                 build_serve_step(lm, mesh=mesh)):
        assert callable(step)
    if lm.cfg.family == "encdec":
        assert callable(build_prep_cache_step(lm, mesh=mesh))
    else:
        with pytest.raises(ValueError, match="enc-dec only"):
            build_prep_cache_step(lm, mesh=mesh)


# ---------------------------------------------------------------- on a card

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("arch,width", [("whisper-large-v3", 1500),
                                        ("whisper-large-v3", 448),
                                        ("llava-next-mistral-7b", 4096)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_split_kernels_at_the_enc_dec_and_vlm_shapes(card, arch,
                                                            width, dtype):
    """The split B.9 with hd cut in two: whisper's cross cache (1500 live
    slots, the query at the last) and ring (hdl 32, K = 20, G = 1), and
    llava's ring (hdl 64, K = 8, G = 4); each shard's partial scores
    summed, then each shard's softmax-combine, against the plain
    versions."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import decode_attention as _da
    from repro_torch.kernels import ops

    cfg = get_config(arch)
    b, w, kk, hd, h = 2, width, cfg.n_kv_heads, cfg.head_dim, cfg.n_heads
    g = torch.Generator().manual_seed(width)
    q = torch.randn(b, h, hd, generator=g).to(dtype)
    k = torch.randn(b, w, kk, hd, generator=g).to(dtype)
    v = torch.randn(b, w, kk, hd, generator=g).to(dtype)
    slot_pos = torch.arange(w, dtype=torch.int32)
    pos = torch.tensor(w - 1, dtype=torch.int32)
    scale = 1.0 / hd ** 0.5
    halves = [(a.contiguous(), c.contiguous(), d.contiguous()) for a, c, d
              in zip(*(torch.chunk(t, 2, dim=-1) for t in (q, k, v)))]
    want = sum(_da.scores_partial_plain(a, c, scale) for a, c, _ in halves)
    got = sum(ops.decode_scores_partial(a.to(card), c.to(card), scale).cpu()
              for a, c, _ in halves)
    terms = scale * torch.einsum("bkgd,bwkd->bkgw",
                                 q.float().abs().reshape(b, kk, h // kk, hd),
                                 k.float().abs()).reshape(b, h, w)
    assert (torch.abs(got - want) <= 1e-6 + 1e-5 * terms).all()
    for _, _, d in halves:
        ref = _da.softmax_combine_plain(got, d, slot_pos, pos, 0)
        out = ops.decode_softmax_combine(got.to(card), d.to(card),
                                         slot_pos.to(card), pos.to(card),
                                         0).cpu()
        vt = d.float().abs().amax(dim=1).repeat_interleave(h // kk, dim=1)
        assert (torch.abs(out - ref) <= 1e-6 + 1e-5 * vt).all()


@pytest.mark.cuda
@pytest.mark.parametrize("vocab", [51866, 32000])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_vt_split_kernels_at_the_enc_dec_and_vlm_vocabularies(card, vocab,
                                                              dtype):
    """The split B.3 at whisper's and llava's vocabularies over two
    shards (25933 columns a shard, an odd width: the narrow-vector plan;
    and 16000), each shard's partial statistics and backward against the
    plain versions."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import vt_kl_loss as _vt

    v, rows = vocab // 2, 64
    g = torch.Generator().manual_seed(vocab)
    for offset in (0, v):
        z = (torch.randn(rows, v, generator=g) * 3).to(dtype)
        labels = torch.randint(0, vocab, (rows,), generator=g)
        labels[0] = offset  # one label in the shard at least
        want = _vt.vt_partial_plain(z, labels, offset)
        got = ops.vt_partial_stats(z.to(card), labels.to(card), offset,
                                   vocab)
        z32 = z.float()
        for a, b, tol in zip(got, want, (0.0, 1e-5, 1e-5, 0.0)):
            b_scale = 1e-6 + tol * (z32.abs().sum(-1) if b is want[2]
                                    else b.abs())
            assert (torch.abs(a.cpu() - b) <= b_scale).all()
        gr = torch.rand(rows, generator=g)
        mx, s = want[0], want[1] * 1.5
        dz = ops.vt_shard_backward(z.to(card), labels.to(card), offset,
                                   mx.to(card), s.to(card), gr.to(card),
                                   0.98, vocab)
        ref = _vt.vt_shard_backward_plain(z, labels, offset, mx, s, gr,
                                          0.98, vocab).float()
        tol = 1e-6 + 1e-5 * ref.abs()
        if dtype == torch.bfloat16:  # one bf16 rounding of the output
            tol = tol + ref.abs() * 2.0 ** -7
        assert (torch.abs(dz.cpu().float() - ref) <= tol).all()
