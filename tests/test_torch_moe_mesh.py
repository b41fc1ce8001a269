"""The partitioned MoE step on the (data, model) and (pod, data, model)
meshes, on the CPU.

`build_train_step`, `build_prefill_step`, `build_serve_step` and
`build_dfl_round(..., mesh=)` run the MoE family partitioned over
`torch.distributed` ranks: params (specs with `expert_parallel=
cfg.expert_parallel`), optimizer state, batch and cache placed as DTensors,
routing, dispatch and combine on each rank's batch shard, the expert GLU
tensor-parallel inside the experts or, under `expert_parallel`, over
experts split on "model".  The shape is mixtral-8x7b reduced to 2 layers,
d_model 256, 4 experts and vocab 2048, batch 4 x 32, in three dispatch
modes: the global pool ("global"), `batch_local` ("moelocal") and
`batch_local` with `expert_parallel` ("expertpar").

  * against the JAX package: four gloo ranks as (data = 2, model = 2) hold
    one train step's loss and params within 1e-5 and the forward's aux
    within 1e-6 of the reference's step jitted with its specs on four host
    devices (a subprocess with `XLA_FLAGS=
    --xla_force_host_platform_device_count=4` and Auto axes), each mode and
    a global pool at `capacity_factor` 0.5 ("dropping", whose drops cross
    the "data" boundary: its drop set is the reference's, and a pool
    counted per shard would drop others); the expert choices are compared
    first (the reference's recorded by a host callback on `lax.top_k`);
  * a sharded router: arctic-480b reduced to d_model 512, 128 experts
    (512 x 128 = 65,536 meets the specs' small-leaf limit, so D lies over
    "model" and the router product is row-parallel) and d_ff 64, its
    forward and aux against the reference;
  * against the port's unpartitioned step, on the same ranks: train step,
    prefill and 4 decode steps of each mode, and train step and prefill
    with `remat`, `zero3_gather` and, under `expertpar`,
    `residual_shard="batch_seq"`; a (1, 1) mesh is bitwise the
    unpartitioned step;
  * the multi mesh (pod = 2, data = 1, model = 2) on the same ranks: one
    DFL round of two `expertpar` nodes against the reference's
    `build_dfl_round` jitted with its `dfl_node_axis` and
    `expert_parallel` specs (fp32 within 1e-5, the deterministic int8
    exchange within 1e-4 plus one int8 grain) and against the port's
    unpartitioned round; prefill with the batch over ("pod", "data") (the
    global pool spans both) and 4 decode steps with the tokens over
    "data", as the dry run places them, against the unpartitioned steps;
  * each step's collectives (`launch/comm_analysis.py`) printed beside the
    reference's, not held equal; the node-block specs with
    `expert_parallel` against the reference's;
  * `cuda`: the split B.9 at the MoE heads, G = 4 (mixtral) and G = 7
    (arctic) with hd 128 split in two, against its plain version (skip
    here).

All ranks run in ONE `torch.multiprocessing.spawn`, with a `FileStore` in
the test's temporary directory; they import neither `jax` nor `repro`.
torch runs on one thread in the ranks and two here.
"""
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

ARCH = "mixtral-8x7b"
REDUCE = {"vocab": 2048}
BATCH, SEQ = 4, 32
LR, DECODE_STEPS, CACHE_SLOTS = 0.1, 4, 16
EXPERTPAR = {"moe_dispatch": "batch_local", "expert_parallel": True}
MODES = {"global": {}, "moelocal": {"moe_dispatch": "batch_local"},
         "expertpar": EXPERTPAR, "dropping": {"capacity_factor": 0.5}}
EXTRAS = {"remat": {"remat": True}, "zero3": {"zero3_gather": True},
          "expertpar+seqshard": dict(EXPERTPAR, residual_shard="batch_seq")}
ROUTER = ("arctic-480b", {"vocab": 2048, "d_model": 512, "n_experts": 128,
                          "d_ff": 64})
DECODED = ("global", "moelocal", "expertpar")  # the decode steps' modes
MULTI, NODES, EXCHANGES = (2, 1, 2), 2, ("fp32", "int8")
SRC = os.path.join(os.path.dirname(__file__), os.pardir, "src")


# -------------------------------------------------------- shared helpers
# (module-level and free of jax: the spawned ranks import this module)

def _lm(over=None, arch=ARCH, reduce=REDUCE):
    from repro_torch.configs import get_config
    from repro_torch.models.lm import build_lm

    return build_lm(get_config(arch).reduced(**reduce, **(over or {})))


def _tokens(rng, lead=()):
    return {k: rng.integers(0, REDUCE["vocab"], lead + (BATCH, SEQ))
            .astype(np.int32) for k in ("tokens", "labels")}


def _inputs():
    """The params (numpy, from the port's seeded init: one mixtral, one
    arctic, two mixtral nodes stacked) and the batches."""
    rng = np.random.default_rng(0)
    gen = torch.Generator().manual_seed(0)
    lm = _lm()
    nodes = [lm.init(gen, device="cpu") for _ in range(NODES)]
    return dict(
        params0=convert.params_to_numpy(lm.init(gen, device="cpu")),
        router0=convert.params_to_numpy(
            _lm(None, *ROUTER).init(gen, device="cpu")),
        nodes0=convert.params_to_numpy(
            tree_map(lambda *xs: torch.stack(xs), *nodes)),
        batch=_tokens(rng), nodes_batch=_tokens(rng, (NODES,)))


def _routing(recorded):
    """The recorded layers' experts and kept masks (numpy)."""
    return [{k: r[k].numpy() for k in ("experts", "gap", "kept")}
            for r in recorded]


def _steps(over, inputs, mesh, arch=ARCH, reduce=REDUCE, decode=True):
    """One train step, the forward (logits, aux, routing) and, with
    `decode`, DECODE_STEPS greedy decode steps (and their routing), on
    `mesh` or whole; the train step's collectives."""
    from repro_torch.dist.dfl_step import build_serve_step, build_train_step
    from repro_torch.dist.sharding import (distribute_tree, full_tree,
                                           make_batch_specs,
                                           make_cache_specs,
                                           make_param_specs)
    from repro_torch.dist.constraints import use_mesh
    from repro_torch.launch.comm_analysis import CollectiveCounter
    from repro_torch.models.lm import moe
    from repro_torch.optim.sgd import sgd_momentum

    lm = _lm(over, arch, reduce)
    ep = lm.cfg.expert_parallel
    key = "params0" if arch == ARCH else "router0"

    def params():
        p = convert.params_from_numpy(inputs[key], device="cpu")
        return p if mesh is None else distribute_tree(
            p, make_param_specs(p, mesh, expert_parallel=ep), mesh)

    def place(tree, specs_fn=make_batch_specs):
        tree = tree_map(lambda a: torch.from_numpy(a.copy()), tree) \
            if isinstance(next(iter(tree.values())), np.ndarray) else tree
        return tree if mesh is None else distribute_tree(
            tree, specs_fn(tree, mesh), mesh)

    out = {}
    if arch == ARCH:
        opt = sgd_momentum(lr=LR, momentum=0.9)
        p = params()
        state, batch = opt.init(p), place(inputs["batch"])
        with CollectiveCounter() as counter:
            _, _, loss = build_train_step(lm, opt, mesh=mesh)(p, state, 0,
                                                              batch)
        out.update(collectives=counter.summary(), loss=float(loss),
                   params=convert.params_to_numpy(full_tree(p)))
    with torch.no_grad(), use_mesh(mesh), moe.record_choices() as seen:
        logits, aux = lm.forward(params(), place(inputs["batch"]))
    out.update(logits=full_tree(logits).numpy(),
               aux=float(full_tree(aux)), routing=_routing(seen))
    if not decode:
        return out
    serve = build_serve_step(lm, mesh=mesh)
    p = params()
    cache = place(lm.init_cache(BATCH, CACHE_SLOTS, device="cpu"),
                  make_cache_specs)
    tok = torch.from_numpy(inputs["batch"]["tokens"][:, :1].copy())
    logits, tokens = [], []
    with moe.record_choices() as seen:
        for _ in range(DECODE_STEPS):
            lg, cache = serve(p, cache, place({"t": tok})["t"])
            lg = full_tree(lg)
            tok = torch.argmax(lg, dim=-1).to(torch.int32)
            logits.append(lg.numpy())
            tokens.append(tok.numpy())
    out.update(decode=np.stack(logits), tokens=np.stack(tokens),
               decode_routing=_routing(seen))
    return out


def _exchange(name):
    return {"fp32": {}, "int8": {"codec": Int8Codec(stochastic=False)}}[name]


def _adjacency():
    return np.array([[0.0, 1.0], [1.0, 0.0]], np.float32)  # a 2-ring


def _round(name, inputs, mesh):
    """One DFL round of two `expertpar` nodes: on the multi `mesh` the
    caller's pod block, placed on its sub-mesh, else both nodes."""
    from repro_torch.dist.dfl_step import build_dfl_round
    from repro_torch.dist.sharding import full_tree, place_node_block
    from repro_torch.launch.comm_analysis import CollectiveCounter
    from repro_torch.launch.mesh import pod_axis
    from repro_torch.optim.sgd import sgd_momentum

    lm = _lm(EXPERTPAR)
    opt = sgd_momentum(lr=LR, momentum=0.9)
    params = convert.params_from_numpy(inputs["nodes0"], device="cpu")
    batch = {k: torch.from_numpy(v.copy())
             for k, v in inputs["nodes_batch"].items()}
    if mesh is not None:
        n_pods, pod, _ = pod_axis(mesh)
        r = NODES // n_pods
        params = place_node_block(tree_map(
            lambda t: t[pod * r:(pod + 1) * r].contiguous(), params), mesh,
            expert_parallel=True)
        batch = place_node_block({k: v[pod * r:(pod + 1) * r].contiguous()
                                  for k, v in batch.items()}, mesh,
                                 batch=True)
    step = build_dfl_round(lm, opt, _adjacency(), mesh=mesh,
                           **_exchange(name))
    with CollectiveCounter() as counter:
        new, _, loss = step(params, opt.init(params), 0, batch)
    return dict(loss=float(loss), collectives=counter.summary(),
                params=convert.params_to_numpy(full_tree(new)))


def _serve_multi(inputs, mesh):
    """Prefill (global pool, the batch over ("pod", "data") on `mesh`) and
    DECODE_STEPS decode steps with the tokens over "data" (the dry run's
    placement), on the multi `mesh` or whole."""
    from repro_torch.dist.dfl_step import build_prefill_step, build_serve_step
    from repro_torch.dist.sharding import (NODE_AXIS, distribute_tree,
                                           full_tree, make_batch_specs,
                                           make_cache_specs,
                                           make_param_specs)
    from repro_torch.models.lm import moe

    lm = _lm()

    def place(tree, specs, **kw):
        return tree if mesh is None else distribute_tree(
            tree, specs(tree, mesh, **kw), mesh)

    params = place(convert.params_from_numpy(inputs["params0"],
                                             device="cpu"), make_param_specs)
    batch = {k: torch.from_numpy(v.copy()) for k, v in
             inputs["batch"].items()}
    with moe.record_choices() as seen:
        logits = build_prefill_step(lm, mesh=mesh)(params, place(
            batch, make_batch_specs, dp_axes=(NODE_AXIS, "data")))
    out = {"prefill": full_tree(logits).numpy(), "routing": _routing(seen)}
    serve = build_serve_step(lm, mesh=mesh)
    cache = place(lm.init_cache(BATCH, CACHE_SLOTS, device="cpu"),
                  make_cache_specs)
    tok = batch["tokens"][:, :1].contiguous()
    logits, tokens = [], []
    for _ in range(DECODE_STEPS):
        lg, cache = serve(params, cache,
                          place({"t": tok}, make_batch_specs)["t"])
        lg = full_tree(lg)
        tok = torch.argmax(lg, dim=-1).to(torch.int32)
        logits.append(lg.numpy())
        tokens.append(tok.numpy())
    out["decode"], out["tokens"] = np.stack(logits), np.stack(tokens)
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
        out.update({name: _steps(over, inputs, mesh, decode=name in DECODED)
                    for name, over in dict(MODES, **EXTRAS).items()})
        out["router"] = _steps(None, inputs, mesh, *ROUTER, decode=False)
        multi = make_host_mesh(pod=MULTI[0], data=MULTI[1], model=MULTI[2],
                               device_type="cpu")
        out["rounds"] = {name: _round(name, inputs, multi)
                         for name in EXCHANGES}
        out["serve"] = _serve_multi(inputs, multi)
        out["pod"] = pod_axis(multi)[1]
        out["imported"] = sorted(k for k in sys.modules
                                 if k.split(".")[0] in ("jax", "repro"))
        with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


# The reference's partitioned steps, in a process of its own with four
# host devices (argv: the job's pickle, the output's).  Each MoE layer's
# expert choices reach the host through a callback on `lax.top_k`, traced
# into the forward only.
_REFERENCE = r"""
import pickle, sys
from concurrent.futures import ThreadPoolExecutor
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType
from repro.comm.codecs import Int8Codec
from repro.configs import get_config
from repro.dist.dfl_step import build_dfl_round, build_train_step
from repro.dist.sharding import make_batch_specs, make_param_specs, named
from repro.launch.hlo_analysis import collective_bytes
from repro.models.lm import build_lm
from repro.optim.sgd import sgd_momentum

with open(sys.argv[1], "rb") as f:
    job = pickle.load(f)
top_k, seen, tracing = jax.lax.top_k, [], {"on": False}


def recorded(x, k):
    w, i = top_k(x, k)
    if tracing["on"]:
        jax.debug.callback(lambda v: seen.append(np.asarray(v)), i)
    return w, i


jax.lax.top_k = recorded
opt = sgd_momentum(lr=job["lr"], momentum=0.9)
auto = lambda n: dict(axis_types=(AxisType.Auto,) * n)
f32 = lambda t: jax.tree.map(lambda x: np.asarray(x, np.float32), t)
lowered = {}  # name: (lowered step, its args, train)
mesh = jax.make_mesh((2, 2), ("data", "model"), **auto(2))
batch = {k: jnp.asarray(v) for k, v in job["batch"].items()}
with mesh:
    for name, (arch, reduce, params0, train) in job["steps"].items():
        lm = build_lm(get_config(arch).reduced(**reduce))
        params = jax.tree.map(jnp.asarray, params0)
        specs = named(make_param_specs(
            params, mesh, expert_parallel=lm.cfg.expert_parallel), mesh)
        shardings = (specs, {"momentum": specs}, None,
                     named(make_batch_specs(batch, mesh), mesh))
        step = build_train_step(lm, opt)

        def both(p, o, s, b, lm=lm, step=step, train=train):
            tracing["on"] = True
            fwd = lm.forward(p, b)
            tracing["on"] = False
            return fwd, (step(p, o, s, b) if train else None)

        args = (params, opt.init(params), jnp.int32(0), batch)
        lowered[name] = (jax.jit(both, in_shardings=shardings).lower(*args),
                         args, train)
        if name == "global":
            lowered["collectives"] = (jax.jit(
                step, in_shardings=shardings).lower(*args), args, None)
    lm = build_lm(get_config(job["arch"]).reduced(**job["expertpar"]))
mesh = jax.make_mesh(tuple(job["mesh"]), ("pod", "data", "model"), **auto(3))
params = jax.tree.map(jnp.asarray, job["nodes0"])
nodes_batch = {k: jnp.asarray(v) for k, v in job["nodes_batch"].items()}
kinds = {"fp32": {}, "int8": {"codec": Int8Codec(stochastic=False)}}
with mesh:
    specs = named(make_param_specs(params, mesh, dfl_node_axis=True,
                                   expert_parallel=True), mesh)
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
for name, (_, args, train) in lowered.items():
    fn = compiled[name]
    if train is None:
        out["global"]["collectives"] = collective_bytes(fn.as_text())
        continue
    if train == "round":
        p, _, loss = fn(*args)
        out[name] = dict(loss=float(loss), params=f32(p))
        continue
    del seen[:]
    (logits, aux), new = fn(*args)
    jax.block_until_ready(logits)
    jax.effects_barrier()
    rec = dict(logits=f32(logits), aux=float(aux),
               experts=[c.reshape(batch["tokens"].shape + (-1,))
                        for c in seen])
    if train:
        p, _, loss = new
        rec.update(loss=float(loss), params=f32(p), shards=sorted(
            {len(x.sharding.device_set) for x in jax.tree.leaves(p)}))
    out[name] = rec
with open(sys.argv[2], "wb") as f:
    pickle.dump(out, f)
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(inputs, the ranks' results, the reference's or None, the port's
    unpartitioned results)."""
    t0 = time.time()
    tmp = str(tmp_path_factory.mktemp("moe_mesh"))
    inputs = _inputs()
    with open(os.path.join(tmp, "inputs.pkl"), "wb") as f:
        pickle.dump(inputs, f)
    ref = None
    try:
        import jax  # noqa: F401
        job = os.path.join(tmp, "job.pkl")
        steps = {name: (ARCH, dict(REDUCE, **over), inputs["params0"], True)
                 for name, over in MODES.items()}
        steps["router"] = ROUTER + (inputs["router0"], False)
        with open(job, "wb") as f:
            pickle.dump(dict(arch=ARCH, expertpar=dict(REDUCE, **EXPERTPAR),
                             steps=steps, batch=inputs["batch"], lr=LR,
                             mesh=MULTI, adj=_adjacency(),
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
    whole = {name: _steps(over, inputs, None, decode=name in DECODED)
             for name, over in dict(MODES, **EXTRAS).items()}
    whole["router"] = _steps(None, inputs, None, *ROUTER, decode=False)
    whole["rounds"] = {name: _round(name, inputs, None) for name in EXCHANGES}
    whole["serve"] = _serve_multi(inputs, None)
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


def _rows(coord_index):
    """The batch rows of a rank whose batch coordinate is `coord_index`
    of two."""
    b = BATCH // 2
    return slice(coord_index * b, (coord_index + 1) * b)


def _same_choices(got, want, label):
    """Assert each layer's experts equal (`got` a rank's [b, S, k], `want`
    the same rows of the other run); print the count and the probability
    gaps of the choices that differ."""
    assert len(got) == len(want) > 0, label
    for layer, (g, w) in enumerate(zip(got, want)):
        g_e = g["experts"]
        w_e = w["experts"] if isinstance(w, dict) else w
        assert g_e.shape == w_e.shape, (label, g_e.shape, w_e.shape)
        diff = np.any(np.sort(g_e, -1) != np.sort(w_e, -1), axis=-1)
        if diff.any():
            print(f"{label}, layer {layer}: {int(diff.sum())} tokens chose "
                  f"other experts, probability gaps "
                  f"{g['gap'][diff].tolist()}")
        assert not diff.any(), f"{label}: expert choices differ"


# ---------------------------------------------------- against the JAX package

@pytest.mark.parametrize("mode", sorted(MODES))
def test_train_step_matches_the_references_partitioned_step(runs, mode):
    _, ranks, want, _ = runs
    if want is None:
        pytest.skip("needs the JAX package")
    import jax

    ref = want[mode]
    assert want["n_devices"] == 4 and 4 in ref["shards"]
    for got in ranks:
        rows = _rows(got["coord"][0])
        _same_choices(got[mode]["routing"],
                      [e[rows] for e in ref["experts"]],
                      f"{mode} forward vs the reference")
        assert abs(got[mode]["loss"] - ref["loss"]) <= 1e-5
        assert abs(got[mode]["aux"] - ref["aux"]) <= 1e-6
        assert np.abs(got[mode]["logits"] - ref["logits"]).max() <= \
            1e-4 * np.abs(ref["logits"]).max()
        errs = [float(np.abs(x - np.asarray(y)).max()) for x, y in zip(
            tree_leaves(got[mode]["params"]), jax.tree.leaves(ref["params"]))]
        assert len(errs) == len(jax.tree.leaves(ref["params"]))
        assert max(errs) <= 1e-5, errs


def _drops(experts, cap, shards=1):
    """The kept assignments [B, S, k] of the reference's global-pool rule
    on a batch's choices [B, S, k]: assignments in token order, each
    expert keeps its first `cap`; with `shards`, a pool counted per batch
    shard instead (each with the capacity of its own tokens)."""
    from repro_torch.models.lm.moe import _capacity

    b, s, k = experts.shape
    per = b // shards
    kept = np.zeros(b * s * k, bool)
    for i in range(shards):
        c = cap if shards == 1 else _capacity(_lm(MODES["dropping"]).cfg,
                                              per * s)
        count = {}
        for j, e in enumerate(experts[i * per:(i + 1) * per].reshape(-1)):
            count[e] = count.get(e, 0) + 1
            kept[i * per * s * k + j] = count[e] <= c
    return kept.reshape(b, s, k)


def test_global_pool_drops_what_the_reference_drops(runs):
    """At `capacity_factor` 0.5 the pool of 128 tokens keeps 40
    assignments an expert: the drops cross the "data" boundary, and a
    pool counted per data shard (each with the capacity of its 64 tokens)
    would keep others.  Each rank's kept assignments are the reference's
    rule on the reference's choices, rows for rows."""
    from repro_torch.models.lm.moe import _capacity

    _, ranks, want, whole = runs
    cap = _capacity(_lm(MODES["dropping"]).cfg, BATCH * SEQ)
    source = want["dropping"]["experts"] if want is not None else [
        r["experts"] for r in whole["dropping"]["routing"]]
    for layer, experts in enumerate(source):
        kept = _drops(experts, cap)
        assert (~kept).sum() > 0
        assert (kept != _drops(experts, cap, shards=2)).any()
        np.testing.assert_array_equal(
            whole["dropping"]["routing"][layer]["kept"], kept)
        for got in ranks:
            rows = _rows(got["coord"][0])
            np.testing.assert_array_equal(
                got["dropping"]["routing"][layer]["kept"], kept[rows])


def test_sharded_router_matches_the_reference(runs):
    """arctic reduced to d_model 512 and 128 experts: the router [512,
    128] is sharded (D over "model", E over "data"), its product
    row-parallel; the forward's choices, logits and aux against the
    reference's and the unpartitioned port's."""
    from repro_torch.dist.sharding import make_param_specs

    _, ranks, want, whole = runs
    lm = _lm(None, *ROUTER)
    specs = make_param_specs(lm.init(torch.Generator(), device="meta"),
                             type("M", (), {"shape": {"data": 2,
                                                      "model": 2}})())
    assert tuple(specs["layers"]["moe"]["router"]) == (None, "model", "data")
    for got in ranks:
        rows = _rows(got["coord"][0])
        g = got["router"]
        _same_choices(g["routing"], [{"experts": r["experts"][rows]}
                                     for r in whole["router"]["routing"]],
                      "sharded router vs unpartitioned")
        assert abs(g["aux"] - whole["router"]["aux"]) <= 1e-6
        assert np.abs(g["logits"] - whole["router"]["logits"]).max() <= \
            1e-4 * np.abs(whole["router"]["logits"]).max()
        if want is None:
            continue
        ref = want["router"]
        _same_choices(g["routing"], [e[rows] for e in ref["experts"]],
                      "sharded router vs the reference")
        assert abs(g["aux"] - ref["aux"]) <= 1e-6
        assert np.abs(g["logits"] - ref["logits"]).max() <= \
            1e-4 * np.abs(ref["logits"]).max()


def test_collective_traffic_beside_the_references(runs):
    """Each mode's train step's per-device collectives (the port's
    `comm_analysis` on each rank) beside the reference's global step
    (`hlo_analysis.collective_bytes`), printed, not held equal.  The
    global pool all-gathers its [E] counts over "data"; `expertpar`
    all-gathers the GLU outputs over "model"; gloo on the CPU has no
    all-to-all (DTensor moves a shard to another dim by all-gather)."""
    _, ranks, want, _ = runs
    for mode in MODES:
        got = [r[mode]["collectives"] for r in ranks]
        assert all(g == got[0] for g in got)
        g = got[0]
        assert g["all-reduce_count"] > 0 and g["all-gather_count"] > 0
        print(f"\nport (2, 2) {mode} train step: {g}")
    assert ranks[0]["expertpar"]["collectives"]["all-gather"] > \
        ranks[0]["moelocal"]["collectives"]["all-gather"]
    for name in EXCHANGES:
        print(f"port (2, 1, 2) {name} expertpar round: "
              f"{ranks[0]['rounds'][name]['collectives']}")
    if want is not None:
        print(f"reference (2, 2) global train step: "
              f"{want['global']['collectives']}")
        assert want["global"]["collectives"]["total"] > 0


def _grain(params):
    """One int8 grain of the largest node: max|w| / 127."""
    return max(float(np.abs(a).max()) for a in tree_leaves(params)) / 127.0


def _block_err(got, want, pod):
    r = NODES // MULTI[0]
    return max(float(np.abs(g - np.asarray(w)[pod * r:(pod + 1) * r]).max())
               for g, w in zip(tree_leaves(got), tree_leaves(want)))


def _tolerance(name, inputs):
    return 1e-4 + _grain(inputs["nodes0"]) if name == "int8" else 1e-5


@pytest.mark.parametrize("name", EXCHANGES)
def test_multi_mesh_round_matches_the_references(runs, name):
    inputs, ranks, want, whole = runs
    for got in ranks:
        r = got["rounds"][name]
        for other in ([whole["rounds"][name]] + (
                [want["round_" + name]] if want is not None else [])):
            assert abs(r["loss"] - other["loss"]) <= 1e-5
            assert _block_err(r["params"], other["params"], got["pod"]) \
                <= _tolerance(name, inputs)


# ------------------------------------------ against the unpartitioned port

@pytest.mark.parametrize("variant", sorted(MODES) + sorted(EXTRAS))
def test_steps_match_the_unpartitioned_step(runs, variant):
    _, ranks, _, whole = runs
    want = whole[variant]
    for got in ranks:
        g, rows = got[variant], _rows(got["coord"][0])
        _same_choices(g["routing"], [{"experts": r["experts"][rows]}
                                     for r in want["routing"]],
                      f"{variant} forward vs unpartitioned")
        assert abs(g["loss"] - want["loss"]) <= 1e-5
        assert abs(g["aux"] - want["aux"]) <= 1e-6
        assert _max_err(g["params"], want["params"]) <= 1e-5
        assert np.abs(g["logits"] - want["logits"]).max() <= \
            1e-4 * np.abs(want["logits"]).max()
        if variant not in DECODED:
            continue
        _same_choices(g["decode_routing"],
                      [{"experts": r["experts"][rows]}
                       for r in want["decode_routing"]],
                      f"{variant} decode vs unpartitioned")
        assert g["decode"].shape == (DECODE_STEPS, BATCH, 1, REDUCE["vocab"])
        assert np.abs(g["decode"] - want["decode"]).max() <= \
            1e-4 * np.abs(want["decode"]).max()
        np.testing.assert_array_equal(g["tokens"], want["tokens"])


def test_multi_mesh_prefill_and_decode_match_the_unpartitioned_step(runs):
    """Prefill's global pool spans "pod" and "data" (the batch over both,
    pod-major); decode's tokens lie over "data" only."""
    _, ranks, _, whole = runs
    want = whole["serve"]
    for got in ranks:
        g = got["serve"]
        _same_choices(g["routing"], [{"experts": r["experts"][_rows(
            got["pod"])]} for r in want["routing"]],
            "multi-mesh prefill vs unpartitioned")
        assert np.abs(g["prefill"] - want["prefill"]).max() <= \
            1e-4 * np.abs(want["prefill"]).max()
        assert np.abs(g["decode"] - want["decode"]).max() <= \
            1e-4 * np.abs(want["decode"]).max()
        np.testing.assert_array_equal(g["tokens"], want["tokens"])


def test_ranks_import_neither_jax_nor_repro(runs):
    _, ranks, _, _ = runs
    assert len(ranks) == 4 and all(r["imported"] == [] for r in ranks)
    assert sorted(r["coord"] for r in ranks) == [(0, 0), (0, 1), (1, 0),
                                                 (1, 1)]


@pytest.mark.parametrize("mode", ["global", "expertpar"])
def test_one_rank_mesh_is_bitwise_the_unpartitioned_step(tmp_path, runs,
                                                         mode):
    """A (1, 1) mesh in this process: every redistribution and every
    collective is over one rank, so the step is the same bits."""
    from repro_torch.launch.mesh import make_host_mesh

    inputs, _, _, whole = runs
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        got = _steps(MODES[mode], inputs, make_host_mesh(device_type="cpu"))
    finally:
        dist.destroy_process_group()
    want = whole[mode]
    assert got["loss"] == want["loss"] and got["aux"] == want["aux"]
    assert _max_err(got["params"], want["params"]) == 0.0
    for key in ("logits", "decode", "tokens"):
        np.testing.assert_array_equal(got[key], want[key])
    for g, w in zip(got["routing"], want["routing"]):
        for key in ("experts", "kept"):
            np.testing.assert_array_equal(g[key], w[key])


# ------------------------------------------------------------------- specs

def test_node_block_specs_with_expert_parallel_are_the_references():
    """`node_block_specs(..., expert_parallel=True)` = the reference's
    `make_param_specs(..., dfl_node_axis=True, expert_parallel=True)` on
    the multi mesh without "pod": the expert weights' E over "model"."""
    jax = pytest.importorskip("jax")
    from repro.dist import sharding as jax_sharding
    from repro_torch.dist.sharding import node_block_specs

    mesh = type("M", (), {"shape": {"pod": 2, "data": 2, "model": 2}})()
    params = tree_map(lambda t: torch.empty((2,) + tuple(t.shape),
                                            dtype=t.dtype, device="meta"),
                      _lm().init(torch.Generator(), device="meta"))
    np_tree = tree_map(lambda t: np.empty(t.shape, np.float32), params)
    want = jax.tree.leaves(
        jax_sharding.make_param_specs(np_tree, mesh, dfl_node_axis=True,
                                      expert_parallel=True),
        is_leaf=lambda s: type(s).__name__ == "PartitionSpec")
    got = node_block_specs(params, mesh, expert_parallel=True)
    leaves = _spec_leaves(got)
    assert len(leaves) == len(want) > 0
    assert all(tuple(g) == tuple(None if e == "pod" else e for e in w)
               for g, w in zip(leaves, want))
    assert tuple(got["layers"]["moe"]["wg"]) == (None, None, "model", None,
                                                 "data")
    assert node_block_specs(params, mesh) != got


def test_split_norm_counts_each_expert_shard_once():
    """B.2's split norm on the multi mesh's `expertpar` node block: over
    the (data = 2, model = 2) sub-mesh's four ranks, every leaf's
    elements enter the norm exactly once (`_counted_here`), the experts
    split over "model" as any other shard and the replicated leaves at
    coordinate 0 only."""
    import math

    from repro_torch.dist.dfl_step import _counted_here
    from repro_torch.dist.sharding import node_block_specs, placements

    mesh = type("M", (), {"shape": {"pod": 2, "data": 2, "model": 2}})()
    sub = type("Sub", (), {"mesh_dim_names": ("data", "model")})()
    params = tree_map(lambda t: torch.empty((1,) + tuple(t.shape),
                                            dtype=t.dtype, device="meta"),
                      _lm(EXPERTPAR).init(torch.Generator(), device="meta"))
    specs = node_block_specs(params, mesh, expert_parallel=True)
    assert tuple(specs["layers"]["moe"]["wd"])[2] == "model"
    for t, spec in zip(tree_leaves(params), _spec_leaves(specs)):
        pl = placements(spec, sub)
        split = math.prod(2 for p in pl if p.is_shard())
        counted = sum(_counted_here(pl, (d, m)) for d in range(2)
                      for m in range(2))
        assert counted * (t.numel() // split) == t.numel(), spec


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
@pytest.mark.parametrize("arch", ["mixtral-8x7b", "arctic-480b"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_split_kernels_at_the_moe_heads(card, arch, dtype):
    """The split B.9 at the MoE archs' heads, hd 128 cut in two (hdl 64):
    mixtral's G = 4 (CUDA-core scores) and arctic's G = 7 (tensor-core
    scores at bf16), each shard's partial scores summed, then each
    shard's softmax-combine, against the plain versions."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import decode_attention as _da
    from repro_torch.kernels import ops

    cfg = get_config(arch)
    b, w, kk, hd = 4, 4096, cfg.n_kv_heads, cfg.head_dim
    h = cfg.n_heads
    g = torch.Generator().manual_seed(h)
    q = torch.randn(b, h, hd, generator=g).to(dtype)
    k = torch.randn(b, w, kk, hd, generator=g).to(dtype)
    v = torch.randn(b, w, kk, hd, generator=g).to(dtype)
    slot_pos = torch.arange(w, dtype=torch.int32)
    slot_pos[w // 3:w // 2] = -1
    pos = torch.tensor(w - 2, dtype=torch.int32)
    scale = 1.0 / hd ** 0.5
    halves = [(a.contiguous(), c.contiguous(), d.contiguous()) for a, c, d
              in zip(*(torch.chunk(t, 2, dim=-1) for t in (q, k, v)))]
    want = sum(_da.scores_partial_plain(a, c, scale) for a, c, _ in halves)
    got = sum(ops.decode_scores_partial(a.to(card), c.to(card), scale).cpu()
              for a, c, _ in halves)
    terms = scale * torch.einsum("bkgd,bwkd->bkgw", q.float().abs().reshape(
        b, kk, h // kk, hd), k.float().abs()).reshape(b, h, w)
    assert (torch.abs(got - want) <= 1e-6 + 1e-5 * terms).all()
    for window in (0, cfg.sliding_window or 17):
        for _, _, d in halves:
            ref = _da.softmax_combine_plain(got, d, slot_pos, pos, window)
            out = ops.decode_softmax_combine(
                got.to(card), d.to(card), slot_pos.to(card), pos.to(card),
                window).cpu()
            vt = d.float().abs().amax(dim=1).repeat_interleave(h // kk, 1)
            assert (torch.abs(out - ref) <= 1e-6 + 1e-5 * vt).all()
