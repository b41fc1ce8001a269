"""Partition specs on a DeviceMesh (ROADMAP A.11.3): the port's
`repro_torch.dist.sharding` against the JAX package's, on the CPU.

  * every registered architecture at full width, on both production mesh
    shapes (a `FakeMesh` of {data: 16, model: 16} and {pod: 2, data: 16,
    model: 16}): the parameter specs (plain, with the DFL node axis, with
    expert parallelism), the batch specs at the dry run's four shapes
    (single pod, the multi-pod DFL round's [P, B / P, ...] batch, multi-pod
    prefill over ("pod", "data")) and the decode caches' specs equal the
    reference's exactly — the reference's trees from `jax.eval_shape`, the
    port's from the meta device, nothing allocated;
  * the four spec tests of tests/test_dist.py, on the port's tensors;
  * placement: on a fake process group of 512 ranks, every leaf's local
    shape is its global shape with each sharded dim divided by its axes'
    sizes; on four gloo ranks (a (data = 2, model = 2) mesh over a reduced
    qwen1.5-0.5b), each rank's `to_local()` is its slice and
    `full_tensor()` is the original, bitwise.  The spawned ranks import
    neither `jax` nor `repro` (this module imports JAX inside tests only).
"""
import dataclasses
import os
import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402

from repro_torch.dist.sharding import (  # noqa: E402
    P,
    distribute_tree,
    leaf_spec,
    make_batch_specs,
    make_cache_specs,
    make_param_specs,
    placements,
)
from repro_torch.utils.pytree import tree_leaves, tree_map  # noqa: E402

ARCHS = ["deepseek-7b", "qwen1.5-0.5b", "qwen2.5-14b", "qwen3-32b",
         "llava-next-mistral-7b", "mixtral-8x7b", "arctic-480b",
         "mamba2-2.7b", "zamba2-2.7b", "whisper-large-v3"]
SHAPES = {"train_4k": (4096, 256, "train"),
          "prefill_32k": (32768, 32, "prefill"),
          "decode_32k": (32768, 128, "decode"),
          "long_500k": (524288, 1, "decode")}


class FakeMesh:
    def __init__(self, **shape):
        self.shape = shape


MESHES = {"single": FakeMesh(data=16, model=16),
          "multi": FakeMesh(pod=2, data=16, model=16)}


def _jax():
    jax = pytest.importorskip("jax")
    return jax


def _jspecs_leaves(tree):
    from jax.sharding import PartitionSpec

    jax = _jax()
    return [tuple(s) for s in jax.tree.leaves(
        tree, is_leaf=lambda x: isinstance(x, PartitionSpec))]


def _tspecs_leaves(tree):
    return [tuple(s) for s in tree_leaves(tree)]


_TREES = {}


def _param_trees(arch):
    """(reference abstract params, the port's meta params) at full width."""
    if arch not in _TREES:
        jax = _jax()
        from repro.configs import get_config as jget
        from repro.models.lm import build_lm as jbuild
        from repro_torch.configs import get_config
        from repro_torch.models.lm import build_lm

        jtree = jax.eval_shape(
            lambda: jbuild(jget(arch)).init(jax.random.PRNGKey(0)))
        ttree = build_lm(get_config(arch)).init(torch.Generator(),
                                                device="meta")
        _TREES[arch] = (jtree, ttree)
    return _TREES[arch]


def _lead(jtree, ttree, n):
    jax = _jax()
    return (jax.tree.map(lambda s: jax.ShapeDtypeStruct((n,) + s.shape,
                                                        s.dtype), jtree),
            tree_map(lambda t: torch.empty((n,) + tuple(t.shape),
                                           dtype=t.dtype, device="meta"),
                     ttree))


@pytest.mark.parametrize("mesh_kind", ["single", "multi"])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_the_reference(arch, mesh_kind):
    jax = _jax()
    from repro.dist import sharding as jsh

    jtree, ttree = _param_trees(arch)
    assert [(s.shape, str(s.dtype)) for s in jax.tree.leaves(jtree)] == [
        (tuple(t.shape), str(t.dtype).split(".")[1])
        for t in tree_leaves(ttree)]
    mesh = MESHES[mesh_kind]
    for dfl, expert in [(False, False), (False, True), (True, False),
                        (True, True)]:
        jt, tt = _lead(jtree, ttree, 2) if dfl else (jtree, ttree)
        want = _jspecs_leaves(jsh.make_param_specs(
            jt, mesh, dfl_node_axis=dfl, expert_parallel=expert))
        got = make_param_specs(tt, mesh, dfl_node_axis=dfl,
                               expert_parallel=expert)
        assert _tspecs_leaves(got) == want, (dfl, expert)
        assert all(isinstance(s, P) for s in tree_leaves(got))


@pytest.mark.parametrize("shape_name", sorted(SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_specs_match_the_reference(arch, shape_name):
    jax = _jax()
    from repro.configs import get_config as jget
    from repro.dist import sharding as jsh
    from repro.models.lm import build_lm as jbuild
    from repro_torch.configs import get_config
    from repro_torch.models.lm import build_lm

    seq, batch, _ = SHAPES[shape_name]
    jspec = jbuild(jget(arch)).input_specs(batch, seq)
    tspec = build_lm(get_config(arch)).input_specs(batch, seq)
    assert {k: (tuple(v.shape), str(v.dtype)) for k, v in jspec.items()} \
        == {k: (tuple(s), str(d).split(".")[1]) for k, (s, d) in
            tspec.items()}
    for mesh in MESHES.values():
        cases = [({}, jspec, tspec)]
        if "pod" in mesh.shape:
            n = mesh.shape["pod"]
            if batch % n == 0:  # the DFL round's [P, B / P, ...] batch
                cases.append((dict(dfl_node_axis=True), {
                    k: jax.ShapeDtypeStruct((n, batch // n) + v.shape[1:],
                                            v.dtype)
                    for k, v in jspec.items()}, {
                    k: ((n, batch // n) + tuple(s[1:]), d)
                    for k, (s, d) in tspec.items()}))
            cases.append((dict(dp_axes=("pod", "data")), jspec, tspec))
        for kw, j, t in cases:
            assert _tspecs_leaves(make_batch_specs(t, mesh, **kw)) == \
                _jspecs_leaves(jsh.make_batch_specs(j, mesh, **kw)), kw


@pytest.mark.parametrize("shape_name", ["decode_32k", "long_500k"])
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_match_the_reference(arch, shape_name):
    jax = _jax()
    from repro.configs import get_config as jget
    from repro.dist import sharding as jsh
    from repro.models.lm import build_lm as jbuild
    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import _adapt_config
    from repro_torch.models.lm import build_lm

    seq, batch, _ = SHAPES[shape_name]
    tcfg = _adapt_config(get_config(arch), shape_name)
    jcfg = dataclasses.replace(jget(arch), decode_window=tcfg.decode_window,
                               remat=tcfg.remat)
    jcache = jax.eval_shape(lambda: jbuild(jcfg).init_cache(batch, seq))
    tcache = build_lm(tcfg).init_cache(batch, seq, device="meta")
    jpaths = [(jax.tree_util.keystr(p), s.shape) for p, s in
              jax.tree_util.tree_flatten_with_path(jcache)[0]]
    tflat = sorted(_flat_paths(tcache))
    assert [(p, tuple(s)) for p, s in tflat] == [
        (p, tuple(s)) for p, s in sorted(jpaths)]
    for mesh in MESHES.values():
        want = dict(zip(
            [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(jcache)[0]],
            _jspecs_leaves(jsh.make_cache_specs(jcache, mesh))))
        got = dict((p, tuple(s)) for p, s in
                   _flat_paths(make_cache_specs(tcache, mesh), spec=True))
        assert got == want


def _flat_paths(tree, prefix="", spec=False):
    """[(jax keystr-style path, shape or spec)] of a nested dict / list."""
    if spec and isinstance(tree, P) or not spec and isinstance(
            tree, torch.Tensor):
        return [(prefix, tree if spec else tree.shape)]
    out = []
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, v in items:
        key = f"[{k!r}]" if isinstance(tree, dict) else f"[{k}]"
        out.extend(_flat_paths(v, prefix + key, spec))
    return out


# ------------------------------------------------ tests/test_dist.py's four

def test_leaf_spec_divisibility():
    mesh = MESHES["single"]
    assert leaf_spec((1024, 4096), torch.float32, 0, "data", "model",
                     mesh) == P("data", "model")
    assert leaf_spec((1000, 56), torch.float32, 0, "data", "model",
                     mesh) == P(None, None)
    assert leaf_spec((1 << 20,), torch.int32, 0, "data", "model",
                     mesh) == P(None)
    assert leaf_spec((1 << 20,), torch.bool, 0, "data", "model",
                     mesh) == P(None)
    assert leaf_spec((128,), torch.float32, 0, "data", "model",
                     mesh) == P(None)
    # numpy dtypes, as the reference passes them
    assert leaf_spec((1 << 20,), np.int32, 0, "data", "model",
                     mesh) == P(None)


def test_param_specs_reserve_stack_dims():
    tree = {"layers": {"w": torch.empty((64, 1024, 4096), device="meta")},
            "embed": {"table": torch.empty((151936, 1024), device="meta")}}
    specs = make_param_specs(tree, MESHES["single"])
    assert specs["layers"]["w"][0] is None  # L dim never sharded
    assert "model" in specs["layers"]["w"]
    assert specs["embed"]["table"] == P("model", "data")


def test_batch_specs():
    mesh = MESHES["single"]
    specs = make_batch_specs({"tokens": ((256, 4096), torch.int32)}, mesh)
    assert specs["tokens"] == P("data", None)
    # tensors work as the (shape, dtype) form does; a batch of 3 replicates
    tokens = torch.zeros((3, 4096), dtype=torch.int32, device="meta")
    assert make_batch_specs({"tokens": tokens}, mesh)["tokens"] == \
        P(None, None)


def test_cache_specs_avoid_window_dim():
    tree = {"k": torch.empty((64, 128, 32768, 8, 128), dtype=torch.bfloat16,
                             device="meta")}
    spec = make_cache_specs(tree, MESHES["single"])["k"]
    assert spec[1] == "data" and spec[4] == "model" and spec[2] is None


def test_placements_shard_where_the_spec_names_an_axis():
    import types

    from torch.distributed.tensor import Replicate, Shard

    mesh = types.SimpleNamespace(mesh_dim_names=("pod", "data", "model"))
    assert placements(P(("pod", "data"), None, "model"), mesh) == [
        Shard(0), Shard(0), Shard(2)]
    assert placements(P(None, "data"), mesh) == [Replicate(), Shard(1),
                                                 Replicate()]
    assert placements(P(), mesh) == [Replicate()] * 3


def test_spec_compares_as_the_reference_spec():
    from jax.sharding import PartitionSpec

    _jax()
    assert P("data", None, ("pod", "data")) == PartitionSpec(
        "data", None, ("pod", "data"))
    assert P() == PartitionSpec() and repr(P("model")) == "P('model',)"


# ------------------------------------------------------------- placement

def _divided(shape, spec, sizes):
    out = list(shape)
    for i, entry in enumerate(spec):
        names = entry if isinstance(entry, tuple) else (entry,)
        for name in names:
            if name is not None:
                out[i] //= sizes[name]
    return tuple(out)


@pytest.mark.parametrize("arch,expert", [("qwen1.5-0.5b", False),
                                         ("mixtral-8x7b", True)])
def test_fake_512_rank_mesh_places_every_leaf(arch, expert):
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import fake_mesh
    from repro_torch.models.lm import build_lm

    dims, names = (2, 16, 16), ("pod", "data", "model")
    sizes = dict(zip(names, dims))
    with fake_mesh(dims, names) as mesh, FakeTensorMode():
        lm = build_lm(get_config(arch))
        one = lm.init(torch.Generator(), device="cpu")
        params = tree_map(lambda *xs: torch.stack(xs), one, one)
        specs = make_param_specs(params, mesh, dfl_node_axis=True,
                                 expert_parallel=expert)
        placed = distribute_tree(params, specs, mesh)
        n_sharded = 0
        for t, s, d in zip(tree_leaves(params), tree_leaves(specs),
                           tree_leaves(placed)):
            assert tuple(d.shape) == tuple(t.shape)
            assert tuple(d.to_local().shape) == _divided(t.shape, s, sizes)
            assert s[0] == "pod"
            n_sharded += any(e in ("data", "model") for e in s)
        assert n_sharded >= 5
    assert not dist.is_initialized()


def _gloo_worker(rank, world_size, tmp):
    """One rank of the (data = 2, model = 2) mesh: each placed leaf's local
    block and full tensor against the original, results pickled."""
    import sys

    from repro_torch.configs import get_config
    from repro_torch.models.lm import build_lm

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(
        os.path.join(tmp, "store"), world_size), rank=rank,
        world_size=world_size)
    try:
        from torch.distributed.device_mesh import init_device_mesh

        mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data",
                                                               "model"))
        coord = dict(zip(("data", "model"), mesh.get_coordinate()))
        lm = build_lm(get_config("qwen1.5-0.5b").reduced())
        params = lm.init(torch.Generator().manual_seed(5), device="cpu")
        specs = make_param_specs(params, mesh)
        placed = distribute_tree(params, specs, mesh)
        out = {"local": [], "full": [], "sharded": 0}
        for t, s, d in zip(tree_leaves(params), tree_leaves(specs),
                           tree_leaves(placed)):
            want = t
            for i, entry in enumerate(s):
                if entry is not None:
                    want = torch.chunk(want, 2, dim=i)[coord[entry]]
            out["local"].append(torch.equal(d.to_local(), want))
            out["full"].append(torch.equal(d.full_tensor(), t))
            out["sharded"] += any(e is not None for e in s)
        out["imported"] = sorted(k for k in sys.modules
                                 if k.split(".")[0] in ("jax", "repro"))
        with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def test_four_gloo_ranks_place_a_reduced_lm(tmp_path):
    mp.spawn(_gloo_worker, args=(4, str(tmp_path)), nprocs=4, join=True)
    for r in range(4):
        with open(tmp_path / f"rank{r}.pkl", "rb") as f:
            out = pickle.load(f)
        assert all(out["local"]) and all(out["full"]), r
        assert out["sharded"] >= 3 and out["imported"] == []
