"""Checkpoints (ROADMAP A.11.2): the port's `repro_torch.checkpoint`
against the JAX package's `repro.checkpoint`, on the CPU.

The on-disk format is the reference's: `step_<N:08d>/arrays.npz` (one
`<key>.npy` member per leaf, keys the '/'-joined tree paths in
`tree_flatten_with_path` order) and `manifest.json`.  A bf16 leaf crosses
without `ml_dtypes`, as its 2-byte pattern under the npy header '<V2'.
What is held:

  * the reference's own cases (round trip, `latest_step` over steps 1, 5,
    3, a named step), list leaves, overwriting a step, every dtype;
  * the same tree written by both packages: every npy member byte for
    byte, and the manifests equal;
  * JAX writes a reduced bf16 qwen1.5-0.5b and the port restores it:
    bitwise `convert.params_from_numpy` of the same arrays, and the port's
    forward on them within the LM tests' whole-forward tolerance (rtol =
    atol = 1e-4) of JAX's;
  * the port writes and the reference's `restore_checkpoint` reads:
    bitwise arrays and an equal manifest.  The reference cannot restore a
    bf16 leaf, its own or the port's (numpy finds no cast from the stored
    'V2' to ml_dtypes' bfloat16): both are held to the same outcome;
  * `launch/train.py --ckpt-dir` in both packages on the same reduced
    arguments: equal manifest keys, shapes, dtypes and metadata (the
    values differ by init stream).
"""
import json
import os
import sys
import zipfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.checkpoint import (  # noqa: E402
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)
from repro_torch.utils.pytree import tree_leaves  # noqa: E402

FWD_RTOL, FWD_ATOL = 1e-4, 1e-4


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads: the suite runs several worker processes at
    once, and every worker spinning a thread per core slows them all."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _members(step_dir):
    """{member name: its bytes} of a checkpoint's npz."""
    with zipfile.ZipFile(os.path.join(step_dir, "arrays.npz")) as zf:
        return {n: zf.read(n) for n in zf.namelist()}


def _manifest(step_dir):
    with open(os.path.join(step_dir, "manifest.json")) as f:
        return json.load(f)


def _mixed_tree(rng):
    """A tree of every leaf kind the LM state has, as numpy (bf16 as
    float32 values that bf16 holds exactly) and as port tensors."""
    bf = rng.standard_normal((3, 5)).astype(np.float32)
    bf = torch.from_numpy(bf).to(torch.bfloat16)
    arrays = {"params": {"w": rng.standard_normal((4, 6)).astype(np.float32),
                         "emb": bf.float().numpy()},
              "opt": {"momentum": {"w": np.zeros((4, 6), np.float32)}},
              "count": np.asarray(7, np.int32)}
    tensors = {"params": {"w": torch.from_numpy(arrays["params"]["w"]),
                          "emb": bf},
               "opt": {"momentum": {"w": torch.zeros((4, 6))}},
               "count": torch.tensor(7, dtype=torch.int32)}
    jtree = {"params": {"w": jnp.asarray(arrays["params"]["w"]),
                        "emb": jnp.asarray(arrays["params"]["emb"],
                                           jnp.bfloat16)},
             "opt": {"momentum": {"w": jnp.zeros((4, 6), jnp.float32)}},
             "count": jnp.asarray(7, jnp.int32)}
    return arrays, tensors, jtree


# ---------------------------------------------------------- the port alone

def test_checkpoint_roundtrip(tmp_path):
    tree = {
        "params": {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3),
                   "b": torch.zeros(3)},
        "momentum": {"w": torch.ones((2, 3)) * 0.5, "b": torch.zeros(3)},
    }
    d = str(tmp_path / "ckpt")
    save_checkpoint(d, 42, tree, metadata={"note": "test"})
    assert latest_step(d) == 42
    restored, manifest = restore_checkpoint(d, device="cpu")
    assert manifest["step"] == 42 and manifest["metadata"]["note"] == "test"
    for a, b in zip(tree_leaves(restored), tree_leaves(tree)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_checkpoint_multiple_steps(tmp_path):
    d = str(tmp_path / "ckpt")
    assert latest_step(d) is None
    for s in (1, 5, 3):
        save_checkpoint(d, s, {"x": torch.tensor([float(s)])})
    assert latest_step(d) == 5
    tree, manifest = restore_checkpoint(d, step=3, device="cpu")
    assert tree["x"][0].item() == 3.0 and manifest["step"] == 3
    tree, _ = restore_checkpoint(d, device="cpu")
    assert tree["x"][0].item() == 5.0


def test_list_leaves_keep_their_places(tmp_path):
    tree = {"blocks": [torch.ones(2), {"a": torch.zeros(3)},
                       torch.full((1,), 2.0)],
            "z": torch.tensor(1.0)}
    d = str(tmp_path / "ckpt")
    save_checkpoint(d, 1, tree)
    manifest = _manifest(os.path.join(d, "step_00000001"))
    assert list(manifest["keys"]) == ["blocks/[0]", "blocks/[1]/a",
                                      "blocks/[2]", "z"]
    restored, _ = restore_checkpoint(d, device="cpu")
    assert isinstance(restored["blocks"], list)
    assert torch.equal(restored["blocks"][0], tree["blocks"][0])
    assert torch.equal(restored["blocks"][1]["a"], tree["blocks"][1]["a"])
    assert torch.equal(restored["blocks"][2], tree["blocks"][2])


def test_overwriting_a_step_leaves_no_temporary(tmp_path):
    d = str(tmp_path / "ckpt")
    save_checkpoint(d, 2, {"x": torch.zeros(4)})
    path = save_checkpoint(d, 2, {"x": torch.ones(4), "y": torch.ones(1)})
    assert path == os.path.join(d, "step_00000002")
    assert sorted(os.listdir(d)) == ["step_00000002"]
    tree, manifest = restore_checkpoint(d, device="cpu")
    assert torch.equal(tree["x"], torch.ones(4)) and set(manifest["keys"]) \
        == {"x", "y"}


def test_missing_checkpoint_and_default_device(tmp_path, monkeypatch):
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path / "none"), device="cpu")
    d = str(tmp_path / "ckpt")
    save_checkpoint(d, 0, {"x": torch.zeros(1)})
    # device=None means the card, and raises on a host without one
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        restore_checkpoint(d)


@pytest.mark.parametrize("dtype", [
    torch.bool, torch.int8, torch.uint8, torch.int16, torch.int32,
    torch.int64, torch.float16, torch.float32, torch.float64,
    torch.bfloat16])
def test_every_dtype_round_trips_bitwise(tmp_path, dtype):
    g = torch.Generator().manual_seed(3)
    x = torch.randn((3, 4), generator=g) * 50
    x = x > 0 if dtype == torch.bool else x.to(dtype)
    d = str(tmp_path / "ckpt")
    save_checkpoint(d, 1, {"x": x, "s": x[0, 0]})
    tree, manifest = restore_checkpoint(d, device="cpu")
    for key, want in (("x", x), ("s", x[0, 0])):
        assert tree[key].dtype == dtype and tree[key].shape == want.shape
        assert torch.equal(tree[key], want)
    assert manifest["keys"]["s"]["shape"] == []


# ------------------------------------------------------- against the JAX package

def test_both_packages_write_the_same_bytes(tmp_path):
    from repro.checkpoint import save_checkpoint as jsave

    _, tensors, jtree = _mixed_tree(np.random.default_rng(0))
    meta = {"arch": "x", "mode": "dfl"}
    pj = jsave(str(tmp_path / "j"), 9, jtree, metadata=meta)
    pt = save_checkpoint(str(tmp_path / "t"), 9, tensors, metadata=meta)
    mj, mt = _members(pj), _members(pt)
    assert list(mj) == list(mt)
    for name in mj:  # header and data of every leaf, byte for byte
        assert mj[name] == mt[name], name
    assert mj["params/emb.npy"][:60].find(b"'<V2'") > 0
    with open(os.path.join(pj, "manifest.json")) as f:
        text_j = f.read()
    with open(os.path.join(pt, "manifest.json")) as f:
        assert f.read() == text_j
    assert _manifest(pt)["keys"]["params/emb"]["dtype"] == "bfloat16"


def test_reference_writes_bf16_lm_and_the_port_restores(tmp_path):
    """JAX saves a reduced bf16 qwen1.5-0.5b; the port's restore is bitwise
    `convert.params_from_numpy` of the same arrays, and its forward on them
    agrees with JAX's."""
    from repro.checkpoint import save_checkpoint as jsave
    from repro.configs import get_config as jget
    from repro.models.lm import build_lm as jbuild
    from repro_torch.configs import get_config
    from repro_torch.models.lm import build_lm

    over = dict(n_layers=2, d_model=64, vocab=256, param_dtype="bfloat16")
    jcfg, tcfg = (jget("qwen1.5-0.5b").reduced(**over),
                  get_config("qwen1.5-0.5b").reduced(**over))
    jlm, tlm = jbuild(jcfg), build_lm(tcfg)
    jparams = jlm.init(jax.random.PRNGKey(2))
    assert {str(x.dtype) for x in jax.tree.leaves(jparams)} == {"bfloat16"}
    jsave(str(tmp_path), 4, {"params": jparams}, metadata={"arch": "q"})
    tree, manifest = restore_checkpoint(str(tmp_path), device="cpu")
    want = convert.params_from_numpy(
        jax.tree.map(lambda x: np.asarray(x, np.float32), jparams),
        device="cpu", dtypes=jax.tree.map(lambda x: str(x.dtype), jparams))
    got_leaves, want_leaves = tree_leaves(tree["params"]), tree_leaves(want)
    assert len(got_leaves) == len(want_leaves)
    for a, b in zip(got_leaves, want_leaves):
        assert a.dtype == b.dtype == torch.bfloat16 and torch.equal(a, b)
    assert manifest["metadata"] == {"arch": "q"} and manifest["step"] == 4

    tokens = np.random.default_rng(1).integers(0, 256, (2, 16)).astype(
        np.int32)
    jlogits, _ = jlm.forward(jparams, {"tokens": jnp.asarray(tokens)})
    tlogits, _ = tlm.forward(tree["params"],
                             {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(tlogits.float().numpy(),
                               np.asarray(jlogits, np.float32),
                               rtol=FWD_RTOL, atol=FWD_ATOL)


def test_port_writes_and_the_reference_reads(tmp_path):
    from repro.checkpoint import restore_checkpoint as jrestore
    from repro.checkpoint import save_checkpoint as jsave

    arrays, tensors, jtree = _mixed_tree(np.random.default_rng(1))
    # without the bf16 leaf: bitwise arrays, equal manifest
    plain = {k: v for k, v in tensors.items() if k != "params"}
    plain["params"] = {"w": tensors["params"]["w"]}
    save_checkpoint(str(tmp_path / "t"), 3, plain, metadata={"m": 1},
                    shardings={"params/w": "('data', 'model')"})
    got, manifest = jrestore(str(tmp_path / "t"))
    assert manifest == _manifest(str(tmp_path / "t" / "step_00000003"))
    assert manifest["sharding"] == {"params/w": "('data', 'model')"}
    np.testing.assert_array_equal(got["params"]["w"], arrays["params"]["w"])
    assert got["params"]["w"].dtype == np.float32
    np.testing.assert_array_equal(got["opt"]["momentum"]["w"],
                                  arrays["opt"]["momentum"]["w"])
    assert got["count"].dtype == np.int32 and int(got["count"]) == 7

    # with the bf16 leaf: the reference meets the port's checkpoint as it
    # meets its own
    save_checkpoint(str(tmp_path / "tb"), 3, tensors)
    jsave(str(tmp_path / "jb"), 3, jtree)

    def outcome(d):
        try:
            tree, man = jrestore(d)
        except Exception as e:  # noqa: BLE001 — compared below
            return type(e).__name__, str(e)
        return jax.tree.map(lambda x: np.asarray(x).tobytes(), tree), man

    assert outcome(str(tmp_path / "tb")) == outcome(str(tmp_path / "jb"))
    # and what JAX writes for it reads back through ml_dtypes bit for bit
    import ml_dtypes

    with np.load(os.path.join(tmp_path, "tb", "step_00000003",
                              "arrays.npz")) as z:
        emb = z["params/emb"].view(ml_dtypes.bfloat16)
    np.testing.assert_array_equal(emb.view(np.int16),
                                  np.asarray(jtree["params"]["emb"]).view(
                                      np.int16))


def test_train_ckpt_dir_writes_the_reference_manifest(tmp_path, monkeypatch,
                                                      capsys):
    from repro.launch import train as jtrain
    from repro_torch.launch import train

    args = ["--steps", "2", "--nodes", "2", "--batch", "2", "--seq", "16",
            "--log-every", "1"]
    losses, params, opt_state = train.run(
        args + ["--device", "cpu", "--ckpt-dir", str(tmp_path / "t")])
    assert len(losses) == 2 and np.isfinite(losses).all()
    out = capsys.readouterr().out
    assert f"checkpoint: {tmp_path / 't' / 'step_00000002'}" in out
    monkeypatch.setattr(sys, "argv", ["train"] + args + [
        "--ckpt-dir", str(tmp_path / "j")])
    jtrain.main()
    mt = _manifest(str(tmp_path / "t" / "step_00000002"))
    mj = _manifest(str(tmp_path / "j" / "step_00000002"))
    assert list(mt["keys"]) == list(mj["keys"]) and mt == {
        **mj, "keys": mt["keys"]}
    assert mt["keys"] == mj["keys"]
    assert mt["metadata"] == {"arch": "qwen1.5-0.5b", "mode": "dfl"}
    # the restored state is what the run ended with
    tree, _ = restore_checkpoint(str(tmp_path / "t"), device="cpu")
    for a, b in zip(tree_leaves(tree), tree_leaves(
            {"params": params, "opt": opt_state})):
        assert torch.equal(a, b)
