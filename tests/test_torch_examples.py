"""The port's examples (`examples_torch/`) against the reference examples.

  * the worlds, exactly: quickstart's ER world, compressed_gossip's smoke
    world and decentralized_mnist's `build_world` equal the reference's
    array for array (numpy-only builders, equal by construction), and the
    printed Gini line is the same text;
  * 3 rounds of each example's Experiment spec from the reference's init
    (quickstart's two methods fused, compressed_gossip's six transports
    with int8 deterministic, `run_method` for decdiff+vt and fedavg):
    params within 1e-6 without a transport and 1e-4 plus one codec grain
    with one (ROADMAP C.1), accuracies within one test sample, bytes and
    triggers exact;
  * the Table II / IV strings and characteristic times exactly the
    reference's for the same result dicts;
  * `eval_every=2` over 5 rounds in loop and fused mode (the examples
    evaluate every 5 and 10 rounds) against the reference's loop run;
  * each `main(argv)` on `--device cpu` at a smoke size, printing the
    reference's line formats, and `device=None` refusing a host without
    CUDA; the multi-pod example without a process group and at two gloo
    ranks, bitwise the same, the node0-node1 distance shrinking.

Nothing here writes under `artifacts/`: the reference's
`bench_accuracy.run` (which saves its table there) is never called.
"""
import dataclasses
import importlib.util
import io
import os
import pickle
import re
import sys
from contextlib import redirect_stdout

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402

from repro_torch import convert  # noqa: E402

ROOT = os.path.join(os.path.dirname(__file__), "..")
ROUND = (r"\[{m}\] round +\d+  acc \d\.\d{{4}} ± \d\.\d{{4}}  loss "
         r"(\d+\.\d{{4}}|nan)")


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _example(name):
    """The port's `examples_torch/<name>.py` as a module."""
    return _load(os.path.join(ROOT, "examples_torch", f"{name}.py"),
                 f"examples_torch_{name}")


def _reference_example(name):
    """The reference's `examples/<name>.py` as a module (importing it runs
    nothing but its path setup)."""
    return _load(os.path.join(ROOT, "examples", f"{name}.py"),
                 f"examples_{name}")


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads: the suite runs several worker processes at
    once, and every worker spinning a thread per core slows them all."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def qs():
    return _example("quickstart")


@pytest.fixture(scope="module")
def cg():
    return _example("compressed_gossip")


@pytest.fixture(scope="module")
def dm():
    return _example("decentralized_mnist")


def _used(n_test):
    """Test samples the eval reads (it drops the last partial batch)."""
    b = min(128, n_test)
    return (n_test // b) * b


def _same_arrays(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


# ------------------------------------------------------------ the worlds

def _reference_quickstart_world(nodes):
    """The reference example's step 1 (examples/quickstart.py:33-43)."""
    from repro.data import make_dataset, zipf_allocation
    from repro.data.allocation import allocation_gini, split_by_allocation
    from repro.engine import World as JWorld
    from repro.graphs import make_topology
    from repro.models.mlp_cnn import model_for_dataset

    ds = make_dataset("synth-mnist", seed=0, scale=0.05)
    topo = make_topology("erdos_renyi", n=nodes, p=0.25, seed=0)
    alloc = zipf_allocation(ds.y_train, topo.num_nodes, seed=0,
                            min_per_class=1)
    xs, ys = split_by_allocation(ds.x_train, ds.y_train, alloc)
    line = (f"graph: {topo.name}  (connected={topo.connected})  "
            f"label-skew Gini={allocation_gini(alloc, ds.y_train):.2f}")
    world = JWorld(model=model_for_dataset("synth-mnist", ds.num_classes),
                   topo=topo, xs=xs, ys=ys,
                   x_test=ds.x_test, y_test=ds.y_test)
    return world, line


def _same_world(jw, tw):
    np.testing.assert_array_equal(tw.topo.adjacency, jw.topo.adjacency)
    np.testing.assert_array_equal(tw.topo.weights, jw.topo.weights)
    _same_arrays(tw.xs, jw.xs)
    _same_arrays(tw.ys, jw.ys)
    np.testing.assert_array_equal(tw.x_test, jw.x_test)
    np.testing.assert_array_equal(tw.y_test, jw.y_test)


@pytest.mark.parametrize("nodes", [16, 8])
def test_quickstart_world_is_the_reference(qs, nodes):
    jw, jline = _reference_quickstart_world(nodes)
    tw, tline = qs.build_world(nodes, "cpu")
    assert tline == jline
    _same_world(jw, tw)


def _same_tuple_world(jw, tw):
    """(ds, topo, xs, ys, model, ...) tuples, array for array."""
    jds, jtopo, jxs, jys = jw[:4]
    tds, ttopo, txs, tys = tw[:4]
    for f in ("x_train", "y_train", "x_test", "y_test"):
        np.testing.assert_array_equal(getattr(tds, f), getattr(jds, f))
    assert tds.num_classes == jds.num_classes
    np.testing.assert_array_equal(ttopo.adjacency, jtopo.adjacency)
    np.testing.assert_array_equal(ttopo.weights, jtopo.weights)
    assert ttopo.name == jtopo.name
    _same_arrays(txs, jxs)
    _same_arrays(tys, jys)
    jshapes = jax.tree.map(lambda a: a.shape, jw[4].init(
        jax.random.PRNGKey(0)))
    tshapes = {k: {kk: tuple(v.shape) for kk, v in d.items()}
               for k, d in tw[4].init(torch.Generator()).items()}
    assert tshapes == jshapes


@pytest.mark.parametrize("graph", ["ba", "er"])
def test_smoke_world_is_the_reference(cg, graph):
    from benchmarks.bench_comm import smoke_world

    _same_tuple_world(smoke_world(graph=graph), cg.smoke_world(graph=graph))


def test_smoke_world_refuses_unknown_graph(cg):
    with pytest.raises(ValueError, match="unknown smoke graph"):
        cg.smoke_world(graph="ring")


@pytest.mark.parametrize("kw", [dict(num_nodes=20, data_scale=0.05),
                                dict(num_nodes=8, topology="barabasi_albert")])
def test_build_world_is_the_reference(dm, kw):
    from benchmarks.common import WorldConfig, build_world

    assert [f.name for f in dataclasses.fields(dm.WorldConfig)] == \
        [f.name for f in dataclasses.fields(WorldConfig)]
    assert dataclasses.asdict(dm.WorldConfig()) == \
        dataclasses.asdict(WorldConfig())
    jw = build_world(WorldConfig(**kw))
    tw = dm.build_world(dm.WorldConfig(**kw))
    _same_tuple_world(jw, tw)
    assert tw[5] == jw[5]  # the Gini, exactly


# ---------------------------------------- runs from the reference's init

def _carry(exp, params0):
    """Start a port Experiment from the reference's init."""
    exp.params = convert.params_from_numpy(params0, "cpu")
    exp.opt_state = exp.optimizer.init(exp.params)
    if exp.transport is not None:
        exp.comm_state = exp.transport.init_state(exp.params)


def _grain(codec, jparams):
    top = max(float(np.abs(jparams[k][kk]).max())
              for k in jparams for kk in jparams[k])
    return {None: 0.0, "fp32": 0.0, "int8": top / 127.0,
            "bf16": top * 2.0 ** -7, "topk": top}[codec]


def _check_run(je, jhist, exp, thist, codec, n_test):
    """ROADMAP C.1's tolerances: params 1e-6 without a transport, 1e-4
    plus one codec grain with one; accuracies within one test sample;
    rounds, bytes and triggers exact."""
    jparams = jax.tree.map(np.asarray, je.params)
    tparams = convert.params_to_numpy(exp.params)
    bound = (1e-6 if exp.transport is None else 1e-4) + _grain(codec,
                                                              jparams)
    for layer in jparams:
        for leaf in jparams[layer]:
            np.testing.assert_allclose(tparams[layer][leaf],
                                       jparams[layer][leaf], rtol=0,
                                       atol=bound)
    assert [m.round for m in thist] == [m.round for m in jhist]
    for jm, tm in zip(jhist, thist):
        assert np.abs(tm.acc_per_node - jm.acc_per_node).max() \
            * _used(n_test) <= 1.0 + 1e-6
        assert tm.bytes_on_wire == jm.bytes_on_wire
        assert tm.triggered_frac == jm.triggered_frac
    assert exp.comm_bytes_total == je.comm_bytes_total
    assert exp.trig_history == list(je.trig_history)


@pytest.mark.parametrize("method", ["isol", "decdiff+vt"])
def test_quickstart_spec_matches_reference(qs, method):
    """The reference example's Experiment call (examples/quickstart.py:
    47-52) with rounds cut to 3, fused, eval every 10, on 8 nodes."""
    from repro.engine import Experiment as JExperiment
    from repro.engine import Schedule as JSchedule

    jw, _ = _reference_quickstart_world(8)
    je = JExperiment(jw, method,
                     schedule=JSchedule(rounds=3, eval_every=10,
                                        mode="fused"),
                     steps_per_round=4, batch_size=32, lr=0.1,
                     momentum=0.9, beta=0.95)
    params0 = jax.tree.map(np.asarray, je.params)
    jhist = je.run()
    tw, _ = qs.build_world(8, "cpu")
    exp = qs.experiment(tw, method, 3, 10)
    assert exp.schedule.mode == "fused"
    _carry(exp, params0)
    thist = exp.run()
    assert [m.round for m in thist] == [0, 2]
    _check_run(je, jhist, exp, thist, None, len(tw.y_test))


SWEEP = ["fp32", "bf16", "int8", "int8-thr1", "int8-adaptive", "topk"]


@pytest.fixture(scope="module")
def gossip_worlds(cg):
    from benchmarks.bench_comm import smoke_world

    return smoke_world(), cg.smoke_world()


@pytest.mark.parametrize("point", range(len(SWEEP)), ids=SWEEP)
def test_compressed_gossip_spec_matches_reference(cg, gossip_worlds, point):
    """The reference example's `run_one` (its decdiff+vt spec, fused, eval
    every 5) over 3 rounds for each point of the default sweep, int8
    deterministic; the port's `run_one` from the reference's init."""
    from repro.comm import CommConfig as JCommConfig
    from repro.engine import Experiment as JExperiment
    from repro.engine import World as JWorld

    ref = _reference_example("compressed_gossip")
    jworld, tworld = gossip_worlds
    comm = cg.default_sweep(stochastic=False)[point]
    jcomm = JCommConfig(**dataclasses.asdict(comm))
    ds, topo, xs, ys, model = jworld
    # the init `run_one` starts from: its spec's seed (the comm draws none)
    params0 = jax.tree.map(np.asarray, JExperiment(
        JWorld(model=model, topo=topo, xs=xs, ys=ys, x_test=ds.x_test,
               y_test=ds.y_test), "decdiff+vt", comm=jcomm,
        seed=0).params)
    je, jhist = ref.run_one(jworld, jcomm, 3)
    exp, thist = cg.run_one(tworld, comm, 3, device="cpu",
                            params=convert.params_from_numpy(params0,
                                                             "cpu"))
    assert exp.comm_bytes_total > 0
    _check_run(je, jhist, exp, thist, comm.codec, len(ds.y_test))


@pytest.fixture(scope="module")
def method_worlds(dm):
    from benchmarks.common import WorldConfig, build_world

    kw = dict(num_nodes=8, data_scale=0.02, rounds=3, eval_every=1)
    return (WorldConfig(**kw), build_world(WorldConfig(**kw)),
            dm.WorldConfig(**kw), dm.build_world(dm.WorldConfig(**kw)))


@pytest.mark.parametrize("method", ["decdiff+vt", "fedavg"])
def test_run_method_matches_reference(dm, method_worlds, method):
    """`benchmarks.common.run_method` against the example's copy, from the
    reference's init: the dict's keys, rounds and bytes per round exactly,
    accuracies within one test sample, losses within 1e-5."""
    from benchmarks.common import run_method
    from repro.engine import Experiment as JExperiment
    from repro.engine import World as JWorld

    jwc, jworld, twc, tworld = method_worlds
    ds, topo, xs, ys, model, _ = jworld
    params0 = jax.tree.map(np.asarray, JExperiment(
        JWorld(model=model, topo=topo, xs=xs, ys=ys, x_test=ds.x_test,
               y_test=ds.y_test), method, seed=jwc.seed).params)
    jr = run_method(jwc, method, world=jworld)
    tr = dm.run_method(twc, method, world=tworld, device="cpu",
                       params=convert.params_from_numpy(params0, "cpu"))
    assert list(tr) == list(jr)
    used = _used(len(ds.y_test))
    for key in ("method", "dataset", "gini", "rounds",
                "comm_bytes_per_round"):
        assert tr[key] == jr[key], key
    assert tr["comm_bytes_per_round"] > 0
    assert np.abs(np.subtract(tr["acc_per_node"], jr["acc_per_node"])).max() \
        * used <= 1.0 + 1e-6
    assert [h["round"] for h in tr["history"]] == \
        [h["round"] for h in jr["history"]] == [0, 1, 2]
    for th, jh in zip(tr["history"], jr["history"]):
        assert abs(th["acc_mean"] - jh["acc_mean"]) * used <= 1.0 + 1e-6
        assert th["loss_mean"] == pytest.approx(jh["loss_mean"], abs=1e-5)
    assert tr["loss_mean"] == pytest.approx(jr["loss_mean"], abs=1e-5)


def test_run_centralized_keys_and_schedule(dm, method_worlds):
    """The example's Centralized baseline has the reference's keys and
    epoch schedule (its init is the port's own draw)."""
    _, _, twc, tworld = method_worlds
    r = dm.run_centralized(twc, world=tworld, device="cpu")
    keys = ["method", "dataset", "gini", "acc_mean", "acc_std", "loss_mean",
            "wall_s", "history", "comm_bytes_per_round"]
    assert list(r) == keys
    assert r["method"] == "centralized" and r["comm_bytes_per_round"] == 0
    assert [h["epoch"] for h in r["history"]] == [0, 1]  # max(2, ...) epochs
    assert 0.0 <= r["acc_mean"] <= 1.0 and np.isfinite(r["loss_mean"])


# ------------------------------------------------------------- the tables

def _results(seed, methods, n_nodes=5, with_never=True):
    """Result dicts as `run` builds them, drawn from a numpy seed."""
    rng = np.random.default_rng(seed)
    res = {"_world": {"gini": 0.5}, "centralized": {
        "method": "centralized", "acc_mean": float(rng.uniform(0.7, 0.95)),
        "acc_std": 0.0}}
    for i, m in enumerate(methods):
        hist = [{"round": r, "acc_mean": float(a), "acc_std": 0.01,
                 "loss_mean": 1.0}
                for r, a in zip(range(0, 60, 5),
                                np.sort(rng.uniform(0.05, 0.95, 12)))]
        if with_never and i == 0:
            for h in hist:
                h["acc_mean"] = 0.1  # never reaches 50%
        res[m] = {"method": m, "acc_mean": hist[-1]["acc_mean"],
                  "acc_std": float(rng.uniform(0, 0.1)),
                  "acc_per_node": rng.uniform(0, 1, n_nodes).tolist(),
                  "history": hist}
    return res


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tables_match_reference(dm, seed):
    from benchmarks.bench_accuracy import METHODS
    from benchmarks.bench_accuracy import format_table as jtable
    from benchmarks.bench_char_time import THRESHOLDS
    from benchmarks.bench_char_time import characteristic_times as jct
    from benchmarks.bench_char_time import format_table as jct_table

    assert dm.METHODS == METHODS and dm.THRESHOLDS == THRESHOLDS
    res = {"synth-mnist": _results(seed, METHODS),
           "synth-fashion": _results(seed + 10, METHODS[:3],
                                     with_never=False)}
    assert dm.format_table(res) == jtable(res)
    ct = dm.characteristic_times(res)
    assert ct == jct(res)
    assert dm.format_char_times(ct) == jct_table(ct)
    assert ct["synth-mnist"]["times"][METHODS[0]] == dict.fromkeys(
        THRESHOLDS)


def test_characteristic_times_agree_with_metrics(dm):
    """`fl.metrics.characteristic_time` gives the table's rounds for the
    same histories (so either may serve)."""
    from repro_torch.fl.metrics import RoundMetrics, characteristic_time

    res = {"d": _results(5, dm.METHODS)}
    ct = dm.characteristic_times(res)
    cacc = res["d"]["centralized"]["acc_mean"]
    for m in dm.METHODS:
        hist = [RoundMetrics(round=h["round"],
                             acc_per_node=np.full(2, h["acc_mean"]),
                             loss_per_node=np.ones(2))
                for h in res["d"][m]["history"]]
        assert characteristic_time(hist, cacc, dm.THRESHOLDS) == \
            ct["d"]["times"][m]


# ------------------------------------------------------ eval_every > 1

@pytest.mark.parametrize("mode", ["loop", "fused"])
def test_eval_every_two_over_five_rounds(gossip_worlds, mode):
    """The examples evaluate every 5 and 10 rounds: `eval_every=2` over 5
    rounds (evals 0, 2, 4) in either mode against the reference's loop
    run, with the per-edge int8 transport."""
    from repro.comm import CommConfig as JCommConfig
    from repro.engine import Experiment as JExperiment
    from repro.engine import World as JWorld
    from repro_torch.comm import CommConfig
    from repro_torch.engine import Experiment, World

    cfg = dict(codec="int8", policy="adaptive", target_trigger=0.9,
               stochastic=False)
    jworld, tworld = gossip_worlds
    ds, topo, xs, ys, model = jworld
    je = JExperiment(JWorld(model=model, topo=topo, xs=xs, ys=ys,
                            x_test=ds.x_test, y_test=ds.y_test),
                     "decdiff+vt", comm=JCommConfig(**cfg),
                     steps_per_round=2, batch_size=32, lr=0.1)
    params0 = jax.tree.map(np.asarray, je.params)
    jhist = je.run(rounds=5, eval_every=2, mode="loop")
    tds, ttopo, txs, tys, tmodel = tworld
    exp = Experiment(World(model=tmodel, topo=ttopo, xs=txs, ys=tys,
                           x_test=tds.x_test, y_test=tds.y_test,
                           device="cpu"),
                     "decdiff+vt", comm=CommConfig(**cfg), device="cpu",
                     steps_per_round=2, batch_size=32, lr=0.1)
    _carry(exp, params0)
    thist = exp.run(rounds=5, eval_every=2, mode=mode)
    assert [m.round for m in thist] == [0, 2, 4]
    assert len(exp.trig_history) == len(exp.train_loss_history) == 5
    _check_run(je, jhist, exp, thist, "int8", len(ds.y_test))


# ------------------------------------------------------ main on the CPU

def _printed(capsys):
    return capsys.readouterr().out.splitlines()


def _in_order(lines, patterns):
    i = 0
    for pat in patterns:
        while i < len(lines) and not re.fullmatch(pat, lines[i]):
            i += 1
        assert i < len(lines), (pat, lines)
        i += 1


def test_quickstart_main_on_cpu(qs, capsys):
    hists = qs.main(["--device", "cpu", "--rounds", "2", "--nodes", "6",
                     "--eval-every", "1"])
    lines = _printed(capsys)
    pats = [r"graph: erdos_renyi\(n=6,p=0\.25\)  \(connected=(True|False)"
            r"\)  label-skew Gini=\d\.\d\d"]
    for m in ("isol", "decdiff+vt"):
        pats += [ROUND.format(m=re.escape(m))] * 2
        pats += [rf"--> {re.escape(m)}: final node-average accuracy "
                 rf"\d\.\d{{3}} ± \d\.\d{{3}}", ""]
    _in_order(lines, pats)
    assert len(lines) == len(pats)
    assert sorted(hists) == ["decdiff+vt", "isol"]
    assert all([m.round for m in h] == [0, 1] for h in hists.values())


def test_compressed_gossip_main_on_cpu(cg, capsys):
    rows = cg.main(["--device", "cpu", "--rounds", "2"])
    lines = _printed(capsys)
    assert lines[0] == (f"{'codec':>6} {'trigger':>14} | {'final acc':>9} | "
                        f"{'wire MB':>8} | {'trig':>5} | reduction")
    assert len(lines) == 7 and len(rows) == 6
    for line, r in zip(lines[1:], rows):
        h = r["history"][-1]
        assert line == (f"{r['comm'].codec:>6} {r['trigger']:>14} | "
                        f"{h.acc_mean:>9.4f} | {r['bytes'] / 1e6:>8.2f} | "
                        f"{h.triggered_frac:>5.2f} | {r['reduction']}")
    assert [r["trigger"] for r in rows] == [
        "thr=0.0", "thr=0.0", "thr=0.0", "thr=1.0", "adaptive(0.9)",
        "thr=0.0"]
    # the always-send rows carry payload x directed edges x rounds
    for r in (rows[0], rows[1], rows[2], rows[5]):
        assert r["bytes"] == r["payload_bytes"] * r["directed_edges"] * 2
    assert rows[2]["reduction"] == \
        f"{rows[0]['payload_bytes'] / rows[2]['payload_bytes']:.1f}x"
    single = cg.main(["--device", "cpu", "--rounds", "1", "--codec", "int8",
                      "--adaptive", "0.8"])
    assert _printed(capsys)[1].split("|")[0].split() == ["int8",
                                                         "adaptive(0.8)"]
    assert single[0]["reduction"] == "-"  # no fp32 reference in the sweep


def test_decentralized_mnist_main_on_cpu(dm, capsys, monkeypatch,
                                         tmp_path):
    monkeypatch.setattr(dm, "METHODS", ["decdiff+vt", "fedavg"])
    monkeypatch.chdir(tmp_path)
    res, ct = dm.main(["--device", "cpu", "--rounds", "2", "--nodes", "6"])
    lines = _printed(capsys)
    pats = [r"\[synth-mnist\] centralized acc=\d\.\d{4}"]
    pats += [rf"\[synth-mnist\] {re.escape(f'{m:12s}')} acc=\d\.\d{{4}} "
             rf"±\d\.\d{{4}}  \(\d+s\)" for m in dm.METHODS]
    _in_order(lines, pats)
    text = "\n".join(lines)
    assert "\n\n=== Table II (accuracy) ===\n" + dm.format_table(res) in text
    assert dm.format_char_times(ct) in text
    assert "\n\n=== Table IV (characteristic time) ===\n" in text
    assert list(res["synth-mnist"]) == ["_world", "centralized",
                                        "decdiff+vt", "fedavg"]
    assert res["synth-mnist"]["_world"] == dict(
        gini=res["synth-mnist"]["centralized"]["gini"], nodes=6, rounds=2,
        dataset="synth-mnist", data_scale=0.05)
    assert ct == dm.characteristic_times(res)
    assert not os.listdir(tmp_path)  # no file written


def test_serve_decode_main_on_cpu(capsys):
    sd = _example("serve_decode")
    gen = sd.main(["--device", "cpu", "--batch", "2", "--prompt-len", "4",
                   "--new-tokens", "5"])
    lines = _printed(capsys)
    assert re.fullmatch(r"arch=qwen1\.5-0\.5b batch=2 decoded 5 tokens in "
                        r"\d+\.\d\ds \(\d+\.\d tok/s\)", lines[0]), lines
    assert lines[1].startswith("first sequence: [") and \
        lines[1].endswith("] ...")
    assert gen.shape == (2, 5)
    from repro_torch.launch.serve import main as serve_main

    np.testing.assert_array_equal(gen, serve_main(
        ["--device", "cpu", "--batch", "2", "--prompt-len", "4",
         "--new-tokens", "5"]))


@pytest.mark.skipif(torch.cuda.is_available(), reason="a CUDA host")
@pytest.mark.parametrize("name", ["quickstart", "compressed_gossip",
                                  "decentralized_mnist", "multipod_dfl_train",
                                  "serve_decode"])
def test_main_without_device_needs_cuda(name):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _example(name).main([])


# ---------------------------------------------------- the multi-pod example

MULTIPOD_ARGV = ["--device", "cpu", "--nodes", "4", "--rounds", "3",
                 "--eval-every", "1"]


def _multipod_digest(out):
    from repro_torch.utils.pytree import tree_leaves

    return dict(params=[t.numpy() for t in tree_leaves(out["params"])],
                acc=[m.acc_per_node.tolist() for m in out["history"]],
                dist=(out["init_dist"], out["final_dist"]),
                n_pods=out["n_pods"])


def _multipod_worker(rank, world_size, tmp):
    torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(tmp, "store"), world_size)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=world_size)
    try:
        buf = io.StringIO()
        with redirect_stdout(buf):
            out = _example("multipod_dfl_train").main(MULTIPOD_ARGV)
        assert dist.is_initialized()  # the caller's group stays open
        res = dict(digest=_multipod_digest(out),
                   lines=buf.getvalue().splitlines(),
                   imported=sorted(k for k in sys.modules
                                   if k.split(".")[0] in ("repro",
                                                          "benchmarks")))
        with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(res, f)
    finally:
        dist.destroy_process_group()


def test_multipod_main_one_and_two_ranks(capsys, tmp_path):
    mod = _example("multipod_dfl_train")
    one = _multipod_digest(mod.main(MULTIPOD_ARGV))
    lines = _printed(capsys)
    _in_order(lines, [
        r"1 device\(s\) -> 1-pod mesh, 4 nodes per pod \(heterogeneous "
        r"init, ring gossip\)"] + [ROUND.format(m=re.escape("decdiff+vt"))]
        * 3 + [r"node0-node1 model distance: init \d+\.\d\d -> final "
               r"\d+\.\d\d \(converging\) — DecDiff pulls heterogeneously-"
               r"initialized nodes together without a server, final acc "
               r"\d\.\d{3} ± \d\.\d{3}"])
    assert one["n_pods"] == 1
    assert one["dist"][1] < one["dist"][0]  # the reference's criterion
    assert not dist.is_initialized()

    mp.spawn(_multipod_worker, args=(2, str(tmp_path)), nprocs=2, join=True)
    ranks = []
    for r in range(2):
        with open(tmp_path / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    assert ranks[0]["lines"][0] == ("2 device(s) -> 2-pod mesh, 2 nodes per "
                                    "pod (heterogeneous init, ring gossip)")
    assert ranks[0]["lines"][1:] == lines[1:]  # the same rounds, same text
    assert ranks[1]["lines"] == []  # only the writer rank prints
    for rk in ranks:
        assert rk["imported"] == []
        assert rk["digest"]["n_pods"] == 2
        _same_arrays(rk["digest"]["params"], one["params"])  # bitwise
        assert rk["digest"]["acc"] == one["acc"]
        assert rk["digest"]["dist"] == one["dist"]
