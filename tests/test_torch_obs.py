"""Telemetry (`repro_torch.obs`) against the JAX package's `repro.obs`, on
the CPU.

The worlds are tests/test_obs.py's: a 4-node ring and a 16-node BA m=2
synth-mnist world at scale 0.02 with the MLP 784-32-10, 4 local steps of
batch 16, lr 0.1, momentum 0.9, seed 3, the `HET` clock and a 4 s
deadline.  The reference's world, init and data are carried into the port,
and both run `decdiff+vt` in loop mode.

  (a) the catalog, the aliases, `channels_for` and the validation errors
      equal the reference's;
  (b) per channel against the reference's `detail` at every eval round,
      over {no transport, per-node int8 with a 0.3 trigger, per-edge int8
      adaptive 0.95} x {dense, sparse}: exact for `node_steps`,
      `edge_trigger`, `edge_bytes`, `edge_staleness` and `node_acc`;
      1e-6 relative for `node_compute` and `edge_latency` (fp32 sums);
      `consensus` and `drift` first from `eval_probes` on one seeded numpy
      [N, D] matrix (1e-6 relative), then in the runs to the parameters'
      own tolerance (1e-6 without a transport, 1e-4 plus one int8 grain
      with one, ROADMAP C.1) carried through the norm: a norm of a
      difference moves by at most 2·sqrt(D) times the largest parameter
      difference, plus fp32 rounding;
  (c) in-port oracles, all bitwise: `telemetry=None` against
      `channels="all"` over layouts x modes x {static, `EdgeDropout`,
      `EnergyChurn` + deadline} x {per-node, per-edge}; detail dense =
      sparse and loop = fused; the exact arithmetic of the fp32 codec at
      threshold 0 (every edge fires every round); a dead node's steps and
      compute seconds do not grow;
  (d) the ledger (both packages' `validate_ledger`), the verbose line
      (byte for byte `repro.obs.format_round`, every optional field on and
      off, and `run(verbose=True)` under capsys), `export_trace` (bytes
      exact, spans equal to the reference's `build_trace`, its errors) and
      `Telemetry(profile_dir=...)`.
"""
import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import repro.obs as jobs  # noqa: E402
import repro_torch.dynamics as td  # noqa: E402
import repro_torch.obs as tobs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.comm import CommConfig  # noqa: E402
from repro_torch.engine import Experiment, Schedule, World  # noqa: E402
from repro_torch.fl.metrics import RoundMetrics  # noqa: E402
from repro_torch.models.mlp_cnn import make_mlp  # noqa: E402
from repro_torch.obs import Telemetry  # noqa: E402
from repro_torch.timing import LognormalLink, LognormalStep, Timing  # noqa: E402
from repro_torch.utils.pytree import tree_flatten_stacked, tree_leaves  # noqa: E402

TINY = dict(steps_per_round=4, batch_size=16, lr=0.1, momentum=0.9, seed=3)
HET_KW = (dict(sigma=0.5, seed=7), dict(seed=9))
HET = Timing(node=LognormalStep(**HET_KW[0]), link=LognormalLink(**HET_KW[1]))
DEADLINE = 4.0

COMMS = {
    "none": None,
    "node-int8-trigger": dict(codec="int8", stochastic=False,
                              trigger_threshold=0.3),
    "edge-int8-adaptive": dict(codec="int8", policy="adaptive",
                               target_trigger=0.95, stochastic=False),
}


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads: the suite runs several worker processes at
    once, and every worker spinning a thread per core slows them all."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _jworld(**kw):
    from repro.engine import World as JWorld
    from repro.models.mlp_cnn import make_mlp as jmake_mlp

    return JWorld.synthetic(dataset="synth-mnist", seed=3, scale=0.02,
                            model=jmake_mlp(num_classes=10, hidden=(32,)),
                            **kw)


@pytest.fixture(scope="module")
def jba():
    return _jworld(nodes=16, topology="barabasi_albert", m=2)


@pytest.fixture(scope="module")
def jring():
    return _jworld(nodes=4, topology="ring")


def _port_world(jw, **kw):
    """The reference world's graph and data as a port World on the CPU."""
    tw = convert.world_from_arrays(
        model=make_mlp(num_classes=10, hidden=(32,)),
        adjacency=jw.topo.adjacency, weights=jw.topo.weights, xs=jw.xs,
        ys=jw.ys, x_test=jw.x_test, y_test=jw.y_test, device="cpu")
    return dataclasses.replace(tw, **kw)


def _both(jw, cfg, layout, rounds=3, timed=True, channels="auto",
          jledger=None, tledger=None):
    """(reference Experiment, its history, port Experiment, its history):
    `decdiff+vt` in loop mode, every round evaluated, from the reference's
    init."""
    from repro.comm import CommConfig as JCommConfig
    from repro.engine import Experiment as JExperiment
    from repro.engine import Schedule as JSchedule
    from repro.timing import LognormalLink as JLink
    from repro.timing import LognormalStep as JStep
    from repro.timing import Timing as JTiming

    deadline = DEADLINE if timed else None
    jtiming = (JTiming(node=JStep(**HET_KW[0]), link=JLink(**HET_KW[1]))
               if timed else None)
    je = JExperiment(
        dataclasses.replace(jw, timing=jtiming, telemetry=jobs.Telemetry(
            channels=channels, ledger=jledger)),
        "decdiff+vt", layout=layout,
        comm=None if cfg is None else JCommConfig(**cfg),
        schedule=JSchedule(rounds=rounds, deadline=deadline), **TINY)
    params0 = jax.tree.map(np.asarray, je.params)
    jhist = je.run(rounds=rounds, eval_every=1, mode="loop")
    exp = Experiment(
        _port_world(jw, timing=HET if timed else None,
                    telemetry=Telemetry(channels=channels, ledger=tledger)),
        "decdiff+vt", device="cpu", layout=layout,
        comm=None if cfg is None else CommConfig(**cfg),
        schedule=Schedule(rounds=rounds, deadline=deadline), **TINY)
    exp.params = convert.params_from_numpy(params0, "cpu")
    exp.opt_state = exp.optimizer.init(exp.params)
    if exp.transport is not None:
        exp.comm_state = exp.transport.init_state(exp.params)
    return je, jhist, exp, exp.run(rounds=rounds, eval_every=1, mode="loop")


def _param_bound(je, cfg):
    """ROADMAP C.1's parameter tolerance for this run."""
    jp = jax.tree.map(np.asarray, je.params)
    top = max(float(np.abs(jp[k][kk]).max()) for k in jp for kk in jp[k])
    return 1e-6 if cfg is None else 1e-4 + top / 127.0


# ------------------------------------------------------- (a) the catalog


def test_catalog_matches_reference():
    assert tobs.available_channels() == jobs.available_channels()
    assert list(tobs.CHANNELS) == list(jobs.CHANNELS)
    for name, spec in tobs.CHANNELS.items():
        ref = jobs.CHANNELS[name]
        assert (spec.axis, spec.needs, spec.doc) == (ref.axis, ref.needs,
                                                     ref.doc)
    for sel in (["drift", "node_steps"], ["edge_bytes"], list(tobs.CHANNELS)):
        assert list(tobs.channels_for(sel)) == list(jobs.channels_for(sel))
    assert tobs.MANIFEST_EDGE_CAP == jobs.MANIFEST_EDGE_CAP
    assert tobs.SCHEMA_VERSION == jobs.SCHEMA_VERSION
    assert tobs.SCHEMA == jobs.SCHEMA


@pytest.mark.parametrize("has_comm", [False, True])
@pytest.mark.parametrize("has_timing", [False, True])
@pytest.mark.parametrize("channels", ["auto", ("drift", "node_steps"),
                                      ("node_acc",)])
def test_resolve_matches_reference(channels, has_comm, has_timing):
    got = Telemetry(channels=channels).resolve(has_comm=has_comm,
                                               has_timing=has_timing)
    assert got == jobs.Telemetry(channels=channels).resolve(
        has_comm=has_comm, has_timing=has_timing)


def _message(fn):
    with pytest.raises((ValueError, TypeError)) as err:
        fn()
    return type(err.value), str(err.value)


@pytest.mark.parametrize("case", ["alias", "unknown", "channels_for",
                                  "needs-timing", "needs-comm", "needs-both"])
def test_validation_errors_match_reference(case):
    def make(mod):
        return {
            "alias": lambda: mod.Telemetry(channels="everything"),
            "unknown": lambda: mod.Telemetry(channels=("nope", "drift")),
            "channels_for": lambda: mod.channels_for(["nope"]),
            "needs-timing": lambda: mod.Telemetry(
                channels=("node_compute",)).resolve(has_comm=True,
                                                    has_timing=False),
            "needs-comm": lambda: mod.Telemetry(channels="all").resolve(
                has_comm=False, has_timing=True),
            "needs-both": lambda: mod.Telemetry(
                channels=("edge_latency", "edge_bytes")).resolve(
                    has_comm=False, has_timing=False),
        }[case]

    t_type, t_msg = _message(make(tobs))
    j_type, j_msg = _message(make(jobs))
    assert t_type is j_type
    # the hints name the port's own classes
    assert t_msg == j_msg.replace("repro.timing.Timing",
                                  "repro_torch.timing.Timing")


def test_experiment_refusals(jring):
    with pytest.raises(ValueError, match="timing"):
        Experiment(_port_world(jring, telemetry=Telemetry(
            channels=("node_compute",))), "decdiff+vt", device="cpu",
            comm=CommConfig(codec="int8"), **TINY)
    with pytest.raises(TypeError, match="repro_torch.obs.Telemetry"):
        Experiment(_port_world(jring, telemetry=object()), "decavg",
                   device="cpu", **TINY)
    # auto drops what the experiment lacks; drift needs only the graph
    exp = Experiment(_port_world(jring, telemetry=Telemetry()), "decavg",
                     device="cpu", **TINY)
    assert exp.bound_obs.channels == ("node_steps", "node_acc", "consensus",
                                      "drift")


# ------------------------------------------------ (b) against the reference


def test_eval_probes_match_reference(jba):
    """consensus and drift from one seeded [N, D] matrix, both layouts."""
    mat = np.random.default_rng(4).normal(size=(16, 5000)).astype(np.float32)
    refs = {}
    for layout in ("dense", "sparse"):
        from repro.engine import Experiment as JExperiment

        je = JExperiment(dataclasses.replace(
            jba, telemetry=jobs.Telemetry()), "decdiff+vt", layout=layout,
            **TINY)
        jp = jax.tree.map(np.asarray, je.bound_obs.eval_probes(
            jax.numpy.asarray(mat)))
        exp = Experiment(_port_world(jba, telemetry=Telemetry()),
                         "decdiff+vt", device="cpu", layout=layout, **TINY)
        tp = {k: v.numpy() for k, v in
              exp.bound_obs.eval_probes(torch.from_numpy(mat)).items()}
        assert sorted(tp) == ["consensus", "drift"]
        for k in tp:
            assert tp[k].dtype == np.float32 and tp[k].shape == jp[k].shape
            np.testing.assert_allclose(tp[k], jp[k], rtol=1e-6, atol=0)
        np.testing.assert_array_equal(exp.bound_obs.edge_src,
                                      je.bound_obs.edge_src)
        np.testing.assert_array_equal(exp.bound_obs.edge_dst,
                                      je.bound_obs.edge_dst)
        refs[layout] = tp
    for k in refs["dense"]:
        np.testing.assert_array_equal(refs["dense"][k], refs["sparse"][k])


def test_drift_walks_pairs_in_chunks(jba, monkeypatch):
    """The chunked pair walk equals one pass over every pair."""
    exp = Experiment(_port_world(jba, telemetry=Telemetry()), "decdiff+vt",
                     device="cpu", **TINY)
    mat = torch.from_numpy(np.random.default_rng(5).normal(
        size=(16, 777)).astype(np.float32))
    whole = exp.bound_obs.eval_probes(mat)["drift"]
    # 5 rows of 777 fp32 a chunk: 5 chunks over the 23 pairs
    monkeypatch.setattr("repro_torch.obs.channels.DRIFT_CHUNK_BYTES",
                        5 * 777 * 4)
    np.testing.assert_array_equal(
        exp.bound_obs.eval_probes(mat)["drift"].numpy(), whole.numpy())
    lo, hi = exp.bound_obs._pair_lo, exp.bound_obs._pair_hi
    direct = torch.sqrt(((mat[lo] - mat[hi]) ** 2).sum(1))
    np.testing.assert_allclose(
        whole.numpy(), direct[exp.bound_obs._pair_of_edge].numpy(),
        rtol=1e-6)


EXACT = ("node_steps", "edge_trigger", "edge_bytes", "edge_staleness",
         "node_acc")


@pytest.mark.parametrize("layout", ["dense", "sparse"])
@pytest.mark.parametrize("comm", sorted(COMMS))
def test_detail_matches_reference(jba, comm, layout):
    cfg = COMMS[comm]
    je, jhist, exp, thist = _both(jba, cfg, layout)
    d_params = int(tree_flatten_stacked(exp.params)[0].shape[1])
    probe_tol = 2.0 * np.sqrt(d_params) * _param_bound(je, cfg)
    assert [m.round for m in thist] == [m.round for m in jhist]
    assert exp.bound_obs.channels == je.bound_obs.channels
    for jm, tm in zip(jhist, thist):
        assert sorted(tm.detail) == sorted(jm.detail)
        for ch, ref in jm.detail.items():
            got = tm.detail[ch]
            ref = np.asarray(ref)
            assert got.shape == ref.shape, ch
            if ch in EXACT:
                np.testing.assert_array_equal(got, ref, err_msg=ch)
            elif ch in ("node_compute", "edge_latency"):
                np.testing.assert_allclose(got, ref, rtol=1e-6, atol=0,
                                           err_msg=ch)
            else:
                np.testing.assert_allclose(got, ref, rtol=1e-6,
                                           atol=probe_tol, err_msg=ch)
        if cfg is not None:
            assert float(np.sum(tm.detail["edge_bytes"])) == tm.bytes_on_wire
    # the run itself agrees as tests/test_torch_timing.py holds it
    assert exp.trig_history == list(je.trig_history)
    assert exp.sim_time_history == je.sim_time_history
    assert exp.arrived_history == je.arrived_history
    assert len(exp.obs_history) == len(je.obs_history) == 3


# ------------------------------------------------------ (c) in-port oracles


def _run(world, cfg=None, layout="dense", mode="loop", rounds=3,
         deadline=DEADLINE, method="decdiff+vt", eval_every=1):
    exp = Experiment(world, method, device="cpu", layout=layout,
                     comm=None if cfg is None else CommConfig(**cfg),
                     schedule=Schedule(rounds=rounds, eval_every=eval_every,
                                       mode=mode, deadline=deadline),
                     **TINY)
    return exp, exp.run()


def _same_run(a, b):
    """Bitwise equal runs; the transport state only within one layout."""
    (ea, ha), (eb, hb) = a, b
    for x, y in zip(tree_leaves(ea.params) + tree_leaves(ea.opt_state),
                    tree_leaves(eb.params) + tree_leaves(eb.opt_state)):
        assert torch.equal(x, y)
    if ea.comm_state is not None and ea.layout == eb.layout:
        for x, y in zip(tree_leaves(ea.comm_state._asdict()),
                        tree_leaves(eb.comm_state._asdict())):
            assert torch.equal(x, y)
    assert ea.train_loss_history == eb.train_loss_history
    assert ea.comm_bytes_total == eb.comm_bytes_total
    for f in ("trig_history", "live_history", "sim_time_history",
              "arrived_history"):
        assert getattr(ea, f) == getattr(eb, f), f
    assert len(ha) == len(hb)
    for ma, mb in zip(ha, hb):
        np.testing.assert_array_equal(ma.acc_per_node, mb.acc_per_node)
        for f in ("bytes_on_wire", "triggered_frac", "live_edge_frac",
                  "sim_time", "arrived_frac"):
            assert getattr(ma, f) == getattr(mb, f), f


def _same_detail(a, b):
    assert list(a) == list(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


DYNAMICS = {
    "static": (None, None),
    "edge-dropout": (lambda: td.EdgeDropout(p=0.3), None),
    "energy-churn-deadline": (
        lambda: td.EnergyChurn(capacity=3.0, recharge=4.0, rejoin_at=2.0),
        DEADLINE),
}


@pytest.mark.parametrize("transport", ["node-int8-trigger",
                                       "edge-int8-adaptive"])
@pytest.mark.parametrize("dyn", sorted(DYNAMICS))
@pytest.mark.parametrize("mode", ["loop", "fused"])
@pytest.mark.parametrize("layout", ["dense", "sparse"])
def test_telemetry_off_bitwise(jba, layout, mode, dyn, transport):
    make, deadline = DYNAMICS[dyn]
    runs = []
    for tele in (None, Telemetry(channels="all")):
        world = _port_world(jba, timing=HET, telemetry=tele,
                            dynamics=None if make is None else make())
        runs.append(_run(world, COMMS[transport], layout, mode,
                         deadline=deadline))
    _same_run(runs[0], runs[1])
    assert runs[0][1][-1].detail is None
    assert sorted(runs[1][1][-1].detail) == sorted(tobs.CHANNELS)
    if make is not None:
        assert min(runs[1][0].live_history) < 1.0


@pytest.mark.parametrize("comm", sorted(COMMS))
def test_detail_dense_sparse_loop_fused_bitwise(jba, comm):
    runs = {}
    for layout, mode in (("dense", "loop"), ("dense", "fused"),
                         ("sparse", "loop"), ("sparse", "fused")):
        world = _port_world(jba, timing=HET, telemetry=Telemetry())
        runs[layout, mode] = _run(world, COMMS[comm], layout, mode,
                                  rounds=4, eval_every=2)
    ref = runs["dense", "loop"]
    for key, other in runs.items():
        _same_run(ref, other)
        for ma, mb in zip(ref[1], other[1]):
            _same_detail(ma.detail, mb.detail)
        assert len(other[0].obs_history) == 4
        for sa, sb in zip(ref[0].obs_history, other[0].obs_history):
            assert ref[0].bound_obs.materialize(sa).keys() \
                == other[0].bound_obs.materialize(sb).keys()
            _same_detail(ref[0].bound_obs.materialize(sa),
                         other[0].bound_obs.materialize(sb))


def test_channels_exact_always_fire(jring):
    """fp32 codec at threshold 0: every directed edge fires every round."""
    rounds = 3
    exp, hist = _run(_port_world(jring, telemetry=Telemetry()),
                     dict(codec="fp32", trigger_threshold=0.0),
                     rounds=rounds, deadline=None, eval_every=rounds)
    d = hist[-1].detail
    obs = exp.bound_obs
    e = obs.num_directed
    assert e == 8
    np.testing.assert_array_equal(d["edge_trigger"], np.full(e, rounds))
    np.testing.assert_array_equal(d["edge_staleness"], np.zeros(e))
    np.testing.assert_array_equal(
        d["node_steps"], np.full(4, rounds * TINY["steps_per_round"]))
    assert float(np.sum(d["edge_bytes"])) == hist[-1].bytes_on_wire
    assert float(np.sum(d["edge_bytes"])) == exp.comm_bytes_total
    np.testing.assert_array_equal(d["node_acc"], hist[-1].acc_per_node)
    pair = {(s, t): i for i, (s, t) in
            enumerate(zip(obs.edge_src, obs.edge_dst))}
    for (s, t), i in pair.items():
        assert d["drift"][i] == d["drift"][pair[(t, s)]]
    mat = tree_flatten_stacked(exp.params)[0].numpy().astype(np.float64)
    ref = np.linalg.norm(mat - mat.mean(axis=0, keepdims=True), axis=1)
    np.testing.assert_allclose(d["consensus"], ref, rtol=1e-5)
    src, dst = obs.edge_src, obs.edge_dst
    np.testing.assert_allclose(
        d["drift"], np.linalg.norm(mat[src] - mat[dst], axis=1), rtol=1e-5)


def test_staleness_counts_undelivered_rounds(jring):
    rounds = 4
    _, hist = _run(_port_world(jring, telemetry=Telemetry()),
                   dict(codec="int8", trigger_threshold=50.0),
                   rounds=rounds, deadline=None, eval_every=rounds)
    age = hist[-1].detail["edge_staleness"]
    assert np.all(age >= 0) and np.all(age <= rounds)
    assert np.any(age > 0)


@pytest.mark.parametrize("method,cfg", [
    ("decdiff+vt", COMMS["node-int8-trigger"]), ("fedavg", None)])
def test_dead_nodes_train_and_compute_nothing(jba, method, cfg):
    world = _port_world(jba, timing=HET, telemetry=Telemetry(),
                        dynamics=td.EnergyChurn(capacity=3.0, recharge=4.0,
                                                rejoin_at=2.0))
    exp = Experiment(world, method, device="cpu",
                     comm=None if cfg is None else CommConfig(**cfg),
                     schedule=Schedule(rounds=4, eval_every=1), **TINY)
    alive, inner = [], exp.bound_dyn.transition

    def transition(*args):
        state, ev = inner(*args)
        alive.append(ev.alive.clone().numpy())
        return state, ev

    object.__setattr__(exp.bound_dyn, "transition", transition)
    exp.run()
    steps = np.stack([s["node_steps"] for s in exp.obs_history])
    secs = np.stack([s["node_secs"] for s in exp.obs_history])
    d_steps = np.diff(steps, axis=0, prepend=0.0)
    d_secs = np.diff(secs, axis=0, prepend=0.0)
    dead = np.stack(alive) == 0
    assert dead.any()
    assert (d_steps[dead] == 0).all() and (d_secs[dead] == 0).all()
    assert (d_steps[~dead] > 0).all() and (d_secs[~dead] > 0).all()


# ------------------------------------------- (d) ledger, verbose line, trace


@pytest.mark.parametrize("mode", ["fused", "loop"])
def test_ledger_validates_in_both_packages(jring, tmp_path, mode):
    path = str(tmp_path / "run.jsonl")
    exp, hist = _run(_port_world(jring, timing=HET,
                                 telemetry=Telemetry(ledger=path)),
                     COMMS["node-int8-trigger"], mode=mode, rounds=4,
                     eval_every=2)
    counts = tobs.validate_ledger(path)
    assert counts == jobs.validate_ledger(path)
    assert counts == {"manifest": 1, "round": len(hist), "summary": 1}
    manifest, rounds, summaries = jobs.read_ledger(path)
    assert manifest["nodes"] == 4 and manifest["method"] == "decdiff+vt"
    assert manifest["channels"] == list(exp.bound_obs.channels)
    assert manifest["payload_bytes"] == exp.transport.payload_bytes
    assert manifest["num_directed"] == 8 and manifest["deadline"] == DEADLINE
    assert manifest["edges"] == {"src": exp.bound_obs.edge_src.tolist(),
                                 "dst": exp.bound_obs.edge_dst.tolist()}
    env = manifest["env"]
    assert "jax" not in env and env["torch"] == torch.__version__
    assert env["device_type"] == "cpu" and env["device_count"] == 1
    for rec, m in zip(rounds, hist):
        assert rec["round"] == m.round
        assert rec["acc_mean"] == m.acc_mean
        assert rec["bytes_on_wire"] == m.bytes_on_wire
        assert rec["sim_time"] == m.sim_time
        for k, v in m.detail.items():
            np.testing.assert_array_equal(np.asarray(rec["detail"][k]), v)
    [summary] = summaries
    assert summary["mode"] == mode and summary["rounds"] == 4
    assert summary["wall_s"] > 0 and summary["rounds_per_sec"] > 0
    assert "compile_s" not in summary and "cold_compile" not in summary


def test_manifest_drops_edges_past_the_cap(jring, tmp_path, monkeypatch):
    path = str(tmp_path / "run.jsonl")
    monkeypatch.setattr("repro_torch.obs.ledger.MANIFEST_EDGE_CAP", 7)
    _run(_port_world(jring, telemetry=Telemetry(ledger=path)), rounds=1,
         deadline=None)
    manifest, _, _ = jobs.read_ledger(path)
    assert "edges" not in manifest and manifest["num_directed"] == 8


def test_ledger_rejects_garbage(tmp_path):
    for rec in ({"no": "kind"}, {"kind": "banana"},
                {"kind": "round", "acc_mean": 0.5},
                {"kind": "round", "round": 1, "acc_mean": "high",
                 "acc_std": 0.0, "loss_mean": 1.0, "acc_per_node": [0.5]}):
        msgs = []
        for mod in (tobs, jobs):
            with pytest.raises(ValueError) as err:
                mod.validate_record(rec)
            msgs.append(str(err.value))
        assert msgs[0] == msgs[1]
    path = tmp_path / "bad.jsonl"
    path.write_text(json.dumps({"kind": "round", "round": 0,
                                "acc_mean": 0.1, "acc_std": 0.0,
                                "loss_mean": 1.0,
                                "acc_per_node": [0.1]}) + "\n")
    with pytest.raises(ValueError, match="manifest"):
        tobs.validate_ledger(str(path))
    led = tobs.RunLedger(str(tmp_path / "x.jsonl"))
    with pytest.raises(ValueError, match="manifest"):
        led.write({"kind": "summary"})


def _metrics(**kw):
    return RoundMetrics(round=7, acc_per_node=np.array([0.5, 0.7]),
                        loss_per_node=np.array([1.0, 2.0]), **kw)


OPTIONAL = {
    "comm": dict(bytes_on_wire=123456789.0, triggered_frac=0.25),
    "live": dict(live_edge_frac=0.875),
    "time": dict(sim_time=1234.5678, arrived_frac=0.5),
}


@pytest.mark.parametrize("fields", [(), ("comm",), ("live",), ("time",),
                                    ("comm", "live", "time")])
def test_format_round_matches_reference(fields):
    kw = {}
    for f in fields:
        kw.update(OPTIONAL[f])
    m = _metrics(**kw)
    assert tobs.format_round("decdiff+vt", m) == jobs.format_round(
        "decdiff+vt", m)
    assert tobs.format_round("decdiff+vt", _metrics(
        bytes_on_wire=1024.0, triggered_frac=0.5)) == (
        "[decdiff+vt] round    7  acc 0.6000 ± 0.1000  loss 1.5000  "
        "wire 0.00 MB  trig 0.50")


@pytest.mark.parametrize("mode", ["fused", "loop"])
def test_verbose_run_prints_reference_lines(jring, capsys, mode):
    world = _port_world(jring, timing=HET,
                        dynamics=td.EdgeDropout(p=0.3))
    exp, hist = _run(world, COMMS["node-int8-trigger"], mode=mode,
                     rounds=2, eval_every=1)
    assert capsys.readouterr().out == ""
    hist = exp.run(rounds=2, eval_every=1, verbose=True, mode=mode)
    out = capsys.readouterr().out.splitlines()
    assert out == [jobs.format_round(exp.method.name, m) for m in hist]
    assert "live" in out[0] and "wire" in out[0] and " t " in out[0]
    assert tobs.get_round_logger().name == "repro_torch.obs.round"


def test_trace_matches_reference(jring, tmp_path):
    cfg = COMMS["node-int8-trigger"]
    je, jhist, exp, thist = _both(jring, cfg, "dense", rounds=4)
    path = tmp_path / "trace.json"
    trace = tobs.export_trace(exp, str(path))
    assert json.loads(path.read_text()) == trace
    spans = [e for e in trace["traceEvents"] if e.get("ph") == "X"]
    edge_spans = [e for e in spans if e["pid"] == 1]
    assert sum(e["args"]["bytes"] for e in edge_spans) \
        == thist[-1].bytes_on_wire
    assert all("deadline_s" in e["args"] for e in edge_spans)
    # the reference's exporter on the port's run: the same trace exactly
    assert jobs.build_trace(exp) == trace
    # and on its own run: the same events, times to 1e-6 relative
    ref = jobs.build_trace(je)["traceEvents"]
    got = trace["traceEvents"]
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        assert {k: v for k, v in a.items() if k not in ("ts", "dur")} \
            == {k: v for k, v in b.items() if k not in ("ts", "dur")}
        for k in ("ts", "dur"):
            if k in b:
                assert a[k] == pytest.approx(b[k], rel=1e-6, abs=1e-6)


def test_trace_errors(jring):
    exp, _ = _run(_port_world(jring, timing=HET),
                  COMMS["node-int8-trigger"], rounds=1)
    with pytest.raises(ValueError, match="telemetry"):
        tobs.build_trace(exp)
    exp2, _ = _run(_port_world(jring, telemetry=Telemetry()),
                   COMMS["node-int8-trigger"], rounds=1, deadline=None)
    with pytest.raises(ValueError, match="timing"):
        tobs.build_trace(exp2)
    exp3 = Experiment(_port_world(jring, timing=HET,
                                  telemetry=Telemetry()), "decdiff+vt",
                      device="cpu", **TINY)
    with pytest.raises(ValueError, match="run"):
        tobs.build_trace(exp3)
    exp4, _ = _run(_port_world(jring, timing=HET, telemetry=Telemetry(
        channels=("node_steps",))), rounds=1)
    with pytest.raises(ValueError, match="node_compute"):
        tobs.build_trace(exp4)


def test_profile_dir_writes_a_trace_and_changes_nothing(jring, tmp_path):
    out = tmp_path / "prof"
    runs = []
    for tele in (Telemetry(), Telemetry(profile_dir=str(out))):
        runs.append(_run(_port_world(jring, timing=HET, telemetry=tele),
                         COMMS["edge-int8-adaptive"], rounds=2))
    _same_run(runs[0], runs[1])
    for ma, mb in zip(runs[0][1], runs[1][1]):
        _same_detail(ma.detail, mb.detail)
    files = os.listdir(out)
    assert len(files) == 1 and files[0].endswith(".json")
    events = json.loads((out / files[0]).read_text())["traceEvents"]
    assert len(events) > 0
