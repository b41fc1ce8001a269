"""The port on the NVIDIA card: each CUDA kernel against its plain version,
and the schedule modes through the kernels, with and without the
transport.

Every test here needs a card and skips without one; on the card run
`PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py`.
These tests import no JAX, so they run where JAX is not installed.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops
from repro_torch.kernels.gather_rows import gather_rows_plain
from repro_torch.kernels.segment_avg import segment_avg_plain

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("b,k,d", [(1, 1, 1), (13, 10, 2051), (3, 0, 5),
                                   (16, 10, 567434)])
def test_kernel_matches_plain_bitwise(card, b, k, d):
    rng = np.random.default_rng([b, k, d])
    vals = torch.from_numpy(
        rng.standard_normal((b, k, d)).astype(np.float32)).to(card)
    w = torch.from_numpy(rng.uniform(0.0, 3.0, (b, k)).astype(np.float32))
    w[w < 0.9] = 0.0
    w = w.to(card)
    before = ops.LAUNCHES["segment_neighbor_avg"]
    s, t = ops.segment_neighbor_avg(vals, w)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["segment_neighbor_avg"] == before + 1
    ps, pt = segment_avg_plain(vals, w)
    assert torch.equal(s, ps) and torch.equal(t, pt)


def test_fused_equals_loop_through_the_kernel(card):
    from repro_torch.engine import Experiment, World
    from repro_torch.models.mlp_cnn import make_mlp

    world = World.synthetic("synth-mnist", nodes=8, topology="barabasi_albert",
                            m=2, scale=0.02, model=make_mlp(hidden=(64, 32)),
                            device=card)
    runs = {}
    for mode in ("loop", "fused"):
        exp = Experiment(world, "decdiff+vt", steps_per_round=2,
                         batch_size=32, device=card)
        ops.reset_launches()
        hist = exp.run(rounds=3, eval_every=1, mode=mode)
        assert ops.LAUNCHES["segment_neighbor_avg"] == 3
        runs[mode] = (exp.params, hist, exp.train_loss_history)
    (pl, hl, ll), (pf, hf, lf) = runs["loop"], runs["fused"]
    for name in pl:
        for leaf in pl[name]:
            assert torch.equal(pl[name][leaf], pf[name][leaf])
    assert ll == lf
    for a, b in zip(hl, hf):
        np.testing.assert_array_equal(a.acc_per_node, b.acc_per_node)


@pytest.mark.parametrize("m,d,k", [(1, 1, 1), (12, 7, 30), (40, 2050, 80),
                                   (24, 4096, 24), (160, 567434, 160),
                                   (5, 3, 0)])
def test_gather_rows_matches_plain_bitwise(card, m, d, k):
    """Odd D (scalar copies), D = 2 mod 4 (float2, the paper's MLP) and
    D = 0 mod 4 (float4), with repeated and aliased indices."""
    rng = np.random.default_rng([m, d, k])
    tbl = torch.from_numpy(
        rng.standard_normal((m, d)).astype(np.float32)).to(card)
    idx = torch.from_numpy(rng.integers(0, m, k)).to(card)
    if k > 2:
        idx[: k // 2] = 0  # padding slots alias row 0
    before = ops.LAUNCHES["gather_rows"]
    out = ops.gather_rows(tbl, idx)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["gather_rows"] == before + 1
    assert torch.equal(out, gather_rows_plain(tbl, idx))
    # an offset view: 4-byte aligned rows take the scalar path
    sub = tbl.reshape(-1)[1:1 + (m - 1) * d].reshape(m - 1, d) if m > 1 \
        else None
    if sub is not None and k:
        j = torch.clamp(idx, max=m - 2)
        assert torch.equal(ops.gather_rows(sub, j), gather_rows_plain(sub, j))


def test_transport_fused_equals_loop_through_the_kernels(card):
    from repro_torch.comm import CommConfig
    from repro_torch.engine import Experiment, World
    from repro_torch.models.mlp_cnn import make_mlp

    world = World.synthetic("synth-mnist", nodes=8, topology="barabasi_albert",
                            m=2, scale=0.02, model=make_mlp(hidden=(64, 32)),
                            device=card)
    runs = {}
    for mode in ("loop", "fused"):
        exp = Experiment(world, "decdiff+vt", steps_per_round=2,
                         batch_size=32, device=card,
                         comm=CommConfig(codec="int8", policy="adaptive",
                                         target_trigger=0.95))
        ops.reset_launches()
        hist = exp.run(rounds=3, eval_every=1, mode=mode)
        assert ops.LAUNCHES["gather_rows"] == 3
        assert ops.LAUNCHES["segment_neighbor_avg"] == 3
        runs[mode] = (exp, hist)
    (el, hl), (ef, hf) = runs["loop"], runs["fused"]
    for name in el.params:
        for leaf in el.params[name]:
            assert torch.equal(el.params[name][leaf], ef.params[name][leaf])
    assert el.trig_history == ef.trig_history
    assert hl[-1].bytes_on_wire == hf[-1].bytes_on_wire > 0
