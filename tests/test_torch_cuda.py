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


@pytest.mark.parametrize("n,r,d", [(4, 4, 1 << 20), (8, 8, 1_000_003),
                                   (3, 2, 7), (5, 11, 4098), (600, 3, 96),
                                   (1, 1, 1)])
def test_dequant_avg_rows_matches_plain_bitwise(card, n, r, d):
    """char4 / float4 (D = 0 mod 4), char2 (D = 2 mod 4) and scalar (odd D)
    columns, more than one block of 8 receivers, more than one 512-sender
    chunk of the weights in shared memory, and a zero weight row."""
    from repro_torch.kernels.dequant_avg import dequant_avg_rows_plain

    rng = np.random.default_rng([n, r, d])
    q = torch.from_numpy(rng.integers(-127, 128, (n, d)).astype(np.int8))
    scale = torch.from_numpy(rng.uniform(1e-3, 0.05, n).astype(np.float32))
    wn = torch.from_numpy(rng.uniform(0, 1, (r, n)).astype(np.float32))
    wn[0] = 0.0
    wn = wn / torch.clamp(wn.sum(1, keepdim=True), min=1e-30)
    q, scale, wn = q.to(card), scale.to(card), wn.to(card)
    before = ops.LAUNCHES["dequant_neighbor_avg_rows"]
    out = ops.dequant_neighbor_avg_rows(q, scale, wn)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["dequant_neighbor_avg_rows"] == before + 1
    ws = (wn * scale[None, :]).contiguous()
    assert torch.equal(out, dequant_avg_rows_plain(q, ws))
    assert not out[0].any()
    if d > 1:  # a payload one byte off its allocation: scalar loads
        qo = q.reshape(-1)[1:1 + n * (d - 1)].reshape(n, d - 1)
        assert torch.equal(ops.dequant_neighbor_avg_rows(qo, scale, wn),
                           dequant_avg_rows_plain(qo, ws))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,v", [(32, 10), (37, 4099), (512, 151936),
                                 (1, 2)])
def test_vt_kl_loss_kernels_match_plain(card, b, v, dtype):
    """Forward (per-row KL, max, Σexp) and backward against the plain
    versions, labels at the first and last lanes.  The kernels sum in
    another order: per-row KL within rtol=1e-5 + atol=1e-5·log V, Σexp
    within rtol=1e-5, the fp32 gradient within 1e-6·|g|, a bf16 gradient
    within one bf16 rounding (rtol=2^-7).  Each gradient entry is also
    within rtol·|ref| + 1e-5·(p + p_t)·|g|, which rejects a backward that
    drops the teacher's tail a = (1-β)/(V-1) even at V = 151,936, where
    a·|g| is below the absolute tolerances above."""
    from repro_torch.kernels import vt_kl_loss as vt

    rng = np.random.default_rng([b, v])
    z = torch.from_numpy((rng.standard_normal((b, v)) * 4).astype(
        np.float32)).to(dtype).to(card)
    y = torch.from_numpy(rng.integers(0, v, b)).to(card)
    y[0], y[-1] = 0, v - 1
    g = torch.from_numpy(rng.uniform(0.1, 1, b).astype(np.float32)).to(card)
    ops.reset_launches()
    zr = z.clone().requires_grad_(True)
    kl = ops.vt_kl_loss(zr, y, 0.98, -0.5)
    (dz,) = torch.autograd.grad(kl, zr, g)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["vt_kl_loss_fwd"] == 1
    assert ops.LAUNCHES["vt_kl_loss_bwd"] == 1
    pk, pm, ps = vt.vt_forward_plain(z, y, 0.98, -0.5)
    kk, km, ks = vt.vt_forward_cuda(z, y, 0.98, -0.5)
    torch.testing.assert_close(kl.detach(), pk, rtol=1e-5,
                               atol=1e-5 * np.log(v))
    assert torch.equal(km, pm)
    torch.testing.assert_close(ks, ps, rtol=1e-5, atol=0)
    want = vt.vt_backward_plain(z, y, pm, ps, g, 0.98)
    assert dz.dtype == dtype
    if dtype == torch.float32:
        torch.testing.assert_close(dz, want, rtol=0, atol=1e-6)
    else:
        torch.testing.assert_close(dz.float(), want.float(), rtol=2 ** -7,
                                   atol=1e-7)
    a = vt.teacher_tail(0.98, v)
    rows = torch.arange(b, device=card)
    terms = torch.exp(z.float() - pm[:, None]) / ps[:, None] + a  # p + p_t
    terms[rows, y] += 0.98 - a
    rtol = 1e-5 if dtype == torch.float32 else 2 ** -7
    tol = rtol * want.float().abs() + 1e-5 * terms * g[:, None]
    assert ((dz.float() - want.float()).abs() <= tol).all()
    no_tail = want.float() + a * g[:, None]  # p_t left out of the wrong
    no_tail[rows, y] -= a * g                # classes: must be rejected
    assert not ((no_tail.to(dtype).float() - want.float()).abs()
                <= tol).all()


def test_lm_round_on_the_card_matches_the_cpu(card):
    """Two fused int8 one-pod rounds of qwen1.5-0.5b reduced to 2 layers,
    d_model 64, vocab 256 (fp32), 4-node ring: the card (the vt_kl_loss and
    dequant_avg_rows kernels) against the CPU (their plain versions, which
    the CPU tests hold against the JAX package).  Params within 1e-4, loss
    within 1e-5."""
    from repro_torch.comm.codecs import Int8Codec
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import synthetic_token_batch
    from repro_torch.dist.dfl_step import build_dfl_round_shardmap
    from repro_torch.launch.train import init_nodes, ring_adjacency
    from repro_torch.models.lm import build_lm
    from repro_torch.optim.sgd import sgd_momentum
    from repro_torch.utils.pytree import tree_leaves, tree_map

    lm = build_lm(get_config("qwen1.5-0.5b").reduced(n_layers=2, d_model=64,
                                                     vocab=256))
    opt = sgd_momentum(lr=3e-3, momentum=0.9)
    rnd = build_dfl_round_shardmap(lm, opt, ring_adjacency(4),
                                   codec=Int8Codec(stochastic=False))
    p0 = init_nodes(lm, 4, "cpu")
    runs = []
    for dev in (card, torch.device("cpu")):
        params = tree_map(lambda t: t.to(dev, copy=True), p0)
        state = opt.init(params)
        losses = []
        ops.reset_launches()
        for r in range(2):
            bs = [synthetic_token_batch(2, 16, 256, seed=r * 131 + i)
                  for i in range(4)]
            batch = {k: torch.from_numpy(np.stack([b[k] for b in bs]).astype(
                np.int64)).to(dev) for k in bs[0]}
            params, state, loss = rnd(params, state, r, batch)
            losses.append(float(loss))
        runs.append((params, losses, dict(ops.LAUNCHES)))
    (pc, lc, nc), (ph, lh, nh) = runs
    assert nc["dequant_neighbor_avg_rows"] == 2
    assert nc["vt_kl_loss_fwd"] == nc["vt_kl_loss_bwd"] == 8
    assert not any(nh.values())
    np.testing.assert_allclose(lc, lh, rtol=0, atol=1e-5)
    for a, b in zip(tree_leaves(pc), tree_leaves(ph)):
        torch.testing.assert_close(a.cpu(), b, rtol=0, atol=1e-4)


DECODE_SHAPES = [(1, 16, 1, 1, 16), (2, 600, 2, 2, 64), (4, 1024, 8, 1, 128),
                 (3, 512, 4, 8, 64), (3, 1000, 16, 1, 64), (5, 4099, 8, 5, 128),
                 (1, 1, 2, 4, 32), (8, 32768, 16, 1, 64)]


def _decode_case(card, b, w, kk, g, hd, dtype, filled=None, seed=0):
    gen = torch.Generator(device=card).manual_seed(seed)
    q = torch.randn((b, kk * g, hd), generator=gen, device=card)
    k = torch.randn((b, w, kk, hd), generator=gen, device=card).to(dtype)
    v = torch.randn((b, w, kk, hd), generator=gen, device=card).to(dtype)
    filled = max(w - 5, 1) if filled is None else filled
    sp = torch.arange(w, dtype=torch.int32, device=card)
    sp[filled:] = -1
    pos = torch.tensor(filled - 1, dtype=torch.int32, device=card)
    return q, k, v, sp, pos


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,w,kk,g,hd", DECODE_SHAPES)
def test_decode_attention_kernel_matches_plain(card, b, w, kk, g, hd, dtype):
    """The split-W kernel against its plain version: the reference sweep,
    odd B and W, a group of 5, one slot, and the serving path's full
    [8, 32768, 16, 64] window.  rtol = atol = 2e-5 (the two sum in another
    order; v ~ N(0, 1))."""
    from repro_torch.kernels.decode_attention import decode_attention_plain

    q, k, v, sp, pos = _decode_case(card, b, w, kk, g, hd, dtype)
    before = ops.LAUNCHES["decode_attention_fused"]
    out = ops.decode_attention_fused(q, k, v, sp, pos)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["decode_attention_fused"] == before + 1
    want = decode_attention_plain(q, k, v, sp, pos)
    torch.testing.assert_close(out, want, rtol=2e-5, atol=2e-5)
    qb = q.to(torch.bfloat16)  # a bf16 query reads as its fp32 value
    torch.testing.assert_close(ops.decode_attention_fused(qb, k, v, sp, pos),
                               decode_attention_plain(qb, k, v, sp, pos),
                               rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("window", [1, 37, 700])
def test_decode_attention_kernel_window_and_empty_splits(card, window):
    """A sliding window, and a ring whose first 10 slots alone are filled,
    so that every split after the first is all masked (m = -inf must merge
    without NaN); and a ring with no slot filled at all (the uniform
    average, as the plain softmax gives)."""
    from repro_torch.kernels.decode_attention import decode_attention_plain

    q, k, v, sp, pos = _decode_case(card, 4, 4096, 2, 4, 64, torch.bfloat16,
                                    filled=10)
    for win in (0, window):
        out = ops.decode_attention_fused(q, k, v, sp, pos, window=win)
        assert torch.isfinite(out).all()
        torch.testing.assert_close(
            out, decode_attention_plain(q, k, v, sp, pos, win), rtol=2e-5,
            atol=2e-5)
    q, k, v, sp, pos = _decode_case(card, 4, 2000, 2, 4, 64, torch.float32,
                                    filled=1500)
    out = ops.decode_attention_fused(q, k, v, sp, pos, window=window)
    torch.testing.assert_close(
        out, decode_attention_plain(q, k, v, sp, pos, window), rtol=2e-5,
        atol=2e-5)
    empty = torch.full_like(sp, -1)
    out = ops.decode_attention_fused(q, k, v, empty, pos)
    torch.testing.assert_close(out, decode_attention_plain(q, k, v, empty,
                                                           pos),
                               rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("r,widths", [(4, [1 << 20]), (16, [567434]),
                                      (3, [7, 4099, 1]), (1, [1]),
                                      (5, [33 * 7, 1000, 5]), (4, [8192])])
def test_decdiff_kernels_match_plain(card, r, widths, dtype):
    """Pass B bitwise the plain step for the kernel's own scale (4-wide and
    scalar columns, several leaves, a gated-off row); the norms within
    rtol 1e-5 of the plain sums (another order); one count per call."""
    from repro_torch.kernels import decdiff_update as dd

    gen = torch.Generator(device=card).manual_seed(r)
    xs = [torch.randn((r, d), generator=gen, device=card).to(dtype)
          for d in widths]
    avgs = [torch.randn((r, d), generator=gen, device=card) for d in widths]
    gate = torch.ones(r, device=card)
    gate[r // 2] = 0.0
    before = ops.LAUNCHES["decdiff_update"]
    outs = ops.decdiff_rows(xs, avgs, gate, 1.0)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["decdiff_update"] == before + 1
    scale, sq = dd.norms_cuda(xs, avgs, gate, 1.0)
    torch.testing.assert_close(sq, dd.sumsq_rows_plain(xs, avgs), rtol=1e-5,
                               atol=0)
    torch.testing.assert_close(
        scale, dd.scale_from_sumsq(dd.sumsq_rows_plain(xs, avgs), gate, 1.0),
        rtol=1e-5, atol=0)
    assert scale[r // 2] == 0
    for out, x, a in zip(outs, xs, avgs):
        assert out.dtype == dtype
        assert torch.equal(out, dd.step_rows_plain(x, a, scale))
        assert torch.equal(out[r // 2], x[r // 2])
        if x.shape[1] > 1:  # an offset view: scalar loads
            xo = x.reshape(-1)[1:1 + r * (x.shape[1] - 1)].reshape(r, -1)
            ao = a.reshape(-1)[1:1 + r * (x.shape[1] - 1)].reshape(r, -1)
            assert torch.equal(dd.step_cuda(xo, ao, scale),
                               dd.step_rows_plain(xo, ao, scale))
    w = xs[0][0].float()
    torch.testing.assert_close(ops.decdiff_update(w, avgs[0][0]),
                               dd.decdiff_rows_plain([w[None]],
                                                     [avgs[0][0][None]],
                                                     None, 1.0)[0][0],
                               rtol=1e-5, atol=1e-6)


def test_decode_step_on_the_card_matches_the_cpu(card):
    """8 tokens of qwen1.5-0.5b and qwen3-32b reduced (fp32) through
    `build_serve_step` on the card (the decode_attention kernel, once per
    layer and step) and on the CPU: logits within 1e-4, greedy tokens
    equal, caches within 1e-5."""
    from repro_torch.configs import get_config
    from repro_torch.dist.dfl_step import build_serve_step
    from repro_torch.models.lm import build_lm
    from repro_torch.utils.pytree import tree_map

    for arch, over in [("qwen1.5-0.5b", dict(n_kv_heads=4)),
                       ("qwen3-32b", dict(n_heads=16, n_kv_heads=2,
                                          head_dim=128))]:
        lm = build_lm(get_config(arch).reduced(**over))
        p0 = lm.init(torch.Generator().manual_seed(0), device="cpu")
        tokens = torch.from_numpy(
            np.random.default_rng(0).integers(0, 512, (3, 8)))
        runs = []
        for dev in (card, torch.device("cpu")):
            params = tree_map(lambda t: t.to(dev), p0)
            cache = lm.init_cache(3, 8, device=dev)
            step = build_serve_step(lm)
            ops.reset_launches()
            logits = []
            for t in range(8):
                out, cache = step(params, cache, tokens[:, t:t + 1].to(dev))
                logits.append(out[:, 0].cpu())
            runs.append((torch.stack(logits, 1), cache,
                         ops.LAUNCHES["decode_attention_fused"]))
        (lc, cc, nc), (lh, ch, nh) = runs
        assert nc == 8 * lm.cfg.n_layers and nh == 0
        torch.testing.assert_close(lc, lh, rtol=1e-4, atol=1e-4)
        assert torch.equal(lc.argmax(-1), lh.argmax(-1))
        for name in ("k", "v"):
            torch.testing.assert_close(cc[name].cpu(), ch[name], rtol=1e-5,
                                       atol=1e-5)
        assert torch.equal(cc["slot_pos"].cpu(), ch["slot_pos"])


def test_engine_and_lm_round_run_eq5_through_the_kernel(card):
    """`decdiff_update` launches once per round in the MLP engine (fused
    and loop schedules, bitwise equal) and in the fused int8 LM round."""
    from repro_torch.comm.codecs import Int8Codec
    from repro_torch.configs import get_config
    from repro_torch.dist.dfl_step import build_dfl_round_shardmap
    from repro_torch.engine import Experiment, World
    from repro_torch.launch.train import init_nodes, make_batches, \
        ring_adjacency
    from repro_torch.models.lm import build_lm
    from repro_torch.models.mlp_cnn import make_mlp
    from repro_torch.optim.sgd import sgd_momentum

    world = World.synthetic("synth-mnist", nodes=8, topology="barabasi_albert",
                            m=2, scale=0.02, model=make_mlp(hidden=(64, 32)),
                            device=card)
    params = {}
    for mode in ("loop", "fused"):
        exp = Experiment(world, "decdiff+vt", steps_per_round=2,
                         batch_size=32, device=card)
        ops.reset_launches()
        exp.run(rounds=3, eval_every=1, mode=mode)
        assert ops.LAUNCHES["decdiff_update"] == 3
        params[mode] = exp.params
    for name in params["loop"]:
        for leaf in params["loop"][name]:
            assert torch.equal(params["loop"][name][leaf],
                               params["fused"][name][leaf])
    lm = build_lm(get_config("qwen1.5-0.5b").reduced(n_layers=2, d_model=64,
                                                     vocab=256))
    opt = sgd_momentum(lr=3e-3, momentum=0.9)
    rnd = build_dfl_round_shardmap(lm, opt, ring_adjacency(4),
                                   codec=Int8Codec(stochastic=False))
    p = init_nodes(lm, 4, card)
    state = opt.init(p)
    ops.reset_launches()
    for r, batch in enumerate(make_batches(lm, 4, 2, 16, 2, card)):
        p, state, _ = rnd(p, state, r, batch)
    assert ops.LAUNCHES["decdiff_update"] == 2
