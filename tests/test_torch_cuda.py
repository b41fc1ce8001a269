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
                                   (16, 10, 567434), (50, 16, 1_199_882)])
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
                                 (1, 2), (128, 32000), (64, 50280),
                                 (96, 51866),
                                 # each tier of vt_plan: sub-warp rows,
                                 # one block a row
                                 (1600, 10), (1600, 26), (5, 33), (3, 2),
                                 (1, 151936), (896, 51866),
                                 # one row past a block's 64 / 128 rows
                                 (65, 10), (129, 2)])
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,v", [(1600, 10), (300, 26), (70, 33), (129, 2),
                                 (40, 3000), (40, 4099), (24, 32000),
                                 (9, 51866), (5, 151936), (150, 151936)])
def test_vt_forward_rows_are_bitwise_across_row_splits(card, b, v, dtype):
    """The forward's per-row KL, max and Σexp are bitwise equal between one
    call on B rows and separate calls on contiguous blocks of them (a row,
    a third, the rest), in both tiers of `vt_plan` (sub-warp rows and one
    block a row): the plan never looks at B, which the pod backend's
    bitwise equality with the vmap rounds relies on."""
    from repro_torch.kernels import vt_kl_loss as vt

    rng = np.random.default_rng([b, v, 7])
    z = torch.from_numpy((rng.standard_normal((b, v)) * 4).astype(
        np.float32)).to(dtype).to(card)
    y = torch.from_numpy(rng.integers(0, v, b)).to(card)
    whole = vt.vt_forward_cuda(z, y, 0.98, -0.5)
    cuts = [0, 1, 1 + b // 3, b]
    parts = [vt.vt_forward_cuda(z[lo:hi], y[lo:hi], 0.98, -0.5)
             for lo, hi in zip(cuts, cuts[1:])]
    torch.cuda.synchronize()
    for k in range(3):
        assert torch.equal(whole[k], torch.cat([p[k] for p in parts]))
    assert torch.isfinite(whole[0]).all()


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
                 (1, 1, 2, 4, 32), (8, 32768, 16, 1, 64), (3, 40, 16, 1, 64),
                 (2, 4097, 16, 1, 64), (2, 2049, 4, 2, 32),
                 (8, 32768, 8, 8, 128),
                 # the families of path n: zamba2's hd 80 (two heads a
                 # block), hd 80 at an odd K (one head a block), W one
                 # slot past a tile at hd 80, arctic's G = 7, whisper's K
                 # = 20 over its 448-slot ring
                 (8, 4096, 32, 1, 80), (3, 1000, 3, 2, 80),
                 (2, 4097, 32, 1, 80), (4, 4096, 8, 7, 128),
                 (8, 448, 20, 1, 64)]


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
    odd B and W, a group of 5, one slot, the serving path's full
    [8, 32768, 16, 64] window, a W below one tile (40 slots, tiles of 64),
    W one slot past a tile boundary (4097 = 64·64 + 1; 2049 = 128·16 + 1
    at hd 32) and qwen3-32b's G = 8, hd = 128 over the full 32,768 slots.
    rtol = atol = 2e-5 (the two sum in another order; v ~ N(0, 1))."""
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
    for qq in (q, q.to(torch.bfloat16)):
        for win in (0, window):
            out = ops.decode_attention_fused(qq, k, v, sp, pos, window=win)
            assert torch.isfinite(out).all()
            torch.testing.assert_close(
                out, decode_attention_plain(qq, k, v, sp, pos, win),
                rtol=2e-5, atol=2e-5)
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
                                      (5, [33 * 7, 1000, 5]), (4, [8192]),
                                      (50, [1_199_882])])
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


@pytest.mark.parametrize("r,d", [(1, 1), (16, 567434), (160, 567434),
                                 (3, 4099), (70_000, 9)])
def test_drift_norms_kernel_matches_plain(card, r, d):
    """The trigger's drift on the card: within rtol 1e-5 of the plain
    norms (another order), every block of rows bitwise the full call's
    rows (a grid of more than 65,535 rows too), one count per call."""
    from repro_torch.kernels import decdiff_update as dd

    gen = torch.Generator(device=card).manual_seed(r)
    x = torch.randn((r, d), generator=gen, device=card)
    ref = torch.randn((r, d), generator=gen, device=card)
    before = ops.LAUNCHES["drift_norms"]
    got = ops.drift_norms(x, ref)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["drift_norms"] == before + 1
    torch.testing.assert_close(got, dd.drift_norms_plain(x, ref), rtol=1e-5,
                               atol=0)
    for lo, hi in [(0, 1), (r // 2, r), (1, max(r - 1, 1))]:
        assert torch.equal(ops.drift_norms(x[lo:hi], ref[lo:hi]),
                           got[lo:hi])


@pytest.mark.parametrize("arch", ["llava-next-mistral-7b", "mixtral-8x7b",
                                  "arctic-480b", "mamba2-2.7b",
                                  "zamba2-2.7b", "whisper-large-v3"])
def test_family_on_the_card_matches_the_cpu(card, arch):
    """Each family's reduced preset (fp32) on the card (the vt_kl_loss and
    decode_attention kernels) and on the CPU (their plain versions, which
    tests/test_torch_families.py holds against the JAX package): logits
    within 1e-4, the VT loss and the router aux within 1e-5, and 8 decode
    steps from the same cache within 1e-4 with equal greedy tokens
    (mixtral's window of 4 and the hybrid's rings of 5 wrap; whisper after
    `prep_decode_cache`); the decode kernel once per attention layer and
    step, no launch on the CPU."""
    from repro_torch.configs import get_config
    from repro_torch.dist.dfl_step import build_serve_step
    from repro_torch.models.lm import build_lm
    from repro_torch.utils.pytree import tree_map

    over = dict(sliding_window=4) if arch == "mixtral-8x7b" else {}
    lm = build_lm(get_config(arch).reduced(**over))
    cfg = lm.cfg
    p0 = lm.init(torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(0)
    batch0 = {k: torch.from_numpy(
        rng.integers(0, cfg.vocab, shape).astype(np.int32)
        if dtype == torch.int32 else
        (rng.standard_normal(shape) * 0.05).astype(np.float32))
        for k, (shape, dtype) in lm.input_specs(2, 64).items()}
    enc = torch.from_numpy((rng.standard_normal((2, 6, cfg.d_model))
                            * 0.05).astype(np.float32))
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 8)))
    window = 5 if cfg.family == "hybrid" else 8
    runs = []
    for dev in (card, torch.device("cpu")):
        params = tree_map(lambda t: t.to(dev), p0)
        batch = {k: v.to(dev) for k, v in batch0.items()}
        ops.reset_launches()
        with torch.no_grad():
            logits, aux = lm.forward(params, batch)
            _, met = lm.loss(params, batch)
        vt = ops.LAUNCHES["vt_kl_loss_fwd"]
        step = build_serve_step(lm)
        cache = lm.init_cache(2, window, device=dev)
        if lm.prep_decode_cache is not None:
            with torch.inference_mode():
                cache = lm.prep_decode_cache(params, cache, enc.to(dev))
        dec = []
        ops.reset_launches()
        for t in range(8):
            out, cache = step(params, cache, toks[:, t:t + 1].to(dev))
            dec.append(out[:, 0].cpu())
        runs.append((logits.cpu(), float(aux), float(met["loss"]),
                     torch.stack(dec, 1), vt,
                     ops.LAUNCHES["decode_attention_fused"]))
    (lc, ac, sc, dc, vc, nc), (lh, ah, sh, dh, vh, nh) = runs
    attn = (0 if cfg.family == "ssm" else
            cfg.n_layers // cfg.shared_attn_every if cfg.family == "hybrid"
            else cfg.n_layers)
    assert (vc, nc) == (1, 8 * attn) and (vh, nh) == (0, 0)
    torch.testing.assert_close(lc, lh, rtol=1e-4, atol=1e-4)
    assert abs(ac - ah) <= 1e-5 and abs(sc - sh) <= 1e-5
    torch.testing.assert_close(dc, dh, rtol=1e-4, atol=1e-4)
    assert torch.equal(dc.argmax(-1), dh.argmax(-1))


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


@pytest.mark.parametrize("n,d,zero", [(16, 567434, False),
                                      (50, 1_199_882, False),
                                      (4, 463_987_712, False),
                                      (10, 1_000_003, True), (1, 1, False),
                                      (1, 5000, False), (3, 7, True),
                                      (1100, 96, True), (5, 4099, None)])
def test_neighbor_avg_matches_plain_bitwise(card, n, d, zero):
    """The one-launch `ops.neighbor_avg` (the weights' ordered sum and IEEE
    division inside the kernel) bitwise its plain version: float4, float2
    and scalar row loads, path f's stack, the LM's 2^31-passing
    [4, 463987712], more than one 1024-sender chunk of weights in shared
    memory, a zero weight, and all-zero weights (w / 0: NaN in both, as in
    the reference); and `neighbor_avg_normalized` on rows one float off
    their allocation."""
    from repro_torch.kernels.neighbor_avg import neighbor_avg_plain

    gen = torch.Generator(device=card).manual_seed(n * 7 + d)
    x = torch.randn((n, d), generator=gen, device=card)
    w = torch.rand((n,), generator=gen, device=card) + 0.1
    if zero:
        w[n // 2] = 0.0
    elif zero is None:
        w.zero_()
    before = ops.LAUNCHES["neighbor_avg"]
    out = ops.neighbor_avg(x, w)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["neighbor_avg"] == before + 1
    assert torch.equal(out, neighbor_avg_plain(x, w, normalize=True)) or (
        zero is None and bool(out.isnan().all()))
    if zero is None:
        assert bool(neighbor_avg_plain(x, w, normalize=True).isnan().all())
        return
    wn = (w / torch.sum(w)).contiguous()
    if d > 1:  # rows one float off their allocation: narrower loads
        xo = x.reshape(-1)[1:1 + n * (d - 1)].reshape(n, d - 1)
        assert torch.equal(ops.neighbor_avg_normalized(xo, wn),
                           neighbor_avg_plain(xo, wn))
    del x


def test_neighbor_avg_is_one_kernel_per_call(card):
    """`ops.neighbor_avg` normalizes inside its kernel: the profiler sees
    one device kernel per call, no sum and no division kernels."""
    from torch.profiler import ProfilerActivity, profile

    x = torch.randn((16, 567434), device=card)
    w = torch.rand((16,), device=card) + 0.1
    ops.neighbor_avg(x, w)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            ops.neighbor_avg(x, w)
        torch.cuda.synchronize()
    kernels = [e.name for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(kernels) == 3 and all("neighbor_avg" in k for k in kernels), \
        kernels


def test_fedavg_and_cfa_ge_run_through_their_kernels(card):
    """FedAvg's server average launches `neighbor_avg` once per round and
    leaves every node's params bitwise equal; CFA-GE's Eq. 9 launches the
    segment reduce once per round; fused and loop schedules are bitwise
    equal."""
    from repro_torch.engine import Experiment, World
    from repro_torch.models.mlp_cnn import make_mlp

    world = World.synthetic("synth-mnist", nodes=8, topology="barabasi_albert",
                            m=2, scale=0.02, model=make_mlp(hidden=(64, 32)),
                            device=card)
    for method, counter, other in [("fedavg", "neighbor_avg",
                                    "segment_neighbor_avg"),
                                   ("cfa-ge", "segment_neighbor_avg",
                                    "neighbor_avg")]:
        params = {}
        for mode in ("loop", "fused"):
            exp = Experiment(world, method, steps_per_round=2, batch_size=32,
                             device=card)
            ops.reset_launches()
            exp.run(rounds=3, eval_every=1, mode=mode)
            torch.cuda.synchronize()
            assert ops.LAUNCHES[counter] == 3 and ops.LAUNCHES[other] == 0
            params[mode] = exp.params
            for name in exp.params:
                for leaf in exp.params[name].values():
                    assert bool(torch.isfinite(leaf).all())
                    if method == "fedavg":
                        assert bool((leaf == leaf[:1]).all())
        for name in params["loop"]:
            for leaf in params["loop"][name]:
                assert torch.equal(params["loop"][name][leaf],
                                   params["fused"][name][leaf])


@pytest.mark.parametrize("b,k,d,zero_slots", [(1, 1, 1, False),
                                              (16, 10, 567434, True),
                                              (13, 8, 2051, True),
                                              (5, 3, 4096, False),
                                              (3, 0, 5, False),
                                              (300, 16, 96, True)])
def test_dequant_segment_matches_plain_bitwise(card, b, k, d, zero_slots):
    """char4 (D = 0 mod 4), char2 (path c's D = 567434) and scalar (odd D)
    columns, K = 0, more rows than one grid row; zero-weight slots hold
    int8 garbage and leave every bit alone."""
    from repro_torch.kernels.segment_avg import dequant_segment_avg_plain

    gen = torch.Generator(device=card).manual_seed(b * 31 + k * 7 + d)
    q = torch.randint(-127, 128, (b, k, d), generator=gen, device=card,
                      dtype=torch.int8)
    scales = torch.rand((b, k), generator=gen, device=card) * 0.05
    w = torch.rand((b, k), generator=gen, device=card) * 2.0
    if zero_slots and k > 1:
        w[:, k // 2:] = 0.0
    before = ops.LAUNCHES["dequant_segment_neighbor_avg"]
    out = ops.dequant_segment_neighbor_avg(q, scales, w)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["dequant_segment_neighbor_avg"] == before + 1
    ws = (w * scales).contiguous()
    assert torch.equal(out, dequant_segment_avg_plain(q, ws))
    if zero_slots and k > 1:  # the zero-weight slots are cut off: no bit moves
        assert torch.equal(out, ops.dequant_segment_neighbor_avg(
            q[:, :k // 2].contiguous(), scales[:, :k // 2].contiguous(),
            w[:, :k // 2].contiguous()))
    del q


@pytest.mark.parametrize("n,d", [(4, 463_987_712), (16, 567434),
                                 (10, 1_000_003), (1100, 96), (3, 4100),
                                 (1, 1)])
def test_dequant_neighbor_avg_matches_plain_and_the_block_bitwise(card, n,
                                                                  d):
    """8-, 4-, 2- and 1-byte column words, path d's 2^31-passing block,
    more than one 1024-sender chunk of weights; bitwise the plain version
    and row 0 of `dequant_neighbor_avg_rows` given the same row."""
    from repro_torch.kernels.dequant_avg import dequant_avg_plain

    gen = torch.Generator(device=card).manual_seed(n * 13 + d)
    q = torch.randint(-127, 128, (n, d), generator=gen, device=card,
                      dtype=torch.int8)
    sc = torch.rand((n,), generator=gen, device=card) * 0.02 + 1e-4
    w = torch.rand((n,), generator=gen, device=card) + 0.1
    before = ops.LAUNCHES["dequant_neighbor_avg"]
    out = ops.dequant_neighbor_avg(q, sc, w)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["dequant_neighbor_avg"] == before + 1
    wn = w / torch.sum(w)
    assert torch.equal(out, dequant_avg_plain(q, (wn * sc).contiguous()))
    assert torch.equal(out, ops.dequant_neighbor_avg_rows(
        q, sc, wn[None, :].contiguous())[0])
    del q


@pytest.mark.parametrize("method,comm,ge_chunk", [
    ("decdiff+vt", None, None), ("cfa-ge", None, None),
    ("cfa-ge", None, 16),
    ("decdiff+vt", dict(codec="int8", policy="adaptive",
                        target_trigger=0.95), None),
    ("decdiff+vt", dict(codec="int8"), None)],
    ids=["decdiff+vt", "cfa-ge", "cfa-ge-calls-of-16", "per-edge-int8",
         "per-node-int8"])
def test_sparse_layout_equals_dense_on_the_card(card, monkeypatch, method,
                                                comm, ge_chunk):
    """The sparse layout's buckets (widths 8 and 16 here) against the dense
    max_deg slots, through the kernels: params, accuracies, bytes and
    trigger history bitwise equal; the segment reduce launches once per
    bucket and `gather_rows` never on the sparse per-edge path.  With
    `ge_chunk`, CFA-GE's gradient walk runs in calls of that many edges
    (the last one holds the rest)."""
    from repro_torch.comm import CommConfig
    from repro_torch.engine import Experiment, World, backends
    from repro_torch.models.mlp_cnn import make_mlp

    if ge_chunk is not None:
        monkeypatch.setattr(backends, "GE_CHUNK", ge_chunk)

    world = World.synthetic("synth-mnist", nodes=24,
                            topology="barabasi_albert", m=2, scale=0.03,
                            model=make_mlp(hidden=(64, 32)), device=card)
    runs = {}
    for layout in ("dense", "sparse"):
        exp = Experiment(world, method, layout=layout, steps_per_round=2,
                         batch_size=32, device=card,
                         comm=None if comm is None else CommConfig(**comm))
        ops.reset_launches()
        hist = exp.run(rounds=3, eval_every=1)
        torch.cuda.synchronize()
        runs[layout] = (exp, hist, dict(ops.LAUNCHES))
    (de, dh, _), (se, sh, sl) = runs["dense"], runs["sparse"]
    for name in de.params:
        for leaf in de.params[name]:
            assert torch.equal(de.params[name][leaf], se.params[name][leaf])
    for a, b in zip(dh, sh):
        assert np.array_equal(a.acc_per_node, b.acc_per_node)
    assert de.comm_bytes_total == se.comm_bytes_total
    assert de.trig_history == se.trig_history
    widths = len(se.sparse_plan.widths)
    assert sl["segment_neighbor_avg"] >= 3 * widths
    assert sl["gather_rows"] == 0


# ------------------------------------------------ the Table I CNN (path j)

def _cnn_case(variant, n=4, b=8, seed=0):
    """A CNN, its params (drawn on the CPU), a batch and, for the EMNIST
    variant, fixed keep masks (the same on both devices)."""
    from repro_torch.models.mlp_cnn import make_cnn
    from repro_torch.utils.pytree import tree_map

    classes, drop = (26, True) if variant == "emnist" else (10, False)
    model = make_cnn(num_classes=classes, use_pool_dropout=drop)
    gen = torch.Generator().manual_seed(seed)
    nodes = [model.init(gen) for _ in range(n)]
    params = tree_map(lambda *ls: torch.stack(ls), nodes[0], *nodes[1:])
    x = torch.randn((n, b, 28, 28), generator=gen)
    y = torch.randint(0, classes, (n, b), generator=gen)
    masks = ([torch.rand((n, b, 12, 12, 64), generator=gen) < 0.75,
              torch.rand((n, b, 128), generator=gen) < 0.5] if drop else [])
    return model, params, x, y, masks


def _cnn_forward_grads(model, params, x, y, masks, dev, dtype=torch.float32):
    from repro_torch.utils.pytree import (tree_leaves, tree_map,
                                          tree_unflatten_like)

    p = tree_map(lambda t: t.to(dev, dtype), params)
    leaves = [t.detach().requires_grad_(True) for t in tree_leaves(p)]
    it = iter([m.to(dev) for m in masks])
    logits = model.apply(tree_unflatten_like(p, leaves), x.to(dev, dtype),
                         train=True, keep=lambda shape, q: next(it))
    loss = torch.nn.functional.cross_entropy(
        logits.reshape(-1, logits.shape[-1]), y.to(dev).reshape(-1))
    grads = torch.autograd.grad(loss, leaves)
    return [logits.detach().cpu()] + [g.cpu() for g in grads]


@pytest.mark.parametrize("variant", ["fashion", "emnist"])
def test_cnn_forward_and_gradient_on_the_card_match_the_cpu(card, variant,
                                                             monkeypatch):
    """The full-width CNN on the card against the CPU.  In float64 the
    logits and every gradient agree to rtol 1e-9, atol 1e-13 (in fp32 a
    ReLU whose input lies within rounding of 0 can switch on one device
    and not the other, which moves one gradient term).  In fp32, with the
    global cuDNN flags set to TF32 and nondeterministic algorithms, the
    logits agree to rtol 1e-4, atol 1e-5 (a TF32 convolution misses by
    ~1e-3), and the gradients are bitwise those of the same call with the
    global flags at fp32 and deterministic: the convolutions' own scope
    sets both, forward and backward, and leaves the global flags as they
    were."""
    case = _cnn_case(variant)
    cpu = torch.device("cpu")
    for a, b in zip(_cnn_forward_grads(*case, card, torch.float64),
                    _cnn_forward_grads(*case, cpu, torch.float64)):
        torch.testing.assert_close(a, b, rtol=1e-9, atol=1e-13)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    scoped = _cnn_forward_grads(*case, card)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", False)
    loose = _cnn_forward_grads(*case, card)
    assert torch.backends.cudnn.allow_tf32 is True
    assert torch.backends.cudnn.deterministic is False
    torch.testing.assert_close(loose[0], _cnn_forward_grads(*case, cpu)[0],
                               rtol=1e-4, atol=1e-5)
    assert all(torch.equal(a, b) for a, b in zip(loose, scoped))


@pytest.mark.parametrize("dataset,method", [("synth-fashion", "decdiff+vt"),
                                            ("synth-emnist", "cfa-ge")])
def test_cnn_rounds_are_deterministic_on_the_card(card, dataset, method,
                                                  monkeypatch):
    """Two runs of the same CNN experiment on the card are bitwise equal
    (cuDNN's deterministic algorithms inside the convolutions' scope, the
    dropout keep masks from the experiment's generator), with the global
    flags left nondeterministic."""
    from repro_torch.engine import Experiment, World
    from repro_torch.utils.pytree import tree_leaves

    monkeypatch.setattr(torch.backends.cudnn, "deterministic", False)
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", True)
    world = World.synthetic(dataset, nodes=8, topology="erdos_renyi", p=0.4,
                            scale=0.02, device=card)
    runs = []
    for _ in range(2):
        exp = Experiment(world, method, steps_per_round=2, batch_size=32,
                         lr=0.05, device=card)
        ops.reset_launches()
        hist = exp.run(rounds=2, eval_every=1)
        assert ops.LAUNCHES["segment_neighbor_avg"] == 2
        runs.append(([p.clone() for p in tree_leaves(exp.params)],
                     [m.acc_per_node for m in hist],
                     list(exp.train_loss_history)))
    (p0, a0, l0), (p1, a1, l1) = runs
    assert all(torch.equal(a, b) for a, b in zip(p0, p1))
    assert all((a == b).all() for a, b in zip(a0, a1)) and l0 == l1
    assert torch.backends.cudnn.benchmark is True


# ------------------------------------- dynamics and the event clock (path k)

def _dyn_run(where, dynamics=None, timing=None, deadline=None, comm=None,
             layout=None, method="decdiff+vt", telemetry=None, mode="fused"):
    from repro_torch.comm import CommConfig
    from repro_torch.engine import Experiment, Schedule, World
    from repro_torch.models.mlp_cnn import make_mlp

    world = World.synthetic("synth-mnist", nodes=16,
                            topology="barabasi_albert", m=2, scale=0.03,
                            model=make_mlp(hidden=(64, 32)), device=where,
                            dynamics=dynamics, timing=timing,
                            telemetry=telemetry)
    exp = Experiment(world, method, layout=layout, steps_per_round=2,
                     batch_size=32, device=where,
                     comm=None if comm is None else CommConfig(**comm),
                     schedule=Schedule(rounds=3, eval_every=1,
                                       deadline=deadline, mode=mode))
    ops.reset_launches()
    hist = exp.run()
    return exp, hist, dict(ops.LAUNCHES)


def _coins16():
    from repro_torch.graphs.topology import make_topology

    m = int(np.triu(make_topology("barabasi_albert", n=16, m=2,
                                  seed=0).adjacency, 1).sum())
    return np.random.default_rng(5).integers(0, 2, (3, m)).astype(np.float32)


@pytest.mark.parametrize("case", ["scripted-edge-int8", "energy-deadline",
                                  "energy-deadline-fedavg"])
def test_dynamics_and_clock_on_the_card_match_the_cpu(card, case):
    """A deterministic process on the card against the same run on the
    CPU: params within 1e-4, accuracies within one test sample, bytes,
    live and arrived fractions and simulated seconds exactly equal."""
    from repro_torch.dynamics import EnergyChurn, ScriptedGraph
    from repro_torch.timing import LognormalLink, LognormalStep, Timing

    if case == "scripted-edge-int8":
        kw = dict(dynamics=ScriptedGraph(_coins16()),
                  comm=dict(codec="int8", policy="adaptive",
                            target_trigger=0.95, stochastic=False))
    else:
        kw = dict(dynamics=EnergyChurn(capacity=3.0, recharge=4.0,
                                       rejoin_at=2.0),
                  timing=Timing(LognormalStep(1.0, 0.5, seed=7),
                                LognormalLink(0.05, 0.5, 1e6, 0.5, seed=11)),
                  deadline=2.5,
                  method="fedavg" if case.endswith("fedavg") else "decdiff+vt")
    (ce, ch, cl), (he, hh, _) = (_dyn_run(card, **kw),
                                 _dyn_run(torch.device("cpu"), **kw))
    for name in ce.params:
        for leaf in ce.params[name]:
            diff = (ce.params[name][leaf].cpu() - he.params[name][leaf]).abs()
            assert float(diff.max()) <= 1e-4
    used = (len(ce.world.x_test) // 128) * 128
    for a, b in zip(ch, hh):
        assert np.abs(a.acc_per_node - b.acc_per_node).max() * used <= 1 + 1e-6
        for f in ("bytes_on_wire", "live_edge_frac", "sim_time",
                  "arrived_frac"):
            assert getattr(a, f) == getattr(b, f), f
    assert ce.live_history == he.live_history
    assert min(ce.live_history) < 1.0
    if case.endswith("fedavg"):
        assert cl["neighbor_avg"] == 3
    else:
        assert cl["segment_neighbor_avg"] >= 3


@pytest.mark.parametrize("comm", [None, dict(codec="int8", policy="adaptive",
                                             target_trigger=0.95)],
                         ids=["none", "per-edge-int8"])
def test_sparse_equals_dense_under_edge_dropout_on_the_card(card, comm):
    """EdgeDropout draws one uniform per undirected pair from the card's
    generator in both layouts, so the two runs are bitwise equal."""
    from repro_torch.dynamics import EdgeDropout

    runs = [_dyn_run(card, dynamics=EdgeDropout(p=0.2), comm=comm,
                     layout=layout) for layout in ("dense", "sparse")]
    (de, dh, dl), (se, sh, sl) = runs
    for name in de.params:
        for leaf in de.params[name]:
            assert torch.equal(de.params[name][leaf], se.params[name][leaf])
    for a, b in zip(dh, sh):
        assert np.array_equal(a.acc_per_node, b.acc_per_node)
        assert a.bytes_on_wire == b.bytes_on_wire
        assert a.live_edge_frac == b.live_edge_frac
    assert 0.0 < min(de.live_history) < 1.0
    assert de.trig_history == se.trig_history
    if comm is not None:
        assert dl["gather_rows"] == 3 and sl["gather_rows"] == 0


# ------------------------------------------------ telemetry (path l)

TELE_CASES = {
    "edge-int8-deadline": dict(
        comm=dict(codec="int8", policy="adaptive", target_trigger=0.95,
                  stochastic=False), deadline=2.5),
    "node-int8-churn": dict(
        comm=dict(codec="int8", stochastic=False, trigger_threshold=0.8),
        deadline=2.5),
    "fedavg-churn": dict(method="fedavg"),
}


@pytest.mark.parametrize("layout", ["dense", "sparse"])
@pytest.mark.parametrize("case", sorted(TELE_CASES))
def test_telemetry_on_the_card_matches_the_cpu(card, case, layout):
    """Every channel on the card: bitwise the run without telemetry, the
    same kernel launches, and its detail against the CPU's: counts
    exactly, seconds to 1e-6, accuracies within one test sample, the
    probes within the parameters' 1e-4 carried through the norm."""
    from repro_torch.dynamics import EnergyChurn
    from repro_torch.obs import Telemetry
    from repro_torch.timing import LognormalLink, LognormalStep, Timing
    from repro_torch.utils.pytree import tree_flatten_stacked, tree_leaves

    kw = dict(TELE_CASES[case], layout=layout,
              timing=Timing(LognormalStep(1.0, 0.5, seed=7),
                            LognormalLink(0.05, 0.5, 1e6, 0.5, seed=11)))
    if case.endswith("churn"):
        kw["dynamics"] = EnergyChurn(capacity=3.0, recharge=4.0,
                                     rejoin_at=2.0)
    off, off_h, off_l = _dyn_run(card, **kw)
    on, on_h, on_l = _dyn_run(card, telemetry=Telemetry(channels="all")
                              if "comm" in kw else Telemetry(), **kw)
    cpu, cpu_h, _ = _dyn_run(torch.device("cpu"), telemetry=Telemetry(
        channels="all") if "comm" in kw else Telemetry(), **kw)
    assert on_l == off_l
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(on.params),
                                                 tree_leaves(off.params)))
    for f in ("comm_bytes_total", "trig_history", "live_history",
              "sim_time_history", "arrived_history"):
        assert getattr(on, f) == getattr(off, f), f
    d = int(tree_flatten_stacked(on.params)[0].shape[1])
    probe_tol = 2.0 * np.sqrt(d) * 1e-4
    used = (len(on.world.x_test) // 128) * 128
    for a, b in zip(on_h, cpu_h):
        assert list(a.detail) == list(b.detail)
        for ch, got in a.detail.items():
            ref = b.detail[ch]
            if ch in ("node_steps", "edge_trigger", "edge_bytes",
                      "edge_staleness"):
                np.testing.assert_array_equal(got, ref, err_msg=ch)
            elif ch in ("node_compute", "edge_latency"):
                np.testing.assert_allclose(got, ref, rtol=1e-6, err_msg=ch)
            elif ch == "node_acc":
                assert np.abs(got - ref).max() * used <= 1 + 1e-6
            else:
                np.testing.assert_allclose(got, ref, rtol=1e-5,
                                           atol=probe_tol, err_msg=ch)
        if "edge_bytes" in a.detail:
            assert float(a.detail["edge_bytes"].sum()) == a.bytes_on_wire
        np.testing.assert_array_equal(a.detail["node_acc"], a.acc_per_node)


def test_telemetry_loop_equals_fused_on_the_card(card):
    from repro_torch.obs import Telemetry
    from repro_torch.timing import LognormalLink, LognormalStep, Timing

    kw = dict(comm=dict(codec="int8", policy="adaptive", target_trigger=0.95),
              deadline=2.5, telemetry=Telemetry(channels="all"),
              timing=Timing(LognormalStep(1.0, 0.5, seed=7),
                            LognormalLink(0.05, 0.5, 1e6, 0.5, seed=11)))
    (fe, fh, fl), (le, lh, ll) = (_dyn_run(card, mode="fused", **kw),
                                  _dyn_run(card, mode="loop", **kw))
    assert fl == ll
    for a, b in zip(fh, lh):
        assert list(a.detail) == list(b.detail)
        for k in a.detail:
            np.testing.assert_array_equal(a.detail[k], b.detail[k])


# ------------------------------------------------- the pod backend (A.10)

def _pod_world(dev, **kw):
    import dataclasses

    from repro_torch.dynamics import EdgeDropout
    from repro_torch.engine import World
    from repro_torch.models.mlp_cnn import make_mlp
    from repro_torch.obs import Telemetry
    from repro_torch.timing import LognormalLink, LognormalStep, Timing

    world = World.synthetic("synth-mnist", nodes=8,
                            topology="barabasi_albert", m=2, scale=0.02,
                            model=make_mlp(hidden=(64, 32)), device=dev)
    return dataclasses.replace(
        world, dynamics=EdgeDropout(p=0.2),
        timing=Timing(LognormalStep(1.0, 0.5, seed=7),
                      LognormalLink(0.05, 0.5, 1e6, 0.5, seed=11)),
        telemetry=Telemetry(channels="all" if kw.get("comm") else "auto"))


POD_RUNS = {
    "decdiff+vt": ("decdiff+vt", dict(codec="int8", policy="adaptive",
                                      target_trigger=0.95), "dense"),
    "decdiff+vt-sparse": ("decdiff+vt", dict(codec="int8", policy="adaptive",
                                             target_trigger=0.95), "sparse"),
    "fedavg": ("fedavg", None, "dense"),
    "cfa-ge": ("cfa-ge", None, "dense"),
}


def _pod_run(dev, key, backend):
    """Path m's run at a small size: 3 fused rounds under EdgeDropout(0.2),
    a lognormal clock with a 2.5 s deadline and every channel; the results
    as host arrays (full node axis)."""
    from repro_torch import convert
    from repro_torch.comm import CommConfig
    from repro_torch.engine import Experiment, Schedule

    method, comm, layout = POD_RUNS[key]
    exp = Experiment(_pod_world(dev, comm=comm), method, backend=backend,
                     layout=layout,
                     comm=None if comm is None else CommConfig(**comm),
                     schedule=Schedule(rounds=3, eval_every=1,
                                       deadline=2.5),
                     steps_per_round=2, batch_size=32, device=dev)
    ops.reset_launches()
    hist = exp.run()
    comm_state = ([] if exp.comm_state is None else
                  [v.cpu().numpy() for v in exp.comm_state if v is not None])
    return dict(params=convert.params_to_numpy(exp.params),
                comm=comm_state, launches=dict(ops.LAUNCHES),
                hist=[(m.acc_per_node, m.bytes_on_wire, m.sim_time,
                       m.detail) for m in hist],
                trig=exp.trig_history, live=exp.live_history,
                loss=exp.train_loss_history, n_pods=exp.n_pods)


def _pod_equal(a, b, loss_tol):
    for layer in a["params"]:
        for leaf in a["params"][layer]:
            np.testing.assert_array_equal(a["params"][layer][leaf],
                                          b["params"][layer][leaf])
    assert len(a["comm"]) == len(b["comm"])
    for x, y in zip(a["comm"], b["comm"]):
        np.testing.assert_array_equal(x, y)
    assert a["trig"] == b["trig"] and a["live"] == b["live"]
    for (acc_a, by_a, t_a, d_a), (acc_b, by_b, t_b, d_b) in zip(a["hist"],
                                                                  b["hist"]):
        np.testing.assert_array_equal(acc_a, acc_b)
        assert by_a == by_b and t_a == t_b and list(d_a) == list(d_b)
        for k in d_a:
            np.testing.assert_array_equal(d_a[k], d_b[k])
    np.testing.assert_allclose(a["loss"], b["loss"], rtol=0, atol=loss_tol)


@pytest.mark.parametrize("key", ["decdiff+vt", "decdiff+vt-sparse"])
def test_pod_backend_on_nccl_at_world_size_one_is_vmap(card, key, tmp_path):
    """Path m0 at a small size: shard_map over an NCCL group of one rank
    (the gather a real collective) bitwise the vmap run, with the same
    launches."""
    import torch.distributed as dist

    want = _pod_run(card, key, "vmap")
    dist.init_process_group(
        "nccl", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
        world_size=1)
    try:
        got = _pod_run(card, key, "shard_map")
    finally:
        dist.destroy_process_group()
    assert got["n_pods"] == 1
    assert got["launches"] == want["launches"]
    _pod_equal(got, want, loss_tol=0.0)


def _pod_rank(rank, n_pods, tmp):
    import pickle

    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group(
        "gloo", store=dist.FileStore(f"{tmp}/store", n_pods), rank=rank,
        world_size=n_pods)
    try:
        dev = torch.device("cuda", 0)
        out = {key: _pod_run(dev, key, "shard_map") for key in POD_RUNS}
        with open(f"{tmp}/rank{rank}.pkl", "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def test_pod_backend_on_two_gloo_ranks_of_one_card_is_vmap(card, tmp_path):
    """Path m1 at a small size: two gloo ranks on the one card (the gather
    staged through host memory), `decdiff+vt` per-edge int8 on both
    layouts, `fedavg` and `cfa-ge`, each bitwise the vmap run."""
    import pickle

    import torch.multiprocessing as mp

    mp.spawn(_pod_rank, args=(2, str(tmp_path)), nprocs=2, join=True)
    ranks = []
    for r in range(2):
        with open(tmp_path / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    for key in POD_RUNS:
        want = _pod_run(card, key, "vmap")
        for rank in ranks:
            assert rank[key]["n_pods"] == 2
            _pod_equal(rank[key], want, loss_tol=1e-6)


def test_checkpoint_restores_bitwise_and_resumes_on_the_card(card, tmp_path):
    """Path o2 at the reduced preset: `launch/train.py --ckpt-dir` on the
    card, the restore onto the card bitwise the state the run ended with,
    and one more DFL round from the restored state bitwise the same round
    from the in-memory state (Eq. 5 through `decdiff_update` once)."""
    from repro_torch.checkpoint import restore_checkpoint
    from repro_torch.configs import get_config
    from repro_torch.dist.dfl_step import build_dfl_round
    from repro_torch.launch import train
    from repro_torch.models.lm import build_lm
    from repro_torch.optim.sgd import sgd_momentum
    from repro_torch.utils.pytree import tree_leaves

    losses, params, opt_state = train.run(
        ["--steps", "2", "--nodes", "2", "--batch", "2", "--seq", "32",
         "--ckpt-dir", str(tmp_path)])
    assert np.isfinite(losses).all()
    restored, manifest = restore_checkpoint(str(tmp_path))
    assert manifest["step"] == 2 and manifest["metadata"]["mode"] == "dfl"
    state = {"params": params, "opt": opt_state}
    assert len(tree_leaves(restored)) == len(tree_leaves(state))
    for a, b in zip(tree_leaves(restored), tree_leaves(state)):
        assert a.device.type == "cuda" and a.dtype == b.dtype
        assert torch.equal(a, b)
    lm = build_lm(get_config("qwen1.5-0.5b").reduced(n_layers=4, d_model=256,
                                                     vocab=2048))
    rnd = build_dfl_round(lm, sgd_momentum(lr=3e-3, momentum=0.9),
                          train.ring_adjacency(2))
    batch = next(iter(train.make_batches(lm, 2, 2, 32, 1, card,
                                         seed=2 * 131)))
    before = ops.LAUNCHES["decdiff_update"]
    p_r, _, loss_r = rnd(restored["params"], restored["opt"], 2, batch)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["decdiff_update"] == before + 1
    p_m, _, loss_m = rnd(params, opt_state, 2, batch)
    assert float(loss_r) == float(loss_m)
    for a, b in zip(tree_leaves(p_r), tree_leaves(p_m)):
        assert torch.equal(a, b)
