"""The port's segment reduce against the JAX Pallas kernel, and its bitwise
contract inside the port.

On the CPU the wrapper takes the kernel's plain PyTorch version (the CUDA
kernel runs only on the card: see tests/test_torch_cuda.py).
The JAX side runs the Pallas kernel in interpret mode, as the JAX
package's own tests run it.

Tolerance against JAX: rtol=1e-5, atol=1e-6.  XLA contracts each row with
a dot that may sum in another order or fuse multiply and add (FMA), so
the two packages agree to fp32 rounding, not bit for bit.  A reordered
sum errs in proportion to the size of its terms, not of its result, so
the relative part is taken against Σ_k |w_k·v_k| (signed inputs can
cancel to a result far smaller than the terms).  Inside the
port the contract is bitwise: row blocking, K zero-padding and finite
garbage in zero-weight slots change no bit.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp

from repro.kernels.ops import segment_neighbor_avg as jax_segment_avg
from repro_torch.kernels import ops

RTOL, ATOL = 1e-5, 1e-6


def _inputs(b, k, d, seed=0, zero_frac=0.3):
    rng = np.random.default_rng([seed, b, k, d])
    vals = rng.standard_normal((b, k, d)).astype(np.float32)
    w = rng.uniform(0.5, 3.0, (b, k)).astype(np.float32)
    w[rng.random((b, k)) < zero_frac] = 0.0
    return vals, w


@pytest.mark.parametrize("d", [1, 255, 2051])
@pytest.mark.parametrize("k", [1, 3, 8, 10])
@pytest.mark.parametrize("b", [1, 8, 13])
def test_matches_jax_reference(b, k, d):
    vals, w = _inputs(b, k, d)
    js, jt = jax_segment_avg(vals, w)
    ps, pt = ops.segment_neighbor_avg(torch.from_numpy(vals),
                                      torch.from_numpy(w))
    scale = np.einsum("bk,bkd->bd", np.abs(w), np.abs(vals))
    err = np.abs(ps.numpy() - np.asarray(js))
    assert (err <= ATOL + RTOL * scale).all(), err.max()
    np.testing.assert_allclose(pt.numpy(), np.asarray(jt), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("b,k,d", [(13, 10, 2051), (8, 3, 255), (5, 1, 7)])
def test_row_blocking_is_bitwise_neutral(b, k, d):
    vals, w = map(torch.from_numpy, _inputs(b, k, d, seed=1))
    sums, tot = ops.segment_neighbor_avg(vals, w)
    for lo, hi in [(0, 1), (1, b), (0, b // 2), (b // 2, b)]:
        if lo == hi:
            continue
        s, t = ops.segment_neighbor_avg(vals[lo:hi].contiguous(),
                                        w[lo:hi].contiguous())
        assert torch.equal(s, sums[lo:hi]) and torch.equal(t, tot[lo:hi])


@pytest.mark.parametrize("garbage", [0.0, 3.4e38, -7.5])
@pytest.mark.parametrize("b,k,d,pad", [(13, 10, 2051, 6), (8, 3, 255, 5),
                                       (1, 1, 1, 15)])
def test_k_padding_is_bitwise_neutral(b, k, d, pad, garbage):
    vals, w = _inputs(b, k, d, seed=2)
    sums, tot = ops.segment_neighbor_avg(torch.from_numpy(vals),
                                         torch.from_numpy(w))
    vals_p = np.concatenate(
        [vals, np.full((b, pad, d), garbage, np.float32)], axis=1)
    w_p = np.concatenate([w, np.zeros((b, pad), np.float32)], axis=1)
    s, t = ops.segment_neighbor_avg(torch.from_numpy(vals_p),
                                    torch.from_numpy(w_p))
    assert torch.equal(s, sums) and torch.equal(t, tot)


def test_garbage_in_zero_weight_slots_is_bitwise_neutral():
    vals, w = _inputs(13, 10, 257, seed=3, zero_frac=0.5)
    clean = np.where(w[:, :, None] == 0, 0.0, vals).astype(np.float32)
    dirty = np.where(w[:, :, None] == 0, 3.4e38, vals).astype(np.float32)
    s0, t0 = ops.segment_neighbor_avg(torch.from_numpy(clean),
                                      torch.from_numpy(w))
    s1, t1 = ops.segment_neighbor_avg(torch.from_numpy(dirty),
                                      torch.from_numpy(w))
    assert torch.equal(s0, s1) and torch.equal(t0, t1)
    assert torch.isfinite(s1).all()


def test_totals_ride_the_ordered_loop():
    vals, w = _inputs(8, 10, 3, seed=4)
    _, tot = ops.segment_neighbor_avg(torch.from_numpy(vals),
                                      torch.from_numpy(w))
    ref = np.zeros(8, np.float32)
    for j in range(10):
        ref = (ref + w[:, j]).astype(np.float32)
    np.testing.assert_array_equal(tot.numpy(), ref)


@pytest.mark.parametrize("bad", ["dtype", "shape", "contig", "device"])
def test_wrapper_rejects_bad_inputs(bad):
    vals, w = map(torch.from_numpy, _inputs(4, 3, 9))
    if bad == "dtype":
        vals = vals.double()
    elif bad == "shape":
        w = w[:, :2].contiguous()
    elif bad == "contig":  # same shapes, strided storage
        vals = vals.transpose(0, 2).contiguous().transpose(0, 2)
        w = w.t().contiguous().t()
    else:  # a non-CPU, non-CUDA tensor never takes the plain path
        vals, w = vals.to("meta"), w.to("meta")
    with pytest.raises((TypeError, ValueError)):
        ops.segment_neighbor_avg(vals, w)


def test_cpu_path_counts_no_launch():
    ops.reset_launches()
    vals, w = map(torch.from_numpy, _inputs(4, 3, 9))
    ops.segment_neighbor_avg(vals, w)
    assert ops.LAUNCHES["segment_neighbor_avg"] == 0


def test_ctypes_binding_declares_64_bit_arguments(monkeypatch):
    """Without argtypes, ctypes passes Python ints as 32-bit ints and cuts
    the device pointers; the binding must declare every argument."""
    import ctypes
    import types

    from repro_torch.kernels import _build
    from repro_torch.kernels import segment_avg as sa

    fake = types.SimpleNamespace(segment_avg_f32=types.SimpleNamespace(
        argtypes=None, restype=ctypes.c_int))
    monkeypatch.setattr(_build, "load", lambda name: fake)
    fn = sa._library().segment_avg_f32
    assert fn.argtypes == [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 3 + [
        ctypes.c_void_p]
    assert fn.restype is ctypes.c_int


# ------------------------------------------------------------ gather rows

def _table(m, d, seed=0):
    rng = np.random.default_rng([seed, m, d])
    return rng.standard_normal((m, d)).astype(np.float32)


@pytest.mark.parametrize("m,d,idx", [
    (12, 7, [3, 3, 0, 11, 0, 0, 5]),          # repeats, D odd
    (40, 2050, list(range(40))[::-1] * 2),     # D = 2 mod 4, every row twice
    (6, 4096, [0] * 9 + [5]),                 # padding slots alias row 0
    (1, 1, [0, 0]),
    (5, 3, [4]),
])
def test_gather_rows_plain_matches_jax_bitwise(m, d, idx):
    """A pure copy: bitwise equal to the Pallas kernel (interpret mode)."""
    from repro.kernels.ops import gather_rows as jax_gather_rows

    tbl = _table(m, d)
    idx = np.asarray(idx, np.int64)
    want = np.asarray(jax_gather_rows(tbl, idx.astype(np.int32),
                                      interpret=True))
    got = ops.gather_rows(torch.from_numpy(tbl), torch.from_numpy(idx))
    assert got.shape == (len(idx), d) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want.reshape(len(idx), d))


def test_gather_rows_on_the_per_edge_index():
    """The transport's real flat index (16-node BA m=2): the plain version
    equals the reference's gather and fancy indexing."""
    from repro.kernels.ops import gather_rows as jax_gather_rows
    from repro_torch.comm import CommConfig, EdgeGossipTransport
    from repro_torch.graphs.topology import make_topology

    topo = make_topology("barabasi_albert", n=16, m=2, seed=0)
    tr = EdgeGossipTransport(CommConfig(per_edge=True),
                             {"w": torch.zeros((16, 1))}, topo.neighbor_idx,
                             topo.neighbor_mask)
    n_slots = 16 * topo.max_degree
    tbl = _table(n_slots, 33, seed=1)
    idx = tr.flat_idx.numpy()
    assert idx.shape == (n_slots,)
    # padding slots alias row 0; valid slots are a permutation of themselves
    valid = topo.neighbor_mask.reshape(-1) > 0
    assert (idx[~valid] == 0).all()
    assert sorted(idx[valid].tolist()) == np.flatnonzero(valid).tolist()
    got = ops.gather_rows(torch.from_numpy(tbl), tr.flat_idx)
    want = np.asarray(jax_gather_rows(tbl, idx.astype(np.int32),
                                      interpret=True))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), tbl[idx])


@pytest.mark.parametrize("bad", ["dtype", "idx-dtype", "shape", "contig",
                                 "device", "empty-table"])
def test_gather_rows_wrapper_rejects_bad_inputs(bad):
    tbl, idx = torch.from_numpy(_table(6, 5)), torch.tensor([0, 5, 2])
    if bad == "dtype":
        tbl = tbl.double()
    elif bad == "idx-dtype":
        idx = idx.to(torch.int32)
    elif bad == "shape":
        idx = idx[None, :]
    elif bad == "contig":
        tbl = tbl.t().contiguous().t()
    elif bad == "device":
        tbl, idx = tbl.to("meta"), idx.to("meta")
    else:
        tbl = tbl[:0]
    with pytest.raises((TypeError, ValueError)):
        ops.gather_rows(tbl, idx)


def test_gather_rows_cpu_path_counts_no_launch():
    ops.reset_launches()
    ops.gather_rows(torch.from_numpy(_table(6, 5)), torch.tensor([1, 1, 4]))
    empty = ops.gather_rows(torch.from_numpy(_table(6, 5)),
                            torch.zeros((0,), dtype=torch.int64))
    assert empty.shape == (0, 5)
    assert set(ops.LAUNCHES) >= {"segment_neighbor_avg", "gather_rows"}
    assert not any(ops.LAUNCHES.values())


def test_gather_rows_ctypes_binding_declares_64_bit_arguments(monkeypatch):
    import ctypes
    import types

    from repro_torch.kernels import _build
    from repro_torch.kernels import gather_rows as gr

    fake = types.SimpleNamespace(gather_rows_f32=types.SimpleNamespace(
        argtypes=None, restype=ctypes.c_int))
    monkeypatch.setattr(_build, "load", lambda name: fake)
    fn = gr._library().gather_rows_f32
    assert fn.argtypes == [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 3 + [
        ctypes.c_void_p]
    assert fn.restype is ctypes.c_int


def test_every_kernel_source_is_built_by_name():
    """Each csrc/*.cu has a wrapper entry, so `_build.build` of the
    wrappers' names builds every kernel of the port."""
    from repro_torch.kernels import _build

    sources = sorted(p.stem for p in _build.CSRC_DIR.glob("*.cu"))
    assert sources == ["decdiff_update", "decode_attention",
                       "decode_attention_split", "dequant_avg",
                       "dequant_avg_rows", "dequant_segment_avg",
                       "gather_rows", "neighbor_avg", "segment_avg",
                       "vt_kl_loss"]
    assert sorted(ops.LAUNCHES) == [
        "decdiff_update", "decode_attention_fused", "decode_scores_partial",
        "decode_softmax_combine", "dequant_neighbor_avg",
        "dequant_neighbor_avg_rows", "dequant_segment_neighbor_avg",
        "drift_norms", "gather_rows", "neighbor_avg", "segment_neighbor_avg",
        "vt_kl_loss_bwd", "vt_kl_loss_fwd", "vt_kl_partial_fwd",
        "vt_kl_shard_bwd"]


# --------------------------------------------------- dequant avg rows

def _payload(n, r, d, seed=0, zero_rows=(0,)):
    rng = np.random.default_rng([seed, n, r, d])
    q = rng.integers(-127, 128, (n, d)).astype(np.int8)
    scale = rng.uniform(1e-3, 0.05, n).astype(np.float32)
    wn = rng.uniform(0.0, 1.0, (r, n)).astype(np.float32)
    wn[rng.random((r, n)) < 0.3] = 0.0
    for i in zero_rows:
        wn[i] = 0.0  # a receiver that heard from nobody
    wn /= np.maximum(wn.sum(1, keepdims=True), 1e-30)
    return q, scale, wn


@pytest.mark.parametrize("n,r,d", [(4, 4, 2051), (8, 8, 4099), (5, 3, 7),
                                   (1, 2, 2048), (4, 4, 6144)])
def test_dequant_avg_rows_matches_jax(n, r, d):
    """The plain version against the Pallas kernel (interpret mode) at D
    that is and is not a multiple of its 2048-column tile, with a zero
    weight row.  Tolerance rtol=1e-5, atol=1e-6 against Σ_n |ws·q|: the
    reference contracts the tile with a dot, in another order."""
    from repro.kernels.ops import dequant_neighbor_avg_rows as jdq

    q, scale, wn = _payload(n, r, d)
    want = np.asarray(jdq(q, scale, wn, interpret=True))
    got = ops.dequant_neighbor_avg_rows(torch.from_numpy(q),
                                        torch.from_numpy(scale),
                                        torch.from_numpy(wn))
    assert got.shape == (r, d) and got.dtype == torch.float32
    ws = wn * scale[None, :]
    bound = np.abs(ws) @ np.abs(q.astype(np.float32))
    assert (np.abs(got.numpy() - want) <= ATOL + RTOL * bound).all()
    assert not got[0].any()  # the zero row averages to exactly zero


def test_dequant_avg_rows_plain_is_the_ordered_loop():
    """The plain version is the kernel's arithmetic: ws = wn·scale, then
    acc + ws[:, n]·q[n] in n order from +0, one rounding per operation."""
    from repro_torch.kernels.dequant_avg import dequant_avg_rows_plain

    q, scale, wn = _payload(6, 3, 257, seed=1)
    ws = (wn * scale[None, :]).astype(np.float32)
    ref = np.zeros((3, 257), np.float32)
    for j in range(6):
        ref = (ref + (ws[:, j:j + 1] * q[j].astype(np.float32)
                      ).astype(np.float32)).astype(np.float32)
    got = ops.dequant_neighbor_avg_rows(torch.from_numpy(q),
                                        torch.from_numpy(scale),
                                        torch.from_numpy(wn))
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(
        dequant_avg_rows_plain(torch.from_numpy(q),
                               torch.from_numpy(ws)).numpy(), ref)


@pytest.mark.parametrize("bad", ["q-dtype", "w-dtype", "shape", "contig",
                                 "device"])
def test_dequant_avg_rows_wrapper_rejects_bad_inputs(bad):
    q, scale, wn = map(torch.from_numpy, _payload(4, 2, 9))
    if bad == "q-dtype":
        q = q.to(torch.int16)
    elif bad == "w-dtype":
        wn = wn.double()
    elif bad == "shape":
        wn = wn[:, :3].contiguous()
    elif bad == "contig":
        q = q.t().contiguous().t()
    else:
        q, scale, wn = q.to("meta"), scale.to("meta"), wn.to("meta")
    with pytest.raises((TypeError, ValueError)):
        ops.dequant_neighbor_avg_rows(q, scale, wn)


# ------------------------------------------------------------ vt kl loss

def _logits(b, v, seed=0, dtype=np.float32):
    rng = np.random.default_rng([seed, b, v])
    z = (rng.standard_normal((b, v)) * 3).astype(np.float32)
    y = rng.integers(0, v, b)
    y[0], y[-1] = 0, v - 1  # labels at the first and last lanes
    return z, y


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("b", [1, 37, 130])
@pytest.mark.parametrize("v", [10, 1000, 4099])
def test_vt_kl_loss_matches_jax(v, b, bf16):
    """The plain loss and its gradient against the Pallas kernels
    (interpret mode) and the reference's closed form, at row counts that
    are not multiples of the 128-row tile and V that is not a multiple of
    the 512-lane tile.  Tolerances: the loss to rtol=atol=1e-5 (fp32 sums
    over V in another order); the fp32 gradient to atol=1e-7 (its entries
    are (p - p_t)/B, below 1/B); a bf16 gradient to one bf16 rounding of
    the fp32 value (rtol=2^-8) plus 1e-7."""
    from repro.core.virtual_teacher import vt_kl_loss as jvt
    from repro.kernels.ops import vt_kl_loss_fused as jfused
    from repro_torch.core.virtual_teacher import teacher_entropy

    z, y = _logits(b, v)
    jdt = jnp.bfloat16 if bf16 else jnp.float32
    jz = jnp.asarray(z).astype(jdt)
    beta = 0.98
    fl, fg = jax.value_and_grad(
        lambda zz: jfused(zz, jnp.asarray(y, jnp.int32), beta, True))(jz)
    cl, cg = jax.value_and_grad(lambda zz: jvt(zz, y, beta=beta))(jz)
    tz = torch.from_numpy(z).to(torch.bfloat16 if bf16 else torch.float32)
    tz.requires_grad_(True)
    h = float(teacher_entropy(beta, v))
    kl = ops.vt_kl_loss(tz, torch.from_numpy(y), beta, -h)
    assert kl.shape == (b,) and kl.dtype == torch.float32
    loss = kl.mean()
    (g,) = torch.autograd.grad(loss, tz)
    assert g.dtype == tz.dtype
    g = g.float().numpy()
    grtol = 2.0 ** -8 if bf16 else 0.0
    for jl_, jg_ in [(fl, fg), (cl, cg)]:
        np.testing.assert_allclose(float(loss.detach()), float(jl_),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(g, np.asarray(jg_, np.float32),
                                   rtol=grtol, atol=1e-7)


def test_vt_kl_loss_row_gradients_and_mask():
    """The backward scales each row by its own incoming gradient, which is
    what a `where=` mask and a per-node mean give it."""
    from repro.core.virtual_teacher import vt_kl_loss as jvt
    from repro_torch.core.virtual_teacher import vt_kl_loss

    z, y = _logits(12, 33, seed=5)
    mask = np.random.default_rng(7).random(12) < 0.6
    jl, jg = jax.value_and_grad(
        lambda zz: jvt(zz, y, beta=0.9, where=mask))(jnp.asarray(z))
    tz = torch.from_numpy(z).requires_grad_(True)
    tl = vt_kl_loss(tz, torch.from_numpy(y), beta=0.9,
                    where=torch.from_numpy(mask))
    (tg,) = torch.autograd.grad(tl, tz)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=1e-7)
    assert not tg[torch.from_numpy(~mask)].any()


def test_vt_kl_loss_plain_backward_formula():
    """(exp(z - max)/Σexp - p_t) · g, with p_t = β on the label and
    (1-β)/(V-1) elsewhere."""
    from repro_torch.kernels.vt_kl_loss import (
        vt_backward_plain,
        vt_forward_plain,
    )

    z, y = _logits(5, 17, seed=2)
    tz, ty = torch.from_numpy(z), torch.from_numpy(y)
    _, mx, se = vt_forward_plain(tz, ty, 0.95, 0.0)
    g = torch.arange(1, 6, dtype=torch.float32)
    got = vt_backward_plain(tz, ty, mx, se, g, 0.95).numpy()
    p = np.exp(z - z.max(1, keepdims=True))
    p /= p.sum(1, keepdims=True)
    pt = np.full_like(p, 0.05 / 16)
    pt[np.arange(5), y] = 0.95
    np.testing.assert_allclose(got, (p - pt) * g.numpy()[:, None],
                               rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("bad", ["dtype", "label-dtype", "shape", "contig",
                                 "one-class", "device"])
def test_vt_kl_loss_wrapper_rejects_bad_inputs(bad):
    z, y = map(torch.from_numpy, _logits(4, 9))
    if bad == "dtype":
        z = z.double()
    elif bad == "label-dtype":
        y = y.to(torch.int32)
    elif bad == "shape":
        y = y[:3]
    elif bad == "contig":
        z = torch.from_numpy(_logits(9, 4)[0]).t()
    elif bad == "one-class":
        z = z[:, :1].contiguous()
    else:
        z, y = z.to("meta"), y.to("meta")
    with pytest.raises((TypeError, ValueError)):
        ops.vt_kl_loss(z, y, 0.9, 0.0)


def _plan_tier(plan):
    """The forward tier a plan launches (csrc/vt_kl_loss.cu)."""
    return "group" if plan.rows_per_block > 1 else "block"


def _registered_vocabs():
    from repro_torch.configs.registry import ARCH_IDS, get_config

    out = set()
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        out |= {cfg.vocab, cfg.reduced().vocab}
    return sorted(out)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_vt_plan_over_every_vocabulary(dtype):
    """`vt_plan` at V = 2..5000 and every registered vocabulary (full and
    reduced): the vector width divides a row's bytes (every row starts at
    the same phase), a sub-warp group is a power of two of 2-32 lanes,
    each holding at most one step of loads, a CTA's threads are whole
    warps, at most 1024, lanes x rows per block of them, one CTA a row,
    and both forward tiers occur.  At a smaller alignment the width drops
    to it."""
    from repro_torch.kernels import vt_kl_loss as vt
    from repro_torch.kernels.vt_kl_loss import vt_plan

    elt = 4 if dtype == torch.float32 else 2
    vocabs = list(range(2, 5001)) + _registered_vocabs()
    assert {32000, 50280, 51866, 151936} <= set(vocabs)
    tiers = set()
    for v in vocabs:
        plan = vt_plan(v, dtype)
        nvec = v * elt // plan.vec_bytes
        assert plan.vec_bytes in (2, 4, 8, 16) and plan.vec_bytes >= elt
        assert (v * elt) % plan.vec_bytes == 0
        # the widest width that divides the row
        assert plan.vec_bytes == 16 or (v * elt) % (2 * plan.vec_bytes)
        assert plan.threads == plan.lanes * plan.rows_per_block
        assert plan.threads % 32 == 0 and plan.threads <= 1024
        tier = _plan_tier(plan)
        tiers.add(tier)
        if tier == "group":  # each lane's share is one step of loads
            assert plan.lanes in (2, 4, 8, 16, 32)
            assert nvec <= plan.lanes * (vt.LOAD_BYTES // plan.vec_bytes)
        else:
            assert plan.rows_per_block == 1 and plan.lanes % 32 == 0
        for align in (2, 4, 8):
            if align >= elt:
                low = vt_plan(v, dtype, align)
                assert low.vec_bytes <= align
                assert (v * elt) % low.vec_bytes == 0
    assert tiers == {"group", "block"}


def test_vt_plan_constants_are_the_kernels():
    """The plan's step and block limits are the ones csrc/vt_kl_loss.cu
    checks and unrolls by."""
    import re

    from repro_torch.kernels import _build
    from repro_torch.kernels import vt_kl_loss as vt

    src = (_build.CSRC_DIR / "vt_kl_loss.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src)[1])

    assert const("kLoadBytes") == vt.LOAD_BYTES
    assert const("kMaxThreads") == vt.MAX_THREADS == vt.GROUP_THREADS
    assert const("kGroupMaxLanes") * vt.LOAD_BYTES == vt.GROUP_BYTES


def test_vt_plan_takes_no_row_count_and_refuses_what_it_cannot_take():
    """The plan's inputs are (V, dtype, alignment): no row count, so a
    row's summation order cannot depend on B.  It refuses one class, a
    dtype the kernels do not take and a pointer off its element size."""
    import inspect

    from repro_torch.kernels.vt_kl_loss import _align, vt_plan

    assert list(inspect.signature(vt_plan).parameters) == ["v", "dtype",
                                                           "align"]
    with pytest.raises(ValueError):
        vt_plan(1, torch.float32)
    with pytest.raises(TypeError):
        vt_plan(10, torch.float16)
    with pytest.raises(ValueError):
        vt_plan(10, torch.float32, align=2)
    x = torch.zeros(64, dtype=torch.float32)  # 64-byte aligned on the CPU
    assert _align(x) == _align(x[4:]) == 16
    assert _align(x[1:]) == 4 and _align(x, x[2:]) == 8


def test_new_wrappers_count_no_launch_on_the_cpu():
    ops.reset_launches()
    q, scale, wn = map(torch.from_numpy, _payload(4, 2, 9))
    ops.dequant_neighbor_avg_rows(q, scale, wn)
    z, y = map(torch.from_numpy, _logits(4, 9))
    z.requires_grad_(True)
    ops.vt_kl_loss(z, y, 0.9, 0.0).sum().backward()
    assert not any(ops.LAUNCHES.values())


@pytest.mark.parametrize("module,fn,n_ptr,n_int,n_float,n_cint", [
    ("dequant_avg", "dequant_avg_rows_f32", 3, 3, 0, 0),
    # vt_kl_fwd's ints: the dtype and the plan (vec_bytes, lanes,
    # rows_per_block); vt_kl_bwd's: the dtype and vec_bytes
    ("vt_kl_loss", "vt_kl_fwd", 5, 2, 3, 4),
    ("vt_kl_loss", "vt_kl_bwd", 6, 2, 2, 2),
    ("neighbor_avg", "neighbor_avg_f32", 3, 2, 0, 1),
    # the vocab-parallel forms: their ints as the above, plus the shard's
    # offset (and the whole vocabulary) as 64-bit sizes
    ("vt_kl_loss", "vt_kl_partial_fwd", 6, 4, 0, 4),
    ("vt_kl_loss", "vt_kl_bwd_shard", 6, 3, 2, 2),
], ids=["dequant_avg-dequant_avg_rows_f32-3-3-0",
        "vt_kl_loss-vt_kl_fwd-5-2-3", "vt_kl_loss-vt_kl_bwd-6-2-2",
        "neighbor_avg-neighbor_avg_f32-3-2-0",
        "vt_kl_loss-vt_kl_partial_fwd-6-4-0",
        "vt_kl_loss-vt_kl_bwd_shard-6-3-2"])
def test_new_ctypes_bindings_declare_their_arguments(monkeypatch, module, fn,
                                                     n_ptr, n_int, n_float,
                                                     n_cint):
    """Every pointer and 64-bit size is declared (ctypes would pass 32-bit
    ints otherwise), the floats as c_float and the 32-bit ints as c_int,
    and nothing else: the argument list is the C function's.  A launcher
    that binds once (it caches the library in `_LIB`) loads and declares at
    its first call only."""
    import ctypes
    import importlib
    import types

    from repro_torch.kernels import _build

    fns = {name: types.SimpleNamespace(argtypes=None, restype=None)
           for name in ("dequant_avg_rows_f32", "vt_kl_fwd", "vt_kl_bwd",
                        "neighbor_avg_f32", "vt_kl_partial_fwd",
                        "vt_kl_bwd_shard")}
    loads = []

    def fake_load(name):
        loads.append(name)
        return types.SimpleNamespace(**fns)

    monkeypatch.setattr(_build, "load", fake_load)
    mod = importlib.import_module(f"repro_torch.kernels.{module}")
    bound_once = hasattr(mod, "_LIB")
    if bound_once:
        monkeypatch.setattr(mod, "_LIB", None)
    lib = mod._library()
    args = getattr(lib, fn).argtypes
    assert args.count(ctypes.c_void_p) == n_ptr + 1  # + the stream
    assert args.count(ctypes.c_int64) == n_int
    assert args.count(ctypes.c_float) == n_float
    assert args.count(ctypes.c_int) == n_cint
    assert len(args) == n_ptr + 1 + n_int + n_float + n_cint
    assert args[-1] is ctypes.c_void_p
    assert getattr(lib, fn).restype is ctypes.c_int
    if bound_once:
        getattr(lib, fn).argtypes = None  # a second call must not re-bind
        assert mod._library() is lib and loads == [module]
        assert getattr(lib, fn).argtypes is None


# --------------------------------------------------- decode attention

DECODE_SWEEP = [(1, 16, 1, 1, 16), (2, 600, 2, 2, 64), (4, 1024, 8, 1, 128),
                (3, 512, 4, 8, 64)]


def _decode_inputs(b, w, kk, g, hd, cache_dtype, filled=None, seed=None):
    """The reference sweep's inputs (`tests/test_kernels.py`), as jnp and
    as torch on the CPU; a bf16 cache crosses as its exact fp32 values."""
    rng = np.random.default_rng(b * w + hd if seed is None else seed)
    h = kk * g
    q = rng.standard_normal((b, h, hd)).astype(np.float32)
    k = jnp.asarray(rng.standard_normal((b, w, kk, hd)), cache_dtype)
    v = jnp.asarray(rng.standard_normal((b, w, kk, hd)), cache_dtype)
    filled = max(w - 5, 1) if filled is None else filled
    sp = np.array([i if i < filled else -1 for i in range(w)], np.int32)
    tdt = torch.bfloat16 if cache_dtype == jnp.bfloat16 else torch.float32
    tk, tv = (torch.tensor(np.asarray(x.astype(jnp.float32))).to(tdt)
              for x in (k, v))
    return ((jnp.asarray(q), k, v, jnp.asarray(sp), jnp.int32(filled - 1)),
            (torch.from_numpy(q), tk, tv, torch.from_numpy(sp),
             torch.tensor(filled - 1, dtype=torch.int32)))


@pytest.mark.parametrize("b,w,kk,g,hd", DECODE_SWEEP)
@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
def test_decode_attention_plain_matches_jax(b, w, kk, g, hd, cache_dtype):
    """The port's plain version against the reference's Pallas kernel
    (interpreted) and its oracle `decode_attention_ref`, rtol = atol =
    2e-5 as the reference holds its kernel to its oracle."""
    from repro.kernels import decode_attention_fused as jfused
    from repro.kernels.ref import decode_attention_ref

    jin, tin = _decode_inputs(b, w, kk, g, hd, getattr(jnp, cache_dtype))
    got = ops.decode_attention_fused(*tin)
    assert got.dtype == torch.float32 and tuple(got.shape) == (b, kk * g, hd)
    for want in (jfused(*jin), decode_attention_ref(*jin)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                                   atol=2e-5)


@pytest.mark.parametrize("window", [1, 7, 300])
def test_decode_attention_window_is_the_layer_clause(window):
    """`window` > 0 masks slot_pos <= pos - window, as the reference layer's
    sliding-window clause does: the same as handing the reference's oracle
    those slots emptied (-1)."""
    from repro.kernels.ref import decode_attention_ref

    jin, tin = _decode_inputs(2, 600, 2, 2, 64, jnp.float32)
    q, k, v, sp, pos = jin
    emptied = jnp.where(sp > pos - window, sp, -1)
    got = ops.decode_attention_fused(*tin, window=window)
    want = decode_attention_ref(q, k, v, emptied, pos)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)
    assert not torch.allclose(got, ops.decode_attention_fused(*tin))


def test_decode_attention_plain_of_bf16_queries_and_an_empty_ring():
    """A bf16 query reads as its fp32 value; a row whose every slot is
    masked gets the softmax of equal scores, the uniform average, as the
    reference's oracle does."""
    from repro.kernels.ref import decode_attention_ref

    jin, tin = _decode_inputs(2, 64, 2, 4, 32, jnp.bfloat16)
    q = tin[0].to(torch.bfloat16)
    got = ops.decode_attention_fused(q, *tin[1:])
    want = ops.decode_attention_fused(q.float(), *tin[1:])
    assert torch.equal(got, want)
    empty = torch.full_like(tin[3], -1)
    got = ops.decode_attention_fused(tin[0], tin[1], tin[2], empty, tin[4])
    want = decode_attention_ref(jin[0], jin[1], jin[2],
                                jnp.asarray(empty.numpy()), jin[4])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)
    torch.testing.assert_close(
        got, tin[2].float().mean(1).repeat_interleave(4, dim=1), rtol=2e-5,
        atol=2e-5)


@pytest.mark.parametrize("bad", ["q-dtype", "kv-dtypes", "pos-dtype",
                                 "sp-dtype", "heads", "shape", "contig",
                                 "device", "pos-shape", "empty"])
def test_decode_attention_wrapper_rejects_bad_inputs(bad):
    _, (q, k, v, sp, pos) = _decode_inputs(2, 16, 2, 2, 16, jnp.float32)
    if bad == "q-dtype":
        q = q.double()
    elif bad == "kv-dtypes":
        v = v.to(torch.bfloat16)
    elif bad == "pos-dtype":
        pos = pos.long()
    elif bad == "sp-dtype":
        sp = sp.long()
    elif bad == "heads":  # H not a multiple of K
        q = q[:, :3].contiguous()
    elif bad == "shape":
        sp = sp[:-1].contiguous()
    elif bad == "contig":
        k = k.transpose(0, 1).contiguous().transpose(0, 1)
    elif bad == "device":
        q, k, v, sp, pos = (t.to("meta") for t in (q, k, v, sp, pos))
    elif bad == "pos-shape":
        pos = pos.reshape(1)
    else:
        k, v, sp = k[:, :0], v[:, :0], sp[:0]
    with pytest.raises((TypeError, ValueError)):
        ops.decode_attention_fused(q, k, v, sp, pos)


def _wave_fill(blocks, resident):
    return blocks / (-(-blocks // resident) * resident)


@pytest.mark.parametrize("sms,per_sm", [(132, 3), (132, 2), (132, 1),
                                        (114, 3), (8, 2)])
@pytest.mark.parametrize("b,kk,w,tile", [
    (8, 16, 32768, 64), (8, 8, 32768, 32), (8, 8, 32768, 16),
    (3, 16, 1000, 64), (3, 16, 40, 64), (2, 16, 4097, 64), (1, 1, 1, 256),
    (1, 2, 1, 16), (4, 2, 4096, 64), (5, 8, 4099, 32), (64, 16, 513, 128),
    (1000, 1, 300, 64)])
def test_decode_split_planner(b, kk, w, tile, sms, per_sm):
    """The split/wave planner, a pure function: whole tiles per split, no
    empty split (S·sps ≥ W > (S − 1)·sps), and a last wave at least 90%
    full whenever any split count gets there (checked by trying them all),
    with the fewest splits that do; else the best fill."""
    from repro_torch.kernels.decode_attention import (
        MIN_WAVE_FILL,
        plan_splits,
    )

    s, sps = plan_splits(b, kk, w, tile, sms, per_sm)
    assert s >= 1 and sps % tile == 0
    assert s * sps >= w > (s - 1) * sps
    resident = sms * per_sm
    ntiles = -(-w // tile)
    counts = sorted({-(-ntiles // -(-ntiles // x))
                     for x in range(1, ntiles + 1)})
    fills = {c: _wave_fill(b * kk * c, resident) for c in counts}
    fill = _wave_fill(b * kk * s, resident)
    good = [c for c in counts if fills[c] >= MIN_WAVE_FILL]
    if good:
        assert fill >= MIN_WAVE_FILL and s == good[0]
    else:
        assert fill == max(fills.values())


def test_decode_split_planner_fills_the_serving_shapes():
    """Path e's cache and the GQA shapes the decode kernel must hold fill
    their last wave to >= 90% at the H100's 132 SMs, at 1-3 resident
    blocks per SM: B·K/2 block rows (two KV heads a block) in tiles of 32
    slots at hd 64 and of 16 at hd 128, and with one head a block."""
    from repro_torch.kernels.decode_attention import plan_splits

    for per_sm in (1, 2, 3):
        for b, kk, w, tile in [(8, 8, 32768, 32), (8, 4, 32768, 16),
                               (8, 16, 32768, 64), (8, 8, 32768, 32)]:
            s, sps = plan_splits(b, kk, w, tile, 132, per_sm)
            assert _wave_fill(b * kk * s, 132 * per_sm) >= 0.9
            assert sps >= 8 * tile  # long splits: the TMA ring fills


def test_decode_group_width():
    from repro_torch.kernels.decode_attention import group_width

    assert [group_width(g) for g in range(1, 9)] == [1, 2, 4, 4, 8, 8, 8, 8]


# ----------------------------------------------------- Eq. 5 (decdiff)


def _flat_pair(n, dtype, seed=None):
    rng = np.random.default_rng(n if seed is None else seed)
    w = jnp.asarray(rng.standard_normal(n), dtype)
    wb = jnp.asarray(rng.standard_normal(n), dtype)
    tdt = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    return (w, wb), tuple(torch.tensor(np.asarray(x.astype(jnp.float32)))
                          .to(tdt) for x in (w, wb))


def _close_in(dtype):
    """fp32: rtol 1e-5.  bf16: both packages round the same fp32 formula
    once into bf16, from norms summed in another order, so an element
    may land one bf16 rounding (2^-8 relative, 2^-7 at most) apart."""
    return (dict(rtol=1e-5, atol=1e-6) if dtype == jnp.float32 else
            dict(rtol=2.0 ** -7, atol=1e-6))


@pytest.mark.parametrize("n", [17, 1000, 32768, 100_001, 500_000])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decdiff_update_matches_jax(n, dtype):
    """`ops.decdiff_update` against the reference's wrapper (its two Pallas
    kernels interpreted) over the reference's sweep."""
    from repro.kernels import decdiff_update as jdd

    dt = getattr(jnp, dtype)
    (w, wb), (tw, twb) = _flat_pair(n, dt)
    got = ops.decdiff_update(tw, twb, s=1.0)
    assert got.dtype == tw.dtype and tuple(got.shape) == (n,)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(jdd(w, wb, s=1.0).astype(
                                   jnp.float32)), **_close_in(dt))


@pytest.mark.parametrize("s", [1.0, 2.5])
def test_decdiff_update_s_param_matches_jax(s):
    from repro.kernels import decdiff_update as jdd

    (w, wb), (tw, twb) = _flat_pair(5000, jnp.float32, seed=0)
    np.testing.assert_allclose(ops.decdiff_update(tw, twb, s=s).numpy(),
                               np.asarray(jdd(w, wb, s=s)), rtol=1e-5)


def test_decdiff_update_tree_matches_jax():
    """One distance over every leaf of a mixed fp32 / bf16 tree, each leaf
    updated in its own dtype (the reference's `decdiff_update_tree`)."""
    from repro.kernels import decdiff_update_tree as jtree
    from repro_torch.utils.pytree import tree_leaves

    rng = np.random.default_rng(3)
    shapes = {"a": (64, 33), "b": {"w": (1000,), "z": (7, 3)}}
    dts = {"a": jnp.float32, "b": {"w": jnp.float32, "z": jnp.bfloat16}}
    mk = lambda: jax.tree.map(
        lambda shp, dt: jnp.asarray(rng.standard_normal(shp), dt), shapes,
        dts, is_leaf=lambda x: isinstance(x, tuple))
    jw, jwb = mk(), mk()
    to_t = lambda t: jax.tree.map(
        lambda x: torch.tensor(np.asarray(x.astype(jnp.float32))).to(
            torch.bfloat16 if x.dtype == jnp.bfloat16 else torch.float32), t)
    got = ops.decdiff_update_tree(to_t(jw), to_t(jwb))
    want = jtree(jw, jwb)
    for g, j in zip(tree_leaves(got), jax.tree.leaves(want)):
        assert str(g.dtype).replace("torch.", "") == str(j.dtype)
        np.testing.assert_allclose(
            g.float().numpy(), np.asarray(j.astype(jnp.float32)),
            **_close_in(j.dtype))


def _old_eq5(local, avg, row, s):
    """The port's Eq. 5 as `dist/dfl_step.py` computed it before the
    kernel existed, kept here as the plain version's oracle."""
    diff = [a - x.to(torch.float32) for x, a in zip(local, avg)]
    sq = sum(torch.sum(torch.square(d), dim=tuple(range(1, d.dim())))
             for d in diff)
    scale = torch.where(row > 0, 1.0 / (torch.sqrt(sq) + s), 0.0)
    return [(x.to(torch.float32) + scale.reshape(
        scale.shape + (1,) * (d.dim() - 1)) * d).to(x.dtype)
        for x, d in zip(local, diff)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", [1.0, 0.25])
def test_decdiff_rows_is_the_old_eq5_bitwise(dtype, s):
    """Row-batched over several leaves, with a receiver whose gate is 0:
    the plain version is the old formula bit for bit, and the gated row
    keeps its model exactly."""
    rng = np.random.default_rng(5)
    tdt = getattr(torch, dtype)
    shapes = [(4, 33, 7), (4, 1000), (4, 5)]
    local = [torch.from_numpy(rng.standard_normal(shp).astype(np.float32))
             .to(tdt) for shp in shapes]
    avg = [torch.from_numpy(rng.standard_normal(shp).astype(np.float32))
           for shp in shapes]
    row = torch.tensor([1.0, 0.5, 0.0, 2.0])
    got = ops.decdiff_rows(local, avg, row, s)
    for g, want, x in zip(got, _old_eq5(local, avg, row, s), local):
        assert g.dtype == tdt and torch.equal(g, want)
        assert torch.equal(g[2], x[2])
        assert not torch.equal(g[0], x[0])


def test_decdiff_rows_plain_pieces_compose():
    from repro_torch.kernels import decdiff_update as dd

    rng = np.random.default_rng(6)
    x = [torch.from_numpy(rng.standard_normal((3, 40)).astype(np.float32))]
    a = [torch.from_numpy(rng.standard_normal((3, 40)).astype(np.float32))]
    sq = dd.sumsq_rows_plain(x, a)
    torch.testing.assert_close(sq, ((a[0] - x[0]) ** 2).sum(1))
    scale = dd.scale_from_sumsq(sq, None, 1.0)
    assert torch.equal(ops.decdiff_rows(x, a, None, 1.0)[0],
                       dd.step_rows_plain(x[0], a[0], scale))


@pytest.mark.parametrize("bad", ["x-dtype", "a-dtype", "shape", "rows",
                                 "count", "gate", "contig", "device"])
def test_decdiff_rows_wrapper_rejects_bad_inputs(bad):
    x = [torch.zeros(3, 8), torch.zeros(3, 2)]
    a = [torch.ones(3, 8), torch.ones(3, 2)]
    gate = torch.ones(3)
    if bad == "x-dtype":
        x[0] = x[0].half()
    elif bad == "a-dtype":
        a[1] = a[1].to(torch.bfloat16)
    elif bad == "shape":
        a[0] = a[0][:, :7].contiguous()
    elif bad == "rows":
        x[1], a[1] = torch.zeros(2, 2), torch.zeros(2, 2)
    elif bad == "count":
        a = a[:1]
    elif bad == "gate":
        gate = torch.ones(4)
    elif bad == "contig":
        x[0] = torch.zeros(8, 3).t()
    else:
        gate = gate.to("meta")
    with pytest.raises((TypeError, ValueError)):
        ops.decdiff_rows(x, a, gate, 1.0)


# ------------------------------------------ the trigger's drift norms

@pytest.mark.parametrize("r,d", [(1, 1), (6, 4099), (12, 567)])
def test_drift_norms_match_jax_and_any_row_block(r, d):
    """`ops.drift_norms` against the reference's `drift_gate` drift, and
    each block of rows bitwise the full call's rows."""
    from repro.comm import trigger as jtrig

    rng = np.random.default_rng([r, d])
    x = rng.standard_normal((r, d)).astype(np.float32)
    ref = rng.standard_normal((r, d)).astype(np.float32)
    got = ops.drift_norms(torch.from_numpy(x), torch.from_numpy(ref))
    _, want = jtrig.drift_gate(jnp.asarray(x), jnp.asarray(ref), 0.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=0)
    for lo, hi in [(0, 1), (r // 2, r), (1, max(r - 1, 1))]:
        part = ops.drift_norms(torch.from_numpy(x[lo:hi]),
                               torch.from_numpy(ref[lo:hi]))
        assert torch.equal(part, got[lo:hi])


@pytest.mark.parametrize("bad", ["dtype", "shape", "dims", "contig",
                                 "device"])
def test_drift_norms_wrapper_rejects_bad_inputs(bad):
    x, ref = torch.zeros(3, 8), torch.ones(3, 8)
    if bad == "dtype":
        x = x.to(torch.bfloat16)
    elif bad == "shape":
        ref = torch.ones(3, 7)
    elif bad == "dims":
        x, ref = x.reshape(-1), ref.reshape(-1)
    elif bad == "contig":
        x = torch.zeros(8, 3).t()
    else:
        ref = ref.to("meta")
    with pytest.raises((TypeError, ValueError)):
        ops.drift_norms(x, ref)


def test_serving_and_eq5_wrappers_count_no_launch_on_the_cpu():
    ops.reset_launches()
    _, tin = _decode_inputs(2, 16, 2, 2, 16, jnp.float32)
    ops.decode_attention_fused(*tin)
    ops.decdiff_rows([torch.zeros(2, 3)], [torch.ones(2, 3)], None, 1.0)
    ops.decdiff_update(torch.zeros(5), torch.ones(5))
    ops.drift_norms(torch.zeros(2, 3), torch.ones(2, 3))
    assert not any(ops.LAUNCHES.values())


@pytest.mark.parametrize("fn,n_ptr,n_int,n_i64,n_float", [
    ("decode_attention_f32", 8, 2, 8, 1),
    ("decdiff_sumsq_rows", 3, 1, 6, 0),
    ("decdiff_scale_rows", 4, 0, 2, 1),
    ("decdiff_step_rows", 4, 1, 2, 0),
])
def test_serving_and_eq5_ctypes_bindings_declare_their_arguments(
        monkeypatch, fn, n_ptr, n_int, n_i64, n_float):
    """Every pointer, flag, 64-bit size and float is declared (ctypes would
    pass 32-bit ints and cut the pointers otherwise)."""
    import ctypes
    import types

    from repro_torch.kernels import _build
    from repro_torch.kernels import decdiff_update as dd
    from repro_torch.kernels import decode_attention as da

    fns = {name: types.SimpleNamespace(argtypes=None, restype=None)
           for name in ("decode_attention_f32", "decode_attention_plan",
                        "decdiff_col_blocks", "decdiff_sumsq_rows",
                        "decdiff_scale_rows", "decdiff_step_rows")}
    loads = []

    def fake_load(name):
        loads.append(name)
        return types.SimpleNamespace(**fns)

    monkeypatch.setattr(_build, "load", fake_load)
    monkeypatch.setattr(da, "_LIB", None)
    lib = (da if fn.startswith("decode") else dd)._library()
    args = getattr(lib, fn).argtypes
    assert args.count(ctypes.c_void_p) == n_ptr + 1  # + the stream
    assert args.count(ctypes.c_int) == n_int
    assert args.count(ctypes.c_int64) == n_i64
    assert args.count(ctypes.c_float) == n_float
    assert args[-1] is ctypes.c_void_p
    assert getattr(lib, fn).restype is ctypes.c_int
    if fn.startswith("decdiff"):
        assert lib.decdiff_col_blocks.argtypes == [ctypes.c_int64]
        assert lib.decdiff_col_blocks.restype is ctypes.c_int64
    else:  # bound once, at load: the plan query too
        assert lib.decode_attention_plan.argtypes == [
            ctypes.c_int, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p]
        assert lib.decode_attention_plan.restype is ctypes.c_int
        lib.decode_attention_f32.argtypes = None
        assert da._library() is lib and loads == ["decode_attention"]
        assert lib.decode_attention_f32.argtypes is None
