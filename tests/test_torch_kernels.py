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
pytest.importorskip("jax")

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
    assert ops.LAUNCHES == {"segment_neighbor_avg": 0, "gather_rows": 0}


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
    assert sources == ["gather_rows", "segment_avg"]
    assert sorted(ops.LAUNCHES) == ["gather_rows", "segment_neighbor_avg"]
