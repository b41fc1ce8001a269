"""The paper's Eq. 5 over row blocks: the CUDA kernels' launchers and their
plain PyTorch version.

For a list of leaves x_i [R, ...] (fp32 or bf16, row r = one node's
model), their fp32 neighbourhood averages a_i, an optional gate [R] and
the damping s:

    sq[r]    = Σ_i Σ (a_i[r] − x_i[r])²
    scale[r] = gate[r] > 0 ? 1 / (√sq[r] + s) : 0        (no gate: always)
    out_i[r] = x_i[r] + scale[r] · (a_i[r] − x_i[r])     in x_i's dtype

The kernels are `csrc/decdiff_update.cu` (they replace the Pallas TPU
kernels `repro.kernels.decdiff_update.sumsq_diff_blocks` and
`scaled_step_blocks`): pass A writes per-(row, column block) partials of
sq, a small kernel adds them in a fixed order into the scale, pass B
writes the step.  For the same scale, pass B is bitwise `step_rows_plain`;
the norms agree with `sumsq_rows_plain` to a tolerance (another summation
order).  The plain version is what the port's Eq. 5 sites computed before
the kernel existed, operation for operation, so the CPU path is unchanged.
Use `repro_torch.kernels.ops.decdiff_rows` (or the reference wrappers'
single-model forms `ops.decdiff_update` / `decdiff_update_tree`), which
validate the inputs and pick between the two by the tensors' device.

The split form (`decdiff_rows_split_*`, through `ops.decdiff_rows_split`)
is Eq. 5 over the local shards of R models partitioned over a group of
ranks: each rank sums (a − x)² over the column spans it counts
(`sumsq_spans_plain`; on the card pass A over each span, rows `ld` apart,
then the scale kernel into [R] partial sums), the caller's all-reduce
adds the ranks' sums, the scale follows from the total (on the card the
scale kernel on the reduced [R, 1] sums) and pass B runs on every local
shard.  With one rank counting every column it is bitwise the unsplit
form, on the CPU and on the card.

Pass A and the scale kernel also give the event trigger's drift
‖x[r] − ref[r]‖ (`drift_norms_cuda`, through `ops.drift_norms`): each row
is summed by the same blocks in the same order whatever the number of
rows, so a block of R rows gets the norms the full N rows get.
"""
from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import torch

from repro_torch.kernels import _build


def sumsq_rows_plain(xs: Sequence[torch.Tensor],
                     avgs: Sequence[torch.Tensor]) -> torch.Tensor:
    """Σ over leaves of each row's Σ(a − x)²: [R] fp32."""
    return sum(torch.sum(torch.square(a - x.to(torch.float32)),
                         dim=tuple(range(1, a.dim())))
               for x, a in zip(xs, avgs))


def scale_from_sumsq(sq: torch.Tensor, gate: Optional[torch.Tensor],
                     s: float) -> torch.Tensor:
    scale = 1.0 / (torch.sqrt(sq) + s)
    if gate is None:
        return scale
    return torch.where(gate > 0, scale, 0.0)


def step_rows_plain(x: torch.Tensor, a: torch.Tensor,
                    scale: torch.Tensor) -> torch.Tensor:
    """x + scale[r] · (a − x) per row, in x's dtype."""
    x32 = x.to(torch.float32)
    sc = scale.reshape(scale.shape + (1,) * (x.dim() - 1))
    return (x32 + sc * (a - x32)).to(x.dtype)


def decdiff_rows_plain(xs, avgs, gate, s) -> List[torch.Tensor]:
    scale = scale_from_sumsq(sumsq_rows_plain(xs, avgs), gate, s)
    return [step_rows_plain(x, a, scale) for x, a in zip(xs, avgs)]


def _span_cols(x: torch.Tensor, c0: int, c1: int) -> torch.Tensor:
    return x.reshape(x.shape[0], -1)[:, c0:c1]


def sumsq_spans_plain(xs, avgs, spans) -> torch.Tensor:
    """Σ over `spans` (leaf index, first column, end column of the leaf's
    row viewed flat) of each row's Σ(a − x)²: [R] fp32.  A span over a
    whole leaf sums it as `sumsq_rows_plain` does, so spans over every
    leaf are bitwise `sumsq_rows_plain`."""
    def one(i, c0, c1):
        x, a = xs[i], avgs[i]
        if c0 == 0 and c1 == a[0].numel():
            return sumsq_rows_plain([x], [a])
        return torch.sum(torch.square(_span_cols(a, c0, c1)
                                      - _span_cols(x, c0, c1).float()),
                         dim=1)

    r = xs[0].shape[0]
    return sum((one(*sp) for sp in spans),
               torch.zeros((r,), dtype=torch.float32, device=xs[0].device)
               if not spans else 0)


def decdiff_rows_split_plain(xs, avgs, gate, s, spans, all_reduce,
                             out=None) -> List[torch.Tensor]:
    sq = all_reduce(sumsq_spans_plain(xs, avgs, spans))
    scale = scale_from_sumsq(sq, gate, s)
    steps = [step_rows_plain(x, a, scale) for x, a in zip(xs, avgs)]
    if out is None:
        return steps
    for o, y in zip(out, steps):
        o.copy_(y)
    return list(out)


def drift_norms_plain(x: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """‖x[r] − ref[r]‖₂ per row of [R, D] fp32: [R] fp32."""
    diff = x - ref
    return torch.sqrt(torch.sum(diff * diff, dim=1))


def _library() -> ctypes.CDLL:
    lib = _build.load("decdiff_update")
    ptr, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.decdiff_col_blocks.argtypes = [i64]
    lib.decdiff_col_blocks.restype = i64
    # x, x_bf16, a, partials, R, D, ldx, lda, nb_total, blk_off, stream
    lib.decdiff_sumsq_rows.argtypes = [ptr, ctypes.c_int, ptr, ptr, i64, i64,
                                       i64, i64, i64, i64, ptr]
    # partials, R, nb, gate, s, scale, sumsq, stream
    lib.decdiff_scale_rows.argtypes = [ptr, i64, i64, ptr, ctypes.c_float,
                                       ptr, ptr, ptr]
    # x, x_bf16, a, scale, out, R, D, stream
    lib.decdiff_step_rows.argtypes = [ptr, ctypes.c_int, ptr, ptr, ptr, i64,
                                      i64, ptr]
    for fn in (lib.decdiff_sumsq_rows, lib.decdiff_scale_rows,
               lib.decdiff_step_rows):
        fn.restype = ctypes.c_int
    return lib


def _check(err: int, what: str, shape) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: cudaError {err} "
                           f"(leaf {tuple(shape)})")


def _partials_cuda(lib, xs, avgs, spans) -> torch.Tensor:
    """Pass A over each span (leaf index, first column, end column of the
    leaf's row viewed flat), on the current stream: the [R, nb] partials
    of Σ(a − x)², the spans' column blocks side by side."""
    dev = xs[0].device
    r = xs[0].shape[0]
    blocks = [lib.decdiff_col_blocks(c1 - c0) for _, c0, c1 in spans]
    partials = torch.empty((r, max(sum(blocks), 1)), dtype=torch.float32,
                           device=dev)
    if sum(blocks) == 0:
        partials.zero_()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        off = 0
        for (i, c0, c1), n in zip(spans, blocks):
            x, a = xs[i], avgs[i]
            ld = a.numel() // r if r else 0
            _check(lib.decdiff_sumsq_rows(
                x.data_ptr() + c0 * x.element_size(),
                int(x.dtype == torch.bfloat16), a.data_ptr() + 4 * c0,
                partials.data_ptr(), r, c1 - c0, ld, ld, partials.shape[1],
                off, stream), "decdiff_sumsq_rows", x.shape)
            off += n
    return partials


def _scale_cuda(lib, partials, gate, s):
    """The scale kernel on the [R, nb] partials: (scale [R], sq [R])."""
    r, nb = partials.shape
    scale = torch.empty((r,), dtype=torch.float32, device=partials.device)
    sq = torch.empty_like(scale)
    with torch.cuda.device(partials.device):
        stream = torch.cuda.current_stream(partials.device).cuda_stream
        _check(lib.decdiff_scale_rows(
            partials.data_ptr(), r, nb,
            None if gate is None else gate.data_ptr(), float(s),
            scale.data_ptr(), sq.data_ptr(), stream),
            "decdiff_scale_rows", (r, nb))
    return scale, sq


def norms_cuda(xs, avgs, gate: Optional[torch.Tensor],
               s: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pass A over every leaf, then the scale kernel: (scale [R], sq [R])
    fp32, on the current stream.  The caller validated the inputs."""
    lib = _library()
    r = xs[0].shape[0]
    spans = [(i, 0, x.numel() // r if r else 0) for i, x in enumerate(xs)]
    return _scale_cuda(lib, _partials_cuda(lib, xs, avgs, spans), gate, s)


def step_cuda(x: torch.Tensor, a: torch.Tensor, scale: torch.Tensor,
              out: torch.Tensor = None) -> torch.Tensor:
    """Pass B for one leaf, on the current stream: [R, ...] in x's dtype,
    into `out` when given (x itself may be it: each element is read
    before it is written, by the same thread)."""
    lib = _library()
    out = torch.empty_like(x) if out is None else out
    r = x.shape[0]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        _check(lib.decdiff_step_rows(
            x.data_ptr(), int(x.dtype == torch.bfloat16), a.data_ptr(),
            scale.data_ptr(), out.data_ptr(), r, x.numel() // r if r else 0,
            stream), "decdiff_step_rows", x.shape)
    return out


def decdiff_rows_cuda(xs, avgs, gate, s) -> List[torch.Tensor]:
    scale, _ = norms_cuda(xs, avgs, gate, s)
    return [step_cuda(x, a, scale) for x, a in zip(xs, avgs)]


def decdiff_rows_split_cuda(xs, avgs, gate, s, spans, all_reduce,
                            out=None) -> List[torch.Tensor]:
    """The split form on the card (module docstring): pass A over each
    span, the scale kernel into the rank's [R] sums, `all_reduce` of
    them, the scale kernel on the [R, 1] totals, pass B on every leaf.
    The caller validated the inputs."""
    lib = _library()
    _, sq = _scale_cuda(lib, _partials_cuda(lib, xs, avgs, spans), None,
                        0.0)
    scale, _ = _scale_cuda(lib, all_reduce(sq)[:, None].contiguous(), gate,
                           s)
    return [step_cuda(x, a, scale, o) for x, a, o in
            zip(xs, avgs, out if out is not None else [None] * len(xs))]


#: rows per pass-A launch (its grid's y dimension)
MAX_GRID_ROWS = 65535


def drift_norms_cuda(x: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """‖x[r] − ref[r]‖₂ per row: pass A and the scale kernel on [R, D]
    fp32, MAX_GRID_ROWS rows a launch, then the square root: [R] fp32.
    The caller validated the inputs."""
    sq = torch.cat([norms_cuda([x[r0:r0 + MAX_GRID_ROWS]],
                               [ref[r0:r0 + MAX_GRID_ROWS]], None, 0.0)[1]
                    for r0 in range(0, x.shape[0], MAX_GRID_ROWS)])
    return torch.sqrt(sq)
