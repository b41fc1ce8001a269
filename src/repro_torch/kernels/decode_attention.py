"""One-token GQA attention over a ring KV cache: the CUDA kernel's launcher
and its plain PyTorch version.

    s[b, kh, g, w] = q[b, kh·G + g] · k[b, w, kh] / √hd     (fp32)
    s = -1e30 where slot w is masked;  out = softmax_w(s) · v   (fp32)

A slot takes part iff 0 ≤ slot_pos[w] ≤ pos, and, when `window` > 0,
slot_pos[w] > pos − window (the reference layer's sliding-window clause).
The kernel is `csrc/decode_attention.cu` (it replaces the Pallas TPU kernel
`repro.kernels.decode_attention.decode_attention_blocks`): split-W flash
decoding over K/V tiles that TMA stages in shared memory, scores from
tensor cores (bf16 k) or CUDA cores (fp32 k), an online softmax per tile,
merged over the splits by a second kernel.  The splits come from
`plan_splits`, a pure function of the card's SMs and the instance's
resident blocks per SM.  It sums in another order than the plain version,
so the two agree to a tolerance, not bitwise.  Use `repro_torch.kernels.
ops.decode_attention_fused`, which validates the inputs and picks between
the two by the tensors' device.

The split-hd form, for a cache split over a mesh's "model" axis along hd
(`csrc/decode_attention_split.cu`): `scores_partial_*` give the scaled
partial scores [B, H, W] fp32 over the local hd columns, which the caller
sums over the shards (an all-reduce), and `softmax_combine_*` mask them,
take the softmax and combine the local hd columns of v.  Both kernels
stream ranges of slots of one batch row, all heads at once, through a
shared-memory ring (the scores on tensor cores for bf16 q and k at 5 to 8
query heads a kv head); the combine is flash decoding, an online softmax
over splits of W and a merge kernel over the splits.  Their slots a
stage, a block and a split, and the rings' stages, come from
`split_plan`, a pure function of the card's SMs, W, K, G, hdl and the
dtype, never of B, so a row's output is bitwise the same at any batch
size.
"""
from __future__ import annotations

import ctypes
import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import _build

#: the head dims the kernel is built for, and the widest query group
HEAD_DIMS = (16, 32, 64, 80, 128)
MAX_GROUP = 8
#: the least share of its last wave that a plan fills, where one can
MIN_WAVE_FILL = 0.9

#: (device, kv bf16, hd, group width, K) -> (slots per tile, resident
#: blocks per SM, SMs, KV heads per block), from the library; and the
#: splits per shape on top of it
_PLANS: Dict[tuple, Tuple[int, int, int, int]] = {}
_SPLITS: Dict[tuple, Tuple[int, int, int]] = {}
_LIB: Optional[ctypes.CDLL] = None
_SPLIT_LIB: Optional[ctypes.CDLL] = None

#: the split-hd kernels: threads a block, the shared memory a block may
#: have (H100), and the bytes a ring stage aims at
SPLIT_THREADS = 256
SMEM_LIMIT = 227 * 1024
STAGE_BYTES = 48 * 1024
#: a ring takes as many stages (2 to 4) as fit these bytes: two or three
#: stages in flight a block while it works on one
RING_BYTES = 96 * 1024
#: the combine's splits are sized for this many batch rows at two blocks
#: an SM (path e's decode batch): fewer, longer blocks spread each
#: block's fixed costs (the first stage's wait, its partials)
DESIGN_ROWS = 8
#: (device, W, K, G, hdl, kv bytes) -> the split kernels' plan
_SPLIT_PLANS: Dict[tuple, "SplitPlan"] = {}


def decode_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           slot_pos: torch.Tensor, pos: torch.Tensor,
                           window: int = 0) -> torch.Tensor:
    """q [B, H, hd], k / v [B, W, K, hd], slot_pos [W], pos 0-d -> [B, H, hd]
    fp32 (mirrors the reference's `kernels/ref.py:decode_attention_ref`)."""
    b, h, hd = q.shape
    kk = k.shape[2]
    qg = q.to(torch.float32).reshape(b, kk, h // kk, hd)
    s = torch.einsum("bkgd,bwkd->bkgw", qg, k.to(torch.float32)) \
        * (1.0 / math.sqrt(hd))
    ok = (slot_pos >= 0) & (slot_pos <= pos)
    if window > 0:
        ok = ok & (slot_pos > pos - window)
    s = torch.where(ok[None, None, None, :], s, -1e30)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgw,bwkd->bkgd", p, v.to(torch.float32))
    return out.reshape(b, h, hd)


def _library() -> ctypes.CDLL:
    """The kernel's library, its functions' argtypes set once, at load."""
    global _LIB
    if _LIB is None:
        lib = _build.load("decode_attention")
        # q, q_bf16, k, v, kv_bf16, slot_pos, pos, window, B, W, K, G, HD,
        # S, sps, scale, part_acc, part_ml, out, stream
        lib.decode_attention_f32.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p] + [
                ctypes.c_int64] * 8 + [ctypes.c_float] + [
                    ctypes.c_void_p] * 4
        lib.decode_attention_f32.restype = ctypes.c_int
        # kv_bf16, HD, G, K, out[4]
        lib.decode_attention_plan.argtypes = [
            ctypes.c_int, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p]
        lib.decode_attention_plan.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def group_width(g: int) -> int:
    """The kernel instance's query group: G rounded up to 1, 2, 4 or 8."""
    return 1 if g <= 1 else 2 if g <= 2 else 4 if g <= 4 else 8


def plan_splits(b: int, kk: int, w: int, tile: int, sms: int,
                per_sm: int) -> Tuple[int, int]:
    """(S, slots per split) for B·K·S blocks over W slots in tiles of
    `tile`: every split a whole number of tiles and none empty (S·sps ≥ W >
    (S − 1)·sps), and the fewest splits whose blocks fill their last wave
    (of `sms`·`per_sm` resident blocks) to at least `MIN_WAVE_FILL`; where
    no split count reaches that, the count that fills it best (the fewest
    among equals)."""
    resident = sms * per_sm
    ntiles = -(-w // tile)
    best, best_fill = None, -1.0
    seen = set()
    for want in range(1, ntiles + 1):
        tps = -(-ntiles // want)  # tiles per split
        s = -(-ntiles // tps)
        if s in seen:
            continue
        seen.add(s)
        blocks = b * kk * s
        fill = blocks / (-(-blocks // resident) * resident)
        if fill >= MIN_WAVE_FILL:
            return s, tps * tile
        if fill > best_fill:
            best, best_fill = (s, tps * tile), fill
    return best


def splits(device: torch.device, b: int, kk: int, w: int, hd: int, g: int,
           kv_bf16: bool) -> Tuple[int, int, int]:
    """(S, slots per split, slots per tile) of a launch, from the
    library's plan for this instance on `device` (asked once) and
    `plan_splits` over its B·(K / heads per block) block rows (once per
    shape)."""
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    key = (idx, bool(kv_bf16), hd, group_width(g), kk, b, w)
    got = _SPLITS.get(key)
    if got is None:
        pkey = key[:5]
        plan = _PLANS.get(pkey)
        if plan is None:
            out = (ctypes.c_int64 * 4)()
            with torch.cuda.device(idx):
                err = _library().decode_attention_plan(
                    int(kv_bf16), hd, group_width(g), kk,
                    ctypes.addressof(out))
            if err != 0:
                raise RuntimeError(f"decode_attention_plan failed: cudaError "
                                   f"{err} (hd={hd}, G={g}, K={kk}, kv_bf16="
                                   f"{kv_bf16})")
            plan = _PLANS[pkey] = tuple(int(x) for x in out)
        tile, per_sm, sms, kpb = plan
        got = _SPLITS[key] = (*plan_splits(b, kk // kpb, w, tile, sms,
                                           per_sm), tile)
    return got


def decode_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          slot_pos: torch.Tensor, pos: torch.Tensor,
                          window: int = 0) -> torch.Tensor:
    """Launch the split kernel and the merge on the current stream.  The
    caller validated the inputs: contiguous CUDA tensors on one device, q
    and k / v bf16 or fp32 with k and v alike, slot_pos [W] and pos 0-d
    int32, hd in `HEAD_DIMS`, H / K ≤ `MAX_GROUP`, k and v 16-byte
    aligned.  The scratch and the output share one allocation; the output
    is a view of its tail."""
    b, h, hd = q.shape
    w, kk = k.shape[1], k.shape[2]
    kv_bf16 = k.dtype == torch.bfloat16
    s, sps, _ = splits(q.device, b, kk, w, hd, h // kk, kv_bf16)
    n_acc, n_ml = b * h * s * hd, b * h * s * 2
    buf = torch.empty((n_acc + n_ml + b * h * hd,), dtype=torch.float32,
                      device=q.device)
    base = buf.data_ptr()
    err = _build.launch(
        q.device, _library().decode_attention_f32, q.data_ptr(),
        int(q.dtype == torch.bfloat16), k.data_ptr(), v.data_ptr(),
        int(kv_bf16), slot_pos.data_ptr(), pos.data_ptr(), int(window), b, w,
        kk, h // kk, hd, s, sps, 1.0 / math.sqrt(hd), base, base + 4 * n_acc,
        base + 4 * (n_acc + n_ml))
    if err != 0:
        raise RuntimeError(f"decode_attention_f32 launch failed: cudaError "
                           f"{err} (B={b}, H={h}, W={w}, K={kk}, hd={hd}, "
                           f"splits={s}x{sps})")
    return buf[n_acc + n_ml:].view(b, h, hd)


def scores_partial_plain(q: torch.Tensor, k: torch.Tensor,
                         scale: float) -> torch.Tensor:
    """q [B, H, hdl], k [B, W, K, hdl] (a shard's hd columns) -> scale ·
    q·k over those columns, [B, H, W] fp32."""
    b, h, hd = q.shape
    kk = k.shape[2]
    qg = q.to(torch.float32).reshape(b, kk, h // kk, hd)
    s = torch.einsum("bkgd,bwkd->bkgw", qg, k.to(torch.float32)) * scale
    return s.reshape(b, h, k.shape[1])


def softmax_combine_plain(scores: torch.Tensor, v: torch.Tensor,
                          slot_pos: torch.Tensor, pos: torch.Tensor,
                          window: int = 0) -> torch.Tensor:
    """scores [B, H, W] (summed over the shards), v [B, W, K, hdl] ->
    softmax over the live slots · v, [B, H, hdl] fp32 (the masking of
    `decode_attention_plain`)."""
    b, h, w = scores.shape
    kk = v.shape[2]
    ok = (slot_pos >= 0) & (slot_pos <= pos)
    if window > 0:
        ok = ok & (slot_pos > pos - window)
    s = torch.where(ok[None, None, :], scores, -1e30)
    p = torch.softmax(s, dim=-1).reshape(b, kk, h // kk, w)
    out = torch.einsum("bkgw,bwkd->bkgd", p, v.to(torch.float32))
    return out.reshape(b, h, v.shape[-1])


class SplitPlan(NamedTuple):
    """The split-hd kernels' launch plan (`split_plan`)."""
    tile: int           # scores: slots a ring stage
    per_block: int      # scores: slots a block, whole tiles
    blocks: int         # scores: blocks over W
    scores_stages: int  # scores: the ring's stages
    chunk: int          # combine: slots a ring stage
    per_split: int      # combine: slots a split, whole chunks
    splits: int         # combine: splits over W
    combine_stages: int
    scores_smem: int    # shared memory bytes a block (the scores' with
    combine_smem: int   # fp32 q: at most)


def _round16(n: int) -> int:
    return -(-n // 16) * 16


def _stage_slots(slot_bytes: int) -> int:
    """Slots a ring stage: the power of two nearest below `STAGE_BYTES` /
    `slot_bytes`, kept within [8, 128]."""
    n = max(1, STAGE_BYTES // slot_bytes)
    return min(128, max(8, 1 << (n.bit_length() - 1)))


def combine_head_threads(h: int) -> int:
    """The combine's threads a head in its mask / max / exp pass:
    `SPLIT_THREADS` over H rounded up to a power of two, at most 32
    (H ≤ `SPLIT_THREADS`)."""
    return min(32, SPLIT_THREADS // (1 << (h - 1).bit_length()))


def _stages(stage: int) -> int:
    """A ring's stages: as many as `RING_BYTES` holds, 2 to 4."""
    return min(4, max(2, RING_BYTES // stage))


def combine_by_head(g: int, hdl: int) -> bool:
    """Whether the combine runs a thread a head (its online softmax and
    the hdl sums of p·v in registers): with one query head a kv head and
    4 or 8 head dims a shard (at more query heads its threads would widen
    the same v G times; the other combine holds up to 8 heads a thread)."""
    return g == 1 and hdl in (4, 8)


def combine_columns(kk: int, g: int, hdl: int) -> Tuple[int, int, int]:
    """(head dims, query heads, columns a slot) of the combine's threads: a
    thread carries a run of `dv` head dims of one kv head for `gw` query
    heads (`group_width`; larger G in groups of 8); `dv` is the widest of
    8, 4 and 1 dividing hdl that keeps a thread's sums (gw·dv) at 32 and
    leaves a slot's v row 8 columns or more (K·⌈G / gw⌉·hdl / dv; 32 slot
    lanes at most); at most `SPLIT_THREADS` columns."""
    gw = group_width(g)
    run = kk * -(-g // gw) * hdl
    dv = 8 if hdl % 8 == 0 and gw * 8 <= 32 and run // 8 >= 8 else \
        4 if hdl % 4 == 0 and run // 4 >= 8 else 1
    return dv, gw, run // dv


def split_plan(w: int, kk: int, g: int, hdl: int, kv_bytes: int,
               sms: int) -> SplitPlan:
    """The split-hd kernels' plan for W slots, K kv heads of G query heads,
    hdl head dims a shard in `kv_bytes`-byte elements, on a card of `sms`
    SMs.  It takes no batch size: a row's output is then bitwise the same
    at any B.  The scores kernel gives a block about W / `sms` slots
    (whole stages), so one batch row fills the card's SMs; the combine
    cuts W into about 2·`sms` / `DESIGN_ROWS` splits (whole stages), long
    enough that their partials (m, l, acc[hdl] a head) stay under 1/16 of
    the bytes a split reads.  Blocks and splits cover W with none empty
    (n·per ≥ W > (n − 1)·per).  The shared memory mirrors
    `csrc/decode_attention_split.cu`'s."""
    h = kk * g
    rowb = kk * hdl * kv_bytes
    fill = -(-w // sms)
    rs = _round16(rowb) + 16
    tile = _stage_slots(rs)
    per_block = tile * -(-fill // tile)
    tq = combine_head_threads(h)
    chunk = _stage_slots(4 * h + rowb + 4)
    least = -(-16 * 4 * h * (hdl + 2) // (4 * h + rowb))
    nsplit = -(-2 * sms // DESIGN_ROWS)
    per_split = chunk * -(-max(-(-w // nsplit), least) // chunk)
    splits = -(-w // per_split)
    if combine_by_head(g, hdl):
        r = 1 if h >= 32 or 32 % h else max(4, 32 // h)
        rsc = chunk + (r - chunk) % 32  # the scores' rows, floats
        extra, held = 0, (SPLIT_THREADS // h) * h * (hdl + 2)
    else:
        dv, gw, cols = combine_columns(kk, g, hdl)
        hp = h + (32 // tq - h) % 32   # p's rows, floats
        rsc = chunk + (tq - chunk) % 32
        extra = 4 * chunk * hp + 4 * h
        held = SPLIT_THREADS // max(cols, 1) * gw * dv * (cols + 1)
    stage = _round16(4 * h * rsc) + _round16(4 * chunk) \
        + _round16(chunk * rowb)
    s_stages = min(_stages(tile * rs), max(2, per_block // tile))
    c_stages = min(_stages(stage), max(2, per_split // chunk))
    return SplitPlan(
        tile=tile, per_block=per_block, blocks=-(-w // per_block),
        scores_stages=s_stages, chunk=chunk, per_split=per_split,
        splits=splits, combine_stages=c_stages,
        scores_smem=_round16(4 * h * hdl) + s_stages * tile * rs,
        combine_smem=_round16(max(c_stages * stage, 4 * held)) + extra)


def _split_plan_on(device: torch.device, w: int, kk: int, g: int, hdl: int,
                   kv_bytes: int) -> SplitPlan:
    """`split_plan` with `device`'s SM count, once per shape."""
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    key = (idx, w, kk, g, hdl, kv_bytes)
    plan = _SPLIT_PLANS.get(key)
    if plan is None:
        sms = torch.cuda.get_device_properties(idx).multi_processor_count
        plan = _SPLIT_PLANS[key] = split_plan(w, kk, g, hdl, kv_bytes, sms)
    return plan


def _split_library() -> ctypes.CDLL:
    global _SPLIT_LIB
    if _SPLIT_LIB is None:
        lib = _build.load("decode_attention_split")
        # q, q_bf16, k, kv_bf16, s, B, W, K, G, hdl, scale, tile,
        # per_block, stages, stream
        lib.decode_scores_partial.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_void_p] + [ctypes.c_int64] * 5 + [ctypes.c_float] + [
                ctypes.c_int64] * 3 + [ctypes.c_void_p]
        lib.decode_scores_partial.restype = ctypes.c_int
        # s, v, kv_bf16, slot_pos, pos, window, part, out, B, W, K, G, hdl,
        # chunk, per_split, splits, stages, stream
        lib.decode_softmax_combine.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_void_p] + [ctypes.c_int64] * 9 + [ctypes.c_void_p]
        lib.decode_softmax_combine.restype = ctypes.c_int
        _SPLIT_LIB = lib
    return _SPLIT_LIB


def scores_partial_cuda(q: torch.Tensor, k: torch.Tensor,
                        scale: float) -> torch.Tensor:
    """Launch the partial-score kernel on the current stream (contiguous
    CUDA tensors, validated by the caller)."""
    b, h, hd = q.shape
    w, kk = k.shape[1], k.shape[2]
    plan = _split_plan_on(q.device, w, kk, h // kk, hd, k.element_size())
    s = torch.empty((b, h, w), dtype=torch.float32, device=q.device)
    err = _build.launch(
        q.device, _split_library().decode_scores_partial, q.data_ptr(),
        int(q.dtype == torch.bfloat16), k.data_ptr(),
        int(k.dtype == torch.bfloat16), s.data_ptr(), b, w, kk, h // kk, hd,
        scale, plan.tile, plan.per_block, plan.scores_stages)
    if err != 0:
        raise RuntimeError(f"decode_scores_partial launch failed: cudaError "
                           f"{err} (B={b}, H={h}, W={w}, K={kk}, hdl={hd}, "
                           f"{plan})")
    return s


def softmax_combine_cuda(scores: torch.Tensor, v: torch.Tensor,
                         slot_pos: torch.Tensor, pos: torch.Tensor,
                         window: int = 0) -> torch.Tensor:
    """Launch the mask / softmax / p·v kernel over the plan's splits and
    the merge of their partials on the current stream.  The partials and
    the output share one allocation; the output is a view of its tail."""
    b, h, w = scores.shape
    kk, hd = v.shape[2], v.shape[3]
    plan = _split_plan_on(v.device, w, kk, h // kk, hd, v.element_size())
    n_part = -(-b * plan.splits * h * 2 // 4) * 4 + b * plan.splits * h * hd
    buf = torch.empty((n_part + b * h * hd,), dtype=torch.float32,
                      device=v.device)
    base = buf.data_ptr()
    err = _build.launch(
        v.device, _split_library().decode_softmax_combine,
        scores.data_ptr(), v.data_ptr(), int(v.dtype == torch.bfloat16),
        slot_pos.data_ptr(), pos.data_ptr(), int(window), base,
        base + 4 * n_part, b, w, kk, h // kk, hd, plan.chunk,
        plan.per_split, plan.splits, plan.combine_stages)
    if err != 0:
        raise RuntimeError(f"decode_softmax_combine launch failed: cudaError "
                           f"{err} (B={b}, H={h}, W={w}, K={kk}, hdl={hd}, "
                           f"{plan})")
    return buf[n_part:].view(b, h, hd)
