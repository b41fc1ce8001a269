// Fused virtual-teacher KL loss (the paper's Eq. 7-8) over the class axis,
// forward and backward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of src/repro/kernels/vt_kl_loss.py:
// `row_max` (:94) and `row_stats` (:108), the forward, and `vt_backward`
// (:127), driven by the JAX package's `kernels/ops.py:vt_kl_loss_fused`.
// With logits z [B, V] (fp32 or bf16), labels c [B] and a = (1-beta)/(V-1):
//
//   forward   KL_b = -H(p_t) - (beta z_c + a (sum_v z_v - z_c) - lse(z_b))
//             written per row with the row's max and sum exp(z - max),
//             which the backward reuses;
//   backward  dz_bv = (exp(z_bv - max_b) / sumexp_b - p_t(v)) * g_b
//             with p_t(c) = beta and a elsewhere, g_b the incoming gradient
//             of KL_b, written in the logits' dtype.
//
// The V-wide teacher distribution never exists in memory, and the forward
// reads each logit once (the TPU kernel's two passes, max then sums, are
// one pass here with a running max).
//
// What bounds it: HBM bytes.  The forward reads B*V logits (qwen1.5-0.5b's
// 512 rows x 151,936 bf16: 155.6 MB, 0.046 ms at 3.35 TB/s), the backward
// reads them again and writes as many.  Each logit costs an expf (and a
// division in the backward), some 10-25 instructions, so in bf16 the issue
// rate is not far below the byte rate; at the paper's 10-26 classes the
// bound is far below a launch, and what counts is each thread's chain of
// dependent steps.
//
// Design.  A plan, picked by the launcher from (V, dtype) and the
// pointers' alignment alone (`kernels/vt_kl_loss.py:vt_plan`), sets the
// vector width (the widest of 16, 8, 4 or 2 bytes that divides a row's
// bytes and the base pointer, so every row starts at the same phase), the
// lanes per row and the rows per block.  It never looks at B, so each
// row is summed in an order that depends on (V, dtype) and nothing else:
// one call on B rows and separate calls on blocks of those rows give the
// same bits.
//
// Forward, two forms:
//   kGroupRows (rows of at most 1 KB): a sub-warp of 2-32 lanes per row,
//     many rows per block, each lane's share loaded at once, reduced with
//     `__shfl_xor_sync(..., width)`: no shared memory, no block barrier;
//     the label's logit is taken from the lane that holds it, so no load
//     waits on the label;
//   kBlockRows: one block per row.  Each thread walks its part of the row
//     kLoadBytes at a time, issuing the next step's loads before folding
//     the current one: it takes the step's max (bf16 pairs compared
//     packed), rescales its running sum once and adds the step's logits
//     and exps in index order.  The label is loaded beside the row's first
//     loads and its logit read once they are folded (trapping on a label
//     outside [0, V)).
// The row's epilogue keeps one IEEE rounding per operation.
// Backward: one flat grid over the B*V/vec vectors, each thread taking
// vectors a grid apart, 16 bytes of them a step (one vector, or up to 8
// narrow ones), at least a thousand blocks while there are vectors for
// them; the row by a multiply-and-shift division; one expf and one
// division per logit, rounded once to the output dtype, so each output
// element depends on (z, max, sumexp, label, g) alone.
// Sums are taken in another order than the plain PyTorch version's, so the
// two agree to fp32 rounding, not bit for bit.  Offsets are 64-bit.
//
// Vocab-parallel forms (logits split over the "model" axis of a mesh, each
// shard holding the columns [off, off + V) of V_total), with kernels and a
// plan of their own (`kernels/vt_kl_loss.py:vt_shard_plan`), after the
// unsplit code.  `vt_kl_partial_fwd` writes each row's partial statistics
// -- max, sum exp(z - max), sum z and z_c when the label falls in the
// shard (0 otherwise; a label outside [0, V_total) traps) -- which the
// caller combines with an all-reduce over the shards (the max first, then
// the rescaled sums: the reference's row_max -> row_stats split with a
// reduction in between); `vt_kl_bwd_shard` is the backward on the local
// columns, from the combined max and sum and the global a, the label
// located by the shard's offset.
//
// What bounds them: HBM bytes, the shard read once (and dz written once
// by the backward).  A shard of an odd width (whisper's 51866 / 2 =
// 25933) starts each row at another 16-byte phase; in bf16 the forward
// must fold ~7 logits a clock on each SM to keep up with the bytes.
// What the design does about each cause that held the unsplit plans back
// at these shapes:
//   narrow loads at odd widths -> both kernels load 16-byte words at any
//     width and phase.  The forward gives each lane the 16-byte chunks of
//     columns [8c, 8c + 8) (bf16; 4 in fp32) by column index, 32 lanes a
//     warp when a row is whole words, else 31, the last lane loading the
//     word after its neighbour's chunk; a row off a 16-byte boundary
//     realigns each chunk in registers from the lane's word and the next
//     lane's (fp32: a shuffle a word it needs, the row loop compiled
//     once a phase; bf16: shuffles, selects, a funnel shift).  So every
//     row is folded in an order that depends on (V, dtype) alone, at
//     every phase.  The
//     words a row only partly covers are loaded element by element, so
//     nothing outside the row is read;
//   per-element row work in the backward -> a CTA takes up to 1280 of one
//     row's 16-byte words: the row's max, sum, 1 / sum (__frcp_rn once), g
//     and label are loaded once, and the division is a multiply and one FMA
//     correction by it (the correctly rounded quotient but for rare
//     last-bit cases, kept so that the bf16 roundings stay the plain
//     version's); expf stays full precision for the same reason.  Only
//     whole words go through the unrolled loop (32-bit column offsets
//     from typed pointers); the row's partial first and last words, at
//     most 2E - 2 columns, are one element a thread of the row's first
//     CTA, which keeps it at 48 registers (five CTAs an SM; bf16 spills
//     8 bytes);
//   instruction-bound bf16 forward -> exp(z - m) is exp2(z log2e - mh) *
//     exp2(mh - m log2e), mh = m log2e rounded: one FFMA and one MUFU
//     (ex2.approx.ftz, relative error ~2^-22, against expf's ~2^-23) a
//     logit, the second factor (an exact FMA residual) once when the max
//     moves, so Sigma exp moves by ~1e-7 relative at any |m|, inside its
//     1e-5; the step's max over packed bf16 pairs (__hmax2) by a tree,
//     bf16 widened by a shift or a mask, each chunk summed apart and the
//     chunks' sums added in order, every sum in fp32 with one rounding an
//     operation;
//   few rows -> up to 8 warps a row (the fewest whose lanes cover it in 2
//     steps), 2 (fp32) or 3 (bf16) chunks a lane a step, the next step's
//     words loaded before the current one is folded, 64 registers a
//     thread (four CTAs an SM, one wave at 512 rows); the label is
//     checked once its row is folded, so no load waits on it; a row's
//     lanes and warps merge by butterflies of the max, then of the
//     rescaled sums, with no atomics and no cluster.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;  // a forward block, any tier
constexpr int kGroupMaxLanes = 32;
constexpr int kBwdThreads = 256;
constexpr int64_t kBwdMinBlocks = 1024;
constexpr int kLoadBytes = 32;    // bytes a thread loads per step
constexpr int kBwdLoadBytes = 16;
constexpr int64_t kMaxRowBlocks = 1 << 20;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

// vectors a thread loads per step, forward and backward (at least 1: a
// vector is at most 16 bytes)
template <typename T, int VEC>
__host__ __device__ constexpr int fwd_unroll() {
  return kLoadBytes / static_cast<int>(sizeof(T) * VEC);
}
template <typename T, int VEC>
__host__ __device__ constexpr int bwd_unroll() {
  return kBwdLoadBytes / static_cast<int>(sizeof(T) * VEC);
}

struct Stats {
  float m;  // running max
  float s;  // sum of exp(z - m)
  float z;  // sum of z
};

// the triple of no logit at all
__device__ __forceinline__ Stats empty_stats() {
  return {-INFINITY, 0.0f, 0.0f};
}

// Commutative bit for bit, so both sides of a butterfly step agree: the
// side with the larger max (on a tie either, as 1 * s is exact) keeps its
// sum, the other's is rescaled by one expf.
__device__ __forceinline__ Stats combine(const Stats& a, const Stats& b) {
  const Stats& hi = a.m >= b.m ? a : b;
  const Stats& lo = a.m >= b.m ? b : a;
  // a side that has seen no logit has m = -inf and s = 0
  const float s = lo.m == -INFINITY ? hi.s : hi.s + lo.s * expf(lo.m - hi.m);
  return {fmaxf(a.m, b.m), s, a.z + b.z};
}

// Butterfly over `width` lanes (a power of two); every lane of a group
// ends with the same triple.
__device__ __forceinline__ Stats shfl_combine(Stats st, unsigned mask,
                                              int width) {
  for (int off = width >> 1; off > 0; off >>= 1) {
    const Stats o{__shfl_xor_sync(mask, st.m, off, width),
                  __shfl_xor_sync(mask, st.s, off, width),
                  __shfl_xor_sync(mask, st.z, off, width)};
    st = combine(st, o);
  }
  return st;
}

// The largest logit of a vector (bf16 pairs compared packed: exact).
template <typename T, int VEC>
__device__ __forceinline__ float pack_max(const Pack<T, VEC>& p) {
  if constexpr (sizeof(T) == 2 && VEC >= 2) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(p.v);
    __nv_bfloat162 m = h[0];
#pragma unroll
    for (int k = 1; k < VEC / 2; ++k) m = __hmax2(m, h[k]);
    return fmaxf(__bfloat162float(m.x), __bfloat162float(m.y));
  } else {
    float m = to_f32(p.v[0]);
#pragma unroll
    for (int j = 1; j < VEC; ++j) m = fmaxf(m, to_f32(p.v[j]));
    return m;
  }
}

// Fold the first n of U loaded vectors into st: their max taken, the
// running sum rescaled once, then their logits and exps added in index
// order.
template <typename T, int VEC, int U>
__device__ __forceinline__ void fold(Stats& st, const Pack<T, VEC> (&p)[U],
                                     int n) {
  float lm = -INFINITY;
#pragma unroll
  for (int u = 0; u < U; ++u)
    if (u < n) lm = fmaxf(lm, pack_max(p[u]));
  const float m = fmaxf(st.m, lm);
  float s = st.m == -INFINITY ? 0.0f : st.s * expf(st.m - m);
#pragma unroll
  for (int u = 0; u < U; ++u) {
    if (u < n) {
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float f = to_f32(p[u].v[j]);
        st.z += f;
        s += expf(f - m);
      }
    }
  }
  st.m = m;
  st.s = s;
}

// The triple of the row's vectors first, first + stride, ... (< end),
// folded U at a step in index order; each full step's loads are issued
// before the step ahead of it is folded.
template <typename T, int VEC>
__device__ __forceinline__ Stats accumulate(const T* __restrict__ zr,
                                            int64_t first, int64_t end,
                                            int stride) {
  constexpr int U = fwd_unroll<T, VEC>();
  using P = Pack<T, VEC>;
  const int64_t step = static_cast<int64_t>(U) * stride;
  const int64_t last = static_cast<int64_t>(U - 1) * stride;
  Stats st = empty_stats();
  int64_t i0 = first;
  if (i0 + last < end) {
    P p[U];
#pragma unroll
    for (int u = 0; u < U; ++u)
      p[u] = *reinterpret_cast<const P*>(zr + (i0 + u * stride) * VEC);
    for (;;) {
      i0 += step;
      const bool more = i0 + last < end;
      P q[U];
      if (more) {
#pragma unroll
        for (int u = 0; u < U; ++u)
          q[u] = *reinterpret_cast<const P*>(zr + (i0 + u * stride) * VEC);
      }
      fold<T, VEC, U>(st, p, U);
      if (!more) break;
#pragma unroll
      for (int u = 0; u < U; ++u) p[u] = q[u];
    }
  }
  if (i0 < end) {  // fewer than U vectors left
    P p[U];
    int n = 0;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (i0 + u * stride < end) {
        p[u] = *reinterpret_cast<const P*>(zr + (i0 + u * stride) * VEC);
        ++n;
      }
    }
    fold<T, VEC, U>(st, p, n);
  }
  return st;
}

// The label's logit: the label is loaded before the row's loads are
// issued, its logit read once they are folded (mostly from a line the
// row just brought in), so neither waits on the other.
template <typename T>
__device__ __forceinline__ float label_logit(const T* __restrict__ zr,
                                             int64_t lab, int64_t V) {
  if (lab < 0 || lab >= V) __trap();
  return to_f32(zr[lab]);
}

// The outputs of a forward launch: the KL and the stats the backward
// reuses, or (PARTIAL) the shard's four partial statistics.
struct FwdOut {
  float* kl;      // KL (full) / sum z (partial)
  float* mx;
  float* sumexp;
  float* zc;      // partial only: z_c or 0
};

template <bool PARTIAL>
__device__ __forceinline__ void write_row(const Stats& t, float zc,
                                          int64_t row, const FwdOut& o,
                                          float beta, float a, float neg_h) {
  if constexpr (PARTIAL) {
    o.kl[row] = t.z;
    o.mx[row] = t.m;
    o.sumexp[row] = t.s;
    o.zc[row] = zc;
    return;
  }
  float* __restrict__ kl = o.kl;
  float* __restrict__ mx = o.mx;
  float* __restrict__ sumexp = o.sumexp;
  const float lse = __fadd_rn(logf(t.s), t.m);
  // beta*z_c + a*(sum z - z_c) - lse, one rounding per operation
  const float cross = __fsub_rn(
      __fadd_rn(__fmul_rn(beta, zc), __fmul_rn(a, __fsub_rn(t.z, zc))), lse);
  kl[row] = __fsub_rn(neg_h, cross);
  mx[row] = t.m;
  sumexp[row] = t.s;
}

// The two forms of the forward (see the plan): rows of a sub-warp each,
// rows of a block each.
enum FwdForm { kGroupRows, kBlockRows };

// Thread 0 gets the block's triple; the block's threads all call it.
__device__ __forceinline__ Stats block_reduce(Stats st, Stats* warp_stats) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  st = shfl_combine(st, 0xffffffffu, 32);
  if (lane == 0) warp_stats[warp] = st;
  __syncthreads();
  if (warp == 0) {
    st = shfl_combine(
        lane < static_cast<int>(blockDim.x >> 5) ? warp_stats[lane]
                                                 : empty_stats(),
        0xffffffffu, 32);
  }
  __syncthreads();  // warp_stats is rewritten by the next call
  return st;
}

// kGroupRows: blockDim.x / lanes rows a block, `lanes` (2-32) lanes a row.
// kBlockRows: one block a row.
// PARTIAL: the shard's partial statistics (labels - lab_off are local,
// out of [0, V) in every shard but one; labels outside [0, v_total) trap).
template <typename T, int VEC, FwdForm FORM, bool PARTIAL>
__global__ void __launch_bounds__(kMaxThreads)
vt_fwd_kernel(const T* __restrict__ z, const int64_t* __restrict__ labels,
              FwdOut o, int64_t B, int64_t V, int lanes, float beta,
              float a, float neg_h, int64_t lab_off, int64_t v_total) {
  const int64_t nvec = V / VEC;
  if constexpr (FORM == kGroupRows) {
    // each lane holds at most U vectors of its row (launch_fwd checks),
    // loaded in one step; the label's logit comes from the lane that
    // holds it, so no load waits on the label
    constexpr int U = fwd_unroll<T, VEC>();
    using P = Pack<T, VEC>;
    const int lane = threadIdx.x & (lanes - 1);
    const int rows = blockDim.x / lanes;
    const int group = threadIdx.x / lanes;
    const unsigned mask =
        lanes == 32 ? 0xffffffffu
                    : ((1u << lanes) - 1u) << ((threadIdx.x & 31) & ~(lanes - 1));
    for (int64_t row = static_cast<int64_t>(blockIdx.x) * rows + group;
         row < B; row += static_cast<int64_t>(gridDim.x) * rows) {
      const T* zr = z + row * V;
      P p[U];
      int n = 0;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (lane + u * lanes < nvec) {
          p[u] = *reinterpret_cast<const P*>(zr + (lane + u * lanes) * VEC);
          ++n;
        }
      }
      const int64_t glab = labels[row];
      const int64_t lab = glab - lab_off;
      float zc = 0.0f;
#pragma unroll
      for (int u = 0; u < U; ++u) {
#pragma unroll
        for (int j = 0; j < VEC; ++j)
          if (u < n && static_cast<int64_t>(lane + u * lanes) * VEC + j == lab)
            zc = to_f32(p[u].v[j]);
      }
      Stats st = empty_stats();
      fold<T, VEC, U>(st, p, n);
      st = shfl_combine(st, mask, lanes);
      if constexpr (PARTIAL) {
        if (glab < 0 || glab >= v_total) __trap();
        // a label outside the shard leaves zc = 0 on every lane
        zc = __shfl_sync(mask, zc,
                         static_cast<int>(((lab < 0 ? 0 : lab) / VEC)
                                          & (lanes - 1)),
                         lanes);
      } else {
        if (lab < 0 || lab >= V) __trap();
        zc = __shfl_sync(mask, zc,
                         static_cast<int>((lab / VEC) & (lanes - 1)), lanes);
      }
      if (lane == 0) write_row<PARTIAL>(st, zc, row, o, beta, a, neg_h);
    }
  } else {
    __shared__ Stats warp_stats[kMaxThreads / 32];
    for (int64_t row = blockIdx.x; row < B; row += gridDim.x) {
      const T* zr = z + row * V;
      const int64_t lab = threadIdx.x == 0 ? labels[row] : 0;
      const Stats part = accumulate<T, VEC>(zr, threadIdx.x, nvec, blockDim.x);
      float zc = 0.0f;
      if (threadIdx.x == 0) {
        if constexpr (PARTIAL) {
          if (lab < 0 || lab >= v_total) __trap();
          const int64_t loc = lab - lab_off;
          if (loc >= 0 && loc < V) zc = to_f32(zr[loc]);
        } else {
          zc = label_logit(zr, lab, V);
        }
      }
      const Stats st = block_reduce(part, warp_stats);
      if (threadIdx.x == 0) write_row<PARTIAL>(st, zc, row, o, beta, a, neg_h);
    }
  }
}

// n / d for n < 2^31 by a multiply and a shift (d >= 1).
struct Divider {
  uint32_t magic;
  uint32_t shift;
  __host__ explicit Divider(uint32_t d) {
    shift = 0;
    while (shift < 32 && (1ull << shift) < d) ++shift;
    magic = static_cast<uint32_t>(
        ((1ull << 32) * ((1ull << shift) - d)) / d + 1);
  }
  __device__ __forceinline__ uint32_t div(uint32_t n) const {
    return (__umulhi(n, magic) + n) >> shift;
  }
};

// Thread t of block k takes vectors i, i + G, ... (G = the grid's
// threads), U of them a step, loads first.
template <typename T, int VEC>
__global__ void __launch_bounds__(kBwdThreads)
vt_bwd_kernel(const T* __restrict__ z, const int64_t* __restrict__ labels,
              const float* __restrict__ mx, const float* __restrict__ sumexp,
              const float* __restrict__ g, T* __restrict__ dz, int64_t total,
              int64_t nvec, int64_t V, Divider rowdiv, bool narrow,
              float beta, float a, int64_t lab_off) {
  constexpr int U = bwd_unroll<T, VEC>();
  const int64_t grid = static_cast<int64_t>(gridDim.x) * kBwdThreads;
  for (int64_t i0 = static_cast<int64_t>(blockIdx.x) * kBwdThreads
                    + threadIdx.x;
       i0 < total; i0 += grid * U) {
    Pack<T, VEC> p[U];
    int64_t row[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int64_t i = i0 + u * grid;
      if (i < total) {
        row[u] = narrow ? rowdiv.div(static_cast<uint32_t>(i)) : i / nvec;
        p[u] = *reinterpret_cast<const Pack<T, VEC>*>(z + i * VEC);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int64_t i = i0 + u * grid;
      if (i < total) {
        const int64_t r = row[u];
        const float m = mx[r], s = sumexp[r], gr = g[r];
        // the label's element (none of row r's when the label lies
        // outside this shard's columns)
        const int64_t lab_at = r * V + (labels[r] - lab_off);
        Pack<T, VEC> out;
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const float prob =
              __fdiv_rn(expf(__fsub_rn(to_f32(p[u].v[j]), m)), s);
          const float pt = (i * VEC + j == lab_at) ? beta : a;
          out.v[j] = from_f32<T>(__fmul_rn(__fsub_rn(prob, pt), gr));
        }
        *reinterpret_cast<Pack<T, VEC>*>(dz + i * VEC) = out;
      }
    }
  }
}

template <typename T, int VEC, bool PARTIAL>
cudaError_t launch_fwd(const void* z, const int64_t* labels, FwdOut o,
                       int64_t B, int64_t V, int lanes, int rows, float beta,
                       float a, float neg_h, int64_t lab_off, int64_t v_total,
                       cudaStream_t stream) {
  const T* zt = static_cast<const T*>(z);
  const int threads = lanes * rows;
  if (rows > 1) {
    if (V / VEC > static_cast<int64_t>(lanes) * fwd_unroll<T, VEC>())
      return cudaErrorInvalidValue;  // a lane would hold more than a step
    const int64_t want = (B + rows - 1) / rows;
    const int64_t blocks = want < kMaxRowBlocks ? want : kMaxRowBlocks;
    vt_fwd_kernel<T, VEC, kGroupRows, PARTIAL>
        <<<static_cast<unsigned>(blocks), threads, 0, stream>>>(
            zt, labels, o, B, V, lanes, beta, a, neg_h, lab_off, v_total);
    return cudaGetLastError();
  }
  const int64_t blocks = B < kMaxRowBlocks ? B : kMaxRowBlocks;
  vt_fwd_kernel<T, VEC, kBlockRows, PARTIAL>
      <<<static_cast<unsigned>(blocks), threads, 0, stream>>>(
          zt, labels, o, B, V, lanes, beta, a, neg_h, lab_off, v_total);
  return cudaGetLastError();
}

template <typename T, int VEC>
cudaError_t launch_bwd(const void* z, const int64_t* labels, const float* mx,
                       const float* sumexp, const float* g, void* dz,
                       int64_t B, int64_t V, float beta, float a,
                       int64_t lab_off, cudaStream_t stream) {
  const int64_t nvec = V / VEC, total = B * nvec;
  const bool narrow = total < (int64_t{1} << 31);
  const Divider rowdiv(narrow ? static_cast<uint32_t>(nvec) : 1u);
  // U vectors a thread, unless that leaves fewer than kBwdMinBlocks
  // blocks: then one a thread
  const int64_t per_block = static_cast<int64_t>(kBwdThreads)
                            * bwd_unroll<T, VEC>();
  const int64_t one_each = (total + kBwdThreads - 1) / kBwdThreads;
  int64_t blocks = (total + per_block - 1) / per_block;
  if (blocks < kBwdMinBlocks)
    blocks = one_each < kBwdMinBlocks ? one_each : kBwdMinBlocks;
  if (blocks > 0x7fffffff) blocks = 0x7fffffff;
  vt_bwd_kernel<T, VEC><<<static_cast<unsigned>(blocks), kBwdThreads, 0,
                          stream>>>(
      static_cast<const T*>(z), labels, mx, sumexp, g, static_cast<T*>(dz),
      total, nvec, V, rowdiv, narrow, beta, a, lab_off);
  return cudaGetLastError();
}

// Whether the vector width fits the rows and the pointers.
bool width_fits(int64_t V, int elt, int vec_bytes, uintptr_t align) {
  return (vec_bytes == 2 || vec_bytes == 4 || vec_bytes == 8 ||
          vec_bytes == 16) &&
         vec_bytes >= elt && (V * elt) % vec_bytes == 0 &&
         align % vec_bytes == 0;
}

// Whether the forward plan is one the kernel takes (see vt_plan).
bool fwd_plan_fits(int lanes, int rows) {
  const bool pow2 = lanes > 0 && (lanes & (lanes - 1)) == 0;
  if (rows > 1)
    return pow2 && lanes >= 2 && lanes <= kGroupMaxLanes &&
           static_cast<int64_t>(lanes) * rows <= kMaxThreads;
  return rows == 1 && lanes % 32 == 0 && lanes >= 32 && lanes <= kMaxThreads;
}

template <typename T, bool PARTIAL>
cudaError_t fwd_by_width(const void* z, const int64_t* labels, FwdOut o,
                         int64_t B, int64_t V, int vec_bytes, int lanes,
                         int rows, float beta, float a, float neg_h,
                         int64_t lab_off, int64_t v_total,
                         cudaStream_t stream) {
  switch (vec_bytes / static_cast<int>(sizeof(T))) {
    case 1:
      return launch_fwd<T, 1, PARTIAL>(z, labels, o, B, V, lanes, rows, beta,
                                       a, neg_h, lab_off, v_total, stream);
    case 2:
      return launch_fwd<T, 2, PARTIAL>(z, labels, o, B, V, lanes, rows, beta,
                                       a, neg_h, lab_off, v_total, stream);
    case 4:
      return launch_fwd<T, 4, PARTIAL>(z, labels, o, B, V, lanes, rows, beta,
                                       a, neg_h, lab_off, v_total, stream);
    case 8:
      if constexpr (sizeof(T) == 2)
        return launch_fwd<T, 8, PARTIAL>(z, labels, o, B, V, lanes, rows,
                                         beta, a, neg_h, lab_off, v_total,
                                         stream);
      return cudaErrorInvalidValue;
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t bwd_by_width(const void* z, const int64_t* labels,
                         const float* mx, const float* sumexp, const float* g,
                         void* dz, int64_t B, int64_t V, int vec_bytes,
                         float beta, float a, int64_t lab_off,
                         cudaStream_t stream) {
  switch (vec_bytes / static_cast<int>(sizeof(T))) {
    case 1:
      return launch_bwd<T, 1>(z, labels, mx, sumexp, g, dz, B, V, beta, a,
                              lab_off, stream);
    case 2:
      return launch_bwd<T, 2>(z, labels, mx, sumexp, g, dz, B, V, beta, a,
                              lab_off, stream);
    case 4:
      return launch_bwd<T, 4>(z, labels, mx, sumexp, g, dz, B, V, beta, a,
                              lab_off, stream);
    case 8:
      if constexpr (sizeof(T) == 2)
        return launch_bwd<T, 8>(z, labels, mx, sumexp, g, dz, B, V, beta, a,
                                lab_off, stream);
      return cudaErrorInvalidValue;
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

namespace {

cudaError_t fwd_any(const void* z, int dtype, const int64_t* labels,
                    FwdOut o, int64_t B, int64_t V, int vec_bytes, int lanes,
                    int rows_per_block, float beta, float a, float neg_h,
                    bool partial, int64_t lab_off, int64_t v_total,
                    cudaStream_t stream) {
  if (B <= 0) return cudaSuccess;
  const int elt = dtype == 0 ? 4 : dtype == 1 ? 2 : 0;
  if (elt == 0 || V < (partial ? 1 : 2) ||
      !width_fits(V, elt, vec_bytes, reinterpret_cast<uintptr_t>(z)) ||
      !fwd_plan_fits(lanes, rows_per_block))
    return cudaErrorInvalidValue;
  if (partial) {
    if (dtype == 0)
      return fwd_by_width<float, true>(z, labels, o, B, V, vec_bytes, lanes,
                                       rows_per_block, beta, a, neg_h,
                                       lab_off, v_total, stream);
    return fwd_by_width<__nv_bfloat16, true>(z, labels, o, B, V, vec_bytes,
                                             lanes, rows_per_block, beta, a,
                                             neg_h, lab_off, v_total, stream);
  }
  if (dtype == 0)
    return fwd_by_width<float, false>(z, labels, o, B, V, vec_bytes, lanes,
                                      rows_per_block, beta, a, neg_h, 0, V,
                                      stream);
  return fwd_by_width<__nv_bfloat16, false>(z, labels, o, B, V, vec_bytes,
                                            lanes, rows_per_block, beta, a,
                                            neg_h, 0, V, stream);
}

cudaError_t bwd_any(const void* z, int dtype, const int64_t* labels,
                    const float* mx, const float* sumexp, const float* g,
                    void* dz, int64_t B, int64_t V, int vec_bytes, float beta,
                    float a, int64_t lab_off, cudaStream_t stream) {
  if (B <= 0) return cudaSuccess;
  const int elt = dtype == 0 ? 4 : dtype == 1 ? 2 : 0;
  const uintptr_t al = reinterpret_cast<uintptr_t>(z)
                       | reinterpret_cast<uintptr_t>(dz);
  if (elt == 0 || V < 1 || !width_fits(V, elt, vec_bytes, al))
    return cudaErrorInvalidValue;
  if (dtype == 0)
    return bwd_by_width<float>(z, labels, mx, sumexp, g, dz, B, V, vec_bytes,
                               beta, a, lab_off, stream);
  return bwd_by_width<__nv_bfloat16>(z, labels, mx, sumexp, g, dz, B, V,
                                     vec_bytes, beta, a, lab_off, stream);
}

}  // namespace

// dtype: 0 = float32 logits, 1 = bfloat16 logits.  (vec_bytes, lanes,
// rows_per_block) is the launcher's plan; a plan the kernel
// does not take returns cudaErrorInvalidValue without a launch.
extern "C" cudaError_t vt_kl_fwd(const void* z, int dtype,
                                 const int64_t* labels, float* kl, float* mx,
                                 float* sumexp, int64_t B, int64_t V,
                                 int vec_bytes, int lanes, int rows_per_block,
                                 float beta, float a, float neg_h,
                                 cudaStream_t stream) {
  return fwd_any(z, dtype, labels, FwdOut{kl, mx, sumexp, nullptr}, B, V,
                 vec_bytes, lanes, rows_per_block, beta, a, neg_h, false, 0,
                 V, stream);
}

extern "C" cudaError_t vt_kl_bwd(const void* z, int dtype,
                                 const int64_t* labels, const float* mx,
                                 const float* sumexp, const float* g,
                                 void* dz, int64_t B, int64_t V,
                                 int vec_bytes, float beta, float a,
                                 cudaStream_t stream) {
  if (V < 2) return cudaErrorInvalidValue;
  return bwd_any(z, dtype, labels, mx, sumexp, g, dz, B, V, vec_bytes, beta,
                 a, 0, stream);
}

// ---------------------------------------------------------------------------
// The vocab-parallel kernels (see the header): their own plan, loads and
// folds; the unsplit kernels above are not used by them.
// ---------------------------------------------------------------------------
namespace {

constexpr int kSplitThreads = 256;  // a CTA of either kernel
constexpr int kSplitLanes = 31;     // lanes of a forward warp that hold chunks
// 16-byte chunks a forward lane loads a step: fp32, bf16 (64 registers a
// thread either way, four CTAs an SM)
constexpr int kSplitStepF32 = 2;
constexpr int kSplitStepBF16 = 3;
constexpr int kSplitBwdWords = 5;   // 16-byte words a backward thread takes
constexpr float kLog2e = 1.44269504088896340736f;

__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Elements of a 16-byte word, and a 32-bit word of -inf elements.
template <typename T> struct WordOf;
template <> struct WordOf<float> {
  static constexpr int E = 4;
  static constexpr uint32_t kNegInf = 0xff800000u;
};
template <> struct WordOf<__nv_bfloat16> {
  static constexpr int E = 8;
  static constexpr uint32_t kNegInf = 0xff80ff80u;
};

// Element e (compile-time) of a chunk held as four 32-bit words in column
// order; a bf16 widened by a shift (the low half) or a mask (the high).
template <typename T, int e>
__device__ __forceinline__ float elem(const uint32_t (&y)[4]) {
  if constexpr (sizeof(T) == 4) {
    return __uint_as_float(y[e]);
  } else if constexpr (e & 1) {
    return __uint_as_float(y[e >> 1] & 0xffff0000u);
  } else {
    return __uint_as_float(y[e >> 1] << 16);
  }
}

// Element i (run time) of a chunk, by selects: the label's logit.
template <typename T, int e = WordOf<T>::E - 1>
__device__ __forceinline__ float elem_at(const uint32_t (&y)[4], int i) {
  if constexpr (e == 0) {
    return elem<T, 0>(y);
  } else {
    const float below = elem_at<T, e - 1>(y, i);
    return i == e ? elem<T, e>(y) : below;
  }
}

// A row's bytes: [a, end), and a rounded down to 16.
struct RowSpan {
  uintptr_t a, end, base;
};

template <typename T>
__device__ __forceinline__ RowSpan row_span(const T* row, int64_t V) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(row);
  return {a, a + static_cast<uintptr_t>(V) * sizeof(T),
          a & ~static_cast<uintptr_t>(15)};
}

// Word k of the row's 16-byte-aligned span: one 16-byte load when the row
// holds all of it; else its elements that lie in the row one by one and
// -inf in the others (nothing outside the row is read).
template <typename T>
__device__ __forceinline__ uint4 load_word(const RowSpan& r, int k) {
  const uintptr_t lo = r.base + 16 * static_cast<uintptr_t>(k);
  if (lo >= r.a && lo + 16 <= r.end)
    return __ldg(reinterpret_cast<const uint4*>(lo));
  uint32_t w[4] = {WordOf<T>::kNegInf, WordOf<T>::kNegInf,
                   WordOf<T>::kNegInf, WordOf<T>::kNegInf};
  if (lo < r.end && lo + 16 > r.a) {
#pragma unroll
    for (int i = 0; i < WordOf<T>::E; ++i) {
      const uintptr_t at = lo + i * sizeof(T);
      if (at >= r.a && at < r.end) {
        if constexpr (sizeof(T) == 4) {
          w[i] = *reinterpret_cast<const uint32_t*>(at);
        } else {
          const uint32_t h = *reinterpret_cast<const unsigned short*>(at);
          w[i >> 1] = (i & 1) ? (w[i >> 1] & 0xffffu) | (h << 16)
                              : (w[i >> 1] & 0xffff0000u) | h;
        }
      }
    }
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// A lane's U words of a step (word c0 + u * slot): plain 16-byte loads
// when the warp's words all lie inside the row (`inside`), else each by
// `load_word`.
template <typename T, int U>
__device__ __forceinline__ void load_step(const RowSpan& r, int c0, int slot,
                                          bool inside, uint4 (&wd)[U]) {
  if (inside) {
#pragma unroll
    for (int u = 0; u < U; ++u)
      wd[u] = __ldg(reinterpret_cast<const uint4*>(
          r.base + 16 * static_cast<uintptr_t>(c0 + u * slot)));
  } else {
#pragma unroll
    for (int u = 0; u < U; ++u) wd[u] = load_word<T>(r, c0 + u * slot);
  }
}

// Chunk c of a row alone, in column order: one 16-byte load when it is an
// aligned word of the row, else element by element, -inf past the row.
template <typename T>
__device__ __forceinline__ void load_chunk(const RowSpan& r, int c,
                                           uint32_t (&y)[4]) {
  const uintptr_t lo = r.a + 16 * static_cast<uintptr_t>(c);
  if ((lo & 15) == 0 && lo + 16 <= r.end) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(lo));
    y[0] = v.x;
    y[1] = v.y;
    y[2] = v.z;
    y[3] = v.w;
    return;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) y[j] = WordOf<T>::kNegInf;
#pragma unroll
  for (int i = 0; i < WordOf<T>::E; ++i) {
    const uintptr_t at = lo + i * sizeof(T);
    if (at < r.end) {
      if constexpr (sizeof(T) == 4) {
        y[i] = *reinterpret_cast<const uint32_t*>(at);
      } else {
        const uint32_t h = *reinterpret_cast<const unsigned short*>(at);
        y[i >> 1] = (i & 1) ? (y[i >> 1] & 0xffffu) | (h << 16)
                            : (y[i >> 1] & 0xffff0000u) | h;
      }
    }
  }
}

// The U chunks of a lane in column order, from the words the lanes loaded:
// lane l loaded word c, the first its chunk c touches; a row that starts
// sb bytes past a 16-byte boundary takes bytes [sb, sb + 16) of that word
// and lane l + 1's.  fp32 (SB = sb, the row loop compiled once a phase):
// a shuffle for each of lane l + 1's words the chunk needs and the words
// picked at compile time.  bf16 (SB < 0): four shuffles, two rounds of
// selects by the whole 32-bit words in sb and a funnel shift by the rest,
// one instruction stream at every phase (compiled once a phase, bf16's
// row loop spills or takes 80 registers, and runs slower).
template <typename T, int U, int SB>
__device__ __forceinline__ void realign(int sb, const uint4 (&wd)[U],
                                        uint32_t (&y)[U][4]) {
  static_assert(SB < 0 || sizeof(T) == 4, "a phase picked at compile time "
                "is whole 32-bit words: fp32 only");
  if constexpr (SB >= 0) {
    constexpr int Q = SB / 4;  // whole 32-bit words skipped
#pragma unroll
    for (int u = 0; u < U; ++u) {
      uint32_t x[8] = {wd[u].x, wd[u].y, wd[u].z, wd[u].w, 0u, 0u, 0u, 0u};
#pragma unroll
      for (int i = 4; i < 8; ++i)
        if (i <= 3 + Q) x[i] = __shfl_down_sync(0xffffffffu, x[i - 4], 1);
#pragma unroll
      for (int k = 0; k < 4; ++k) y[u][k] = x[k + Q];
    }
    return;
  }
  if (sb == 0) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      y[u][0] = wd[u].x;
      y[u][1] = wd[u].y;
      y[u][2] = wd[u].z;
      y[u][3] = wd[u].w;
    }
    return;
  }
  const bool q1 = sb & 4, q2 = sb & 8;
  const unsigned sh = (sb & 3) * 8;  // 0, or 16 for bf16
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const uint32_t x[8] = {wd[u].x, wd[u].y, wd[u].z, wd[u].w,
                           __shfl_down_sync(0xffffffffu, wd[u].x, 1),
                           __shfl_down_sync(0xffffffffu, wd[u].y, 1),
                           __shfl_down_sync(0xffffffffu, wd[u].z, 1),
                           __shfl_down_sync(0xffffffffu, wd[u].w, 1)};
    uint32_t t[7], v[5];
#pragma unroll
    for (int k = 0; k < 7; ++k) t[k] = q1 ? x[k + 1] : x[k];
#pragma unroll
    for (int k = 0; k < 5; ++k) v[k] = q2 ? t[k + 2] : t[k];
#pragma unroll
    for (int k = 0; k < 4; ++k) y[u][k] = __funnelshift_r(v[k], v[k + 1], sh);
  }
}

// The largest element of the step's chunks below nchunk (a tail chunk's
// columns past V hold -inf), by a tree; bf16 pairs compared packed.
template <typename T, int U>
__device__ __forceinline__ float step_max(const uint32_t (&y)[U][4], int c0,
                                          int slot, int nchunk) {
  float m[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    if constexpr (sizeof(T) == 2) {
      const uint32_t w[4] = {y[u][0], y[u][1], y[u][2], y[u][3]};
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(w);
      const __nv_bfloat162 p = __hmax2(__hmax2(h[0], h[1]),
                                       __hmax2(h[2], h[3]));
      m[u] = fmaxf(__low2float(p), __high2float(p));
    } else {
      m[u] = fmaxf(fmaxf(__uint_as_float(y[u][0]), __uint_as_float(y[u][1])),
                   fmaxf(__uint_as_float(y[u][2]), __uint_as_float(y[u][3])));
    }
    if (c0 + u * slot >= nchunk) m[u] = -INFINITY;
  }
#pragma unroll
  for (int n = 1; n < U; n *= 2) {
#pragma unroll
    for (int u = 0; u + n < U; u += 2 * n) m[u] = fmaxf(m[u], m[u + n]);
  }
  return m[0];
}

// The first n elements of a chunk into t (sum of exp2(f log2e - mh)) and
// zs (sum of f), in column order.
template <typename T, int e = 0>
__device__ __forceinline__ void add_chunk(const uint32_t (&y)[4], int n,
                                          float mh, float& t, float& zs) {
  if (e < n) {
    const float f = elem<T, e>(y);
    zs = __fadd_rn(zs, f);
    t = __fadd_rn(t, ex2_approx(__fmaf_rn(f, kLog2e, -mh)));
    if constexpr (e + 1 < WordOf<T>::E) add_chunk<T, e + 1>(y, n, mh, t, zs);
  }
}

// Fold a step: its max m taken, the running sum rescaled once, then each
// chunk's logits and exps summed in column order and the chunks' sums
// added in order (full chunks, then the row's tail chunk, which is the
// last of its lane's).  exp(f - m) is exp2(f log2e - mh) * exp2(mh - m
// log2e), mh = m log2e rounded: one FFMA and one MUFU a logit, the second
// factor (mh - m log2e by an exact FMA residual) once a step.  The label's
// logit is written by the lane whose chunk holds it.
// A lane's running triple, with mh = m log2e rounded and corr = exp2(mh -
// m log2e), which change only with m.
struct LaneStats {
  Stats st;
  float mh, corr;
};

template <typename T, int U>
__device__ __forceinline__ void fold_step(LaneStats& ls,
                                          const uint32_t (&y)[U][4], int c0,
                                          int slot, int V, int lab,
                                          float* __restrict__ zc) {
  constexpr int E = WordOf<T>::E;
  const int nfull = V / E, nchunk = (V + E - 1) / E;
  const Stats& st = ls.st;
  const float m = fmaxf(st.m, step_max<T, U>(y, c0, slot, nchunk));
  float s = st.s;
  if (m != st.m) {  // the max moved: rescale the sum, new mh and corr
    s = st.m == -INFINITY
            ? 0.0f
            : __fmul_rn(st.s, ex2_approx(__fmul_rn(__fsub_rn(st.m, m),
                                                   kLog2e)));
    ls.mh = __fmul_rn(m, kLog2e);
    ls.corr = m == -INFINITY ? 1.0f
                             : ex2_approx(-__fmaf_rn(m, kLog2e, -ls.mh));
  }
  const float mh = ls.mh;
  float t = 0.0f, zs = st.z;
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int c = c0 + u * slot;
    float tu = 0.0f, zu = 0.0f;  // the chunk's sums, then added in order
    if (c < nfull) {
      add_chunk<T>(y[u], E, mh, tu, zu);
    } else if (c < nchunk) {
      add_chunk<T>(y[u], V - c * E, mh, tu, zu);
    }
    t = __fadd_rn(t, tu);
    zs = __fadd_rn(zs, zu);
    if (lab >= 0 && c == lab / E) *zc = elem_at<T>(y[u], lab - c * E);
  }
  ls.st = {m, __fmaf_rn(t, ls.corr, s), zs};
}

// The triples of `width` lanes (a power of two) merged by fixed trees:
// their max by a butterfly, each lane's sum rescaled to it once, then the
// sums by a butterfly (each step adds two lanes' values, which both sides
// of it round alike).
__device__ __forceinline__ Stats shfl_merge(const Stats& st, int width) {
  float m = st.m;
  for (int off = width >> 1; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off, width));
  float s = st.m == -INFINITY
                ? 0.0f
                : __fmul_rn(st.s, ex2_approx(__fmul_rn(__fsub_rn(st.m, m),
                                                       kLog2e)));
  float zs = st.z;
  for (int off = width >> 1; off > 0; off >>= 1) {
    s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, off, width));
    zs = __fadd_rn(zs, __shfl_xor_sync(0xffffffffu, zs, off, width));
  }
  return {m, s, zs};
}

// The streaming loop of `shard_row` for rows that start sb bytes past a
// 16-byte boundary (SB = sb, or < 0: see `realign`; `lanes` a warp, chunk
// c0 + u * slot of step k).  A lane loads step k + 1's words before it
// folds step k.
template <typename T, int U, int SB>
__device__ __forceinline__ Stats stream_row(const RowSpan& r, int sb, int V,
                                            int lanes, int slot, int w,
                                            int lane, int lab,
                                            float* __restrict__ zc) {
  constexpr int E = WordOf<T>::E;
  const int nchunk = (V + E - 1) / E;
  const int per_step = slot * U;
  const int nsteps = (nchunk + per_step - 1) / per_step;
  const int first = w * lanes + lane;
  const bool active = lane < lanes;
  // the warp's words of step k: from its lane 0's first to its lane 31's
  // last, all inside the row?
  auto inside = [&](int k) {
    const int lo = k * per_step + w * lanes;
    const int hi = lo + 31 + (U - 1) * slot;
    return r.base + 16 * static_cast<uintptr_t>(lo) >= r.a &&
           r.base + 16 * static_cast<uintptr_t>(hi) + 16 <= r.end;
  };
  LaneStats ls{empty_stats(), -INFINITY, 1.0f};
  uint4 cur[U], nxt[U];
  load_step<T, U>(r, first, slot, inside(0), cur);
  for (int k = 0; k < nsteps; ++k) {
    const int c0 = k * per_step + first;
    if (k + 1 < nsteps)
      load_step<T, U>(r, c0 + per_step, slot, inside(k + 1), nxt);
    uint32_t y[U][4];
    realign<T, U, SB>(sb, cur, y);
    if (active) fold_step<T, U>(ls, y, c0, slot, V, lab, zc);
#pragma unroll
    for (int u = 0; u < U; ++u) cur[u] = nxt[u];
  }
  return ls.st;
}

// One row's triple from the lanes of `nw` warps (warp w of them): lane l
// of warp w takes chunks ((k U + u) nw + w) L + l, U a step k, L = 32
// lanes a warp when a row is whole 16-byte words, else 31: lane 31 then
// only loads the word after lane 30's chunk, with which lane 30 realigns
// its chunk (`stream_row`).  Rows of whole words
// that start off a 16-byte boundary load chunk by chunk.
template <typename T, int U>
__device__ __forceinline__ Stats shard_row(const T* __restrict__ zr, int V,
                                           int nw, int w, int lane, int lab,
                                           float* __restrict__ zc) {
  constexpr int E = WordOf<T>::E;
  const RowSpan r = row_span(zr, V);
  const int sb = static_cast<int>(r.a & 15);
  const int lanes = (V * static_cast<int>(sizeof(T))) % 16 ? kSplitLanes : 32;
  const int slot = lanes * nw;
  if (lanes == 32 && sb != 0) {
    const int nchunk = (V + E - 1) / E, per_step = slot * U;
    const int nsteps = (nchunk + per_step - 1) / per_step;
    LaneStats ls{empty_stats(), -INFINITY, 1.0f};
    for (int k = 0; k < nsteps; ++k) {
      const int c0 = k * per_step + w * lanes + lane;
      uint32_t y[U][4];
#pragma unroll
      for (int u = 0; u < U; ++u) load_chunk<T>(r, c0 + u * slot, y[u]);
      fold_step<T, U>(ls, y, c0, slot, V, lab, zc);
    }
    return ls.st;
  }
  if constexpr (sizeof(T) == 2) {
    return stream_row<T, U, -1>(r, sb, V, lanes, slot, w, lane, lab, zc);
  } else {
    switch (sb) {
      case 4:
        return stream_row<T, U, 4>(r, sb, V, lanes, slot, w, lane, lab, zc);
      case 8:
        return stream_row<T, U, 8>(r, sb, V, lanes, slot, w, lane, lab, zc);
      case 12:
        return stream_row<T, U, 12>(r, sb, V, lanes, slot, w, lane, lab,
                                    zc);
      default:
        return stream_row<T, U, 0>(r, sb, V, lanes, slot, w, lane, lab, zc);
    }
  }
}

// Rows of `nw` warps each, 8 / nw rows a CTA; the row's triple is its
// lanes' merged by `shfl_merge` in each warp, then its warps' (through
// shared memory).
template <typename T>
__global__ void __launch_bounds__(kSplitThreads)
vt_partial_kernel(const T* __restrict__ z, const int64_t* __restrict__ labels,
                  FwdOut o, int64_t B, int V, int nw, int64_t lab_off,
                  int64_t v_total) {
  __shared__ Stats warp_stats[kSplitThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int rows = kSplitThreads / 32 / nw;
  const int team = warp / nw, w = warp - team * nw;
  for (int64_t row0 = static_cast<int64_t>(blockIdx.x) * rows; row0 < B;
       row0 += static_cast<int64_t>(gridDim.x) * rows) {
    const int64_t row = row0 + team;
    Stats st = empty_stats();
    int lab = -1;
    if (row < B) {
      // the label is checked once the row is folded, so that no load
      // waits on it
      const int64_t glab = labels[row];
      const int64_t loc = glab - lab_off;
      lab = loc >= 0 && loc < V ? static_cast<int>(loc) : -1;
      st = shard_row<T, sizeof(T) == 2 ? kSplitStepBF16 : kSplitStepF32>(
          z + row * V, V, nw, w, lane, lab, o.zc + row);
      if (glab < 0 || glab >= v_total) __trap();
    }
    st = shfl_merge(st, 32);
    if (nw > 1) {
      if (lane == 0) warp_stats[warp] = st;
      __syncthreads();
      if (w == 0)
        st = shfl_merge(lane < nw ? warp_stats[warp + lane] : empty_stats(),
                        nw);
      __syncthreads();  // warp_stats is rewritten by the next rows
    }
    if (row < B && w == 0 && lane == 0) {
      o.kl[row] = st.z;
      o.mx[row] = st.m;
      o.sumexp[row] = st.s;
      if (lab < 0) o.zc[row] = 0.0f;
    }
  }
}

// dz of one logit: (exp(f - m) / s - pt) * g, the quotient as e * (1 / s)
// corrected once by an FMA.
__device__ __forceinline__ float shard_grad(float f, float m, float s,
                                            float rs, float pt, float g) {
  const float e = expf(__fsub_rn(f, m));
  const float q = __fmul_rn(e, rs);
  const float prob = __fmaf_rn(__fmaf_rn(-q, s, e), rs, q);
  return __fmul_rn(__fsub_rn(prob, pt), g);
}

// dz of a 16-byte word of logits x, every element taking pt = a.
template <typename T>
__device__ __forceinline__ void grad_word(const uint32_t (&x)[4],
                                          uint32_t (&out)[4], float m,
                                          float s, float rs, float a,
                                          float g) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if constexpr (sizeof(T) == 4) {
      out[j] = __float_as_uint(
          shard_grad(__uint_as_float(x[j]), m, s, rs, a, g));
    } else {
      const __nv_bfloat162 h = __floats2bfloat162_rn(
          shard_grad(__uint_as_float(x[j] << 16), m, s, rs, a, g),
          shard_grad(__uint_as_float(x[j] & 0xffff0000u), m, s, rs, a, g));
      out[j] = *reinterpret_cast<const uint32_t*>(&h);
    }
  }
}

// Element i (run time) of a word set to v, rounded to T.
template <typename T, int e = 0>
__device__ __forceinline__ void set_elem(uint32_t (&w)[4], int i, float v) {
  if constexpr (e + 1 < WordOf<T>::E) {
    if (i != e) {
      set_elem<T, e + 1>(w, i, v);
      return;
    }
  }
  if constexpr (sizeof(T) == 4) {
    w[e] = __float_as_uint(v);
  } else {
    const uint32_t h = __bfloat16_as_ushort(__float2bfloat16_rn(v));
    w[e >> 1] = (e & 1) ? (w[e >> 1] & 0xffffu) | (h << 16)
                        : (w[e >> 1] & 0xffff0000u) | h;
  }
}

// CTA k of a row's `nblk` takes its 16-byte words k * 256 * kw + t + 256 j
// (j < kw <= W, kw the fewest that cover the row's words, so every CTA of
// the row but the last has the same share): the row's statistics loaded
// once; word k holds columns [k E - ph, k E - ph + E), ph the elements of
// the row's first word before its start; whole words by 16-byte loads and
// stores, then CTA 0 of the row takes the columns of its partial first
// and last words element by element.  z and dz at different 16-byte
// phases (`same` false): the CTA's columns one element at a time.
template <typename T>
__global__ void __launch_bounds__(kSplitThreads, 5)
vt_bwd_shard_kernel(const T* __restrict__ z,
                    const int64_t* __restrict__ labels,
                    const float* __restrict__ mx,
                    const float* __restrict__ sumexp,
                    const float* __restrict__ g, T* __restrict__ dz,
                    int64_t B, int V, int nblk, int kw, float beta, float a,
                    int64_t lab_off, bool same) {
  constexpr int E = WordOf<T>::E, W = kSplitBwdWords;
  const int64_t total = B * nblk;
  for (int64_t blk = blockIdx.x; blk < total; blk += gridDim.x) {
    const int64_t row = blk / nblk;
    const int cb = static_cast<int>(blk - row * nblk);
    const T* zr = z + row * V;
    T* dr = dz + row * V;
    const float m = mx[row], s = sumexp[row], gr = g[row];
    const float rs = __frcp_rn(s);
    const int64_t lab = labels[row] - lab_off;  // the label's column
    auto one = [&](int col) {
      dr[col] = from_f32<T>(shard_grad(to_f32(zr[col]), m, s, rs,
                                       col == lab ? beta : a, gr));
    };
    if (!same) {
      const int cols = kSplitThreads * kw * E;
      const int end = (cb + 1) * cols < V ? (cb + 1) * cols : V;
      for (int col = cb * cols + threadIdx.x; col < end;
           col += kSplitThreads)
        one(col);
      continue;
    }
    const int ph = static_cast<int>(
        (reinterpret_cast<uintptr_t>(zr) & 15) / sizeof(T));
    const int k0 = cb * kSplitThreads * kw + threadIdx.x;
    uint4 v[W];
#pragma unroll
    for (int j = 0; j < W; ++j) {
      const int c = (k0 + j * kSplitThreads) * E - ph;  // the word's column
      if (j < kw && c >= 0 && c + E <= V)
        v[j] = __ldg(reinterpret_cast<const uint4*>(zr + c));
    }
#pragma unroll
    for (int j = 0; j < W; ++j) {
      const int c = (k0 + j * kSplitThreads) * E - ph;
      if (j < kw && c >= 0 && c + E <= V) {
        const uint32_t x[4] = {v[j].x, v[j].y, v[j].z, v[j].w};
        uint32_t out[4];
        grad_word<T>(x, out, m, s, rs, a, gr);
        if (lab >= c && lab < c + E) {  // the label's element takes beta
          const int i = static_cast<int>(lab - c);
          set_elem<T>(out, i, shard_grad(elem_at<T>(x, i), m, s, rs, beta,
                                         gr));
        }
        *reinterpret_cast<uint4*>(dr + c) =
            make_uint4(out[0], out[1], out[2], out[3]);
      }
    }
    if (cb == 0 && threadIdx.x < 2 * E) {
      // the columns before the first whole word, and after the last
      const int head = ph == 0 ? 0 : (E - ph < V ? E - ph : V);
      const int tail = head + (V - head) / E * E;
      const int col = threadIdx.x < E ? threadIdx.x
                                      : tail + threadIdx.x - E;
      if (threadIdx.x < E ? col < head : col < V) one(col);
    }
  }
}

int elt_of(int dtype) { return dtype == 0 ? 4 : dtype == 1 ? 2 : 0; }

}  // namespace

// The shard [B, V] holding columns [lab_off, lab_off + V) of V_total: per
// row its max, sum exp(z - max), sum z and z_c (0 when the label is not
// in the shard).  `warps` (1, 2, 4 or 8 a row) is the launcher's plan.
extern "C" cudaError_t vt_kl_partial_fwd(const void* z, int dtype,
                                         const int64_t* labels,
                                         int64_t lab_off, int64_t v_total,
                                         float* mx, float* sumexp,
                                         float* zsum, float* zc, int64_t B,
                                         int64_t V, int warps,
                                         cudaStream_t stream) {
  const int elt = elt_of(dtype);
  if (elt == 0 || V < 1 || V * elt > 0x7fffffff || v_total < 2 ||
      lab_off < 0 || lab_off + V > v_total ||
      reinterpret_cast<uintptr_t>(z) % elt ||
      !(warps == 1 || warps == 2 || warps == 4 || warps == 8))
    return cudaErrorInvalidValue;
  if (B <= 0) return cudaSuccess;
  const int rows = kSplitThreads / 32 / warps;
  const int64_t want = (B + rows - 1) / rows;
  const unsigned blocks =
      static_cast<unsigned>(want < kMaxRowBlocks ? want : kMaxRowBlocks);
  const FwdOut o{zsum, mx, sumexp, zc};
  if (dtype == 0)
    vt_partial_kernel<float><<<blocks, kSplitThreads, 0, stream>>>(
        static_cast<const float*>(z), labels, o, B, static_cast<int>(V), warps,
        lab_off, v_total);
  else
    vt_partial_kernel<__nv_bfloat16><<<blocks, kSplitThreads, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(z), labels, o, B,
        static_cast<int>(V), warps, lab_off, v_total);
  return cudaGetLastError();
}

// The backward on the shard's columns: mx / sumexp the combined row
// statistics, a = (1 - beta) / (V_total - 1); `blocks_per_row` CTAs a row
// (the launcher's plan: they must cover the row's 16-byte words).
extern "C" cudaError_t vt_kl_bwd_shard(const void* z, int dtype,
                                       const int64_t* labels, int64_t lab_off,
                                       const float* mx, const float* sumexp,
                                       const float* g, void* dz, int64_t B,
                                       int64_t V, int blocks_per_row,
                                       float beta, float a,
                                       cudaStream_t stream) {
  const int elt = elt_of(dtype);
  const uintptr_t zp = reinterpret_cast<uintptr_t>(z);
  const uintptr_t dp = reinterpret_cast<uintptr_t>(dz);
  const int64_t words = (V * elt + 15) / 16 + 1;  // at any phase
  const int64_t span = static_cast<int64_t>(blocks_per_row) * kSplitThreads;
  if (elt == 0 || V < 1 || V * elt > 0x7fffffff || blocks_per_row < 1 ||
      zp % elt || dp % elt || span * kSplitBwdWords < words)
    return cudaErrorInvalidValue;
  if (B <= 0) return cudaSuccess;
  const int kw = static_cast<int>((words + span - 1) / span);
  const int64_t total = B * blocks_per_row;
  const unsigned blocks =
      static_cast<unsigned>(total < 0x7fffffff ? total : 0x7fffffff);
  const bool same = (zp & 15) == (dp & 15);
  if (dtype == 0)
    vt_bwd_shard_kernel<float><<<blocks, kSplitThreads, 0, stream>>>(
        static_cast<const float*>(z), labels, mx, sumexp, g,
        static_cast<float*>(dz), B, static_cast<int>(V), blocks_per_row, kw,
        beta, a, lab_off, same);
  else
    vt_bwd_shard_kernel<__nv_bfloat16><<<blocks, kSplitThreads, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(z), labels, mx, sumexp, g,
        static_cast<__nv_bfloat16*>(dz), B, static_cast<int>(V),
        blocks_per_row, kw, beta, a, lab_off, same);
  return cudaGetLastError();
}
