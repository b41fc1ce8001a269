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
// shard holding the columns [off, off + V) of V_total): `vt_kl_partial_fwd`
// runs the same forward plans but writes the row's partial statistics
// instead of the KL -- max, sum exp(z - max), sum z and z_c when the
// label falls in the shard (0 otherwise; a label outside [0, V_total)
// traps) -- which the caller combines with an all-reduce over the shards
// (the max first, then the rescaled sums: the reference's row_max ->
// row_stats split with a reduction in between); `vt_kl_bwd_shard` is the
// backward on the local columns, from the combined max and sum and the
// global a, the label located by the shard's offset.
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

// The shard [B, V] holding columns [lab_off, lab_off + V) of V_total: per
// row its max, sum exp(z - max), sum z and z_c (0 when the label is not
// in the shard).
extern "C" cudaError_t vt_kl_partial_fwd(const void* z, int dtype,
                                         const int64_t* labels,
                                         int64_t lab_off, int64_t v_total,
                                         float* mx, float* sumexp,
                                         float* zsum, float* zc, int64_t B,
                                         int64_t V, int vec_bytes, int lanes,
                                         int rows_per_block,
                                         cudaStream_t stream) {
  if (v_total < 2 || lab_off < 0 || lab_off + V > v_total)
    return cudaErrorInvalidValue;
  return fwd_any(z, dtype, labels, FwdOut{zsum, mx, sumexp, zc}, B, V,
                 vec_bytes, lanes, rows_per_block, 0.0f, 0.0f, 0.0f, true,
                 lab_off, v_total, stream);
}

// The backward on the shard's columns: mx / sumexp the combined row
// statistics, a = (1 - beta) / (V_total - 1).
extern "C" cudaError_t vt_kl_bwd_shard(const void* z, int dtype,
                                       const int64_t* labels, int64_t lab_off,
                                       const float* mx, const float* sumexp,
                                       const float* g, void* dz, int64_t B,
                                       int64_t V, int vec_bytes, float beta,
                                       float a, cudaStream_t stream) {
  return bwd_any(z, dtype, labels, mx, sumexp, g, dz, B, V, vec_bytes, beta,
                 a, lab_off, stream);
}
