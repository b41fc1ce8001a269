// The paper's Eq. 5 (the DecDiff step) over row blocks, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels src/repro/kernels/decdiff_update.py:42
// `sumsq_diff_blocks` and :60 `scaled_step_blocks`, driven by the JAX
// package's `kernels/ops.py:decdiff_update`.  The TPU form updates one
// flat model in two passes with a host scalar between them; the port's
// form is row-batched over a list of leaves, each viewed as [R, D_leaf]
// (row r = one node's model), because both of the port's Eq. 5 sites work
// on [R, ...] blocks: `dist/dfl_step.py:_decdiff_step_from_avg` (the LM
// round, the flat [4, 463987712] block on the fused int8 path) and
// `engine/strategies.py:DecDiffStrategy.flat_aggregate` (the MLP engine).
// For every row r, with x the local model (fp32 or bf16, read as fp32) and
// a the fp32 neighbourhood average:
//
//   pass A   partials[r, blk] = sum over the block's columns of (a - x)^2
//   scale    scale[r] = gate[r] > 0 ? 1 / (sqrt(sum_blk partials) + s) : 0
//            (no gate: always on; the sum in a fixed order)
//   pass B   out[r, :] = x + scale[r] * (a - x), rounded to x's dtype
//
// The split form (`ops.decdiff_rows_split`, the LM round partitioned
// inside each pod) runs pass A on each rank's local shards, over the
// column spans that rank counts (rows `ld` apart), the scale
// kernel to add them into the rank's [R] partial sums, which an
// all-reduce over the pod's (data, model) group sums, then the scale
// kernel again on the reduced [R, 1] sums and pass B on the local shards.
//
// Nothing is read back to the host between the passes, and the [R, D]
// difference and its square, which the unfused form writes, never exist.
// Pass B uses __fsub_rn / __fmul_rn / __fadd_rn and one rounding to bf16,
// the plain version's three fp32 operations and its cast, so for the same
// scale it is bitwise the plain version.  Pass A has no atomics: each
// (row, column block) writes its own partial, the scale kernel adds them
// in index order and every block reduces in a fixed tree, so the norms are
// the same from run to run (not bitwise the plain version's, whose sum
// runs in another order).
//
// What bounds it: HBM bytes.  At the LM round's [4, 463987712] fp32 block
// pass A reads 14.85 GB (4.43 ms at 3.35 TB/s) and pass B reads 14.85 GB
// and writes 7.42 GB (6.65 ms); 3 and 3 flops per element are far below
// the fp32 rate.  Each thread takes 16 elements of its row block, as
// float4 (bf16: 4-wide) loads where D and every pointer allow it, else
// coalesced scalar loads (the MLP's D = 567,434 is 2 mod 4).  Offsets are
// 64-bit.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 16;                       // elements per thread
constexpr int64_t kBlockCols = kThreads * kItems;  // columns per block

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_f32(float y, float* out) { *out = y; }
__device__ __forceinline__ void from_f32(float y, __nv_bfloat16* out) {
  *out = __float2bfloat16_rn(y);
}

template <typename TX, int VW>
__device__ __forceinline__ void load_x(const TX* p, float (&f)[VW]) {
  if constexpr (VW == 1) {
    f[0] = to_f32(*p);
  } else if constexpr (sizeof(TX) == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
  } else {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
    const float2 lo = __bfloat1622float2(h[0]), hi = __bfloat1622float2(h[1]);
    f[0] = lo.x; f[1] = lo.y; f[2] = hi.x; f[3] = hi.y;
  }
}

template <int VW>
__device__ __forceinline__ void load_a(const float* p, float (&f)[VW]) {
  if constexpr (VW == 1) {
    f[0] = *p;
  } else {
    const float4 v = *reinterpret_cast<const float4*>(p);
    f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
  }
}

template <typename TX, int VW>
__device__ __forceinline__ void store_out(TX* p, const float (&f)[VW]) {
  if constexpr (VW == 1) {
    from_f32(f[0], p);
  } else if constexpr (sizeof(TX) == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
  } else {
    __nv_bfloat162 h[2];
    h[0] = __floats2bfloat162_rn(f[0], f[1]);
    h[1] = __floats2bfloat162_rn(f[2], f[3]);
    *reinterpret_cast<uint2*>(p) = *reinterpret_cast<const uint2*>(h);
  }
}

// Sum of v over the block, the same tree every launch; thread 0 gets it.
__device__ __forceinline__ float block_sum(float v) {
  __shared__ float warp_sums[kThreads / 32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < kThreads / 32 ? warp_sums[lane] : 0.0f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  }
  return v;
}

template <typename TX, int VW>
__global__ void __launch_bounds__(kThreads)
sumsq_rows_kernel(const TX* __restrict__ x, const float* __restrict__ a,
                  float* __restrict__ partials, int64_t D, int64_t ldx,
                  int64_t lda, int64_t nb_total, int64_t blk_off) {
  const int64_t r = blockIdx.y;
  const int64_t col0 = static_cast<int64_t>(blockIdx.x) * kBlockCols;
  const TX* xr = x + r * ldx;
  const float* ar = a + r * lda;
  float acc = 0.0f;
#pragma unroll
  for (int i = 0; i < kItems / VW; ++i) {
    const int64_t col = col0 + (static_cast<int64_t>(i) * kThreads +
                                threadIdx.x) * VW;
    if (col < D) {
      float xf[VW], af[VW];
      load_x<TX, VW>(xr + col, xf);
      load_a<VW>(ar + col, af);
#pragma unroll
      for (int j = 0; j < VW; ++j) {
        const float d = __fsub_rn(af[j], xf[j]);
        acc = __fadd_rn(acc, __fmul_rn(d, d));
      }
    }
  }
  acc = block_sum(acc);
  if (threadIdx.x == 0) partials[r * nb_total + blk_off + blockIdx.x] = acc;
}

__global__ void __launch_bounds__(kThreads)
scale_rows_kernel(const float* __restrict__ partials, int64_t nb,
                  const float* __restrict__ gate, float s,
                  float* __restrict__ scale, float* __restrict__ sumsq) {
  const int64_t r = blockIdx.x;
  float acc = 0.0f;
  for (int64_t i = threadIdx.x; i < nb; i += kThreads)
    acc = __fadd_rn(acc, partials[r * nb + i]);
  acc = block_sum(acc);
  if (threadIdx.x == 0) {
    sumsq[r] = acc;
    const bool on = gate == nullptr || gate[r] > 0.0f;
    scale[r] = on ? __fdiv_rn(1.0f, __fadd_rn(sqrtf(acc), s)) : 0.0f;
  }
}

template <typename TX, int VW>
__global__ void __launch_bounds__(kThreads)
step_rows_kernel(const TX* __restrict__ x, const float* __restrict__ a,
                 const float* __restrict__ scale, TX* __restrict__ out,
                 int64_t D) {
  const int64_t r = blockIdx.y;
  const int64_t col0 = static_cast<int64_t>(blockIdx.x) * kBlockCols;
  const float sc = scale[r];
  const TX* xr = x + r * D;
  const float* ar = a + r * D;
  TX* orow = out + r * D;
#pragma unroll
  for (int i = 0; i < kItems / VW; ++i) {
    const int64_t col = col0 + (static_cast<int64_t>(i) * kThreads +
                                threadIdx.x) * VW;
    if (col < D) {
      float xf[VW], af[VW], y[VW];
      load_x<TX, VW>(xr + col, xf);
      load_a<VW>(ar + col, af);
#pragma unroll
      for (int j = 0; j < VW; ++j)
        y[j] = __fadd_rn(xf[j], __fmul_rn(sc, __fsub_rn(af[j], xf[j])));
      store_out<TX, VW>(orow + col, y);
    }
  }
}

int64_t col_blocks(int64_t D) { return (D + kBlockCols - 1) / kBlockCols; }

// 4-wide only where every row start is aligned: D a multiple of 4 and
// each pointer aligned to 4 elements.
bool wide(int64_t D, const void* x, int x_bytes, const void* a,
          const void* out) {
  const uintptr_t xa = reinterpret_cast<uintptr_t>(x);
  const uintptr_t aa = reinterpret_cast<uintptr_t>(a);
  const uintptr_t oa = reinterpret_cast<uintptr_t>(out);
  return D % 4 == 0 && xa % (4 * x_bytes) == 0 && aa % 16 == 0 &&
         oa % (4 * x_bytes) == 0;
}

template <typename TX>
cudaError_t sumsq_launch(const void* x, const float* a, float* partials,
                         int64_t R, int64_t D, int64_t ldx, int64_t lda,
                         int64_t nb_total, int64_t blk_off,
                         cudaStream_t stream) {
  dim3 grid(static_cast<unsigned>(col_blocks(D)), static_cast<unsigned>(R));
  const TX* xt = static_cast<const TX*>(x);
  if (wide(D, x, sizeof(TX), a, a) && ldx % 4 == 0 && lda % 4 == 0)
    sumsq_rows_kernel<TX, 4><<<grid, kThreads, 0, stream>>>(
        xt, a, partials, D, ldx, lda, nb_total, blk_off);
  else
    sumsq_rows_kernel<TX, 1><<<grid, kThreads, 0, stream>>>(
        xt, a, partials, D, ldx, lda, nb_total, blk_off);
  return cudaGetLastError();
}

template <typename TX>
cudaError_t step_launch(const void* x, const float* a, const float* scale,
                        void* out, int64_t R, int64_t D,
                        cudaStream_t stream) {
  dim3 grid(static_cast<unsigned>(col_blocks(D)), static_cast<unsigned>(R));
  const TX* xt = static_cast<const TX*>(x);
  TX* ot = static_cast<TX*>(out);
  if (wide(D, x, sizeof(TX), a, out))
    step_rows_kernel<TX, 4><<<grid, kThreads, 0, stream>>>(xt, a, scale, ot,
                                                           D);
  else
    step_rows_kernel<TX, 1><<<grid, kThreads, 0, stream>>>(xt, a, scale, ot,
                                                           D);
  return cudaGetLastError();
}

bool bad_grid(int64_t R, int64_t D) {
  return R > 65535 || col_blocks(D) > 0x7fffffff;
}

}  // namespace

// The number of column blocks pass A writes for a leaf of D columns.
extern "C" int64_t decdiff_col_blocks(int64_t D) { return col_blocks(D); }

// Pass A for one leaf or column span: D columns of R rows of x (x_bf16:
// bf16, else fp32) and of a (fp32), the rows ldx and lda elements apart
// (the leaf's own width, or a wider row of which the span is part: the
// split norm of `ops.decdiff_rows_split` sums only the columns a rank
// counts); writes partials[r, blk_off : blk_off + decdiff_col_blocks(D)]
// of the [R, nb_total] buffer.
extern "C" cudaError_t decdiff_sumsq_rows(const void* x, int x_bf16,
                                          const float* a, float* partials,
                                          int64_t R, int64_t D, int64_t ldx,
                                          int64_t lda, int64_t nb_total,
                                          int64_t blk_off,
                                          cudaStream_t stream) {
  if (R <= 0 || D <= 0) return cudaSuccess;
  if (bad_grid(R, D) || blk_off + col_blocks(D) > nb_total || ldx < D ||
      lda < D)
    return cudaErrorInvalidValue;
  return x_bf16 ? sumsq_launch<__nv_bfloat16>(x, a, partials, R, D, ldx,
                                              lda, nb_total, blk_off, stream)
                : sumsq_launch<float>(x, a, partials, R, D, ldx, lda,
                                      nb_total, blk_off, stream);
}

// The per-row scale from the [R, nb] partials; gate may be null (always
// on).  sumsq [R] receives each row's sum of squares.
extern "C" cudaError_t decdiff_scale_rows(const float* partials, int64_t R,
                                          int64_t nb, const float* gate,
                                          float s, float* scale, float* sumsq,
                                          cudaStream_t stream) {
  if (R <= 0) return cudaSuccess;
  if (R > 0x7fffffff) return cudaErrorInvalidValue;
  scale_rows_kernel<<<static_cast<unsigned>(R), kThreads, 0, stream>>>(
      partials, nb, gate, s, scale, sumsq);
  return cudaGetLastError();
}

// Pass B for one leaf: out [R, D] in x's dtype.
extern "C" cudaError_t decdiff_step_rows(const void* x, int x_bf16,
                                         const float* a, const float* scale,
                                         void* out, int64_t R, int64_t D,
                                         cudaStream_t stream) {
  if (R <= 0 || D <= 0) return cudaSuccess;
  if (bad_grid(R, D)) return cudaErrorInvalidValue;
  return x_bf16 ? step_launch<__nv_bfloat16>(x, a, scale, out, R, D, stream)
                : step_launch<float>(x, a, scale, out, R, D, stream);
}
