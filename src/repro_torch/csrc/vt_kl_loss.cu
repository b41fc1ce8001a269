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
// reads them again and writes as many.  It does one expf per logit (and a
// division in the backward), below the fp32 rate at these sizes.
//
// Design, simple first.  Forward: one block of kFwdThreads per row; each
// thread walks the row in 16-byte vectors (8 bf16 or 4 fp32; scalars when
// V or the base pointer does not allow it) and keeps (max, sum exp(z -
// max), sum z) with a running max, rescaling its sum once per vector;
// the block combines the threads' triples with warp shuffles and shared
// memory, and thread 0 reads z_c (trapping on a label outside [0, V)) and
// writes the row's KL, max and sum.  Backward: a 2-D grid of (vector
// chunk, row) blocks, one vector per thread, one expf and one division
// per logit, rounded once to the output dtype.  Sums are taken in another
// order than the plain PyTorch version's, so the two agree to fp32
// rounding, not bit for bit.  Offsets are 64-bit.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kFwdThreads = 512;
constexpr int kBwdThreads = 256;

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

struct Stats {
  float m;  // running max
  float s;  // sum of exp(z - m)
  float z;  // sum of z
};

__device__ __forceinline__ Stats combine(const Stats& a, const Stats& b) {
  const float m = fmaxf(a.m, b.m);
  // a side that has seen no logit has m = -inf and s = 0
  const float sa = a.m == -INFINITY ? 0.0f : a.s * expf(a.m - m);
  const float sb = b.m == -INFINITY ? 0.0f : b.s * expf(b.m - m);
  return {m, sa + sb, a.z + b.z};
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kFwdThreads)
vt_fwd_kernel(const T* __restrict__ z, const int64_t* __restrict__ labels,
              float* __restrict__ kl, float* __restrict__ mx,
              float* __restrict__ sumexp, int64_t B, int64_t V, float beta,
              float a, float neg_h) {
  __shared__ Stats warp_stats[kFwdThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t nvec = V / VEC;
  for (int64_t row = blockIdx.x; row < B; row += gridDim.x) {
    const T* zr = z + row * V;
    Stats st{-INFINITY, 0.0f, 0.0f};
    for (int64_t i = threadIdx.x; i < nvec; i += kFwdThreads) {
      const Pack<T, VEC> p =
          *reinterpret_cast<const Pack<T, VEC>*>(zr + i * VEC);
      float f[VEC];
      float lm = -INFINITY;
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        f[j] = to_f32(p.v[j]);
        lm = fmaxf(lm, f[j]);
        st.z += f[j];
      }
      const float m = fmaxf(st.m, lm);
      float s = st.m == -INFINITY ? 0.0f : st.s * expf(st.m - m);
#pragma unroll
      for (int j = 0; j < VEC; ++j) s += expf(f[j] - m);
      st.m = m;
      st.s = s;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const Stats o{__shfl_xor_sync(0xffffffffu, st.m, off),
                    __shfl_xor_sync(0xffffffffu, st.s, off),
                    __shfl_xor_sync(0xffffffffu, st.z, off)};
      st = combine(st, o);
    }
    if (lane == 0) warp_stats[warp] = st;
    __syncthreads();
    if (threadIdx.x == 0) {
      Stats t = warp_stats[0];
      for (int w = 1; w < kFwdThreads / 32; ++w) t = combine(t, warp_stats[w]);
      const int64_t lab = labels[row];
      if (lab < 0 || lab >= V) __trap();
      const float zc = to_f32(zr[lab]);
      const float lse = __fadd_rn(logf(t.s), t.m);
      // beta*z_c + a*(sum z - z_c) - lse, one rounding per operation
      const float cross = __fsub_rn(
          __fadd_rn(__fmul_rn(beta, zc), __fmul_rn(a, __fsub_rn(t.z, zc))),
          lse);
      kl[row] = __fsub_rn(neg_h, cross);
      mx[row] = t.m;
      sumexp[row] = t.s;
    }
    __syncthreads();  // warp_stats is rewritten for the next row
  }
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kBwdThreads)
vt_bwd_kernel(const T* __restrict__ z, const int64_t* __restrict__ labels,
              const float* __restrict__ mx, const float* __restrict__ sumexp,
              const float* __restrict__ g, T* __restrict__ dz, int64_t B,
              int64_t V, float beta, float a) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kBwdThreads
                    + threadIdx.x;
  if (i >= V / VEC) return;
  for (int64_t row = blockIdx.y; row < B; row += gridDim.y) {
    const float m = mx[row], s = sumexp[row], gr = g[row];
    const int64_t lab = labels[row];
    const Pack<T, VEC> p =
        *reinterpret_cast<const Pack<T, VEC>*>(z + row * V + i * VEC);
    Pack<T, VEC> out;
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const float prob = __fdiv_rn(expf(__fsub_rn(to_f32(p.v[j]), m)), s);
      const float pt = (i * VEC + j == lab) ? beta : a;
      out.v[j] = from_f32<T>(__fmul_rn(__fsub_rn(prob, pt), gr));
    }
    *reinterpret_cast<Pack<T, VEC>*>(dz + row * V + i * VEC) = out;
  }
}

template <typename T, int VEC>
cudaError_t launch_fwd(const void* z, const int64_t* labels, float* kl,
                       float* mx, float* sumexp, int64_t B, int64_t V,
                       float beta, float a, float neg_h, cudaStream_t stream) {
  const int64_t blocks = B < (1 << 20) ? B : (1 << 20);
  vt_fwd_kernel<T, VEC><<<static_cast<unsigned>(blocks), kFwdThreads, 0,
                          stream>>>(static_cast<const T*>(z), labels, kl, mx,
                                    sumexp, B, V, beta, a, neg_h);
  return cudaGetLastError();
}

template <typename T, int VEC>
cudaError_t launch_bwd(const void* z, const int64_t* labels, const float* mx,
                       const float* sumexp, const float* g, void* dz,
                       int64_t B, int64_t V, float beta, float a,
                       cudaStream_t stream) {
  const int64_t nvec = V / VEC;
  const int64_t col_blocks = (nvec + kBwdThreads - 1) / kBwdThreads;
  if (col_blocks > 0x7fffffff) return cudaErrorInvalidValue;
  const int64_t row_blocks = B < 65535 ? B : 65535;
  dim3 grid(static_cast<unsigned>(col_blocks),
            static_cast<unsigned>(row_blocks));
  vt_bwd_kernel<T, VEC><<<grid, kBwdThreads, 0, stream>>>(
      static_cast<const T*>(z), labels, mx, sumexp, g, static_cast<T*>(dz), B,
      V, beta, a);
  return cudaGetLastError();
}

// 16-byte vectors when V and every row pointer allow them, else scalars.
template <typename T>
bool vectorizable(int64_t V, uintptr_t align) {
  return V % (16 / sizeof(T)) == 0 && align % 16 == 0;
}

}  // namespace

// dtype: 0 = float32 logits, 1 = bfloat16 logits.
extern "C" cudaError_t vt_kl_fwd(const void* z, int dtype,
                                 const int64_t* labels, float* kl, float* mx,
                                 float* sumexp, int64_t B, int64_t V,
                                 float beta, float a, float neg_h,
                                 cudaStream_t stream) {
  if (B <= 0) return cudaSuccess;
  if (V < 2) return cudaErrorInvalidValue;
  const uintptr_t al = reinterpret_cast<uintptr_t>(z);
  if (dtype == 0)
    return vectorizable<float>(V, al)
               ? launch_fwd<float, 4>(z, labels, kl, mx, sumexp, B, V, beta,
                                      a, neg_h, stream)
               : launch_fwd<float, 1>(z, labels, kl, mx, sumexp, B, V, beta,
                                      a, neg_h, stream);
  if (dtype == 1)
    return vectorizable<__nv_bfloat16>(V, al)
               ? launch_fwd<__nv_bfloat16, 8>(z, labels, kl, mx, sumexp, B, V,
                                              beta, a, neg_h, stream)
               : launch_fwd<__nv_bfloat16, 1>(z, labels, kl, mx, sumexp, B, V,
                                              beta, a, neg_h, stream);
  return cudaErrorInvalidValue;
}

extern "C" cudaError_t vt_kl_bwd(const void* z, int dtype,
                                 const int64_t* labels, const float* mx,
                                 const float* sumexp, const float* g,
                                 void* dz, int64_t B, int64_t V, float beta,
                                 float a, cudaStream_t stream) {
  if (B <= 0) return cudaSuccess;
  if (V < 2) return cudaErrorInvalidValue;
  const uintptr_t al = reinterpret_cast<uintptr_t>(z)
                       | reinterpret_cast<uintptr_t>(dz);
  if (dtype == 0)
    return vectorizable<float>(V, al)
               ? launch_bwd<float, 4>(z, labels, mx, sumexp, g, dz, B, V,
                                      beta, a, stream)
               : launch_bwd<float, 1>(z, labels, mx, sumexp, g, dz, B, V,
                                      beta, a, stream);
  if (dtype == 1)
    return vectorizable<__nv_bfloat16>(V, al)
               ? launch_bwd<__nv_bfloat16, 8>(z, labels, mx, sumexp, g, dz, B,
                                              V, beta, a, stream)
               : launch_bwd<__nv_bfloat16, 1>(z, labels, mx, sumexp, g, dz, B,
                                              V, beta, a, stream);
  return cudaErrorInvalidValue;
}
