// Weighted neighbour-model average for one receiver (the paper's Eq. 6),
// for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/neighbor_avg.py:32
// `neighbor_avg_blocks` (`_avg_kernel`), driven by the JAX package's
// `kernels/ops.py:neighbor_avg`, whose formula (w / sum(w), then a
// contraction over the stacked rows) is also that of
// `core/aggregation.py:fedavg_aggregate` (the FedAvg server) and
// `core/decdiff.py:neighborhood_average` (Eq. 6).  For every column d:
//
//     out[d] = sum_n w[n] * x[n, d]        x [N, D] fp32, w [N] fp32
//
// w is already normalized by the wrapper (or by a caller that gates a
// zero total itself), so the kernel is a pure weighted sum.
//
// What bounds it: HBM bytes.  It reads 4*N*D + 4*N bytes and writes 4*D;
// its 2*N*D flops are 0.5 per byte, far below the card's balance point
// (path f's FedAvg over 16 x 567,434 params: 38.6 MB, 0.0115 ms at
// 3.35 TB/s, so launch-bound; 4 x 463,987,712 params: 9.28 GB, 2.77 ms).
//
// Design, simple first: each thread owns VW consecutive columns (VW = 4 /
// 2 / 1, the widest that divides D and fits the alignment of x and out,
// so no row has a ragged tail) and reads x[n, d..d+VW) once per sender as
// one float4 / float2 / float, neighbouring threads on neighbouring
// addresses.  The sender loop is unrolled by 4, so four senders' loads
// are in flight together.  The block stages w in shared memory, kNChunk
// senders at a time, so any N works.  Each column accumulates over n in
// order from +0 with a separate multiply and add (__fmul_rn / __fadd_rn,
// never contracted into an FMA): the plain version's `acc = acc + w[n] *
// x[n]` in its order, so the two agree bit for bit.  No TMA, shared-memory
// tiles or tensor cores: every x element is used once.  Offsets are
// 64-bit: N*D passes 2^31 at 16 x 463,987,712.  There is no column
// padding: the TPU's 2048-column tile has no counterpart here.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kNChunk = 1024;  // senders' weights staged at a time

template <int VW> struct FVec;
template <> struct FVec<4> { using T = float4; };
template <> struct FVec<2> { using T = float2; };
template <> struct FVec<1> { using T = float; };

__device__ __forceinline__ void unpack(float4 v, float (&f)[4]) {
  f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
}
__device__ __forceinline__ void unpack(float2 v, float (&f)[2]) {
  f[0] = v.x; f[1] = v.y;
}
__device__ __forceinline__ void unpack(float v, float (&f)[1]) { f[0] = v; }
__device__ __forceinline__ float4 pack(const float (&f)[4]) {
  return make_float4(f[0], f[1], f[2], f[3]);
}
__device__ __forceinline__ float2 pack(const float (&f)[2]) {
  return make_float2(f[0], f[1]);
}
__device__ __forceinline__ float pack(const float (&f)[1]) { return f[0]; }

template <int VW>
__global__ void __launch_bounds__(kThreads)
neighbor_avg_kernel(const float* __restrict__ x, const float* __restrict__ w,
                    float* __restrict__ out, int64_t N, int64_t D) {
  using FV = typename FVec<VW>::T;
  __shared__ float sw[kNChunk];
  const int64_t col =
      (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) * VW;
  const bool live = col < D;
  float acc[VW];
#pragma unroll
  for (int j = 0; j < VW; ++j) acc[j] = 0.0f;

  for (int64_t n0 = 0; n0 < N; n0 += kNChunk) {
    const int nc = static_cast<int>(N - n0 < kNChunk ? N - n0 : kNChunk);
    __syncthreads();  // the previous chunk's weights are no longer read
    for (int i = threadIdx.x; i < nc; i += kThreads) sw[i] = w[n0 + i];
    __syncthreads();
    if (live) {
      const float* xp = x + n0 * D + col;
#pragma unroll 4
      for (int n = 0; n < nc; ++n) {
        float f[VW];
        unpack(__ldg(reinterpret_cast<const FV*>(xp + n * D)), f);
        const float wn = sw[n];
#pragma unroll
        for (int j = 0; j < VW; ++j)
          acc[j] = __fadd_rn(acc[j], __fmul_rn(wn, f[j]));
      }
    }
  }
  if (live) *reinterpret_cast<FV*>(out + col) = pack(acc);
}

template <int VW>
cudaError_t launch(const float* x, const float* w, float* out, int64_t N,
                   int64_t D, cudaStream_t stream) {
  const int64_t per_block = static_cast<int64_t>(kThreads) * VW;
  const int64_t blocks = (D + per_block - 1) / per_block;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  neighbor_avg_kernel<VW><<<static_cast<unsigned>(blocks), kThreads, 0,
                            stream>>>(x, w, out, N, D);
  return cudaGetLastError();
}

}  // namespace

extern "C" cudaError_t neighbor_avg_f32(const float* x, const float* w,
                                        float* out, int64_t N, int64_t D,
                                        cudaStream_t stream) {
  if (D <= 0) return cudaSuccess;
  if (N <= 0) return cudaMemsetAsync(out, 0, sizeof(float) * D, stream);
  const uintptr_t xa = reinterpret_cast<uintptr_t>(x);
  const uintptr_t oa = reinterpret_cast<uintptr_t>(out);
  if (D % 4 == 0 && xa % 16 == 0 && oa % 16 == 0)
    return launch<4>(x, w, out, N, D, stream);
  if (D % 2 == 0 && xa % 8 == 0 && oa % 8 == 0)
    return launch<2>(x, w, out, N, D, stream);
  return launch<1>(x, w, out, N, D, stream);
}
