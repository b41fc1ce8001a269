// Fused int8 dequantize + weighted neighbour average for one receiver,
// for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/dequant_avg.py:42
// `dequant_avg_blocks` (`_dequant_avg_kernel`), driven by the JAX
// package's `kernels/ops.py:dequant_neighbor_avg`.  For every column d:
//
//     out[d] = sum_n ws[n] * float(q[n, d])
//
// q [N, D] int8 holds the neighbours' wire payloads, ws [N] fp32 the
// normalized gossip weights with the senders' dequantization scales folded
// in (ws = (w / sum(w)) * scale, formed by the wrapper), out [D] fp32 the
// Eq. 6 average.  The dequantized fp32 models never exist in device
// memory.
//
// Order: the senders add in the order of dequant_avg_rows.cu (the
// multi-receiver kernel), n = 0..N-1 from +0, each step a separate
// multiply and add (__fmul_rn / __fadd_rn, never contracted into an FMA).
// So this average is bitwise row r of that kernel whenever the weights
// equal its row r, and bitwise the plain version in
// kernels/dequant_avg.py, which loops over n with `acc = acc + ws[n] *
// q[n].float()`.
//
// What bounds it: HBM bytes.  It reads N*D int8 and 4*N bytes of weights
// and writes 4*D bytes; its 2*N*D flops are far below the fp32 rate (path
// d's int8 gossip block [4, 463987712]: 3.712 GB, 1.108 ms at 3.35 TB/s).
//
// Design, simple first: each thread owns VW consecutive columns (VW = 8 /
// 4 / 2 / 1, the widest that divides D and fits the alignment of q and
// out, so no row has a ragged tail) and loads q[n, d..d+VW) once per
// sender as one 8-, 4-, 2- or 1-byte word, neighbouring threads on
// neighbouring addresses; the sender loop is unrolled by 4, so four
// senders' loads are in flight together.  The block stages ws in shared
// memory, kNChunk senders at a time, so any N works.  Offsets are 64-bit:
// N*D passes 2^31 at 5 x 463,987,712.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kNChunk = 1024;  // senders' weights staged at a time

template <int VW> struct QVec;
template <> struct QVec<8> { using T = uint2; };
template <> struct QVec<4> { using T = char4; };
template <> struct QVec<2> { using T = char2; };
template <> struct QVec<1> { using T = signed char; };

__device__ __forceinline__ float byte_at(unsigned word, int i) {
  return static_cast<float>(
      static_cast<signed char>((word >> (8 * i)) & 0xffu));
}
__device__ __forceinline__ void unpack(uint2 v, float (&f)[8]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[i] = byte_at(v.x, i);
    f[4 + i] = byte_at(v.y, i);
  }
}
__device__ __forceinline__ void unpack(char4 v, float (&f)[4]) {
  f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
}
__device__ __forceinline__ void unpack(char2 v, float (&f)[2]) {
  f[0] = v.x; f[1] = v.y;
}
__device__ __forceinline__ void unpack(signed char v, float (&f)[1]) {
  f[0] = v;
}

__device__ __forceinline__ void store(float* p, const float (&f)[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(f[0], f[1], f[2], f[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(f[4], f[5], f[6], f[7]);
}
__device__ __forceinline__ void store(float* p, const float (&f)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
}
__device__ __forceinline__ void store(float* p, const float (&f)[2]) {
  *reinterpret_cast<float2*>(p) = make_float2(f[0], f[1]);
}
__device__ __forceinline__ void store(float* p, const float (&f)[1]) {
  *p = f[0];
}

template <int VW>
__global__ void __launch_bounds__(kThreads)
dequant_avg_kernel(const int8_t* __restrict__ q, const float* __restrict__ ws,
                   float* __restrict__ out, int64_t N, int64_t D) {
  using QV = typename QVec<VW>::T;
  __shared__ float sws[kNChunk];
  const int64_t col =
      (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) * VW;
  const bool live = col < D;
  float acc[VW];
#pragma unroll
  for (int j = 0; j < VW; ++j) acc[j] = 0.0f;

  for (int64_t n0 = 0; n0 < N; n0 += kNChunk) {
    const int nc = static_cast<int>(N - n0 < kNChunk ? N - n0 : kNChunk);
    __syncthreads();  // the previous chunk's weights are no longer read
    for (int i = threadIdx.x; i < nc; i += kThreads) sws[i] = ws[n0 + i];
    __syncthreads();
    if (live) {
      const int8_t* qp = q + n0 * D + col;
#pragma unroll 4
      for (int n = 0; n < nc; ++n) {
        float f[VW];
        unpack(__ldg(reinterpret_cast<const QV*>(qp + n * D)), f);
        const float w = sws[n];
#pragma unroll
        for (int j = 0; j < VW; ++j)
          acc[j] = __fadd_rn(acc[j], __fmul_rn(w, f[j]));
      }
    }
  }
  if (live) store(out + col, acc);
}

template <int VW>
cudaError_t launch(const int8_t* q, const float* ws, float* out, int64_t N,
                   int64_t D, cudaStream_t stream) {
  const int64_t per_block = static_cast<int64_t>(kThreads) * VW;
  const int64_t blocks = (D + per_block - 1) / per_block;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  dequant_avg_kernel<VW><<<static_cast<unsigned>(blocks), kThreads, 0,
                           stream>>>(q, ws, out, N, D);
  return cudaGetLastError();
}

}  // namespace

extern "C" cudaError_t dequant_avg_f32(const int8_t* q, const float* ws,
                                       float* out, int64_t N, int64_t D,
                                       cudaStream_t stream) {
  if (D <= 0) return cudaSuccess;
  if (N <= 0) return cudaMemsetAsync(out, 0, sizeof(float) * D, stream);
  const uintptr_t qa = reinterpret_cast<uintptr_t>(q);
  const uintptr_t oa = reinterpret_cast<uintptr_t>(out);
  if (D % 8 == 0 && qa % 8 == 0 && oa % 16 == 0)
    return launch<8>(q, ws, out, N, D, stream);
  if (D % 4 == 0 && qa % 4 == 0 && oa % 16 == 0)
    return launch<4>(q, ws, out, N, D, stream);
  if (D % 2 == 0 && qa % 2 == 0 && oa % 8 == 0)
    return launch<2>(q, ws, out, N, D, stream);
  return launch<1>(q, ws, out, N, D, stream);
}
