// Ragged int8 dequantize-and-reduce for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/segment_avg.py:81
// `dequant_segment_avg_chunk` (`_dequant_segment_avg_kernel`), which the
// JAX package's `kernels/ops.py:dequant_segment_neighbor_avg` drives over
// 8-row chunks.  For every receiver row b and column d:
//
//     sums[b, d] = sum_k ws[b, k] * float(q[b, k, d])
//
// q [B, K, D] int8 holds each receiver's slot-padded neighbour payloads,
// ws [B, K] fp32 the gossip weights with the senders' dequantization
// scales folded in (ws = w * scale, formed by the wrapper), sums [B, D]
// fp32.  The dequantized fp32 rows never exist in device memory.  There
// are no totals: the fp32 route's ones column gives those.
//
// Bitwise contract: each receiver row is contracted on its own, over
// k = 0..K-1 in order from +0, as acc = acc + (ws * float(q)) with each
// step rounded on its own (__fmul_rn / __fadd_rn, so nvcc cannot contract
// it into an FMA).  The result is therefore independent of how rows are
// blocked and of how far K is padded with zero-weight slots, whatever
// int8 values those slots hold (a zero weight adds +-0 to an accumulator
// that starts at +0).  The plain PyTorch version in
// kernels/segment_avg.py performs the same operations in the same order,
// so the two agree bit for bit.
//
// What bounds it: HBM bytes.  It reads B*K*D int8 and 4*B*K bytes of
// weights and writes 4*B*D bytes; its 2*B*K*D flops are far below the fp32
// rate (path c's per-node panel [16, 10, 567434]: 127.1 MB, 0.0379 ms at
// 3.35 TB/s).
//
// Design, simple first: each thread owns VW consecutive columns of one row
// (VW = 4 / 2 / 1, the widest that divides D and fits the alignment of q
// and sums, so no row has a ragged tail) and loads q[b, k, d..d+VW) as one
// char4 / char2 / char per slot, neighbouring threads on neighbouring
// addresses.  The weights of the row are a broadcast read that stays in
// L1.  The grid's y walks the rows.  Offsets are 64-bit: B*K*D passes 2^31
// at about 3,800 slots of the 567,434-parameter MLP.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <int VW> struct QVec;
template <> struct QVec<4> { using T = char4; };
template <> struct QVec<2> { using T = char2; };
template <> struct QVec<1> { using T = signed char; };
template <int VW> struct FVec;
template <> struct FVec<4> { using T = float4; };
template <> struct FVec<2> { using T = float2; };
template <> struct FVec<1> { using T = float; };

__device__ __forceinline__ void unpack(char4 v, float (&f)[4]) {
  f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
}
__device__ __forceinline__ void unpack(char2 v, float (&f)[2]) {
  f[0] = v.x; f[1] = v.y;
}
__device__ __forceinline__ void unpack(signed char v, float (&f)[1]) {
  f[0] = v;
}
__device__ __forceinline__ float4 pack(const float (&f)[4]) {
  return make_float4(f[0], f[1], f[2], f[3]);
}
__device__ __forceinline__ float2 pack(const float (&f)[2]) {
  return make_float2(f[0], f[1]);
}
__device__ __forceinline__ float pack(const float (&f)[1]) { return f[0]; }

template <int VW>
__global__ void __launch_bounds__(kThreads)
dequant_segment_avg_kernel(const int8_t* __restrict__ q,
                           const float* __restrict__ ws,
                           float* __restrict__ sums, int64_t B, int64_t K,
                           int64_t D) {
  using QV = typename QVec<VW>::T;
  using FV = typename FVec<VW>::T;
  const int64_t col =
      (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) * VW;
  if (col >= D) return;
  for (int64_t b = blockIdx.y; b < B; b += gridDim.y) {
    const float* wrow = ws + b * K;
    const int8_t* qrow = q + b * K * D + col;
    float acc[VW];
#pragma unroll
    for (int j = 0; j < VW; ++j) acc[j] = 0.0f;
#pragma unroll 4
    for (int64_t k = 0; k < K; ++k) {
      const float wk = __ldg(wrow + k);
      float f[VW];
      unpack(__ldg(reinterpret_cast<const QV*>(qrow + k * D)), f);
#pragma unroll
      for (int j = 0; j < VW; ++j)
        acc[j] = __fadd_rn(acc[j], __fmul_rn(wk, f[j]));
    }
    *reinterpret_cast<FV*>(sums + b * D + col) = pack(acc);
  }
}

template <int VW>
cudaError_t launch(const int8_t* q, const float* ws, float* sums, int64_t B,
                   int64_t K, int64_t D, cudaStream_t stream) {
  const int64_t per_block = static_cast<int64_t>(kThreads) * VW;
  const int64_t col_blocks = (D + per_block - 1) / per_block;
  if (col_blocks > 0x7fffffff) return cudaErrorInvalidValue;
  const int64_t row_blocks = B < 65535 ? B : 65535;
  dim3 grid(static_cast<unsigned>(col_blocks),
            static_cast<unsigned>(row_blocks));
  dequant_segment_avg_kernel<VW><<<grid, kThreads, 0, stream>>>(q, ws, sums,
                                                                B, K, D);
  return cudaGetLastError();
}

}  // namespace

extern "C" cudaError_t dequant_segment_avg_f32(const int8_t* q,
                                               const float* ws, float* sums,
                                               int64_t B, int64_t K,
                                               int64_t D,
                                               cudaStream_t stream) {
  if (B <= 0 || D <= 0) return cudaSuccess;
  if (K <= 0) return cudaMemsetAsync(sums, 0, sizeof(float) * B * D, stream);
  const uintptr_t qa = reinterpret_cast<uintptr_t>(q);
  const uintptr_t sa = reinterpret_cast<uintptr_t>(sums);
  if (D % 4 == 0 && qa % 4 == 0 && sa % 16 == 0)
    return launch<4>(q, ws, sums, B, K, D, stream);
  if (D % 2 == 0 && qa % 2 == 0 && sa % 8 == 0)
    return launch<2>(q, ws, sums, B, K, D, stream);
  return launch<1>(q, ws, sums, B, K, D, stream);
}
