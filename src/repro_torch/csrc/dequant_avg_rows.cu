// Fused int8 dequantize + weighted neighbour average for a block of
// receivers, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/dequant_avg.py:79
// `dequant_avg_rows_blocks` (`_dequant_avg_rows_kernel`), driven by the JAX
// package's `kernels/ops.py:dequant_neighbor_avg_rows` from the fused int8
// DFL pod round (`dist/dfl_step.py:fused_block`).  For every receiver r and
// column d:
//
//     out[r, d] = sum_n ws[r, n] * float(q[n, d])
//
// q [N, D] int8 is the nodes' wire payload, ws [R, N] fp32 the
// row-normalized gossip weights with the senders' dequantization scales
// folded in (ws = wn * scale[None, :], built by the wrapper), out [R, D]
// fp32 the Eq. 6 averages.  The dequantized fp32 models never exist in
// device memory.
//
// What bounds it: HBM bytes.  It reads N*D int8 once and writes R*D fp32
// once (the qwen1.5-0.5b pod round: 1.856 GB read, 7.424 GB written,
// 2.77 ms at 3.35 TB/s); its 2*R*N*D flops are far below the fp32 rate.
//
// Design, simple first: each thread owns VW consecutive columns and a
// block of up to kRB receivers (grid y walks further receiver blocks).  It
// loads each q[n, d..d+VW) once, as one char4 / char2 / char (the sender
// loop is unrolled by 4, so four senders' loads are in flight together),
// and accumulates all of its receivers in n order from +0 with a separate
// multiply and add (__fmul_rn / __fadd_rn, never fused), so the result is
// bitwise equal to the plain version that loops over n with
// `acc = acc + ws[:, n:n+1] * q[n].float()`.  The block's ws rows sit in
// shared memory, kNChunk senders at a time.  An all-zero ws row gives an
// all-zero average.  VW is the widest of 4 / 2 / 1 that divides D and fits
// the alignment of q and out, so no row has a ragged tail (an odd D takes
// scalar loads).  Offsets are 64-bit: N*D and R*D pass 2^31 / 4 at the
// model's D = 463,987,712.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRB = 8;        // receivers per block
constexpr int kNChunk = 512;  // senders staged in shared memory at a time

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
dequant_avg_rows_kernel(const int8_t* __restrict__ q,
                        const float* __restrict__ ws, float* __restrict__ out,
                        int64_t N, int64_t R, int64_t D) {
  using QV = typename QVec<VW>::T;
  using FV = typename FVec<VW>::T;
  __shared__ float sws[kRB * kNChunk];
  const int64_t r0 = static_cast<int64_t>(blockIdx.y) * kRB;
  const int rb = static_cast<int>(R - r0 < kRB ? R - r0 : kRB);
  const int64_t col =
      (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) * VW;
  const bool live = col < D;
  float acc[kRB][VW];
#pragma unroll
  for (int r = 0; r < kRB; ++r)
#pragma unroll
    for (int j = 0; j < VW; ++j) acc[r][j] = 0.0f;

  for (int64_t n0 = 0; n0 < N; n0 += kNChunk) {
    const int nc = static_cast<int>(N - n0 < kNChunk ? N - n0 : kNChunk);
    __syncthreads();  // the previous chunk's weights are no longer read
    for (int i = threadIdx.x; i < rb * nc; i += kThreads) {
      const int r = i / nc, n = i - r * nc;
      sws[r * kNChunk + n] = ws[(r0 + r) * N + n0 + n];
    }
    __syncthreads();
    if (live) {
#pragma unroll 4
      for (int n = 0; n < nc; ++n) {
        float f[VW];
        unpack(__ldg(reinterpret_cast<const QV*>(q + (n0 + n) * D + col)),
               f);
#pragma unroll
        for (int r = 0; r < kRB; ++r) {
          if (r < rb) {
            const float w = sws[r * kNChunk + n];
#pragma unroll
            for (int j = 0; j < VW; ++j)
              acc[r][j] = __fadd_rn(acc[r][j], __fmul_rn(w, f[j]));
          }
        }
      }
    }
  }
  if (!live) return;
#pragma unroll
  for (int r = 0; r < kRB; ++r) {
    if (r < rb)
      *reinterpret_cast<FV*>(out + (r0 + r) * D + col) = pack(acc[r]);
  }
}

template <int VW>
cudaError_t launch(const int8_t* q, const float* ws, float* out, int64_t N,
                   int64_t R, int64_t D, cudaStream_t stream) {
  const int64_t per_block = static_cast<int64_t>(kThreads) * VW;
  const int64_t col_blocks = (D + per_block - 1) / per_block;
  const int64_t row_blocks = (R + kRB - 1) / kRB;
  if (col_blocks > 0x7fffffff || row_blocks > 65535)
    return cudaErrorInvalidValue;
  dim3 grid(static_cast<unsigned>(col_blocks),
            static_cast<unsigned>(row_blocks));
  dequant_avg_rows_kernel<VW><<<grid, kThreads, 0, stream>>>(q, ws, out, N,
                                                             R, D);
  return cudaGetLastError();
}

}  // namespace

extern "C" cudaError_t dequant_avg_rows_f32(const int8_t* q, const float* ws,
                                            float* out, int64_t N, int64_t R,
                                            int64_t D, cudaStream_t stream) {
  if (R <= 0 || D <= 0) return cudaSuccess;
  if (N <= 0) return cudaMemsetAsync(out, 0, sizeof(float) * R * D, stream);
  const uintptr_t qa = reinterpret_cast<uintptr_t>(q);
  const uintptr_t oa = reinterpret_cast<uintptr_t>(out);
  if (D % 4 == 0 && qa % 4 == 0 && oa % 16 == 0)
    return launch<4>(q, ws, out, N, R, D, stream);
  if (D % 2 == 0 && qa % 2 == 0 && oa % 8 == 0)
    return launch<2>(q, ws, out, N, R, D, stream);
  return launch<1>(q, ws, out, N, R, D, stream);
}
