// Ragged segment neighbour reduce for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/segment_avg.py:34
// `_segment_avg_kernel`, launched by `segment_avg_chunk` (:58), which the
// JAX package's `kernels/ops.py:segment_neighbor_avg` drives over 8-row
// chunks.  For every receiver row b:
//
//     sums[b, d] = sum_k w[b, k] * vals[b, k, d]        vals [B, K, D] fp32
//     tot[b]     = sum_k w[b, k]                        w    [B, K]    fp32
//
// Bitwise contract (kept from the reference): the result does not depend
// on how rows are blocked, on how far K is zero-padded, or on how columns
// are tiled, and a zero-weight slot is neutral even when it holds finite
// garbage.  One thread owns one (b, d) output and accumulates over
// k = 0..K-1 in order as acc = acc + (w * v), each step rounded on its own
// (__fmul_rn / __fadd_rn, so nvcc cannot contract it into an FMA).  The
// plain PyTorch version in kernels/segment_avg.py performs the same
// operations in the same order, so the two agree bit for bit.  The total
// comes out of the same ordered loop over w; the thread of column 0 stores
// it.  A zero weight adds +-0 to an accumulator that starts at +0, which
// leaves it unchanged.
//
// What bounds it: HBM bytes.  The kernel reads 4*B*K*D + 4*B*K bytes and
// writes 4*B*D + 4*B; it does 2 flops per 4 bytes read, far below the
// card's balance point.  The design reads every vals element exactly once,
// neighbouring threads on neighbouring d (coalesced 128-byte lines per
// warp), keeps the accumulator in a register, and reads w[b, :] as a
// broadcast that stays in L1.  Offsets are 64-bit: B*K*D passes 2^31 at
// about 380 nodes of the 567,434-parameter MNIST MLP.  No shared memory,
// TMA or tensor cores: there is no reuse for them to exploit.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
segment_avg_kernel(const float* __restrict__ vals, const float* __restrict__ w,
                   float* __restrict__ sums, float* __restrict__ tot,
                   int64_t B, int64_t K, int64_t D) {
  const int64_t d = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const bool active = d < D;
  for (int64_t b = blockIdx.y; b < B; b += gridDim.y) {
    const float* wrow = w + b * K;
    const float* vrow = vals + b * K * D + d;
    float acc = 0.0f;
    float wsum = 0.0f;
#pragma unroll 4
    for (int64_t k = 0; k < K; ++k) {
      const float wk = __ldg(wrow + k);
      wsum = __fadd_rn(wsum, wk);
      if (active) acc = __fadd_rn(acc, __fmul_rn(wk, __ldg(vrow + k * D)));
    }
    if (active) sums[b * D + d] = acc;
    if (d == 0) tot[b] = wsum;
  }
}

}  // namespace

extern "C" cudaError_t segment_avg_f32(const float* vals, const float* w,
                                       float* sums, float* tot, int64_t B,
                                       int64_t K, int64_t D,
                                       cudaStream_t stream) {
  if (B <= 0) return cudaSuccess;
  const int64_t col_blocks = D > 0 ? (D + kThreads - 1) / kThreads : 1;
  if (col_blocks > 0x7fffffff) return cudaErrorInvalidValue;
  const int64_t row_blocks = B < 65535 ? B : 65535;
  dim3 grid(static_cast<unsigned>(col_blocks),
            static_cast<unsigned>(row_blocks));
  segment_avg_kernel<<<grid, kThreads, 0, stream>>>(vals, w, sums, tot, B, K,
                                                    D);
  return cudaGetLastError();
}
