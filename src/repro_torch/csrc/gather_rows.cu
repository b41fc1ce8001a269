// Row gather out of a stacked table, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/gather_rows.py:39
// `gather_rows_blocks` (`_gather_rows_kernel`), driven by the JAX package's
// `kernels/ops.py:gather_rows`.  For every output row k:
//
//     out[k, :] = tbl[idx[k], :]        tbl [M, D] fp32, idx [K] int64
//
// The per-edge gossip transport resolves its reverse slots with it: tbl is
// the flattened [N*max_deg, D] per-link reference table, idx the
// receivers' flattened (neighbour, reverse slot) pairs.
//
// A pure copy with no float operation, so it equals `tbl[idx]` bit for bit.
// What bounds it: HBM bytes (read the indexed rows, write K*D*4, read 8K of
// indices); there is nothing to compute and no reuse beyond rows that
// several slots alias, which the 50 MB L2 serves.
//
// Design, simple first: block (x, y) copies one contiguous chunk of
// kThreads * kUnroll vectors of output row y; neighbouring threads take
// neighbouring vectors, and each thread issues kUnroll loads before its
// stores so several are in flight.  The vector width is the widest of
// float4 / float2 / float that divides D and fits the alignment of both
// base pointers, so every row start is aligned for it and no row has a
// ragged tail (the paper's MLP has D = 567,434 = 2 mod 4: float2).
// Offsets are 64-bit (K*D passes 2^31 at ~3,800 slots of that model).
// Rows beyond the grid's 65,535 limit are walked by a grid-stride loop.
// An index outside [0, M) traps, as PyTorch's own index kernels assert,
// instead of reading out of bounds.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;

template <typename Vec>
__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const Vec* __restrict__ tbl, const int64_t* __restrict__ idx,
                   Vec* __restrict__ out, int64_t M, int64_t K, int64_t nvec) {
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kThreads * kUnroll
                        + threadIdx.x;
  for (int64_t k = blockIdx.y; k < K; k += gridDim.y) {
    const int64_t src = __ldg(idx + k);
    if (src < 0 || src >= M) __trap();
    const Vec* srow = tbl + src * nvec;
    Vec* orow = out + k * nvec;
    Vec v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t i = first + static_cast<int64_t>(u) * kThreads;
      if (i < nvec) v[u] = __ldg(srow + i);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t i = first + static_cast<int64_t>(u) * kThreads;
      if (i < nvec) orow[i] = v[u];
    }
  }
}

template <typename Vec>
cudaError_t launch(const float* tbl, const int64_t* idx, float* out, int64_t M,
                   int64_t K, int64_t D, cudaStream_t stream) {
  const int64_t width = sizeof(Vec) / sizeof(float);
  const int64_t nvec = D / width;
  const int64_t per_block = static_cast<int64_t>(kThreads) * kUnroll;
  const int64_t col_blocks = (nvec + per_block - 1) / per_block;
  if (col_blocks > 0x7fffffff) return cudaErrorInvalidValue;
  const int64_t row_blocks = K < 65535 ? K : 65535;
  dim3 grid(static_cast<unsigned>(col_blocks),
            static_cast<unsigned>(row_blocks));
  gather_rows_kernel<Vec><<<grid, kThreads, 0, stream>>>(
      reinterpret_cast<const Vec*>(tbl), idx, reinterpret_cast<Vec*>(out), M,
      K, nvec);
  return cudaGetLastError();
}

}  // namespace

extern "C" cudaError_t gather_rows_f32(const float* tbl, const int64_t* idx,
                                       float* out, int64_t M, int64_t K,
                                       int64_t D, cudaStream_t stream) {
  if (K <= 0 || D <= 0) return cudaSuccess;
  const uintptr_t align = reinterpret_cast<uintptr_t>(tbl)
                          | reinterpret_cast<uintptr_t>(out);
  if (D % 4 == 0 && align % 16 == 0)
    return launch<float4>(tbl, idx, out, M, K, D, stream);
  if (D % 2 == 0 && align % 8 == 0)
    return launch<float2>(tbl, idx, out, M, K, D, stream);
  return launch<float>(tbl, idx, out, M, K, D, stream);
}
