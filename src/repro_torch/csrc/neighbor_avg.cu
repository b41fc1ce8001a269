// Weighted neighbour-model average for one receiver (the paper's Eq. 6),
// for Hopper (sm_90a), normalization included.
//
// Replaces the Pallas TPU kernel src/repro/kernels/neighbor_avg.py:32
// `neighbor_avg_blocks` (`_avg_kernel`), driven by the JAX package's
// `kernels/ops.py:neighbor_avg`, whose formula (w / sum(w), then a
// contraction over the stacked rows) is also that of
// `core/aggregation.py:fedavg_aggregate` (the FedAvg server) and
// `core/decdiff.py:neighborhood_average` (Eq. 6).  For every column d:
//
//     total  = ((0 + w[0]) + w[1]) + ... + w[N-1]     (normalize = 1)
//     wn[n]  = w[n] / total   (IEEE division; wn = w when normalize = 0)
//     out[d] = sum_n wn[n] * x[n, d]        x [N, D] fp32, w [N] fp32
//
// One launch per `ops.neighbor_avg` call: the weights' sum and division
// are done here, so the wrapper launches no `torch.sum` and no division
// kernel.  Every block forms `total` itself, in n order from +0 with
// __fadd_rn, and divides with __fdiv_rn; the plain version sums in the
// same order and divides in IEEE, so the two agree bit for bit (a zero
// total gives w / 0, as the reference's w / sum(w) does).  Gated callers
// that normalized by a safe total themselves pass normalize = 0.
//
// What bounds it: HBM bytes.  It reads 4*N*D + 4*N bytes and writes 4*D;
// its 2*N*D flops are 0.5 per byte, far below the card's balance point.
// Path f's FedAvg over 16 x 567,434 params moves 38.6 MB, 0.0115 ms at
// 3.35 TB/s, which fits in the 50 MB L2; path d's block [4, 463987712]
// moves 9.28 GB, 2.77 ms.  At the small shape the time is latency: the
// launch, one round trip to memory per batch of loads, and the tail of
// the grid.
//
// Design:
//   * A thread owns a group of 4 consecutive columns.  Each sender row is
//     read with the widest load its address allows: one float4 where the
//     row is 16-byte aligned, two float2 at 8 mod 16 (path f's D = 2 mod 4
//     puts every odd row there), four scalars otherwise; the test is per
//     row and uniform across a warp, so no lane diverges.  A ragged last
//     group reads scalars.
//     When x, out and every row are 16-byte aligned (D = 0 mod 4) an
//     instance without the test reads float4 only (path d's block).
//   * Senders are taken BATCH at a time: a whole batch's loads are issued
//     before its first add.  BATCH = 4 when N <= 4 (path d's ring: few
//     registers, so more threads per SM and more bytes in flight), else 8
//     (path f's N = 16: two round trips to memory).
//   * One column group per thread, blocks of 128.  At path f's shape that
//     is one wave: 1,109 blocks, nine per SM under the BATCH = 8
//     instance's register cap, so no block waits for a second wave (a
//     second round of two round trips would nearly double the time).  At
//     path d's shape the grid is ~900k blocks, whose last partial wave is
//     a small fraction of the time; one group per thread kept the old
//     kernel at 91% of its bound there, where a persistent grid-stride
//     loop measured slower (more registers per thread, fewer threads).
//   * Each column accumulates over n in order from +0 with a separate
//     multiply and add (__fmul_rn / __fadd_rn, never contracted into an
//     FMA): the plain version's `acc = acc + wn[n] * x[n]` in its order.
//   * The block stages wn in shared memory, kNChunk senders at a time, so
//     any N works; past one chunk a column's running sum is kept in `out`
//     between chunks (an fp32 store and load change no bit).
// No TMA, shared-memory tiles or tensor cores: every x element is used
// once.  Offsets are 64-bit: N*D passes 2^31 at 4 x 463,987,712.  The
// launcher (kernels/neighbor_avg.py) binds this function once and enters
// no device context on the current device, so a call's host work is the
// output's allocation and one ctypes call.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kNChunk = 1024;  // senders' weights staged at a time

// x[p .. p + 4): one float4 where p is 16-byte aligned (always, when
// ALIGNED), two float2 at 8 mod 16, else four scalars
template <bool ALIGNED>
__device__ __forceinline__ void load4(const float* p, float (&f)[4]) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  if (ALIGNED || (a & 15) == 0) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
  } else if ((a & 7) == 0) {
    const float2 u = __ldg(reinterpret_cast<const float2*>(p));
    const float2 v = __ldg(reinterpret_cast<const float2*>(p + 2));
    f[0] = u.x; f[1] = u.y; f[2] = v.x; f[3] = v.y;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) f[j] = __ldg(p + j);
  }
}

// BATCH senders' loads in flight at once; ALIGNED: x, out and every row
// 16-byte aligned (D = 0 mod 4), so no row needs the alignment test.  The
// BATCH = 8 instance caps its registers at 56 so that nine blocks of 128
// fit on an SM: path f's 1,109 blocks then run in one wave on 132 SMs.
template <int BATCH, bool ALIGNED>
__global__ void __launch_bounds__(kThreads, BATCH == 8 ? 9 : 1)
neighbor_avg_kernel(const float* __restrict__ x, const float* __restrict__ w,
                    float* __restrict__ out, int64_t N, int64_t D,
                    int normalize) {
  __shared__ float sw[kNChunk];
  __shared__ float s_total;
  const int tid = threadIdx.x;

  float total = 1.0f;
  if (normalize) {
    float t = 0.0f;  // thread 0's sum, in n order from +0
    for (int64_t n0 = 0; n0 < N; n0 += kNChunk) {
      const int nc = static_cast<int>(N - n0 < kNChunk ? N - n0 : kNChunk);
      __syncthreads();
      for (int i = tid; i < nc; i += kThreads) sw[i] = __ldg(w + n0 + i);
      __syncthreads();
      if (tid == 0)
        for (int i = 0; i < nc; ++i) t = __fadd_rn(t, sw[i]);
    }
    if (tid == 0) s_total = t;
    __syncthreads();
    total = s_total;
  }

  const int64_t col =
      (static_cast<int64_t>(blockIdx.x) * kThreads + tid) * 4;
  const bool live = col < D;
  const bool whole = ALIGNED || D - col >= 4;
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int64_t n0 = 0; n0 < N; n0 += kNChunk) {
    const int nc = static_cast<int>(N - n0 < kNChunk ? N - n0 : kNChunk);
    __syncthreads();  // the previous chunk's weights are no longer read
    for (int i = tid; i < nc; i += kThreads) {
      const float wi = __ldg(w + n0 + i);
      sw[i] = normalize ? __fdiv_rn(wi, total) : wi;
    }
    __syncthreads();
    if (!live) continue;
    const float* xp = x + n0 * D + col;
    if (whole) {
      int n = 0;
      for (; n + BATCH <= nc; n += BATCH) {  // whole batches
        float f[BATCH][4];
#pragma unroll
        for (int u = 0; u < BATCH; ++u) load4<ALIGNED>(xp + (n + u) * D, f[u]);
#pragma unroll
        for (int u = 0; u < BATCH; ++u) {
          const float wn = sw[n + u];
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[j] = __fadd_rn(acc[j], __fmul_rn(wn, f[u][j]));
        }
      }
      for (; n < nc; ++n) {  // the rest, one sender at a time
        float f[4];
        load4<ALIGNED>(xp + n * D, f);
        const float wn = sw[n];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[j] = __fadd_rn(acc[j], __fmul_rn(wn, f[j]));
      }
    } else {  // the ragged last group, one column at a time
#pragma unroll
      for (int j = 0; j < 3; ++j)
        if (col + j < D)
          for (int n = 0; n < nc; ++n)
            acc[j] = __fadd_rn(acc[j],
                               __fmul_rn(sw[n], __ldg(xp + n * D + j)));
    }
  }
  if (!live) return;
  float* op = out + col;
  if (ALIGNED || (whole && (reinterpret_cast<uintptr_t>(op) & 15) == 0)) {
    *reinterpret_cast<float4*>(op) = make_float4(acc[0], acc[1], acc[2],
                                                 acc[3]);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (col + j < D) op[j] = acc[j];
  }
}

template <int BATCH, bool ALIGNED>
cudaError_t launch(const float* x, const float* w, float* out, int64_t N,
                   int64_t D, int normalize, cudaStream_t stream) {
  const int64_t blocks = ((D + 3) / 4 + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  neighbor_avg_kernel<BATCH, ALIGNED>
      <<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
          x, w, out, N, D, normalize);
  return cudaGetLastError();
}

}  // namespace

// x [N, D] and w [N] fp32, out [D] fp32; normalize = 1 divides w by its
// ordered sum first (ops.neighbor_avg), 0 takes w as it is
// (ops.neighbor_avg_normalized).  Any alignment of x and out that fp32
// allows.
extern "C" cudaError_t neighbor_avg_f32(const float* x, const float* w,
                                        float* out, int64_t N, int64_t D,
                                        int normalize, cudaStream_t stream) {
  if (D <= 0) return cudaSuccess;
  if (N <= 0) return cudaMemsetAsync(out, 0, sizeof(float) * D, stream);
  const bool aligned = D % 4 == 0 &&
                       reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (N <= 4)
    return aligned ? launch<4, true>(x, w, out, N, D, normalize, stream)
                   : launch<4, false>(x, w, out, N, D, normalize, stream);
  return aligned ? launch<8, true>(x, w, out, N, D, normalize, stream)
                 : launch<8, false>(x, w, out, N, D, normalize, stream);
}
