// One-token GQA attention over a ring KV cache split over the head dim,
// for Hopper (sm_90a): the split-hd form of decode_attention.cu.
//
// Replaces, for a cache partitioned over a mesh's "model" axis along hd
// (the reference's cache spec, src/repro/dist/sharding.py:209-235: at
// qwen1.5-0.5b's hd 64 and model = 16, 4 dims a device), the Pallas TPU
// kernel src/repro/kernels/decode_attention.py:92 `decode_attention_blocks`
// as GSPMD partitions its caller.  A shard holding hd columns
// [c0, c0 + hdl) cannot take the softmax alone: the scores sum over the
// whole hd.  So the work is two kernels with an all-reduce between them:
//
//   decode_scores_partial   s[b, h, w] = scale * sum_{d < hdl}
//                               q[b, h, d] * k[b, w, h / G, d]   (fp32)
//   (the caller all-reduces s over the shards: the whole q.k / sqrt(hd))
//   decode_softmax_combine  s = -1e30 where slot w is masked; p =
//                           softmax_w(s); out[b, h, d] = sum_w p[w] *
//                           v[b, w, h / G, d] for the local d < hdl
//
// with the masking of decode_attention.cu (0 <= slot_pos[w] <= pos, and
// slot_pos[w] > pos - window when window > 0; an all-masked row averages
// uniformly, as softmax gives).  q [B, H, hdl] and k / v [B, W, K, hdl]
// are bf16 or fp32 (k and v alike), slot_pos [W] and pos (0-d, read on the
// device) int32, s and out fp32.
//
// What bounds it: HBM bytes, k's and v's once each (at path e's
// [8, 32768, 16, 64] bf16 cache split 16 ways: 67 MB a layer and shard),
// plus the fp32 scores, written once and read twice (16.8 MB).  The design
// is the simple one: kernel 1 stages a tile of TW slots of k (contiguous
// in memory: TW * K * hdl elements) and q in shared memory as fp32, and
// each thread computes scores of one (h, w) pair, w fastest, so the
// writes run along w; kernel 2 takes one block per (b, h), a max pass and
// a pass of exp, sum and p * v over W, each thread holding hdl
// accumulators, then reduces them over the block.  It reads v once per
// query head (G times per KV head, from L2 at best).  Offsets are 64-bit.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileFloats = 8192;  // kernel 1's k tile: 32 KB of fp32
constexpr int kMaxHdl = 64;        // a shard's head dims (hd <= 128, >= 2
                                   // shards)
constexpr float kMasked = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename TQ, typename TK>
__global__ void __launch_bounds__(kThreads)
scores_kernel(const TQ* __restrict__ q, const TK* __restrict__ k,
              float* __restrict__ s, int64_t W, int K, int G, int hdl,
              int tw, float scale) {
  extern __shared__ float smem[];
  const int H = K * G;
  float* qs = smem;                 // [H, hdl]
  float* ks = smem + H * hdl;       // [tw, K, hdl]
  const int64_t b = blockIdx.y;
  const int64_t w0 = static_cast<int64_t>(blockIdx.x) * tw;
  const int64_t nw = W - w0 < tw ? W - w0 : tw;
  const TQ* qb = q + b * H * hdl;
  for (int i = threadIdx.x; i < H * hdl; i += kThreads) qs[i] = to_f32(qb[i]);
  const int64_t row = static_cast<int64_t>(K) * hdl;
  const TK* kb = k + (b * W + w0) * row;
  const int64_t n = nw * row;
  for (int64_t i = threadIdx.x; i < n; i += kThreads) ks[i] = to_f32(kb[i]);
  __syncthreads();
  for (int o = threadIdx.x; o < H * tw; o += kThreads) {
    const int w = o % tw, h = o / tw;
    if (w >= nw) continue;
    const float* qr = qs + h * hdl;
    const float* kr = ks + (static_cast<int64_t>(w) * K + h / G) * hdl;
    float acc = 0.0f;
    for (int d = 0; d < hdl; ++d) acc = fmaf(qr[d], kr[d], acc);
    s[(b * H + h) * W + w0 + w] = acc * scale;
  }
}

__device__ __forceinline__ bool slot_ok(int32_t sp, int32_t pos,
                                        int64_t window) {
  return sp >= 0 && sp <= pos && (window <= 0 || sp > pos - window);
}

__device__ __forceinline__ float block_max(float x, float* red) {
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = x;
  __syncthreads();
  x = lane < kThreads / 32 ? red[lane] : -INFINITY;
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  __syncthreads();
  return x;
}

// One block per (b, h): out[b, h, :hdl] = softmax(masked s[b, h, :]) . v
template <typename TK>
__global__ void __launch_bounds__(kThreads)
combine_kernel(const float* __restrict__ s, const TK* __restrict__ v,
               const int32_t* __restrict__ slot_pos,
               const int32_t* __restrict__ pos_p, float* __restrict__ out,
               int64_t W, int K, int G, int hdl, int64_t window) {
  __shared__ float red[kThreads / 32 * (kMaxHdl + 1)];
  const int H = K * G;
  const int64_t bh = blockIdx.x;
  const int64_t b = bh / H;
  const int h = static_cast<int>(bh % H);
  const int32_t pos = *pos_p;
  const float* sr = s + bh * W;
  float m = -INFINITY;
  for (int64_t w = threadIdx.x; w < W; w += kThreads)
    m = fmaxf(m, slot_ok(slot_pos[w], pos, window) ? sr[w] : kMasked);
  m = block_max(m, red);
  float l = 0.0f;
  float acc[kMaxHdl];
#pragma unroll
  for (int d = 0; d < kMaxHdl; ++d) acc[d] = 0.0f;
  const int64_t row = static_cast<int64_t>(K) * hdl;
  const TK* vb = v + b * W * row + static_cast<int64_t>(h / G) * hdl;
  for (int64_t w = threadIdx.x; w < W; w += kThreads) {
    const float sc = slot_ok(slot_pos[w], pos, window) ? sr[w] : kMasked;
    const float p = expf(sc - m);
    l += p;
    const TK* vr = vb + w * row;
#pragma unroll
    for (int d = 0; d < kMaxHdl; ++d)
      if (d < hdl) acc[d] = fmaf(p, to_f32(vr[d]), acc[d]);
  }
  // block sums of l and acc[0:hdl]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int off = 16; off > 0; off >>= 1)
    l += __shfl_xor_sync(0xffffffffu, l, off);
#pragma unroll
  for (int d = 0; d < kMaxHdl; ++d) {
    if (d < hdl) {
      float x = acc[d];
      for (int off = 16; off > 0; off >>= 1)
        x += __shfl_xor_sync(0xffffffffu, x, off);
      acc[d] = x;
    }
  }
  __shared__ float tot[kMaxHdl + 1];
  if (lane == 0) {
    red[warp * (kMaxHdl + 1)] = l;
    for (int d = 0; d < hdl; ++d) red[warp * (kMaxHdl + 1) + 1 + d] = acc[d];
  }
  __syncthreads();
  if (threadIdx.x <= hdl) {  // tot[0] = l, tot[1 + d] = acc[d]
    float t = 0.0f;
    for (int i = 0; i < kThreads / 32; ++i)
      t += red[i * (kMaxHdl + 1) + threadIdx.x];
    tot[threadIdx.x] = t;
  }
  __syncthreads();
  if (threadIdx.x < hdl)
    out[bh * hdl + threadIdx.x] = tot[1 + threadIdx.x] / fmaxf(tot[0], 1e-30f);
}

template <typename TQ, typename TK>
cudaError_t launch_scores(const void* q, const void* k, float* s, int64_t B,
                          int64_t W, int64_t K, int64_t G, int64_t hdl,
                          float scale, cudaStream_t stream) {
  const int64_t row = K * hdl;
  int64_t tw = kTileFloats / row;
  if (tw > 64) tw = 64;
  if (tw < 1) return cudaErrorInvalidValue;
  const size_t shm = sizeof(float) * (K * G * hdl + tw * row);
  if (shm > 227 * 1024) return cudaErrorInvalidValue;
  if (shm > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        scores_kernel<TQ, TK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(shm));
    if (e != cudaSuccess) return e;
  }
  const dim3 grid(static_cast<unsigned>((W + tw - 1) / tw),
                  static_cast<unsigned>(B));
  scores_kernel<TQ, TK><<<grid, kThreads, shm, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TK*>(k), s, W,
      static_cast<int>(K), static_cast<int>(G), static_cast<int>(hdl),
      static_cast<int>(tw), scale);
  return cudaGetLastError();
}

}  // namespace

// q_bf16 / kv_bf16: 1 for bfloat16, 0 for float32.  s [B, K * G, W] fp32.
extern "C" cudaError_t decode_scores_partial(const void* q, int q_bf16,
                                             const void* k, int kv_bf16,
                                             float* s, int64_t B, int64_t W,
                                             int64_t K, int64_t G,
                                             int64_t hdl, float scale,
                                             cudaStream_t stream) {
  if (B <= 0 || W <= 0) return cudaSuccess;
  if (K <= 0 || G <= 0 || hdl <= 0 || B > 65535) return cudaErrorInvalidValue;
  if (q_bf16 && kv_bf16)
    return launch_scores<__nv_bfloat16, __nv_bfloat16>(q, k, s, B, W, K, G,
                                                       hdl, scale, stream);
  if (q_bf16)
    return launch_scores<__nv_bfloat16, float>(q, k, s, B, W, K, G, hdl,
                                               scale, stream);
  if (kv_bf16)
    return launch_scores<float, __nv_bfloat16>(q, k, s, B, W, K, G, hdl,
                                               scale, stream);
  return launch_scores<float, float>(q, k, s, B, W, K, G, hdl, scale, stream);
}

// s [B, K * G, W] fp32 (the whole scores), v [B, W, K, hdl] -> out
// [B, K * G, hdl] fp32.
extern "C" cudaError_t decode_softmax_combine(const float* s, const void* v,
                                              int kv_bf16,
                                              const int32_t* slot_pos,
                                              const int32_t* pos,
                                              int64_t window, float* out,
                                              int64_t B, int64_t W, int64_t K,
                                              int64_t G, int64_t hdl,
                                              cudaStream_t stream) {
  if (B <= 0) return cudaSuccess;
  if (W <= 0 || K <= 0 || G <= 0 || hdl <= 0 || hdl > kMaxHdl ||
      B * K * G > 0x7fffffff)
    return cudaErrorInvalidValue;
  const unsigned blocks = static_cast<unsigned>(B * K * G);
  if (kv_bf16)
    combine_kernel<__nv_bfloat16><<<blocks, kThreads, 0, stream>>>(
        s, static_cast<const __nv_bfloat16*>(v), slot_pos, pos, out, W,
        static_cast<int>(K), static_cast<int>(G), static_cast<int>(hdl),
        window);
  else
    combine_kernel<float><<<blocks, kThreads, 0, stream>>>(
        s, static_cast<const float*>(v), slot_pos, pos, out, W,
        static_cast<int>(K), static_cast<int>(G), static_cast<int>(hdl),
        window);
  return cudaGetLastError();
}
