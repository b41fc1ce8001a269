// One-token GQA attention over a ring KV cache (split-W flash decoding),
// for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/decode_attention.py:92
// `decode_attention_blocks` (`_decode_attn_kernel`), driven by the JAX
// package's `kernels/ops.py:decode_attention_fused`; in the port it is the
// score, softmax and combine of `models/lm/layers.py:decode_attention`,
// once per layer of every decode step.  For every batch row b and query
// head h = kh * G + g (kh the KV head, G = H / K the group width):
//
//     s[w]  = ok(w) ? (q[b, h, :] . k[b, w, kh, :]) / sqrt(hd) : -1e30
//     out[b, h, :] = sum_w softmax(s)[w] * v[b, w, kh, :]
//     ok(w) = 0 <= slot_pos[w] <= pos  (and slot_pos[w] > pos - window
//             when window > 0, the reference layer's sliding-window clause)
//
// q [B, H, hd] bf16 or fp32, k / v [B, W, K, hd] bf16 or fp32 (one
// template), slot_pos [W] int32, pos a 0-d int32 on the device (read by
// pointer: nothing is read back to the host), out [B, H, hd] fp32.  A
// masked slot takes the score -1e30 rather than being skipped, so the
// result is the plain version's softmax in every case, including a row
// whose every slot is masked (a uniform average, as `softmax` gives).
//
// What bounds it: HBM bytes.  Every step streams the whole window's k and
// v once: at the serving path's [8, 32768, 16, 64] bf16 cache 1.074 GB a
// layer, 0.3205 ms at 3.35 TB/s; the 4·B·H·W·hd fp32 flops are 1.07 GFLOP,
// 0.016 ms at 67 TFLOP/s.
//
// Design, simple first (no TMA, no wgmma): the grid is (W-split, K, B).
// A block of 128 threads owns one (b, kh) and a contiguous run of slots;
// it holds the G query rows of its KV head in registers and streams its
// slots' k and v rows with 16-byte loads: TPR = hd / (16 / sizeof(T))
// threads share one slot row, so 128 / TPR slots are in flight per block
// step.  Each group of TPR lanes reduces its dot products with xor
// shuffles and keeps its own online softmax (running m, l) and fp32
// accumulator over its slots; at the end the block merges its groups in
// shared memory and writes one (m, l, acc) per (b, h, split).  A second
// small kernel merges the splits in split order and divides by
// max(l, 1e-30), as the reference divides.  An empty group or split
// carries m = -inf and weighs exp(-inf) = 0 in the merge, never NaN.
// Offsets are 64-bit: the serving cache is 25.8 GB.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr float kMasked = -1e30f;

template <typename T> struct Vec;
template <> struct Vec<float> { static constexpr int N = 4; };
template <> struct Vec<__nv_bfloat16> { static constexpr int N = 8; };

__device__ __forceinline__ void load16(const float* p, float (&f)[4]) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(p));
  f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
}

__device__ __forceinline__ void load16(const __nv_bfloat16* p,
                                       float (&f)[8]) {
  const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

template <typename T, int HD, int GMAX>
__global__ void __launch_bounds__(kThreads)
decode_split_kernel(const void* __restrict__ q_raw, int q_bf16,
                    const T* __restrict__ k, const T* __restrict__ v,
                    const int32_t* __restrict__ slot_pos,
                    const int32_t* __restrict__ pos_ptr, int64_t window,
                    int64_t W, int64_t K, int G, int64_t sps, float scale,
                    float* __restrict__ part_acc,
                    float* __restrict__ part_ml) {
  constexpr int VEC = Vec<T>::N;
  constexpr int TPR = HD / VEC;          // lanes per slot row
  constexpr int NGRP = kThreads / TPR;   // slots per block step
  static_assert(HD % VEC == 0 && TPR >= 1 && TPR <= 32 &&
                (TPR & (TPR - 1)) == 0, "hd / (16 / sizeof(T)) must be a "
                "power of two in [1, 32]");
  __shared__ float sm_ml[NGRP][GMAX][2];
  __shared__ float sm_acc[NGRP][GMAX][HD];

  const int64_t split = blockIdx.x;
  const int64_t kh = blockIdx.y;
  const int64_t b = blockIdx.z;
  const int64_t S = gridDim.x;
  const int64_t H = K * G;
  const int lane = threadIdx.x % TPR;
  const int grp = threadIdx.x / TPR;
  const int d0 = lane * VEC;

  float qf[GMAX][VEC];
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    const int64_t off = (b * H + kh * G + g) * HD + d0;
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      float x = 0.0f;
      if (g < G)
        x = q_bf16 ? __bfloat162float(
                         static_cast<const __nv_bfloat16*>(q_raw)[off + j])
                   : static_cast<const float*>(q_raw)[off + j];
      qf[g][j] = x;
    }
  }

  const int64_t pos = *pos_ptr;
  const int64_t w_lo = split * sps;
  const int64_t w_hi = w_lo + sps < W ? w_lo + sps : W;
  const int64_t row_stride = K * HD;  // elements from one slot to the next
  const T* kb = k + (b * W * K + kh) * HD + d0;
  const T* vb = v + (b * W * K + kh) * HD + d0;

  float m[GMAX], l[GMAX], acc[GMAX][VEC];
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.0f;
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[g][j] = 0.0f;
  }

  // every lane runs every block step, so the shuffles below always see
  // the whole warp; a lane past the split's end only skips the update
#pragma unroll 2
  for (int64_t w0 = w_lo; w0 < w_hi; w0 += NGRP) {
    const int64_t w = w0 + grp;
    const bool live = w < w_hi;
    float kf[VEC], vf[VEC];
    bool ok = false;
    if (live) {
      load16(kb + w * row_stride, kf);
      load16(vb + w * row_stride, vf);
      const int64_t sp = __ldg(slot_pos + w);
      ok = sp >= 0 && sp <= pos && (window <= 0 || sp > pos - window);
    } else {
#pragma unroll
      for (int j = 0; j < VEC; ++j) kf[j] = vf[j] = 0.0f;
    }
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      if (g < G) {
        float dot = 0.0f;
#pragma unroll
        for (int j = 0; j < VEC; ++j) dot = fmaf(qf[g][j], kf[j], dot);
#pragma unroll
        for (int o = TPR / 2; o > 0; o >>= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, o);
        if (live) {
          const float s = ok ? dot * scale : kMasked;
          const float m_new = fmaxf(m[g], s);
          const float alpha = expf(m[g] - m_new);  // 0 on the first slot
          const float p = expf(s - m_new);
          l[g] = l[g] * alpha + p;
#pragma unroll
          for (int j = 0; j < VEC; ++j) acc[g][j] = acc[g][j] * alpha + p * vf[j];
          m[g] = m_new;
        }
      }
    }
  }

#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    if (g < G) {
      if (lane == 0) {
        sm_ml[grp][g][0] = m[g];
        sm_ml[grp][g][1] = l[g];
      }
#pragma unroll
      for (int j = 0; j < VEC; ++j) sm_acc[grp][g][d0 + j] = acc[g][j];
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < G * HD; idx += kThreads) {
    const int g = idx / HD, d = idx - g * HD;
    float mx = -INFINITY;
    for (int r = 0; r < NGRP; ++r) mx = fmaxf(mx, sm_ml[r][g][0]);
    float lsum = 0.0f, asum = 0.0f;
    for (int r = 0; r < NGRP; ++r) {
      const float mr = sm_ml[r][g][0];
      const float wgt = mr == -INFINITY ? 0.0f : expf(mr - mx);
      lsum += wgt * sm_ml[r][g][1];
      asum += wgt * sm_acc[r][g][d];
    }
    const int64_t o = (b * H + kh * G + g) * S + split;
    part_acc[o * HD + d] = asum;
    if (d == 0) {
      part_ml[2 * o] = mx;
      part_ml[2 * o + 1] = lsum;
    }
  }
}

// One block per (b, h), one thread per head dimension: merge the splits.
__global__ void decode_combine_kernel(const float* __restrict__ part_acc,
                                      const float* __restrict__ part_ml,
                                      int64_t S, int64_t HD,
                                      float* __restrict__ out) {
  const int64_t bh = blockIdx.x;
  const int64_t d = threadIdx.x;
  const float* ml = part_ml + bh * S * 2;
  float mx = -INFINITY;
  for (int64_t s = 0; s < S; ++s) mx = fmaxf(mx, ml[2 * s]);
  float lsum = 0.0f, asum = 0.0f;
  for (int64_t s = 0; s < S; ++s) {
    const float ms = ml[2 * s];
    const float wgt = ms == -INFINITY ? 0.0f : expf(ms - mx);
    lsum += wgt * ml[2 * s + 1];
    asum += wgt * part_acc[(bh * S + s) * HD + d];
  }
  out[bh * HD + d] = asum / fmaxf(lsum, 1e-30f);
}

template <typename T, int HD, int GMAX>
cudaError_t launch_split(const void* q, int q_bf16, const void* k,
                         const void* v, const int32_t* slot_pos,
                         const int32_t* pos, int64_t window, int64_t B,
                         int64_t W, int64_t K, int G, int64_t S, int64_t sps,
                         float scale, float* part_acc, float* part_ml,
                         cudaStream_t stream) {
  dim3 grid(static_cast<unsigned>(S), static_cast<unsigned>(K),
            static_cast<unsigned>(B));
  decode_split_kernel<T, HD, GMAX><<<grid, kThreads, 0, stream>>>(
      q, q_bf16, static_cast<const T*>(k), static_cast<const T*>(v),
      slot_pos, pos, window, W, K, G, sps, scale, part_acc, part_ml);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t by_group(const void* q, int q_bf16, const void* k, const void* v,
                     const int32_t* slot_pos, const int32_t* pos,
                     int64_t window, int64_t B, int64_t W, int64_t K, int G,
                     int64_t S, int64_t sps, float scale, float* part_acc,
                     float* part_ml, cudaStream_t stream) {
#define REPRO_SPLIT(GM)                                                     \
  return launch_split<T, HD, GM>(q, q_bf16, k, v, slot_pos, pos, window, B, \
                                 W, K, G, S, sps, scale, part_acc, part_ml, \
                                 stream)
  if (G <= 1) REPRO_SPLIT(1);
  if (G <= 2) REPRO_SPLIT(2);
  if (G <= 4) REPRO_SPLIT(4);
  REPRO_SPLIT(8);
#undef REPRO_SPLIT
}

template <typename T>
cudaError_t by_head_dim(int64_t HD, const void* q, int q_bf16, const void* k,
                        const void* v, const int32_t* slot_pos,
                        const int32_t* pos, int64_t window, int64_t B,
                        int64_t W, int64_t K, int G, int64_t S, int64_t sps,
                        float scale, float* part_acc, float* part_ml,
                        cudaStream_t stream) {
  switch (HD) {
    case 16:
      return by_group<T, 16>(q, q_bf16, k, v, slot_pos, pos, window, B, W, K,
                             G, S, sps, scale, part_acc, part_ml, stream);
    case 32:
      return by_group<T, 32>(q, q_bf16, k, v, slot_pos, pos, window, B, W, K,
                             G, S, sps, scale, part_acc, part_ml, stream);
    case 64:
      return by_group<T, 64>(q, q_bf16, k, v, slot_pos, pos, window, B, W, K,
                             G, S, sps, scale, part_acc, part_ml, stream);
    case 128:
      return by_group<T, 128>(q, q_bf16, k, v, slot_pos, pos, window, B, W,
                              K, G, S, sps, scale, part_acc, part_ml, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// part_acc [B, H, S, HD] and part_ml [B, H, S, 2] are the caller's fp32
// scratch; every split covers sps slots (the last one the rest), and
// S * sps >= W > (S - 1) * sps, so no split is empty.
extern "C" cudaError_t decode_attention_f32(
    const void* q, int q_bf16, const void* k, const void* v, int kv_bf16,
    const int32_t* slot_pos, const int32_t* pos, int64_t window, int64_t B,
    int64_t W, int64_t K, int64_t G, int64_t HD, int64_t S, int64_t sps,
    float scale, float* part_acc, float* part_ml, float* out,
    cudaStream_t stream) {
  if (B <= 0 || K <= 0 || G <= 0) return cudaSuccess;
  if (W <= 0 || G > 8 || S <= 0 || sps <= 0 || S * sps < W ||
      (S - 1) * sps >= W || S > 0x7fffffff || K > 65535 || B > 65535 ||
      B * K * G > 0x7fffffff)
    return cudaErrorInvalidValue;
  const int g = static_cast<int>(G);
  cudaError_t err =
      kv_bf16 ? by_head_dim<__nv_bfloat16>(HD, q, q_bf16, k, v, slot_pos, pos,
                                           window, B, W, K, g, S, sps, scale,
                                           part_acc, part_ml, stream)
              : by_head_dim<float>(HD, q, q_bf16, k, v, slot_pos, pos, window,
                                   B, W, K, g, S, sps, scale, part_acc,
                                   part_ml, stream);
  if (err != cudaSuccess) return err;
  decode_combine_kernel<<<static_cast<unsigned>(B * K * G),
                          static_cast<unsigned>(HD), 0, stream>>>(
      part_acc, part_ml, S, HD, out);
  return cudaGetLastError();
}
