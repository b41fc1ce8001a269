// One-token GQA attention over a ring KV cache (split-W flash decoding on
// TMA-staged K/V tiles), for Hopper (sm_90a).
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
// pointer: nothing is read back to the host), out [B, H, hd] fp32,
// hd in {16, 32, 64, 80, 128}, G <= 8.  A masked slot takes the score -1e30
// rather than being skipped, so the result is the plain version's softmax
// in every case, including a row whose every slot is masked (a uniform
// average, as `softmax` gives).
//
// What bounds it: HBM bytes.  Every step streams the whole window's k and
// v once: at the serving path's [8, 32768, 16, 64] bf16 cache 1.074 GB a
// layer, 0.3205 ms at 3.35 TB/s; the 4·B·H·W·hd flops are 1.07 GFLOP.
// So the kernel has to keep enough bytes in flight to fill HBM, spend few
// instructions per byte, and keep every SM busy to the end.  What held
// the first version (PR 14) back, and what this design does about it:
//
//   1. A partial last wave (17 splits = 2,176 blocks where ~2,112 fit).
//      The split count S now comes from the caller's planner
//      (kernels/decode_attention.py:plan_splits), which reads the resident
//      blocks per SM of this very instance from the occupancy API
//      (`decode_attention_plan` below) and takes the fewest tile-aligned
//      splits whose B·K·S blocks fill their last wave to >= 90%.
//   2. Per-slot softmax work (two expf, three shuffles and a dependent
//      rescale for every slot).  The online softmax now runs once per tile
//      and warp: one row max, one rescale of l and acc (skipped when no
//      row's max moved), and p = exp2 of log2(e)-prescaled scores; scores
//      and p pass through a small per-warp buffer in shared memory.
//   3. Little memory in flight (2 x 32 B a thread).  One producer warp
//      streams K and V tiles with TMA (a 4-D CUtensorMap over [B, W, K,
//      hd], box {hd, KPB, tile, 1}; K cut into 128-byte rows and swizzled
//      so that ldmatrix reads it without bank conflicts) into a ring of 6
//      stages, each 8 KB of K and 8 KB of V, completed on an mbarrier with
//      expect_tx.  It keeps five stages (80 KB) in flight while eight
//      consumer warps (four at hd 128) compute, two blocks an SM.  With
//      bf16 k / v and an even K a block takes KPB = 2 KV heads, so each
//      slot's rows arrive as one contiguous piece (256 B at hd 64), not as
//      128-byte pieces 2 KB apart, which HBM served markedly slower on the
//      card once more than a wave of short blocks streamed at once.
//   4. Register spills at GQA (q and acc of 8 rows in registers).  With
//      bf16 k the scores of a whole tile come from tensor cores:
//      mma.sync.m16n8k16 bf16 with fp32 accumulation, the G query rows as
//      the A fragment (rows 0-7), the tile's K from shared memory
//      (ldmatrix) as B.  An fp32 query is split exactly into three bf16
//      terms q = h + l + r (each the rounding of what is left); h sits in
//      rows 0-7, l in rows 8-15 and r in a second mma into the same
//      accumulator, so every product is exact in fp32 and only the order
//      of the sums differs from the plain version.  P·V stays fp32 on
//      CUDA cores from the V tile in shared memory (at G <= 8 at most 8
//      flops per byte), each lane holding G x (2 or 4) accumulators.
//      With fp32 k / v the scores are fp32 dot products on CUDA cores from
//      the same shared-memory tiles.
//   5. Host work inside the timed window.  The launcher binds once, takes
//      one torch.empty for the scratch and the output, and caches the
//      plan; this file encodes the two tensor maps per call (host only,
//      through cudaGetDriverEntryPoint, so the library needs no -lcuda).
//      A failed encode or launch returns an error, which the wrapper
//      raises.  There is no other kernel to fall back to.
//
// hd 80 (zamba2-2.7b's shared attention block: 2560 / 32 heads) is a
// multiple of the mma's k of 16 but not a power of two, so its instance
// lays the tile out differently: a slot's K row is 160 bytes, loaded whole
// by one TMA box without swizzle (ldmatrix then meets at most 2-way bank
// conflicts), five k-steps (two pairs through ldmatrix.x4, the fifth
// through .x2), a tile of the most slots that fit 8 KB and split evenly
// over the warps (16 slots x 2 heads = 5 KB with bf16), with 9 stages
// instead of 6 so the ring holds as many bytes, and P·V over 8 lanes a row
// of 10 head dims each.  The cache is read in place: no padding to 128.
//
// Each block owns KPB KV heads of one b and one split of sps slots (a
// multiple of the tile), and writes one (m, l, acc) per (b, h, split), m
// in log2 units; the slot positions of the next tile are loaded while a
// tile is computed, so no tile waits on a global load.  A second small
// kernel merges the splits in split order and divides by max(l, 1e-30),
// as the reference divides.  Slots past W in
// the last tile arrive zero-filled from TMA and take the score -inf (they
// are not slots); an empty warp or split carries m = -inf and weighs 0 in
// the merges, never NaN.  Offsets are 64-bit: the serving cache is
// 25.8 GB.
#include <cuda.h>  // CUtensorMap and its enums (types only: no -lcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTileBytes = 8192;                   // one K (or V) tile
constexpr float kMasked = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kMaxDevices = 64;

// KPB KV heads per block: a tile is TILE slots x KPB heads, so each slot's
// KPB rows are one contiguous piece of memory (KPB·hd·esize bytes)
template <typename T, int HD, int GMAX, int KPB>
struct Cfg {
  static constexpr int ESZ = sizeof(T);
  static constexpr bool MMA = sizeof(T) == 2;      // bf16 k: tensor cores
  // a power-of-two hd (16 .. 128) fills the 8 KB tile exactly; hd 80 (a
  // multiple of 16 that is not one) takes the most slots that fit, a
  // multiple of what the warps split (SPW slots a warp, 8 per mma n-block)
  static constexpr bool POW2 = (HD & (HD - 1)) == 0;
  // consumer warps, and one producer: eight with bf16 k / v at hd <= 64,
  // where a block's registers allow it (four could not keep up with the
  // ring at path e's shape), four otherwise; WPH warps share a head, each
  // taking SPW of the tile's slots
  static constexpr int NC = MMA && HD <= 64 ? 8 : 4;
  static constexpr int THREADS = 32 * (NC + 1);
  static constexpr int WPH = NC / KPB;
  static constexpr int QUANT = WPH * (MMA ? 8 : 1);
  static constexpr int TILE =
      kTileBytes / (KPB * HD * ESZ) / QUANT * QUANT;  // slots
  static constexpr int TBYTES = TILE * KPB * HD * ESZ;  // one K (or V) tile
  // stages of SB bytes of K and SB of V (1 KB aligned); a smaller tile
  // gets more stages, so the ring holds the same ~96 KB
  static constexpr int SB = (TBYTES + 1023) / 1024 * 1024;
  static constexpr int STAGES = 6 * kTileBytes / SB;
  static constexpr int SPW = TILE / WPH;           // slots per warp
  // K rows in shared memory: bf16 rows of at most 64 elements (128 B),
  // swizzled, at a power-of-two hd; whole and plain otherwise (hd 80:
  // 160-byte rows, which ldmatrix reads with at most 2-way conflicts) and
  // for fp32 k
  static constexpr int KCOLS = MMA && POW2 ? (HD < 64 ? HD : 64) : HD;
  static constexpr int KROWB = KCOLS * ESZ;
  static constexpr int KBOXES = HD / KCOLS;
  static constexpr int SWZ = MMA && POW2 ? KROWB / 16 - 1 : 0;  // 1, 3, 7
  static constexpr int KS = HD / 16;               // mma k-steps
  // P·V: DPL head dims per lane, LPR lanes per V row, RG rows at a time
  // (hd 80: 10 dims a lane, 8 lanes a row)
  static constexpr int DPL = HD >= 128 ? 4 : POW2 ? 2 : HD / 8;
  static constexpr int LPR = HD / DPL;
  static constexpr int RG = 32 / LPR;
  // shared memory, from a 1024-byte aligned base
  static constexpr int S_OFF = STAGES * 2 * SB;
  static constexpr int Q_OFF = S_OFF + NC * SPW * 8 * 4;
  static constexpr int BAR_OFF = Q_OFF + GMAX * HD * 4;
  static constexpr int SMEM = BAR_OFF + 2 * STAGES * 8 + 1024;
  static_assert(HD % 16 == 0 && TILE >= QUANT && TBYTES <= kTileBytes &&
                TILE <= 256 && NC % KPB == 0 && HD % KCOLS == 0, "tile");
  static_assert(!POW2 || TBYTES == kTileBytes, "pow2 tile");
  static_assert(SPW % (MMA ? 8 : 1) == 0 && SPW >= 4 && SPW <= 64, "spw");
  static_assert(LPR <= 32 && 32 % LPR == 0 && DPL % 2 == 0,
                "lanes per row");
  static_assert(NC * GMAX * HD * 4 + NC * 8 * 2 * 4 <= S_OFF,
                "merge scratch");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// a wait that never completes (a bug, not a slow load) traps after ~2^28
// polls, so the launch fails instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0, polls = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (++polls == (1u << 28)) __trap();
  } while (!done);
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, int c2, int c3,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t& r0,
                                        uint32_t& r1, uint32_t& r2,
                                        uint32_t& r3) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x2(uint32_t addr, uint32_t& r0,
                                        uint32_t& r1) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];"
               : "=r"(r0), "=r"(r1)
               : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  __nv_bfloat162 p;
  p.x = lo;
  p.y = hi;
  return *reinterpret_cast<uint32_t*>(&p);
}

// x = h + l + r exactly, each a bf16 (the rounding of what is left)
__device__ __forceinline__ void split3(float x, __nv_bfloat16& h,
                                       __nv_bfloat16& l, __nv_bfloat16& r) {
  h = __float2bfloat16_rn(x);
  const float x1 = x - __bfloat162float(h);
  l = __float2bfloat16_rn(x1);
  r = __float2bfloat16_rn(x1 - __bfloat162float(l));
}

__device__ __forceinline__ float q_at(const void* q, int q_bf16, int64_t i) {
  return q_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(q)[i])
                : static_cast<const float*>(q)[i];
}

__device__ __forceinline__ void load_v(const float* p, float (&f)[2]) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  f[0] = v.x; f[1] = v.y;
}
__device__ __forceinline__ void load_v(const float* p, float (&f)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
}
__device__ __forceinline__ void load_v(const __nv_bfloat16* p,
                                       float (&f)[2]) {
  const float2 v =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  f[0] = v.x; f[1] = v.y;
}
__device__ __forceinline__ void load_v(const __nv_bfloat16* p,
                                       float (&f)[4]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.y));
  f[0] = a.x; f[1] = a.y; f[2] = b.x; f[3] = b.y;
}

// N even and not 2 or 4 (hd 80's 10 dims a lane): pairs, 8-byte (fp32) or
// 4-byte (bf16) aligned
template <int N>
__device__ __forceinline__ void load_v(const float* p, float (&f)[N]) {
#pragma unroll
  for (int e = 0; e < N; e += 2) {
    const float2 v = *reinterpret_cast<const float2*>(p + e);
    f[e] = v.x; f[e + 1] = v.y;
  }
}
template <int N>
__device__ __forceinline__ void load_v(const __nv_bfloat16* p,
                                       float (&f)[N]) {
#pragma unroll
  for (int e = 0; e < N; e += 2) {
    const float2 v =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p + e));
    f[e] = v.x; f[e + 1] = v.y;
  }
}

// p[j][0..GMAX) of the per-warp buffer (rows of 8 floats, 32-byte aligned)
template <int GMAX>
__device__ __forceinline__ void load_p(const float* row, float (&p)[GMAX]) {
  if constexpr (GMAX == 8) {
    const float4 a = *reinterpret_cast<const float4*>(row);
    const float4 b = *reinterpret_cast<const float4*>(row + 4);
    p[0] = a.x; p[1] = a.y; p[2] = a.z; p[3] = a.w;
    p[4] = b.x; p[5] = b.y; p[6] = b.z; p[7] = b.w;
  } else if constexpr (GMAX == 4) {
    const float4 a = *reinterpret_cast<const float4*>(row);
    p[0] = a.x; p[1] = a.y; p[2] = a.z; p[3] = a.w;
  } else if constexpr (GMAX == 2) {
    const float2 a = *reinterpret_cast<const float2*>(row);
    p[0] = a.x; p[1] = a.y;
  } else {
    p[0] = row[0];
  }
}

__device__ __forceinline__ bool slot_ok(int64_t sp, int64_t pos,
                                        int64_t window) {
  return sp >= 0 && sp <= pos && (window <= 0 || sp > pos - window);
}

template <typename T, int HD, int GMAX, int KPB>
__global__ void __launch_bounds__(Cfg<T, HD, GMAX, KPB>::THREADS, 2)
decode_tma_kernel(const __grid_constant__ CUtensorMap tmap_k,
                  const __grid_constant__ CUtensorMap tmap_v,
                  const void* __restrict__ q_raw, int q_bf16,
                  const int32_t* __restrict__ slot_pos,
                  const int32_t* __restrict__ pos_ptr, int64_t window, int W,
                  int K, int G, int sps, float qk_log2,
                  float* __restrict__ part_acc,
                  float* __restrict__ part_ml) {
  using C = Cfg<T, HD, GMAX, KPB>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::BAR_OFF);
  uint64_t* empty = full + C::STAGES;
  float* sQ = reinterpret_cast<float*>(smem + C::Q_OFF);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int split = blockIdx.x;
  const int kh0 = blockIdx.y * KPB;  // this block's first KV head
  const int64_t b = blockIdx.z;
  const int S = gridDim.x;
  const int H = K * G;
  const int w_lo = split * sps;
  const int w_hi = w_lo + sps < W ? w_lo + sps : W;
  const int ntiles = (w_hi - w_lo + C::TILE - 1) / C::TILE;

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], C::NC);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  if constexpr (!C::MMA) {  // the CUDA-core path reads q from here
    static_assert(C::MMA || KPB == 1, "fp32 k / v: one head a block");
    for (int i = threadIdx.x; i < GMAX * HD; i += C::THREADS) {
      const int g = i / HD;
      sQ[i] = g < G ? q_at(q_raw, q_bf16, (b * H + kh0 * G + g) * HD + i % HD)
                    : 0.0f;
    }
  }
  __syncthreads();

  if (warp == C::NC) {  // the producer: one lane issues every load
    if (lane == 0) {
      for (int t = 0; t < ntiles; ++t) {
        const int s = t % C::STAGES;
        if (t >= C::STAGES) mbar_wait(&empty[s], ((t / C::STAGES) - 1) & 1);
        mbar_expect_tx(&full[s], 2 * C::TBYTES);
        unsigned char* kd = smem + s * 2 * C::SB;
        const int w0 = w_lo + t * C::TILE;
#pragma unroll
        for (int bx = 0; bx < C::KBOXES; ++bx)
          tma_load_4d(kd + bx * C::TILE * KPB * C::KROWB, &tmap_k,
                      bx * C::KCOLS, kh0, w0, static_cast<int>(b), &full[s]);
        tma_load_4d(kd + C::SB, &tmap_v, 0, kh0, w0, static_cast<int>(b),
                    &full[s]);
      }
    }
    return;
  }

  // ---- consumers: warp c takes head hh, slots [slot0, slot0 + SPW) of
  // every tile; the tile's row of (slot j, head hh) is j·KPB + hh ----------
  const int c = warp;
  const int hh = c / C::WPH;
  const int slot0 = (c % C::WPH) * C::SPW;
  const int kh = kh0 + hh;
  const int grow = lane >> 2;  // mma fragment row (query g)
  const int tig = lane & 3;
  float* myS = reinterpret_cast<float*>(smem + C::S_OFF) + c * C::SPW * 8;

  // A fragments: q's bf16 terms, h in rows 0-7, l in rows 8-15, r apart
  uint32_t ah[C::MMA ? C::KS : 1][2], al[C::MMA ? C::KS : 1][2],
      ar[C::MMA ? C::KS : 1][2];
  if constexpr (C::MMA) {
    const int64_t qrow = (b * H + kh * G + grow) * HD;
#pragma unroll
    for (int ks = 0; ks < C::KS; ++ks) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int d = ks * 16 + half * 8 + tig * 2;
        __nv_bfloat16 h[2], l[2], r[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float x = grow < G ? q_at(q_raw, q_bf16, qrow + d + e) : 0.0f;
          split3(x, h[e], l[e], r[e]);
        }
        ah[ks][half] = pack_bf16(h[0], h[1]);
        al[ks][half] = pack_bf16(l[0], l[1]);
        ar[ks][half] = pack_bf16(r[0], r[1]);
      }
    }
  }

  const int64_t pos = *pos_ptr;
  const int sg = lane & 7;   // softmax lanes: row sg,
  const int sj = lane >> 3;  // slots sj, sj + 4, ...
  float m_run = -INFINITY, l_run = 0.0f;
  const int rg = lane / C::LPR;  // P·V lanes: rows rg, rg + RG, ...
  const int d0 = (lane % C::LPR) * C::DPL;
  float acc[GMAX][C::DPL];
#pragma unroll
  for (int g = 0; g < GMAX; ++g)
#pragma unroll
    for (int e = 0; e < C::DPL; ++e) acc[g][e] = 0.0f;

  // slot positions of this lane's slots (mma: 2 per n-block; CUDA cores:
  // one), loaded one tile ahead so that no tile waits on a global load
  constexpr int NSP = C::MMA ? C::SPW / 4 : 1;
  auto slot_of = [&](int t, int i) {
    const int w0 = w_lo + t * C::TILE + slot0;
    return C::MMA ? w0 + (i >> 1) * 8 + tig * 2 + (i & 1) : w0 + lane;
  };
  int32_t sp_next[NSP];
  auto fetch = [&](int t) {
#pragma unroll
    for (int i = 0; i < NSP; ++i) {
      const int w = slot_of(t, i);
      sp_next[i] = w < w_hi && (C::MMA || lane < C::SPW)
                       ? __ldg(slot_pos + w) : -1;
    }
  };
  fetch(0);

  for (int t = 0; t < ntiles; ++t) {
    const int s = t % C::STAGES;
    const unsigned char* kt = smem + s * 2 * C::SB;
    const T* vt = reinterpret_cast<const T*>(kt + C::SB) + hh * HD;
    const int w0 = w_lo + t * C::TILE + slot0;
    int32_t sp[NSP];
#pragma unroll
    for (int i = 0; i < NSP; ++i) sp[i] = sp_next[i];
    if (t + 1 < ntiles) fetch(t + 1);

    if constexpr (C::MMA) {
      constexpr int NB = C::SPW / 8;
      uint32_t live = 0, ok = 0;  // the mask of this lane's slots
#pragma unroll
      for (int i = 0; i < NSP; ++i) {
        if (slot_of(t, i) < w_hi) {
          live |= 1u << i;
          if (slot_ok(sp[i], pos, window)) ok |= 1u << i;
        }
      }
      mbar_wait(&full[s], (t / C::STAGES) & 1);
      const uint32_t kbase = smem_u32(kt);
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        float cf[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        const int row = (slot0 + nb * 8 + (lane & 7)) * KPB + hh;
        if constexpr (C::KS == 1) {  // hd 16: one k-step, two chunks
          const int off = row * C::KROWB + (lane >> 3 & 1) * 16;
          uint32_t b0, b1;
          ldsm_x2(kbase + (off ^ (((off >> 7) & C::SWZ) << 4)), b0, b1);
          mma_bf16(cf, ah[0][0], al[0][0], ah[0][1], al[0][1], b0, b1);
          if (!q_bf16) mma_bf16(cf, ar[0][0], 0u, ar[0][1], 0u, b0, b1);
        } else {
#pragma unroll
          for (int ks = 0; ks + 1 < C::KS; ks += 2) {
            // chunks 2ks .. 2ks+3 of the row (8 head dims each)
            const int ch = ks * 2 + (lane >> 3);
            const int bx = ch * 8 / C::KCOLS;
            const int off = bx * C::TILE * KPB * C::KROWB + row * C::KROWB +
                            (ch * 8 % C::KCOLS) * 2;
            uint32_t b0, b1, b2, b3;
            ldsm_x4(kbase + (off ^ (((off >> 7) & C::SWZ) << 4)), b0, b1,
                    b2, b3);
            mma_bf16(cf, ah[ks][0], al[ks][0], ah[ks][1], al[ks][1], b0, b1);
            mma_bf16(cf, ah[ks + 1][0], al[ks + 1][0], ah[ks + 1][1],
                     al[ks + 1][1], b2, b3);
            if (!q_bf16) {
              mma_bf16(cf, ar[ks][0], 0u, ar[ks][1], 0u, b0, b1);
              mma_bf16(cf, ar[ks + 1][0], 0u, ar[ks + 1][1], 0u, b2, b3);
            }
          }
          if constexpr (C::KS % 2 == 1) {  // hd 80: the fifth k-step alone
            constexpr int ks = C::KS - 1;
            const int ch = ks * 2 + (lane >> 3 & 1);
            const int off = row * C::KROWB + ch * 16;  // one box, no swizzle
            uint32_t b0, b1;
            ldsm_x2(kbase + off, b0, b1);
            mma_bf16(cf, ah[ks][0], al[ks][0], ah[ks][1], al[ks][1], b0, b1);
            if (!q_bf16) mma_bf16(cf, ar[ks][0], 0u, ar[ks][1], 0u, b0, b1);
          }
        }
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int bit = nb * 2 + e;
          const float sc = (cf[e] + cf[2 + e]) * qk_log2;
          myS[(nb * 8 + tig * 2 + e) * 8 + grow] =
              (live >> bit & 1) ? ((ok >> bit & 1) ? sc : kMasked)
                                : -INFINITY;
        }
      }
    } else {  // fp32 k: CUDA-core dot products, one slot per lane
      const int j = lane;
      const bool mine = j < C::SPW;
      const bool is_live = mine && w0 + j < w_hi;
      const bool is_ok = is_live && slot_ok(sp[0], pos, window);
      mbar_wait(&full[s], (t / C::STAGES) & 1);
      if (mine) {
        const float* krow =
            reinterpret_cast<const float*>(kt) + (slot0 + j) * HD;
        float dot[GMAX];
#pragma unroll
        for (int g = 0; g < GMAX; ++g) dot[g] = 0.0f;
        constexpr int NCH = HD / 4;
        for (int cc = 0; cc < NCH; ++cc) {
          const int ch = (cc + lane) % NCH;  // lanes start apart: no conflicts
          const float4 kv = reinterpret_cast<const float4*>(krow)[ch];
#pragma unroll
          for (int g = 0; g < GMAX; ++g) {
            const float4 qv = reinterpret_cast<const float4*>(sQ + g * HD)[ch];
            dot[g] = fmaf(qv.x, kv.x, dot[g]);
            dot[g] = fmaf(qv.y, kv.y, dot[g]);
            dot[g] = fmaf(qv.z, kv.z, dot[g]);
            dot[g] = fmaf(qv.w, kv.w, dot[g]);
          }
        }
#pragma unroll
        for (int g = 0; g < 8; ++g) {
          float sc = 0.0f;
          if (g < GMAX) sc = dot[g] * qk_log2;
          myS[j * 8 + g] = is_live ? (is_ok ? sc : kMasked) : -INFINITY;
        }
      }
    }
    __syncwarp();

    // the online softmax, once per tile: lanes (sg, sj) take slots sj + 4i
    // of row sg; one max, one rescale, p = exp2(s - m)
    float tmax = -INFINITY;
    for (int j = sj; j < C::SPW; j += 4) tmax = fmaxf(tmax, myS[j * 8 + sg]);
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 8));
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 16));
    const float m_new = fmaxf(m_run, tmax);
    const float m_use = m_new == -INFINITY ? 0.0f : m_new;
    const float alpha = exp2f(m_run - m_use);  // 0 on the first live tile
    float psum = 0.0f;
    for (int j = sj; j < C::SPW; j += 4) {
      const float p = exp2f(myS[j * 8 + sg] - m_use);
      myS[j * 8 + sg] = p;
      psum += p;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 8);
    psum += __shfl_xor_sync(0xffffffffu, psum, 16);
    l_run = l_run * alpha + psum;
    m_run = m_new;
    __syncwarp();

    // P·V: lanes (rg, d0) take rows rg + RG·i, head dims d0 .. d0 + DPL;
    // acc is rescaled only on a tile that moved a row's max (alpha != 1)
    if (__any_sync(0xffffffffu, alpha != 1.0f)) {
#pragma unroll
      for (int g = 0; g < GMAX; ++g) {
        const float a = __shfl_sync(0xffffffffu, alpha, g);
#pragma unroll
        for (int e = 0; e < C::DPL; ++e) acc[g][e] *= a;
      }
    }
#pragma unroll 4
    for (int j = rg; j < C::SPW; j += C::RG) {
      float p[GMAX], v[C::DPL];
      load_p<GMAX>(myS + j * 8, p);
      load_v(vt + (slot0 + j) * KPB * HD + d0, v);
#pragma unroll
      for (int g = 0; g < GMAX; ++g)
        if (g < G)
#pragma unroll
          for (int e = 0; e < C::DPL; ++e)
            acc[g][e] = fmaf(p[g], v[e], acc[g][e]);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  // ---- merge the warps (the stage buffers are free once all are here) ----
#pragma unroll
  for (int o = C::LPR; o < 32; o <<= 1)
#pragma unroll
    for (int g = 0; g < GMAX; ++g)
#pragma unroll
      for (int e = 0; e < C::DPL; ++e)
        acc[g][e] += __shfl_xor_sync(0xffffffffu, acc[g][e], o);
  asm volatile("bar.sync 1, %0;" ::"n"(C::NC * 32) : "memory");
  float* wacc = reinterpret_cast<float*>(smem);       // [c][GMAX][HD]
  float* wml = wacc + C::NC * GMAX * HD;              // [c][8][2]
  if (rg == 0)
#pragma unroll
    for (int g = 0; g < GMAX; ++g)
#pragma unroll
      for (int e = 0; e < C::DPL; ++e)
        wacc[(c * GMAX + g) * HD + d0 + e] = acc[g][e];
  if (lane < 8) {
    wml[(c * 8 + lane) * 2] = m_run;
    wml[(c * 8 + lane) * 2 + 1] = l_run;
  }
  asm volatile("bar.sync 1, %0;" ::"n"(C::NC * 32) : "memory");
  for (int idx = threadIdx.x; idx < KPB * G * HD; idx += C::NC * 32) {
    const int hi = idx / (G * HD), g = idx / HD % G, d = idx % HD;
    float mx = -INFINITY;
#pragma unroll
    for (int r = hi * C::WPH; r < (hi + 1) * C::WPH; ++r)
      mx = fmaxf(mx, wml[(r * 8 + g) * 2]);
    float lsum = 0.0f, asum = 0.0f;
#pragma unroll
    for (int r = hi * C::WPH; r < (hi + 1) * C::WPH; ++r) {
      const float mr = wml[(r * 8 + g) * 2];
      const float wgt = mr == -INFINITY ? 0.0f : exp2f(mr - mx);
      lsum += wgt * wml[(r * 8 + g) * 2 + 1];
      asum += wgt * wacc[(r * GMAX + g) * HD + d];
    }
    const int64_t o = (b * H + (kh0 + hi) * G + g) * S + split;
    part_acc[o * HD + d] = asum;
    if (d == 0) {
      part_ml[2 * o] = mx;
      part_ml[2 * o + 1] = lsum;
    }
  }
}

// One block per (b, h), one thread per head dimension: merge the splits
// in split order (m in log2 units).
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
    const float wgt = ms == -INFINITY ? 0.0f : exp2f(ms - mx);
    lsum += wgt * ml[2 * s + 1];
    asum += wgt * part_acc[(bh * S + s) * HD + d];
  }
  out[bh * HD + d] = asum / fmaxf(lsum, 1e-30f);
}

// ---- host side ------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime already loaded
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess)
      return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a [B, W, K, HD] map, box {cols, heads, tile, 1}
cudaError_t encode_map(CUtensorMap* map, const void* base, bool bf16,
                       int64_t B, int64_t W, int64_t K, int64_t HD, int cols,
                       int heads, int tile, CUtensorMapSwizzle swizzle) {
  EncodeTiled enc = encoder();
  if (enc == nullptr) return cudaErrorNotSupported;
  const int64_t esz = bf16 ? 2 : 4;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(HD),
                              static_cast<cuuint64_t>(K),
                              static_cast<cuuint64_t>(W),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(HD * esz),
                                 static_cast<cuuint64_t>(K * HD * esz),
                                 static_cast<cuuint64_t>(W * K * HD * esz)};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(cols),
                             static_cast<cuuint32_t>(heads),
                             static_cast<cuuint32_t>(tile), 1};
  const cuuint32_t estride[4] = {1, 1, 1, 1};
  const CUresult r = enc(
      map, bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
      4, const_cast<void*>(base), dims, strides, box, estride,
      CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <typename T, int HD, int GMAX, int KPB>
struct Instance {
  using C = Cfg<T, HD, GMAX, KPB>;

  static cudaError_t prepare() {
    static bool done[kMaxDevices] = {};  // the attribute, once per device
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
    if (!done[dev]) {
      err = cudaFuncSetAttribute(decode_tma_kernel<T, HD, GMAX, KPB>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 C::SMEM);
      if (err != cudaSuccess) return err;
      done[dev] = true;
    }
    return cudaSuccess;
  }

  static cudaError_t plan(int64_t* out) {
    cudaError_t err = prepare();
    if (err != cudaSuccess) return err;
    int dev = 0, sms = 0, per_sm = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev)) != cudaSuccess)
      return err;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, decode_tma_kernel<T, HD, GMAX, KPB>, C::THREADS,
             C::SMEM)) !=
        cudaSuccess)
      return err;
    if (per_sm <= 0) return cudaErrorInvalidConfiguration;
    out[0] = C::TILE;
    out[1] = per_sm;
    out[2] = sms;
    out[3] = KPB;
    return cudaSuccess;
  }

  static cudaError_t launch(const void* q, int q_bf16, const void* k,
                            const void* v, const int32_t* slot_pos,
                            const int32_t* pos, int64_t window, int64_t B,
                            int64_t W, int64_t K, int G, int64_t S,
                            int64_t sps, float scale, float* part_acc,
                            float* part_ml, cudaStream_t stream) {
    if (sps % C::TILE != 0 || K % KPB != 0) return cudaErrorInvalidValue;
    cudaError_t err = prepare();
    if (err != cudaSuccess) return err;
    CUtensorMap tk, tv;
    const CUtensorMapSwizzle kswz =
        C::SWZ == 0 ? CU_TENSOR_MAP_SWIZZLE_NONE
        : C::KROWB == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
        : C::KROWB == 64  ? CU_TENSOR_MAP_SWIZZLE_64B
                          : CU_TENSOR_MAP_SWIZZLE_32B;
    if ((err = encode_map(&tk, k, C::MMA, B, W, K, HD, C::KCOLS, KPB,
                          C::TILE, kswz)) != cudaSuccess)
      return err;
    if ((err = encode_map(&tv, v, C::MMA, B, W, K, HD, HD, KPB, C::TILE,
                          CU_TENSOR_MAP_SWIZZLE_NONE)) != cudaSuccess)
      return err;
    const dim3 grid(static_cast<unsigned>(S), static_cast<unsigned>(K / KPB),
                    static_cast<unsigned>(B));
    decode_tma_kernel<T, HD, GMAX, KPB>
        <<<grid, C::THREADS, C::SMEM, stream>>>(
        tk, tv, q, q_bf16, slot_pos, pos, window, static_cast<int>(W),
        static_cast<int>(K), G, static_cast<int>(sps), scale * kLog2e,
        part_acc, part_ml);
    return cudaGetLastError();
  }
};

// bf16 k / v with an even K: two heads a block (each slot's two rows are
// one 256-byte piece at hd 64); otherwise one
template <typename T, int HD, int GM>
cudaError_t by_heads(int64_t G, bool plan_only, int64_t* plan,
                     const void* q, int q_bf16, const void* k, const void* v,
                     const int32_t* slot_pos, const int32_t* pos,
                     int64_t window, int64_t B, int64_t W, int64_t K,
                     int64_t S, int64_t sps, float scale, float* part_acc,
                     float* part_ml, cudaStream_t stream) {
#define REPRO_HEADS(KPB)                                                     \
  return plan_only                                                           \
             ? Instance<T, HD, GM, KPB>::plan(plan)                          \
             : Instance<T, HD, GM, KPB>::launch(                             \
                   q, q_bf16, k, v, slot_pos, pos, window, B, W, K,          \
                   static_cast<int>(G), S, sps, scale, part_acc, part_ml,    \
                   stream)
  if constexpr (sizeof(T) == 2) {
    if (K % 2 == 0) REPRO_HEADS(2);
  }
  REPRO_HEADS(1);
#undef REPRO_HEADS
}

template <typename T, int HD>
cudaError_t by_group(int64_t G, bool plan_only, int64_t* plan,
                     const void* q, int q_bf16, const void* k, const void* v,
                     const int32_t* slot_pos, const int32_t* pos,
                     int64_t window, int64_t B, int64_t W, int64_t K,
                     int64_t S, int64_t sps, float scale, float* part_acc,
                     float* part_ml, cudaStream_t stream) {
#define REPRO_GROUP(GM)                                                      \
  return by_heads<T, HD, GM>(G, plan_only, plan, q, q_bf16, k, v, slot_pos,  \
                             pos, window, B, W, K, S, sps, scale, part_acc,  \
                             part_ml, stream)
  if (G <= 1) REPRO_GROUP(1);
  if (G <= 2) REPRO_GROUP(2);
  if (G <= 4) REPRO_GROUP(4);
  REPRO_GROUP(8);
#undef REPRO_GROUP
}

template <typename T>
cudaError_t by_head_dim(int64_t HD, int64_t G, bool plan_only, int64_t* plan,
                        const void* q, int q_bf16, const void* k,
                        const void* v, const int32_t* slot_pos,
                        const int32_t* pos, int64_t window, int64_t B,
                        int64_t W, int64_t K, int64_t S, int64_t sps,
                        float scale, float* part_acc, float* part_ml,
                        cudaStream_t stream) {
#define REPRO_HD(D)                                                         \
  case D:                                                                   \
    return by_group<T, D>(G, plan_only, plan, q, q_bf16, k, v, slot_pos,    \
                          pos, window, B, W, K, S, sps, scale, part_acc,    \
                          part_ml, stream)
  switch (HD) {
    REPRO_HD(16);
    REPRO_HD(32);
    REPRO_HD(64);
    REPRO_HD(80);
    REPRO_HD(128);
    default:
      return cudaErrorInvalidValue;
  }
#undef REPRO_HD
}

}  // namespace

// The launch plan of the instance for (k / v dtype, hd, G, K) on the
// current device: out[0] = slots per tile (every split must be a multiple
// of it), out[1] = resident blocks per SM (occupancy API), out[2] = SMs,
// out[3] = KV heads per block (the grid has K / out[3] of them).
extern "C" cudaError_t decode_attention_plan(int kv_bf16, int64_t HD,
                                             int64_t G, int64_t K,
                                             int64_t* out) {
  if (G <= 0 || G > 8 || K <= 0) return cudaErrorInvalidValue;
  return kv_bf16 ? by_head_dim<__nv_bfloat16>(HD, G, true, out, nullptr, 0,
                                              nullptr, nullptr, nullptr,
                                              nullptr, 0, 0, 0, K, 0, 0, 0.0f,
                                              nullptr, nullptr, nullptr)
                 : by_head_dim<float>(HD, G, true, out, nullptr, 0, nullptr,
                                      nullptr, nullptr, nullptr, 0, 0, 0, K,
                                      0, 0, 0.0f, nullptr, nullptr, nullptr);
}

// part_acc [B, H, S, HD] and part_ml [B, H, S, 2] are the caller's fp32
// scratch; every split covers sps slots (the last one the rest), sps is a
// multiple of the plan's tile, and S * sps >= W > (S - 1) * sps, so no
// split is empty.  k and v are 16-byte aligned (TMA).
extern "C" cudaError_t decode_attention_f32(
    const void* q, int q_bf16, const void* k, const void* v, int kv_bf16,
    const int32_t* slot_pos, const int32_t* pos, int64_t window, int64_t B,
    int64_t W, int64_t K, int64_t G, int64_t HD, int64_t S, int64_t sps,
    float scale, float* part_acc, float* part_ml, float* out,
    cudaStream_t stream) {
  if (B <= 0 || K <= 0 || G <= 0) return cudaSuccess;
  if (W <= 0 || G > 8 || S <= 0 || sps <= 0 || S * sps < W ||
      (S - 1) * sps >= W || W > 0x7fffffff || S > 0x7fffffff ||
      K > 65535 || B > 65535 || B * K * G > 0x7fffffff ||
      (reinterpret_cast<uintptr_t>(k) & 15) ||
      (reinterpret_cast<uintptr_t>(v) & 15))
    return cudaErrorInvalidValue;
  cudaError_t err =
      kv_bf16 ? by_head_dim<__nv_bfloat16>(HD, G, false, nullptr, q, q_bf16,
                                           k, v, slot_pos, pos, window, B, W,
                                           K, S, sps, scale, part_acc,
                                           part_ml, stream)
              : by_head_dim<float>(HD, G, false, nullptr, q, q_bf16, k, v,
                                   slot_pos, pos, window, B, W, K, S, sps,
                                   scale, part_acc, part_ml, stream);
  if (err != cudaSuccess) return err;
  decode_combine_kernel<<<static_cast<unsigned>(B * K * G),
                          static_cast<unsigned>(HD), 0, stream>>>(
      part_acc, part_ml, S, HD, out);
  return cudaGetLastError();
}
