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
// device) int32, s and out fp32.  Offsets are 64-bit.
//
// What bounds it: HBM bytes.  The scores kernel reads k once and writes
// the fp32 scores once; the combine reads the scores and v once each (at
// path e's [8, 32768, 16, 64] bf16 cache split 2 ways: 134 MB of k or v a
// layer and shard beside 16.8 MB of scores).  At most G = 8 query heads
// share a k or v element, <= 4 multiply-adds a byte of bf16.  That is
// where the CUDA cores stop keeping up: at G = 8 the scores need about 1.4
// instructions a multiply-add (the k widening and the q reads around
// them), more than an SM runs at its share of HBM's rate, so with bf16 q
// and k and 5 to 8 query heads a kv head they run on tensor cores
// (mma.sync, exact products and fp32 sums as on the CUDA cores).
//
// The design, both kernels: a block owns a range of slots of one batch
// row for every head, so each slot's [K, hdl] row is one contiguous run
// (1 KB at hd 64 split 2 ways, 128 B split 16 ways).  It streams the range
// through a ring of 2 to 4 stages in shared memory filled by 16-byte
// cp.async (4-byte, or plain 2-byte copies, where an address, a stride or
// a run length is not a multiple of 16), the next stages in flight while
// the block computes on one, with one barrier a stage.  Elements stay in
// their storage dtype in shared memory and widen to fp32 in registers.
// The slots a stage, a block and a split and the stages come from the
// launcher's plan (kernels/decode_attention.py: `split_plan`), a function
// of the card's SMs, W, K, G, hdl and the dtype, never of B: a row's
// output is bitwise the same at any batch size.  What it does about what
// held back the first form (one thread per (h, w) dot over fp32 rows in
// shared memory; one block per (b, h) for the combine):
//
//   decode_scores_partial: a thread takes a (slot, kv head) pair and all G
//   query heads of it, so k is read once from shared memory.  Slots run
//   fastest across a warp, and each slot's row is padded by 16 bytes in
//   shared memory, so a warp's 16-byte reads of its dots fall on distinct
//   banks (the first form's rows, a multiple of 32 words apart, put all 32
//   lanes on one bank).  q sits in shared memory as fp32, read as
//   broadcast vectors; the writes run along w, coalesced.  Each dot sums
//   over d in order, as the first form did.  (The tensor-core form: a
//   warp takes 16 slots of one kv head, see scores_mma_kernel.)
//   decode_softmax_combine: flash decoding.  A block owns (b, a split of
//   slots) for all H heads, so the scores and v are each read once
//   whatever G is (the first form read v once per query head and the
//   scores twice), and B x splits blocks fill the card (the first form ran
//   B x H blocks, 128 at path e, one an SM).  With one query head a kv
//   head and 4 or 8 head dims a shard, a thread takes a head and a slot
//   lane and runs its own online softmax with the hdl sums of p * v in
//   registers (combine_heads_kernel).
//   Otherwise, for each stage, the threads of a head mask its scores and
//   update its running max and sum (p = exp(s - m) into shared memory);
//   then a thread takes (a slot lane, a kv head, a run of up to 8 head
//   dims) for up to 8 query heads, rescales its sums and adds p * v over
//   its slots: the v reads of a warp are consecutive 4- to 16-byte runs
//   (combine_kernel).  The block writes (m, l, acc[hdl]) a head to scratch
//   that the wrapper allocates, and a merge kernel joins the splits:
//   out = sum_s e^(m_s - M) acc_s / sum_s e^(m_s - M) l_s.  No float
//   atomics: every sum runs in a fixed order, so two calls agree bitwise.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMergeThreads = 128;
constexpr int kMaxStages = 4;  // the rings' stages: 2 to 4, by the plan
constexpr int kMaxShared = 227 * 1024;
constexpr float kMasked = -1e30f;

__host__ __device__ __forceinline__ int64_t round16(int64_t n) {
  return (n + 15) & ~static_cast<int64_t>(15);
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <int BYTES>
struct Raw;
template <>
struct Raw<2> {
  using T = unsigned short;
};
template <>
struct Raw<4> {
  using T = unsigned int;
};
template <>
struct Raw<8> {
  using T = uint2;
};
template <>
struct Raw<16> {
  using T = uint4;
};

// N elements of T at p (aligned to N * sizeof(T), up to 16 bytes) as fp32
template <typename T, int N>
__device__ __forceinline__ void load_f32(const T* p, float* out) {
  constexpr int kBytes = N * static_cast<int>(sizeof(T));
  constexpr int kPiece = kBytes < 16 ? kBytes : 16;
  constexpr int kPer = kPiece / static_cast<int>(sizeof(T));
#pragma unroll
  for (int j = 0; j < N; j += kPer) {
    const typename Raw<kPiece>::T raw =
        *reinterpret_cast<const typename Raw<kPiece>::T*>(p + j);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < kPer; ++i) out[j + i] = to_f32(e[i]);
  }
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// all but the last n (0 to 2) groups of this thread's copies done
__device__ __forceinline__ void cp_wait_but(int n) {
  if (n <= 0)
    cp_wait<0>();
  else if (n == 1)
    cp_wait<1>();
  else
    cp_wait<2>();
}

// `rows` runs of `len` bytes, `sstride` bytes apart at src, to dst, each
// run `dstride` bytes after the last (dst 16-byte aligned), by the whole
// block: 16-byte cp.async where src, len and both strides allow it, else
// 4-byte cp.async, else (bf16 runs of odd length) plain 2-byte copies.
__device__ __forceinline__ void stage_rows(unsigned char* dst,
                                           const unsigned char* src,
                                           int rows, int len, int64_t sstride,
                                           int dstride) {
  const uint64_t a = reinterpret_cast<uintptr_t>(src) |
                     static_cast<uint64_t>(len) |
                     static_cast<uint64_t>(sstride) |
                     static_cast<uint64_t>(dstride);
  // piece i of the rows is (r, c), r = i / per, c = i % per: each thread
  // steps its (r, c) by kThreads pieces without dividing
  const int shift = (a & 15) == 0 ? 4 : (a & 3) == 0 ? 2 : 1;
  const int per = len >> shift, n = rows * per;
  if (n <= 0) return;
  int r = threadIdx.x / per, c = threadIdx.x - r * per;
  const int dr = kThreads / per, dc = kThreads - dr * per;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    unsigned char* d = dst + r * dstride + (c << shift);
    const unsigned char* s = src + r * sstride + (c << shift);
    if (shift == 4)
      cp_async16(d, s);
    else if (shift == 2)
      cp_async4(d, s);
    else  // bf16 runs of odd length
      *reinterpret_cast<unsigned short*>(d) =
          *reinterpret_cast<const unsigned short*>(s);
    r += dr;
    c += dc;
    if (c >= per) {
      c -= per;
      ++r;
    }
  }
}

// The live slots' positions are [lo, pos]: slot_pos >= 0, <= pos and,
// with a window, > pos - window.
__device__ __forceinline__ int32_t live_from(int32_t pos, int64_t window) {
  const int64_t lo = window > 0 ? static_cast<int64_t>(pos) - window + 1 : 0;
  return static_cast<int32_t>(lo < 0 ? 0 : lo > pos ? pos + 1 : lo);
}

// Block (slot range x, batch row y): s[b, :, wb:we] for every head.  A
// thread takes slot wl of each stage of ts = 2^lts slots (slots fastest
// across a warp) and kv heads kl, kl + 256 / ts, ...  VE: k elements a
// shared-memory read (VE * sizeof(TK) <= 16, VE | hdl); GW: query heads
// a thread sums at once (G rounded up to 1, 2, 4 or 8; larger G in
// groups of 8).
template <typename TK, int VE, int GW>
__global__ void __launch_bounds__(kThreads)
scores_kernel(const void* __restrict__ q, int q_bf16,
              const TK* __restrict__ k, float* __restrict__ s, int64_t W,
              int K, int G, int hdl, int lts, int nst, int64_t per_block,
              float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ts = 1 << lts;
  const int H = K * G;
  const int rowb = K * hdl * static_cast<int>(sizeof(TK));
  const int rs = static_cast<int>(round16(rowb)) + 16;  // padded row
  const int stage = ts * rs;
  float* qs = reinterpret_cast<float*>(smem);  // [H, hdl]
  unsigned char* ring = smem + round16(static_cast<int64_t>(H) * hdl * 4);
  const int64_t b = blockIdx.y;
  const int64_t wb = static_cast<int64_t>(blockIdx.x) * per_block;
  const int64_t nw = (W - wb < per_block ? W : wb + per_block) - wb;
  const int nch = static_cast<int>((nw + ts - 1) >> lts);
  const unsigned char* kb =
      reinterpret_cast<const unsigned char*>(k) + (b * W + wb) * rowb;
  auto load_stage = [&](int c) {  // an empty group past the last stage
    const int64_t w0 = static_cast<int64_t>(c) << lts;
    const int cn = static_cast<int>(nw - w0 < ts ? nw - w0 : ts);
    if (c < nch)
      stage_rows(ring + c % nst * stage, kb + w0 * rowb, cn, rowb, rowb,
                 rs);
    cp_commit();
  };
  for (int c = 0; c < nst - 1; ++c) load_stage(c);
  const int64_t qoff = b * H * hdl;
  for (int i = threadIdx.x; i < H * hdl; i += kThreads)
    qs[i] = q_bf16 ? __bfloat162float(
                         static_cast<const __nv_bfloat16*>(q)[qoff + i])
                   : static_cast<const float*>(q)[qoff + i];
  const int wl = threadIdx.x & (ts - 1);
  const int kl = threadIdx.x >> lts, kstep = kThreads >> lts;
  float* sw = s + b * H * W + wb + wl;  // head h's row at sw[h * W]
  // stage c waits for its copies and a barrier, then refills the stage
  // that every thread finished with before that barrier
  for (int c = 0; c < nch; ++c) {
    cp_wait_but(nst - 2);
    __syncthreads();
    load_stage(c + nst - 1);
    const int64_t w0 = static_cast<int64_t>(c) << lts;
    if (w0 + wl < nw) {
      const TK* kr0 =
          reinterpret_cast<const TK*>(ring + c % nst * stage + wl * rs);
      for (int kh = kl; kh < K; kh += kstep) {
        const TK* kr = kr0 + kh * hdl;
        for (int g0 = 0; g0 < G; g0 += GW) {
          const int gn = G - g0 < GW ? G - g0 : GW;
          const float* qr = qs + (kh * G + g0) * hdl;
          float acc[GW];
#pragma unroll
          for (int g = 0; g < GW; ++g) acc[g] = 0.0f;
          for (int d = 0; d < hdl; d += VE) {
            float kv[VE];
            load_f32<TK, VE>(kr + d, kv);
#pragma unroll
            for (int g = 0; g < GW; ++g) {
              if (g < gn) {
                float qv[VE];
                load_f32<float, VE>(qr + g * hdl + d, qv);
#pragma unroll
                for (int e = 0; e < VE; ++e)
                  acc[g] = fmaf(qv[e], kv[e], acc[g]);
              }
            }
          }
          float* sr = sw + w0 + static_cast<int64_t>(kh * G + g0) * W;
#pragma unroll
          for (int g = 0; g < GW; ++g)
            if (g < gn) sr[g * W] = acc[g] * scale;
        }
      }
    }
  }
}

// The combine's shared memory and its threads' shapes, for the kernel and
// its launcher (kernels/decode_attention.py: `split_plan` mirrors it).  A
// stage holds the scores [H, rsc] (fp32), slot_pos [ct] and v [ct, K, hdl];
// after the ring (or over it, after the last stage: the slot lanes' sums)
// p [ct, hp] and each head's rescale.  The slot lanes' sums take `held`
// (GW * DV) sums a thread, [lane, held, cols + 1] floats, so a warp's
// writes of one sum fall on distinct banks.  The mask / max / exp pass
// gives each head tq threads (256 over H rounded up to a power of two, at
// most 32), each over slots qa, qa + tq, ...: the scores' rows rsc = tq
// (mod 32) floats apart and p's rows hp = 32 / tq (mod 32) apart put a
// warp's reads and writes on distinct banks.
struct CombineLayout {
  int H, tq, hp, rsc, lanes;
  int64_t sc_bytes, sp_bytes, stage, ring, shm;
};

__host__ __device__ __forceinline__ CombineLayout
combine_layout(int K, int G, int hdl, int ct, int rowb, int cols,
               int held, int nst) {
  CombineLayout L;
  L.H = K * G;
  int hq = 1;
  while (hq < L.H) hq <<= 1;
  L.tq = kThreads / hq < 32 ? kThreads / hq : 32;
  L.hp = L.H + ((32 / L.tq - L.H) % 32 + 32) % 32;
  L.rsc = ct + ((L.tq - ct) % 32 + 32) % 32;
  L.lanes = kThreads / cols;
  L.sc_bytes = round16(static_cast<int64_t>(L.H) * L.rsc * 4);
  L.sp_bytes = round16(ct * 4);
  L.stage = L.sc_bytes + L.sp_bytes + round16(static_cast<int64_t>(ct) * rowb);
  const int64_t red = static_cast<int64_t>(L.lanes) * held * (cols + 1) * 4;
  L.ring = round16(nst * L.stage > red ? nst * L.stage : red);
  L.shm = L.ring + static_cast<int64_t>(ct) * L.hp * 4 + L.H * 4;
  return L;
}

// Block (split x, batch row y): the split's (m, l, acc[hdl]) of every
// head.  DV: head dims a thread carries (DV | hdl); GW: query heads it
// carries (G rounded up to 1, 2, 4 or 8; larger G in groups of 8).
template <typename TK, int DV, int GW>
__global__ void __launch_bounds__(kThreads, 3)
combine_kernel(const float* __restrict__ s, const TK* __restrict__ v,
               const int32_t* __restrict__ slot_pos,
               const int32_t* __restrict__ pos_p, float* __restrict__ part_ml,
               float* __restrict__ part_acc, int64_t W, int K, int G, int hdl,
               int ct, int nst, int64_t sps, int64_t window) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int rowb = K * hdl * static_cast<int>(sizeof(TK));
  const int cpk = hdl / DV, ngg = (G + GW - 1) / GW;
  const int cols = K * ngg * cpk;  // a slot's v columns
  const CombineLayout L =
      combine_layout(K, G, hdl, ct, rowb, cols, GW * DV, nst);
  const int H = L.H, hp = L.hp, tq = L.tq, lanes = L.lanes;
  float* pt = reinterpret_cast<float*>(smem + L.ring);  // [ct, hp]
  float* alpha = pt + ct * hp;
  const int64_t split = blockIdx.x, b = blockIdx.y;
  const int64_t wb = split * sps;
  const int64_t we = W - wb < sps ? W : wb + sps;
  const int nch = static_cast<int>((we - wb + ct - 1) / ct);
  const int32_t pos = *pos_p, lo = live_from(pos, window);
  const float* sb = s + b * H * W;
  const unsigned char* vb =
      reinterpret_cast<const unsigned char*>(v) + b * W * rowb;
  auto load_stage = [&](int c) {  // an empty group past the last stage
    const int64_t w0 = wb + static_cast<int64_t>(c) * ct;
    const int cn = static_cast<int>(we - w0 < ct ? we - w0 : ct);
    unsigned char* st = smem + c % nst * L.stage;
    if (c < nch) {
      stage_rows(st, reinterpret_cast<const unsigned char*>(sb + w0), H,
                 cn * 4, W * 4, L.rsc * 4);
      stage_rows(st + L.sc_bytes,
                 reinterpret_cast<const unsigned char*>(slot_pos + w0), 1,
                 cn * 4, 0, 0);
      stage_rows(st + L.sc_bytes + L.sp_bytes, vb + w0 * rowb, cn, rowb,
                 rowb, rowb);
    }
    cp_commit();
  };
  // the mask / max / exp pass: head ha, its lane qa of tq; the head's
  // running max and sum in registers
  const int ha = threadIdx.x / tq, qa = threadIdx.x - ha * tq;
  const bool head_ok = ha < H;
  float m_h = -INFINITY, l_h = 0.0f;
  // the p * v pass: kv head kh, query heads g0 .. g0 + gn, head dims
  // dc .. dc + DV; slots sl, sl + lanes, ... of each stage
  const int sl = threadIdx.x / cols, col = threadIdx.x - sl * cols;
  const int kh = col / (ngg * cpk), rem = col - kh * ngg * cpk;
  const int g0 = rem / cpk * GW, dc = rem % cpk * DV;
  const int gn = G - g0 < GW ? G - g0 : GW;
  const bool active = sl < lanes;
  const bool pvec = G == GW && hp % (GW < 4 ? GW : 4) == 0;
  float acc[GW][DV];
#pragma unroll
  for (int g = 0; g < GW; ++g)
#pragma unroll
    for (int e = 0; e < DV; ++e) acc[g][e] = 0.0f;
  for (int c = 0; c < nst - 1; ++c) load_stage(c);
  // stage c waits for its copies and a barrier, then refills the stage
  // that every thread finished with before that barrier
  for (int c = 0; c < nch; ++c) {
    cp_wait_but(nst - 2);
    __syncthreads();
    load_stage(c + nst - 1);
    const int64_t w0 = wb + static_cast<int64_t>(c) * ct;
    const int cn = static_cast<int>(we - w0 < ct ? we - w0 : ct);
    const unsigned char* st = smem + c % nst * L.stage;
    const int32_t* spc = reinterpret_cast<const int32_t*>(st + L.sc_bytes);
    const TK* vc =
        reinterpret_cast<const TK*>(st + L.sc_bytes + L.sp_bytes);
    {
      // the scores masked in place, their max; then p and its sum
      float* sr = reinterpret_cast<float*>(smem + c % nst * L.stage) +
                  ha * L.rsc;
      const int wn = head_ok ? cn : 0;
      float mx = -INFINITY;
#pragma unroll 4
      for (int w = qa; w < wn; w += tq) {
        const int32_t sp = spc[w];
        const float x = sp >= lo && sp <= pos ? sr[w] : kMasked;
        sr[w] = x;
        mx = fmaxf(mx, x);
      }
      for (int off = tq >> 1; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_h, mx);
      float sum = 0.0f;
#pragma unroll 4
      for (int w = qa; w < wn; w += tq) {
        const float p = __expf(sr[w] - m_new);
        pt[w * hp + ha] = p;
        sum += p;
      }
      for (int off = tq >> 1; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const float a = expf(m_h - m_new);
      l_h = l_h * a + sum;
      m_h = m_new;
      if (head_ok && qa == 0) alpha[ha] = a;
    }
    __syncthreads();
    if (active) {
#pragma unroll
      for (int g = 0; g < GW; ++g) {
        const float a = g < gn ? alpha[kh * G + g0 + g] : 0.0f;
#pragma unroll
        for (int e = 0; e < DV; ++e) acc[g][e] *= a;
      }
      const float* pk = pt + kh * G + g0;
      const TK* vk = vc + kh * hdl + dc;
      for (int w = sl; w < cn; w += lanes) {
        float vv[DV], pv[GW];
        load_f32<TK, DV>(vk + w * (K * hdl), vv);
        if (pvec) {
          load_f32<float, GW>(pk + w * hp, pv);
        } else {
#pragma unroll
          for (int g = 0; g < GW; ++g) pv[g] = g < gn ? pk[w * hp + g] : 0.0f;
        }
#pragma unroll
        for (int g = 0; g < GW; ++g)
#pragma unroll
          for (int e = 0; e < DV; ++e) acc[g][e] = fmaf(pv[g], vv[e], acc[g][e]);
      }
    }
  }
  // the slot lanes' sums, in lane order, over the ring (no copy is in
  // flight: the groups past the last stage are empty)
  __syncthreads();
  constexpr int kHeld = GW * DV;
  const int cp = cols + 1;
  float* red = reinterpret_cast<float*>(smem);
  if (active) {
#pragma unroll
    for (int g = 0; g < GW; ++g)
#pragma unroll
      for (int e = 0; e < DV; ++e)
        red[(sl * kHeld + g * DV + e) * cp + col] = acc[g][e];
  }
  __syncthreads();
  const int64_t row = (b * gridDim.x + split) * H;
  float* pa = part_acc + row * hdl;
  for (int o = threadIdx.x; o < H * hdl; o += kThreads) {
    const int h = o / hdl, d = o - h * hdl;
    const int kv = h / G, gi = h - kv * G;
    const int at = (gi % GW * DV + d % DV) * cp +
                   (kv * ngg + gi / GW) * cpk + d / DV;
    float t = red[at];
    for (int j = 1; j < lanes; ++j) t += red[j * kHeld * cp + at];
    pa[o] = t;
  }
  if (head_ok && qa == 0) {
    part_ml[(row + ha) * 2] = m_h;
    part_ml[(row + ha) * 2 + 1] = l_h;
  }
}

// (m, l, a[0:n]) <- its merge with (m2, l2, a2[0:n]): both softmax
// states over their slots, rescaled to the larger max (a state over no
// slot, m2 = -inf, leaves it as it is).
template <int N>
__device__ __forceinline__ void merge_into(float& m, float& l, float* a,
                                           int n, float m2, float l2,
                                           const float* a2) {
  if (m2 == -INFINITY) return;
  const float mn = fmaxf(m, m2);
  const float c1 = expf(m - mn), c2 = expf(m2 - mn);
  l = l * c1 + l2 * c2;
#pragma unroll
  for (int e = 0; e < N; ++e)
    if (e < n) a[e] = a[e] * c1 + a2[e] * c2;
  m = mn;
}

// The per-head combine's shared memory: nst stages of the scores
// [H, rsc] (fp32), slot_pos [ct] and v [ct, K, D], and over them, after
// the last, the slot lanes' states [lanes, H, D + 2].  A warp holds 32
// heads (or all H, for a slot lane each of 32 / H), so the scores' rows
// rsc = 32 / min(H, 32) (mod 32) floats apart put its reads on distinct
// banks; at H = 16, rsc = 4 (mod 32) instead, two ways to a bank, keeps
// the rows 16-byte copies.
struct HeadsLayout {
  int H, lanes, rsc;
  int64_t sc_bytes, sp_bytes, stage, shm;
};

__host__ __device__ __forceinline__ HeadsLayout heads_layout(int K, int G,
                                                             int D, int ct,
                                                             int rowb,
                                                             int nst) {
  HeadsLayout L;
  L.H = K * G;
  L.lanes = kThreads / L.H;
  const int r = L.H >= 32 || 32 % L.H != 0 ? 1 : 32 / L.H < 4 ? 4 : 32 / L.H;
  L.rsc = ct + ((r - ct) % 32 + 32) % 32;
  L.sc_bytes = round16(static_cast<int64_t>(L.H) * L.rsc * 4);
  L.sp_bytes = round16(ct * 4);
  L.stage = L.sc_bytes + L.sp_bytes + round16(static_cast<int64_t>(ct) * rowb);
  const int64_t red = static_cast<int64_t>(L.lanes) * L.H * (D + 2) * 4;
  L.shm = round16(nst * L.stage > red ? nst * L.stage : red);
  return L;
}

// Block (split x, batch row y), for one query head a kv head and a shard
// of D = 4 or 8 head dims: the split's (m, l, acc[D]) of every head.  Thread (slot lane sl, head h)
// runs its own online softmax over slots sl, sl + lanes, ... of each
// stage, with the D sums of p * v in registers (no barrier between the
// softmax and p * v); the slot lanes then merge pairwise in a fixed tree.
template <typename TK, int D>
__global__ void __launch_bounds__(kThreads, 4)
combine_heads_kernel(const float* __restrict__ s, const TK* __restrict__ v,
                     const int32_t* __restrict__ slot_pos,
                     const int32_t* __restrict__ pos_p,
                     float* __restrict__ part_ml,
                     float* __restrict__ part_acc, int64_t W, int K, int G,
                     int ct, int nst, int64_t sps, int64_t window) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int rowb = K * D * static_cast<int>(sizeof(TK));
  const HeadsLayout L = heads_layout(K, G, D, ct, rowb, nst);
  const int H = L.H, lanes = L.lanes;
  const int64_t split = blockIdx.x, b = blockIdx.y;
  const int64_t wb = split * sps;
  const int64_t we = W - wb < sps ? W : wb + sps;
  const int nch = static_cast<int>((we - wb + ct - 1) / ct);
  const int32_t pos = *pos_p, lo = live_from(pos, window);
  const float* sb = s + b * H * W;
  const unsigned char* vb =
      reinterpret_cast<const unsigned char*>(v) + b * W * rowb;
  auto load_stage = [&](int c) {  // an empty group past the last stage
    const int64_t w0 = wb + static_cast<int64_t>(c) * ct;
    const int cn = static_cast<int>(we - w0 < ct ? we - w0 : ct);
    unsigned char* st = smem + c % nst * L.stage;
    if (c < nch) {
      stage_rows(st, reinterpret_cast<const unsigned char*>(sb + w0), H,
                 cn * 4, W * 4, L.rsc * 4);
      stage_rows(st + L.sc_bytes,
                 reinterpret_cast<const unsigned char*>(slot_pos + w0), 1,
                 cn * 4, 0, 0);
      stage_rows(st + L.sc_bytes + L.sp_bytes, vb + w0 * rowb, cn, rowb,
                 rowb, rowb);
    }
    cp_commit();
  };
  const int sl = threadIdx.x / H, h = threadIdx.x - sl * H;
  const bool active = sl < lanes;
  const int kh = h / G;
  float m = -INFINITY, l = 0.0f, acc[D];
#pragma unroll
  for (int e = 0; e < D; ++e) acc[e] = 0.0f;
  for (int c = 0; c < nst - 1; ++c) load_stage(c);
  for (int c = 0; c < nch; ++c) {
    cp_wait_but(nst - 2);
    __syncthreads();
    load_stage(c + nst - 1);
    const int64_t w0 = wb + static_cast<int64_t>(c) * ct;
    const int cn = active ? static_cast<int>(we - w0 < ct ? we - w0 : ct) : 0;
    const unsigned char* st = smem + c % nst * L.stage;
    const float* sr = reinterpret_cast<const float*>(st) + h * L.rsc;
    const int32_t* spc = reinterpret_cast<const int32_t*>(st + L.sc_bytes);
    const TK* vk =
        reinterpret_cast<const TK*>(st + L.sc_bytes + L.sp_bytes) + kh * D;
#pragma unroll 2
    for (int w = sl; w < cn; w += lanes) {
      const int32_t sp = spc[w];
      const float x = sp >= lo && sp <= pos ? sr[w] : kMasked;
      if (x > m) {  // a new max: rescale what came before
        const float r = __expf(m - x);
        l *= r;
#pragma unroll
        for (int e = 0; e < D; ++e) acc[e] *= r;
        m = x;
      }
      const float p = __expf(x - m);
      float vv[D];
      load_f32<TK, D>(vk + w * (K * D), vv);
      l += p;
#pragma unroll
      for (int e = 0; e < D; ++e) acc[e] = fmaf(p, vv[e], acc[e]);
    }
  }
  // the slot lanes pairwise, in a fixed tree, over the ring (no copy is in
  // flight: the groups past the last stage are empty)
  float* red = reinterpret_cast<float*>(smem);
  for (int n = lanes; n > 1;) {
    const int half = (n + 1) / 2;
    __syncthreads();
    if (active && sl >= half && sl < n) {
      float* r = red + (sl * H + h) * (D + 2);
      r[0] = m;
      r[1] = l;
#pragma unroll
      for (int e = 0; e < D; ++e) r[2 + e] = acc[e];
    }
    __syncthreads();
    if (sl + half < n) {
      const float* r = red + ((sl + half) * H + h) * (D + 2);
      merge_into<D>(m, l, acc, D, r[0], r[1], r + 2);
    }
    n = half;
  }
  if (sl == 0) {
    const int64_t row = (b * gridDim.x + split) * H + h;
    part_ml[row * 2] = m;
    part_ml[row * 2 + 1] = l;
#pragma unroll
    for (int e = 0; e < D; ++e) part_acc[row * D + e] = acc[e];
  }
}

// Block bh = (b, h): out[b, h, :] from the S splits' partials.  Thread
// (grp, q) merges splits grp, grp + groups, ... online over head dims
// q * dm .. q * dm + dm (dm = 4 where hdl allows: 16-byte reads), then
// the groups merge pairwise in a fixed tree: out = sum_s e^(m_s - M)
// acc_s / sum_s e^(m_s - M) l_s, rounded the same way at any B.
__global__ void __launch_bounds__(kMergeThreads)
merge_kernel(const float* __restrict__ part_ml,
             const float* __restrict__ part_acc, float* __restrict__ out,
             int S, int H, int hdl) {
  __shared__ float red[6][kMergeThreads];
  const int64_t bh = blockIdx.x, b = bh / H;
  const int h = static_cast<int>(bh % H);
  const int tid = threadIdx.x;
  const int dm = hdl % 4 == 0 ? 4 : 1, per = hdl / dm;
  const int groups = kMergeThreads / per, grp = tid / per;
  const int q = tid - grp * per;
  const float2* ml =
      reinterpret_cast<const float2*>(part_ml) + b * S * H + h;  // j at jH
  const float* pa = part_acc + (b * S * H + h) * hdl + q * dm;  // j H hdl
  float m = -INFINITY, l = 0.0f, a[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  if (grp < groups) {
#pragma unroll 4
    for (int j = grp; j < S; j += groups) {
      const float2 r = ml[static_cast<int64_t>(j) * H];
      const float* x = pa + static_cast<int64_t>(j) * H * hdl;
      float xv[4];
      if (dm == 4) {
        const float4 x4 = *reinterpret_cast<const float4*>(x);
        xv[0] = x4.x, xv[1] = x4.y, xv[2] = x4.z, xv[3] = x4.w;
      } else {
        xv[0] = x[0];
      }
      merge_into<4>(m, l, a, dm, r.x, r.y, xv);
    }
  }
  // the groups pairwise, in a fixed tree: group i takes group i + half
  int n = groups < S ? groups : S;
  while (n > 1) {
    const int half = (n + 1) / 2;
    if (grp >= half && grp < n) {
      red[0][tid] = m;
      red[1][tid] = l;
#pragma unroll
      for (int e = 0; e < 4; ++e) red[2 + e][tid] = a[e];
    }
    __syncthreads();
    if (grp + half < n) {
      const int o = tid + half * per;
      const float a2[4] = {red[2][o], red[3][o], red[4][o], red[5][o]};
      merge_into<4>(m, l, a, dm, red[0][o], red[1][o], a2);
    }
    __syncthreads();
    n = half;
  }
  if (tid < per)
    for (int e = 0; e < dm; ++e) out[bh * hdl + q * dm + e] = a[e] / l;
}

// Block (slot range x, batch row y), bf16 q and k with 5 to 8 query heads
// a kv head and hdl a multiple of 16: the scores from tensor cores.  A
// warp takes 16 slots of a stage and one kv head: mma.sync m16n8k16 with
// A = k [16 slots, 16 dims] (ldmatrix from the padded rows: 16 bytes of
// 8 rows at 1040 bytes apart are distinct banks), B = q [16 dims, 8 query
// heads] (bf16 in shared memory; the heads past G zero) and fp32 sums.
// The products of two bf16 are exact in fp32, so this is the CUDA cores'
// arithmetic in another order of summation; at 8 query heads the CUDA
// cores need about 1.4 instructions a multiply-add, at 4 multiply-adds a
// byte of k, more than an SM runs while HBM streams its share.
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(kThreads)
scores_mma_kernel(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ k, float* __restrict__ s,
                  int64_t W, int K, int G, int hdl, int lts, int nst,
                  int64_t per_block, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ts = 1 << lts;
  const int H = K * G;
  const int rowb = K * hdl * 2;
  const int rs = static_cast<int>(round16(rowb)) + 16;  // padded row
  const int stage = ts * rs;
  unsigned short* qs = reinterpret_cast<unsigned short*>(smem);  // [H, hdl]
  unsigned char* ring = smem + round16(static_cast<int64_t>(H) * hdl * 2);
  const int64_t b = blockIdx.y;
  const int64_t wb = static_cast<int64_t>(blockIdx.x) * per_block;
  const int64_t nw = (W - wb < per_block ? W : wb + per_block) - wb;
  const int nch = static_cast<int>((nw + ts - 1) >> lts);
  const unsigned char* kb =
      reinterpret_cast<const unsigned char*>(k) + (b * W + wb) * rowb;
  auto load_stage = [&](int c) {  // an empty group past the last stage
    const int64_t w0 = static_cast<int64_t>(c) << lts;
    const int cn = static_cast<int>(nw - w0 < ts ? nw - w0 : ts);
    if (c < nch)
      stage_rows(ring + c % nst * stage, kb + w0 * rowb, cn, rowb, rowb,
                 rs);
    cp_commit();
  };
  for (int c = 0; c < nst - 1; ++c) load_stage(c);
  const unsigned short* qb =
      reinterpret_cast<const unsigned short*>(q) + b * H * hdl;
  for (int i = threadIdx.x; i < H * hdl; i += kThreads) qs[i] = qb[i];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int groups = ts >> 4, tiles = groups * K;  // (16 slots, kv head)
  // the lane's A row and column half, B column (query head) and k pair
  const int ar = (lane & 7) + ((lane >> 3) & 1) * 8, ac = (lane >> 4) * 8;
  const int bn = lane >> 2, bk = (lane & 3) * 2;
  float* sbh = s + b * H * W + wb;
  for (int c = 0; c < nch; ++c) {
    cp_wait_but(nst - 2);
    __syncthreads();
    load_stage(c + nst - 1);
    const int64_t w0 = static_cast<int64_t>(c) << lts;
    const int cn = static_cast<int>(nw - w0 < ts ? nw - w0 : ts);
    const unsigned char* st = ring + c % nst * stage;
    for (int tile = warp; tile < tiles; tile += kThreads / 32) {
      const int sg = tile % groups, kh = tile / groups;
      if (sg * 16 >= cn) continue;
      const unsigned char* arow =
          st + (sg * 16 + ar) * rs + (kh * hdl + ac) * 2;
      const unsigned short* qh = qs + (kh * G + bn) * hdl + bk;
      float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      for (int ks = 0; ks < hdl; ks += 16) {
        uint32_t a[4];
        ldmatrix_x4(a, arow + ks * 2);
        const uint32_t b0 =
            bn < G ? *reinterpret_cast<const uint32_t*>(qh + ks) : 0u;
        const uint32_t b1 =
            bn < G ? *reinterpret_cast<const uint32_t*>(qh + ks + 8) : 0u;
        mma_bf16(d, a, b0, b1);
      }
      // d[0], d[1]: slot lane / 4, heads bk, bk + 1; d[2], d[3]: slot + 8
      const int slot = sg * 16 + (lane >> 2);
      float* out = sbh + static_cast<int64_t>(kh * G + bk) * W + w0 + slot;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int g = bk + (j & 1), sj = slot + (j >> 1) * 8;
        if (g < G && sj < cn)
          out[static_cast<int64_t>(j & 1) * W + (j >> 1) * 8] = d[j] * scale;
      }
    }
  }
}

cudaError_t allow_shared(const void* fn, int64_t shm) {
  if (shm > kMaxShared) return cudaErrorInvalidValue;
  if (shm <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(shm));
}

cudaError_t run_scores_mma(const void* q, const void* k, float* s, int64_t B,
                           int64_t W, int K, int G, int hdl, int lts,
                           int nst, int64_t per_block, float scale,
                           cudaStream_t stream) {
  const int64_t rs = round16(static_cast<int64_t>(K) * hdl * 2) + 16;
  const int64_t shm = round16(static_cast<int64_t>(K) * G * hdl * 2) +
                      nst * (static_cast<int64_t>(1) << lts) * rs;
  const cudaError_t e =
      allow_shared(reinterpret_cast<const void*>(scores_mma_kernel), shm);
  if (e != cudaSuccess) return e;
  const dim3 grid(static_cast<unsigned>((W + per_block - 1) / per_block),
                  static_cast<unsigned>(B));
  scores_mma_kernel<<<grid, kThreads, static_cast<size_t>(shm), stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k), s, W, K, G, hdl, lts, nst,
      per_block, scale);
  return cudaGetLastError();
}

template <typename TK, int VE, int GW>
cudaError_t run_scores(const void* q, int q_bf16, const void* k, float* s,
                       int64_t B, int64_t W, int K, int G, int hdl, int lts,
                       int nst, int64_t per_block, float scale,
                       cudaStream_t stream) {
  const int64_t rs = round16(static_cast<int64_t>(K) * hdl * sizeof(TK)) + 16;
  const int64_t shm = round16(static_cast<int64_t>(K) * G * hdl * 4) +
                      nst * (static_cast<int64_t>(1) << lts) * rs;
  const cudaError_t e = allow_shared(
      reinterpret_cast<const void*>(scores_kernel<TK, VE, GW>), shm);
  if (e != cudaSuccess) return e;
  const dim3 grid(static_cast<unsigned>((W + per_block - 1) / per_block),
                  static_cast<unsigned>(B));
  scores_kernel<TK, VE, GW><<<grid, kThreads, static_cast<size_t>(shm),
                              stream>>>(q, q_bf16, static_cast<const TK*>(k),
                                        s, W, K, G, hdl, lts, nst, per_block,
                                        scale);
  return cudaGetLastError();
}

template <typename TK, int VE>
cudaError_t scores_by_group(const void* q, int q_bf16, const void* k,
                            float* s, int64_t B, int64_t W, int K, int G,
                            int hdl, int lts, int nst, int64_t per_block,
                            float scale, cudaStream_t stream) {
  if (G <= 1)
    return run_scores<TK, VE, 1>(q, q_bf16, k, s, B, W, K, G, hdl, lts, nst,
                                 per_block, scale, stream);
  if (G <= 2)
    return run_scores<TK, VE, 2>(q, q_bf16, k, s, B, W, K, G, hdl, lts, nst,
                                 per_block, scale, stream);
  if (G <= 4)
    return run_scores<TK, VE, 4>(q, q_bf16, k, s, B, W, K, G, hdl, lts, nst,
                                 per_block, scale, stream);
  return run_scores<TK, VE, 8>(q, q_bf16, k, s, B, W, K, G, hdl, lts, nst,
                               per_block, scale, stream);
}

template <typename TK>
cudaError_t scores_by_width(const void* q, int q_bf16, const void* k,
                            float* s, int64_t B, int64_t W, int K, int G,
                            int hdl, int lts, int nst, int64_t per_block,
                            float scale, cudaStream_t stream) {
  constexpr int kWide = 16 / static_cast<int>(sizeof(TK));
  if (hdl % kWide == 0)
    return scores_by_group<TK, kWide>(q, q_bf16, k, s, B, W, K, G, hdl, lts,
                                      nst, per_block, scale, stream);
  if (kWide == 8 && hdl % 4 == 0)  // bf16 runs of 4: 8-byte reads
    return scores_by_group<TK, 4>(q, q_bf16, k, s, B, W, K, G, hdl, lts, nst,
                                  per_block, scale, stream);
  return scores_by_group<TK, 1>(q, q_bf16, k, s, B, W, K, G, hdl, lts, nst,
                                per_block, scale, stream);
}

template <typename TK, int DV, int GW>
cudaError_t run_combine(const float* s, const void* v,
                        const int32_t* slot_pos, const int32_t* pos,
                        int64_t window, float* part, float* out, int64_t B,
                        int64_t W, int K, int G, int hdl, int ct, int nst,
                        int64_t sps, int64_t S, cudaStream_t stream) {
  const int H = K * G;
  const int cols = K * ((G + GW - 1) / GW) * (hdl / DV);
  if (cols > kThreads || H > kThreads || hdl > kMergeThreads)
    return cudaErrorInvalidValue;
  const int rowb = K * hdl * static_cast<int>(sizeof(TK));
  const CombineLayout L =
      combine_layout(K, G, hdl, ct, rowb, cols, GW * DV, nst);
  cudaError_t e = allow_shared(
      reinterpret_cast<const void*>(combine_kernel<TK, DV, GW>), L.shm);
  if (e != cudaSuccess) return e;
  float* part_ml = part;
  float* part_acc = part + ((B * S * H * 2 + 3) & ~int64_t{3});  // 16 B
  combine_kernel<TK, DV, GW><<<dim3(static_cast<unsigned>(S),
                                     static_cast<unsigned>(B)),
                                kThreads, static_cast<size_t>(L.shm),
                                stream>>>(s, static_cast<const TK*>(v),
                                          slot_pos, pos, part_ml, part_acc,
                                          W, K, G, hdl, ct, nst, sps, window);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  merge_kernel<<<static_cast<unsigned>(B * H), kMergeThreads, 0, stream>>>(
      part_ml, part_acc, out, static_cast<int>(S), H, hdl);
  return cudaGetLastError();
}

template <typename TK, int D>
cudaError_t run_combine_heads(const float* s, const void* v,
                              const int32_t* slot_pos, const int32_t* pos,
                              int64_t window, float* part, float* out,
                              int64_t B, int64_t W, int K, int G, int ct,
                              int nst, int64_t sps, int64_t S,
                              cudaStream_t stream) {
  const int H = K * G;
  if (H > kThreads) return cudaErrorInvalidValue;
  const HeadsLayout L = heads_layout(
      K, G, D, ct, K * D * static_cast<int>(sizeof(TK)), nst);
  cudaError_t e = allow_shared(
      reinterpret_cast<const void*>(combine_heads_kernel<TK, D>), L.shm);
  if (e != cudaSuccess) return e;
  float* part_ml = part;
  float* part_acc = part + ((B * S * H * 2 + 3) & ~int64_t{3});  // 16 B
  combine_heads_kernel<TK, D><<<dim3(static_cast<unsigned>(S),
                                     static_cast<unsigned>(B)),
                                kThreads, static_cast<size_t>(L.shm),
                                stream>>>(s, static_cast<const TK*>(v),
                                          slot_pos, pos, part_ml, part_acc,
                                          W, K, G, ct, nst, sps, window);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  merge_kernel<<<static_cast<unsigned>(B * H), kMergeThreads, 0, stream>>>(
      part_ml, part_acc, out, static_cast<int>(S), H, D);
  return cudaGetLastError();
}

template <typename TK, int DV>
cudaError_t combine_by_group(const float* s, const void* v,
                             const int32_t* slot_pos, const int32_t* pos,
                             int64_t window, float* part, float* out,
                             int64_t B, int64_t W, int K, int G, int hdl,
                             int ct, int nst, int64_t sps, int64_t S,
                             cudaStream_t stream) {
  if (G <= 1)
    return run_combine<TK, DV, 1>(s, v, slot_pos, pos, window, part, out, B,
                                  W, K, G, hdl, ct, nst, sps, S, stream);
  if (G <= 2)
    return run_combine<TK, DV, 2>(s, v, slot_pos, pos, window, part, out, B,
                                  W, K, G, hdl, ct, nst, sps, S, stream);
  if (G <= 4)
    return run_combine<TK, DV, 4>(s, v, slot_pos, pos, window, part, out, B,
                                  W, K, G, hdl, ct, nst, sps, S, stream);
  return run_combine<TK, DV, 8>(s, v, slot_pos, pos, window, part, out, B, W,
                                K, G, hdl, ct, nst, sps, S, stream);
}

template <typename TK>
cudaError_t combine_by_width(const float* s, const void* v,
                             const int32_t* slot_pos, const int32_t* pos,
                             int64_t window, float* part, float* out,
                             int64_t B, int64_t W, int K, int G, int hdl,
                             int ct, int nst, int64_t sps, int64_t S,
                             cudaStream_t stream) {
  // one query head a kv head and 4 or 8 dims a shard: a thread a head
  // (at more query heads its threads would widen the same v G times)
  if (G == 1 && hdl == 4)
    return run_combine_heads<TK, 4>(s, v, slot_pos, pos, window, part, out,
                                    B, W, K, G, ct, nst, sps, S, stream);
  if (G == 1 && hdl == 8)
    return run_combine_heads<TK, 8>(s, v, slot_pos, pos, window, part, out,
                                    B, W, K, G, ct, nst, sps, S, stream);
  // the widest run of head dims (8, 4 or 1) dividing hdl that keeps a
  // thread's sums (query heads x head dims) at 32 and leaves a slot 8
  // columns or more (32 slot lanes at most)
  const int gw = G <= 1 ? 1 : G <= 2 ? 2 : G <= 4 ? 4 : 8;
  const int64_t run = static_cast<int64_t>(K) * ((G + 7) / 8) * hdl;
  if (hdl % 8 == 0 && gw * 8 <= 32 && run / 8 >= 8)
    return combine_by_group<TK, 8>(s, v, slot_pos, pos, window, part, out, B,
                                   W, K, G, hdl, ct, nst, sps, S, stream);
  if (hdl % 4 == 0 && run / 4 >= 8)
    return combine_by_group<TK, 4>(s, v, slot_pos, pos, window, part, out, B,
                                   W, K, G, hdl, ct, nst, sps, S, stream);
  return combine_by_group<TK, 1>(s, v, slot_pos, pos, window, part, out, B,
                                 W, K, G, hdl, ct, nst, sps, S, stream);
}

bool shape_ok(int64_t B, int64_t K, int64_t G, int64_t hdl) {
  return K > 0 && G > 0 && hdl > 0 && B <= 65535 &&
         K * G * hdl <= (1 << 20) && K * hdl * 4 <= (1 << 20);
}

}  // namespace

// q_bf16 / kv_bf16: 1 for bfloat16, 0 for float32.  s [B, K * G, W] fp32.
// tile: slots a ring stage, a power of two <= 256; per_block: slots a
// block, a multiple of tile; stages: the ring's stages, 2 to 4.
extern "C" cudaError_t decode_scores_partial(
    const void* q, int q_bf16, const void* k, int kv_bf16, float* s,
    int64_t B, int64_t W, int64_t K, int64_t G, int64_t hdl, float scale,
    int64_t tile, int64_t per_block, int64_t stages, cudaStream_t stream) {
  if (B <= 0 || W <= 0) return cudaSuccess;
  int lts = 0;
  while ((int64_t{1} << lts) < tile) ++lts;
  if (!shape_ok(B, K, G, hdl) || tile <= 0 || tile > kThreads ||
      (int64_t{1} << lts) != tile || per_block < tile ||
      per_block % tile != 0 || (W + per_block - 1) / per_block > 0x7fffffff ||
      stages < 2 || stages > kMaxStages)
    return cudaErrorInvalidValue;
  const int k_ = static_cast<int>(K), g_ = static_cast<int>(G);
  const int h_ = static_cast<int>(hdl), n_ = static_cast<int>(stages);
  if (q_bf16 && kv_bf16 && G > 4 && G <= 8 && hdl % 16 == 0 && tile >= 16)
    return run_scores_mma(q, k, s, B, W, k_, g_, h_, lts, n_, per_block,
                          scale, stream);
  if (kv_bf16)
    return scores_by_width<__nv_bfloat16>(q, q_bf16, k, s, B, W, k_, g_, h_,
                                          lts, n_, per_block, scale, stream);
  return scores_by_width<float>(q, q_bf16, k, s, B, W, k_, g_, h_, lts, n_,
                                per_block, scale, stream);
}

// s [B, K * G, W] fp32 (the whole scores), v [B, W, K, hdl] -> out
// [B, K * G, hdl] fp32.  part: scratch of B * splits * K * G * 2 floats
// (rounded up to a multiple of 4), then B * splits * K * G * hdl, 16-byte
// aligned, written before it is read.  chunk: slots a ring stage;
// per_split: slots a split, a multiple of chunk, with splits * per_split
// >= W > (splits - 1) * per_split; stages: the ring's stages, 2 to 4.
extern "C" cudaError_t decode_softmax_combine(
    const float* s, const void* v, int kv_bf16, const int32_t* slot_pos,
    const int32_t* pos, int64_t window, float* part, float* out, int64_t B,
    int64_t W, int64_t K, int64_t G, int64_t hdl, int64_t chunk,
    int64_t per_split, int64_t splits, int64_t stages, cudaStream_t stream) {
  if (B <= 0) return cudaSuccess;
  if (W <= 0 || !shape_ok(B, K, G, hdl) || B * K * G > 0x7fffffff ||
      chunk <= 0 || chunk > 4096 || per_split < chunk ||
      per_split % chunk != 0 || splits <= 0 || splits > 65535 ||
      splits * per_split < W || (splits - 1) * per_split >= W ||
      stages < 2 || stages > kMaxStages)
    return cudaErrorInvalidValue;
  const int k_ = static_cast<int>(K), g_ = static_cast<int>(G);
  const int h_ = static_cast<int>(hdl), c_ = static_cast<int>(chunk);
  const int n_ = static_cast<int>(stages);
  if (kv_bf16)
    return combine_by_width<__nv_bfloat16>(s, v, slot_pos, pos, window, part,
                                           out, B, W, k_, g_, h_, c_, n_,
                                           per_split, splits, stream);
  return combine_by_width<float>(s, v, slot_pos, pos, window, part, out, B,
                                 W, k_, g_, h_, c_, n_, per_split, splits,
                                 stream);
}
