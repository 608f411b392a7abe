// FlashAttention-2 forward for grouped-query attention (Hopper, sm_90a).
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/flash_attention.py::_flash_kernel (wrapper
// flash_attention).  q is (B, Hq, S, D), k and v (B, Hkv, S, D), all of one
// type, float32 or bfloat16, contiguous; query head h reads KV head
// h / (Hq / Hkv).  For each query row it computes, as _flash_kernel does:
//
//   q' = q * (1 / sqrt(D))        rounded in q's type (flash_attention.py:47)
//   s  = q' . k                   in float32 (:50)
//   s  = cap * tanh(s / cap)      when a soft-cap is given, before the mask
//   s  = -1e30                    where the causal (k_pos <= q_pos) or window
//                                 (k_pos > q_pos - window) mask excludes k
//   online softmax over key tiles in float32: running max m, sum l and
//   accumulator acc, rescaled by exp(m_prev - m_new) at every tile (:63-70)
//   out = acc / max(l, 1e-30)     in q's type (:74)
//   lse = m + log(max(l, 1e-30))  float32, (B, Hq, S): the row's
//                                 log-sum-exp of its capped, masked scores
//                                 in natural log, written only when the
//                                 caller passes a buffer (the training
//                                 forward; csrc/flash_attention_bwd.cu reads
//                                 it to form P = exp(s - lse))
//   out_f32 = acc / max(l, 1e-30) float32, the bf16 kernel's output before
//                                 its rounding, likewise only on request:
//                                 the backward's Di = rowsum(d_out * out)
//                                 takes it, as autograd of the float32
//                                 softmax does (the float32 kernel's out is
//                                 that already)
//
// Positions are absolute, from 0 for queries and keys alike.  Any S is
// taken: the tail tiles are masked (a key past S is excluded like a masked
// one, a query row past S is never written).  The TPU block shapes and the
// S % block == 0 restriction of the Pallas wrapper do not carry over.
//
// Two kernels, chosen by the type alone (flash_attention_launch):
//
// * bfloat16: flash_tc_kernel, on the tensor cores.  One block of two
//   warpgroups per (b, h, 128-row query tile); each warpgroup owns 64
//   query rows.  Q and the bf16 K and V tiles of 64 keys come in by TMA,
//   K and V into a ring of 2 stages at D = 256 and 4 below, each stage
//   signalled full on an mbarrier; the warpgroup that releases a stage
//   last refills it with the tile STAGES on, so loads run ahead of the
//   products.  Per key tile a warpgroup runs S = Q K^T by wgmma with both
//   operands in shared memory (swizzled as TMA lays them out: 128-byte
//   rows at D = 64, 128 and 256, 64-byte at D = 32, 32-byte at D = 80 and
//   112),
//   the soft-cap, mask and online softmax on the S fragment in registers,
//   and O += P V by wgmma with P in registers (the accumulator layout of S
//   is the A-operand layout of P) and V read from shared memory as an
//   MN-major operand.  The two warpgroups run independently, so one's
//   softmax overlaps the other's products.  Shared memory at D = 256: Q
//   64 KiB + 2 stages x (K + V) 64 KiB = 192 KiB; at D = 80: 20 KiB + 4 x
//   20 KiB; at D = 112: 28 KiB + 4 stages x 28 KiB = 140 KiB.  P V is one
//   m64nDk16 product per 16 keys (V's subtiles are its MN atoms; m64n80k16
//   at D = 80, 40 accumulators a thread; m64n112k16 at D = 112, 56).
//   D = 80 and D = 112 are not padded: Q K^T takes five and seven k16
//   steps, one per 16-column subtile.
//   There is no producer warp: ptxas compiles the whole kernel under its
//   launch bound's register cap (168 a thread at 384 threads, and also at
//   288, which it rounds up to whole warpgroups) whatever setmaxnreg grants
//   at run time, while the D = 256 consumer needs about 215 (O alone is 128);
//   with a producer warpgroup it spilled and ptxas serialised its wgmma
//   (ptxas -v).
//
//   Numerics.  The products take bf16 operands and accumulate in fp32, as
//   the reference's dots do.  P is fp32 in the reference; rounding it to
//   bf16 (up to 2^-8 relative per weight) puts some per cent of the
//   outputs of diffuse attention outside the bf16 band of one output ulp
//   (tests/test_torch_flash_numerics.py shows it on the CPU), so P goes
//   in as a hi/lo pair, P = bf16(P) + bf16(P - bf16(P)), two P V
//   products (2^-16 per weight): 1.5 times the tensor-core work of one.
//   l sums the fp32 P.  exp is ex2.approx of (x - m) log2(e); the cap's tanh is built as
//   1 - 2 / (2^(2 x log2(e) / cap) + 1) from ex2.approx and rcp.approx
//   (within two float32 ulps of the cap: 2.4e-5 of a score at 50), not
//   tanh.approx, whose 2^-11 would move the scores by 0.02.  The final
//   division and the roundings of q' and out are IEEE.
//
// * float32: flash_fwd_kernel, the first version, on the fp32 units.  One
//   block of 256 threads per (b, h, 64-row query tile) stages the query
//   tile, pre-scaled, and each key tile's K and V as float32 in shared
//   memory (212 KiB at D = 256), computes q.k and p.v with FMAs over D and
//   keeps m, l and the accumulator in registers; expf and tanhf are IEEE.
//   It is the fp32 path of the decode-vs-prefill check, exact to fp32
//   rounding.
//
// Skipped tiles: a block visits only the key tiles that hold at least one
// unmasked (query, key) pair of its rows, [max(0, q0 - window + 1), q_last]
// under the causal mask.  That gives the reference's result because every
// row keeps its diagonal (k_pos = q_pos is never masked): a tile in which all
// of a row's entries are masked, before the row's first unmasked key, adds
// exp(-1e30 - (-1e30)) = 1 per entry to l and acc in the reference's
// arithmetic, and the row's first real tile multiplies both by
// exp(-1e30 - m) = 0.  Tiles that are visited reproduce that arithmetic as
// it stands, so a row whose keys in a visited tile are all masked is erased
// the same way.  The heaviest query tiles (the last, under the causal mask)
// are scheduled first.
//
// Bound on the card: 4 D operations (two multiply-adds in q.k and two in
// p.v) per unmasked (query, key) pair and head, against the H100's
// 989 TFLOP/s of dense bf16 tensor-core work; at gemma2-9b's prefill shape
// (B 2, Hq 16, S 8192, D 256) that is 1.1 ms for a global layer and 0.83 ms
// for a local one (window 4096); at hubert-xlarge's (B 2, H 16, S 8192,
// D 80, non-causal) 0.69 ms; at zamba2-7b's shared block (B 2, H 32,
// S 8192, D 112, causal) 0.97 ms.  The bytes (q, k, v read once, out written
// once, 0.4 GB) take 0.12 ms: bound by operations.  The hi/lo P costs the
// tensor-core path 1.5 times that work; the fp32 path runs at 67 TFLOP/s.
//
// No atomics and a fixed order of every sum, so every launch gives the
// same bits.  Asking for lse (and out_f32) adds stores after the output's
// and changes no arithmetic of out: its bits are the same with and without.
// Both kernels hold m in natural units (the tensor-core one only evaluates
// exp(x - m) as ex2((x - m) log2 e)), so lse needs no change of base.
#include "hopper_common.cuh"

namespace simt {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // key rows per tile
constexpr int kThreads = 256;  // a 16 x 16 grid of threads
constexpr int kLDP = kBK + 4;  // padded row of the probability tile
constexpr float kNegInf = -1e30f;

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         ((size_t)(kBQ + 2 * kBK) * (D + 4) + (size_t)kBQ * kLDP);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ out,
                     float* __restrict__ lse, int hq, int hkv, int s,
                     float scale, int causal, int window, float softcap) {
  static_assert(D % 16 == 0, "D must be a multiple of 16");
  constexpr int LD = D + 4;     // padded row of the Q, K and V tiles
  constexpr int CPT = D / 16;   // output columns per thread
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // [kBQ][LD]
  float* ks = qs + kBQ * LD;                    // [kBK][LD]
  float* vs = ks + kBK * LD;                    // [kBK][LD]
  float* ps = vs + kBK * LD;                    // [kBQ][kLDP]

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;  // heaviest first
  const int bh = blockIdx.y;                          // b * hq + h
  const int b = bh / hq, h = bh % hq;
  const size_t q_off = (size_t)bh * s * D;
  const size_t kv_off = ((size_t)b * hkv + h / (hq / hkv)) * s * D;

  const float sc = scale;
  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, c = i % D;
    float x = 0.0f;
    if (q0 + r < s)
      x = q[q_off + (size_t)(q0 + r) * D + c] * sc;
    qs[r * LD + c] = x;
  }

  // the key tiles holding an unmasked pair of this block's rows
  const int q_last = min(q0 + kBQ, s) - 1;
  const int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  const int k_end = causal ? q_last + 1 : s;

  float m[4], l[4], acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.0f;
  }

  for (int k0 = k_begin / kBK * kBK; k0 < k_end; k0 += kBK) {
    __syncthreads();  // the previous tile's K, V and P are consumed
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int r = i / D, c = i % D;
      float kx = 0.0f, vx = 0.0f;
      if (k0 + r < s) {
        const size_t g = kv_off + (size_t)(k0 + r) * D + c;
        kx = k[g];
        vx = v[g];
      }
      ks[r * LD + c] = kx;
      vs[r * LD + c] = vx;
    }
    __syncthreads();

    // scores of rows 4 ty + i against keys tx + 16 j
    float st[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) st[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(qs + (ty * 4 + i) * LD + d);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(ks + (tx + 16 * j) * LD + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          st[i][j] = fmaf(qv[i].x, kv[j].x, st[i][j]);
          st[i][j] = fmaf(qv[i].y, kv[j].y, st[i][j]);
          st[i][j] = fmaf(qv[i].z, kv[j].z, st[i][j]);
          st[i][j] = fmaf(qv[i].w, kv[j].w, st[i][j]);
        }
    }

    // soft-cap, mask, online softmax; the 16 lanes of a row share m and l
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty * 4 + i;
      float rmax = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float x = st[i][j];
        if (softcap > 0.0f) x = softcap * tanhf(x / softcap);
        const int kj = k0 + tx + 16 * j;
        bool keep = kj < s;
        if (causal) keep = keep && kj <= qi;
        if (window > 0) keep = keep && kj > qi - window;
        x = keep ? x : kNegInf;
        st[i][j] = x;
        rmax = fmaxf(rmax, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, off));
      const float m_new = fmaxf(m[i], rmax);
      float rsum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(st[i][j] - m_new);
        ps[(ty * 4 + i) * kLDP + tx + 16 * j] = p;
        rsum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rsum += __shfl_xor_sync(0xffffffffu, rsum, off);
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + rsum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

    // acc += P V over the tile's keys, in key order
#pragma unroll 2
    for (int kk = 0; kk < kBK; kk += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pv[i] = *reinterpret_cast<const float4*>(ps + (ty * 4 + i) * kLDP + kk);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float vr[CPT];
#pragma unroll
        for (int c = 0; c < CPT; ++c) vr[c] = vs[(kk + e) * LD + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = e == 0 ? pv[i].x : e == 1 ? pv[i].y
                        : e == 2 ? pv[i].z : pv[i].w;
#pragma unroll
          for (int c = 0; c < CPT; ++c) acc[i][c] = fmaf(p, vr[c], acc[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty * 4 + i;
    if (qi >= s) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    float* row = out + q_off + (size_t)qi * D;
#pragma unroll
    for (int c = 0; c < CPT; ++c) row[tx + 16 * c] = acc[i][c] / denom;
    if (lse != nullptr && tx == 0)
      lse[(size_t)bh * s + qi] = m[i] + logf(denom);
  }
}

}  // namespace simt


namespace tc {

using namespace hopper;

constexpr int kBQ = 128;       // query rows per block: two consumers of 64
constexpr int kBK = 64;        // key rows per tile
constexpr int kThreads = 256;  // two warpgroups of 64 query rows each
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// Shared-memory geometry of head dim D.  Every 64-row tile of Q, K or V is
// stored as D / W subtiles of 64 rows x W columns, each row W bf16 (128
// bytes for W = 64, 64 for W = 32, 32 for W = 16), swizzled by TMA in
// 8-row atoms.  W is the widest of 64, 32, 16 that divides D: D = 80
// (hubert-xlarge, 1280 / 16 heads) takes five 16-column subtiles with the
// 32-byte swizzle, D = 112 (zamba2-7b's shared block, 3584 / 32 heads)
// seven, so no column of a tile is padding.  STAGES is 4 below D = 256
// (D = 112: 4 stages of 28 KiB).
template <int D>
struct Cfg {
  static_assert(D % 16 == 0, "D must be a multiple of 16");
  static constexpr int W = D % 64 == 0 ? 64 : D % 32 == 0 ? 32 : 16;
  static constexpr int NSUB = D / W;              // subtiles of a tile
  static constexpr int RB = 2 * W;                // bytes of a subtile row
  static constexpr int SUB = 64 * RB;             // bytes of a subtile
  static constexpr int ATOM = 8 * RB;             // bytes of a swizzle atom
  // wgmma descriptor layout: 1 = 128B, 2 = 64B, 3 = 32B swizzle
  static constexpr int LAYOUT = W == 64 ? 1 : W == 32 ? 2 : 3;
  static constexpr int STAGES = D == 256 ? 2 : 4;
  static constexpr int Q_BYTES = 2 * NSUB * SUB;  // two halves of 64 rows
  static constexpr int KV_BYTES = 2 * NSUB * SUB; // K and V of one tile
  static constexpr int SMEM =
      1024 + Q_BYTES + STAGES * KV_BYTES + 8 * (1 + STAGES);
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_tc_kernel(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    __nv_bfloat16* __restrict__ out,
                    float* __restrict__ lse, float* __restrict__ out_f32,
                    int hq, int hkv, int s,
                    float scale, int causal, int window, float softcap) {
  using C = Cfg<D>;
  constexpr int W = C::W, NSUB = C::NSUB;
  extern __shared__ uint8_t smem_raw[];
  // 1024-byte alignment: the 128-byte swizzle repeats every 8 rows
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const gbase = smem_raw + (base - raw);
  const uint32_t q_s = base;
  const uint32_t kv_s = base + C::Q_BYTES;
  const uint32_t bar_q = kv_s + C::STAGES * C::KV_BYTES;
  auto bar_full = [&](int st) { return bar_q + 8u * (1 + st); };
  auto k_sub = [&](int st, int sub) {
    return kv_s + st * C::KV_BYTES + sub * C::SUB;
  };
  auto v_sub = [&](int st, int sub) {
    return kv_s + st * C::KV_BYTES + (NSUB + sub) * C::SUB;
  };
  auto q_sub = [&](int half, int sub) {
    return q_s + (half * NSUB + sub) * C::SUB;
  };

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;  // heaviest first
  const int bh = blockIdx.y;                          // b * hq + h
  const int kvh = (bh / hq) * hkv + (bh % hq) / (hq / hkv);
  // the key tiles holding an unmasked pair of this block's rows
  const int q_last = min(q0 + kBQ, s) - 1;
  const int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  const int k_end = causal ? q_last + 1 : s;
  const int t0 = k_begin / kBK;
  const int n_tiles = (k_end + kBK - 1) / kBK - t0;

  // Loads: thread 0 issues Q and the first STAGES key tiles; afterwards the
  // warpgroup that releases a stage last refills it with the tile STAGES on.
  __shared__ int released[C::STAGES];
  auto load_tile = [&](int t) {
    const int st = t % C::STAGES;
    mbar_expect_tx(bar_full(st), C::KV_BYTES);
    const int row = (t0 + t) * kBK;
    for (int sub = 0; sub < NSUB; ++sub) {
      tma_load_3d(k_sub(st, sub), &tk, bar_full(st), sub * W, row, kvh);
      tma_load_3d(v_sub(st, sub), &tv, bar_full(st), sub * W, row, kvh);
    }
  };
  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int st = 0; st < C::STAGES; ++st) {
      mbar_init(bar_full(st), 1);
      released[st] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(bar_q, C::Q_BYTES);
    for (int half = 0; half < 2; ++half)
      for (int sub = 0; sub < NSUB; ++sub)
        tma_load_3d(q_sub(half, sub), &tq, bar_q, sub * W, q0 + 64 * half, bh);
    for (int t = 0; t < min(n_tiles, C::STAGES); ++t) load_tile(t);
  }
  __syncthreads();

  // warpgroup `half` owns rows rb .. rb + 63
  const int half = threadIdx.x / 128;
  const int ct = threadIdx.x % 128;
  const int warp = ct / 32, lane = ct % 32;
  const int rb = q0 + 64 * half;
  // this thread's rows r0 and r0 + 8 of the fragment; its columns are
  // cq, cq + 1 of every 8-column chunk
  const int r0 = rb + 16 * warp + lane / 4;
  const int cq = 2 * (lane % 4);

  mbar_wait(bar_q, 0);
  {
    // q * scale rounded in bf16, in place (elementwise: the swizzle is
    // immaterial); then visible to the tensor cores' reads
    const float sc = __bfloat162float(__float2bfloat16_rn(scale));
    uint4* qh = reinterpret_cast<uint4*>(gbase + half * (C::Q_BYTES / 2));
    for (int i = ct; i < 64 * D / 8; i += 128) {
      uint4 w = qh[i];
      uint32_t* u = reinterpret_cast<uint32_t*>(&w);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f =
            __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&u[e]));
        u[e] = bf16x2_bits(__floats2bfloat162_rn(f.x * sc, f.y * sc));
      }
      qh[i] = w;
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + half) : "memory");
  }

  // O: this thread's D / 2 accumulators; o[4 J + 2 r + c] is row
  // r0 + 8 r, column 8 J + cq + c
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.0f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};
  const float cap_k = softcap > 0.0f ? 2.0f * kLog2e / softcap : 0.0f;

  for (int t = 0; t < n_tiles; ++t) {
    const int st = t % C::STAGES;
    mbar_wait(bar_full(st), (t / C::STAGES) & 1);
    const int k0 = (t0 + t) * kBK;

    // S = Q K^T: 64 rows x 64 keys, fp32
    float sc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = 0.0f;
    wgmma_fence();
#pragma unroll
    for (int sub = 0; sub < NSUB; ++sub) {
      const uint64_t dq =
          make_desc(q_sub(half, sub), C::ATOM, C::ATOM, C::LAYOUT);
      const uint64_t dk =
          make_desc(k_sub(st, sub), C::ATOM, C::ATOM, C::LAYOUT);
#pragma unroll
      for (int kk = 0; kk < W / 16; ++kk)  // 16 columns = 32 bytes = 2 units
        wgmma_ss_n64(sc, dq + 2 * kk, dk + 2 * kk, (sub | kk) != 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);

    // soft-cap, mask, online softmax.  sc[i] is row r0 + 8 ((i >> 1) & 1),
    // key k0 + 8 (i >> 2) + cq + (i & 1)
    const bool need_mask = k0 + kBK > s || (causal && k0 + kBK - 1 > rb) ||
                           (window > 0 && k0 <= rb + 63 - window);
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      float x = sc[i];
      if (softcap > 0.0f) x = softcap * cap_tanh(x, cap_k);
      if (need_mask) {
        const int row = r0 + 8 * ((i >> 1) & 1);
        const int col = k0 + 8 * (i >> 2) + cq + (i & 1);
        bool keep = col < s;
        if (causal) keep = keep && col <= row;
        if (window > 0) keep = keep && col > row - window;
        if (!keep) x = kNegInf;
      }
      sc[i] = x;
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], x);
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      corr[r] = ex2((m[r] - m_new) * kLog2e);
      m[r] = m_new;
      l[r] *= corr[r];
    }
    // P as a bf16 hi/lo pair in the A-operand layout: register e of k-step
    // kk holds the pair sc[8 kk + 2 e], sc[8 kk + 2 e + 1]
    uint32_t p_hi[4][4], p_lo[4][4];
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int r = (i >> 1) & 1;
      const float p0 = ex2((sc[i] - m[r]) * kLog2e);
      const float p1 = ex2((sc[i + 1] - m[r]) * kLog2e);
      l[r] += p0 + p1;
      split_hi_lo(p0, p1, p_hi[i / 8][(i % 8) / 2],
                  p_lo[i / 8][(i % 8) / 2]);
    }
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] *= corr[(i >> 1) & 1];

    // O += P V: per 16 keys (16 rows of V: whole atoms) one m64nDk16
    // product for each half of P
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint64_t dv = make_desc(v_sub(st, 0) + kk * 16 * C::RB, C::SUB,
                                    C::ATOM, C::LAYOUT);
      wgmma_rs<D>(o, p_hi[kk], dv);
      wgmma_rs<D>(o, p_lo[kk], dv);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);
    // the wait above saw this warpgroup's reads of stage st complete
    if (ct == 0 && t + C::STAGES < n_tiles) __threadfence_block();
    if (ct == 0 && t + C::STAGES < n_tiles &&
        atomicAdd(&released[st], 1) == 1) {
      released[st] = 0;
      load_tile(t + C::STAGES);
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  const size_t q_off = (size_t)bh * s * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    if (row >= s) continue;
    const float denom = fmaxf(l[r], 1e-30f);
    __nv_bfloat16* orow = out + q_off + (size_t)row * D;
#pragma unroll
    for (int c8 = 0; c8 < D / 8; ++c8) {
      const float2 f = make_float2(o[4 * c8 + 2 * r] / denom,
                                   o[4 * c8 + 2 * r + 1] / denom);
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * c8 + cq) =
          __floats2bfloat162_rn(f.x, f.y);
      if (out_f32 != nullptr)
        *reinterpret_cast<float2*>(out_f32 + q_off + (size_t)row * D +
                                   8 * c8 + cq) = f;
    }
    // m is the quad's common row maximum, in natural units
    if (lse != nullptr && (lane & 3) == 0)
      lse[(size_t)bh * s + row] = m[r] + logf(denom);
  }
}

}  // namespace tc

namespace {

using namespace hopper;

template <int D>
cudaError_t launch_simt(const void* q, const void* k, const void* v,
                        void* out, float* lse, float* /* out_f32: out */,
                        int b, int hq, int hkv, int s,
                        float scale, int causal, int window, float softcap,
                        cudaStream_t stream) {
  const size_t bytes = simt::smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      simt::flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((s + simt::kBQ - 1) / simt::kBQ, b * hq);
  simt::flash_fwd_kernel<D><<<grid, simt::kThreads, bytes, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)out, lse, hq,
      hkv, s, scale, causal, window, softcap);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_tc(const void* q, const void* k, const void* v, void* out,
                      float* lse, float* out_f32, int b, int hq, int hkv,
                      int s, float scale,
                      int causal, int window, float softcap,
                      cudaStream_t stream) {
  using C = tc::Cfg<D>;
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(out)) %
          16 != 0)
    return cudaErrorMisalignedAddress;
  CUtensorMap mq, mk, mv;
  cudaError_t err = make_map(&mq, q, b * hq, s, D, C::W);
  if (err == cudaSuccess) err = make_map(&mk, k, b * hkv, s, D, C::W);
  if (err == cudaSuccess) err = make_map(&mv, v, b * hkv, s, D, C::W);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(tc::flash_tc_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             C::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((s + tc::kBQ - 1) / tc::kBQ, b * hq);
  tc::flash_tc_kernel<D><<<grid, tc::kThreads, C::SMEM, stream>>>(
      mq, mk, mv, (__nv_bfloat16*)out, lse, out_f32, hq, hkv, s, scale, causal,
      window, softcap);
  return cudaGetLastError();
}

#define FLASH_DISPATCH_D(fn)                                            \
  switch (d) {                                                          \
    case 32: return fn<32>(q, k, v, out, lse, out_f32, b, hq, hkv, s,   \
        scale, causal, window, softcap, st);                            \
    case 64: return fn<64>(q, k, v, out, lse, out_f32, b, hq, hkv, s,   \
        scale, causal, window, softcap, st);                            \
    case 80: return fn<80>(q, k, v, out, lse, out_f32, b, hq, hkv, s,   \
        scale, causal, window, softcap, st);                            \
    case 112: return fn<112>(q, k, v, out, lse, out_f32, b, hq, hkv, s, \
        scale, causal, window, softcap, st);                            \
    case 128: return fn<128>(q, k, v, out, lse, out_f32, b, hq, hkv, s, \
        scale, causal, window, softcap, st);                            \
    case 256: return fn<256>(q, k, v, out, lse, out_f32, b, hq, hkv, s, \
        scale, causal, window, softcap, st);                            \
    default: return cudaErrorInvalidValue;                              \
  }

cudaError_t launch(int d, int dtype, const void* q, const void* k,
                   const void* v, void* out, float* lse, float* out_f32,
                   int b, int hq, int hkv, int s, float scale, int causal,
                   int window, float softcap, cudaStream_t st) {
  if (dtype == 0) FLASH_DISPATCH_D(launch_simt)
  if (dtype == 1) FLASH_DISPATCH_D(launch_tc)
  return cudaErrorInvalidValue;
}

}  // namespace

// q (b, hq, s, d), k and v (b, hkv, s, d), out like q; contiguous, on
// `device`, of one type: dtype 0 float32 (the SIMT kernel), 1 bfloat16 (the
// tensor-core kernel; pointers 16-byte aligned).  lse: null, or float32
// (b, hq, s) for each row's log-sum-exp; out_f32: null, or float32 like q
// for the bfloat16 kernel's output before its rounding (the float32 kernel
// does not read it).  d is 32, 64, 80, 112, 128
// or 256; hq a multiple of hkv.  scale is 1/sqrt(d) as float (the bf16 kernel
// rounds it to bf16); window <= 0 means no window, softcap <= 0 no
// soft-cap.  Returns cudaGetLastError() or the first error met.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, void* lse,
                                      void* out_f32, int b, int hq, int hkv,
                                      int s, int d, int dtype,
                                      float scale, int causal, int window,
                                      float softcap, int device,
                                      void* stream) {
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return (int)err;
  if (b <= 0 || s <= 0 || hkv <= 0 || hq % hkv != 0)
    return (int)cudaErrorInvalidValue;
  return (int)launch(d, dtype, q, k, v, out, (float*)lse, (float*)out_f32, b,
                     hq, hkv, s, scale, causal, window, softcap,
                     (cudaStream_t)stream);
}
