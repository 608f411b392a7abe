// FlashAttention-2 backward for grouped-query attention (Hopper, sm_90a).
//
// The gradient of csrc/flash_attention.cu's function.  The Pallas kernel it
// stands beside, src/repro/kernels/flash_attention.py::_flash_kernel, has no
// backward: the reference trains through XLA's derivative of its jnp
// attention (src/repro/models/attention.py::_sdpa), which computes the same
// function.  These kernels give that gradient on the card, in place of
// autograd of the plain version, so that attention layers train there.
//
// Given q (B, Hq, S, D), k and v (B, Hkv, S, D), the forward's out in
// float32 (the bfloat16 kernel's before its rounding) and its row
// statistics lse (B, Hq, S, float32: the natural log-sum-exp of each row's
// capped, masked scores), and d_out like q, they produce dq, dk and dv in
// q's type (float32 or bfloat16):
//
//   q' = q * (1/sqrt(D))            rounded in q's type, as the forward
//   s  = q' . k                     float32
//   c  = cap * tanh(s / cap)        with a soft-cap, else c = s
//   P  = exp(c - lse)               0 where the causal / window mask (or the
//                                   end of the sequence) excludes the pair
//   dP = d_out . v
//   Di = sum_d d_out * out          (flash_bwd_pre_kernel, float32)
//   dS = P (dP - Di) (1 - tanh^2(s / cap))   (the last factor with a cap)
//   dv = sum over rows of P^T d_out           dk = sum of dS^T q'
//   dq = dq' * (1/sqrt(D)),  dq' = dS k
//
// Di takes the float32 out, not the bf16 out the caller receives.  Autograd
// of the plain version forms the same quantity as sum_j P dP over its float32
// softmax, which is d_out . out with out in float32.  From the rounded bf16
// out (2^-9 relative per term) dS = P (dP - Di) moved dq and dk by up to
// 0.5 % of their largest entry at small widths (measured on the CPU by this
// file's plain twin, kernels/flash_attention.py::flash_attention_bwd_plain),
// five times the bf16 band (rtol 1e-2 and 1e-3 of the leaf's max); from the
// float32 out they stay within 8e-4 of it.  dq' is rounded to q's type before
// the multiply by the scale (itself rounded to q's type), as autograd rounds
// the gradient of q' at the cast that widened it: dq = bf16(bf16(dq') *
// bf16(1/sqrt(D))) in bfloat16, dq' * fp32(1/sqrt(D)) in float32.  dk and dv
// are summed in float32 over the whole GQA group and rounded once.
//
// Two paths, chosen by the type alone (flash_attention_bwd_launch):
//
// * bfloat16, on the tensor cores (namespace tc), four launches:
//   - flash_bwd_pre_kernel: Di, one warp per row (as below);
//   - flash_bwd_scale_q: q' = bf16(q * bf16(1/sqrt(D))) once, written into
//     dq's storage, so that both product kernels read q' by TMA (the dQ
//     kernel reads each block's own rows of it before it overwrites them
//     with dq; the dK/dV kernel has run to its end before);
//   - flash_bwd_dkdv_tc: one block per (b, kv head, 64-key tile).  K and V
//     come in once by TMA and stay resident; a ring of stages (3, 2 at
//     D = 256) brings q', d_out, lse and Di of each query tile by TMA
//     (lse and Di through one-dimensional tensor maps), for each query
//     head of the GQA group in turn and each query tile the masks let
//     reach the keys.  Per tile S^T = K q'^T and dP^T = V d_out^T by wgmma
//     with both operands in shared memory and the keys as M, so that the
//     accumulator layout of S^T is the A-operand layout of P^T and dS^T
//     (the forward's trick for P V); then dV += P^T d_out and dK += dS^T q'
//     by wgmma with A from registers and B, d_out or q', an MN-major
//     operand in shared memory.  P and dS never touch shared memory.  From
//     D = 128 two warpgroups split dK's and dV's columns: warpgroup 0
//     computes S^T, warpgroup 1 dP^T, and each thread hands its fragment to
//     its twin through shared memory.
//   - flash_bwd_dq_tc: one warpgroup per (b, q head, 64-row query tile),
//     q' and d_out resident, a ring of K and V tiles; per tile S = q' K^T
//     and dP = d_out V^T by wgmma from shared memory, committed as two
//     groups so that P is formed while dP is still on the tensor cores, dS
//     in registers, then dq' += dS K with dS from registers and K an
//     MN-major operand.  The dK/dV kernel waits for S^T and dP^T together:
//     the same overlap there kept P, dP^T and the cap's derivative live at
//     once, which took the registers past three blocks an SM at D = 64 and
//     was slower on the card.  S and dP are computed twice, once per
//     kernel: with nothing summed across blocks, dq has no other
//     deterministic home (a float32 partial of dq per key tile would take
//     8.6 GB at stablelm-1.6b's train shape).
//   At D = 256 a dK/dV block owns half of the columns of its rows (grid
//   z) and a dQ block's two warpgroups a half each, so that a warpgroup's
//   accumulators fit its registers (64 for dK and dV together, 64 for
//   dq); each computes the whole S and dP.  Every tile is stored as the
//   forward's (csrc/flash_attention.cu, tc::Cfg): D / W subtiles of 64
//   rows x W columns, swizzled by TMA; D = 80 and 112 are not padded.
//
//   Numerics.  The products take bf16 operands and accumulate in fp32.  P
//   (for dV) and dS (for dK and dq) are float32 in the function; one bf16
//   rounding of either (2^-8 of each weight) moves some entries of dv, or
//   of dq and dk, outside the bf16 band (shown on the CPU by
//   tests/test_torch_flash_bwd_numerics.py), so each goes in as a hi/lo
//   pair, x = bf16(x) + bf16(x - bf16(x)), two products (2^-16).  exp is
//   ex2.approx of (c - lse) log2(e) and the cap's tanh the forward's
//   formula (within two float32 ulps of the cap).  The design runs 20 D
//   operations per unmasked pair and head (dK/dV: S, dP, dV and dK twice;
//   dQ: S, dP, dq twice), twice the function's 10 D: at least 1.39 ms at
//   the train shape.
//
// * float32, the first version (the anonymous namespace below), three
//   launches on the fp32 units, the check path of the float32
//   card-vs-CPU training runs:
//   - flash_bwd_pre_kernel: one warp per row, Di by a shuffle tree.
//   - flash_bwd_dkdv_kernel: one block of 256 threads (a 16 x 16 grid) per
//     (b, kv head, key tile of T keys).  It keeps its K and V tile in
//     shared memory as float32 and loops over the Hq / Hkv query heads of
//     its group and, for each, over the query tiles of T rows that the
//     causal and window masks let reach the key tile; per query tile it
//     stages q' and d_out, recomputes S and dP (a thread owns R x R of the
//     T x T tile), writes P and dS to shared memory, then adds P^T d_out
//     and dS^T q' into dv and dk (a thread owns R key rows x D / 16
//     columns, in registers).
//   - flash_bwd_dq_kernel: one block per (b, q head, query tile of T rows),
//     q' and d_out resident; it loops over the key tiles the masks let the
//     rows reach, recomputes S, dP and dS, and adds dS K into dq'.
//   T is 64 query rows and keys, and 32 at D = 256, where the dK and dV
//   accumulators of 64 keys would be 128 registers a thread and the four
//   tiles of 64 rows 260 KiB: shared memory is 4 T (D + 4) + 2 T (T + 4) +
//   2 T floats, 104 KiB at D = 64, 167 KiB at D = 128 and 139 KiB at
//   D = 256.  Every product is a float32 FMA; exp and tanh are expf and
//   tanhf (IEEE-accurate to a few ulps).
//
// Nothing is summed across blocks, in either path: a block owns the dk and
// dv rows of its key tile and sums its group's heads and query tiles in a
// fixed order, and dq has a kernel of its own.  Every launch gives the same
// bits.
//
// Bound on the card: the backward's own work is 10 D operations per unmasked
// (query, key) pair and head (S, dP, dv, dk, dq: a multiply-add over D each),
// against the H100's 989 TFLOP/s of dense bf16 tensor-core work: at
// stablelm-1.6b's train shape (B 4, H 32, S 4096, D 64, causal) 0.695 ms;
// the bytes (q, k, v, out, d_out read once, dq, dk, dv written once, lse)
// 0.54 GB, 0.16 ms: bound by operations.  The float32 kernels do 14 D (S and
// dP twice) at the 67 TFLOP/s of the fp32 units: at least 14 ms at that
// shape.
#include "hopper_common.cuh"

namespace {

constexpr int kThreads = 256;  // a 16 x 16 grid of threads

template <int D>
struct Tile {
  static_assert(D % 16 == 0, "D must be a multiple of 16");
  static constexpr int T = D == 256 ? 32 : 64;  // rows and keys of a tile
  static constexpr int R = T / 16;              // score rows of a thread
  static constexpr int LD = D + 4;    // padded row of a q', d_out, K, V tile
  static constexpr int LP = T + 4;    // padded row of a P or dS tile
  static constexpr int CPT = D / 16;  // columns of D a thread accumulates
  static constexpr size_t SMEM =
      sizeof(float) * (4 * (size_t)T * LD + 2 * (size_t)T * LP + 2 * T);
};

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// x rounded to E's type, as float
template <typename E>
__device__ __forceinline__ float rnd(float x);
template <>
__device__ __forceinline__ float rnd<float>(float x) {
  return x;
}

__device__ __forceinline__ void put(float* p, float x) { *p = x; }

// Rows row0 .. row0 + T - 1 of a (s, D) matrix into a [T][LD] float tile,
// zeros past s; with `sc` > 0 each value becomes rnd<E>(x * sc) (q').
template <int D, typename E>
__device__ __forceinline__ void stage(float* dst, const E* __restrict__ src,
                                      int row0, int s, float sc) {
  using C = Tile<D>;
  for (int i = threadIdx.x; i < C::T * D; i += kThreads) {
    const int r = i / D, c = i % D;
    float x = 0.0f;
    if (row0 + r < s) {
      x = widen(src[(size_t)(row0 + r) * D + c]);
      if (sc > 0.0f) x = rnd<E>(x * sc);
    }
    dst[r * C::LD + c] = x;
  }
}

// lse and Di of rows q0 .. q0 + T - 1 (0 past s)
template <int D>
__device__ __forceinline__ void stage_rows(float* lse_s, float* di_s,
                                           const float* __restrict__ lse,
                                           const float* __restrict__ di,
                                           int q0, int s) {
  for (int i = threadIdx.x; i < Tile<D>::T; i += kThreads) {
    const bool in = q0 + i < s;
    lse_s[i] = in ? lse[q0 + i] : 0.0f;
    di_s[i] = in ? di[q0 + i] : 0.0f;
  }
}

// acc[i][j] = sum_d a[row ty R + i][d] * b[key tx + 16 j][d]
template <int D>
__device__ __forceinline__ void tile_dot(
    float (&acc)[Tile<D>::R][Tile<D>::R], const float* a, const float* b) {
  using C = Tile<D>;
  constexpr int R = C::R, LD = C::LD;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < R; ++j) acc[i][j] = 0.0f;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    float4 av[R], bv[R];
#pragma unroll
    for (int i = 0; i < R; ++i)
      av[i] = *reinterpret_cast<const float4*>(a + (ty * R + i) * LD + d);
#pragma unroll
    for (int j = 0; j < R; ++j)
      bv[j] = *reinterpret_cast<const float4*>(b + (tx + 16 * j) * LD + d);
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) {
        acc[i][j] = fmaf(av[i].x, bv[j].x, acc[i][j]);
        acc[i][j] = fmaf(av[i].y, bv[j].y, acc[i][j]);
        acc[i][j] = fmaf(av[i].z, bv[j].z, acc[i][j]);
        acc[i][j] = fmaf(av[i].w, bv[j].w, acc[i][j]);
      }
  }
}

// P (when WRITE_P) and dS of query rows q0 + [0, T) against keys k0 + [0, T)
// into ps / dss ([T][LP], row-major by query row).
template <int D, bool WRITE_P>
__device__ __forceinline__ void scores(const float* qs, const float* dos,
                                       const float* ks, const float* vs,
                                       const float* lse_s, const float* di_s,
                                       float* ps, float* dss, int q0, int k0,
                                       int s, int causal, int window,
                                       float softcap) {
  using C = Tile<D>;
  constexpr int R = C::R, LP = C::LP;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float st[R][R], dp[R][R];
  tile_dot<D>(st, qs, ks);
  tile_dot<D>(dp, dos, vs);
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = ty * R + i;
    const int qi = q0 + row;
    const float m = lse_s[row], di = di_s[row];
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int col = tx + 16 * j;
      const int kj = k0 + col;
      float x = st[i][j], dcap = 1.0f;
      if (softcap > 0.0f) {
        const float t = tanhf(x / softcap);
        x = softcap * t;
        dcap = 1.0f - t * t;
      }
      bool keep = qi < s && kj < s;
      if (causal) keep = keep && kj <= qi;
      if (window > 0) keep = keep && kj > qi - window;
      const float p = keep ? expf(x - m) : 0.0f;
      if constexpr (WRITE_P) ps[row * LP + col] = p;
      dss[row * LP + col] = p * (dp[i][j] - di) * dcap;
    }
  }
}

// Di = rowsum(d_out * out) in float32: one warp per row
template <typename E>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_pre_kernel(const float* __restrict__ out,
                         const E* __restrict__ dout, float* __restrict__ di,
                         long long rows, int d) {
  const long long row = (long long)blockIdx.x * (kThreads / 32) +
                        threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // the whole warp leaves together
  const float* o = out + row * d;
  const E* g = dout + row * d;
  float acc = 0.0f;
  for (int c = lane; c < d; c += 32) acc = fmaf(widen(g[c]), o[c], acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) di[row] = acc;
}

template <int D, typename E>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkdv_kernel(const E* __restrict__ q, const E* __restrict__ k,
                          const E* __restrict__ v, const E* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ di, E* __restrict__ dk,
                          E* __restrict__ dv, int hq, int hkv, int s,
                          float scale, int causal, int window, float softcap) {
  using C = Tile<D>;
  constexpr int T = C::T, R = C::R, LD = C::LD, LP = C::LP, CPT = C::CPT;
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);  // [T][LD]
  float* vs = ks + T * LD;                      // [T][LD]
  float* qs = vs + T * LD;                      // [T][LD], q'
  float* dos = qs + T * LD;                     // [T][LD]
  float* ps = dos + T * LD;                     // [T][LP]
  float* dss = ps + T * LP;                     // [T][LP]
  float* lse_s = dss + T * LP;                  // [T]
  float* di_s = lse_s + T;                      // [T]

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  // key tile 0 has the most query tiles under the causal mask: first
  const int k0 = blockIdx.x * T;
  const int bkv = blockIdx.y;  // b * hkv + kv head
  const int b = bkv / hkv, kvh = bkv % hkv, g = hq / hkv;
  const size_t kv_off = (size_t)bkv * s * D;
  const float sc = rnd<E>(scale);

  stage<D>(ks, k + kv_off, k0, s, 0.0f);
  stage<D>(vs, v + kv_off, k0, s, 0.0f);

  // the query rows that reach a key of this tile
  const int q_begin = causal ? k0 : 0;
  const int q_end = window > 0 ? min(s, k0 + T - 1 + window) : s;

  float dk_acc[R][CPT], dv_acc[R][CPT];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int c = 0; c < CPT; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.0f;

  for (int hg = 0; hg < g; ++hg) {
    const size_t bh = (size_t)b * hq + kvh * g + hg;
    const E* qh = q + bh * s * D;
    const E* gh = dout + bh * s * D;
    for (int q0 = q_begin / T * T; q0 < q_end; q0 += T) {
      __syncthreads();  // the previous tile's q', d_out, P and dS consumed
      stage<D>(qs, qh, q0, s, sc);
      stage<D>(dos, gh, q0, s, 0.0f);
      stage_rows<D>(lse_s, di_s, lse + bh * s, di + bh * s, q0, s);
      __syncthreads();
      scores<D, true>(qs, dos, ks, vs, lse_s, di_s, ps, dss, q0, k0, s,
                      causal, window, softcap);
      __syncthreads();
      // dv += P^T d_out, dk += dS^T q' over the tile's rows, in row order
#pragma unroll 2
      for (int r = 0; r < T; ++r) {
        float pr[R], dr[R], gr[CPT], qr[CPT];
#pragma unroll
        for (int i = 0; i < R; ++i) {
          pr[i] = ps[r * LP + ty * R + i];
          dr[i] = dss[r * LP + ty * R + i];
        }
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          gr[c] = dos[r * LD + tx + 16 * c];
          qr[c] = qs[r * LD + tx + 16 * c];
        }
#pragma unroll
        for (int i = 0; i < R; ++i)
#pragma unroll
          for (int c = 0; c < CPT; ++c) {
            dv_acc[i][c] = fmaf(pr[i], gr[c], dv_acc[i][c]);
            dk_acc[i][c] = fmaf(dr[i], qr[c], dk_acc[i][c]);
          }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int kj = k0 + ty * R + i;
    if (kj >= s) continue;
    E* krow = dk + kv_off + (size_t)kj * D;
    E* vrow = dv + kv_off + (size_t)kj * D;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      put(krow + tx + 16 * c, dk_acc[i][c]);
      put(vrow + tx + 16 * c, dv_acc[i][c]);
    }
  }
}

template <int D, typename E>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const E* __restrict__ q, const E* __restrict__ k,
                        const E* __restrict__ v, const E* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ di, E* __restrict__ dq,
                        int hq, int hkv, int s, float scale, int causal,
                        int window, float softcap) {
  using C = Tile<D>;
  constexpr int T = C::T, R = C::R, LD = C::LD, LP = C::LP, CPT = C::CPT;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // [T][LD], q'
  float* dos = qs + T * LD;                     // [T][LD]
  float* ks = dos + T * LD;                     // [T][LD]
  float* vs = ks + T * LD;                      // [T][LD]
  float* dss = vs + T * LD;                     // [T][LP]
  float* lse_s = dss + 2 * T * LP;              // [T] (P's room unused)
  float* di_s = lse_s + T;                      // [T]

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * T;  // heaviest first
  const int bh = blockIdx.y;                        // b * hq + h
  const int b = bh / hq, h = bh % hq;
  const size_t q_off = (size_t)bh * s * D;
  const size_t kv_off = ((size_t)b * hkv + h / (hq / hkv)) * s * D;
  const float sc = rnd<E>(scale);

  stage<D>(qs, q + q_off, q0, s, sc);
  stage<D>(dos, dout + q_off, q0, s, 0.0f);
  stage_rows<D>(lse_s, di_s, lse + (size_t)bh * s, di + (size_t)bh * s, q0,
                s);

  // the key tiles holding an unmasked pair of this block's rows
  const int q_last = min(q0 + T, s) - 1;
  const int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  const int k_end = causal ? q_last + 1 : s;

  float acc[R][CPT];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.0f;

  for (int k0 = k_begin / T * T; k0 < k_end; k0 += T) {
    __syncthreads();  // the previous tile's K and dS consumed
    stage<D>(ks, k + kv_off, k0, s, 0.0f);
    stage<D>(vs, v + kv_off, k0, s, 0.0f);
    __syncthreads();
    scores<D, false>(qs, dos, ks, vs, lse_s, di_s, nullptr, dss, q0, k0, s,
                     causal, window, softcap);
    __syncthreads();
    // dq' += dS K over the tile's keys, in key order
#pragma unroll 2
    for (int j = 0; j < T; ++j) {
      float dr[R], kr[CPT];
#pragma unroll
      for (int i = 0; i < R; ++i) dr[i] = dss[(ty * R + i) * LP + j];
#pragma unroll
      for (int c = 0; c < CPT; ++c) kr[c] = ks[j * LD + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int c = 0; c < CPT; ++c) acc[i][c] = fmaf(dr[i], kr[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int qi = q0 + ty * R + i;
    if (qi >= s) continue;
    E* row = dq + q_off + (size_t)qi * D;
#pragma unroll
    for (int c = 0; c < CPT; ++c)
      put(row + tx + 16 * c, rnd<E>(acc[i][c]) * sc);
  }
}

struct Args {
  const void *q, *k, *v, *out, *lse, *dout;
  void *dq, *dk, *dv, *di;
  int b, hq, hkv, s;
  float scale;
  int causal, window;
  float softcap;
  cudaStream_t stream;
};

template <int D, typename E>
cudaError_t launch_bwd(const Args& a) {
  using C = Tile<D>;
  const E* q = static_cast<const E*>(a.q);
  const E* k = static_cast<const E*>(a.k);
  const E* v = static_cast<const E*>(a.v);
  const E* dout = static_cast<const E*>(a.dout);
  const float* lse = static_cast<const float*>(a.lse);
  float* di = static_cast<float*>(a.di);
  const long long rows = (long long)a.b * a.hq * a.s;
  const int rows_per_block = kThreads / 32;
  flash_bwd_pre_kernel<E>
      <<<(unsigned)((rows + rows_per_block - 1) / rows_per_block), kThreads,
         0, a.stream>>>(static_cast<const float*>(a.out), dout, di, rows, D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  err = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<D, E>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)C::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid_kv((a.s + C::T - 1) / C::T, a.b * a.hkv);
  flash_bwd_dkdv_kernel<D, E><<<grid_kv, kThreads, C::SMEM, a.stream>>>(
      q, k, v, dout, lse, di, static_cast<E*>(a.dk), static_cast<E*>(a.dv),
      a.hq, a.hkv, a.s, a.scale, a.causal, a.window, a.softcap);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  err = cudaFuncSetAttribute(flash_bwd_dq_kernel<D, E>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)C::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid_q((a.s + C::T - 1) / C::T, a.b * a.hq);
  flash_bwd_dq_kernel<D, E><<<grid_q, kThreads, C::SMEM, a.stream>>>(
      q, k, v, dout, lse, di, static_cast<E*>(a.dq), a.hq, a.hkv, a.s,
      a.scale, a.causal, a.window, a.softcap);
  return cudaGetLastError();
}

template <typename E>
cudaError_t launch_d(int d, const Args& a) {
  switch (d) {
    case 32: return launch_bwd<32, E>(a);
    case 64: return launch_bwd<64, E>(a);
    case 80: return launch_bwd<80, E>(a);
    case 112: return launch_bwd<112, E>(a);
    case 128: return launch_bwd<128, E>(a);
    case 256: return launch_bwd<256, E>(a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

namespace tc {

using namespace hopper;

constexpr int kT = 64;  // keys of a dK/dV block and of a dQ tile; query
                        // rows of a dK/dV tile and of a dQ warpgroup
constexpr float kLog2e = 1.4426950408889634f;

// Shared-memory geometry of a 64-row bf16 tile of head dim D, as the
// forward's (csrc/flash_attention.cu, tc::Cfg): D / W subtiles of 64 rows
// x W columns, W the widest of 64, 32, 16 that divides D, each swizzled by
// TMA in 8-row atoms.
template <int D>
struct Geo {
  static_assert(D % 16 == 0, "D must be a multiple of 16");
  static constexpr int W = D % 64 == 0 ? 64 : D % 32 == 0 ? 32 : 16;
  static constexpr int NSUB = D / W;
  static constexpr int RB = 2 * W;         // bytes of a subtile row
  static constexpr int SUB = 64 * RB;      // bytes of a subtile
  static constexpr int ATOM = 8 * RB;      // bytes of a swizzle atom
  static constexpr int LAYOUT = W == 64 ? 1 : W == 32 ? 2 : 3;
  static constexpr int TILE = NSUB * SUB;  // bytes of a 64-row tile
};

// dK/dV: NWG warpgroups, each owning DC columns of dK and dV; at NWG = 2
// warpgroup 0 computes S^T and warpgroup 1 dP^T, and they trade them
// through shared memory (XCH).  At D = 256 a block owns half of the
// columns of its dK and dV rows (NZ = 2 blocks, grid z), so that a
// warpgroup's accumulators fit its registers; it computes the whole S^T
// and dP^T all the same.  A ring of STAGES holds q', d_out and the
// rows' lse and Di (ROWS bytes: a TMA box must start on 16 bytes, so each
// comes as a box of RBOX = 68 floats from the row's start rounded down to
// a multiple of 4, each in 384 bytes).
template <int D>
struct DkdvCfg {
  using G = Geo<D>;
  static constexpr int NWG = D >= 128 ? 2 : 1;
  static constexpr int NZ = D == 256 ? 2 : 1;
  static constexpr int DC = D / NZ / NWG;
  static constexpr int THREADS = 128 * NWG;
  static constexpr int STAGES = D == 256 ? 2 : 3;
  static constexpr int RBOX = kT + 4;
  static constexpr int ROWS = 2 * 384;
  static constexpr int XCH = NWG == 2 ? 2 * 32 * 128 * 4 : 0;
  static constexpr int SMEM = 1024 + (2 + 2 * STAGES) * G::TILE +
                              STAGES * ROWS + XCH + 8 * (1 + STAGES);
  static_assert(NWG * NZ == 1 || DC % G::W == 0,
                "a warpgroup's columns must be whole subtiles");
  static_assert(SMEM <= 232448, "dK/dV shared memory");
};

// dQ: a block of 64 query rows, q' and d_out resident, a ring of STAGES K
// and V tiles (two blocks an SM fit from D = 80 to 128, three at D = 64).
// At D = 256 two warpgroups each own half of dq's columns, so that the
// accumulators fit the registers; each computes the whole S and dP (the
// block loads q' once: it lives in dq's storage until the block writes
// dq).
template <int D>
struct DqCfg {
  using G = Geo<D>;
  static constexpr int NWG = D == 256 ? 2 : 1;
  static constexpr int DC = D / NWG;
  static constexpr int THREADS = 128 * NWG;
  static constexpr int STAGES = D <= 64 ? 3 + (D < 64) : D <= 80 ? 3 : 2;
  static constexpr int SMEM =
      1024 + (2 + 2 * STAGES) * G::TILE + 8 * (1 + STAGES);
  static_assert(SMEM <= 232448, "dQ shared memory");
};

// c = cap tanh(x / cap) by the forward's formula, and dcap = 1 - tanh^2
__device__ __forceinline__ float capped(float x, float softcap, float cap_k,
                                        float& dcap) {
  const float t = cap_tanh(x, cap_k);
  dcap = 1.0f - t * t;
  return softcap * t;
}

// q' = bf16(q * bf16(scale)), eight values a thread
__global__ void __launch_bounds__(256)
    flash_bwd_scale_q(const uint4* __restrict__ q, uint4* __restrict__ qs,
                      long long n8, float scale) {
  const float sc = __bfloat162float(__float2bfloat16_rn(scale));
  for (long long i = (long long)blockIdx.x * 256 + threadIdx.x; i < n8;
       i += (long long)gridDim.x * 256) {
    uint4 w = q[i];
    uint32_t* u = reinterpret_cast<uint32_t*>(&w);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f =
          __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&u[e]));
      u[e] = bf16x2_bits(__floats2bfloat162_rn(f.x * sc, f.y * sc));
    }
    qs[i] = w;
  }
}

// dK and dV of one tile of 64 keys (and one column group), summed over the
// GQA group's query heads and, for each, the query tiles the masks let
// reach the keys, in that order.
template <int D>
__global__ void __launch_bounds__(DkdvCfg<D>::THREADS, 1)
    flash_bwd_dkdv_tc(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tdo,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      const __grid_constant__ CUtensorMap tlse,
                      const __grid_constant__ CUtensorMap tdi,
                      __nv_bfloat16* __restrict__ dk,
                      __nv_bfloat16* __restrict__ dv, int hq, int hkv, int s,
                      int causal, int window, float softcap) {
  using G = Geo<D>;
  using C = DkdvCfg<D>;
  constexpr int W = G::W, NSUB = G::NSUB, NWG = C::NWG, DC = C::DC;
  extern __shared__ uint8_t smem_raw[];
  // 1024-byte alignment: the 128-byte swizzle repeats every 8 rows
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const gbase = smem_raw + (base - raw);
  // K, V; q' and d_out of each stage; lse and Di of each stage; the
  // exchange; the barriers
  const uint32_t k_s = base, v_s = base + G::TILE;
  auto q_s = [&](int st) { return base + (2 + 2 * st) * G::TILE; };
  auto do_s = [&](int st) { return base + (3 + 2 * st) * G::TILE; };
  const uint32_t rows_off = (2 + 2 * C::STAGES) * G::TILE;
  const uint32_t xch_off = rows_off + C::STAGES * C::ROWS;
  const uint32_t bar_kv = base + xch_off + C::XCH;
  auto bar_full = [&](int st) { return bar_kv + 8u * (1 + st); };

  const int k0 = blockIdx.x * kT;  // key tile 0 has the most query tiles
  const int bkv = blockIdx.y;      // b * hkv + kv head
  const int g = hq / hkv;
  const int bh0 = (bkv / hkv) * hq + (bkv % hkv) * g;  // the group's first
  // the query rows that reach a key of this tile, in tiles: nq per head
  const int q_begin = causal ? k0 : 0;
  const int q_end = window > 0 ? min(s, k0 + kT - 1 + window) : s;
  const int t0 = q_begin / kT;
  const int nq = (q_end + kT - 1) / kT - t0;
  const int n_items = g * nq;

  // item n: head bh0 + n / nq, query tile t0 + n % nq, into stage n % STAGES
  auto load_item = [&](int n) {
    const int st = n % C::STAGES;
    const int bh = bh0 + n / nq;
    const int q0 = (t0 + n % nq) * kT;
    mbar_expect_tx(bar_full(st), 2 * G::TILE + 2 * 4 * C::RBOX);
    for (int sub = 0; sub < NSUB; ++sub) {
      tma_load_3d(q_s(st) + sub * G::SUB, &tq, bar_full(st), sub * W, q0, bh);
      tma_load_3d(do_s(st) + sub * G::SUB, &tdo, bar_full(st), sub * W, q0,
                  bh);
    }
    const uint32_t rows = base + rows_off + st * C::ROWS;
    const int r = (bh * s + q0) & ~3;
    tma_load_1d(rows, &tlse, bar_full(st), r);
    tma_load_1d(rows + C::ROWS / 2, &tdi, bar_full(st), r);
  };
  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
    for (int st = 0; st < C::STAGES; ++st) mbar_init(bar_full(st), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(bar_kv, 2 * G::TILE);
    for (int sub = 0; sub < NSUB; ++sub) {
      tma_load_3d(k_s + sub * G::SUB, &tk, bar_kv, sub * W, k0, bkv);
      tma_load_3d(v_s + sub * G::SUB, &tv, bar_kv, sub * W, k0, bkv);
    }
    for (int n = 0; n < min(n_items, C::STAGES); ++n) load_item(n);
  }
  __syncthreads();

  const int wg = threadIdx.x / 128, ct = threadIdx.x % 128;
  const int warp = ct / 32, lane = ct % 32;
  // this thread's keys j0 and j0 + 8 (rows of S^T); its query columns are
  // cq, cq + 1 of every 8-column chunk
  const int j0 = k0 + 16 * warp + lane / 4;
  const int cq = 2 * (lane % 4);
  const int col0 = (blockIdx.z * NWG + wg) * DC;  // its dK / dV columns
  const int csub = col0 / W;

  // dva[4 J + 2 r + c] is key j0 + 8 r, column col0 + 8 J + cq + c
  float dva[DC / 2], dka[DC / 2];
#pragma unroll
  for (int i = 0; i < DC / 2; ++i) dva[i] = dka[i] = 0.0f;
  const float cap_k = softcap > 0.0f ? 2.0f * kLog2e / softcap : 0.0f;
  mbar_wait(bar_kv, 0);

  for (int n = 0; n < n_items; ++n) {
    const int st = n % C::STAGES;
    const int q0 = (t0 + n % nq) * kT;
    mbar_wait(bar_full(st), (n / C::STAGES) & 1);

    // S^T = K q'^T and dP^T = V d_out^T: 64 keys x 64 queries, fp32.
    // sc[i] is key j0 + 8 ((i >> 1) & 1), query q0 + 8 (i >> 2) + cq + (i & 1)
    float sc[32], dp[32];
    if constexpr (NWG == 1) {
#pragma unroll
      for (int i = 0; i < 32; ++i) sc[i] = dp[i] = 0.0f;
      wgmma_fence();
#pragma unroll
      for (int sub = 0; sub < NSUB; ++sub) {
        const uint64_t dk_ =
            make_desc(k_s + sub * G::SUB, G::ATOM, G::ATOM, G::LAYOUT);
        const uint64_t dq_ =
            make_desc(q_s(st) + sub * G::SUB, G::ATOM, G::ATOM, G::LAYOUT);
#pragma unroll
        for (int kk = 0; kk < W / 16; ++kk)
          wgmma_ss_n64(sc, dk_ + 2 * kk, dq_ + 2 * kk, (sub | kk) != 0);
      }
#pragma unroll
      for (int sub = 0; sub < NSUB; ++sub) {
        const uint64_t dv_ =
            make_desc(v_s + sub * G::SUB, G::ATOM, G::ATOM, G::LAYOUT);
        const uint64_t do_ =
            make_desc(do_s(st) + sub * G::SUB, G::ATOM, G::ATOM, G::LAYOUT);
#pragma unroll
        for (int kk = 0; kk < W / 16; ++kk)
          wgmma_ss_n64(dp, dv_ + 2 * kk, do_ + 2 * kk, (sub | kk) != 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);
      fence_regs(dp);
    } else {
      // warpgroup 0 computes S^T, warpgroup 1 dP^T; each thread hands its
      // fragment to the same thread of the other warpgroup
      float mine[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) mine[i] = 0.0f;
      const uint32_t a_s = wg == 0 ? k_s : v_s;
      const uint32_t b_s = wg == 0 ? q_s(st) : do_s(st);
      wgmma_fence();
#pragma unroll
      for (int sub = 0; sub < NSUB; ++sub) {
        const uint64_t da =
            make_desc(a_s + sub * G::SUB, G::ATOM, G::ATOM, G::LAYOUT);
        const uint64_t db =
            make_desc(b_s + sub * G::SUB, G::ATOM, G::ATOM, G::LAYOUT);
#pragma unroll
        for (int kk = 0; kk < W / 16; ++kk)
          wgmma_ss_n64(mine, da + 2 * kk, db + 2 * kk, (sub | kk) != 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(mine);
      float* xch = reinterpret_cast<float*>(gbase + xch_off);
#pragma unroll
      for (int i = 0; i < 32; ++i) xch[(wg * 32 + i) * 128 + ct] = mine[i];
      __syncthreads();
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const float other = xch[((1 - wg) * 32 + i) * 128 + ct];
        sc[i] = wg == 0 ? mine[i] : other;
        dp[i] = wg == 0 ? other : mine[i];
      }
    }

    // P = exp(c - lse) and dS = P (dP - Di) dcap, masked, as bf16 hi/lo
    // pairs in the A-operand layout: register e of k-step kk holds the
    // pair at sc[8 kk + 2 e], sc[8 kk + 2 e + 1].  The tile's rows start
    // ((b h) s + q0) % 4 floats into the boxes of lse and Di.
    const float* lse_s =
        reinterpret_cast<const float*>(gbase + rows_off + st * C::ROWS) +
        ((bh0 + n / nq) * s + q0) % 4;
    const float* di_s = lse_s + C::ROWS / 8;
    const bool need_mask = k0 + kT > s || q0 + kT > s ||
                           (causal && k0 + kT - 1 > q0) ||
                           (window > 0 && k0 + window <= q0 + kT - 1);
    uint32_t p_hi[4][4], p_lo[4][4], d_hi[4][4], d_lo[4][4];
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int qc = 8 * (i >> 2) + cq;  // query column within the tile
      const int key = j0 + 8 * ((i >> 1) & 1);
      const float m[2] = {lse_s[qc], lse_s[qc + 1]};
      const float di[2] = {di_s[qc], di_s[qc + 1]};
      float p[2], ds[2];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        float x = sc[i + c], dcap = 1.0f;
        if (softcap > 0.0f) x = capped(x, softcap, cap_k, dcap);
        float pc = ex2((x - m[c]) * kLog2e);
        if (need_mask) {
          const int query = q0 + qc + c;
          bool keep = key < s && query < s;
          if (causal) keep = keep && key <= query;
          if (window > 0) keep = keep && key > query - window;
          if (!keep) pc = 0.0f;
        }
        p[c] = pc;
        ds[c] = pc * (dp[i + c] - di[c]) * dcap;
      }
      split_hi_lo(p[0], p[1], p_hi[i / 8][(i % 8) / 2],
                  p_lo[i / 8][(i % 8) / 2]);
      split_hi_lo(ds[0], ds[1], d_hi[i / 8][(i % 8) / 2],
                  d_lo[i / 8][(i % 8) / 2]);
    }

    // dV += P^T d_out and dK += dS^T q': per 16 queries (16 rows of d_out
    // and q': whole atoms) one m64nDCk16 product for each half of the pair
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kT / 16; ++kk) {
      const uint64_t db = make_desc(do_s(st) + csub * G::SUB + kk * 16 * G::RB,
                                    G::SUB, G::ATOM, G::LAYOUT);
      wgmma_rs<DC>(dva, p_hi[kk], db);
      wgmma_rs<DC>(dva, p_lo[kk], db);
    }
#pragma unroll
    for (int kk = 0; kk < kT / 16; ++kk) {
      const uint64_t db = make_desc(q_s(st) + csub * G::SUB + kk * 16 * G::RB,
                                    G::SUB, G::ATOM, G::LAYOUT);
      wgmma_rs<DC>(dka, d_hi[kk], db);
      wgmma_rs<DC>(dka, d_lo[kk], db);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(dva);
    fence_regs(dka);
    // every thread is past its reads of stage st: the tensor cores' by the
    // wait, lse and Di before the products (and, at NWG = 2, of the
    // exchange): refill it
    __syncthreads();
    if (threadIdx.x == 0 && n + C::STAGES < n_items) load_item(n + C::STAGES);
  }

  const size_t kv_off = (size_t)bkv * s * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = j0 + 8 * r;
    if (key >= s) continue;
    __nv_bfloat16* krow = dk + kv_off + (size_t)key * D + col0;
    __nv_bfloat16* vrow = dv + kv_off + (size_t)key * D + col0;
#pragma unroll
    for (int c8 = 0; c8 < DC / 8; ++c8) {
      *reinterpret_cast<__nv_bfloat162*>(krow + 8 * c8 + cq) =
          __floats2bfloat162_rn(dka[4 * c8 + 2 * r], dka[4 * c8 + 2 * r + 1]);
      *reinterpret_cast<__nv_bfloat162*>(vrow + 8 * c8 + cq) =
          __floats2bfloat162_rn(dva[4 * c8 + 2 * r], dva[4 * c8 + 2 * r + 1]);
    }
  }
}

// dq of a tile of 64 query rows: over the key tiles the masks let the rows
// reach, in key order.
template <int D>
__global__ void __launch_bounds__(DqCfg<D>::THREADS, 1)
    flash_bwd_dq_tc(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tdo,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    const float* __restrict__ lse,
                    const float* __restrict__ di,
                    __nv_bfloat16* __restrict__ dq, int hq, int hkv, int s,
                    float scale, int causal, int window, float softcap) {
  using G = Geo<D>;
  using C = DqCfg<D>;
  constexpr int W = G::W, NSUB = G::NSUB, DC = C::DC;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  // q', d_out; K and V of each stage; the barriers
  const uint32_t q_s = base, do_s = base + G::TILE;
  auto k_s = [&](int st) { return base + (2 + 2 * st) * G::TILE; };
  auto v_s = [&](int st) { return base + (3 + 2 * st) * G::TILE; };
  const uint32_t bar_q = base + (2 + 2 * C::STAGES) * G::TILE;
  auto bar_full = [&](int st) { return bar_q + 8u * (1 + st); };

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kT;  // heaviest first
  const int bh = blockIdx.y;                            // b * hq + h
  const int kvh = (bh / hq) * hkv + (bh % hq) / (hq / hkv);
  // the key tiles holding an unmasked pair of this block's rows
  const int q_last = min(q0 + kT, s) - 1;
  const int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  const int k_end = causal ? q_last + 1 : s;
  const int t0 = k_begin / kT;
  const int n_tiles = (k_end + kT - 1) / kT - t0;

  // Loads: thread 0 issues q', d_out and the first STAGES key tiles, and
  // refills a stage with the tile STAGES on once every thread is past it.
  auto load_tile = [&](int t) {
    const int st = t % C::STAGES;
    mbar_expect_tx(bar_full(st), 2 * G::TILE);
    const int row = (t0 + t) * kT;
    for (int sub = 0; sub < NSUB; ++sub) {
      tma_load_3d(k_s(st) + sub * G::SUB, &tk, bar_full(st), sub * W, row, kvh);
      tma_load_3d(v_s(st) + sub * G::SUB, &tv, bar_full(st), sub * W, row, kvh);
    }
  };
  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int st = 0; st < C::STAGES; ++st) mbar_init(bar_full(st), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(bar_q, 2 * G::TILE);
    for (int sub = 0; sub < NSUB; ++sub) {
      tma_load_3d(q_s + sub * G::SUB, &tq, bar_q, sub * W, q0, bh);
      tma_load_3d(do_s + sub * G::SUB, &tdo, bar_q, sub * W, q0, bh);
    }
    for (int t = 0; t < min(n_tiles, C::STAGES); ++t) load_tile(t);
  }
  __syncthreads();

  // this thread's rows r0 and r0 + 8, and the key columns cq, cq + 1 of
  // every 8-column chunk; its warpgroup's dq columns from col0
  const int wg = threadIdx.x / 128, ct = threadIdx.x % 128;
  const int warp = ct / 32, lane = ct % 32;
  const int r0 = q0 + 16 * warp + lane / 4;
  const int cq = 2 * (lane % 4);
  const int col0 = wg * DC;
  const int csub = col0 / W;
  float m[2], dI[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    m[r] = row < s ? lse[(size_t)bh * s + row] : 0.0f;
    dI[r] = row < s ? di[(size_t)bh * s + row] : 0.0f;
  }

  // acc[4 J + 2 r + c] is row r0 + 8 r, column col0 + 8 J + cq + c
  float acc[DC / 2];
#pragma unroll
  for (int i = 0; i < DC / 2; ++i) acc[i] = 0.0f;
  const float cap_k = softcap > 0.0f ? 2.0f * kLog2e / softcap : 0.0f;
  mbar_wait(bar_q, 0);

  for (int t = 0; t < n_tiles; ++t) {
    const int st = t % C::STAGES;
    mbar_wait(bar_full(st), (t / C::STAGES) & 1);
    const int k0 = (t0 + t) * kT;

    // S = q' K^T and dP = d_out V^T: 64 rows x 64 keys, fp32.  sc[i] is
    // row r0 + 8 ((i >> 1) & 1), key k0 + 8 (i >> 2) + cq + (i & 1)
    float sc[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = dp[i] = 0.0f;
    wgmma_fence();
#pragma unroll
    for (int sub = 0; sub < NSUB; ++sub) {
      const uint64_t da =
          make_desc(q_s + sub * G::SUB, G::ATOM, G::ATOM, G::LAYOUT);
      const uint64_t db =
          make_desc(k_s(st) + sub * G::SUB, G::ATOM, G::ATOM, G::LAYOUT);
#pragma unroll
      for (int kk = 0; kk < W / 16; ++kk)
        wgmma_ss_n64(sc, da + 2 * kk, db + 2 * kk, (sub | kk) != 0);
    }
    wgmma_commit();
#pragma unroll
    for (int sub = 0; sub < NSUB; ++sub) {
      const uint64_t da =
          make_desc(do_s + sub * G::SUB, G::ATOM, G::ATOM, G::LAYOUT);
      const uint64_t db =
          make_desc(v_s(st) + sub * G::SUB, G::ATOM, G::ATOM, G::LAYOUT);
#pragma unroll
      for (int kk = 0; kk < W / 16; ++kk)
        wgmma_ss_n64(dp, da + 2 * kk, db + 2 * kk, (sub | kk) != 0);
    }
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(sc);

    // P into sc while dP is still on the tensor cores
    const bool need_mask = k0 + kT > s || (causal && k0 + kT - 1 > q0) ||
                           (window > 0 && k0 <= q0 + kT - 1 - window);
    float dcap[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i >> 1) & 1;
      const int row = r0 + 8 * r;
      float x = sc[i];
      dcap[i] = 1.0f;
      if (softcap > 0.0f) x = capped(x, softcap, cap_k, dcap[i]);
      float pc = ex2((x - m[r]) * kLog2e);
      if (need_mask) {
        const int col = k0 + 8 * (i >> 2) + cq + (i & 1);
        bool keep = col < s;
        if (causal) keep = keep && col <= row;
        if (window > 0) keep = keep && col > row - window;
        if (!keep) pc = 0.0f;
      }
      sc[i] = pc;
    }
    wgmma_wait<0>();
    fence_regs(dp);
    uint32_t d_hi[4][4], d_lo[4][4];
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int r = (i >> 1) & 1;
      float ds[2];
#pragma unroll
      for (int c = 0; c < 2; ++c)
        ds[c] = sc[i + c] * (dp[i + c] - dI[r]) * dcap[i + c];
      split_hi_lo(ds[0], ds[1], d_hi[i / 8][(i % 8) / 2],
                  d_lo[i / 8][(i % 8) / 2]);
    }

    // dq' += dS K: per 16 keys (16 rows of K: whole atoms) one m64nDCk16
    // product for each half of dS
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kT / 16; ++kk) {
      const uint64_t db = make_desc(k_s(st) + csub * G::SUB + kk * 16 * G::RB,
                                    G::SUB, G::ATOM, G::LAYOUT);
      wgmma_rs<DC>(acc, d_hi[kk], db);
      wgmma_rs<DC>(acc, d_lo[kk], db);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    // every warp's wait has seen the tensor cores' reads of stage st end
    __syncthreads();
    if (threadIdx.x == 0 && t + C::STAGES < n_tiles) load_tile(t + C::STAGES);
  }

  // dq = bf16(bf16(dq') * bf16(scale)), as autograd rounds at the cast
  const float scb = __bfloat162float(__float2bfloat16_rn(scale));
  const size_t q_off = (size_t)bh * s * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    if (row >= s) continue;
    __nv_bfloat16* orow = dq + q_off + (size_t)row * D + col0;
#pragma unroll
    for (int c8 = 0; c8 < DC / 8; ++c8) {
      const float2 a = __bfloat1622float2(__floats2bfloat162_rn(
          acc[4 * c8 + 2 * r], acc[4 * c8 + 2 * r + 1]));
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * c8 + cq) =
          __floats2bfloat162_rn(a.x * scb, a.y * scb);
    }
  }
}

template <int D>
cudaError_t launch_bwd(const Args& a) {
  using G = Geo<D>;
  using KC = DkdvCfg<D>;
  using QC = DqCfg<D>;
  if ((reinterpret_cast<uintptr_t>(a.q) | reinterpret_cast<uintptr_t>(a.k) |
       reinterpret_cast<uintptr_t>(a.v) | reinterpret_cast<uintptr_t>(a.dout) |
       reinterpret_cast<uintptr_t>(a.lse) | reinterpret_cast<uintptr_t>(a.di) |
       reinterpret_cast<uintptr_t>(a.dq)) %
          16 != 0)
    return cudaErrorMisalignedAddress;
  const long long rows = (long long)a.b * a.hq * a.s;
  const int rows_per_block = kThreads / 32;
  flash_bwd_pre_kernel<__nv_bfloat16>
      <<<(unsigned)((rows + rows_per_block - 1) / rows_per_block), kThreads,
         0, a.stream>>>(static_cast<const float*>(a.out),
                        static_cast<const __nv_bfloat16*>(a.dout),
                        static_cast<float*>(a.di), rows, D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // q' into dq's storage: the dK/dV kernel reads it whole, the dQ kernel
  // reads each block's own rows before it overwrites them with dq
  const long long n8 = rows * D / 8;
  const long long blocks = (n8 + 255) / 256;
  flash_bwd_scale_q<<<(unsigned)(blocks < 132 * 16 ? blocks : 132 * 16), 256,
                      0, a.stream>>>(static_cast<const uint4*>(a.q),
                                  static_cast<uint4*>(a.dq), n8, a.scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  CUtensorMap mq, mdo, mk, mv, mlse, mdi;
  err = make_map(&mq, a.dq, a.b * a.hq, a.s, D, G::W);
  if (err == cudaSuccess)
    err = make_map(&mdo, a.dout, a.b * a.hq, a.s, D, G::W);
  if (err == cudaSuccess) err = make_map(&mk, a.k, a.b * a.hkv, a.s, D, G::W);
  if (err == cudaSuccess) err = make_map(&mv, a.v, a.b * a.hkv, a.s, D, G::W);
  if (err == cudaSuccess) err = make_map_1d_f32(&mlse, a.lse, rows, KC::RBOX);
  if (err == cudaSuccess) err = make_map_1d_f32(&mdi, a.di, rows, KC::RBOX);
  if (err != cudaSuccess) return err;

  err = cudaFuncSetAttribute(flash_bwd_dkdv_tc<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             KC::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid_kv((a.s + kT - 1) / kT, a.b * a.hkv, KC::NZ);
  flash_bwd_dkdv_tc<D><<<grid_kv, KC::THREADS, KC::SMEM, a.stream>>>(
      mq, mdo, mk, mv, mlse, mdi, static_cast<__nv_bfloat16*>(a.dk),
      static_cast<__nv_bfloat16*>(a.dv), a.hq, a.hkv, a.s, a.causal, a.window,
      a.softcap);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  err = cudaFuncSetAttribute(flash_bwd_dq_tc<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             QC::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid_q((a.s + kT - 1) / kT, a.b * a.hq);
  flash_bwd_dq_tc<D><<<grid_q, QC::THREADS, QC::SMEM, a.stream>>>(
      mq, mdo, mk, mv, static_cast<const float*>(a.lse),
      static_cast<const float*>(a.di), static_cast<__nv_bfloat16*>(a.dq),
      a.hq, a.hkv, a.s, a.scale, a.causal, a.window, a.softcap);
  return cudaGetLastError();
}

cudaError_t launch_d(int d, const Args& a) {
  switch (d) {
    case 32: return launch_bwd<32>(a);
    case 64: return launch_bwd<64>(a);
    case 80: return launch_bwd<80>(a);
    case 112: return launch_bwd<112>(a);
    case 128: return launch_bwd<128>(a);
    case 256: return launch_bwd<256>(a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace tc

// q (b, hq, s, d), k and v (b, hkv, s, d), d_out and dq like q, dk and dv
// like k; contiguous, on `device`, of one type: dtype 0 float32, 1 bfloat16.
// out (b, hq, s, d) float32 and lse (b, hq, s) float32 from
// flash_attention_launch (out_f32 for bfloat16); di a float32 scratch of
// b * hq * s (Di).  d is 32, 64, 80, 112, 128 or 256; hq a multiple of hkv;
// scale 1/sqrt(d) as float; window <= 0 means no window, softcap <= 0 no
// soft-cap.  Returns cudaGetLastError() or the first error met.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* out,
    const void* lse, const void* dout, void* dq, void* dk, void* dv, void* di,
    int b, int hq, int hkv, int s, int d, int dtype, float scale, int causal,
    int window, float softcap, int device, void* stream) {
  cudaError_t err = hopper::use_device(device);
  if (err != cudaSuccess) return (int)err;
  if (b <= 0 || s <= 0 || hkv <= 0 || hq % hkv != 0)
    return (int)cudaErrorInvalidValue;
  const Args a{q,  k,  v,   out, lse,   dout,   dq,     dk,      dv,
               di, b,  hq,  hkv, s,     scale,  causal, window,  softcap,
               (cudaStream_t)stream};
  if (dtype == 0) return (int)launch_d<float>(d, a);
  if (dtype == 1) return (int)tc::launch_d(d, a);
  return (int)cudaErrorInvalidValue;
}
