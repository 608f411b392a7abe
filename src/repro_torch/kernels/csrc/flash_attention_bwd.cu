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
// Three kernels on the caller's stream, one launch each:
//
// * flash_bwd_pre_kernel: one warp per row, Di by a shuffle tree.
// * flash_bwd_dkdv_kernel: one block of 256 threads (a 16 x 16 grid) per
//   (b, kv head, key tile of T keys).  It keeps its K and V tile in shared
//   memory as float32 and loops over the Hq / Hkv query heads of its group
//   and, for each, over the query tiles of T rows that the causal and window
//   masks let reach the key tile; per query tile it stages q' and d_out,
//   recomputes S and dP (a thread owns R x R of the T x T tile), writes P
//   and dS to shared memory, then adds P^T d_out and dS^T q' into dv and dk
//   (a thread owns R key rows x D / 16 columns, in registers).
// * flash_bwd_dq_kernel: one block per (b, q head, query tile of T rows),
//   q' and d_out resident; it loops over the key tiles the masks let the
//   rows reach, recomputes S, dP and dS, and adds dS K into dq'.
//
// T is 64 query rows and keys, and 32 at D = 256, where the dK and dV
// accumulators of 64 keys would be 128 registers a thread and the four tiles
// of 64 rows 260 KiB: shared memory is 4 T (D + 4) + 2 T (T + 4) + 2 T
// floats, 104 KiB at D = 64, 167 KiB at D = 128 and 139 KiB at D = 256.
//
// Every product is a float32 FMA on the SIMT units; bfloat16 inputs are
// widened as they are staged (exact), so both types share the arithmetic.
// Rounding P or dS to bf16 for the tensor cores would cost up to 2^-8 per
// weight, the error that the forward's hi/lo P exists to avoid.  exp and
// tanh are expf and tanhf (IEEE-accurate to a few ulps).
//
// No atomics anywhere: a block owns the dk and dv rows of its key tile and
// sums its group's heads and query tiles in a fixed order, and dq has a
// kernel of its own.  Every launch gives the same bits.
//
// Bound on the card: the backward's own work is 10 D operations per unmasked
// (query, key) pair and head (S, dP, dv, dk, dq: a multiply-add over D each),
// against the H100's 989 TFLOP/s of dense bf16 tensor-core work: at
// stablelm-1.6b's train shape (B 4, H 32, S 4096, D 64, causal) 0.695 ms;
// the bytes (q, k, v, out, d_out read once, dq, dk, dv written once, lse)
// 0.54 GB, 0.16 ms: bound by operations.  These kernels do 14 D (S and dP
// twice) at the 67 TFLOP/s of the fp32 units: at least 14 ms at that shape.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
template <>
__device__ __forceinline__ float rnd<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ void put(float* p, float x) { *p = x; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

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

// Make `device` current for this runtime before a launch (the library
// carries its own static CUDA runtime; the context is the device's primary
// context, shared with PyTorch).
cudaError_t use_device(int device) {
  int cur = -1;
  cudaError_t err = cudaGetDevice(&cur);
  if (err != cudaSuccess) return err;
  return cur == device ? cudaSuccess : cudaSetDevice(device);
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
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return (int)err;
  if (b <= 0 || s <= 0 || hkv <= 0 || hq % hkv != 0)
    return (int)cudaErrorInvalidValue;
  const Args a{q,  k,  v,   out, lse,   dout,   dq,     dk,      dv,
               di, b,  hq,  hkv, s,     scale,  causal, window,  softcap,
               (cudaStream_t)stream};
  if (dtype == 0) return (int)launch_d<float>(d, a);
  if (dtype == 1) return (int)launch_d<__nv_bfloat16>(d, a);
  return (int)cudaErrorInvalidValue;
}
