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
//
// Positions are absolute, from 0 for queries and keys alike.  Any S is
// taken: the tail tiles are masked (a key past S is excluded like a masked
// one, a query row past S is never written).  The TPU block shapes and the
// S % block == 0 restriction of the Pallas wrapper do not carry over.
//
// Design (a simple, correct first version; tensor cores, wgmma and TMA are
// for a later change): one block of 256 threads per (b, h, 64-row query
// tile).  The block stages its query tile, pre-scaled, in shared memory as
// float32 and walks the key tiles of 64 rows in order, staging each K and V
// tile as float32 in shared memory.  Thread (ty, tx) of the 16 x 16 grid
// owns query rows 4 ty .. 4 ty + 3: it computes their scores against keys
// tx + 16 j (j < 4) with FMAs over D, keeps their running max and sum in
// registers (reduced over the 16 lanes of a row by shuffles), writes the
// probabilities to shared memory, and accumulates output columns
// tx + 16 c (c < D / 16) of the same rows.  Rows are padded by 4 floats so
// that both the column reads of K and the row reads of V are free of bank
// conflicts.  At D = 256 that is 212 KiB of shared memory, one block per SM.
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
// for a local one (window 4096).  The bytes (q, k, v read once, out written
// once, 0.4 GB) take 0.12 ms: bound by operations.  This kernel runs on the
// fp32 units (67 TFLOP/s), so it is far from that bound by design.
//
// No --use_fast_math: expf and tanhf stay IEEE-accurate.  No atomics and a
// fixed order of every sum, so every launch gives the same bits.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // key rows per tile
constexpr int kThreads = 256;  // a 16 x 16 grid of threads
constexpr int kLDP = kBK + 4;  // padded row of the probability tile
constexpr float kNegInf = -1e30f;

template <typename T>
__device__ __forceinline__ float to_f32(T x);
template <>
__device__ __forceinline__ float to_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// x rounded to T's precision (round to nearest even), back in float
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f32<T>(from_f32<T>(x));
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         ((size_t)(kBQ + 2 * kBK) * (D + 4) + (size_t)kBQ * kLDP);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out, int hq,
                     int hkv, int s, float scale, int causal, int window,
                     float softcap) {
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

  // q * scale rounded in T, as float32
  const float sc = round_to<T>(scale);
  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, c = i % D;
    float x = 0.0f;
    if (q0 + r < s)
      x = round_to<T>(to_f32<T>(q[q_off + (size_t)(q0 + r) * D + c]) * sc);
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
        kx = to_f32<T>(k[g]);
        vx = to_f32<T>(v[g]);
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
    T* row = out + q_off + (size_t)qi * D;
#pragma unroll
    for (int c = 0; c < CPT; ++c) row[tx + 16 * c] = from_f32<T>(acc[i][c] / denom);
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

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int b, int hq, int hkv, int s, float scale, int causal,
                   int window, float softcap, cudaStream_t stream) {
  const size_t bytes = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((s + kBQ - 1) / kBQ, b * hq);
  flash_fwd_kernel<T, D><<<grid, kThreads, bytes, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, hq, hkv, s, scale,
      causal, window, softcap);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(int d, const void* q, const void* k, const void* v,
                     void* out, int b, int hq, int hkv, int s, float scale,
                     int causal, int window, float softcap,
                     cudaStream_t stream) {
  switch (d) {
    case 32: return launch<T, 32>(q, k, v, out, b, hq, hkv, s, scale, causal, window, softcap, stream);
    case 64: return launch<T, 64>(q, k, v, out, b, hq, hkv, s, scale, causal, window, softcap, stream);
    case 128: return launch<T, 128>(q, k, v, out, b, hq, hkv, s, scale, causal, window, softcap, stream);
    case 256: return launch<T, 256>(q, k, v, out, b, hq, hkv, s, scale, causal, window, softcap, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (b, hq, s, d), k and v (b, hkv, s, d), out like q; contiguous, on
// `device`, of one type: dtype 0 float32, 1 bfloat16.  d is 32, 64, 128 or
// 256; hq a multiple of hkv.  scale is 1/sqrt(d) as float (the kernel rounds
// it to the type); window <= 0 means no window, softcap <= 0 no soft-cap.
// Returns cudaGetLastError().
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int b, int hq,
                                      int hkv, int s, int d, int dtype,
                                      float scale, int causal, int window,
                                      float softcap, int device,
                                      void* stream) {
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return (int)err;
  if (b <= 0 || s <= 0 || hkv <= 0 || hq % hkv != 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    err = launch_d<float>(d, q, k, v, out, b, hq, hkv, s, scale, causal,
                          window, softcap, st);
  else if (dtype == 1)
    err = launch_d<__nv_bfloat16>(d, q, k, v, out, b, hq, hkv, s, scale,
                                  causal, window, softcap, st);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}
