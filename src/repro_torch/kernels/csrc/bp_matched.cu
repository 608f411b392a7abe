// Exact transpose A^T of the Joseph forward projector (Hopper, sm_90a).
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/bp_matched.py::_bp_matched_kernel (wrapper
// bp_matched_pallas).  The Pallas kernel scatters each ray's cotangent
// into the two y and two z taps that fp_ray read it from.  A scatter on
// this card needs float atomics, whose order changes from run to run;
// this kernel gathers instead, so that it is deterministic: every launch
// on the same input gives the same bits, which the bit-identical
// prefetch depths and step-wise runs of the streaming executor need.
//
// Design.  Most of a sample's arithmetic does not depend on the voxel:
// s_par, fj, j0i, wj and the mask depend on (angle, u, plane x) alone, fk
// on (angle, u, v, x), and seg on the ray (angle, u, v) alone.  So
//   0. a first kernel forms gs = g * seg for every ray, once, into a
//      scratch that holds a chunk of seg_chunk angles; the entry runs the
//      two kernels chunk by chunk, and each chunk after the first carries
//      every voxel's sum in from the output, so that the sum runs over the
//      angles in order as in one pass (the same bits for any chunk);
// then a block owns one marching plane x and a tile of 32 y rows j by 16
// slab planes k, one thread per output voxel, and walks the angles in
// order, kAngles = 4 at a time, staging for each angle in shared memory
//   1. the window of u whose taps can reach the tile: the plane-to-detector
//      map inverted at the tile's two y edges (as the first version did per
//      voxel), widened by 2 pixels to absorb the rounding of the inversion;
//   2. joseph_u() of every u of the window, computed once; the window of v
//      whose z taps can reach the tile's planes (fk is affine in v),
//      widened by 1; and each ray's place in the lists of the two rows j
//      its y taps reach, with its y weight;
//   3. joseph_v_tap() of every (u, v) of those windows, computed once, and
//      gs * (1 - wk) and gs * wk, the products the two planes it reaches
//      add; for each plane k and u, the run of v hits: k0i rises with v
//      (every step of fk's expression is monotone in v for s_par > 0), so
//      they are a run, its first entry and length set by shared atomic
//      min and add, which give the same tables in any order.
// Each thread then reads its voxel's hits off the tables: its row's list
// of u hits (at most three, sorted by u), and for each the run of v hits
// of its plane, adding (gs * wz) * wy: u and v in order within the angle,
// the angles in order.  Every value comes from the functions fp_ray calls
// (joseph_common.cuh) with the same roundings, so the weights are fp_ray's
// bit for bit and the pair is exact to summation order.  A window wider
// than a table, a row with more than three u hits or a v window wider than
// its row computes what the tables do not hold on the fly: the same
// values, never another result.  Tables are padded so that neighbouring u
// fall in distinct banks, both where a row is filled and where rows are
// read.  A few fast divisions serve only the window bounds.
//
// Output layout (Nx, nz_slab, Ny), the marching-plane layout of fp_ray's
// input: the 32 threads of a warp hold neighbouring j and write one
// contiguous row.  The wrapper transposes it back to (nz_slab, Ny, Nx).
//
// Bound on the card: the same 6.9e10 (voxel, angle) pairs as fp_ray's
// ray-plane samples at N=512 with 512 angles, and the same ~8 fp32
// operations each for the weights and the accumulation: about 8 ms at the
// 67 TFLOP/s fp32 peak against about 0.3 ms of memory traffic, so it is
// bound by operations.  What remains per pair beyond that bound is the
// tables, per block and angle: about 45 u-parts (two IEEE divisions each)
// and 45 x 23 z taps (one each, with a read of gs and two shared atomics)
// for 512 voxels, and the reads of a voxel's hits.
//
// Tile configurations (tile_configs.cuh).  The slab planes of a block
// (block_k) and the angles staged at a time (angles) are template
// parameters; the library holds the instantiations of kConfigs below, row
// 0 (16 planes, 4 angles: the tables described above, 103,072 bytes) the
// default, and bp_matched_launch takes the row's index.  A table row's v
// entries scale with the planes (kVCap = block_k + 12: 28 at 16), and
// angles <= block_k (the stage's per-angle steps take a thread each).
// Neither knob touches a voxel's sum: the angles are summed in order,
// within an angle the u hits in order of u and each ray's v hits in order
// of v, whether read off the tables or computed where they overflow, so
// every configuration gives the same output bit for bit.  The launch
// bounds keep 1024 threads an SM (64 registers).
#include "joseph_common.cuh"
#include "tile_configs.cuh"

namespace {

constexpr int kBlockJ = 32;
// {block_k, angles}: slab planes of a block, angles staged at a time
constexpr int kConfigs[][2] = {{16, 4}, {16, 2}, {16, 8},
                               {8, 4}, {8, 8}, {32, 4}};
constexpr int kNumConfigs = sizeof(kConfigs) / sizeof(kConfigs[0]);
constexpr int kUCap = 64;         // u entries of a table
constexpr int kRun = 3;           // u hits of a row j held in its list
constexpr int kWidenU = 2;
constexpr int kWidenV = 1;

// gs = g * seg for every ray (angle a, v, u): seg depends on the ray alone,
// not on the plane, so the product the adjoint weights is formed once.
__global__ void seg_scale_kernel(const float* __restrict__ proj,
                                 const float* __restrict__ consts,
                                 float* __restrict__ gs, JosephGeom g) {
  const int iu = blockIdx.x * blockDim.x + threadIdx.x;
  const int iv = blockIdx.y;
  const int a = blockIdx.z;
  if (iu >= g.nu) return;
  const AngleConsts c = load_angle(consts, a);
  const JosephU su = joseph_u(c, iu, 0.0f, g);  // dxy2, adx: plane-free
  const size_t i = ((size_t)a * g.nv + iv) * g.nu + iu;
  gs[i] = proj[i] * joseph_seg(su.dxy2, su.adx, joseph_dz(c, iv, g), g);
}

// Detector index (fractional) of the pixel whose ray crosses plane x at
// world y = yt, for angle c.  From y = sy + (x - sx) * d_y / d_x with
// d = (C + D u, A + B u): u = (A - r C) / (r D - B), r = (yt - sy) / (x - sx).
// The window it bounds is widened by 2 pixels, so fast divisions do.
__device__ __forceinline__ float u_index_at(const AngleConsts& c, float x,
                                            float yt, const JosephGeom& g) {
  const float r = __fdividef(yt - c.sy, x - c.sx);
  const float u =
      __fdividef((c.dcy - c.sy) - r * (c.dcx - c.sx), r * c.eux - c.euy);
  return __fdividef(u - g.offu, g.du) + g.cu;
}

// Clamp a fractional candidate interval, widened, to [0, n).  A
// non-finite bound falls back to the whole axis.
__device__ __forceinline__ void candidate_range(float f0, float f1, int n,
                                                int widen, int* lo, int* hi) {
  if (!isfinite(f0) || !isfinite(f1)) {
    *lo = 0;
    *hi = n - 1;
    return;
  }
  // clamp before the conversion so that no bound overflows an int
  const float a = fminf(fmaxf(fminf(f0, f1), -4.0f), (float)n + 4.0f);
  const float b = fminf(fmaxf(fmaxf(f0, f1), -4.0f), (float)n + 4.0f);
  *lo = max(0, (int)floorf(a) - widen);
  *hi = min(n - 1, (int)ceilf(b) + widen);
}

// Candidate rows v of the ray with parameter s_par whose z taps can reach
// world z in [z_lo, z_hi]: fk is affine in v, v = sz + (z - sz) / s_par.
// The range is widened by 1 pixel, so fast divisions do.
__device__ __forceinline__ void v_range(const AngleConsts& c, float s_par,
                                        float z_lo, float z_hi,
                                        const JosephGeom& g, int* v0,
                                        int* v1) {
  const float inv = __fdividef(1.0f, s_par);
  const float inv_dv = __fdividef(1.0f, g.dv);
  const float v_lo = c.sz + (z_lo - c.sz) * inv;
  const float v_hi = c.sz + (z_hi - c.sz) * inv;
  candidate_range((v_lo - g.offv) * inv_dv + g.cv,
                  (v_hi - g.offv) * inv_dv + g.cv, g.nv, kWidenV, v0, v1);
}

// One configuration's shape: the tile and its tables.
template <int kBlockK_, int kAngles_>
struct Tile {
  static constexpr int kBlockK = kBlockK_;
  static constexpr int kAngles = kAngles_;         // angles staged at a time
  static constexpr int kThreads = kBlockJ * kBlockK;
  static constexpr int kVCap = kBlockK + 12;       // v entries of a row
  static constexpr int kVPad = kVCap + 1;  // row stride: rows of
                                           // neighbouring u in distinct banks
  static_assert(kAngles <= kBlockK, "a stage's angles take a warp each");
};

// One stage of kAngles angles: the constants and u window of each angle;
// its u-parts; for each u its v window and, per entry, gs * wz for the two
// planes the entry's z taps reach; per plane k of the tile and u, the run
// of v hits; for each row j the list of its u hits with their y weights.
template <class T>
struct Tables {
  static constexpr int kAngles = T::kAngles, kBlockK = T::kBlockK;
  static constexpr int kVCap = T::kVCap, kVPad = T::kVPad;
  float consts[kAngles][8];
  int u0[kAngles];                 // first u of the window
  int cnt[kAngles];                // u in the window
  float s_par[kAngles][kUCap];
  float wj[kAngles][kUCap];
  int j0i[kAngles][kUCap];
  int v0[kAngles][kUCap];          // first v of the row
  int vcnt[kAngles][kUCap];        // v in the row (0: the ray is masked)
  // entry (u, v): gs * (1 - wk), the weight of plane k0i, and gs * wk,
  // that of plane k0i + 1
  float g_lo[kAngles][kUCap][kVPad];
  float g_hi[kAngles][kUCap][kVPad];
  // plane k's run of v hits in row q: its first entry, and its length |
  // the count of its entries with k0i = k - 1 (they come first) << 8; rows
  // padded so that both the fill (one q, many k) and the reads (many q,
  // one k) spread over the banks
  int vlo[kAngles][kUCap][kBlockK + 1];
  int vrun[kAngles][kUCap][kBlockK + 1];
  // the u hits of row j, in no order: their number (more than kRun, or a
  // window past the table: walk the window), entries and y weights
  int run_n[kAngles][kBlockJ];
  int run_q[kAngles][kRun][kBlockJ];
  float run_wy[kAngles][kRun][kBlockJ];
};

// y weight of ray (u-part su) for row j; *hit says whether it hits row j.
__device__ __forceinline__ float y_weight(const JosephU& su, int j, bool* hit) {
  *hit = su.mask && (su.j0i == j || su.j0i + 1 == j);
  return su.j0i == j ? __fsub_rn(1.0f, su.wj) : su.wj;
}

// Add the v hits of ray (angle c, s_par, u = iu) on voxel (k, j), y weight
// wy, to acc, computing the z taps over the voxel's own v window.
__device__ __forceinline__ void add_ray_direct(const AngleConsts& c,
                                               float s_par, int iu, float wy,
                                               int k, float z_lo, float z_hi,
                                               const float* gs_a,
                                               const JosephGeom& g,
                                               float& acc) {
  int v0, v1;
  v_range(c, s_par, z_lo, z_hi, g, &v0, &v1);
  for (int iv = v0; iv <= v1; ++iv) {
    const JosephV sv = joseph_v_tap(c, s_par, iv, g);
    float wz;
    if (sv.k0i == k) {
      wz = __fsub_rn(1.0f, sv.wk);
    } else if (sv.k0i + 1 == k) {
      wz = sv.wk;
    } else {
      continue;
    }
    acc += (__ldg(gs_a + (size_t)iv * g.nu + iu) * wz) * wy;
  }
}

// Add the v hits of table ray q of angle i on voxel (k, j), y weight wy, to
// acc: read at plane k's run, or computed where the row overflowed.
template <class T>
__device__ __forceinline__ void add_ray(const Tables<T>& t, int i, int q,
                                        float wy, int k, float z_lo,
                                        float z_hi, const float* gs_a,
                                        const JosephGeom& g, float& acc) {
  if (t.vcnt[i][q] > T::kVCap) {
    add_ray_direct(load_angle(&t.consts[0][0], i), t.s_par[i][q],
                   t.u0[i] + q, wy, k, z_lo, z_hi, gs_a, g, acc);
    return;
  }
  const int kl = k % T::kBlockK;
  const int lo = t.vlo[i][q][kl], run = t.vrun[i][q][kl];
  const int len = run & 0xff, below = run >> 8;
  const float* hi_w = t.g_hi[i][q] + lo;  // entries with k0i = k - 1
  const float* lo_w = t.g_lo[i][q] + lo;  // entries with k0i = k
  // the run is 2 or 3 long: a fixed, predicated loop lets the loads overlap
#pragma unroll
  for (int e = 0; e < 3; ++e)
    if (e < len) acc += (e < below ? hi_w[e] : lo_w[e]) * wy;
  for (int e = 3; e < len; ++e) acc += (e < below ? hi_w[e] : lo_w[e]) * wy;
}

template <class T>
__device__ __forceinline__ JosephU table_u(const Tables<T>& t, int i,
                                           int q) {
  JosephU su;
  su.s_par = t.s_par[i][q];
  su.wj = t.wj[i][q];
  su.j0i = t.j0i[i][q];
  su.mask = (su.s_par > 0.0f) && (su.s_par <= 1.0f);
  return su;
}

// carry: out_t already holds the sums over the earlier angles; continue them
template <class T>
__global__ void __launch_bounds__(T::kThreads, 1024 / T::kThreads)
    bp_matched_kernel(const float* __restrict__ gs,
                      const float* __restrict__ consts,
                      const float* __restrict__ xc, float* __restrict__ out_t,
                      int n_angles, bool carry, JosephGeom g) {
  constexpr int kBlockK = T::kBlockK, kAngles = T::kAngles;
  constexpr int kThreads = T::kThreads, kVCap = T::kVCap;
  extern __shared__ float4 smem4[];
  Tables<T>& t = *reinterpret_cast<Tables<T>*>(smem4);
  const int tid = threadIdx.y * kBlockJ + threadIdx.x;
  const int jb = blockIdx.x * kBlockJ;
  const int kb = blockIdx.y * kBlockK;
  const int j = jb + threadIdx.x;
  const int k = kb + threadIdx.y;
  const int p = blockIdx.z;
  const bool active = j < g.ny && k < g.nz_slab;

  const float x = xc[p];
  // world y of fj = jb - 1 and fj = j_last + 1 (the tile's reach); world z
  // of fk = k - 1, k + 1 (the voxel's) and kb - 1, k_last + 1 (the tile's)
  const float y_lo = ((float)(jb - 1) - g.cy) * g.dy + g.offy;
  const float y_hi = ((float)(min(jb + kBlockJ, g.ny)) - g.cy) * g.dy + g.offy;
  const float z_lo = ((float)(k - 1) + g.z0 - g.cz) * g.dz + g.offz;
  const float z_hi = ((float)(k + 1) + g.z0 - g.cz) * g.dz + g.offz;
  const float zt_lo = ((float)(kb - 1) + g.z0 - g.cz) * g.dz + g.offz;
  const float zt_hi =
      ((float)(min(kb + kBlockK, g.nz_slab)) + g.z0 - g.cz) * g.dz + g.offz;

  const size_t o = ((size_t)p * g.nz_slab + k) * g.ny + j;
  float acc = carry && active ? out_t[o] : 0.0f;
  for (int a0 = 0; a0 < n_angles; a0 += kAngles) {
    const int na = min(kAngles, n_angles - a0);
    __syncthreads();  // the previous stage's tables are consumed
    // 1. the constants, and the window of u whose taps can reach the tile
    if (tid < na * 8) (&t.consts[0][0])[tid] = consts[(size_t)a0 * 8 + tid];
    if (tid < na * kBlockJ) (&t.run_n[0][0])[tid] = 0;
    if (tid >= kThreads - na) {
      const int i = kThreads - 1 - tid;
      const AngleConsts c = load_angle(consts, a0 + i);
      int u0, u1;
      candidate_range(u_index_at(c, x, y_lo, g), u_index_at(c, x, y_hi, g),
                      g.nu, kWidenU, &u0, &u1);
      t.u0[i] = u0;
      t.cnt[i] = max(0, u1 - u0 + 1);
    }
    __syncthreads();
    // a window past the table: walk it (an add, as step 2 adds to the
    // same counts)
    if (tid < na * kBlockJ && t.cnt[tid / kBlockJ] > kUCap)
      atomicAdd(&t.run_n[0][0] + tid, kRun + 1);
    // 2. the u-parts, each computed once, and the v window of each ray
    for (int e = tid; e < na * kUCap; e += kThreads) {
      const int i = e / kUCap, q = e % kUCap;
      if (q >= t.cnt[i]) continue;
      const AngleConsts c = load_angle(&t.consts[0][0], i);
      const JosephU su = joseph_u(c, t.u0[i] + q, x, g);
      t.s_par[i][q] = su.s_par;
      t.wj[i][q] = su.wj;
      t.j0i[i][q] = su.j0i;
      int v0 = 0, v1 = -1;
      if (su.mask) v_range(c, su.s_par, zt_lo, zt_hi, g, &v0, &v1);
      t.v0[i][q] = v0;
      t.vcnt[i][q] = v1 - v0 + 1;
#pragma unroll
      for (int kl = 0; kl < kBlockK; ++kl) {
        t.vlo[i][q][kl] = kVCap;
        t.vrun[i][q][kl] = 0;
      }
      // the ray is a hit of rows j0i (wy = 1 - wj) and j0i + 1 (wy = wj)
      if (!su.mask) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int jl = su.j0i + h - jb;
        if (jl < 0 || jl >= kBlockJ) continue;
        const int slot = atomicAdd(&t.run_n[i][jl], 1);
        if (slot < kRun) {
          t.run_q[i][slot][jl] = q;
          t.run_wy[i][slot][jl] = h == 0 ? __fsub_rn(1.0f, su.wj) : su.wj;
        }
      }
    }
    __syncthreads();
    // 3. the z taps of every (u, v) of the windows, each computed once,
    // weighting that ray's gs, and the runs of v hits of each plane
    {
      int off[kAngles + 1];
      off[0] = 0;
#pragma unroll
      for (int i = 0; i < kAngles; ++i)
        off[i + 1] = off[i] + (i < na ? min(t.cnt[i], kUCap) * kVCap : 0);
#pragma unroll 2
      for (int e = tid; e < off[kAngles]; e += kThreads) {
        int i = 0;
#pragma unroll
        for (int m = 1; m < kAngles; ++m) i += e >= off[m];
        // neighbouring lanes take neighbouring u of one row r: their gs
        // reads are contiguous
        const int width = min(t.cnt[i], kUCap);
        const int r = (e - off[i]) / width, q = (e - off[i]) % width;
        if (r >= t.vcnt[i][q]) continue;
        const int iv = t.v0[i][q] + r;
        const JosephV sv =
            joseph_v_tap(load_angle(&t.consts[0][0], i), t.s_par[i][q], iv, g);
        const float gv = __ldg(gs + ((size_t)(a0 + i) * g.nv + iv) * g.nu +
                               t.u0[i] + q);
        t.g_lo[i][q][r] = gv * __fsub_rn(1.0f, sv.wk);
        t.g_hi[i][q][r] = gv * sv.wk;
        // entry r is a hit of planes k0i (wz = 1 - wk) and k0i + 1
        // (wz = wk).  k0i rises with v (each step of fk's expression is
        // monotone in v for s_par > 0), so a plane's hits are a run whose
        // entries with k0i = k - 1 come first: its first entry, length and
        // that count are order-free, so these updates give the same
        // tables in any order
        const int kl = sv.k0i - kb;
        if (kl >= 0 && kl < kBlockK) {
          atomicMin(&t.vlo[i][q][kl], r);
          atomicAdd(&t.vrun[i][q][kl], 1);
        }
        if (kl + 1 >= 0 && kl + 1 < kBlockK) {
          atomicMin(&t.vlo[i][q][kl + 1], r);
          atomicAdd(&t.vrun[i][q][kl + 1], 1 + (1 << 8));
        }
      }
    }
    __syncthreads();
    if (!active) continue;

    // 4. each voxel's hits, off the tables
    for (int i = 0; i < na; ++i) {
      const float* gs_a = gs + (size_t)(a0 + i) * g.nv * g.nu;
      const int n = t.run_n[i][threadIdx.x];
      if (n <= kRun) {
        // the row's hits in the order of u: a sort of at most three
        int q[kRun];
        float wy[kRun];
#pragma unroll
        for (int e = 0; e < kRun; ++e) {
          q[e] = e < n ? t.run_q[i][e][threadIdx.x] : kUCap + e;
          wy[e] = e < n ? t.run_wy[i][e][threadIdx.x] : 0.0f;
        }
        auto order = [&](int a, int b) {
          if (q[a] > q[b]) {
            const int tq = q[a];
            q[a] = q[b];
            q[b] = tq;
            const float tw = wy[a];
            wy[a] = wy[b];
            wy[b] = tw;
          }
        };
        order(0, 1);
        order(1, 2);
        order(0, 1);
#pragma unroll
        for (int e = 0; e < kRun; ++e)
          if (e < n)
            add_ray(t, i, q[e], wy[e], k, z_lo, z_hi, gs_a, g, acc);
      } else {
        const AngleConsts c = load_angle(&t.consts[0][0], i);
        for (int q = 0; q < t.cnt[i]; ++q) {
          const JosephU su =
              q < kUCap ? table_u(t, i, q) : joseph_u(c, t.u0[i] + q, x, g);
          bool hit;
          const float wy = y_weight(su, j, &hit);
          if (!hit) continue;
          if (q < kUCap)
            add_ray(t, i, q, wy, k, z_lo, z_hi, gs_a, g, acc);
          else
            add_ray_direct(c, su.s_par, t.u0[i] + q, wy, k, z_lo, z_hi, gs_a,
                           g, acc);
        }
      }
    }
  }
  if (active) out_t[o] = acc;
}

// One configuration's launches: the pre-pass and the kernel of each chunk
// of seg_chunk angles, in order, on `st`; returns the first launch error.
template <class T>
int launch_tiles(const float* proj, const float* consts, const float* xc,
                 float* out_t, float* gs, int seg_chunk, int n_angles,
                 const JosephGeom& g, cudaStream_t st) {
  constexpr int kSmem = (int)sizeof(Tables<T>);
  cudaError_t err = cudaFuncSetAttribute(
      bp_matched_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmem);
  if (err != cudaSuccess) return (int)err;
  const int nv = g.nv, nu = g.nu;
  const dim3 block(kBlockJ, T::kBlockK);
  const dim3 grid((g.ny + kBlockJ - 1) / kBlockJ,
                  (g.nz_slab + T::kBlockK - 1) / T::kBlockK, g.nx);
  for (int c0 = 0; c0 < n_angles; c0 += seg_chunk) {
    const int na = min(seg_chunk, n_angles - c0);
    const float* consts_c = consts + (size_t)c0 * 8;
    seg_scale_kernel<<<dim3((nu + 127) / 128, nv, na), 128, 0, st>>>(
        proj + (size_t)c0 * nv * nu, consts_c, gs, g);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    bp_matched_kernel<T><<<grid, block, kSmem, st>>>(gs, consts_c, xc, out_t,
                                                     na, c0 > 0, g);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

}  // namespace

// The tile configurations: "block_k angles", one row of kConfigs each.
extern "C" const char* bp_matched_config_knobs() { return "block_k angles"; }
extern "C" int bp_matched_configs(int* values, int capacity) {
  return copy_configs(kConfigs, values, capacity);
}

// proj (n_angles, nv, nu); gs scratch of (seg_chunk, nv, nu); out_t (nx,
// nz_slab, ny); config: a row of kConfigs.  Launches seg_scale_kernel and
// bp_matched_kernel for each chunk of seg_chunk angles, in order, on
// `stream`; returns the first launch error.
extern "C" int bp_matched_launch(const void* proj, const void* consts,
                                 const void* xc, void* out_t, void* gs,
                                 int seg_chunk, int config, int n_angles,
                                 int nz, int ny, int nx, int nz_slab, int nv,
                                 int nu, float dz, float dy, float dx,
                                 float dv, float du, float offz, float offy,
                                 float offv, float offu, float z0,
                                 int device, void* stream) {
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return (int)err;
  if (seg_chunk < 1) return (int)cudaErrorInvalidValue;
  const JosephGeom g = make_geom(nz, ny, nx, nz_slab, nv, nu, dz, dy, dx,
                                 dv, du, offz, offy, offv, offu, z0);
  return dispatch_config<kNumConfigs>(config, [&](auto c) {
    constexpr int i = decltype(c)::value;
    return launch_tiles<Tile<kConfigs[i][0], kConfigs[i][1]>>(
        (const float*)proj, (const float*)consts, (const float*)xc,
        (float*)out_t, (float*)gs, seg_chunk, n_angles, g,
        (cudaStream_t)stream);
  });
}
