// Voxel-driven cone-beam backprojector (Hopper, sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/bp_voxel.py::_bp_kernel
// (wrapper bp_voxel_pallas).  For every voxel of the output slab (planes
// [z_start, z_start + planes) of the volume) it sums over the angles, in
// order, a bilinear sample of that angle's projection at the voxel's
// detector position (each of the 4 taps zero outside the detector), times
// one of three depth weights:
//   weight 0  fdk       (DSO / depth)^2
//   weight 1  pmatched  (DSD / depth)^2 * (DSO / DSD)
//   weight 2  none      1
// The result is un-normalised; the algorithms apply their own constants.
//
// Bound on the card (unchanged): each voxel-angle pair costs 19 fp32
// operations of the reference's inner loop (fv: 3, floor and fraction: 2,
// the tap weights: 5, the four taps: 4 multiplies and 3 adds, the depth
// weight and the accumulation: 2).  At the FDK shape (512^3 voxels, 512
// angles) that is 6.9e10 pairs, 1.3e12 operations, 19.5 ms at the 67
// TFLOP/s fp32 peak, against 0.32 ms to read the projections and write the
// volume once at 3.35 TB/s: it is bound by operations.
//
// What held the first version (one thread per column and 8 planes, 217 ms)
// back, read off probe builds (tools/probe_projectors.py): the instruction
// stream, not memory.  Without its gathers it still took 178 ms; with 32
// planes a thread it needed 96 registers and got slower.  Per pair it ran
// bounds tests on four taps, two 64-bit row addresses and four predicated
// global loads; per (column, angle) four IEEE divisions and two loads of
// the angle table.
//
// Design.  A block of 256 threads owns a tile of 32 x 8 (x, y) columns and
// 32 z planes; each thread owns one column and its 32 sums, in registers,
// and walks the angles in order, so no sum crosses threads and no atomics
// are used: every launch gives the same bits.  For each angle
//   * one warp computes the angle's cos and sin and the window of the
//     projection the tile can reach: fu and fv at the 8 corners of the
//     tile's box (fu and fv are linear-fractional in (x, y) and fv affine
//     in z, so their extremes lie at corners), floored and widened by one
//     pixel, the u origin rounded down to a multiple of 4.  It does so
//     kStages angles ahead, into a ring of kStages + 1 table entries;
//   * all threads stage that window into shared memory by cp.async,
//     16 bytes a copy where the detector row is a multiple of 4 floats,
//     with zeros off the detector, kStages - 1 angles ahead of the one
//     being summed (kStages buffers, one __syncthreads per angle);
//   * each thread computes its column's terms once, with one reciprocal of
//     the depth (__frcp_rn) in place of four IEEE divisions:
//       rd = 1 / depth, mag = DSD * rd,
//       fu = (q * mag) * (1 / du) + (cu - offu / du),
//       fv = gz * dfv + fv0, gz = (z_start + kz0 + k) - cz (exact),
//       dfv = dz * (mag / dv), fv0 = offz * (mag / dv) + (cv - offv / dv),
//     so that a plane's fv depends on its index in the volume alone, not
//     on where a slab or a tile starts (streamed and in-core runs take
//     the same taps),
//       w2d = (DSO * rd)^2, mag^2 * (DSO / DSD) or 1;
//     then for each of its 32 planes: floor by adding 1.5 * 2^23 rounding
//     down (exact for |x| < 2^22; no conversion instruction), the four taps
//     from the window at a fixed row stride (no bounds tests: the window
//     holds zeros off the detector), and the blend as three lerps:
//       r0 = p00 + wu * (p01 - p00), r1 = p10 + wu * (p11 - p10),
//       acc += (r0 + wv * (r1 - r0)) * w2d    (each line fused multiply-adds).
// The reordered expressions differ from the reference's order by a few
// fp32 ulps of fu and fv; tests/test_torch_projector_windows.py emulates
// them on the CPU and holds them to the plain version's band (rtol 2e-4,
// atol 5e-3).  A column whose taps leave the staged window (the window
// wider than a buffer, a depth <= 0 at a corner, or rounding past the
// widened edge) reads its taps from global memory with bounds tests, by
// the same arithmetic: the same value, never another result.  The z, y and
// x tails of the volume are computed as virtual voxels and not stored, so
// any shape, slab (z_start, planes) and angle count is taken.  No texture
// filtering (its 8-bit weights would miss the 2e-4 parity band).
//
// Resources (nvcc 12.9, ptxas -v; tools/probe_projectors.py): 45,824 bytes
// of shared memory a block (3 buffers of 56 x 68 floats and the
// 4-entry angle ring), 64 registers (the launch bounds' cap for 4 blocks;
// 80 uncapped, 3 blocks, 2.4 % slower), 4 blocks of 256 threads an SM:
// 32 of 64 warps.
//
// Tile configurations (tile_configs.cuh).  The planes a thread sums
// (tile_z) and the columns in y of a block (tile_y, its warps) are
// template parameters; the library holds the instantiations of kConfigs
// below, row 0 (32 planes, 8 rows: the tile described above) the
// default, and bp_voxel_launch takes the row's index.  A buffer's rows
// scale with the planes (kRows = 7/4 kTZ: 56 at 32) and its row stride
// with the tile's width across the rays (68 floats up to 8 rows, 84 at
// 16); the buffers are dynamic shared memory (91,520 bytes a block at 64
// planes).  Neither knob touches a voxel's sum: a thread sums its own
// voxels over the angles in order, a plane's fv depends on its index in
// the volume alone, and a tap read from the window or from global memory
// is the same value, so every configuration gives the same output bit for
// bit.  The launch bounds keep 1024 threads an SM (64 registers) up to 32
// planes a thread and 512 (128 registers) at 64.
#include <cuda_runtime.h>

#include "tile_configs.cuh"

namespace {

constexpr int kTX = 32;              // columns in x (a warp's lanes)
// {tile_z, tile_y}: planes a thread sums, columns in y (the block's warps)
constexpr int kConfigs[][2] = {{32, 8}, {16, 8}, {64, 8},
                               {32, 4}, {32, 16}, {16, 16}};
constexpr int kNumConfigs = sizeof(kConfigs) / sizeof(kConfigs[0]);
constexpr int kStages = 3;           // window buffers (angles in flight)
constexpr int kWiden = 1;            // pixels added on each side
constexpr float kMagic = 12582912.0f;      // 1.5 * 2^23
constexpr float kCoordMax = 1048576.0f;    // 2^20: larger detector indices
                                           // are off any window

// ---- staging: a window of a projection into shared memory by cp.async.
// The window holds rows [r0, r0 + rows) and columns [c0, c0 + 4 * nch) of
// an image of n_rows x n_cols floats (row pitch `pitch` floats) at a row
// stride of `stride` floats.  Every element off the image is written as
// 0.0f, so a tap off the detector reads zero from the window.  Where the
// pitch, c0 and the stride are multiples of 4 the copies are 16 bytes (a
// chunk lies wholly on or wholly off the detector), else 4 bytes.
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// cp.async of `bytes` (4 or 16) with zero fill: src_bytes = 0 writes zeros
// and reads nothing.
template <int kBytes>
__device__ __forceinline__ void cp_async_zfill(void* dst, const void* src,
                                               bool valid) {
  if constexpr (kBytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "r"(valid ? 16 : 0));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "r"(valid ? 4 : 0));
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// Issue the copies of one window; warps take rows, lanes take chunks.
__device__ __forceinline__ void stage_window(
    float* __restrict__ win, int stride, int rows, int r0, int c0, int nch,
    const float* __restrict__ img, int pitch, int n_rows, int n_cols,
    bool vec, int warp, int lane, int n_warps) {
  for (int r = warp; r < rows; r += n_warps) {
    const int gr = r0 + r;
    const bool row_ok = gr >= 0 && gr < n_rows;
    const float* src_row = img + (size_t)(row_ok ? gr : 0) * pitch;
    float* dst_row = win + r * stride;
    if (vec) {
      for (int ch = lane; ch < nch; ch += 32) {
        const int gc = c0 + 4 * ch;
        const bool ok = row_ok && gc >= 0 && gc < n_cols;
        cp_async_zfill<16>(dst_row + 4 * ch, ok ? src_row + gc : img, ok);
      }
    } else {
      for (int c = lane; c < 4 * nch; c += 32) {
        const int gc = c0 + c;
        const bool ok = row_ok && gc >= 0 && gc < n_cols;
        cp_async_zfill<4>(dst_row + c, ok ? src_row + gc : img, ok);
      }
    }
  }
}

// A float of shared memory at byte address addr + kOff.
template <int kOff>
__device__ __forceinline__ float lds(unsigned addr) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1+%2];\n" : "=f"(v) : "r"(addr), "n"(kOff));
  return v;
}

// The compile-time shape of one configuration: the tile and its window
// buffers.
template <int kTZ_, int kTY_>
struct Tile {
  static constexpr int kTZ = kTZ_;               // planes a thread sums
  static constexpr int kTY = kTY_;               // columns in y
  static constexpr int kThreads = kTX * kTY;
  static constexpr int kWarps = kThreads / 32;
  static constexpr int kRows = kTZ * 7 / 4;      // window rows per buffer
  static constexpr int kStride = kTY > 8 ? 84 : 68;  // floats per row
  static constexpr int kWinFloats = kRows * kStride;
  static constexpr int kMinBlocks = (kTZ > 32 ? 512 : 1024) / kThreads;
};

struct VoxelGeom {
  int n_angles;
  int nz, ny, nx;      // full volume (nz sets the z centre)
  int planes;          // z planes of the output slab
  int nv, nu;          // detector
  float dz, dy, dx;    // voxel pitch
  float offz, offy, offx;
  float cz, cy, cx;    // (n - 1) / 2 of the volume axes
  float dso, dsd;
  float dso_over_dsd;  // DSO / DSD (rounded once)
  float z_start;       // global index of the slab's first plane
  float inv_du, inv_dv;
  float fu_c;          // cu - offu / du
  float fv_c;          // cv - offv / dv
  bool vec;            // 16-byte copies: nu a multiple of 4, proj aligned
};

// One angle's entry of the ring: cos, sin and the staged window (rows
// [v0, v0 + rows), columns [u0, u0 + 4 * nch)); ok: the window fits a
// buffer and every corner lies in front of the source.
struct AngleWin {
  float cth, sth;
  int u0, v0, nch, rows, ok, pad;
};

// The per-(column, angle) terms; front: depth > 0.
struct ColTerms {
  float fu, fv0, dfv, w2d;   // fv = gz * dfv + fv0
  bool front;
};

template <int W>
__device__ __forceinline__ ColTerms column_terms(const VoxelGeom& g, float X,
                                                 float Y,
                                                 float cth, float sth) {
  const float p = X * cth + Y * sth;
  const float q = Y * cth - X * sth;
  const float depth = g.dso - p;
  const float rd = __frcp_rn(depth);
  const float mag = g.dsd * rd;
  const float fvs = mag * g.inv_dv;
  ColTerms t;
  t.fu = fmaf(q * mag, g.inv_du, g.fu_c);
  t.fv0 = fmaf(g.offz, fvs, g.fv_c);
  t.dfv = g.dz * fvs;
  if (W == 0) {
    const float r = g.dso * rd;
    t.w2d = r * r;
  } else if (W == 1) {
    t.w2d = (mag * mag) * g.dso_over_dsd;
  } else {
    t.w2d = 1.0f;
  }
  t.front = depth > 0.0f;
  return t;
}

__device__ __forceinline__ float clamp_coord(float f) {
  return fminf(fmaxf(f, -kCoordMax), kCoordMax);
}

// floor(x) and its int, for |x| < 2^22: x + 1.5 * 2^23 rounded down is
// floor(x) + 1.5 * 2^23 exactly, its low mantissa bits the integer.
__device__ __forceinline__ float floor_magic(float x, int* i) {
  const float t = __fadd_rd(x, kMagic);
  *i = __float_as_int(t) - __float_as_int(kMagic);
  return t - kMagic;
}

__device__ __forceinline__ float column_x(const VoxelGeom& g, int ix) {
  return ((float)ix - g.cx) * g.dx + g.offx;
}
__device__ __forceinline__ float column_y(const VoxelGeom& g, int iy) {
  return ((float)iy - g.cy) * g.dy + g.offy;
}

// The window of angle a for the tile at (ix0, iy0), planes from gz0: each
// lane takes corner (lane & 7) of the box; the whole warp calls it.
template <class T>
__device__ void compute_window(const VoxelGeom& g,
                               const float* __restrict__ consts, int a,
                               int ix0, int iy0, float gz0, int lane,
                               AngleWin* out) {
  const float sth = -__ldg(consts + 8 * a + 5);
  const float cth = __ldg(consts + 8 * a + 6);
  const int c = lane & 7;
  const float X = column_x(g, ix0 + ((c & 1) ? kTX - 1 : 0));
  const float Y = column_y(g, iy0 + ((c & 2) ? T::kTY - 1 : 0));
  const ColTerms t = column_terms<2>(g, X, Y, cth, sth);
  const float fv =
      fmaf(gz0 + ((c & 4) ? (float)(T::kTZ - 1) : 0.0f), t.dfv, t.fv0);
  bool good = t.front && fabsf(t.fu) < kCoordMax && fabsf(fv) < kCoordMax;
  float umin = t.fu, umax = t.fu, vmin = fv, vmax = fv;
#pragma unroll
  for (int m = 1; m < 8; m <<= 1) {
    umin = fminf(umin, __shfl_xor_sync(0xffffffffu, umin, m));
    umax = fmaxf(umax, __shfl_xor_sync(0xffffffffu, umax, m));
    vmin = fminf(vmin, __shfl_xor_sync(0xffffffffu, vmin, m));
    vmax = fmaxf(vmax, __shfl_xor_sync(0xffffffffu, vmax, m));
  }
  good = __all_sync(0xffffffffu, good);
  if (lane == 0) {
    AngleWin w;
    w.cth = cth;
    w.sth = sth;
    w.ok = 0;
    w.u0 = w.v0 = w.nch = w.rows = w.pad = 0;
    if (good) {
      const int u0 = ((int)floorf(umin) - kWiden) & ~3;
      const int u1 = (int)floorf(umax) + 1 + kWiden;
      const int v0 = (int)floorf(vmin) - kWiden;
      const int v1 = (int)floorf(vmax) + 1 + kWiden;
      w.u0 = u0;
      w.nch = (u1 - u0) / 4 + 1;
      w.v0 = v0;
      w.rows = v1 - v0 + 1;
      w.ok = 4 * w.nch <= T::kStride && w.rows <= T::kRows;
    }
    *out = w;
  }
}

// Add one column's kTZ planes of one angle to acc; tap(tb, p) reads the
// four taps p[0..3] = (j0, i0), (j0, i0 + 1), (j0 + 1, i0), (j0 + 1, i0 + 1)
// of row j0 = tb - kMagicBits, tb the bits of fv + 1.5 * 2^23 rounded down
// (so that the window's address is one multiply-add of them).  kClamp
// bounds fv for the global path (a value it changes lies off every window
// and off the detector).
constexpr unsigned kMagicBits = 0x4B400000u;   // the bits of kMagic

template <bool kClamp, int kTZ, class Tap>
__device__ __forceinline__ void add_planes(float (&acc)[kTZ], float wu,
                                           float gz0, float fv0, float dfv,
                                           float w2d, Tap tap) {
#pragma unroll
  for (int k = 0; k < kTZ; ++k) {
    float fv = fmaf(gz0 + (float)k, dfv, fv0);
    if (kClamp) fv = clamp_coord(fv);
    const float t = __fadd_rd(fv, kMagic);
    const float wv = fv - (t - kMagic);
    float p[4];
    tap(__float_as_uint(t), p);
    const float r0 = fmaf(wu, p[1] - p[0], p[0]);
    const float r1 = fmaf(wu, p[3] - p[2], p[2]);
    acc[k] = fmaf(fmaf(wv, r1 - r0, r0), w2d, acc[k]);
  }
}

template <class T, int W>
__global__ void __launch_bounds__(T::kThreads, T::kMinBlocks)
    bp_voxel_kernel(const float* __restrict__ proj,
                    const float* __restrict__ consts, float* __restrict__ out,
                    VoxelGeom g) {
  constexpr int kTY = T::kTY, kTZ = T::kTZ, kWarps = T::kWarps;
  constexpr int kStride = T::kStride;
  // kStages window buffers of T::kWinFloats, then the angle ring
  extern __shared__ __align__(16) float smem[];
  float* const win = smem;
  AngleWin* const tab =
      reinterpret_cast<AngleWin*>(smem + kStages * T::kWinFloats);
  const int tid = threadIdx.y * kTX + threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int ix0 = blockIdx.x * kTX, iy0 = blockIdx.y * kTY;
  const int kz0 = blockIdx.z * kTZ;
  const int ix = ix0 + threadIdx.x, iy = iy0 + threadIdx.y;
  const float X = column_x(g, ix), Y = column_y(g, iy);
  // the index of the tile's first plane in the volume, less cz (exact)
  const float gz0 = ((float)kz0 + g.z_start) - g.cz;
  const int n_angles = g.n_angles;
  const size_t det = (size_t)g.nv * g.nu;

  float acc[kTZ];
#pragma unroll
  for (int k = 0; k < kTZ; ++k) acc[k] = 0.0f;

  auto issue = [&](int b) {
    const AngleWin& w = tab[b % (kStages + 1)];
    if (w.ok)
      stage_window(win + (b % kStages) * T::kWinFloats, kStride, w.rows,
                   w.v0, w.u0, w.nch,
                   proj + (size_t)b * det, g.nu, g.nv, g.nu, g.vec, warp, lane,
                   kWarps);
  };

  if (warp < kStages && warp < n_angles)
    compute_window<T>(g, consts, warp, ix0, iy0, gz0, lane, &tab[warp]);
  __syncthreads();
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_angles) issue(s);
    cp_async_commit();
  }

  for (int a = 0; a < n_angles; ++a) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // angle a's window has landed; a - 1's is consumed
    if (a + kStages - 1 < n_angles) issue(a + kStages - 1);
    cp_async_commit();
    if (warp == a % kWarps && a + kStages < n_angles)
      compute_window<T>(g, consts, a + kStages, ix0, iy0, gz0, lane,
                     &tab[(a + kStages) % (kStages + 1)]);

    const AngleWin w = tab[a % (kStages + 1)];
    const ColTerms t = column_terms<W>(g, X, Y, w.cth, w.sth);
    int i0, jf, jl;
    const float fu = clamp_coord(t.fu);
    const float wu = fu - floor_magic(fu, &i0);
    floor_magic(clamp_coord(fmaf(gz0, t.dfv, t.fv0)), &jf);
    floor_magic(clamp_coord(fmaf(gz0 + (float)(kTZ - 1), t.dfv, t.fv0)),
                &jl);
    const bool fast = w.ok && t.front && i0 >= w.u0 &&
                      i0 + 1 < w.u0 + 4 * w.nch && min(jf, jl) >= w.v0 &&
                      max(jf, jl) + 1 < w.v0 + w.rows;
    if (fast) {
      // byte address of tap (j0, i0): base + 4 * kStride * (tb - kMagicBits)
      const unsigned base =
          smem_addr(win + (a % kStages) * T::kWinFloats) +
          4u * (unsigned)((i0 - w.u0) - w.v0 * kStride) -
          kMagicBits * (4u * kStride);
      add_planes<false>(acc, wu, gz0, t.fv0, t.dfv, t.w2d,
                        [&](unsigned tb, float* p) {
                          const unsigned r = base + tb * (4u * kStride);
                          p[0] = lds<0>(r);
                          p[1] = lds<4>(r);
                          p[2] = lds<4 * kStride>(r);
                          p[3] = lds<4 * kStride + 4>(r);
                        });
    } else {
      const float* pa = proj + (size_t)a * det;
      const int nv = g.nv, nu = g.nu;
      add_planes<true>(acc, wu, gz0, t.fv0, t.dfv, t.w2d,
                       [&](unsigned tb, float* p) {
                         const int j0 = (int)(tb - kMagicBits);
#pragma unroll
                         for (int e = 0; e < 4; ++e) {
                           const int jj = j0 + (e >> 1), ii = i0 + (e & 1);
                           p[e] = (jj >= 0 && jj < nv && ii >= 0 && ii < nu)
                                      ? __ldg(pa + (size_t)jj * nu + ii)
                                      : 0.0f;
                         }
                       });
    }
  }

  if (ix >= g.nx || iy >= g.ny) return;
  const size_t plane = (size_t)g.ny * g.nx;
  float* o = out + (size_t)kz0 * plane + (size_t)iy * g.nx + ix;
#pragma unroll
  for (int k = 0; k < kTZ; ++k) {
    if (kz0 + k < g.planes) o[(size_t)k * plane] = acc[k];
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

// One configuration's launch: the kernel of `weight`, its dynamic shared
// memory (the window buffers and the angle ring) opted in.
template <class T, int W>
int launch_weight(const float* p, const float* c, float* o,
                  const VoxelGeom& g, cudaStream_t st) {
  constexpr int kSmem =
      kStages * T::kWinFloats * (int)sizeof(float) +
      (kStages + 1) * (int)sizeof(AngleWin);
  cudaError_t err = cudaFuncSetAttribute(
      bp_voxel_kernel<T, W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmem);
  if (err != cudaSuccess) return (int)err;
  const dim3 block(kTX, T::kTY);
  const dim3 grid((g.nx + kTX - 1) / kTX, (g.ny + T::kTY - 1) / T::kTY,
                  (g.planes + T::kTZ - 1) / T::kTZ);
  bp_voxel_kernel<T, W><<<grid, block, kSmem, st>>>(p, c, o, g);
  return (int)cudaGetLastError();
}

template <class T>
int launch_tiles(const float* p, const float* c, float* o,
                 const VoxelGeom& g, int weight, cudaStream_t st) {
  if (weight == 0) return launch_weight<T, 0>(p, c, o, g, st);
  if (weight == 1) return launch_weight<T, 1>(p, c, o, g, st);
  return launch_weight<T, 2>(p, c, o, g, st);
}

}  // namespace

// The tile configurations: "tile_z tile_y", one row of kConfigs each.
extern "C" const char* bp_voxel_config_knobs() { return "tile_z tile_y"; }
extern "C" int bp_voxel_configs(int* values, int capacity) {
  return copy_configs(kConfigs, values, capacity);
}

// proj (n_angles, nv, nu), consts (n_angles, 8) and out (planes, ny, nx),
// all float32, contiguous, on `device`; config: a row of kConfigs.
// Returns cudaGetLastError().
extern "C" int bp_voxel_launch(const void* proj, const void* consts,
                               void* out, int n_angles, int nz, int ny,
                               int nx, int planes, int nv, int nu, float dz,
                               float dy, float dx, float dv, float du,
                               float offz, float offy, float offx, float ovd,
                               float offu, float dso, float dsd,
                               float dso_over_dsd, float z_start, int weight,
                               int config, int device, void* stream) {
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return (int)err;
  if (weight < 0 || weight > 2) return (int)cudaErrorInvalidValue;
  VoxelGeom g;
  g.n_angles = n_angles;
  g.nz = nz; g.ny = ny; g.nx = nx; g.planes = planes;
  g.nv = nv; g.nu = nu;
  g.dz = dz; g.dy = dy; g.dx = dx;
  g.offz = offz; g.offy = offy; g.offx = offx;
  g.cz = (float)((nz - 1) / 2.0);
  g.cy = (float)((ny - 1) / 2.0);
  g.cx = (float)((nx - 1) / 2.0);
  g.dso = dso; g.dsd = dsd; g.dso_over_dsd = dso_over_dsd;
  g.z_start = z_start;
  g.inv_du = (float)(1.0 / (double)du);
  g.inv_dv = (float)(1.0 / (double)dv);
  g.fu_c = (float)((nu - 1) / 2.0 - (double)offu / (double)du);
  g.fv_c = (float)((nv - 1) / 2.0 - (double)ovd);
  g.vec = (nu & 3) == 0 && ((size_t)proj & 15) == 0;
  return dispatch_config<kNumConfigs>(config, [&](auto cfg) {
    constexpr int i = decltype(cfg)::value;
    return launch_tiles<Tile<kConfigs[i][0], kConfigs[i][1]>>(
        (const float*)proj, (const float*)consts, (float*)out, g, weight,
        (cudaStream_t)stream);
  });
}
