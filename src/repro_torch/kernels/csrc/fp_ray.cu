// Joseph cone-beam forward projector A for x-dominant angles (Hopper, sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/fp_ray.py::_fp_kernel
// (wrapper fp_ray_pallas).  Computes, for every ray (angle, v, u), the sum
// over the marching x planes of a bilinear (z, y) sample of the plane,
// counted only where 0 < s <= 1, times the per-plane path length seg.
// Taps outside [0, nz_slab) x [0, Ny) contribute zero, so the partial
// projections of disjoint z slabs sum to the projection of the whole
// volume (the out-of-core executor relies on it).
//
// Bound on the card (unchanged): at N=512 with 512 angles the kernel takes
// 512 * 512 * 512 * 512 = 6.9e10 ray-plane samples at about 8 fp32
// operations each for the two blends and the accumulation, about 8 ms at
// the 67 TFLOP/s fp32 peak, against about 0.3 ms to read the volume and
// write the projections once at 3.35 TB/s: it is bound by operations.
//
// What held the first version (one thread per ray, every sample through
// joseph_sample(), 146 ms at one dominance group of 257 angles) back, read
// off probe builds (tools/probe_projectors.py): the instruction stream, not
// memory.  Without its gathers it still took 119 ms, without its IEEE
// divisions 137 ms.  Each sample recomputed the u-part (an IEEE division
// and ~15 operations that do not depend on v) beside the z tap (a second
// division), eight bounds tests and four 64-bit gather addresses.
//
// Design.  A block of 128 threads owns one angle and a tile of 32 u by 16
// v rays; a thread owns one u (its lane) and 4 consecutive rows v, keeps
// their 4 sums in registers and walks the planes in order, so no sum
// crosses threads and no atomics are used.  The ray's terms that do not
// depend on the plane (joseph_ray(): d_y, 1 / d_x, seg's) are computed
// once; then for each plane x it
//   * computes the u-part once for its 4 rows: the y tap, its bounds tests
//     and weights, and the mask;
//   * computes the rows' z taps;
//   both by the short route of joseph_common.cuh (joseph_u_fast(),
//   joseph_v_tap_fast()): a quotient from the correctly rounded reciprocal
//   of dy or dz and one fused correction (the correctly rounded quotient,
//   which __fdiv_rn returns) and a floor by adding 1.5 * 2^23 rounding
//   down, with no conversion instruction; a numerator or index outside the
//   ranges where that is exact (zero, subnormal, |f| >= 2^22) takes the
//   __fdiv_rn route (joseph_u_at(), joseph_v_tap_dz());
//   * skips the plane when the last row's z taps lie below the slab or
//     the first row's above it: k0i rises with v (every step of fk is
//     monotone in v for s_par > 0), so no row samples the slab there (a
//     streamed slab of 171 of 512 planes skips most planes of most tiles);
//   * for each row, loads the four taps at clamped 32-bit offsets into the
//     plane, with no branch (so the loads of all rows are in flight
//     together), and selects away the taps the reference's bounds tests
//     zero.
// Every tap and weight is joseph_common.cuh's, bit for bit, and the blend
// is the first kernel's to the rounding: nvcc had fused its products as
//   col0 = fma(wy0, v00, wy1 * v01), col1 = fma(wy1, v11, wy0 * v10),
//   acc += fma(wz0, col0, wz1 * col1),
// (read off its SASS), which this kernel writes out with the __f*_rn
// intrinsics, so that the result is the first kernel's bit for bit and
// bp_matched stays its exact transpose.  Tails of u and v are computed as
// virtual rays and not stored.
//
// Not staged in shared memory.  A tile's rays sample about one voxel each
// per plane (at N = 512 a ray pitch of ~0.52 mm at the volume, ~0.87 mm in
// y at 45 degrees, against 0.5 mm voxels), so a staged window is read ~1.5
// to 4 times a float: a build that staged each plane's window by cp.async
// (one __syncthreads a plane) ran at 161 ms, slower than the first kernel;
// the gathers' lines serve neighbouring lanes from L1 instead.
//
// The wrapper hands the volume over in the marching-plane layout (Nx,
// nz_slab, Ny) (as fp_ray.py:176 does), so the 32 lanes of a warp, which
// hold neighbouring u, read neighbouring j of one plane row.  The copy
// costs one more slab of device memory and, at N = 512, about 2.3 ms a
// launch (tools/probe_projectors.py).
//
// Resources (nvcc 12.9, ptxas -v; tools/probe_projectors.py): no shared
// memory, at most 64 registers (the launch bounds' cap for 8 blocks), 8
// blocks of 128 threads an SM: 32 of 64 warps.
//
// Tile configurations (tile_configs.cuh).  The rows v a thread owns
// (rows_per) and the warps of a block (warps) are template parameters; the
// library holds the instantiations of kConfigs below, row 0 (4 rows, 4
// warps: the tile described above) the default, and fp_ray_launch takes
// the row's index.  Neither knob touches a ray's sum: each thread sums its
// own rays over the planes in order, the plane skip drops only planes
// whose taps are all zero for every row it owns, and the short and exact
// routes of the taps give the same bits, so every configuration gives
// the same output bit for bit.  The launch bounds keep 1024 threads an SM
// (64 registers) for 2 and 4 rows a thread and 512 (128 registers) for 8.
#include "joseph_common.cuh"
#include "tile_configs.cuh"

namespace {

constexpr int kTU = 32;              // u per tile (a warp's lanes)
// {rows_per, warps}
constexpr int kConfigs[][2] = {{4, 4}, {2, 4}, {8, 4},
                               {2, 8}, {4, 8}, {8, 8}};
constexpr int kNumConfigs = sizeof(kConfigs) / sizeof(kConfigs[0]);

// p, with its provenance hidden from the compiler (which otherwise folds
// the plane's base into every gather's 64-bit address arithmetic).
__device__ __forceinline__ const float* opaque(const float* p) {
  asm("" : "+l"(p));
  return p;
}

template <int kRowsPer, int kWarps>
__global__ void __launch_bounds__(kTU * kWarps,
                                  (kRowsPer > 4 ? 512 : 1024) / (kTU * kWarps))
    fp_ray_kernel(const float* __restrict__ vol_t,
                  const float* __restrict__ consts,
                  const float* __restrict__ xc, float* __restrict__ out,
                  JosephGeom g) {
  constexpr int kTV = kWarps * kRowsPer;
  const int iu = blockIdx.x * kTU + threadIdx.x;
  const int v0 = blockIdx.y * kTV + threadIdx.y * kRowsPer;
  const int a = blockIdx.z;
  const AngleConsts c = load_angle(consts, a);
  const size_t plane_size = (size_t)g.nz_slab * g.ny;

  float acc[kRowsPer], d_z[kRowsPer];
#pragma unroll
  for (int r = 0; r < kRowsPer; ++r) {
    acc[r] = 0.0f;
    d_z[r] = joseph_dz(c, v0 + r, g);
  }

  const JosephRay ray = joseph_ray(c, iu, g);
  const float rdy = __frcp_rn(g.dy), rdz = __frcp_rn(g.dz);
  for (int p = 0; p < g.nx; ++p) {
    // the u-part and the rows' z taps by the short route; the exact one
    // where it does not apply (a zero or extreme numerator or index, never
    // at a sane geometry)
    const float x = __ldg(xc + p);
    JosephU su;
    if (!joseph_u_fast(c, ray, x, rdy, g, &su)) su = joseph_u_at(c, ray, x, g);
    if (!su.mask) continue;
    const bool okj0 = su.j0i >= 0 && su.j0i < g.ny;
    const bool okj1 = su.j0i + 1 >= 0 && su.j0i + 1 < g.ny;
    if (!(okj0 || okj1)) continue;
    int k0[kRowsPer];
    float wk[kRowsPer];
    bool fast = true;
#pragma unroll
    for (int r = 0; r < kRowsPer; ++r)
      fast &= joseph_v_tap_fast(c, su.s_par, d_z[r], rdz, g, &k0[r], &wk[r]);
    if (!fast) {
#pragma unroll
      for (int r = 0; r < kRowsPer; ++r) {
        const JosephV s = joseph_v_tap_dz(c, su.s_par, d_z[r], g);
        k0[r] = s.k0i;
        wk[r] = s.wk;
      }
    }
    // k0i rises with v: no row reaches the slab
    if (k0[kRowsPer - 1] < -1 || k0[0] > g.nz_slab - 1) continue;
    const float wy0 = okj0 ? __fsub_rn(1.0f, su.wj) : 0.0f;
    const float wy1 = okj1 ? su.wj : 0.0f;
    // the j taps' column of the plane and the next one (the same where
    // j0i + 1 is clamped), through an empty asm so that each gather is one
    // wide multiply-add of a 32-bit row offset
    const int j0 = min(max(su.j0i, 0), g.ny - 1);
    const int j1 = min(max(su.j0i + 1, 0), g.ny - 1);
    const float* p0 = opaque(vol_t + (size_t)p * plane_size + j0);
    const float* p1 = opaque(vol_t + (size_t)p * plane_size + j1);
#pragma unroll
    for (int r = 0; r < kRowsPer; ++r) {
      const bool okk0 = k0[r] >= 0 && k0[r] < g.nz_slab;
      const bool okk1 = k0[r] + 1 >= 0 && k0[r] + 1 < g.nz_slab;
      // every address clamped into the plane, every load made, the taps
      // off the slab or the plane selected away: no branch, so the loads
      // of all rows are in flight together
      const int o0 = min(max(k0[r], 0), g.nz_slab - 1) * g.ny;
      const int o1 = min(max(k0[r] + 1, 0), g.nz_slab - 1) * g.ny;
      const float v00 = okj0 ? __ldg(p0 + o0) : 0.0f;
      const float v01 = okj1 ? __ldg(p1 + o0) : 0.0f;
      const float v10 = okj0 ? __ldg(p0 + o1) : 0.0f;
      const float v11 = okj1 ? __ldg(p1 + o1) : 0.0f;
      // y blend of the two z rows, then the z blend (fp_ray.py:109-132),
      // each product fused where nvcc fused it in the first kernel (its
      // SASS): the second row's blend fuses the other product
      const float col0 =
          okk0 ? __fmaf_rn(wy0, v00, __fmul_rn(wy1, v01)) : 0.0f;
      const float col1 =
          okk1 ? __fmaf_rn(wy1, v11, __fmul_rn(wy0, v10)) : 0.0f;
      const float wz0 = okk0 ? __fsub_rn(1.0f, wk[r]) : 0.0f;
      const float wz1 = okk1 ? wk[r] : 0.0f;
      acc[r] = __fadd_rn(acc[r], __fmaf_rn(wz0, col0, __fmul_rn(wz1, col1)));
    }
  }

  if (iu >= g.nu) return;
#pragma unroll
  for (int r = 0; r < kRowsPer; ++r) {
    if (v0 + r < g.nv)
      out[((size_t)a * g.nv + v0 + r) * g.nu + iu] =
          acc[r] * joseph_seg(ray.dxy2, ray.adx, d_z[r], g);
  }
}

template <int kRowsPer, int kWarps>
int launch_tiles(const float* vol_t, const float* consts, const float* xc,
                 float* out, int n_angles, const JosephGeom& g,
                 cudaStream_t stream) {
  constexpr int kTV = kWarps * kRowsPer;
  const dim3 block(kTU, kWarps);
  const dim3 grid((g.nu + kTU - 1) / kTU, (g.nv + kTV - 1) / kTV, n_angles);
  fp_ray_kernel<kRowsPer, kWarps><<<grid, block, 0, stream>>>(
      vol_t, consts, xc, out, g);
  return (int)cudaGetLastError();
}

}  // namespace

// The tile configurations: "rows_per warps", one row of kConfigs each.
extern "C" const char* fp_ray_config_knobs() { return "rows_per warps"; }
extern "C" int fp_ray_configs(int* values, int capacity) {
  return copy_configs(kConfigs, values, capacity);
}

extern "C" int fp_ray_launch(const void* vol_t, const void* consts,
                             const void* xc, void* out, int config,
                             int n_angles, int nz, int ny, int nx,
                             int nz_slab, int nv, int nu, float dz, float dy,
                             float dx, float dv, float du, float offz,
                             float offy, float offv, float offu, float z0,
                             int device, void* stream) {
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return (int)err;
  const JosephGeom g = make_geom(nz, ny, nx, nz_slab, nv, nu, dz, dy, dx,
                                 dv, du, offz, offy, offv, offu, z0);
  return dispatch_config<kNumConfigs>(config, [&](auto c) {
    constexpr int i = decltype(c)::value;
    return launch_tiles<kConfigs[i][0], kConfigs[i][1]>(
        (const float*)vol_t, (const float*)consts, (const float*)xc,
        (float*)out, n_angles, g, (cudaStream_t)stream);
  });
}
