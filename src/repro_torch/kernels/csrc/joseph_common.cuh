// Shared index and weight arithmetic of the Joseph projector pair.
//
// fp_ray.cu (A) and bp_matched.cu (the exact transpose A^T) both call
// joseph_sample() below, and nothing else, to turn one (angle, detector
// pixel (v, u), marching plane x) tuple into the ray's sample position and
// its interpolation taps.  Every line is the fp32 expression of the Pallas
// reference (src/repro/kernels/fp_ray.py:86-134), written with the
// round-to-nearest intrinsics (__fadd_rn, __fmul_rn, __fdiv_rn, __fsqrt_rn)
// so that the compiler can neither contract nor reorder it: the two
// kernels therefore see bit-identical taps and weights, which is what
// keeps <A x, y> == <x, A^T y> to fp32 summation tolerance
// (src/repro/kernels/bp_matched.py:45-49).
//
// The function is force-inlined.  A caller that reads only some fields
// gets the rest removed as dead code, and a loop that varies only the
// plane x gets the per-ray terms hoisted out of the loop; the values
// themselves never change with the call site.
//
// No texture filtering anywhere: its 8-bit fixed-point weights would miss
// the 2e-4 parity band and break the pairing.
#pragma once

#include <cuda_runtime.h>

// Static geometry of one launch.  Mirrors the Python scalars the Pallas
// kernel closes over, each already rounded to fp32 (as JAX does with weak
// Python floats).
struct JosephGeom {
  int nz, ny, nx;      // full volume (nz: full Nz, sets the z centre)
  int nz_slab;         // z planes held by this launch: [z0, z0 + nz_slab)
  int nv, nu;          // detector
  float dz, dy, dx;    // voxel pitch
  float dv, du;        // detector pitch
  float offz, offy;    // volume offsets
  float offv, offu;    // detector offsets
  float cz, cy;        // (nz - 1) / 2, (ny - 1) / 2
  float cv, cu;        // (nv - 1) / 2, (nu - 1) / 2
  float z0;            // global index of the slab's first z plane
};

// One row of the (A, 8) angle table built by angle_constants():
// source (x, y, z), detector centre (x, y), detector u axis (x, y), pad.
struct AngleConsts {
  float sx, sy, sz, dcx, dcy, eux, euy;
};

__device__ __forceinline__ AngleConsts load_angle(
    const float* __restrict__ consts, int a) {
  const float* c = consts + 8 * a;
  AngleConsts k;
  k.sx = c[0]; k.sy = c[1]; k.sz = c[2];
  k.dcx = c[3]; k.dcy = c[4];
  k.eux = c[5]; k.euy = c[6];
  return k;
}

// Everything both kernels need about one ray at one marching plane.
struct JosephSample {
  float s_par;   // ray parameter at the plane (0 at the source, 1 at the pixel)
  float fj, fk;  // fractional y index, slab-local fractional z index
  int j0i, k0i;  // floor of fj, fk
  float wj, wk;  // fj - j0, fk - k0
  bool mask;     // 0 < s_par <= 1: the sample lies between source and pixel
  float seg;     // path length per marching plane, |d| / |d_x| * dx
};

__device__ __forceinline__ JosephSample joseph_sample(
    const AngleConsts& c, int iu, int iv, float x, const JosephGeom& g) {
  // detector coordinates of the pixel centre
  const float u = __fadd_rn(__fmul_rn(__fsub_rn((float)iu, g.cu), g.du), g.offu);
  const float v = __fadd_rn(__fmul_rn(__fsub_rn((float)iv, g.cv), g.dv), g.offv);
  // ray direction: pixel minus source
  const float d_x = __fsub_rn(__fadd_rn(c.dcx, __fmul_rn(u, c.eux)), c.sx);
  const float d_y = __fsub_rn(__fadd_rn(c.dcy, __fmul_rn(u, c.euy)), c.sy);
  const float d_z = __fsub_rn(v, c.sz);
  const float norm = __fsqrt_rn(__fadd_rn(
      __fadd_rn(__fmul_rn(d_x, d_x), __fmul_rn(d_y, d_y)), __fmul_rn(d_z, d_z)));
  const float ad_x = fabsf(d_x);
  JosephSample s;
  s.seg = __fmul_rn(__fdiv_rn(norm, fmaxf(ad_x, 1e-9f)), g.dx);
  const float inv_dx = __fdiv_rn(1.0f, ad_x < 1e-9f ? 1e-9f : d_x);
  // sample at the plane
  s.s_par = __fmul_rn(__fsub_rn(x, c.sx), inv_dx);
  const float yw = __fadd_rn(c.sy, __fmul_rn(s.s_par, d_y));
  s.fj = __fadd_rn(__fdiv_rn(__fsub_rn(yw, g.offy), g.dy), g.cy);
  const float zw = __fsub_rn(__fadd_rn(c.sz, __fmul_rn(s.s_par, d_z)), g.offz);
  s.fk = __fsub_rn(__fadd_rn(__fdiv_rn(zw, g.dz), g.cz), g.z0);
  const float j0 = floorf(s.fj);
  const float k0 = floorf(s.fk);
  s.wj = __fsub_rn(s.fj, j0);
  s.wk = __fsub_rn(s.fk, k0);
  s.j0i = (int)j0;
  s.k0i = (int)k0;
  s.mask = (s.s_par > 0.0f) && (s.s_par <= 1.0f);
  return s;
}

// Fill a JosephGeom from the scalar launch arguments both C entries take.
inline JosephGeom make_geom(int nz, int ny, int nx, int nz_slab, int nv,
                            int nu, float dz, float dy, float dx, float dv,
                            float du, float offz, float offy, float offv,
                            float offu, float z0) {
  JosephGeom g;
  g.nz = nz; g.ny = ny; g.nx = nx; g.nz_slab = nz_slab;
  g.nv = nv; g.nu = nu;
  g.dz = dz; g.dy = dy; g.dx = dx; g.dv = dv; g.du = du;
  g.offz = offz; g.offy = offy; g.offv = offv; g.offu = offu;
  g.cz = (float)((nz - 1) / 2.0);
  g.cy = (float)((ny - 1) / 2.0);
  g.cv = (float)((nv - 1) / 2.0);
  g.cu = (float)((nu - 1) / 2.0);
  g.z0 = z0;
  return g;
}

// Make `device` current for this runtime before a launch (the library
// carries its own static CUDA runtime; the context is the device's primary
// context, shared with PyTorch).
inline cudaError_t use_device(int device) {
  int cur = -1;
  cudaError_t err = cudaGetDevice(&cur);
  if (err != cudaSuccess) return err;
  return cur == device ? cudaSuccess : cudaSetDevice(device);
}
