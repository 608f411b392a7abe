// Shared index and weight arithmetic of the Joseph projector pair.
//
// fp_ray.cu (A) and bp_matched.cu (the exact transpose A^T) call
// joseph_u() (what depends on the angle, u and the plane x), joseph_v_tap()
// (the z tap of one pixel row v), joseph_dz() and joseph_seg() (the path
// length per plane); fp_ray takes the same bits of the first two from
// joseph_ray() once per ray and joseph_u_fast() / joseph_v_tap_fast() (a
// shorter route) or joseph_u_at() / joseph_v_tap_dz() per plane; and
// nothing else, to turn one (angle, detector pixel (v, u), marching plane x) tuple
// into the ray's sample position and its interpolation taps.  Every line
// is the fp32 expression of the Pallas reference
// (src/repro/kernels/fp_ray.py:86-134), written with the round-to-nearest
// intrinsics (__fadd_rn, __fmul_rn, __fdiv_rn, __fsqrt_rn) so that the
// compiler can neither contract nor reorder it: the two kernels therefore
// see bit-identical taps and weights, which is what keeps
// <A x, y> == <x, A^T y> to fp32 summation tolerance
// (src/repro/kernels/bp_matched.py:45-49).
//
// The functions are force-inlined.  A caller that reads only some fields
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

// The part of a sample that depends on (angle, u, plane x) alone: the
// in-plane (y) tap and everything the z tap and seg need from u.
struct JosephU {
  float s_par;   // ray parameter at the plane (0 at the source, 1 at the pixel)
  float fj;      // fractional y index
  int j0i;       // floor of fj
  float wj;      // fj - j0
  bool mask;     // 0 < s_par <= 1: the sample lies between source and pixel
  float dxy2;    // d_x^2 + d_y^2, the first two terms of |d|^2
  float adx;     // max(|d_x|, 1e-9), the divisor of seg
};

// The part that depends on (angle, u, v, plane x): the z tap and seg.
struct JosephV {
  float fk;      // slab-local fractional z index
  int k0i;       // floor of fk
  float wk;      // fk - k0
  float d_z;     // v - sz, the ray's z direction (for seg)
};

// The part of a ray that does not depend on the plane: its y direction,
// 1 / d_x and the terms of seg.
struct JosephRay {
  float d_y, inv_dx, dxy2, adx;
};

__device__ __forceinline__ JosephRay joseph_ray(const AngleConsts& c, int iu,
                                                const JosephGeom& g) {
  // detector u of the pixel centre; ray direction (pixel minus source)
  const float u = __fadd_rn(__fmul_rn(__fsub_rn((float)iu, g.cu), g.du), g.offu);
  const float d_x = __fsub_rn(__fadd_rn(c.dcx, __fmul_rn(u, c.eux)), c.sx);
  JosephRay r;
  r.d_y = __fsub_rn(__fadd_rn(c.dcy, __fmul_rn(u, c.euy)), c.sy);
  const float ad_x = fabsf(d_x);
  r.dxy2 = __fadd_rn(__fmul_rn(d_x, d_x), __fmul_rn(r.d_y, r.d_y));
  r.adx = fmaxf(ad_x, 1e-9f);
  r.inv_dx = __fdiv_rn(1.0f, ad_x < 1e-9f ? 1e-9f : d_x);
  return r;
}

// s_par and (yw - offy) of the ray at plane x, the first steps of
// joseph_u_at().
__device__ __forceinline__ float joseph_s_par(const AngleConsts& c,
                                              const JosephRay& ray, float x) {
  return __fmul_rn(__fsub_rn(x, c.sx), ray.inv_dx);
}
__device__ __forceinline__ float joseph_yw(const AngleConsts& c,
                                           const JosephRay& ray, float s_par,
                                           const JosephGeom& g) {
  return __fsub_rn(__fadd_rn(c.sy, __fmul_rn(s_par, ray.d_y)), g.offy);
}

// The u-part at plane x of the ray joseph_ray() gave.
__device__ __forceinline__ JosephU joseph_u_at(const AngleConsts& c,
                                               const JosephRay& ray, float x,
                                               const JosephGeom& g) {
  JosephU r;
  r.dxy2 = ray.dxy2;
  r.adx = ray.adx;
  // sample at the plane
  r.s_par = joseph_s_par(c, ray, x);
  r.fj = __fadd_rn(__fdiv_rn(joseph_yw(c, ray, r.s_par, g), g.dy), g.cy);
  const float j0 = floorf(r.fj);
  r.wj = __fsub_rn(r.fj, j0);
  r.j0i = (int)j0;
  r.mask = (r.s_par > 0.0f) && (r.s_par <= 1.0f);
  return r;
}

__device__ __forceinline__ JosephU joseph_u(const AngleConsts& c, int iu,
                                            float x, const JosephGeom& g) {
  return joseph_u_at(c, joseph_ray(c, iu, g), x, g);
}

// ---- a shorter route to the same bits, for fp_ray's plane loop.
// a / b is q0 = a * rb corrected once, q0 + rb * (a - b * q0), by fused
// multiply-adds, with rb = 1 / b correctly rounded (__frcp_rn): for a
// normal a and quotient that is the correctly rounded quotient (Markstein's
// theorem), the value __fdiv_rn(a, b) returns.  floorf(f) is f + 1.5 * 2^23
// rounded down, less 1.5 * 2^23, exactly for |f| < 2^22, and the low
// mantissa bits of the sum are its int.  joseph_exact() says whether a
// numerator a and an index f lie in those ranges (a zero or subnormal a
// does not); where one does not, the caller takes the __fdiv_rn route.
__device__ __forceinline__ float joseph_div(float a, float b, float rb) {
  const float q0 = __fmul_rn(a, rb);
  return __fmaf_rn(rb, __fmaf_rn(-b, q0, a), q0);
}

__device__ __forceinline__ float joseph_floor(float f, int* i) {
  const float t = __fadd_rd(f, 12582912.0f);   // 1.5 * 2^23
  *i = __float_as_int(t) - 0x4B400000;
  return __fsub_rn(t, 12582912.0f);
}

__device__ __forceinline__ bool joseph_exact(float a, float f) {
  const float aa = fabsf(a);
  return aa >= 0x1p-100f && aa < 0x1p100f && fabsf(f) < 0x1p22f;
}

// joseph_u_at()'s s_par, j0i, wj and mask by the shorter route (rdy =
// __frcp_rn(dy)); false where it does not apply.
__device__ __forceinline__ bool joseph_u_fast(const AngleConsts& c,
                                              const JosephRay& ray, float x,
                                              float rdy, const JosephGeom& g,
                                              JosephU* r) {
  r->s_par = joseph_s_par(c, ray, x);
  const float a = joseph_yw(c, ray, r->s_par, g);
  r->fj = __fadd_rn(joseph_div(a, g.dy, rdy), g.cy);
  r->wj = __fsub_rn(r->fj, joseph_floor(r->fj, &r->j0i));
  r->mask = (r->s_par > 0.0f) && (r->s_par <= 1.0f);
  return joseph_exact(a, r->fj);
}

// The ray's z direction for pixel row iv: detector v minus source z.
__device__ __forceinline__ float joseph_dz(const AngleConsts& c, int iv,
                                           const JosephGeom& g) {
  const float v = __fadd_rn(__fmul_rn(__fsub_rn((float)iv, g.cv), g.dv), g.offv);
  return __fsub_rn(v, c.sz);
}

// z tap of the ray with u-part parameter s_par and z direction d_z (its
// row's joseph_dz()): a caller that marches planes keeps d_z in a register.
__device__ __forceinline__ JosephV joseph_v_tap_dz(const AngleConsts& c,
                                                   float s_par, float d_z,
                                                   const JosephGeom& g) {
  const float zw = __fsub_rn(__fadd_rn(c.sz, __fmul_rn(s_par, d_z)), g.offz);
  JosephV r;
  r.fk = __fsub_rn(__fadd_rn(__fdiv_rn(zw, g.dz), g.cz), g.z0);
  const float k0 = floorf(r.fk);
  r.wk = __fsub_rn(r.fk, k0);
  r.k0i = (int)k0;
  r.d_z = d_z;
  return r;
}

// joseph_v_tap_dz()'s k0i and wk by the shorter route (rdz =
// __frcp_rn(dz)); false where it does not apply.
__device__ __forceinline__ bool joseph_v_tap_fast(const AngleConsts& c,
                                                  float s_par, float d_z,
                                                  float rdz,
                                                  const JosephGeom& g,
                                                  int* k0i, float* wk) {
  const float zw = __fsub_rn(__fadd_rn(c.sz, __fmul_rn(s_par, d_z)), g.offz);
  const float fk = __fsub_rn(__fadd_rn(joseph_div(zw, g.dz, rdz), g.cz), g.z0);
  *wk = __fsub_rn(fk, joseph_floor(fk, k0i));
  return joseph_exact(zw, fk);
}

// z tap of pixel row iv on the ray whose u-part has parameter s_par.
__device__ __forceinline__ JosephV joseph_v_tap(const AngleConsts& c,
                                                float s_par, int iv,
                                                const JosephGeom& g) {
  return joseph_v_tap_dz(c, s_par, joseph_dz(c, iv, g), g);
}

// seg of the ray from the u-part's dxy2 and adx and the v tap's d_z:
// |d| / max(|d_x|, 1e-9) * dx.
__device__ __forceinline__ float joseph_seg(float dxy2, float adx, float d_z,
                                            const JosephGeom& g) {
  const float norm = __fsqrt_rn(__fadd_rn(dxy2, __fmul_rn(d_z, d_z)));
  return __fmul_rn(__fdiv_rn(norm, adx), g.dx);
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
