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
// Design: one thread owns one output voxel (k, j, plane x) of the slab
// and loops over the angles in order.  For one angle and plane, fj
// depends on u alone and is monotone in u, so the u whose taps can reach
// row j (fj in [j - 1, j + 1)) form one interval; the thread inverts the
// plane-to-detector map to find it, widens it by 2 pixels on each side to
// absorb rounding, and tests each candidate with joseph_sample(), the
// function fp_ray uses.  For each u that passes, fk is affine in v, and
// the v interval is found and tested the same way.  A candidate
// contributes g * seg * wz * wy with the identical fp32 weights, so the
// pair is exact to summation order, and a ray that fp_ray reads from
// voxel (k, j) is always among the candidates: the widening is ~1e3 times
// the rounding error of the inversion.
//
// Output layout (Nx, nz_slab, Ny), the marching-plane layout of fp_ray's
// input: the 32 threads of a warp hold neighbouring j and write one
// contiguous row.  The wrapper transposes it back to (nz_slab, Ny, Nx).
//
// Bound on the card: the same 6.9e10 (voxel, angle) pairs as fp_ray's
// ray-plane samples at N=512 with 512 angles, and the same ~8 fp32
// operations each for the weights and the accumulation: about 8 ms at the
// 67 TFLOP/s fp32 peak against about 0.3 ms of memory traffic, so it is
// bound by operations.  The candidate search evaluates the tap arithmetic
// for several u and v per pair, which this simple version pays in full.
#include "joseph_common.cuh"

namespace {

constexpr int kBlockJ = 32;
constexpr int kBlockK = 8;
constexpr int kWiden = 2;

// Detector index (fractional) of the pixel whose ray crosses plane x at
// world y = yt, for angle c.  From y = sy + (x - sx) * d_y / d_x with
// d = (C + D u, A + B u): u = (A - r C) / (r D - B), r = (yt - sy) / (x - sx).
__device__ __forceinline__ float u_index_at(const AngleConsts& c, float x,
                                            float yt, const JosephGeom& g) {
  const float r = (yt - c.sy) / (x - c.sx);
  const float u = ((c.dcy - c.sy) - r * (c.dcx - c.sx)) / (r * c.eux - c.euy);
  return (u - g.offu) / g.du + g.cu;
}

// Clamp a fractional candidate interval, widened, to [0, n).  A
// non-finite bound falls back to the whole axis.
__device__ __forceinline__ void candidate_range(float f0, float f1, int n,
                                                int* lo, int* hi) {
  if (!isfinite(f0) || !isfinite(f1)) {
    *lo = 0;
    *hi = n - 1;
    return;
  }
  // clamp before the conversion so that no bound overflows an int
  const float a = fminf(fmaxf(fminf(f0, f1), -4.0f), (float)n + 4.0f);
  const float b = fminf(fmaxf(fmaxf(f0, f1), -4.0f), (float)n + 4.0f);
  *lo = max(0, (int)floorf(a) - kWiden);
  *hi = min(n - 1, (int)ceilf(b) + kWiden);
}

__global__ void bp_matched_kernel(const float* __restrict__ proj,
                                  const float* __restrict__ consts,
                                  const float* __restrict__ xc,
                                  float* __restrict__ out_t, int n_angles,
                                  JosephGeom g) {
  const int j = blockIdx.x * kBlockJ + threadIdx.x;
  const int k = blockIdx.y * kBlockK + threadIdx.y;
  const int p = blockIdx.z;
  if (j >= g.ny || k >= g.nz_slab) return;

  const float x = xc[p];
  // world y of fj = j - 1 and fj = j + 1; world z of fk = k - 1, k + 1
  const float y_lo = ((float)(j - 1) - g.cy) * g.dy + g.offy;
  const float y_hi = ((float)(j + 1) - g.cy) * g.dy + g.offy;
  const float z_lo = ((float)(k - 1) + g.z0 - g.cz) * g.dz + g.offz;
  const float z_hi = ((float)(k + 1) + g.z0 - g.cz) * g.dz + g.offz;

  float acc = 0.0f;
  for (int a = 0; a < n_angles; ++a) {
    const AngleConsts c = load_angle(consts, a);
    int u0, u1;
    candidate_range(u_index_at(c, x, y_lo, g), u_index_at(c, x, y_hi, g),
                    g.nu, &u0, &u1);
    const float* proj_a = proj + (size_t)a * g.nv * g.nu;
    for (int iu = u0; iu <= u1; ++iu) {
      const JosephSample su = joseph_sample(c, iu, 0, x, g);
      if (!su.mask) continue;
      float wy;
      if (su.j0i == j) {
        wy = __fsub_rn(1.0f, su.wj);
      } else if (su.j0i + 1 == j) {
        wy = su.wj;
      } else {
        continue;
      }
      // fk is affine in the detector v for this u:
      // v = sz + (z - sz) / s_par, then to a fractional pixel index
      const float v_lo = c.sz + (z_lo - c.sz) / su.s_par;
      const float v_hi = c.sz + (z_hi - c.sz) / su.s_par;
      int v0, v1;
      candidate_range((v_lo - g.offv) / g.dv + g.cv,
                      (v_hi - g.offv) / g.dv + g.cv, g.nv, &v0, &v1);
      for (int iv = v0; iv <= v1; ++iv) {
        const JosephSample s = joseph_sample(c, iu, iv, x, g);
        float wz;
        if (s.k0i == k) {
          wz = __fsub_rn(1.0f, s.wk);
        } else if (s.k0i + 1 == k) {
          wz = s.wk;
        } else {
          continue;
        }
        acc += ((__ldg(proj_a + (size_t)iv * g.nu + iu) * s.seg) * wz) * wy;
      }
    }
  }
  out_t[((size_t)p * g.nz_slab + k) * g.ny + j] = acc;
}

}  // namespace

extern "C" int bp_matched_launch(const void* proj, const void* consts,
                                 const void* xc, void* out_t, int n_angles,
                                 int nz, int ny, int nx, int nz_slab, int nv,
                                 int nu, float dz, float dy, float dx,
                                 float dv, float du, float offz, float offy,
                                 float offv, float offu, float z0,
                                 int device, void* stream) {
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return (int)err;
  const JosephGeom g = make_geom(nz, ny, nx, nz_slab, nv, nu, dz, dy, dx,
                                 dv, du, offz, offy, offv, offu, z0);
  const dim3 block(kBlockJ, kBlockK);
  const dim3 grid((ny + kBlockJ - 1) / kBlockJ,
                  (nz_slab + kBlockK - 1) / kBlockK, nx);
  bp_matched_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const float*)proj, (const float*)consts, (const float*)xc,
      (float*)out_t, n_angles, g);
  return (int)cudaGetLastError();
}
