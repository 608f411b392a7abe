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
// Design: one thread per ray; the TPU grid's sequential slab axis becomes
// the loop over planes inside the thread, accumulating in a register, so
// no sum crosses blocks and the result is deterministic.  The wrapper
// hands the volume over in the marching-plane layout (Nx, nz_slab, Ny)
// (as fp_ray.py:176 does), so the 32 threads of a warp, which hold
// neighbouring u, read neighbouring j of one plane row.
//
// Bound on the card: at N=512 with 512 angles the kernel takes
// 512 * 512 * 512 * 512 = 6.9e10 ray-plane samples at about 8 fp32
// operations each for the two blends and the accumulation, about 8 ms at
// the 67 TFLOP/s fp32 peak, against about 0.3 ms to read the volume
// (0.5 GB) and write the projections (0.5 GB) once at 3.35 TB/s: it is
// bound by operations.  The tap arithmetic (two divisions and some
// twenty other operations per sample, kept exact so that the adjoint
// pairs) comes on top of that bound and is what a later, faster version
// has to hide.
#include "joseph_common.cuh"

namespace {

constexpr int kBlockU = 32;
constexpr int kBlockV = 8;

__global__ void fp_ray_kernel(const float* __restrict__ vol_t,
                              const float* __restrict__ consts,
                              const float* __restrict__ xc,
                              float* __restrict__ out, JosephGeom g) {
  const int iu = blockIdx.x * kBlockU + threadIdx.x;
  const int iv = blockIdx.y * kBlockV + threadIdx.y;
  const int a = blockIdx.z;
  if (iu >= g.nu || iv >= g.nv) return;

  const AngleConsts c = load_angle(consts, a);
  const size_t plane_size = (size_t)g.nz_slab * g.ny;
  const float seg = joseph_sample(c, iu, iv, xc[0], g).seg;
  float acc = 0.0f;
  for (int p = 0; p < g.nx; ++p) {
    const JosephSample s = joseph_sample(c, iu, iv, xc[p], g);
    if (!s.mask) continue;
    const bool okj0 = s.j0i >= 0 && s.j0i < g.ny;
    const bool okj1 = s.j0i + 1 >= 0 && s.j0i + 1 < g.ny;
    const bool okk0 = s.k0i >= 0 && s.k0i < g.nz_slab;
    const bool okk1 = s.k0i + 1 >= 0 && s.k0i + 1 < g.nz_slab;
    if (!(okk0 || okk1) || !(okj0 || okj1)) continue;
    const float wy0 = okj0 ? __fsub_rn(1.0f, s.wj) : 0.0f;
    const float wy1 = okj1 ? s.wj : 0.0f;
    const float* plane = vol_t + (size_t)p * plane_size;
    // y blend of the two z rows, then the z blend (fp_ray.py:109-132)
    float col0 = 0.0f, col1 = 0.0f;
    if (okk0) {
      const float* row = plane + (size_t)s.k0i * g.ny;
      col0 = (okj0 ? __ldg(row + s.j0i) : 0.0f) * wy0 +
             (okj1 ? __ldg(row + s.j0i + 1) : 0.0f) * wy1;
    }
    if (okk1) {
      const float* row = plane + (size_t)(s.k0i + 1) * g.ny;
      col1 = (okj0 ? __ldg(row + s.j0i) : 0.0f) * wy0 +
             (okj1 ? __ldg(row + s.j0i + 1) : 0.0f) * wy1;
    }
    const float wz0 = okk0 ? __fsub_rn(1.0f, s.wk) : 0.0f;
    const float wz1 = okk1 ? s.wk : 0.0f;
    acc += col0 * wz0 + col1 * wz1;
  }
  out[((size_t)a * g.nv + iv) * g.nu + iu] = acc * seg;
}

}  // namespace

extern "C" int fp_ray_launch(const void* vol_t, const void* consts,
                             const void* xc, void* out, int n_angles,
                             int nz, int ny, int nx, int nz_slab, int nv,
                             int nu, float dz, float dy, float dx, float dv,
                             float du, float offz, float offy, float offv,
                             float offu, float z0, int device,
                             void* stream) {
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return (int)err;
  const JosephGeom g = make_geom(nz, ny, nx, nz_slab, nv, nu, dz, dy, dx,
                                 dv, du, offz, offy, offv, offu, z0);
  const dim3 block(kBlockU, kBlockV);
  const dim3 grid((nu + kBlockU - 1) / kBlockU, (nv + kBlockV - 1) / kBlockV,
                  n_angles);
  fp_ray_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const float*)vol_t, (const float*)consts, (const float*)xc,
      (float*)out, g);
  return (int)cudaGetLastError();
}
