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
// Design: one thread per (y, x) column and per run of kPlanes z planes,
// which it owns: it keeps their kPlanes sums in registers and loops over
// the angles in order.  No sum crosses threads and no atomics are used, so
// every launch gives the same bits.  The TPU grid's sequential angle-chunk
// axis becomes the loop inside the thread.  For each angle the in-plane
// terms (fu, mag / dv and the weight) are computed once per thread and
// reused for its kPlanes planes, as the Pallas kernel reuses them over its
// z block (bp_voxel.py:60-76).  The z and angle padding of bp_voxel_pallas
// is a TPU block-shape artefact; this kernel takes any shape, masking the
// ragged z tail itself.  The 32 threads of a warp hold neighbouring x of
// one y row, so their taps fall on neighbouring u of one detector row.
//
// The expressions follow the Pallas kernel's order of operations
// (bp_voxel.py:52-101); cos/sin come back from the e_u = (-sin, cos)
// entries of the angle table.  No texture filtering (its 8-bit weights
// would miss the 2e-4 parity band).
//
// Bound on the card: each voxel-angle pair costs 19 fp32 operations in the
// inner loop (fv: 3, floor and fraction: 2, the tap weights: 5, the four
// taps: 4 multiplies and 3 adds, the depth weight and the accumulation: 2).
// At the FDK shape (512^3 voxels, 512 angles) that is 6.9e10 pairs, 1.3e12
// operations, 19.5 ms at the 67 TFLOP/s fp32 peak, against 0.32 ms to read
// the projections (0.54 GB) and write the volume (0.54 GB) once at
// 3.35 TB/s: it is bound by operations.  The four gathers per pair, served
// from L1/L2, come on top of that bound.
#include <cuda_runtime.h>

namespace {

constexpr int kBlockX = 32;
constexpr int kBlockY = 4;
constexpr int kPlanes = 8;

struct VoxelGeom {
  int n_angles;
  int nz, ny, nx;      // full volume (nz sets the z centre)
  int planes;          // z planes of the output slab
  int nv, nu;          // detector
  float dz, dy, dx;    // voxel pitch
  float offz, offy, offx;
  float du, offu;
  float ovd;           // offv / dv (rounded once, as the Pallas constant)
  float dv;
  float cz, cy, cx;    // (n - 1) / 2 of the volume axes
  float cv, cu;        // (n - 1) / 2 of the detector axes
  float dso, dsd;
  float dso_over_dsd;  // DSO / DSD (rounded once)
  float z_start;       // global index of the slab's first plane
  int weight;          // 0 fdk, 1 pmatched, 2 none
};

__global__ void bp_voxel_kernel(const float* __restrict__ proj,
                                const float* __restrict__ consts,
                                float* __restrict__ out, VoxelGeom g) {
  const int ix = blockIdx.x * kBlockX + threadIdx.x;
  const int iy = blockIdx.y * kBlockY + threadIdx.y;
  const int kz0 = blockIdx.z * kPlanes;
  if (ix >= g.nx || iy >= g.ny) return;

  const float X = ((float)ix - g.cx) * g.dx + g.offx;
  const float Y = ((float)iy - g.cy) * g.dy + g.offy;
  float zs[kPlanes];
  float acc[kPlanes];
#pragma unroll
  for (int k = 0; k < kPlanes; ++k) {
    zs[k] = (((float)(kz0 + k) + g.z_start) - g.cz) * g.dz + g.offz;
    acc[k] = 0.0f;
  }
  const size_t det = (size_t)g.nv * g.nu;

  for (int a = 0; a < g.n_angles; ++a) {
    const float sth = -__ldg(consts + 8 * a + 5);
    const float cth = __ldg(consts + 8 * a + 6);
    const float p = X * cth + Y * sth;
    const float q = -X * sth + Y * cth;
    const float depth = g.dso - p;
    const float mag = g.dsd / depth;
    const float fu = (q * mag - g.offu) / g.du + g.cu;
    const float fv_scale = mag / g.dv;
    float w2d;
    if (g.weight == 0) {
      const float r = g.dso / depth;
      w2d = r * r;
    } else if (g.weight == 1) {
      const float r = g.dsd / depth;
      w2d = r * r * g.dso_over_dsd;
    } else {
      w2d = 1.0f;
    }
    const float i0 = floorf(fu);
    const float wu = fu - i0;
    const int i0i = (int)i0;
    const bool oku0 = i0i >= 0 && i0i < g.nu;
    const bool oku1 = i0i + 1 >= 0 && i0i + 1 < g.nu;
    if (!(oku0 || oku1)) continue;      // every tap of this angle is zero
    const float wu0 = 1.0f - wu;
    const float* pa = proj + (size_t)a * det;

#pragma unroll
    for (int k = 0; k < kPlanes; ++k) {
      const float fv = zs[k] * fv_scale - g.ovd + g.cv;
      const float j0 = floorf(fv);
      const float wv = fv - j0;
      const int j0i = (int)j0;
      const bool okv0 = j0i >= 0 && j0i < g.nv;
      const bool okv1 = j0i + 1 >= 0 && j0i + 1 < g.nv;
      const float wv0 = 1.0f - wv;
      const float* r0 = pa + (size_t)(okv0 ? j0i : 0) * g.nu;
      const float* r1 = pa + (size_t)(okv1 ? j0i + 1 : 0) * g.nu;
      const float t00 = (okv0 && oku0) ? __ldg(r0 + i0i) * (wv0 * wu0) : 0.0f;
      const float t01 = (okv0 && oku1) ? __ldg(r0 + i0i + 1) * (wv0 * wu) : 0.0f;
      const float t10 = (okv1 && oku0) ? __ldg(r1 + i0i) * (wv * wu0) : 0.0f;
      const float t11 = (okv1 && oku1) ? __ldg(r1 + i0i + 1) * (wv * wu) : 0.0f;
      acc[k] += (((t00 + t01) + t10) + t11) * w2d;
    }
  }

  const size_t plane = (size_t)g.ny * g.nx;
  float* o = out + (size_t)kz0 * plane + (size_t)iy * g.nx + ix;
#pragma unroll
  for (int k = 0; k < kPlanes; ++k) {
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

}  // namespace

// proj (n_angles, nv, nu), consts (n_angles, 8) and out (planes, ny, nx),
// all float32, contiguous, on `device`.  Returns cudaGetLastError().
extern "C" int bp_voxel_launch(const void* proj, const void* consts,
                               void* out, int n_angles, int nz, int ny,
                               int nx, int planes, int nv, int nu, float dz,
                               float dy, float dx, float dv, float du,
                               float offz, float offy, float offx, float ovd,
                               float offu, float dso, float dsd,
                               float dso_over_dsd, float z_start, int weight,
                               int device, void* stream) {
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return (int)err;
  VoxelGeom g;
  g.n_angles = n_angles;
  g.nz = nz; g.ny = ny; g.nx = nx; g.planes = planes;
  g.nv = nv; g.nu = nu;
  g.dz = dz; g.dy = dy; g.dx = dx;
  g.offz = offz; g.offy = offy; g.offx = offx;
  g.du = du; g.offu = offu; g.ovd = ovd; g.dv = dv;
  g.cz = (float)((nz - 1) / 2.0);
  g.cy = (float)((ny - 1) / 2.0);
  g.cx = (float)((nx - 1) / 2.0);
  g.cv = (float)((nv - 1) / 2.0);
  g.cu = (float)((nu - 1) / 2.0);
  g.dso = dso; g.dsd = dsd; g.dso_over_dsd = dso_over_dsd;
  g.z_start = z_start;
  g.weight = weight;
  const dim3 block(kBlockX, kBlockY);
  const dim3 grid((nx + kBlockX - 1) / kBlockX, (ny + kBlockY - 1) / kBlockY,
                  (planes + kPlanes - 1) / kPlanes);
  bp_voxel_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const float*)proj, (const float*)consts, (float*)out, g);
  return (int)cudaGetLastError();
}
