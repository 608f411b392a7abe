// Gradient of the smoothed isotropic TV objective (Hopper, sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/tv_grad.py::_tv_grad_kernel
// (wrapper tv_grad_pallas).  For a volume f of shape (nz, ny, nx) it writes
// the closed-form gradient of sum_i m_i, m = sqrt(dz^2 + dy^2 + dx^2 + eps^2),
// with edge-replicate forward differences (dz_i = f_{i+z} - f_i, and 0 at
// the last index of the axis; likewise dy, dx):
//
//   g_i = -(dz_i + dy_i + dx_i) / m_i
//         + dz_{i-z} / m_{i-z} + dy_{i-y} / m_{i-y} + dx_{i-x} / m_{i-x}
//
// where a backward term is 0 at index 0 of its axis.  These are the
// semantics of jnp.diff(..., append=v[-1:]) and of the Pallas kernel's
// replicated global ends.
//
// Design: one thread per voxel.  It reads the 13 values it needs (itself,
// its three forward neighbours, and for each backward neighbour that
// neighbour's own forward neighbours, e.g. f(z-1, y+1, x) for m_{i-z}),
// computes m at itself and at its three backward neighbours, and writes
// g_i.  Neighbouring threads read neighbouring x, so the reads of a warp
// coalesce and the re-reads of neighbouring voxels hit L1/L2.  The z block,
// the overlapping slab stack and the Nz % z_block restriction of
// tv_grad_pallas are TPU block-shape artefacts: this kernel takes any
// shape, a dimension of size 1 or 2 included, and walks z with a grid
// stride so any nz fits the grid.  No atomics and no reductions, so every
// launch gives the same bits.
//
// Arithmetic: the sums and products are written with __fadd_rn /
// __fsub_rn / __fmul_rn in the plain version's order, so nvcc can neither
// contract them into FMAs nor reorder them; sqrtf and the division stay
// IEEE (no --use_fast_math).
//
// Bound on the card: each voxel reads 4 bytes once and writes 4 bytes
// once, 2 * 512^3 * 4 B = 1.07 GB at N=512, 0.32 ms at 3.35 TB/s.  The
// inner body does 54 fp32 operations per voxel (counted in tv_grad_voxel
// below: at the voxel 3 differences, |d|^2 5 and eps^2 1, sqrt 1, the
// reciprocal 1, the forward sum 2, negation 1 and the product 1 = 15; each
// of the three backward terms 3 + 5 + 1 + 1 + 1, its product 1 and the add
// into g 1 = 13), 7.2e9 operations, 0.11 ms at 67 TFLOP/s: bound by bytes.
#include <cuda_runtime.h>

namespace {

constexpr int kBlockX = 32;
constexpr int kBlockY = 8;

// sqrt(((dz*dz + dy*dy) + dx*dx) + eps2), the plain version's order.
__device__ __forceinline__ float magnitude(float dz, float dy, float dx,
                                           float eps2) {
  const float s = __fadd_rn(__fadd_rn(__fmul_rn(dz, dz), __fmul_rn(dy, dy)),
                            __fmul_rn(dx, dx));
  return sqrtf(__fadd_rn(s, eps2));
}

__device__ __forceinline__ float tv_grad_voxel(const float* __restrict__ f,
                                               int z, int y, int x, int nz,
                                               int ny, int nx, float eps2) {
  const size_t sy = (size_t)nx;
  const size_t sz = (size_t)ny * nx;
  const size_t i = (size_t)z * sz + (size_t)y * sy + x;
  const bool zf = z + 1 < nz, yf = y + 1 < ny, xf = x + 1 < nx;
  const float c = __ldg(f + i);

  // at the voxel itself: g = -(dz + dy + dx) / m
  const float dz = zf ? __fsub_rn(__ldg(f + i + sz), c) : 0.0f;
  const float dy = yf ? __fsub_rn(__ldg(f + i + sy), c) : 0.0f;
  const float dx = xf ? __fsub_rn(__ldg(f + i + 1), c) : 0.0f;
  const float inv_m = __fdiv_rn(1.0f, magnitude(dz, dy, dx, eps2));
  float g = __fmul_rn(-__fadd_rn(__fadd_rn(dz, dy), dx), inv_m);

  // + dz_{i-z} / m_{i-z}: the neighbour below in z, whose forward
  // differences in y and x reach f(z-1, y+1, x) and f(z-1, y, x+1)
  if (z > 0) {
    const size_t j = i - sz;
    const float b = __ldg(f + j);
    const float bz = __fsub_rn(c, b);
    const float by = yf ? __fsub_rn(__ldg(f + j + sy), b) : 0.0f;
    const float bx = xf ? __fsub_rn(__ldg(f + j + 1), b) : 0.0f;
    const float inv = __fdiv_rn(1.0f, magnitude(bz, by, bx, eps2));
    g = __fadd_rn(g, __fmul_rn(bz, inv));
  }
  // + dy_{i-y} / m_{i-y}: reaches f(z+1, y-1, x) and f(z, y-1, x+1)
  if (y > 0) {
    const size_t j = i - sy;
    const float b = __ldg(f + j);
    const float bz = zf ? __fsub_rn(__ldg(f + j + sz), b) : 0.0f;
    const float by = __fsub_rn(c, b);
    const float bx = xf ? __fsub_rn(__ldg(f + j + 1), b) : 0.0f;
    const float inv = __fdiv_rn(1.0f, magnitude(bz, by, bx, eps2));
    g = __fadd_rn(g, __fmul_rn(by, inv));
  }
  // + dx_{i-x} / m_{i-x}: reaches f(z+1, y, x-1) and f(z, y+1, x-1)
  if (x > 0) {
    const size_t j = i - 1;
    const float b = __ldg(f + j);
    const float bz = zf ? __fsub_rn(__ldg(f + j + sz), b) : 0.0f;
    const float by = yf ? __fsub_rn(__ldg(f + j + sy), b) : 0.0f;
    const float bx = __fsub_rn(c, b);
    const float inv = __fdiv_rn(1.0f, magnitude(bz, by, bx, eps2));
    g = __fadd_rn(g, __fmul_rn(bx, inv));
  }
  return g;
}

__global__ void tv_grad_kernel(const float* __restrict__ f,
                               float* __restrict__ out, int nz, int ny,
                               int nx, float eps2) {
  const int x = blockIdx.x * kBlockX + threadIdx.x;
  const int y = blockIdx.y * kBlockY + threadIdx.y;
  if (x >= nx || y >= ny) return;
  const size_t plane = (size_t)ny * nx;
  for (int z = blockIdx.z; z < nz; z += gridDim.z) {
    out[(size_t)z * plane + (size_t)y * nx + x] =
        tv_grad_voxel(f, z, y, x, nz, ny, nx, eps2);
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

// vol and out (nz, ny, nx), float32, contiguous, on `device`; eps2 is
// eps * eps rounded to float.  Returns cudaGetLastError().
extern "C" int tv_grad_launch(const void* vol, void* out, int nz, int ny,
                              int nx, float eps2, int device, void* stream) {
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return (int)err;
  const dim3 block(kBlockX, kBlockY);
  const dim3 grid((nx + kBlockX - 1) / kBlockX, (ny + kBlockY - 1) / kBlockY,
                  nz < 65535 ? nz : 65535);
  tv_grad_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const float*)vol, (float*)out, nz, ny, nx, eps2);
  return (int)cudaGetLastError();
}
