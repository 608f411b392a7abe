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
// where a backward term is absent at index 0 of its axis.  These are the
// semantics of jnp.diff(..., append=v[-1:]) and of the Pallas kernel's
// replicated global ends.  Any shape is taken, a dimension of size 1 or 2
// included: the z block, the overlapping slab stack and the Nz % z_block
// restriction of tv_grad_pallas are TPU block-shape artefacts.
//
// What bounds it: each voxel's value must be read once and its gradient
// written once, so the card's memory rate; the PR 13 kernel (one thread a
// voxel, four magnitudes and 13 loads each) was bound by its instruction
// stream instead.  The design spends as few instructions a voxel as it can:
//
// - One smoothed magnitude per voxel.  A block of kTX x kWarps threads owns
//   a tile of kTX columns by kTY = kWarps * kRowsPer rows and walks a chunk
//   of kZC planes in z (the grid strides over chunks, so any nz fits the
//   grid).  A thread owns kRowsPer consecutive rows of one column.  Per
//   plane it forms, for each of its voxels, r = 1/m and q = (dz, dy, dx) * r
//   once.  Its own rows pass q_y down in registers; q_x reaches the thread
//   at x+1 by a warp shuffle; q_z stays in a register for the next plane
//   (a chunk's prologue forms it for plane z0-1).  Only the rows at a
//   warp's edge (q_y), the ring row y0-1 (computed by warp 0) and the ring
//   column x0-1 (warp 1) go through shared memory, double-buffered by
//   plane so one barrier a plane is enough.  (kTY+1)(kTX+1)-1 magnitudes
//   are formed per plane of kTY*kTX voxels.
// - The plane window (rows y0-1 .. y0+kTY, columns x0-4 .. x0+kTX+3) comes
//   into shared memory by TMA, one box a plane issued by one thread,
//   kStages - 2 planes ahead of the plane being read, in a ring of kStages
//   buffers with an mbarrier each; the box's parts off the volume read as
//   zeros.  (Its start column must be a multiple of 16 bytes: a box at
//   x0-2 faults with an illegal instruction on the H100.)  A thread's own
//   value at the next plane is kept in a register.  Where TMA cannot address the volume (nx % 4 != 0, or a base that is not
//   16-byte aligned) the window comes by 4-byte cp.async copies instead.
// - Each m and each q are the same roundings whichever thread forms them,
//   so sharing them changes no bit.  The window's zeros off the volume are
//   never used: the differences at the last index of an axis are 0 by
//   predicate, and an absent backward term is skipped.  No atomics and no
//   reductions, so every launch gives the same bits.
//
// Arithmetic: the sums and products are written with __fadd_rn /
// __fsub_rn / __fmul_rn in the plain version's order, so nvcc can neither
// contract them into FMAs nor reorder them; g is summed as
// ((-(dz+dy+dx)*r + q_z(z-1)) + q_y(y-1)) + q_x(x-1).  sqrtf stays IEEE (no
// --use_fast_math), and __frcp_rn(m) is the correctly rounded 1/m, the
// bits of __fdiv_rn(1, m).
//
// Bound on the card: each voxel reads 4 bytes once and writes 4 bytes
// once, 2 * 512^3 * 4 B = 1.07 GB at N=512, 0.32 ms at 3.35 TB/s.  The
// body does 21 fp32 operations at a voxel (3 differences, |d|^2 5, eps^2 1,
// sqrt 1, reciprocal 1, the three q products 3, the forward sum 2,
// negation 1, its product 1 and the three backward adds 3) and 12 at each
// ring or prologue point (differences, |d|^2, eps^2, sqrt, reciprocal and
// one product): 22.125 a voxel at 32 x 32 x 32 (a ring of 1/16 and a
// prologue of 1/32 of the voxels), 3.0e9 operations at N=512, 0.04 ms at
// 67 TFLOP/s.  Bound by bytes.
#include <climits>
#include <cstdint>

#include <cuda.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTX = 32;        // tile columns: a warp's lanes
constexpr int kWarps = 4;      // warps of a block
constexpr int kRowsPer = 8;    // consecutive rows a thread owns
constexpr int kTY = kWarps * kRowsPer;  // tile rows
constexpr int kZC = 32;        // planes of one chunk
// launch bounds: blocks an SM at least (80 registers a thread; the TMA
// kernel takes 64 and runs 8 blocks an SM)
constexpr int kMinBlocks = 6;
constexpr int kThreads = kTX * kWarps;
// window ring: planes p and p+1 read, kStages - 2 more in flight
constexpr int kStages = 4;
constexpr int kRows = kTY + 2;  // window rows y0-1 .. y0+kTY
// window columns x0-kX0 .. x0+kTX+kX0-1: a TMA box starts and ends on 16
// bytes
constexpr int kX0 = 4;  // window column of x0
constexpr int kW = kTX + 2 * kX0;
constexpr int kBoxBytes = kRows * kW * 4;
constexpr int kBuf = (kBoxBytes + 127) / 128 * 32;  // floats, 128-byte steps
static_assert(kTX == 32, "a tile row is one warp");
static_assert(kTY <= 32 && kWarps >= 2, "warp 1 computes the ring column");
static_assert(kRows <= 256 && kW <= 256, "a TMA box is at most 256 a side");

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// sqrt(((dz*dz + dy*dy) + dx*dx) + eps2), the plain version's order.
__device__ __forceinline__ float magnitude(float dz, float dy, float dx,
                                           float eps2) {
  const float s = __fadd_rn(__fadd_rn(__fmul_rn(dz, dz), __fmul_rn(dy, dy)),
                            __fmul_rn(dx, dx));
  return sqrtf(__fadd_rn(s, eps2));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

// Wait until the phase of parity `parity` of barrier `bar` has completed.
// A wait that lasts 2^34 cycles (about 10 s) can only be a fault of the
// kernel: it traps, so that the launch fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  const long long t0 = clock64();
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > (1ll << 34)) __trap();
  }
}

// TMA: the box at (c0, c1, c2) of `map` into shared memory at dst,
// completing `bar`'s transaction count.  Coordinates off the tensor read
// as zeros.
__device__ __forceinline__ void tma_load_3d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// 4 bytes from src to shared memory, or zeros where bytes == 0
__device__ __forceinline__ void copy4(uint32_t dst, const float* src,
                                      int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// every cp.async group of this thread but the newest N complete
template <int N>
__device__ __forceinline__ void wait_groups() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 1/m and a q component at one ring point of the window: the ring row's q_y
// (take_y) or the ring column's q_x
__device__ __forceinline__ float ring_q(const float* w0, const float* w1,
                                        int o, bool zf, bool yf, bool xf,
                                        bool take_y, float eps2) {
  const float c = w0[o];
  const float dz = zf ? __fsub_rn(w1[o], c) : 0.0f;
  const float dy = yf ? __fsub_rn(w0[o + kW], c) : 0.0f;
  const float dx = xf ? __fsub_rn(w0[o + 1], c) : 0.0f;
  const float r = __frcp_rn(magnitude(dz, dy, dx, eps2));
  return __fmul_rn(take_y ? dy : dx, r);
}

// kTma: the window by TMA through `map`; else by cp.async from `vol`.
template <bool kTma>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    tv_grad_kernel(const __grid_constant__ CUtensorMap map,
                   const float* __restrict__ vol, float* __restrict__ out,
                   int nz, int ny, int nx, float eps2) {
  __shared__ __align__(128) float win[kStages][kBuf];
  // q of the plane's parity: sqy[.][0] the ring row y0-1, sqy[.][w + 1]
  // warp w's last row; sqx[.][j] the ring column at row y0+j
  __shared__ float sqy[2][kWarps][kTX];
  __shared__ float sqx[2][kTY];
  __shared__ __align__(8) uint64_t full[kStages];

  const int lane = threadIdx.x, warp = threadIdx.y;
  const int tid = warp * kTX + lane;
  const int x0 = blockIdx.x * kTX, y0 = blockIdx.y * kTY;
  const int x = x0 + lane;
  const int ya = y0 + warp * kRowsPer;  // the thread's first row
  const size_t plane = (size_t)ny * nx;
  const uint32_t win_s = smem_addr(&win[0][0]);
  const uint32_t full_s = smem_addr(&full[0]);
  const bool issuer = tid == 0;
  if (kTma && issuer) {
    for (int s = 0; s < kStages; ++s) mbar_init(full_s + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  uint32_t phase = 0;  // bit s: the parity buffer s completes next

  auto stage = [&](int p, int s) {
    if (kTma) {
      if (issuer) {
        mbar_expect_tx(full_s + 8 * s, kBoxBytes);
        tma_load_3d(win_s + s * kBuf * 4, &map, full_s + 8 * s, x0 - kX0,
                    y0 - 1, p);
      }
    } else {
      // window columns x0-1 .. x0+kTX, 4 bytes each
      const float* src = vol + (size_t)p * plane;
      for (int i = tid; i < kRows * (kTX + 2); i += kThreads) {
        const int r = i / (kTX + 2), col = kX0 - 1 + i % (kTX + 2);
        const int yg = y0 - 1 + r, xg = x0 - kX0 + col;
        const bool ok = yg >= 0 && yg < ny && xg >= 0 && xg < nx;
        copy4(win_s + (s * kBuf + r * kW + col) * 4,
              src + (ok ? yg * nx + xg : 0), ok ? 4 : 0);
      }
    }
  };
  auto land = [&](int s) {  // TMA: buffer s's plane is readable
    mbar_wait(full_s + 8 * s, (phase >> s) & 1u);
    phase ^= 1u << s;
  };

  const bool xf = x + 1 < nx;
  const int own0 = (1 + warp * kRowsPer) * kW + kX0 + lane;  // (ya, x)
  const int n_chunks = nz / kZC + (nz % kZC != 0);
  for (int chunk = blockIdx.z; chunk < n_chunks; chunk += gridDim.z) {
    const int z0 = chunk * kZC;
    const int z1 = min(z0 + kZC, nz);    // planes written: z0 .. z1-1
    const int zs = z0 > 0 ? z0 - 1 : 0;  // first plane staged (prologue)
    const int zl = min(z1, nz - 1);      // last plane staged
#pragma unroll
    for (int k = 0; k < kStages - 1; ++k) {
      if (zs + k <= zl) stage(zs + k, k);
      if (!kTma) commit();
    }
    if (kTma) land(0);
    int s = 0;  // ring buffer of plane p
    float c[kRowsPer], qz[kRowsPer];
    for (int p = zs; p < z1; ++p) {
      const int s1 = s + 1 == kStages ? 0 : s + 1;
      // into the buffer of plane p-1, last read before the previous barrier
      if (p + kStages - 1 <= zl)
        stage(p + kStages - 1, s == 0 ? kStages - 1 : s - 1);
      if (kTma) {
        if (p + 1 <= zl) land(s1);  // plane p+1 has landed
      } else {
        commit();
        wait_groups<kStages - 2>();  // planes p and p+1 have landed
        __syncthreads();
      }
      const float* w0 = win[s];
      const float* w1 = win[s1];
      const bool zf = p + 1 < nz;
      const bool body = p >= z0;  // block-uniform: not the prologue
      const int h = p & 1;
      if (p == zs) {
#pragma unroll
        for (int k = 0; k < kRowsPer; ++k) c[k] = w0[own0 + k * kW];
      }
      float g[kRowsPer], qxn[kRowsPer], qy = 0.0f;
#pragma unroll
      for (int k = 0; k < kRowsPer; ++k) {
        const int o = own0 + k * kW;
        const float fz = w1[o];
        const float fy = k + 1 < kRowsPer ? c[k + 1] : w0[o + kW];
        const float dz = zf ? __fsub_rn(fz, c[k]) : 0.0f;
        const float dy = ya + k + 1 < ny ? __fsub_rn(fy, c[k]) : 0.0f;
        const float dx = xf ? __fsub_rn(w0[o + 1], c[k]) : 0.0f;
        const float r = __frcp_rn(magnitude(dz, dy, dx, eps2));
        if (body) {
          float gk = __fmul_rn(-__fadd_rn(__fadd_rn(dz, dy), dx), r);
          if (p > 0) gk = __fadd_rn(gk, qz[k]);
          if (k > 0) gk = __fadd_rn(gk, qy);  // row ya+k-1 is this thread's
          g[k] = gk;
          qxn[k] = __shfl_up_sync(0xffffffffu, __fmul_rn(dx, r), 1);
        }
        qy = __fmul_rn(dy, r);
        qz[k] = __fmul_rn(dz, r);
        c[k] = fz;  // the voxel's value at the next plane
      }
      if (body) {
        if (warp + 1 < kWarps) sqy[h][warp + 1][lane] = qy;
        if (warp == 0) {
          sqy[h][0][lane] =
              ring_q(w0, w1, kX0 + lane, zf, true, xf, true, eps2);
        } else if (warp == 1 && lane < kTY) {
          sqx[h][lane] = ring_q(w0, w1, (1 + lane) * kW + kX0 - 1, zf,
                                y0 + lane + 1 < ny, true, false, eps2);
        }
      }
      // q of the plane shared; every window read of the plane done
      __syncthreads();
      if (body) {
        float* o = out + (size_t)p * plane;
#pragma unroll
        for (int k = 0; k < kRowsPer; ++k) {
          float gk = g[k];
          if (k == 0 && ya > 0) gk = __fadd_rn(gk, sqy[h][warp][lane]);
          if (x > 0)
            gk = __fadd_rn(gk, lane > 0 ? qxn[k]
                                        : sqx[h][warp * kRowsPer + k]);
          if (x < nx && ya + k < ny) o[(unsigned)((ya + k) * nx + x)] = gk;
        }
      }
      s = s1;
    }
  }
}

// cuTensorMapEncodeTiled from the driver, found through the runtime (no
// link against libcuda).
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

cudaError_t encode_fn(EncodeTiled* fn) {
  static EncodeTiled cached = nullptr;
  if (cached == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || p == nullptr)
      return cudaErrorSymbolNotFound;
    cached = reinterpret_cast<EncodeTiled>(p);
  }
  *fn = cached;
  return cudaSuccess;
}

// (nz, ny, nx) float32, read in boxes of one plane's window; the parts of
// a box off the volume read as zeros
cudaError_t make_map(CUtensorMap* map, const void* vol, int nz, int ny,
                     int nx) {
  EncodeTiled encode;
  const cudaError_t err = encode_fn(&encode);
  if (err != cudaSuccess) return err;
  const cuuint64_t dims[3] = {(cuuint64_t)nx, (cuuint64_t)ny, (cuuint64_t)nz};
  const cuuint64_t strides[2] = {(cuuint64_t)nx * 4,
                                 (cuuint64_t)ny * nx * 4};
  const cuuint32_t box[3] = {kW, kRows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(vol), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
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
// eps * eps rounded to float.  A plane of 2^31 or more voxels, or more
// than 65535 tile rows, is refused (cudaErrorInvalidValue).  Returns
// cudaGetLastError().
extern "C" int tv_grad_launch(const void* vol, void* out, int nz, int ny,
                              int nx, float eps2, int device, void* stream) {
  if ((long long)ny * nx > INT_MAX || (ny + kTY - 1) / kTY > 65535)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return (int)err;
  // TMA needs 16-byte aligned rows and base
  const bool tma = nx % 4 == 0 && ((uintptr_t)vol & 15) == 0;
  CUtensorMap map = {};
  if (tma) {
    err = make_map(&map, vol, nz, ny, nx);
    if (err != cudaSuccess) return (int)err;
  }
  const int n_chunks = nz / kZC + (nz % kZC != 0);
  const dim3 block(kTX, kWarps);
  const dim3 grid((nx + kTX - 1) / kTX, (ny + kTY - 1) / kTY,
                  n_chunks < 65535 ? n_chunks : 65535);
  auto kernel = tma ? tv_grad_kernel<true> : tv_grad_kernel<false>;
  kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      map, (const float*)vol, (float*)out, nz, ny, nx, eps2);
  return (int)cudaGetLastError();
}
