// Pressure-solve stencil kernels of the FLIP frame (K3, K4), for Hopper
// (sm_90a), with a plain C interface bound through ctypes
// (fluidsim_tpu_torch/ops/stencil_kernels.py).
//
// All arrays are dense (n, n, n) f32, z fastest.  A cell is fluid exactly
// where adiag > 0; every operand is read through that mask (q = adiag > 0 ?
// p : 0) and neighbours outside the box read 0.
//
// K3 fs_apply_laplacian replaces fluidsim_tpu/ops/pallas_stencil.py:
//   apply_laplacian_padded (_kernel) and apply_laplacian_padded_lh
//   (_kernel_lh), the masked 7-point Laplacian
//   out = adiag > 0 ? adiag*q - scale*(x- + x+ + y- + y+ + z- + z+) : 0,
//   summed in that order.
//   Bound on the H100: memory.  2 reads + 1 write of 4 B per cell = 12 B per
//   cell, 26 MB at 129^3 (~8 us at 3.35 TB/s).  The 6 neighbour reads of a
//   cell are served by L1/L2: the y and z neighbours are in the same or an
//   adjacent line, the x neighbours one plane (66 KB) away, well inside L2.
//   Design: one thread per cell, consecutive threads on consecutive z, no
//   shared-memory tiling (the TPU kernel's VMEM windows and lane rolls are
//   layout work that the cache does here).
//
// K4 fs_cheb_step replaces fluidsim_tpu/ops/pallas_stencil.py:
//   cheb_step_padded (_kernel_cheb) and cheb_step_padded_lh
//   (_kernel_cheb_lh), one fused Chebyshev inner step
//   az = (K3 of z); resid = r - az; pd = adiag > 0 ? resid/adiag : 0;
//   d' = c1*d + c2*pd; z' = q + d'.
//   Bound on the H100: memory, 4 reads + 2 writes = 24 B per cell (52 MB at
//   129^3).  Design: the K3 thread layout with r and d read and d', z'
//   written by the same thread, so the step is one pass instead of an apply
//   and four elementwise sweeps.
//
// Built with --fmad=false: with the same operation order as the plain
// PyTorch versions every result is rounded identically (bitwise equal).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float masked(const float* __restrict__ p,
                                        const float* __restrict__ a,
                                        long long i) {
  return a[i] > 0.f ? p[i] : 0.f;
}

// adiag*q - scale*(sum of the 6 masked neighbours), for an interior-or-edge
// cell c = (x, y, z) whose own adiag is am and masked value mid.
__device__ __forceinline__ float laplacian_at(const float* __restrict__ p,
                                              const float* __restrict__ a,
                                              long long c, int x, int y, int z,
                                              int n, float am, float mid,
                                              float scale) {
  const long long sx = (long long)n * n;
  const float xm = x > 0 ? masked(p, a, c - sx) : 0.f;
  const float xp = x < n - 1 ? masked(p, a, c + sx) : 0.f;
  const float ym = y > 0 ? masked(p, a, c - n) : 0.f;
  const float yp = y < n - 1 ? masked(p, a, c + n) : 0.f;
  const float zm = z > 0 ? masked(p, a, c - 1) : 0.f;
  const float zp = z < n - 1 ? masked(p, a, c + 1) : 0.f;
  const float s = ((((xm + xp) + ym) + yp) + zm) + zp;
  return am * mid - scale * s;
}

__global__ void apply_laplacian_kernel(const float* __restrict__ p,
                                       const float* __restrict__ a,
                                       float* __restrict__ out, float scale,
                                       int n) {
  const long long ncell = (long long)n * n * n;
  const long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= ncell) return;
  const float am = a[c];
  if (!(am > 0.f)) {
    out[c] = 0.f;
    return;
  }
  const int x = (int)(c / ((long long)n * n));
  const int y = (int)((c / n) % n);
  const int z = (int)(c % n);
  out[c] = laplacian_at(p, a, c, x, y, z, n, am, p[c], scale);
}

__global__ void cheb_step_kernel(const float* __restrict__ zv,
                                 const float* __restrict__ a,
                                 const float* __restrict__ r,
                                 const float* __restrict__ d,
                                 float* __restrict__ dn,
                                 float* __restrict__ zn, float scale, float c1,
                                 float c2, int n) {
  const long long ncell = (long long)n * n * n;
  const long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= ncell) return;
  const float am = a[c];
  const bool fluid = am > 0.f;
  const float mid = fluid ? zv[c] : 0.f;
  float az = 0.f;
  if (fluid) {
    const int x = (int)(c / ((long long)n * n));
    const int y = (int)((c / n) % n);
    const int z = (int)(c % n);
    az = laplacian_at(zv, a, c, x, y, z, n, am, mid, scale);
  }
  const float resid = r[c] - az;
  const float pd = fluid ? resid / am : 0.f;
  const float dnew = c1 * d[c] + c2 * pd;
  dn[c] = dnew;
  zn[c] = mid + dnew;
}

}  // namespace

extern "C" int fs_apply_laplacian(const float* p, const float* adiag,
                                  float* out, float scale, int n,
                                  void* stream) {
  const long long ncell = (long long)n * n * n;
  const unsigned blocks = (unsigned)((ncell + kThreads - 1) / kThreads);
  apply_laplacian_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      p, adiag, out, scale, n);
  return (int)cudaGetLastError();
}

extern "C" int fs_cheb_step(const float* z, const float* adiag,
                            const float* r, const float* d, float* dn,
                            float* zn, float scale, float c1, float c2, int n,
                            void* stream) {
  const long long ncell = (long long)n * n * n;
  const unsigned blocks = (unsigned)((ncell + kThreads - 1) / kThreads);
  cheb_step_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      z, adiag, r, d, dn, zn, scale, c1, c2, n);
  return (int)cudaGetLastError();
}
