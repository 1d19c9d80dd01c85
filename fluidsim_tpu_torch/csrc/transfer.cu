// Particle <-> grid transfer kernels of the FLIP frame (K1, K2), for Hopper
// (sm_90a), with a plain C interface bound through ctypes
// (fluidsim_tpu_torch/ops/transfer_kernels.py).
//
// Both kernels take particles sorted by the flat id (x*n + y)*n + z of their
// clipped base cell round(pos) + B, and the transposed stencil weights
// w27t (27, P) f32, zero for particles whose base cell is outside the box.
// Offset o is (o/9 - 1, (o/3)%3 - 1, o%3 - 1).
//
// K1 fs_p2g_scatter replaces fluidsim_tpu/ops/pallas_transfer.py:
//   scatter_wv_fused (_scatter_wv_fused_kernel), expand='wv'.
//   out[g, c] = sum_o sum_{p : base(p) = c - off_o} w27t[o, p] * [1, v_p][g]
//   for g = weight, mx, my, mz; contributions to cells outside the box are
//   dropped.  Output (4, n, n, n) f32.
//   Bound on the H100: memory.  It reads w27t once (27*4 = 108 B/particle),
//   the velocities 27 times (mostly from L1/L2: the 27 neighbour cells of a
//   thread block's cells share their particle ranges) and writes 16 B/cell;
//   at 129^3 / 2M particles that is ~0.25 GB of compulsory traffic.
//   Design: a deterministic PULL with no atomics.  One thread per target
//   cell walks its 27 source cells in offset order and each source cell's
//   particle range [cell_start[b], cell_start[b+1]) in sorted order, so the
//   sum order is fixed and frames are bit-reproducible run to run.  Threads
//   of a block are consecutive z-cells, whose source ranges are adjacent in
//   the sorted arrays, so the loads of a warp fall on neighbouring lines.
//
// K2 fs_g2p_gather replaces fluidsim_tpu/ops/pallas_transfer.py:
//   gather_wv_fused (_gather_wv_fused_kernel), nout=8 (rows 0-3 live).
//   out[c, p] = sum_o w27t[o, p] * fm[c, base(p) + off_o] for c = 0..3,
//   where fm holds 3 within-wall-masked field channels and the mask itself;
//   neighbours outside the box read 0.  Output (4, P) f32.
//   Bound on the H100: memory.  Per particle it reads 108 B of weights,
//   4 B of id and 27 x 16 B of grid values, writes 16 B; the grid reads of
//   the ~25 particles of one cell hit the same addresses (L1 broadcast).
//   Design: one thread per particle; consecutive threads are consecutive
//   sorted particles, so the weight reads and output writes are coalesced.
//
// Both are built with --fmad=false so every product and sum is rounded as
// in the plain PyTorch versions they are checked against.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void p2g_scatter_kernel(const float* __restrict__ w27t,
                                   const float* __restrict__ vel,
                                   const int* __restrict__ cell_start,
                                   float* __restrict__ out, int n,
                                   long long np) {
  const long long ncell = (long long)n * n * n;
  const long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= ncell) return;
  const int x = (int)(c / ((long long)n * n));
  const int y = (int)((c / n) % n);
  const int z = (int)(c % n);
  float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
  for (int o = 0; o < 27; ++o) {
    const int bx = x - (o / 9 - 1);
    const int by = y - ((o / 3) % 3 - 1);
    const int bz = z - (o % 3 - 1);
    if (bx < 0 || bx >= n || by < 0 || by >= n || bz < 0 || bz >= n) continue;
    const long long b = ((long long)bx * n + by) * n + bz;
    const int s = cell_start[b];
    const int e = cell_start[b + 1];
    const float* wo = w27t + (long long)o * np;
    for (int p = s; p < e; ++p) {
      const float w = wo[p];
      a0 += w;
      a1 += w * vel[3LL * p];
      a2 += w * vel[3LL * p + 1];
      a3 += w * vel[3LL * p + 2];
    }
  }
  out[c] = a0;
  out[ncell + c] = a1;
  out[2 * ncell + c] = a2;
  out[3 * ncell + c] = a3;
}

__global__ void g2p_gather_kernel(const float* __restrict__ fm,
                                  const float* __restrict__ w27t,
                                  const int* __restrict__ flat,
                                  float* __restrict__ out, int n,
                                  long long np) {
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= np) return;
  const long long ncell = (long long)n * n * n;
  const int f = flat[p];
  const int x = f / (n * n);
  const int y = (f / n) % n;
  const int z = f % n;
  float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
  for (int o = 0; o < 27; ++o) {
    const int cx = x + (o / 9 - 1);
    const int cy = y + ((o / 3) % 3 - 1);
    const int cz = z + (o % 3 - 1);
    if (cx < 0 || cx >= n || cy < 0 || cy >= n || cz < 0 || cz >= n) continue;
    const long long c = ((long long)cx * n + cy) * n + cz;
    const float w = w27t[(long long)o * np + p];
    s0 += w * fm[c];
    s1 += w * fm[ncell + c];
    s2 += w * fm[2 * ncell + c];
    s3 += w * fm[3 * ncell + c];
  }
  out[p] = s0;
  out[np + p] = s1;
  out[2 * np + p] = s2;
  out[3 * np + p] = s3;
}

}  // namespace

extern "C" int fs_p2g_scatter(const float* w27t, const float* vel,
                              const int* cell_start, float* out, int n,
                              long long np, void* stream) {
  const long long ncell = (long long)n * n * n;
  const unsigned blocks = (unsigned)((ncell + kThreads - 1) / kThreads);
  p2g_scatter_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      w27t, vel, cell_start, out, n, np);
  return (int)cudaGetLastError();
}

extern "C" int fs_g2p_gather(const float* fm, const float* w27t,
                             const int* flat, float* out, int n, long long np,
                             void* stream) {
  if (np == 0) return 0;
  const unsigned blocks = (unsigned)((np + kThreads - 1) / kThreads);
  g2p_gather_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      fm, w27t, flat, out, n, np);
  return (int)cudaGetLastError();
}
