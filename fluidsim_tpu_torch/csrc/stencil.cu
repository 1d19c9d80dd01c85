// Pressure-solve stencil kernels of the FLIP frame (K3, K4) and the
// 27-offset shift stencils of the unfused transfers (K6b, K7b) and of the
// row layout (K10a, K10b), for Hopper (sm_90a), with a plain C interface bound
// through ctypes (fluidsim_tpu_torch/ops/stencil_kernels.py,
// ops/transfer_kernels.py, ops/shift.py).
//
// All arrays are dense (n, n, n) f32, z fastest.  A cell is fluid exactly
// where adiag > 0; every operand is read through that mask (q = adiag > 0 ?
// p : 0) and neighbours outside the box read 0.  K3 and K4 also take an
// (nx, n, n) slab (the x extent nx beside n): a rank's pressure solve in
// fluidsim_tpu_torch/parallel/flip_sharded.py, on (nl + 2, n, n) with its
// two ghost rows, which the kernels compute like any row and the caller
// clears; neighbours past the slab's x ends read 0.
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
// K6b fs_shift_reduce replaces fluidsim_tpu/ops/pallas_shift.py:
//   reduce_haloed (_reduce_kernel), the 27-offset shift-reduce of the
//   unfused P2G: acc[g, c] = sum_o d[o, g, c - off_o] over the offsets in
//   order from 0, sources outside the box adding 0 (as the plain version's
//   zero-padded shifts do).  d is (27, 4, n, n, n), acc (4, n, n, n); here
//   d and acc are dense, not the TPU's haloed lane layout, so no lane wrap
//   reaches a wall cell.
//   Bound on the H100: memory.  Each d value is read by exactly one (cell,
//   channel), so 108 reads + 4 writes of 4 B per cell (962 MB at 129^3,
//   ~0.29 ms at 3.35 TB/s).
//   Design: one thread per (cell, channel), consecutive threads on
//   consecutive z, so each of the 27 loads of a warp is one contiguous row
//   segment; the TPU kernel's x-block windows, lane rolls and double
//   buffering are work the cache and the coalesced loads do here.
//
// K10a fs_shift_reduce_rows replaces fluidsim_tpu/ops/pallas_shift.py:150
//   p2g_shift_reduce (_reduce_kernel on the unhaloed lane layout), K6b's
//   function on the row layout: acc[cell, g] = sum_o d[cell - off_o, 4o + g]
//   over the offsets in order from 0, sources outside the box adding 0 as
//   in K6b.  d is (n^3, 108), acc (n, n, n, 4), both dense.
//   Bound on the H100: memory.  Each d value is read by exactly one (cell,
//   channel): one read of the rows (927.4 MB at 129^3) and one write of the
//   result (34.3 MB), 961.7 MB, ~0.2871 ms at 3.35 TB/s.
//   Design: one kernel on the rows, no transpose on either side (the port's
//   first K10a was K10c, K6b and K10d, three launches).  One thread per
//   target cell, consecutive threads on consecutive z: offset o is one
//   16-byte load of d[(cell - off_o) * 108 + 4o ..] (a 432-byte row is 27
//   aligned 16-byte slots), the four channels added at once, and the cell's
//   result is one 16-byte store.  The other half of each 32-byte sector is
//   offset o + 1 of the neighbouring z cell, read by the next thread from
//   L1 or L2, so device memory sees about one read of d.  What limits it
//   is loads in flight: the 27 loads are independent, and with registers
//   for all of them (see the kernel) a thread has them all in flight.
//
// K7b fs_shift_expand replaces fluidsim_tpu/ops/pallas_shift.py:
//   expand_haloed (_expand_kernel_haloed), the 27-offset neighbourhood table
//   of the unfused G2P and the exact transpose of K6b:
//   table[o, g, c] = fm[g, c + off_o], 0 where c + off_o is outside the box.
//   fm is (4, n, n, n), table (27, 4, n, n, n) (K6a's layout); the TPU's
//   haloed lanes, whose rolls wrap y/z edge shifts into the next row, are
//   not needed, so every out-of-box neighbour reads 0.
//   Bound on the H100: memory.  4 reads + 108 writes of 4 B per cell, the
//   writes most of it (962 MB at 129^3, ~0.29 ms at 3.35 TB/s).
//   Design: K6b's thread per (cell, channel), consecutive threads on
//   consecutive z, looping over the 27 offsets: each offset's store of a
//   warp is one contiguous row segment of the table, and the 27 loads of a
//   cell's neighbours come from L1/L2 (the x neighbours are one plane,
//   66 KB, away).
//
// K10b fs_shift_expand_rows replaces fluidsim_tpu/ops/pallas_shift.py:179
//   g2p_table_expand (_expand_kernel, l.111, on the unhaloed lane layout),
//   K7b's function on the row layout and the mirror of K10a:
//   table[cell, 4o + g] = fm[cell + off_o, g], 0 where cell + off_o is
//   outside the box.  fm is (n, n, n, 4), table (n^3, 108), both dense.
//   Bound on the H100: memory.  One read of fm (34.3 MB at 129^3) and one
//   write of the rows (927.4 MB), 961.7 MB, ~0.2871 ms at 3.35 TB/s; the
//   writes are 96% of it, so the design serves them.
//   Design: one kernel on the rows, no transpose (the port's first K10b
//   was K10c, K7b and K10d, three launches moving ~2.8 GB).  A block takes
//   kExpandCells consecutive cells of the flat index and stages in shared
//   memory the 9 line ranges of fm its cells' neighbours come from,
//   [c0 + dx n^2 + dy n - 1, c0 + T + dx n^2 + dy n + 1) for dx, dy in
//   {-1, 0, 1} (9 x 130 x 16 B at T = 128), with a 27-bit mask per cell of
//   the neighbours inside the box.  The block's output is one contiguous,
//   16-byte aligned span of T x 432 B: consecutive threads write
//   consecutive 16-byte slots (slot e is offset e % 27 of cell c0 + e / 27),
//   so every warp store is 512 contiguous bytes; the value comes from
//   shared memory, masked by the cell's bit, so a neighbour across a line,
//   plane or box edge reads 0.  The fm reads of the 9 lines are served
//   mostly by L2 (the x neighbours are one plane, 266 KB, away).
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
// cell c = (x, y, z) of an (nx, n, n) grid whose own adiag is am and masked
// value mid.
__device__ __forceinline__ float laplacian_at(const float* __restrict__ p,
                                              const float* __restrict__ a,
                                              long long c, int x, int y, int z,
                                              int nx, int n, float am,
                                              float mid, float scale) {
  const long long sx = (long long)n * n;
  const float xm = x > 0 ? masked(p, a, c - sx) : 0.f;
  const float xp = x < nx - 1 ? masked(p, a, c + sx) : 0.f;
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
                                       int nx, int n) {
  const long long ncell = (long long)nx * n * n;
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
  out[c] = laplacian_at(p, a, c, x, y, z, nx, n, am, p[c], scale);
}

__global__ void cheb_step_kernel(const float* __restrict__ zv,
                                 const float* __restrict__ a,
                                 const float* __restrict__ r,
                                 const float* __restrict__ d,
                                 float* __restrict__ dn,
                                 float* __restrict__ zn, float scale, float c1,
                                 float c2, int nx, int n) {
  const long long ncell = (long long)nx * n * n;
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
    az = laplacian_at(zv, a, c, x, y, z, nx, n, am, mid, scale);
  }
  const float resid = r[c] - az;
  const float pd = fluid ? resid / am : 0.f;
  const float dnew = c1 * d[c] + c2 * pd;
  dn[c] = dnew;
  zn[c] = mid + dnew;
}

__global__ void shift_reduce_kernel(const float* __restrict__ d,
                                    float* __restrict__ out, int n) {
  const long long ncell = (long long)n * n * n;
  const long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= ncell) return;
  const int g = blockIdx.y;
  const int x = (int)(c / ((long long)n * n));
  const int y = (int)((c / n) % n);
  const int z = (int)(c % n);
  float a = 0.f;
  for (int o = 0; o < 27; ++o) {
    const int bx = x - (o / 9 - 1);
    const int by = y - ((o / 3) % 3 - 1);
    const int bz = z - (o % 3 - 1);
    const bool inb = bx >= 0 && bx < n && by >= 0 && by < n && bz >= 0 && bz < n;
    const float v =
        inb ? d[(4LL * o + g) * ncell + ((long long)bx * n + by) * n + bz] : 0.f;
    a = a + v;
  }
  out[g * ncell + c] = a;
}

// __launch_bounds__(kThreads, 1) leaves the registers for all 27 loads in
// flight at once; capped at 64 or fewer the loads go out a few at a time
// and the kernel is slower on the H100.
__global__ void __launch_bounds__(kThreads, 1)
    shift_reduce_rows_kernel(const float4* __restrict__ d,
                             float4* __restrict__ out, int n) {
  const long long ncell = (long long)n * n * n;
  const long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= ncell) return;
  const int x = (int)(c / ((long long)n * n));
  const int y = (int)((c / n) % n);
  const int z = (int)(c % n);
  float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int o = 0; o < 27; ++o) {
    const int bx = x - (o / 9 - 1);
    const int by = y - ((o / 3) % 3 - 1);
    const int bz = z - (o % 3 - 1);
    const bool inb = bx >= 0 && bx < n && by >= 0 && by < n && bz >= 0 && bz < n;
    const float4 v =
        inb ? __ldg(d + 27LL * (((long long)bx * n + by) * n + bz) + o)
            : make_float4(0.f, 0.f, 0.f, 0.f);
    a.x = a.x + v.x;
    a.y = a.y + v.y;
    a.z = a.z + v.z;
    a.w = a.w + v.w;
  }
  out[c] = a;
}

__global__ void shift_expand_kernel(const float* __restrict__ fm,
                                    float* __restrict__ table, int n) {
  const long long ncell = (long long)n * n * n;
  const long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= ncell) return;
  const int g = blockIdx.y;
  const int x = (int)(c / ((long long)n * n));
  const int y = (int)((c / n) % n);
  const int z = (int)(c % n);
  const float* src = fm + g * ncell;
  for (int o = 0; o < 27; ++o) {
    const int cx = x + (o / 9 - 1);
    const int cy = y + ((o / 3) % 3 - 1);
    const int cz = z + (o % 3 - 1);
    const bool inb = cx >= 0 && cx < n && cy >= 0 && cy < n && cz >= 0 && cz < n;
    table[(4LL * o + g) * ncell + c] =
        inb ? src[((long long)cx * n + cy) * n + cz] : 0.f;
  }
}


// K10b: a block of kExpandCells cells; lines[l] holds fm[c0 + dx n^2 + dy n
// - 1 + k] for l = 3 (dx + 1) + (dy + 1), k < kExpandCells + 2 (0 outside
// the array), valid[j] bit o whether cell c0 + j's neighbour o is in the
// box.  Offset o = 9 (dx + 1) + 3 (dy + 1) + (dz + 1) reads lines[o / 3][j +
// dz + 1].
constexpr int kExpandCells = 128;
constexpr int kExpandPitch = kExpandCells + 3;   // odd in float4: fewer conflicts

__global__ void __launch_bounds__(kThreads)
    shift_expand_rows_kernel(const float4* __restrict__ fm,
                             float4* __restrict__ table, int n) {
  __shared__ float4 lines[9][kExpandPitch];
  __shared__ unsigned valid[kExpandCells];
  const long long ncell = (long long)n * n * n;
  const long long n2 = (long long)n * n;
  const long long c0 = (long long)blockIdx.x * kExpandCells;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int i = threadIdx.x; i < 9 * (kExpandCells + 2); i += blockDim.x) {
    const int l = i / (kExpandCells + 2), k = i - l * (kExpandCells + 2);
    const long long src = c0 + (l / 3 - 1) * n2 + (l % 3 - 1) * n + k - 1;
    lines[l][k] = src >= 0 && src < ncell ? __ldg(fm + src) : zero;
  }
  for (int j = threadIdx.x; j < kExpandCells; j += blockDim.x) {
    const long long c = c0 + j;
    unsigned m = 0;
    if (c < ncell) {
      const int x = (int)(c / n2), y = (int)((c / n) % n), z = (int)(c % n);
      // bit d + 1 of each: whether the neighbour at d in {-1, 0, 1} is inside
      const unsigned mx = (x > 0) | 2u | (x < n - 1) << 2;
      const unsigned my = (y > 0) | 2u | (y < n - 1) << 2;
      const unsigned mz = (z > 0) | 2u | (z < n - 1) << 2;
#pragma unroll
      for (int o = 0; o < 27; ++o)
        m |= (mx >> (o / 9) & my >> (o / 3 % 3) & mz >> (o % 3) & 1u) << o;
    }
    valid[j] = m;
  }
  __syncthreads();
  const long long cells = ncell - c0 < kExpandCells ? ncell - c0 : kExpandCells;
  const int slots = (int)cells * 27;
  float4* out = table + c0 * 27;
  for (int e = threadIdx.x; e < slots; e += blockDim.x) {
    const int j = e / 27, o = e - 27 * j;
    out[e] = valid[j] >> o & 1u ? lines[o / 3][j + o % 3] : zero;
  }
}

}  // namespace

extern "C" int fs_apply_laplacian(const float* p, const float* adiag,
                                  float* out, float scale, int nx, int n,
                                  void* stream) {
  const long long ncell = (long long)nx * n * n;
  if (ncell == 0) return 0;
  const unsigned blocks = (unsigned)((ncell + kThreads - 1) / kThreads);
  apply_laplacian_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      p, adiag, out, scale, nx, n);
  return (int)cudaGetLastError();
}

extern "C" int fs_cheb_step(const float* z, const float* adiag,
                            const float* r, const float* d, float* dn,
                            float* zn, float scale, float c1, float c2,
                            int nx, int n, void* stream) {
  const long long ncell = (long long)nx * n * n;
  if (ncell == 0) return 0;
  const unsigned blocks = (unsigned)((ncell + kThreads - 1) / kThreads);
  cheb_step_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      z, adiag, r, d, dn, zn, scale, c1, c2, nx, n);
  return (int)cudaGetLastError();
}

extern "C" int fs_shift_reduce(const float* d, float* out, int n,
                               void* stream) {
  const long long ncell = (long long)n * n * n;
  const dim3 blocks((unsigned)((ncell + kThreads - 1) / kThreads), 4);
  shift_reduce_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(d, out, n);
  return (int)cudaGetLastError();
}

extern "C" int fs_shift_reduce_rows(const float* d, float* out, int n,
                                    void* stream) {
  const long long ncell = (long long)n * n * n;
  const unsigned blocks = (unsigned)((ncell + kThreads - 1) / kThreads);
  shift_reduce_rows_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(d), reinterpret_cast<float4*>(out), n);
  return (int)cudaGetLastError();
}

extern "C" int fs_shift_expand(const float* fm, float* table, int n,
                               void* stream) {
  const long long ncell = (long long)n * n * n;
  const dim3 blocks((unsigned)((ncell + kThreads - 1) / kThreads), 4);
  shift_expand_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(fm, table,
                                                                     n);
  return (int)cudaGetLastError();
}

extern "C" int fs_shift_expand_rows(const float* fm, float* table, int n,
                                    void* stream) {
  const long long ncell = (long long)n * n * n;
  const long long blocks = (ncell + kExpandCells - 1) / kExpandCells;
  if (blocks == 0) return 0;
  shift_expand_rows_kernel<<<(unsigned)blocks, kThreads, 0,
                             (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(fm), reinterpret_cast<float4*>(table),
      n);
  return (int)cudaGetLastError();
}
