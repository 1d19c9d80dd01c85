// Particle <-> grid transfer kernels of the FLIP, PIC, APIC and MPM frames
// (K1, K2 and their APIC and MPM modes) and of the unfused transfers (K6a,
// K7a), for Hopper (sm_90a), with a plain
// C interface bound through ctypes (fluidsim_tpu_torch/ops/transfer_kernels.py).
//
// All take particles sorted by the flat id (x*n + y)*n + z of their
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
// K1 aff fs_p2g_scatter_affine replaces the same TPU kernel with the APIC
//   affine block live (pack_cols(aff=...), _wv_mats_cm):
//   the velocity of offset o is veff_p + C_p off_o, i.e.
//   veff_i + C[i,0]*off_0 + C[i,1]*off_1 + C[i,2]*off_2 summed in that order,
//   with veff = v + C (base - pos) formed by the caller (ops/apic.py).
//   Bound on the H100: memory.  Compulsory traffic adds C (36 B/particle)
//   to K1's; at 129^3 / 2M particles ~353 MB.  Design: K1's pull with a
//   template flag, so the FLIP instantiation is the same code as before.
//
// K2 moments fs_g2p_moments replaces the same TPU gather with nout=24
//   (_contract_mat): the 22 live rows, from wf = w27t[o,p] * fm[:, base+off_o]
//     row 0 den = sum wf3, rows 1-3 sum wf_c, rows 4-6 sum wf3 off_k,
//     rows 7-15 sum wf_c off_k (row 7+3c+k), rows 16-21 sum wf3 off_k off_l
//     over the pairs (00, 01, 02, 11, 12, 22).
//   Output (22, P) f32.  Bound on the H100: memory; per particle 108 B of
//   weights, 4 B of id, 88 B of output, the grid values from cache; ~432 MB
//   at 129^3 / 2M particles.  Design: K2's thread per particle with 22
//   register accumulators; the offsets are compile-time constants in
//   {-1, 0, 1}, so every product by an offset is exact.
//
// K1 fg fs_p2g_scatter_force replaces the same TPU scatter with
//   expand='fg' (_fg_expand_cm): the MPM grid force
//   out[c, cell] = sum_o sum_{p : base(p) = cell - off_o}
//                  (M[p,c,0]*gW[p,o,0] + M[p,c,1]*gW[p,o,1] + M[p,c,2]*gW[p,o,2])
//   for c = 0..2, the k-sum in that order, with M = -V sigma (P, 9)
//   row-major and gradW (81, P) with row 3o+k; contributions to cells
//   outside the box are dropped.  Output (3, n, n, n) f32.
//   Bound on the H100: memory.  Compulsory traffic is gradW (324 B), M
//   (36 B) per particle, cell_start and 12 B/cell out; at 127^3 / 473,798
//   particles ~203 MB.  What holds a pull over the source cells back is
//   load imbalance, not bytes: the snow cone piles ~11,000 particles into
//   one cell, and a thread per target cell would walk them one by one for
//   each of that cell's 27 neighbours.
//   Design: a deterministic chunked pull, no float atomics, so the MPM
//   frame stays bit-reproducible.  A plan built once per frame
//   (transfer_kernels.force_plan) cuts every occupied cell's particle
//   range into chunks of at most FORCE_CHUNK particles, listed in (cell,
//   chunk) order: chunk_first[k] is chunk k's first particle, chunk_cell[k]
//   its cell, chunk_start[b] cell b's first chunk (chunk_start[n^3] the
//   number of chunks).
//   Stage A (force_chunk_sums_kernel): one warp per chunk stages kTile
//   particles at a time in shared memory (the 81 gradW rows read coalesced
//   along p, M once) and lane o < 27 sums the chunk's 3 values of offset o
//   in particle order: sums[k, 3o + c] = sum_p (M[p,c,0] gW[p,o,0] +
//   M[p,c,1] gW[p,o,1]) + M[p,c,2] gW[p,o,2].  A crowded cell becomes many
//   chunks on many warps.  force_combine_kernel then adds the chunks of
//   each cell of several chunks in chunk order into its first chunk's row:
//   one 81-float record per occupied cell.
//   Stage B (force_pull_kernel): one thread per target cell adds, for each
//   offset o in order 0..26, the record of source cell cell - off_o
//   (sources outside the box or without particles dropped).  Its reads do
//   not depend on one another, and a target with an empty neighbourhood
//   stops after 18 reads of chunk_start.
//   transfer_kernels.p2g_scatter_force_chunked is this order written in
//   PyTorch; the kernel equals it bit for bit.
//
// K2 gw fs_g2p_gather_gw replaces the same TPU gather with contract='gw',
//   nout=16: out[3c+k, p] = sum_o gW[p,o,k] * fm[c, base(p) + off_o] for
//   c, k = 0..2 (the TPU kernel's live rows 4k+c; its rows 4k+3 contract
//   the mask channel and every caller drops them), neighbours outside the
//   box reading 0.  fm is (3, n, n, n).  Output (9, P) f32.
//   Bound on the H100: memory; per particle 324 B of gradW, 4 B of id and
//   36 B of output, the grid values from cache; ~197 MB at 127^3 / 473,798
//   particles.  Design: K2's thread per sorted particle with 9 register
//   accumulators over the 27 neighbours.
//
// K6a fs_p2g_scatter_base replaces fluidsim_tpu/ops/pallas_transfer.py:
//   scatter_wv_cm (_scatter_wv_kernel, rows of pack_wv_rows, _wv_mats), the
//   base-cell scatter of the unfused P2G:
//   out[o, c, cell] = sum_{p : flat(p) = cell} w27t[o, p] * [1, v_p][c]
//   with v_p + C_p off_o (C row-major, summed as in K1 aff) when aff is given.
//   Output (27, 4, n, n, n) f32, every cell written (zeros where empty).
//   The particles need only be grouped by 512-cell window of their flat id
//   (the bucket sort's order); wstart[b] is the first particle of window b.
//   Bound on the H100: memory.  Writing the 108 channels of every cell is
//   most of the compulsory traffic (927 MB at 129^3; with w27t, v and the
//   ids ~1.17 GB, ~0.35 ms at 3.35 TB/s).
//   Design: deterministic, no float atomics.  One thread block per window,
//   one thread per cell of the window.  The block counts its span's
//   particles per cell (integer shared-memory atomics), scans the counts,
//   and each thread then walks the span in order, through shared-memory
//   tiles of ids, listing its cell's particles in a scratch array: a
//   stable counting sort, so each cell's particles keep the order of the
//   array (the full stable sort's order).  Each thread then sums its cell's
//   particles, offset by offset, in that order; a warp's 32 cells are
//   consecutive, so every channel's writes are coalesced.  The TPU kernel's
//   one-hot matmuls, split3 passes and window-local f32 ids are not needed.
//
// K7a fs_g2p_gather_table and fs_g2p_moments_table replace
//   fluidsim_tpu/ops/pallas_transfer.py: gather_wv_cm (_gather_wv_kernel,
//   contracted by _contract_mat(nout)), the gather of the unfused G2P: the
//   4 rows of K2 (nout=8) or the 22 of K2 moments (nout=24), each reading
//   table[o, :, base(p)] of K7b's (27, 4, n, n, n) neighbourhood table in
//   place of fm at base(p) + off_o.  Output (4, P) or (22, P) f32.
//   Bound on the H100: memory.  Per particle 108 B of weights, 4 B of id and
//   16 or 88 B of output, plus 432 B of table per distinct base cell: the
//   sorted particles of one cell read the same 108 values (L1 broadcast).
//   Design: K2's and K2 moments' kernels, templated on where a particle's
//   grid values come from (NeighbourFields or TableColumn), so the
//   accumulators are one code and the offsets are summed in K2's order:
//   the materialised G2P equals the fused one bit for bit.
//
// All are built with --fmad=false so every product and sum is rounded as
// in the plain PyTorch versions they are checked against.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <bool kAffine>
__global__ void p2g_scatter_kernel(const float* __restrict__ w27t,
                                   const float* __restrict__ vel,
                                   const float* __restrict__ aff,
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
    const int ox = o / 9 - 1, oy = (o / 3) % 3 - 1, oz = o % 3 - 1;
    const int bx = x - ox;
    const int by = y - oy;
    const int bz = z - oz;
    if (bx < 0 || bx >= n || by < 0 || by >= n || bz < 0 || bz >= n) continue;
    const long long b = ((long long)bx * n + by) * n + bz;
    const int s = cell_start[b];
    const int e = cell_start[b + 1];
    const float* wo = w27t + (long long)o * np;
    const float fx = (float)ox, fy = (float)oy, fz = (float)oz;
    for (int p = s; p < e; ++p) {
      const float w = wo[p];
      float v0 = vel[3LL * p];
      float v1 = vel[3LL * p + 1];
      float v2 = vel[3LL * p + 2];
      if (kAffine) {
        const float* cp = aff + 9LL * p;
        v0 = v0 + cp[0] * fx + cp[1] * fy + cp[2] * fz;
        v1 = v1 + cp[3] * fx + cp[4] * fy + cp[5] * fz;
        v2 = v2 + cp[6] * fx + cp[7] * fy + cp[8] * fz;
      }
      a0 += w;
      a1 += w * v0;
      a2 += w * v1;
      a3 += w * v2;
    }
  }
  out[c] = a0;
  out[ncell + c] = a1;
  out[2 * ncell + c] = a2;
  out[3 * ncell + c] = a3;
}

constexpr int kMoments = 22;

// The 4 grid values that offset o of a particle with base cell f = (x, y, z)
// reads.  K2 reads the (4, n, n, n) fields at f + off_o and skips a
// neighbour outside the box; K7a reads column f of the (27, 4, n, n, n)
// table, which holds 0 for such a neighbour.  Adding w * 0 leaves a sum that
// started at +0 unchanged to the bit, so K2 and K7a agree bit for bit.
struct NeighbourFields {
  const float* fm;
  __device__ __forceinline__ bool load(int o, int f, int x, int y, int z,
                                       int n, long long ncell,
                                       float v[4]) const {
    const int cx = x + (o / 9 - 1);
    const int cy = y + ((o / 3) % 3 - 1);
    const int cz = z + (o % 3 - 1);
    if (cx < 0 || cx >= n || cy < 0 || cy >= n || cz < 0 || cz >= n)
      return false;
    const long long c = ((long long)cx * n + cy) * n + cz;
    v[0] = __ldg(fm + c);
    v[1] = __ldg(fm + ncell + c);
    v[2] = __ldg(fm + 2 * ncell + c);
    v[3] = __ldg(fm + 3 * ncell + c);
    return true;
  }
};

struct TableColumn {
  const float* table;
  __device__ __forceinline__ bool load(int o, int f, int, int, int, int,
                                       long long ncell, float v[4]) const {
    const float* t = table + 4LL * o * ncell + f;
    v[0] = __ldg(t);
    v[1] = __ldg(t + ncell);
    v[2] = __ldg(t + 2 * ncell);
    v[3] = __ldg(t + 3 * ncell);
    return true;
  }
};

template <class Src>
__global__ void g2p_moments_kernel(Src src, const float* __restrict__ w27t,
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
  const int kPairK[6] = {0, 0, 0, 1, 1, 2};
  const int kPairL[6] = {0, 1, 2, 1, 2, 2};
  float acc[kMoments];
#pragma unroll
  for (int r = 0; r < kMoments; ++r) acc[r] = 0.f;
#pragma unroll
  for (int o = 0; o < 27; ++o) {
    const int off[3] = {o / 9 - 1, (o / 3) % 3 - 1, o % 3 - 1};
    float v[4];
    if (!src.load(o, f, x, y, z, n, ncell, v)) continue;
    const float w = w27t[(long long)o * np + p];
    const float wf[4] = {w * v[0], w * v[1], w * v[2], w * v[3]};
    acc[0] += wf[3];
    acc[1] += wf[0];
    acc[2] += wf[1];
    acc[3] += wf[2];
#pragma unroll
    for (int k = 0; k < 3; ++k) acc[4 + k] += wf[3] * (float)off[k];
#pragma unroll
    for (int ch = 0; ch < 3; ++ch)
#pragma unroll
      for (int k = 0; k < 3; ++k)
        acc[7 + 3 * ch + k] += wf[ch] * (float)off[k];
#pragma unroll
    for (int i = 0; i < 6; ++i)
      acc[16 + i] += wf[3] * (float)(off[kPairK[i]] * off[kPairL[i]]);
  }
#pragma unroll
  for (int r = 0; r < kMoments; ++r) out[r * np + p] = acc[r];
}

template <class Src>
__global__ void g2p_gather_kernel(Src src, const float* __restrict__ w27t,
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
    float v[4];
    if (!src.load(o, f, x, y, z, n, ncell, v)) continue;
    const float w = w27t[(long long)o * np + p];
    s0 += w * v[0];
    s1 += w * v[1];
    s2 += w * v[2];
    s3 += w * v[3];
  }
  out[p] = s0;
  out[np + p] = s1;
  out[2 * np + p] = s2;
  out[3 * np + p] = s3;
}

constexpr int kTile = 32;           // particles a warp stages at a time
constexpr int kPitch = kTile + 1;   // the 27 lanes' gradW rows in distinct banks
constexpr int kChunkWarpsPerSm = 16;

// Stage A: sums[k, 3o + c] over chunk k's particles, in particle order.
__global__ void __launch_bounds__(32, kChunkWarpsPerSm)
    force_chunk_sums_kernel(const float* __restrict__ gradw,
                            const float* __restrict__ m9,
                            const int* __restrict__ chunk_first,
                            int nch, float* __restrict__ sums,
                            long long np) {
  __shared__ float g[81 * kPitch];
  __shared__ float4 m[3 * kTile];   // row c of M as (M[c,0], M[c,1], M[c,2], 0)
  const int lane = threadIdx.x;
  for (int k = blockIdx.x; k < nch; k += gridDim.x) {
    const int p0 = chunk_first[k], p1 = chunk_first[k + 1];
    float a0 = 0.f, a1 = 0.f, a2 = 0.f;
    for (int t0 = p0; t0 < p1; t0 += kTile) {
      const int len = min(kTile, p1 - t0);
      __syncwarp();
      if (lane < len) {
        const long long p = t0 + lane;
#pragma unroll 27
        for (int r = 0; r < 81; ++r) g[r * kPitch + lane] = gradw[r * np + p];
        const float* mp = m9 + 9 * p;
        m[3 * lane] = make_float4(mp[0], mp[1], mp[2], 0.f);
        m[3 * lane + 1] = make_float4(mp[3], mp[4], mp[5], 0.f);
        m[3 * lane + 2] = make_float4(mp[6], mp[7], mp[8], 0.f);
      }
      __syncwarp();
      if (lane < 27) {
        const float* g0 = g + 3 * lane * kPitch;
        const float* g1 = g0 + kPitch;
        const float* g2 = g1 + kPitch;
        for (int j = 0; j < len; ++j) {
          const float gx = g0[j], gy = g1[j], gz = g2[j];
          const float4 r0 = m[3 * j], r1 = m[3 * j + 1], r2 = m[3 * j + 2];
          a0 += r0.x * gx + r0.y * gy + r0.z * gz;
          a1 += r1.x * gx + r1.y * gy + r1.z * gz;
          a2 += r2.x * gx + r2.y * gy + r2.z * gz;
        }
      }
    }
    if (lane < 27) {
      float* s = sums + 81LL * k + 3 * lane;
      s[0] = a0;
      s[1] = a1;
      s[2] = a2;
    }
  }
}

// Stage A's second kernel: the record of a cell of several chunks, the sum
// of its chunks' sums in chunk order, into its first chunk's row.
__global__ void force_combine_kernel(float* __restrict__ sums,
                                     const int* __restrict__ chunk_cell,
                                     const int* __restrict__ chunk_start,
                                     int nch) {
  const int lane = threadIdx.x;
  for (int k = blockIdx.x; k < nch; k += gridDim.x) {
    const int b = chunk_cell[k];
    const int k1 = chunk_start[b + 1];
    if (chunk_start[b] != k || k1 - k < 2 || lane >= 27) continue;
    float t0 = 0.f, t1 = 0.f, t2 = 0.f;
#pragma unroll 8
    for (int q = k; q < k1; ++q) {
      const float* s = sums + 81LL * q + 3 * lane;
      t0 += s[0];
      t1 += s[1];
      t2 += s[2];
    }
    float* s = sums + 81LL * k + 3 * lane;
    s[0] = t0;
    s[1] = t1;
    s[2] = t2;
  }
}

// Stage B: one thread per target cell adds the records of its source cells
// in offset order; a target whose 27 sources hold no chunk writes zeros
// after 18 reads of chunk_start.  n^3 < 2^31 (checked by the caller).
__global__ void force_pull_kernel(const float* __restrict__ rec,
                                  const int* __restrict__ chunk_start,
                                  float* __restrict__ out, int n) {
  const int ncell = n * n * n;
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= ncell) return;
  const int x = c / (n * n);
  const int y = (c - x * n * n) / n;
  const int z = c - (x * n + y) * n;
  const int zlo = z > 0 ? z - 1 : 0;
  const int zend = z + 1 < n ? z + 2 : n;   // one past the last source z
  bool any = false;
#pragma unroll
  for (int r = 0; r < 9; ++r) {
    const int bx = x - (r / 3 - 1), by = y - (r % 3 - 1);
    if (bx >= 0 && bx < n && by >= 0 && by < n) {
      const int row = (bx * n + by) * n;
      any |= __ldg(chunk_start + row + zend) > __ldg(chunk_start + row + zlo);
    }
  }
  float a0 = 0.f, a1 = 0.f, a2 = 0.f;
  if (any) {
#pragma unroll
    for (int o = 0; o < 27; ++o) {
      const int bx = x - (o / 9 - 1);
      const int by = y - ((o / 3) % 3 - 1);
      const int bz = z - (o % 3 - 1);
      if (bx < 0 || bx >= n || by < 0 || by >= n || bz < 0 || bz >= n) continue;
      const int b = (bx * n + by) * n + bz;
      const int k0 = __ldg(chunk_start + b);
      if (__ldg(chunk_start + b + 1) > k0) {
        const float* s = rec + 81LL * k0 + 3 * o;
        a0 += __ldg(s);
        a1 += __ldg(s + 1);
        a2 += __ldg(s + 2);
      }
    }
  }
  out[c] = a0;
  out[ncell + c] = a1;
  out[2 * ncell + c] = a2;
}

__global__ void g2p_gather_gw_kernel(const float* __restrict__ fm,
                                     const float* __restrict__ gradw,
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
  float acc[9];
#pragma unroll
  for (int r = 0; r < 9; ++r) acc[r] = 0.f;
#pragma unroll
  for (int o = 0; o < 27; ++o) {
    const int cx = x + (o / 9 - 1);
    const int cy = y + ((o / 3) % 3 - 1);
    const int cz = z + (o % 3 - 1);
    if (cx < 0 || cx >= n || cy < 0 || cy >= n || cz < 0 || cz >= n) continue;
    const long long c = ((long long)cx * n + cy) * n + cz;
    const float fv[3] = {fm[c], fm[ncell + c], fm[2 * ncell + c]};
    const float gv[3] = {gradw[3LL * o * np + p], gradw[(3LL * o + 1) * np + p],
                         gradw[(3LL * o + 2) * np + p]};
#pragma unroll
    for (int ch = 0; ch < 3; ++ch)
#pragma unroll
      for (int k = 0; k < 3; ++k) acc[3 * ch + k] += fv[ch] * gv[k];
  }
#pragma unroll
  for (int r = 0; r < 9; ++r) out[r * np + p] = acc[r];
}

constexpr int kWin = 512;      // cells per window (the bucket sort's grouping)
constexpr int kIdTile = 2048;  // span ids staged in shared memory at a time

template <bool kAffine>
__global__ void __launch_bounds__(kWin)
    p2g_scatter_base_kernel(const float* __restrict__ w27t,
                            const float* __restrict__ vel,
                            const float* __restrict__ aff,
                            const int* __restrict__ flat,
                            const int* __restrict__ wstart,
                            int* __restrict__ order, float* __restrict__ out,
                            int n, long long np) {
  __shared__ int count[kWin];
  __shared__ int warp_total[kWin / 32];
  __shared__ int ids[kIdTile];
  const long long ncell = (long long)n * n * n;
  const int j = threadIdx.x;
  const long long cell0 = (long long)blockIdx.x * kWin;
  const int s = wstart[blockIdx.x];
  const int e = wstart[blockIdx.x + 1];

  // 1. particles per cell of the window (ids outside it are skipped)
  count[j] = 0;
  __syncthreads();
  for (int p = s + j; p < e; p += kWin) {
    const long long id = flat[p] - cell0;
    if (id >= 0 && id < kWin) atomicAdd(&count[id], 1);
  }
  __syncthreads();

  // 2. exclusive scan of the counts: the first slot of each cell
  const int mine = count[j];
  const int lane = j & 31, warp = j >> 5;
  int incl = mine;
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += v;
  }
  if (lane == 31) warp_total[warp] = incl;
  __syncthreads();
  int before = 0;
  for (int k = 0; k < warp; ++k) before += warp_total[k];
  const int first = s + before + incl - mine;

  // 3. stable counting sort: each thread lists its cell's particles in
  // span order
  int last = first;
  for (int t0 = s; t0 < e; t0 += kIdTile) {
    const int m = min(kIdTile, e - t0);
    __syncthreads();
    for (int k = j; k < m; k += kWin) ids[k] = (int)(flat[t0 + k] - cell0);
    __syncthreads();
    if (mine > 0)
      for (int k = 0; k < m; ++k)
        if (ids[k] == j) order[last++] = t0 + k;
  }

  // 4. the 108 sums of this thread's cell, offset by offset
  const long long cell = cell0 + j;
  if (cell >= ncell) return;
  for (int o = 0; o < 27; ++o) {
    const float fx = (float)(o / 9 - 1);
    const float fy = (float)((o / 3) % 3 - 1);
    const float fz = (float)(o % 3 - 1);
    const float* wo = w27t + (long long)o * np;
    float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
    for (int q = first; q < last; ++q) {
      const long long p = order[q];
      const float w = wo[p];
      float v0 = vel[3 * p];
      float v1 = vel[3 * p + 1];
      float v2 = vel[3 * p + 2];
      if (kAffine) {
        const float* cp = aff + 9 * p;
        v0 = v0 + cp[0] * fx + cp[1] * fy + cp[2] * fz;
        v1 = v1 + cp[3] * fx + cp[4] * fy + cp[5] * fz;
        v2 = v2 + cp[6] * fx + cp[7] * fy + cp[8] * fz;
      }
      a0 += w;
      a1 += w * v0;
      a2 += w * v1;
      a3 += w * v2;
    }
    float* oc = out + 4LL * o * ncell + cell;
    oc[0] = a0;
    oc[ncell] = a1;
    oc[2 * ncell] = a2;
    oc[3 * ncell] = a3;
  }
}

}  // namespace

extern "C" int fs_p2g_scatter(const float* w27t, const float* vel,
                              const int* cell_start, float* out, int n,
                              long long np, void* stream) {
  const long long ncell = (long long)n * n * n;
  const unsigned blocks = (unsigned)((ncell + kThreads - 1) / kThreads);
  p2g_scatter_kernel<false><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      w27t, vel, nullptr, cell_start, out, n, np);
  return (int)cudaGetLastError();
}

extern "C" int fs_p2g_scatter_affine(const float* w27t, const float* veff,
                                     const float* aff, const int* cell_start,
                                     float* out, int n, long long np,
                                     void* stream) {
  const long long ncell = (long long)n * n * n;
  const unsigned blocks = (unsigned)((ncell + kThreads - 1) / kThreads);
  p2g_scatter_kernel<true><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      w27t, veff, aff, cell_start, out, n, np);
  return (int)cudaGetLastError();
}

extern "C" int fs_g2p_gather(const float* fm, const float* w27t,
                             const int* flat, float* out, int n, long long np,
                             void* stream) {
  if (np == 0) return 0;
  const unsigned blocks = (unsigned)((np + kThreads - 1) / kThreads);
  g2p_gather_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      NeighbourFields{fm}, w27t, flat, out, n, np);
  return (int)cudaGetLastError();
}

extern "C" int fs_g2p_moments(const float* fm, const float* w27t,
                              const int* flat, float* out, int n,
                              long long np, void* stream) {
  if (np == 0) return 0;
  const unsigned blocks = (unsigned)((np + kThreads - 1) / kThreads);
  g2p_moments_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      NeighbourFields{fm}, w27t, flat, out, n, np);
  return (int)cudaGetLastError();
}

extern "C" int fs_g2p_gather_table(const float* table, const float* w27t,
                                   const int* flat, float* out, int n,
                                   long long np, void* stream) {
  if (np == 0) return 0;
  const unsigned blocks = (unsigned)((np + kThreads - 1) / kThreads);
  g2p_gather_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      TableColumn{table}, w27t, flat, out, n, np);
  return (int)cudaGetLastError();
}

extern "C" int fs_g2p_moments_table(const float* table, const float* w27t,
                                    const int* flat, float* out, int n,
                                    long long np, void* stream) {
  if (np == 0) return 0;
  const unsigned blocks = (unsigned)((np + kThreads - 1) / kThreads);
  g2p_moments_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      TableColumn{table}, w27t, flat, out, n, np);
  return (int)cudaGetLastError();
}

// sums: (nchunk, 81) scratch, nchunk the plan's chunk count chunk_start[n^3]
// (force_plan reads it once per frame); the warps of stage A stride over
// the chunks.
extern "C" int fs_p2g_scatter_force(const float* gradw, const float* m9,
                                    const int* chunk_first,
                                    const int* chunk_cell,
                                    const int* chunk_start, float* sums,
                                    float* out, int n, long long np,
                                    int nchunk, void* stream) {
  const long long ncell = (long long)n * n * n;
  const cudaStream_t st = (cudaStream_t)stream;
  if (nchunk > 0) {
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    const int warps = 2 * kChunkWarpsPerSm * sms;
    const int grid = nchunk < warps ? nchunk : warps;
    force_chunk_sums_kernel<<<grid, 32, 0, st>>>(gradw, m9, chunk_first,
                                                 nchunk, sums, np);
    force_combine_kernel<<<grid, 32, 0, st>>>(sums, chunk_cell, chunk_start,
                                              nchunk);
    const int rc = (int)cudaGetLastError();
    if (rc != 0) return rc;
  }
  const unsigned blocks = (unsigned)((ncell + kThreads - 1) / kThreads);
  force_pull_kernel<<<blocks, kThreads, 0, st>>>(sums, chunk_start, out, n);
  return (int)cudaGetLastError();
}

extern "C" int fs_g2p_gather_gw(const float* fm, const float* gradw,
                                const int* flat, float* out, int n,
                                long long np, void* stream) {
  if (np == 0) return 0;
  const unsigned blocks = (unsigned)((np + kThreads - 1) / kThreads);
  g2p_gather_gw_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      fm, gradw, flat, out, n, np);
  return (int)cudaGetLastError();
}

extern "C" int fs_p2g_scatter_base(const float* w27t, const float* vel,
                                   const float* aff, const int* flat,
                                   const int* wstart, int* order, float* out,
                                   int n, long long np, void* stream) {
  const long long ncell = (long long)n * n * n;
  const unsigned blocks = (unsigned)((ncell + kWin - 1) / kWin);
  if (aff == nullptr)
    p2g_scatter_base_kernel<false><<<blocks, kWin, 0, (cudaStream_t)stream>>>(
        w27t, vel, nullptr, flat, wstart, order, out, n, np);
  else
    p2g_scatter_base_kernel<true><<<blocks, kWin, 0, (cudaStream_t)stream>>>(
        w27t, vel, aff, flat, wstart, order, out, n, np);
  return (int)cudaGetLastError();
}
