// Particle <-> grid transfer kernels of the FLIP, PIC, APIC and MPM frames
// (K1, K2 and their APIC and MPM modes: K1 aff, K1 fg, K2 moments, K2 gw)
// and of the unfused transfers (K6a, K7a), for Hopper (sm_90a), with a plain
// C interface bound through ctypes (fluidsim_tpu_torch/ops/transfer_kernels.py).
//
// All take particles sorted by the flat id (x*n + y)*n + z of their
// clipped base cell round(pos) + B, and the transposed stencil weights
// w27t (27, P) f32, zero for particles whose base cell is outside the box.
// Offset o is (o/9 - 1, (o/3)%3 - 1, o%3 - 1).
//
// K1 fs_p2g_scatter, fs_p2g_scatter_affine and fs_p2g_scatter_force replace
//   fluidsim_tpu/ops/pallas_transfer.py:1064 scatter_wv_fused
//   (_scatter_wv_fused_kernel) in its three modes, the 27-offset scatter
//     out[c, cell] = sum_o sum_{p : base(p) = cell - off_o} u(p, o)[c]
//   of nc channels per offset, contributions to cells outside the box
//   dropped.  Output (nc, n, n, n) f32.  The modes differ in u:
//     wv  (expand='wv', FLIP, PIC and the MPM mass and momentum), nc = 4:
//         u(p, o) = w27t[o, p] * [1, v_p];
//     aff (the APIC affine block, pack_cols(aff=...), _wv_mats_cm), nc = 4:
//         u(p, o) = w27t[o, p] * [1, veff_p + C_p off_o], the velocity
//         veff_i + C[i,0]*off_0 + C[i,1]*off_1 + C[i,2]*off_2 summed in that
//         order, with veff = v + C (base - pos) formed by ops/apic.py and C
//         (P, 9) row-major;
//     fg  (expand='fg', _fg_expand_cm, the MPM grid force), nc = 3:
//         u(p, o)[c] = M[p,c,0]*gW[p,o,0] + M[p,c,1]*gW[p,o,1]
//                      + M[p,c,2]*gW[p,o,2], the k-sum in that order, with
//         M = -V sigma (P, 9) row-major and gradW (81, P), row 3o + k.
//   Bound on the H100: memory.  Compulsory traffic, each input read once
//   and the output written once: per particle w27t 108 B and v 12 B (wv),
//   + C 36 B (aff), or gradW 324 B and M 36 B (fg); per cell cell_start
//   4 B and 4 nc B of output.  wv: 281.5 MB at 129^3 / 1,987,675 particles
//   (0.084 ms at 3.35 TB/s), 97.8 MB on the 127^3 MPM cone (473,798
//   particles, 0.029 ms); aff: 353.0 MB at 129^3 (0.105 ms); fg: 203.3 MB
//   on the cone (0.061 ms).  What holds a pull over the source cells back
//   is not bytes: a thread per target cell walking its 27 source ranges one
//   particle at a time is unbalanced (the snow cone piles hundreds of
//   particles into a cell), its warp reads 32 scattered runs at once, and
//   the affine mode would read each particle's C on each of its 27 visits.
//   Design: a deterministic chunked pull, no float atomics, so frames are
//   bit-reproducible run to run.  A plan built once per frame
//   (transfer_kernels.chunk_plan; chunk_fill_kernel writes its lists) cuts
//   every occupied cell's particle range into chunks of at most CHUNK
//   particles, listed in (cell, chunk) order: chunk_first[k] is chunk k's
//   first particle, chunk_cell[k] its cell, chunk_start[b] cell b's first
//   chunk (chunk_start[n^3] the number of chunks).
//   Stage A (chunk_sums_kernel<Values>): one warp per chunk stages kTile
//   particles at a time in shared memory (the 27 w27t or 81 gradW rows read
//   coalesced along p; v, veff and C, or M once per particle) and lane
//   o < 27 sums the chunk's nc values of offset o in particle order:
//   sums[k, nc*o + c].  A crowded cell becomes many chunks on many warps.
//   chunk_combine_kernel<nc> then adds the chunks of each cell of several
//   chunks in chunk order into its first chunk's row (a thread per chunk
//   and offset): one 27*nc-float record per occupied cell.
//   Stage B (chunk_pull_kernel<nc>): one thread per target cell adds, for
//   each offset o in order 0..26, the record of source cell cell - off_o
//   (sources outside the box or without particles dropped).  Its reads do
//   not depend on one another, and a target with an empty neighbourhood
//   stops after 18 reads of chunk_start.
//   transfer_kernels.p2g_scatter_chunked, p2g_scatter_affine_chunked and
//   p2g_scatter_force_chunked are this order written in PyTorch; the
//   kernels equal them bit for bit.
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

// ---- K1: the chunked pull of every mode --------------------------------

constexpr int kTile = 32;           // particles a warp stages at a time
constexpr int kPitch = kTile + 1;   // the 27 lanes' rows in distinct banks

// The per-(particle, offset) values u(p, o) of the K1 modes.  stage() copies
// particle p into slot `slot` of the warp's shared tile (the row-major rows
// read along p, the per-particle vectors once); add() adds offset o's nc
// values of the tile's particle j into a[].
struct WvValues {
  static constexpr int kNc = 4;
  static constexpr int kWarpsPerSm = 32;
  struct Tile {
    float w[27 * kPitch];
    float4 v[kTile];              // (v0, v1, v2, 0)
  };
  const float* w27t;
  const float* vel;
  __device__ __forceinline__ void stage(Tile& t, long long p, int slot,
                                        long long np) const {
#pragma unroll 27
    for (int r = 0; r < 27; ++r) t.w[r * kPitch + slot] = w27t[r * np + p];
    const float* vp = vel + 3 * p;
    t.v[slot] = make_float4(vp[0], vp[1], vp[2], 0.f);
  }
  __device__ __forceinline__ void add(const Tile& t, int o, int j,
                                      float a[4]) const {
    const float w = t.w[o * kPitch + j];
    const float4 v = t.v[j];
    a[0] += w;
    a[1] += w * v.x;
    a[2] += w * v.y;
    a[3] += w * v.z;
  }
};

struct AffValues {
  static constexpr int kNc = 4;
  static constexpr int kWarpsPerSm = 32;
  struct Tile {
    float w[27 * kPitch];
    float4 v[kTile];              // veff
    float4 c[3 * kTile];          // row i of C as (C[i,0], C[i,1], C[i,2], 0)
  };
  const float* w27t;
  const float* veff;
  const float* aff;
  __device__ __forceinline__ void stage(Tile& t, long long p, int slot,
                                        long long np) const {
#pragma unroll 27
    for (int r = 0; r < 27; ++r) t.w[r * kPitch + slot] = w27t[r * np + p];
    const float* vp = veff + 3 * p;
    t.v[slot] = make_float4(vp[0], vp[1], vp[2], 0.f);
    const float* cp = aff + 9 * p;
    t.c[3 * slot] = make_float4(cp[0], cp[1], cp[2], 0.f);
    t.c[3 * slot + 1] = make_float4(cp[3], cp[4], cp[5], 0.f);
    t.c[3 * slot + 2] = make_float4(cp[6], cp[7], cp[8], 0.f);
  }
  __device__ __forceinline__ void add(const Tile& t, int o, int j,
                                      float a[4]) const {
    const float fx = (float)(o / 9 - 1);
    const float fy = (float)((o / 3) % 3 - 1);
    const float fz = (float)(o % 3 - 1);
    const float w = t.w[o * kPitch + j];
    const float4 v = t.v[j];
    const float4 c0 = t.c[3 * j], c1 = t.c[3 * j + 1], c2 = t.c[3 * j + 2];
    a[0] += w;
    a[1] += w * (v.x + c0.x * fx + c0.y * fy + c0.z * fz);
    a[2] += w * (v.y + c1.x * fx + c1.y * fy + c1.z * fz);
    a[3] += w * (v.z + c2.x * fx + c2.y * fy + c2.z * fz);
  }
};

struct ForceValues {
  static constexpr int kNc = 3;
  static constexpr int kWarpsPerSm = 16;
  struct Tile {
    float g[81 * kPitch];
    float4 m[3 * kTile];          // row c of M as (M[c,0], M[c,1], M[c,2], 0)
  };
  const float* gradw;
  const float* m9;
  __device__ __forceinline__ void stage(Tile& t, long long p, int slot,
                                        long long np) const {
#pragma unroll 27
    for (int r = 0; r < 81; ++r) t.g[r * kPitch + slot] = gradw[r * np + p];
    const float* mp = m9 + 9 * p;
    t.m[3 * slot] = make_float4(mp[0], mp[1], mp[2], 0.f);
    t.m[3 * slot + 1] = make_float4(mp[3], mp[4], mp[5], 0.f);
    t.m[3 * slot + 2] = make_float4(mp[6], mp[7], mp[8], 0.f);
  }
  __device__ __forceinline__ void add(const Tile& t, int o, int j,
                                      float a[3]) const {
    const float* g0 = t.g + 3 * o * kPitch;
    const float gx = g0[j], gy = g0[kPitch + j], gz = g0[2 * kPitch + j];
    const float4 r0 = t.m[3 * j], r1 = t.m[3 * j + 1], r2 = t.m[3 * j + 2];
    a[0] += r0.x * gx + r0.y * gy + r0.z * gz;
    a[1] += r1.x * gx + r1.y * gy + r1.z * gz;
    a[2] += r2.x * gx + r2.y * gy + r2.z * gz;
  }
};

// The nc floats of one offset in a row of chunk sums or records (27 * nc
// floats a row; for nc = 4 every offset's group is 16-byte aligned).
template <int kNc>
__device__ __forceinline__ void load_group(const float* s, float a[kNc]) {
  if constexpr (kNc == 4) {
    const float4 r = *reinterpret_cast<const float4*>(s);
    a[0] = r.x;
    a[1] = r.y;
    a[2] = r.z;
    a[3] = r.w;
  } else {
#pragma unroll
    for (int c = 0; c < kNc; ++c) a[c] = s[c];
  }
}

template <int kNc>
__device__ __forceinline__ void store_group(float* s, const float a[kNc]) {
  if constexpr (kNc == 4) {
    *reinterpret_cast<float4*>(s) = make_float4(a[0], a[1], a[2], a[3]);
  } else {
#pragma unroll
    for (int c = 0; c < kNc; ++c) s[c] = a[c];
  }
}

// Stage A: sums[k, nc*o + c] over chunk k's particles, in particle order.
template <class V>
__global__ void __launch_bounds__(32, V::kWarpsPerSm)
    chunk_sums_kernel(V vals, const int* __restrict__ chunk_first, int nch,
                      float* __restrict__ sums, long long np) {
  constexpr int kNc = V::kNc;
  __shared__ typename V::Tile tile;
  const int lane = threadIdx.x;
  for (int k = blockIdx.x; k < nch; k += gridDim.x) {
    const int p0 = chunk_first[k], p1 = chunk_first[k + 1];
    float a[kNc];
#pragma unroll
    for (int c = 0; c < kNc; ++c) a[c] = 0.f;
    for (int t0 = p0; t0 < p1; t0 += kTile) {
      const int len = min(kTile, p1 - t0);
      __syncwarp();
      if (lane < len) vals.stage(tile, t0 + lane, lane, np);
      __syncwarp();
      if (lane < 27)
        for (int j = 0; j < len; ++j) vals.add(tile, lane, j, a);
    }
    if (lane < 27) store_group<kNc>(sums + 27LL * kNc * k + kNc * lane, a);
  }
}

// Stage A's second kernel: the record of a cell of several chunks, the sum
// of its chunks' sums in chunk order, into its first chunk's row.  One
// thread per (chunk, offset): those of a cell's first chunk sum their
// offset's group, the rest only test their chunk.
template <int kNc>
__global__ void chunk_combine_kernel(float* __restrict__ sums,
                                     const int* __restrict__ chunk_cell,
                                     const int* __restrict__ chunk_start,
                                     int nch) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= 27LL * nch) return;
  const int k = (int)(i / 27), o = (int)(i - 27LL * k);
  const int b = chunk_cell[k];
  const int k1 = chunk_start[b + 1];
  if (chunk_start[b] != k || k1 - k < 2) return;
  float t[kNc], g[kNc];
#pragma unroll
  for (int c = 0; c < kNc; ++c) t[c] = 0.f;
#pragma unroll 4
  for (int q = k; q < k1; ++q) {
    load_group<kNc>(sums + 27LL * kNc * q + kNc * o, g);
#pragma unroll
    for (int c = 0; c < kNc; ++c) t[c] += g[c];
  }
  store_group<kNc>(sums + 27LL * kNc * k + kNc * o, t);
}

// Stage B: one thread per target cell adds the records of its source cells
// in offset order; a target whose 27 sources hold no chunk writes zeros
// after 18 reads of chunk_start.  n^3 < 2^31 (checked by the caller).
template <int kNc>
__global__ void chunk_pull_kernel(const float* __restrict__ rec,
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
  float a[kNc], g[kNc];
#pragma unroll
  for (int ch = 0; ch < kNc; ++ch) a[ch] = 0.f;
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
        load_group<kNc>(rec + 27LL * kNc * k0 + kNc * o, g);
#pragma unroll
        for (int ch = 0; ch < kNc; ++ch) a[ch] += g[ch];
      }
    }
  }
#pragma unroll
  for (int ch = 0; ch < kNc; ++ch) out[(long long)ch * ncell + c] = a[ch];
}

// The plan's chunk lists: thread b writes the chunks of cell b, and the
// last cell's thread the closing entry (P, n^3) at chunk_start[n^3].
__global__ void chunk_fill_kernel(const int* __restrict__ cell_start,
                                  const int* __restrict__ chunk_start,
                                  int* __restrict__ chunk_first,
                                  int* __restrict__ chunk_cell, int ncell,
                                  int chunk) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= ncell) return;
  const int e = cell_start[b + 1];
  int k = chunk_start[b];
  for (int q = cell_start[b]; q < e; q += chunk, ++k) {
    chunk_first[k] = q;
    chunk_cell[k] = b;
  }
  if (b == ncell - 1) {
    chunk_first[k] = e;
    chunk_cell[k] = ncell;
  }
}

// The three kernels of a K1 launch.  sums: (nch, 27 * nc) scratch, nch the
// plan's chunk count chunk_start[n^3] (chunk_plan reads it once per frame);
// the warps of stage A stride over the chunks.
template <class V>
int chunked_scatter(V vals, const int* chunk_first, const int* chunk_cell,
                    const int* chunk_start, float* sums, float* out, int n,
                    long long np, int nch, cudaStream_t st) {
  const long long ncell = (long long)n * n * n;
  if (nch > 0) {
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    const int warps = 2 * V::kWarpsPerSm * sms;
    const int grid = nch < warps ? nch : warps;
    chunk_sums_kernel<V><<<grid, 32, 0, st>>>(vals, chunk_first, nch, sums,
                                              np);
    const unsigned pairs = (unsigned)((27LL * nch + kThreads - 1) / kThreads);
    chunk_combine_kernel<V::kNc><<<pairs, kThreads, 0, st>>>(
        sums, chunk_cell, chunk_start, nch);
    const int rc = (int)cudaGetLastError();
    if (rc != 0) return rc;
  }
  const unsigned blocks = (unsigned)((ncell + kThreads - 1) / kThreads);
  chunk_pull_kernel<V::kNc><<<blocks, kThreads, 0, st>>>(sums, chunk_start,
                                                         out, n);
  return (int)cudaGetLastError();
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
                              const int* chunk_first, const int* chunk_cell,
                              const int* chunk_start, float* sums, float* out,
                              int n, long long np, int nch, void* stream) {
  return chunked_scatter(WvValues{w27t, vel}, chunk_first, chunk_cell,
                         chunk_start, sums, out, n, np, nch,
                         (cudaStream_t)stream);
}

extern "C" int fs_p2g_scatter_affine(const float* w27t, const float* veff,
                                     const float* aff, const int* chunk_first,
                                     const int* chunk_cell,
                                     const int* chunk_start, float* sums,
                                     float* out, int n, long long np, int nch,
                                     void* stream) {
  return chunked_scatter(AffValues{w27t, veff, aff}, chunk_first, chunk_cell,
                         chunk_start, sums, out, n, np, nch,
                         (cudaStream_t)stream);
}

extern "C" int fs_p2g_scatter_force(const float* gradw, const float* m9,
                                    const int* chunk_first,
                                    const int* chunk_cell,
                                    const int* chunk_start, float* sums,
                                    float* out, int n, long long np, int nch,
                                    void* stream) {
  return chunked_scatter(ForceValues{gradw, m9}, chunk_first, chunk_cell,
                         chunk_start, sums, out, n, np, nch,
                         (cudaStream_t)stream);
}

extern "C" int fs_chunk_fill(const int* cell_start, const int* chunk_start,
                             int* chunk_first, int* chunk_cell, int ncell,
                             int chunk, void* stream) {
  const unsigned blocks = (unsigned)((ncell + kThreads - 1) / kThreads);
  chunk_fill_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      cell_start, chunk_start, chunk_first, chunk_cell, ncell, chunk);
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
