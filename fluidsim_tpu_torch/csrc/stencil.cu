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
// fluidsim_tpu_torch/parallel/flip_sharded.py.  Beside each slab operand
// they take its neighbours' edge planes where those lie (SlabField: h
// planes before row 0 and h after row nx - 1); a null plane reads 0, a
// domain end.  No operand with ghost rows is built and no output is cut.
//
// K3 fs_apply_laplacian replaces fluidsim_tpu/ops/pallas_stencil.py:
//   apply_laplacian_padded (_kernel) and apply_laplacian_padded_lh
//   (_kernel_lh), the masked 7-point Laplacian
//   out = adiag > 0 ? adiag*q - scale*(((((x- + x+) + y-) + y+) + z-) + z+)
//   : 0, summed in that order, with one edge plane of p and adiag on each
//   side (h = 1).
//   Bound on the H100: memory.  2 reads + 1 write of 4 B per cell = 12 B per
//   cell, 25.8 MB at 129^3 (~7.7 us at 3.35 TB/s), 7.0 MB on a 4-way rank's
//   33-row slab (~2.1 us).
//   Design: an x-marching (y, z) tile.  A block owns kLapY x kLapRows rows
//   of 32 z columns and marches over a chunk of x planes; a thread computes
//   kLapRows rows of its column.  Each plane of p is staged in shared
//   memory with the tile's one-cell y/z halo by cp.async while the plane
//   before is computed, and copied only where adiag > 0 (adiag comes into
//   registers a plane ahead: only the thread that stages a cell reads it):
//   outside the fluid, the box and the slab's null edge planes the copy
//   zero-fills, so the staged plane is the masked q, every value is read
//   from memory about once and no edge is branched on in the inner loop.
//   A thread keeps q of planes x - 1, x and x + 1 of its cells in
//   registers, and the y neighbours of its inner rows too; the sum keeps
//   its order.  Indices come from blockIdx and the plane loop (no 64-bit
//   divide).  The x chunk is sized so that one wave of blocks fills the
//   card, at least kLapMinRows planes (a 33-row slab still fills the 132
//   SMs).  It is slower than the port's earlier K3, a thread per cell that
//   read p at fluid cells only, on the frame's data (PERF.md section 6): a
//   plane step costs a block its loads, copies, a barrier and its loop
//   whatever the fluid share.
//
// K4 fs_cheb_steps replaces fluidsim_tpu/ops/pallas_stencil.py:
//   cheb_step_padded (_kernel_cheb) and cheb_step_padded_lh
//   (_kernel_cheb_lh), one fused Chebyshev inner step
//   az = (K3 of z); resid = r - az; pd = adiag > 0 ? resid/adiag : 0;
//   d' = c1*d + c2*pd; z' = q + d',
//   and chebyshev_precond_fused (l.532), which chains them: here S of those
//   steps (1 <= S <= kMaxChebSteps = 3) run in one launch, from a given
//   (z, d), or from the Jacobi term d0 = (adiag > 0 ? r/adiag : 0) *
//   (1/theta), z0 = d0 computed in the kernel (no z or d read).  Every
//   input takes h = S edge planes.  It writes z after the S steps, and d'
//   where asked for.
//   Bound on the H100: memory.  From the Jacobi start: r and adiag read,
//   z written, 12 B per cell (25.8 MB at 129^3, ~7.7 us) for the whole
//   preconditioner; from a given (z, d): 4 reads + 2 writes, 24 B per cell.
//   The port's first preconditioner took three eager passes for the
//   Jacobi term, then degree - 1 launches of 24 B per cell.
//   Design: temporal blocking on the x-marching tile.  A block's tile is
//   (32 - 2S) x (16 - 2S) output columns with an S-cell ring, and it marches
//   over a chunk of x planes and S planes on each side of it.  At plane
//   step i it stages level 0 (z, d, or the Jacobi term, and adiag, r) of
//   plane i, then computes level k (the state after k steps) of plane i - k
//   for k = 1..S: level k of a plane needs level k - 1 of that plane and its
//   two x neighbours, which the thread keeps in registers, and of its y and
//   z neighbours, which the previous plane step left in shared memory (two
//   buffers a level, one barrier a plane step).  The valid region shrinks
//   by one cell a level, so level S is right on the inner tile and the
//   chunk: the ring's and the extra planes' cells are computed again by
//   the blocks that own them, each with the same f32 operations in the
//   same order as its owner, so the results are the composed steps' bit for
//   bit.  Only level S is written to device memory.  The time hardly
//   depends on how much of the grid is fluid: every plane step costs the
//   block its loads, its level updates and a barrier.  A thread per cell
//   recomputing the lower levels of its L1 ball in registers (no shared
//   memory, nothing done outside the fluid) was built, held bit for bit,
//   and was several times slower at S = 2 and 3.  Four steps in one launch
//   cost more than two launches of two, so a launch takes at most three.
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

// ---- K3 and K4 ---------------------------------------------------------

// One field of an (nx, n, n) slab and its neighbours' edge planes: lo holds
// the h planes before row 0 (lo[h - 1] beside it), hi the h planes after
// row nx - 1.  A null mid, lo or hi reads 0.
struct SlabField {
  const float* mid;
  const float* lo;
  const float* hi;
};

// cp.async of one f32 from global memory to the shared address dst; with
// read false nothing is read and the element is zero-filled (src must
// still be a valid address).
__device__ __forceinline__ void stage4(unsigned dst, const float* src,
                                       bool read) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(read ? 4 : 0));
}
// wait for this thread's cp.async copies
__device__ __forceinline__ void stage_wait() {
  asm volatile("cp.async.wait_all;\n" ::);
}

// The planes per block: enough chunks of x that one wave of blocks (all
// resident at once) fills the card, but at least min_rows planes a chunk.
// wave caches the kernel's blocks in one wave (each launcher keeps its own).
template <typename Kernel>
int chunk_rows(Kernel kernel, int threads, int& wave, long long tiles,
               int nx, int min_rows) {
  if (wave == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                  0);
    wave = sms * (per_sm > 0 ? per_sm : 1);
  }
  long long chunks = wave / tiles;
  if (chunks < 1) chunks = 1;
  int rows = (int)((nx + chunks - 1) / chunks);
  if (rows < min_rows) rows = min_rows;
  return rows < nx ? rows : nx;
}

// K3: a block of kLapZ x TY threads (TY = kLapY, R = kLapRows) owns a
// (TY R) x kLapZ (y, z) tile of output columns, a thread R rows of its z
// column, and marches over a chunk of x planes, rows [x0, x1), staging
// planes x0 - 1 .. x1.  Tick t: the thread loads adiag of plane first + t
// at its cells into registers, and issues the cp.async copy of p of plane
// first + t - 1 into shared memory with the tile's one-cell y/z halo
// ((TY R + 2) x (kLapZ + 2) cells; each thread copies its own R cells, the
// first 2 kLapZ + 2 TY R threads one halo cell too), reading p only where
// its adiag, loaded the tick before, is > 0: outside the fluid, the box or
// the slab's null edge planes the copy zero-fills, so the staged plane is
// already masked (q) and no edge is branched on in the inner loop.  After
// a wait and a barrier, plane j = first + t - 2 has landed and the thread
// writes plane j - 1: x- and x+ are q of planes j - 2 and j, which it
// keeps in registers, the y and z neighbours those of plane j - 1, from
// its own rows' registers or read from the staged tile the tick before.
// Two staged planes (j, and j + 1 in flight) are all the shared memory.
constexpr int kLapZ = 32;
// the fastest on the H100 on the FLIP frame's fields among TY 4-16, R 1-8,
// 2-64 planes a block and deeper cp.async pipelines
constexpr int kLapY = 4;        // TY: thread rows of a block
constexpr int kLapRows = 4;     // R: y rows a thread computes
constexpr int kLapMinRows = 4;  // the least x planes a block computes

// The (n, n) plane x of a field (-h <= x < nx + h), or null: a null mid, lo
// or hi plane, which reads 0.  x is the same for the whole block.
__device__ __forceinline__ const float* plane_at(const SlabField& f, int x,
                                                 int nx, int h, int plane) {
  const float* base = x < 0 ? f.lo : x < nx ? f.mid : f.hi;
  const int k = x < 0 ? x + h : x < nx ? x : x - nx;
  return base ? base + (long long)k * plane : nullptr;
}

__global__ void __launch_bounds__(kLapZ * kLapY)
    apply_laplacian_kernel(SlabField p, SlabField a, float* __restrict__ out,
                           float scale, int nx, int n, int rows) {
  constexpr int TY = kLapY, R = kLapRows;
  constexpr int W = kLapZ + 2, H = TY * R + 2, HW = H * W;
  constexpr int kHalo = 2 * kLapZ + 2 * (H - 2);
  static_assert(kHalo <= kLapZ * TY, "one halo cell a thread at most");
  constexpr int E = R + 1;        // staged cells a thread: R rows + 1 halo
  __shared__ float sq[2 * HW];    // q of planes j and j + 1
  const int tz = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kLapZ + tz;
  const int y0 = blockIdx.y * (TY * R) - 1, z0 = blockIdx.x * kLapZ - 1;
  const int x0 = blockIdx.z * rows, x1 = min(nx, x0 + rows);
  const int first = x0 - 1, last = x1;
  const int plane = n * n;
  // the staged cells of this thread: e < R its rows ty R + e of its
  // column, e = R a halo cell (threads tid < kHalo); sc[e] the cell's
  // offset in a staged plane, gyz[e] in a field's plane (-1 outside the box)
  int sc[E], gyz[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    int ey = ty * R + e + 1, ez = tz + 1;
    if (e == R) {
      const int h = tid < kHalo ? tid : 0;
      if (h < kLapZ) {
        ey = 0, ez = h + 1;
      } else if (h < 2 * kLapZ) {
        ey = H - 1, ez = h - kLapZ + 1;
      } else if (h < 2 * kLapZ + H - 2) {
        ey = h - 2 * kLapZ + 1, ez = 0;
      } else {
        ey = h - 2 * kLapZ - (H - 2) + 1, ez = W - 1;
      }
    }
    const int gy = y0 + ey, gz = z0 + ez;
    sc[e] = ey * W + ez;
    gyz[e] = gy >= 0 && gy < n && gz >= 0 && gz < n ? gy * n + gz : -1;
    if (e == R && tid >= kHalo) gyz[e] = -1;
  }
  const unsigned sq0 = (unsigned)__cvta_generic_to_shared(sq);
  float* o = out + (long long)x0 * plane + (y0 + ty * R + 1) * n + tz + z0 + 1;
  // adiag of the thread's cells, loaded a plane ahead of the copy of p it
  // gates: an of plane first + t (this tick's loads), aq of first + t - 1
  // (the copy of p issued this tick), and of its rows a1, a2 of planes
  // first + t - 2, first + t - 3 (the plane written this tick)
  float an[E], aq[E], a1[R], a2[R];
  // per row: q of planes j - 2 (qm) and j - 1 (qc), and the z neighbours in
  // plane j - 1; the y neighbours of the end rows in plane j - 1 (yl, yh)
  float qm[R], qc[R], zm[R], zp[R], yl = 0.f, yh = 0.f;
#pragma unroll
  for (int e = 0; e < E; ++e) an[e] = aq[e] = 0.f;
#pragma unroll
  for (int r = 0; r < R; ++r)
    a1[r] = a2[r] = qm[r] = qc[r] = zm[r] = zp[r] = 0.f;
  const int ticks = last - first + 3;
  for (int t = 0; t < ticks; ++t) {
    // p of plane j = first + t - 2 (issued the tick before) has landed
    stage_wait();
    __syncthreads();
    const int xq = first + t - 1, xa = first + t;
    const bool iq = xq >= first && xq <= last, ia = xa <= last;
    const float* bq = iq ? plane_at(p, xq, nx, 1, plane) : nullptr;
    const float* ba = ia ? plane_at(a, xa, nx, 1, plane) : nullptr;
    const int wq = (t + 1) & 1;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const bool in = gyz[e] >= 0;
      aq[e] = an[e];
      an[e] = ba && in ? __ldg(ba + gyz[e]) : 0.f;
      if (iq && (e < R || tid < kHalo)) {
        const bool fluid = bq && in && aq[e] > 0.f;
        stage4(sq0 + 4 * (wq * HW + sc[e]), fluid ? bq + gyz[e] : p.mid,
               fluid);
      }
    }
    if (t >= 2) {
      // write plane j - 1
      const float* b = sq + (t & 1) * HW;
      float qn[R];
#pragma unroll
      for (int r = 0; r < R; ++r) qn[r] = b[sc[r]];
      if (t >= 4) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          if (gyz[r] < 0) continue;
          const float am = a2[r];
          float v = 0.f;
          if (am > 0.f) {
            const float ym = r > 0 ? qc[r - 1] : yl;
            const float yp = r < R - 1 ? qc[r + 1] : yh;
            const float s = ((((qm[r] + qn[r]) + ym) + yp) + zm[r]) + zp[r];
            v = am * qc[r] - scale * s;
          }
          o[r * n] = v;
        }
        o += plane;
      }
      yl = b[sc[0] - W];
      yh = b[sc[R - 1] + W];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        zm[r] = b[sc[r] - 1];
        zp[r] = b[sc[r] + 1];
        qm[r] = qc[r];
        qc[r] = qn[r];
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      a2[r] = a1[r];
      a1[r] = aq[r];
    }
  }
}

// A block of K4 is kTileZ x kTileY threads, one per (z, y) column of its
// tile (threadIdx.x along z: a warp is 32 consecutive cells of a row).  The
// outer ring of S cells is computed for the inner columns, whose cells are
// written.
constexpr int kTileZ = 32;
constexpr int kTileY = 16;
constexpr int kTileThreads = kTileZ * kTileY;
constexpr int kMaxChebSteps = 3;
// planes whose loads are in flight ahead of the one being staged
constexpr int kPrefetch = 2;

// A thread's pointer into a field along x: its column's cell of plane x
// (-h <= x < nx + h), or null where that plane is null or the column lies
// outside the box (inb false), which reads 0.
__device__ __forceinline__ const float* column(const SlabField& f, int x,
                                               int nx, int h, long long plane,
                                               int yz, bool inb) {
  const float* base = x < 0 ? f.lo : x < nx ? f.mid : f.hi;
  if (!inb || base == nullptr) return nullptr;
  const int k = x < 0 ? x + h : x < nx ? x : x - nx;
  return base + (long long)k * plane + yz;
}

// Move a column pointer from plane x_next - 1 to x_next.  x is the same for
// the whole block, so only the null test is per thread.
__device__ __forceinline__ void advance(const float*& c, const SlabField& f,
                                        int x_next, int nx, long long plane,
                                        int yz, bool inb) {
  if (x_next == 0)
    c = inb && f.mid ? f.mid + yz : nullptr;
  else if (x_next == nx)
    c = inb && f.hi ? f.hi + yz : nullptr;
  else if (c)
    c += plane;
}

__device__ __forceinline__ float load(const float* c) {
  return c ? __ldg(c) : 0.f;
}

struct ChebCoefs {
  float c1[kMaxChebSteps];
  float c2[kMaxChebSteps];
};

// K4: S steps on rows [x0, x0 + rows).  Plane step i (from x0 - S to
// x1 + S - 1) stages level 0 of plane i and computes level k of plane i - k
// for k = 1..S (see the note at the top).  Per thread: aw[k], rw[k] are
// adiag and r of plane i - k; qw[k] holds level k's masked z of planes
// i - k - 2, i - k - 1, i - k; dw[k] level k's d of plane i - 1 - k (the
// previous plane step's).  Level k is valid at least k cells inside the
// tile's edge (ring >= k) and skipped elsewhere; a thread skipped at level
// k is skipped above it too.
template <int S, bool kJacobi>
__global__ void __launch_bounds__(kTileThreads)
    cheb_steps_kernel(SlabField zf, SlabField df, SlabField rf, SlabField af,
                      float* __restrict__ zn, float* __restrict__ dn,
                      ChebCoefs cf, float scale, float inv_theta, int nx,
                      int n, int rows) {
  __shared__ float sq[S][2][kTileY][kTileZ];
  const int tz = threadIdx.x, ty = threadIdx.y;
  const int z = blockIdx.x * (kTileZ - 2 * S) - S + tz;
  const int y = blockIdx.y * (kTileY - 2 * S) - S + ty;
  const int x0 = blockIdx.z * rows;
  const int x1 = min(nx, x0 + rows);
  const bool inb = y >= 0 && y < n && z >= 0 && z < n;
  const int ring = min(min(tz, kTileZ - 1 - tz), min(ty, kTileY - 1 - ty));
  const bool own = inb && ring >= S;
  const int yz = inb ? y * n + z : 0;
  const long long plane = (long long)n * n;
  float* oz = zn + (long long)x0 * plane + yz;
  float* od = dn ? dn + (long long)x0 * plane + yz : nullptr;
  const int first = x0 - S, last = x1 + S - 1;   // staged planes
  const float* ca = column(af, first, nx, S, plane, yz, inb);
  const float* cr = column(rf, first, nx, S, plane, yz, inb);
  const float* cz =
      kJacobi ? nullptr : column(zf, first, nx, S, plane, yz, inb);
  const float* cd =
      kJacobi ? nullptr : column(df, first, nx, S, plane, yz, inb);
  int xl = first;
  float pf_a[kPrefetch], pf_r[kPrefetch], pf_z[kPrefetch], pf_d[kPrefetch];
  // the loads of the cursors' plane into slot j, then the cursors moved on
  auto fetch = [&](int j) {
    pf_a[j] = load(ca);
    pf_r[j] = load(cr);
    if (!kJacobi) {
      pf_z[j] = load(cz);
      pf_d[j] = load(cd);
    }
    ++xl;
    advance(ca, af, xl, nx, plane, yz, inb);
    advance(cr, rf, xl, nx, plane, yz, inb);
    if (!kJacobi) {
      advance(cz, zf, xl, nx, plane, yz, inb);
      advance(cd, df, xl, nx, plane, yz, inb);
    }
  };
#pragma unroll
  for (int j = 0; j < kPrefetch; ++j) {
    pf_a[j] = pf_r[j] = pf_z[j] = pf_d[j] = 0.f;
    if (xl <= last) fetch(j);
  }
  float aw[S + 1], rw[S + 1], qw[S][3], dw[S];
#pragma unroll
  for (int k = 0; k <= S; ++k) aw[k] = rw[k] = 0.f;
#pragma unroll
  for (int k = 0; k < S; ++k) qw[k][0] = qw[k][1] = qw[k][2] = dw[k] = 0.f;
  for (int i0 = first; i0 <= last; i0 += kPrefetch) {
#pragma unroll
    for (int j = 0; j < kPrefetch; ++j) {
      const int i = i0 + j;
      if (i > last) break;
#pragma unroll
      for (int k = S; k > 0; --k) {
        aw[k] = aw[k - 1];
        rw[k] = rw[k - 1];
      }
      aw[0] = pf_a[j];
      rw[0] = pf_r[j];
      float z0, d0;
      if (kJacobi) {
        d0 = (aw[0] > 0.f ? rw[0] / aw[0] : 0.f) * inv_theta;
        z0 = d0;
      } else {
        z0 = pf_z[j];
        d0 = pf_d[j];
      }
      if (xl <= last) fetch(j);
      float dnew[S];
      {  // level 0 of plane i
        const float q0 = aw[0] > 0.f ? z0 : 0.f;
        sq[0][i & 1][ty][tz] = q0;
        qw[0][0] = qw[0][1];
        qw[0][1] = qw[0][2];
        qw[0][2] = q0;
        dnew[0] = d0;
      }
#pragma unroll
      for (int k = 1; k <= S; ++k) {  // level k of plane i - k
        if (k < S) dnew[k] = 0.f;
        if (ring < k) continue;
        const float am = aw[k];
        const bool fluid = am > 0.f;
        const float mid = qw[k - 1][1];
        float az = 0.f;
        if (fluid) {
          const float(*b)[kTileZ] = sq[k - 1][(i - 1) & 1];
          const float s = ((((qw[k - 1][0] + qw[k - 1][2]) + b[ty - 1][tz]) +
                            b[ty + 1][tz]) +
                           b[ty][tz - 1]) +
                          b[ty][tz + 1];
          az = am * mid - scale * s;
        }
        const float resid = rw[k] - az;
        const float pd = fluid ? resid / am : 0.f;
        const float dv = cf.c1[k - 1] * dw[k - 1] + cf.c2[k - 1] * pd;
        const float zv = mid + dv;
        if (k < S) {
          const float qk = fluid ? zv : 0.f;
          sq[k][i & 1][ty][tz] = qk;
          qw[k][0] = qw[k][1];
          qw[k][1] = qw[k][2];
          qw[k][2] = qk;
          dnew[k] = dv;
        } else if (own && i - S >= x0) {
          *oz = zv;
          oz += plane;
          if (od) {
            *od = dv;
            od += plane;
          }
        }
      }
#pragma unroll
      for (int k = 0; k < S; ++k) dw[k] = dnew[k];
      __syncthreads();
    }
  }
}

template <int S, bool kJacobi>
int launch_cheb_steps(const SlabField* f, float* zn, float* dn,
                      const ChebCoefs& cf, float scale, float inv_theta,
                      int nx, int n, cudaStream_t stream) {
  const auto kernel = cheb_steps_kernel<S, kJacobi>;
  const dim3 grid((n + kTileZ - 2 * S - 1) / (kTileZ - 2 * S),
                  (n + kTileY - 2 * S - 1) / (kTileY - 2 * S));
  static int wave = 0;
  const int rows =
      chunk_rows(kernel, kTileThreads, wave, (long long)grid.x * grid.y,
                 nx, 2 * S);
  const dim3 blocks(grid.x, grid.y, (nx + rows - 1) / rows);
  kernel<<<blocks, dim3(kTileZ, kTileY), 0, stream>>>(
      f[0], f[1], f[2], f[3], zn, dn, cf, scale, inv_theta, nx, n, rows);
  return (int)cudaGetLastError();
}

template <int S>
int launch_cheb_steps(bool jacobi, const SlabField* f, float* zn, float* dn,
                      const ChebCoefs& cf, float scale, float inv_theta,
                      int nx, int n, cudaStream_t stream) {
  return jacobi ? launch_cheb_steps<S, true>(f, zn, dn, cf, scale, inv_theta,
                                             nx, n, stream)
                : launch_cheb_steps<S, false>(f, zn, dn, cf, scale, inv_theta,
                                              nx, n, stream);
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

// K3 on an (nx, n, n) slab; p_lo, p_hi, a_lo, a_hi are the (n, n) edge
// planes of p and adiag beside rows 0 and nx - 1, or null (zeros).
extern "C" int fs_apply_laplacian(const float* p, const float* adiag,
                                  const float* p_lo, const float* p_hi,
                                  const float* a_lo, const float* a_hi,
                                  float* out, float scale, int nx, int n,
                                  void* stream) {
  if (nx <= 0 || n <= 0) return 0;
  constexpr int tile_y = kLapY * kLapRows;
  const dim3 grid((n + kLapZ - 1) / kLapZ, (n + tile_y - 1) / tile_y);
  static int wave = 0;
  const int rows = chunk_rows(apply_laplacian_kernel, kLapZ * kLapY, wave,
                              (long long)grid.x * grid.y, nx, kLapMinRows);
  const dim3 blocks(grid.x, grid.y, (nx + rows - 1) / rows);
  apply_laplacian_kernel<<<blocks, dim3(kLapZ, kLapY), 0,
                           (cudaStream_t)stream>>>(
      SlabField{p, p_lo, p_hi}, SlabField{adiag, a_lo, a_hi}, out, scale, nx,
      n, rows);
  return (int)cudaGetLastError();
}

// K4: steps (1..kMaxChebSteps) Chebyshev steps on an (nx, n, n) slab.
// fields: 12 pointers, (mid, lo, hi) of z, d, r and adiag in that order, each
// lo / hi `steps` (n, n) planes or null (zeros); a null z (and d) starts
// from the Jacobi term with 1/theta = inv_theta.  coefs: (c1, c2) of each
// step, on the host.  zn gets z after the steps, dn (if not null) d'.
extern "C" int fs_cheb_steps(const float* const* fields, float* zn, float* dn,
                             const float* coefs, int steps, float scale,
                             float inv_theta, int nx, int n, void* stream) {
  if (steps < 1 || steps > kMaxChebSteps) return (int)cudaErrorInvalidValue;
  if (nx <= 0 || n <= 0) return 0;
  SlabField f[4];
  for (int k = 0; k < 4; ++k)
    f[k] = SlabField{fields[3 * k], fields[3 * k + 1], fields[3 * k + 2]};
  ChebCoefs cf = {};
  for (int k = 0; k < steps; ++k) {
    cf.c1[k] = coefs[2 * k];
    cf.c2[k] = coefs[2 * k + 1];
  }
  const bool jacobi = f[0].mid == nullptr;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (steps) {
    case 1:
      return launch_cheb_steps<1>(jacobi, f, zn, dn, cf, scale, inv_theta, nx,
                                  n, st);
    case 2:
      return launch_cheb_steps<2>(jacobi, f, zn, dn, cf, scale, inv_theta, nx,
                                  n, st);
    default:
      return launch_cheb_steps<3>(jacobi, f, zn, dn, cf, scale, inv_theta, nx,
                                  n, st);
  }
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
