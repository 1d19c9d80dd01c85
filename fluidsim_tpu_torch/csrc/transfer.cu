// Particle <-> grid transfer kernels of the FLIP, PIC, APIC and MPM frames
// (K1, K2 and their APIC and MPM modes: K1 aff, K1 fg, K2 moments, K2 gw)
// and of the unfused and span transfers (K6a, K7a, K9a, K9b), for Hopper
// (sm_90a), with a plain C interface bound through ctypes
// (fluidsim_tpu_torch/ops/transfer_kernels.py).
//
// All take particles sorted by the flat id (x*n + y)*n + z of their
// clipped base cell round(pos) + B, and the transposed stencil weights
// w27t (27, P) f32, zero for particles whose base cell is outside the box.
// Offset o is (o/9 - 1, (o/3)%3 - 1, o%3 - 1).
//
// Slabs.  The K1 modes, K2, K2 moments, K2 gw and K7a take the grid's x
// extent nx beside n: the grid is (nx, n, n), the cube when nx = n, or the
// x-slab of one rank of the sharded sims (fluidsim_tpu_torch/parallel/,
// the counterpart of fluidsim_tpu/parallel/flip_sharded.py:144-216 and
// mpm_sharded.py:143-258, whose slab is (nl + 4, n, n)).  Ids and
// neighbours are then x in [0, nx): a cell outside the slab reads 0 and
// takes nothing, as a cell outside the box does.  A rank's slots end with
// dead ones, whose id nx n^2 sorts them last; cell_start[nx n^2] is then
// the live count.  K1 never reaches them (its plan covers the cell ranges
// only); the gathers but K2 moments (which no slab path launches) take
// that count as `count`, a device int read by the kernel (nullptr: all P
// rows), and write zeros to the rows past it, so a dead slot's id, which
// decodes to row nx, reads no real cell and no host read sizes the launch.  A cube call (nx = n, count nullptr) launches the
// gathers built without the count test (kCount false).  K2 reads the count
// once a tile of particles and tests rows only in the tile that straddles
// it.
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
//   Output (nc, nx, n, n) on a slab.
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
// K2 fs_g2p_gather replaces fluidsim_tpu/ops/pallas_transfer.py:1339
//   gather_wv_fused (_gather_wv_fused_kernel), nout=8 (rows 0-3 live).
//   out[c, p] = sum_o w27t[o, p] * fm[c, base(p) + off_o] for c = 0..3,
//   each sum over o = 0..26 in order from +0, where fm holds 3 within-wall-
//   masked field channels and the mask itself; neighbours outside the grid
//   are skipped; rows past the count are 0.  Output (4, P) f32, bit for bit
//   transfer_kernels.g2p_gather_plain (and K7a and K9b).
//   Bound on the H100: memory.  Per particle it reads 108 B of weights
//   (214.7 of the 288.8 compulsory MB at 129^3) and 4 B of id, writes 16 B,
//   and its 27 neighbours' 432 B are shared by the ~25 sorted particles of
//   a cell.  A thread per particle that tested each neighbour against the
//   box before loading its weight kept about one weight line in flight a
//   warp and issued 108 scalar field loads a particle: 55-57% of the bound.
//   Design: a block per tile of kGatherTile = 128 sorted particles, a
//   thread each, at most 64 registers (8 blocks an SM):
//   - the tile's live count is read once: a tile wholly past it writes its
//     zeros with 16-byte stores and reads nothing; only the tile that
//     straddles it tests rows;
//   - each thread issues its id and all 27 weight loads into registers
//     first, so 27 lines a warp are in flight while the block reduces the
//     box of its live base cells (min and max of x, y, z: right for any
//     order, small for the sorted one);
//   - a box (the live base cells widened by one cell) of at most
//     kStageCells cells is staged in shared memory as float4, zeros outside
//     the grid, so each offset is one 16-byte shared read with no box test
//     (99% of the tiles of the 129^3 FLIP state; the rest read the fields
//     directly, the offsets unrolled, neighbours outside the grid skipped).
//   A staged zero adds w * 0 where the direct read skips: the same bits
//   (see tile_neighbours).  With `paths` given (two device ints), thread 0
//   of each tile with a live row adds 1 to paths[1], and to paths[0] when
//   its tile stages: the kernel's own count of the path it took.
//   A cp.async-fed persistent tile that double-buffered the weights in
//   shared memory, and the register tile without the staged box, were
//   slower at every launch shape on the H100 (PERF.md §6).
//
// K2 moments fs_g2p_moments replaces the same TPU gather with nout=24
//   (_contract_mat): the 22 live rows, from wf = w27t[o,p] * fm[:, base+off_o]
//     row 0 den = sum wf3, rows 1-3 sum wf_c, rows 4-6 sum wf3 off_k,
//     rows 7-15 sum wf_c off_k (row 7+3c+k), rows 16-21 sum wf3 off_k off_l
//     over the pairs (00, 01, 02, 11, 12, 22),
//   each over the 27 offsets in order from +0, neighbours outside the grid
//   skipped.  Output (22, P) f32, bit for bit
//   transfer_kernels.g2p_moments_plain (and K7a and K9b moments) on finite
//   fields.  No path gives it a live count (APIC has no sharded frame, as
//   in JAX): the entry refuses one.
//   The contract of the zero terms: a term whose offset factor is 0 is
//   skipped and a factor of -1 is a subtraction (moment_add, add_signed).
//   The plain version multiplies every term by its factor; on finite fields
//   the bits are the same (x * 0 is +-0, which leaves a sum that started at
//   +0 unchanged, and x * -1 is -x exactly).  On a non-finite field value
//   they may differ (inf * 0 is NaN where a skipped term adds nothing), but
//   rows 0-3 take every offset, so the particle's velocity is non-finite
//   all the same and check_finite still catches it.  The sources build with
//   --fmad=false, which keeps nvcc from folding x * 0; skipping takes ~180
//   multiplies and ~180 adds of exact +-0 a particle out (~880 -> ~520 FP32
//   instructions).
//   Bound on the H100: memory.  Per particle 108 B of weights, 4 B of id and
//   88 B of output, and 16 B at each cell the particles read: 399.0 MB at
//   129^3 / 1,987,675 particles (91,134 cells read), 0.1191 ms at 3.35 TB/s.
//   A thread per particle that loaded each weight inside its 27-offset loop
//   and tested each neighbour against the box (4 scalar field loads an
//   offset) ran at 44% of it (0.2704 ms, NVIDIA H100 80GB HBM3, 700.00 W).
//   Design: K2's tile (gather_box, stage_box, tile_neighbours), a block per
//   kGatherTile = 128 sorted particles: each thread loads its id and all 27
//   weights into registers before any field read, the block reduces and
//   stages the box as K2 does (the fields read directly when it is larger
//   than kStageCells), and each thread keeps its 22 sums in registers; at
//   most 128 registers a thread (it takes 72: 7 blocks an SM).  With `paths`
//   it counts its tiles and the staged ones as K2 does.  On the same card
//   (PERF.md §6) it ran at 0.160 ms at 129^3 (74% of the bound); slower
//   there: the tile's 27 x 128 weights copied into shared memory by
//   cp.async beside the box (0.175 ms), and two threads a particle on those
//   staged weights, one summing den, vnum, mbar and M, the other F
//   (0.189 ms).
//
// K2 gw fs_g2p_gather_gw replaces the same TPU gather with contract='gw',
//   nout=16: out[3c+k, p] = sum_o gW[p,o,k] * fm[c, base(p) + off_o] for
//   c, k = 0..2 (the TPU kernel's live rows 4k+c; its rows 4k+3 contract
//   the mask channel and every caller drops them), neighbours outside the
//   box reading 0.  fm is (3, n, n, n).  Output (9, P) f32.
//   Bound on the H100: memory; per particle 324 B of gradW, 4 B of id and
//   36 B of output, the grid values from cache; ~197 MB at 127^3 / 473,798
//   particles.  Design: a thread per sorted particle with 9 register
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
//   most of the compulsory traffic: at 129^3 / 1,987,675 particles the
//   output is 927.4 MB, with w27t, v and the ids 1,173.9 MB (0.3504 ms at
//   3.35 TB/s); with C (APIC) 1,245.5 MB (0.3718 ms).
//   Summation order (the contract): each of a cell's 108 sums is a
//   sequential f32 sum from +0 over the cell's particles in array order,
//   the products w * v and v + C off formed as in K1 aff.  That is the order
//   of the plain version on the CPU (index_add_) and of
//   transfer_kernels.p2g_scatter_base_ordered, which the kernel equals bit
//   for bit.
//   Design: deterministic, no float atomics; two kernels.  At 129^3 88% of
//   the windows hold no particle: zero_empty_windows_kernel writes their
//   108 x 512 zeros with 16-byte stores, 128 threads and two rows a block,
//   no shared memory.  Then p2g_scatter_base_kernel<kAffine> runs one
//   512-thread block per window, and an occupied window's block
//   1. ranks its span stably in one pass: each warp takes a contiguous
//      sub-span, counts its ids per cell and per group of kGroup cells
//      (__match_any_sync groups equal keys of 32 consecutive particles; the
//      group's leader adds its size to the warp's histogram), a scan over
//      (cell, warp) gives every warp's first slot per cell and group, and a
//      second pass over the sub-span writes each particle's sorted slot
//      (its key group's base plus its rank among the lower lanes) into
//      three lists in the scratch: the window's sorted order, each group's
//      particles in array order, and each particle's sorted slot;
//   2. sums group by group: the group's particles are staged in shared
//      memory in their sorted slots (the 27 weights, v, and C), loaded in
//      array order so that the reads of w27t coalesce (a group of more than
//      kStage particles is staged kStage at a time in sorted order), and
//      each (occupied cell, offset) pair of the group is one thread's four
//      sums over the cell's staged particles, reading only shared memory;
//      the running sums live in a shared (108, kGroup) block, so a cell that
//      spans several stages continues its sums there;
//   3. writes the group's (108, kGroup) block to the output, a warp per row
//      segment of 32 consecutive cells.
//   Staging every group in sorted order took most of an occupied block's
//   time on the H100: the window's order scatters a warp's weight reads
//   over the whole span, where the group's array order keeps them in runs.
//   The TPU kernel's one-hot matmuls, split3 passes and window-local f32 ids
//   are not needed.
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
//   Design: a thread per particle through the row contractions that K9b
//   shares (gather_rows, moment_rows, templated on where a particle's grid
//   values come from: TableColumn here), the offsets summed in K2's order:
//   the materialised G2P equals the fused one bit for bit.
//
// K9a fs_p2g_scatter_spans replaces fluidsim_tpu/ops/pallas_transfer.py:1500
//   scatter_wv_spans (_scatter_wv_spans_kernel, its plan build_spans): K6a's
//   function and summation order on particles fully sorted by cell, where
//   each cell's particles are one contiguous span.  Output (27, 4, n, n, n)
//   f32, every cell written, equal to K6a and
//   transfer_kernels.p2g_scatter_base_ordered bit for bit.
//   Bound on the H100: memory, as K6a: 1,173.9 MB at 129^3 / 1,987,675
//   particles (0.3504 ms), with C 1,245.5 MB (0.3718 ms); the output is 79%.
//   Design: three kernels and no scratch but the tile plan.
//   span_plan_kernel binary-searches the edges of the kSpanCells-cell tiles
//   (16,772 at 129^3) and checks the order: it sets a device flag, which
//   the caller zeroes, when an id lies below its predecessor or outside the
//   box; the wrapper copies it into pinned memory behind the kernels, waits
//   on an event and raises on it.  zero_empty_tiles_kernel writes the zeros
//   of the empty tiles (14,880 of 16,772 on the frame-2 FLIP state; 108
//   segments of 512 B each, 16-byte stores, a warp per segment): its many
//   small blocks write them faster than the tile blocks could, which fit
//   only 3 to an SM for their shared memory.  Then
//   scatter_spans_kernel<kAffine> runs a block per tile, and an occupied
//   tile's particles are one span [lo, hi):
//   - the block stages them span_stage() at a time in shared memory (the
//     27 weight rows read along p, v, C and the ids as contiguous runs),
//     each thread's share of the next stage loaded into registers while
//     the block sums the current one;
//   - each cell's run in the stage comes from the staged ids, and a thread
//     per (cell, offset) adds the run's particles in array order onto its 4
//     sums, which a shared (108, 128) block carries across stages from +0;
//     no rank pass, as K6a needs on a window-grouped order;
//   - the block then writes the tile, a warp per 512 B row segment.
//   A crowded cell is one thread's serial sum per offset: the order forbids
//   splitting it.  On an order that is not sorted the output is undefined
//   (the wrapper raises), but every access stays inside the arrays: a
//   tile's range is clamped to lo <= hi in [0, P], ids outside the tile are
//   skipped and a cell's run is clipped to the stage.
//
// K9b fs_g2p_gather_spans replaces fluidsim_tpu/ops/pallas_transfer.py:1603
//   gather_wv_spans (_gather_wv_spans_kernel): K7a's 4 rows (nout=8) or 22
//   moments (nout=24) on particles fully sorted by cell, equal to K7a and K2
//   (K2 moments) bit for bit through the same accumulators.
//   Bound on the H100: memory, as K7a: 289.5 MB (0.0864 ms), moments 432.7
//   MB (0.1292 ms).
//   Design: K7a's thread per particle with the order check fused in (each
//   thread tests its id against the box and its predecessor's id and sets
//   the flag, as K9a's plan does).  Sorted neighbours share cells, so a
//   block of 256 particles covers a short id range: when it spans at most
//   kSpanStageCells = 32 cells, the block first stages those cells' 108
//   table rows in shared memory, its reads coalesced along cells; a wider
//   block reads the table directly, as K7a.  On the H100 staging took the
//   frame-2 FLIP state from 0.1331 to 0.1196 ms (a probe; PERF.md §6).
//   An id out of order or outside the box is clamped into the arrays.
//
// All are built with --fmad=false so every product and sum is rounded as
// in the plain PyTorch versions they are checked against.

#include <cuda_runtime.h>

#include <climits>

#include "tile_search.cuh"

namespace {

constexpr int kThreads = 256;

constexpr int kMoments = 22;

// The 4 grid values that offset o of a particle with base cell f reads
// from column f of K7b's (27, 4, n, n, n) table, which holds 0 for a
// neighbour outside the box, where K2 and K2 moments skip the neighbour.
// Adding w * 0 leaves a sum that started at +0 unchanged to the bit, so
// K7a agrees with them bit for bit.
struct TableColumn {
  const float* table;
  __device__ __forceinline__ void load(int o, int f, long long ncell,
                                       float v[4]) const {
    const float* t = table + 4LL * o * ncell + f;
    v[0] = __ldg(t);
    v[1] = __ldg(t + ncell);
    v[2] = __ldg(t + 2 * ncell);
    v[3] = __ldg(t + 3 * ncell);
  }
};

// K9b's staged table: the columns f0 .. f0 + len - 1 of the block's id range
// in shared memory, row r = 4o + c of column d at cols[r * len + d]; `col`
// points at the particle's column.  The same values as TableColumn's.
struct StagedColumn {
  const float* col;
  int len;
  __device__ __forceinline__ void load(int o, int, long long,
                                       float v[4]) const {
    const float* t = col + 4 * o * len;
    v[0] = t[0];
    v[1] = t[len];
    v[2] = t[2 * len];
    v[3] = t[3 * len];
  }
};

// s + sign * x for a factor sign in {-1, 0, 1} known at compile time: the
// term of a factor 0 is skipped and a factor -1 is a subtraction.  For a
// finite x the bits are those of s + x * (float)sign: x * 0 is +-0, and
// adding +-0 to a sum that started at +0 leaves it unchanged (such a sum
// is never -0); x * -1 is -x exactly.
__device__ __forceinline__ void add_signed(float& s, float x, int sign) {
  if (sign > 0)
    s += x;
  else if (sign < 0)
    s -= x;
}

// K2 moments' terms of offset o, from the weight w and the grid values v
// of the neighbour at off_o: wf = w * v, and
//   row 0 den += wf.w, rows 1-3 vnum_c += wf_c, rows 4-6 mbar_k += wf.w
//   off_k, rows 7-15 F_{c,k} += wf_c off_k (row 7 + 3c + k), rows 16-21
//   M_kl += wf.w off_k off_l over the pairs (00, 01, 02, 11, 12, 22),
// each factor of 0 skipped and -1 subtracted (add_signed).  Rows 0-3 take
// every offset, so a non-finite grid value still reaches den or vnum.
__device__ __forceinline__ void moment_add(float (&s)[kMoments], int o,
                                           float w, float4 v) {
  const int off[3] = {o / 9 - 1, (o / 3) % 3 - 1, o % 3 - 1};
  const int kPairK[6] = {0, 0, 0, 1, 1, 2};
  const int kPairL[6] = {0, 1, 2, 1, 2, 2};
  const float wf[4] = {w * v.x, w * v.y, w * v.z, w * v.w};
  s[0] += wf[3];
  s[1] += wf[0];
  s[2] += wf[1];
  s[3] += wf[2];
#pragma unroll
  for (int k = 0; k < 3; ++k) add_signed(s[4 + k], wf[3], off[k]);
#pragma unroll
  for (int ch = 0; ch < 3; ++ch)
#pragma unroll
    for (int k = 0; k < 3; ++k) add_signed(s[7 + 3 * ch + k], wf[ch], off[k]);
#pragma unroll
  for (int i = 0; i < 6; ++i)
    add_signed(s[16 + i], wf[3], off[kPairK[i]] * off[kPairL[i]]);
}

// The rows of one particle p with base cell f: K2's 4 sums (gather_rows) or
// K2 moments' 22 (moment_rows), each over the 27 offsets in order from +0,
// the grid values read through src.  K7a and K9b run this code with their
// own sources, K2 and K2 moments their tiles (tile_neighbours) in the same
// order, so they agree bit for bit.  moment_rows multiplies every term by
// its offset factor, where moment_add skips a factor of 0: the same bits
// for finite values (add_signed); with the skip K9b moments ran 15% slower
// (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md §6).
template <class Src>
__device__ __forceinline__ void moment_rows(const Src& src,
                                            const float* __restrict__ w27t,
                                            float* __restrict__ out, int f,
                                            long long ncell, long long p,
                                            long long np) {
  const int kPairK[6] = {0, 0, 0, 1, 1, 2};
  const int kPairL[6] = {0, 1, 2, 1, 2, 2};
  float acc[kMoments];
#pragma unroll
  for (int r = 0; r < kMoments; ++r) acc[r] = 0.f;
#pragma unroll
  for (int o = 0; o < 27; ++o) {
    const int off[3] = {o / 9 - 1, (o / 3) % 3 - 1, o % 3 - 1};
    float v[4];
    src.load(o, f, ncell, v);
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
__device__ __forceinline__ void gather_rows(const Src& src,
                                            const float* __restrict__ w27t,
                                            float* __restrict__ out, int f,
                                            long long ncell, long long p,
                                            long long np) {
  float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
  for (int o = 0; o < 27; ++o) {
    float v[4];
    src.load(o, f, ncell, v);
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

template <bool kMom, class Src>
__device__ __forceinline__ void contract_rows(const Src& src,
                                              const float* __restrict__ w27t,
                                              float* __restrict__ out, int f,
                                              long long ncell, long long p,
                                              long long np) {
  if constexpr (kMom)
    moment_rows(src, w27t, out, f, ncell, p, np);
  else
    gather_rows(src, w27t, out, f, ncell, p, np);
}

// The particles a gather reads: the first *count of the np rows when the
// launch has a count (kCount: a device int, the alive prefix that a slab's
// cell_start ends with), else all np.  Each row past them gets zeros in every
// output row instead.  A launch without a count compiles the test away.
template <bool kCount>
__device__ __forceinline__ bool dead_row(const int* __restrict__ count,
                                         float* __restrict__ out, int rows,
                                         long long p, long long np) {
  if constexpr (!kCount) {
    return false;
  } else {
    if (p < (long long)__ldg(count)) return false;
    for (int r = 0; r < rows; ++r) out[r * np + p] = 0.f;
    return true;
  }
}

// K7a on the table (4 or 22 rows): a thread per sorted particle.
template <bool kMom, bool kCount, class Src>
__global__ void g2p_rows_kernel(Src src, const float* __restrict__ w27t,
                                const int* __restrict__ flat,
                                const int* __restrict__ count,
                                float* __restrict__ out, long long ncell,
                                long long np) {
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= np || dead_row<kCount>(count, out, kMom ? kMoments : 4, p, np))
    return;
  contract_rows<kMom>(src, w27t, out, flat[p], ncell, p, np);
}

// ---- K2 and K2 moments: a tile of sorted particles a block ---------------

constexpr int kGatherTile = 128;   // particles a tile
constexpr int kGatherBlocks = 8;   // K2's blocks an SM: at most 64 registers
constexpr int kMomentBlocks = 4;   // K2 moments': 128 registers (72 used; 64 spill)
constexpr int kStageCells = 1024;  // float4 cells a tile may stage (16 KB)

// Zeros into rows 0..3 of out at [p0, p0 + len), by the block: 16-byte
// stores where a row's span is aligned, scalar ones at its two ends.
__device__ __forceinline__ void zero_gather_rows(float* __restrict__ out,
                                                 long long np, long long p0,
                                                 int len) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    float* d = out + r * np + p0;
    const int mis = (int)(((unsigned long long)d >> 2) & 3);
    const int head = min(len, (4 - mis) & 3);
    const int body = (len - head) >> 2;
    float4* b = reinterpret_cast<float4*>(d + head);
    for (int i = threadIdx.x; i < body; i += blockDim.x)
      b[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    const int tail = len - head - 4 * body;
    if ((int)threadIdx.x < head) d[threadIdx.x] = 0.f;
    if ((int)threadIdx.x < tail) d[head + 4 * body + threadIdx.x] = 0.f;
  }
}

// The cells a tile's live particles read: the box of their base cells
// widened by one cell on every side, origin (x0, y0, z0), extents
// (bx, by, bz).  Staged when it holds at most kStageCells cells.
struct GatherBox {
  int x0, y0, z0, bx, by, bz;
  bool staged;
};

// The box of a tile's live particles, by the whole block (it synchronises):
// f is the thread's id when alive.  Each extent is a min and a max reduced
// over the live ids, so the box holds every live particle's neighbours
// whatever their order (the bucket path's window-grouped order too).
__device__ __forceinline__ GatherBox gather_box(int f, bool alive, int n,
                                                int (*red)[6]) {
  const int c[3] = {f / (n * n), (f / n) % n, f % n};
  const unsigned all = 0xffffffffu;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    const int v = __reduce_min_sync(
        all, alive ? (k & 1 ? -c[k >> 1] : c[k >> 1]) : INT_MAX);
    if ((threadIdx.x & 31) == 0) red[warp][k] = v;
  }
  __syncthreads();
  int m[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    m[k] = red[0][k];
#pragma unroll
    for (int i = 1; i < kGatherTile / 32; ++i) m[k] = min(m[k], red[i][k]);
  }
  GatherBox b;          // (lo, -hi) of each axis -> origin lo - 1, extent
  b.x0 = m[0] - 1;
  b.y0 = m[2] - 1;
  b.z0 = m[4] - 1;
  b.bx = -m[1] - m[0] + 3;
  b.by = -m[3] - m[2] + 3;
  b.bz = -m[5] - m[4] + 3;
  b.staged = (long long)b.bx * b.by * b.bz <= kStageCells;
  return b;
}

// Stage the box's cells as float4 (the 4 channels of one cell), zeros for
// cells outside the (nx, n, n) grid, then synchronise.
__device__ __forceinline__ void stage_box(const GatherBox& b,
                                          const float* __restrict__ fm,
                                          int nx, int n, long long ncell,
                                          float4* box) {
  const int plane = b.by * b.bz;
  for (int i = threadIdx.x; i < b.bx * plane; i += blockDim.x) {
    const int a = i / plane, r = i - a * plane;
    const int cy = r / b.bz, cz = r - cy * b.bz;
    const int gx = b.x0 + a, gy = b.y0 + cy, gz = b.z0 + cz;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (gx >= 0 && gx < nx && gy >= 0 && gy < n && gz >= 0 && gz < n) {
      const float* q = fm + ((long long)gx * n + gy) * n + gz;
      v = make_float4(__ldg(q), __ldg(q + ncell), __ldg(q + 2 * ncell),
                      __ldg(q + 3 * ncell));
    }
    box[i] = v;
  }
  __syncthreads();
}

// The 27 offsets o of a particle with base cell f, in order: add(o, v) with
// v the 4 grid values at f + off_o, from the staged box or from the fields
// (a neighbour outside the grid skipped).  A staged zero adds w * 0 where
// the direct read skips, which leaves a sum that started at +0 unchanged
// to the bit (see add_signed), so both give the same bits.  add is a
// functor whose sums live in registers (GatherSums, MomentSums).
template <class Add>
__device__ __forceinline__ void tile_neighbours(int f, int nx, int n,
                                                long long ncell,
                                                const float* __restrict__ fm,
                                                const GatherBox& b,
                                                const float4* box, Add& add) {
  const int nn = n * n;
  const int x = f / nn, y = (f / n) % n, z = f % n;
  if (b.staged) {
    const int zs = b.bz, ys = b.by * b.bz;
    const int c0 = (x - b.x0) * ys + (y - b.y0) * zs + (z - b.z0);
#pragma unroll
    for (int o = 0; o < 27; ++o)
      add(o, box[c0 + (o / 9 - 1) * ys + ((o / 3) % 3 - 1) * zs +
                 (o % 3 - 1)]);
    return;
  }
  const bool in_x[3] = {x > 0, true, x + 1 < nx};
  const bool in_y[3] = {y > 0, true, y + 1 < n};
  const bool in_z[3] = {z > 0, true, z + 1 < n};
#pragma unroll
  for (int o = 0; o < 27; ++o) {
    if (!(in_x[o / 9] && in_y[(o / 3) % 3] && in_z[o % 3])) continue;
    const float* q = fm + f + (o / 9 - 1) * nn + ((o / 3) % 3 - 1) * n +
                     (o % 3 - 1);
    add(o, make_float4(__ldg(q), __ldg(q + ncell), __ldg(q + 2 * ncell),
                       __ldg(q + 3 * ncell)));
  }
}

// K2's 4 sums of one particle, its 27 weights in registers.
struct GatherSums {
  float w[27];
  float s[4];
  __device__ __forceinline__ void operator()(int o, float4 v) {
    s[0] += w[o] * v.x;
    s[1] += w[o] * v.y;
    s[2] += w[o] * v.z;
    s[3] += w[o] * v.w;
  }
};

// K2: a block per tile of kGatherTile sorted particles, a thread each (see
// the note at the top).
template <bool kCount>
__global__ void __launch_bounds__(kGatherTile, kGatherBlocks)
    g2p_gather_kernel(const float* __restrict__ fm,
                      const float* __restrict__ w27t,
                      const int* __restrict__ flat,
                      const int* __restrict__ count, float* __restrict__ out,
                      int nx, int n, long long np, int* __restrict__ paths) {
  __shared__ int red[kGatherTile / 32][6];
  __shared__ float4 box[kStageCells];
  const long long ncell = (long long)nx * n * n;
  const long long p0 = (long long)blockIdx.x * kGatherTile;
  const int j = threadIdx.x;
  // the rows gathered: the first *count, or all np (the test compiled away)
  const long long live = kCount ? min((long long)__ldg(count), np) : np;
  const int len = (int)min((long long)kGatherTile, np - p0);
  if (p0 >= live) {                   // the whole tile past the count
    zero_gather_rows(out, np, p0, len);
    return;
  }
  const int nlive = (int)min((long long)len, live - p0);
  const bool alive = j < nlive;
  const long long p = p0 + j;
  const int f = alive ? __ldg(flat + p) : 0;
  GatherSums acc;                      // all 27 weight loads in flight
#pragma unroll
  for (int o = 0; o < 27; ++o)
    acc.w[o] = alive ? __ldg(w27t + o * np + p) : 0.f;
  const GatherBox b = gather_box(f, alive, n, red);
  if (paths != nullptr && j == 0) {    // the path taken: (staged, tiles)
    if (b.staged) atomicAdd(paths, 1);
    atomicAdd(paths + 1, 1);
  }
  if (b.staged) stage_box(b, fm, nx, n, ncell, box);
  if (j >= len) return;
#pragma unroll
  for (int r = 0; r < 4; ++r) acc.s[r] = 0.f;
  if (alive) tile_neighbours(f, nx, n, ncell, fm, b, box, acc);
#pragma unroll
  for (int r = 0; r < 4; ++r) out[r * np + p] = acc.s[r];
}

// K2 moments' 22 sums of one particle, its 27 weights in registers.
struct MomentSums {
  float w[27];
  float s[kMoments];
  __device__ __forceinline__ void operator()(int o, float4 v) {
    moment_add(s, o, w[o], v);
  }
};

// K2 moments: a block per tile of kGatherTile sorted particles, a thread
// each (see the note at the top); 27 weights and 22 sums in registers.
__global__ void __launch_bounds__(kGatherTile, kMomentBlocks)
    g2p_moments_kernel(const float* __restrict__ fm,
                       const float* __restrict__ w27t,
                       const int* __restrict__ flat, float* __restrict__ out,
                       int nx, int n, long long np, int* __restrict__ paths) {
  __shared__ int red[kGatherTile / 32][6];
  __shared__ float4 box[kStageCells];
  const long long ncell = (long long)nx * n * n;
  const long long p0 = (long long)blockIdx.x * kGatherTile;
  const int j = threadIdx.x;
  const int len = (int)min((long long)kGatherTile, np - p0);
  const bool alive = j < len;
  const long long p = p0 + j;
  const int f = alive ? __ldg(flat + p) : 0;
  MomentSums acc;                      // all 27 weight loads in flight
#pragma unroll
  for (int o = 0; o < 27; ++o)
    acc.w[o] = alive ? __ldg(w27t + o * np + p) : 0.f;
  const GatherBox b = gather_box(f, alive, n, red);
  if (paths != nullptr && j == 0) {    // the path taken: (staged, tiles)
    if (b.staged) atomicAdd(paths, 1);
    atomicAdd(paths + 1, 1);
  }
  if (b.staged) stage_box(b, fm, nx, n, ncell, box);
  if (!alive) return;
#pragma unroll
  for (int r = 0; r < kMoments; ++r) acc.s[r] = 0.f;
  tile_neighbours(f, nx, n, ncell, fm, b, box, acc);
#pragma unroll
  for (int r = 0; r < kMoments; ++r) out[r * np + p] = acc.s[r];
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

// Stage B: one thread per target cell of the (nx, n, n) grid adds the
// records of its source cells in offset order; a target whose 27 sources
// hold no chunk writes zeros after 18 reads of chunk_start.  nx n^2 < 2^31
// (checked by the caller).
template <int kNc>
__global__ void chunk_pull_kernel(const float* __restrict__ rec,
                                  const int* __restrict__ chunk_start,
                                  float* __restrict__ out, int nx, int n) {
  const int ncell = nx * n * n;
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
    if (bx >= 0 && bx < nx && by >= 0 && by < n) {
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
      if (bx < 0 || bx >= nx || by < 0 || by >= n || bz < 0 || bz >= n)
        continue;
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

// The three kernels of a K1 launch on an (nx, n, n) grid.  sums: (nch,
// 27 * nc) scratch, nch the plan's chunk count chunk_start[nx n^2]
// (chunk_plan reads it once per frame); the warps of stage A stride over the
// chunks.
template <class V>
int chunked_scatter(V vals, const int* chunk_first, const int* chunk_cell,
                    const int* chunk_start, float* sums, float* out, int nx,
                    int n, long long np, int nch, cudaStream_t st) {
  const long long ncell = (long long)nx * n * n;
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
                                                         out, nx, n);
  return (int)cudaGetLastError();
}

template <bool kCount>
__global__ void g2p_gather_gw_kernel(const float* __restrict__ fm,
                                     const float* __restrict__ gradw,
                                     const int* __restrict__ flat,
                                     const int* __restrict__ count,
                                     float* __restrict__ out, int nx, int n,
                                     long long np) {
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= np || dead_row<kCount>(count, out, 9, p, np)) return;
  const long long ncell = (long long)nx * n * n;
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
    if (cx < 0 || cx >= nx || cy < 0 || cy >= n || cz < 0 || cz >= n)
      continue;
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

constexpr int kWin = 512;             // cells per window (the bucket order's)
constexpr int kWarps = kWin / 32;     // warps of a K6a block
constexpr int kGroup = 32;            // cells summed and written together
constexpr int kGroups = kWin / kGroup;
static_assert(kGroups == kWarps, "lane 0 of warp g scans group g");
constexpr int kStage = kWin;          // particles staged at a time, one a thread
constexpr int kStageLd = kStage + 1;  // staged weight row stride (bank spread)
constexpr int kGroupLd = kGroup + 1;  // row stride of the group's sums

// K6a's dynamic shared memory, in 4-byte words: the staged particles (27
// weight rows, v, C), whose space the rank pass uses first for its per-warp
// histograms of cells and of groups; then the group's (108, kGroup) sums,
// the window's first slot per cell (kWin + 1) and the group's occupied
// cells (kGroup + 1).
template <bool kAffine>
__host__ __device__ constexpr int base_staged_words() {
  return 27 * kStageLd + 3 * kStage + (kAffine ? 9 * kStage : 0);
}
template <bool kAffine>
__host__ __device__ constexpr int base_smem_bytes() {
  return 4 * (base_staged_words<kAffine>() + 108 * kGroupLd + kWin + 1 +
              kGroup + 1);
}
static_assert(base_staged_words<false>() >= kWarps * (kWin + kGroups),
              "the rank pass's histograms must fit in the staging space");

// Zero row[0, len): 16-byte stores between a scalar head and tail (a row of
// the (27, 4, n, n, n) output starts at r * n^3 floats, which need not be
// 16-byte aligned); thread i of `threads` (at least 3) takes every
// threads-th store.
__device__ __forceinline__ void zero_segment(float* row, int len, int i,
                                             int threads) {
  const int mis = (int)(((unsigned long long)row >> 2) & 3);
  const int head = min(len, (4 - mis) & 3);
  const int body = (len - head) >> 2;
  const int tail = head + 4 * body;
  if (i < head) row[i] = 0.f;
  for (int k = i; k < body; k += threads)
    reinterpret_cast<float4*>(row + head)[k] = make_float4(0.f, 0.f, 0.f, 0.f);
  if (tail + i < len) row[tail + i] = 0.f;
}

// The 108 x 512 zeros of an empty window: block (b, y) writes rows 2y and
// 2y + 1 of window b.  Blocks of 1, 2, 4 and 12 rows and a flat fill were
// measured: 2 rows were fastest.
__global__ void __launch_bounds__(128)
    zero_empty_windows_kernel(const int* __restrict__ wstart,
                              float* __restrict__ out, long long ncell) {
  const int b = blockIdx.x;
  if (wstart[b] != wstart[b + 1]) return;
  const long long cell0 = (long long)b * kWin;
  const int ncw = (int)min((long long)kWin, ncell - cell0);
  for (int r = 2 * blockIdx.y; r < 2 * blockIdx.y + 2; ++r)
    zero_segment(out + r * ncell + cell0, ncw, threadIdx.x, 128);
}

// One block per occupied window (see the note at the top).  scratch holds
// 3 np ints: the window's particles in sorted order (sorted[s + pos] = p),
// group by group in array order (garr), and each particle's sorted position
// (rank[p] = pos), pos and the group lists' slots counted from the window's
// first particle s.
template <bool kAffine>
__global__ void __launch_bounds__(kWin, 2)
    p2g_scatter_base_kernel(const float* __restrict__ w27t,
                            const float* __restrict__ vel,
                            const float* __restrict__ aff,
                            const int* __restrict__ flat,
                            const int* __restrict__ wstart, int* scratch,
                            float* __restrict__ out, int n, long long np) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int warp_total[kWarps];
  const long long ncell = (long long)n * n * n;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long cell0 = (long long)blockIdx.x * kWin;
  const int ncw = (int)min((long long)kWin, ncell - cell0);
  const int s = wstart[blockIdx.x];
  const int e = wstart[blockIdx.x + 1];
  if (s == e) return;        // zero_empty_windows_kernel writes its zeros
  int* sorted = scratch;
  int* garr = scratch + np;
  int* rank = scratch + 2 * np;
  float* sw = smem;                          // [27][kStageLd] weights
  float* sv = sw + 27 * kStageLd;            // [3][kStage] v
  float* sc = sv + 3 * kStage;               // [9][kStage] C (APIC)
  int* hist = reinterpret_cast<int*>(smem);  // [kWarps][kWin], rank pass
  int* ghist = hist + kWarps * kWin;         // [kWarps][kGroups], rank pass
  float* res = smem + base_staged_words<kAffine>();   // [108][kGroupLd]
  int* first = reinterpret_cast<int*>(res + 108 * kGroupLd);   // [kWin + 1]
  int* occ = first + kWin + 1;               // [kGroup], occ[kGroup] = count

  // 1. the stable rank: warp w ranks the sub-span [ws, we), by cell and by
  // group of cells
  for (int k = tid; k < kWarps * (kWin + kGroups); k += kWin) hist[k] = 0;
  for (int k = tid; k < 108 * kGroupLd; k += kWin) res[k] = 0.f;
  __syncthreads();
  const int len = (e - s + kWarps - 1) / kWarps;
  const int ws = min(e, s + warp * len), we = min(e, ws + len);
  int* h = hist + warp * kWin;
  int* gh = ghist + warp * kGroups;
  const unsigned below = (1u << lane) - 1u;
  for (int p0 = ws; p0 < we; p0 += 32) {
    const int p = p0 + lane;
    int id = -1;      // ids outside the window are skipped
    if (p < we) {
      const long long d = flat[p] - cell0;
      if (d >= 0 && d < kWin) id = (int)d;
    }
    const int gid = id >= 0 ? id / kGroup : -1;
    const unsigned peers = __match_any_sync(0xffffffffu, id);
    const unsigned gpeers = __match_any_sync(0xffffffffu, gid);
    if (id >= 0 && (peers & below) == 0u) h[id] += __popc(peers);
    if (id >= 0 && (gpeers & below) == 0u) gh[gid] += __popc(gpeers);
    __syncwarp();
  }
  __syncthreads();
  // cell tid: each warp's first slot relative to the cell's, then the
  // window's; lane 0 of warp g does the same for group g, whose first slot
  // is its first cell's
  int cnt = 0;
  for (int w = 0; w < kWarps; ++w) {
    const int t = hist[w * kWin + tid];
    hist[w * kWin + tid] = cnt;
    cnt += t;
  }
  if (lane == 0) {
    int gcnt = 0;
    for (int w = 0; w < kWarps; ++w) {
      const int t = ghist[w * kGroups + warp];
      ghist[w * kGroups + warp] = gcnt;
      gcnt += t;
    }
  }
  int incl = cnt;     // exclusive scan of the counts over the window's cells
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += v;
  }
  if (lane == 31) warp_total[warp] = incl;
  __syncthreads();
  int before = 0;
  for (int k = 0; k < warp; ++k) before += warp_total[k];
  const int f = before + incl - cnt;
  first[tid] = f;
  if (tid == kWin - 1) first[kWin] = f + cnt;
  for (int w = 0; w < kWarps; ++w) hist[w * kWin + tid] += f;
  if (lane == 0)
    for (int w = 0; w < kWarps; ++w) ghist[w * kGroups + warp] += f;
  __syncthreads();
  for (int p0 = ws; p0 < we; p0 += 32) {
    const int p = p0 + lane;
    int id = -1;
    if (p < we) {
      const long long d = flat[p] - cell0;
      if (d >= 0 && d < kWin) id = (int)d;
    }
    const int gid = id >= 0 ? id / kGroup : -1;
    const unsigned peers = __match_any_sync(0xffffffffu, id);
    const unsigned gpeers = __match_any_sync(0xffffffffu, gid);
    if (id >= 0) {
      const int pos = h[id] + __popc(peers & below);
      sorted[s + pos] = p;
      garr[s + gh[gid] + __popc(gpeers & below)] = p;
      rank[p] = pos;
    }
    __syncwarp();
    if (id >= 0 && (peers & below) == 0u) h[id] += __popc(peers);
    if (id >= 0 && (gpeers & below) == 0u) gh[gid] += __popc(gpeers);
    __syncwarp();
  }
  __syncthreads();

  // 2-3. the sums of each group of kGroup cells, then its output block
  for (int g0 = 0; g0 < kWin; g0 += kGroup) {
    if (warp == 0) {
      const bool has = first[g0 + lane + 1] > first[g0 + lane];
      const unsigned b = __ballot_sync(0xffffffffu, has);
      if (has) occ[__popc(b & below)] = lane;
      if (lane == 0) occ[kGroup] = __popc(b);
    }
    const int q_end = first[g0 + kGroup];
    // a group that fits one stage loads its particles in array order (its
    // reads of w27t, v and C coalesce) into their sorted slots
    const bool whole = q_end - first[g0] <= kStage;
    for (int q0 = first[g0]; q0 < q_end; q0 += kStage) {
      const int nq = min(kStage, q_end - q0);
      if (tid < nq) {
        long long p;
        int slot;
        if (whole) {
          p = garr[s + q0 + tid];
          slot = rank[p] - q0;
        } else {
          p = sorted[s + q0 + tid];
          slot = tid;
        }
        for (int o = 0; o < 27; ++o)
          sw[o * kStageLd + slot] = w27t[o * np + p];
        sv[slot] = vel[3 * p];
        sv[kStage + slot] = vel[3 * p + 1];
        sv[2 * kStage + slot] = vel[3 * p + 2];
        if (kAffine) {
#pragma unroll
          for (int k = 0; k < 9; ++k) sc[k * kStage + slot] = aff[9 * p + k];
        }
      }
      __syncthreads();
      const int items = occ[kGroup] * 27;
      for (int it = tid; it < items; it += kWin) {
        const int c = occ[it / 27], o = it % 27;
        const int lo = max(first[g0 + c], q0) - q0;
        const int hi = min(first[g0 + c + 1], q0 + nq) - q0;
        if (lo >= hi) continue;
        const float fx = (float)(o / 9 - 1);
        const float fy = (float)((o / 3) % 3 - 1);
        const float fz = (float)(o % 3 - 1);
        const float* wo = sw + o * kStageLd;
        float* rc = res + 4 * o * kGroupLd + c;
        float a0 = rc[0], a1 = rc[kGroupLd], a2 = rc[2 * kGroupLd],
              a3 = rc[3 * kGroupLd];
        for (int q = lo; q < hi; ++q) {
          const float w = wo[q];
          float v0 = sv[q];
          float v1 = sv[kStage + q];
          float v2 = sv[2 * kStage + q];
          if (kAffine) {
            const float* cq = sc + q;
            v0 = v0 + cq[0] * fx + cq[kStage] * fy + cq[2 * kStage] * fz;
            v1 = v1 + cq[3 * kStage] * fx + cq[4 * kStage] * fy +
                 cq[5 * kStage] * fz;
            v2 = v2 + cq[6 * kStage] * fx + cq[7 * kStage] * fy +
                 cq[8 * kStage] * fz;
          }
          a0 += w;
          a1 += w * v0;
          a2 += w * v1;
          a3 += w * v2;
        }
        rc[0] = a0;
        rc[kGroupLd] = a1;
        rc[2 * kGroupLd] = a2;
        rc[3 * kGroupLd] = a3;
      }
      __syncthreads();
    }
    for (int k = tid; k < 108 * kGroup; k += kWin) {
      const int r = k / kGroup, c = k % kGroup;
      float* rp = res + r * kGroupLd + c;
      if (g0 + c < ncw) out[r * ncell + cell0 + g0 + c] = *rp;
      *rp = 0.f;
    }
    __syncthreads();
  }
}

// ---- K9a, K9b: the span kernels, on particles fully sorted by cell -------

constexpr int kSpanCells = 128;             // cells of a K9a tile
constexpr int kSpanPitch = kSpanCells + 1;  // row stride of its running sums

// Particles a K9a block stages at a time: as many as let 3 blocks share an
// SM's 228 KB.  Shared memory: the (108, kSpanPitch) running sums, the 27
// weight rows of the stage, its v (and C) rows and ids, and each of its
// cells' run [first, last) in the stage.
template <bool kAffine>
__host__ __device__ constexpr int span_stage() {
  return kAffine ? 112 : 128;
}
template <bool kAffine>
__host__ __device__ constexpr int span_smem_bytes() {
  return 4 * (108 * kSpanPitch + 27 * (span_stage<kAffine>() + 1) +
              (kAffine ? 13 : 4) * span_stage<kAffine>() + 2 * kSpanCells);
}

// K9a's plan: tile_start[t], the first p with flat[p] >= min(t kSpanCells,
// ncell), by a binary search per tile edge (t = 0 .. ntiles), and the order
// check: flag = 1 when an id lies outside [0, ncell) or below its
// predecessor, each block's threads striding over all ids.  On any order
// every start lies in [0, np].
__global__ void __launch_bounds__(kThreads)
    span_plan_kernel(const int* __restrict__ flat, long long np,
                     int* __restrict__ tile_start, long long ncell,
                     long long ntiles, int* __restrict__ flag) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t <= ntiles)
    tile_start[t] = (int)first_at_least(flat, np, min(t * kSpanCells, ncell));
  bool bad = false;
  for (long long p = t; p < np; p += (long long)gridDim.x * kThreads) {
    const int f = flat[p];
    bad |= f < 0 || f >= ncell || (p > 0 && flat[p - 1] > f);
  }
  if (__syncthreads_or(bad) && threadIdx.x == 0) *flag = 1;
}

// The zeros of K9a's empty tiles: block (b, y) writes rows 4y .. 4y + 3 of
// tile b, a warp per 512 B row segment.
__global__ void __launch_bounds__(128)
    zero_empty_tiles_kernel(const int* __restrict__ tile_start,
                            float* __restrict__ out, long long ncell) {
  const int lo = tile_start[blockIdx.x];
  if (max(lo, tile_start[blockIdx.x + 1]) != lo) return;
  const long long c0 = (long long)blockIdx.x * kSpanCells;
  const int cells = (int)min((long long)kSpanCells, ncell - c0);
  const int r = 4 * blockIdx.y + (threadIdx.x >> 5);
  zero_segment(out + r * ncell + c0, cells, threadIdx.x & 31, 32);
}

// A thread's share of one K9a stage, held in registers from its loads
// until the block stores it: weight rows o0, o0 + kRowsAtOnce, ... at
// particle qt, and v (and C) floats i, i + kThreads, ... of the stage's
// contiguous runs, and the id of particle i (i < kS <= kThreads).
template <bool kAffine>
struct SpanShare {
  static constexpr int kS = span_stage<kAffine>();
  static constexpr int kRowsAtOnce = kThreads / kS;
  static constexpr int kW = (27 + kRowsAtOnce - 1) / kRowsAtOnce;
  static constexpr int kV = (3 * kS + kThreads - 1) / kThreads;
  static constexpr int kC = kAffine ? (9 * kS + kThreads - 1) / kThreads : 0;
  float w[kW], v[kV], c[kC > 0 ? kC : 1];
  int id;

  // issue every load of the stage [q0, q0 + nq) before any is used
  __device__ __forceinline__ void load(const float* __restrict__ w27t,
                                       const float* __restrict__ vel,
                                       const float* __restrict__ aff,
                                       const int* __restrict__ flat,
                                       long long np, int q0, int nq) {
    const int t = threadIdx.x, o0 = t / kS, qt = t % kS;
    const bool lane_ok = t < kRowsAtOnce * kS && qt < nq;
#pragma unroll
    for (int k = 0; k < kW; ++k) {
      const int o = o0 + k * kRowsAtOnce;
      w[k] = lane_ok && o < 27 ? w27t[o * np + q0 + qt] : 0.f;
    }
#pragma unroll
    for (int k = 0; k < kV; ++k) {
      const int i = t + k * kThreads;
      v[k] = i < 3 * nq ? vel[3LL * q0 + i] : 0.f;
    }
#pragma unroll
    for (int k = 0; k < kC; ++k) {
      const int i = t + k * kThreads;
      c[k] = i < 9 * nq ? aff[9LL * q0 + i] : 0.f;
    }
    id = t < nq ? flat[q0 + t] : 0;
  }

  __device__ __forceinline__ void store(float* sw, float* sv, float* sc,
                                        int* sid, int nq) const {
    const int t = threadIdx.x, o0 = t / kS, qt = t % kS;
    if (t < kRowsAtOnce * kS && qt < nq)
#pragma unroll
      for (int k = 0; k < kW; ++k)
        if (o0 + k * kRowsAtOnce < 27)
          sw[(o0 + k * kRowsAtOnce) * (kS + 1) + qt] = w[k];
#pragma unroll
    for (int k = 0; k < kV; ++k)
      if (t + k * kThreads < 3 * nq) sv[t + k * kThreads] = v[k];
#pragma unroll
    for (int k = 0; k < kC; ++k)
      if (t + k * kThreads < 9 * nq) sc[t + k * kThreads] = c[k];
    if (t < nq) sid[t] = id;
  }
};

// Sum one occupied tile [lo, hi) of K9a into its 108 output row segments.
template <bool kAffine>
__device__ __forceinline__ void sum_span_tile(
    const float* __restrict__ w27t, const float* __restrict__ vel,
    const float* __restrict__ aff, const int* __restrict__ flat,
    float* __restrict__ out, int n, long long np, int tile, int lo, int hi) {
  constexpr int kS = span_stage<kAffine>();
  constexpr int kLd = kS + 1;                  // weight row stride
  const long long ncell = (long long)n * n * n;
  const long long c0 = (long long)tile * kSpanCells;
  const int cells = (int)min((long long)kSpanCells, ncell - c0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  extern __shared__ __align__(16) float smem[];
  float* acc = smem;                           // [108][kSpanPitch]
  float* sw = acc + 108 * kSpanPitch;          // [27][kLd] weights
  float* sv = sw + 27 * kLd;                   // [kS][3] v
  float* sc = sv + 3 * kS;                     // [kS][9] C
  int* sid = reinterpret_cast<int*>(sc + (kAffine ? 9 * kS : 0));  // [kS]
  int* first = sid + kS;                       // [kSpanCells]
  int* last = first + kSpanCells;

  SpanShare<kAffine> share;
  share.load(w27t, vel, aff, flat, np, lo, min(kS, hi - lo));
  for (int i = threadIdx.x; i < 108 * kSpanPitch; i += kThreads) acc[i] = 0.f;
  for (int j = threadIdx.x; j < kSpanCells; j += kThreads)
    first[j] = last[j] = 0;

  for (int q0 = lo; q0 < hi; q0 += kS) {
    const int nq = min(kS, hi - q0);
    share.store(sw, sv, sc, sid, nq);
    __syncthreads();
    // the next stage's loads fly while the block sums this one
    if (q0 + kS < hi)
      share.load(w27t, vel, aff, flat, np, q0 + kS, min(kS, hi - q0 - kS));
    // each cell's run [first, last) in the stage, from the staged ids
    if (threadIdx.x < nq) {
      const int q = threadIdx.x, id = sid[q];
      const long long j = id - c0;
      if (j >= 0 && j < cells) {
        if (q == 0 || sid[q - 1] != id) first[j] = q;
        if (q == nq - 1 || sid[q + 1] != id) last[j] = q + 1;
      }
    }
    __syncthreads();
    // the stage's cells, clamped into the tile; a thread per (cell, offset)
    // adds the cell's staged particles in order onto its 4 running sums.
    // A cell between them that is not in the stage was in no earlier one
    // either (sorted order), so its run is still the empty [0, 0).
    const long long jf = sid[0] - c0, jl = sid[nq - 1] - c0;
    const int j0 = (int)(jf < 0 ? 0 : jf < cells ? jf : cells - 1);
    const int j1 = (int)(jl < 0 ? 0 : jl < cells ? jl : cells - 1);
    const int items = (j1 - j0 + 1) * 27;
    for (int it = threadIdx.x; it < items; it += kThreads) {
      const int j = j0 + it / 27, o = it % 27;
      const int a = first[j], e = min(last[j], nq);
      if (a >= e) continue;
      const float fx = (float)(o / 9 - 1);
      const float fy = (float)((o / 3) % 3 - 1);
      const float fz = (float)(o % 3 - 1);
      const float* wo = sw + o * kLd;
      float* rc = acc + 4 * o * kSpanPitch + j;
      float a0 = rc[0], a1 = rc[kSpanPitch], a2 = rc[2 * kSpanPitch],
            a3 = rc[3 * kSpanPitch];
      for (int q = a; q < e; ++q) {
        const float w = wo[q];
        float v0 = sv[3 * q], v1 = sv[3 * q + 1], v2 = sv[3 * q + 2];
        if (kAffine) {
          const float* cq = sc + 9 * q;
          v0 = v0 + cq[0] * fx + cq[1] * fy + cq[2] * fz;
          v1 = v1 + cq[3] * fx + cq[4] * fy + cq[5] * fz;
          v2 = v2 + cq[6] * fx + cq[7] * fy + cq[8] * fz;
        }
        a0 += w;
        a1 += w * v0;
        a2 += w * v1;
        a3 += w * v2;
      }
      rc[0] = a0;
      rc[kSpanPitch] = a1;
      rc[2 * kSpanPitch] = a2;
      rc[3 * kSpanPitch] = a3;
    }
    __syncthreads();       // every thread is done with the stage
  }

  // a warp per row: one 512 B segment of each of the 108 rows
  for (int r = warp; r < 108; r += kThreads / 32) {
    float* row = out + r * ncell + c0;
    const float* a = acc + r * kSpanPitch;
    for (int j = lane; j < cells; j += 32) row[j] = a[j];
  }
}

// K9a: a block per tile of kSpanCells cells (see the note at the top).
template <bool kAffine>
__global__ void __launch_bounds__(kThreads, 3)
    scatter_spans_kernel(const float* __restrict__ w27t,
                         const float* __restrict__ vel,
                         const float* __restrict__ aff,
                         const int* __restrict__ flat,
                         const int* __restrict__ tile_start,
                         float* __restrict__ out, int n, long long np) {
  // clamped, so that no order makes a block read outside [0, np)
  const int lo = tile_start[blockIdx.x];
  const int hi = max(lo, tile_start[blockIdx.x + 1]);
  if (hi > lo)             // zero_empty_tiles_kernel writes the others
    sum_span_tile<kAffine>(w27t, vel, aff, flat, out, n, np, blockIdx.x, lo,
                           hi);
}

// K9b: a thread per sorted particle (see the note at the top).  A block
// whose ids span at most `cap` cells stages their 108 table rows in shared
// memory first; the others read the table directly, as K7a does.  The
// launcher passes cap = kSpanStageCells as an argument rather than the
// kernel reading the constant: with the bound known at compile time nvcc
// gives the moments kernel 40 registers instead of 48, and in a probe on
// the H100 it ran 9% slower (0.206 against 0.188 ms on the frame-2 FLIP
// state).
constexpr int kSpanStageCells = 32;
template <bool kMom>
__global__ void __launch_bounds__(kThreads)
    gather_spans_kernel(const float* __restrict__ table,
                        const float* __restrict__ w27t,
                        const int* __restrict__ flat, float* __restrict__ out,
                        int* __restrict__ flag, int n, long long np,
                        int cap) {
  extern __shared__ float cols[];              // [108][len] when staged
  const long long ncell = (long long)n * n * n;
  const long long p0 = (long long)blockIdx.x * kThreads;
  const long long p1 = min(p0 + kThreads, np);
  const int f0 = flat[p0];
  const long long len = (long long)flat[p1 - 1] - f0 + 1;
  const bool staged =
      f0 >= 0 && f0 + len <= ncell && len >= 1 && len <= cap;
  const int m = staged ? (int)len : 1;
  if (staged) {            // uniform over the block
    for (int i = threadIdx.x; i < 108 * m; i += kThreads) {
      const int r = i / m;
      cols[i] = __ldg(table + r * ncell + f0 + (i - r * m));
    }
    __syncthreads();
  }
  const long long p = p0 + threadIdx.x;
  if (p >= np) return;
  const int f = flat[p];
  if (f < 0 || f >= ncell || (p > 0 && flat[p - 1] > f)) *flag = 1;
  // an id out of order or outside the box is clamped into the arrays
  if (staged) {
    const int d = min(max(f - f0, 0), m - 1);
    contract_rows<kMom>(StagedColumn{cols + d, m}, w27t, out, f, ncell, p,
                        np);
  } else {
    const int fc = (int)min(max((long long)f, 0LL), ncell - 1);
    contract_rows<kMom>(TableColumn{table}, w27t, out, fc, ncell, p, np);
  }
}

}  // namespace

extern "C" int fs_p2g_scatter(const float* w27t, const float* vel,
                              const int* chunk_first, const int* chunk_cell,
                              const int* chunk_start, float* sums, float* out,
                              int nx, int n, long long np, int nch,
                              void* stream) {
  return chunked_scatter(WvValues{w27t, vel}, chunk_first, chunk_cell,
                         chunk_start, sums, out, nx, n, np, nch,
                         (cudaStream_t)stream);
}

extern "C" int fs_p2g_scatter_affine(const float* w27t, const float* veff,
                                     const float* aff, const int* chunk_first,
                                     const int* chunk_cell,
                                     const int* chunk_start, float* sums,
                                     float* out, int nx, int n, long long np,
                                     int nch, void* stream) {
  return chunked_scatter(AffValues{w27t, veff, aff}, chunk_first, chunk_cell,
                         chunk_start, sums, out, nx, n, np, nch,
                         (cudaStream_t)stream);
}

extern "C" int fs_p2g_scatter_force(const float* gradw, const float* m9,
                                    const int* chunk_first,
                                    const int* chunk_cell,
                                    const int* chunk_start, float* sums,
                                    float* out, int nx, int n, long long np,
                                    int nch, void* stream) {
  return chunked_scatter(ForceValues{gradw, m9}, chunk_first, chunk_cell,
                         chunk_start, sums, out, nx, n, np, nch,
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

// K7a's gathers of the table (27, 4, nx, n, n); count as in dead_row
// (nullptr: every row).
template <bool kMom>
int launch_rows(const float* table, const float* w27t, const int* flat,
                const int* count, float* out, int nx, int n, long long np,
                void* stream) {
  if (np == 0) return 0;
  const unsigned blocks = (unsigned)((np + kThreads - 1) / kThreads);
  const long long ncell = (long long)nx * n * n;
  const TableColumn src{table};
  if (count != nullptr)
    g2p_rows_kernel<kMom, true><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        src, w27t, flat, count, out, ncell, np);
  else
    g2p_rows_kernel<kMom, false><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        src, w27t, flat, count, out, ncell, np);
  return (int)cudaGetLastError();
}

extern "C" int fs_g2p_gather(const float* fm, const float* w27t,
                             const int* flat, const int* count, float* out,
                             int nx, int n, long long np, int* paths,
                             void* stream) {
  if (np == 0) return 0;
  const unsigned tiles = (unsigned)((np + kGatherTile - 1) / kGatherTile);
  const cudaStream_t st = (cudaStream_t)stream;
  if (count != nullptr)
    g2p_gather_kernel<true><<<tiles, kGatherTile, 0, st>>>(
        fm, w27t, flat, count, out, nx, n, np, paths);
  else
    g2p_gather_kernel<false><<<tiles, kGatherTile, 0, st>>>(
        fm, w27t, flat, count, out, nx, n, np, paths);
  return (int)cudaGetLastError();
}

// No path gathers the moments with a live count: a count is refused.
extern "C" int fs_g2p_moments(const float* fm, const float* w27t,
                              const int* flat, const int* count, float* out,
                              int nx, int n, long long np, int* paths,
                              void* stream) {
  if (count != nullptr) return (int)cudaErrorInvalidValue;
  if (np == 0) return 0;
  const unsigned tiles = (unsigned)((np + kGatherTile - 1) / kGatherTile);
  g2p_moments_kernel<<<tiles, kGatherTile, 0, (cudaStream_t)stream>>>(
      fm, w27t, flat, out, nx, n, np, paths);
  return (int)cudaGetLastError();
}

extern "C" int fs_g2p_gather_table(const float* table, const float* w27t,
                                   const int* flat, const int* count,
                                   float* out, int nx, int n, long long np,
                                   void* stream) {
  return launch_rows<false>(table, w27t, flat, count, out, nx, n, np,
                            stream);
}

extern "C" int fs_g2p_moments_table(const float* table, const float* w27t,
                                    const int* flat, const int* count,
                                    float* out, int nx, int n, long long np,
                                    void* stream) {
  return launch_rows<true>(table, w27t, flat, count, out, nx, n, np,
                           stream);
}

extern "C" int fs_g2p_gather_gw(const float* fm, const float* gradw,
                                const int* flat, const int* count, float* out,
                                int nx, int n, long long np, void* stream) {
  if (np == 0) return 0;
  const unsigned blocks = (unsigned)((np + kThreads - 1) / kThreads);
  if (count != nullptr)
    g2p_gather_gw_kernel<true><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        fm, gradw, flat, count, out, nx, n, np);
  else
    g2p_gather_gw_kernel<false><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        fm, gradw, flat, count, out, nx, n, np);
  return (int)cudaGetLastError();
}

template <bool kAffine>
int launch_scatter_base(const float* w27t, const float* vel, const float* aff,
                        const int* flat, const int* wstart, int* scratch,
                        float* out, int n, long long np, cudaStream_t st) {
  constexpr int bytes = base_smem_bytes<kAffine>();
  const cudaError_t rc = cudaFuncSetAttribute(
      p2g_scatter_base_kernel<kAffine>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (rc != cudaSuccess) return (int)rc;
  const long long ncell = (long long)n * n * n;
  const unsigned blocks = (unsigned)((ncell + kWin - 1) / kWin);
  zero_empty_windows_kernel<<<dim3(blocks, 54), 128, 0, st>>>(wstart, out,
                                                                ncell);
  p2g_scatter_base_kernel<kAffine><<<blocks, kWin, bytes, st>>>(
      w27t, vel, aff, flat, wstart, scratch, out, n, np);
  return (int)cudaGetLastError();
}

extern "C" int fs_p2g_scatter_base(const float* w27t, const float* vel,
                                   const float* aff, const int* flat,
                                   const int* wstart, int* scratch, float* out,
                                   int n, long long np, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (aff == nullptr)
    return launch_scatter_base<false>(w27t, vel, nullptr, flat, wstart,
                                      scratch, out, n, np, st);
  return launch_scatter_base<true>(w27t, vel, aff, flat, wstart, scratch, out,
                                   n, np, st);
}

template <bool kAffine>
int launch_scatter_spans(const float* w27t, const float* vel, const float* aff,
                         const int* flat, int* tile_start, int* flag,
                         float* out, int n, long long np, cudaStream_t st) {
  constexpr int bytes = span_smem_bytes<kAffine>();
  cudaError_t err = cudaFuncSetAttribute(
      scatter_spans_kernel<kAffine>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const long long ncell = (long long)n * n * n;
  if (ncell == 0) return 0;
  const long long ntiles = (ncell + kSpanCells - 1) / kSpanCells;
  if (ntiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  // ntiles + 1 searches, and about 8 ids a thread for the check
  const long long edge_blocks = (ntiles + kThreads) / kThreads;
  const long long check_blocks = (np + 8LL * kThreads - 1) / (8LL * kThreads);
  const long long blocks =
      edge_blocks > check_blocks ? edge_blocks : check_blocks;
  span_plan_kernel<<<(unsigned)blocks, kThreads, 0, st>>>(flat, np, tile_start,
                                                          ncell, ntiles, flag);
  zero_empty_tiles_kernel<<<dim3((unsigned)ntiles, 27), 128, 0, st>>>(
      tile_start, out, ncell);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  scatter_spans_kernel<kAffine><<<(unsigned)ntiles, kThreads, bytes, st>>>(
      w27t, vel, aff, flat, tile_start, out, n, np);
  return (int)cudaGetLastError();
}

extern "C" int fs_p2g_scatter_spans(const float* w27t, const float* vel,
                                    const float* aff, const int* flat,
                                    int* tile_start, int* flag, float* out,
                                    int n, long long np, void* stream) {
  // tile_start holds ceil(n^3 / kSpanCells) + 1 ints (transfer_kernels.py)
  const cudaStream_t st = (cudaStream_t)stream;
  if (aff == nullptr)
    return launch_scatter_spans<false>(w27t, vel, nullptr, flat, tile_start,
                                       flag, out, n, np, st);
  return launch_scatter_spans<true>(w27t, vel, aff, flat, tile_start, flag,
                                    out, n, np, st);
}

extern "C" int fs_g2p_gather_spans(const float* table, const float* w27t,
                                   const int* flat, int* flag, float* out,
                                   int n, long long np, int moments,
                                   void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (np == 0) return 0;
  const unsigned blocks = (unsigned)((np + kThreads - 1) / kThreads);
  constexpr int bytes = 108 * 4 * kSpanStageCells;
  if (moments)
    gather_spans_kernel<true><<<blocks, kThreads, bytes, st>>>(
        table, w27t, flat, out, flag, n, np, kSpanStageCells);
  else
    gather_spans_kernel<false><<<blocks, kThreads, bytes, st>>>(
        table, w27t, flat, out, flag, n, np, kSpanStageCells);
  return (int)cudaGetLastError();
}
