// Row-layout transfer kernels (K8a, K8b), for Hopper (sm_90a), with a plain
// C interface bound through ctypes (fluidsim_tpu_torch/ops/rows.py).
//
// Particle rows are (P_pad, 128) f32, one 512 B row per sorted particle;
// the grid side is channel-major (128, ncells) f32, cells on the minor
// axis.  flat (P,) int32 holds the cell id of rows 0..P-1, sorted
// ascending.  Offsets are 64-bit: 128 x ncells passes 2^31 at 255^3.
// Rows whose id lies outside [0, ncells) are skipped (the wrapper raises on
// them), so no id makes a kernel read or write out of range.
//
// K8a fs_gather_rows_cm replaces fluidsim_tpu/ops/pallas_transfer.py:
//   gather_rows_cm (_gather_kernel).
//   out[p, c] = table[c, flat[p]] for p < P on all 128 lanes, and
//   out[p, :] = init[p, :] for P <= p < P_pad.
//   Bound on the H100: memory.  Writing the rows is most of the compulsory
//   traffic (1,017.7 MB at 129^3 / 1,987,675 particles); with the ids, the
//   tail rows and one 512 B table column per distinct cell ~1.07 GB,
//   ~0.32 ms at 3.35 TB/s.
//   Design: one block per tile of 32 rows x 128 lanes, through shared
//   memory with a row pitch of 33 words (no bank conflicts either way).  The
//   block reads the tile with lanes over rows: a warp loads
//   table[c, flat[p0 .. p0+31]], and sorted neighbours share a cell or sit
//   in adjacent ones, so its loads fall on one or two lines.  It writes
//   the tile with lanes over channels: a warp stores 128 contiguous bytes
//   of one row.  The tail rows are copied row by row in the same store.
//
// K8b fs_scatter_rows_cm replaces fluidsim_tpu/ops/pallas_transfer.py:332
//   scatter_rows_cm (_scatter_kernel, l.263).
//   out[c, i] = sum_{p < P : flat[p] = i} u[p, c] on all 128 lanes, 0 for a
//   cell with no row.
//   Bound on the H100: memory.  It reads the rows (1,017.7 MB) and ids
//   and writes 128 x ncells x 4 B (1,099.1 MB at 129^3): ~2.12 GB,
//   ~0.63 ms at 3.35 TB/s.
//   Design: a deterministic pull with no float atomics, so reruns are bit
//   identical, over tiles of kScatterCells = 128 cells, so that each
//   channel's output segment of a tile is 512 contiguous bytes.  A light
//   first kernel finds each tile's row range [lo, hi) by a binary search
//   of the sorted ids per tile edge (ncells / 128 + 1 searches).  Then one
//   256-thread block per tile:
//   - an empty tile (lo == hi) writes its zeros and nothing else;
//   - an occupied tile's rows are one contiguous span of (hi - lo) x 512 B,
//     streamed into shared memory with 1-D bulk asynchronous copies
//     (cp.async.bulk, completing on an mbarrier) in kStages buffers of
//     kStageRows rows, each buffer refilled as soon as the block has
//     summed it.  Each cell's row range inside the tile comes from the
//     tile's ids.  A warp per cell sums the cell's rows of a stage out of
//     shared memory in array order, lane l holding channels 4l..4l+3, onto
//     the cell's running sum, which starts at +0 and is carried across
//     stages in a (128, 128) block in shared memory;
//   - the block's sums then leave through that block, lanes over cells,
//     so that the channel-major store is one 512 B segment per channel.
//   Each sum adds the same f32 values in the same order as K6a
//   (fs_p2g_scatter_base) on a fully sorted order, so the two agree bit
//   for bit on the 108 w*[1, v] channels.  On an order that is not sorted
//   the result is undefined, but every access stays inside the arrays:
//   the rows a block reads lie in [lo, hi) ⊂ [0, P), and a cell's range is
//   clipped to the stage.
//
// The TPU kernels' one-hot MXU matmuls, split3 bf16 passes, chunk list,
// (T+8)-row read-modify-write windows and f32 ids in lane 127 are not
// needed: the ids come from flat.  Both are copies and f32 sums, built with
// --fmad=false like the other sources.

#include <cuda_runtime.h>

#include "tile_search.cuh"

namespace {

constexpr int kLanes = 128;  // lanes of a row / channels of the table
constexpr int kTile = 32;    // rows per K8a block
constexpr int kWarps = 8;    // warps per block
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kTile * kWarps)
    gather_rows_kernel(const float* __restrict__ table,
                       const float* __restrict__ init,
                       const int* __restrict__ flat, float* __restrict__ out,
                       long long ncells, long long np, long long np_pad) {
  __shared__ float tile[kLanes][kTile + 1];
  const long long p0 = (long long)blockIdx.x * kTile;
  const int tx = threadIdx.x, ty = threadIdx.y;

  // lanes over rows: this thread's row, channels ty, ty + 8, ...
  const long long p = p0 + tx;
  if (p < np) {
    const int id = flat[p];
    const bool ok = id >= 0 && id < ncells;
    for (int c = ty; c < kLanes; c += kWarps)
      tile[c][tx] = ok ? __ldg(table + c * ncells + id) : 0.f;
  }
  __syncthreads();

  // lanes over channels: rows ty, ty + 8, ... of the tile
  for (int i = ty; i < kTile; i += kWarps) {
    const long long q = p0 + i;
    if (q >= np_pad) break;
    float* row = out + q * kLanes;
    if (q < np) {
#pragma unroll
      for (int k = 0; k < kLanes; k += kTile) row[k + tx] = tile[k + tx][i];
    } else {
      const float* src = init + q * kLanes;
#pragma unroll
      for (int k = 0; k < kLanes; k += kTile) row[k + tx] = __ldg(src + k + tx);
    }
  }
}

// K8b: kScatterCells cells a tile, kStages buffers of kStageRows rows.
constexpr int kScatterCells = 128;
constexpr int kStageRows = 32;
constexpr int kStages = 2;
constexpr int kAccPitch = kScatterCells + 1;
constexpr int kRowBytes = kLanes * 4;
constexpr int kStageBytes = kStageRows * kRowBytes;
constexpr int kScatterSmem = kStages * kStageBytes            // row stages
                             + kLanes * kAccPitch * 4           // running sums
                             + 2 * kScatterCells * 4            // cell ranges
                             + kStages * 8;                     // mbarriers

// tile_start[t] = the first p with flat[p] >= min(t * kScatterCells, ncells)
__global__ void tile_starts_kernel(const int* __restrict__ flat, long long np,
                                   int* __restrict__ tile_start,
                                   long long ncells, long long ntiles) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t > ntiles) return;
  const long long key = t * kScatterCells < ncells ? t * kScatterCells : ncells;
  tile_start[t] = (int)first_at_least(flat, np, key);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// Queue the copy of rows [r0, r0 + rows) into a stage buffer; the barrier
// completes when its bytes have landed.
__device__ __forceinline__ void load_stage(float4* dst, const float4* src,
                                           unsigned bytes,
                                           unsigned long long* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void wait_stage(unsigned long long* bar,
                                           unsigned parity) {
  unsigned done = 0;
  while (!done)
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
}

__global__ void __launch_bounds__(kThreads)
    scatter_tiles_kernel(const float4* __restrict__ u,
                         const int* __restrict__ flat,
                         const int* __restrict__ tile_start,
                         float* __restrict__ out, long long ncells) {
  const long long c0 = (long long)blockIdx.x * kScatterCells;
  const int cells = (int)(ncells - c0 < kScatterCells ? ncells - c0
                                                      : kScatterCells);
  const int lo = tile_start[blockIdx.x], hi = tile_start[blockIdx.x + 1];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (hi <= lo) {          // no row: the tile's zeros, one segment a channel
    for (int c = warp; c < kLanes; c += kWarps) {
      float* row = out + c * ncells + c0;
      for (int j = lane; j < cells; j += 32) row[j] = 0.f;
    }
    return;
  }

  extern __shared__ __align__(128) unsigned char smem[];
  float4* stage = reinterpret_cast<float4*>(smem);
  float(*acc)[kAccPitch] =
      reinterpret_cast<float(*)[kAccPitch]>(smem + kStages * kStageBytes);
  int* first = reinterpret_cast<int*>(acc + kLanes);
  int* last = first + kScatterCells;
  unsigned long long* bar =
      reinterpret_cast<unsigned long long*>(last + kScatterCells);

  const int nstage = (hi - lo + kStageRows - 1) / kStageRows;
  if (threadIdx.x == 0) {
    for (int b = 0; b < kStages; ++b)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                   :: "r"(smem_addr(bar + b)) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int s = 0; s < kStages && s < nstage; ++s) {
      const int r0 = lo + s * kStageRows;
      const int rows = hi - r0 < kStageRows ? hi - r0 : kStageRows;
      load_stage(stage + s * (kStageBytes / 16), u + (long long)r0 * 32,
                 rows * kRowBytes, bar + s);
    }
  }
  for (int i = threadIdx.x; i < kLanes * kAccPitch; i += blockDim.x)
    (&acc[0][0])[i] = 0.f;
  for (int j = threadIdx.x; j < kScatterCells; j += blockDim.x)
    first[j] = last[j] = 0;
  __syncthreads();
  // each cell's rows [first, last), from the tile's ids
  for (int p = lo + threadIdx.x; p < hi; p += blockDim.x) {
    const int id = flat[p];
    const long long j = id - c0;
    if (j < 0 || j >= cells) continue;
    if (p == lo || flat[p - 1] != id) first[j] = p;
    if (p == hi - 1 || flat[p + 1] != id) last[j] = p + 1;
  }
  __syncthreads();

  for (int s = 0; s < nstage; ++s) {
    const int b = s % kStages;
    const int r0 = lo + s * kStageRows;
    const int r1 = hi - r0 < kStageRows ? hi : r0 + kStageRows;
    wait_stage(bar + b, (unsigned)(s / kStages) & 1u);
    const float4* rows = stage + b * (kStageBytes / 16);
    // the stage's cells, clamped into the tile
    const long long jf = flat[r0] - c0, jl = flat[r1 - 1] - c0;
    const int j0 = (int)(jf < 0 ? 0 : jf < cells ? jf : cells - 1);
    const int j1 = (int)(jl < 0 ? 0 : jl < cells ? jl : cells - 1);
    for (int j = j0 + warp; j <= j1; j += kWarps) {
      const int a = first[j] > r0 ? first[j] : r0;
      const int e = last[j] < r1 ? last[j] : r1;
      if (a >= e) continue;
      float4 sum = make_float4(acc[4 * lane][j], acc[4 * lane + 1][j],
                               acc[4 * lane + 2][j], acc[4 * lane + 3][j]);
      for (int p = a; p < e; ++p) {
        const float4 v = rows[(p - r0) * 32 + lane];
        sum.x += v.x;
        sum.y += v.y;
        sum.z += v.z;
        sum.w += v.w;
      }
      acc[4 * lane][j] = sum.x;
      acc[4 * lane + 1][j] = sum.y;
      acc[4 * lane + 2][j] = sum.z;
      acc[4 * lane + 3][j] = sum.w;
    }
    __syncthreads();       // every warp is done with buffer b
    if (threadIdx.x == 0 && s + kStages < nstage) {
      const int q0 = r0 + kStages * kStageRows;
      const int rows_q = hi - q0 < kStageRows ? hi - q0 : kStageRows;
      load_stage(stage + b * (kStageBytes / 16), u + (long long)q0 * 32,
                 rows_q * kRowBytes, bar + b);
    }
  }

  // lanes over cells: one 512 B segment of each channel row
  for (int c = warp; c < kLanes; c += kWarps) {
    float* row = out + c * ncells + c0;
    for (int j = lane; j < cells; j += 32) row[j] = acc[c][j];
  }
}

}  // namespace

extern "C" int fs_gather_rows_cm(const float* table, const float* init,
                                 const int* flat, float* out, long long ncells,
                                 long long np, long long np_pad, void* stream) {
  if (np_pad == 0) return 0;
  const long long blocks = (np_pad + kTile - 1) / kTile;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  gather_rows_kernel<<<(unsigned)blocks, dim3(kTile, kWarps), 0,
                       (cudaStream_t)stream>>>(table, init, flat, out, ncells,
                                               np, np_pad);
  return (int)cudaGetLastError();
}

extern "C" int fs_scatter_rows_cm(const float* u, const int* flat,
                                  int* tile_start, float* out,
                                  long long ncells, long long np,
                                  void* stream) {
  // tile_start holds ncells / kScatterCells + 2 ints (ops/rows.py)
  if (ncells == 0) return 0;
  const long long ntiles = (ncells + kScatterCells - 1) / kScatterCells;
  const long long edge_blocks = (ntiles + kThreads) / kThreads;  // ntiles + 1
  if (ntiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      scatter_tiles_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kScatterSmem);
  if (err != cudaSuccess) return (int)err;
  tile_starts_kernel<<<(unsigned)edge_blocks, kThreads, 0,
                       (cudaStream_t)stream>>>(flat, np, tile_start, ncells,
                                               ntiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  scatter_tiles_kernel<<<(unsigned)ntiles, kThreads, kScatterSmem,
                         (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(u), flat, tile_start, out, ncells);
  return (int)cudaGetLastError();
}
