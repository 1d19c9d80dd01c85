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
// K8b fs_scatter_rows_cm replaces fluidsim_tpu/ops/pallas_transfer.py:
//   scatter_rows_cm (_scatter_kernel).
//   out[c, i] = sum_{p < P : flat[p] = i} u[p, c] on all 128 lanes, 0 for a
//   cell with no row.
//   Bound on the H100: memory.  It reads the rows (1,017.7 MB) and ids
//   and writes 128 x ncells x 4 B (1,099.1 MB at 129^3): ~2.12 GB,
//   ~0.63 ms at 3.35 TB/s.
//   Design: a deterministic pull with no float atomics, so reruns are bit
//   identical.  A first kernel finds each cell's first row, a binary search
//   of the sorted ids per edge (ncells + 1 edges, as
//   transfer_kernels.cell_starts).  Then a block of 32 cells loads their
//   row ranges at once, and one warp per cell sums its rows
//   [start_i, start_{i+1}) in array order from +0, lane l holding channels
//   4l..4l+3 and reading each 512 B row as one float4 per lane; the
//   block's sums go through shared memory so that the channel-major store
//   runs lanes over cells.  Each sum adds the same f32 values in the same order
//   as K6a (fs_p2g_scatter_base) on a fully sorted order, so the two agree
//   bit for bit on the 108 w*[1, v] channels.
//
// The TPU kernels' one-hot MXU matmuls, split3 bf16 passes, chunk list,
// (T+8)-row read-modify-write windows and f32 ids in lane 127 are not
// needed: the ids come from flat.  Both are copies and f32 sums, built with
// --fmad=false like the other sources.

#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 128;  // lanes of a row / channels of the table
constexpr int kTile = 32;    // rows (K8a) or cells (K8b) per block
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

// starts[i] = the first p with flat[p] >= i, for i = 0 .. ncells
__global__ void cell_starts_kernel(const int* __restrict__ flat, long long np,
                                   int* __restrict__ starts,
                                   long long ncells) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i > ncells) return;
  long long lo = 0, hi = np;
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if ((long long)flat[mid] < i) lo = mid + 1;
    else hi = mid;
  }
  starts[i] = (int)lo;
}

__global__ void __launch_bounds__(kTile * kWarps)
    scatter_rows_kernel(const float4* __restrict__ u,
                        const int* __restrict__ starts,
                        float* __restrict__ out, long long ncells) {
  __shared__ float tile[kLanes][kTile + 1];
  __shared__ int first[kTile + 1];
  const long long c0 = (long long)blockIdx.x * kTile;
  const int lane = threadIdx.x, warp = threadIdx.y;

  // the row ranges of the block's cells, in one load
  const int t = warp * kTile + lane;
  if (t <= kTile && c0 + t <= ncells) first[t] = starts[c0 + t];
  __syncthreads();

  // one warp per cell: lane l sums channels 4l .. 4l+3 over the cell's rows
  // (unrolled, so that several rows are in flight; the adds stay in order)
  for (int j = warp; j < kTile; j += kWarps) {
    const long long cell = c0 + j;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    if (cell < ncells) {
      const int s = first[j], e = first[j + 1];
#pragma unroll 4
      for (int p = s; p < e; ++p) {
        const float4 v = __ldg(u + (long long)p * (kLanes / 4) + lane);
        acc.x += v.x;
        acc.y += v.y;
        acc.z += v.z;
        acc.w += v.w;
      }
    }
    tile[4 * lane][j] = acc.x;
    tile[4 * lane + 1][j] = acc.y;
    tile[4 * lane + 2][j] = acc.z;
    tile[4 * lane + 3][j] = acc.w;
  }
  __syncthreads();

  // lanes over cells: channels warp, warp + 8, ... of the block's 32 cells
  const long long cell = c0 + lane;
  if (cell < ncells)
    for (int c = warp; c < kLanes; c += kWarps)
      out[c * ncells + cell] = tile[c][lane];
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

extern "C" int fs_scatter_rows_cm(const float* u, const int* flat, int* starts,
                                  float* out, long long ncells, long long np,
                                  void* stream) {
  if (ncells == 0) return 0;
  const long long edge_blocks = (ncells + kThreads) / kThreads;  // ncells + 1 edges
  const long long blocks = (ncells + kTile - 1) / kTile;
  if (edge_blocks > 0x7fffffffLL || blocks > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cell_starts_kernel<<<(unsigned)edge_blocks, kThreads, 0,
                       (cudaStream_t)stream>>>(flat, np, starts, ncells);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  scatter_rows_kernel<<<(unsigned)blocks, dim3(kTile, kWarps), 0,
                        (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(u), starts, out, ncells);
  return (int)cudaGetLastError();
}
