// Layout kernel of the unhaloed shift entry points (K10c, K10d), for Hopper
// (sm_90a), with a plain C interface bound through ctypes
// (fluidsim_tpu_torch/ops/shift.py).
//
// fs_transpose_pad replaces fluidsim_tpu/ops/pallas_shift.py:
//   to_channel_major and from_channel_major (_t_kernel), the tiled
//   transposes between the (n^3, C) row layout and the (C, n3p) channel-major
//   one.  It writes out[c, r] = in[r, c] of an f32 (R, C) matrix whose rows
//   are ld apart into a (C, Rp) matrix, Rp >= R, with out[c, r] = 0 for
//   R <= r < Rp.  to_channel_major is (n3, C) -> (C, n3p) with ld = C;
//   from_channel_major reads the first n3 columns of a (C, n3p) matrix
//   (R = C, C = n3, ld = n3p) into (n3, C) with Rp = R.
//   Bound on the H100: memory.  Each input value read once and each output
//   value written once: at 129^3 with C = 108, 927 MB each way (~0.55 ms at
//   3.35 TB/s).
//   Design: a 32 x 32 tile through shared memory per block, 32 x 8 threads.
//   The block reads its tile row by row (a warp on 32 consecutive columns of
//   one input row) and writes it column by column (a warp on 32 consecutive
//   entries of one output row), so both sides are coalesced; the tile's row
//   pitch of 33 words keeps the column reads free of bank conflicts.  Tiles
//   are numbered on a 1-D grid, because the longer side (n^3 / 32 ~ 67,000
//   tiles at 129^3) may exceed the 65,535 blocks of a grid's y dimension.
//   The TPU kernel's (2048, C) VMEM blocks, which set its padding, are not
//   needed: a caller pads only to match the JAX shapes.
//
// A copy: the output equals the plain version's bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 32;
constexpr int kRows = 8;     // threads per tile column; each copies 4 rows

__global__ void __launch_bounds__(kTile * kRows)
    transpose_pad_kernel(const float* __restrict__ in, float* __restrict__ out,
                         long long rows, long long cols, long long ld,
                         long long rows_pad, long long row_tiles) {
  __shared__ float tile[kTile][kTile + 1];
  const long long r0 = (long long)(blockIdx.x % row_tiles) * kTile;
  const long long c0 = (long long)(blockIdx.x / row_tiles) * kTile;
  const int tx = threadIdx.x, ty = threadIdx.y;
  for (int i = ty; i < kTile; i += kRows) {
    const long long r = r0 + i, c = c0 + tx;
    tile[i][tx] = (r < rows && c < cols) ? in[r * ld + c] : 0.f;
  }
  __syncthreads();
  for (int i = ty; i < kTile; i += kRows) {
    const long long c = c0 + i, r = r0 + tx;
    if (c < cols && r < rows_pad) out[c * rows_pad + r] = tile[tx][i];
  }
}

}  // namespace

extern "C" int fs_transpose_pad(const float* in, float* out, long long rows,
                                long long cols, long long ld,
                                long long rows_pad, void* stream) {
  if (cols == 0 || rows_pad == 0) return 0;
  const long long row_tiles = (rows_pad + kTile - 1) / kTile;
  const long long tiles = row_tiles * ((cols + kTile - 1) / kTile);
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  transpose_pad_kernel<<<(unsigned)tiles, dim3(kTile, kRows), 0,
                         (cudaStream_t)stream>>>(in, out, rows, cols, ld,
                                                 rows_pad, row_tiles);
  return (int)cudaGetLastError();
}
