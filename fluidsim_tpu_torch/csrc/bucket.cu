// The row move of the window-grouped bucket sort (K5), for Hopper (sm_90a),
// with a plain C interface bound through ctypes
// (fluidsim_tpu_torch/ops/bucket_sort.py).
//
// K5 fs_bucket_move replaces fluidsim_tpu/ops/bucket_sort.py:
//   bucket_by_window (_move_kernel).  The rows of the chunk-sorted arrays
//   (an int32 key column of TC rows and an (NC, TC) f32 channel-major
//   payload) move to their window-grouped places: for each run descriptor
//   (dst, src, cnt), out[dst + i] = in[src + i] for i < cnt.  The descriptors
//   arrive as a per-output-block table tbl (nout, 3, emax) int32: rows dst,
//   src, cnt of the at most emax runs meeting block j, i.e. output rows
//   [j*to, (j+1)*to); dead entries have dst 2^30 and meet no block.  Only
//   output rows below np are written (the rest are the tail padding).
//   Bound on the H100: memory.  Pure data movement: each row's key and NC
//   payload values are read once and written once, (1 + NC) * 8 B per row;
//   ~111 MB at 129^3 / 2M particles with NC = 6.
//   Design: one thread block per output block.  A run is contiguous on both
//   sides, so each run's rows are a contiguous copy: consecutive threads
//   take consecutive rows, and every column (the key and each payload
//   channel) is read and written coalesced.  The TPU kernel's packing of 16
//   particles per 128-lane row and its sub-row rolls were DMA-alignment
//   work that a coalesced copy does not need.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void bucket_move_kernel(const int* __restrict__ key,
                                   const float* __restrict__ pay,
                                   const int* __restrict__ tbl,
                                   int* __restrict__ key_out,
                                   float* __restrict__ cols_out, int nc,
                                   long long tc, long long np, int to,
                                   int emax) {
  const long long base = (long long)blockIdx.x * to;
  const int* t = tbl + (long long)blockIdx.x * 3 * emax;
  for (int e = 0; e < emax; ++e) {
    const long long dst = t[e];
    const long long src = t[emax + e];
    const long long cnt = t[2 * emax + e];
    const long long a = dst > base ? dst - base : 0;
    const long long end = dst + cnt - base < to ? dst + cnt - base : to;
    const long long shift = src - dst;  // output row i reads row i + shift
    for (long long i = base + a + threadIdx.x; i < base + end;
         i += blockDim.x) {
      const long long s = i + shift;
      if (i >= np || s < 0 || s >= tc) break;
      key_out[i] = key[s];
      for (int c = 0; c < nc; ++c) cols_out[c * np + i] = pay[c * tc + s];
    }
  }
}

}  // namespace

extern "C" int fs_bucket_move(const int* key, const float* pay,
                              const int* tbl, int* key_out, float* cols_out,
                              int nc, long long tc, long long np, int nout,
                              int to, int emax, void* stream) {
  if (nout == 0 || np == 0) return 0;
  bucket_move_kernel<<<nout, kThreads, 0, (cudaStream_t)stream>>>(
      key, pay, tbl, key_out, cols_out, nc, tc, np, to, emax);
  return (int)cudaGetLastError();
}
