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
//   [j*to, (j+1)*to), in dst order, with the dead entries (dst 2^30, meeting
//   no block) last, as bucket_plan builds it.  Only output rows below np are
//   written (the rest are the tail padding).
//   Bound on the H100: memory.  Pure data movement: each row's key and NC
//   payload values are read once and written once, (1 + NC) * 8 B per row;
//   ~111 MB at 129^3 / 2M particles with NC = 6.
//   Design: one thread per output row.  A thread block covers kThreads rows
//   of one output block and stages that block's (dst, src, cnt) table in
//   shared memory once; each thread finds its row's run by a binary search
//   on dst (the last entry with dst <= row) and copies the key and the NC
//   payload values from row + (src - dst).  A warp's 32 rows are
//   consecutive outputs, nearly always of one run, so both its reads and
//   its writes coalesce, and no thread waits on another's run.  The
//   search costs log2(emax) shared-memory reads.  The TPU kernel's packing
//   of 16 particles per 128-lane row and its sub-row rolls were
//   DMA-alignment work that a coalesced copy does not need.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    bucket_move_kernel(const int* __restrict__ key,
                       const float* __restrict__ pay,
                       const int* __restrict__ tbl, int* __restrict__ key_out,
                       float* __restrict__ cols_out, int nc, long long tc,
                       long long np, int to, int emax) {
  extern __shared__ int run[];  // dst[emax], src[emax], cnt[emax]
  const int* t = tbl + (long long)blockIdx.x * 3 * emax;
  for (int k = threadIdx.x; k < 3 * emax; k += blockDim.x) run[k] = t[k];
  __syncthreads();
  const int r = blockIdx.y * kThreads + threadIdx.x;  // row in the block
  const long long i = (long long)blockIdx.x * to + r;
  if (r >= to || i >= np) return;
  int lo = 0, hi = emax;  // the first entry with dst > i
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (run[mid] <= i) lo = mid + 1;
    else hi = mid;
  }
  if (lo == 0) return;
  const long long dst = run[lo - 1];
  if (i >= dst + run[2 * emax + lo - 1]) return;
  const long long s = i + (run[emax + lo - 1] - dst);
  if (s < 0 || s >= tc) return;
  key_out[i] = key[s];
  for (int c = 0; c < nc; ++c) cols_out[c * np + i] = pay[c * tc + s];
}

}  // namespace

extern "C" int fs_bucket_move(const int* key, const float* pay,
                              const int* tbl, int* key_out, float* cols_out,
                              int nc, long long tc, long long np, int nout,
                              int to, int emax, void* stream) {
  if (nout == 0 || np == 0) return 0;
  const dim3 grid(nout, (to + kThreads - 1) / kThreads);
  bucket_move_kernel<<<grid, kThreads, 3 * emax * sizeof(int),
                       (cudaStream_t)stream>>>(key, pay, tbl, key_out,
                                               cols_out, nc, tc, np, to, emax);
  return (int)cudaGetLastError();
}
