// The tile-edge search shared by the pull scatters' plan kernels (K8b in
// rows.cu, K9a in transfer.cu).
#pragma once

// The first p in [0, np) with flat[p] >= key, np if there is none, by
// halving [0, np).  On ids sorted ascending this is where the rows of the
// tile starting at cell `key` begin; on any order the result still lies in
// [0, np], so a tile's range never reaches outside the rows.
__device__ __forceinline__ long long first_at_least(
    const int* __restrict__ flat, long long np, long long key) {
  long long lo = 0, hi = np;
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if ((long long)flat[mid] < key) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}
