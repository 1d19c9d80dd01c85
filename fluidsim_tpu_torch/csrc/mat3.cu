// The MPM frame's batched 3x3 chain, for Hopper (sm_90a), with a plain C
// interface bound through ctypes (fluidsim_tpu_torch/ops/svd3.py).
//
// These replace no TPU kernel: the JAX package runs this chain as plain jnp
// (fluidsim_tpu/ops/svd3.py), which XLA fuses on the TPU.  In PyTorch's
// eager form each entry of each 3x3 matrix is its own (P,) tensor in device
// memory, a strided slice or a stack per operation, some 500 launches an
// implicit apply: 84% of a 255^3 frame.  Here one thread per particle keeps
// the whole chain in registers.
//
// Each routine below is svd3.py's, line for line: the same f32 operations
// in the same order (a + b + c is (a + b) + c, as there), built with the
// library's --fmad=false, IEEE division and IEEE sqrt, so a kernel equals
// the plain chain on the card bit for bit.  Comparisons and selections are
// theirs too: torch.where's fallbacks, clamp's NaN pass-through
// (x != x ? x : fminf(fmaxf(x, lo), hi)), argmin's first index on ties with
// NaN as the least, 1.0 / x as PyTorch computes it (reciprocal, then * 1),
// and the Python literals 1e-20, 1e-12 and 1e-30 rounded from double to
// float as PyTorch rounds a scalar operand.
//
// Matrices are row-major.  A (P, 3, 3) operand is read through its element
// strides (s0, s1, s2), so a transposed view, a slice of the sort's
// payload or a view of (9, P) rows is read in place; every output is
// contiguous.
//
// fs_polar_stress (piola_linearized): from FE, mu, lam: the SVD of FE
//   (Jacobi on FE^T FE, 5 sweeps), R = U V^T, S = V diag(s) V^T, J = det FE,
//   cof = cofactor(FE) and P0 = 2 mu (FE - R) + lam (J - 1) cof.  Writes
//   P0 (P, 3, 3) and what an apply reads of the factors, fac (25, P)
//   (svd3.FACTOR_ROWS): rows 0-8 R, 9-14 the six entries of S that
//   polar_delta reads (00, 01, 02, 11, 12, 22), 15-23 cof, 24 J.
//   Bound on the H100: arithmetic.  About 1,300 f32 operations a particle
//   (the plain chain's count, chip_smoke.py); 180 B read and written.
// fs_stress_apply (StressDifferential.apply): m9 = scale (dP(g FE) FE^T),
//   (P, 9), with g[c][k] = g9[3c + k][p] read from K2 gw's (9, P) output,
//   dP the full corotated differential or its SPD part (template flag).
//   Bound on the H100: memory.  g, FE, R, six of S, cof, J, mu, lam and the
//   scale read, m9 written: 220 B a particle ("full"), 0.26 ms at 255^3.
// fs_clamp_singular (clamp_singular): from F, the SVD, s clamped to
//   [lo, hi], U clamp(s) V^T and V clamp(s)^-1 U^T.  Bound: arithmetic.
// fs_mm3 (mm3): C = A B, each operand through its strides.  Bound: memory,
//   108 B a particle.
//
// Design: a thread per particle, 128 threads a block, every matrix in
// registers, the loops over entries unrolled at compile time.  The (P, 3,
// 3) operands whose rows are nine consecutive floats, and the outputs,
// pass through shared memory, so that a warp's loads and stores fall on
// consecutive floats (read in place, a thread's nine loads 36 B apart
// touched 32 sectors each: on an H100 at 255^3 the apply ran at 61% of its
// byte bound, mm3 at 37%); the (9, P) and (25, P) rows are read and
// written in place, already consecutive across a warp.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

struct Strides {
  long long s0, s1, s2;
};

// A block's rows: thread t's particle is row p0 + t, for t < rows.
struct Block {
  long long p0;
  int rows;
};

__device__ __forceinline__ Block block_of(long long np) {
  const long long p0 = (long long)blockIdx.x * kThreads;
  return Block{p0, (int)(np - p0 < kThreads ? np - p0 : kThreads)};
}

// Each thread's matrix of a (P, 3, 3) operand, read by the whole block.
// Where a row's nine entries are nine consecutive floats (strides {3, 1} or
// {1, 3} inside a row: a contiguous operand, its transposed view, a slice of
// a wider row), the block copies its rows to shared memory ``sm``
// (kThreads x 9 floats), consecutive threads on consecutive floats, and
// each thread reads its own row there (a stride of 9 words: no bank
// conflict).  Any other layout is read in place: the frame's (I + dt gradV)
// keeps the layout of K2 gw's (9, P) rows, in which rows p and p + 1 lie
// next to each other already.
__device__ __forceinline__ void load_rows(const float* __restrict__ a,
                                          Strides st, Block b,
                                          float* __restrict__ sm,
                                          float m[3][3]) {
  const int t = threadIdx.x;
  if ((st.s1 == 3 && st.s2 == 1) || (st.s1 == 1 && st.s2 == 3)) {
    for (int i = t; i < b.rows * 9; i += kThreads) {
      const int r = i / 9;
      sm[i] = a[(b.p0 + r) * st.s0 + (i - 9 * r)];
    }
    __syncthreads();
    if (t < b.rows) {
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int j = 0; j < 3; ++j)
          m[i][j] = sm[9 * t + i * (int)st.s1 + j * (int)st.s2];
    }
  } else if (t < b.rows) {
    const float* row = a + (b.p0 + t) * st.s0;
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) m[i][j] = row[i * st.s1 + j * st.s2];
  }
}

// Each thread's matrix as its row of a contiguous (P, 9) output, through
// shared memory ``sm``: a thread writes only its own row of ``sm`` (the
// one it read an operand from, if any), and the block stores the rows with
// consecutive threads on consecutive floats.
__device__ __forceinline__ void store_rows(float* __restrict__ out, Block b,
                                           float* __restrict__ sm,
                                           const float m[3][3]) {
  const int t = threadIdx.x;
  if (t < b.rows) {
#pragma unroll
    for (int e = 0; e < 9; ++e) sm[9 * t + e] = m[e / 3][e % 3];
  }
  __syncthreads();
  for (int i = t; i < b.rows * 9; i += kThreads) out[b.p0 * 9 + i] = sm[i];
}

// ---- svd3.py's helpers --------------------------------------------------

// mm3: c[i][j] = a[i][0] b[0][j] + a[i][1] b[1][j] + a[i][2] b[2][j]
__device__ __forceinline__ void mm3(const float a[3][3], const float b[3][3],
                                    float c[3][3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      c[i][j] = a[i][0] * b[0][j] + a[i][1] * b[1][j] + a[i][2] * b[2][j];
}

__device__ __forceinline__ float det3(const float f[3][3]) {
  return f[0][0] * (f[1][1] * f[2][2] - f[1][2] * f[2][1]) -
         f[0][1] * (f[1][0] * f[2][2] - f[1][2] * f[2][0]) +
         f[0][2] * (f[1][0] * f[2][1] - f[1][1] * f[2][0]);
}

__device__ __forceinline__ void cofactor3(const float f[3][3],
                                          float c[3][3]) {
  c[0][0] = f[1][1] * f[2][2] - f[1][2] * f[2][1];
  c[0][1] = f[1][2] * f[2][0] - f[1][0] * f[2][2];
  c[0][2] = f[1][0] * f[2][1] - f[1][1] * f[2][0];
  c[1][0] = f[0][2] * f[2][1] - f[0][1] * f[2][2];
  c[1][1] = f[0][0] * f[2][2] - f[0][2] * f[2][0];
  c[1][2] = f[0][1] * f[2][0] - f[0][0] * f[2][1];
  c[2][0] = f[0][1] * f[1][2] - f[0][2] * f[1][1];
  c[2][1] = f[0][2] * f[1][0] - f[0][0] * f[1][2];
  c[2][2] = f[0][0] * f[1][1] - f[0][1] * f[1][0];
}

// PyTorch's clamp_min / clamp of a scalar bound: NaN passes through
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return x != x ? x : fmaxf(x, lo);
}

__device__ __forceinline__ float clamp(float x, float lo, float hi) {
  return x != x ? x : fminf(fmaxf(x, lo), hi);
}

// ``1.0 / x`` of a tensor: x.reciprocal() * 1.0
__device__ __forceinline__ float rdiv1(float x) { return (1.0f / x) * 1.0f; }

__device__ __forceinline__ float dot3(const float a[3], const float b[3]) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

__device__ __forceinline__ void cross3(const float a[3], const float b[3],
                                       float c[3]) {
  c[0] = a[1] * b[2] - a[2] * b[1];
  c[1] = a[2] * b[0] - a[0] * b[2];
  c[2] = a[0] * b[1] - a[1] * b[0];
}

// _unit: x / |x| where |x| > 1e-20, else the fallback axis e_axis
__device__ __forceinline__ void unit3(const float x[3], int axis,
                                      float out[3]) {
  const float n = sqrtf(dot3(x, x));
  const bool ok = n > (float)1e-20;
#pragma unroll
  for (int i = 0; i < 3; ++i)
    out[i] = ok ? x[i] / n : (i == axis ? 1.0f : 0.0f);
}

// _rot_apply: A <- J^T A J, V <- V J for the Givens rotation J(p, q; c, s)
template <int p, int q>
__device__ __forceinline__ void rot_apply(float a[3][3], float v[3][3],
                                          float c, float s) {
  constexpr int r = 3 - p - q;
  const float app = a[p][p], aqq = a[q][q], apq = a[p][q];
  const float arp = a[r][p], arq = a[r][q];
  const float app_n = c * c * app - 2.0f * s * c * apq + s * s * aqq;
  const float aqq_n = s * s * app + 2.0f * s * c * apq + c * c * aqq;
  const float arp_n = c * arp - s * arq;
  const float arq_n = s * arp + c * arq;
  a[p][p] = app_n;
  a[q][q] = aqq_n;
  a[p][q] = a[q][p] = 0.0f;
  a[r][p] = a[p][r] = arp_n;
  a[r][q] = a[q][r] = arq_n;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float vp = v[i][p], vq = v[i][q];
    v[i][p] = c * vp - s * vq;
    v[i][q] = s * vp + c * vq;
  }
}

// one step of _jacobi_eigh3's sweep on the pair (p, q)
template <int p, int q>
__device__ __forceinline__ void jacobi_step(float a[3][3], float v[3][3]) {
  const float apq = a[p][q];
  const float diff = a[q][q] - a[p][p];
  const bool nz = fabsf(apq) > 0.0f;
  const float tau = diff / (2.0f * (nz ? apq : 1.0f));
  // tau == 0 (equal diagonal) takes the full 45-degree rotation
  const float sgn = tau >= 0.0f ? 1.0f : -1.0f;
  float t = sgn / (fabsf(tau) + sqrtf(1.0f + tau * tau));
  t = nz ? t : 0.0f;
  const float c = rdiv1(sqrtf(1.0f + t * t));
  rot_apply<p, q>(a, v, c, t * c);
}

// svd3: (U, s, V) of F with s >= 0 descending, det(U V^T) = sign(det F)
__device__ __forceinline__ void svd3(const float f[3][3], float u[3][3],
                                     float s[3], float v[3][3]) {
  float a[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      a[i][j] = f[0][i] * f[0][j] + f[1][i] * f[1][j] + f[2][i] * f[2][j];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) v[i][j] = i == j ? 1.0f : 0.0f;
#pragma unroll
  for (int sweep = 0; sweep < 5; ++sweep) {
    jacobi_step<0, 1>(a, v);
    jacobi_step<0, 2>(a, v);
    jacobi_step<1, 2>(a, v);
  }
  // _sort_desc3: the network (0, 1), (0, 2), (1, 2), V's columns along
  float w[3] = {a[0][0], a[1][1], a[2][2]};
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const int i = k == 2 ? 1 : 0, j = k == 0 ? 1 : 2;
    const bool sw = w[i] < w[j];
    const float wi = w[i], wj = w[j];
    w[i] = sw ? wj : wi;
    w[j] = sw ? wi : wj;
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      const float ci = v[r][i], cj = v[r][j];
      v[r][i] = sw ? cj : ci;
      v[r][j] = sw ? ci : cj;
    }
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) s[k] = sqrtf(clamp_min(w[k], 0.0f));

  // proper V (det +1): flip the last column where the sort left det -1
  const float flip = det3(v) < 0.0f ? -1.0f : 1.0f;
#pragma unroll
  for (int r = 0; r < 3; ++r) v[r][2] = v[r][2] * flip;

  float fv[3][3];
  mm3(f, v, fv);
  const float fv0[3] = {fv[0][0], fv[1][0], fv[2][0]};
  const float f1[3] = {fv[0][1], fv[1][1], fv[2][1]};
  float u0[3];
  unit3(fv0, 0, u0);
  const float d01 = dot3(u0, f1);
  float g1[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) g1[i] = f1[i] - d01 * u0[i];
  // rank-1 fallback: cross u0 with the axis least aligned with it
  // (torch.argmin: the first index on ties, NaN the least)
  int k = 0;
  float best = fabsf(u0[0]);
#pragma unroll
  for (int i = 1; i < 3; ++i) {
    const float x = fabsf(u0[i]);
    const bool take = best != best ? false : (x != x || x < best);
    k = take ? i : k;
    best = take ? x : best;
  }
  const float ek[3] = {k == 0 ? 1.0f : 0.0f, k == 1 ? 1.0f : 0.0f,
                       k == 2 ? 1.0f : 0.0f};
  float c0[3], u1_fb[3];
  cross3(u0, ek, c0);
  unit3(c0, 1, u1_fb);
  const float n1 = sqrtf(dot3(g1, g1));
  const bool ok1 = n1 > clamp_min(s[0], (float)1e-30) * (float)1e-12;
  float u1[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) u1[i] = ok1 ? g1[i] / n1 : u1_fb[i];
  const float sgn = det3(f) < 0.0f ? -1.0f : 1.0f;
  float c01[3], u2[3];
  cross3(u0, u1, c01);
  unit3(c01, 2, u2);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    u[i][0] = u0[i];
    u[i][1] = u1[i];
    u[i][2] = sgn * u2[i];
  }
}

// ---- one particle's chain ----------------------------------------------

// piola_linearized's: polar_rs, J, cof and P0 of f; the factors written
// to their rows of fac, P0 to out
__device__ __forceinline__ void polar_stress_row(const float f[3][3],
                                                 float mu, float lam,
                                                 float* __restrict__ fac,
                                                 long long p, long long np,
                                                 float out[3][3]) {
  float u[3][3], s[3], v[3][3];
  svd3(f, u, s, v);
  // polar_rs: R = U V^T, S = V (s V^T)
  float vt[3][3], sv[3][3], r[3][3], sm[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      vt[i][j] = v[j][i];
      sv[i][j] = s[i] * v[j][i];
    }
  mm3(u, vt, r);
  mm3(v, sv, sm);
  const float j = det3(f);
  float cof[3][3];
  cofactor3(f, cof);
  const float two_mu = 2.0f * mu;
  const float lj = lam * (j - 1.0f);
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int k = 0; k < 3; ++k)
      out[i][k] = two_mu * (f[i][k] - r[i][k]) + lj * cof[i][k];
#pragma unroll
  for (int e = 0; e < 9; ++e) {
    fac[e * np + p] = r[e / 3][e % 3];
    fac[(15 + e) * np + p] = cof[e / 3][e % 3];
  }
  fac[9 * np + p] = sm[0][0];
  fac[10 * np + p] = sm[0][1];
  fac[11 * np + p] = sm[0][2];
  fac[12 * np + p] = sm[1][1];
  fac[13 * np + p] = sm[1][2];
  fac[14 * np + p] = sm[2][2];
  fac[24 * np + p] = j;
}

// StressDifferential.apply_plain's: scale (dP(g f) f^T) into out
template <bool kSpd>
__device__ __forceinline__ void stress_apply_row(
    const float f[3][3], const float* __restrict__ g9,
    const float* __restrict__ fac, float mu, float lm, float sc, long long p,
    long long np, float out[3][3]) {
  float g[3][3], cof[3][3], df[3][3];
#pragma unroll
  for (int e = 0; e < 9; ++e) {
    g[e / 3][e % 3] = g9[e * np + p];
    cof[e / 3][e % 3] = fac[(15 + e) * np + p];
  }
  mm3(g, f, df);
  // _ddot(cof, dF): the nine products summed in row-major order
  float dd = cof[0][0] * df[0][0];
#pragma unroll
  for (int e = 1; e < 9; ++e) dd = dd + cof[e / 3][e % 3] * df[e / 3][e % 3];
  const float two_mu = 2.0f * mu;
  float dp[3][3];
  if (kSpd) {
    // 2 mu dF + lam (cof:dF) cof
    const float ld = lm * dd;
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int k = 0; k < 3; ++k)
        dp[i][k] = two_mu * df[i][k] + ld * cof[i][k];
  } else {
    float r[3][3];
#pragma unroll
    for (int e = 0; e < 9; ++e) r[e / 3][e % 3] = fac[e * np + p];
    const float s00 = fac[9 * np + p], s01 = fac[10 * np + p],
                s02 = fac[11 * np + p], s11 = fac[12 * np + p],
                s12 = fac[13 * np + p], s22 = fac[14 * np + p];
    const float j = fac[24 * np + p];
    // polar_delta: rhs = R^T dF - dF^T R, its entries (0,1), (0,2), (1,2)
    float x3[3];
    {
#pragma unroll
      for (int t = 0; t < 3; ++t) {
        const int i = t == 2 ? 1 : 0, k = t == 0 ? 1 : 2;
        const float lhs =
            r[0][i] * df[0][k] + r[1][i] * df[1][k] + r[2][i] * df[2][k];
        const float rhs =
            df[0][i] * r[0][k] + df[1][i] * r[1][k] + df[2][i] * r[2][k];
        x3[t] = lhs - rhs;
      }
    }
    const float m[3][3] = {{s00 + s11, s12, -s02},
                           {s12, s00 + s22, s01},
                           {-s02, s01, s11 + s22}};
    const float det = det3(m);
    float cm[3][3];
    cofactor3(m, cm);
    const float dv = det != 0.0f ? det : 1.0f;
    float x[3];
#pragma unroll
    for (int i = 0; i < 3; ++i)
      x[i] = cm[0][i] / dv * x3[0] + cm[1][i] / dv * x3[1] +
             cm[2][i] / dv * x3[2];
    const float kx[3][3] = {{0.0f, x[0], x[1]},
                            {-x[0], 0.0f, x[2]},
                            {-x[1], -x[2], 0.0f}};
    float dr[3][3];
    mm3(r, kx, dr);
    // dcofactor3: each a*b - c*d of cofactor3 as (da*b + a*db) - (dc*d + c*dd)
    float dc[3][3];
#define FS_DCOF(I, J, A, B, C, D, E, F, G, H)                             \
  dc[I][J] = (df[A][B] * f[C][D] + f[A][B] * df[C][D]) -                  \
             (df[E][F] * f[G][H] + f[E][F] * df[G][H])
    FS_DCOF(0, 0, 1, 1, 2, 2, 1, 2, 2, 1);
    FS_DCOF(0, 1, 1, 2, 2, 0, 1, 0, 2, 2);
    FS_DCOF(0, 2, 1, 0, 2, 1, 1, 1, 2, 0);
    FS_DCOF(1, 0, 0, 2, 2, 1, 0, 1, 2, 2);
    FS_DCOF(1, 1, 0, 0, 2, 2, 0, 2, 2, 0);
    FS_DCOF(1, 2, 0, 1, 2, 0, 0, 0, 2, 1);
    FS_DCOF(2, 0, 0, 1, 1, 2, 0, 2, 1, 1);
    FS_DCOF(2, 1, 0, 2, 1, 0, 0, 0, 1, 2);
    FS_DCOF(2, 2, 0, 0, 1, 1, 0, 1, 1, 0);
#undef FS_DCOF
    const float jm1 = j - 1.0f;
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int k = 0; k < 3; ++k)
        dp[i][k] = two_mu * (df[i][k] - dr[i][k]) +
                   lm * (dd * cof[i][k] + jm1 * dc[i][k]);
  }
  // sigma = dP FE^T, scaled
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int k = 0; k < 3; ++k)
      out[i][k] = sc * (dp[i][0] * f[k][0] + dp[i][1] * f[k][1] +
                        dp[i][2] * f[k][2]);
}

// clamp_singular_plain's: U clamp(s) V^T and V clamp(s)^-1 U^T of f
__device__ __forceinline__ void clamp_singular_row(const float f[3][3],
                                                   float lo, float hi,
                                                   float fe[3][3],
                                                   float inv[3][3]) {
  float u[3][3], s[3], v[3][3];
  svd3(f, u, s, v);
  float sc[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) sc[k] = clamp(s[k], lo, hi);
  // U (clamp(s) V^T) and V (U^T / clamp(s))
  float a[3][3], b[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      a[i][j] = sc[i] * v[j][i];
      b[i][j] = u[j][i] / sc[i];
    }
  mm3(u, a, fe);
  mm3(v, b, inv);
}

// ---- the kernels --------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
    polar_stress_kernel(const float* __restrict__ fe, Strides fs,
                        const float* __restrict__ mu,
                        const float* __restrict__ lam,
                        float* __restrict__ p0, float* __restrict__ fac,
                        long long np) {
  __shared__ float sa[kThreads * 9];
  const Block b = block_of(np);
  const long long p = b.p0 + threadIdx.x;
  float f[3][3], out[3][3];
  load_rows(fe, fs, b, sa, f);
  if (threadIdx.x < b.rows)
    polar_stress_row(f, mu[p], lam[p], fac, p, np, out);
  store_rows(p0, b, sa, out);
}

template <bool kSpd>
__global__ void __launch_bounds__(kThreads)
    stress_apply_kernel(const float* __restrict__ g9,
                        const float* __restrict__ fe, Strides fs,
                        const float* __restrict__ fac,
                        const float* __restrict__ mu,
                        const float* __restrict__ lam,
                        const float* __restrict__ scale,
                        float* __restrict__ m9, long long np) {
  __shared__ float sa[kThreads * 9];
  const Block b = block_of(np);
  const long long p = b.p0 + threadIdx.x;
  float f[3][3], out[3][3];
  load_rows(fe, fs, b, sa, f);
  if (threadIdx.x < b.rows)
    stress_apply_row<kSpd>(f, g9, fac, mu[p], lam[p], scale[p], p, np, out);
  store_rows(m9, b, sa, out);
}

__global__ void __launch_bounds__(kThreads)
    clamp_singular_kernel(const float* __restrict__ fin, Strides fs,
                          float lo, float hi, float* __restrict__ fe_out,
                          float* __restrict__ inv_out, long long np) {
  __shared__ float sa[kThreads * 9], sb[kThreads * 9];
  const Block b = block_of(np);
  float f[3][3], fe[3][3], inv[3][3];
  load_rows(fin, fs, b, sa, f);
  if (threadIdx.x < b.rows) clamp_singular_row(f, lo, hi, fe, inv);
  store_rows(fe_out, b, sa, fe);
  store_rows(inv_out, b, sb, inv);
}

__global__ void __launch_bounds__(kThreads)
    mm3_kernel(const float* __restrict__ a, Strides as,
               const float* __restrict__ b, Strides bs,
               float* __restrict__ c, long long np) {
  __shared__ float sa[kThreads * 9], sb[kThreads * 9];
  const Block blk = block_of(np);
  float x[3][3], y[3][3], z[3][3];
  load_rows(a, as, blk, sa, x);
  load_rows(b, bs, blk, sb, y);
  if (threadIdx.x < blk.rows) mm3(x, y, z);
  store_rows(c, blk, sa, z);
}

bool grid_of(long long np, unsigned* blocks) {
  const long long b = (np + kThreads - 1) / kThreads;
  if (b > 0x7fffffffLL) return false;
  *blocks = (unsigned)b;
  return true;
}

}  // namespace

extern "C" int fs_polar_stress(const float* fe, long long fs0, long long fs1,
                               long long fs2, const float* mu,
                               const float* lam, float* p0, float* fac,
                               long long np, void* stream) {
  unsigned blocks;
  if (np == 0) return 0;
  if (!grid_of(np, &blocks)) return (int)cudaErrorInvalidValue;
  polar_stress_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      fe, Strides{fs0, fs1, fs2}, mu, lam, p0, fac, np);
  return (int)cudaGetLastError();
}

extern "C" int fs_stress_apply(const float* g9, const float* fe,
                               long long fs0, long long fs1, long long fs2,
                               const float* fac, const float* mu,
                               const float* lam, const float* scale,
                               float* m9, int spd, long long np,
                               void* stream) {
  unsigned blocks;
  if (np == 0) return 0;
  if (!grid_of(np, &blocks)) return (int)cudaErrorInvalidValue;
  const Strides fs{fs0, fs1, fs2};
  if (spd)
    stress_apply_kernel<true><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        g9, fe, fs, fac, mu, lam, scale, m9, np);
  else
    stress_apply_kernel<false><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        g9, fe, fs, fac, mu, lam, scale, m9, np);
  return (int)cudaGetLastError();
}

extern "C" int fs_clamp_singular(const float* f, long long s0, long long s1,
                                 long long s2, float lo, float hi,
                                 float* fe_out, float* inv_out, long long np,
                                 void* stream) {
  unsigned blocks;
  if (np == 0) return 0;
  if (!grid_of(np, &blocks)) return (int)cudaErrorInvalidValue;
  clamp_singular_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      f, Strides{s0, s1, s2}, lo, hi, fe_out, inv_out, np);
  return (int)cudaGetLastError();
}

extern "C" int fs_mm3(const float* a, long long as0, long long as1,
                      long long as2, const float* b, long long bs0,
                      long long bs1, long long bs2, float* c, long long np,
                      void* stream) {
  unsigned blocks;
  if (np == 0) return 0;
  if (!grid_of(np, &blocks)) return (int)cudaErrorInvalidValue;
  mm3_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      a, Strides{as0, as1, as2}, b, Strides{bs0, bs1, bs2}, c, np);
  return (int)cudaGetLastError();
}
