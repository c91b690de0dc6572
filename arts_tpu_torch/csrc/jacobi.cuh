// Tournament cyclic Jacobi for one small symmetric matrix per thread, the
// sweeps of csrc/eigh_jacobi.cu (the batched eigh); csrc/disort_fused.cu
// (the DISORT eigen stage, a team of threads per matrix) shares the
// schedule (seat) and the rotation (rot_cs).  Both are those of
// arts_tpu/ops/eigh_jacobi.py (_tournament, _rot_cs).
#pragma once

#include <cuda_runtime.h>

namespace jacobi {

template <typename T>
__device__ __forceinline__ T tabs(T a) { return a < T(0) ? -a : a; }

// player at seat k after r rotations of the circle method for an even
// number of players n: the schedule of _tournament
__host__ __device__ constexpr int seat(int n, int r, int k) {
  return k == 0 ? 0 : 1 + (((k - 1 - r) % (n - 1)) + (n - 1)) % (n - 1);
}

// (c, s) of the Jacobi rotation zeroing apq, never dividing by apq:
// t = 2 apq sign(d) / (|d| + sqrt(d^2 + 4 apq^2)), d = aqq - app
template <typename T>
__device__ __forceinline__ void rot_cs(T app, T aqq, T apq, T& c, T& s) {
  const T d = aqq - app;
  const T denom = tabs(d) + sqrt(d * d + T(4) * apq * apq);
  T t = T(0);
  if (denom > T(0)) {
    const T sg = d > T(0) ? T(1) : (d < T(0) ? T(-1) : T(0));
    t = T(2) * apq * sg / denom;
  }
  c = T(1) / sqrt(t * t + T(1));
  s = t * c;
}

// `sweeps` sweeps on the leading n x n block of M (n <= N), accumulated
// into V: n - 1 (even n) or n (odd n) rounds of disjoint rotations each.
// Per round: the angles of all pairs first, then the row rotations, then
// the column rotations of M and V.  Odd n schedules n + 1 players; pairs
// with the extra player sit out.
//
// U is the unroll factor of the loops inside a sweep.  U = N (the default,
// called with n = N) unrolls them fully: every index is a compile-time
// constant once the function is inlined, so M and V stay in registers.
// U = 1 keeps the loops, for a run-time n, with M and V in local memory.
template <typename T, int N, int U = N>
__device__ __forceinline__ void sweeps(T (&M)[N][N], T (&V)[N][N], int n, int nsweeps) {
  const int P = n + (n & 1);
#pragma unroll 1
  for (int sw = 0; sw < nsweeps; ++sw) {
#pragma unroll (U)
    for (int r = 0; r < P - 1; ++r) {
      T cs[(N + 1) / 2], sn[(N + 1) / 2];
#pragma unroll (U)
      for (int k = 0; k < P / 2; ++k) {
        const int a = seat(P, r, k), e = seat(P, r, P - 1 - k);
        const int p = a < e ? a : e, q = a < e ? e : a;
        if (q < n) rot_cs(M[p][p], M[q][q], M[p][q], cs[k], sn[k]);
      }
#pragma unroll (U)
      for (int k = 0; k < P / 2; ++k) {
        const int a = seat(P, r, k), e = seat(P, r, P - 1 - k);
        const int p = a < e ? a : e, q = a < e ? e : a;
        if (q < n) {
#pragma unroll (U)
          for (int j = 0; j < n; ++j) {
            const T mp = M[p][j], mq = M[q][j];
            M[p][j] = cs[k] * mp - sn[k] * mq;
            M[q][j] = sn[k] * mp + cs[k] * mq;
          }
        }
      }
#pragma unroll (U)
      for (int k = 0; k < P / 2; ++k) {
        const int a = seat(P, r, k), e = seat(P, r, P - 1 - k);
        const int p = a < e ? a : e, q = a < e ? e : a;
        if (q < n) {
#pragma unroll (U)
          for (int i = 0; i < n; ++i) {
            const T mp = M[i][p], mq = M[i][q];
            M[i][p] = cs[k] * mp - sn[k] * mq;
            M[i][q] = sn[k] * mp + cs[k] * mq;
            const T vp = V[i][p], vq = V[i][q];
            V[i][p] = cs[k] * vp - sn[k] * vq;
            V[i][q] = sn[k] * vp + cs[k] * vq;
          }
        }
      }
    }
  }
}

}  // namespace jacobi
