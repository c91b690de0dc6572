// Tournament cyclic Jacobi for small symmetric matrices on a team of
// threads per matrix: the schedule (seat), the rotation (rot_cs; rot_fast,
// its float32 form on the hardware approximations; rot_exact, the plain
// version's arithmetic), and the team's sweeps (slot_player, team_sweeps).
// One core for the batched eigh (csrc/eigh_jacobi.cu) and the DISORT eigen
// stage (csrc/disort_fused.cu: stage 1 and fused_eigen); the schedule,
// rotation and order of a round are those of arts_tpu/ops/eigh_jacobi.py
// (_tournament, _rot_cs).
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

// a reciprocal: in float32 the hardware approximation and one Newton step
// (no branch to the slow path of an IEEE quotient, whose inputs, a zero,
// denormal or infinite value, do not arise where it is used: the pivots of
// stages 2+3's diagonally dominant blocks, sqrt(1 + t^2) >= 1, and the
// denominator of a rotation angle, whose zero rot_fast discards), in float64
// the IEEE quotient
__device__ __forceinline__ float recip(float x) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return fmaf(r, fmaf(-x, r, 1.0f), r);
}
__device__ __forceinline__ double recip(double x) { return 1.0 / x; }

// (c, s) of a Jacobi rotation: jacobi::rot_cs (IEEE quotients and square
// roots), or rot_fast, the same division-safe formula in float32 with the
// hardware square root and reciprocals (sqrt.approx for the denominator;
// recip; for c = 1/sqrt(1 + t^2) rsqrt.approx, one Newton step on the square
// root and recip, whose residuals an FMA forms exactly, so that c keeps the
// IEEE version's accuracy and the rotations stay orthogonal to rounding)
// and no branch: without the slow paths of IEEE division and square root
// (float64: rot_cs)
__device__ __forceinline__ void rot_fast(float app, float aqq, float apq, float& c, float& s) {
  const float d = aqq - app;
  float root, r;
  asm("sqrt.approx.f32 %0, %1;" : "=f"(root) : "f"(d * d + 4.0f * apq * apq));
  const float denom = fabsf(d) + root;
  const float num = d > 0.0f ? 2.0f * apq : d < 0.0f ? -2.0f * apq : 0.0f;
  const float t = denom > 0.0f ? num * recip(denom) : 0.0f;
  const float u = t * t + 1.0f;
  asm("rsqrt.approx.f32 %0, %1;" : "=f"(r) : "f"(u));
  const float q = u * r;                               // ~sqrt(u)
  c = recip(fmaf(fmaf(-q, q, u), 0.5f * r, q));        // 1 / sqrt(u), one Newton step each
  s = t * c;
}
__device__ __forceinline__ void rot_fast(double app, double aqq, double apq, double& c, double& s) {
  jacobi::rot_cs(app, aqq, apq, c, s);
}

// products, sums and differences rounded one by one, never fused into an FMA
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }

// (c, s) of rot_cs computed as the plain version's _rot_cs computes it:
// the same operations in the same order, each rounded on its own, IEEE
// quotients and square roots
template <typename T>
__device__ __forceinline__ void rot_exact(T app, T aqq, T apq, T& c, T& s) {
  const T d = sub_rn(aqq, app);
  const T denom = add_rn(tabs(d), sqrt(add_rn(mul_rn(d, d), mul_rn(mul_rn(T(4), apq), apq))));
  T t = T(0);
  if (denom > T(0)) {
    const T sg = d > T(0) ? T(1) : (d < T(0) ? T(-1) : T(0));
    t = mul_rn(mul_rn(T(2), apq), sg) / denom;
  }
  c = T(1) / sqrt(add_rn(mul_rn(t, t), T(1)));
  s = mul_rn(t, c);
}

// slots (columns of M, rows of V) of each thread of a team of TEAM threads
// on n players: two for each of its ceil(n/2 / TEAM) pairs, or one column
// when TEAM = n
__host__ __device__ constexpr int team_slots(int n, int team) {
  return team == n ? 1 : 2 * ((n / 2 + team - 1) / team);
}

// player (index of a row and column of M) in slot s of thread k at the
// start of a sweep, of S slots: slot 2i holds seat k S/2 + i, slot 2i + 1
// seat n - 1 - (k S/2 + i), or with one slot seat k; after a whole sweep
// every player is back in its seat.  Where the team's pair slots outnumber
// the n/2 pairs, the slots of pairs k S/2 + i >= n/2 are idle (the last
// ones of the team): the value is not a player there.
template <int N, int S>
__device__ __forceinline__ int slot_player(int k, int s) {
  if (S == 1) return k;
  const int a = k * (S / 2) + s / 2;
  return s % 2 == 0 ? a : N - 1 - a;
}

// The team's tournament Jacobi (the schedule, angles and order of the
// plain jacobi_sweeps).  Thread k of the team holds S = team_slots(n, TEAM)
// columns of M (the seats of slot_player: the two columns of each of its
// pairs of the round, or one column), rows in seat order: row r of a column
// is M's row of the player in seat r.  So in every round the pairs are rows
// (j, n - 1 - j), the same for every column and thread, and a round ends
// with one fixed renaming of the rows.  It holds rows k S .. k S + S - 1 of V, which never
// move.  One round:
//   1. the angles of its own pairs, from its own columns (which entries
//      depends on k: a chain of selects over the team, no indexing); with
//      one column, from two entries of the partner's column by shuffle;
//   2. every pair's angle by shuffle from the thread that owns the pair;
//   3. the row rotations of all pairs on its columns;
//   4. its pairs' column rotations of M (with one column, the partner's
//      column by shuffle), and all pairs' column rotations of its rows of V;
//   5. the circle method's move, the player in seat r to seat r + 1 (seat
//      n - 1 to 1, seat 0 stays): inside a thread a renaming, across
//      threads two columns by shuffle (the first left seat from the thread
//      below, the last right seat from the thread above), or with one
//      column that column.
// The angles are in the seat convention, s of the pair (left seat, right
// seat): the plain (p < q) rotation with s negated where the left seat
// holds q, which is the same rotation.
// Where n/2 is not a multiple of TEAM, the last pair slots are idle (see
// slot_player): their columns and rows take part in the rotations and
// moves without reaching a real one, except that the last real pair's right
// seat, in thread KL, takes its left seat in the move.  With whole pairs
// per thread the idle-slot code compiles away.
// EXACT computes every angle with rot_exact and every rotated entry as two
// products and a sum, each rounded (no FMA): the plain version's arithmetic
// in its order, so that M and V are the plain jacobi_sweeps' bit for bit
// (a dummy player's pairs turn by exactly the identity).
template <typename T, int N, int TEAM, bool EXACT = false>
__device__ __forceinline__ void team_sweeps(T (&col)[team_slots(N, TEAM)][N],
                                            T (&vr)[team_slots(N, TEAM)][N], int k, int nsweeps) {
  constexpr int P = N, NP = N / 2, S = team_slots(N, TEAM), PT = S / 2;
  // the thread holding the last real pair, and that pair's slot there
  constexpr int KL = PT > 0 ? (NP - 1) / PT : 0, IL = NP - 1 - KL * PT;
  static_assert(TEAM == N || TEAM * PT <= NP + NP, "the team's pair slots index seats");
  static_assert(!EXACT || S > 1, "EXACT takes whole pairs per thread");
  constexpr unsigned FULL = 0xffffffffu;
#pragma unroll 1
  for (int sw = 0; sw < nsweeps; ++sw) {
#pragma unroll
    for (int r = 0; r < P - 1; ++r) {
      // 1., 2. the angles
      T cs[PT > 0 ? PT : 1], sn[PT > 0 ? PT : 1], C[NP], Sn[NP];
      if constexpr (S == 1) {
        // seat k; its pair j = min(k, n - 1 - k) is (left seat j, right seat
        // n - 1 - j); both threads of the pair compute its angle
        T dk = T(0), ok = T(0);
        bool lo = true;
#pragma unroll
        for (int kk = 0; kk < TEAM; ++kk) {
          if (kk == k) {
            dk = col[0][kk];
            ok = col[0][P - 1 - kk];
            const int j = kk < NP ? kk : P - 1 - kk;
            lo = jacobi::seat(P, r, j) < jacobi::seat(P, r, P - 1 - j);
          }
        }
        const T dp = __shfl_sync(FULL, dk, P - 1 - k, TEAM);
        const T op = __shfl_sync(FULL, ok, P - 1 - k, TEAM);
        const bool left = k < NP;
        const T maa = left ? dk : dp, mbb = left ? dp : dk;
        const T mab = lo ? (left ? op : ok) : (left ? ok : op);  // M[p][q], p < q
        T c, s;
        rot_fast(lo ? maa : mbb, lo ? mbb : maa, mab, c, s);
        cs[0] = c;
        sn[0] = lo ? s : -s;
#pragma unroll
        for (int j = 0; j < NP; ++j) {
          C[j] = __shfl_sync(FULL, cs[0], j, TEAM);
          Sn[j] = __shfl_sync(FULL, sn[0], j, TEAM);
        }
      } else {
        // the thread's pairs: seats a = k PT + i (slot 2i), b = n - 1 - a
#pragma unroll
        for (int i = 0; i < PT; ++i) {
          T maa = T(0), mbb = T(0), mab = T(0);
          bool lo = true;
#pragma unroll
          for (int kk = 0; kk < TEAM; ++kk) {
            const int a = kk * PT + i, bs = P - 1 - a;
            const bool l0 = jacobi::seat(P, r, a) < jacobi::seat(P, r, bs);
            if (kk == k) {
              maa = col[2 * i][a];
              mbb = col[2 * i + 1][bs];
              mab = l0 ? col[2 * i + 1][a] : col[2 * i][bs];  // M[p][q], p < q
              lo = l0;
            }
          }
          T c, s;
          if constexpr (EXACT) rot_exact(lo ? maa : mbb, lo ? mbb : maa, mab, c, s);
          else rot_fast(lo ? maa : mbb, lo ? mbb : maa, mab, c, s);
          cs[i] = c;
          sn[i] = lo ? s : -s;
        }
        // pair j's angle from thread j / PT, slot j % PT
#pragma unroll
        for (int j = 0; j < NP; ++j) {
          if constexpr (TEAM == 1) {
            C[j] = cs[j];
            Sn[j] = sn[j];
          } else {
            C[j] = __shfl_sync(FULL, cs[j % PT], j / PT, TEAM);
            Sn[j] = __shfl_sync(FULL, sn[j % PT], j / PT, TEAM);
          }
        }
      }
      // 3. row rotations
#pragma unroll
      for (int s = 0; s < S; ++s) {
#pragma unroll
        for (int j = 0; j < NP; ++j) {
          const T x = col[s][j], y = col[s][P - 1 - j];
          if constexpr (EXACT) {
            col[s][j] = sub_rn(mul_rn(C[j], x), mul_rn(Sn[j], y));
            col[s][P - 1 - j] = add_rn(mul_rn(Sn[j], x), mul_rn(C[j], y));
          } else {
            col[s][j] = C[j] * x - Sn[j] * y;
            col[s][P - 1 - j] = Sn[j] * x + C[j] * y;
          }
        }
      }
      // 4. column rotations: the thread's pairs of M, all pairs of its rows of V
      if constexpr (S == 1) {
        const T sg = k < NP ? -sn[0] : sn[0];
#pragma unroll
        for (int x = 0; x < P; ++x) {
          const T v = __shfl_sync(FULL, col[0][x], P - 1 - k, TEAM);
          col[0][x] = cs[0] * col[0][x] + sg * v;
        }
      } else {
#pragma unroll
        for (int i = 0; i < PT; ++i) {
#pragma unroll
          for (int x = 0; x < P; ++x) {
            const T u = col[2 * i][x], v = col[2 * i + 1][x];
            if constexpr (EXACT) {
              col[2 * i][x] = sub_rn(mul_rn(cs[i], u), mul_rn(sn[i], v));
              col[2 * i + 1][x] = add_rn(mul_rn(sn[i], u), mul_rn(cs[i], v));
            } else {
              col[2 * i][x] = cs[i] * u - sn[i] * v;
              col[2 * i + 1][x] = sn[i] * u + cs[i] * v;
            }
          }
        }
      }
#pragma unroll
      for (int m = 0; m < S; ++m) {
#pragma unroll
        for (int j = 0; j < NP; ++j) {
          const int pa = jacobi::seat(P, r, j), pb = jacobi::seat(P, r, P - 1 - j);
          const T u = vr[m][pa], v = vr[m][pb];
          if constexpr (EXACT) {
            vr[m][pa] = sub_rn(mul_rn(C[j], u), mul_rn(Sn[j], v));
            vr[m][pb] = add_rn(mul_rn(Sn[j], u), mul_rn(C[j], v));
          } else {
            vr[m][pa] = C[j] * u - Sn[j] * v;
            vr[m][pb] = Sn[j] * u + C[j] * v;
          }
        }
      }
      // 5. the move to the next round's seats
      T nw[S][P];
      if constexpr (S == 1) {
        const int src = k == 1 ? P - 1 : k == 0 ? 0 : k - 1;
#pragma unroll
        for (int x = 0; x < P; ++x) nw[0][x] = __shfl_sync(FULL, col[0][x], src, TEAM);
      } else {
#pragma unroll
        for (int x = 0; x < P; ++x) {
          // the first left seat of thread k takes the last left seat of
          // thread k - 1 (seat 1 takes seat n - 1: thread 0's first right
          // seat when PT = 1); the last right seat takes the first right
          // seat of thread k + 1
          T up = col[0][x], dn = col[S - 2][x];
          if constexpr (TEAM > 1) {
            up = __shfl_up_sync(FULL, PT == 1 && k == 0 ? col[1][x] : col[S - 2][x], 1, TEAM);
            dn = __shfl_down_sync(FULL, col[1][x], 1, TEAM);
          }
          nw[0][x] = k == 0 ? col[0][x] : up;
          if constexpr (PT > 1) nw[2][x] = k == 0 ? col[1][x] : col[0][x];
#pragma unroll
          for (int i = 2; i < PT; ++i) nw[2 * i][x] = col[2 * i - 2][x];
#pragma unroll
          for (int i = 0; i + 1 < PT; ++i) nw[2 * i + 1][x] = col[2 * i + 3][x];
          nw[S - 1][x] = k == TEAM - 1 ? col[S - 2][x] : dn;
          if constexpr (KL < TEAM - 1 || IL + 1 < PT)
            nw[2 * IL + 1][x] = k == KL ? col[2 * IL][x] : nw[2 * IL + 1][x];
        }
      }
      // rows follow their players: row r + 1 <- r, row 1 <- n - 1
#pragma unroll
      for (int s = 0; s < S; ++s) {
        col[s][0] = nw[s][0];
        col[s][1] = nw[s][P - 1];
#pragma unroll
        for (int x = 2; x < P; ++x) col[s][x] = nw[s][x - 1];
      }
    }
  }
}

}  // namespace jacobi
