// Fused DISORT solve for Hopper (sm_90a): two kernels for the three stages
// of the TPU path, and the standalone eigen stage.
//
// Replaces the Pallas TPU kernels of arts_tpu/disort/fused_kernel.py:
//   disort_stage1   <- _stage1_kernel (pallas_call at :447), which runs
//                      eigen_core (arts_tpu/disort/eigen_kernel.py:35) and
//                      the tournament Jacobi of arts_tpu/ops/eigh_jacobi.py
//   disort_stage23  <- _stage2_kernel (:489) and _stage3_kernel (:508)
// and of arts_tpu/disort/eigen_kernel.py:
//   fused_eigen     <- _kernel (pallas_call at :207, wrapper fused_eigen
//                      at :252): eigen_core alone, writing k, Ek and G+-.
// Stage 1 and fused_eigen share one eigen core (eigen_stage below); its
// Jacobi sweeps (team_sweeps), schedule and rotations are csrc/jacobi.cuh's,
// shared with the batched eigh, csrc/eigh_jacobi.cu.
//
// Layout: every (frequency x Fourier mode) problem is a lane b; arrays are
// [layer, entry, lane], so the threads of a warp, which hold neighbouring
// lanes, read and write neighbouring addresses.
//
// Stage 1 and fused_eigen, a team of threads per (lane, layer) problem
// (kTeamMax = 2: 64 problems per block of 128): pp/pm staged into the
// problem's shared tiles with cp.async, H1/H2, the thermal particular
// solution (stage 1: the ApB/AmB eliminations on the team, in registers),
// Cholesky of -H1, Hsym = -Lc^T H2 Lc, the tournament cyclic Jacobi (6
// sweeps at f32, 8 at f64) with the division-safe rotation, k =
// sqrt(max(lambda, 1e-24)), Ek = exp(-k dtau), and G+/G-.  In the Jacobi
// each thread holds the columns of M of two pairs of each round and two
// rows of V; every round moves the rotation angles and two columns of M
// between the threads by shuffle (team_sweeps).  Writes Ek, G+-, and the
// particular radiances (stage 1) or k (fused_eigen).  Stage 1's beam
// instance first forms AmB, exactly rounded, into the problem's X tile and
// solves the beam's system from the staged pp/pm before H1/H2 overwrite
// them (beam_rows: every entry of ApB formed once, AmB read from the
// tile); z+- and the layer's attenuation then wait in the X tile, so that
// nothing of the beam is held in registers across the thermal solve.  At
// n = 8 in float32 that takes 128 registers against the thermal
// instance's 96 (ptxas, sm_90a): both fit the 4 blocks per SM that the
// shared memory allows.
//
// Stages 2+3, kTPL = 8 threads per lane (four lanes per warp), kLanes =
// 16 lanes per block: the TPU grid walked the layers in order with W
// [n x n] and uy [n] carried in VMEM scratch; here a loop in the block
// carries them in shared memory.  Per layer the block stages its lanes'
// G+, G-, Ek and right-hand sides in shared memory with cp.async
// (lane-major, the next layer's copy in flight while this one is solved).
// Thread t of a lane owns columns c = s kTPL + t of the layer system
// [D | 0; I | rmod]: of D's 2n columns two (n = 8), and column t of P's n
// (t < n); y's 2n rows are spread over the 8 threads, two each.  The
// thread builds its columns (A rows -[Gm | GpE] - W T, B rows [GpE | Gm]
// - Rsurf U at the surface), then an unpivoted Gauss-Jordan elimination
// runs 2n steps: at step i, thread i % 8 writes column i and y's row i to
// a per-lane shared slot, and every thread updates its columns and rows
// (the blocks are diagonally dominant by construction).  Each value read
// from the slot serves two or three columns: the shared-memory traffic
// per step is what bounds such a solve, and one thread per column (a warp
// per lane) moved three times as much.  Thread t ends holding P's column
// t; it writes it to the scratch S [L, B, n + 1, 2n] (one contiguous 2n
// run; y's rows after P's columns) and forms column t of W = U P, and row
// t of uy = U y.  The backward loop stages each layer's S block with G+-,
// Ek and the particular radiances; thread t forms rows t, t + 8 of X = y -
// P t and then row t of the four outputs (utop, vtop, ubot, vbot), staged
// in shared memory so that the block's stores coalesce.  No atomics:
// repeated runs are bit-identical.
//
// Bound: stage 1 moves every input and output once (1.2 KB per (lane,
// layer) in float32, ~0.09 ms at the bench shape); its arithmetic (~32
// kflop per problem, 84 % of it the Jacobi sweeps) bounds it at ~0.12 ms.
// What holds the eigen core back is instruction issue: every rotation
// output is a multiply and an FMA, and a round adds its shuffles, the
// selects of the thread's own pairs and the moves, ~290 instructions per
// thread and round at n = 8; one thread per problem issues fewer but
// holds 128 values of M and V and hides its latency with too few warps.
// Stages 2+3 move their inputs and outputs
// once, plus the scratch S (written once, read once) and G+-/Ek read a
// second time, ~620 MB at the bench shape in float32 (~0.19 ms at 3.35
// TB/s); the least arithmetic is ~3.1 GFLOP.  Each Gauss-Jordan step is a
// dependency chain through shared memory, and 4096 lanes make only 1024
// warps, 8 per SM: the kernel hides that latency with the independent
// columns of a thread, not with other warps.

#include <cuda_runtime.h>

#include <type_traits>

#include "async.cuh"
#include "jacobi.cuh"

namespace {

using async::cp_async;
using async::cp_async_commit;
using async::cp_async_wait;
using async::ld16;
using async::st16;
using jacobi::recip;
using jacobi::slot_player;
using jacobi::team_sweeps;

// ---------------------------------------------------------------------------
// stage 1 and fused_eigen: the eigen stage, a team of threads per problem
// ---------------------------------------------------------------------------

// The design's switches; tools/stage1_variants.py times the others, and
// the values here are the fastest measured (PERF.md).
constexpr int kThreads1 = 128;          // threads per block
constexpr int kTeamMax = 2;             // threads per (lane, layer) problem, at most n / 2
constexpr bool kSeatPerThread = false;  // n threads per problem, one column each
constexpr bool kTilesShared = true;     // H1/H2 in shared tiles, or from pp/pm at each use

// Layout of the eigen kernels, in elements of T: the quadrature table, then
// per problem three n x n tiles (pp, H1, later Lc; pm, H2; X: AmB under a
// beam, M, later V; without kTilesShared no H2 tile and H1's only for Lc),
// the problem's stride padded to TEAM (mod 32) 4-byte words so that the
// same entry of the warp's problems falls in distinct banks.
template <typename T, int N>
struct E1 {
  static constexpr int NN = N * N, NP = N / 2;
  static constexpr int TEAM = kSeatPerThread ? N : NP < kTeamMax ? NP : kTeamMax;
  static constexpr int S = N / TEAM;     // columns of M, and rows of V, per thread
  static constexpr int NPB = kThreads1 / TEAM;  // problems per block
  static constexpr int NQ = 5 * N + 2 * NN;
  static constexpr int NT = kTilesShared ? 3 : 2;  // tiles per problem
  static constexpr int W0 = NT * NN * int(sizeof(T)) / 4, Q = TEAM * int(sizeof(T)) / 4;
  static constexpr int TS = (W0 + ((Q - W0) % 32 + 32) % 32) * 4 / int(sizeof(T));
  static constexpr int SIZE = NQ + NPB * TS;
  static_assert((TEAM == N || NP % TEAM == 0) && 32 % TEAM == 0,
                "a thread holds whole pairs or one column, a warp whole teams");
};

// Gaussian elimination without pivoting, A X = B, on the team in registers:
// thread k holds rows k + TEAM m of A and B (slot m).  Step i hands the
// pivot row to the team by shuffle from its thread (i % TEAM, slot i / TEAM,
// both fixed at compile time); every thread scales it and eliminates its
// rows below it, and the pivot row's thread keeps it scaled.  The
// back-substitution hands each solved row to the team the same way, so that
// every thread ends with all of X.  The operations and their order are those
// of one thread's elimination (the plain version's _ge_solve); EXACT keeps
// each product and difference rounded on its own (no FMA), as the plain
// version rounds them.
template <typename T, int N, int K, int TEAM, bool EXACT = false>
__device__ __forceinline__ void ge_team(T (&A)[N / TEAM][N], T (&B)[N / TEAM][K], T (&X)[N][K],
                                        int k) {
  using jacobi::mul_rn;
  using jacobi::sub_rn;
  constexpr int R = N / TEAM;
  auto bcast = [](T v, int src) {
    if constexpr (TEAM == 1) return v;
    else return __shfl_sync(0xffffffffu, v, src, TEAM);
  };
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int o = i % TEAM, m0 = i / TEAM;
    const T inv = T(1) / bcast(A[m0][i], o);
    T u[N], x[K];
#pragma unroll
    for (int j = i + 1; j < N; ++j) u[j] = bcast(A[m0][j], o) * inv;
#pragma unroll
    for (int j = 0; j < K; ++j) x[j] = bcast(B[m0][j], o) * inv;
    if (k == o) {
#pragma unroll
      for (int j = i + 1; j < N; ++j) A[m0][j] = u[j];
#pragma unroll
      for (int j = 0; j < K; ++j) B[m0][j] = x[j];
    }
#pragma unroll
    for (int m = 0; m < R; ++m) {
      if (k + TEAM * m > i) {
        const T f = A[m][i];
        if constexpr (EXACT) {
#pragma unroll
          for (int j = i + 1; j < N; ++j) A[m][j] = sub_rn(A[m][j], mul_rn(f, u[j]));
#pragma unroll
          for (int j = 0; j < K; ++j) B[m][j] = sub_rn(B[m][j], mul_rn(f, x[j]));
        } else {
#pragma unroll
          for (int j = i + 1; j < N; ++j) A[m][j] -= f * u[j];
#pragma unroll
          for (int j = 0; j < K; ++j) B[m][j] -= f * x[j];
        }
      }
    }
  }
#pragma unroll
  for (int i = N - 1; i >= 0; --i) {
#pragma unroll
    for (int j = 0; j < K; ++j) {
      T acc = B[i / TEAM][j];
#pragma unroll
      for (int r = i + 1; r < N; ++r) {
        if constexpr (EXACT) acc = sub_rn(acc, mul_rn(A[i / TEAM][r], X[r][j]));
        else acc -= A[i / TEAM][r] * X[r][j];
      }
      X[i][j] = bcast(acc, i % TEAM);
    }
  }
}

// copy the problem's pp and pm (at mat0 of [layer, n*n, lane]) into its H1
// and H2 tiles: thread k of the team copies entries k + TEAM m, all in
// flight at once (cp.async, no registers held)
template <typename T, int N, int TEAM>
__device__ __forceinline__ void stage_pp_pm(const T* __restrict__ pp, const T* __restrict__ pm,
                                            long mat0, long B, int k, T* h1, T* h2) {
#pragma unroll
  for (int m = 0; m < N * N / TEAM; ++m) {
    const int e = k + TEAM * m;
    cp_async<sizeof(T)>(h1 + e, pp + mat0 + static_cast<long>(e) * B);
    cp_async<sizeof(T)>(h2 + e, pm + mat0 + static_cast<long>(e) * B);
  }
  cp_async_commit();
}

// H1/H2 = F (c (Pp -/+ Pm) - diag(1/w)) F in place over the staged pp/pm,
// thread k of the team taking the entries it staged
template <typename T, int N, int TEAM>
__device__ __forceinline__ void h12(T c, const T* ff, const T* dg, int k, T* h1, T* h2) {
  cp_async_wait<0>();
#pragma unroll
  for (int m = 0; m < N * N / TEAM; ++m) {
    const int e = k + TEAM * m, i = e / N, j = e % N;
    const T a = h1[e];
    const T b = h2[e];
    const T ffc = ff[e] * c;
    const T d = i == j ? dg[i] : T(0);
    h1[e] = ffc * (a - b) - d;
    h2[e] = ffc * (a + b) - d;
  }
}

// entry e of ApB (plus false) or AmB from pp/pm's entries u, v: sc (F (c
// (Pp -/+ Pm) - diag(1/w)) F), every product and difference rounded on its
// own, as the plain version forms sc * H1/H2
template <typename T, int N>
__device__ __forceinline__ T ab_rn(T u, T v, bool plus, int e, T c, const T* ff, const T* dg,
                                   const T* sc) {
  using jacobi::add_rn;
  using jacobi::mul_rn;
  using jacobi::sub_rn;
  const T d = e / N == e % N ? dg[e / N] : T(0);
  return mul_rn(sc[e], sub_rn(mul_rn(mul_rn(ff[e], c), plus ? add_rn(u, v) : sub_rn(u, v)), d));
}

// The beam's particular solution (all modes) of one problem on its team:
// (ApB AmB - I/mu0^2) s = ApB (q+ + q-)/mu - (q+ - q-)/(mu mu0), d = -mu0
// (AmB s - (q+ + q-)/mu), z+- = (s +- d)/2; thread k forms rows r = k +
// TEAM m of the system and of z+-.  apb(e) gives entry e of ApB, amb is
// AmB in the problem's X tile.  The system squares the conditioning of ApB
// and AmB (and is singular where k mu0 = 1), so every product and sum
// rounds on its own, in the plain version's order (_beam_plain): the
// kernel then carries the plain version's rounding, not an amplified
// difference from it.  The sums over t run outermost: step t forms (q+ +
// q-)/mu of row t and column t of the thread's rows of ApB, reads row t of
// AmB an entry at a time, and adds the products to the thread's rows of
// the system and of the right-hand side, so that every AmB and ApB entry is
// read or formed once and only those rows are held.
template <typename T, int N, int TEAM, typename ApB>
__device__ __forceinline__ void beam_rows(ApB apb, const T* amb, const T* imu,
                                          const T* __restrict__ qp, const T* __restrict__ qm,
                                          long vec0c, long B, T mu0, int k, T (&zp)[N / TEAM],
                                          T (&zm)[N / TEAM]) {
  using jacobi::add_rn;
  using jacobi::mul_rn;
  using jacobi::sub_rn;
  constexpr int R = N / TEAM;
  const T imu0 = T(1) / mu0;
  const T imu02 = T(1) / mul_rn(mu0, mu0);
  T Bs[R][1], Sv[N][1], Pr[R][N], pr[R];
  // step t of the sums (FIRST: t = 0, which starts them); a loop, not
  // unrolled, so that no step's loads are hoisted into another's registers
  auto step = [&](int t, auto first) {
    constexpr bool FIRST = decltype(first)::value;
    const T sp = mul_rn(add_rn(qp[vec0c + static_cast<long>(t) * B],
                               qm[vec0c + static_cast<long>(t) * B]), imu[t]);
    T a[R];
#pragma unroll
    for (int m = 0; m < R; ++m) {
      a[m] = apb((k + TEAM * m) * N + t);
      Bs[m][0] = FIRST ? mul_rn(a[m], sp) : add_rn(Bs[m][0], mul_rn(a[m], sp));
    }
#pragma unroll
    for (int c2 = 0; c2 < N; ++c2) {
      const T x = amb[t * N + c2];
#pragma unroll
      for (int m = 0; m < R; ++m)
        Pr[m][c2] = FIRST ? mul_rn(a[m], x) : add_rn(Pr[m][c2], mul_rn(a[m], x));
    }
  };
  step(0, std::true_type{});
#pragma unroll 1
  for (int t = 1; t < N; ++t) step(t, std::false_type{});
#pragma unroll
  for (int m = 0; m < R; ++m) {
    const int r = k + TEAM * m;
    const T u = qp[vec0c + static_cast<long>(r) * B];
    const T v = qm[vec0c + static_cast<long>(r) * B];
    Bs[m][0] = sub_rn(Bs[m][0], mul_rn(mul_rn(sub_rn(u, v), imu[r]), imu0));
    pr[m] = mul_rn(add_rn(u, v), imu[r]);
#pragma unroll
    for (int c2 = 0; c2 < N; ++c2)
      if (c2 == r) Pr[m][c2] = sub_rn(Pr[m][c2], imu02);
  }
  ge_team<T, N, 1, TEAM, true>(Pr, Bs, Sv, k);
#pragma unroll
  for (int m = 0; m < R; ++m) {
    const int r = k + TEAM * m;
    T s = mul_rn(amb[r * N], Sv[0][0]);
#pragma unroll
    for (int t = 1; t < N; ++t) s = add_rn(s, mul_rn(amb[r * N + t], Sv[t][0]));
    T sr = T(0);
#pragma unroll
    for (int t = 0; t < TEAM; ++t)
      if (t == k) sr = Sv[t + TEAM * m][0];
    const T d = mul_rn(-mu0, sub_rn(s, pr[m]));
    zp[m] = mul_rn(T(0.5), add_rn(sr, d));
    zm[m] = mul_rn(T(0.5), sub_rn(sr, d));
  }
}

// One (lane, layer) problem of stage 1 (THERMAL) or of fused_eigen (WRITE_K)
// on a team of E1::TEAM threads: pp/pm staged and turned into H1/H2 in the
// problem's tiles, the thermal particular solution (ge_team; thread k
// stores rows k + TEAM m) and with BEAM the beam's (beam_rows, before
// h12; z+- added with the layer's attenuation at the stores), Cholesky of -H1 (every thread; the tile of H1
// becomes Lc, zero above the diagonal), Hsym = -Lc^T H2 Lc (each thread its
// columns, the upper part mirrored through the X tile), the team's Jacobi,
// k = sqrt(max(lambda, 1e-24)), Ek = exp(-k dtau), then V through the X
// tile and, for the thread's columns j, Y = diag(1/E) Lc V[:, j] and G+- =
// (Y +- D)/2 with D = diag(1/(mu F)) H2 diag(w/F) Y (1/k_j).  Arrays are
// [layer, entry, lane]; lanes past B compute on the last lane's data and
// store nothing.
template <typename T, int N, bool THERMAL, bool WRITE_K, bool BEAM = false>
__device__ __forceinline__ void eigen_stage(
    const T* __restrict__ pp, const T* __restrict__ pm, const T* __restrict__ om,
    const T* __restrict__ dtau, const T* __restrict__ tb0, const T* __restrict__ tb1,
    const T* __restrict__ qtab, T* __restrict__ kout, T* __restrict__ ek, T* __restrict__ gp,
    T* __restrict__ gm, T* __restrict__ ut, T* __restrict__ vt, T* __restrict__ ub,
    T* __restrict__ vb, int B, int sweeps, const T* __restrict__ qp = nullptr,
    const T* __restrict__ qm = nullptr, const T* __restrict__ ebt = nullptr,
    const T* __restrict__ ebb = nullptr, T mu0 = T(0)) {
  static_assert(THERMAL || !BEAM, "the beam's particular solution is stage 1's");
  using C = E1<T, N>;
  constexpr int NN = C::NN, TEAM = C::TEAM, S = C::S;
  extern __shared__ __align__(16) unsigned char smem[];
  T* const q = reinterpret_cast<T*>(smem);
  const int pb = threadIdx.x / TEAM, k = threadIdx.x % TEAM;
  const long b = static_cast<long>(blockIdx.x) * C::NPB + pb;
  const bool valid = b < B;
  const long bc = valid ? b : B - 1;
  const int l = blockIdx.y;
  T* const lt = q + C::NQ + pb * C::TS;  // pp, H1, then Lc
  T* const h2 = lt + NN;                 // pm, then H2
  T* const xt = lt + (C::NT - 1) * NN;  // M, then V
  const long mat0 = static_cast<long>(l) * NN * B + bc;
  if (kTilesShared) stage_pp_pm<T, N, TEAM>(pp, pm, mat0, B, k, lt, h2);
  for (int i = threadIdx.x; i < C::NQ; i += kThreads1) q[i] = qtab[i];
  const T* imu = q;
  const T* ei = q + N;
  const T* ri = q + 2 * N;
  const T* dg = q + 3 * N;
  const T* wF = q + 4 * N;
  const T* ff = q + 5 * N;
  const T* sc = q + 5 * N + NN;
  const long mats = static_cast<long>(l) * NN * B + b;  // stores
  const long vec0 = static_cast<long>(l) * N * B + b;
  const long one0 = static_cast<long>(l) * B + bc;
  const T dt = dtau[one0];
  const T c = T(0.5) * om[one0];
  __syncthreads();  // the quadrature table
  constexpr int R = N / TEAM;
  if constexpr (BEAM) {
    // the beam's particular solution of the team's rows: AmB into the X
    // tile (free until Hsym), each thread the entries it staged, then the
    // beam's solve with ApB's rows formed from the staged pp/pm before h12
    // overwrites them
    static_assert(2 * N + 2 <= NN, "z+- and the attenuation fit the X tile");
    const long vec0c = static_cast<long>(l) * N * B + bc;  // loads
    // entry e of pp, or of pm (of_pm), before h12: the staged tiles, or
    // device memory
    auto raw = [&](int e, bool of_pm) -> T {
      if (kTilesShared) return of_pm ? h2[e] : lt[e];
      return (of_pm ? pm : pp)[mat0 + static_cast<long>(e) * B];
    };
    if (kTilesShared) cp_async_wait<0>();
#pragma unroll
    for (int m = 0; m < NN / TEAM; ++m) {
      const int e = k + TEAM * m;
      xt[e] = ab_rn<T, N>(raw(e, false), raw(e, true), true, e, c, ff, dg, sc);
    }
    __syncwarp();  // the team's AmB and staged pp/pm
    T zp[R], zm[R];
    beam_rows<T, N, TEAM>(
        [&](int e) { return ab_rn<T, N>(raw(e, false), raw(e, true), false, e, c, ff, dg, sc); },
        xt, imu, qp, qm, vec0c, B, mu0, k, zp, zm);
    __syncwarp();  // the team has read pp/pm and AmB
    // z+- of row i at entries i and n + i of the X tile, the layer's
    // attenuation at its top and bottom at 2n and 2n + 1: they wait there,
    // not in registers, across the thermal solve
#pragma unroll
    for (int m = 0; m < R; ++m) {
      xt[k + TEAM * m] = zp[m];
      xt[N + k + TEAM * m] = zm[m];
    }
    if (k == 0) {
      xt[2 * N] = ebt[one0];
      xt[2 * N + 1] = ebb[one0];
    }
  }
  if (kTilesShared) h12<T, N, TEAM>(c, ff, dg, k, lt, h2);
  __syncwarp();
  // entry e of H2 (plus) or H1: from its tile, or from pp/pm at each use
  auto H = [&](int e, bool plus) -> T {
    if (kTilesShared) return plus ? h2[e] : lt[e];
    const T u = pp[mat0 + static_cast<long>(e) * B];
    const T v = pm[mat0 + static_cast<long>(e) * B];
    const T ffc = ff[e] * c;
    const T d = e / N == e % N ? dg[e / N] : T(0);
    return plus ? ffc * (u + v) - d : ffc * (u - v) - d;
  };

  if constexpr (THERMAL) {
    // q1 = AmB^-1 tb1/mu, p+r = 2 AmB^-1 tb0/mu (Q), p-r = 2 ApB^-1 q1 (X),
    // with ApB/AmB = sc * H1/H2; thread k stores rows k + TEAM m
    const T t1 = tb1[one0];
    const T t0 = tb0[one0];
    T A[R][N], G[R][2], Q[N][2];
#pragma unroll
    for (int m = 0; m < R; ++m) {
      const int r = k + TEAM * m;
#pragma unroll
      for (int j = 0; j < N; ++j) A[m][j] = sc[r * N + j] * H(r * N + j, true);
      G[m][0] = t1 * imu[r];
      G[m][1] = t0 * imu[r];
    }
    ge_team<T, N, 2, TEAM>(A, G, Q, k);
    T Y[R][1], X[N][1];
#pragma unroll
    for (int m = 0; m < R; ++m) {
      const int r = k + TEAM * m;
#pragma unroll
      for (int j = 0; j < N; ++j) A[m][j] = sc[r * N + j] * H(r * N + j, false);
#pragma unroll
      for (int t = 0; t < TEAM; ++t)
        if (t == k) Y[m][0] = Q[t + TEAM * m][0];
    }
    ge_team<T, N, 1, TEAM>(A, Y, X, k);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      if (valid && i % TEAM == k) {
        const T ppr = T(2) * Q[i][1];
        const T pmr = T(2) * X[i][0];
        const T p0 = T(0.5) * (ppr + pmr);
        const T r0 = T(0.5) * (ppr - pmr);
        const T q1d = Q[i][0] * dt;
        if constexpr (BEAM) {
          // row i's z+- and the attenuation from the X tile
          const T zpi = xt[i], zmi = xt[N + i];
          const T et = xt[2 * N], eb = xt[2 * N + 1];
          ut[vec0 + static_cast<long>(i) * B] = p0 + zpi * et;
          vt[vec0 + static_cast<long>(i) * B] = r0 + zmi * et;
          ub[vec0 + static_cast<long>(i) * B] = p0 + q1d + zpi * eb;
          vb[vec0 + static_cast<long>(i) * B] = r0 + q1d + zmi * eb;
        } else {
          ut[vec0 + static_cast<long>(i) * B] = p0;
          vt[vec0 + static_cast<long>(i) * B] = r0;
          ub[vec0 + static_cast<long>(i) * B] = p0 + q1d;
          vb[vec0 + static_cast<long>(i) * B] = r0 + q1d;
        }
      }
    }
  }

  // Lc = cholesky(-H1), lower; the clamp keeps omega -> 1 finite
  {
    T Lc[N][N];
#pragma unroll
    for (int j = 0; j < N; ++j) {
      T s = -H(j * N + j, false);
#pragma unroll
      for (int kk = 0; kk < j; ++kk) s -= Lc[j][kk] * Lc[j][kk];
      const T d = sqrt(s > T(1e-30) ? s : T(1e-30));
      Lc[j][j] = d;
      const T dinv = T(1) / d;
#pragma unroll
      for (int i = j + 1; i < N; ++i) {
        T s2 = -H(i * N + j, false);
#pragma unroll
        for (int kk = 0; kk < j; ++kk) s2 -= Lc[i][kk] * Lc[j][kk];
        Lc[i][j] = s2 * dinv;
      }
    }
    __syncwarp();  // the team has read H1
#pragma unroll
    for (int e = 0; e < NN; ++e)
      if (e % TEAM == k) lt[e] = e % N <= e / N ? Lc[e / N][e % N] : T(0);
    __syncwarp();
  }

  // M = Hsym = -Lc^T (H2 Lc): the thread's columns m (Lc's columns first
  // held in col), each row of H2 and column of Lc read once for all of
  // them; the upper part (rows i <= m) with its mirror into the X tile.  The
  // sums run in the order of the plain version (terms of Lc's zero upper
  // part add zero)
  T col[S][N];
  {
    int ms[S];
    T tm[S][N];
#pragma unroll
    for (int s = 0; s < S; ++s) {
      ms[s] = slot_player<N, S>(k, s);
#pragma unroll
      for (int kk = 0; kk < N; ++kk) col[s][kk] = lt[kk * N + ms[s]];
    }
#pragma unroll
    for (int i = 0; i < N; ++i) {
      T h[N];
#pragma unroll
      for (int kk = 0; kk < N; ++kk) h[kk] = H(i * N + kk, true);
#pragma unroll
      for (int s = 0; s < S; ++s) {
        T a = T(0);
#pragma unroll
        for (int kk = 0; kk < N; ++kk) a += h[kk] * col[s][kk];
        tm[s][i] = a;
      }
    }
#pragma unroll
    for (int i = 0; i < N; ++i) {
      T lc[N];
#pragma unroll
      for (int j = i; j < N; ++j) lc[j] = lt[j * N + i];
#pragma unroll
      for (int s = 0; s < S; ++s) {
        T a = lc[i] * tm[s][i];
#pragma unroll
        for (int j = i + 1; j < N; ++j) a += lc[j] * tm[s][j];
        if (i <= ms[s]) {
          xt[i * N + ms[s]] = -a;
          xt[ms[s] * N + i] = -a;
        }
      }
    }
  }
  __syncwarp();
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int m = slot_player<N, S>(k, s);
#pragma unroll
    for (int i = 0; i < N; ++i) col[s][i] = xt[i * N + m];
  }
  T vr[S][N];
#pragma unroll
  for (int s = 0; s < S; ++s) {
#pragma unroll
    for (int j = 0; j < N; ++j) vr[s][j] = k * S + s == j ? T(1) : T(0);
  }
  team_sweeps<T, N, TEAM>(col, vr, k, sweeps);

  // the eigenvalue of each of the thread's columns (M's diagonal)
  T kk[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    T d = T(0);
#pragma unroll
    for (int t = 0; t < TEAM; ++t)
      if (t == k) d = col[s][slot_player<N, S>(t, s)];
    kk[s] = sqrt(d > T(1e-24) ? d : T(1e-24));
  }
  __syncwarp();  // the team has read M
#pragma unroll
  for (int s = 0; s < S; ++s) {
#pragma unroll
    for (int j = 0; j < N; ++j) xt[(k * S + s) * N + j] = vr[s][j];
  }
  __syncwarp();
  // per row i, for all the thread's columns j at once (each row of Lc and
  // of wF H2 read once): Y = diag(1/E) Lc V[:, j], then D = diag(1/(mu F))
  // H2 diag(w/F) Y (1/k_j) and G+- = (Y +- D)/2
  int js[S];
  T v[S][N], y[S][N], ik[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    js[s] = slot_player<N, S>(k, s);
    ik[s] = T(1) / kk[s];
    if (valid) {
      if (WRITE_K) kout[vec0 + static_cast<long>(js[s]) * B] = kk[s];
      ek[vec0 + static_cast<long>(js[s]) * B] = exp(-kk[s] * dt);
    }
#pragma unroll
    for (int i = 0; i < N; ++i) v[s][i] = xt[i * N + js[s]];
  }
#pragma unroll
  for (int i = 0; i < N; ++i) {
    T lr[N];
#pragma unroll
    for (int m = 0; m <= i; ++m) lr[m] = lt[i * N + m];
#pragma unroll
    for (int s = 0; s < S; ++s) {
      T a = lr[i] * v[s][i];
#pragma unroll
      for (int m = 0; m < i; ++m) a += lr[m] * v[s][m];
      y[s][i] = ei[i] * a;
    }
  }
  // Y over the thread's own columns of V in the X tile, for the rows of
  // the loop below, whose index is not known at compile time
#pragma unroll
  for (int s = 0; s < S; ++s) {
#pragma unroll
    for (int i = 0; i < N; ++i) xt[i * N + js[s]] = y[s][i];
  }
#pragma unroll 1
  for (int i = 0; i < N; ++i) {
    T wh[N];
#pragma unroll
    for (int m = 0; m < N; ++m) wh[m] = wF[m] * H(i * N + m, true);
#pragma unroll
    for (int s = 0; s < S; ++s) {
      T a = wh[0] * y[s][0];
#pragma unroll
      for (int m = 1; m < N; ++m) a += wh[m] * y[s][m];
      const T D = ri[i] * a * ik[s];
      const T yi = xt[i * N + js[s]];
      if (valid) {
        gp[mats + static_cast<long>(i * N + js[s]) * B] = T(0.5) * (yi + D);
        gm[mats + static_cast<long>(i * N + js[s]) * B] = T(0.5) * (yi - D);
      }
    }
  }
}

// stage 1; the BEAM instance also reads the beam sources qp/qm [layer, n,
// lane] (the (2 - delta_m0) fbeam omega'/4 pi prefactor applied) and the
// beam's attenuation at the layer's top and bottom ebt/ebb [layer, lane];
// without BEAM they are not read (the parameters after sweeps come last, so
// that the instances without the beam keep their machine code)
template <typename T, int N, bool BEAM>
__global__ void __launch_bounds__(kThreads1)
stage1_kernel(const T* __restrict__ pp, const T* __restrict__ pm,
              const T* __restrict__ om, const T* __restrict__ dtau,
              const T* __restrict__ tb0, const T* __restrict__ tb1,
              const T* __restrict__ qtab, T* __restrict__ ek,
              T* __restrict__ gp, T* __restrict__ gm, T* __restrict__ ut,
              T* __restrict__ vt, T* __restrict__ ub, T* __restrict__ vb,
              int B, int sweeps, const T* __restrict__ qp, const T* __restrict__ qm,
              const T* __restrict__ ebt, const T* __restrict__ ebb, T mu0) {
  eigen_stage<T, N, true, false, BEAM>(pp, pm, om, dtau, tb0, tb1, qtab, nullptr, ek, gp, gm, ut,
                                       vt, ub, vb, B, sweeps, qp, qm, ebt, ebb, mu0);
}

// the standalone eigen stage: stage 1 without the particular solution,
// writing k as well
template <typename T, int N>
__global__ void __launch_bounds__(kThreads1)
fused_eigen_kernel(const T* __restrict__ pp, const T* __restrict__ pm,
                   const T* __restrict__ om, const T* __restrict__ dtau,
                   const T* __restrict__ qtab, T* __restrict__ k,
                   T* __restrict__ ek, T* __restrict__ gp, T* __restrict__ gm,
                   int B, int sweeps) {
  eigen_stage<T, N, false, true>(pp, pm, om, dtau, nullptr, nullptr, qtab, k, ek, gp, gm,
                                 nullptr, nullptr, nullptr, nullptr, B, sweeps);
}

// ---------------------------------------------------------------------------
// stages 2+3
// ---------------------------------------------------------------------------

constexpr int kTPL = 8;                    // threads per lane
constexpr int kLanes = 16;                 // lanes per block, 4 per warp
constexpr int kThreads23 = kTPL * kLanes;  // threads per block

// Shared-memory layout of the stage 2+3 kernel, in elements of T.  Every
// region and every per-lane stride is a multiple of 16 bytes.
template <typename T, int N>
struct S23 {
  static constexpr int N2 = 2 * N, NN = N * N;
  static constexpr int NOUT = 4 * N;          // output rows per layer
  static constexpr int PS = (N + 1) * N2;     // scratch per (layer, lane)
  // a thread's columns: c = s kTPL + t for slots s < NS; slots s < ND hold
  // columns of the block D, slot ND one of P's (t < n); y's rows r = t +
  // kTPL m, m < NY, are spread over the lane's threads
  static constexpr int ND = N2 / kTPL, NS = ND + 1, NY = N2 / kTPL;
  // a lane's staged layer; forward: G+, G-, Ek, rhs
  static constexpr int FGP = 0, FGM = NN, FE = 2 * NN, FRHS = 2 * NN + N;
  // backward: S (P columns, then y), G+, G-, Ek, ut, vt, ub, vb
  static constexpr int BGP = PS, BGM = PS + NN, BE = PS + 2 * NN, BU = PS + 2 * NN + N;
  // per-lane tile stride, padded to 4 (mod 32) 4-byte words so that the
  // copies of one row for 8 neighbouring lanes fall in distinct banks
  static constexpr int W0 = (PS + 2 * NN + 5 * N) * int(sizeof(T)) / 4;
  static constexpr int TILE = (W0 + ((4 - W0) % 32 + 32) % 32) * 4 / int(sizeof(T));
  static constexpr int WS = NN + N;           // W [n][n], then uy [n]
  static constexpr int PV = N2 + 4;           // the pivot column, then y's pivot row
  static constexpr int XS = N2 + N;           // y or X [2n], then t [n]
  // region offsets
  static constexpr int O_RS = 2 * kLanes * TILE;
  static constexpr int O_W = O_RS + kLanes * NN;
  static constexpr int O_PV = O_W + kLanes * WS;
  static constexpr int O_X = O_PV + kLanes * 2 * PV;
  static constexpr int O_OUT = O_X + kLanes * XS;
  static constexpr int SIZE = O_OUT + 2 * NOUT * kLanes;
  static_assert(TILE >= 2 * NN + 3 * N, "the forward tile fits");
  static_assert(N2 % kTPL == 0 && N <= kTPL, "columns and rows spread evenly");
};

// copy the ROWS rows of layer l of a [layer, ROWS, B] array for the
// block's lanes into the lane-major tiles: thread t copies lane t % kLanes
// of rows t / kLanes + k kThreads23 / kLanes.  dst is that lane's tile,
// src that lane's first entry (src + b), ok whether the lane exists.
template <typename T, int ROWS>
__device__ __forceinline__ void stage_rows(T* dst, const T* src, int l, int B, bool ok) {
  constexpr int STEP = kThreads23 / kLanes;
  if (!ok) return;
  const int r0 = threadIdx.x / kLanes;
#pragma unroll
  for (int k = 0; k < (ROWS + STEP - 1) / STEP; ++k) {
    const int r = r0 + k * STEP;
    if (ROWS % STEP == 0 || r < ROWS)
      cp_async<sizeof(T)>(dst + r, src + (static_cast<long>(l) * ROWS + r) * B);
  }
}

template <typename T, int N>
__global__ void __launch_bounds__(kThreads23, sizeof(T) == 4 ? 2 : 1)
stage23_kernel(const T* __restrict__ gp, const T* __restrict__ gm,
               const T* __restrict__ ek, const T* __restrict__ rhs,
               const T* __restrict__ rsurf, const T* __restrict__ ut,
               const T* __restrict__ vt, const T* __restrict__ ub,
               const T* __restrict__ vb, T* __restrict__ S,
               T* __restrict__ utop, T* __restrict__ vtop, T* __restrict__ ubot,
               T* __restrict__ vbot, int L, int B) {
  using C = S23<T, N>;
  constexpr int N2 = C::N2, NN = C::NN, PS = C::PS, ND = C::ND, NS = C::NS, NY = C::NY;
  extern __shared__ __align__(16) unsigned char smem[];
  T* const sh = reinterpret_cast<T*>(smem);
  // lane w of the block, thread t of the lane's kTPL; the four lanes of a
  // warp run in step, so a lane past B computes on stale data and stores
  // nothing
  const int w = threadIdx.x / kTPL, t = threadIdx.x % kTPL;
  const int b0 = blockIdx.x * kLanes;
  const long b = b0 + w;
  const bool valid = b < B;
  T* const W = sh + C::O_W + w * C::WS;
  T* const pv = sh + C::O_PV + w * 2 * C::PV;
  T* const X = sh + C::O_X + w * C::XS;
  const T* const Rs = sh + C::O_RS + w * NN;

  auto tile = [&](int buf, int lane) { return sh + (buf * kLanes + lane) * C::TILE; };
  // the lane this thread stages, and whether it exists
  const int sl = threadIdx.x % kLanes;
  const bool sok = b0 + sl < B;
  const long sb = b0 + sl;
  auto stage_fwd = [&](int l, int buf) {
    T* tl = tile(buf, sl);
    stage_rows<T, NN>(tl + C::FGP, gp + sb, l, B, sok);
    stage_rows<T, NN>(tl + C::FGM, gm + sb, l, B, sok);
    stage_rows<T, N>(tl + C::FE, ek + sb, l, B, sok);
    stage_rows<T, N2>(tl + C::FRHS, rhs + sb, l, B, sok);
  };
  // chunks of 16 bytes of the block's S blocks (one contiguous run per
  // layer) that exist
  constexpr int V = 16 / sizeof(T), CH = PS / V, NCH = CH * kLanes;
  const unsigned nch = CH * static_cast<unsigned>(B - b0 < kLanes ? B - b0 : kLanes);
  auto stage_bwd = [&](int l, int buf) {
    const T* src = S + (static_cast<long>(l) * B + b0) * PS;
#pragma unroll
    for (int k = 0; k < (NCH + kThreads23 - 1) / kThreads23; ++k) {
      const unsigned i = threadIdx.x + k * kThreads23;
      if (i < nch) cp_async<16>(tile(buf, i / CH) + (i % CH) * V, src + i * V);
    }
    T* tl = tile(buf, sl);
    stage_rows<T, NN>(tl + C::BGP, gp + sb, l, B, sok);
    stage_rows<T, NN>(tl + C::BGM, gm + sb, l, B, sok);
    stage_rows<T, N>(tl + C::BE, ek + sb, l, B, sok);
    stage_rows<T, N>(tl + C::BU, ut + sb, l, B, sok);
    stage_rows<T, N>(tl + C::BU + N, vt + sb, l, B, sok);
    stage_rows<T, N>(tl + C::BU + 2 * N, ub + sb, l, B, sok);
    stage_rows<T, N>(tl + C::BU + 3 * N, vb + sb, l, B, sok);
  };

  // Rsurf, the first layer, and W = uy = t = 0
  for (int i = threadIdx.x; i < NN * kLanes; i += kThreads23) {
    const int r = i / kLanes, lane = i % kLanes;
    if (b0 + lane < B)
      cp_async<sizeof(T)>(sh + C::O_RS + lane * NN + r, rsurf + static_cast<long>(r) * B + b0 + lane);
  }
  stage_fwd(0, 0);
  cp_async_commit();
  for (int i = threadIdx.x; i < kLanes * C::WS; i += kThreads23) sh[C::O_W + i] = T(0);
  for (int i = threadIdx.x; i < kLanes * C::XS; i += kThreads23) sh[C::O_X + i] = T(0);
  cp_async_wait<0>();
  __syncthreads();

  // forward elimination over the layers
#pragma unroll 1
  for (int l = 0; l < L; ++l) {
    const int buf = l & 1;
    if (l + 1 < L) stage_fwd(l + 1, buf ^ 1);
    cp_async_commit();
    const T* const tf = tile(buf, w);
    T col[NS][N2], yv[NY];
    {
      // D's columns c = s kTPL + t, s < ND, from column kk of G+ and G-:
      // U = [GmE | Gp], T = -[Gp | GmE]
      T x[ND][N], y[ND][N], we[ND], wb[ND];
#pragma unroll
      for (int s = 0; s < ND; ++s) {
        const int c = s * kTPL + t, kk = c < N ? c : c - N;
        const T e = tf[C::FE + kk];
        we[s] = c < N ? T(1) : e;
        wb[s] = c < N ? e : T(1);
        const int ox = c < N ? C::FGP : C::FGM, oy = c < N ? C::FGM : C::FGP;
#pragma unroll
        for (int m = 0; m < N; ++m) {
          x[s][m] = tf[ox + m * N + kk];
          y[s][m] = tf[oy + m * N + kk];
        }
      }
      // A rows: W (-T) - [Gm | GpE]
#pragma unroll
      for (int i = 0; i < N; ++i) {
        T wr[N];
        ld16(W + i * N, wr);
#pragma unroll
        for (int s = 0; s < ND; ++s) {
          T a = wr[0] * (x[s][0] * we[s]);
#pragma unroll
          for (int m = 1; m < N; ++m) a += wr[m] * (x[s][m] * we[s]);
          col[s][i] = a - y[s][i] * we[s];
        }
      }
      // B rows: [GpE | Gm], minus Rsurf U at the surface
#pragma unroll
      for (int s = 0; s < ND; ++s) {
#pragma unroll
        for (int i = 0; i < N; ++i) col[s][N + i] = x[s][i] * wb[s];
      }
      if (l == L - 1) {
#pragma unroll
        for (int i = 0; i < N; ++i) {
          T rr[N];
          ld16(Rs + i * N, rr);
#pragma unroll
          for (int s = 0; s < ND; ++s) {
            T a = rr[0] * (y[s][0] * wb[s]);
#pragma unroll
            for (int m = 1; m < N; ++m) a += rr[m] * (y[s][m] * wb[s]);
            col[s][N + i] -= a;
          }
        }
      }
      // P's column j = t: [0; e_j]
#pragma unroll
      for (int r = 0; r < N2; ++r) col[ND][r] = t < N && r == N + t ? T(1) : T(0);
      // y's rows: [rhs_top - uy; rhs_bot]
#pragma unroll
      for (int m = 0; m < NY; ++m) {
        const int r = t + kTPL * m;
        yv[m] = tf[C::FRHS + r] - (r < N ? W[NN + r] : T(0));
      }
    }

    // Gauss-Jordan without pivoting: thread i % kTPL hands out column i
    // and y's row i; every column c > i and every row of y takes the step
    // (a column c <= i is never read again, so a slot whose columns are
    // all done is skipped)
#pragma unroll
    for (int i = 0; i < N2; ++i) {
      T* const slot = pv + (i & 1) * C::PV;
      if (t == i % kTPL) {
        st16(slot, col[i / kTPL]);
        slot[N2] = yv[i / kTPL];
      }
      __syncwarp();
      T p[N2];
      ld16(slot, p);
      const T inv = recip(p[i]);
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        if (s < ND && s * kTPL + kTPL - 1 <= i) continue;
        const T xi = col[s][i] * inv;
#pragma unroll
        for (int r = 0; r < N2; ++r)
          if (r != i) col[s][r] -= p[r] * xi;
        col[s][i] = xi;
      }
      const T yi = slot[N2] * inv;
#pragma unroll
      for (int m = 0; m < NY; ++m) {
        const int r = t + kTPL * m;
        yv[m] = r == i ? yi : yv[m] - slot[r] * yi;
      }
    }

    // the solution: P's column t and y's rows, to the scratch and (y) to
    // shared memory
    T* const Sl = S + (static_cast<long>(l) * B + b) * PS;
    if (valid && t < N) st16(Sl + t * N2, col[ND]);
#pragma unroll
    for (int m = 0; m < NY; ++m) {
      if (valid) Sl[N * N2 + t + kTPL * m] = yv[m];
      X[t + kTPL * m] = yv[m];
    }
    __syncwarp();
    // W = U P (column t, from the thread's own P column) and uy = U y (row
    // t, from y in shared memory)
    if (t < N) {
      T e[N], yy[N2];
      ld16(tf + C::FE, e);
      ld16(X, yy);
      T wc[N];
#pragma unroll
      for (int i = 0; i < N; ++i) {
        T g1[N], g2[N];
        ld16(tf + C::FGM + i * N, g1);
        ld16(tf + C::FGP + i * N, g2);
        T a = (g1[0] * e[0]) * col[ND][0];
#pragma unroll
        for (int k = 1; k < N; ++k) a += (g1[k] * e[k]) * col[ND][k];
#pragma unroll
        for (int k = 0; k < N; ++k) a += g2[k] * col[ND][N + k];
        wc[i] = a;
      }
      T g1[N], g2[N];
      ld16(tf + C::FGM + t * N, g1);
      ld16(tf + C::FGP + t * N, g2);
      T a = (g1[0] * e[0]) * yy[0];
#pragma unroll
      for (int k = 1; k < N; ++k) a += (g1[k] * e[k]) * yy[k];
#pragma unroll
      for (int k = 0; k < N; ++k) a += g2[k] * yy[N + k];
#pragma unroll
      for (int i = 0; i < N; ++i) W[i * N + t] = wc[i];
      W[NN + t] = a;
    }
    cp_async_wait<0>();
    __syncthreads();
  }

  // back-substitution and level radiances, surface to TOA; t = 0 below
  // the surface layer
  for (int i = threadIdx.x; i < kLanes * C::XS; i += kThreads23) sh[C::O_X + i] = T(0);
  stage_bwd(L - 1, 0);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
#pragma unroll 1
  for (int l = L - 1; l >= 0; --l) {
    const int buf = (L - 1 - l) & 1;
    if (l > 0) stage_bwd(l - 1, buf ^ 1);
    cp_async_commit();
    T* const ot = sh + C::O_OUT + buf * C::NOUT * kLanes;
    const T* const tb = tile(buf, w);
    {
      // X = y - P t, rows t + kTPL m
      T tt[N];
      ld16(X + N2, tt);
      T xv[NY];
#pragma unroll
      for (int m = 0; m < NY; ++m) {
        const int k = t + kTPL * m;
        T v = tb[k] * tt[0];
#pragma unroll
        for (int j = 1; j < N; ++j) v += tb[j * N2 + k] * tt[j];
        xv[m] = tb[N * N2 + k] - v;
      }
      __syncwarp();  // t is read
#pragma unroll
      for (int m = 0; m < NY; ++m) X[t + kTPL * m] = xv[m];
    }
    __syncwarp();
    if (t < N) {
      // row t of utop = Gp Cp + GmE Cm + ut, vtop = Gm Cp + GpE Cm + vt,
      // ubot = GpE Cp + Gm Cm + ub, vbot = GmE Cp + Gp Cm + vb
      T gpr[N], gmr[N], e[N], xp[N], xm[N];
      ld16(tb + C::BGP + t * N, gpr);
      ld16(tb + C::BGM + t * N, gmr);
      ld16(tb + C::BE, e);
      ld16(X, xp);
      ld16(X + N, xm);
      T s[4][2];
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const T gpe = gpr[j] * e[j], gme = gmr[j] * e[j];
        const T f[4][2] = {{gpr[j], gme}, {gmr[j], gpe}, {gpe, gmr[j]}, {gme, gpr[j]}};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          s[q][0] = j == 0 ? f[q][0] * xp[0] : s[q][0] + f[q][0] * xp[j];
          s[q][1] = j == 0 ? f[q][1] * xm[0] : s[q][1] + f[q][1] * xm[j];
        }
      }
#pragma unroll
      for (int q = 0; q < 4; ++q)
        ot[(q * N + t) * kLanes + w] = s[q][0] + s[q][1] + tb[C::BU + q * N + t];
      X[N2 + t] = -(s[0][0] + s[0][1]);  // carry to the layer above
    }
    cp_async_wait<0>();
    __syncthreads();
    // the block's outputs of layer l, lanes contiguous
#pragma unroll
    for (int k = 0; k < (C::NOUT * kLanes + kThreads23 - 1) / kThreads23; ++k) {
      const int i = threadIdx.x + k * kThreads23;
      const int r = i / kLanes, lane = i % kLanes, q = r / N;
      if (i < C::NOUT * kLanes && b0 + lane < B) {
        T* const out = q == 0 ? utop : q == 1 ? vtop : q == 2 ? ubot : vbot;
        out[(static_cast<long>(l) * N + r % N) * B + b0 + lane] = ot[i];
      }
    }
  }
}

// the eigen kernels' dynamic shared memory, with the attribute set where
// it passes the default 48 KB
template <typename T, int N, typename K>
int eigen_smem(K kernel, size_t& smem) {
  smem = E1<T, N>::SIZE * sizeof(T);
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem)));
}

template <typename T, int N, bool BEAM>
int launch_stage1(const void* const* a, void* const* o, int L, int B,
                  int sweeps, double mu0, cudaStream_t s) {
  size_t smem;
  if (const int e = eigen_smem<T, N>(stage1_kernel<T, N, BEAM>, smem)) return e;
  const dim3 grid((B + E1<T, N>::NPB - 1) / E1<T, N>::NPB, L);
  stage1_kernel<T, N, BEAM><<<grid, kThreads1, smem, s>>>(
      static_cast<const T*>(a[0]), static_cast<const T*>(a[1]),
      static_cast<const T*>(a[2]), static_cast<const T*>(a[3]),
      static_cast<const T*>(a[4]), static_cast<const T*>(a[5]),
      static_cast<const T*>(a[6]), static_cast<T*>(o[0]),
      static_cast<T*>(o[1]), static_cast<T*>(o[2]), static_cast<T*>(o[3]),
      static_cast<T*>(o[4]), static_cast<T*>(o[5]), static_cast<T*>(o[6]),
      B, sweeps, static_cast<const T*>(a[7]), static_cast<const T*>(a[8]),
      static_cast<const T*>(a[9]), static_cast<const T*>(a[10]), static_cast<T>(mu0));
  return static_cast<int>(cudaGetLastError());
}

// blocks of stage 1 resident at once on one SM of the current card, and
// its dynamic shared memory per block
template <typename T, int N, bool BEAM>
int occupancy1(int* blocks, int* smem_bytes) {
  size_t smem;
  if (const int e = eigen_smem<T, N>(stage1_kernel<T, N, BEAM>, smem)) return e;
  *smem_bytes = static_cast<int>(smem);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, stage1_kernel<T, N, BEAM>, kThreads1, smem));
}

template <typename T>
int occupancy(int n, int beam, int* blocks, int* smem_bytes) {
  if (n == 8) return beam ? occupancy1<T, 8, true>(blocks, smem_bytes)
                          : occupancy1<T, 8, false>(blocks, smem_bytes);
  if (n == 4) return beam ? occupancy1<T, 4, true>(blocks, smem_bytes)
                          : occupancy1<T, 4, false>(blocks, smem_bytes);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T, int N>
int launch_stage23(const void* const* a, void* const* o, int L, int B,
                   cudaStream_t s) {
  const size_t smem = S23<T, N>::SIZE * sizeof(T);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        stage23_kernel<T, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  stage23_kernel<T, N><<<(B + kLanes - 1) / kLanes, kThreads23, smem, s>>>(
      static_cast<const T*>(a[0]), static_cast<const T*>(a[1]),
      static_cast<const T*>(a[2]), static_cast<const T*>(a[3]),
      static_cast<const T*>(a[4]), static_cast<const T*>(a[5]),
      static_cast<const T*>(a[6]), static_cast<const T*>(a[7]),
      static_cast<const T*>(a[8]), static_cast<T*>(o[0]),
      static_cast<T*>(o[1]), static_cast<T*>(o[2]), static_cast<T*>(o[3]),
      static_cast<T*>(o[4]), L, B);
  return static_cast<int>(cudaGetLastError());
}

// the beam instance when qp is given (then qm, ebt, ebb too, and mu0 > 0)
template <typename T>
int stage1(const void* pp, const void* pm, const void* om, const void* dtau,
           const void* tb0, const void* tb1, const void* qtab, void* ek,
           void* gp, void* gm, void* ut, void* vt, void* ub, void* vb, int n,
           int L, int B, int sweeps, const void* qp, const void* qm, const void* ebt,
           const void* ebb, double mu0, void* stream) {
  const void* a[] = {pp, pm, om, dtau, tb0, tb1, qtab, qp, qm, ebt, ebb};
  void* o[] = {ek, gp, gm, ut, vt, ub, vb};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool beam = qp != nullptr;
  if (beam && (!qm || !ebt || !ebb || !(mu0 > 0.0))) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 8) return beam ? launch_stage1<T, 8, true>(a, o, L, B, sweeps, mu0, s)
                          : launch_stage1<T, 8, false>(a, o, L, B, sweeps, mu0, s);
  if (n == 4) return beam ? launch_stage1<T, 4, true>(a, o, L, B, sweeps, mu0, s)
                          : launch_stage1<T, 4, false>(a, o, L, B, sweeps, mu0, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int stage23(const void* gp, const void* gm, const void* ek, const void* rhs,
            const void* rsurf, const void* ut, const void* vt, const void* ub,
            const void* vb, void* S, void* utop, void* vtop, void* ubot,
            void* vbot, int n, int L, int B, void* stream) {
  const void* a[] = {gp, gm, ek, rhs, rsurf, ut, vt, ub, vb};
  void* o[] = {S, utop, vtop, ubot, vbot};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n == 8) return launch_stage23<T, 8>(a, o, L, B, s);
  if (n == 4) return launch_stage23<T, 4>(a, o, L, B, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T, int N>
int launch_eigen(const void* const* a, void* const* o, int L, int B, int sweeps,
                 cudaStream_t s) {
  size_t smem;
  if (const int e = eigen_smem<T, N>(fused_eigen_kernel<T, N>, smem)) return e;
  const dim3 grid((B + E1<T, N>::NPB - 1) / E1<T, N>::NPB, L);
  fused_eigen_kernel<T, N><<<grid, kThreads1, smem, s>>>(
      static_cast<const T*>(a[0]), static_cast<const T*>(a[1]),
      static_cast<const T*>(a[2]), static_cast<const T*>(a[3]),
      static_cast<const T*>(a[4]), static_cast<T*>(o[0]), static_cast<T*>(o[1]),
      static_cast<T*>(o[2]), static_cast<T*>(o[3]), B, sweeps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int eigen(const void* pp, const void* pm, const void* om, const void* dtau,
          const void* qtab, void* k, void* ek, void* gp, void* gm, int n, int L,
          int B, int sweeps, void* stream) {
  const void* a[] = {pp, pm, om, dtau, qtab};
  void* o[] = {k, ek, gp, gm};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n == 8) return launch_eigen<T, 8>(a, o, L, B, sweeps, s);
  if (n == 4) return launch_eigen<T, 4>(a, o, L, B, sweeps, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

#define EIGEN_ARGS                                                         \
  const void *pp, const void *pm, const void *om, const void *dtau,        \
      const void *qtab, void *k, void *ek, void *gp, void *gm, int n,      \
      int L, int B, int sweeps, void *stream
#define STAGE1_ARGS                                                        \
  const void *pp, const void *pm, const void *om, const void *dtau,        \
      const void *tb0, const void *tb1, const void *qtab, void *ek,        \
      void *gp, void *gm, void *ut, void *vt, void *ub, void *vb, int n,   \
      int L, int B, int sweeps, const void *qp, const void *qm,            \
      const void *ebt, const void *ebb, double mu0, void *stream
#define STAGE23_ARGS                                                       \
  const void *gp, const void *gm, const void *ek, const void *rhs,         \
      const void *rsurf, const void *ut, const void *vt, const void *ub,   \
      const void *vb, void *S, void *utop, void *vtop, void *ubot,         \
      void *vbot, int n, int L, int B, void *stream

extern "C" int disort_stage1_f32(STAGE1_ARGS) {
  return stage1<float>(pp, pm, om, dtau, tb0, tb1, qtab, ek, gp, gm, ut, vt,
                       ub, vb, n, L, B, sweeps, qp, qm, ebt, ebb, mu0, stream);
}
extern "C" int disort_stage1_f64(STAGE1_ARGS) {
  return stage1<double>(pp, pm, om, dtau, tb0, tb1, qtab, ek, gp, gm, ut, vt,
                        ub, vb, n, L, B, sweeps, qp, qm, ebt, ebb, mu0, stream);
}
extern "C" int disort_stage1_occupancy_f32(int n, int beam, int* blocks, int* smem_bytes) {
  return occupancy<float>(n, beam, blocks, smem_bytes);
}
extern "C" int disort_stage1_occupancy_f64(int n, int beam, int* blocks, int* smem_bytes) {
  return occupancy<double>(n, beam, blocks, smem_bytes);
}
extern "C" int disort_stage23_f32(STAGE23_ARGS) {
  return stage23<float>(gp, gm, ek, rhs, rsurf, ut, vt, ub, vb, S, utop, vtop,
                        ubot, vbot, n, L, B, stream);
}
extern "C" int disort_stage23_f64(STAGE23_ARGS) {
  return stage23<double>(gp, gm, ek, rhs, rsurf, ut, vt, ub, vb, S, utop, vtop,
                         ubot, vbot, n, L, B, stream);
}
extern "C" int fused_eigen_f32(EIGEN_ARGS) {
  return eigen<float>(pp, pm, om, dtau, qtab, k, ek, gp, gm, n, L, B, sweeps,
                      stream);
}
extern "C" int fused_eigen_f64(EIGEN_ARGS) {
  return eigen<double>(pp, pm, om, dtau, qtab, k, ek, gp, gm, n, L, B, sweeps,
                       stream);
}
