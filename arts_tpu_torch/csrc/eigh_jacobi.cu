// Batched symmetric eigendecomposition of small matrices for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel arts_tpu/ops/eigh_jacobi.py:
// eigh_jacobi_pallas (pallas_call at :235, body _jacobi_kernel at :156):
// A = V diag(w) V^T for B symmetric n x n matrices, n <= 16, by `sweeps`
// sweeps of the tournament cyclic Jacobi with the division-safe rotation,
// eigenvalues in ascending order (stable: ties keep their index order, as
// a stable argsort does).
//
// Layout: A is the caller's row-major [B, n, n]; w comes back as [B, n] and
// V as [B, n, n] (column j the eigenvector of w_j).  A block's matrices are
// one contiguous run of A, V and w, so its loads (cp.async into per-matrix
// shared tiles) and its stores (through the same tiles) coalesce.
//
// Design: the team eigen core of the DISORT eigen stage (csrc/jacobi.cuh:
// team_sweeps), a team of TEAM threads per matrix in registers, one
// instance per even number of players N = 4, 6, ..., 16: n is padded with
// zero rows and columns to N = n + 1 for odd n, and to 4 below, as dummy
// players.  A pair with a zero off-diagonal rotates by the identity (t = 0,
// c = 1, s = 0), so with one dummy the rounds and rotations are those of
// _tournament(n) (n <= 2 turns at most one real pair a round, so its order
// is the same too), and the dummies are dropped from the sort by position.
// Thread k holds S = team_slots(N, TEAM) columns of M in seat order, two
// per pair slot (where TEAM does not divide N/2 the last slots are idle),
// and rows k S .. k S + S - 1 of V; float32 turns by rot_fast up to N = 8
// and with the plain version's exact arithmetic above (kExact), float64 by
// rot_cs.  After the sweeps every thread gathers the N diagonal entries by
// shuffle and ranks the real ones; the team writes V's columns and w by
// rank into the tile, and the block stores its run.  Matrices past B
// compute on zeros and store nothing (the shuffles need the whole team).
//
// Bound: operations.  A rotation pair costs ~16 operations for its angle
// and 18 n for the row, column and V updates; with n/2 pairs, n - 1 rounds
// and 6 sweeps at n = 8 that is 26,880 operations per matrix against 544
// bytes in and out (float32).  The sweeps are issue-bound (shuffles,
// selects and moves beside the rotations' multiplies and FMAs).

#include <cuda_runtime.h>

#include "async.cuh"
#include "jacobi.cuh"

namespace {

using async::cp_async;
using async::cp_async_commit;
using async::cp_async_wait;
using jacobi::slot_player;
using jacobi::team_sweeps;

constexpr int kThreads = 128;  // threads per block
constexpr unsigned kFull = 0xffffffffu;

// values of M per thread that set the team size: float32 32, float64 16
// (PERF.md: the team sizes measured)
template <typename T>
constexpr int kColValues = sizeof(T) == 4 ? 32 : 16;

// float32 instances from N = 10 on turn with the plain version's arithmetic
// (team_sweeps' EXACT: IEEE angles, no FMA), bit for bit its results: at
// those sizes the float32 sweeps' own rounding reaches the 2e-6 tolerance,
// so two roundings of them differ by as much (PERF.md)
template <typename T, int N>
constexpr bool kExact = sizeof(T) == 4 && N >= 10;

// players of the instance that takes n x n matrices: n, or n + 1 for odd n
// (a zero dummy), at least 4
constexpr int players(int n) { return n <= 4 ? 4 : n + (n & 1); }

// threads per matrix at N players: the smallest team of 2, 4 or 8 (at most
// N) whose threads hold at most kColValues values of M each
template <typename T, int N>
constexpr int team_size() {
  int team = 2;
  while (team < 8 && 2 * team <= N && jacobi::team_slots(N, team) * N > kColValues<T>) team *= 2;
  return team;
}

// Shared-memory layout, in elements of T: per matrix one tile of N N + N
// (M in, then V at i n + j and w at N N), the stride padded to TEAM (mod 32)
// 4-byte words so that the same entry of a warp's matrices falls in distinct
// banks.
template <typename T, int N>
struct Cfg {
  static constexpr int NN = N * N, TEAM = team_size<T, N>();
  static constexpr int S = jacobi::team_slots(N, TEAM);  // columns of M, rows of V, per thread
  static constexpr int NPB = kThreads / TEAM;   // matrices per block
  static constexpr int W0 = (NN + N) * int(sizeof(T)) / 4, Q = TEAM * int(sizeof(T)) / 4;
  static constexpr int TS = (W0 + ((Q - W0) % 32 + 32) % 32) * 4 / int(sizeof(T));
  static constexpr int SIZE = NPB * TS;
  static_assert(32 % TEAM == 0 && S > 1, "a warp holds whole teams, a thread whole pairs");
};

template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
eigh_team_kernel(const T* __restrict__ a, T* __restrict__ w, T* __restrict__ v, int n, int B,
                 int nsweeps) {
  using C = Cfg<T, N>;
  constexpr int NN = C::NN, TEAM = C::TEAM, S = C::S;
  extern __shared__ __align__(16) unsigned char smem[];
  T* const tiles = reinterpret_cast<T*>(smem);
  const int pb = threadIdx.x / TEAM, k = threadIdx.x % TEAM;
  const long b0 = static_cast<long>(blockIdx.x) * C::NPB;
  const int nn = n * n;

  // the block's matrices into their tiles, entry (i, j) at i N + j; zeros
  // in the dummy rows and columns and for matrices past B
#pragma unroll
  for (int u0 = 0; u0 < C::NPB * NN; u0 += kThreads) {
    const int u = u0 + threadIdx.x, m = u / NN, i = u / N % N, j = u % N;
    if (C::NPB * NN % kThreads && u >= C::NPB * NN) break;
    T* const dst = tiles + m * C::TS + i * N + j;
    if (i < n && j < n && b0 + m < B)
      cp_async<sizeof(T)>(dst, a + (b0 + m) * nn + i * n + j);
    else
      *dst = T(0);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // the thread's columns of M, rows in seat order (at the start of a sweep
  // seat r holds player r; idle slots zero), and its rows of V
  T* const tile = tiles + pb * C::TS;
  T col[S][N], vr[S][N];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int m = slot_player<N, S>(k, s);
    const bool real = k * (S / 2) + s / 2 < N / 2;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      col[s][i] = real ? tile[i * N + m] : T(0);
      vr[s][i] = k * S + s == i ? T(1) : T(0);
    }
  }
  team_sweeps<T, N, TEAM, kExact<T, N>>(col, vr, k, nsweeps);

  // every player's diagonal entry on every thread: the thread's own (a
  // chain of selects over the team), then by shuffle
  T dk[S], d[N];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    T x = T(0);
#pragma unroll
    for (int t = 0; t < TEAM; ++t)
      if (t == k) x = col[s][slot_player<N, S>(t, s)];
    dk[s] = x;
  }
#pragma unroll
  for (int t = 0; t < TEAM; ++t) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const T x = __shfl_sync(kFull, dk[s], t, TEAM);
      if (t * (S / 2) + s / 2 < N / 2) d[slot_player<N, S>(t, s)] = x;
    }
  }
  // stable ascending rank of each real player among the real players
  int rk[N];
#pragma unroll
  for (int p = 0; p < N; ++p) {
    int r = 0;
#pragma unroll
    for (int q = 0; q < N; ++q) r += q < n && (d[q] < d[p] || (q < p && d[q] == d[p]));
    rk[p] = r;
  }

  // V's rows and w by rank through the tile, then the block's run of each
  __syncwarp();  // the team has read its columns
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int i = k * S + s;
#pragma unroll
    for (int p = 0; p < N; ++p)
      if (i < n && p < n) tile[i * n + rk[p]] = vr[s][p];
  }
#pragma unroll
  for (int p = 0; p < N; ++p)
    if (p % TEAM == k && p < n) tile[NN + rk[p]] = d[p];
  __syncthreads();
#pragma unroll
  for (int u0 = 0; u0 < C::NPB * NN; u0 += kThreads) {
    const int u = u0 + threadIdx.x, m = u / NN, e = u % NN;
    if (C::NPB * NN % kThreads && u >= C::NPB * NN) break;
    if (e < nn && b0 + m < B) v[(b0 + m) * nn + e] = tiles[m * C::TS + e];
  }
#pragma unroll
  for (int u0 = 0; u0 < C::NPB * N; u0 += kThreads) {
    const int u = u0 + threadIdx.x, m = u / N, e = u % N;
    if (C::NPB * N % kThreads && u >= C::NPB * N) break;
    if (e < n && b0 + m < B) w[(b0 + m) * n + e] = tiles[m * C::TS + NN + e];
  }
}

template <typename T, int N>
int launch(const void* a, void* w, void* v, int n, int B, int nsweeps, cudaStream_t s) {
  using C = Cfg<T, N>;
  const size_t smem = C::SIZE * sizeof(T);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        eigh_team_kernel<T, N>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  eigh_team_kernel<T, N><<<(B + C::NPB - 1) / C::NPB, kThreads, smem, s>>>(
      static_cast<const T*>(a), static_cast<T*>(w), static_cast<T*>(v), n, B, nsweeps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int eigh(const void* a, void* w, void* v, int n, int B, int nsweeps, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n < 1 || n > 16 || B < 1) return static_cast<int>(cudaErrorInvalidValue);
  switch (players(n)) {
    case 4: return launch<T, 4>(a, w, v, n, B, nsweeps, s);
    case 6: return launch<T, 6>(a, w, v, n, B, nsweeps, s);
    case 8: return launch<T, 8>(a, w, v, n, B, nsweeps, s);
    case 10: return launch<T, 10>(a, w, v, n, B, nsweeps, s);
    case 12: return launch<T, 12>(a, w, v, n, B, nsweeps, s);
    case 14: return launch<T, 14>(a, w, v, n, B, nsweeps, s);
    default: return launch<T, 16>(a, w, v, n, B, nsweeps, s);
  }
}

}  // namespace

// a [B, n, n] -> w [B, n], v [B, n, n]; returns the launch's CUDA error code
extern "C" int eigh_jacobi_f32(const void* a, void* w, void* v, int n, int B,
                               int nsweeps, void* stream) {
  return eigh<float>(a, w, v, n, B, nsweeps, stream);
}
extern "C" int eigh_jacobi_f64(const void* a, void* w, void* v, int n, int B,
                               int nsweeps, void* stream) {
  return eigh<double>(a, w, v, n, B, nsweeps, stream);
}
