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
// Stage 1 and fused_eigen share the device functions h12 and eigen_core
// below; the Jacobi sweeps are csrc/jacobi.cuh's, shared with
// csrc/eigh_jacobi.cu.
//
// Layout: every (frequency x Fourier mode) problem is a lane b; arrays are
// [layer, entry, lane], so the threads of a warp, which hold neighbouring
// lanes, read and write neighbouring addresses.
//
// Stage 1, one thread per (lane, layer): H1/H2 from the phase matrices,
// the thermal particular solution (ApB/AmB solves; done first so that H1
// is dead before the eigen stage), Cholesky of -H1, Hsym = -Lc^T H2 Lc,
// the tournament cyclic Jacobi (6 sweeps at f32, 8 at f64) with the
// division-safe rotation, k = sqrt(max(lambda, 1e-24)), Ek = exp(-k dtau),
// and G+/G-.  Writes Ek, G+-, and the particular radiances.
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
// layer) in float32), so at the bench shape its memory bound is a fraction
// of a millisecond; its arithmetic (~32 kflop per problem, mostly the
// Jacobi sweeps) is of the same order.  What limits stage 1 in this simple
// form is neither: a thread holds several 8 x 8 matrices, which spill from
// registers to local memory.  Stages 2+3 move their inputs and outputs
// once, plus the scratch S (written once, read once) and G+-/Ek read a
// second time, ~620 MB at the bench shape in float32 (~0.19 ms at 3.35
// TB/s); the least arithmetic is ~3.1 GFLOP.  Each Gauss-Jordan step is a
// dependency chain through shared memory, and 4096 lanes make only 1024
// warps, 8 per SM: the kernel hides that latency with the independent
// columns of a thread, not with other warps.

#include <cuda_runtime.h>

#include "async.cuh"
#include "jacobi.cuh"

namespace {

using async::cp_async;
using async::cp_async_commit;
using async::cp_async_wait;
using async::ld16;
using async::st16;

// Gaussian elimination without pivoting, A X = B; X overwrites B
template <typename T, int N, int K>
__device__ __forceinline__ void ge_solve(T (&A)[N][N], T (&B)[N][K]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const T inv = T(1) / A[i][i];
#pragma unroll
    for (int j = i + 1; j < N; ++j) A[i][j] *= inv;
#pragma unroll
    for (int j = 0; j < K; ++j) B[i][j] *= inv;
#pragma unroll
    for (int r = i + 1; r < N; ++r) {
      const T f = A[r][i];
#pragma unroll
      for (int j = i + 1; j < N; ++j) A[r][j] -= f * A[i][j];
#pragma unroll
      for (int j = 0; j < K; ++j) B[r][j] -= f * B[i][j];
    }
  }
#pragma unroll
  for (int i = N - 1; i >= 0; --i) {
#pragma unroll
    for (int j = 0; j < K; ++j) {
      T acc = B[i][j];
#pragma unroll
      for (int r = i + 1; r < N; ++r) acc -= A[i][r] * B[r][j];
      B[i][j] = acc;
    }
  }
}

// qtab (arts_tpu_torch/disort/fused_kernel.py:quad_table): 1/mu, 1/E,
// 1/(mu F), F^2/w, w/F (n each), then F_i F_j and -w_j/(F_i F_j mu_i)
template <typename T, int N>
__device__ __forceinline__ void load_qtab(const T* __restrict__ qtab, T* q) {
  constexpr int NQ = 5 * N + 2 * N * N;
  for (int i = threadIdx.x; i < NQ; i += blockDim.x) q[i] = qtab[i];
  __syncthreads();
}

// H1/H2 = F (c (Pp -/+ Pm) - diag(1/w)) F for the problem at mat0
template <typename T, int N>
__device__ __forceinline__ void h12(const T* __restrict__ pp, const T* __restrict__ pm,
                                    long mat0, long B, T c, const T* ff, const T* dg,
                                    T (&H1)[N][N], T (&H2)[N][N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const T a = pp[mat0 + static_cast<long>(i * N + j) * B];
      const T m = pm[mat0 + static_cast<long>(i * N + j) * B];
      const T ffc = ff[i * N + j] * c;
      const T d = i == j ? dg[i] : T(0);
      H1[i][j] = ffc * (a - m) - d;
      H2[i][j] = ffc * (a + m) - d;
    }
  }
}

// The eigen stage of one problem: Cholesky of -H1, Hsym = -Lc^T H2 Lc, the
// tournament Jacobi, k = sqrt(max(lambda, 1e-24)), Ek = exp(-k dtau) and
// G+-, written at vec0 ([layer, n, lane]) and mat0 ([layer, n*n, lane]).
// With WRITE_K, k itself is written to kout as well.
template <typename T, int N, bool WRITE_K>
__device__ __forceinline__ void eigen_core(const T (&H1)[N][N], const T (&H2)[N][N],
                                           T dt, const T* ei, const T* ri, const T* wF,
                                           int sweeps, long vec0, long mat0, long B,
                                           T* __restrict__ kout, T* __restrict__ ek,
                                           T* __restrict__ gp, T* __restrict__ gm) {
  // Lc = cholesky(-H1), lower; the clamp keeps omega -> 1 finite
  T Lc[N][N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    T s = -H1[j][j];
#pragma unroll
    for (int k = 0; k < j; ++k) s -= Lc[j][k] * Lc[j][k];
    const T d = sqrt(s > T(1e-30) ? s : T(1e-30));
    Lc[j][j] = d;
    const T dinv = T(1) / d;
#pragma unroll
    for (int i = j + 1; i < N; ++i) {
      T s2 = -H1[i][j];
#pragma unroll
      for (int k = 0; k < j; ++k) s2 -= Lc[i][k] * Lc[j][k];
      Lc[i][j] = s2 * dinv;
    }
  }

  // M = Hsym = -Lc^T (H2 Lc), symmetric
  T M[N][N];
  {
    T Tm[N][N];
#pragma unroll
    for (int i = 0; i < N; ++i) {
#pragma unroll
      for (int m = 0; m < N; ++m) {
        T s = H2[i][m] * Lc[m][m];
#pragma unroll
        for (int k = m + 1; k < N; ++k) s += H2[i][k] * Lc[k][m];
        Tm[i][m] = s;
      }
    }
#pragma unroll
    for (int i = 0; i < N; ++i) {
#pragma unroll
      for (int m = i; m < N; ++m) {
        T s = Lc[i][i] * Tm[i][m];
#pragma unroll
        for (int j = i + 1; j < N; ++j) s += Lc[j][i] * Tm[j][m];
        M[i][m] = -s;
        M[m][i] = -s;
      }
    }
  }

  T V[N][N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = 0; j < N; ++j) V[i][j] = i == j ? T(1) : T(0);
  }
  jacobi::sweeps<T, N>(M, V, N, sweeps);

  T kk[N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    kk[j] = sqrt(M[j][j] > T(1e-24) ? M[j][j] : T(1e-24));
    if (WRITE_K) kout[vec0 + static_cast<long>(j) * B] = kk[j];
    ek[vec0 + static_cast<long>(j) * B] = exp(-kk[j] * dt);
  }

  // Y = diag(1/E) Lc V, in place over V (row i reads rows <= i)
#pragma unroll
  for (int i = N - 1; i >= 0; --i) {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      T s = Lc[i][i] * V[i][j];
#pragma unroll
      for (int m = 0; m < i; ++m) s += Lc[i][m] * V[m][j];
      V[i][j] = ei[i] * s;
    }
  }
  // D = diag(1/(mu F)) H2 diag(w/F) Y / k;  G+- = (Y +- D)/2
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      T s = wF[0] * H2[i][0] * V[0][j];
#pragma unroll
      for (int m = 1; m < N; ++m) s += wF[m] * H2[i][m] * V[m][j];
      const T D = ri[i] * s / kk[j];
      gp[mat0 + static_cast<long>(i * N + j) * B] = T(0.5) * (V[i][j] + D);
      gm[mat0 + static_cast<long>(i * N + j) * B] = T(0.5) * (V[i][j] - D);
    }
  }
}

template <typename T, int N>
__global__ void __launch_bounds__(128)
stage1_kernel(const T* __restrict__ pp, const T* __restrict__ pm,
              const T* __restrict__ om, const T* __restrict__ dtau,
              const T* __restrict__ tb0, const T* __restrict__ tb1,
              const T* __restrict__ qtab, T* __restrict__ ek,
              T* __restrict__ gp, T* __restrict__ gm, T* __restrict__ ut,
              T* __restrict__ vt, T* __restrict__ ub, T* __restrict__ vb,
              int L, int B, int sweeps) {
  __shared__ T q[5 * N + 2 * N * N];
  load_qtab<T, N>(qtab, q);
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  const int l = blockIdx.y;
  if (b >= B) return;
  const T* imu = q;
  const T* ei = q + N;
  const T* ri = q + 2 * N;
  const T* dg = q + 3 * N;
  const T* wF = q + 4 * N;
  const T* ff = q + 5 * N;
  const T* sc = q + 5 * N + N * N;

  const long mat0 = static_cast<long>(l) * N * N * B + b;
  const long vec0 = static_cast<long>(l) * N * B + b;
  const long one0 = static_cast<long>(l) * B + b;
  const T dt = dtau[one0];
  T H1[N][N], H2[N][N];
  h12<T, N>(pp, pm, mat0, B, T(0.5) * om[one0], ff, dg, H1, H2);

  // thermal particular solution: q1 = AmB^-1 tb1/mu, p+r = 2 AmB^-1 tb0/mu,
  // p-r = 2 ApB^-1 q1, with ApB/AmB = sc * H1/H2
  {
    const T t1 = tb1[one0];
    const T t0 = tb0[one0];
    T A[N][N], G[N][2];
#pragma unroll
    for (int i = 0; i < N; ++i) {
#pragma unroll
      for (int j = 0; j < N; ++j) A[i][j] = sc[i * N + j] * H2[i][j];
      G[i][0] = t1 * imu[i];
      G[i][1] = t0 * imu[i];
    }
    ge_solve<T, N, 2>(A, G);
    T X[N][1];
#pragma unroll
    for (int i = 0; i < N; ++i) {
#pragma unroll
      for (int j = 0; j < N; ++j) A[i][j] = sc[i * N + j] * H1[i][j];
      X[i][0] = G[i][0];
    }
    ge_solve<T, N, 1>(A, X);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const T ppr = T(2) * G[i][1];
      const T pmr = T(2) * X[i][0];
      const T p0 = T(0.5) * (ppr + pmr);
      const T r0 = T(0.5) * (ppr - pmr);
      const T q1d = G[i][0] * dt;
      ut[vec0 + static_cast<long>(i) * B] = p0;
      vt[vec0 + static_cast<long>(i) * B] = r0;
      ub[vec0 + static_cast<long>(i) * B] = p0 + q1d;
      vb[vec0 + static_cast<long>(i) * B] = r0 + q1d;
    }
  }

  eigen_core<T, N, false>(H1, H2, dt, ei, ri, wF, sweeps, vec0, mat0, B, nullptr,
                          ek, gp, gm);
}

// the standalone eigen stage: stage 1 without the particular solution,
// writing k as well; the same [layer, entry, lane] layout
template <typename T, int N>
__global__ void __launch_bounds__(128)
fused_eigen_kernel(const T* __restrict__ pp, const T* __restrict__ pm,
                   const T* __restrict__ om, const T* __restrict__ dtau,
                   const T* __restrict__ qtab, T* __restrict__ k,
                   T* __restrict__ ek, T* __restrict__ gp, T* __restrict__ gm,
                   int L, int B, int sweeps) {
  __shared__ T q[5 * N + 2 * N * N];
  load_qtab<T, N>(qtab, q);
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  const int l = blockIdx.y;
  if (b >= B) return;
  const long mat0 = static_cast<long>(l) * N * N * B + b;
  const long vec0 = static_cast<long>(l) * N * B + b;
  const long one0 = static_cast<long>(l) * B + b;
  T H1[N][N], H2[N][N];
  h12<T, N>(pp, pm, mat0, B, T(0.5) * om[one0], q + 5 * N, q + 3 * N, H1, H2);
  eigen_core<T, N, true>(H1, H2, dtau[one0], q + N, q + 2 * N, q + 4 * N, sweeps,
                         vec0, mat0, B, k, ek, gp, gm);
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

// the pivot's reciprocal: in float32 the hardware approximation and one
// Newton step (no branch to the slow path of an IEEE quotient, whose
// inputs, a zero, denormal or infinite pivot, do not arise in these
// diagonally dominant blocks), in float64 the IEEE quotient
__device__ __forceinline__ float recip(float x) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return fmaf(r, fmaf(-x, r, 1.0f), r);
}
__device__ __forceinline__ double recip(double x) { return 1.0 / x; }

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

template <typename T, int N>
int launch_stage1(const void* const* a, void* const* o, int L, int B,
                  int sweeps, cudaStream_t s) {
  const dim3 grid((B + 127) / 128, L);
  stage1_kernel<T, N><<<grid, 128, 0, s>>>(
      static_cast<const T*>(a[0]), static_cast<const T*>(a[1]),
      static_cast<const T*>(a[2]), static_cast<const T*>(a[3]),
      static_cast<const T*>(a[4]), static_cast<const T*>(a[5]),
      static_cast<const T*>(a[6]), static_cast<T*>(o[0]),
      static_cast<T*>(o[1]), static_cast<T*>(o[2]), static_cast<T*>(o[3]),
      static_cast<T*>(o[4]), static_cast<T*>(o[5]), static_cast<T*>(o[6]),
      L, B, sweeps);
  return static_cast<int>(cudaGetLastError());
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

template <typename T>
int stage1(const void* pp, const void* pm, const void* om, const void* dtau,
           const void* tb0, const void* tb1, const void* qtab, void* ek,
           void* gp, void* gm, void* ut, void* vt, void* ub, void* vb, int n,
           int L, int B, int sweeps, void* stream) {
  const void* a[] = {pp, pm, om, dtau, tb0, tb1, qtab};
  void* o[] = {ek, gp, gm, ut, vt, ub, vb};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n == 8) return launch_stage1<T, 8>(a, o, L, B, sweeps, s);
  if (n == 4) return launch_stage1<T, 4>(a, o, L, B, sweeps, s);
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
  const dim3 grid((B + 127) / 128, L);
  fused_eigen_kernel<T, N><<<grid, 128, 0, s>>>(
      static_cast<const T*>(a[0]), static_cast<const T*>(a[1]),
      static_cast<const T*>(a[2]), static_cast<const T*>(a[3]),
      static_cast<const T*>(a[4]), static_cast<T*>(o[0]), static_cast<T*>(o[1]),
      static_cast<T*>(o[2]), static_cast<T*>(o[3]), L, B, sweeps);
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
      int L, int B, int sweeps, void *stream
#define STAGE23_ARGS                                                       \
  const void *gp, const void *gm, const void *ek, const void *rhs,         \
      const void *rsurf, const void *ut, const void *vt, const void *ub,   \
      const void *vb, void *S, void *utop, void *vtop, void *ubot,         \
      void *vbot, int n, int L, int B, void *stream

extern "C" int disort_stage1_f32(STAGE1_ARGS) {
  return stage1<float>(pp, pm, om, dtau, tb0, tb1, qtab, ek, gp, gm, ut, vt,
                       ub, vb, n, L, B, sweeps, stream);
}
extern "C" int disort_stage1_f64(STAGE1_ARGS) {
  return stage1<double>(pp, pm, om, dtau, tb0, tb1, qtab, ek, gp, gm, ut, vt,
                        ub, vb, n, L, B, sweeps, stream);
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
