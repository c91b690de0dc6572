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
// Stages 2+3, one thread per lane: the TPU grid walked the layers in
// order with W [n x n] and uy [n] carried in VMEM scratch; here a loop in
// the thread carries them in registers.  Per layer it assembles the
// 2n x 2n block and the [0; I | rmod] right-hand side, eliminates without
// pivoting (the blocks are diagonally dominant by construction), writes
// the factors P [2n x n] and y [2n], and updates W = U P, uy = U y.  A
// second loop walks the layers in reverse for the back-substitution and
// the level radiances.
//
// Bound: both kernels move every input and output once (1.2 KB per
// (lane, layer) in float32 for stage 1), so at the bench shape the memory
// bound is a fraction of a millisecond; the arithmetic of stage 1 (~32
// kflop per problem, mostly the Jacobi sweeps) is of the same order.
// What limits them in this simple form is neither: a thread holds several
// 8 x 8 matrices (stage 1) or a 16 x 17 system (stage 2), which spill from
// registers to local memory, and stages 2+3 have one thread per lane, 4096
// threads at the bench shape, too few to fill 132 SMs.  Blocks of 32 lanes
// spread them over as many SMs as there are warps.

#include <cuda_runtime.h>

#include "jacobi.cuh"

namespace {

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

template <typename T, int N>
__global__ void __launch_bounds__(32)
stage23_kernel(const T* __restrict__ gp, const T* __restrict__ gm,
               const T* __restrict__ ek, const T* __restrict__ rhs,
               const T* __restrict__ rsurf, const T* __restrict__ ut,
               const T* __restrict__ vt, const T* __restrict__ ub,
               const T* __restrict__ vb, T* __restrict__ P,
               T* __restrict__ y, T* __restrict__ utop, T* __restrict__ vtop,
               T* __restrict__ ubot, T* __restrict__ vbot, int L, int B) {
  constexpr int N2 = 2 * N;
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const long sB = B;
  auto at = [&](const T* base, long layer, int rows, int k) {
    return base[(layer * rows + k) * sB + b];
  };

  T Rs[N][N], W[N][N], uy[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    uy[i] = T(0);
#pragma unroll
    for (int j = 0; j < N; ++j) {
      Rs[i][j] = rsurf[static_cast<long>(i * N + j) * sB + b];
      W[i][j] = T(0);
    }
  }

  // forward elimination over the layers
#pragma unroll 1
  for (int l = 0; l < L; ++l) {
    T Gp[N][N], GmE[N][N], Gm[N][N], GpE[N][N];
    {
      T e[N];
#pragma unroll
      for (int j = 0; j < N; ++j) e[j] = at(ek, l, N, j);
#pragma unroll
      for (int i = 0; i < N; ++i) {
#pragma unroll
        for (int j = 0; j < N; ++j) {
          Gp[i][j] = at(gp, l, N * N, i * N + j);
          Gm[i][j] = at(gm, l, N * N, i * N + j);
          GpE[i][j] = Gp[i][j] * e[j];
          GmE[i][j] = Gm[i][j] * e[j];
        }
      }
    }
    // U = [GmE | Gp];  T = -[Gp | GmE]
    auto U = [&](int i, int k) { return k < N ? GmE[i][k] : Gp[i][k - N]; };
    auto Tn = [&](int i, int k) { return -(k < N ? Gp[i][k] : GmE[i][k - N]); };
    T D[N2][N2], R[N2][N + 1];
#pragma unroll
    for (int i = 0; i < N; ++i) {
#pragma unroll
      for (int k = 0; k < N2; ++k) {
        // A rows: -[Gm | GpE] - W T
        T wt = W[i][0] * Tn(0, k);
#pragma unroll
        for (int m = 1; m < N; ++m) wt += W[i][m] * Tn(m, k);
        D[i][k] = -(k < N ? Gm[i][k] : GpE[i][k - N]) - wt;
        // B rows: [GpE | Gm], minus Rsurf U at the surface
        T bk = k < N ? GpE[i][k] : Gm[i][k - N];
        if (l == L - 1) {
          T ru = Rs[i][0] * U(0, k);
#pragma unroll
          for (int m = 1; m < N; ++m) ru += Rs[i][m] * U(m, k);
          bk -= ru;
        }
        D[N + i][k] = bk;
      }
#pragma unroll
      for (int j = 0; j < N; ++j) {
        R[i][j] = T(0);
        R[N + i][j] = i == j ? T(1) : T(0);
      }
      R[i][N] = at(rhs, l, N2, i) - uy[i];
      R[N + i][N] = at(rhs, l, N2, N + i);
    }
    ge_solve<T, N2, N + 1>(D, R);
#pragma unroll
    for (int k = 0; k < N2; ++k) {
#pragma unroll
      for (int j = 0; j < N; ++j) P[(static_cast<long>(l) * N2 * N + k * N + j) * sB + b] = R[k][j];
      y[(static_cast<long>(l) * N2 + k) * sB + b] = R[k][N];
    }
    // W = U P;  uy = U y
#pragma unroll
    for (int i = 0; i < N; ++i) {
#pragma unroll
      for (int j = 0; j < N; ++j) {
        T s = U(i, 0) * R[0][j];
#pragma unroll
        for (int k = 1; k < N2; ++k) s += U(i, k) * R[k][j];
        W[i][j] = s;
      }
      T s = U(i, 0) * R[0][N];
#pragma unroll
      for (int k = 1; k < N2; ++k) s += U(i, k) * R[k][N];
      uy[i] = s;
    }
  }

  // back-substitution and level radiances, surface to TOA
  T t[N];
#pragma unroll
  for (int i = 0; i < N; ++i) t[i] = T(0);
#pragma unroll 1
  for (int l = L - 1; l >= 0; --l) {
    T X[N2];
#pragma unroll
    for (int k = 0; k < N2; ++k) {
      T v = P[(static_cast<long>(l) * N2 * N + k * N) * sB + b] * t[0];
#pragma unroll
      for (int j = 1; j < N; ++j) v += P[(static_cast<long>(l) * N2 * N + k * N + j) * sB + b] * t[j];
      X[k] = y[(static_cast<long>(l) * N2 + k) * sB + b] - v;
    }
    T Gp[N][N], Gm[N][N], e[N];
#pragma unroll
    for (int j = 0; j < N; ++j) e[j] = at(ek, l, N, j);
#pragma unroll
    for (int i = 0; i < N; ++i) {
#pragma unroll
      for (int j = 0; j < N; ++j) {
        Gp[i][j] = at(gp, l, N * N, i * N + j);
        Gm[i][j] = at(gm, l, N * N, i * N + j);
      }
    }
    const T* Cp = X;
    const T* Cm = X + N;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      // sums over j of each product, in ascending j as in the plain version
      T GpX = Gp[i][0] * Cp[0], GmEX = Gm[i][0] * e[0] * Cm[0];
      T GmX = Gm[i][0] * Cp[0], GpEX = Gp[i][0] * e[0] * Cm[0];
      T GpEXp = Gp[i][0] * e[0] * Cp[0], GmXm = Gm[i][0] * Cm[0];
      T GmEXp = Gm[i][0] * e[0] * Cp[0], GpXm = Gp[i][0] * Cm[0];
#pragma unroll
      for (int j = 1; j < N; ++j) {
        const T gpe = Gp[i][j] * e[j], gme = Gm[i][j] * e[j];
        GpX += Gp[i][j] * Cp[j];
        GmEX += gme * Cm[j];
        GmX += Gm[i][j] * Cp[j];
        GpEX += gpe * Cm[j];
        GpEXp += gpe * Cp[j];
        GmXm += Gm[i][j] * Cm[j];
        GmEXp += gme * Cp[j];
        GpXm += Gp[i][j] * Cm[j];
      }
      const long o = (static_cast<long>(l) * N + i) * sB + b;
      utop[o] = GpX + GmEX + ut[o];
      vtop[o] = GmX + GpEX + vt[o];
      ubot[o] = GpEXp + GmXm + ub[o];
      vbot[o] = GmEXp + GpXm + vb[o];
      t[i] = -(GpX + GmEX);  // carry to the layer above
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
  stage23_kernel<T, N><<<(B + 31) / 32, 32, 0, s>>>(
      static_cast<const T*>(a[0]), static_cast<const T*>(a[1]),
      static_cast<const T*>(a[2]), static_cast<const T*>(a[3]),
      static_cast<const T*>(a[4]), static_cast<const T*>(a[5]),
      static_cast<const T*>(a[6]), static_cast<const T*>(a[7]),
      static_cast<const T*>(a[8]), static_cast<T*>(o[0]),
      static_cast<T*>(o[1]), static_cast<T*>(o[2]), static_cast<T*>(o[3]),
      static_cast<T*>(o[4]), static_cast<T*>(o[5]), L, B);
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
            const void* vb, void* P, void* y, void* utop, void* vtop,
            void* ubot, void* vbot, int n, int L, int B, void* stream) {
  const void* a[] = {gp, gm, ek, rhs, rsurf, ut, vt, ub, vb};
  void* o[] = {P, y, utop, vtop, ubot, vbot};
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
      const void *vb, void *P, void *y, void *utop, void *vtop,            \
      void *ubot, void *vbot, int n, int L, int B, void *stream

extern "C" int disort_stage1_f32(STAGE1_ARGS) {
  return stage1<float>(pp, pm, om, dtau, tb0, tb1, qtab, ek, gp, gm, ut, vt,
                       ub, vb, n, L, B, sweeps, stream);
}
extern "C" int disort_stage1_f64(STAGE1_ARGS) {
  return stage1<double>(pp, pm, om, dtau, tb0, tb1, qtab, ek, gp, gm, ut, vt,
                        ub, vb, n, L, B, sweeps, stream);
}
extern "C" int disort_stage23_f32(STAGE23_ARGS) {
  return stage23<float>(gp, gm, ek, rhs, rsurf, ut, vt, ub, vb, P, y, utop,
                        vtop, ubot, vbot, n, L, B, stream);
}
extern "C" int disort_stage23_f64(STAGE23_ARGS) {
  return stage23<double>(gp, gm, ek, rhs, rsurf, ut, vt, ub, vb, P, y, utop,
                         vtop, ubot, vbot, n, L, B, stream);
}
extern "C" int fused_eigen_f32(EIGEN_ARGS) {
  return eigen<float>(pp, pm, om, dtau, qtab, k, ek, gp, gm, n, L, B, sweeps,
                      stream);
}
extern "C" int fused_eigen_f64(EIGEN_ARGS) {
  return eigen<double>(pp, pm, om, dtau, qtab, k, ek, gp, gm, n, L, B, sweeps,
                       stream);
}
