// Batched symmetric eigendecomposition of small matrices for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel arts_tpu/ops/eigh_jacobi.py:
// eigh_jacobi_pallas (pallas_call at :235, body _jacobi_kernel at :156):
// A = V diag(w) V^T for B symmetric n x n matrices, n <= 16, by `sweeps`
// sweeps of the tournament cyclic Jacobi with the division-safe rotation
// (csrc/jacobi.cuh), eigenvalues in ascending order.
//
// Layout: the wrapper (arts_tpu_torch/ops/eigh_jacobi.py) hands the batch
// over in lane layout, a [n*n, B] with entry (i, j) at row i*n + j, so that
// the threads of a warp, one matrix each, read and write neighbouring
// addresses; w comes back as [n, B] and V as [n*n, B].  The TPU kernel
// kept the same layout ([n*n, S, 128] tiles, lanes = batch).
//
// Design: one thread per matrix, every sweep in the thread: device memory
// sees each matrix once in and once out.  A round computes the angles of
// its n/2 disjoint pairs, then rotates rows, then columns and V.  The
// ascending order is a stable rank (ties keep their index order, as a
// stable argsort does).
//
// Two instances of the design.  For n <= 8 (nquad <= 16), the unrolled
// template: every index is a compile-time constant, so M and V stay in
// registers.  For 9 <= n <= 16 the 2 n^2 values would not fit in 255
// registers anyway, so one kernel per type takes n at run time and keeps M
// and V in local memory (cached in L1); unrolling those sizes took minutes
// of ptxas time per instance for no gain over the spills it produced.
//
// Bound: operations.  A rotation pair costs ~16 operations for its angle
// and 6n multiply-adds of 2 operations for the row, column and V updates;
// with n/2 pairs, n - 1 rounds and 6 sweeps at n = 8 that is ~27k
// operations per matrix against 544 bytes in and out (float32).

#include <cuda_runtime.h>

#include "jacobi.cuh"

namespace {

template <typename T, int N>
__global__ void __launch_bounds__(128)
eigh_jacobi_kernel(const T* __restrict__ a, T* __restrict__ w,
                   T* __restrict__ v, int B, int nsweeps) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const long sB = B;
  T M[N][N], V[N][N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      M[i][j] = a[(i * N + j) * sB + b];
      V[i][j] = i == j ? T(1) : T(0);
    }
  }
  jacobi::sweeps<T, N>(M, V, N, nsweeps);

  // stable ascending rank of each diagonal entry, applied with selects so
  // that no register array is indexed at run time
  int rank[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    int r = 0;
#pragma unroll
    for (int j = 0; j < N; ++j) r += (M[j][j] < M[i][i]) || (j < i && M[j][j] == M[i][i]);
    rank[i] = r;
  }
#pragma unroll
  for (int c = 0; c < N; ++c) {
    T wc = T(0);
#pragma unroll
    for (int i = 0; i < N; ++i) wc = rank[i] == c ? M[i][i] : wc;
    w[c * sB + b] = wc;
#pragma unroll
    for (int r = 0; r < N; ++r) {
      T vc = T(0);
#pragma unroll
      for (int i = 0; i < N; ++i) vc = rank[i] == c ? V[r][i] : vc;
      v[(r * N + c) * sB + b] = vc;
    }
  }
}

constexpr int KMAX = 16;

// 9 <= n <= 16: the same sweeps and order with n at run time
template <typename T>
__global__ void __launch_bounds__(128)
eigh_jacobi_local_kernel(const T* __restrict__ a, T* __restrict__ w,
                         T* __restrict__ v, int n, int B, int nsweeps) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const long sB = B;
  T M[KMAX][KMAX], V[KMAX][KMAX];
#pragma unroll 1
  for (int i = 0; i < n; ++i) {
#pragma unroll 1
    for (int j = 0; j < n; ++j) {
      M[i][j] = a[(i * n + j) * sB + b];
      V[i][j] = i == j ? T(1) : T(0);
    }
  }
  jacobi::sweeps<T, KMAX, 1>(M, V, n, nsweeps);
  // stable ascending rank; entry i goes to position rank(i)
#pragma unroll 1
  for (int i = 0; i < n; ++i) {
    int r = 0;
#pragma unroll 1
    for (int j = 0; j < n; ++j) r += (M[j][j] < M[i][i]) || (j < i && M[j][j] == M[i][i]);
    w[r * sB + b] = M[i][i];
#pragma unroll 1
    for (int row = 0; row < n; ++row) v[(row * n + r) * sB + b] = V[row][i];
  }
}

template <typename T, int N>
int launch(const void* a, void* w, void* v, int B, int nsweeps, cudaStream_t s) {
  eigh_jacobi_kernel<T, N><<<(B + 127) / 128, 128, 0, s>>>(
      static_cast<const T*>(a), static_cast<T*>(w), static_cast<T*>(v), B, nsweeps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int eigh(const void* a, void* w, void* v, int n, int B, int nsweeps, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n) {
    case 1: return launch<T, 1>(a, w, v, B, nsweeps, s);
    case 2: return launch<T, 2>(a, w, v, B, nsweeps, s);
    case 3: return launch<T, 3>(a, w, v, B, nsweeps, s);
    case 4: return launch<T, 4>(a, w, v, B, nsweeps, s);
    case 5: return launch<T, 5>(a, w, v, B, nsweeps, s);
    case 6: return launch<T, 6>(a, w, v, B, nsweeps, s);
    case 7: return launch<T, 7>(a, w, v, B, nsweeps, s);
    case 8: return launch<T, 8>(a, w, v, B, nsweeps, s);
    default:
      if (n < 1 || n > KMAX) return static_cast<int>(cudaErrorInvalidValue);
      eigh_jacobi_local_kernel<T><<<(B + 127) / 128, 128, 0, s>>>(
          static_cast<const T*>(a), static_cast<T*>(w), static_cast<T*>(v), n, B, nsweeps);
      return static_cast<int>(cudaGetLastError());
  }
}

}  // namespace

// a [n*n, B] -> w [n, B], v [n*n, B]; returns the launch's CUDA error code
extern "C" int eigh_jacobi_f32(const void* a, void* w, void* v, int n, int B,
                               int nsweeps, void* stream) {
  return eigh<float>(a, w, v, n, B, nsweeps, stream);
}
extern "C" int eigh_jacobi_f64(const void* a, void* w, void* v, int n, int B,
                               int nsweeps, void* stream) {
  return eigh<double>(a, w, v, n, B, nsweeps, stream);
}
