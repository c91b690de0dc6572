// Voigt lines x frequencies contraction for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels _voigt_kernel / voigt_sum (pallas_call at
// arts_tpu/ops/voigt_kernel.py:869) and _voigt_kernel_pol / voigt_sum_pol
// (pallas_call at :975).  For every level z and frequency f of a tile it
// computes
//
//   out[z, f] = Re sum_l s_l (w(z_l(f)) - wcut_l)  over |f - f0_l| <= cut_l
//
// over the line blocks listed for that (level, tile) by the tensor code in
// arts_tpu_torch/ops/voigt_kernel.py (visit lists and block extrema built
// on the device; the multipole far field is added outside the kernel).
// The polarized instance (NP = 3, Zeeman pseudo-lines) computes
//
//   out[z, c, f] = sum_l tab[z, pol_l, c] Re s_l (w(z_l(f)) - wcut_l), c < 7
//
// The TPU kernel weights every line's term with its [7] row of pw [L, 7]
// on the MXU.  Those rows take only three values per level (pi, sigma-,
// sigma+), so here each thread keeps one sum per polarization, shared by
// all seven components, and applies the level's [3, 7] table once per
// frequency after the line loop: 3 accumulators instead of 7, a per-line
// polarization index in shared memory instead of a [7] row, and fewer
// roundings than seven weighted sums.
//
// Design.  One CUDA block per (frequency tile, level), one thread per
// frequency: the whole 60-level profile is one launch, where JAX vmaps the
// pallas_call over levels.  The block reads its own visit count and loops
// over its visited line blocks; for each it stages the block's seven line
// columns in shared memory, chooses the w(z) tier once from the block's
// |z|^2 lower bound (exactly the rule at voigt_kernel.py:439-496) and every
// thread accumulates its frequency's sum in a register, so there is no
// [8, F] partial and no reduction after the kernel.  The TPU's static-grid
// machinery (max_visits, the approximate reciprocal and its Newton step,
// sub-tiles, the coarse far field) has no counterpart here.
//
// Bound.  Per (line, frequency) pair the kernel does 14 (deep) to 155
// (Weideman n = 16) floating-point operations (ops/voigt_kernel.py
// pair_flops) on operands that live in registers and shared memory; the
// bytes it moves are the line columns, read once per visit, and one output
// per frequency.  So it is bound by operations on the FP32 pipes, not by
// memory.  The design keeps it there: line data is staged once per block
// and shared by all its threads, and the tier branch is uniform across the
// block (only the Weideman tier's per-frequency blend diverges).  Divides
// are IEEE (no fast math): the tolerances against the plain version need
// them.

#include <cuda_runtime.h>

namespace {

constexpr double kInvSqrtPi = 0.56418958354775628695;
constexpr double kAsymR2 = 512.0;
constexpr double kDeepR2 = 1.0e6;

// Laurent coefficients c_k = (2k-1)!!/2^k of w ~ i/(sqrt(pi) z) sum c_k z^-2k
__constant__ double kLaurent[8] = {
    1.0, 0.5, 0.75, 15.0 / 8.0, 105.0 / 16.0, 945.0 / 32.0,
    10395.0 / 64.0, 135135.0 / 128.0};

// products that the compiler must not fuse into an FMA: the tier gate
// compares against the plain version's separately rounded arithmetic
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }

template <typename T>
__device__ __forceinline__ T tmax(T a, T b) { return a > b ? a : b; }

template <typename T>
__device__ __forceinline__ T tabs(T a) { return a < T(0) ? -a : a; }

// 1-term Laurent: the pure Lorentz far wing (|z|^2 > 2e6)
template <typename T>
struct Deep {
  __device__ __forceinline__ void operator()(T zr, T zi, T& wr, T& wi) const {
    const T inv = T(1) / (zr * zr + zi * zi) * T(kInvSqrtPi);
    wr = zi * inv;
    wi = zr * inv;
  }
};

// K-term Laurent series w ~ i/(sqrt(pi) z) sum_{k<K} c_k z^-2k
template <typename T, int K>
__device__ __forceinline__ void wofz_series(T zr, T zi, T& wr, T& wi) {
  const T inv = T(1) / (zr * zr + zi * zi);
  const T ur = (zr * zr - zi * zi) * inv * inv;
  const T ui = (T(-2) * zr * zi) * inv * inv;
  T sr = T(kLaurent[K - 1]);
  T si = T(0);
#pragma unroll
  for (int k = K - 2; k >= 0; --k) {
    const T nr = sr * ur - si * ui + T(kLaurent[k]);
    si = sr * ui + si * ur;
    sr = nr;
  }
  const T fr = zi * inv * T(kInvSqrtPi);
  const T fi = zr * inv * T(kInvSqrtPi);
  wr = fr * sr - fi * si;
  wi = fr * si + fi * sr;
}

template <typename T, int K>
struct Series {
  __device__ __forceinline__ void operator()(T zr, T zi, T& wr, T& wi) const {
    wofz_series<T, K>(zr, zi, wr, wi);
  }
};

// Weideman rational of order n (coefficients in shared memory, L first),
// blended with the K-term series where |z|^2 > 512
template <typename T, int K>
struct Parts {
  const T* wc;
  int n;
  __device__ __forceinline__ void operator()(T zr, T zi, T& wr, T& wi) const {
    if (zr * zr + zi * zi > T(kAsymR2)) {
      wofz_series<T, K>(zr, zi, wr, wi);
      return;
    }
    const T Lw = wc[0];
    const T dr = Lw + zi;  // Re(L - iz)
    const T di = -zr;      // Im(L - iz)
    const T inv = T(1) / (dr * dr + di * di);
    const T nr = Lw - zi;  // Re(L + iz)
    const T ni = zr;
    const T Zr = (nr * dr + ni * di) * inv;
    const T Zi = (ni * dr - nr * di) * inv;
    T pr = T(0), pi = T(0);
    for (int k = 1; k <= n; ++k) {
      const T t = pr * Zr - pi * Zi + wc[k];
      pi = pr * Zi + pi * Zr;
      pr = t;
    }
    const T tr = (T(2) * (pr * dr + pi * di)) * inv + T(kInvSqrtPi);
    const T ti = (T(2) * (pi * dr - pr * di)) * inv;
    wr = (tr * dr + ti * di) * inv;
    wi = (ti * dr - tr * di) * inv;
  }
};

// accumulate one staged line block into this thread's frequency: eight
// interleaved partial sums (lines l = k mod 8), added as a tree, keep the
// float32 rounding error of a block near that of the TPU kernel's 8-row
// accumulator and give the adds eight independent chains.  NP = 3 keeps
// one set per polarization, selected by the line's index in pol (the
// selects keep the partials in registers: no dynamic register index).
template <typename T, int NP, typename W>
__device__ __forceinline__ void block_sum(const T* __restrict__ sh,
                                          const int* __restrict__ pol, int tl,
                                          T fv, const W& wofz, T (&acc)[NP]) {
  const T* f0 = sh;
  const T* igd = sh + tl;
  const T* zi = sh + 2 * tl;
  const T* sr = sh + 3 * tl;
  const T* si = sh + 4 * tl;
  const T* cut = sh + 5 * tl;
  const T* swc = sh + 6 * tl;
  T part[NP][8];
#pragma unroll
  for (int q = 0; q < NP; ++q) {
#pragma unroll
    for (int k = 0; k < 8; ++k) part[q][k] = T(0);
  }
  for (int l0 = 0; l0 < tl; l0 += 8) {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int l = l0 + k;
      if (l < tl) {
        const T df = fv - f0[l];
        T wr, wi;
        wofz(igd[l] * df, zi[l], wr, wi);
        const T val = (sr[l] * wr - si[l] * wi) - swc[l];
        const T v = tabs(df) <= cut[l] ? val : T(0);
        if constexpr (NP == 1) {
          part[0][k] += v;
        } else {
          const int p = pol[l];
#pragma unroll
          for (int q = 0; q < NP; ++q) part[q][k] += p == q ? v : T(0);
        }
      }
    }
  }
#pragma unroll
  for (int q = 0; q < NP; ++q) {
    acc[q] += ((part[q][0] + part[q][1]) + (part[q][2] + part[q][3])) +
              ((part[q][4] + part[q][5]) + (part[q][6] + part[q][7]));
  }
}

// grid (nf, Z), block tf threads.  f [nf*tf]; lines [Z, 7, nl*tl] as
// (f0, inv_gd, z_imag, s_re, s_im, cutoff, swc); ext [Z, 4, nl] as
// (f0_min, f0_max, igd_min, zi_min); blkidx [Z, nf, nl]; nvisit [Z, nf];
// wcoef [n+1]; NP = 1: out [Z, nf*tf] (pol and tab unused).  NP = 3:
// pol [nl*tl] in 0..2, tab [Z, 3, 7], out [Z, 7, nf*tf].
template <typename T, int NP>
__global__ void voigt_sum_kernel(const T* __restrict__ f,
                                 const T* __restrict__ lines,
                                 const T* __restrict__ ext,
                                 const int* __restrict__ blkidx,
                                 const int* __restrict__ nvisit,
                                 const T* __restrict__ wcoef,
                                 const int* __restrict__ pol,
                                 const T* __restrict__ tab,
                                 T* __restrict__ out, int nf, int nl, int tl,
                                 int nweid) {
  constexpr bool kF32 = sizeof(T) == 4;
  constexpr int kAsymTerms = kF32 ? 3 : 4;
  constexpr int kMidTerms = kF32 ? 6 : 8;
  const T mid_gate = T(2.0 * (kF32 ? 36.0 : 150.0));

  extern __shared__ __align__(16) unsigned char smem[];
  T* sh = reinterpret_cast<T*>(smem);  // [7][tl] line columns
  T* wc = sh + 7 * tl;                 // [nweid + 1] Weideman table
  int* shp = reinterpret_cast<int*>(wc + nweid + 1);  // NP = 3: [tl]

  const int tile = blockIdx.x;
  const int z = blockIdx.y;
  const int tf = blockDim.x;
  const int tid = threadIdx.x;
  const long lp = static_cast<long>(nl) * tl;
  const T* lz = lines + static_cast<long>(z) * 7 * lp;
  const T* ez = ext + static_cast<long>(z) * 4 * nl;
  const long t0 = static_cast<long>(tile) * tf;

  for (int i = tid; i <= nweid; i += tf) wc[i] = wcoef[i];
  const T fv = f[t0 + tid];
  const T t_lo = f[t0];
  const T t_hi = f[t0 + tf - 1];
  const long row = static_cast<long>(z) * nf + tile;
  const int nv = nvisit[row];
  const int* bl = blkidx + row * nl;

  T acc[NP];
#pragma unroll
  for (int q = 0; q < NP; ++q) acc[q] = T(0);
  for (int j = 0; j < nv; ++j) {
    const int jb = bl[j];
    __syncthreads();  // the previous block's columns are consumed
    for (int i = tid; i < 7 * tl; i += tf) {
      const int c = i / tl;
      sh[i] = lz[c * lp + static_cast<long>(jb) * tl + (i - c * tl)];
    }
    if constexpr (NP > 1) {
      for (int i = tid; i < tl; i += tf) shp[i] = pol[static_cast<long>(jb) * tl + i];
    }
    __syncthreads();
    // |z|^2 >= (igd_min gap)^2 + zi_min^2 over the whole (tile, block)
    const T gap = tmax(tmax(ez[jb] - t_hi, t_lo - ez[nl + jb]), T(0));
    const T gmin = mul_rn(ez[2 * nl + jb], gap);
    const T zmin = ez[3 * nl + jb];
    const T bound2 = mul_rn(gmin, gmin) + mul_rn(zmin, zmin);
    if (bound2 > T(2.0 * kDeepR2)) {
      block_sum(sh, shp, tl, fv, Deep<T>{}, acc);
    } else if (bound2 > T(2.0 * kAsymR2)) {
      block_sum(sh, shp, tl, fv, Series<T, kAsymTerms>{}, acc);
    } else if (bound2 > mid_gate) {
      block_sum(sh, shp, tl, fv, Series<T, kMidTerms>{}, acc);
    } else {
      block_sum(sh, shp, tl, fv, Parts<T, kAsymTerms>{wc, nweid}, acc);
    }
  }
  if constexpr (NP == 1) {
    out[row * tf + tid] = acc[0];
  } else {
    // out[z, c] = sum_p tab[z, p, c] acc[p]; the table is 21 values per
    // level, read through the read-only cache
    const T* tz = tab + static_cast<long>(z) * 3 * 7;
    const long fcount = static_cast<long>(nf) * tf;
#pragma unroll
    for (int c = 0; c < 7; ++c) {
      const T v = (__ldg(tz + c) * acc[0] + __ldg(tz + 7 + c) * acc[1]) +
                  __ldg(tz + 14 + c) * acc[2];
      out[(static_cast<long>(z) * 7 + c) * fcount + t0 + tid] = v;
    }
  }
}

template <typename T, int NP>
int launch(const void* f, const void* lines, const void* ext,
           const void* blkidx, const void* nvisit, const void* wcoef,
           const void* pol, const void* tab, void* out, int Z, int nf,
           int nl, int tl, int tf, int nweid, void* stream) {
  const dim3 grid(nf, Z);
  const size_t smem = static_cast<size_t>(7 * tl + nweid + 1) * sizeof(T) +
                      (NP > 1 ? static_cast<size_t>(tl) * sizeof(int) : 0);
  voigt_sum_kernel<T, NP><<<grid, tf, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(f), static_cast<const T*>(lines),
      static_cast<const T*>(ext), static_cast<const int*>(blkidx),
      static_cast<const int*>(nvisit), static_cast<const T*>(wcoef),
      static_cast<const int*>(pol), static_cast<const T*>(tab),
      static_cast<T*>(out), nf, nl, tl, nweid);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int voigt_sum_f32(const void* f, const void* lines, const void* ext,
                             const void* blkidx, const void* nvisit,
                             const void* wcoef, void* out, int Z, int nf,
                             int nl, int tl, int tf, int nweid, void* stream) {
  return launch<float, 1>(f, lines, ext, blkidx, nvisit, wcoef, nullptr,
                          nullptr, out, Z, nf, nl, tl, tf, nweid, stream);
}

extern "C" int voigt_sum_f64(const void* f, const void* lines, const void* ext,
                             const void* blkidx, const void* nvisit,
                             const void* wcoef, void* out, int Z, int nf,
                             int nl, int tl, int tf, int nweid, void* stream) {
  return launch<double, 1>(f, lines, ext, blkidx, nvisit, wcoef, nullptr,
                           nullptr, out, Z, nf, nl, tl, tf, nweid, stream);
}

extern "C" int voigt_sum_pol_f32(const void* f, const void* lines,
                                 const void* ext, const void* blkidx,
                                 const void* nvisit, const void* wcoef,
                                 const void* pol, const void* tab, void* out,
                                 int Z, int nf, int nl, int tl, int tf,
                                 int nweid, void* stream) {
  return launch<float, 3>(f, lines, ext, blkidx, nvisit, wcoef, pol, tab, out,
                          Z, nf, nl, tl, tf, nweid, stream);
}

extern "C" int voigt_sum_pol_f64(const void* f, const void* lines,
                                 const void* ext, const void* blkidx,
                                 const void* nvisit, const void* wcoef,
                                 const void* pol, const void* tab, void* out,
                                 int Z, int nf, int nl, int tl, int tf,
                                 int nweid, void* stream) {
  return launch<double, 3>(f, lines, ext, blkidx, nvisit, wcoef, pol, tab,
                           out, Z, nf, nl, tl, tf, nweid, stream);
}
