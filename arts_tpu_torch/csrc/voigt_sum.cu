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
// sigma+), and the tensor code pads each polarization's lines to whole
// blocks, so every block holds one polarization (blkpol [nl]): the inner
// loop is the unpolarized one, a visit's sum goes to its polarization's
// accumulator, and the level's [3, 7] table is applied once per frequency
// at the end.
//
// Design.  The unit of the tier rule and of the visit lists is one tile of
// kTF = 256 frequencies x one block of kTL = 128 lines.  A CUDA block of
// 256 threads takes one chunk of one (level, tile)'s visit list: the list
// is cut into `split` chunks, so the 60 x 16 uneven lists become many
// units of similar size that fill the 132 SMs, and the chunks' partial
// sums are added in chunk order by a second kernel (no atomics: repeated
// runs are bit-identical).  Inside the block, four groups of 64 threads
// each take 32 lines of the staged block, and each thread 4 adjacent
// frequencies, so one line record (two 16-byte shared loads in float32)
// serves 4 pairs.  Line blocks are 8-wide records (f0, inv_gd, z_imag,
// cutoff | s_re, s_im, swc, pad), one contiguous 4 KB (float32) array per
// visit, copied into a ring of three shared buffers with cp.async while
// the block before is summed.  The w(z) tier is chosen once per visit from
// the block's |z|^2 lower bound (exactly the rule at voigt_kernel.py:439-
// 496).  A line whose cutoff window misses all 128 frequencies of a warp
// is skipped by that warp (a masked term is zero, so the sum is the same).
// A thread's 4 frequencies take their divides together (recip), so the
// compiler interleaves four dependency chains where the branch around
// each `1.0f / x` serialized them, and the Laurent tiers fold the strength
// and 1/sqrt(pi) into per-line products (Strength).  After the loop the
// four groups' sums meet in shared memory and are added in a fixed order.
//
// Bound.  Per (line, frequency) pair the kernel does 14 (deep) to 155
// (Weideman n = 16) floating-point operations (ops/voigt_kernel.py
// pair_flops) on operands in registers; the bytes it moves are the line
// records, read once per visit, and one output per frequency.  So it is
// bound by operations on the FP32 pipes, not by memory, and its time is
// the instructions it executes per pair.  Divides are IEEE (no fast math):
// the tolerances against the plain version need them.

#include <cuda_runtime.h>

#include "async.cuh"

namespace {

using async::cp_async;
using async::cp_async_commit;
using async::cp_async_wait;

constexpr double kInvSqrtPi = 0.56418958354775628695;
constexpr double kAsymR2 = 512.0;
constexpr double kDeepR2 = 1.0e6;

constexpr int kTF = 256;                      // frequencies per tile
constexpr int kTL = 128;                      // lines per block
constexpr int kR = 4;                         // frequencies per thread
constexpr int kGroups = 4;                    // line groups per CUDA block
constexpr int kThreads = kTF / kR * kGroups;  // 256, one per frequency too
constexpr int kGroupLines = kTL / kGroups;    // 32
constexpr int kRec = 8;                       // record width
constexpr int kStages = 3;                    // staged line blocks in the ring
static_assert(kThreads == kTF, "the epilogue gives each thread one frequency");

// Laurent coefficients c_k = (2k-1)!!/2^k of w ~ i/(sqrt(pi) z) sum c_k z^-2k
// (a switch, so that unrolled loops fold them into immediates)
__device__ __forceinline__ constexpr double laurent(int k) {
  switch (k) {
    case 0: return 1.0;
    case 1: return 0.5;
    case 2: return 0.75;
    case 3: return 15.0 / 8.0;
    case 4: return 105.0 / 16.0;
    case 5: return 945.0 / 32.0;
    case 6: return 10395.0 / 64.0;
    default: return 135135.0 / 128.0;
  }
}

// products that the compiler must not fuse into an FMA: the tier gate
// compares against the plain version's separately rounded arithmetic
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }

template <typename T>
__device__ __forceinline__ T tmax(T a, T b) { return a > b ? a : b; }

template <typename T>
__device__ __forceinline__ T tmin(T a, T b) { return a < b ? a : b; }

template <typename T>
struct Line {
  T f0, igd, zi, cut, sr, si, swc;
};

__device__ __forceinline__ Line<float> load_line(const float* p) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  return {a.x, a.y, a.z, a.w, b.x, b.y, b.z};
}

__device__ __forceinline__ Line<double> load_line(const double* p) {
  const double2* q = reinterpret_cast<const double2*>(p);
  const double2 a = q[0], b = q[1], c = q[2], d = q[3];
  return {a.x, a.y, b.x, b.y, c.x, c.y, d.x};
}

// x <- 1 / x for a thread's kR denominators.  In float32 `1.0f / x` takes
// a fast path for x in [2^-126, 2^126) (the hardware approximation and one
// Newton step, correctly rounded there) and a branch around it for the
// rest.  Here the kR reciprocals take that fast path together when all
// are in range, so the compiler can interleave them; otherwise each is
// `1.0f / x`.  Denominators are sums of squares, so NaN is the only
// other value that can reach the fast path, and it stays NaN there too.
__device__ __forceinline__ void recip(float (&x)[kR]) {
  float lo = x[0], hi = x[0];
#pragma unroll
  for (int r = 1; r < kR; ++r) {
    lo = fminf(lo, x[r]);
    hi = fmaxf(hi, x[r]);
  }
  if (lo >= 0x1p-126f && hi < 0x1p126f) {
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      float a;
      asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(a) : "f"(x[r]));
      x[r] = fmaf(a, fmaf(-x[r], a, 1.0f), a);
    }
  } else {
#pragma unroll
    for (int r = 0; r < kR; ++r) x[r] = 1.0f / x[r];
  }
}

__device__ __forceinline__ void recip(double (&x)[kR]) {
#pragma unroll
  for (int r = 0; r < kR; ++r) x[r] = 1.0 / x[r];
}

// The w(z) tiers.  Each gives one line's terms Re s (w(z) - wcut) at a
// thread's kR frequencies, z = zr + i zi.  The Laurent tiers write
// w = i S(z) / (sqrt(pi) z) = (zi + i zr) S / (sqrt(pi) |z|^2), so with
// g = s (zi + i zr) / sqrt(pi), whose zi products are per line, a term is
// Re(g S) / |z|^2 - Re(s wcut).
template <typename T>
struct Strength {
  T ar, ai, arzi, aizi;  // a = s / sqrt(pi) and a zi
  __device__ __forceinline__ explicit Strength(const Line<T>& ln)
      : ar(ln.sr * T(kInvSqrtPi)), ai(ln.si * T(kInvSqrtPi)),
        arzi(ln.sr * T(kInvSqrtPi) * ln.zi), aizi(ln.si * T(kInvSqrtPi) * ln.zi) {}
};

// |z|^2 -> 1 / |z|^2 at the kR frequencies
template <typename T>
__device__ __forceinline__ void inv_r2(const T (&zr)[kR], T zi, T (&inv)[kR]) {
#pragma unroll
  for (int r = 0; r < kR; ++r) inv[r] = zr[r] * zr[r] + zi * zi;
  recip(inv);
}

// K-term Laurent series S = sum_{k<K} c_k z^-2k and the term Re(g S) / |z|^2
// - swc, given inv = 1 / |z|^2; the top Horner step (from c_{K-1}) is
// written out
template <typename T, int K>
__device__ __forceinline__ T series_term(T zr, const Line<T>& ln, const Strength<T>& a,
                                         T inv) {
  const T ur = (zr * zr - ln.zi * ln.zi) * inv * inv;
  const T ui = (T(-2) * zr * ln.zi) * inv * inv;
  T sr = T(laurent(K - 1)) * ur + T(laurent(K - 2));
  T si = T(laurent(K - 1)) * ui;
#pragma unroll
  for (int k = K - 3; k >= 0; --k) {
    const T nr = sr * ur - si * ui + T(laurent(k));
    si = sr * ui + si * ur;
    sr = nr;
  }
  const T gr = a.arzi - a.ai * zr;
  const T gi = a.ar * zr + a.aizi;
  return (gr * sr - gi * si) * inv - ln.swc;
}

// 1-term Laurent: the pure Lorentz far wing (|z|^2 > 2e6), S = 1
template <typename T>
struct Deep {
  __device__ __forceinline__ void operator()(const T (&zr)[kR], const Line<T>& ln,
                                             T (&val)[kR]) const {
    const Strength<T> a(ln);
    T inv[kR];
    inv_r2(zr, ln.zi, inv);
#pragma unroll
    for (int r = 0; r < kR; ++r) val[r] = (a.arzi - a.ai * zr[r]) * inv[r] - ln.swc;
  }
};

template <typename T, int K>
struct Series {
  __device__ __forceinline__ void operator()(const T (&zr)[kR], const Line<T>& ln,
                                             T (&val)[kR]) const {
    const Strength<T> a(ln);
    T inv[kR];
    inv_r2(zr, ln.zi, inv);
#pragma unroll
    for (int r = 0; r < kR; ++r) val[r] = series_term<T, K>(zr[r], ln, a, inv[r]);
  }
};

// Weideman rational of order N (coefficients in shared memory, L first),
// blended with the K-term series where |z|^2 > 512; each frequency's one
// divide (|z|^2 or |L - iz|^2) is taken with the others'.  The first two
// Horner steps (from p = 0) are written out.
template <typename T, int K, int N>
struct Parts {
  const T* wc;
  __device__ __forceinline__ void operator()(const T (&zr)[kR], const Line<T>& ln,
                                             T (&val)[kR]) const {
    const Strength<T> a(ln);
    const T zi = ln.zi;
    const T Lw = wc[0];
    const T dr = Lw + zi;  // Re(L - iz)
    const T nr = Lw - zi;  // Re(L + iz)
    bool big[kR];
    T inv[kR];
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      const T r2 = zr[r] * zr[r] + zi * zi;
      big[r] = r2 > T(kAsymR2);
      inv[r] = big[r] ? r2 : dr * dr + zr[r] * zr[r];
    }
    recip(inv);
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      if (big[r]) {
        val[r] = series_term<T, K>(zr[r], ln, a, inv[r]);
        continue;
      }
      const T di = -zr[r];  // Im(L - iz)
      const T ni = zr[r];   // Im(L + iz)
      const T Zr = (nr * dr + ni * di) * inv[r];
      const T Zi = (ni * dr - nr * di) * inv[r];
      T pr = wc[1] * Zr + wc[2];
      T pi = wc[1] * Zi;
#pragma unroll
      for (int k = 3; k <= N; ++k) {
        const T t = pr * Zr - pi * Zi + wc[k];
        pi = pr * Zi + pi * Zr;
        pr = t;
      }
      const T tr = (T(2) * (pr * dr + pi * di)) * inv[r] + T(kInvSqrtPi);
      const T ti = (T(2) * (pi * dr - pr * di)) * inv[r];
      const T wr = (tr * dr + ti * di) * inv[r];
      const T wi = (ti * dr - tr * di) * inv[r];
      val[r] = (ln.sr * wr - ln.si * wi) - ln.swc;
    }
  }
};

// add this group's 32 staged lines (records at sh) into the sums bs of
// this thread's kR frequencies: with the four groups, four chains of 32
// lines per block and frequency.  [wlo, whi] spans the warp's frequencies.
template <typename T, typename W>
__device__ __forceinline__ void block_sum(const T* __restrict__ sh,
                                          const T (&fv)[kR], T wlo, T whi,
                                          const W& term, T (&bs)[kR]) {
#pragma unroll
  for (int r = 0; r < kR; ++r) bs[r] = T(0);
#pragma unroll 2
  for (int l = 0; l < kGroupLines; ++l) {
    const Line<T> ln = load_line(sh + l * kRec);
    // fl(f - f0) is monotone in f, so a window that misses both ends of
    // the warp's range misses every frequency in it
    if (wlo - ln.f0 > ln.cut || ln.f0 - whi > ln.cut) continue;
    T df[kR], zr[kR], val[kR];
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      df[r] = fv[r] - ln.f0;
      zr[r] = ln.igd * df[r];
    }
    term(zr, ln, val);
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      if (fabs(df[r]) <= ln.cut) bs[r] += val[r];
    }
  }
}

// NP = 1: out[z, f] = v[0].  NP = 3: out[z, c, f] = sum_p tab[z, p, c] v[p]
// (21 table values per level, read through the read-only cache)
template <typename T, int NP>
__device__ __forceinline__ void store_out(const T (&v)[NP], const T* __restrict__ tab,
                                          T* __restrict__ out, int z, int tile,
                                          int nf, int i) {
  const long fcount = static_cast<long>(nf) * kTF;
  const long fi = static_cast<long>(tile) * kTF + i;
  if constexpr (NP == 1) {
    out[z * fcount + fi] = v[0];
  } else {
    const T* tz = tab + static_cast<long>(z) * 3 * 7;
#pragma unroll
    for (int c = 0; c < 7; ++c) {
      out[(static_cast<long>(z) * 7 + c) * fcount + fi] =
          (__ldg(tz + c) * v[0] + __ldg(tz + 7 + c) * v[1]) + __ldg(tz + 14 + c) * v[2];
    }
  }
}

// grid (Z * nf * split), kThreads threads.  f [nf*kTF]; lines [Z, nl*kTL,
// kRec] records; ext [Z, 4, nl] as (f0_min, f0_max, igd_min, zi_min);
// blkidx [Z, nf, nl]; nvisit [Z, nf]; wcoef [nweid + 1]; NP = 3: blkpol
// [nl] in 0..2 and tab [Z, 3, 7].  Block u takes chunk s = u % split of
// row (z, tile) = u / split: visits [s nv / split, (s + 1) nv / split).
// split = 1 writes out [Z, nf*kTF] (NP = 1) or [Z, 7, nf*kTF] (NP = 3);
// split > 1 writes the chunk's sums to part [Z * nf * split, NP, kTF].
template <typename T, int NP>
__global__ void __launch_bounds__(kThreads, sizeof(T) == 4 ? 4 : 1)
voigt_sum_kernel(const T* __restrict__ f, const T* __restrict__ lines,
                 const T* __restrict__ ext, const int* __restrict__ blkidx,
                 const int* __restrict__ nvisit, const T* __restrict__ wcoef,
                 const int* __restrict__ blkpol, const T* __restrict__ tab,
                 T* __restrict__ part, T* __restrict__ out, int nf, int nl,
                 int nweid, int split) {
  constexpr bool kF32 = sizeof(T) == 4;
  constexpr int kAsymTerms = kF32 ? 3 : 4;
  constexpr int kMidTerms = kF32 ? 6 : 8;
  constexpr int kWeid = kF32 ? 16 : 24;  // Weideman order, weideman_order()
  constexpr int kBlockElems = kTL * kRec;
  constexpr int kChunks = kBlockElems * static_cast<int>(sizeof(T)) / 16;
  constexpr int kPerChunk = 16 / static_cast<int>(sizeof(T));
  const T mid_gate = T(2.0 * (kF32 ? 36.0 : 150.0));

  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);  // [kStages][kTL][kRec]
  T* wc = ring + kStages * kBlockElems;  // [nweid + 1] Weideman table
  T* red = ring;  // after the loop: [kGroups][NP][kTF], over the ring
  static_assert(kGroups * NP * kTF <= kStages * kBlockElems, "red fits the ring");

  const int unit = blockIdx.x;
  const int s = unit % split;
  const int row = unit / split;
  const int z = row / nf;
  const int tile = row % nf;
  const int tid = threadIdx.x;
  const int g = tid / (kTF / kR);  // line group
  const int q = tid % (kTF / kR);  // frequency quad in the tile
  const long lp = static_cast<long>(nl) * kTL;
  const T* lz = lines + static_cast<long>(z) * lp * kRec;
  const T* ez = ext + static_cast<long>(z) * 4 * nl;
  const long t0 = static_cast<long>(tile) * kTF;
  const int* bl = blkidx + static_cast<long>(row) * nl;
  const int nv = nvisit[row];
  const int j0 = static_cast<int>(static_cast<long>(s) * nv / split);
  const int j1 = static_cast<int>(static_cast<long>(s + 1) * nv / split);

  auto stage = [&](int j, int buf) {
    const T* src = lz + static_cast<long>(bl[j]) * kBlockElems;
    T* dst = ring + buf * kBlockElems;
    for (int c = tid; c < kChunks; c += kThreads) {
      cp_async<16>(dst + c * kPerChunk, src + c * kPerChunk);
    }
  };
#pragma unroll
  for (int k = 0; k < kStages - 1; ++k) {
    if (j0 + k < j1) stage(j0 + k, k);
    cp_async_commit();
  }

  for (int i = tid; i <= nweid; i += kThreads) wc[i] = wcoef[i];
  T fv[kR];
#pragma unroll
  for (int r = 0; r < kR; ++r) fv[r] = f[t0 + q * kR + r];
  // the warp's frequency range, for skipping lines whose window misses it
  T wlo = fv[0], whi = fv[0];
#pragma unroll
  for (int r = 1; r < kR; ++r) {
    wlo = tmin(wlo, fv[r]);
    whi = tmax(whi, fv[r]);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    wlo = tmin(wlo, __shfl_xor_sync(0xffffffffu, wlo, o));
    whi = tmax(whi, __shfl_xor_sync(0xffffffffu, whi, o));
  }
  const T t_lo = f[t0];
  const T t_hi = f[t0 + kTF - 1];

  T acc[NP][kR];
#pragma unroll
  for (int p = 0; p < NP; ++p) {
#pragma unroll
    for (int r = 0; r < kR; ++r) acc[p][r] = T(0);
  }
  for (int j = j0; j < j1; ++j) {
    const int i = j - j0;
    __syncthreads();  // the buffer refilled below was consumed at j - 1
    if (j + kStages - 1 < j1) stage(j + kStages - 1, (i + kStages - 1) % kStages);
    cp_async_commit();
    cp_async_wait<kStages - 1>();  // this thread's copies of block j landed
    __syncthreads();               // and every other thread's
    const T* sh = ring + (i % kStages) * kBlockElems + g * kGroupLines * kRec;
    const int jb = bl[j];
    // |z|^2 >= (igd_min gap)^2 + zi_min^2 over the whole (tile, block)
    const T gap = tmax(tmax(ez[jb] - t_hi, t_lo - ez[nl + jb]), T(0));
    const T gmin = mul_rn(ez[2 * nl + jb], gap);
    const T zmin = ez[3 * nl + jb];
    const T bound2 = mul_rn(gmin, gmin) + mul_rn(zmin, zmin);
    T bs[kR];
    if (bound2 > T(2.0 * kDeepR2)) {
      block_sum(sh, fv, wlo, whi, Deep<T>{}, bs);
    } else if (bound2 > T(2.0 * kAsymR2)) {
      block_sum(sh, fv, wlo, whi, Series<T, kAsymTerms>{}, bs);
    } else if (bound2 > mid_gate) {
      block_sum(sh, fv, wlo, whi, Series<T, kMidTerms>{}, bs);
    } else {
      block_sum(sh, fv, wlo, whi, Parts<T, kAsymTerms, kWeid>{wc}, bs);
    }
    if constexpr (NP == 1) {
#pragma unroll
      for (int r = 0; r < kR; ++r) acc[0][r] += bs[r];
    } else {
      // one polarization per block; the selects keep acc in registers
      const int pb = __ldg(blkpol + jb);
#pragma unroll
      for (int p = 0; p < NP; ++p) {
#pragma unroll
        for (int r = 0; r < kR; ++r) acc[p][r] += pb == p ? bs[r] : T(0);
      }
    }
  }

  // the groups' sums, added in a fixed order: ((g0 + g1) + (g2 + g3))
  cp_async_wait<0>();
  __syncthreads();
#pragma unroll
  for (int p = 0; p < NP; ++p) {
#pragma unroll
    for (int r = 0; r < kR; ++r) red[(g * NP + p) * kTF + q * kR + r] = acc[p][r];
  }
  __syncthreads();
  T v[NP];
#pragma unroll
  for (int p = 0; p < NP; ++p) {
    const T* rp = red + p * kTF + tid;
    v[p] = (rp[0] + rp[NP * kTF]) + (rp[2 * NP * kTF] + rp[3 * NP * kTF]);
  }
  if (split == 1) {
    store_out<T, NP>(v, tab, out, z, tile, nf, tid);
  } else {
#pragma unroll
    for (int p = 0; p < NP; ++p) part[(static_cast<long>(unit) * NP + p) * kTF + tid] = v[p];
  }
}

// grid (Z * nf), kTF threads: the chunks' sums of each (level, tile) in
// chunk order, then the output as in voigt_sum_kernel
template <typename T, int NP>
__global__ void __launch_bounds__(kTF)
combine_kernel(const T* __restrict__ part, const T* __restrict__ tab,
               T* __restrict__ out, int nf, int split) {
  const int row = blockIdx.x;
  const int tid = threadIdx.x;
  T v[NP];
#pragma unroll
  for (int p = 0; p < NP; ++p) {
    const T* pp = part + (static_cast<long>(row) * split * NP + p) * kTF + tid;
    T a = pp[0];
    for (int s = 1; s < split; ++s) a += pp[static_cast<long>(s) * NP * kTF];
    v[p] = a;
  }
  store_out<T, NP>(v, tab, out, row / nf, row % nf, nf, tid);
}

template <typename T, int NP>
int launch(const void* f, const void* lines, const void* ext,
           const void* blkidx, const void* nvisit, const void* wcoef,
           const void* blkpol, const void* tab, void* part, void* out, int Z,
           int nf, int nl, int nweid, int split, void* stream) {
  if (nweid != (sizeof(T) == 4 ? 16 : 24)) return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  const size_t smem = (static_cast<size_t>(kStages) * kTL * kRec + nweid + 1) * sizeof(T);
  const unsigned units = static_cast<unsigned>(Z) * nf * split;
  voigt_sum_kernel<T, NP><<<units, kThreads, smem, st>>>(
      static_cast<const T*>(f), static_cast<const T*>(lines),
      static_cast<const T*>(ext), static_cast<const int*>(blkidx),
      static_cast<const int*>(nvisit), static_cast<const T*>(wcoef),
      static_cast<const int*>(blkpol), static_cast<const T*>(tab),
      static_cast<T*>(part), static_cast<T*>(out), nf, nl, nweid, split);
  if (split > 1) {
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    combine_kernel<T, NP><<<static_cast<unsigned>(Z) * nf, kTF, 0, st>>>(
        static_cast<const T*>(part), static_cast<const T*>(tab),
        static_cast<T*>(out), nf, split);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define VOIGT_ENTRY(name, T, NP)                                              \
  extern "C" int name(const void* f, const void* lines, const void* ext,     \
                      const void* blkidx, const void* nvisit,                \
                      const void* wcoef, const void* blkpol, const void* tab, \
                      void* part, void* out, int Z, int nf, int nl,          \
                      int nweid, int split, void* stream) {                  \
    return launch<T, NP>(f, lines, ext, blkidx, nvisit, wcoef, blkpol, tab,  \
                         part, out, Z, nf, nl, nweid, split, stream);        \
  }

VOIGT_ENTRY(voigt_sum_f32, float, 1)
VOIGT_ENTRY(voigt_sum_f64, double, 1)
VOIGT_ENTRY(voigt_sum_pol_f32, float, 3)
VOIGT_ENTRY(voigt_sum_pol_f64, double, 3)
