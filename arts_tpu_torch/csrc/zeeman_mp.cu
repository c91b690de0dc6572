// Zeeman parent-pole expansion field for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel _zeeman_mp_kernel / zeeman_mp_eval in
// arts_tpu/ops/zeeman_mp_kernel.py (pallas_call at :256).  The Zeeman
// components of one parent line collapse, beyond a small near radius, into
// a P-term pole expansion around the parent (ops/zeeman_mp_kernel.py in
// arts_tpu_torch builds the moments).  For every level z, frequency f and
// component c < 7 this kernel sums over all parents p
//
//   out[z, c, f] = sum_p  [inwin far] sum_{j=1..P} Re(M_pjc u_p^j)
//                        - [inwin] swcsum_pc,
//   u_p = R_p / (f - c_p + i g0_p) = R_p (dr - i g0_p) / |f - c_p|^2,
//   inwin = |dr| <= cut_p,  far = |f - c_p|^2 >= rnear_p^2,  dr = f - c_p.
//
// Bound.  Per in-window far (parent, frequency) pair: 8 + 34 P
// floating-point operations (add, multiply, divide 1, FMA 2), 178 at
// P = 5; 11 per in-window near pair, 4 per pair out of window.  The bytes
// are the pole records and 7 outputs per frequency (40 MB and 7 MB at the
// benchmark's 60 levels x 2048 parents x 4096 frequencies: 0.014 ms at
// 3.35 TB/s), so it is bound by the FP32 pipes, and, since the sum is
// FMAs and a few selects, by instruction issue.
//
// Design.  One block of kThreads threads per (tile of kThreads * kFPT
// frequencies, level, one of kSplit parts of the parents); a loop inside
// the block takes the place of the TPU grid's sequential parent-block axis.
//  * Each thread owns kFPT adjacent frequencies, so one read of a
//    parent's record from shared memory serves kFPT pairs, which are
//    independent chains.
//  * A record is [c_re, g0, R, rnear2, cut, swcsum[7], M_re[P][7],
//    M_im[P][7]] padded to a multiple of 4 values (84 at P = 5: 21 float4
//    or 42 double2); each 16-byte piece is read once, as the terms need it.
//  * Before the sum the block takes the least and largest of its
//    frequencies and keeps, in order, the parents whose window reaches that
//    range (fmin - c <= cut and fmax - c >= -cut; rounding of f - c is
//    monotone in f, so a parent dropped here has no pair in its window:
//    it adds exactly nothing, as in the per-pair test).  The kept parents
//    are staged chunk by chunk into a ring of kStages shared buffers with
//    cp.async, one barrier per chunk, the next chunk's copy in flight
//    while this one is summed.
//  * A warp covers 32 kFPT adjacent frequencies and sums only the staged
//    parents
//    whose window reaches its own range (the same exact test, one ballot
//    per 32 parents, the hits listed in shared memory): a branch that is
//    uniform across the warp.  The summing loop takes kUnroll parents per
//    iteration, so one parent's reciprocal chain runs beside another's
//    sums.
//  * Within a parent the masks are selects folded into u and into the
//    swcsum subtraction, so a warp across a window edge or a near point
//    does not split.
//  * u = R recip(d2): the hardware reciprocal and one Newton step in
//    float32 (the IEEE quotient in float64); the masks do not read it.
//  * |f - c|^2 is formed from separately rounded products (no FMA
//    contraction), exactly as the tensor code forms it, so the far mask
//    here and the near mask of the exact near correction are complements
//    bit for bit: no grid point is left out or counted twice.
//  * Each chunk's sum goes to its own partial before it is added to the
//    running total, so no single register sums all parents' terms; the
//    order is fixed and there are no atomics, so runs repeat bit for bit.
//    Each of the kSplit parts writes its own slab and combine_kernel adds
//    the slabs in order: 4 blocks per tile and level balance tiles of
//    unequal work over the SMs.
// It stays issue-bound: ~120 instructions per (parent, frequency) pair in
// the summing loop, three quarters of them FFMA (PERF.md, PR 9).
// tools/zeeman_mp_variants.py times other values of the constants below and
// other designs (by text substitutions of this file).

#include <cuda_runtime.h>

#include "async.cuh"
#include "jacobi.cuh"

namespace {

using async::cp_async;
using async::cp_async_commit;
using async::cp_async_wait;
using jacobi::mul_rn;
using jacobi::recip;

constexpr int kComp = 7;
constexpr int kThreads = 128;  // threads per block
constexpr int kPB = 32;        // parents staged per chunk
constexpr int kStages = 2;     // chunk buffers in the cp.async ring
constexpr int kScan = 32;      // parents per thread in one round of the window test
constexpr int kFPT = 2;        // adjacent frequencies per thread
constexpr int kUnroll = 2;     // parents per iteration of the summing loop
constexpr int kSplit = 4;      // blocks over the parents of one tile and level

// values per record: 12 + 14 P padded to 16-byte rows
template <int P>
__host__ __device__ constexpr int rec_width() { return (12 + 2 * kComp * P + 3) / 4 * 4; }

// dynamic shared memory: the ring, the warps' frequency extremes, the
// kept parents of a round, the warps' counts and their lists of parents
template <typename T, int P>
constexpr size_t smem_bytes() {
  return sizeof(T) * (kStages * kPB * rec_width<P>() + 2 * (kThreads / 32)) +
         sizeof(unsigned short) * kScan * kThreads + sizeof(int) * (kThreads / 32) * 33;
}

// one parent's terms at the thread's kFPT frequencies, added to part
template <typename T, int P>
__device__ __forceinline__ void pole(const T* r, const T (&fv)[kFPT], T (&part)[kComp][kFPT]) {
  constexpr int W = rec_width<P>();
  constexpr int MI = 12 + kComp * P;  // first M_im value
  // the record's values, each 16-byte piece read once, at its first need
  // (`have` folds away: every index is a constant once the loops unroll)
  constexpr int V = 16 / sizeof(T);
  T v[W];
  bool have[W / V] = {};
  auto need = [&](int lo, int hi) {
#pragma unroll
    for (int q = lo / V; q <= hi / V; ++q) {
      if (!have[q]) {
        T piece[V];
        async::ld16(r + q * V, piece);
#pragma unroll
        for (int i = 0; i < V; ++i) v[q * V + i] = piece[i];
        have[q] = true;
      }
    }
  };
  need(0, 11);
  const T c = v[0], g0 = v[1], R = v[2], rn2 = v[3], cut = v[4];
  const T g02 = mul_rn(g0, g0);
  T ur[kFPT], ui[kFPT], w[kFPT];
#pragma unroll
  for (int k = 0; k < kFPT; ++k) {
    const T dr = fv[k] - c;
    const T d2 = mul_rn(dr, dr) + g02;
    // the predicate tabs(dr) <= cut for every dr (-0 and NaN included), by
    // the sign-bit modifier in place of a select
    const bool inwin = fabs(dr) <= cut;
    const bool far = inwin && d2 >= rn2;  // near: !(d2 >= rn2), corrected outside
    const T invR = R * recip(d2);  // float32: hardware reciprocal, one Newton step
    const T m = far ? invR : T(0);
    ur[k] = dr * m;
    ui[k] = -(g0 * m);
    w[k] = inwin ? T(1) : T(0);
  }
#pragma unroll
  for (int cc = 0; cc < kComp; ++cc) {
#pragma unroll
    for (int k = 0; k < kFPT; ++k) part[cc][k] -= w[k] * v[5 + cc];
  }
  T Ur[kFPT], Ui[kFPT];
#pragma unroll
  for (int k = 0; k < kFPT; ++k) {
    Ur[k] = ur[k];
    Ui[k] = ui[k];
  }
#pragma unroll
  for (int j = 0; j < P; ++j) {
    need(12 + kComp * j, 12 + kComp * j + kComp - 1);
    need(MI + kComp * j, MI + kComp * j + kComp - 1);
#pragma unroll
    for (int cc = 0; cc < kComp; ++cc) {
#pragma unroll
      for (int k = 0; k < kFPT; ++k) {
        part[cc][k] += v[12 + kComp * j + cc] * Ur[k];
        part[cc][k] -= v[MI + kComp * j + cc] * Ui[k];
      }
    }
    if (j < P - 1) {
#pragma unroll
      for (int k = 0; k < kFPT; ++k) {
        const T nr = Ur[k] * ur[k] - Ui[k] * ui[k];
        Ui[k] = Ur[k] * ui[k] + Ui[k] * ur[k];
        Ur[k] = nr;
      }
    }
  }
}

// grid (ceil(F / (kThreads kFPT)), Z, kSplit).  f [F]; rec [Z, NP, W];
// out [kSplit, Z, 7, F], the slabs of the parts
template <typename T, int P>
__global__ void __launch_bounds__(kThreads)
zeeman_mp_kernel(const T* __restrict__ f, const T* __restrict__ rec,
                 T* __restrict__ out, int F, int NP) {
  constexpr int W = rec_width<P>();
  constexpr int V = 16 / sizeof(T);  // values per 16-byte copy
  constexpr int kPieces = W / V;     // copies per record
  constexpr int kWarps = kThreads / 32;
  constexpr int kRound = kScan * kThreads;  // parents per round of the window test
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);   // [kStages][kPB][W]
  T* ext = ring + kStages * kPB * W;      // [2][kWarps] least, largest frequency
  unsigned short* kept = reinterpret_cast<unsigned short*>(ext + 2 * kWarps);  // [kRound]
  int* cnt = reinterpret_cast<int*>(kept + kRound);                            // [kWarps]

  const int z = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  int* sel = cnt + kWarps + warp * 32;  // this warp's parents of a ballot
  const int base = blockIdx.x * kThreads * kFPT;
  int fi[kFPT];
  T fv[kFPT];
#pragma unroll
  for (int k = 0; k < kFPT; ++k) {
    fi[k] = base + tid * kFPT + k;
    fv[k] = f[fi[k] < F ? fi[k] : F - 1];  // f[F - 1] is this tile's too
  }

  // the block's frequency range
  T lo = fv[0], hi = fv[0];
#pragma unroll
  for (int k = 1; k < kFPT; ++k) {
    lo = fv[k] < lo ? fv[k] : lo;
    hi = fv[k] > hi ? fv[k] : hi;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const T a = __shfl_xor_sync(0xffffffffu, lo, o);
    const T b = __shfl_xor_sync(0xffffffffu, hi, o);
    lo = a < lo ? a : lo;
    hi = b > hi ? b : hi;
  }
  const T wlo = lo, whi = hi;  // the warp's
  if (lane == 0) {
    ext[warp] = lo;
    ext[kWarps + warp] = hi;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kWarps; ++i) {
    lo = ext[i] < lo ? ext[i] : lo;
    hi = ext[kWarps + i] > hi ? ext[kWarps + i] : hi;
  }

  // this part's parents
  const int p_lo = static_cast<int>(static_cast<long>(NP) * blockIdx.z / gridDim.z);
  const int p_hi = static_cast<int>(static_cast<long>(NP) * (blockIdx.z + 1) / gridDim.z);
  const T* rz = rec + static_cast<long>(z) * NP * W;

  T acc[kComp][kFPT];
#pragma unroll
  for (int cc = 0; cc < kComp; ++cc) {
#pragma unroll
    for (int k = 0; k < kFPT; ++k) acc[cc][k] = T(0);
  }

  for (int r0 = p_lo; r0 < p_hi; r0 += kRound) {
    // the window test: bit i of `mask` for parent q0 + i
    const int q0 = r0 + tid * kScan;
    const int nq = p_hi - q0 < 0 ? 0 : (p_hi - q0 < kScan ? p_hi - q0 : kScan);
    unsigned mask = 0u;
#pragma unroll 8
    for (int i = 0; i < kScan; ++i) {
      if (i < nq) {
        const T* r = rz + static_cast<long>(q0 + i) * W;
        const T c = r[0], cut = r[4];
        const bool hit = lo - c <= cut && hi - c >= -cut;
        mask |= static_cast<unsigned>(hit) << i;
      }
    }
    // the kept parents in order: a block-wide exclusive scan of the counts
    const int mine = __popc(mask);
    int incl = mine;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += y;
    }
    __syncthreads();  // the previous round's list and counts are consumed
    if (lane == 31) cnt[warp] = incl;
    __syncthreads();
    int pos = incl - mine, total = 0;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) {
      pos += i < warp ? cnt[i] : 0;
      total += cnt[i];
    }
    for (unsigned m = mask; m != 0u; m &= m - 1u) {
      kept[pos++] = static_cast<unsigned short>(tid * kScan + __ffs(m) - 1);
    }
    __syncthreads();

    const int nch = (total + kPB - 1) / kPB;
    auto stage = [&](int k) {
      if (k < nch) {
        T* dst = ring + (k % kStages) * kPB * W;
        const int rows = total - k * kPB < kPB ? total - k * kPB : kPB;
        for (int i = tid; i < rows * kPieces; i += kThreads) {
          const int row = i / kPieces;
          const int piece = i - row * kPieces;
          const long p = r0 + kept[k * kPB + row];
          cp_async<16>(dst + row * W + piece * V, rz + p * W + piece * V);
        }
      }
      cp_async_commit();
    };
#pragma unroll
    for (int k = 0; k < kStages - 1; ++k) stage(k);
    for (int k = 0; k < nch; ++k) {
      cp_async_wait<kStages - 2>();  // this thread's copies of chunk k landed
      __syncthreads();               // every thread's; chunk k - 1 is consumed
      stage(k + kStages - 1);
      const T* buf = ring + (k % kStages) * kPB * W;
      const int rows = total - k * kPB < kPB ? total - k * kPB : kPB;
      T part[kComp][kFPT];
#pragma unroll
      for (int cc = 0; cc < kComp; ++cc) {
#pragma unroll
        for (int kk = 0; kk < kFPT; ++kk) part[cc][kk] = T(0);
      }
      // the same window test against the warp's range, 32 parents a ballot
      for (int p0 = 0; p0 < rows; p0 += 32) {
        const T* r = buf + (p0 + lane) * W;
        const bool hit = p0 + lane < rows && wlo - r[0] <= r[4] && whi - r[0] >= -r[4];
        const unsigned m = __ballot_sync(0xffffffffu, hit);
        if (hit) sel[__popc(m & ((1u << lane) - 1u))] = p0 + lane;
        __syncwarp();
        const int n = __popc(m);
#pragma unroll kUnroll
        for (int i = 0; i < n; ++i) pole<T, P>(buf + sel[i] * W, fv, part);
        __syncwarp();  // sel is read before the next ballot writes it
      }
#pragma unroll
      for (int cc = 0; cc < kComp; ++cc) {
#pragma unroll
        for (int kk = 0; kk < kFPT; ++kk) acc[cc][kk] += part[cc][kk];
      }
    }
  }

  T* o = out + (static_cast<long>(blockIdx.z) * gridDim.y + z) * kComp * F;
#pragma unroll
  for (int k = 0; k < kFPT; ++k) {
    if (fi[k] < F) {
#pragma unroll
      for (int cc = 0; cc < kComp; ++cc) o[static_cast<long>(cc) * F + fi[k]] = acc[cc][k];
    }
  }
}

// out [n] = the slabs part [kSplit, n] added in order
template <typename T>
__global__ void combine_kernel(const T* __restrict__ part, T* __restrict__ out, long n) {
  for (long i = blockIdx.x * static_cast<long>(blockDim.x) + threadIdx.x; i < n;
       i += static_cast<long>(gridDim.x) * blockDim.x) {
    T a = part[i];
#pragma unroll
    for (int s = 1; s < kSplit; ++s) a += part[s * n + i];
    out[i] = a;
  }
}

template <typename T, int P>
int launch_p(const void* f, const void* rec, void* out, void* part, int Z, int F, int NP,
             void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  constexpr size_t smem = smem_bytes<T, P>();
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        zeeman_mp_kernel<T, P>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int tile = kThreads * kFPT;
  const dim3 grid((F + tile - 1) / tile, Z, kSplit);
  zeeman_mp_kernel<T, P><<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(f), static_cast<const T*>(rec), static_cast<T*>(part), F, NP);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const long n = static_cast<long>(Z) * kComp * F;
  const long blocks = (n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096;
  combine_kernel<T><<<static_cast<unsigned>(blocks), 256, 0, st>>>(
      static_cast<const T*>(part), static_cast<T*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

// built for the port's expansion length (ops/zeeman_mp_kernel.py MP_TERMS);
// part holds `slabs` [Z, 7, F] slabs, which must be kSplit (SPLIT there)
template <typename T>
int launch(const void* f, const void* rec, void* out, void* part, int Z, int F, int NP,
           int P, int slabs, void* stream) {
  if (P != 5 || slabs != kSplit) return static_cast<int>(cudaErrorInvalidValue);
  return launch_p<T, 5>(f, rec, out, part, Z, F, NP, stream);
}

}  // namespace

extern "C" int zeeman_mp_f32(const void* f, const void* rec, void* out, void* part, int Z,
                             int F, int NP, int P, int slabs, void* stream) {
  return launch<float>(f, rec, out, part, Z, F, NP, P, slabs, stream);
}

extern "C" int zeeman_mp_f64(const void* f, const void* rec, void* out, void* part, int Z,
                             int F, int NP, int P, int slabs, void* stream) {
  return launch<double>(f, rec, out, part, Z, F, NP, P, slabs, stream);
}
