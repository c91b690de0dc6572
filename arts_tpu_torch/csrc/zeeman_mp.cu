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
// Design.  One CUDA block per (frequency tile, level), one thread per
// frequency; a loop over chunks of PB parents takes the place of the TPU
// grid's sequential parent-block axis.  Each chunk's pole records are
// staged in shared memory by the whole block (contiguous, coalesced
// loads), and every thread reads them as broadcasts.  A record is
//   [c_re, g0, R, rnear2, cut, swcsum[7], M_re[P][7], M_im[P][7]]
// (12 + 14 P values).  Per in-window far parent a thread forms u by one
// IEEE divide, the powers u^2..u^P by complex products, and 7 sums of
// Mr u_r - Mi u_i in full precision: the TPU kernel ran the tail terms on
// the MXU in bf16 for speed; here the whole contraction is FP32 (FP64 for
// doubles) FMAs in the thread's registers.  Each chunk's sum goes to its
// own partial before it is added to the running total, so no single
// register sums all 2048 parents' terms.  |f - c|^2 is formed from
// separately rounded products (no FMA contraction), exactly as the tensor
// code forms it, so the far mask here and the near mask of the exact
// near correction are complements bit for bit: no grid point is left out
// or counted twice.  Parents are not padded: the chunk loop and the
// frequency guard mask the ragged edges.
//
// Bound.  Per in-window far (parent, frequency) pair: 8 + 34 P
// floating-point operations (add, multiply, divide 1, FMA 2), 178 at
// P = 5; 11 per in-window near pair, 4 per pair out of window.  The bytes
// are the pole records (one read per block, from L2 after the first
// level's tiles) and 7 outputs per frequency, so it is bound by
// operations on the FP32 pipes.

#include <cuda_runtime.h>

namespace {

constexpr int kComp = 7;
constexpr int kPB = 32;  // parents staged per chunk

template <typename T>
__device__ __forceinline__ T tabs(T a) { return a < T(0) ? -a : a; }

// products that the compiler must not fuse into an FMA (see above)
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }

// grid (ceil(F / blockDim.x), Z).  f [F]; rec [Z, NP, 12 + 14 P];
// out [Z, 7, F].
template <typename T, int P>
__global__ void zeeman_mp_kernel(const T* __restrict__ f,
                                 const T* __restrict__ rec,
                                 T* __restrict__ out, int F, int NP) {
  constexpr int W = 12 + 2 * kComp * P;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sh = reinterpret_cast<T*>(smem);  // [kPB][W]

  const int z = blockIdx.y;
  const int tid = threadIdx.x;
  const int fi = blockIdx.x * blockDim.x + tid;
  const T fv = f[fi < F ? fi : F - 1];
  const T* rz = rec + static_cast<long>(z) * NP * W;

  T acc[kComp];
#pragma unroll
  for (int c = 0; c < kComp; ++c) acc[c] = T(0);

  for (int p0 = 0; p0 < NP; p0 += kPB) {
    const int n = NP - p0 < kPB ? NP - p0 : kPB;
    __syncthreads();  // the previous chunk is consumed
    const T* src = rz + static_cast<long>(p0) * W;
    for (int i = tid; i < n * W; i += blockDim.x) sh[i] = src[i];
    __syncthreads();

    T part[kComp];
#pragma unroll
    for (int c = 0; c < kComp; ++c) part[c] = T(0);
    for (int p = 0; p < n; ++p) {
      const T* r = sh + p * W;
      const T dr = fv - r[0];
      const T g0 = r[1];
      const T d2 = mul_rn(dr, dr) + mul_rn(g0, g0);
      if (!(tabs(dr) <= r[4])) continue;  // out of the parent's window
#pragma unroll
      for (int c = 0; c < kComp; ++c) part[c] -= r[5 + c];
      if (!(d2 >= r[3])) continue;  // near: corrected outside the kernel
      const T invR = r[2] / d2;
      const T ur = dr * invR;
      const T ui = -(g0 * invR);
      T Ur = ur, Ui = ui;
      const T* Mr = r + 12;
      const T* Mi = r + 12 + kComp * P;
#pragma unroll
      for (int j = 0; j < P; ++j) {
#pragma unroll
        for (int c = 0; c < kComp; ++c) {
          part[c] += Mr[j * kComp + c] * Ur;
          part[c] -= Mi[j * kComp + c] * Ui;
        }
        if (j < P - 1) {
          const T nr = Ur * ur - Ui * ui;
          Ui = Ur * ui + Ui * ur;
          Ur = nr;
        }
      }
    }
#pragma unroll
    for (int c = 0; c < kComp; ++c) acc[c] += part[c];
  }
  if (fi < F) {
#pragma unroll
    for (int c = 0; c < kComp; ++c) {
      out[(static_cast<long>(z) * kComp + c) * F + fi] = acc[c];
    }
  }
}

template <typename T, int P>
int launch_p(const void* f, const void* rec, void* out, int Z, int F, int NP,
             int tf, void* stream) {
  constexpr int W = 12 + 2 * kComp * P;
  const dim3 grid((F + tf - 1) / tf, Z);
  const size_t smem = static_cast<size_t>(kPB) * W * sizeof(T);
  zeeman_mp_kernel<T, P><<<grid, tf, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(f), static_cast<const T*>(rec),
      static_cast<T*>(out), F, NP);
  return static_cast<int>(cudaGetLastError());
}

// built for the port's expansion length (ops/zeeman_mp_kernel.py MP_TERMS)
template <typename T>
int launch(const void* f, const void* rec, void* out, int Z, int F, int NP,
           int P, int tf, void* stream) {
  if (P != 5) return static_cast<int>(cudaErrorInvalidValue);
  return launch_p<T, 5>(f, rec, out, Z, F, NP, tf, stream);
}

}  // namespace

extern "C" int zeeman_mp_f32(const void* f, const void* rec, void* out, int Z,
                             int F, int NP, int P, int tf, void* stream) {
  return launch<float>(f, rec, out, Z, F, NP, P, tf, stream);
}

extern "C" int zeeman_mp_f64(const void* f, const void* rec, void* out, int Z,
                             int F, int NP, int P, int tf, void* stream) {
  return launch<double>(f, rec, out, Z, F, NP, P, tf, stream);
}
