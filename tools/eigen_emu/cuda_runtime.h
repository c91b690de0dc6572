// CPU stand-in for the CUDA built-ins the eigen kernels of
// csrc/disort_fused.cu, csrc/eigh_jacobi.cu and csrc/zeeman_mp.cu use
// (tools/eigen_emu.py): one block at a time, one
// std::thread per CUDA thread, a block-wide barrier for __syncwarp,
// __syncthreads and each shuffle or vote (stronger than the warp's, which
// the kernels' uniform control flow allows).
#pragma once
#include <barrier>
#include <cmath>
#include <cstring>
using std::exp;
using std::fabs;
using std::sqrt;
struct dim3 {
  unsigned x = 1, y = 1, z = 1;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
typedef int cudaError_t;
typedef void* cudaStream_t;
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __restrict__ __restrict
inline thread_local dim3 threadIdx, blockIdx;
inline dim3 gridDim;
inline std::barrier<>* emu_bar;
inline unsigned char* emu_smem;
inline unsigned char emu_xch[1024 * 8];
inline void __syncwarp(unsigned = 0xffffffffu) { emu_bar->arrive_and_wait(); }
// rounded one by one: the emulator compiles with -ffp-contract=off
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline double __dmul_rn(double a, double b) { return a * b; }
inline double __dadd_rn(double a, double b) { return a + b; }
inline double __dsub_rn(double a, double b) { return a - b; }
inline void __syncthreads() { emu_bar->arrive_and_wait(); }
template <typename T>
T emu_xchg(T v, int src_tid) {
  std::memcpy(emu_xch + threadIdx.x * 8, &v, sizeof(T));
  emu_bar->arrive_and_wait();
  T r;
  std::memcpy(&r, emu_xch + src_tid * 8, sizeof(T));
  emu_bar->arrive_and_wait();
  return r;
}
template <typename T>
T __shfl_sync(unsigned, T v, int src, int width = 32) {
  const int t = threadIdx.x, lane = t % 32, seg = t - lane + (lane - lane % width);
  return emu_xchg(v, seg + (src % width));
}
template <typename T>
T __shfl_up_sync(unsigned, T v, unsigned d, int width = 32) {
  const int t = threadIdx.x, lw = t % 32 % width;
  return emu_xchg(v, lw < int(d) ? t : t - int(d));
}
template <typename T>
T __shfl_down_sync(unsigned, T v, unsigned d, int width = 32) {
  const int t = threadIdx.x, lw = t % 32 % width;
  return emu_xchg(v, lw + int(d) >= width ? t : t + int(d));
}
template <typename T>
T __shfl_xor_sync(unsigned, T v, int o) {
  return emu_xchg(v, int(threadIdx.x) ^ o);
}
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline int __ffs(int x) { return __builtin_ffs(x); }
inline unsigned __ballot_sync(unsigned, int p) {
  const int t = threadIdx.x, w0 = t - t % 32;
  std::memcpy(emu_xch + t * 8, &p, sizeof p);
  emu_bar->arrive_and_wait();
  unsigned r = 0;
  for (int i = 0; i < 32; ++i) {
    int q;
    std::memcpy(&q, emu_xch + (w0 + i) * 8, sizeof q);
    r |= unsigned(q != 0) << i;
  }
  emu_bar->arrive_and_wait();
  return r;
}
