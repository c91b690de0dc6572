// Asynchronous global -> shared copies and 16-byte vector accesses, shared
// by csrc/voigt_sum.cu (the staged line blocks) and csrc/disort_fused.cu
// (the staged layers of stages 2+3).
#pragma once

#include <cuda_runtime.h>

namespace async {

// asynchronous copy of BYTES (4, 8 or 16) global -> shared; 16-byte copies
// bypass L1 (they read data that is used once, or that the same kernel
// wrote)
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s), "l"(src),
                 "n"(BYTES)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// K values from / to a 16-byte aligned address, 16 bytes per access
template <typename T, int K>
__device__ __forceinline__ void ld16(const T* p, T (&v)[K]) {
  if constexpr (sizeof(T) == 4) {
    static_assert(K % 4 == 0, "float4 loads");
#pragma unroll
    for (int i = 0; i < K / 4; ++i) {
      const float4 q = reinterpret_cast<const float4*>(p)[i];
      v[4 * i] = q.x;
      v[4 * i + 1] = q.y;
      v[4 * i + 2] = q.z;
      v[4 * i + 3] = q.w;
    }
  } else {
    static_assert(K % 2 == 0, "double2 loads");
#pragma unroll
    for (int i = 0; i < K / 2; ++i) {
      const double2 q = reinterpret_cast<const double2*>(p)[i];
      v[2 * i] = q.x;
      v[2 * i + 1] = q.y;
    }
  }
}

template <typename T, int K>
__device__ __forceinline__ void st16(T* p, const T (&v)[K]) {
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int i = 0; i < K / 4; ++i)
      reinterpret_cast<float4*>(p)[i] =
          make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
  } else {
#pragma unroll
    for (int i = 0; i < K / 2; ++i)
      reinterpret_cast<double2*>(p)[i] = make_double2(v[2 * i], v[2 * i + 1]);
  }
}

}  // namespace async
