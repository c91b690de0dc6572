// CPU stand-in for csrc/async.cuh in tools/eigen_emu.py: the copies happen
// at once; the 16-byte accessors are not used by the eigen kernels.
#pragma once
#include <cstring>
namespace async {
template <int BYTES>
void cp_async(void* dst, const void* src) { std::memcpy(dst, src, BYTES); }
inline void cp_async_commit() {}
template <int N>
void cp_async_wait() {}
template <typename T, int K>
void ld16(const T*, T (&)[K]) {}
template <typename T, int K>
void st16(T*, const T (&)[K]) {}
}  // namespace async
