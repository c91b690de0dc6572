// CPU stand-in for csrc/async.cuh in tools/eigen_emu.py: the copies happen
// at once; the 16-byte accessors copy K values.
#pragma once
#include <cstring>
namespace async {
template <int BYTES>
void cp_async(void* dst, const void* src) { std::memcpy(dst, src, BYTES); }
inline void cp_async_commit() {}
template <int N>
void cp_async_wait() {}
template <typename T, int K>
void ld16(const T* p, T (&v)[K]) { std::memcpy(v, p, sizeof v); }
template <typename T, int K>
void st16(T* p, const T (&v)[K]) { std::memcpy(p, v, sizeof v); }
}  // namespace async
