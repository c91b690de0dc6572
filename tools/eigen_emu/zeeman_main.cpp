// Runs zeeman_mp_kernel of the translation unit it is appended to
// (tools/eigen_emu.py, cut from csrc/zeeman_mp.cu) on the CPU, one block
// at a time, one std::thread per CUDA thread:
//   emu_zeeman <f32|f64> Z F NP dir
// reads dir/f.bin ([F]) and dir/rec.bin ([Z, NP, W]) and writes
// dir/out.bin ([Z, 7, F]): the kSplit parts' slabs added in order, as
// combine_kernel adds them.
#include <algorithm>
#include <cstdio>
#include <cstdlib>
#include <string>
#include <thread>
#include <vector>
template <typename T>
std::vector<T> rd(const std::string& p) {
  FILE* f = fopen(p.c_str(), "rb");
  fseek(f, 0, SEEK_END);
  long n = ftell(f) / sizeof(T);
  fseek(f, 0, SEEK_SET);
  std::vector<T> v(n);
  if (fread(v.data(), sizeof(T), n, f) != size_t(n)) abort();
  fclose(f);
  return v;
}
template <typename T>
void wr(const std::string& p, const std::vector<T>& v) {
  FILE* f = fopen(p.c_str(), "wb");
  fwrite(v.data(), sizeof(T), v.size(), f);
  fclose(f);
}
template <typename T>
void run(int Z, int F, int NP, const std::string& d) {
  constexpr int S = kSplit;
  constexpr int P = 5;
  auto f = rd<T>(d + "/f.bin");
  auto rec = rd<T>(d + "/rec.bin");
  const long n = long(Z) * kComp * F;
  std::vector<T> part(size_t(S) * n, T(-999));
  std::vector<unsigned char> sm(smem_bytes<T, P>());
  const int tile = kThreads * kFPT;
  gridDim = dim3((F + tile - 1) / tile, Z, S);
  for (unsigned s = 0; s < gridDim.z; ++s)
    for (unsigned z = 0; z < gridDim.y; ++z)
      for (unsigned x = 0; x < gridDim.x; ++x) {
        std::barrier<> bar(kThreads);
        emu_bar = &bar;
        emu_smem = sm.data();
        std::fill(sm.begin(), sm.end(), 0xff);  // stale data: NaN everywhere
        std::vector<std::thread> th;
        for (int t = 0; t < kThreads; ++t)
          th.emplace_back([&, t] {
            threadIdx = dim3(t);
            blockIdx = dim3(x, z, s);
            zeeman_mp_kernel<T, P>(f.data(), rec.data(), part.data(), F, NP);
          });
        for (auto& y : th) y.join();
      }
  std::vector<T> out(part.begin(), part.begin() + n);
  for (int s = 1; s < S; ++s)
    for (long i = 0; i < n; ++i) out[i] += part[s * n + i];
  wr(d + "/out.bin", out);
}
int main(int argc, char** argv) {
  const int Z = atoi(argv[2]), F = atoi(argv[3]), NP = atoi(argv[4]);
  if (std::string(argv[1]) == "f32") run<float>(Z, F, NP, argv[5]);
  else run<double>(Z, F, NP, argv[5]);
}
