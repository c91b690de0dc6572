// Runs eigh_team_kernel of the translation unit it is appended to
// (tools/eigen_emu.py, cut from csrc/eigh_jacobi.cu) on the CPU, one block
// at a time, one std::thread per CUDA thread:
//   emu_eigh <f32|f64> n B sweeps dir
// reads dir/a.bin ([B, n, n]) and writes dir/w.out ([B, n]) and dir/v.out.
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
template <typename T, int N>
void run(int n, int B, int sw, const std::string& d) {
  using C = Cfg<T, N>;
  auto a = rd<T>(d + "/a.bin");
  std::vector<T> w(size_t(B) * n, T(-999)), v(size_t(B) * n * n, T(-999));
  std::vector<unsigned char> sm(C::SIZE * sizeof(T) + 16);
  for (int bx = 0; bx < (B + C::NPB - 1) / C::NPB; ++bx) {
    std::barrier<> bar(kThreads);
    emu_bar = &bar;
    emu_smem = sm.data();
    std::fill(sm.begin(), sm.end(), 0xff);  // stale data: NaN in every tile
    std::vector<std::thread> th;
    for (int t = 0; t < kThreads; ++t)
      th.emplace_back([&, t] {
        threadIdx = dim3(t);
        blockIdx = dim3(bx);
        eigh_team_kernel<T, N>(a.data(), w.data(), v.data(), n, B, sw);
      });
    for (auto& x : th) x.join();
  }
  wr(d + "/w.out", w);
  wr(d + "/v.out", v);
}
template <typename T>
void dispatch(int n, int B, int sw, const std::string& d) {
  switch (players(n)) {
    case 4: return run<T, 4>(n, B, sw, d);
    case 6: return run<T, 6>(n, B, sw, d);
    case 8: return run<T, 8>(n, B, sw, d);
    case 10: return run<T, 10>(n, B, sw, d);
    case 12: return run<T, 12>(n, B, sw, d);
    case 14: return run<T, 14>(n, B, sw, d);
    default: return run<T, 16>(n, B, sw, d);
  }
}
int main(int argc, char** argv) {
  const bool f32 = std::string(argv[1]) == "f32";
  const int n = atoi(argv[2]), B = atoi(argv[3]), sw = atoi(argv[4]);
  if (f32) dispatch<float>(n, B, sw, argv[5]);
  else dispatch<double>(n, B, sw, argv[5]);
}
