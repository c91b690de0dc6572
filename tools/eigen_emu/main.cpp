// Runs stage1_kernel (its beam instance with "beam") or fused_eigen_kernel
// of the translation unit it is appended to (tools/eigen_emu.py) on the
// CPU, one block at a time, one std::thread per CUDA thread:
//   emu <stage1|beam|eigen> <f32|f64> n L B sweeps dir [mu0]
// reads dir/{pp,pm,om,dtau,tb0,tb1,qtab}.bin (and qp, qm, ebt, ebb) and
// writes dir/*.out.
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
void run(bool s1, bool beam, int L, int B, int sw, double mu0, const std::string& d) {
  using C = E1<T, N>;
  auto pp = rd<T>(d + "/pp.bin"), pm = rd<T>(d + "/pm.bin"), om = rd<T>(d + "/om.bin"),
       dtau = rd<T>(d + "/dtau.bin"), qtab = rd<T>(d + "/qtab.bin");
  std::vector<T> tb0, tb1;
  if (s1) { tb0 = rd<T>(d + "/tb0.bin"); tb1 = rd<T>(d + "/tb1.bin"); }
  std::vector<T> qp, qm, ebt, ebb;
  if (beam) {
    qp = rd<T>(d + "/qp.bin"); qm = rd<T>(d + "/qm.bin");
    ebt = rd<T>(d + "/ebt.bin"); ebb = rd<T>(d + "/ebb.bin");
  }
  const size_t nv = size_t(L) * N * B, nm = size_t(L) * N * N * B;
  std::vector<T> kk(nv, T(-999)), ek(nv, T(-999)), gp(nm, T(-999)), gm(nm, T(-999)), ut(nv, T(-999)),
      vt(nv, T(-999)), ub(nv, T(-999)), vb(nv, T(-999));
  std::vector<unsigned char> sm(C::SIZE * sizeof(T) + 16);
  const int gx = (B + C::NPB - 1) / C::NPB;
  for (int by = 0; by < L; ++by)
    for (int bx = 0; bx < gx; ++bx) {
      std::barrier<> bar(kThreads1);
      emu_bar = &bar;
      emu_smem = sm.data();
      std::vector<std::thread> th;
      for (int t = 0; t < kThreads1; ++t)
        th.emplace_back([&, t] {
          threadIdx = dim3(t);
          blockIdx = dim3(bx, by);
          if (beam)
            stage1_kernel<T, N, true>(pp.data(), pm.data(), om.data(), dtau.data(), tb0.data(),
                                      tb1.data(), qtab.data(), ek.data(), gp.data(), gm.data(),
                                      ut.data(), vt.data(), ub.data(), vb.data(), B, sw, qp.data(),
                                      qm.data(), ebt.data(), ebb.data(), T(mu0));
          else if (s1)
            stage1_kernel<T, N, false>(pp.data(), pm.data(), om.data(), dtau.data(), tb0.data(),
                                       tb1.data(), qtab.data(), ek.data(), gp.data(), gm.data(),
                                       ut.data(), vt.data(), ub.data(), vb.data(), B, sw, nullptr,
                                       nullptr, nullptr, nullptr, T(0));
          else
            fused_eigen_kernel<T, N>(pp.data(), pm.data(), om.data(), dtau.data(), qtab.data(),
                                     kk.data(), ek.data(), gp.data(), gm.data(), B, sw);
        });
      for (auto& x : th) x.join();
    }
  wr(d + "/k.out", kk); wr(d + "/ek.out", ek); wr(d + "/gp.out", gp); wr(d + "/gm.out", gm);
  wr(d + "/ut.out", ut); wr(d + "/vt.out", vt); wr(d + "/ub.out", ub); wr(d + "/vb.out", vb);
}
int main(int argc, char** argv) {
  const std::string mode = argv[1];
  const bool beam = mode == "beam", s1 = beam || mode == "stage1";
  const bool f32 = std::string(argv[2]) == "f32";
  const int n = atoi(argv[3]), L = atoi(argv[4]), B = atoi(argv[5]), sw = atoi(argv[6]);
  const std::string d = argv[7];
  const double mu0 = beam ? atof(argv[8]) : 0.0;
  if (f32) {
    if (n == 8) run<float, 8>(s1, beam, L, B, sw, mu0, d);
    else run<float, 4>(s1, beam, L, B, sw, mu0, d);
  } else {
    if (n == 8) run<double, 8>(s1, beam, L, B, sw, mu0, d);
    else run<double, 4>(s1, beam, L, B, sw, mu0, d);
  }
}
