"""Float32 against float64 on identical inputs for the three Zeeman routes,
at the top levels of the benchmark's Zeeman inputs.

    python3 tools/zeeman_f32_gap.py [--device cpu] [--levels 5] [--threads 4]
                                    [--routes dense,kernel,profile] [--root DIR]

scene.build_zeeman_inputs (2048 .par lines -> 20,820 Zeeman components per
polarization, 4096 frequencies from 160 to 260 GHz, 60 levels, top first)
is built once in float64 and rounded to float32; the float64 run takes the
rounded values back in float64, so that both runs see the same grid,
catalog and atmosphere and differ only in their arithmetic.  Routes:

  * dense:   zeeman_propmat(backend="xla"), the per-polarization shape sums;
  * kernel:  zeeman_propmat(backend="pallas"), kernel 5's plain version on
             CPU tensors, the polarized Voigt kernel on the card;
  * profile: zeeman_propmat_profile, kernel 6 (the parent-pole expansion)
             and the near correction, plain on CPU tensors.

For each route and each of the top `--levels` levels it prints the largest
|float32 - float64| over frequencies and the 7 components as a share of
that level's largest |float64| value, then one JSON line with all of them.
--root DIR takes arts_tpu_torch from DIR (a checkout of another commit,
e.g. unpacked with git archive) in place of this one's.  On the CPU the
dense route at float64 takes ~20 minutes on 4 threads.
"""

import argparse
import json
import os
import sys
import time


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--levels", type=int, default=5)
    ap.add_argument("--threads", type=int, default=4)
    ap.add_argument("--routes", default="dense,kernel,profile")
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    a = ap.parse_args()
    sys.path.insert(0, os.path.abspath(a.root))
    import torch

    from arts_tpu_torch._cuda import move
    from arts_tpu_torch.lbl.zeeman import zeeman_propmat, zeeman_propmat_profile
    from arts_tpu_torch.scene import build_zeeman_inputs

    torch.set_num_threads(a.threads)
    dev = torch.device(a.device)
    base = build_zeeman_inputs(device="cpu", dtype=torch.float64)
    tune = base.pop("tune")
    los = base.pop("los_za_deg")
    top = slice(0, a.levels)
    ins = {}
    for dt in (torch.float32, torch.float64):
        d = {k: move(move(v, dev, torch.float32), dev, dt) for k, v in base.items()}
        for k in ("T", "P", "vmr"):
            d[k] = d[k][top]
        ins[dt] = d

    def run(route, d, dt):
        kw = dict(device=dev, dtype=dt)
        if route == "profile":
            return zeeman_propmat_profile(d["f_grid"], d["pzcat"], d["pf"], d["T"], d["P"],
                                          d["vmr"], d["mag"], los, **tune, **kw)
        return zeeman_propmat(d["f_grid"], d["zcat"], d["pf"], d["T"], d["P"], d["vmr"],
                              d["mag"], los, backend="xla" if route == "dense" else "pallas",
                              **kw)

    print(f"arts_tpu_torch from {os.path.abspath(a.root)}; {a.device}; "
          f"{sum(int(i.numel()) for i in base['zcat'].idx)} components, "
          f"{base['f_grid'].numel()} frequencies, top {a.levels} levels", flush=True)
    out = {}
    for route in a.routes.split(","):
        t0 = time.perf_counter()
        pm = {dt: run(route, ins[dt], dt).double().cpu() for dt in (torch.float32, torch.float64)}
        scale = pm[torch.float64].abs().amax((-2, -1))
        gap = ((pm[torch.float32] - pm[torch.float64]).abs().amax((-2, -1)) / scale).tolist()
        out[route] = gap
        print(f"{route}: float32 vs float64 per level (share of the level's largest value) "
              f"{', '.join(f'{g:.3e}' for g in gap)}; {time.perf_counter() - t0:.1f} s",
              flush=True)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
