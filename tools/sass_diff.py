"""Compare the machine code of csrc/disort_fused.cu's kernels with another
checkout's, instance by instance.

    python3 tools/sass_diff.py --parent DIR [--beam-changes]

Compiles both sources to cubins with the package's nvcc flags (nvcc and
cuobjdump from CUDA_HOME, no card needed) and compares the SASS of each
kernel instance of the parent's, keyed by kernel, type and n: an instance
that gained a template flag (stage1_kernel<T, N> -> stage1_kernel<T, N,
false>) is compared under its parent's key.  Prints one line per instance
and the tree's instances the parent lacks; exits non-zero if any of the
parent's instances changed, but for the beam instances of stage 1
(stage1_kernel<T, N, true>) under --beam-changes, for a change to the beam
instance that must leave every other instance's machine code as it was.
"""

import argparse
import pathlib
import re
import subprocess
import sys
import tempfile

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from arts_tpu_torch import _cuda  # noqa: E402

KEY = re.compile(r"(stage1_kernel|fused_eigen_kernel|stage23_kernel)I([fd])Li(\d+)E(?:Lb([01])E)?")


def sass(src, out):
    """{(kernel, type, n, flag): SASS lines} of src compiled to the cubin out."""
    nvcc = _cuda._nvcc()
    flags = [f for f in _cuda.NVCC_FLAGS if f not in ("-Xptxas", "-v", "-Xcompiler", "-fPIC")]
    subprocess.run([nvcc, *flags, "-cubin", "-I", str(src.parent), str(src), "-o", str(out)],
                   check=True)
    text = subprocess.run([str(pathlib.Path(nvcc).with_name("cuobjdump")), "-sass", str(out)],
                          capture_output=True, text=True, check=True).stdout
    funcs, key = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            k = KEY.search(m.group(1))
            key = (k.group(1), k.group(2), int(k.group(3)), k.group(4)) if k else m.group(1)
            funcs[key] = []
        elif key is not None:
            # symbols in the code (calls to out-of-line helpers) carry the
            # kernel's mangled name and the anonymous namespace's hash
            funcs[key].append(re.sub(r"_Z\w+", "_Z", line.rstrip()))
    return funcs


def compare(parent, beam_changes=False):
    """Print the comparison with the checkout `parent`; True when every
    instance of the parent's has the same machine code here (with
    beam_changes, every one but stage 1's beam instances)."""
    name = "disort_fused.cu"
    with tempfile.TemporaryDirectory() as tmp:
        old = sass(parent / "arts_tpu_torch" / "csrc" / name, pathlib.Path(tmp) / "old.cubin")
        new = sass(_cuda.CSRC / name, pathlib.Path(tmp) / "new.cubin")
    changed = allowed = 0
    for key, lines in sorted(old.items(), key=str):
        mine = new.get(key)
        if mine is None and isinstance(key, tuple) and key[3] is None:
            mine = new.get(key[:3] + ("0",))
        same = mine == lines
        free = beam_changes and isinstance(key, tuple) and key[0] == "stage1_kernel" \
            and key[3] == "1"
        changed += not same and not free
        allowed += not same and free
        diff = "" if same or mine is None else (
            f", {sum(x != y for x, y in zip(lines, mine)) + abs(len(lines) - len(mine))} lines differ")
        state = "same machine code" if same else "changed (a beam instance)" if free else "CHANGED"
        print(f"  {key}: {state} ({len(lines)} lines{diff})", flush=True)
    seen = set(old) | {k[:3] + ("0",) for k in old if isinstance(k, tuple) and k[3] is None}
    for key in sorted(set(new) - seen, key=str):
        print(f"  {key}: new ({len(new[key])} lines)", flush=True)
    print(f"  {changed} of {len(old)} instances of the parent changed"
          + (f" outside stage 1's beam instances ({allowed} of those changed)"
             if beam_changes else ""), flush=True)
    return changed == 0


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=pathlib.Path, required=True)
    ap.add_argument("--beam-changes", action="store_true",
                    help="stage 1's beam instances may differ from the parent's")
    args = ap.parse_args()
    return 0 if compare(args.parent, args.beam_changes) else 1


if __name__ == "__main__":
    sys.exit(main())
