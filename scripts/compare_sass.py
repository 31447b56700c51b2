"""Whether two checkouts compile the same CUDA sources to the same machine
code: builds ``src/repro_torch/kernels/csrc/<name>.cu`` of each checkout
with ``nvcc`` (the flags of ``kernels/_build.py``, as a cubin) into
``build/sass/`` of the current directory and compares every kernel's SASS
(``cuobjdump -sass``), with the per-file hash in anonymous-namespace names
masked. For a change that moves shared device code between headers, it
shows that the kernels that include them did not change. Needs the CUDA
toolkit (no card):

  python scripts/compare_sass.py PARENT_ROOT CHANGE_ROOT qmm qmm_qout

Prints one line per source and exits 1 if any kernel differs.
"""
from __future__ import annotations

import argparse
import os
import re
import subprocess
import sys
from pathlib import Path

CUDA = os.environ.get("CUDA_HOME", "/usr/local/cuda")
FLAGS = ["-std=c++17", "-O3", "-cubin", "-gencode=arch=compute_90a,code=sm_90a"]


def kernels(cubin: Path) -> dict[str, list[str]]:
    """Kernel name → its SASS lines."""
    sass = subprocess.run([f"{CUDA}/bin/cuobjdump", "-sass", str(cubin)], capture_output=True,
                          text=True, check=True).stdout
    out, name = {}, None
    for line in sass.splitlines():
        line = re.sub(r"_GLOBAL__N__[0-9a-f]+_[0-9]+_\w+?_cu_[0-9a-f]{8}", "ANON", line).strip()
        m = re.match(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            out[name] = []
        elif name and line:
            out[name].append(line)
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("root_a")
    ap.add_argument("root_b")
    ap.add_argument("names", nargs="+")
    args = ap.parse_args()
    work = Path("build/sass")
    work.mkdir(parents=True, exist_ok=True)
    differ = False
    for name in args.names:
        sides = []
        for i, root in enumerate((args.root_a, args.root_b)):
            csrc = Path(root).resolve() / "src/repro_torch/kernels/csrc"
            cubin = (work / f"{name}-{i}.cubin").resolve()
            subprocess.run([f"{CUDA}/bin/nvcc", *FLAGS, "-o", str(cubin), f"{name}.cu"],
                           cwd=csrc, check=True)
            sides.append(kernels(cubin))
        a, b = sides
        changed = sorted(n for n in a.keys() | b.keys() if a.get(n) != b.get(n))
        differ |= bool(changed)
        print(f"{name}: {len(a)} / {len(b)} kernels, identical SASS: "
              f"{len(a.keys() & b.keys()) - len(set(changed) & a.keys() & b.keys())}; "
              f"differ: {changed}", flush=True)
    sys.exit(1 if differ else 0)


if __name__ == "__main__":
    main()
