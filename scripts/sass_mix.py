"""The instruction mix of each kernel of one checkout's CUDA sources: builds
``src/repro_torch/kernels/csrc/<name>.cu`` with ``nvcc`` (the flags of
``scripts/compare_sass.py``, as a cubin) into ``build/sass/`` of the current
directory, writes its SASS there (``<name>.sass``, ``cuobjdump -sass``) and
prints, per kernel, the number of SASS instructions and the count of each
opcode (its base mnemonic: ``IADD3.X`` counts as ``IADD3``). A count is of
the instructions in the code, not of those executed: read a loop's body in
the ``.sass`` file. Needs the CUDA toolkit (no card):

  python scripts/sass_mix.py ROOT threefry quant_adamw [--top 12]
"""
from __future__ import annotations

import argparse
import collections
import re
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
from compare_sass import CUDA, FLAGS  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("root")
    ap.add_argument("names", nargs="+")
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args()
    work = Path("build/sass")
    work.mkdir(parents=True, exist_ok=True)
    csrc = Path(args.root).resolve() / "src/repro_torch/kernels/csrc"
    for name in args.names:
        cubin = (work / f"{name}.cubin").resolve()
        subprocess.run([f"{CUDA}/bin/nvcc", *FLAGS, "-o", str(cubin), f"{name}.cu"],
                       cwd=csrc, check=True)
        sass = subprocess.run([f"{CUDA}/bin/cuobjdump", "-sass", str(cubin)],
                              capture_output=True, text=True, check=True).stdout
        (work / f"{name}.sass").write_text(sass)
        mix, kernel = {}, None
        for line in sass.splitlines():
            m = re.match(r"\s*Function : (\S+)", line)
            if m:
                kernel = m.group(1)
                mix[kernel] = collections.Counter()
                continue
            m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", line)
            if kernel and m:
                mix[kernel][m.group(2)] += 1
        for kernel, ops in mix.items():
            top = ", ".join(f"{op} {n}" for op, n in ops.most_common(args.top))
            print(f"{name} {kernel}: {sum(ops.values())} instructions; {top}", flush=True)


if __name__ == "__main__":
    main()
