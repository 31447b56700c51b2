"""Kernel B5's (``qmm``) rows of ``chip_smoke.py`` for one checkout, timed in
a fresh process on one NVIDIA card: ``chip_smoke.check_qmm`` run as is, its
decode (M 4), prefill (M 112) and training (M 2048) lines printed; with
``--kernel qmm_t``, kernel B6's rows instead (``check_qmm_t`` and
``check_qmm_t_unembed``: every line). With ``--warm`` the card first
multiplies bf16 matrices for that many seconds. To compare a change with
its parent on one card, unpack both checkouts and run them interleaved in
one call (parent, change, change, parent):

  python scripts/qmm_rows_timing.py ROOT [--warm SECONDS] [--kernel qmm|qmm_t]

ROOT is the checkout whose ``chip_smoke.py`` and ``src/`` are imported.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import re
import sys
import time


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("root")
    ap.add_argument("--warm", type=float, default=0.0)
    ap.add_argument("--kernel", choices=("qmm", "qmm_t"), default="qmm")
    args = ap.parse_args()
    sys.path[:0] = [args.root, args.root + "/src"]
    import torch

    if not torch.cuda.is_available():
        sys.exit("qmm_rows_timing: no CUDA device")
    import chip_smoke
    from repro_torch.kernels import _build

    _build.load(args.kernel)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    if args.warm > 0:
        a = torch.randn(8192, 8192, device=dev, dtype=torch.bfloat16)
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < args.warm:
            a @ a
            torch.cuda.synchronize()
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=dev)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        if args.kernel == "qmm":
            chip_smoke.check_qmm(dev, flush)
        else:
            chip_smoke.check_qmm_t(dev, flush)
            chip_smoke.check_qmm_t_unembed(dev, flush)
    for line in out.getvalue().splitlines():
        if args.kernel == "qmm_t" or re.search(r"\(M,K,N\)=\((4|112|2048),", line):
            print(f"{args.root} warm={args.warm:g}: "
                  + re.sub(r"max_err.*?kernel_ms", "kernel_ms", line), flush=True)


if __name__ == "__main__":
    main()
