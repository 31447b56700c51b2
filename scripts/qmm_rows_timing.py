"""Kernel B5's (``qmm``) rows of ``chip_smoke.py`` for one checkout, timed in
a fresh process on one NVIDIA card: ``chip_smoke.check_qmm`` run as is, its
decode (M 4), prefill (M 112) and training (M 2048) lines printed; with
``--kernel qmm_t``, kernel B6's rows instead (``check_qmm_t`` and
``check_qmm_t_unembed``: every line), with ``--kernel qmv`` or ``--kernel
ssd`` kernel B3's (``check_qmv``) or B12's (``check_ssd``), every line;
with ``--kernel threefry``, ``ds_quant`` or ``quant_adamw`` the plane
kernel's (``check_threefry``), B1's or B8/B9's rows (the keyed entries
beside the rand ones, pass 1's path entry beside its parity entry), with
``--kernel row_absmax`` B2's, every line.
With ``--warm`` the card first
multiplies bf16 matrices for that many seconds. To compare a change with
its parent on one card, unpack both checkouts and run them interleaved in
one call (parent, change, change, parent):

  python scripts/qmm_rows_timing.py ROOT [--warm SECONDS]
      [--kernel qmm|qmm_t|qmv|ssd|threefry|ds_quant|quant_adamw|row_absmax]

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
    ap.add_argument("--kernel", choices=("qmm", "qmm_t", "qmv", "ssd", "threefry", "ds_quant",
                                         "quant_adamw", "row_absmax"), default="qmm")
    args = ap.parse_args()
    sys.path[:0] = [args.root, args.root + "/src"]
    import torch

    if not torch.cuda.is_available():
        sys.exit("qmm_rows_timing: no CUDA device")
    import chip_smoke
    from repro_torch.kernels import _build

    _build.load({"row_absmax": "stoch_quant"}.get(args.kernel, args.kernel))
    if hasattr(chip_smoke, "_int32_rate"):      # the int32 bound of the hashing rows
        chip_smoke.INT32_OPS = chip_smoke._int32_rate()
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
        elif args.kernel == "qmm_t":
            chip_smoke.check_qmm_t(dev, flush)
            chip_smoke.check_qmm_t_unembed(dev, flush)
        else:
            getattr(chip_smoke, f"check_{args.kernel}")(dev, flush)
    for line in out.getvalue().splitlines():
        if args.kernel != "qmm" or re.search(r"\(M,K,N\)=\((4|112|2048),", line):
            print(f"{args.root} warm={args.warm:g}: "
                  + re.sub(r"max_err.*?kernel_ms", "kernel_ms", line), flush=True)


if __name__ == "__main__":
    main()
