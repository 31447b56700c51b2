"""Kernel B5 (``qmm``) on both of its cores, on one NVIDIA card: each shape
through the SIMT core and through the tensor-core core, checked against
``qmm_plain`` (rel 1e-5 of the largest output) and timed beside the bf16
``torch.matmul`` of the same shape. These are the measurements behind
``qmm.TC_THRESHOLD``: at M ∈ {4, 8, 16, 32, 64, 112} for gemma-2b's (K, N)
of q/o, k/v, gate/up and down, int8 and int4, bf16 x. The script forces a
core by moving the module's threshold (to 0 or past every M) for the
duration of one timing; ``qmm.plan`` chooses as always.

  PYTHONPATH=src python scripts/qmm_core_sweep.py [--ms 4,8,16,32,64,112] [--out FILE]

Prints one line per (shape, bits) and, last, a JSON object with every
time; ``--out`` also writes it to a file. Times are medians of CUDA-event
timings over 20 launches, the 50 MB L2 flushed before each.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

KN = {"q/o": (2048, 2048), "k/v": (2048, 256), "gate/up": (2048, 16384),
      "down": (16384, 2048)}
TOL = 1e-5


def timed(fn, flush, iters=20):
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    ev = []
    for _ in range(iters):
        flush.zero_()
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        ev.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in ev)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--ms", default="4,8,16,32,64,112")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import torch
    from repro_torch.kernels import qmm as Q
    from repro_torch.quant import QScheme, encode

    if not torch.cuda.is_available():
        sys.exit("qmm_core_sweep: no CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=dev)
    gen = torch.Generator(device=dev).manual_seed(5)
    ms = [int(v) for v in args.ms.split(",")]
    threshold = Q.TC_THRESHOLD
    rows = []
    try:
        for bits in (8, 4):
            packed = bits == 4
            for what, (k, n) in KN.items():
                w = torch.randn(k, n, generator=gen, device=dev) * k ** -0.5
                qt = encode(w, QScheme.int_symmetric(bits, scaling="channel",
                                                     rounding="nearest", packed=packed))
                w_bf16 = qt.decode().to(torch.bfloat16)
                for m in ms:
                    x = torch.randn(m, k, generator=gen, device=dev).to(torch.bfloat16)
                    want = Q.qmm_plain(x, qt.codes, qt.scale, packed=packed)
                    row = {"bits": bits, "what": what, "m": m, "k": k, "n": n,
                           "planned": Q.plan(m, k, n, x.dtype).core}
                    for core, edge in (("simt", 1 << 30), ("tc", 0)):
                        Q.TC_THRESHOLD = edge
                        got = Q.qmm(x, qt.codes, qt.scale, packed=packed)
                        err = float((got - want).abs().max())
                        if not err <= TOL * float(want.abs().max()):
                            raise AssertionError(f"{core} int{bits} {m}x{k}x{n}: err {err}")
                        row[f"{core}_ms"] = timed(
                            lambda: Q.qmm(x, qt.codes, qt.scale, packed=packed), flush)
                        row[f"{core}_err"] = err
                    Q.TC_THRESHOLD = threshold
                    row["matmul_ms"] = timed(lambda: torch.matmul(x, w_bf16), flush)
                    row["bound_ms"] = max((x.numel() * 2 + qt.codes.numel() + 4 * n
                                           + 4 * m * n) / 3.35e12,
                                          2 * m * k * n / 989e12) * 1e3
                    rows.append(row)
                    print(f"int{bits} {what} M{m} K{k} N{n}: simt {row['simt_ms']:.4f} ms, "
                          f"tc {row['tc_ms']:.4f} ms, bf16 matmul {row['matmul_ms']:.4f} ms, "
                          f"bound {row['bound_ms']:.5f} ms; plan takes {row['planned']}",
                          flush=True)
    finally:
        Q.TC_THRESHOLD = threshold
    out = {"card": card, "threshold": threshold, "rows": rows}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    print(json.dumps(out))


if __name__ == "__main__":
    main()
