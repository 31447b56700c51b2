"""Kernel B6 (``qmm_t``) on both of its cores, on one NVIDIA card: each shape
through the streaming core and through the tensor-core core, checked against
``qmm_t_plain`` (rel 1e-5 of the largest output) and timed beside the bf16
``torch.matmul`` of the same shape. These are the measurements behind
``qmm_t.TC_THRESHOLD``: M ∈ {1, 2, 4, 6, 8, 12, 16, 24, 32} by default over
the (K, N) that the paths give ``qmm_t`` (the training backward's q/o, k/v,
gate/up and down; the tied unembed's 256000 × 2048 table), int8 and int4,
f32 g (training) and bf16 g (the unembed). The script forces a core by
moving the module's threshold (to 0 or past every M) for the duration of
one timing; ``qmm_t.plan`` chooses as always.

  PYTHONPATH=src python scripts/qmm_t_core_sweep.py [--ms 1,4,8,16] [--kn unembed,q/o]
      [--bits 8,4] [--cores stream,tc] [--out FILE]

Prints one line per (shape, bits) and, last, a JSON object with every
time; ``--out`` also writes it to a file. Times are medians of CUDA-event timings over 20
launches, the 50 MB L2 flushed before each.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

KN = {"q/o": (2048, 2048), "k/v": (2048, 256), "gate/up": (2048, 16384),
      "down": (16384, 2048), "unembed": (256000, 2048)}
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
    ap.add_argument("--ms", default="1,2,4,6,8,12,16,24,32")
    ap.add_argument("--kn", default=",".join(KN))
    ap.add_argument("--bits", default="8,4")
    ap.add_argument("--cores", default="stream,tc")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
    import torch
    from repro_torch.kernels import qmm_t as QT
    from repro_torch.quant import QScheme, encode

    if not torch.cuda.is_available():
        sys.exit("qmm_t_core_sweep: no CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=dev)
    gen = torch.Generator(device=dev).manual_seed(5)
    ms = [int(v) for v in args.ms.split(",")]
    threshold = QT.TC_THRESHOLD
    rows = []
    try:
        for bits in (int(b) for b in args.bits.split(",")):
            packed = bits == 4
            for what in args.kn.split(","):
                k, n = KN[what]
                gdtype = torch.bfloat16 if what == "unembed" else torch.float32
                w = torch.randn(k, n, generator=gen, device=dev) * n ** -0.5
                qt = encode(w, QScheme.int_symmetric(bits, scaling="channel",
                                                     rounding="nearest", packed=packed))
                del w
                w_bf16 = qt.decode(torch.bfloat16)
                for m in ms:
                    g = torch.randn(m, n, generator=gen, device=dev).to(gdtype)
                    want = QT.qmm_t_plain(g, qt.codes, qt.scale, packed=packed)
                    row = {"bits": bits, "what": what, "m": m, "k": k, "n": n,
                           "g": str(gdtype).split(".")[-1], "planned": QT.plan(m, k, n).core}
                    for core, edge in (("stream", 1 << 30), ("tc", 0)):
                        if core not in args.cores.split(","):
                            continue
                        QT.TC_THRESHOLD = edge
                        got = QT.qmm_t(g, qt.codes, qt.scale, packed=packed)
                        err = float((got - want).abs().max())
                        if not err <= TOL * float(want.abs().max()):
                            raise AssertionError(f"{core} int{bits} {m}x{k}x{n}: err {err}")
                        row[f"{core}_ms"] = timed(
                            lambda: QT.qmm_t(g, qt.codes, qt.scale, packed=packed), flush)
                        row[f"{core}_err"] = err
                    QT.TC_THRESHOLD = threshold
                    gb = g.to(torch.bfloat16)
                    row["matmul_ms"] = timed(lambda: torch.matmul(gb, w_bf16.T), flush)
                    row["bound_ms"] = max((g.numel() * g.element_size() + qt.codes.numel()
                                           + 4 * n + 4 * m * k) / 3.35e12,
                                          2 * m * k * n / 989e12) * 1e3
                    rows.append(row)
                    cores = ", ".join(f"{c} {row[c + '_ms']:.4f} ms" for c in ("stream", "tc")
                                      if c + "_ms" in row)
                    print(f"int{bits} {what} M{m} K{k} N{n} g {row['g']}: {cores}, bf16 "
                          f"matmul {row['matmul_ms']:.4f} ms, bound {row['bound_ms']:.5f} ms; "
                          f"plan takes {row['planned']}", flush=True)
                    del g, want
                del qt, w_bf16
                torch.cuda.empty_cache()
    finally:
        QT.TC_THRESHOLD = threshold
    out = {"card": card, "threshold": threshold, "rows": rows}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    print(json.dumps(out))


if __name__ == "__main__":
    main()
