"""Kernel B10 (``paged_decode_attn``) at several pages per split, on one
NVIDIA card. The split is a constant of ``csrc/paged_attn.cu``
(``kPagesPerSplit``); for each value asked for, the script builds a copy of
the source with that constant (the flags of ``kernels/_build.py``, into
``build/paged_attn_sweep/``), loads it in place of the shipped library,
checks every case against ``paged_decode_attn_plain`` (abs 1e-4, as
``chip_smoke.py``) and times it. Cases: the serving decode step (B 4, H 8,
Hkv 1, D 256, page 16, lengths 160/97/33/1), the verify window of that
step (B 16: four positions a slot), gemma-7b's (16, 16, 256) and
granite-3-8b's (32, 8, 128) head layouts at the serving lengths, and long
rows (4096/1500/257/0), each at kv 8, 4 and bf16; and, as the timing's
floor, one trivial launch (a 4-element fill) timed the same way.

  PYTHONPATH=src python scripts/paged_attn_split_sweep.py [--pps 1,2,4] [--out FILE]

Prints one line per (split, case) and, last, a JSON object with every
time. Times are medians of CUDA-event timings over 20 launches, the 50 MB
L2 flushed before each; versions alternate within each case (1, 2, 4,
4, 2, 1 by default) and each time is the median of both turns.
"""
from __future__ import annotations

import argparse
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-4
SERVE_LENS = [160, 97, 33, 1]
CASES = {  # name → (H, Hkv, D, lengths)
    "decode": (8, 1, 256, SERVE_LENS),
    "verify window": (8, 1, 256, [n + j for n in SERVE_LENS for j in range(4)]),
    "gemma-7b MHA": (16, 16, 256, SERVE_LENS),
    "granite GQA": (32, 8, 128, SERVE_LENS),
    "long": (8, 1, 256, [4096, 1500, 257, 0]),
}
PAGE = 16


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


def build(pps: int):
    """A library of ``csrc/paged_attn.cu`` with ``kPagesPerSplit = pps``."""
    import ctypes

    from repro_torch.kernels import _build

    src = (_build.CSRC / "paged_attn.cu").read_text()
    src, n = re.subn(r"constexpr int kPagesPerSplit = \d+;",
                     f"constexpr int kPagesPerSplit = {pps};", src)
    if n != 1:
        raise RuntimeError("kPagesPerSplit not found in csrc/paged_attn.cu")
    out = _build.build_dir().parent / "paged_attn_sweep"
    out.mkdir(parents=True, exist_ok=True)
    cu, so = out / f"paged_attn_pps{pps}.cu", out / f"paged_attn_pps{pps}.so"
    cu.write_text(src)
    subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", str(so),
                    str(cu)], check=True, capture_output=True, text=True)
    return ctypes.CDLL(str(so))


def inputs(dev, bits, h, hkv, d, lens, seed):
    import torch
    from repro_torch.serve import pages as pg

    gen = torch.Generator(device=dev).manual_seed(seed)
    b = len(lens)
    maxp = -(-max(lens) // PAGE) + 1
    n_pages = b * maxp + 1
    q = torch.randn(b, h, d, generator=gen, device=dev).to(torch.bfloat16)
    bt = (torch.randperm(n_pages - 1, generator=gen, device=dev)[: b * maxp] + 1)
    bt = bt.reshape(b, maxp).to(torch.int32)
    kv = torch.randn(2, n_pages, PAGE, hkv, d, generator=gen, device=dev)
    kc, ks = pg.quant_rows(kv[0], bits)
    vc, vs = pg.quant_rows(kv[1], bits)
    return q, kc, vc, ks, vs, bt, torch.tensor(lens, dtype=torch.int32, device=dev)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--pps", default="1,2,4")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    if not torch.cuda.is_available():
        sys.exit("paged_attn_split_sweep: no CUDA device")
    from repro_torch.kernels import paged_attn as PA

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    ppss = [int(x) for x in args.pps.split(",")]
    libs = {p: PA.typed(build(p)) for p in ppss}
    for p, lib in libs.items():
        if lib.pages_per_split != p:
            raise RuntimeError(f"built {p} pages per split, library says {lib.pages_per_split}")
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=dev)
    a = torch.randn(8192, 8192, device=dev, dtype=torch.bfloat16)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < 5.0:      # a cold card reads its first rows slow
        a @ a
        torch.cuda.synchronize()
    del a
    # the harness's floor: one trivial launch (a 4-element fill) timed the same way
    tiny = torch.empty(4, device=dev)
    floor_ms = timed(lambda: tiny.fill_(1.0), flush)
    print(f"launch floor (4-element fill, same timing): {floor_ms:.4f} ms", flush=True)
    results = []
    for ci, (case, (h, hkv, d, lens)) in enumerate(CASES.items()):
        for bits in (8, 4, 0):
            ops = inputs(dev, bits, h, hkv, d, lens, seed=ci)
            kw = dict(softmax_scale=d ** -0.5, kv_bits=bits)
            want = PA.paged_decode_attn_plain(*ops, **kw)
            times = {p: [] for p in ppss}
            for p in [*ppss, *reversed(ppss)]:
                PA._lib = lambda lib=libs[p]: lib
                got = PA.paged_decode_attn(*ops, **kw)
                err = float((got - want).abs().max())
                if not err <= TOL:
                    raise AssertionError(f"{case} kv{bits} pps {p}: max err {err} > {TOL}")
                times[p].append(timed(lambda: PA.paged_decode_attn(*ops, **kw), flush))
            for p in ppss:
                ms = statistics.median(times[p])
                results.append({"case": case, "H": h, "Hkv": hkv, "D": d, "lens": lens,
                                "kv_bits": bits, "pages_per_split": p, "ms": ms,
                                "turns_ms": times[p]})
                print(f"{case:14s} kv{bits} H{h} Hkv{hkv} D{d} pages/split {p}: "
                      f"{ms:.4f} ms (turns {times[p]})", flush=True)
    report = {"card": card, "launch_floor_ms": floor_ms, "results": results}
    if args.out:
        Path(args.out).write_text(json.dumps(report, indent=1))
    print(json.dumps(report))


if __name__ == "__main__":
    main()
