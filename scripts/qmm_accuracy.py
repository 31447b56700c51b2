"""How close kernel B5 (``qmm``) comes to the exact product, on one NVIDIA
card, beside its plain version: for each shape, y from the SIMT core, the
tensor-core core and ``qmm_plain`` (f32 dequant, f32 matmul) against the
f64 product of the same bf16 x and integer codes, and the share of
``qmm_qout``'s 8-bit pair codes (bf16 y, the same rand plane) that each core
changes against the plain version's and against the exact pair (the f64
product's) — the quantities ``chip_smoke.py`` and the GPU tests bound at
1e-4. The script forces a core by moving
``qmm.TC_THRESHOLD`` for one call; ``qmm.plan`` chooses as always.

  PYTHONPATH=src python scripts/qmm_accuracy.py [--seed 11]
"""
from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

SHAPES = [(2048, 2048, 256), (2048, 2048, 2048), (2048, 2048, 16384), (2048, 16384, 2048),
          (128, 2048, 16384)]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=11)
    args = ap.parse_args()
    import torch
    from repro_torch.kernels import qmm as Q
    from repro_torch.kernels.ref import ds_row_pair_ref
    from repro_torch.quant import QScheme, encode

    if not torch.cuda.is_available():
        sys.exit("qmm_accuracy: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0], flush=True)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    threshold = Q.TC_THRESHOLD
    try:
        for m, k, n in SHAPES:
            for bits in (8, 4):
                packed = bits == 4
                w = torch.randn(k, n, generator=gen, device=dev) * k ** -0.5
                qt = encode(w, QScheme.int_symmetric(bits, scaling="channel",
                                                     rounding="nearest", packed=packed))
                x = torch.randn(m, k, generator=gen, device=dev).to(torch.bfloat16)
                rand = torch.randint(-2 ** 31, 2 ** 31, (m, n), generator=gen, device=dev,
                                     dtype=torch.int32)
                codes = torch.round(qt.decode().double() / qt.scale.double().reshape(1, -1))
                exact = (x.double() @ codes) * qt.scale.double().reshape(1, -1)
                ys = {"plain": Q.qmm_plain(x, qt.codes, qt.scale, packed=packed)}
                for core, edge in (("simt", 1 << 30), ("tc", 0)):
                    Q.TC_THRESHOLD = edge
                    ys[core] = Q.qmm(x, qt.codes, qt.scale, packed=packed)
                Q.TC_THRESHOLD = threshold
                p1, p2, _ = ds_row_pair_ref(ys["plain"].to(torch.bfloat16), rand, qmax=127)
                e1, e2, _ = ds_row_pair_ref(exact.to(torch.bfloat16), rand, qmax=127)
                parts = []
                for name, y in ys.items():
                    err = (y.double() - exact).abs()
                    c1, c2, _ = ds_row_pair_ref(y.to(torch.bfloat16), rand, qmax=127)
                    share, share_exact = (
                        float(((c1 != a).sum() + (c2 != b).sum()).double() / (2 * c1.numel()))
                        for a, b in ((p1, p2), (e1, e2)))
                    parts.append(f"{name} |y - exact| mean {float(err.mean()):.2e} max "
                                 f"{float(err.max()):.2e}, pair codes off plain {share:.2e}, "
                                 f"off exact {share_exact:.2e}")
                print(f"int{bits} M{m} K{k} N{n}: " + "; ".join(parts), flush=True)
    finally:
        Q.TC_THRESHOLD = threshold


if __name__ == "__main__":
    main()
