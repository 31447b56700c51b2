"""Pass 2 of ``quant_adamw`` (kernel B9, ``qadamw_update``) for one checkout,
timed in a fresh process on one NVIDIA card at every leaf shape of the
training path (``chip_smoke.ADAMW_SHAPES``), on three kinds of data:

* ``smoke``: ``chip_smoke.check_quant_adamw``'s (random masters, gradients,
  codes and scales);
* ``zeros``: g 0, codes 0, scales 1 — a leaf no gradient reached, where
  every division's dividend is 0;
* ``half``: the smoke's data with every other element's g and codes 0.

Each line gives the rand entry and, where the checkout has one, the keyed
entry: with the body the wrapper picks and, where the checkout has that
choice, with one element a thread (``quant_adamw._vec_ok`` forced false),
both timed with CUDA events, the L2 flushed before each launch, in the same
process. To compare a change with its parent on one card, unpack both
checkouts and run them interleaved in one call (parent, change, change,
parent):

  python scripts/qadamw_pass2_timing.py ROOT [--data smoke,zeros,half]
      [--shapes R:C,...] [--iters N]

ROOT is the checkout whose ``chip_smoke.py`` and ``src/`` are imported.
"""
from __future__ import annotations

import argparse
import inspect
import sys


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("root")
    ap.add_argument("--data", default="smoke,zeros,half")
    ap.add_argument("--shapes", default="", help="R:C,... (default ADAMW_SHAPES)")
    ap.add_argument("--iters", type=int, default=10, help="timed launches (median)")
    args = ap.parse_args()
    sys.path[:0] = [args.root, args.root + "/src"]
    import torch

    if not torch.cuda.is_available():
        sys.exit("qadamw_pass2_timing: no CUDA device")
    import chip_smoke
    from repro_torch import prng
    from repro_torch.kernels import ops
    from repro_torch.kernels import quant_adamw as QA

    dev = torch.device("cuda", 0)
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=dev)
    kw = chip_smoke.ADAMW_KW
    ukw = {k: kw[k] for k in ("b1", "b2", "eps", "wd", "qmax", "uclip")}
    params = torch.tensor([kw["clip"], kw["finite"], kw["lr"], kw["b1c"], kw["b2c"], 0, 0, 0],
                          dtype=torch.float32, device=dev)
    keyed = "key" in inspect.signature(QA.qadamw_update).parameters
    has_vec = hasattr(QA, "_vec_ok")
    shapes = ([tuple(int(v) for v in s.split(":")) for s in args.shapes.split(",")]
              if args.shapes else chip_smoke.ADAMW_SHAPES)
    gen = torch.Generator(device=dev).manual_seed(6)
    for r, c in shapes:
        for data in args.data.split(","):
            master = torch.randn(r, c, generator=gen, device=dev)
            g = torch.randn(r, c, generator=gen, device=dev) * 0.1
            mc = torch.randint(-127, 128, (r, c), generator=gen, device=dev, dtype=torch.int8)
            vc = torch.randint(0, 128, (r, c), generator=gen, device=dev, dtype=torch.int8)
            ms = torch.rand(c, generator=gen, device=dev) * 0.01 + 1e-4
            vs = torch.rand(c, generator=gen, device=dev) * 0.01 + 1e-4
            rand = torch.randint(-2 ** 31, 2 ** 31, (r, c), generator=gen, device=dev,
                                 dtype=torch.int32)
            if data == "zeros":
                for t in (g, mc, vc):
                    t.zero_()
                ms.fill_(1.0)
                vs.fill_(1.0)
            elif data == "half":
                for t in (g, mc, vc):
                    t.view(-1)[::2] = 0
            elif data != "smoke":
                sys.exit(f"qadamw_pass2_timing: unknown data {data!r}")
            _, _, msn, _, vsn = ops.quant_adamw_update(master, g, mc, ms, vc, vs, rand, **kw)
            upd = (master, g, mc, ms, vc, vs, msn, vsn)
            key = prng.PRNGKey(r + c)
            entries = [("rand", lambda: QA.qadamw_update(*upd, rand, params, **ukw))]
            if keyed:
                entries.append(("keyed", lambda: QA.qadamw_update(*upd, None, params,
                                                                   key=key, **ukw)))
            parts = []
            for name, fn in entries:
                ms_pick = chip_smoke._timed(fn, flush, iters=args.iters)
                part = f"{name} {ms_pick:.4f}"
                if has_vec:
                    pick = QA._vec_ok
                    QA._vec_ok = lambda *a: False
                    try:
                        ms_one = chip_smoke._timed(fn, flush, iters=args.iters)
                    finally:
                        QA._vec_ok = pick
                    part += f" (one a thread {ms_one:.4f})"
                parts.append(part)
            print(f"{args.root} {data} R{r} C{c}: ms " + ", ".join(parts), flush=True)
            del master, g, mc, vc, rand, upd
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
