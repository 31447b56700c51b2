"""Two absmax kernels at their path shapes, timed on one NVIDIA card, so
that a change and its parent can be timed in turns in one call: kernel B8's
pass 1 at every leaf of full-width gemma-2b (the path entry
``quant_adamw.qadamw_scales``, held bit-equal to its plain version, and the
parity entry ``qadamw_absmax`` with the host's reduction to the scales after
it, the design before the path entry), and kernel B2 ``row_absmax`` at
gisette's (6000, 5000) and the linear path's (16, 5000), f32, held
bit-exact, beside ``torch.linalg.vector_norm(x, inf)``. A checkout without
the path entry gets the parity rows alone.

Each row gives three times in ms: ``write`` the median of ``--iters``
launches with the L2 cache flushed before each by writing 256 MB (what
``chip_smoke._timed`` does: the flush leaves dirty lines whose write-back
competes with the kernel's reads), ``read`` the same with the cache flushed
by reading 256 MB (clean lines), and ``device`` the summed duration
of every kernel of a call but the flush's, from ``torch.profiler`` over
``--iters`` calls after a read flush each.

  python scripts/absmax_timing.py ROOT [--iters 20]

ROOT is the checkout whose ``chip_smoke.py`` and ``src/`` are imported.
"""
from __future__ import annotations

import argparse
import statistics
import subprocess
import sys


def _device_keys(fn) -> set:
    """The device events' names of one call of ``fn`` under torch.profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.key for e in prof.key_averages() if e.device_type == DeviceType.CUDA}


def _event_ms(fn, flush, iters: int) -> float:
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(iters):
        flush()
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        events.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def _device_ms(fn, flush, flush_keys, iters: int) -> float:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            flush()
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(e, "self_device_time_total", 0) for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA and e.key not in flush_keys)
    return us / iters / 1e3 if us else float("nan")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("root")
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()
    sys.path[:0] = [args.root, args.root + "/src"]
    import torch

    if not torch.cuda.is_available():
        sys.exit("absmax_timing: no CUDA device")
    import chip_smoke
    from repro_torch.kernels import quant_adamw as QA
    from repro_torch.kernels import ref
    from repro_torch.kernels import stoch_quant as SQ

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    dev = torch.device("cuda", 0)
    buf = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=dev)
    words = buf.view(torch.int32)
    write_flush, read_flush = buf.zero_, lambda: words.max()
    chip_smoke._warm_up(dev)
    gen = torch.Generator(device=dev).manual_seed(6)
    hbm = chip_smoke.HBM_BYTES_PER_S

    rows = []           # (what, fn, bytes): every row's event timings run before
                        # any profiler session (one slows the launches after it)

    def report(what, fn, nbytes):
        rows.append((what, fn, nbytes, _event_ms(fn, write_flush, args.iters),
                     _event_ms(fn, read_flush, args.iters)))

    kw = dict(b1=0.9, b2=0.95)
    params = torch.tensor([0.5, 1, 1e-4, 0.1, 0.05, 0, 0, 0], dtype=torch.float32, device=dev)
    for r, c in chip_smoke.ADAMW_SHAPES:
        g = torch.randn(r, c, generator=gen, device=dev) * 0.1
        mc = torch.randint(-127, 128, (r, c), generator=gen, device=dev, dtype=torch.int8)
        vc = torch.randint(0, 128, (r, c), generator=gen, device=dev, dtype=torch.int8)
        ms = torch.rand(c, generator=gen, device=dev) * 0.01 + 1e-4
        vs = torch.rand(c, generator=gen, device=dev) * 0.01 + 1e-4
        ops = (g, mc, ms, vc, vs, params)
        if hasattr(QA, "qadamw_scales"):
            got = QA.qadamw_scales(*ops, **kw, qmax=127)
            want = QA.qadamw_scales_plain(*ops, **kw, qmax=127)
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                sys.exit(f"qadamw_scales ({r},{c}): not bit-equal to its plain version")
            del got, want
            report(f"qadamw_scales R{r} C{c}",
                   lambda ops=ops: QA.qadamw_scales(*ops, **kw, qmax=127), 6 * r * c + 16 * c)

        def parity_then_host(ops=ops):
            mx, vx = QA.qadamw_absmax(*ops, **kw)
            return (ref.adamw_scale_ref(torch.amax(mx, dim=0), 127),
                    ref.adamw_scale_ref(torch.amax(vx, dim=0), 127))

        report(f"parity entry + host reduction R{r} C{c}", parity_then_host,
               6 * r * c + 16 * c)
    for r, c in ((6000, 5000), (16, 5000)):
        x = torch.randn(r, c, generator=gen, device=dev) * 2
        if not torch.equal(SQ.row_absmax(x), SQ.row_absmax_plain(x)):
            sys.exit(f"row_absmax ({r},{c}): not bit-exact")
        report(f"row_absmax f32 R{r} C{c}", lambda x=x: SQ.row_absmax(x), 4 * r * c + 4 * r)
        report(f"torch.linalg.vector_norm(x, inf) R{r} C{c}",
               lambda x=x: torch.linalg.vector_norm(x, float("inf"), dim=1, keepdim=True),
               4 * r * c + 4 * r)

    flush_keys = _device_keys(read_flush)
    for what, fn, nbytes, w, r in rows:
        d = _device_ms(fn, read_flush, flush_keys, args.iters)
        b = nbytes / hbm * 1e3
        print(f"{what}: write {w:.4f} ms, read {r:.4f} ms, device {d:.4f} ms; bound {b:.5f} "
              f"(bytes; bound/ms write {b / w:.3f}, read {b / r:.3f}, device {b / d:.3f})",
              flush=True)


if __name__ == "__main__":
    main()
