"""Device time of bitplane serving for one checkout, on one NVIDIA card:
full-width gemma-2b (random weights from seed 0) with 8-bit bitplane
weights, KV 8 and self-speculative decoding (k 3, draft 4 bits), built
through that checkout's ``serve_engine``. ``torch.profiler`` measures

* a prefill at each prompt bucket of ``chip_smoke.py``'s served trace (M
  48–112): ``transformer.prefill`` of one random prompt of that length
  under the served weights (the model pass of an admission);
* ``--windows`` speculative windows of 4 live requests (64-token prompts),
  as ``chip_smoke.profile_decode`` runs them;

and prints, for each, the device time and the part of it in kernel B11
(``qmm_bitplane``'s kernels and its split-K reduce) as one JSON line. To
compare a change with its parent on one card, unpack both checkouts and
run them interleaved in one call (parent, change, change, parent):

  python scripts/bitplane_device_time.py ROOT [--warm SECONDS] [--windows N]

ROOT is the checkout whose ``src/`` is imported.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

BUCKETS = (48, 64, 80, 96, 112)
SERVE = dict(max_slots=4, page_size=16, max_prompt=128, max_new=32)


def _profile(fn, reps: int) -> dict:
    """Device ms per call of ``fn`` over ``reps`` calls, all kernels and
    B11's alone (``torch.profiler``'s device-side events)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    total = b11 = 0.0
    launches = 0
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0)
        total += us
        if "qmm_bitplane" in ev.key or "splitk_reduce_scale" in ev.key:
            b11 += us
            launches += ev.count
    return {"device_ms": total / 1e3 / reps, "b11_ms": b11 / 1e3 / reps,
            "b11_kernel_launches": launches / reps, "wall_ms": 1e3 * wall / reps}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("root")
    ap.add_argument("--warm", type=float, default=5.0)
    ap.add_argument("--windows", type=int, default=5)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    sys.path.insert(0, args.root + "/src")
    import torch

    if not torch.cuda.is_available():
        sys.exit("bitplane_device_time: no CUDA device")
    from repro_torch.kernels import registry
    from repro_torch.launch.serve import make_trace, serve_engine
    from repro_torch.models import transformer as T

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    engine, _ = serve_engine("gemma-2b", reduced=False, weight_bits=8, kv_bits=8,
                             weight_layout="bitplane", device=dev, spec_decode=3,
                             draft_bits=4, n_requests=0, **SERVE)
    if args.warm > 0:
        a = torch.randn(8192, 8192, device=dev, dtype=torch.bfloat16)
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < args.warm:
            a @ a
            torch.cuda.synchronize()
        del a
    gen = torch.Generator().manual_seed(0)
    prefill = {}
    for m in BUCKETS:
        toks = torch.randint(0, engine.cfg.vocab_size, (1, m), generator=gen).to(dev)

        def run(toks=toks):
            with registry.using(engine.backend):
                T.prefill(engine.params, toks, engine._cfg_fp)
        prefill[m] = _profile(run, args.reps)
    for r in make_trace(4, engine.cfg.vocab_size, max_new=args.windows + 4, min_prompt=64,
                        max_prompt=64, seed=7):
        engine.submit(r)
    engine.step()                                  # admit all four + one window
    windows = _profile(engine.step, args.windows)
    while engine.busy:
        engine.step()
    print(json.dumps({"root": args.root, "card": card, "prefill_by_bucket": prefill,
                      "speculative_window": windows,
                      "acceptance_rate": engine.acceptance_rate()}), flush=True)


if __name__ == "__main__":
    main()
