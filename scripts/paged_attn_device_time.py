"""Device time of paged attention (kernel B10) in gemma-2b decode steps for
one checkout, on one NVIDIA card: full-width gemma-2b (random weights from
seed 0) at weight/KV bits 8/8 and 4/4 through that checkout's
``serve_engine`` (4 slots, page 16), 4 live requests of 64-token prompts,
as ``chip_smoke.profile_decode`` runs them. ``torch.profiler`` measures
``--steps`` decode steps, ``--reps`` times; the script prints, per bits,
the device ms per step, the part of it in the ``paged_attn`` kernel and
that kernel's launches per step as one JSON line. To compare a change with
its parent on one card, unpack both checkouts and run them interleaved in
one call (parent, change, change, parent):

  python scripts/paged_attn_device_time.py ROOT [--warm SECONDS] [--steps N] [--reps N]

ROOT is the checkout whose ``src/`` is imported.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

SERVE = dict(max_slots=4, page_size=16, max_prompt=128, max_new=32)


def _profile(engine, steps: int) -> dict:
    """Device ms per decode step over ``steps`` steps: all kernels and
    ``paged_attn``'s alone (``torch.profiler``'s device-side events)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch.serve import make_trace

    for r in make_trace(4, engine.cfg.vocab_size, max_new=steps + 4, min_prompt=64,
                        max_prompt=64, seed=7):
        engine.submit(r)
    engine.step()                                  # admit all four + one decode
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            engine.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    while engine.busy:
        engine.step()
    total = attn = 0.0
    launches = 0
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0)
        total += us
        if "paged_attn" in ev.key:
            attn += us
            launches += ev.count
    return {"device_ms": total / 1e3 / steps, "paged_attn_ms": attn / 1e3 / steps,
            "paged_attn_launches": launches / steps, "wall_ms": 1e3 * wall / steps}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("root")
    ap.add_argument("--warm", type=float, default=5.0)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    sys.path.insert(0, args.root + "/src")
    import torch

    if not torch.cuda.is_available():
        sys.exit("paged_attn_device_time: no CUDA device")
    from repro_torch.launch.serve import serve_engine

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    out = {"root": args.root, "card": card}
    for bits in (8, 4):
        engine, _ = serve_engine("gemma-2b", reduced=False, weight_bits=bits, kv_bits=bits,
                                 device=dev, n_requests=0, **SERVE)
        if args.warm > 0:
            a = torch.randn(8192, 8192, device=dev, dtype=torch.bfloat16)
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < args.warm:
                a @ a
                torch.cuda.synchronize()
            del a
        reps = [_profile(engine, args.steps) for _ in range(args.reps)]
        out[f"{bits}/{bits}"] = {k: statistics.median(r[k] for r in reps) for k in reps[0]}
        out[f"{bits}/{bits}"]["reps"] = reps
        del engine
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
