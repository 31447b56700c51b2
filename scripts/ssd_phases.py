"""Kernel B12 (``ssd_chunk_scan``) of one checkout, by device kernel, on one
NVIDIA card: ``torch.profiler`` over 10 calls at each row of
``chip_smoke.SSD_CASES`` (after 3 untimed calls), the device time of each
kernel the call launched, per call — on the tensor cores the three phases
(``ssd_tc_state``: cum and bx; ``ssd_tc_carry``: the states entering each
chunk; ``ssd_tc_out``: y), on the SIMT core its one kernel.

  PYTHONPATH=src python scripts/ssd_phases.py ROOT

ROOT is the checkout whose ``chip_smoke.py`` and ``src/`` are imported.
"""
from __future__ import annotations

import re
import subprocess
import sys
import time

CALLS = 10


def main():
    root = sys.argv[1] if len(sys.argv) > 1 else "."
    sys.path[:0] = [root, root + "/src"]
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        sys.exit("ssd_phases: no CUDA device")
    import chip_smoke
    from repro_torch.kernels import ssd as SD

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    a = torch.randn(8192, 8192, device=dev, dtype=torch.bfloat16)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < 5.0:      # a cold card reads its first rows slow
        a @ a
        torch.cuda.synchronize()
    del a
    for shape, dname, init, role in chip_smoke.SSD_CASES:
        args = chip_smoke._ssd_inputs(dev, shape, getattr(torch, dname), init)
        for _ in range(3):
            SD.ssd_chunk_scan(*args)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(CALLS):
                SD.ssd_chunk_scan(*args)
            torch.cuda.synchronize()
        by = {}
        for ev in prof.key_averages():
            if ev.device_type != DeviceType.CUDA:
                continue
            us = getattr(ev, "self_device_time_total", None)
            if us is None:
                us = getattr(ev, "self_cuda_time_total", 0)
            m = re.search(r"ssd_\w+", ev.key)
            name = m.group(0) if m else ev.key[:40]
            by[name] = by.get(name, 0.0) + us / 1e3 / CALLS
        total = sum(by.values())
        print(f"{root}: {dname} {shape}{' init' if init else ''} ({role}): device "
              f"{total:.4f} ms a call = " + " + ".join(
                  f"{k} {v:.4f}" for k, v in sorted(by.items(), key=lambda kv: -kv[1])),
              flush=True)
        del args
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
