"""Step sizes for the gisette LS-SVM run of ``chip_smoke.py``, on the JAX
reference (``repro.core.linear.train_linear``, CPU).

  PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/reference_lr_sweep.py [lr ...]

For each lr (default 0.3 0.1 0.05 0.03 0.02 0.01 0.003) trains LS-SVM on
``make_dataset("gisette")`` (6000 × 5000), batch 16, 2 epochs, in fp32 and
at e2e 6/8/8 bits, and prints the per-epoch losses, the e2e/fp32 ratio of
the final losses and whether the convergence criterion of
``benchmarks/bench_linear_convergence.py`` (e2e ≤ 1.4 × fp32 + 1e-4) holds.
"""
from __future__ import annotations

import sys

from repro.core.linear import make_dataset, train_linear
from repro.quant import PrecisionPlan

DEFAULT_LRS = (0.3, 0.1, 0.05, 0.03, 0.02, 0.01, 0.003)


def main(lrs):
    ds = make_dataset("gisette")
    plans = {"fp32": PrecisionPlan("full"),
             "e2e": PrecisionPlan("e2e", sample_bits=6, model_bits=8, grad_bits=8)}
    for lr in lrs:
        losses = {name: train_linear(ds, plan, model="lssvm", epochs=2, batch=16,
                                     lr=lr).losses for name, plan in plans.items()}
        fp32, e2e = losses["fp32"][-1], losses["e2e"][-1]
        print(f"lr {lr}: fp32 {losses['fp32'].tolist()} e2e {losses['e2e'].tolist()} "
              f"ratio {e2e / fp32} criterion {bool(e2e <= 1.4 * fp32 + 1e-4)}", flush=True)


if __name__ == "__main__":
    main([float(a) for a in sys.argv[1:]] or DEFAULT_LRS)
