"""repro_torch.core — the paper's linear-model suite (port of ``repro.core``).

quantize        — unbiased stochastic quantization Q(v, s) (C1), and
                  rounding onto arbitrary level sets
double_sampling — unbiased low-precision LSQ gradients (C2, C3) and the
                  §4.1 polynomial estimator
optimal         — variance-optimal quantization levels (C4, §3)
chebyshev       — Chebyshev gradients for non-linear losses (C6/C7, §4)
linear          — datasets and the SGD driver ``train_linear`` for linear
                  regression, LS-SVM, the SVM and logistic regression under
                  every ``PrecisionPlan.mode``
"""
from repro_torch.quant import PrecisionPlan  # noqa: F401

from . import chebyshev, double_sampling, linear, optimal, quantize  # noqa: F401
from .linear import Dataset, TrainResult, make_dataset, train_linear  # noqa: F401
from .quantize import stochastic_quantize  # noqa: F401
