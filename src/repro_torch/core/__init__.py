"""repro_torch.core — the paper's linear-model suite (port of ``repro.core``).

quantize        — unbiased stochastic quantization Q(v, s) (C1)
double_sampling — unbiased low-precision LSQ gradients (C2, C3)
linear          — datasets and the SGD driver ``train_linear`` for linear
                  regression and LS-SVM under every ``PrecisionPlan.mode``

The Chebyshev gradients (logistic regression, SVM) and the variance-optimal
levels raise ``NotImplementedError`` naming their ROADMAP items.
"""
from repro_torch.quant import PrecisionPlan  # noqa: F401

from . import double_sampling, linear, quantize  # noqa: F401
from .linear import Dataset, TrainResult, make_dataset, train_linear  # noqa: F401
from .quantize import stochastic_quantize  # noqa: F401
