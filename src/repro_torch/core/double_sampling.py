"""C2/C3 — double sampling and end-to-end quantized gradients (port of
``repro.core.double_sampling``; ZipML §2.2, App. B/E).

For least-squares losses the stochastic gradient a(aᵀx − b) is quadratic in
the sample a, so quantizing a once biases it (App. B.1). Double sampling
draws two independent quantizations and uses the symmetrized estimator

    g = ½ [ Q₁(a)(Q₂(a)ᵀx − b) + Q₂(a)(Q₁(a)ᵀx − b) ],

unbiased. The end-to-end variant (App. E) also quantizes the model (Q₃) and
the produced gradient (Q₄), both row-scaled. ``a`` is a (B, n) minibatch.

The pair draw and the gradient built from it dispatch through
:mod:`repro_torch.kernels.registry`: ``ref`` decodes two split-key draws,
``cuda`` runs the fused ``ds_quant`` kernel and four ``qmv`` launches on the
int8 code planes.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch import prng
from repro_torch.kernels import registry

from .quantize import row_scale, stochastic_quantize


class DSConfig(NamedTuple):
    """Interval counts s of each channel (levels = s+1; 0 = full precision):
    ``s_sample`` for Q₁/Q₂ on samples (column-scaled), ``s_model`` for Q₃
    on the model and ``s_grad`` for Q₄ on the gradient (both row-scaled)."""

    s_sample: int = 15
    s_model: int = 0
    s_grad: int = 0


def double_sample_pair(a: torch.Tensor, s: int, key: torch.Tensor,
                       scale: torch.Tensor | None = None, backend=None):
    """Two independent unbiased quantizations (decoded) of the same batch."""
    return registry.resolve(backend, a.device).ds_quant_values(a, s, key, scale=scale)


def lsq_gradient_fullprec(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Mean over the batch of a(aᵀx − b)."""
    resid = a @ x - b
    return a.T @ resid / a.shape[0]


def lsq_gradient_naive_quant(x, a, b, s: int, key, scale=None) -> torch.Tensor:
    """The biased estimator of App. B.1: one quantization used twice; kept
    as the baseline that shows the divergence."""
    qa = stochastic_quantize(a, s, key, scale=scale)
    resid = qa @ x - b
    return qa.T @ resid / a.shape[0]


def lsq_gradient_double_sampling(x, a, b, s: int, key, scale=None,
                                 backend=None) -> torch.Tensor:
    """The unbiased double-sampling gradient (symmetrized, §2.2)."""
    return registry.resolve(backend, a.device).lsq_ds_gradient(x, a, b, s, key,
                                                               scale=scale)


def lsq_gradient_e2e(x, a, b, cfg: DSConfig, key, sample_scale=None,
                     backend=None) -> torch.Tensor:
    """End-to-end quantized gradient (App. E, Eq. 13): samples, model and
    gradient; the update itself stays full precision (Eq. 14)."""
    k_s, k_m, k_g = prng.split(key, 3)
    xq = x
    if cfg.s_model > 0:
        xq = stochastic_quantize(x, cfg.s_model, k_m, scale=row_scale(x))
    g = lsq_gradient_double_sampling(xq, a, b, cfg.s_sample, k_s,
                                     scale=sample_scale, backend=backend)
    if cfg.s_grad > 0:
        g = stochastic_quantize(g, cfg.s_grad, k_g, scale=row_scale(g))
    return g

