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



def poly_estimate(coeffs: torch.Tensor, a: torch.Tensor, x: torch.Tensor, s: int,
                  u: torch.Tensor, scale: torch.Tensor | None = None) -> torch.Tensor:
    """:func:`polynomial_estimator` from its d uniform planes ``u`` (d, B, n):
    all d quantizations in one pass, the running products Πⱼ≤ᵢ Qⱼ(a)ᵀx and
    the sum m₀ + Σ mᵢ·prodᵢ accumulated in the reference's order (a
    cumulative product and sum along the monomial axis)."""
    d = coeffs.shape[0] - 1
    B = a.shape[0]
    c = coeffs.to(device=a.device, dtype=torch.float32)
    if d == 0:
        return torch.full((B,), float(c[0]), dtype=torch.float32, device=a.device)
    qa = stochastic_quantize(a.expand(d, *a.shape), s, None, scale=scale, u=u)
    prods = torch.cumprod(qa @ x, dim=0)                           # (d, B)
    terms = torch.cat([c[:1].expand(1, B), c[1:, None] * prods])
    return torch.cumsum(terms, dim=0)[-1]


def polynomial_estimator(coeffs: torch.Tensor, a: torch.Tensor, x: torch.Tensor,
                         s: int, key: torch.Tensor,
                         scale: torch.Tensor | None = None) -> torch.Tensor:
    """C6, §4.1: unbiased estimate of P(aᵀx) = Σ mᵢ (aᵀx)ⁱ from i independent
    quantizations per monomial, Πⱼ≤ᵢ Qⱼ(a)ᵀx. ``coeffs`` (d+1,) are
    m₀..m_d; returns (B,). The variance grows with the degree (Lemma 4).
    The d planes, one per key of ``split(key, d)``, are drawn in one
    batched call with the bits of d separate draws."""
    d = coeffs.shape[0] - 1
    keys = prng.split(key, max(d, 1))[:d]
    u = prng.uniform(keys, a.shape, device=a.device) if d else None
    return poly_estimate(coeffs, a, x, s, u, scale)
