"""C6/C7 — Chebyshev gradient approximation for non-linear losses (port of
``repro.core.chebyshev``; ZipML §4).

Smooth losses: approximate ℓ'(z) on z ∈ [−R, R] by a degree-d Chebyshev
polynomial P (|P − ℓ'| ≤ ε), then estimate b·P(b·aᵀx)·a unbiasedly from
d+1 independent quantizations of a (§4.2: Q₁..Q_d feed the polynomial
estimator of :func:`~repro_torch.core.double_sampling.polynomial_estimator`,
Q_{d+1} carries the outer a).

Non-smooth losses (SVM / hinge): the step function H is fitted on
[−R, R] \\ [−δ, δ] (§4.3); inside the δ-gap the gradient can flip sign,
which ``train_linear``'s refetching handles.

The coefficients are numpy float64, the reference's own computation; the
callers cast them to f32 where the reference does. The d+1 uniform planes
of one gradient are drawn in one batched threefry call
(:func:`poly_gradient_keys` names their keys), with the bits of the
reference's d+1 separate draws.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from repro_torch import prng

from .double_sampling import poly_estimate
from .quantize import stochastic_quantize


def chebyshev_coeffs(f: Callable[[np.ndarray], np.ndarray], degree: int,
                     R: float, n_nodes: int = 513) -> np.ndarray:
    """Monomial coefficients m_i (P(z) = Σ m_i zⁱ) of the degree-d Chebyshev
    approximation of f on [−R, R]: Gauss–Chebyshev quadrature in the
    Chebyshev basis, converted to monomials in u = z/R and unmapped."""
    k = np.arange(n_nodes)
    t = np.cos(np.pi * (k + 0.5) / n_nodes)          # Chebyshev nodes in [-1,1]
    fz = f(t * R)
    j = np.arange(degree + 1)
    Tjk = np.cos(np.outer(j, np.pi * (k + 0.5) / n_nodes))
    c = (2.0 / n_nodes) * Tjk @ fz
    c[0] *= 0.5
    cheb = np.polynomial.chebyshev.Chebyshev(c)
    mono_u = cheb.convert(kind=np.polynomial.Polynomial).coef  # coeffs in u = z/R
    if len(mono_u) < degree + 1:
        mono_u = np.pad(mono_u, (0, degree + 1 - len(mono_u)))
    scale = float(R) ** -np.arange(degree + 1)
    return mono_u * scale


def sigmoid_prime_coeffs(degree: int, R: float) -> np.ndarray:
    """ℓ'(z) of the logistic loss ℓ(z) = log(1+e^{−z}): ℓ'(z) = −sigmoid(−z)."""
    return chebyshev_coeffs(lambda z: -1.0 / (1.0 + np.exp(z)), degree, R)


def step_coeffs(degree: int, R: float, delta: float = 0.05) -> np.ndarray:
    """Heaviside approximation for the hinge loss: least squares in the
    monomial basis on the Chebyshev nodes outside the δ-gap [−δ, δ]."""
    n_nodes = 1025
    k = np.arange(n_nodes)
    z = np.cos(np.pi * (k + 0.5) / n_nodes) * R
    mask = np.abs(z) > delta
    z = z[mask]
    y = (z >= 0).astype(np.float64)
    V = np.vander(z / R, degree + 1, increasing=True)
    coef, *_ = np.linalg.lstsq(V, y, rcond=None)
    return coef * float(R) ** -np.arange(degree + 1)


class ChebGradConfig(NamedTuple):
    degree: int = 15
    R: float = 4.0
    s: int = 15          # quantization intervals per independent sample (4-bit)
    delta: float = 0.05  # hinge-only: half-width of the unapproximated gap


def poly_gradient_keys(key: torch.Tensor, degree: int) -> torch.Tensor:
    """The d+1 keys of :func:`quantized_poly_gradient` — split(key) into
    (k_poly, k_outer), ``split(k_poly, max(d, 1))[:d]`` for the monomials,
    then k_outer — as (…, d+1, 2) for a key or a batch of keys (…, 2)."""
    k_poly, k_outer = prng.split(key).unbind(-2)
    mono = prng.split(k_poly, max(degree, 1))[..., :degree, :]
    return torch.cat([mono, k_outer.unsqueeze(-2)], dim=-2)


def quantized_poly_gradient(coeffs: torch.Tensor, x: torch.Tensor, a: torch.Tensor,
                            b: torch.Tensor, s: int, key: torch.Tensor | None,
                            scale: torch.Tensor | None = None, *,
                            u: torch.Tensor | None = None) -> torch.Tensor:
    """§4.2: g = b · Q(P)(b·aᵀx) · Q_{d+1}(a), averaged over the batch.

    Bias ≤ ε sup|a| (|P − ℓ'| ≤ ε); every quantization is independent, so
    the polynomial estimator is unbiased for P. ``u`` (d+1, B, n) holds
    the planes of :func:`poly_gradient_keys` (key), drawn beforehand."""
    d = coeffs.shape[0] - 1
    if u is None:
        u = prng.uniform(poly_gradient_keys(key, d), a.shape, device=a.device)
    # P(b·aᵀx) = P((b·a)ᵀx) for b ∈ {−1, +1}: the label is absorbed into a
    ab = a * b[:, None]
    pb = poly_estimate(coeffs, ab, x, s, u[:d], scale)
    qa = stochastic_quantize(a, s, None, scale=scale, u=u[d])
    return (qa * (b * pb)[:, None]).mean(dim=0)


def poly_eval(coeffs: np.ndarray, z: np.ndarray) -> np.ndarray:
    """Horner evaluation, for tests of the approximation error."""
    out = np.zeros_like(z, dtype=np.float64)
    for c in coeffs[::-1]:
        out = out * z + c
    return out
