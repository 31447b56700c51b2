"""C1 — unbiased stochastic quantization Q(v, s) (port of
``repro.core.quantize``; ZipML §2.1, App. A.3).

v/M maps into [-1, 1] and each coordinate snaps stochastically to one of the
two nearest of ``s+1`` uniformly spaced levels, so E[Q(v, s)] = v (Lemma 6).
M is a row scale (one scalar per vector, :func:`row_scale`) or a column
scale (per feature over a dataset, :func:`column_scale`). Storage is a
:class:`repro_torch.quant.QTensor` on the zipml grid; randomness enters
through an explicit key (:mod:`repro_torch.prng`), bit-exact with the
reference's ``jax.random`` draws.
"""
from __future__ import annotations

import torch

from repro_torch.quant import QScheme, QTensor
from repro_torch.quant.qtensor import encode


def row_scale(v: torch.Tensor, norm: str = "linf") -> torch.Tensor:
    """M(v): a 0-d f32 bound with |v|/M ≤ 1 — max|v| (``linf``) or the
    paper's ‖v‖₂ (``l2``); 0 maps to 1."""
    v32 = v.to(torch.float32)
    if norm == "l2":
        m = torch.linalg.vector_norm(v32)
    elif norm == "linf":
        m = torch.amax(v32.abs())
    else:
        raise ValueError(f"unknown norm {norm!r}")
    return torch.where(m == 0, torch.ones_like(m), m)


def column_scale(data: torch.Tensor) -> torch.Tensor:
    """Per-feature M_i = max_k |data[k, i]| over a (K, n) dataset (App. A.3)."""
    m = torch.amax(data.to(torch.float32).abs(), dim=0)
    return torch.where(m == 0, torch.ones_like(m), m)


def quantize(v: torch.Tensor, s: int, key: torch.Tensor,
             scale: torch.Tensor | None = None, signed: bool = True) -> QTensor:
    """Stochastic uniform quantization Q(v, s), unbiased: codes are
    sign · level ∈ [-s, s] (App. A.3 Eq. 10). ``scale=None`` → row scale."""
    if scale is None:
        scale = row_scale(v)
    return encode(v, QScheme.zipml(s, signed=signed), key, scale=scale)


def quantize_nearest(v: torch.Tensor, s: int, scale: torch.Tensor | None = None,
                     signed: bool = True) -> QTensor:
    """Deterministic nearest rounding — the §5.4 straw man (biased)."""
    if scale is None:
        scale = row_scale(v)
    return encode(v, QScheme.zipml(s, signed=signed, rounding="nearest"),
                  scale=scale)


def dequantize(q: QTensor) -> torch.Tensor:
    return q.decode()


def stochastic_quantize(v: torch.Tensor, s: int, key: torch.Tensor,
                        scale: torch.Tensor | None = None,
                        signed: bool = True) -> torch.Tensor:
    """quantize → dequantize in one step: the low-precision values, the form
    the double-sampling gradient math is written in."""
    return quantize(v, s, key, scale=scale, signed=signed).decode()


def quantize_to_levels(v, levels, key=None):
    raise NotImplementedError(
        "quantization onto variance-optimal levels is not ported yet "
        "(ROADMAP A2.3, core/optimal.py)")


def tv_variance(v: torch.Tensor, s: int, scale: torch.Tensor | None = None) -> torch.Tensor:
    """TV(v) = E‖Q(v) − v‖² in closed form: (hi − v)(v − lo) per coordinate,
    in units of the level width scale/s."""
    v32 = v.to(torch.float32)
    if scale is None:
        scale = row_scale(v32)
    x = torch.clamp((v32 / scale).abs(), 0.0, 1.0)
    t = x * s
    lo = torch.clamp(torch.floor(t), 0, s - 1)
    frac = t - lo
    w = scale / s
    return torch.sum(frac * (1.0 - frac) * (w ** 2))
