"""§3.4 — double-sampled activation quantization for deep nets (port of
``repro.precision.act_quant``).

A linear layer y = x·W consumes its saved activation x twice: in the
forward product and in the weight gradient ∂W = xᵀ·δ. Storing two
independent stochastic quantizations Q₁(x), Q₂(x) — Q₁ for the forward, Q₂
for the backward — keeps E[∂W] = xᵀ·δ unbiased (the paper's double
sampling, §2.2) while the saved activation shrinks to int8/int4 codes.

* :func:`ds_dense` — y = Q₁(x)·W with ∂W from Q₂(x): a
  ``torch.autograd.Function`` (the reference's ``custom_vjp``). The
  quantizer is the per-tensor symmetric int grid with double-sampled
  rounding (``ds_pair``: two independent draws from the split key). When
  no gradient is needed, only the Q₁ plane is drawn, with the pair's first
  split key, as the reference's primal does.
* :func:`ds_mlp` — the gated MLP block with all three products through
  :func:`ds_dense`.
* :func:`ds_project` — y = x·W emitted straight as its §2.2 row-scaled
  pair (``quant_dense_q``): on the card the ``qmm_qout`` kernel encodes
  both planes from the product, with no dense activation in between.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import prng
from repro_torch.models.layers import gelu_tanh
from repro_torch.quant import QScheme, QTensor, ds_pair, encode, mm_f32, quant_dense_q


def _act_scheme(bits: int) -> QScheme:
    """Per-tensor symmetric int grid, double-sampled stochastic rounding."""
    return QScheme.int_symmetric(bits, scaling="tensor", rounding="ds")


class _DSDense(torch.autograd.Function):
    """Forward on Q₁(x), backward from the saved Q₂ codes: gx = g·Wᵀ and
    gW = Q₂(x)ᵀ·g, each accumulated in f32 and cast to W's dtype (plain
    products: the reference computes them outside any kernel)."""

    @staticmethod
    def forward(ctx, x, w, key, bits):
        qx = ds_pair(x.detach(), _act_scheme(bits), key)
        y = mm_f32(qx.decode(x.dtype), w.detach()).to(x.dtype)
        # only the Q₂ plane (the int8 codes) and W are kept for the backward
        ctx.save_for_backward(qx.codes2, qx.scale, w)
        ctx.bits = bits
        return y

    @staticmethod
    def backward(ctx, g):
        codes2, scale, w = ctx.saved_tensors
        q2 = QTensor(codes2, scale, _act_scheme(ctx.bits).with_rounding("stochastic"))
        gx = gw = None
        if ctx.needs_input_grad[0]:
            gx = mm_f32(g, w.t()).to(w.dtype)
        if ctx.needs_input_grad[1]:
            xq2 = q2.decode(w.dtype)
            gw = mm_f32(xq2.reshape(-1, xq2.shape[-1]).t(),
                        g.reshape(-1, g.shape[-1])).to(w.dtype)
        return gx, gw, None, None


def ds_dense(x: torch.Tensor, w: torch.Tensor, key: torch.Tensor,
             bits: int = 8) -> torch.Tensor:
    """y = Q₁(x)·W (f32 accumulation, cast to x's dtype) with ∂W computed
    from the independent Q₂(x). ``w`` is a dense (K, N) weight; ``key`` a
    port key (:mod:`repro_torch.prng`)."""
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return _DSDense.apply(x, w, key, bits)
    k1, _ = prng.split(key)
    qx = encode(x, _act_scheme(bits).with_rounding("stochastic"), k1)
    return mm_f32(qx.decode(x.dtype), w).to(x.dtype)


def ds_mlp(p, x: torch.Tensor, key: torch.Tensor, act: str = "silu",
           bits: int = 8) -> torch.Tensor:
    """Gated MLP with double-sampled activation quantization on all three
    products; ``act`` is ``silu`` or the tanh GELU (gemma's, evaluated op by
    op in x's dtype as ``jax.nn.gelu`` does, ROADMAP C5)."""
    k1, k2, k3 = prng.split(key, 3)
    hg = ds_dense(x, p["gate"]["w"], k1, bits)
    hu = ds_dense(x, p["up"]["w"], k2, bits)
    a = F.silu(hg) if act == "silu" else gelu_tanh(hg)
    return ds_dense(a * hu, p["down"]["w"], k3, bits)


def ds_project(x: torch.Tensor, w, key: torch.Tensor, bits: int = 8,
               backend=None) -> QTensor:
    """y = x·W emitted as its §2.2 double-sampled row-quantized pair — one
    QTensor with both int8 code planes and (…, 1) row scales — instead of a
    dense activation (``quant_dense_q``). ``w`` is dense, a QTensor or a
    ShipWeight. Forward only: the consumer of the pair owns the backward.
    Decode Q₁ with ``.decode(dtype)``, Q₂ with ``.decode2(dtype)``."""
    return quant_dense_q(x, w, key, bits=bits, backend=backend)
