"""quant_dense — the one registry op every QTensor-weighted matmul routes
through, forward and backward (port of ``repro.quant.quant_dense``).

``ref`` decodes the weight to bf16 and multiplies with f32 accumulation;
``cuda`` streams the int8 / packed-int4 codes through the hand-written
``qmm`` kernel, and the transposed product x · Wᵀ through ``qmm_t``.

:class:`ShipWeight` is the quantize-on-gather training form: the int codes
the matmul streams plus the dense ``master`` the straight-through gradient
flows to. Its product is one ``torch.autograd.Function``
(the reference's ``_qd_ste`` custom VJP): the forward is the registry's
``quant_dense``; the backward computes dx in the code domain —
``quant_dense(g, qt, transpose=True)``, the ``qmm_t`` kernel on the card —
and dW = Σ x ⊗ g as a plain product emitted in the master's dtype.

``transpose=True`` contracts against Wᵀ (the tied unembed: logits =
h · tableᵀ, ``qmm_t`` on the card). :func:`quant_dense_q` is the product
with the fused quantize epilogue: the §2.2 double-sampled row-scaled pair of
the output (``qmm_qout`` on the card), forward only.
"""
from __future__ import annotations

import torch

from .qtensor import QTensor


class ShipWeight:
    """A shipped (quantize-on-gather) weight: ``qt`` int codes for the
    matmul + the dense ``master`` the STE gradient flows back to."""

    __slots__ = ("master", "qt")

    def __init__(self, master: torch.Tensor, qt: QTensor):
        self.master = master
        self.qt = qt

    @property
    def shape(self):
        return self.qt.shape

    @property
    def ndim(self) -> int:
        return self.qt.ndim

    def __repr__(self):
        return f"ShipWeight({self.qt!r})"


def _mm_has_out_dtype() -> bool:
    """Whether this PyTorch has ``torch.mm(..., out_dtype=)`` (older builds
    widen both operands instead)."""
    return "dtype" in torch.ops.aten.mm.overloads()


def _half(t: torch.Tensor) -> bool:
    return t.dtype in (torch.bfloat16, torch.float16)


class _MmF32(torch.autograd.Function):
    """a (M, K) · b (K, N) half-precision operands → f32 with f32
    accumulation, one GEMM on the card. PyTorch has no derivative for
    ``mm(..., out_dtype=)`` ("derivative for aten::mm is not implemented",
    torch 2.11 on the H100), so the backward is written here as the same
    kind of product (the cotangent rounded to the operands' dtype, f32
    accumulation, cast to each operand's dtype): no operand is ever widened
    to an f32 copy — the tied unembed's (256000, 2048) table included."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return torch.mm(a, b, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        gh = g.to(a.dtype)
        da = db = None
        if ctx.needs_input_grad[0]:
            da = torch.mm(gh, b.t(), out_dtype=torch.float32).to(a.dtype)
        if ctx.needs_input_grad[1]:
            db = torch.mm(a.t(), gh, out_dtype=torch.float32).to(b.dtype)
        return da, db


def mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (…, K) · b (K, N) → f32 with f32 accumulation — what
    ``jnp.einsum(..., preferred_element_type=f32)`` computes. On the card,
    bf16 operands go to one bf16 GEMM with an f32 output (no f32 copy of a
    large weight), differentiable through :class:`_MmF32`; elsewhere both
    operands widen to f32, which is exact for the products."""
    if a.is_cuda and a.dtype == b.dtype and _half(a) and _mm_has_out_dtype():
        lead = a.shape[:-1]
        y = _MmF32.apply(a.reshape(-1, a.shape[-1]), b)
        return y.reshape(*lead, b.shape[-1])
    return a.to(torch.float32) @ b.to(torch.float32)


def bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (…, S, M, K) · b (S, K, N) → (…, S, M, N) f32 with f32
    accumulation: the stacked product of ``jnp.einsum("...smk,skn->...smn",
    preferred_element_type=f32)`` (the MoE expert axis S rides on both
    operands). On the card, half-precision operands go to one batched GEMM
    with an f32 output (forward only: no stacked weight is trained);
    elsewhere both operands widen to f32, which is exact for the
    products."""
    if a.is_cuda and a.dtype == b.dtype and _half(a) \
            and "dtype" in torch.ops.aten.bmm.overloads():
        s, (m, k) = b.shape[0], a.shape[-2:]
        lead = a.shape[:-3]
        a3 = a.movedim(-3, 0).reshape(s, -1, k)
        y = torch.bmm(a3, b, out_dtype=torch.float32)
        return y.reshape(s, *lead, m, b.shape[-1]).movedim(0, -3)
    return torch.matmul(a.to(torch.float32), b.to(torch.float32))


def _backend(backend, device):
    from repro_torch.kernels import registry

    return registry.resolve(backend, device)


class _ShipDense(torch.autograd.Function):
    """y = x · decode(qt) (or · decode(qt)ᵀ) with the straight-through
    gradient to the master (the reference's ``_qd_ste``). Integer codes and
    scales get no gradient."""

    @staticmethod
    def forward(ctx, x, master, codes, scale, scheme, backend, transpose):
        qt = QTensor(codes, scale, scheme)
        ctx.save_for_backward(x, codes, scale)
        ctx.meta = (master.dtype, scheme, backend, transpose)
        return _backend(backend, x.device).quant_dense(x, qt, transpose=transpose)

    @staticmethod
    def backward(ctx, g):
        x, codes, scale = ctx.saved_tensors
        mdtype, scheme, backend, transpose = ctx.meta
        qt = QTensor(codes, scale, scheme)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = _backend(backend, g.device).quant_dense(
                g, qt, transpose=not transpose).to(x.dtype)
        if ctx.needs_input_grad[1]:
            # layers.dense casts y to x.dtype, so g's values are exact in
            # x's dtype and Σ_batch x ⊗ g runs as one product there
            x2 = x.reshape(-1, x.shape[-1])
            g2 = g.reshape(-1, g.shape[-1]).to(x.dtype)
            dw = (mm_f32(g2.t(), x2) if transpose else mm_f32(x2.t(), g2)).to(mdtype)
        return dx, dw, None, None, None, None, None


def quant_dense(x: torch.Tensor, w, *, transpose: bool = False,
                backend=None) -> torch.Tensor:
    """y = x · W (or x · Wᵀ) in f32; the caller casts.

    ``w``: a :class:`QTensor` (codes stream through the kernel backend), a
    :class:`ShipWeight` (the same, plus the straight-through master
    gradient), or a dense weight (plain product). Weights are 2-D (K, N);
    ``transpose`` contracts x (…, N) against Wᵀ → (…, K) (the tied unembed,
    and the backward's dx)."""
    if isinstance(w, ShipWeight):
        qt = w.qt
        return _ShipDense.apply(x, w.master, qt.codes, qt.scale, qt.scheme,
                                backend, transpose)
    if isinstance(w, QTensor):
        return _backend(backend, x.device).quant_dense(x, w, transpose=transpose)
    return mm_f32(x, w.t() if transpose else w)


def quant_dense_q(x: torch.Tensor, w, key: torch.Tensor, *, bits: int = 8,
                  backend=None) -> QTensor:
    """``quant_dense`` with the fused quantize epilogue: the §2.2
    double-sampled row-scaled int-grid pair of the output activation as one
    QTensor (codes + codes2 + (…, 1) row scales) instead of the dense y.
    Forward only: the consumer of the pair owns the backward. A ShipWeight
    streams its codes; a dense ``w`` takes the plain product, cast to x's
    dtype, then the split-key pair (``ds_pair``)."""
    if isinstance(w, ShipWeight):
        w = w.qt
    if isinstance(w, QTensor):
        return _backend(backend, x.device).quant_dense_out_q(x, w, key, bits=bits)
    from .qtensor import ds_pair
    from .scheme import QScheme

    y = mm_f32(x, w).to(x.dtype)
    return ds_pair(y, QScheme.int_symmetric(bits, scaling="row", rounding="ds"), key,
                   backend=backend)
