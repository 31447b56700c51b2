"""quant_dense — the one registry op every QTensor-weighted matmul routes
through (port of ``repro.quant.quant_dense``, forward only).

``ref`` decodes the weight to bf16 and multiplies with f32 accumulation;
``cuda`` streams the int8 / packed-int4 codes through the hand-written
``qmm`` kernel. The code-domain VJP and ``ShipWeight`` wait for the
training slice (ROADMAP A4).
"""
from __future__ import annotations

import torch

from .qtensor import QTensor


def mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (…, K) · b (K, N) → f32 with f32 accumulation — what
    ``jnp.einsum(..., preferred_element_type=f32)`` computes. On the card,
    bf16 operands go to one bf16 GEMM with an f32 output (no f32 copy of a
    large weight); elsewhere both operands widen to f32, which is exact for
    the products."""
    if a.is_cuda and a.dtype == b.dtype and a.dtype in (torch.bfloat16, torch.float16) \
            and _mm_has_out_dtype():
        lead = a.shape[:-1]
        y = torch.mm(a.reshape(-1, a.shape[-1]), b, out_dtype=torch.float32)
        return y.reshape(*lead, b.shape[-1])
    return a.to(torch.float32) @ b.to(torch.float32)


def _mm_has_out_dtype() -> bool:
    """Whether this PyTorch has ``torch.mm(..., out_dtype=)`` (older builds
    widen both operands instead)."""
    return "dtype" in torch.ops.aten.mm.overloads()


def quant_dense(x: torch.Tensor, w, *, backend=None) -> torch.Tensor:
    """y = x · W for a QTensor (through the kernel registry) or a dense
    weight (plain product), f32 result; the caller casts."""
    if isinstance(w, QTensor):
        from repro_torch.kernels import registry

        return registry.resolve(backend, x.device).quant_dense(x, w)
    return mm_f32(x, w)
