"""Public wrappers around the kernels (port of ``repro.kernels.ops`` for
``quant_dense_apply``, ``paged_attention``, ``ds_quantize``,
``int8_matvec`` and ``ds_gradient_from_codes``).

Unlike the TPU wrappers nothing is padded to 128: the CUDA kernels mask
ragged edges themselves.
"""
from __future__ import annotations

import torch

from repro_torch import prng

from . import paged_attn as pa_mod
from . import qmm as qmm_mod
from . import qmv as qmv_mod
from . import stoch_quant as sq_mod


def quant_dense_apply(x: torch.Tensor, codes: torch.Tensor,
                      scale: torch.Tensor, *, packed: bool = False) -> torch.Tensor:
    """y = x · dequant(codes, scale) for a 2-D code plane.

    x: (*lead, K); codes (K, N) int8 or (K, N/2) packed-int4 uint8; scale
    (1, N) f32. Leading x dims fold into the GEMM's M axis. Returns
    (*lead, N) f32."""
    lead = x.shape[:-1]
    y = qmm_mod.qmm(x.reshape(-1, x.shape[-1]), codes, scale, packed=packed)
    return y.reshape(*lead, y.shape[-1])


def kv_bits_of(pages: torch.Tensor) -> int:
    """KV width from a page plane's dtype: uint8 = packed int4, int8 = int8,
    anything else unquantized (0)."""
    if pages.dtype == torch.uint8:
        return 4
    if pages.dtype == torch.int8:
        return 8
    return 0


def paged_attention(q, k_pages, v_pages, k_scale, v_scale, block_table,
                    seq_lens, *, softmax_scale: float) -> torch.Tensor:
    """Paged flash-decode attention through the kernel (in-kernel int8/int4
    dequant). q: (B, H, D); pages (P, page, Hkv, D[/2]); scales may be None
    (bf16 pool). Returns (B, H, D) in q.dtype."""
    out = pa_mod.paged_decode_attn(
        q, k_pages, v_pages, k_scale, v_scale, block_table, seq_lens,
        softmax_scale=float(softmax_scale), kv_bits=kv_bits_of(k_pages))
    return out.to(q.dtype)


def ds_quantize(x: torch.Tensor, s: int, key: torch.Tensor, scale: torch.Tensor):
    """Fused double-sampling quantization: both Q₁/Q₂ int8 code planes from
    one pass over x (paper §2.2 — shared base + 1 extra bit), the rounding
    bits one ``jax.random.bits(key, x.shape, uint32)``-exact plane made on
    x's device.

    A ``(R, 1)`` scale selects row scaling; anything else (a scalar, (C,),
    (1, C)) broadcasts to column scales ``(1, C)``. Returns (codes1, codes2,
    scale) with E[codesᵢ/s·scale] = x."""
    if x.ndim != 2:
        raise ValueError(f"ds_quantize takes a 2-D x, got {tuple(x.shape)}")
    if scale is None:
        raise NotImplementedError(
            "ds_quantize(scale=None) needs the row_absmax kernel (ROADMAP B2)")
    r, c = x.shape
    scale = torch.as_tensor(scale, dtype=torch.float32, device=x.device)
    if tuple(scale.shape) == (r, 1):
        axis = "row"
    else:
        scale = scale.reshape(1, -1).expand(1, c)
        axis = "col"
    rand = prng.bits(key, x.shape, device=x.device).to(torch.int32)
    c1, c2 = sq_mod.ds_quant(x, rand, scale, s=s, scale_axis=axis)
    return c1, c2, scale


def int8_matvec(codes: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """r = codes · v for int8 (R, C) codes — a plane or a transposed view of
    one — and (C,) v; (R,) f32."""
    return qmv_mod.qmv(codes, v.to(torch.float32))


def ds_gradient_from_codes(codes1, codes2, x, b, scale, s: int) -> torch.Tensor:
    """Symmetrized double-sampling LSQ gradient ½[q₁ᵀr₂ + q₂ᵀr₁]/B straight
    from the int8 code planes and column scales m: qᵢ = cᵢ ⊙ m / s, so
    qᵢᵀ(qⱼx − b) = m ⊙ (cᵢᵀ rⱼ)/s with rⱼ = cⱼ(m ⊙ x)/s − b — four int8
    matvecs, two of them on transposed views of the planes."""
    B = codes1.shape[0]
    m = scale.to(torch.float32).reshape(-1)
    xs = x.to(torch.float32) * m
    r1 = int8_matvec(codes1, xs) / s - b
    r2 = int8_matvec(codes2, xs) / s - b
    g = int8_matvec(codes1.T, r2) + int8_matvec(codes2.T, r1)
    return g * m / (2.0 * B * s)
