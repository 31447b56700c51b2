"""Public wrappers around the kernels (port of ``repro.kernels.ops`` for
``quant_dense_apply`` and ``paged_attention``).

Unlike the TPU wrappers nothing is padded to 128: the CUDA kernels mask
ragged M, K and N themselves.
"""
from __future__ import annotations

import torch

from . import paged_attn as pa_mod
from . import qmm as qmm_mod


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
