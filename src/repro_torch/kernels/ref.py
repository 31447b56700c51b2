"""Plain PyTorch oracles mirroring ``repro.kernels.ref`` (the ``ref``
backend's numerics)."""
from __future__ import annotations

import torch

from repro_torch.quant.qtensor import unpack_int4


def qmm_ref(x, codes, scale):
    """The f32-dequant oracle: x · (codes ⊙ scale), all in f32."""
    w = codes.to(torch.float32) * scale.to(torch.float32)
    return x.to(torch.float32) @ w


def ds_quant_ref(x, rand, scale, *, s: int):
    """The fused double-sampling quantizer in plain PyTorch (the reference's
    ``ds_quant_ref``): a shared base level ⌊clip(|x|/scale)·s⌋ and two
    up-bits from the high and low 16 bits of one 32-bit ``rand`` word (int32
    bit patterns, widened and masked before shifting: torch cannot shift
    uint32, ROADMAP C3)."""
    x32 = x.to(torch.float32)
    r = rand.to(torch.int64) & 0xFFFFFFFF
    u1 = (r >> 16).to(torch.float32) * (1.0 / (1 << 16))
    u2 = (r & 0xFFFF).to(torch.float32) * (1.0 / (1 << 16))
    mag = x32.abs() / torch.clamp_min(scale.to(torch.float32), 1e-30)
    t = torch.clamp(mag, 0.0, 1.0) * s
    base = torch.clamp(torch.floor(t), 0, s - 1)
    frac = t - base
    sign = torch.sign(x32)
    c1 = ((base + (u1 < frac).to(torch.float32)) * sign).to(torch.int8)
    c2 = ((base + (u2 < frac).to(torch.float32)) * sign).to(torch.int8)
    return c1, c2


def qmv_ref(codes, v):
    """int8 codes (R, C) · v (C,) with the codes widened to f32."""
    return codes.to(torch.float32) @ v.to(torch.float32)


def dequant_pages_ref(pages, scale):
    """Dequantize KV pages to bf16 rows (the ring buffer's per-row math).

    pages: (…, page, Hkv, D) bf16 | int8 codes | uint8 packed int4 (…, D/2);
    scale: (…, page, Hkv, 1) f32 or None (unquantized passthrough)."""
    if scale is None:
        return pages
    codes = unpack_int4(pages) if pages.dtype == torch.uint8 \
        else pages.to(torch.float32)
    return (codes * scale).to(torch.bfloat16)


def gather_pages_ref(pages, block_table):
    """(P, page, Hkv, Dk) pool + (B, MAXP) table → (B, MAXP·page, Hkv, Dk)
    contiguous per-sequence rows (rows past seq_len are masked garbage)."""
    g = pages[block_table.to(torch.int64)]
    b, mp, page = g.shape[:3]
    return g.reshape(b, mp * page, *g.shape[3:])


def paged_attention_ref(q, k_pages, v_pages, k_scale, v_scale, block_table,
                        seq_lens, *, softmax_scale):
    """Gather pages through the block table, dequantize to bf16 rows, run the
    masked one-shot softmax decode (models.attention.decode_attention).
    q: (B, H, D) → (B, H, D) in q.dtype."""
    from repro_torch.models import attention as attn

    k = dequant_pages_ref(gather_pages_ref(k_pages, block_table),
                          gather_pages_ref(k_scale, block_table)
                          if k_scale is not None else None)
    v = dequant_pages_ref(gather_pages_ref(v_pages, block_table),
                          gather_pages_ref(v_scale, block_table)
                          if v_scale is not None else None)
    b, h, d = q.shape
    spec = attn.AttnSpec(n_heads=h, n_kv_heads=k.shape[2], head_dim=d,
                         softmax_scale=softmax_scale)
    out = attn.decode_attention(q[:, None], k, v, spec, kv_len=seq_lens)
    return out[:, 0]
