"""Plain PyTorch oracles mirroring ``repro.kernels.ref`` (the ``ref``
backend's numerics)."""
from __future__ import annotations

import torch

from repro_torch.quant.qtensor import decode_bitplanes, div_exact, unpack_int4


def qmm_ref(x, codes, scale):
    """The f32-dequant oracle: x · (codes ⊙ scale), all in f32."""
    w = codes.to(torch.float32) * scale.to(torch.float32)
    return x.to(torch.float32) @ w


def ds_row_pair_ref(y, rand, *, qmax: int):
    """The §2.2 row-scaled double-sampling pair of y (M, N) on the int grid,
    both planes from one ``rand`` word per element (the epilogue of the
    reference's ``_qmm_qout_kernel``): scale = absmax/qmax per row (1 where
    the absmax is 0), t = y/scale, codeᵢ = clip(⌊t⌋ + [uᵢ < t − ⌊t⌋], ±qmax)
    with u1/u2 the high/low 16 bits · 2⁻¹⁶ (int32 patterns widened before
    shifting, ROADMAP C3), every division IEEE (C17); NaN → 0. Returns
    (codes1, codes2, scale (M, 1))."""
    y32 = y.to(torch.float32)
    absmax = torch.amax(y32.abs(), dim=1, keepdim=True)
    scale = torch.where(absmax == 0, torch.ones_like(absmax), div_exact(absmax, qmax))
    t = y32 / scale
    base = torch.floor(t)
    frac = t - base
    r = rand.to(torch.int64) & 0xFFFFFFFF
    u1 = (r >> 16).to(torch.float32) * (1.0 / (1 << 16))
    u2 = (r & 0xFFFF).to(torch.float32) * (1.0 / (1 << 16))
    c1 = torch.clamp(base + (u1 < frac).to(torch.float32), -qmax, qmax)
    c2 = torch.clamp(base + (u2 < frac).to(torch.float32), -qmax, qmax)
    return _nan_to_zero_int8(c1), _nan_to_zero_int8(c2), scale


def qmm_qout_ref(x, codes, scale, rand, *, qmax: int, packed: bool = False,
                 out_dtype=torch.bfloat16):
    """The plain ``qmm_qout``: f32 dequant and f32 accumulation of
    x (M, K) · (codes ⊙ scale), the product rounded to ``out_dtype``, then
    :func:`ds_row_pair_ref` on one uint32 ``rand`` plane (M, N). Returns
    (codes1, codes2 int8 (M, N), row scales (M, 1) f32)."""
    c = unpack_int4(codes) if packed else codes.to(torch.float32)
    y = x.to(torch.float32) @ (c * scale.to(torch.float32).reshape(1, -1))
    return ds_row_pair_ref(y.to(out_dtype), rand, qmax=qmax)


def qmm_t_ref(g, codes, scale, *, packed: bool = False):
    """The transposed f32-dequant oracle: g (M, N) · (codes ⊙ scale)ᵀ →
    (M, K) f32, codes (K, N) int8 or (K, N/2) packed int4."""
    c = unpack_int4(codes) if packed else codes.to(torch.float32)
    w = c * scale.to(torch.float32).reshape(1, -1)
    return g.to(torch.float32) @ w.t()


def qmm_bitplane_ref(x, planes, scale):
    """The f32-decode oracle of ``qmm_bitplane``: x (M, K) · decode(planes
    (P, K, ⌈N/32⌉), scale (1, N)) with the weight decoded and multiplied in
    f32; N is the scale's length, P = k + 1 (sign plane first)."""
    n = scale.numel()
    w = decode_bitplanes(planes, scale.to(torch.float32).reshape(1, n), n)
    return x.to(torch.float32) @ w


def adamw_moments_ref(g, m_codes, m_scale, v_codes, v_scale, clip, finite, *,
                      b1: float, b2: float):
    """Decode the old int8 moments (column scales, v in the √v domain) and
    take the EMA step, one op at a time in f32; non-finite steps keep the
    previous moments. Returns (m_store, v_store)."""
    f32 = torch.float32
    g32 = g.to(f32) * clip
    m_prev = m_codes.to(f32) * m_scale.to(f32).reshape(1, -1)
    v_sqrt = v_codes.to(f32) * v_scale.to(f32).reshape(1, -1)
    v_prev = v_sqrt * v_sqrt
    m = b1 * m_prev + (1 - b1) * g32
    v = b2 * v_prev + (1 - b2) * g32 * g32
    ok = torch.as_tensor(finite, device=g.device) > 0
    return torch.where(ok, m, m_prev), torch.where(ok, v, v_prev)


def adamw_scale_ref(absmax, qmax: int):
    """New moment scales from column absmaxes: absmax / qmax, 0 → 1; an
    IEEE division on every device (``div_exact``, ROADMAP C17), as the
    kernel's ``__fdiv_rn``."""
    return torch.where(absmax == 0, torch.ones_like(absmax), div_exact(absmax, qmax))


def adamw_update_ref(master, m_store, v_store, msn, vsn, rand, *, qmax: int,
                     eps: float, wd: float, lr, b1c, b2c, finite, uclip: float = 0.0):
    """The master update and the stochastic re-encode of m and √v against
    the new column scales, u1/u2 from the high/low 16 bits of one rand
    word (int32 patterns widened before shifting, ROADMAP C3). Returns
    (new_master, m_codes, v_codes)."""
    f32 = torch.float32
    update = (m_store / b1c) / (torch.sqrt(v_store / b2c) + eps)
    if uclip:
        update = torch.clamp(update, -uclip, uclip)
    mst = master.to(f32)
    ok = torch.as_tensor(finite, device=master.device) > 0
    new_master = torch.where(ok, mst - lr * (update + wd * mst), mst)
    r = rand.to(torch.int64) & 0xFFFFFFFF
    u1 = (r >> 16).to(f32) * (1.0 / (1 << 16))
    u2 = (r & 0xFFFF).to(f32) * (1.0 / (1 << 16))

    def code(t, u):
        lo = torch.floor(t)
        return torch.clamp(lo + (u < (t - lo)).to(f32), -qmax, qmax).to(torch.int8)

    mc = code(m_store / msn.reshape(1, -1), u1)
    vc = code(torch.sqrt(v_store) / vsn.reshape(1, -1), u2)
    return new_master, mc, vc


def quant_adamw_ref(master, g, m_codes, m_scale, v_codes, v_scale, rand, *,
                    qmax: int, b1: float, b2: float, eps: float, wd: float,
                    lr, b1c, b2c, clip, finite, uclip: float = 0.0):
    """The fused quantized-moment AdamW leaf update in plain PyTorch (the
    reference's ``ref.quant_adamw_ref``). master/g (R, C) f32; codes int8;
    scales (C,)/(1, C) f32; rand (R, C) uint32 words as int32 patterns.
    Returns (new_master, m_codes, m_scale_new, v_codes, v_scale_new) with
    (C,) scales."""
    m_store, v_store = adamw_moments_ref(g, m_codes, m_scale, v_codes, v_scale,
                                         clip, finite, b1=b1, b2=b2)
    msn = adamw_scale_ref(torch.amax(m_store.abs(), dim=0), qmax)
    vsn = adamw_scale_ref(torch.amax(torch.sqrt(v_store), dim=0), qmax)
    nm, mc, vc = adamw_update_ref(master, m_store, v_store, msn, vsn, rand,
                                  qmax=qmax, eps=eps, wd=wd, lr=lr, b1c=b1c,
                                  b2c=b2c, finite=finite, uclip=uclip)
    return nm, mc, msn, vc, vsn


def ds_quant_ref(x, rand, scale, *, s: int):
    """The fused double-sampling quantizer in plain PyTorch (the reference's
    ``ds_quant_ref``): a shared base level ⌊clip(|x|/scale)·s⌋ and two
    up-bits from the high and low 16 bits of one 32-bit ``rand`` word (int32
    bit patterns, widened and masked before shifting: torch cannot shift
    uint32, ROADMAP C3); NaN → 0."""
    x32 = x.to(torch.float32)
    r = rand.to(torch.int64) & 0xFFFFFFFF
    u1 = (r >> 16).to(torch.float32) * (1.0 / (1 << 16))
    u2 = (r & 0xFFFF).to(torch.float32) * (1.0 / (1 << 16))
    mag = x32.abs() / torch.clamp_min(scale.to(torch.float32), 1e-30)
    t = torch.clamp(mag, 0.0, 1.0) * s
    base = torch.clamp(torch.floor(t), 0, s - 1)
    frac = t - base
    sign = torch.sign(x32)
    c1 = _nan_to_zero_int8((base + (u1 < frac).to(torch.float32)) * sign)
    c2 = _nan_to_zero_int8((base + (u2 < frac).to(torch.float32)) * sign)
    return c1, c2


def _nan_to_zero_int8(codes):
    """f32 codes → int8, NaN (from a NaN x or scale) → 0: what the
    reference's ``astype(int8)`` gives, where torch's cast is undefined."""
    return torch.nan_to_num(codes, nan=0.0).to(torch.int8)


def stoch_quant_ref(x, rand, scale, *, s: int):
    """The single-plane stochastic quantizer in plain PyTorch (the
    reference's ``stoch_quant_ref``): u = (rand ≫ 8)·2⁻²⁴ from the int32
    bit patterns of uint32 words (widened and masked before shifting,
    ROADMAP C3), codes = (lo + [u < t − lo])·sign(x) with
    t = clip(|x|/scale, 0, 1)·s, lo = clip(⌊t⌋, 0, s − 1); NaN → 0."""
    x32 = x.to(torch.float32)
    r = rand.to(torch.int64) & 0xFFFFFFFF
    uf = (r >> 8).to(torch.float32) * (1.0 / (1 << 24))
    mag = x32.abs() / torch.clamp_min(scale.to(torch.float32), 1e-30)
    t = torch.clamp(mag, 0.0, 1.0) * s
    lo = torch.clamp(torch.floor(t), 0, s - 1)
    codes = lo + (uf < (t - lo)).to(torch.float32)
    return _nan_to_zero_int8(codes * torch.sign(x32))


def row_absmax_ref(x):
    """(R, C) → (R, 1) f32 max|x| per row (``jnp.max``: NaN propagates)."""
    return torch.amax(x.to(torch.float32).abs(), dim=1, keepdim=True)


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


def ssd_chunk_scan_ref(xh, dt, logdec, bmat, cmat, init_state=None):
    """The plain chunked SSD (mirrors ``repro.kernels.ref.ssd_chunk_scan_ref``
    and the einsum form of ``models/ssm.ssd_chunked``), all in f32, the
    decay masked before the exponential.

    xh (B, NC, L, H, P); dt/logdec (B, NC, L, H); b/c (B, NC, L, N);
    init_state (B, H, P, N) or None (zeros). Returns y (B, NC, L, H, P) in
    xh's dtype and the final state (B, H, P, N) f32."""
    f32 = torch.float32
    b, nc, L, h, p = xh.shape
    n = bmat.shape[-1]
    state = (torch.zeros((b, h, p, n), dtype=f32, device=xh.device)
             if init_state is None else init_state.to(f32))
    mask = torch.ones((L, L), dtype=torch.bool, device=xh.device).tril()[None, :, :, None]
    ys = []
    for c in range(nc):
        xc, dtc, ldc = xh[:, c].to(f32), dt[:, c].to(f32), logdec[:, c].to(f32)
        bc, cc = bmat[:, c].to(f32), cmat[:, c].to(f32)
        cum = torch.cumsum(ldc, dim=1)                           # (B, L, H)
        xw = xc * dtc[..., None]                                 # (B, L, H, P)
        diff = cum[:, :, None, :] - cum[:, None, :, :]           # (B, L, L, H)
        dec = torch.exp(torch.where(mask, diff, -torch.inf))
        att = (cc @ bc.transpose(1, 2))[..., None] * dec         # (B, L, L, H)
        y_intra = torch.einsum("blmh,bmhp->blhp", att, xw)
        y_inter = torch.einsum("bln,bhpn->blhp", cc, state) * torch.exp(cum)[..., None]
        tail = torch.exp(cum[:, -1:, :] - cum)                   # decay to the chunk's end
        bx = torch.einsum("blhp,bln->bhpn", xw * tail[..., None], bc)
        state = state * torch.exp(cum[:, -1])[:, :, None, None] + bx
        ys.append((y_intra + y_inter).to(xh.dtype))
    return torch.stack(ys, dim=1), state
