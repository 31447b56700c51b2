"""Public wrappers around the kernels (port of ``repro.kernels.ops`` for
``quant_dense_apply``, ``paged_attention``, ``quantize_rows``,
``dequantize_rows``, ``ds_quantize``, ``int8_matvec``,
``ds_gradient_from_codes``, ``quant_adamw_update``, ``quant_dense_bitplane``,
``quant_dense_out_q`` and ``ssd_chunked_kernel``).

Unlike the TPU wrappers nothing is padded to 128: the CUDA kernels mask
ragged edges themselves.
"""
from __future__ import annotations

import torch

from repro_torch import prng

from . import paged_attn as pa_mod
from . import qmm as qmm_mod
from . import qmm_bitplane as qbp_mod
from . import qmm_qout as qout_mod
from . import qmm_t as qmm_t_mod
from . import qmv as qmv_mod
from . import quant_adamw as qa_mod
from . import ref
from . import ssd as ssd_mod
from . import stoch_quant as sq_mod


def quant_dense_apply(x: torch.Tensor, codes: torch.Tensor,
                      scale: torch.Tensor, *, packed: bool = False,
                      transpose: bool = False) -> torch.Tensor:
    """y = x · dequant(codes, scale)[ᵀ] for a 2-D code plane.

    x: (*lead, K) [or (*lead, N) transposed]; codes (K, N) int8 or (K, N/2)
    packed-int4 uint8; scale (1, N) f32. Leading x dims fold into the GEMM's
    M axis. Returns (*lead, N) [or (*lead, K)] f32: ``qmm``, or ``qmm_t``
    for the transposed product."""
    lead = x.shape[:-1]
    kern = qmm_t_mod.qmm_t if transpose else qmm_mod.qmm
    y = kern(x.reshape(-1, x.shape[-1]), codes, scale, packed=packed)
    return y.reshape(*lead, y.shape[-1])


def quant_dense_bitplane(x: torch.Tensor, codes: torch.Tensor,
                         scale: torch.Tensor, n_out: int) -> torch.Tensor:
    """y = x · decode(bitplane codes) for a 2-D logical weight.

    x: (*lead, K); codes (P, K, ⌈n_out/32⌉) 32-bit words (plane 0 = sign,
    then magnitude MSB first); scale (1, n_out) f32. Leading x dims fold
    into the GEMM's M axis; the kernel masks the ragged M, K and the tail
    word's columns itself, so nothing is padded. Returns (*lead, n_out) f32
    (``qmm_bitplane``)."""
    lead = x.shape[:-1]
    y = qbp_mod.qmm_bitplane(x.reshape(-1, x.shape[-1]), codes,
                             scale.reshape(1, n_out))
    return y.reshape(*lead, n_out)


def quant_dense_out_q(x: torch.Tensor, codes: torch.Tensor, scale: torch.Tensor,
                      rand: torch.Tensor, *, qmax: int, packed: bool = False,
                      out_dtype=torch.bfloat16):
    """Fused GEMM + double-sampled row quantization of the output
    (``qmm_qout``). x: (M, K); codes (K, N) int8 or (K, N/2) packed uint8;
    scale (1, N); rand (M, N) uint32 words (as int32). Returns (codes1,
    codes2 (M, N) int8, row scales (M, 1) f32). M and K may be ragged (the
    kernel masks them); N is the true output width, since the row absmax
    must see nothing but real columns."""
    return qout_mod.qmm_qout(x, codes, scale, rand, qmax=qmax, packed=packed,
                             out_dtype=out_dtype)


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


def quantize_rows(x: torch.Tensor, s: int, key: torch.Tensor):
    """Row-scaled stochastic quantization: ``row_absmax``, one
    ``jax.random.bits(key, x.shape, uint32)``-exact plane made on x's
    device, then ``stoch_quant``. x (R, C) → (codes int8 in [-s, s],
    scale (R, 1) f32), unbiased: E[codes/s·scale] = x."""
    if x.ndim != 2:
        raise ValueError(f"quantize_rows takes a 2-D x, got {tuple(x.shape)}")
    scale = sq_mod.row_absmax(x)
    rand = prng.bits(key, x.shape, device=x.device, dtype=torch.int32)
    return sq_mod.stoch_quant(x, rand, scale, s=s), scale


def dequantize_rows(codes: torch.Tensor, scale: torch.Tensor, s: int) -> torch.Tensor:
    """codes / s · scale in f32 (the reference computes it in jnp, outside
    any kernel)."""
    return codes.to(torch.float32) / s * scale


def ds_quantize(x: torch.Tensor, s: int, key: torch.Tensor,
                scale: torch.Tensor | None = None):
    """Fused double-sampling quantization: both Q₁/Q₂ int8 code planes from
    one pass over x (paper §2.2 — shared base + 1 extra bit), the rounding
    bits those of ``jax.random.bits(key, x.shape, uint32)``, bit for bit.
    On the card that is one launch of ``ds_quant``'s keyed entry, which
    hashes each element's word in registers (73 32-bit integer operations,
    41 of them shifts and xors, ``csrc/threefry.cuh``) and moves 6 bytes
    per f32 element (x, two code planes) where the plane and the rand entry
    moved 14 (the plane written, then x, rand and the codes); on the CPU
    the plane is drawn and the plain version run.

    ``scale=None`` takes per-row absmax scales (R, 1) from ``row_absmax``; a
    ``(R, 1)`` scale selects row scaling; anything else (a scalar, (C,),
    (1, C)) broadcasts to column scales ``(1, C)``. Returns (codes1, codes2,
    scale) with E[codesᵢ/s·scale] = x."""
    if x.ndim != 2:
        raise ValueError(f"ds_quantize takes a 2-D x, got {tuple(x.shape)}")
    r, c = x.shape
    if scale is None:
        scale = sq_mod.row_absmax(x)
    scale = torch.as_tensor(scale, dtype=torch.float32, device=x.device)
    if tuple(scale.shape) == (r, 1):
        axis = "row"
    else:
        scale = scale.reshape(1, -1).expand(1, c)
        axis = "col"
    c1, c2 = sq_mod.ds_quant_keyed(x, key, scale, s=s, scale_axis=axis)
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


def quant_adamw_update(master, g, m_codes, m_scale, v_codes, v_scale, rand=None, *,
                       key=None, qmax: int, b1: float, b2: float, eps: float, wd: float,
                       lr, b1c, b2c, clip, finite, uclip: float = 0.0):
    """Fused quantized-moment AdamW leaf update through the two kernels:
    pass 1 (``qadamw_scales``) reduces the new-moment column absmaxes over
    every row and writes the new scales in one launch, and pass 2 follows
    it directly, with nothing between: it updates the master and re-encodes
    both moments. The f32 moments never reach device memory.

    master/g (R, C) f32; codes (R, C) int8; scales (C,) f32; rand (R, C)
    int32 (uint32 words: hi/lo 16 bits drive the m and √v draws) or, in
    its place, ``key``: pass 2 then hashes the words of ``prng.bits(key,
    (R, C))`` in registers (the keyed entry, 16 bytes an element where the
    plane and the rand entry move 24);
    lr/b1c/b2c/clip/finite are step scalars (Python floats or 0-d tensors,
    the latter may live on the device). Returns
    (new_master, m_codes, m_scale_new, v_codes, v_scale_new), (C,) scales."""
    dev = master.device
    params = torch.cat([
        torch.stack([torch.as_tensor(v, dtype=torch.float32).to(dev).reshape(())
                     for v in (clip, finite, lr, b1c, b2c)]),
        torch.zeros(3, dtype=torch.float32, device=dev)])
    master, g = master.to(torch.float32), g.to(torch.float32)
    msn, vsn = qa_mod.qadamw_scales(g, m_codes, m_scale, v_codes, v_scale, params,
                                    b1=b1, b2=b2, qmax=qmax)
    nm, mc, vc = qa_mod.qadamw_update(master, g, m_codes, m_scale, v_codes, v_scale,
                                      msn, vsn, rand, params, key=key, b1=b1, b2=b2,
                                      eps=eps, wd=wd, qmax=qmax, uclip=uclip)
    return nm, mc, msn, vc, vsn


def _ssd_chunked(scan, xh, dt, a_log, b_mat, c_mat, chunk, init_state):
    b, s, h, p = xh.shape
    L = min(chunk, s)
    if s % L:
        L = s                 # one chunk as long as the sequence
    nc = s // L
    a = -torch.exp(a_log.to(torch.float32))
    logdec = (dt * a[None, None, :]).to(torch.float32)

    def chunked(t):
        return t.reshape(b, nc, L, *t.shape[2:])

    y, state = scan(chunked(xh), chunked(dt), chunked(logdec), chunked(b_mat),
                    chunked(c_mat), init_state)
    return y.reshape(b, s, h, p), state


def ssd_chunked_kernel(xh, dt, a_log, b_mat, c_mat, chunk: int = 256,
                       init_state=None):
    """Drop-in for ``models/ssm.ssd_chunked`` through the SSD kernel
    (``ssd_chunk_scan``). xh (B, S, H, P); dt (B, S, H) f32 step sizes;
    a_log (H,); b/c (B, S, G·N) with G = 1; init_state (B, H, P, N) or None.
    A chunk of ``chunk`` steps, or one chunk of S where ``chunk`` does not
    divide S. Returns (y (B, S, H, P) in xh's dtype, state (B, H, P, N)
    f32)."""
    return _ssd_chunked(ssd_mod.ssd_chunk_scan, xh, dt, a_log, b_mat, c_mat, chunk,
                        init_state)


def ssd_chunked_plain(xh, dt, a_log, b_mat, c_mat, chunk: int = 256,
                      init_state=None):
    """:func:`ssd_chunked_kernel` with the plain scan (``ref.ssd_chunk_scan_ref``)
    — the einsum form of the reference's ``models/ssm.ssd_chunked``."""
    return _ssd_chunked(ref.ssd_chunk_scan_ref, xh, dt, a_log, b_mat, c_mat, chunk,
                        init_state)
