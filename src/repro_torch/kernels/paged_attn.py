"""paged_decode_attn — one-token flash decode over a paged, possibly
quantized KV pool (port of ``repro.kernels.paged_attn``; the CUDA source is
``csrc/paged_attn.cu``).

On a CUDA tensor the wrapper launches the hand-written kernel once or
raises: a split-page flash decode whose blocks each take a fixed run of a
sequence's pages and whose last block per (sequence, kv head) merges the
splits in fixed order (:func:`plan` sizes the grid and the workspace from
shapes alone). On a CPU tensor it computes :func:`paged_decode_attn_plain`,
the same f32 online-softmax math written out in PyTorch.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.quant.qtensor import unpack_int4

from . import _build, _workspace
from ._workspace import current_stream as _stream

NEG_INF = -2.0 ** 30   # matches models/attention.py: finite, exp() == 0.0 in f32
launches = 0           # kernel launches made by paged_decode_attn()


def _dequant(pages, scale, kv_bits: int):
    """(…, page, Hkv, D[/2]) pages + (…, page, Hkv, 1) scales → f32 rows."""
    if kv_bits == 4:
        return unpack_int4(pages) * scale.to(torch.float32)
    x = pages.to(torch.float32)
    return x * scale.to(torch.float32) if kv_bits else x


def paged_decode_attn_plain(q, k_pages, v_pages, k_scale, v_scale,
                            block_table, seq_lens, *, softmax_scale: float,
                            kv_bits: int = 0) -> torch.Tensor:
    """The kernel's f32 flash math, page by page over the block table:
    running max / denominator / weighted values, rows at or past seq_len
    masked with NEG_INF and re-masked to probability 0. Returns (B, H, D)
    f32; a sequence of length 0 gives 0."""
    b, h, d = q.shape
    g = k_pages.shape[2]
    r = h // g
    page = k_pages.shape[1]
    qg = q.to(torch.float32).reshape(b, g, r, d)
    lens = seq_lens.to(torch.int64)
    m = torch.full((b, g, r), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, g, r), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, g, r, d), dtype=torch.float32, device=q.device)
    bt = block_table.to(torch.int64)
    for p in range(bt.shape[1]):
        ids = bt[:, p]
        k = _dequant(k_pages[ids], k_scale[ids] if kv_bits else None, kv_bits)
        v = _dequant(v_pages[ids], v_scale[ids] if kv_bits else None, kv_bits)
        s = torch.einsum("bgrd,btgd->bgrt", qg, k) * softmax_scale
        pos = p * page + torch.arange(page, device=q.device)
        valid = (pos[None, :] < lens[:, None])[:, None, None, :]
        s = torch.where(valid, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        pexp = torch.where(valid, torch.exp(s - m_new[..., None]),
                           torch.zeros_like(s))
        m = m_new
        l = l * alpha + pexp.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum("bgrt,btgd->bgrd", pexp, v)
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(b, h, d)


def _lib():
    return typed(_build.load("paged_attn"))


def typed(lib):
    """Declare the C entry points of a ``csrc/paged_attn.cu`` library (a
    build of it with another split, too) and read its pages per split."""
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.paged_attn_launch.argtypes = [p, i, p, p, p, p, p, p, p, p, p,
                                          i, i, i, i, i, i, i, i,
                                          ctypes.c_float, p]
        lib.paged_attn_launch.restype = i
        lib.paged_attn_pages_per_split.argtypes = []
        lib.paged_attn_pages_per_split.restype = i
        lib.paged_attn_error_string.argtypes = [i]
        lib.paged_attn_error_string.restype = ctypes.c_char_p
        lib.pages_per_split = lib.paged_attn_pages_per_split()
        lib._typed = True
    return lib



_PAGE_DTYPE = {0: torch.bfloat16, 8: torch.int8, 4: torch.uint8}
MAX_D = 512                 # csrc/paged_attn.cu · kMaxChunks: 4 chunks of 4 per lane


class Plan(NamedTuple):
    """How one call runs: ``splits`` blocks per (sequence, kv head), each
    over ``pages_per_split`` consecutive block-table entries (the kernel's
    constant); ``ws`` f32 words of split partials and ``counters`` int32
    arrival counters; K/V rows copied ``copy_w`` bytes at a time."""
    splits: int
    ws: int
    counters: int
    copy_w: int


def plan(b: int, h: int, hkv: int, d: int, maxp: int, row_bytes: int,
         base: int, pages_per_split: int) -> Plan:
    """From shapes alone (never from ``seq_lens``, which stays on the
    card): the grid's split axis covers the widest block-table row, and a
    split's partial holds R·D weighted values plus R maxima and R
    denominators. ``base`` is the pages' addresses or-ed together: the
    copy width is the widest of 16, 8, 4 bytes that it and the row's
    bytes are multiples of."""
    if d % 8 or d > MAX_D:
        raise ValueError(f"paged_decode_attn: the kernel takes D a multiple of 8 "
                         f"up to {MAX_D}, got {d}")
    splits = max(1, -(-maxp // pages_per_split))
    r = h // hkv
    w = 16
    while w > 4 and (base | row_bytes) % w:
        w //= 2
    if (base | row_bytes) % w:
        raise ValueError("paged_decode_attn: page rows must be 4-byte aligned")
    return Plan(splits, b * hkv * splits * (r * d + 2 * r), b * hkv, w)


# per (device, stream): the split partials and the arrival counters
# (_workspace.kept)
_WORKSPACE: dict = {}


def paged_decode_attn(q, k_pages, v_pages, k_scale, v_scale, block_table,
                      seq_lens, *, softmax_scale: float,
                      kv_bits: int = 0) -> torch.Tensor:
    """q (B, H, D) × paged KV pool → (B, H, D) f32.

    k/v_pages: (P, page, Hkv, D) bf16/int8 or (P, page, Hkv, D/2) uint8
    (packed int4); k/v_scale: (P, page, Hkv, 1) f32 (ignored for bf16);
    block_table (B, MAXP) int32; seq_lens (B,) int32."""
    if not q.is_cuda:
        return paged_decode_attn_plain(
            q, k_pages, v_pages, k_scale, v_scale, block_table, seq_lens,
            softmax_scale=softmax_scale, kv_bits=kv_bits)
    b, h, d = q.shape
    n_pages, page, hkv, dk = k_pages.shape
    if kv_bits not in _PAGE_DTYPE or k_pages.dtype != _PAGE_DTYPE[kv_bits] \
            or v_pages.dtype != k_pages.dtype:
        raise TypeError(f"paged_decode_attn: kv_bits={kv_bits} needs "
                        f"{_PAGE_DTYPE.get(kv_bits)} pages, got {k_pages.dtype}")
    if dk != (d // 2 if kv_bits == 4 else d) or h % hkv \
            or v_pages.shape != k_pages.shape:
        raise ValueError(f"paged_decode_attn: q {tuple(q.shape)} vs pages "
                         f"{tuple(k_pages.shape)}")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"paged_decode_attn: q must be bf16 or f32, got {q.dtype}")
    for t in (k_pages, v_pages, block_table, seq_lens):
        if not t.is_cuda:
            raise ValueError("paged_decode_attn: every operand must be on the card")
    if not (k_pages.is_contiguous() and v_pages.is_contiguous()):
        raise ValueError("paged_decode_attn: page planes must be contiguous")
    if kv_bits:
        for sc in (k_scale, v_scale):
            if not sc.is_contiguous() or sc.shape != (n_pages, page, hkv, 1) \
                    or sc.dtype != torch.float32:
                raise ValueError("paged_decode_attn: scales must be contiguous "
                                 f"(P, page, Hkv, 1) f32, got {tuple(sc.shape)}")
    return _launch(q.contiguous(), k_pages, v_pages,
                   k_scale if kv_bits else None, v_scale if kv_bits else None,
                   block_table.to(torch.int32).contiguous(),
                   seq_lens.to(torch.int32).contiguous(), float(softmax_scale), kv_bits)


def _launch(q, k_pages, v_pages, k_scale, v_scale, bt, lens, softmax_scale, kv_bits):
    """Plan the grid and the workspace from shapes, and launch once."""
    global launches
    b, h, d = q.shape
    page, hkv, dk = k_pages.shape[1:]
    lib = _lib()
    p = plan(b, h, hkv, d, bt.shape[1], dk * k_pages.element_size(),
             k_pages.data_ptr() | v_pages.data_ptr(), lib.pages_per_split)
    stream = _stream(q)
    ws, counters = _workspace.kept(_WORKSPACE, q.device, stream, p.ws, p.counters)
    out = torch.empty((b, h, d), dtype=torch.float32, device=q.device)
    err = lib.paged_attn_launch(
        q.data_ptr(), int(q.dtype == torch.bfloat16), k_pages.data_ptr(),
        v_pages.data_ptr(), None if k_scale is None else k_scale.data_ptr(),
        None if v_scale is None else v_scale.data_ptr(), bt.data_ptr(),
        lens.data_ptr(), out.data_ptr(), ws.data_ptr(), counters.data_ptr(),
        b, h, hkv, d, page, bt.shape[1], kv_bits, p.copy_w, softmax_scale, stream)
    if err:
        raise RuntimeError(f"paged_decode_attn kernel launch failed: "
                           f"{lib.paged_attn_error_string(err).decode()}")
    launches += 1
    return out
