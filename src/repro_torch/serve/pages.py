"""Paged KV-cache pool + host-side page allocator (port of
``repro.serve.pages``).

``k_pages``/``v_pages``: (L, P, page, Hkv, D) bf16 or int8 codes, or
(L, P, page, Hkv, D/2) uint8 packed int4; quantized pools carry
per-(token, head) f32 scales (L, P, page, Hkv, 1) from the row-symmetric
nearest scheme. Page 0 is the null page: never allocated, the write target
of inactive slots.

Unlike the reference's functional updates, :func:`write_prompt`,
:func:`append_rows`, :func:`write_rows` and :func:`scrub_pages` write into
the pool **in place** — a decode step would otherwise copy every layer's
page planes.

The allocator refcounts pages so full (immutable) prompt pages can be
shared read-only across block-table rows (the prefix cache): ``alloc``
hands a page out at refcount 1, every further sharer takes :meth:`incref`,
and ``free`` drops one reference.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.kernels.ops import kv_bits_of
from repro_torch.quant import QScheme, encode


def kv_scheme(kv_bits: int) -> QScheme:
    """Row-symmetric (per token × head) nearest int grid; packed at 4 bits."""
    if kv_bits not in (4, 8):
        raise ValueError(f"quantized KV pools support 4/8 bits, got {kv_bits}")
    return QScheme.int_symmetric(kv_bits, scaling="row", rounding="nearest",
                                 packed=(kv_bits == 4))


class PagedKVPool(NamedTuple):
    k_pages: torch.Tensor                 # (L, P, page, Hkv, D or D/2)
    v_pages: torch.Tensor
    k_scale: torch.Tensor | None = None   # (L, P, page, Hkv, 1) f32 if quantized
    v_scale: torch.Tensor | None = None

    @property
    def n_layers(self) -> int:
        return self.k_pages.shape[0]

    @property
    def n_pages(self) -> int:
        return self.k_pages.shape[1]

    @property
    def page_size(self) -> int:
        return self.k_pages.shape[2]

    @property
    def kv_bits(self) -> int:
        return kv_bits_of(self.k_pages)

    def layer(self, i: int):
        """(k_pages, v_pages, k_scale, v_scale) of layer ``i`` — views."""
        q = self.k_scale is not None
        return (self.k_pages[i], self.v_pages[i],
                self.k_scale[i] if q else None, self.v_scale[i] if q else None)


def init_pool(n_layers: int, n_pages: int, page_size: int, n_kv: int,
              head_dim: int, *, kv_bits: int = 0, dtype=torch.bfloat16,
              device="cpu") -> PagedKVPool:
    shape = (n_layers, n_pages, page_size, n_kv)
    if kv_bits:
        kv_scheme(kv_bits)                        # validates the width
        if kv_bits == 4 and head_dim % 2:
            raise ValueError("packed int4 pool needs an even head_dim")
        d, dt = (head_dim // 2, torch.uint8) if kv_bits == 4 else (head_dim, torch.int8)
        return PagedKVPool(
            torch.zeros((*shape, d), dtype=dt, device=device),
            torch.zeros((*shape, d), dtype=dt, device=device),
            torch.ones((*shape, 1), dtype=torch.float32, device=device),
            torch.ones((*shape, 1), dtype=torch.float32, device=device))
    return PagedKVPool(torch.zeros((*shape, head_dim), dtype=dtype, device=device),
                       torch.zeros((*shape, head_dim), dtype=dtype, device=device))


def quant_rows(x: torch.Tensor, kv_bits: int, dtype=torch.bfloat16):
    """New KV rows (…, Hkv, D) → (codes, scale | None) in the pool format."""
    if not kv_bits:
        return x.to(dtype), None
    qt = encode(x, kv_scheme(kv_bits))
    return qt.codes, qt.scale


def write_prompt(pool: PagedKVPool, k: torch.Tensor, v: torch.Tensor,
                 page_ids: torch.Tensor) -> PagedKVPool:
    """Write one sequence's prefill K/V (L, S, Hkv, D) into its pages
    ``page_ids`` (n,) with n = ceil(S / page), in place. Padded tail rows
    (codes 0, scale 1) stay masked by seq_len."""
    L, s, hkv, d = k.shape
    page = pool.page_size
    n = page_ids.shape[0]
    pad = n * page - s
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    k = k.reshape(L, n, page, hkv, d)
    v = v.reshape(L, n, page, hkv, d)
    kc, ks = quant_rows(k, pool.kv_bits, pool.k_pages.dtype)
    vc, vs = quant_rows(v, pool.kv_bits, pool.v_pages.dtype)
    ids = page_ids.to(torch.int64)
    pool.k_pages[:, ids] = kc
    pool.v_pages[:, ids] = vc
    if pool.kv_bits:
        pool.k_scale[:, ids] = ks
        pool.v_scale[:, ids] = vs
    return pool


def append_rows(k_pages, v_pages, k_scale, v_scale, k_new, v_new,
                page_ids, offsets) -> None:
    """Append one decode token's K/V per slot into ONE layer's page planes,
    in place. k/v_new: (B, Hkv, D) pre-quantization; page_ids/offsets (B,)
    — inactive slots target the null page 0 (duplicate writes there are
    harmless: page 0 is never read unmasked)."""
    kv_bits = kv_bits_of(k_pages)
    kc, ks = quant_rows(k_new, kv_bits, k_pages.dtype)
    vc, vs = quant_rows(v_new, kv_bits, v_pages.dtype)
    ids, offs = page_ids.to(torch.int64), offsets.to(torch.int64)
    k_pages[ids, offs] = kc
    v_pages[ids, offs] = vc
    if kv_bits:
        k_scale[ids, offs] = ks
        v_scale[ids, offs] = vs


def write_rows(k_pages, v_pages, k_scale, v_scale, k_new, v_new,
               page_ids, offsets) -> None:
    """Scatter a window of KV rows per slot into ONE layer's page planes, in
    place — the W-wide :func:`append_rows` of the speculative verify window.
    k/v_new: (B, W, Hkv, D) pre-quantization; page_ids/offsets (B, W) — rows
    of inactive slots target the null page 0. The rows are quantized per
    (token, head) like single-row appends, so a row's codes are the same
    whether decode or a verify window wrote it."""
    append_rows(k_pages, v_pages, k_scale, v_scale,
                k_new.flatten(0, 1), v_new.flatten(0, 1),
                page_ids.reshape(-1), offsets.reshape(-1))


def scrub_pages(pool: PagedKVPool, page_ids) -> PagedKVPool:
    """Zero the codes (and set the scales to 1) of ``page_ids`` in every
    layer, in place — quarantine hygiene: a masked row's softmax weight is
    0, but 0 × NaN = NaN through the value product, so a non-finite row
    left in a recycled page would poison its next owner."""
    ids = [int(i) for i in page_ids]
    if not ids:
        return pool
    idx = torch.tensor(ids, dtype=torch.int64, device=pool.k_pages.device)
    pool.k_pages[:, idx] = 0
    pool.v_pages[:, idx] = 0
    if pool.kv_bits:
        pool.k_scale[:, idx] = 1.0
        pool.v_scale[:, idx] = 1.0
    return pool


def pool_nbytes(pool: PagedKVPool, n_pages: int | None = None) -> int:
    """Logical KV HBM bytes of ``n_pages`` pages (default the whole pool)
    with the reference's QTensor.nbytes accounting (unquantized pools count
    16-bit codes and no scale plane)."""
    bits = pool.kv_bits
    P = pool.n_pages if n_pages is None else int(n_pages)

    def plane(codes):
        shape = (codes.shape[0], P, *codes.shape[2:])
        n = math.prod(shape)
        if not bits:
            return n * 2
        if bits == 4:
            n *= 2
        return -(-n * bits // 8) + math.prod(shape[:-1]) * 4

    return int(plane(pool.k_pages) + plane(pool.v_pages))


class PageAllocator:
    """Host-side refcounted free list over pool pages (page 0 is the null
    page, never allocated). A fresh allocator yields pages 1, 2, …; freed
    pages are reused LIFO."""

    def __init__(self, n_pages: int):
        if n_pages < 2:
            raise ValueError("pool needs at least 2 pages (one is the null page)")
        self.n_pages = n_pages
        self._free = list(range(n_pages - 1, 0, -1))
        self._free_set = set(self._free)
        self._rc: dict[int, int] = {}

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_used(self) -> int:
        """Unique pages currently referenced (shared pages count once)."""
        return (self.n_pages - 1) - len(self._free)

    def alloc(self, n: int) -> list[int] | None:
        """Allocate ``n`` pages at refcount 1, or None if not enough free."""
        if n > len(self._free):
            return None
        out = [self._free.pop() for _ in range(n)]
        for i in out:
            self._free_set.discard(i)
            self._rc[i] = 1
        return out

    def incref(self, ids) -> None:
        """Take one more reference on allocated pages (prefix sharing); a
        free page or the null page raises."""
        for i in ids:
            i = int(i)
            if i == 0:
                raise ValueError("page 0 is the null page — never allocated")
            if i in self._free_set or i not in self._rc:
                raise ValueError(f"incref of free page {i}")
            self._rc[i] += 1

    def refcount(self, i: int) -> int:
        return self._rc.get(int(i), 0)

    def used_pages(self) -> list[int]:
        """Sorted ids of the allocated pages (shared pages once)."""
        return sorted(self._rc)

    def free(self, ids) -> None:
        """Drop one reference per page; pages reaching refcount 0 return to
        the free list. Double frees and page 0 raise."""
        for i in ids:
            i = int(i)
            if i == 0:
                raise ValueError("page 0 is the null page — never allocated")
            rc = self._rc.get(i, 0)
            if i in self._free_set or rc <= 0:
                raise ValueError(f"double free of page {i}")
            if rc == 1:
                del self._rc[i]
                self._free.append(i)
                self._free_set.add(i)
            else:
                self._rc[i] = rc - 1

    def check_leaks(self, expected_in_use: int = 0) -> None:
        if self.n_used != expected_in_use:
            raise AssertionError(
                f"page leak: {self.n_used} pages in use, expected {expected_in_use}")


def pages_needed(n_tokens: int, page_size: int) -> int:
    return -(-int(n_tokens) // int(page_size))


__all__ = ["PagedKVPool", "PageAllocator", "init_pool", "write_prompt",
           "append_rows", "write_rows", "quant_rows", "pool_nbytes", "scrub_pages",
           "kv_scheme", "pages_needed"]
