"""Attention (port of ``repro.models.attention``): GQA/MQA causal prefill
attention over query blocks, optionally within a sliding window (q, k and
v may carry a bias), cross attention of a prompt over other tokens (the
vlm family's vision tokens: no causal mask, no RoPE), the single-token
decode projections, the masked one-shot decode softmax of the ``ref``
backend, and the ring-buffer KV cache of the legacy serve loop
(``KVCache``, :func:`init_kv_cache`, :func:`update_kv_cache`,
:func:`prefill_cache_from_kv`, :func:`attention_decode_step`), whose rows
are quantized as the paged pool's (``serve.pages.quant_rows``). With a
window W the cache keeps the prompt's last W rows and decode writes at
``length % rows``, as the reference's; that ring holds the window only for
a prompt longer than W and a multiple of it (ROADMAP C24).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from .layers import Params, apply_rope, dense, init_dense, stack_layers

NEG_INF = -2.0 ** 30  # large-but-finite: keeps fully-masked rows NaN-free


def init_attention(gen, d_model: int, n_heads: int, n_kv_heads: int,
                   head_dim: int, *, qkv_bias: bool = False, lead=(),
                   dtype=torch.bfloat16, device="cpu", weight=stack_layers) -> Params:
    kw = dict(lead=lead, dtype=dtype, device=device, weight=weight)
    return {
        "q": init_dense(gen, d_model, n_heads * head_dim, bias=qkv_bias, **kw),
        "k": init_dense(gen, d_model, n_kv_heads * head_dim, bias=qkv_bias, **kw),
        "v": init_dense(gen, d_model, n_kv_heads * head_dim, bias=qkv_bias, **kw),
        "o": init_dense(gen, n_heads * head_dim, d_model,
                        scale=(n_heads * head_dim) ** -0.5, **kw),
    }


@dataclasses.dataclass(frozen=True)
class AttnSpec:
    n_heads: int
    n_kv_heads: int
    head_dim: int
    window: int = 0            # 0 = full causal
    rope_theta: float = 10_000.0
    q_chunk: int = 1024        # query block length for chunked attention
    softmax_scale: float | None = None

    @property
    def scale(self) -> float:
        return self.softmax_scale or self.head_dim ** -0.5


def _attend_block(q, k, v, scale, mask):
    """Grouped-query attention of one query block without repeating KV.
    q: (B, Cq, H, D); k/v: (B, Skv, G, D); mask (Cq, Skv) or (B, Cq, Skv),
    or None where every query sees every key (cross attention: the
    reference's all-true mask, which changes no score)."""
    b, cq, h, d = q.shape
    g = k.shape[2]
    r = h // g
    qg = q.reshape(b, cq, g, r, d)
    scores = torch.einsum("bqgrd,bkgd->bgrqk", qg.to(torch.float32),
                          k.to(torch.float32)) * scale
    if mask is not None:
        mask_b = mask[:, None, None] if mask.ndim == 3 else mask[None, None, None]
        scores = torch.where(mask_b, scores, torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bgrqk,bkgd->bqgrd",
                       probs.to(v.dtype).to(torch.float32), v.to(torch.float32))
    return out.reshape(b, cq, h, d).to(q.dtype)


def chunked_attention(q, k, v, spec: AttnSpec, *, causal: bool = True) -> torch.Tensor:
    """Causal attention over query blocks of ``spec.q_chunk`` rows.
    q: (B, S, H, D); k/v: (B, S, Hkv, D), post-RoPE. Returns (B, S, H, D).

    With a window W < S each block attends over the reference's span of
    ``min(W + q_chunk, S)`` keys, starting at ``clip(start + q_chunk −
    span, 0, S − span)``, masked to ``q − k < W``: O(S·W) compute and
    memory, never S × S scores. ``causal=False`` (cross attention; k/v
    (B, Skv, Hkv, D) of any Skv, no window) attends each block over every
    key unmasked: (Cq, Skv) scores a block, never (S, Skv)."""
    s = q.shape[1]
    cq = min(spec.q_chunk, s)
    if not causal:
        outs = [_attend_block(q[:, i:i + cq], k, v, spec.scale, None)
                for i in range(0, s, cq)]
        return torch.cat(outs, dim=1) if len(outs) > 1 else outs[0]
    w = spec.window
    span = min(w + cq, s) if 0 < w < s else s
    outs = []
    for start in range(0, s, cq):
        k0 = min(max(start + cq - span, 0), s - span)
        q_pos = torch.arange(start, min(start + cq, s), device=q.device)
        k_pos = torch.arange(k0, k0 + span, device=q.device)
        mask = q_pos[:, None] >= k_pos[None, :]
        if w:
            mask &= q_pos[:, None] - k_pos[None, :] < w
        outs.append(_attend_block(q[:, start:start + cq], k[:, k0:k0 + span],
                                  v[:, k0:k0 + span], spec.scale, mask))
    return torch.cat(outs, dim=1) if len(outs) > 1 else outs[0]


def decode_attention(q, k_cache, v_cache, spec: AttnSpec, *, kv_len) -> torch.Tensor:
    """One-token attention: q (B, 1, H, D) vs cache (B, Smax, Hkv, D) with
    ``kv_len`` (B,) valid rows — the ``ref`` backend's one-shot softmax."""
    b, _, h, d = q.shape
    smax = k_cache.shape[1]
    g = k_cache.shape[2]
    r = h // g
    qg = q.reshape(b, 1, g, r, d)
    scores = torch.einsum("bqgrd,bkgd->bgrqk", qg.to(torch.float32),
                          k_cache.to(torch.float32)) * spec.scale
    pos = torch.arange(smax, device=q.device)
    valid = pos[None, :] < torch.as_tensor(kv_len, device=q.device).reshape(-1, 1)
    scores = torch.where(valid[:, None, None, None, :], scores,
                         torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bgrqk,bkgd->bqgrd",
                       probs.to(v_cache.dtype).to(torch.float32),
                       v_cache.to(torch.float32))
    return out.reshape(b, 1, h, d).to(q.dtype)


def attention_block(p: Params, x: torch.Tensor, spec: AttnSpec, *,
                    positions: torch.Tensor | None = None,
                    kv_tokens: torch.Tensor | None = None,
                    return_kv: bool = False):
    """Causal self-attention of a prompt, or cross attention when
    ``kv_tokens`` (B, Skv, d) is given: q from ``x``, k and v from
    ``kv_tokens``, no causal mask and no RoPE on q or k. ``return_kv=True``
    also returns the K/V (post-RoPE for self attention) — exactly what the
    decode cache stores."""
    b, s, _ = x.shape
    src = x if kv_tokens is None else kv_tokens
    sk = src.shape[1]
    q = dense(p["q"], x).reshape(b, s, spec.n_heads, spec.head_dim)
    k = dense(p["k"], src).reshape(b, sk, spec.n_kv_heads, spec.head_dim)
    v = dense(p["v"], src).reshape(b, sk, spec.n_kv_heads, spec.head_dim)
    if kv_tokens is None:
        pos = positions if positions is not None else torch.arange(s, device=x.device)
        q = apply_rope(q, pos, spec.rope_theta)
        k = apply_rope(k, pos, spec.rope_theta)
    out = chunked_attention(q, k, v, spec, causal=kv_tokens is None)
    y = dense(p["o"], out.reshape(b, s, spec.n_heads * spec.head_dim))
    if return_kv:
        return y, (k, v)
    return y


def decode_qkv(p: Params, x: torch.Tensor, spec: AttnSpec, pos: torch.Tensor):
    """Single-token q/k/v projections + RoPE at absolute positions ``pos``
    (B, 1)."""
    b = x.shape[0]
    q = dense(p["q"], x).reshape(b, 1, spec.n_heads, spec.head_dim)
    k = dense(p["k"], x).reshape(b, 1, spec.n_kv_heads, spec.head_dim)
    v = dense(p["v"], x).reshape(b, 1, spec.n_kv_heads, spec.head_dim)
    q = apply_rope(q, pos, spec.rope_theta)
    k = apply_rope(k, pos, spec.rope_theta)
    return q, k, v


# ---------------------------------------------------------------------------
# The ring-buffer KV cache of the legacy serve loop
# ---------------------------------------------------------------------------

class KVCache(NamedTuple):
    """Ring-buffer KV cache. ``k``/``v``: (B, Smax, Hkv, D) in the compute
    dtype; int8 codes when quantized (scales set); uint8 = packed int4, two
    offset-binary nibbles a byte, (B, Smax, Hkv, D/2). ``length``: filled
    entries (B,) int32, the write cursor."""

    k: torch.Tensor
    v: torch.Tensor
    length: torch.Tensor
    k_scale: torch.Tensor | None = None   # (B, Smax, Hkv, 1) f32 when quantized
    v_scale: torch.Tensor | None = None

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    def materialize(self):
        """(k, v) to attend over: the raw rows, or the codes decoded to bf16
        whatever the compute dtype (as the reference)."""
        if not self.quantized:
            return self.k, self.v
        from repro_torch.quant.qtensor import unpack_int4

        if self.k.dtype == torch.uint8:
            kc, vc = unpack_int4(self.k), unpack_int4(self.v)
        else:
            kc, vc = self.k.to(torch.float32), self.v.to(torch.float32)
        return ((kc * self.k_scale).to(torch.bfloat16),
                (vc * self.v_scale).to(torch.bfloat16))


def init_kv_cache(batch: int, smax: int, n_kv: int, head_dim: int, *,
                  kv_bits: int = 0, dtype=torch.bfloat16, device="cpu") -> KVCache:
    """An empty cache of ``smax`` rows: zero codes, unit scales."""
    shape = (batch, smax, n_kv)
    length = torch.zeros((batch,), dtype=torch.int32, device=device)
    if not kv_bits:
        return KVCache(torch.zeros((*shape, head_dim), dtype=dtype, device=device),
                       torch.zeros((*shape, head_dim), dtype=dtype, device=device), length)
    d, dt = (head_dim // 2, torch.uint8) if kv_bits == 4 else (head_dim, torch.int8)
    return KVCache(torch.zeros((*shape, d), dtype=dt, device=device),
                   torch.zeros((*shape, d), dtype=dt, device=device), length,
                   torch.ones((*shape, 1), dtype=torch.float32, device=device),
                   torch.ones((*shape, 1), dtype=torch.float32, device=device))


def _quant_rows(x: torch.Tensor, like: torch.Tensor):
    """Rows (…, Hkv, D) in the format of cache plane ``like``: the paged
    pool's per-(token, head) nearest quantizer (``serve.pages.quant_rows``),
    so a row has the same codes in either cache."""
    from repro_torch.kernels.ops import kv_bits_of
    from repro_torch.serve.pages import quant_rows

    return quant_rows(x, kv_bits_of(like), like.dtype)


def update_kv_cache(cache: KVCache, k_new: torch.Tensor, v_new: torch.Tensor, *,
                    window: int = 0) -> KVCache:
    """Append one token's K/V (B, 1, Hkv, D) at each sequence's cursor:
    ``length % Smax`` with a sliding ``window`` (a ring), else ``min(length,
    Smax − 1)``. The cache is only read: the new cache's planes are copies,
    so a discarded step leaves the old one as it was."""
    b, smax = cache.k.shape[:2]
    rows = torch.arange(b, device=cache.k.device)
    length = cache.length.to(torch.int64)
    cursor = length % smax if window else torch.clamp(length, max=smax - 1)

    def write(buf, new):
        out = buf.clone()
        out[rows, cursor] = new[:, 0]
        return out

    kc, ks = _quant_rows(k_new, cache.k)
    vc, vs = _quant_rows(v_new, cache.v)
    if cache.quantized:
        return KVCache(write(cache.k, kc), write(cache.v, vc), cache.length + 1,
                       write(cache.k_scale, ks), write(cache.v_scale, vs))
    return KVCache(write(cache.k, kc), write(cache.v, vc), cache.length + 1)


def prefill_cache_from_kv(k: torch.Tensor, v: torch.Tensor, *, window: int = 0,
                          kv_bits: int = 0, pad_to: int = 0) -> KVCache:
    """A prompt's post-RoPE K/V (B, S, Hkv, D) as a decode cache, every row
    quantized at ``kv_bits`` as :func:`update_kv_cache` does. With a
    sliding ``window`` W < S the cache is the last W rows (no padding: the
    ring's order is the identity only where W divides S, ROADMAP C24);
    otherwise ``pad_to`` reserves rows past the prompt for decode to append
    to (zero rows, which quantize to zero codes and unit scales)."""
    from repro_torch.serve.pages import quant_rows

    b, s = k.shape[:2]
    length = torch.full((b,), s, dtype=torch.int32, device=k.device)
    if window and window < s:
        k, v = k[:, -window:], v[:, -window:]
    elif pad_to > s:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad_to - s))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad_to - s))
    kc, ks = quant_rows(k, kv_bits, k.dtype)
    vc, vs = quant_rows(v, kv_bits, v.dtype)
    return KVCache(kc, vc, length, ks, vs)


def attention_decode_step(p: Params, x: torch.Tensor, cache: KVCache,
                          spec: AttnSpec) -> tuple[torch.Tensor, KVCache]:
    """x (B, 1, d): project at position ``length``, append to the cache
    (a ring with ``spec.window``), attend over its first ``min(length,
    rows)`` rows, with no position mask, as the reference. Returns (out
    (B, 1, d), new cache)."""
    b = x.shape[0]
    q, k, v = decode_qkv(p, x, spec, cache.length[:, None])
    cache = update_kv_cache(cache, k, v, window=spec.window)
    kc, vc = cache.materialize()
    kv_len = torch.clamp(cache.length, max=kc.shape[1])
    out = decode_attention(q, kc, vc, spec, kv_len=kv_len)
    return dense(p["o"], out.reshape(b, 1, spec.n_heads * spec.head_dim)), cache
