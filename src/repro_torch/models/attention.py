"""Attention (port of ``repro.models.attention``): GQA/MQA causal prefill
attention over query blocks, the single-token decode projections, and the
masked one-shot decode softmax of the ``ref`` backend.

Sliding windows and cross-attention wait for ROADMAP A6.
"""
from __future__ import annotations

import dataclasses

import torch

from .layers import Params, apply_rope, dense, init_dense

NEG_INF = -2.0 ** 30  # large-but-finite: keeps fully-masked rows NaN-free


def init_attention(gen, d_model: int, n_heads: int, n_kv_heads: int,
                   head_dim: int, *, lead=(), dtype=torch.bfloat16,
                   device="cpu") -> Params:
    kw = dict(lead=lead, dtype=dtype, device=device)
    return {
        "q": init_dense(gen, d_model, n_heads * head_dim, **kw),
        "k": init_dense(gen, d_model, n_kv_heads * head_dim, **kw),
        "v": init_dense(gen, d_model, n_kv_heads * head_dim, **kw),
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
    q: (B, Cq, H, D); k/v: (B, Skv, G, D); mask (Cq, Skv) or (B, Cq, Skv)."""
    b, cq, h, d = q.shape
    g = k.shape[2]
    r = h // g
    qg = q.reshape(b, cq, g, r, d)
    scores = torch.einsum("bqgrd,bkgd->bgrqk", qg.to(torch.float32),
                          k.to(torch.float32)) * scale
    mask_b = mask[:, None, None] if mask.ndim == 3 else mask[None, None, None]
    scores = torch.where(mask_b, scores, torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bgrqk,bkgd->bqgrd",
                       probs.to(v.dtype).to(torch.float32), v.to(torch.float32))
    return out.reshape(b, cq, h, d).to(q.dtype)


def chunked_attention(q, k, v, spec: AttnSpec) -> torch.Tensor:
    """Causal attention over query blocks of ``spec.q_chunk`` rows.
    q: (B, S, H, D); k/v: (B, S, Hkv, D), post-RoPE. Returns (B, S, H, D)."""
    if spec.window:
        raise NotImplementedError("sliding-window attention (ROADMAP A6)")
    s = q.shape[1]
    cq = min(spec.q_chunk, s)
    k_pos = torch.arange(k.shape[1], device=q.device)
    outs = []
    for start in range(0, s, cq):
        q_pos = torch.arange(start, min(start + cq, s), device=q.device)
        mask = q_pos[:, None] >= k_pos[None, :]
        outs.append(_attend_block(q[:, start:start + cq], k, v, spec.scale, mask))
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
                    return_kv: bool = False):
    """Causal self-attention of a prompt. ``return_kv=True`` also returns
    the post-RoPE K/V — exactly what the decode cache stores."""
    b, s, _ = x.shape
    q = dense(p["q"], x).reshape(b, s, spec.n_heads, spec.head_dim)
    k = dense(p["k"], x).reshape(b, s, spec.n_kv_heads, spec.head_dim)
    v = dense(p["v"], x).reshape(b, s, spec.n_kv_heads, spec.head_dim)
    pos = positions if positions is not None else torch.arange(s, device=x.device)
    q = apply_rope(q, pos, spec.rope_theta)
    k = apply_rope(k, pos, spec.rope_theta)
    out = chunked_attention(q, k, v, spec)
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
