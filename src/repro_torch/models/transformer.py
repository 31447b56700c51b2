"""Model assembly for the dense family (port of
``repro.models.transformer``): ``ModelConfig``, ``init_params``, the
training ``forward`` and ``loss_fn``, ``prefill`` and the single-token
decode block.

``lax.scan`` over stacked layers becomes a Python loop over per-layer views
of the same stacked tensors; the training forward rematerializes each layer
in the backward (``cfg.remat``, ``torch.utils.checkpoint``) as the
reference's ``jax.checkpoint`` does. MoE, SSM, hybrid and VLM families wait
for ROADMAP A6.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.quant import PrecisionPlan

from . import attention as attn
from .layers import (Params, embed, init_embedding, init_mlp, init_rmsnorm,
                     layer_view, mlp, rmsnorm, unembed, unstack_layers)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # only 'dense' is ported
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    window: int = 0
    qkv_bias: bool = False
    mlp_act: str = "silu"
    rope_theta: float = 10_000.0
    attn_shard: str = "heads"
    q_chunk: int = 1024
    dtype: Any = torch.bfloat16
    logit_chunk: int = 512
    tie_embeddings: bool = True
    precision: PrecisionPlan = PrecisionPlan()
    remat: bool = True

    @property
    def vocab_padded(self) -> int:
        """Embedding vocab padded to 256 (padded logits are masked)."""
        return ((self.vocab_size + 255) // 256) * 256

    @property
    def attn_spec(self) -> attn.AttnSpec:
        return attn.AttnSpec(self.n_heads, self.n_kv_heads, self.head_dim,
                             window=self.window, rope_theta=self.rope_theta,
                             q_chunk=self.q_chunk)


def _check_dense(cfg: ModelConfig):
    if cfg.family != "dense" or cfg.window or cfg.qkv_bias or not cfg.tie_embeddings:
        raise NotImplementedError(
            f"{cfg.name}: only the dense family with tied embeddings, no "
            "window and no qkv bias is ported (ROADMAP A6)")


def init_params(cfg: ModelConfig, *, seed: int = 0, device=None) -> Params:
    """Random weights with the reference's distributions, drawn from an
    explicit ``torch.Generator`` on ``device`` (default ``cuda``; the numbers
    differ from ``jax.random`` — bridge JAX params with ``interop`` to
    compare). Layer weights are stacked (L, …)."""
    from repro_torch import resolve_device

    _check_dense(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    L, dt = cfg.n_layers, cfg.dtype
    kw = dict(lead=(L,), dtype=dt, device=dev)
    return {
        "embed": init_embedding(gen, cfg.vocab_padded, cfg.d_model, dtype=dt,
                                device=dev),
        "final_norm": init_rmsnorm(cfg.d_model, dtype=dt, device=dev),
        "layers": {
            "ln1": init_rmsnorm(cfg.d_model, **kw),
            "attn": attn.init_attention(gen, cfg.d_model, cfg.n_heads,
                                        cfg.n_kv_heads, cfg.head_dim, **kw),
            "ln2": init_rmsnorm(cfg.d_model, **kw),
            "mlp": init_mlp(gen, cfg.d_model, cfg.d_ff, **kw),
        },
    }


def layer_views(params: Params, cfg: ModelConfig) -> list[Params]:
    """Per-layer views of the stacked layer params (build once, reuse)."""
    return [layer_view(params["layers"], i) for i in range(cfg.n_layers)]


def _readout(params: Params, cfg: ModelConfig, h: torch.Tensor) -> torch.Tensor:
    logits = unembed(params["embed"], h)
    if cfg.vocab_padded != cfg.vocab_size:
        # mask the padding tail so argmax never selects a pad id
        pad = torch.arange(cfg.vocab_padded, device=h.device) >= cfg.vocab_size
        logits = torch.where(pad, torch.full_like(logits, -1e30), logits)
    return logits


def final_logits(params: Params, cfg: ModelConfig, h: torch.Tensor) -> torch.Tensor:
    """Final norm + tied readout → (…, V) f32 logits at every position."""
    return _readout(params, cfg, rmsnorm(params["final_norm"], h))


def _layer_fwd(cfg: ModelConfig, layer: Params, x: torch.Tensor) -> torch.Tensor:
    h = x + attn.attention_block(layer["attn"], rmsnorm(layer["ln1"], x), cfg.attn_spec)
    return h + mlp(layer["mlp"], rmsnorm(layer["ln2"], h), cfg.mlp_act)


def forward(params: Params, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """tokens (B, S) → final-normed hidden states (B, S, d), differentiable
    (weights may be dense, QTensor or ShipWeight leaves). Each layer is
    recomputed in the backward when ``cfg.remat`` (the saved state is one
    (B, S, d) carry per layer)."""
    _check_dense(cfg)
    if cfg.precision.act_bits:
        raise NotImplementedError(
            "act_bits: the reference does not wire act_bits into its model "
            "(a plan with it trains as one without it); the port raises "
            "rather than ignore a requested channel (ROADMAP C9; the "
            "activation channel itself is precision.act_quant)")
    x = embed(params["embed"], tokens, cfg.dtype).to(cfg.dtype)
    for layer in unstack_layers(params["layers"], cfg.n_layers):
        if cfg.remat:
            x = checkpoint(_layer_fwd, cfg, layer, x, use_reentrant=False)
        else:
            x = _layer_fwd(cfg, layer, x)
    return rmsnorm(params["final_norm"], x)


def loss_fn(params: Params, tokens: torch.Tensor, targets: torch.Tensor,
            cfg: ModelConfig) -> torch.Tensor:
    """Mean next-token cross-entropy, in sequence chunks of
    ``cfg.logit_chunk`` so the (B, S, V) f32 logits never exist at once
    (the reference's chunking: a length that the chunk does not divide is
    one chunk). The gold logit is read with a gather — the same value as the
    reference's masked sum, which only avoids an all-gather across a
    vocab-sharded mesh."""
    h = forward(params, tokens, cfg)
    b, s, _ = h.shape
    cs = min(cfg.logit_chunk, s)
    if s % cs:
        cs = s
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for start in range(0, s, cs):
        logits = _readout(params, cfg, h[:, start:start + cs])
        logz = torch.logsumexp(logits, dim=-1)
        tc = targets[:, start:start + cs].to(torch.int64)
        gold = torch.gather(logits, -1, tc[..., None])[..., 0]
        total = total + torch.sum(logz - gold)
    return total / (b * s)


def prefill(params: Params, tokens: torch.Tensor, cfg: ModelConfig,
            last_pos: int | None = None, layers: list | None = None):
    """Process a prompt (B, S): returns (logits (B, V) at ``last_pos``
    (default the last position), (k, v)) with the raw post-RoPE K/V of every
    layer stacked as (L, B, S, Hkv, D) — what the paged pool quantizes.
    The serving engine right-pads prompts to a page multiple; causality
    keeps positions ≤ last_pos unaffected by the padding."""
    _check_dense(cfg)
    if cfg.precision.kv_bits:
        raise NotImplementedError(
            "prefill fills raw K/V only (kv_bits=0); the paged pool "
            "quantizes them (ring-cache prefill: ROADMAP A6)")
    layers = layers if layers is not None else layer_views(params, cfg)
    x = embed(params["embed"], tokens, cfg.dtype).to(cfg.dtype)
    ks, vs = [], []
    for layer in layers:
        a_out, (k, v) = attn.attention_block(
            layer["attn"], rmsnorm(layer["ln1"], x), cfg.attn_spec, return_kv=True)
        h = x + a_out
        x = h + mlp(layer["mlp"], rmsnorm(layer["ln2"], h), cfg.mlp_act)
        ks.append(k)
        vs.append(v)
    pos = x.shape[1] - 1 if last_pos is None else int(last_pos)
    logits = final_logits(params, cfg, x[:, pos:pos + 1])[:, 0]
    return logits, (torch.stack(ks), torch.stack(vs))


def decode_layer_block(cfg: ModelConfig, layer: Params, h: torch.Tensor,
                       attend) -> torch.Tensor:
    """One decoder layer for single-token decode: pre-norm attention
    residual (``attend(z)`` owns the cache update), then pre-norm MLP."""
    h = h + attend(rmsnorm(layer["ln1"], h))
    return h + mlp(layer["mlp"], rmsnorm(layer["ln2"], h), cfg.mlp_act)
