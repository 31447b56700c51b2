"""Model assembly for the dense and ssm families (port of
``repro.models.transformer``): ``ModelConfig``, ``init_params``, the
training ``forward`` and ``loss_fn``, ``prefill`` (the paged engine's: raw
K/V out), the single-token decode block of the dense family, and the legacy
serve loop's ``DecodeState``, ``prefill_state``, ``init_decode_state`` and
``decode_step``: the dense family's ring-buffer KV cache, the ssm family's
O(1) recurrent (conv, ssm) cache.

``lax.scan`` over stacked layers becomes a Python loop over per-layer views
of the same stacked tensors; the training forward rematerializes each layer
in the backward (``cfg.remat``, ``torch.utils.checkpoint``) as the
reference's ``jax.checkpoint`` does. MoE, hybrid, VLM and audio families,
and sliding windows, wait for ROADMAP A6.
"""
from __future__ import annotations

import dataclasses
import typing
from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.quant import PrecisionPlan

from . import attention as attn
from . import ssm as ssm_mod
from .layers import (Params, embed, init_embedding, init_mlp, init_rmsnorm,
                     layer_view, mlp, rmsnorm, unembed, unstack_layers)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # 'dense' or 'ssm' in the port
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
    # ssm
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssd_chunk: int = 256
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

    @property
    def ssm_spec(self) -> ssm_mod.SSMSpec:
        return ssm_mod.SSMSpec(self.d_model, d_state=self.ssm_state,
                               head_dim=self.ssm_head_dim, chunk=self.ssd_chunk)


def _check_family(cfg: ModelConfig):
    """The ported families: dense (tied embeddings, no window; q, k and v
    may carry a bias) and ssm (tied embeddings). An ssm config with
    ``kv_bits`` raises: it has no KV cache to quantize (the reference
    ignores the request; ROADMAP C18)."""
    if cfg.family == "ssm" and cfg.tie_embeddings:
        if cfg.precision.kv_bits:
            raise ValueError(
                f"{cfg.name}: kv_bits={cfg.precision.kv_bits} on an ssm model, "
                "which has no KV cache to quantize (the reference ignores it; "
                "ROADMAP C18)")
        return
    if cfg.family != "dense" or cfg.window or not cfg.tie_embeddings:
        raise NotImplementedError(
            f"{cfg.name}: only the dense family with tied embeddings and no "
            "window, and the ssm family, are ported (ROADMAP A6)")


def init_params(cfg: ModelConfig, *, seed: int = 0, device=None) -> Params:
    """Random weights with the reference's distributions, drawn from an
    explicit ``torch.Generator`` on ``device`` (default ``cuda``; the numbers
    differ from ``jax.random`` — bridge JAX params with ``interop`` to
    compare). Layer weights are stacked (L, …)."""
    from repro_torch import resolve_device

    _check_family(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    L, dt = cfg.n_layers, cfg.dtype
    kw = dict(lead=(L,), dtype=dt, device=dev)
    params = {
        "embed": init_embedding(gen, cfg.vocab_padded, cfg.d_model, dtype=dt,
                                device=dev),
        "final_norm": init_rmsnorm(cfg.d_model, dtype=dt, device=dev),
    }
    if cfg.family == "ssm":
        params["layers"] = {"norm": init_rmsnorm(cfg.d_model, **kw),
                            "mamba": ssm_mod.init_mamba2(gen, cfg.ssm_spec, **kw)}
        return params
    return {
        **params,
        "layers": {
            "ln1": init_rmsnorm(cfg.d_model, **kw),
            "attn": attn.init_attention(gen, cfg.d_model, cfg.n_heads,
                                        cfg.n_kv_heads, cfg.head_dim,
                                        qkv_bias=cfg.qkv_bias, **kw),
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
    if cfg.family == "ssm":
        return x + ssm_mod.mamba2_forward(layer["mamba"], rmsnorm(layer["norm"], x),
                                          cfg.ssm_spec)
    h = x + attn.attention_block(layer["attn"], rmsnorm(layer["ln1"], x), cfg.attn_spec)
    return h + mlp(layer["mlp"], rmsnorm(layer["ln2"], h), cfg.mlp_act)


def forward(params: Params, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """tokens (B, S) → final-normed hidden states (B, S, d), differentiable
    (weights may be dense, QTensor or ShipWeight leaves). Each layer is
    recomputed in the backward when ``cfg.remat`` (the saved state is one
    (B, S, d) carry per layer). The ssm family runs forward only: the SSD
    kernel has no backward, so on the card its gradient raises (ROADMAP
    A6, ssm training); the plain scan on the CPU is differentiable."""
    _check_family(cfg)
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
    keeps positions ≤ last_pos unaffected by the padding. The legacy loop's
    ring cache comes from :func:`prefill_state`.

    The ssm family returns (logits, :class:`DecodeState`) instead: every
    layer's ``MambaCache`` stacked (conv (L, B, K−1, conv_dim), ssm (L, B,
    H, P, N) f32), ``step`` the prompt length — decode continues from it."""
    _check_family(cfg)
    if cfg.family == "ssm":
        return _prefill_ssm(params, tokens, cfg, last_pos, layers)
    if cfg.precision.kv_bits:
        raise NotImplementedError(
            "prefill fills raw K/V only (kv_bits=0); the paged pool "
            "quantizes them (the ring cache's prefill is prefill_state)")
    logits, ks, vs = _prefill_dense(params, tokens, cfg, last_pos, layers)
    return logits, (torch.stack(ks), torch.stack(vs))


def _prefill_dense(params, tokens, cfg, last_pos, layers):
    """The dense prompt forward: (logits at ``last_pos``, every layer's
    post-RoPE K, every layer's V)."""
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
    return final_logits(params, cfg, x[:, pos:pos + 1])[:, 0], ks, vs


def prefill_state(params: Params, tokens: torch.Tensor, cfg: ModelConfig, *,
                  pad_to: int = 0, last_pos: int | None = None,
                  layers: list | None = None):
    """Prefill a prompt (B, S) for the legacy serve loop: (logits (B, V) at
    ``last_pos``, :class:`DecodeState`) as the reference's ``prefill``
    returns them. The dense family's state holds one ring-buffer
    :class:`~repro_torch.models.attention.KVCache` of stacked (L, …)
    planes, sized ``max(S, pad_to)`` rows and quantized at
    ``cfg.precision.kv_bits``; the ssm family's is :func:`prefill`'s
    (``pad_to`` unused)."""
    _check_family(cfg)
    if cfg.family == "ssm":
        return _prefill_ssm(params, tokens, cfg, last_pos, layers)
    logits, ks, vs = _prefill_dense(params, tokens, cfg, last_pos, layers)
    caches = [attn.prefill_cache_from_kv(k, v, kv_bits=cfg.precision.kv_bits,
                                         pad_to=pad_to) for k, v in zip(ks, vs)]
    return logits, DecodeState(_stack_kv(caches), step=tokens.shape[1])


def decode_layer_block(cfg: ModelConfig, layer: Params, h: torch.Tensor,
                       attend) -> torch.Tensor:
    """One decoder layer for single-token decode: pre-norm attention
    residual (``attend(z)`` owns the cache update), then pre-norm MLP."""
    h = h + attend(rmsnorm(layer["ln1"], h))
    return h + mlp(layer["mlp"], rmsnorm(layer["ln2"], h), cfg.mlp_act)


# ---------------------------------------------------------------------------
# The ssm family's recurrent decode (the legacy serve loop's cache)
# ---------------------------------------------------------------------------

class DecodeState(typing.NamedTuple):
    """Per-layer caches + step counter. ``layers`` is one cache of stacked
    (L, …) tensors: a ``KVCache`` (dense) or a ``MambaCache`` (ssm)."""

    layers: Any
    shared: Any = None
    cross: Any = None
    step: Any = None


def _stack_caches(caches) -> ssm_mod.MambaCache:
    return ssm_mod.MambaCache(conv=torch.stack([c.conv for c in caches]),
                              ssm=torch.stack([c.ssm for c in caches]))


def _stack_kv(caches) -> attn.KVCache:
    return attn.KVCache(*[None if t[0] is None else torch.stack(t)
                          for t in zip(*caches)])


def _kv_layer(cache: attn.KVCache, i: int) -> attn.KVCache:
    return attn.KVCache(*[None if t is None else t[i] for t in cache])


def _prefill_ssm(params, tokens, cfg, last_pos, layers):
    layers = layers if layers is not None else layer_views(params, cfg)
    x = embed(params["embed"], tokens, cfg.dtype).to(cfg.dtype)
    caches = []
    for layer in layers:
        out, mc = ssm_mod.mamba2_forward(layer["mamba"], rmsnorm(layer["norm"], x),
                                         cfg.ssm_spec, return_state=True)
        x = x + out
        caches.append(mc)
    pos = x.shape[1] - 1 if last_pos is None else int(last_pos)
    logits = final_logits(params, cfg, x[:, pos:pos + 1])[:, 0]
    return logits, DecodeState(_stack_caches(caches), step=tokens.shape[1])


def init_decode_state(cfg: ModelConfig, batch: int, smax: int, *,
                      device=None) -> DecodeState:
    """Zero caches for ``batch`` sequences on ``device`` (default ``cuda``).
    The dense family's is an empty ring-buffer KV cache of ``smax`` rows a
    layer at ``cfg.precision.kv_bits``. The ssm family's cache is O(1) in
    the sequence (``smax`` is unused); its conv cache is bf16 whatever the
    compute dtype, as in the reference."""
    from repro_torch import resolve_device

    _check_family(cfg)
    dev = resolve_device(device)
    if cfg.family == "dense":
        one = attn.init_kv_cache(batch, smax, cfg.n_kv_heads, cfg.head_dim,
                                 kv_bits=cfg.precision.kv_bits, dtype=cfg.dtype,
                                 device=dev)
        return DecodeState(_stack_kv([one] * cfg.n_layers), step=0)
    one = ssm_mod.init_mamba_cache(batch, cfg.ssm_spec, device=dev)
    return DecodeState(ssm_mod.MambaCache(
        conv=one.conv.expand(cfg.n_layers, *one.conv.shape).clone(),
        ssm=one.ssm.expand(cfg.n_layers, *one.ssm.shape).clone()), step=0)


def decode_step(params: Params, state: DecodeState, tokens: torch.Tensor,
                cfg: ModelConfig):
    """One serve step of the legacy loop: tokens (B, 1) → (logits (B, 1, V)
    f32 with the vocab pad masked, new state). ``state`` is only read: the
    new state's tensors are new, so a discarded step leaves it as it was.
    The dense family appends each layer's K/V row to its ring cache and
    attends in plain PyTorch (``attention_decode_step``), as the
    reference does."""
    _check_family(cfg)
    x = embed(params["embed"], tokens, cfg.dtype).to(cfg.dtype)
    caches = []
    if cfg.family == "dense":
        for i, layer in enumerate(layer_views(params, cfg)):
            def attend(z, layer=layer, i=i):
                out, cache = attn.attention_decode_step(
                    layer["attn"], z, _kv_layer(state.layers, i), cfg.attn_spec)
                caches.append(cache)
                return out

            x = decode_layer_block(cfg, layer, x, attend)
        return final_logits(params, cfg, x), DecodeState(_stack_kv(caches),
                                                         step=state.step + 1)
    for i, layer in enumerate(layer_views(params, cfg)):
        cache = ssm_mod.MambaCache(state.layers.conv[i], state.layers.ssm[i])
        y, new_cache = ssm_mod.mamba2_decode_step(
            layer["mamba"], rmsnorm(layer["norm"], x), cache, cfg.ssm_spec)
        x = x + y
        caches.append(new_cache)
    return final_logits(params, cfg, x), DecodeState(_stack_caches(caches),
                                                     step=state.step + 1)
