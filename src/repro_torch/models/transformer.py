"""Model assembly for every family of the reference — dense, moe, ssm,
hybrid, vlm and audio (port of ``repro.models.transformer``):
``ModelConfig``, ``init_params``, the training ``forward`` and
``loss_fn``, ``prefill`` (the paged engine's: raw K/V out), the
single-token decode block of the attention families, and the legacy serve
loop's ``DecodeState``, ``prefill_state``, ``init_decode_state`` and
``decode_step``: the dense, moe, audio and vlm families' ring-buffer KV
cache, the ssm family's O(1) recurrent (conv, ssm) cache, and the hybrid's
both — Mamba2 layers with one shared attention block after every
``shared_attn_every`` of them, each application of the block on a ring
cache of its own. The moe family is the dense layer with its MLP replaced
by the MoE block (``models/moe``); the audio family is the dense layer
(musicgen-medium's gelu MLP); the vlm family is the dense stack with a
cross-attention block (``ln1`` and ``attn``, no MLP) over the vision
tokens after every ``cross_attn_every`` layers, whose K/V over the vision
tokens are cached raw in ``cfg.dtype`` (``DecodeState.cross``) whatever
``kv_bits``.

``lax.scan`` over stacked layers becomes a Python loop over per-layer views
of the same stacked tensors; the training forward rematerializes each layer
in the backward (``cfg.remat``, ``torch.utils.checkpoint``) as the
reference's ``jax.checkpoint`` does. The reference stacks a vlm model's
self layers (n_cross, per, …) under ``blocks.self`` and its cross blocks
under ``blocks.cross``; the port keeps the self layers as one (L, …) stack
in ``params["layers"]`` (block i, layer j is layer i · per + j) and the
cross blocks as one (n_cross, …) stack in ``params["cross"]``
(``interop.params_from_numpy`` reshapes a reference tree). A window on the
hybrid waits for ROADMAP A6.
"""
from __future__ import annotations

import dataclasses
import typing
from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.quant import PrecisionPlan

from . import attention as attn
from . import moe as moe_mod
from . import ssm as ssm_mod
from .layers import (Params, dense, embed, init_embedding, init_mlp, init_rmsnorm,
                     layer_view, mlp, rmsnorm, stack_layers, unembed, unstack_layers)

# the families whose every layer is a pre-norm attention block (their
# legacy loop's ring KV cache, ``init_params``' layer stack)
ATTN_FAMILIES = ("dense", "moe", "audio", "vlm")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int                   # moe: each expert's
    vocab_size: int
    # moe
    n_experts: int = 0
    top_k: int = 0
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
    shared_attn_every: int = 0  # hybrid: the shared attention block after every k layers
    # vlm: a cross-attention block over n_vis_tokens vision tokens after
    # every cross_attn_every layers (the vision tower is a stub)
    cross_attn_every: int = 0
    n_vis_tokens: int = 0
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
    def moe_spec(self) -> moe_mod.MoESpec:
        return moe_mod.MoESpec(self.n_experts, self.top_k, self.d_model, self.d_ff,
                               act=self.mlp_act)

    @property
    def ssm_spec(self) -> ssm_mod.SSMSpec:
        return ssm_mod.SSMSpec(self.d_model, d_state=self.ssm_state,
                               head_dim=self.ssm_head_dim, chunk=self.ssd_chunk)


def _check_family(cfg: ModelConfig):
    """The ported families, each with tied embeddings: dense, audio, vlm and
    moe (a sliding ``window`` or none; q, k and v may carry a bias), ssm
    and hybrid (no window). An ssm config with ``kv_bits`` raises: it has
    no KV cache to quantize (the reference ignores the request; ROADMAP
    C18). A hybrid config whose ``shared_attn_every``, or a vlm config
    whose ``cross_attn_every``, is not a positive divisor of ``n_layers``
    raises (the reference dies in a reshape or a division by zero), and so
    does an moe config that routes to fewer than one expert or to more
    experts than it has."""
    if cfg.family == "ssm" and cfg.tie_embeddings:
        if cfg.precision.kv_bits:
            raise ValueError(
                f"{cfg.name}: kv_bits={cfg.precision.kv_bits} on an ssm model, "
                "which has no KV cache to quantize (the reference ignores it; "
                "ROADMAP C18)")
        return
    if cfg.family == "hybrid" and cfg.tie_embeddings and not cfg.window:
        k = cfg.shared_attn_every
        if k <= 0 or cfg.n_layers % k:
            raise ValueError(
                f"{cfg.name}: a hybrid model applies its shared attention block "
                f"after every shared_attn_every layers, which must divide "
                f"n_layers={cfg.n_layers}; got shared_attn_every={k}")
        return
    if cfg.family == "moe" and cfg.tie_embeddings:
        if cfg.top_k < 1 or cfg.n_experts < cfg.top_k:
            raise ValueError(
                f"{cfg.name}: an moe model routes each token to top_k >= 1 of its "
                f"n_experts experts; got n_experts={cfg.n_experts}, top_k={cfg.top_k}")
        return
    if cfg.family == "vlm" and cfg.tie_embeddings:
        k = cfg.cross_attn_every
        if k <= 0 or cfg.n_layers % k:
            raise ValueError(
                f"{cfg.name}: a vlm model applies a cross-attention block after "
                f"every cross_attn_every layers, which must divide "
                f"n_layers={cfg.n_layers}; got cross_attn_every={k}")
        return
    if cfg.family not in ("dense", "audio") or not cfg.tie_embeddings:
        raise NotImplementedError(
            f"{cfg.name}: only the families with tied embeddings, and the "
            "hybrid family without a window, are ported (ROADMAP A6)")


def _shared_after(cfg: ModelConfig, i: int) -> bool:
    """Whether the hybrid's shared attention block runs after layer ``i``."""
    return cfg.family == "hybrid" and (i + 1) % cfg.shared_attn_every == 0


def _cross_after(cfg: ModelConfig, i: int) -> bool:
    """Whether a vlm model's cross-attention block runs after layer ``i``."""
    return cfg.family == "vlm" and (i + 1) % cfg.cross_attn_every == 0


def _n_cross(cfg: ModelConfig) -> int:
    return cfg.n_layers // cfg.cross_attn_every


def _init_attn_block(gen, cfg: ModelConfig, weight=stack_layers, cross: bool = False,
                     **kw) -> Params:
    """A pre-norm attention + MLP block (``ln1``, ``attn``, ``ln2``,
    ``mlp``): a dense layer, stacked with ``lead=(L,)``, or the hybrid's
    shared block; an moe layer has the MoE block ``moe`` in place of
    ``mlp``; a vlm model's ``cross`` block has ``ln1`` and ``attn``
    only."""
    blk = {
        "ln1": init_rmsnorm(cfg.d_model, **kw),
        "attn": attn.init_attention(gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                                    cfg.head_dim, qkv_bias=cfg.qkv_bias, weight=weight,
                                    **kw),
    }
    if cross:
        return blk
    blk["ln2"] = init_rmsnorm(cfg.d_model, **kw)
    if cfg.family == "moe":
        blk["moe"] = moe_mod.init_moe(gen, cfg.moe_spec, weight=weight, **kw)
    else:
        blk["mlp"] = init_mlp(gen, cfg.d_model, cfg.d_ff, weight=weight, **kw)
    return blk


def init_params(cfg: ModelConfig, *, seed: int = 0, device=None,
                weight=stack_layers) -> Params:
    """Random weights with the reference's distributions, drawn from an
    explicit ``torch.Generator`` on ``device`` (default ``cuda``; the numbers
    differ from ``jax.random`` — bridge JAX params with ``interop`` to
    compare). Layer weights are stacked (L, …); the hybrid's shared block
    ``shared_attn`` is one unstacked block; a vlm model's cross blocks are
    stacked (n_cross, …) in ``cross``. Each matmul weight is drawn a
    layer at a time and stored by ``weight(layers, lead)`` — by default
    stacked in ``cfg.dtype``; ``precision.qat.quantizing_store`` encodes
    each layer as it is drawn, so the compute-dtype tree never exists
    whole."""
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
    if cfg.family in ATTN_FAMILIES:
        params["layers"] = _init_attn_block(gen, cfg, weight, **kw)
        if cfg.family == "vlm":
            params["cross"] = _init_attn_block(gen, cfg, weight, cross=True,
                                               lead=(_n_cross(cfg),), dtype=dt, device=dev)
        return params
    params["layers"] = {"norm": init_rmsnorm(cfg.d_model, **kw),
                        "mamba": ssm_mod.init_mamba2(gen, cfg.ssm_spec, weight=weight,
                                                     **kw)}
    if cfg.family == "hybrid":
        params["shared_attn"] = _init_attn_block(gen, cfg, weight, dtype=dt, device=dev)
    return params


def layer_views(params: Params, cfg: ModelConfig) -> list[Params]:
    """Per-layer views of the stacked layer params (build once, reuse)."""
    return [layer_view(params["layers"], i) for i in range(cfg.n_layers)]


def cross_views(params: Params, cfg: ModelConfig) -> list[Params]:
    """Per-block views of a vlm model's stacked cross blocks (none for the
    other families)."""
    if cfg.family != "vlm":
        return []
    return [layer_view(params["cross"], i) for i in range(_n_cross(cfg))]


def _vision(cfg: ModelConfig, vision_tokens) -> torch.Tensor | None:
    """A vlm model's vision tokens (B, n_vis, d) in ``cfg.dtype``, as the
    reference casts them; None for the other families."""
    if cfg.family != "vlm":
        return None
    if vision_tokens is None:
        raise ValueError(f"{cfg.name}: a vlm model attends its vision tokens: pass "
                         "vision_tokens (B, n_vis_tokens, d_model)")
    return vision_tokens.to(cfg.dtype)


def _cross_block_kv(cfg: ModelConfig, blk: Params, x: torch.Tensor, vis: torch.Tensor):
    """A prompt through a vlm cross block (pre-norm cross attention over the
    vision tokens, no MLP): (out, K, V) of the vision tokens."""
    a_out, (k, v) = attn.attention_block(blk["attn"], rmsnorm(blk["ln1"], x),
                                         cfg.attn_spec, kv_tokens=vis, return_kv=True)
    return x + a_out, k, v


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


def _ffn(cfg: ModelConfig, blk: Params, z: torch.Tensor) -> torch.Tensor:
    """The block's feed-forward half on the normed stream: the MoE block of
    an moe layer, else the gated MLP."""
    if cfg.family == "moe":
        return moe_mod.moe_block(blk["moe"], z, cfg.moe_spec)
    return mlp(blk["mlp"], z, cfg.mlp_act)


def _attn_block_kv(cfg: ModelConfig, blk: Params, x: torch.Tensor):
    """A prompt through a pre-norm attention + MLP (or MoE) block: (out,
    post-RoPE K, V)."""
    a_out, (k, v) = attn.attention_block(blk["attn"], rmsnorm(blk["ln1"], x),
                                         cfg.attn_spec, return_kv=True)
    h = x + a_out
    return h + _ffn(cfg, blk, rmsnorm(blk["ln2"], h)), k, v


def _layer_fwd(cfg: ModelConfig, layer: Params, x: torch.Tensor) -> torch.Tensor:
    if cfg.family in ("ssm", "hybrid"):
        return x + ssm_mod.mamba2_forward(layer["mamba"], rmsnorm(layer["norm"], x),
                                          cfg.ssm_spec)
    return _attn_block_kv(cfg, layer, x)[0]


def forward(params: Params, tokens: torch.Tensor, cfg: ModelConfig,
            vision_tokens: torch.Tensor | None = None) -> torch.Tensor:
    """tokens (B, S) → final-normed hidden states (B, S, d), differentiable
    (weights may be dense, QTensor or ShipWeight leaves). Each layer is
    recomputed in the backward when ``cfg.remat`` (the saved state is one
    (B, S, d) carry per layer). The ssm family runs forward only: the SSD
    kernel has no backward, so on the card its gradient raises (ROADMAP
    A6, ssm training); the plain scan on the CPU is differentiable. The
    hybrid runs its shared attention block after every
    ``shared_attn_every`` Mamba2 layers, and a vlm model a cross block
    over ``vision_tokens`` (B, n_vis, d) after every ``cross_attn_every``
    layers, neither rematerialized."""
    _check_family(cfg)
    if cfg.precision.act_bits:
        raise NotImplementedError(
            "act_bits: the reference does not wire act_bits into its model "
            "(a plan with it trains as one without it); the port raises "
            "rather than ignore a requested channel (ROADMAP C9; the "
            "activation channel itself is precision.act_quant)")
    vis = _vision(cfg, vision_tokens)
    cross = unstack_layers(params["cross"], _n_cross(cfg)) if vis is not None else []
    x = embed(params["embed"], tokens, cfg.dtype).to(cfg.dtype)
    for i, layer in enumerate(unstack_layers(params["layers"], cfg.n_layers)):
        if cfg.remat:
            x = checkpoint(_layer_fwd, cfg, layer, x, use_reentrant=False)
        else:
            x = _layer_fwd(cfg, layer, x)
        if _shared_after(cfg, i):
            x = _attn_block_kv(cfg, params["shared_attn"], x)[0]
        if _cross_after(cfg, i):
            x = _cross_block_kv(cfg, cross[i // cfg.cross_attn_every], x, vis)[0]
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
            last_pos: int | None = None, layers: list | None = None,
            vision_tokens: torch.Tensor | None = None):
    """Process a prompt (B, S): returns (logits (B, V) at ``last_pos``
    (default the last position), (k, v)) with the raw post-RoPE K/V of every
    layer stacked as (L, B, S, Hkv, D) — what the paged pool quantizes.
    The serving engine right-pads prompts to a page multiple; causality
    keeps positions ≤ last_pos unaffected by the padding. The legacy loop's
    ring cache comes from :func:`prefill_state`.

    The ssm and hybrid families return (logits, :class:`DecodeState`)
    instead: every layer's ``MambaCache`` stacked (conv (L, B, K−1,
    conv_dim), ssm (L, B, H, P, N) f32), ``step`` the prompt length —
    decode continues from it; the hybrid's ``shared`` holds one ring KV
    cache of S rows per application of its shared block, stacked, at
    ``cfg.precision.kv_bits`` (:func:`prefill_state` reserves rows for
    decode to append to). So does the vlm family, whose caches the paged
    pool does not take either: :func:`prefill_state`'s of S rows."""
    _check_family(cfg)
    if cfg.family in ("ssm", "hybrid"):
        return _prefill_ssm(params, tokens, cfg, last_pos, layers)
    if cfg.family == "vlm":
        return prefill_state(params, tokens, cfg, vision_tokens=vision_tokens,
                             last_pos=last_pos, layers=layers)
    if cfg.precision.kv_bits:
        raise NotImplementedError(
            "prefill fills raw K/V only (kv_bits=0); the paged pool "
            "quantizes them (the ring cache's prefill is prefill_state)")
    logits, ks, vs, _ = _prefill_dense(params, tokens, cfg, last_pos, layers)
    return logits, (torch.stack(ks), torch.stack(vs))


def _prefill_dense(params, tokens, cfg, last_pos, layers, vision_tokens=None):
    """The attention stack's prompt forward: (logits at ``last_pos``, every
    layer's post-RoPE K, every layer's V, a vlm model's cross caches
    ``{"k", "v"}`` of (n_cross, B, n_vis, Hkv, D) in ``cfg.dtype``, else
    None). A cross block's K/V come from its one projection of the vision
    tokens (the reference projects them a second time, to the same
    values)."""
    layers = layers if layers is not None else layer_views(params, cfg)
    vis = _vision(cfg, vision_tokens)
    cross = cross_views(params, cfg)
    x = embed(params["embed"], tokens, cfg.dtype).to(cfg.dtype)
    ks, vs, cks, cvs = [], [], [], []
    for i, layer in enumerate(layers):
        x, k, v = _attn_block_kv(cfg, layer, x)
        ks.append(k)
        vs.append(v)
        if _cross_after(cfg, i):
            x, ck, cv = _cross_block_kv(cfg, cross[len(cks)], x, vis)
            cks.append(ck)
            cvs.append(cv)
    pos = x.shape[1] - 1 if last_pos is None else int(last_pos)
    kv = {"k": torch.stack(cks), "v": torch.stack(cvs)} if cks else None
    return final_logits(params, cfg, x[:, pos:pos + 1])[:, 0], ks, vs, kv


def prefill_state(params: Params, tokens: torch.Tensor, cfg: ModelConfig, *,
                  vision_tokens: torch.Tensor | None = None, pad_to: int = 0,
                  last_pos: int | None = None, layers: list | None = None):
    """Prefill a prompt (B, S) for the legacy serve loop: (logits (B, V) at
    ``last_pos``, :class:`DecodeState`) as the reference's ``prefill``
    returns them. The dense and moe families' state holds one ring-buffer
    :class:`~repro_torch.models.attention.KVCache` of stacked (L, …)
    planes, sized ``max(S, pad_to)`` rows — the last ``cfg.window`` rows
    where a window is shorter than S — and quantized at
    ``cfg.precision.kv_bits``; the audio family's is the dense one; a vlm
    model's adds ``cross``, the K/V of its cross blocks over
    ``vision_tokens`` (B, n_vis, d), raw in ``cfg.dtype`` whatever
    ``kv_bits``, as the reference's; the ssm family's is :func:`prefill`'s
    (``pad_to`` unused); the hybrid's is :func:`prefill`'s with its shared
    caches sized ``max(S, pad_to)`` rows. The legacy loop writes a decoded
    row at ``min(length, rows − 1)``: without ``pad_to`` > S the first step
    overwrites the last prompt row, as the reference's; with a window at
    ``length % rows`` (ROADMAP C24)."""
    _check_family(cfg)
    if cfg.family in ("ssm", "hybrid"):
        return _prefill_ssm(params, tokens, cfg, last_pos, layers, pad_to)
    logits, ks, vs, cross = _prefill_dense(params, tokens, cfg, last_pos, layers,
                                           vision_tokens)
    caches = [attn.prefill_cache_from_kv(k, v, window=cfg.window,
                                         kv_bits=cfg.precision.kv_bits, pad_to=pad_to)
              for k, v in zip(ks, vs)]
    return logits, DecodeState(_stack_kv(caches), cross=cross, step=tokens.shape[1])


def decode_layer_block(cfg: ModelConfig, layer: Params, h: torch.Tensor,
                       attend) -> torch.Tensor:
    """One decoder layer for single-token decode: pre-norm attention
    residual (``attend(z)`` owns the cache update), then pre-norm MLP (or
    MoE block: B tokens a step take its dense path)."""
    h = h + attend(rmsnorm(layer["ln1"], h))
    return h + _ffn(cfg, layer, rmsnorm(layer["ln2"], h))


# ---------------------------------------------------------------------------
# The ssm family's recurrent decode (the legacy serve loop's cache)
# ---------------------------------------------------------------------------

class DecodeState(typing.NamedTuple):
    """Per-layer caches + step counter. ``layers`` is one cache of stacked
    (L, …) tensors: a ``KVCache`` (the attention families) or a
    ``MambaCache`` (ssm, hybrid); ``shared`` the hybrid's ``KVCache`` of
    stacked (L / k, …) planes, one per application of its shared block;
    ``cross`` a vlm model's ``{"k", "v"}``, each (n_cross, B, n_vis, Hkv,
    D) in ``cfg.dtype``: its cross blocks' K/V over the vision tokens,
    read and never written by decode."""

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


def _prefill_ssm(params, tokens, cfg, last_pos, layers, pad_to=0):
    """The Mamba2 stack's prompt forward (ssm and hybrid): every layer's
    cache and, after every ``shared_attn_every`` layers of a hybrid, the
    shared block with its KV quantized into a ring cache of
    ``max(S, pad_to)`` rows."""
    layers = layers if layers is not None else layer_views(params, cfg)
    x = embed(params["embed"], tokens, cfg.dtype).to(cfg.dtype)
    caches, shared = [], []
    for i, layer in enumerate(layers):
        out, mc = ssm_mod.mamba2_forward(layer["mamba"], rmsnorm(layer["norm"], x),
                                         cfg.ssm_spec, return_state=True)
        x = x + out
        caches.append(mc)
        if _shared_after(cfg, i):
            x, k, v = _attn_block_kv(cfg, params["shared_attn"], x)
            shared.append(attn.prefill_cache_from_kv(
                k, v, kv_bits=cfg.precision.kv_bits, pad_to=pad_to))
    pos = x.shape[1] - 1 if last_pos is None else int(last_pos)
    logits = final_logits(params, cfg, x[:, pos:pos + 1])[:, 0]
    return logits, DecodeState(_stack_caches(caches),
                               shared=_stack_kv(shared) if shared else None,
                               step=tokens.shape[1])


def init_decode_state(cfg: ModelConfig, batch: int, smax: int, *, params=None,
                      vision_tokens: torch.Tensor | None = None,
                      device=None) -> DecodeState:
    """Zero caches for ``batch`` sequences on ``device`` (default ``cuda``).
    The attention families' is an empty ring-buffer KV cache of ``smax``
    rows a layer (``min(window, smax)`` with a sliding window) at
    ``cfg.precision.kv_bits``; a vlm model's ``cross`` holds each cross
    block's K/V projection of ``vision_tokens`` (B, n_vis, d) under
    ``params`` when both are given, else zeros of ``n_vis_tokens`` rows, in
    ``cfg.dtype``. The ssm family's cache is O(1) in
    the sequence (``smax`` is unused); its conv cache is bf16 whatever the
    compute dtype, as in the reference. The hybrid has the ssm family's
    caches and one ring KV cache of ``smax`` rows per application of its
    shared block."""
    from repro_torch import resolve_device

    _check_family(cfg)
    dev = resolve_device(device)

    def kv_caches(n, rows=smax):
        one = attn.init_kv_cache(batch, rows, cfg.n_kv_heads, cfg.head_dim,
                                 kv_bits=cfg.precision.kv_bits, dtype=cfg.dtype,
                                 device=dev)
        return _stack_kv([one] * n)

    if cfg.family in ATTN_FAMILIES:
        rows = min(cfg.window, smax) if cfg.window else smax
        cross = None
        if cfg.family == "vlm":
            cross = _init_cross(cfg, batch, params, vision_tokens, dev)
        return DecodeState(kv_caches(cfg.n_layers, rows), cross=cross, step=0)
    one = ssm_mod.init_mamba_cache(batch, cfg.ssm_spec, device=dev)
    shared = (kv_caches(cfg.n_layers // cfg.shared_attn_every)
              if cfg.family == "hybrid" else None)
    return DecodeState(ssm_mod.MambaCache(
        conv=one.conv.expand(cfg.n_layers, *one.conv.shape).clone(),
        ssm=one.ssm.expand(cfg.n_layers, *one.ssm.shape).clone()), shared=shared,
        step=0)


def _init_cross(cfg: ModelConfig, batch: int, params, vision_tokens, dev) -> dict:
    """A vlm model's cross caches for :func:`init_decode_state`."""
    shape = (_n_cross(cfg), batch, cfg.n_vis_tokens, cfg.n_kv_heads, cfg.head_dim)
    if params is None or vision_tokens is None:
        return {"k": torch.zeros(shape, dtype=cfg.dtype, device=dev),
                "v": torch.zeros(shape, dtype=cfg.dtype, device=dev)}
    vis = vision_tokens.to(device=dev, dtype=cfg.dtype)
    rows = (batch, vis.shape[1], cfg.n_kv_heads, cfg.head_dim)
    ks, vs = [], []
    for blk in cross_views(params, cfg):
        ks.append(dense(blk["attn"]["k"], vis).reshape(rows))
        vs.append(dense(blk["attn"]["v"], vis).reshape(rows))
    return {"k": torch.stack(ks), "v": torch.stack(vs)}


def _cross_decode(cfg: ModelConfig, blk: Params, x: torch.Tensor, ck: torch.Tensor,
                  cv: torch.Tensor) -> torch.Tensor:
    """One token (B, 1, d) through a vlm cross block on its cached K/V
    (B, n_vis, Hkv, D): every row valid (``kv_len = n_vis``), no cache
    update."""
    b, spec = x.shape[0], cfg.attn_spec
    q = dense(blk["attn"]["q"], rmsnorm(blk["ln1"], x)).reshape(
        b, 1, cfg.n_heads, cfg.head_dim)
    out = attn.decode_attention(q, ck, cv, spec, kv_len=ck.shape[1])
    return x + dense(blk["attn"]["o"], out.reshape(b, 1, cfg.n_heads * cfg.head_dim))


def decode_step(params: Params, state: DecodeState, tokens: torch.Tensor,
                cfg: ModelConfig):
    """One serve step of the legacy loop: tokens (B, 1) → (logits (B, 1, V)
    f32 with the vocab pad masked, new state). ``state`` is only read: the
    new state's tensors are new, so a discarded step leaves it as it was.
    The attention families append each layer's K/V row to its ring cache
    (at ``length % rows`` with a sliding window) and attend in plain
    PyTorch (``attention_decode_step``), as the reference does; a vlm
    model's cross blocks attend their cached K/V (``state.cross``, passed
    on as it is); the hybrid attends in its shared block, on the cache of
    that application."""
    _check_family(cfg)
    x = embed(params["embed"], tokens, cfg.dtype).to(cfg.dtype)

    def attend_block(blk, x, kv: attn.KVCache, i: int, out: list):
        """``x`` through attention block ``blk`` on cache ``i`` of ``kv``;
        the new cache goes to ``out``."""
        def attend(z):
            a_out, cache = attn.attention_decode_step(blk["attn"], z, _kv_layer(kv, i),
                                                      cfg.attn_spec)
            out.append(cache)
            return a_out
        return decode_layer_block(cfg, blk, x, attend)

    caches = []
    if cfg.family in ATTN_FAMILIES:
        cross = cross_views(params, cfg)
        for i, layer in enumerate(layer_views(params, cfg)):
            x = attend_block(layer, x, state.layers, i, caches)
            if _cross_after(cfg, i):
                j = i // cfg.cross_attn_every
                x = _cross_decode(cfg, cross[j], x, state.cross["k"][j],
                                  state.cross["v"][j])
        return final_logits(params, cfg, x), DecodeState(
            _stack_kv(caches), cross=state.cross, step=state.step + 1)
    shared = []
    for i, layer in enumerate(layer_views(params, cfg)):
        cache = ssm_mod.MambaCache(state.layers.conv[i], state.layers.ssm[i])
        y, new_cache = ssm_mod.mamba2_decode_step(
            layer["mamba"], rmsnorm(layer["norm"], x), cache, cfg.ssm_spec)
        x = x + y
        caches.append(new_cache)
        if _shared_after(cfg, i):
            x = attend_block(params["shared_attn"], x, state.shared, len(shared), shared)
    return final_logits(params, cfg, x), DecodeState(
        _stack_caches(caches), shared=_stack_kv(shared) if shared else None,
        step=state.step + 1)
