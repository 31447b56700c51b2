"""Step builders of the serving half (port of ``repro.launch.steps``:
``make_prefill_step`` and ``make_serve_step``). The training step builder
and the dry-run input specs wait for ROADMAP A9."""
from __future__ import annotations

import torch

from repro_torch.models import transformer as T


def make_prefill_step(cfg: T.ModelConfig, pad_to: int = 0):
    """``prefill_step(params, {"tokens": (B, S)[, "vision": (B, n_vis, d)]})
    → (last logits, DecodeState)``; the attention families' ring cache and
    the hybrid's shared caches get ``max(S, pad_to)`` rows; a vlm model
    attends ``batch["vision"]``, as the reference's step passes it."""
    def prefill_step(params, batch):
        return T.prefill_state(params, batch["tokens"], cfg,
                               vision_tokens=batch.get("vision"), pad_to=pad_to)
    return prefill_step


def make_serve_step(cfg: T.ModelConfig):
    """``serve_step(params, state, tokens (B, 1)) → (logits, next tokens (B,)
    int32, new state)``: one decode step and its greedy pick."""
    def serve_step(params, state, tokens):
        logits, new_state = T.decode_step(params, state, tokens, cfg)
        next_tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        return logits, next_tok, new_state
    return serve_step
