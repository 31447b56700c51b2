"""Token sampling for the serving engine: greedy, temperature and top-k
(port of ``repro.serve.sampling``).

Every slot samples with its own key, ``fold_in(base, position)`` of the
request's base key and the absolute sequence position — never the batch
layout — so a request's sampled continuation is the same alone or packed
into a mixed batch. Keys are threefry2x32 words as ``prng`` holds them:
int64 tensors ``(..., 2)`` on the host. The draw is ``jax.random.categorical``
as the reference runs it: the argmax of ``logits / T + gumbel``, where
``gumbel = -log(-log(u))`` and ``u`` is the key's uniform plane over the
vocabulary floored at the smallest normal f32 (jax 0.9.0's ``_gumbel``,
mode "low"). On the card that plane is one launch of the threefry kernel
for the whole batch of keys (``kernels/threefry.py``).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import prng
from repro_torch.prng import MASK, threefry2x32

TINY = torch.finfo(torch.float32).tiny


def slot_key(seed_key, position) -> torch.Tensor:
    """The per-step sampling key ``fold_in(seed_key, position)``. A batch
    of keys ``(..., 2)`` broadcasts against a batch of positions; returns
    ``(*batch, 2)`` int64 on the host."""
    k = torch.as_tensor(np.asarray(seed_key), dtype=torch.int64).cpu()
    p = torch.as_tensor(np.asarray(position), dtype=torch.int64).cpu()
    lead = torch.broadcast_shapes(k.shape[:-1], p.shape)
    kk = k.expand(*lead, 2).reshape(-1, 2).tolist()
    pp = p.expand(lead).reshape(-1).tolist()
    out = [threefry2x32(a, b, 0, d & MASK) for (a, b), d in zip(kk, pp)]
    return torch.tensor(out, dtype=torch.int64).reshape(*lead, 2)


def window_keys(seed_keys, positions) -> torch.Tensor:
    """:func:`slot_key` over a decode window: seed_keys (B, 2) × positions
    (B, W) → (B, W, 2) — the keys sequential decode would use at those
    positions, so a sampled verify window is token-identical to sampled
    decode."""
    return slot_key(torch.as_tensor(np.asarray(seed_keys))[:, None, :], positions)


def sample_tokens(logits: torch.Tensor, temperature, top_k, keys) -> torch.Tensor:
    """logits (B, V) f32 → token ids (B,) int32.

    temperature (B,): ≤ 0 means greedy argmax for that slot. top_k (B,):
    ≤ 0 means no filter; otherwise every logit below the k-th largest is
    masked (ties at the k-th value all kept). keys (B, 2): one key per
    slot. ``temperature`` and ``top_k`` are host arrays; the uniform plane
    is drawn on the logits' device."""
    b, v = logits.shape
    dev = logits.device
    temps = torch.as_tensor(np.asarray(temperature), dtype=torch.float32).reshape(b)
    topk = torch.as_tensor(np.asarray(top_k), dtype=torch.int64).reshape(b)
    greedy = torch.argmax(logits, dim=-1)
    hot = temps > 0
    if not bool(hot.any()):
        return greedy.to(torch.int32)
    kth_idx = topk.clamp(1, v) - 1
    host = torch.stack([torch.where(hot, temps, 1.0), (topk <= 0).to(torch.float32),
                        hot.to(torch.float32), kth_idx.to(torch.float32)])
    if dev.type == "cuda":
        host = host.pin_memory()
    temp, nofilter, hot_d, kth_d = host.to(dev, non_blocking=True).unbind(0)
    top = torch.topk(logits, int(kth_idx.max()) + 1, dim=-1).values
    kth = top.gather(1, kth_d.to(torch.int64)[:, None])
    keep = nofilter.bool()[:, None] | (logits >= kth)
    masked = torch.where(keep, logits, float("-inf"))
    keys = torch.as_tensor(keys, dtype=torch.int64).reshape(b, 2)
    u = prng.uniform(keys, (v,), device=dev).clamp_min(TINY)
    gumbel = -torch.log(-torch.log(u))
    sampled = torch.argmax(masked / temp[:, None] + gumbel, dim=-1)
    return torch.where(hot_d.bool(), sampled, greedy).to(torch.int32)


__all__ = ["sample_tokens", "slot_key", "window_keys"]
