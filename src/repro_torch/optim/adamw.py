"""AdamW with f32 master weights and optional ZipML-quantized moments (port
of ``repro.optim.adamw``).

``moment_bits=8`` stores m and v as :class:`~repro_torch.quant.QTensor`
leaves (int8 codes + per-out-feature f32 scales, v in the √v domain) and
re-encodes them with stochastic rounding on every update — E[m̂] = m keeps
the update unbiased. The update dispatches through the kernel registry's
``quant_adamw_update``: ``ref`` is the plain decode → update → re-encode,
``cuda`` the two-pass kernel pair of ``kernels/quant_adamw``.

State is a pytree mirroring the params (nested dicts); leaves are visited
in the reference's ``jax.tree.flatten`` order (dict keys sorted), so the
per-leaf keys split from one step key land on the same leaves as in the
reference. Legacy ``MomentQ`` checkpoints and their migration are not
ported (no checkpoints yet: ROADMAP A8).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch

from repro_torch import prng, quant
from repro_torch.quant import QScheme, QTensor
from repro_torch.tree import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    decay_steps: int = 10_000
    min_lr_ratio: float = 0.1
    moment_bits: int = 0        # 0 = f32 moments; 8 = int8 QTensor storage
    update_clip: float = 10.0   # per-coordinate |update| bound on the
    # quantized-moment path (0 disables): quantizing √v can round a small
    # second moment to 0 while m stays nonzero, and the update degenerates
    # to m/eps (the reference's AdamWConfig.update_clip)


class OptState(NamedTuple):
    step: torch.Tensor
    m: Any            # f32 tree, or QTensor tree when moment_bits > 0
    v: Any            # (QTensor v stores √v codes — decode_moment squares)
    master: Any       # f32 master copy of params


def moment_scheme(bits: int, ndim: int) -> QScheme:
    """Per-out-feature (last-axis) scales for matrices, one scalar for
    vectors/scalars."""
    return QScheme.int_symmetric(
        bits, scaling="column" if ndim > 1 else "tensor", rounding="stochastic")


def encode_moment(x: torch.Tensor, bits: int, key, positive: bool = False) -> QTensor:
    """Stochastically quantize a moment tensor; ``positive`` (second moment)
    encodes √v, which :func:`decode_moment` squares on the way out."""
    t0 = torch.sqrt(x) if positive else x
    return quant.encode(t0, moment_scheme(bits, x.ndim), key)


def decode_moment(q, positive: bool = False) -> torch.Tensor:
    if not isinstance(q, QTensor):
        return q
    val = q.decode()
    return val * val if positive else val


def init(params, cfg: AdamWConfig) -> OptState:
    master = tree_map(lambda p: p.to(torch.float32, copy=True), params)
    if cfg.moment_bits:
        def zq(p):
            sshape = p.shape[-1:] if p.ndim > 1 else ()
            return QTensor(torch.zeros(p.shape, dtype=torch.int8, device=p.device),
                           torch.ones(sshape, dtype=torch.float32, device=p.device),
                           moment_scheme(cfg.moment_bits, p.ndim))
        m, v = tree_map(zq, params), tree_map(zq, params)
    else:
        m = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                           device=p.device), params)
        v = tree_map(torch.zeros_like, m)
    return OptState(torch.zeros((), dtype=torch.int32), m, v, master)


def schedule(cfg: AdamWConfig, step: int) -> torch.Tensor:
    """Linear warmup + cosine decay to min_lr_ratio, in f32 (as the
    reference's traced arithmetic), as a 0-d CPU tensor."""
    f32 = torch.float32
    step_f = torch.tensor(float(step), dtype=f32)
    warm = torch.clamp(step_f / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step_f - cfg.warmup_steps)
                       / max(cfg.decay_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(torch.tensor(math.pi, dtype=f32) * prog))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(torch.sum(torch.stack(
        [torch.sum(torch.square(g.to(torch.float32))) for g in tree_leaves(tree)])))


def apply_updates(params, grads, state: OptState, cfg: AdamWConfig, key=None,
                  backend=None):
    """One AdamW step. Returns (params, new_state, metrics); the metrics are
    0-d tensors on the params' device (nothing waits for the host).
    NaN/inf gradients skip the update entirely.

    Unlike the reference, the step updates in place what has a fixed shape —
    the f32 masters, f32 moments and the params — so that a full-width run
    holds one copy of each (2.5 G parameters: 10 GB per f32 tree); the
    returned state shares those tensors, and the state passed in must not be
    used again. Quantized moments are new QTensors (their scales change)."""
    from repro_torch.kernels import registry

    leaves = tree_leaves(state.master)
    dev = leaves[0].device
    f32 = torch.float32
    gnorm = global_norm(grads)
    finite = torch.isfinite(gnorm)
    clip = torch.where(gnorm > cfg.grad_clip, cfg.grad_clip / (gnorm + 1e-9),
                       torch.ones((), dtype=f32, device=dev))
    step = int(state.step) + 1
    step_f = torch.tensor(float(step), dtype=f32)
    host = torch.stack([schedule(cfg, step),
                        1 - torch.tensor(cfg.b1, dtype=f32) ** step_f,
                        1 - torch.tensor(cfg.b2, dtype=f32) ** step_f]).to(dev)
    lr, b1c, b2c = host[0], host[1], host[2]

    keys = None
    if cfg.moment_bits and key is not None:
        n = len(leaves)
        ks = prng.split(key, 2 * n)
        keys = iter(zip(ks[:n], ks[n:]))
    kb = registry.resolve(backend, dev)

    def upd(p_master, g, m_old, v_old, p):
        if cfg.moment_bits:
            km, kv = next(keys) if keys is not None else (None, None)
            nm, m_new, v_new = kb.quant_adamw_update(
                p_master, g, m_old, v_old, km, kv, bits=cfg.moment_bits,
                b1=cfg.b1, b2=cfg.b2, eps=cfg.eps, b1c=b1c, b2c=b2c, lr=lr,
                clip=clip, finite=finite,
                wd=cfg.weight_decay if p_master.ndim >= 2 else 0.0,
                uclip=cfg.update_clip)
        else:
            g32 = g.to(f32) * clip
            m = cfg.b1 * m_old + (1 - cfg.b1) * g32
            v = cfg.b2 * v_old + (1 - cfg.b2) * g32 * g32
            update = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
            decay = cfg.weight_decay * p_master if p_master.ndim >= 2 else 0.0
            nm = torch.where(finite, p_master - lr * (update + decay), p_master)
            m_new = m_old.copy_(torch.where(finite, m, m_old))
            v_new = v_old.copy_(torch.where(finite, v, v_old))
        p_master.copy_(nm)
        p.copy_(p_master)
        return m_new, v_new

    out = tree_map(upd, state.master, grads, state.m, state.v, params)
    new_m = tree_map(lambda t: t[0], out)
    new_v = tree_map(lambda t: t[1], out)
    metrics = {"grad_norm": gnorm, "lr": lr, "skipped": 1.0 - finite.to(f32)}
    new_state = OptState(torch.tensor(step, dtype=torch.int32), new_m, new_v,
                         state.master)
    return params, new_state, metrics
