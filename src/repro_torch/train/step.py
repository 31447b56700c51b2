"""The train step over a TrainState, built from the four channel objects
(port of ``repro.train.step``).

Per-step keys follow the reference's lanes: ``key = fold_in(rng, step)``
splits into kq (model channel), kg (grad channel) and km (quantized
moments), and ``ks = fold_in(key, 3)`` feeds the sample channel. The kernel
backend of the whole step — forward, backward and optimizer — is
``cfg.precision.backend`` (None: the registry's selection, else ``cuda`` on
the card and ``ref`` on the CPU).
"""
from __future__ import annotations

import torch

from repro_torch import prng
from repro_torch.kernels import registry
from repro_torch.models import transformer as T
from repro_torch.optim import adamw
from repro_torch.tree import tree_leaves, tree_map

from .channels import Channel, default_channels
from .state import TrainState


def make_grads_fn(cfg: T.ModelConfig, model_channel: Channel, accum_steps: int = 1):
    """Returns grads_of(params, batch, kq) → (loss, grads): the model
    channel applied inside the loss, gradients wrt every param leaf (in the
    params' dtype)."""
    if accum_steps != 1:
        raise NotImplementedError("gradient accumulation (accum_steps > 1) is not "
                                  "ported (ROADMAP A8)")
    if cfg.family == "moe":
        raise NotImplementedError(
            f"{cfg.name}: training an moe model is not ported (ROADMAP A6(e): the "
            "experts' bf16 weight gradient, the load-balance term, stacked "
            "ShipWeight and qmm_t per expert); the port serves it")
    if cfg.family == "vlm":
        raise NotImplementedError(
            f"{cfg.name}: training a vlm model is not ported (ROADMAP A6(f): the "
            "batch's vision tokens through the channels and the loss); the port "
            "serves it")

    def grads_of(params, batch, kq):
        leaves = tree_map(lambda p: p.detach().requires_grad_(), params)
        p, _ = model_channel.apply(leaves, {}, kq)
        loss = T.loss_fn(p, batch["tokens"], batch["targets"], cfg)
        del p
        it = iter(torch.autograd.grad(loss, tree_leaves(leaves)))
        return loss.detach(), tree_map(lambda _: next(it), leaves)

    return grads_of


def make_step(cfg: T.ModelConfig, opt_cfg: adamw.AdamWConfig,
              channels: dict[str, Channel] | None = None, accum_steps: int = 1):
    """Returns step(state, batch) → (state, metrics). ``batch``:
    {"tokens": (B, S), "targets": (B, S)} tensors on the params' device,
    the batch at ``state.step``. The f32 masters, the params and the
    error-feedback residual are updated in place: the state passed in must
    not be used again (see ``adamw.apply_updates``)."""
    channels = channels if channels is not None else default_channels(cfg.precision)
    grads_of = make_grads_fn(cfg, channels["model"], accum_steps)

    def step(state: TrainState, batch):
        with registry.using(cfg.precision.backend):
            key = prng.fold_in(state.rng, state.step)
            kq, kg, km = prng.split(key, 3)
            ks = prng.fold_in(key, 3)
            ch = dict(state.channels)
            batch, ch["sample"] = channels["sample"].apply(
                batch, ch.get("sample", {}), ks)
            loss, grads = grads_of(state.params, batch, kq)
            grads, ch["grad"] = channels["grad"].apply(grads, ch.get("grad", {}), kg)
            mkey = km if opt_cfg.moment_bits else None
            params, opt, metrics = adamw.apply_updates(
                state.params, grads, state.opt, opt_cfg, key=mkey)
        metrics["loss"] = loss
        return TrainState(params, opt, ch, state.step + 1, state.rng, state.epoch), metrics

    return step
