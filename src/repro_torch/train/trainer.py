"""Trainer — state init, the channel-composed step and a plain run loop
(port of ``repro.train.trainer`` without its supervisor).

Checkpoints, restore-and-replay, fault injection and elastic resizing are
not ported (ROADMAP A8): ``ckpt_dir``, ``fail_at`` and ``accum_steps > 1``
raise. There is no restart loop: any exception — a kernel that fails to
build or launch included — propagates to the caller.
"""
from __future__ import annotations

import time

import torch

from repro_torch import prng, resolve_device
from repro_torch.data.pipeline import TokenStream, TokenStreamConfig
from repro_torch.models import transformer as T
from repro_torch.optim import adamw

from .channels import Channel, default_channels
from .state import TrainState, init_state
from .step import make_step

_TODO = "is not ported (ROADMAP A8: checkpoints, the supervisor, elastic resizing)"


class Trainer:
    """One training run on one device (default ``cuda``)."""

    def __init__(self, cfg: T.ModelConfig, opt_cfg: adamw.AdamWConfig | None = None, *,
                 stream_cfg: TokenStreamConfig | None = None,
                 channels: dict[str, Channel] | None = None,
                 error_feedback: bool = True, accum_steps: int = 1,
                 ckpt_dir: str | None = None, log_every: int = 10, seed: int = 0,
                 device=None):
        if ckpt_dir is not None:
            raise NotImplementedError(f"checkpointing (ckpt_dir) {_TODO}")
        if accum_steps != 1:
            raise NotImplementedError("gradient accumulation (accum_steps > 1) "
                                      "is not ported (ROADMAP A8)")
        self.cfg = cfg
        self.plan = cfg.precision
        self.opt_cfg = opt_cfg if opt_cfg is not None else adamw.AdamWConfig()
        self.channels = channels if channels is not None else \
            default_channels(self.plan, error_feedback=error_feedback)
        self.log_every = log_every
        self.seed = seed
        self.key = prng.PRNGKey(seed)
        self.device = resolve_device(device)
        self.stream_cfg = stream_cfg
        self.stream = TokenStream(stream_cfg) if stream_cfg else None
        self._step_fn = make_step(cfg, self.opt_cfg, self.channels)
        self.history: list[dict] = []   # per step: loss, grad_norm, skipped, seconds

    def init_state(self) -> TrainState:
        """Random weights from ``seed`` (``torch.Generator`` draws: not the
        reference's numbers — carry a reference state across with
        ``interop.train_state_from_numpy`` to compare)."""
        params = T.init_params(self.cfg, seed=self.seed, device=self.device)
        opt = adamw.init(params, self.opt_cfg)
        ch = {name: c.init(params) for name, c in self.channels.items()}
        return init_state(params, opt, ch, self.key)

    def step(self, state: TrainState, batch: dict):
        """One training step on the batch at ``state.step`` (numpy or tensor
        leaves). Consumes ``state`` (see ``make_step``)."""
        batch = {k: torch.as_tensor(v).to(self.device) for k, v in batch.items()}
        return self._step_fn(state, batch)

    def run(self, steps: int, *, state: TrainState | None = None,
            fail_at: int | None = None):
        """Train until ``state.step == steps``. Returns (final state, losses);
        per-step metrics land in :attr:`history`."""
        if fail_at is not None:
            raise NotImplementedError(f"fault injection (fail_at) {_TODO}")
        if self.stream is None:
            raise RuntimeError("Trainer built without stream_cfg")
        if state is None:
            state = self.init_state()
        self.stream.skip_to(state.cursor)
        losses = []
        while state.step < steps:
            step_i = state.step
            batch = self.stream.next_batch()
            t0 = time.perf_counter()
            state, metrics = self.step(state, batch)
            loss = float(metrics["loss"])          # waits for the device
            dt = time.perf_counter() - t0
            rec = {"step": step_i, "loss": loss,
                   "grad_norm": float(metrics["grad_norm"]),
                   "skipped": float(metrics["skipped"]), "seconds": dt}
            self.history.append(rec)
            losses.append(loss)
            if (step_i + 1) % self.log_every == 0:
                print(f"[train] step {step_i + 1}: loss={loss:.4f} "
                      f"gnorm={rec['grad_norm']:.3f} skipped={rec['skipped']:.0f} "
                      f"({dt:.2f}s)", flush=True)
        return state, losses
