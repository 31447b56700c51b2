"""TrainState — everything a training run is (port of
``repro.train.state``): params, optimizer state (quantized moments), the
per-channel state (the grad channel's error-feedback residual), the step
counter (also the data cursor), the base PRNG key and the epoch.

``step`` and ``epoch`` are Python ints and ``rng`` a host key
(:mod:`repro_torch.prng`): per-step keys are ``fold_in(rng, step)``.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.data.pipeline import Cursor


@dataclasses.dataclass
class TrainState:
    params: Any
    opt: Any
    channels: dict
    step: int
    rng: torch.Tensor
    epoch: int = 0

    @property
    def cursor(self) -> Cursor:
        """The data-pipeline position this state expects to consume next."""
        return Cursor(int(self.step), int(self.epoch))

    def replace(self, **kw) -> "TrainState":
        return dataclasses.replace(self, **kw)

    def to(self, device) -> "TrainState":
        """A copy of the state with every tensor on ``device`` (the key
        stays on the host)."""
        from repro_torch.optim.adamw import OptState
        from repro_torch.quant import QTensor
        from repro_torch.tree import tree_map

        def move(t):
            return t.to(device) if isinstance(t, QTensor) else t.to(device, copy=True)

        opt = OptState(self.opt.step, tree_map(move, self.opt.m),
                       tree_map(move, self.opt.v), tree_map(move, self.opt.master))
        return self.replace(params=tree_map(move, self.params), opt=opt,
                            channels=tree_map(move, self.channels))


def init_state(params, opt, channels: dict, key: torch.Tensor, step: int = 0,
               epoch: int = 0) -> TrainState:
    return TrainState(params, opt, dict(channels), int(step), key, int(epoch))
