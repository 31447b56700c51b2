"""repro_torch.train — the training path (port of ``repro.train``):
:class:`TrainState`, the four PrecisionPlan channels, :func:`make_step`
and the :class:`Trainer` loop. Checkpoints, the restart supervisor,
elastic resizing and gradient accumulation are not ported (ROADMAP A8)."""
from .channels import (ActChannel, Channel, GradChannel, ModelChannel,
                       SampleChannel, default_channels)
from .state import TrainState, init_state
from .step import make_grads_fn, make_step
from .trainer import Trainer

__all__ = ["ActChannel", "Channel", "GradChannel", "ModelChannel",
           "SampleChannel", "TrainState", "Trainer", "default_channels",
           "init_state", "make_grads_fn", "make_step"]
