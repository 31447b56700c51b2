"""The four PrecisionPlan channels as stateful objects (port of
``repro.train.channels``)::

    state = channel.init(params)            # its slice of TrainState.channels
    value, state = channel.apply(value, state, key)

* sample — float sample tensors are quantized in the 'e2e' plan mode only
  (LM token batches pass through);
* model  — 'fake' (QAT fake quantization) or 'ship' (int codes streamed by
  the ``quant_dense`` op, straight-through gradient to the master), applied
  inside the loss;
* grad   — stochastic int quantization with the error-feedback residual
  ``{'ef': f32 tree}`` carried in the channel state;
* act    — the reference's model never reads ``act_bits`` (its channel
  does nothing); the port raises on a plan with it (ROADMAP C9).
"""
from __future__ import annotations

import torch

from repro_torch import prng, quant
from repro_torch.precision import gradcomp, qat
from repro_torch.quant import PrecisionPlan, QScheme
from repro_torch.tree import tree_leaves, tree_map


class Channel:
    """Base: a stateless passthrough. Subclasses override what they need."""

    name = "abstract"

    def __init__(self, plan: PrecisionPlan):
        self.plan = plan

    def init(self, params) -> dict:
        del params
        return {}

    def apply(self, value, state: dict, key):
        del key
        return value, state


class SampleChannel(Channel):
    """Q_s: float sample leaves are quantized at ``sample_bits`` (int grid,
    per-tensor scale, stochastic rounding) in the 'e2e' plan mode only;
    integer leaves (LM tokens) pass through."""

    name = "sample"

    def apply(self, batch, state, key):
        if self.plan.mode != "e2e" or not self.plan.sample_bits:
            return batch, state
        scheme = QScheme.int_symmetric(self.plan.sample_bits, scaling="tensor",
                                       rounding="stochastic")
        keys = iter(prng.split(key, len(tree_leaves(batch))))

        def one(x):
            k = next(keys)
            if not torch.is_floating_point(x):
                return x
            return quant.encode(x, scheme, k).decode(x.dtype)

        return tree_map(one, batch), state


class ModelChannel(Channel):
    """Q_m — weight quantization inside the loss. ``model_storage='fake'``:
    QAT fake quantization with stochastic rounding; ``'ship'``: int codes
    for the matmuls (:class:`~repro_torch.quant.ShipWeight`, weights of at
    least ``ship_min_size`` elements); ``'int'`` is the serving format and
    leaves a train step on the dense masters."""

    name = "model"

    def __init__(self, plan: PrecisionPlan, ship_min_size: int = 1 << 16):
        super().__init__(plan)
        self.ship_min_size = ship_min_size

    def apply(self, params, state, key):
        plan = self.plan
        if not plan.model_bits:
            return params, state
        if plan.model_storage == "fake":
            return qat.fake_quant_tree(params, plan.model_bits, key), state
        if plan.model_storage == "ship":
            return qat.ship_quant_tree(params, plan.model_bits,
                                       min_size=self.ship_min_size), state
        if plan.model_storage == "int":
            return params, state
        raise ValueError(f"unknown model_storage {plan.model_storage!r} "
                         "(have 'fake' | 'ship' | 'int')")


class GradChannel(Channel):
    """Q_g — quantized gradients with error feedback: the residual
    e_t = (g_t + e_{t−1}) − Q(g_t + e_{t−1}) carries to the next step in
    ``TrainState.channels['grad']['ef']`` (updated in place)."""

    name = "grad"

    def __init__(self, plan: PrecisionPlan, error_feedback: bool = True,
                 rounding: str = "stochastic"):
        super().__init__(plan)
        self.error_feedback = error_feedback
        self.rounding = rounding

    def init(self, params):
        if self.plan.grad_bits and self.error_feedback:
            return {"ef": gradcomp.init_error_feedback(params)}
        return {}

    def apply(self, grads, state, key):
        bits = self.plan.grad_bits
        if not bits:
            return grads, state
        comp, new_err = gradcomp.compress_tree(
            grads, bits, key, error=state.get("ef"), rounding=self.rounding)
        grads = gradcomp.decompress_tree(comp)
        if self.error_feedback:
            state = {"ef": new_err}
        return grads, state


class ActChannel(Channel):
    """Q_a — the activation channel. The reference's ``ActChannel`` does
    nothing and its model never reads ``act_bits``; the port raises on it
    instead of silently ignoring a requested channel."""

    name = "act"

    def __init__(self, plan: PrecisionPlan):
        if plan.act_bits:
            raise NotImplementedError(
                "act_bits: the reference does not wire act_bits into its model "
                "(a plan with it trains as one without it); the port raises "
                "rather than ignore a requested channel (ROADMAP C9; the "
                "activation channel itself is precision.act_quant)")
        super().__init__(plan)


def default_channels(plan: PrecisionPlan, *, error_feedback: bool = True
                     ) -> dict[str, Channel]:
    """The standard four-channel composition for a PrecisionPlan."""
    return {"sample": SampleChannel(plan), "model": ModelChannel(plan),
            "grad": GradChannel(plan, error_feedback=error_feedback),
            "act": ActChannel(plan)}
