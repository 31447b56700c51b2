"""Port parity — slice 3's ``make_step`` at the model's default bf16 and
with plain f32 moments (see ``test_torch_train.py`` for the pairings).

* all three channels at 8 bits, bf16 weights and activations: the three
  losses of a run started from one state carried across agree to rtol 2e-2
  (bf16 rounds at other places in torch and XLA; the step-1 loss, before any
  update, to rtol 1e-2);
* no channel and f32 moments (the bf16 yardstick of the chip run, here at
  f32): losses rtol 1e-4, the masters' update (after − before, against the
  reference's) within a relative L2 distance of 1e-4, and the moments —
  which start at zero — within 1e-4 of each leaf's largest entry: no
  stochastic rounding anywhere, so only summation order differs.
"""
import numpy as np
import pytest
import torch

from torch_bridge import np32
from test_torch_train import (PAIRINGS, _port_step, _rel, _tbatch, master_updates,
                              run_reference)

from repro_torch.interop import train_state_from_numpy
from repro_torch.tree import tree_leaves
import jax


@pytest.mark.parametrize("pairing", PAIRINGS)
def test_make_step_bf16_losses_match_reference(pairing):
    states, losses, batches = run_reference("bf16", pairing)
    step = _port_step(pairing, dtype="bf16")
    state = train_state_from_numpy(states[0])
    assert tree_leaves(state.params)[0].dtype == torch.bfloat16
    got = []
    for b in batches:
        state, m = step(state, _tbatch(b))
        got.append(float(m["loss"]))
        assert float(m["skipped"]) == 0.0
    np.testing.assert_allclose(got[0], losses[0], rtol=1e-2)
    np.testing.assert_allclose(got, losses, rtol=2e-2)


def test_make_step_plain_moments_match_reference():
    pairing = ("ref", "ref")
    states, losses, batches = run_reference("f32", pairing, plan_kw={}, moment_bits=0)
    step = _port_step(pairing, plan_kw={}, moment_bits=0)
    state = train_state_from_numpy(states[0])
    got = []
    for b in batches:
        state, m = step(state, _tbatch(b))
        got.append(float(m["loss"]))
    np.testing.assert_allclose(got, losses, rtol=1e-4)
    assert master_updates(state, states[0], states[-1])[1] <= 1e-4
    for name in ("m", "v"):
        for a, b in zip(tree_leaves(getattr(state.opt, name)),
                        jax.tree.leaves(states[-1]["opt"][name])):
            assert _rel(np32(a), b) <= 1e-4
