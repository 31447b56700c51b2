"""Carry parameter trees across from the reference as numpy.

``params_from_numpy(tree, device)`` takes the reference's parameter tree as
nested dicts of numpy arrays, where a quantized leaf comes as
``{"codes": ndarray, "scale": ndarray, "scheme": {QScheme fields}}`` (plus
``"levels"``, the level table of a ``grid='levels'`` QTensor), and
returns the port's tree: tensors and :class:`~repro_torch.quant.QTensor`
leaves on ``device`` (a bitplane QTensor's uint32 words arrive as the
port's int32 words, bit for bit; its ``vec_dim`` rides in the scheme). bfloat16 arrays (``ml_dtypes``) arrive as torch
bfloat16 exactly (through f32, which holds every bf16 value). Converting a
JAX ``QTensor`` into that dict form is the caller's job — this package
never imports JAX. A vlm tree's ``blocks`` — self layers stacked (n_cross,
per, …) under ``self``, cross blocks (n_cross, …) under ``cross`` —
arrives as the port's ``layers`` (every leaf's two lead axes merged into
one, QTensor codes, scales and level tables alike: block i, layer j is
layer i · per + j) and ``cross``.

``key_from_numpy(k)`` takes a JAX PRNG key (``uint32[2]``, or a stack of
them) as numpy and returns the port's key (:mod:`repro_torch.prng`: int64
words on the host); a model vector or any other array crosses with
``tensor_from_numpy``.

``train_state_from_numpy(d, device)`` takes a reference ``TrainState`` as
``{"params", "opt": {"step", "m", "v", "master"}, "channels", "step",
"rng", "epoch"}`` with every tree in the form above (moment QTensors
included) and returns the port's :class:`~repro_torch.train.TrainState`,
so both packages can train on from one state.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.quant import QScheme, QTensor


def tensor_from_numpy(a, device="cpu") -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(device=device,
                                                         dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _merge_lead(tree):
    """Every array of a numpy tree with its first two axes merged."""
    if isinstance(tree, dict):
        return {k: v if k == "scheme" else _merge_lead(v) for k, v in tree.items()}
    a = np.asarray(tree)
    return a.reshape(a.shape[0] * a.shape[1], *a.shape[2:])


def params_from_numpy(tree, device="cpu"):
    if isinstance(tree, dict) and set(tree.get("blocks") or ()) == {"self", "cross"}:
        tree = {**{k: v for k, v in tree.items() if k != "blocks"},
                "layers": _merge_lead(tree["blocks"]["self"]),
                "cross": tree["blocks"]["cross"]}
    if isinstance(tree, dict):
        if set(tree) in ({"codes", "scale", "scheme"},
                         {"codes", "scale", "scheme", "levels"}):
            scheme = QScheme(**tree["scheme"])
            codes = np.asarray(tree["codes"])
            if scheme.layout == "bitplane":
                codes = codes.view(np.int32)     # the uint32 words' bits
            levels = tree.get("levels")
            return QTensor(tensor_from_numpy(codes, device),
                           tensor_from_numpy(tree["scale"], device), scheme,
                           levels=None if levels is None
                           else tensor_from_numpy(levels, device))
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    return tensor_from_numpy(tree, device)


def key_from_numpy(k) -> torch.Tensor:
    """A JAX ``uint32[..., 2]`` key as the port's int64 key words."""
    k = np.asarray(k)
    if k.shape[-1:] != (2,) or k.dtype != np.uint32:
        raise ValueError(f"a JAX key is uint32[..., 2], got {k.dtype}{list(k.shape)}")
    return torch.from_numpy(k.astype(np.int64))


def train_state_from_numpy(d, device="cpu"):
    """A reference TrainState (as numpy, see the module docstring) as the
    port's TrainState on ``device``."""
    from repro_torch.optim.adamw import OptState
    from repro_torch.train.state import TrainState

    opt = d["opt"]
    return TrainState(
        params_from_numpy(d["params"], device),
        OptState(torch.tensor(int(opt["step"]), dtype=torch.int32),
                 params_from_numpy(opt["m"], device),
                 params_from_numpy(opt["v"], device),
                 params_from_numpy(opt["master"], device)),
        {k: params_from_numpy(v, device) for k, v in d["channels"].items()},
        int(d["step"]), key_from_numpy(d["rng"]), int(d["epoch"]))
