"""Carry parameter trees across from the reference as numpy.

``params_from_numpy(tree, device)`` takes the reference's parameter tree as
nested dicts of numpy arrays, where a quantized leaf comes as
``{"codes": ndarray, "scale": ndarray, "scheme": {QScheme fields}}``, and
returns the port's tree: tensors and :class:`~repro_torch.quant.QTensor`
leaves on ``device``. bfloat16 arrays (``ml_dtypes``) arrive as torch
bfloat16 exactly (through f32, which holds every bf16 value). Converting a
JAX ``QTensor`` into that dict form is the caller's job — this package
never imports JAX.

``key_from_numpy(k)`` takes a JAX PRNG key (``uint32[2]``, or a stack of
them) as numpy and returns the port's key (:mod:`repro_torch.prng`: int64
words on the host); a model vector or any other array crosses with
``tensor_from_numpy``.
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


def params_from_numpy(tree, device="cpu"):
    if isinstance(tree, dict):
        if set(tree) == {"codes", "scale", "scheme"}:
            return QTensor(tensor_from_numpy(tree["codes"], device),
                           tensor_from_numpy(tree["scale"], device),
                           QScheme(**tree["scheme"]))
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    return tensor_from_numpy(tree, device)


def key_from_numpy(k) -> torch.Tensor:
    """A JAX ``uint32[..., 2]`` key as the port's int64 key words."""
    k = np.asarray(k)
    if k.shape[-1:] != (2,) or k.dtype != np.uint32:
        raise ValueError(f"a JAX key is uint32[..., 2], got {k.dtype}{list(k.shape)}")
    return torch.from_numpy(k.astype(np.int64))
