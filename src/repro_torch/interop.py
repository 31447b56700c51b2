"""Carry parameter trees across from the reference as numpy.

``params_from_numpy(tree, device)`` takes the reference's parameter tree as
nested dicts of numpy arrays, where a quantized leaf comes as
``{"codes": ndarray, "scale": ndarray, "scheme": {QScheme fields}}``, and
returns the port's tree: tensors and :class:`~repro_torch.quant.QTensor`
leaves on ``device``. bfloat16 arrays (``ml_dtypes``) arrive as torch
bfloat16 exactly (through f32, which holds every bf16 value). Converting a
JAX ``QTensor`` into that dict form is the caller's job — this package
never imports JAX.
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
