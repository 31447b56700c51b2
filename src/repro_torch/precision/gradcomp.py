"""Quantized gradients with error feedback (port of
``repro.precision.gradcomp``: ``compress_tree``, ``decompress_tree``,
``init_error_feedback``).

ZipML stochastic quantization of every gradient leaf to int codes with one
per-tensor scale (unbiased, C1); with an error-feedback tree the
quantization residual (g + e) − Q(g + e) carries to the next step. Leaves
take their keys in ``jax.tree.flatten`` order (dict keys sorted), one key
each from ``split(key, n_leaves)``, as in the reference. The compressed
all-reduce (``make_compressed_psum``) needs a mesh (ROADMAP A9).
"""
from __future__ import annotations

import torch

from repro_torch import prng, quant
from repro_torch.quant import QScheme
from repro_torch.tree import tree_leaves, tree_map


def _grad_scheme(bits: int, rounding: str = "stochastic") -> QScheme:
    return QScheme.int_symmetric(bits, scaling="tensor", rounding=rounding)


def compress_tree(grads, bits: int, key, error=None, rounding: str = "stochastic"):
    """Quantize a gradient tree. Returns (compressed, new_error).

    ``error``: the error-feedback tree (same structure, f32), added before
    quantization; new_error = (g + e) − Q(g + e). The residual is written
    into ``error``'s own tensors (one f32 copy of the model instead of two
    at full width), so the returned new_error is ``error``."""
    n = len(tree_leaves(grads))
    keys = iter(prng.split(key, n))
    scheme = _grad_scheme(bits, rounding)

    def one(g, e=None):
        k = next(keys)
        if e is None:
            g32 = g.to(torch.float32)
        else:
            g32 = e.add_(g)
        c = quant.encode(g32, scheme, k)
        if e is not None:
            e.sub_(c.decode())
        return c, e

    out = tree_map(one, grads) if error is None else tree_map(one, grads, error)
    return tree_map(lambda t: t[0], out), (None if error is None else error)


def decompress_tree(comp):
    return tree_map(lambda c: c.decode(), comp)


def init_error_feedback(grads_like):
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                          device=g.device), grads_like)

