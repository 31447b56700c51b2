"""threefry2x32 keys and draws, bit-exact with ``jax.random`` as the reference
runs it (``jax_threefry_partitionable=True``, 32-bit mode).

A key is an int64 tensor of shape ``(..., 2)`` holding two uint32 words, the
layout of a JAX ``uint32[2]`` key (a JAX key crosses over as numpy through
:func:`repro_torch.interop.key_from_numpy`). Keys stay on the host: key
arithmetic is a few words, and done in Python integers it costs microseconds
where a device launch costs more. The bulk planes (:func:`bits`,
:func:`uniform`, :func:`randint`) are made on the device the caller names
by ``kernels/threefry.py``: on the card each plane is one launch of the CUDA
threefry2x32 (``csrc/threefry.cu``: uint32 words, one key or a batch of
keys), which launches or raises; on the CPU by the int64 path there, which
is also that kernel's plain version. The hash (:func:`threefry2x32`) lives
there too; this module only calls down into it.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import threefry as _tf
from repro_torch.kernels.threefry import MASK, threefry2x32  # noqa: F401 (re-exported)


def PRNGKey(seed: int) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` in 32-bit mode: the seed wraps to its
    low 32 bits, the high word is 0."""
    return torch.tensor([0, int(seed) & MASK], dtype=torch.int64)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)`` → ``(num, 2)``. A batch of keys
    ``(..., 2)`` splits each one (JAX's ``vmap(split)``) → ``(..., num, 2)``."""
    b1, b2 = _tf.hash_counts(key, (int(num),), key.device)
    return torch.stack([b1, b2], dim=-1)


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in(key, data)``: the hash of the counter (0, data)."""
    d = int(data) & MASK
    if key.ndim == 1:
        k1, k2 = _tf.words(key, key.device, 0)
        return torch.tensor(threefry2x32(k1, k2, 0, d), dtype=torch.int64)
    y1, y2 = _tf.hash_counts(key, (1,), key.device, start=d)
    return torch.stack([y1[..., 0], y2[..., 0]], dim=-1)


def bits(key: torch.Tensor, shape, device=None, dtype=torch.int64) -> torch.Tensor:
    """``jax.random.bits(key, shape, uint32)``: the xor of the two hash
    words of each element's counter. ``dtype=int64`` holds the values in
    [0, 2**32); ``dtype=int32`` the same 32-bit patterns (what the kernels
    read as uint32), at half the memory."""
    out = "int32" if dtype == torch.int32 else "int64"
    return _tf.threefry_plane(key, shape, out=out, device=device).to(dtype)


def uniform(key: torch.Tensor, shape, device=None) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32)`` in [0, 1): the top 23 bits
    as the mantissa of a float in [1, 2), minus 1."""
    return _tf.threefry_plane(key, shape, out="f32", device=device)


def randint(key: torch.Tensor, shape, minval: int, maxval: int,
            device=None) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval, int32)``: two 32-bit
    planes from a split key, combined modulo the span in uint32 arithmetic
    (its modulo bias included)."""
    lo32, hi32 = -2 ** 31, 2 ** 31 - 1
    above = int(maxval) > hi32          # JAX widens the span by one then
    minval = min(max(int(minval), lo32), hi32)
    maxval = min(max(int(maxval), lo32), hi32)
    span = maxval - minval + int(above) if maxval > minval else 1
    if span > MASK:
        raise ValueError("randint: a span of 2**32 values is not supported")
    k = split(key)
    higher = bits(k[..., 0, :], shape, device)
    lower = bits(k[..., 1, :], shape, device)
    mult = ((2 ** 16 % span) ** 2 & MASK) % span     # uint32 products wrap
    off = ((higher % span) * mult) & MASK
    off = ((off + lower % span) & MASK) % span
    return (minval + off).to(torch.int32)
