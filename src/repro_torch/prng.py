"""threefry2x32 keys and draws, bit-exact with ``jax.random`` as the reference
runs it (``jax_threefry_partitionable=True``, 32-bit mode).

A key is an int64 tensor of shape ``(..., 2)`` holding two uint32 words, the
layout of a JAX ``uint32[2]`` key (a JAX key crosses over as numpy through
:func:`repro_torch.interop.key_from_numpy`). Keys stay on the host: key
arithmetic is a few words, and done in Python integers it costs microseconds
where a device launch costs more. The bulk planes (:func:`bits`,
:func:`uniform`, :func:`randint`) are made on the device the caller names.

torch cannot shift ``uint32`` (ROADMAP C3), so every word is carried in
int64 and masked to 32 bits after each add and shift. One hash,
:func:`threefry2x32`, serves Python integers and tensors alike, since it only
uses ``+ << >> | ^ &``.
"""
from __future__ import annotations

import math

import torch

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_SMALL = 16          # counts up to this many are hashed as Python integers


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 hash (20 rounds) of counter words (x1, x2) under
    key words (k1, k2). Operands are Python ints or int64 tensors holding
    uint32 values; they broadcast. Returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x1 = (x1 + ks[0]) & MASK
    x2 = (x2 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & MASK
            x2 = (((x2 << r) & MASK) | (x2 >> (32 - r))) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & MASK
        x2 = (x2 + ks[(i + 2) % 3] + i + 1) & MASK
    return x1, x2


def PRNGKey(seed: int) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` in 32-bit mode: the seed wraps to its
    low 32 bits, the high word is 0."""
    return torch.tensor([0, int(seed) & MASK], dtype=torch.int64)


def _words(key: torch.Tensor, device, extra_dims: int):
    """Key words as Python ints (one key) or as tensors shaped to broadcast
    against ``extra_dims`` trailing count dims (a batch of keys)."""
    if key.shape[-1] != 2:
        raise ValueError(f"a key has two words in its last dim, got {tuple(key.shape)}")
    if key.ndim == 1:
        return int(key[0]), int(key[1])
    k = key.to(device=device, dtype=torch.int64)
    shape = (*key.shape[:-1], *([1] * extra_dims))
    return k[..., 0].reshape(shape), k[..., 1].reshape(shape)


def _hash_counts(key: torch.Tensor, shape: tuple, device):
    """threefry of the flat index of every element of ``shape`` (high word,
    low word) under ``key`` — JAX's ``iota_2x32_shape`` counters. Returns
    the two output planes, shaped ``(*key.shape[:-1], *shape)``."""
    device = key.device if device is None else torch.device(device)
    n = math.prod(shape)
    k1, k2 = _words(key, device, len(shape))
    if key.ndim == 1 and n <= _SMALL and device.type == "cpu":
        pairs = [threefry2x32(k1, k2, i >> 32, i & MASK) for i in range(n)]
        return (torch.tensor([p[0] for p in pairs], dtype=torch.int64).reshape(shape),
                torch.tensor([p[1] for p in pairs], dtype=torch.int64).reshape(shape))
    idx = torch.arange(n, dtype=torch.int64, device=device).reshape(shape)
    hi = idx >> 32 if n > MASK else 0
    return threefry2x32(k1, k2, hi, idx)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)`` → ``(num, 2)``. A batch of keys
    ``(..., 2)`` splits each one (JAX's ``vmap(split)``) → ``(..., num, 2)``."""
    b1, b2 = _hash_counts(key, (int(num),), key.device)
    return torch.stack([b1, b2], dim=-1)


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in(key, data)``: the hash of the counter (0, data)."""
    k1, k2 = _words(key, key.device, 0)
    d = int(data) & MASK
    if key.ndim == 1:
        return torch.tensor(threefry2x32(k1, k2, 0, d), dtype=torch.int64)
    y1, y2 = threefry2x32(k1, k2, 0, d)
    return torch.stack([y1, y2], dim=-1)


def bits(key: torch.Tensor, shape, device=None) -> torch.Tensor:
    """``jax.random.bits(key, shape, uint32)`` as int64 values in
    [0, 2**32): the xor of the two hash words of each element's counter."""
    b1, b2 = _hash_counts(key, tuple(shape), device)
    return b1 ^ b2


def uniform(key: torch.Tensor, shape, device=None) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32)`` in [0, 1): the top 23 bits
    as the mantissa of a float in [1, 2), minus 1."""
    m = (bits(key, shape, device) >> 9) | 0x3F800000
    return m.to(torch.int32).view(torch.float32) - 1.0


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
