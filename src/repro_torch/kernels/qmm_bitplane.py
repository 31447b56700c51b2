"""qmm_bitplane — fused dequantize-matmul over bit-plane (MLWeaving) weights
(port of ``repro.kernels.qmm_bitplane.qmm_bitplane``; the CUDA source is
``csrc/qmm_bitplane.cu``).

``qmm_bitplane(x, planes, scale)`` = x (M, K) · decode(planes (P, K, W)) ⊙
scale (1, N) → (M, N) f32 with W = ⌈N/32⌉ and P = k + 1 (sign plane, then
k magnitude planes MSB first). Only the planes passed are read, so a
``slice_planes(k)`` view streams (k + 1)/(B + 1) of the artifact's code
bytes. On a CUDA tensor it launches the hand-written kernel or raises; on a
CPU tensor it computes :func:`qmm_bitplane_plain`, the kernel's f32-decode
oracle.
"""
from __future__ import annotations

import collections
import ctypes

import torch

from . import _build
from .ref import qmm_bitplane_ref as qmm_bitplane_plain

launches = 0          # kernel launches made by qmm_bitplane() (plain calls excluded)
shape_launches: collections.Counter = collections.Counter()  # (P, M, K, N) → launches
TARGET_BLOCKS = 264   # two blocks per SM of an H100 (132 SMs)
MIN_K_CHUNK = 64      # k rows per split-K block, at least eight per warp
MAX_SPLITS = 64       # bounds the (splits, M, N) partial plane at prefill
BLOCK_WORDS = 32      # 32-column words per block (one per lane)


def split_k(k: int, n: int) -> int:
    """How many K slices keep ~TARGET_BLOCKS blocks in flight at decode.
    It depends on (K, N) only, never on M, so every row of x is summed in
    the same order at every M (a decode step and a verify window agree)."""
    words = -(-n // 32)
    tiles = -(-words // BLOCK_WORDS)
    want = -(-TARGET_BLOCKS // tiles)
    return max(1, min(want, k // MIN_K_CHUNK, MAX_SPLITS))


def _lib():
    lib = _build.load("qmm_bitplane")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.qmm_bitplane_launch.argtypes = [p, i, p, i, p, p, p, i, i, i, i, p]
        lib.qmm_bitplane_launch.restype = i
        lib.qmm_bitplane_error_string.argtypes = [i]
        lib.qmm_bitplane_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def qmm_bitplane(x: torch.Tensor, planes: torch.Tensor,
                 scale: torch.Tensor) -> torch.Tensor:
    """x (M, K) bf16/f32 · planes (P, K, ⌈N/32⌉) int32 words (the uint32
    words' bits) with scale (1, N) or (N,) f32 → (M, N) f32, P in 1..9."""
    global launches
    if not x.is_cuda:
        return qmm_bitplane_plain(x, planes, scale)
    m, k = x.shape
    p, k2, w = planes.shape
    n = scale.numel()
    if k != k2 or w != -(-n // 32):
        raise ValueError(f"qmm_bitplane: x {tuple(x.shape)}, planes "
                         f"{tuple(planes.shape)} and {n} scales do not match")
    if not 1 <= p <= 9:
        raise ValueError(f"qmm_bitplane: {p} planes, need 1..9")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"qmm_bitplane: x must be bf16 or f32, got {x.dtype}")
    if planes.dtype != torch.int32:
        raise TypeError(f"qmm_bitplane: planes must be int32 words, got {planes.dtype}")
    if not (planes.is_cuda and scale.is_cuda):
        raise ValueError("qmm_bitplane: x, planes and scale must all be on the card")
    x = x.contiguous()
    planes = planes.contiguous()
    scale = scale.reshape(-1).to(torch.float32).contiguous()
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    splits = split_k(k, n)
    part = (torch.empty((splits, m, n), dtype=torch.float32, device=x.device)
            if splits > 1 else out)
    lib = _lib()
    err = lib.qmm_bitplane_launch(
        x.data_ptr(), int(x.dtype == torch.bfloat16), planes.data_ptr(), p,
        scale.data_ptr(), out.data_ptr(), part.data_ptr(), m, k, n, splits,
        torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"qmm_bitplane kernel launch failed: "
                           f"{lib.qmm_bitplane_error_string(err).decode()}")
    launches += 1
    shape_launches[(p, m, k, n)] += 1
    return out
