"""qmm_t — the transposed dequantize-matmul dx = g · (codes ⊙ scale)ᵀ
(port of ``repro.kernels.qmm.qmm_t``; the CUDA source is ``csrc/qmm_t.cu``).

The code-domain backward of ``quant_dense``: g (M, N) against the (K, N)
code plane of the forward's weight gives dx (M, K) in f32, the codes
dequantized in f32 and accumulated in f32 (the Pallas numerics). On a CUDA
tensor it launches the hand-written kernel or raises; on a CPU tensor it
computes :func:`qmm_t_plain`, the kernel's oracle.
"""
from __future__ import annotations

import collections
import ctypes

import torch

from . import _build
from .ref import qmm_t_ref

launches = 0          # kernel launches made by qmm_t() (plain calls excluded)
shape_launches: collections.Counter = collections.Counter()  # (packed, M, K, N) → launches


qmm_t_plain = qmm_t_ref


def _lib():
    lib = _build.load("qmm_t")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.qmm_t_launch.argtypes = [p, i, p, i, p, p, i, i, i, p]
        lib.qmm_t_launch.restype = i
        lib.qmm_t_error_string.argtypes = [i]
        lib.qmm_t_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def qmm_t(g: torch.Tensor, codes: torch.Tensor, scale: torch.Tensor, *,
          packed: bool = False) -> torch.Tensor:
    """g (M, N) bf16/f32 · [codes (K, N) int8 or (K, N/2) packed uint8 with
    scale (1, N) or (N,) f32]ᵀ → (M, K) f32."""
    global launches
    if not g.is_cuda:
        return qmm_t_plain(g, codes, scale, packed=packed)
    m, n = g.shape
    k, nb = codes.shape
    if n != (nb * 2 if packed else nb):
        raise ValueError(f"qmm_t: g {tuple(g.shape)} vs codes {tuple(codes.shape)}")
    if g.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"qmm_t: g must be bf16 or f32, got {g.dtype}")
    want = torch.uint8 if packed else torch.int8
    if codes.dtype != want:
        raise TypeError(f"qmm_t: codes must be {want}, got {codes.dtype}")
    if not (codes.is_cuda and scale.is_cuda):
        raise ValueError("qmm_t: g, codes and scale must all be on the card")
    scale = scale.reshape(-1).to(torch.float32).contiguous()
    if scale.numel() != n:
        raise ValueError(f"qmm_t: scale has {scale.numel()} entries, need {n}")
    g = g.contiguous()
    codes = codes.contiguous()
    out = torch.empty((m, k), dtype=torch.float32, device=g.device)
    lib = _lib()
    err = lib.qmm_t_launch(
        g.data_ptr(), int(g.dtype == torch.bfloat16), codes.data_ptr(),
        int(packed), scale.data_ptr(), out.data_ptr(), m, k, n,
        torch.cuda.current_stream(g.device).cuda_stream)
    if err:
        raise RuntimeError(f"qmm_t kernel launch failed: "
                           f"{lib.qmm_t_error_string(err).decode()}")
    launches += 1
    shape_launches[(packed, m, k, n)] += 1
    return out
