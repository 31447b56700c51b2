"""ds_quant — fused double-sampling quantization (port of
``repro.kernels.stoch_quant.ds_quant``; the CUDA source is
``csrc/ds_quant.cu``).

``ds_quant(x, rand, scale, s=s, scale_axis=...)`` emits both int8 code
planes of the §2.2 pair from one read of x: a shared base level and two
up-bits from the high and low 16 bits of one 32-bit ``rand`` word. On a CUDA
tensor it launches the hand-written kernel or raises; on a CPU tensor it
computes :func:`ds_quant_plain`, the kernel's bit-exact oracle.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .ref import ds_quant_ref

launches = 0          # kernel launches made by ds_quant() (plain calls excluded)


ds_quant_plain = ds_quant_ref


def _lib():
    lib = _build.load("ds_quant")
    if not getattr(lib, "_typed", False):
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.ds_quant_launch.argtypes = [p, i, p, p, i, p, p, ll, ll, i, p]
        lib.ds_quant_launch.restype = i
        lib.ds_quant_error_string.argtypes = [i]
        lib.ds_quant_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def ds_quant(x: torch.Tensor, rand: torch.Tensor, scale: torch.Tensor, *,
             s: int, scale_axis: str = "row"):
    """x (R, C) f32/bf16; rand (R, C) int32 holding the bit patterns of
    uint32 words; scale (R, 1) row scales or (1, C) column scales per
    ``scale_axis``. Returns (codes1, codes2) int8 in [-s, s]."""
    global launches
    if s > 127:
        raise ValueError(f"int8 code planes need s <= 127, got {s}")
    if scale_axis not in ("row", "col"):
        raise ValueError(f"unknown scale_axis {scale_axis!r}")
    if rand.dtype != torch.int32:
        raise TypeError(f"ds_quant: rand must hold int32 words, got {rand.dtype}")
    if x.ndim != 2 or tuple(rand.shape) != tuple(x.shape):
        raise ValueError(f"ds_quant: x {tuple(x.shape)} and rand {tuple(rand.shape)} "
                         "must be the same 2-D shape")
    r, c = x.shape
    want = (r, 1) if scale_axis == "row" else (1, c)
    if scale.numel() != want[0] * want[1]:
        raise ValueError(f"ds_quant: {scale_axis} scale needs shape {want}, "
                         f"got {tuple(scale.shape)}")
    if not x.is_cuda:
        return ds_quant_plain(x, rand, scale.reshape(want), s=s)
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"ds_quant: x must be bf16 or f32, got {x.dtype}")
    if not (rand.is_cuda and scale.is_cuda):
        raise ValueError("ds_quant: x, rand and scale must all be on the card")
    x = x.contiguous()
    rand = rand.contiguous()
    scale = scale.reshape(-1).to(torch.float32).contiguous()
    c1 = torch.empty((r, c), dtype=torch.int8, device=x.device)
    c2 = torch.empty((r, c), dtype=torch.int8, device=x.device)
    lib = _lib()
    err = lib.ds_quant_launch(
        x.data_ptr(), int(x.dtype == torch.bfloat16), rand.data_ptr(),
        scale.data_ptr(), int(scale_axis == "col"), c1.data_ptr(), c2.data_ptr(),
        r, c, int(s), torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"ds_quant kernel launch failed: "
                           f"{lib.ds_quant_error_string(err).decode()}")
    launches += 1
    return c1, c2
