"""qmv — int8 code plane times an f32 vector (port of
``repro.kernels.qmm.qmv``; the CUDA source is ``csrc/qmv.cu``).

``qmv(codes, v)`` = codes (R, C) · v (C,) → (R,) f32, the codes widened to
f32 and accumulated in f32. The plane is read through its strides, so a
transposed view (``codes.T``) goes to the kernel as it is, without a copy.
On a CUDA tensor it launches the hand-written kernel or raises; on a CPU
tensor it computes :func:`qmv_plain`, the kernel's oracle.
"""
from __future__ import annotations

import collections
import ctypes

import torch

from . import _build
from .ref import qmv_ref

launches = 0          # kernel launches made by qmv() (plain calls excluded)
shape_launches: collections.Counter = collections.Counter()  # (R, C, cols) → launches
TARGET_BLOCKS = 264   # two blocks per SM of an H100 (132 SMs)
ROW_WARPS = 8         # output rows per block in the warp-per-row layout
COL_THREADS = 256     # output rows per block in the thread-per-row layout


qmv_plain = qmv_ref


def plan(r: int, c: int, cols: bool) -> tuple[int, int]:
    """(splits, chunk): how many column chunks keep ~TARGET_BLOCKS blocks in
    flight, and the chunk width (a multiple of 4, for the 4-code loads)."""
    tiles = -(-r // (COL_THREADS if cols else ROW_WARPS))
    min_chunk = 16 if cols else 512
    splits = max(1, min(-(-TARGET_BLOCKS // tiles), -(-c // min_chunk), 65535))
    chunk = -(-c // splits)
    chunk += -chunk % 4
    return -(-c // chunk), chunk


def _lib():
    lib = _build.load("qmv")
    if not getattr(lib, "_typed", False):
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.qmv_launch.argtypes = [p, ll, ll, p, p, p, i, i, i, i, i, i, p]
        lib.qmv_launch.restype = i
        lib.qmv_error_string.argtypes = [i]
        lib.qmv_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def qmv(codes: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """codes (R, C) int8, any strides; v (C,) → (R,) f32."""
    global launches
    if codes.ndim != 2 or v.ndim != 1 or v.shape[0] != codes.shape[1]:
        raise ValueError(f"qmv: codes {tuple(codes.shape)} vs v {tuple(v.shape)}")
    if not codes.is_cuda:
        return qmv_plain(codes, v)
    if codes.dtype != torch.int8:
        raise TypeError(f"qmv: codes must be int8, got {codes.dtype}")
    if not v.is_cuda:
        raise ValueError("qmv: codes and v must both be on the card")
    r, c = codes.shape
    sr, sc = codes.stride()
    cols = sr == 1 and r > 1
    splits, chunk = plan(r, c, cols)
    vec = int(not cols and sc == 1 and sr % 4 == 0 and codes.data_ptr() % 4 == 0)
    v = v.to(torch.float32).contiguous()
    out = torch.empty(r, dtype=torch.float32, device=codes.device)
    part = (torch.empty((splits, r), dtype=torch.float32, device=codes.device)
            if splits > 1 else out)
    lib = _lib()
    err = lib.qmv_launch(codes.data_ptr(), sr, sc, v.data_ptr(), out.data_ptr(),
                         part.data_ptr(), r, c, int(cols), vec, splits, chunk,
                         torch.cuda.current_stream(codes.device).cuda_stream)
    if err:
        raise RuntimeError(f"qmv kernel launch failed: "
                           f"{lib.qmv_error_string(err).decode()}")
    launches += 1
    shape_launches[(r, c, cols)] += 1
    return out
