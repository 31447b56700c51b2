"""qmm — fused dequantize-matmul over int8 / packed-int4 code planes
(port of ``repro.kernels.qmm.qmm``; the CUDA source is ``csrc/qmm.cu``).

``qmm(x, codes, scale)`` = x (M, K) · (codes ⊙ scale) → (M, N) f32, the
codes dequantized in f32 and accumulated in f32 (the Pallas numerics). On a
CUDA tensor it launches the hand-written kernel or raises; on a CPU tensor
it computes :func:`qmm_plain`, the kernel's oracle.
"""
from __future__ import annotations

import collections
import ctypes

import torch

from repro_torch.quant.qtensor import unpack_int4

from . import _build

launches = 0          # kernel launches made by qmm() (plain calls excluded)
shape_launches: collections.Counter = collections.Counter()  # (packed, M, K, N) → launches
TARGET_BLOCKS = 264   # two blocks per SM of an H100 (132 SMs)
MIN_K_CHUNK = 64      # k rows per split-K block, at least eight per warp


def qmm_plain(x: torch.Tensor, codes: torch.Tensor, scale: torch.Tensor, *,
              packed: bool = False) -> torch.Tensor:
    """``x.float() @ (codes.float() * scale)`` — the f32 dequant oracle."""
    c = unpack_int4(codes) if packed else codes.to(torch.float32)
    return x.to(torch.float32) @ (c * scale.to(torch.float32).reshape(1, -1))


def block_cols(packed: bool) -> int:
    return 256 if packed else 128


def split_k(m: int, k: int, n: int, packed: bool) -> int:
    """How many K slices keep ~TARGET_BLOCKS blocks in flight when the
    (M, N) tiling alone is too small (decode: M ≤ 8, N down to 256)."""
    tiles = -(-n // block_cols(packed)) * -(-m // 8)
    want = -(-TARGET_BLOCKS // tiles)
    return max(1, min(want, k // MIN_K_CHUNK))


def _lib():
    lib = _build.load("qmm")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.qmm_launch.argtypes = [p, i, p, i, p, p, p, i, i, i, i, p]
        lib.qmm_launch.restype = i
        lib.qmm_error_string.argtypes = [i]
        lib.qmm_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def qmm(x: torch.Tensor, codes: torch.Tensor, scale: torch.Tensor, *,
        packed: bool = False) -> torch.Tensor:
    """x (M, K) bf16/f32 · codes (K, N) int8 [or (K, N/2) packed uint8]
    with scale (1, N) or (N,) f32 → (M, N) f32."""
    global launches
    if not x.is_cuda:
        return qmm_plain(x, codes, scale, packed=packed)
    m, k = x.shape
    k2, nb = codes.shape
    n = nb * 2 if packed else nb
    if k != k2:
        raise ValueError(f"qmm: x {tuple(x.shape)} vs codes {tuple(codes.shape)}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"qmm: x must be bf16 or f32, got {x.dtype}")
    want = torch.uint8 if packed else torch.int8
    if codes.dtype != want:
        raise TypeError(f"qmm: codes must be {want}, got {codes.dtype}")
    if not (codes.is_cuda and scale.is_cuda):
        raise ValueError("qmm: x, codes and scale must all be on the card")
    scale = scale.reshape(-1).to(torch.float32).contiguous()
    if scale.numel() != n:
        raise ValueError(f"qmm: scale has {scale.numel()} entries, need {n}")
    x = x.contiguous()
    codes = codes.contiguous()
    if codes.data_ptr() % 4:
        codes = codes.clone()             # 32-bit code loads need alignment
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    splits = split_k(m, k, n, packed)
    part = (torch.empty((splits, m, n), dtype=torch.float32, device=x.device)
            if splits > 1 else out)
    lib = _lib()
    err = lib.qmm_launch(
        x.data_ptr(), int(x.dtype == torch.bfloat16), codes.data_ptr(),
        int(packed), scale.data_ptr(), out.data_ptr(), part.data_ptr(),
        m, k, n, splits, torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"qmm kernel launch failed: "
                           f"{lib.qmm_error_string(err).decode()}")
    launches += 1
    shape_launches[(packed, m, k, n)] += 1
    return out
