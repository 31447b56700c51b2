"""qmm — fused dequantize-matmul over int8 / packed-int4 code planes
(port of ``repro.kernels.qmm.qmm``; the CUDA source is ``csrc/qmm.cu``).

``qmm(x, codes, scale)`` = x (M, K) · (codes ⊙ scale) → (M, N) f32 with f32
accumulation; the per-column scale multiplies after the contraction, so
the kernel's products are those of the codes (exact in bf16: the
tensor-core core's operands). On a CUDA tensor it launches the hand-written
kernel on the core :func:`plan` chooses, or raises; on a CPU tensor it
computes :func:`qmm_plain`, the kernel's oracle (f32 dequant, then f32
accumulation: the Pallas numerics).
"""
from __future__ import annotations

import collections
import ctypes
from typing import NamedTuple

import torch

from repro_torch.quant.qtensor import unpack_int4

from . import _build
from ._workspace import SMS
from ._workspace import current_stream as _stream

launches = 0          # kernel launches made by qmm() (plain calls excluded)
simt_launches = 0     # ... of them on the SIMT core
tc_launches = 0       # ... of them on the tensor-core core
shape_launches: collections.Counter = collections.Counter()  # (packed, M, K, N) → launches

# plan()'s rule: bf16 x with more rows than TC_THRESHOLD takes the
# tensor-core core, everything else the SIMT core. Set from both cores'
# times on an H100 80GB HBM3 at 700 W over every gemma-2b projection at
# int8 and int4 (scripts/qmm_core_sweep.py --ms 4,5,6,7,8,9; PERF.md §6):
# at M 5-8 the two lie within ±9 % of each other, and from M 9 the tensor
# cores win every shape
TC_THRESHOLD = 8
CORES = {"simt": 0, "tc": 1}   # the core ids of csrc/qmm_core.cuh
# the tiles that split-K counts (rows of x, columns) and the K step of a
# split; the C side builds the grid from the same tiles (csrc/qmm_core.cuh)
TILES = {"simt": (4, 512, 1), "tc": (128, 256, 64)}
TARGET_BLOCKS = {"simt": 2 * SMS,  # 2 blocks per SM, ~32 KB of codes in flight
                 "tc": SMS}        # one wave of one 193 KB block per SM
MIN_K_CHUNK = {"simt": 64,         # k rows per split: eight per warp
               "tc": 128}          # two K steps


class Plan(NamedTuple):
    """How one ``qmm`` product runs: the core and the K split (``splits``
    slices of ``k_chunk`` rows, the last one ragged)."""
    core: str
    splits: int
    k_chunk: int


def plan(m: int, k: int, n: int, x_dtype) -> Plan:
    """The one place that chooses a core: bf16 x with M above
    ``TC_THRESHOLD`` goes to the tensor cores, everything else (decode M,
    f32 x at any M) to the SIMT core. K is split only where the (M, N)
    tiles alone cannot fill the card's SMs, then into as many slices as
    the core's target of blocks holds (one wave), but none with fewer
    than the core's minimum of k rows."""
    core = "tc" if x_dtype == torch.bfloat16 and m > TC_THRESHOLD else "simt"
    bm, bn, step = TILES[core]
    tiles = -(-m // bm) * -(-n // bn)
    splits = 1 if tiles >= SMS else max(
        1, min(TARGET_BLOCKS[core] // tiles, k // MIN_K_CHUNK[core]))
    rows = -(-k // splits)
    k_chunk = max(step, -(-rows // step) * step)
    return Plan(core, -(-k // k_chunk), k_chunk)


def qmm_plain(x: torch.Tensor, codes: torch.Tensor, scale: torch.Tensor, *,
              packed: bool = False) -> torch.Tensor:
    """``x.float() @ (codes.float() * scale)`` — the f32 dequant oracle."""
    c = unpack_int4(codes) if packed else codes.to(torch.float32)
    return x.to(torch.float32) @ (c * scale.to(torch.float32).reshape(1, -1))


def _lib():
    lib = _build.load("qmm")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.qmm_launch.argtypes = [p, i, p, i, p, p, p, i, i, i, i, i, i, p]
        lib.qmm_launch.restype = i
        lib.qmm_error_string.argtypes = [i]
        lib.qmm_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def qmm(x: torch.Tensor, codes: torch.Tensor, scale: torch.Tensor, *,
        packed: bool = False) -> torch.Tensor:
    """x (M, K) bf16/f32 · codes (K, N) int8 [or (K, N/2) packed uint8]
    with scale (1, N) or (N,) f32 → (M, N) f32."""
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
    return _launch(x.contiguous(), codes.contiguous(), scale, packed)



def _launch(x, codes, scale, packed):
    """Plan the product and launch it (codes may be any view: the kernels
    read unaligned bases in place)."""
    global launches, simt_launches, tc_launches
    m, k = x.shape
    n = codes.shape[1] * 2 if packed else codes.shape[1]
    p = plan(m, k, n, x.dtype)
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    part = (torch.empty((p.splits, m, n), dtype=torch.float32, device=x.device)
            if p.splits > 1 else out)
    lib = _lib()
    err = lib.qmm_launch(
        x.data_ptr(), int(x.dtype == torch.bfloat16), codes.data_ptr(),
        int(packed), scale.data_ptr(), out.data_ptr(), part.data_ptr(),
        m, k, n, CORES[p.core], p.splits, p.k_chunk, _stream(x))
    if err:
        raise RuntimeError(f"qmm kernel launch failed ({p}): "
                           f"{lib.qmm_error_string(err).decode()}")
    launches += 1
    if p.core == "tc":
        tc_launches += 1
    else:
        simt_launches += 1
    shape_launches[(packed, m, k, n)] += 1
    return out


def reset_counters() -> None:
    """Set every launch counter of ``qmm()`` to 0."""
    global launches, simt_launches, tc_launches
    launches = simt_launches = tc_launches = 0
    shape_launches.clear()
