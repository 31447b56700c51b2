"""qmm_bitplane — fused dequantize-matmul over bit-plane (MLWeaving) weights
(port of ``repro.kernels.qmm_bitplane.qmm_bitplane``; the CUDA source is
``csrc/qmm_bitplane.cu``).

``qmm_bitplane(x, planes, scale)`` = x (M, K) · decode(planes (P, K, W)) ⊙
scale (1, N) → (M, N) f32 with W = ⌈N/32⌉ and P = k + 1 (sign plane, then
k magnitude planes MSB first). Only the planes passed are read, so a
``slice_planes(k)`` view streams (k + 1)/(B + 1) of the artifact's code
bytes. On a CUDA tensor it launches the hand-written kernel on the core
:func:`plan` chooses, or raises; on a CPU tensor it computes
:func:`qmm_bitplane_plain`, the kernel's f32-decode oracle.
"""
from __future__ import annotations

import collections
import ctypes
from typing import NamedTuple

import torch

from . import _build
from ._workspace import SMS
from ._workspace import current_stream as _stream
from .ref import qmm_bitplane_ref as qmm_bitplane_plain

launches = 0          # kernel launches made by qmm_bitplane() (plain calls excluded)
simt_launches = 0     # ... of them on the SIMT core
tc_launches = 0       # ... of them on the tensor-core core
shape_launches: collections.Counter = collections.Counter()  # (P, M, K, N) → launches

CORES = {"simt": 0, "tc": 1}   # the core ids of csrc/qmm_bitplane.cu
# the tiles of each core (rows of x, columns, K step); the C side builds the
# grid from the same tiles (csrc/qmm_bitplane.cu, csrc/wgmma_tile.cuh)
TILES = {"simt": (4, 1024, 1), "tc": (128, 256, 64)}
TARGET_BLOCKS = {"simt": 2 * SMS,  # two SIMT blocks per SM
                 "tc": SMS}        # one wave of one ~201 KB block per SM
MIN_K_CHUNK = {"simt": 64,         # k rows per split: eight per warp
               "tc": 128}          # two K steps
MAX_SPLITS = {"simt": 64,          # bounds the (splits, M, N) partial plane
              "tc": 16}


class Plan(NamedTuple):
    """How one ``qmm_bitplane`` product runs: the core and the K split
    (``splits`` slices of ``k_chunk`` rows, the last one ragged)."""
    core: str
    splits: int
    k_chunk: int


def split_k(k: int, n: int, core: str) -> int:
    """How many K slices fill the card with ``core``'s blocks: as many as
    the target of blocks over the (N) column tiles asks, with at least the
    core's minimum of k rows each.

    There is no M in it, nor in the choice of core: the speculative verify
    window (M 16) must compute exactly what sequential decode (M 4)
    computes, and a prompt bucket what the rows of any other M would, so
    every row of x is summed over the same K slices in the same order at
    every M. The split is sized for decode, where the code bytes bound the
    product: a tile column streams its words from HBM, so the tile columns
    times the splits must keep every SM reading. At prefill (one 128-row
    tile holds every prompt bucket) the same split serves, since the same
    code bytes still bound the tensor-core core there (gate/up's 64 column
    tiles in 2 slices, q/o and down's 8 and k/v's 1 in 16)."""
    tiles = -(-n // TILES[core][1])
    # a tensor-core block fills an SM: at most one wave of them
    want = TARGET_BLOCKS[core] // tiles if core == "tc" else -(-TARGET_BLOCKS[core] // tiles)
    return max(1, min(want, k // MIN_K_CHUNK[core], MAX_SPLITS[core]))


def plan(k: int, n: int, x_dtype) -> Plan:
    """The one place that chooses a core, from x's dtype alone: bf16 x
    runs on the tensor cores at every M (its products are exact in bf16),
    f32 x on the SIMT core (f32 products). The K split is
    :func:`split_k`'s, in whole K steps of the core; no slice is empty."""
    core = "tc" if x_dtype == torch.bfloat16 else "simt"
    step = TILES[core][2]
    rows = -(-k // split_k(k, n, core))
    k_chunk = max(step, -(-rows // step) * step)
    return Plan(core, -(-k // k_chunk), k_chunk)


def _lib():
    lib = _build.load("qmm_bitplane")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.qmm_bitplane_launch.argtypes = [p, i, p, i, p, p, p, i, i, i, i, i, i, p]
        lib.qmm_bitplane_launch.restype = i
        lib.qmm_bitplane_error_string.argtypes = [i]
        lib.qmm_bitplane_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib



def qmm_bitplane(x: torch.Tensor, planes: torch.Tensor,
                 scale: torch.Tensor) -> torch.Tensor:
    """x (M, K) bf16/f32 · planes (P, K, ⌈N/32⌉) int32 words (the uint32
    words' bits) with scale (1, N) or (N,) f32 → (M, N) f32, P in 1..9."""
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
    return _launch(x.contiguous(), planes.contiguous(),
                   scale.reshape(-1).to(torch.float32).contiguous())


def _launch(x, planes, scale):
    """Plan the product and launch it on the planned core."""
    global launches, simt_launches, tc_launches
    m, k = x.shape
    p, n = planes.shape[0], scale.numel()
    pl = plan(k, n, x.dtype)
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    part = (torch.empty((pl.splits, m, n), dtype=torch.float32, device=x.device)
            if pl.splits > 1 else out)
    lib = _lib()
    err = lib.qmm_bitplane_launch(
        x.data_ptr(), int(x.dtype == torch.bfloat16), planes.data_ptr(), p,
        scale.data_ptr(), out.data_ptr(), part.data_ptr(), m, k, n,
        CORES[pl.core], pl.splits, pl.k_chunk, _stream(x))
    if err:
        raise RuntimeError(f"qmm_bitplane kernel launch failed ({pl}): "
                           f"{lib.qmm_bitplane_error_string(err).decode()}")
    launches += 1
    if pl.core == "tc":
        tc_launches += 1
    else:
        simt_launches += 1
    shape_launches[(p, m, k, n)] += 1
    return out


def reset_counters() -> None:
    """Set every launch counter of ``qmm_bitplane()`` to 0."""
    global launches, simt_launches, tc_launches
    launches = simt_launches = tc_launches = 0
    shape_launches.clear()
