"""qmm_t — the transposed dequantize-matmul dx = g · (codes ⊙ scale)ᵀ
(port of ``repro.kernels.qmm.qmm_t``; the CUDA source is ``csrc/qmm_t.cu``).

The code-domain backward of ``quant_dense``: g (M, N) against the (K, N)
code plane of the forward's weight gives dx (M, K) in f32, within f32
rounding of the f32-dequant product (the Pallas numerics). It is also the
tied unembed of a quantized table (M 4 at decode, 1 per prefill readout,
K the vocabulary). On a CUDA tensor it launches the hand-written kernel on
the core :func:`plan` chooses, or raises; on a CPU tensor it computes
:func:`qmm_t_plain`, the kernel's oracle.
"""
from __future__ import annotations

import collections
import ctypes
from typing import NamedTuple

import torch

from . import _build
from ._workspace import SMS
from ._workspace import current_stream as _stream
from .ref import qmm_t_ref

launches = 0          # kernel launches made by qmm_t() (plain calls excluded)
stream_launches = 0   # ... of them on the streaming core
tc_launches = 0       # ... of them on the tensor-core core
shape_launches: collections.Counter = collections.Counter()  # (packed, M, K, N) → launches

qmm_t_plain = qmm_t_ref

# plan()'s rule: g with more rows than TC_THRESHOLD takes the tensor-core
# core (three bf16 pieces of g · scale), everything else the streaming
# core. Started from qmm.TC_THRESHOLD; scripts/qmm_t_core_sweep.py times
# both cores at M 1-32 over the path's (K, N) (PERF.md §6)
TC_THRESHOLD = 8
CORES = {"stream": 0, "tc": 1}   # the core ids of csrc/qmm_t.cu
# the tensor-core tile (dx rows, dx columns, contraction step); the C side
# builds its grid from the same tile (csrc/qmm_t.cu · tct)
TC_TILE = (128, 256, 64)         # one ~193 KB block per SM: a wave is SMS blocks
MIN_N_CHUNK = 128                # contraction columns per split: two steps


class Plan(NamedTuple):
    """How one ``qmm_t`` product runs: the core and the contraction split
    (``splits`` slices of ``n_chunk`` columns of N, the last one ragged)."""
    core: str
    splits: int
    n_chunk: int


def plan(m: int, k: int, n: int) -> Plan:
    """The one place that chooses a core, from M alone: M above
    ``TC_THRESHOLD`` goes to the tensor cores, whatever g's dtype (the
    training backward hands over f32 g), M up to it to the streaming core,
    whose blocks are row ranges of the code plane and never split. The
    tensor cores' contraction is split only where the (M, K) tiles alone
    cannot fill the card's SMs, then into as many slices as one wave
    holds, none with fewer than ``MIN_N_CHUNK`` columns."""
    if m <= TC_THRESHOLD:
        return Plan("stream", 1, n)
    bm, bk, step = TC_TILE
    tiles = -(-m // bm) * -(-k // bk)
    splits = 1 if tiles >= SMS else max(1, min(SMS // tiles, n // MIN_N_CHUNK))
    cols = -(-n // splits)
    n_chunk = max(step, -(-cols // step) * step)
    return Plan("tc", -(-n // n_chunk), n_chunk)


def split_bf16x3(v: torch.Tensor):
    """The kernel's split of f32 ``v`` into three bf16 pieces (hi, mid,
    lo), in plain torch (for the tests): hi = bf16(v), mid = bf16(v − hi),
    lo = bf16(v − hi − mid), every subtraction exact in f32, so that
    hi + mid + lo == v wherever |v| ≥ 2^−110."""
    v = v.to(torch.float32)
    hi = v.to(torch.bfloat16)
    r = v - hi.to(torch.float32)
    mid = r.to(torch.bfloat16)
    lo = (r - mid.to(torch.float32)).to(torch.bfloat16)
    return hi, mid, lo


def _lib():
    lib = _build.load("qmm_t")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.qmm_t_launch.argtypes = [p, i, p, i, p, p, p, p, i, i, i, i, i, i, p]
        lib.qmm_t_launch.restype = i
        lib.qmm_t_error_string.argtypes = [i]
        lib.qmm_t_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib



def qmm_t(g: torch.Tensor, codes: torch.Tensor, scale: torch.Tensor, *,
          packed: bool = False) -> torch.Tensor:
    """g (M, N) bf16/f32 · [codes (K, N) int8 or (K, N/2) packed uint8 with
    scale (1, N) or (N,) f32]ᵀ → (M, K) f32."""
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
    return _launch(g.contiguous(), codes.contiguous(), scale, packed)


def _launch(g, codes, scale, packed):
    """Plan the product and launch it on the planned core."""
    global launches, stream_launches, tc_launches
    m, n = g.shape
    k = codes.shape[0]
    p = plan(m, k, n)
    out = torch.empty((m, k), dtype=torch.float32, device=g.device)
    part = (torch.empty((p.splits, m, k), dtype=torch.float32, device=g.device)
            if p.splits > 1 else out)
    # the tensor-core core's three bf16 planes of g · scale (hi, mid, lo)
    pieces = (torch.empty((3, m, n), dtype=torch.bfloat16, device=g.device)
              if p.core == "tc" else out)
    lib = _lib()
    err = lib.qmm_t_launch(
        g.data_ptr(), int(g.dtype == torch.bfloat16), codes.data_ptr(), int(packed),
        scale.data_ptr(), out.data_ptr(), part.data_ptr(), pieces.data_ptr(), m, k, n,
        CORES[p.core], p.splits, p.n_chunk, _stream(g))
    if err:
        raise RuntimeError(f"qmm_t kernel launch failed ({p}): "
                           f"{lib.qmm_t_error_string(err).decode()}")
    launches += 1
    if p.core == "tc":
        tc_launches += 1
    else:
        stream_launches += 1
    shape_launches[(packed, m, k, n)] += 1
    return out


def reset_counters() -> None:
    """Set every launch counter of ``qmm_t()`` to 0."""
    global launches, stream_launches, tc_launches
    launches = stream_launches = tc_launches = 0
    shape_launches.clear()
