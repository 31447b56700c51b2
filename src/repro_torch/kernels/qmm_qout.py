"""qmm_qout — the dequantize-matmul with a fused double-sampling epilogue
(port of ``repro.kernels.qmm.qmm_qout``; the CUDA source is
``csrc/qmm_qout.cu``).

``qmm_qout(x, codes, scale, rand, qmax=...)`` = the §2.2 row-scaled pair
(codes1, codes2 int8 (M, N), row scales (M, 1) f32) of
y = x (M, K) · (codes ⊙ scale) rounded to ``out_dtype``, both planes drawn
from the high and low 16 bits of one uint32 ``rand`` word per element. On a
CUDA tensor it launches the hand-written kernel or raises; on a CPU tensor
it computes :func:`qmm_qout_plain`, the kernel's oracle. The kernel's
product is ``qmm``'s own (the same source, and the core and split
order that :func:`~repro_torch.kernels.qmm.plan` gives ``qmm``), so its
output equals ``qmm`` → cast →
:func:`~repro_torch.kernels.ref.ds_row_pair_ref` bit for bit.
"""
from __future__ import annotations

import collections
import ctypes

import torch

from . import _build
from .qmm import CORES, _stream, plan
from .ref import qmm_qout_ref

launches = 0          # kernel launches made by qmm_qout() (plain calls excluded)
simt_launches = 0     # ... of them with the product on the SIMT core
tc_launches = 0       # ... of them with the product on the tensor-core core
shape_launches: collections.Counter = collections.Counter()  # (packed, M, K, N) → launches

qmm_qout_plain = qmm_qout_ref

_OUT_DTYPES = (torch.bfloat16, torch.float32)


def _lib():
    lib = _build.load("qmm_qout")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.qmm_qout_launch.argtypes = [p, i, p, i, p, p, p, p, p, p,
                                        i, i, i, i, i, i, i, i, p]
        lib.qmm_qout_launch.restype = i
        lib.qmm_qout_error_string.argtypes = [i]
        lib.qmm_qout_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def qmm_qout(x: torch.Tensor, codes: torch.Tensor, scale: torch.Tensor,
             rand: torch.Tensor, *, qmax: int, packed: bool = False,
             out_dtype=torch.bfloat16):
    """x (M, K) bf16/f32 · codes (K, N) int8 [or (K, N/2) packed uint8]
    with scale (1, N) or (N,) f32, rand (M, N) int32 (uint32 bit patterns)
    → (codes1, codes2 (M, N) int8, row scales (M, 1) f32)."""
    if not x.is_cuda:
        return qmm_qout_plain(x, codes, scale, rand, qmax=qmax, packed=packed,
                              out_dtype=out_dtype)
    m, k = x.shape
    k2, nb = codes.shape
    n = nb * 2 if packed else nb
    if k != k2:
        raise ValueError(f"qmm_qout: x {tuple(x.shape)} vs codes {tuple(codes.shape)}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"qmm_qout: x must be bf16 or f32, got {x.dtype}")
    if out_dtype not in _OUT_DTYPES:
        raise TypeError(f"qmm_qout: out_dtype must be bf16 or f32, got {out_dtype}")
    want = torch.uint8 if packed else torch.int8
    if codes.dtype != want:
        raise TypeError(f"qmm_qout: codes must be {want}, got {codes.dtype}")
    if rand.dtype not in (torch.int32, torch.uint32) or tuple(rand.shape) != (m, n):
        raise ValueError(f"qmm_qout: rand must be ({m}, {n}) 32-bit words, got "
                         f"{rand.dtype}{list(rand.shape)}")
    if not 1 <= qmax <= 127:
        raise ValueError(f"qmm_qout: qmax must be in 1..127 for int8 codes, got {qmax}")
    if not (codes.is_cuda and scale.is_cuda and rand.is_cuda):
        raise ValueError("qmm_qout: x, codes, scale and rand must all be on the card")
    scale = scale.reshape(-1).to(torch.float32).contiguous()
    if scale.numel() != n:
        raise ValueError(f"qmm_qout: scale has {scale.numel()} entries, need {n}")
    return _launch(x.contiguous(), codes.contiguous(), scale, rand.contiguous(), qmax,
                   packed, out_dtype)


def _launch(x, codes, scale, rand, qmax, packed, out_dtype):
    """Plan the product as ``qmm`` plans it for the same operands (the same
    core and K splits: the bit-equality with ``qmm`` → cast → encode
    rests on it) and launch both kernels."""
    global launches, simt_launches, tc_launches
    m, k = x.shape
    n = codes.shape[1] * 2 if packed else codes.shape[1]
    p = plan(m, k, n, x.dtype)
    part = torch.empty((p.splits, m, n), dtype=torch.float32, device=x.device)
    c1 = torch.empty((m, n), dtype=torch.int8, device=x.device)
    c2 = torch.empty((m, n), dtype=torch.int8, device=x.device)
    oscale = torch.empty((m, 1), dtype=torch.float32, device=x.device)
    lib = _lib()
    err = lib.qmm_qout_launch(
        x.data_ptr(), int(x.dtype == torch.bfloat16), codes.data_ptr(), int(packed),
        scale.data_ptr(), rand.data_ptr(), part.data_ptr(), c1.data_ptr(),
        c2.data_ptr(), oscale.data_ptr(), m, k, n, CORES[p.core], p.splits, p.k_chunk,
        int(qmax), int(out_dtype == torch.bfloat16), _stream(x))
    if err:
        raise RuntimeError(f"qmm_qout kernel launch failed ({p}): "
                           f"{lib.qmm_qout_error_string(err).decode()}")
    launches += 1
    if p.core == "tc":
        tc_launches += 1
    else:
        simt_launches += 1
    shape_launches[(packed, m, k, n)] += 1
    return c1, c2, oscale


def reset_counters() -> None:
    """Set every launch counter of ``qmm_qout()`` to 0."""
    global launches, simt_launches, tc_launches
    launches = simt_launches = tc_launches = 0
    shape_launches.clear()
