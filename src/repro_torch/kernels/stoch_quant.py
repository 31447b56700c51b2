"""The stochastic quantizers (port of ``repro.kernels.stoch_quant``): three
kernels, each a wrapper here over a hand-written CUDA kernel.

* ``ds_quant(x, rand, scale, s=s, scale_axis=...)`` (``csrc/ds_quant.cu``)
  emits both int8 code planes of the §2.2 pair from one read of x: a shared
  base level and two up-bits from the high and low 16 bits of one 32-bit
  ``rand`` word; ``ds_quant_keyed(x, key, scale, ...)`` is the same kernel
  hashing each element's word from ``key`` in registers (the word
  ``prng.bits(key, x.shape)`` holds there), so no plane is made;
* ``row_absmax(x)`` (``csrc/stoch_quant.cu``): (R, C) → (R, 1) f32 max|x|,
  the row scales (NaN propagates, as in ``jnp.max``);
* ``stoch_quant(x, rand, scale, s=s)`` (``csrc/stoch_quant.cu``): one int8
  plane of stochastic rounding against row scales, u = (rand ≫ 8)·2⁻²⁴.

On CUDA tensors each wrapper launches its kernel or raises; on CPU tensors
it computes its plain version (``*_plain``), the kernel's bit-exact oracle.
Every launch adds one to the kernel's counter and to ``shape_launches``
(keyed ``(kernel, R, C)``, ``ds_quant_keyed`` for the keyed entry); plain
calls count nothing.
"""
from __future__ import annotations

import collections
import ctypes

import torch

from repro_torch import prng

from . import _build
from ._workspace import current_stream as _stream
from .ref import ds_quant_ref, row_absmax_ref, stoch_quant_ref

launches = 0                  # ds_quant kernel launches (the rand entry)
keyed_launches = 0            # ds_quant kernel launches (the keyed entry)
row_absmax_launches = 0       # row_absmax kernel launches
stoch_quant_launches = 0      # stoch_quant kernel launches
shape_launches: collections.Counter = collections.Counter()  # (kernel, R, C) → launches


ds_quant_plain = ds_quant_ref
row_absmax_plain = row_absmax_ref
stoch_quant_plain = stoch_quant_ref


def reset_counts():
    """Set every launch counter of this module to 0."""
    global launches, keyed_launches, row_absmax_launches, stoch_quant_launches
    launches = keyed_launches = row_absmax_launches = stoch_quant_launches = 0
    shape_launches.clear()


def _raise(lib, name: str, err: int):
    raise RuntimeError(f"{name} kernel launch failed: "
                       f"{lib.stoch_quant_error_string(err).decode()}")


def _sq_lib():
    lib = _build.load("stoch_quant")
    if not getattr(lib, "_typed", False):
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.row_absmax_launch.argtypes = [p, i, p, ll, ll, p]
        lib.row_absmax_launch.restype = i
        lib.stoch_quant_launch.argtypes = [p, i, p, p, p, ll, ll, i, i, p]
        lib.stoch_quant_launch.restype = i
        lib.stoch_quant_error_string.argtypes = [i]
        lib.stoch_quant_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _check_x(name: str, x: torch.Tensor):
    if x.ndim != 2:
        raise ValueError(f"{name}: x must be 2-D, got {tuple(x.shape)}")
    if x.is_cuda and x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{name}: x must be bf16 or f32, got {x.dtype}")


def row_absmax(x: torch.Tensor) -> torch.Tensor:
    """(R, C) f32/bf16 → (R, 1) f32 row maxima of |x| (the paper's linf row
    scale M(v); an all-zero row gives 0, NaN propagates)."""
    _check_x("row_absmax", x)
    r, c = x.shape
    if c == 0:
        raise ValueError("row_absmax: x has no columns")
    if not x.is_cuda:
        return row_absmax_plain(x)
    return _absmax_launch(x.contiguous())


def _absmax_launch(x: torch.Tensor) -> torch.Tensor:
    """Launch ``row_absmax`` once on contiguous x: a CTA a row."""
    global row_absmax_launches
    r, c = x.shape
    out = torch.empty((r, 1), dtype=torch.float32, device=x.device)
    if r == 0:
        return out
    lib = _sq_lib()
    err = lib.row_absmax_launch(x.data_ptr(), int(x.dtype == torch.bfloat16),
                                out.data_ptr(), r, c, _stream(x))
    if err:
        _raise(lib, "row_absmax", err)
    row_absmax_launches += 1
    shape_launches[("row_absmax", r, c)] += 1
    return out


def stoch_quant(x: torch.Tensor, rand: torch.Tensor, scale: torch.Tensor, *,
                s: int) -> torch.Tensor:
    """x (R, C) f32/bf16; rand (R, C) int32 holding the bit patterns of
    uint32 words; scale (R, 1) row scales. Returns int8 codes in [-s, s]
    with E[codes/s·scale] = x (u = (rand ≫ 8)·2⁻²⁴)."""
    global stoch_quant_launches
    if not 1 <= s <= 127:
        raise ValueError(f"int8 codes need 1 <= s <= 127, got {s}")
    _check_x("stoch_quant", x)
    if rand.dtype != torch.int32:
        raise TypeError(f"stoch_quant: rand must hold int32 words, got {rand.dtype}")
    if tuple(rand.shape) != tuple(x.shape):
        raise ValueError(f"stoch_quant: x {tuple(x.shape)} and rand "
                         f"{tuple(rand.shape)} must be the same shape")
    r, c = x.shape
    if scale.numel() != r:
        raise ValueError(f"stoch_quant: row scales need shape ({r}, 1), "
                         f"got {tuple(scale.shape)}")
    if not x.is_cuda:
        return stoch_quant_plain(x, rand, scale.reshape(r, 1), s=s)
    if not (rand.is_cuda and scale.is_cuda):
        raise ValueError("stoch_quant: x, rand and scale must all be on the card")
    x = x.contiguous()
    rand = rand.contiguous()
    scale = scale.reshape(-1).to(torch.float32).contiguous()
    codes = torch.empty((r, c), dtype=torch.int8, device=x.device)
    if r * c == 0:
        return codes
    vec_io = int(x.data_ptr() % 16 == 0 and rand.data_ptr() % 16 == 0
                 and codes.data_ptr() % 4 == 0)
    lib = _sq_lib()
    err = lib.stoch_quant_launch(
        x.data_ptr(), int(x.dtype == torch.bfloat16), rand.data_ptr(), scale.data_ptr(),
        codes.data_ptr(), r, c, int(s), vec_io, _stream(x))
    if err:
        _raise(lib, "stoch_quant", err)
    stoch_quant_launches += 1
    shape_launches[("stoch_quant", r, c)] += 1
    return codes


def _lib():
    lib = _build.load("ds_quant")
    if not getattr(lib, "_typed", False):
        p, i, u, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_longlong
        lib.ds_quant_launch.argtypes = [p, i, p, p, i, p, p, ll, ll, i, p]
        lib.ds_quant_launch.restype = i
        lib.ds_quant_keyed_launch.argtypes = [p, i, u, u, p, i, p, p, ll, ll, i, p]
        lib.ds_quant_keyed_launch.restype = i
        lib.ds_quant_error_string.argtypes = [i]
        lib.ds_quant_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _ds_check(name: str, x: torch.Tensor, scale: torch.Tensor, s: int, scale_axis: str):
    """Validate a ``ds_quant`` call; returns the scale's 2-D shape."""
    if s > 127:
        raise ValueError(f"int8 code planes need s <= 127, got {s}")
    if scale_axis not in ("row", "col"):
        raise ValueError(f"unknown scale_axis {scale_axis!r}")
    if x.ndim != 2:
        raise ValueError(f"{name}: x must be 2-D, got {tuple(x.shape)}")
    r, c = x.shape
    want = (r, 1) if scale_axis == "row" else (1, c)
    if scale.numel() != want[0] * want[1]:
        raise ValueError(f"{name}: {scale_axis} scale needs shape {want}, "
                         f"got {tuple(scale.shape)}")
    if x.is_cuda:
        if x.dtype not in (torch.bfloat16, torch.float32):
            raise TypeError(f"{name}: x must be bf16 or f32, got {x.dtype}")
        if not scale.is_cuda:
            raise ValueError(f"{name}: x and scale must both be on the card")
    return want


def _ds_launch(name: str, entry, x: torch.Tensor, word_args, scale: torch.Tensor,
               s: int, scale_axis: str):
    """Launch one ``ds_quant`` entry on the card; returns (codes1, codes2)."""
    r, c = x.shape
    x = x.contiguous()
    scale = scale.reshape(-1).to(torch.float32).contiguous()
    c1 = torch.empty((r, c), dtype=torch.int8, device=x.device)
    c2 = torch.empty((r, c), dtype=torch.int8, device=x.device)
    err = entry(x.data_ptr(), int(x.dtype == torch.bfloat16), *word_args,
                scale.data_ptr(), int(scale_axis == "col"), c1.data_ptr(), c2.data_ptr(),
                r, c, int(s), _stream(x))
    if err:
        raise RuntimeError(f"{name} kernel launch failed: "
                           f"{_lib().ds_quant_error_string(err).decode()}")
    shape_launches[(name, r, c)] += 1
    return c1, c2


def ds_quant(x: torch.Tensor, rand: torch.Tensor, scale: torch.Tensor, *,
             s: int, scale_axis: str = "row"):
    """x (R, C) f32/bf16; rand (R, C) int32 holding the bit patterns of
    uint32 words; scale (R, 1) row scales or (1, C) column scales per
    ``scale_axis``. Returns (codes1, codes2) int8 in [-s, s]."""
    global launches
    want = _ds_check("ds_quant", x, scale, s, scale_axis)
    if rand.dtype != torch.int32:
        raise TypeError(f"ds_quant: rand must hold int32 words, got {rand.dtype}")
    if tuple(rand.shape) != tuple(x.shape):
        raise ValueError(f"ds_quant: x {tuple(x.shape)} and rand {tuple(rand.shape)} "
                         "must be the same 2-D shape")
    if not x.is_cuda:
        return ds_quant_plain(x, rand, scale.reshape(want), s=s)
    if not rand.is_cuda:
        raise ValueError("ds_quant: x, rand and scale must all be on the card")
    out = _ds_launch("ds_quant", _lib().ds_quant_launch, x,
                     (rand.contiguous().data_ptr(),), scale, s, scale_axis)
    launches += 1
    return out


def ds_quant_keyed(x: torch.Tensor, key: torch.Tensor, scale: torch.Tensor, *,
                   s: int, scale_axis: str = "row"):
    """:func:`ds_quant` with the words of ``prng.bits(key, x.shape)``
    hashed in the kernel's registers: one launch, no plane. ``key`` is one
    threefry key, a (2,) integer tensor on the host. On CPU tensors it
    computes ``ds_quant_plain(x, prng.bits(key, x.shape), scale)``."""
    global keyed_launches
    want = _ds_check("ds_quant_keyed", x, scale, s, scale_axis)
    if tuple(key.shape) != (2,) or key.dtype.is_floating_point:
        raise ValueError(f"ds_quant_keyed: key must be one (2,) integer key, got "
                         f"{key.dtype}{list(key.shape)}")
    if not x.is_cuda:
        rand = prng.bits(key, x.shape, device=x.device, dtype=torch.int32)
        return ds_quant_plain(x, rand, scale.reshape(want), s=s)
    k1, k2 = int(key[0]) & prng.MASK, int(key[1]) & prng.MASK
    out = _ds_launch("ds_quant_keyed", _lib().ds_quant_keyed_launch, x, (k1, k2), scale,
                     s, scale_axis)
    keyed_launches += 1
    return out
