"""qmv — int8 code plane times an f32 vector (port of
``repro.kernels.qmm.qmv``; the CUDA source is ``csrc/qmv.cu``).

``qmv(codes, v)`` = codes (R, C) · v (C,) → (R,) f32, the codes widened to
f32 and accumulated in f32. The plane is read through its strides, so a
transposed view (``codes.T``) goes to the kernel as it is, without a copy.
On a CUDA tensor it launches the hand-written kernel once or raises (one
CUDA launch at every shape: where :func:`plan` splits C, the last block to
arrive merges the chunks in order through a per-device workspace); on a
CPU tensor it computes :func:`qmv_plain`, the kernel's oracle.
"""
from __future__ import annotations

import collections
import ctypes
from typing import NamedTuple

import torch

from . import _build
from .ref import qmv_ref

launches = 0          # kernel launches made by qmv() (plain calls excluded)
shape_launches: collections.Counter = collections.Counter()  # (R, C, cols) → launches
THREADS = 128         # csrc/qmv.cu · kThreads: a block
MAX_UNROLL = 8        # rows: vector loads per thread (a compile-time unroll)
MAX_COLS_STEP = 16    # cols: columns per thread (a compile-time unroll)
# R-contiguous planes with more rows than this take "cols"; up to it a block
# per output row ("rows", any strides) is one wave and the faster:
# yearprediction's (90, 16) view 0.0058 ms against 0.0063 on cols, gisette's
# (5000, 16) 0.0089 against 0.0066 (PERF.md §6)
COLS_MIN_ROWS = 256
LAYOUTS = {"rows": 0, "cols": 1}

qmv_plain = qmv_ref


class Plan(NamedTuple):
    """How one ``qmv`` call runs. ``layout`` "rows" (a block per output
    row, C contiguous) or "cols" (a thread per ``width`` consecutive
    outputs, R contiguous: the transposed view); ``width`` the code bytes
    of one load (rows 16, 8, 4 or 1; cols 4, 2 or 1 rows of a column);
    ``unroll`` the loads (rows) or columns (cols) of one thread, all issued
    before the first FMA; C in ``splits`` chunks of ``chunk`` columns;
    ``tiles`` the blocks along R; ``ws`` the f32 partials and
    ``counters`` the int32 arrival counters a split call needs (0 and 0
    when it does not split)."""
    layout: str
    width: int
    unroll: int
    splits: int
    chunk: int
    tiles: int
    ws: int
    counters: int


def _pow2_at_least(n: int) -> int:
    return 1 << max(0, n - 1).bit_length()


def plan(r: int, c: int, sr: int, sc: int, base: int) -> Plan:
    """The layout, the load width and the split of an (r, c) plane read at
    element strides (sr, sc) from address ``base``, from those alone.
    R-contiguous planes (sr 1) of more than ``COLS_MIN_ROWS`` rows take
    "cols", every other "rows".
    Rows: the widest of 16, 8, 4 bytes that the row addresses allow (sc 1,
    base and sr multiples of it), else single codes; a block covers
    THREADS · MAX_UNROLL loads of a row in one step, and C splits only
    where one step would not cover it. Cols: 4 rows a thread where base
    and sc are multiples of 4, else 2 or 1; C splits into chunks of at
    most MAX_COLS_STEP columns, so every thread's loads are one step."""
    if r < 1 or c < 1:
        raise ValueError(f"qmv: empty plane ({r}, {c})")
    if sr == 1 and r > COLS_MIN_ROWS:
        width = next(w for w in (4, 2, 1) if (base | sc) % w == 0)
        splits = -(-c // MAX_COLS_STEP)
        chunk = -(-c // splits)
        splits = -(-c // chunk)
        tiles = -(-r // (THREADS * width))
        unroll = _pow2_at_least(chunk)
        layout = "cols"
    else:
        width = next((w for w in (16, 8, 4) if sc == 1 and (base | sr) % w == 0), 1)
        splits = -(-c // (THREADS * MAX_UNROLL * width))
        chunk = -(-c // splits)
        chunk += -chunk % width
        splits = -(-c // chunk)
        tiles = r
        unroll = _pow2_at_least(-(-chunk // (THREADS * width)))
        layout = "rows"
    if splits > 65535:
        raise ValueError(f"qmv: ({r}, {c}) needs {splits} chunks, more than a grid holds")
    split = splits > 1
    return Plan(layout, width, unroll, splits, chunk, tiles,
                splits * r if split else 0, tiles if split else 0)


def _lib():
    lib = _build.load("qmv")
    if not getattr(lib, "_typed", False):
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.qmv_launch.argtypes = [p, ll, ll, p, p, p, p, i, i, i, i, i, i, i, p]
        lib.qmv_launch.restype = i
        lib.qmv_error_string.argtypes = [i]
        lib.qmv_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


# per (device, stream): the chunk partials and the arrival counters, grown
# when a call needs more; the counters are zeroed only when allocated, and
# every launch leaves them at 0
_WORKSPACE: dict = {}


def _workspace(device, stream: int, p: Plan):
    ws, counters = _WORKSPACE.get((device, stream), (None, None))
    if ws is None or ws.numel() < p.ws:
        ws = torch.empty(max(p.ws, 1), dtype=torch.float32, device=device)
    if counters is None or counters.numel() < p.counters:
        counters = torch.zeros(max(p.counters, 1), dtype=torch.int32, device=device)
    _WORKSPACE[(device, stream)] = (ws, counters)
    return ws, counters


def qmv(codes: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """codes (R, C) int8, any strides; v (C,) → (R,) f32."""
    if codes.ndim != 2 or v.ndim != 1 or v.shape[0] != codes.shape[1]:
        raise ValueError(f"qmv: codes {tuple(codes.shape)} vs v {tuple(v.shape)}")
    if not codes.is_cuda:
        return qmv_plain(codes, v)
    if codes.dtype != torch.int8:
        raise TypeError(f"qmv: codes must be int8, got {codes.dtype}")
    if not v.is_cuda:
        raise ValueError("qmv: codes and v must both be on the card")
    v = v.to(torch.float32).contiguous()
    if v.data_ptr() % 16:                 # the rows layout reads v by float4
        v = v.clone()
    return _launch(codes, v)


def _launch(codes, v):
    """Plan the call from shapes, strides and the address, and launch once."""
    global launches
    r, c = codes.shape
    sr, sc = codes.stride()
    p = plan(r, c, sr, sc, codes.data_ptr())
    stream = _stream(codes)
    ws, counters = _workspace(codes.device, stream, p)
    out = torch.empty(r, dtype=torch.float32, device=codes.device)
    lib = _lib()
    err = lib.qmv_launch(codes.data_ptr(), sr, sc, v.data_ptr(), out.data_ptr(),
                         ws.data_ptr(), counters.data_ptr(), r, c, LAYOUTS[p.layout],
                         p.width, p.unroll, p.splits, p.chunk, stream)
    if err:
        raise RuntimeError(f"qmv kernel launch failed ({p}): "
                           f"{lib.qmv_error_string(err).decode()}")
    launches += 1
    shape_launches[(r, c, p.layout == "cols")] += 1
    return out
