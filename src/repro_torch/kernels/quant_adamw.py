"""quant_adamw — the two passes of the fused quantized-moment AdamW leaf
update (port of ``repro.kernels.quant_adamw``; the CUDA source is
``csrc/quant_adamw.cu``).

* pass 1, two entries on one kernel body: :func:`qadamw_scales` (the path
  entry) — the new moment scales, absmax / qmax (0 → 1) of the new m and
  √v over all R rows, merged in the one launch; :func:`qadamw_absmax` (the
  parity entry, the Pallas kernel's contract) — per block of
  :data:`ROWS_PER_BLOCK` rows, the column absmaxes of the new m and √v.
  :func:`plan` lays both out from the shape and the addresses;
* :func:`qadamw_update` (pass 2) — the new f32 master and both int8 moment
  code planes, re-encoded stochastically against the new scales, the
  rounding words read from a ``rand`` plane (the parity entry) or, given a
  ``key``, hashed in the kernel's registers as ``prng.bits(key, (R, C))``
  holds them (the keyed entry: no plane; bit-equal to the parity entry on
  that plane).

The step's traced scalars arrive as one (8,) f32 ``params`` tensor on the
leaf's device — [clip, finite, lr, b1c, b2c, 0, 0, 0], the Pallas kernels'
SMEM operand — so nothing of the step waits for the host. On CUDA tensors
each wrapper launches its kernel or raises; on CPU tensors it computes its
plain version (the reference's ``ref.quant_adamw_ref`` split at the same
seams).
"""
from __future__ import annotations

import collections
import ctypes
from typing import NamedTuple

import torch

from repro_torch import prng

from . import _build, _workspace
from ._workspace import SMS
from ._workspace import current_stream as _stream
from .ref import adamw_moments_ref, adamw_scale_ref, adamw_update_ref

absmax_launches = 0   # qadamw_absmax() launches, the parity entry (plain calls excluded)
scales_launches = 0   # qadamw_scales() launches, pass 1's path entry
update_launches = 0   # qadamw_update() launches of the rand entry (plain calls excluded)
keyed_update_launches = 0   # qadamw_update() launches of the keyed entry
# (pass, R, C) → launches; pass "absmax", "scales", "update" or "update_keyed"
shape_launches: collections.Counter = collections.Counter()
ROWS_PER_BLOCK = 256  # rows per partial of the parity entry
WARPS = 8             # warps a pass-1 block (kWarps in the source)
# the path entry's rows a block: the most, a power of two from MIN_ROWS
# to MAX_ROWS, that still gives MIN_BLOCKS blocks (32 a SM). Device time
# on an H100 (PERF.md §6): q/o's R36864 C2048 0.175 ms at 8 blocks a SM,
# 0.159 at 32; k/v's R36864 C256 0.0275 at 64 rows a block, 0.0300 at 32;
# the largest leaves alike at 4–32
MIN_BLOCKS = 32 * SMS
MIN_ROWS, MAX_ROWS = 64, 1024
P_CLIP, P_FINITE, P_LR, P_B1C, P_B2C = range(5)


class Plan(NamedTuple):
    """How one pass-1 launch runs: a block per tile of 32 · ``width``
    columns (``tiles``) and run of ``rows`` rows (``runs``); a lane owns
    ``width`` columns (4: a 16-byte load of g and 4-byte code loads a row;
    1: single elements) and issues ``unroll`` rows' loads before its first
    max; ``ws`` uint32 words (2 · C) and ``counters`` arrival counters (one
    a tile) where the path entry merges runs, else 0 and 0."""
    width: int
    unroll: int
    rows: int
    tiles: int
    runs: int
    ws: int
    counters: int


def plan(r: int, c: int, alignment: int, *, partials: bool = False) -> Plan:
    """Pass 1's layout from the leaf's (r, c) and ``alignment`` (the
    operands' addresses or-ed together, the code planes' times 4: 16
    divides it when g is 16-byte and the code planes 4-byte aligned).
    Four columns a lane where C % 4 == 0 and 16 divides ``alignment``.
    ``partials`` (the parity entry): ROWS_PER_BLOCK rows a block, no merge.
    Else the most rows a block, a power of two from MIN_ROWS to MAX_ROWS,
    that gives MIN_BLOCKS blocks; a merge where runs > 1."""
    if r < 1 or c < 1:
        raise ValueError(f"quant_adamw: empty leaf ({r}, {c})")
    width = 4 if c % 4 == 0 and alignment % 16 == 0 else 1
    tiles = -(-c // (32 * width))
    rows = ROWS_PER_BLOCK if partials else MAX_ROWS
    while not partials and rows > MIN_ROWS and tiles * -(-r // rows) < MIN_BLOCKS:
        rows //= 2
    runs = -(-r // rows)
    if runs > 65535:
        raise ValueError(f"quant_adamw: ({r}, {c}) needs {runs} row runs, more than a grid holds")
    unroll = 8 if width == 1 and rows >= WARPS * 8 else 4
    merge = not partials and runs > 1
    return Plan(width, unroll, rows, tiles, runs, 2 * c if merge else 0, tiles if merge else 0)


def _alignment(g, m_codes, v_codes) -> int:
    return g.data_ptr() | 4 * (m_codes.data_ptr() | v_codes.data_ptr())


def qadamw_absmax_plain(g, m_codes, m_scale, v_codes, v_scale, params, *,
                        b1: float, b2: float):
    m, v = adamw_moments_ref(g, m_codes, m_scale, v_codes, v_scale,
                             params[P_CLIP], params[P_FINITE], b1=b1, b2=b2)
    r, c = m.shape
    nb = -(-r // ROWS_PER_BLOCK)
    pad = nb * ROWS_PER_BLOCK - r             # zeros never raise an absmax

    def blocks(t):
        t = torch.cat([t, t.new_zeros(pad, c)]) if pad else t
        return torch.amax(t.reshape(nb, ROWS_PER_BLOCK, c), dim=1)

    return blocks(m.abs()), blocks(torch.sqrt(v))


def qadamw_scales_plain(g, m_codes, m_scale, v_codes, v_scale, params, *,
                        b1: float, b2: float, qmax: int):
    """``adamw_scale_ref`` of the column absmaxes of the new m and √v over
    every row: what the max of :func:`qadamw_absmax_plain`'s partials gives
    (a max is exact in any order)."""
    m, v = adamw_moments_ref(g, m_codes, m_scale, v_codes, v_scale,
                             params[P_CLIP], params[P_FINITE], b1=b1, b2=b2)
    return (adamw_scale_ref(torch.amax(m.abs(), dim=0), qmax),
            adamw_scale_ref(torch.amax(torch.sqrt(v), dim=0), qmax))


def qadamw_update_plain(master, g, m_codes, m_scale, v_codes, v_scale,
                        m_scale_new, v_scale_new, rand, params, *, b1: float,
                        b2: float, eps: float, wd: float, qmax: int,
                        uclip: float = 0.0):
    m, v = adamw_moments_ref(g, m_codes, m_scale, v_codes, v_scale,
                             params[P_CLIP], params[P_FINITE], b1=b1, b2=b2)
    return adamw_update_ref(master, m, v, m_scale_new.reshape(-1),
                            v_scale_new.reshape(-1), rand, qmax=qmax, eps=eps,
                            wd=wd, lr=params[P_LR], b1c=params[P_B1C],
                            b2c=params[P_B2C], finite=params[P_FINITE], uclip=uclip)


def _lib():
    lib = _build.load("quant_adamw")
    if not getattr(lib, "_typed", False):
        p, ll, f = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_float
        i, u = ctypes.c_int, ctypes.c_uint
        lib.qadamw_absmax_launch.argtypes = ([p] * 10 + [ll, ll] + [f] * 5 + [i] * 3
                                             + [ll, i, i, p])
        lib.qadamw_absmax_launch.restype = i
        lib.qadamw_update_launch.argtypes = [p] * 13 + [ll, ll] + [f] * 8 + [i, p]
        lib.qadamw_update_launch.restype = i
        lib.qadamw_update_keyed_launch.argtypes = ([p] * 8 + [u, u] + [p] * 4 + [ll, ll]
                                                   + [f] * 8 + [i, p])
        lib.qadamw_update_keyed_launch.restype = i
        lib.quant_adamw_error_string.argtypes = [ctypes.c_int]
        lib.quant_adamw_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib



def _check(name, g, m_codes, m_scale, v_codes, v_scale, params, *planes):
    r, c = g.shape
    for t in (g, *planes):
        if t.dtype != torch.float32 or tuple(t.shape) != (r, c):
            raise ValueError(f"{name}: f32 (R, C) planes of one shape, got "
                             f"{t.dtype}{list(t.shape)}")
    for t in (m_codes, v_codes):
        if t.dtype != torch.int8 or tuple(t.shape) != (r, c):
            raise ValueError(f"{name}: int8 (R, C) code planes, got {t.dtype}{list(t.shape)}")
    for t in (m_scale, v_scale):
        if t.numel() != c:
            raise ValueError(f"{name}: a scale needs {c} entries, got {t.numel()}")
    if params.dtype != torch.float32 or params.numel() != 8:
        raise ValueError(f"{name}: params must be an (8,) f32 tensor")
    if not all(t.is_cuda for t in (m_codes, m_scale, v_codes, v_scale, params, *planes)):
        raise ValueError(f"{name}: every operand must be on the card")


def _f32(t):
    return t.reshape(-1).to(torch.float32).contiguous()


def _raise_on(lib, err, name):
    if err:
        raise RuntimeError(f"{name} kernel launch failed: "
                           f"{lib.quant_adamw_error_string(err).decode()}")


# per (device, stream): the path entry's running maxima (uint32 bits, 0
# between calls) and its arrival counters (_workspace.kept)
_WORKSPACE: dict = {}


def _pass1(name, g, m_codes, m_scale, v_codes, v_scale, params, *, b1, b2, qmax,
           partials):
    """Plan pass 1 from the shape and the addresses, launch once and count
    it; returns (out_m, out_v): the (runs, C) partials, or the (C,) new
    scales."""
    global absmax_launches, scales_launches
    r, c = g.shape
    g, m_codes, v_codes = g.contiguous(), m_codes.contiguous(), v_codes.contiguous()
    ms, vs = _f32(m_scale), _f32(v_scale)
    p = plan(r, c, _alignment(g, m_codes, v_codes), partials=partials)
    shape = (p.runs, c) if partials else (c,)
    out_m = torch.empty(shape, dtype=torch.float32, device=g.device)
    out_v = torch.empty_like(out_m)
    stream = _stream(g)
    ws, counters = _workspace.kept(_WORKSPACE, g.device, stream, p.ws, p.counters,
                                   ws_dtype=torch.int32, zero_ws=True)
    lib = _lib()
    err = lib.qadamw_absmax_launch(
        g.data_ptr(), m_codes.data_ptr(), ms.data_ptr(), v_codes.data_ptr(), vs.data_ptr(),
        params.data_ptr(), out_m.data_ptr(), out_v.data_ptr(), ws.data_ptr(),
        counters.data_ptr(), r, c, b1, 1 - b1, b2, 1 - b2, float(qmax), p.width, p.unroll,
        p.rows, p.tiles, p.runs, int(partials), stream)
    _raise_on(lib, err, f"{name} ({p})")
    if partials:
        absmax_launches += 1
    else:
        scales_launches += 1
    shape_launches[("absmax" if partials else "scales", r, c)] += 1
    return out_m, out_v


def qadamw_absmax(g, m_codes, m_scale, v_codes, v_scale, params, *,
                  b1: float, b2: float):
    """The parity entry. g (R, C) f32; codes (R, C) int8; scales (C,) f32;
    params (8,) f32. Returns the per-block column absmaxes (⌈R/256⌉, C) of
    the new m and √v (a NaN kept, as ``jnp.max`` keeps it)."""
    if not g.is_cuda:
        return qadamw_absmax_plain(g, m_codes, m_scale, v_codes, v_scale, params,
                                   b1=b1, b2=b2)
    _check("qadamw_absmax", g, m_codes, m_scale, v_codes, v_scale, params)
    return _pass1("qadamw_absmax", g, m_codes, m_scale, v_codes, v_scale, params, b1=b1,
                  b2=b2, qmax=1, partials=True)


def qadamw_scales(g, m_codes, m_scale, v_codes, v_scale, params, *,
                  b1: float, b2: float, qmax: int):
    """Pass 1's path entry: the new moment scales (msn, vsn), two (C,) f32
    tensors, absmax / qmax (0 → 1) of the new m and √v over every row, in
    one launch; bit-equal to ``adamw_scale_ref`` of the max of
    :func:`qadamw_absmax`'s partials. Operands as :func:`qadamw_absmax`."""
    if not g.is_cuda:
        return qadamw_scales_plain(g, m_codes, m_scale, v_codes, v_scale, params,
                                   b1=b1, b2=b2, qmax=qmax)
    _check("qadamw_scales", g, m_codes, m_scale, v_codes, v_scale, params)
    return _pass1("qadamw_scales", g, m_codes, m_scale, v_codes, v_scale, params, b1=b1,
                  b2=b2, qmax=qmax, partials=False)


def _vec_ok(c, planes, scales, codes) -> bool:
    """Whether pass 2 may take four elements a thread: C % 4 == 0, every
    f32 plane and scale 16-byte aligned, the code planes 4-byte aligned."""
    return (c % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in (*planes, *scales))
            and all(t.data_ptr() % 4 == 0 for t in codes))


def qadamw_update(master, g, m_codes, m_scale, v_codes, v_scale, m_scale_new,
                  v_scale_new, rand, params, *, key=None, b1: float, b2: float,
                  eps: float, wd: float, qmax: int, uclip: float = 0.0):
    """master/g (R, C) f32; codes (R, C) int8; old and new scales (C,) f32;
    params (8,) f32; and exactly one of ``rand`` (R, C) int32 holding uint32
    words, or ``key``, one (2,) threefry key whose ``prng.bits(key, (R,
    C))`` words the kernel hashes itself. Returns (new_master f32,
    new_m_codes int8, new_v_codes int8)."""
    global update_launches, keyed_update_launches
    if (rand is None) == (key is None):
        raise ValueError("qadamw_update: pass exactly one of rand and key")
    r, c = g.shape
    if key is not None and (tuple(key.shape) != (2,) or key.dtype.is_floating_point):
        raise ValueError(f"qadamw_update: key must be one (2,) integer key, got "
                         f"{key.dtype}{list(key.shape)}")
    if not g.is_cuda:
        if rand is None:
            rand = prng.bits(key, (r, c), device=g.device, dtype=torch.int32)
        return qadamw_update_plain(master, g, m_codes, m_scale, v_codes, v_scale,
                                   m_scale_new, v_scale_new, rand, params, b1=b1,
                                   b2=b2, eps=eps, wd=wd, qmax=qmax, uclip=uclip)
    _check("qadamw_update", g, m_codes, m_scale, v_codes, v_scale, params, master)
    if rand is not None and (rand.dtype != torch.int32 or tuple(rand.shape) != (r, c)
                             or not rand.is_cuda):
        raise ValueError("qadamw_update: rand must be an (R, C) int32 plane on the card")
    for t in (m_scale_new, v_scale_new):
        if t.numel() != c or not t.is_cuda:
            raise ValueError(f"qadamw_update: a new scale needs {c} entries on the card")
    master, g = master.contiguous(), g.contiguous()
    m_codes, v_codes = m_codes.contiguous(), v_codes.contiguous()
    ms, vs, msn, vsn = (_f32(t) for t in (m_scale, v_scale, m_scale_new, v_scale_new))
    out_master = torch.empty_like(master)
    out_mc = torch.empty_like(m_codes)
    out_vc = torch.empty_like(v_codes)
    planes = [master, g, out_master] + ([] if rand is None else [rand.contiguous()])
    vec = int(_vec_ok(c, planes, (ms, vs, msn, vsn), (m_codes, v_codes, out_mc, out_vc)))
    head = (master.data_ptr(), g.data_ptr(), m_codes.data_ptr(), ms.data_ptr(),
            v_codes.data_ptr(), vs.data_ptr(), msn.data_ptr(), vsn.data_ptr())
    tail = (params.data_ptr(), out_master.data_ptr(), out_mc.data_ptr(), out_vc.data_ptr(),
            r, c, b1, 1 - b1, b2, 1 - b2, eps, wd, float(qmax), uclip, vec, _stream(g))
    lib = _lib()
    if rand is None:
        k1, k2 = int(key[0]) & prng.MASK, int(key[1]) & prng.MASK
        err = lib.qadamw_update_keyed_launch(*head, k1, k2, *tail)
        _raise_on(lib, err, "qadamw_update")
        keyed_update_launches += 1
        shape_launches[("update_keyed", r, c)] += 1
    else:
        err = lib.qadamw_update_launch(*head, planes[3].data_ptr(), *tail)
        _raise_on(lib, err, "qadamw_update")
        update_launches += 1
        shape_launches[("update", r, c)] += 1
    return out_master, out_mc, out_vc
