"""quant_adamw — the two passes of the fused quantized-moment AdamW leaf
update (port of ``repro.kernels.quant_adamw``; the CUDA source is
``csrc/quant_adamw.cu``).

* :func:`qadamw_absmax` (pass 1) — per block of :data:`ROWS_PER_BLOCK`
  rows, the column absmaxes of the new m and √v;
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
seam).
"""
from __future__ import annotations

import collections
import ctypes

import torch

from repro_torch import prng

from . import _build
from .ref import adamw_moments_ref, adamw_update_ref

absmax_launches = 0   # kernel launches made by qadamw_absmax() (plain calls excluded)
update_launches = 0   # qadamw_update() launches of the rand entry (plain calls excluded)
keyed_update_launches = 0   # qadamw_update() launches of the keyed entry
# (pass, R, C) → launches; pass "absmax", "update" or "update_keyed"
shape_launches: collections.Counter = collections.Counter()
ROWS_PER_BLOCK = 256  # rows per pass-1 partial absmax (kRowsPerBlock in the source)
P_CLIP, P_FINITE, P_LR, P_B1C, P_B2C = range(5)


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
        lib.qadamw_absmax_launch.argtypes = [p] * 8 + [ll, ll] + [f] * 4 + [p]
        lib.qadamw_absmax_launch.restype = ctypes.c_int
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


def qadamw_absmax(g, m_codes, m_scale, v_codes, v_scale, params, *,
                  b1: float, b2: float):
    """g (R, C) f32; codes (R, C) int8; scales (C,) f32; params (8,) f32.
    Returns the per-block column absmaxes (⌈R/256⌉, C) of the new m and √v."""
    global absmax_launches
    if not g.is_cuda:
        return qadamw_absmax_plain(g, m_codes, m_scale, v_codes, v_scale, params,
                                   b1=b1, b2=b2)
    _check("qadamw_absmax", g, m_codes, m_scale, v_codes, v_scale, params)
    r, c = g.shape
    nb = -(-r // ROWS_PER_BLOCK)
    mx = torch.empty((nb, c), dtype=torch.float32, device=g.device)
    vx = torch.empty_like(mx)
    g, m_codes, v_codes = g.contiguous(), m_codes.contiguous(), v_codes.contiguous()
    ms, vs = _f32(m_scale), _f32(v_scale)
    lib = _lib()
    err = lib.qadamw_absmax_launch(
        g.data_ptr(), m_codes.data_ptr(), ms.data_ptr(), v_codes.data_ptr(),
        vs.data_ptr(), params.data_ptr(), mx.data_ptr(), vx.data_ptr(), r, c,
        b1, 1 - b1, b2, 1 - b2, torch.cuda.current_stream(g.device).cuda_stream)
    _raise_on(lib, err, "qadamw_absmax")
    absmax_launches += 1
    shape_launches[("absmax", r, c)] += 1
    return mx, vx


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
            r, c, b1, 1 - b1, b2, 1 - b2, eps, wd, float(qmax), uclip, vec,
            torch.cuda.current_stream(g.device).cuda_stream)
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
