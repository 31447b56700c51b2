"""ssd_chunk_scan — Mamba2's SSD chunk scan (port of
``repro.kernels.ssd.ssd_chunk_scan``; the CUDA source is ``csrc/ssd.cu``).

``ssd_chunk_scan(xh, dt, logdec, bmat, cmat)`` runs the chunked dual form of
the SSD recurrence over pre-chunked inputs and returns y and the final
state; the state is carried across the chunks in f32. On a CUDA tensor it
launches the hand-written kernel or raises; on a CPU tensor it computes
:func:`ssd_chunk_scan_plain`, the kernel's oracle. Neither has a backward:
a call whose inputs require a gradient raises.
"""
from __future__ import annotations

import collections
import ctypes

import torch

from . import _build
from .ref import ssd_chunk_scan_ref

launches = 0          # kernel launches made by ssd_chunk_scan() (plain calls excluded)
# (x dtype, B, NC, L, H, P, N, initial state given) → launches
shape_launches: collections.Counter = collections.Counter()

MAX_HEAD_DIM = 64     # csrc/ssd.cu's register tile (kMaxP)

ssd_chunk_scan_plain = ssd_chunk_scan_ref

NO_GRAD = ("ssd_chunk_scan has no backward (the reference has no SSD backward "
           "kernel either; ssm training is ROADMAP A6, 'ssm training')")


def _lib():
    lib = _build.load("ssd")
    if not getattr(lib, "_typed", False):
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.ssd_chunk_scan_launch.argtypes = [
            p, i, ll, ll, ll, ll, p, p, p, ll, ll, ll, p, ll, ll, ll, p, p, p, p,
            i, i, i, i, i, i, p]
        lib.ssd_chunk_scan_launch.restype = i
        lib.ssd_error_string.argtypes = [i]
        lib.ssd_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _unit_last(t: torch.Tensor) -> torch.Tensor:
    return t if t.stride(-1) == 1 else t.contiguous()


def ssd_chunk_scan(xh, dt, logdec, bmat, cmat, init_state=None):
    """xh (B, NC, L, H, P) bf16/f32; dt, logdec (B, NC, L, H) f32; bmat,
    cmat (B, NC, L, N) in xh's dtype; init_state (B, H, P, N) f32 or None
    (zeros). Returns (y (B, NC, L, H, P) in xh's dtype, state (B, H, P, N)
    f32). xh, bmat and cmat may be strided views (the model's slices of one
    projection) as long as their last dimension is contiguous."""
    global launches
    tensors = (xh, dt, logdec, bmat, cmat, init_state)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise NotImplementedError(NO_GRAD)
    if not xh.is_cuda:
        return ssd_chunk_scan_plain(xh, dt, logdec, bmat, cmat, init_state)
    b, nc, L, h, p = xh.shape
    n = bmat.shape[-1]
    if tuple(dt.shape) != (b, nc, L, h) or tuple(logdec.shape) != (b, nc, L, h) \
            or tuple(bmat.shape) != (b, nc, L, n) or tuple(cmat.shape) != (b, nc, L, n):
        raise ValueError(f"ssd_chunk_scan: shapes xh {tuple(xh.shape)}, dt "
                         f"{tuple(dt.shape)}, logdec {tuple(logdec.shape)}, b "
                         f"{tuple(bmat.shape)}, c {tuple(cmat.shape)}")
    if xh.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"ssd_chunk_scan: xh must be bf16 or f32, got {xh.dtype}")
    if bmat.dtype != xh.dtype or cmat.dtype != xh.dtype:
        raise TypeError(f"ssd_chunk_scan: b and c must be {xh.dtype} like xh, got "
                        f"{bmat.dtype}, {cmat.dtype}")
    if not all(t.is_cuda for t in tensors if t is not None):
        raise ValueError("ssd_chunk_scan: every input must be on the card")
    if init_state is not None and tuple(init_state.shape) != (b, h, p, n):
        raise ValueError(f"ssd_chunk_scan: init_state {tuple(init_state.shape)}, "
                         f"need {(b, h, p, n)}")
    if p > MAX_HEAD_DIM:
        raise ValueError(f"ssd_chunk_scan: head_dim {p} > {MAX_HEAD_DIM}")
    xh, bmat, cmat = _unit_last(xh), _unit_last(bmat), _unit_last(cmat)
    dt = dt.to(torch.float32).contiguous()
    logdec = logdec.to(torch.float32).contiguous()
    init = None if init_state is None else init_state.to(torch.float32).contiguous()
    y = torch.empty((b, nc, L, h, p), dtype=xh.dtype, device=xh.device)
    state = torch.empty((b, h, p, n), dtype=torch.float32, device=xh.device)
    cum = torch.empty((b, h, L), dtype=torch.float32, device=xh.device)
    lib = _lib()
    err = lib.ssd_chunk_scan_launch(
        xh.data_ptr(), int(xh.dtype == torch.bfloat16), *xh.stride()[:4],
        dt.data_ptr(), logdec.data_ptr(), bmat.data_ptr(), *bmat.stride()[:3],
        cmat.data_ptr(), *cmat.stride()[:3], None if init is None else init.data_ptr(),
        y.data_ptr(), state.data_ptr(), cum.data_ptr(), b, nc, L, h, p, n,
        torch.cuda.current_stream(xh.device).cuda_stream)
    if err:
        raise RuntimeError(f"ssd_chunk_scan kernel launch failed: "
                           f"{lib.ssd_error_string(err).decode()}")
    launches += 1
    shape_launches[(str(xh.dtype).removeprefix("torch."), b, nc, L, h, p, n,
                    init is not None)] += 1
    return y, state
