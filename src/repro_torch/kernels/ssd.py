"""ssd_chunk_scan — Mamba2's SSD chunk scan (port of
``repro.kernels.ssd.ssd_chunk_scan``; the CUDA source is ``csrc/ssd.cu``).

``ssd_chunk_scan(xh, dt, logdec, bmat, cmat)`` runs the chunked dual form of
the SSD recurrence over pre-chunked inputs and returns y and the final
state; the state is carried across the chunks in f32. On a CUDA tensor it
launches the hand-written kernel on the core :func:`plan` picks from x's
dtype, or raises: bf16 x on the tensor cores, chunk-parallel in three
phases (:func:`ssd_chunk_scan_tc_plain` is that core's order written out in
torch), f32 x on the first port's SIMT kernel. On a CPU tensor it computes
:func:`ssd_chunk_scan_plain`, the kernel's oracle. Neither has a backward:
a call whose inputs require a gradient raises.
"""
from __future__ import annotations

import collections
import ctypes
from typing import NamedTuple

import torch

from . import _build
from .qmm_t import split_bf16x3
from .ref import ssd_chunk_scan_ref

launches = 0          # wrapper calls that launched the kernel (plain calls excluded)
tc_launches = 0       # ... of them on the tensor-core core
# (x dtype, B, NC, L, H, P, N, initial state given) → launches
shape_launches: collections.Counter = collections.Counter()

MAX_HEAD_DIM = 64     # csrc/ssd.cu · kMaxP: both cores' register tiles
TC_MAX_STATE = 256    # csrc/ssd.cu · tcs::kMaxN
ROW_TILE = 64         # csrc/ssd.cu · tcs::kRows: rows of l a phase-3 block
HEAD_GROUP = 2        # csrc/ssd.cu · tcs::kHeads: heads sharing one S = C·Bᵀ
CORES = {"simt": 0, "tc": 1}

ssd_chunk_scan_plain = ssd_chunk_scan_ref

NO_GRAD = ("ssd_chunk_scan has no backward (the reference has no SSD backward "
           "kernel either; ssm training is ROADMAP A6, 'ssm training')")


class Plan(NamedTuple):
    """How one call runs: the core, and the grid of its output phase —
    ``row_tiles`` blocks of ``ROW_TILE`` rows along L by ``head_groups``
    blocks of ``HEAD_GROUP`` heads (tensor cores), or a block per head
    walking the chunks (SIMT: 1 and H), each for every (batch, chunk)."""
    core: str
    row_tiles: int
    head_groups: int


def plan(x_dtype, L: int, H: int, P: int, N: int) -> Plan:
    """The core from x's dtype alone: bf16 on the tensor cores (both served
    mamba2 prefills; the core multiplies bf16 x, B and C exactly), f32 on
    the SIMT kernel (the f32 consistency check's: its numbers stay those of
    the first port). P above
    ``MAX_HEAD_DIM``, or N above ``TC_MAX_STATE`` on the tensor cores,
    raises."""
    if P > MAX_HEAD_DIM:
        raise ValueError(f"ssd_chunk_scan: head_dim {P} > {MAX_HEAD_DIM}")
    if x_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"ssd_chunk_scan: xh must be bf16 or f32, got {x_dtype}")
    if x_dtype == torch.bfloat16:
        if N > TC_MAX_STATE:
            raise ValueError(f"ssd_chunk_scan: state {N} > {TC_MAX_STATE} on the tensor cores")
        return Plan("tc", -(-L // ROW_TILE), -(-H // HEAD_GROUP))
    return Plan("simt", 1, H)


def _pieces(v):
    """f32 ``v`` as the sum of its three bf16 pieces, each back in f32 —
    (lo, mid, hi), the order the tensor-core core adds their products in."""
    hi, mid, lo = split_bf16x3(v)
    return lo.float(), mid.float(), hi.float()


def _cumsum_in_order(ld):
    """The running sum along dim 2, one add after another (the kernel's
    scan; torch.cumsum may sum in another order on the card)."""
    out = torch.empty_like(ld)
    acc = torch.zeros_like(ld[:, :, 0])
    for l in range(ld.shape[2]):
        acc = acc + ld[:, :, l]
        out[:, :, l] = acc
    return out


def ssd_chunk_scan_tc_plain(xh, dt, logdec, bmat, cmat, init_state=None):
    """The tensor-core core's arithmetic in torch, phase by phase, for the
    tests: every f32 operand of a product (v = (x ⊙ dt) ⊙ tail, the
    entering states, W = (S ⊙ exp(cum_l − cum_m)) ⊙ dt_m) goes through
    :func:`~repro_torch.kernels.qmm_t.split_bf16x3` and the pieces'
    products are summed lo, mid, hi. The kernel's f32 sums run in another
    order, and left of each 64-row tile's diagonal it takes the decay as
    exp(cum_l − cum_l0) · exp(cum_l0 − cum_m) (l0 the tile's first row):
    the same values to f32 rounding. Same arguments and results as
    :func:`ssd_chunk_scan_plain`."""
    f32 = torch.float32
    b, nc, L, h, p = xh.shape
    n = bmat.shape[-1]
    x, bm, cm = xh.to(f32), bmat.to(f32), cmat.to(f32)
    dt, logdec = dt.to(f32), logdec.to(f32)
    # phase 1, per (batch, chunk, head): cum in order, bx_c = vᵀ · B
    cum = _cumsum_in_order(logdec)                              # (B, NC, L, H)
    tail = torch.exp(cum[:, :, -1:] - cum)
    v = (x * dt[..., None]) * tail[..., None]                   # (B, NC, L, H, P)
    bx = sum(torch.einsum("bclhp,bcln->bchpn", pc, bm) for pc in _pieces(v))
    # phase 2, per (batch, head): the carry in chunk order
    s = (torch.zeros((b, h, p, n), dtype=f32, device=xh.device)
         if init_state is None else init_state.to(f32))
    entering = []
    for c in range(nc):
        entering.append(s)
        s = s * torch.exp(cum[:, c, -1])[:, :, None, None] + bx[:, c]
    states = torch.stack(entering, dim=1)                       # (B, NC, H, P, N)
    # phase 3, per (batch, chunk): y_inter, then y_intra added to it
    y = sum(torch.einsum("bcln,bchpn->bclhp", cm, pc) for pc in _pieces(states))
    y = y * torch.exp(cum)[..., None]
    mask = torch.ones((L, L), dtype=torch.bool, device=xh.device).tril()[:, :, None]
    scores = cm @ bm.transpose(-1, -2)                          # (B, NC, L, L)
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]        # (B, NC, L, L, H)
    dec = torch.exp(torch.where(mask, diff, -torch.inf))
    w = (scores[..., None] * dec) * dt[:, :, None, :, :]
    for pc in _pieces(w):
        y = y + torch.einsum("bclmh,bcmhp->bclhp", pc, x)
    return y.to(xh.dtype), s


def _lib():
    lib = _build.load("ssd")
    if not getattr(lib, "_typed", False):
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.ssd_chunk_scan_launch.argtypes = [
            p, i, ll, ll, ll, ll, p, p, p, ll, ll, ll, p, ll, ll, ll, p, p, p, p, p, p,
            i, i, i, i, i, i, i, i, i, p]
        lib.ssd_chunk_scan_launch.restype = i
        lib.ssd_error_string.argtypes = [i]
        lib.ssd_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _unit_last(t: torch.Tensor) -> torch.Tensor:
    return t if t.stride(-1) == 1 else t.contiguous()


def ssd_chunk_scan(xh, dt, logdec, bmat, cmat, init_state=None):
    """xh (B, NC, L, H, P) bf16/f32; dt, logdec (B, NC, L, H) f32; bmat,
    cmat (B, NC, L, N) in xh's dtype; init_state (B, H, P, N) f32 or None
    (zeros). Returns (y (B, NC, L, H, P) in xh's dtype, state (B, H, P, N)
    f32). xh, bmat and cmat may be strided views (the model's slices of one
    projection) as long as their last dimension is contiguous."""
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
    init = None if init_state is None else init_state.to(torch.float32).contiguous()
    return _launch(_unit_last(xh), dt.to(torch.float32).contiguous(),
                   logdec.to(torch.float32).contiguous(), _unit_last(bmat),
                   _unit_last(cmat), init)


def _launch(xh, dt, logdec, bmat, cmat, init):
    """Plan the call from x's dtype and the shapes, and launch its core."""
    global launches, tc_launches
    b, nc, L, h, p = xh.shape
    n = bmat.shape[-1]
    pl = plan(xh.dtype, L, h, p, n)
    dev = xh.device
    y = torch.empty((b, nc, L, h, p), dtype=xh.dtype, device=dev)
    state = torch.empty((b, h, p, n), dtype=torch.float32, device=dev)
    if pl.core == "tc":    # cum and bx per chunk; the entering states' bf16 pieces
        cum = torch.empty((b, nc, h, L), dtype=torch.float32, device=dev)
        buf = torch.empty((b, nc, h, p, n), dtype=torch.float32, device=dev)
        pieces = torch.empty((b, nc, h, 3, p, n), dtype=torch.bfloat16, device=dev)
    else:
        cum = torch.empty((b, h, L), dtype=torch.float32, device=dev)
        buf = pieces = None
    lib = _lib()
    err = lib.ssd_chunk_scan_launch(
        xh.data_ptr(), int(xh.dtype == torch.bfloat16), *xh.stride()[:4],
        dt.data_ptr(), logdec.data_ptr(), bmat.data_ptr(), *bmat.stride()[:3],
        cmat.data_ptr(), *cmat.stride()[:3], None if init is None else init.data_ptr(),
        y.data_ptr(), state.data_ptr(), cum.data_ptr(),
        None if buf is None else buf.data_ptr(),
        None if pieces is None else pieces.data_ptr(), b, nc, L, h, p, n,
        CORES[pl.core], pl.row_tiles, pl.head_groups, _stream(xh))
    if err:
        raise RuntimeError(f"ssd_chunk_scan kernel launch failed ({pl}): "
                           f"{lib.ssd_error_string(err).decode()}")
    launches += 1
    tc_launches += pl.core == "tc"
    shape_launches[(str(xh.dtype).removeprefix("torch."), b, nc, L, h, p, n,
                    init is not None)] += 1
    return y, state
