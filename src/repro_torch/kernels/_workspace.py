"""What the wrappers' launch plans share: the card's SM count, the stream
a launch takes, and the kept workspace of the in-launch merges (``qmv``,
``paged_decode_attn``, ``qadamw_scales``): where a kernel splits its work,
the last block to arrive merges the partials, so a call stays one launch.
Each wrapper keeps its own ``cache`` dict, keyed by (device, stream); the
buffers grow when a call needs more and are kept otherwise. The arrival
counters, and the partials of a kernel that folds into them (``zero_ws``),
are zeroed only when allocated: every launch leaves them at 0, so no
launch needs a memset.
"""
from __future__ import annotations

import torch

SMS = 132                     # streaming multiprocessors of an H100


def kept(cache: dict, device, stream: int, ws: int, counters: int, *,
         ws_dtype=torch.float32, zero_ws: bool = False):
    """The (partials, int32 counters) of ``cache`` for (device, stream), at
    least ``ws`` and ``counters`` entries (one each at the least)."""
    ws_t, cn = cache.get((device, stream), (None, None))
    if ws_t is None or ws_t.numel() < ws:
        make = torch.zeros if zero_ws else torch.empty
        ws_t = make(max(ws, 1), dtype=ws_dtype, device=device)
    if cn is None or cn.numel() < counters:
        cn = torch.zeros(max(counters, 1), dtype=torch.int32, device=device)
    cache[(device, stream)] = (ws_t, cn)
    return ws_t, cn


def current_stream(x: torch.Tensor) -> int:
    """The handle of PyTorch's current stream on ``x``'s device: every kernel
    launches there, and a workspace is kept per (device, stream)."""
    return torch.cuda.current_stream(x.device).cuda_stream
