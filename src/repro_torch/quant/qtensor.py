"""QTensor — codes + scale + scheme (port of ``repro.quant.qtensor``).

The arithmetic is byte-identical to the reference for the int grid:
scale = absmax/qmax (absmax 0 → 1), codes = clip(round(x / scale), ±qmax)
— a *division*, and ``torch.round`` rounds half to even as ``jnp.round``
does. Packed int4 is offset-binary (code + 8), the low nibble holding the
even element; only ``uint8`` is shifted (torch on the CPU cannot shift
``uint32``).

Stacked layer weights keep their leading layer axis — codes (L, K, N) with
(L, 1, N) channel scales — and :meth:`QTensor.index` hands out the per-layer
2-D view without copying.
"""
from __future__ import annotations

import math

import torch

from .scheme import QScheme


def _todo(what: str, item: str):
    raise NotImplementedError(f"{what} is not in slice 1 of the port "
                              f"(ROADMAP {item})")


def pack_int4(codes: torch.Tensor) -> torch.Tensor:
    """int codes in [-7, 7], last dim even → uint8 (…, D/2): offset-binary
    nibbles (c+8 ∈ [1, 15]), low nibble = even element."""
    if codes.shape[-1] % 2:
        raise ValueError(f"packed int4 needs an even last dim, got {tuple(codes.shape)}")
    c = (codes.to(torch.int32) + 8).to(torch.uint8)
    return c[..., 0::2] | (c[..., 1::2] << 4)


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """uint8 (…, D/2) → f32 codes (…, D) in [-7, 7] (inverse of pack_int4)."""
    lo = (packed & 0xF).to(torch.float32) - 8.0
    hi = ((packed >> 4) & 0xF).to(torch.float32) - 8.0
    return torch.stack([lo, hi], dim=-1).reshape(
        *packed.shape[:-1], packed.shape[-1] * 2)


def _reduce_dims(scheme: QScheme):
    if scheme.scaling == "row":
        return (-1,)
    if scheme.scaling == "channel":
        return (scheme.channel_axis,)
    _todo(f"{scheme.scaling!r} scaling", "A1")


def compute_scale(x: torch.Tensor, scheme: QScheme) -> torch.Tensor:
    """The int grid's decode multiplier: absmax/qmax per scaling group,
    with an all-zero group mapped to scale 1 (so its decode is exact)."""
    if scheme.grid != "int" or scheme.layout != "dense":
        _todo(f"grid {scheme.grid!r} / layout {scheme.layout!r}", "A1")
    x32 = x.detach().to(torch.float32)
    m = torch.amax(x32.abs(), dim=_reduce_dims(scheme), keepdim=True)
    return torch.where(m == 0, torch.ones_like(m), m / float(scheme.qmax))


class QTensor:
    """codes + scale(s) + scheme — the int-grid storage of a weight or a
    KV row. ``codes2``/``levels`` of the reference wait for slice 2."""

    __slots__ = ("codes", "scale", "scheme")

    def __init__(self, codes: torch.Tensor, scale: torch.Tensor, scheme: QScheme):
        self.codes = codes
        self.scale = scale
        self.scheme = scheme

    @property
    def shape(self):
        return tuple(self.codes.shape)

    @property
    def ndim(self) -> int:
        return self.codes.ndim

    @property
    def nbits(self) -> int:
        return self.scheme.code_bits

    @property
    def nbytes(self) -> int:
        """Logical HBM bytes: packed codes + f32 scales (the reference's
        ``QTensor.nbytes`` accounting)."""
        n = math.prod(self.codes.shape)
        if self.scheme.packed:
            n *= 2                               # two logical codes per byte
        return -(-n * self.nbits // 8) + math.prod(self.scale.shape) * 4

    def decode(self, dtype=None) -> torch.Tensor:
        """Dequantize; ``dtype`` selects the multiply dtype (bf16 for the
        ``ref`` weight decode), default f32."""
        sch = self.scheme
        if sch.grid != "int" or sch.layout != "dense":
            _todo(f"decode of grid {sch.grid!r} / layout {sch.layout!r}", "A1")
        ct = torch.float32 if dtype is None else dtype
        codes = unpack_int4(self.codes) if sch.packed else self.codes
        return codes.to(ct) * self.scale.to(ct)

    def index(self, i: int) -> "QTensor":
        """Layer ``i`` of a stacked (L, …) QTensor — views, not copies."""
        return QTensor(self.codes[i], self.scale[i], self.scheme)

    def to(self, device) -> "QTensor":
        return QTensor(self.codes.to(device), self.scale.to(device), self.scheme)

    def __repr__(self):
        return (f"QTensor({tuple(self.codes.shape)}, {self.scheme.grid}, "
                f"bits={self.scheme.bits}, scaling={self.scheme.scaling})")


def encode(x: torch.Tensor, scheme: QScheme) -> QTensor:
    """Quantize ``x`` onto the symmetric int grid with nearest rounding
    (int8 codes; packed uint8 nibbles at ``packed=True``)."""
    if scheme.rounding != "nearest":
        _todo(f"{scheme.rounding!r} rounding (needs the threefry port)", "A1")
    scale = compute_scale(x, scheme)
    qmax = float(scheme.qmax)
    t = x.to(torch.float32) / scale
    dtype = torch.int8 if scheme.qmax <= 127 else torch.int32
    codes = torch.clamp(torch.round(t), -qmax, qmax).to(dtype)
    if scheme.packed:
        codes = pack_int4(codes)
    return QTensor(codes, scale, scheme)


def decode(qt: QTensor, dtype=None) -> torch.Tensor:
    return qt.decode(dtype)


def tree_nbytes(tree) -> int:
    """Logical HBM bytes of a nested dict of tensors / QTensors."""
    if isinstance(tree, QTensor):
        return tree.nbytes
    if isinstance(tree, dict):
        return sum(tree_nbytes(v) for v in tree.values())
    return tree.numel() * tree.element_size()
