"""QTensor — codes + scale + scheme (port of ``repro.quant.qtensor``).

The arithmetic is byte-identical to the reference for the int grid:
scale = absmax/qmax (absmax 0 → 1), codes = clip(round(x / scale), ±qmax)
— a *division*, and ``torch.round`` rounds half to even as ``jnp.round``
does. Packed int4 is offset-binary (code + 8), the low nibble holding the
even element; only ``uint8`` is shifted (torch on the CPU cannot shift
``uint32``).

The paper's interval grid (``grid='zipml'``) follows ``encode_jnp``: codes =
sign(x) · round(clip(|x|/scale, 0, 1) · s) with stochastic rounding
⌊t⌋ + [u < t − ⌊t⌋] on a ``jax.random.uniform``-exact draw
(:mod:`repro_torch.prng`), or nearest rounding; decode = codes / s · scale.
A double-sampled pair (``rounding='ds'``) carries its second plane in
``codes2``.

Stacked layer weights keep their leading layer axis — codes (L, K, N) with
(L, 1, N) channel scales — and :meth:`QTensor.index` hands out the per-layer
2-D view without copying.
"""
from __future__ import annotations

import math

import torch

from repro_torch import prng

from .scheme import QScheme


def _todo(what: str, item: str):
    raise NotImplementedError(f"{what} is not ported yet (ROADMAP {item})")


def _code_dtype(s: int):
    return torch.int8 if s <= 127 else torch.int32


def stochastic_round(t: torch.Tensor, key: torch.Tensor) -> torch.Tensor:
    """Unbiased stochastic rounding ⌊t⌋ + Bernoulli(t − ⌊t⌋) (Lemma 6), the
    uniform draw bit-exact with ``jax.random.uniform(key, t.shape)``."""
    lo = torch.floor(t)
    u = prng.uniform(key, t.shape, device=t.device)
    return lo + (u < (t - lo)).to(torch.float32)


def _round(t: torch.Tensor, key) -> torch.Tensor:
    return torch.round(t) if key is None else stochastic_round(t, key)


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


def _absmax(x32: torch.Tensor, scheme: QScheme) -> torch.Tensor:
    """max|x| per scaling group, shaped as the reference's scales: a 0-d
    tensor ('tensor'), (…, 1) ('row'), (C,) ('column'), keepdim over
    ``channel_axis`` ('channel')."""
    a = x32.abs()
    if scheme.scaling == "tensor":
        return torch.amax(a)
    if scheme.scaling == "row":
        return torch.amax(a, dim=-1, keepdim=True)
    if scheme.scaling == "column":
        return torch.amax(a, dim=tuple(range(a.ndim - 1))) if a.ndim > 1 else a
    return torch.amax(a, dim=scheme.channel_axis, keepdim=True)


def compute_scale(x: torch.Tensor, scheme: QScheme) -> torch.Tensor:
    """The decode multiplier of ``x`` under ``scheme``'s scaling family:
    absmax/qmax on the int grid, absmax itself on the zipml grid, with an
    all-zero group mapped to scale 1 (so its decode is exact)."""
    if scheme.grid == "levels" or scheme.layout != "dense":
        _todo(f"grid {scheme.grid!r} / layout {scheme.layout!r}",
              "A1 (bitplanes), A2.3 (level grid)")
    m = _absmax(x.detach().to(torch.float32), scheme)
    if scheme.grid == "int":
        return torch.where(m == 0, torch.ones_like(m), m / float(scheme.qmax))
    return torch.where(m == 0, torch.ones_like(m), m)


class QTensor:
    """codes + scale(s) + scheme, plus the second double-sampling plane
    ``codes2`` of a §2.2 pair (Q₁ and Q₂ share the base level, so the pair
    costs one extra bit). The reference's ``levels`` table waits for the
    level grid (ROADMAP A2.3)."""

    __slots__ = ("codes", "scale", "scheme", "codes2")

    def __init__(self, codes: torch.Tensor, scale: torch.Tensor, scheme: QScheme,
                 codes2: torch.Tensor | None = None):
        self.codes = codes
        self.scale = scale
        self.scheme = scheme
        self.codes2 = codes2

    @property
    def shape(self):
        return tuple(self.codes.shape)

    @property
    def ndim(self) -> int:
        return self.codes.ndim

    @property
    def is_ds(self) -> bool:
        return self.codes2 is not None

    @property
    def nbits(self) -> int:
        """Storage bits per element; a double-sampled pair pays +1."""
        return self.scheme.code_bits + (1 if self.is_ds else 0)

    @property
    def nbytes(self) -> int:
        """Logical HBM bytes: packed codes + f32 scales (the reference's
        ``QTensor.nbytes`` accounting)."""
        n = math.prod(self.codes.shape)
        if self.scheme.packed:
            n *= 2                               # two logical codes per byte
        return -(-n * self.nbits // 8) + math.prod(self.scale.shape) * 4

    def _decode_plane(self, codes, dtype=None) -> torch.Tensor:
        sch = self.scheme
        if sch.grid == "levels" or sch.layout != "dense":
            _todo(f"decode of grid {sch.grid!r} / layout {sch.layout!r}",
                  "A1 (bitplanes), A2.3 (level grid)")
        ct = torch.float32 if dtype is None else dtype
        if sch.grid == "zipml":
            return codes.to(ct) / sch.s * self.scale.to(ct)
        codes = unpack_int4(codes) if sch.packed else codes
        return codes.to(ct) * self.scale.to(ct)

    def decode(self, dtype=None) -> torch.Tensor:
        """Dequantize the (first) code plane; ``dtype`` selects the multiply
        dtype (bf16 for the ``ref`` weight decode), default f32."""
        return self._decode_plane(self.codes, dtype)

    def decode2(self, dtype=None) -> torch.Tensor:
        """Dequantize the second double-sampling plane (Q₂)."""
        if self.codes2 is None:
            raise ValueError("QTensor has no second double-sampling plane")
        return self._decode_plane(self.codes2, dtype)

    def dequantize(self) -> torch.Tensor:
        return self.decode()

    def dot(self, v: torch.Tensor, backend=None) -> torch.Tensor:
        """decode(self) @ v through the kernel-backend registry (the ``cuda``
        backend streams int8 codes through ``qmv``)."""
        return dot(self, v, backend=backend)

    def index(self, i: int) -> "QTensor":
        """Layer ``i`` of a stacked (L, …) QTensor — views, not copies."""
        return QTensor(self.codes[i], self.scale[i], self.scheme,
                       None if self.codes2 is None else self.codes2[i])

    def to(self, device) -> "QTensor":
        return QTensor(self.codes.to(device), self.scale.to(device), self.scheme,
                       None if self.codes2 is None else self.codes2.to(device))

    def __repr__(self):
        extra = "+ds" if self.is_ds else ""
        return (f"QTensor({tuple(self.codes.shape)}, {self.scheme.grid}{extra}, "
                f"bits={self.scheme.bits}, scaling={self.scheme.scaling})")


def encode(x: torch.Tensor, scheme: QScheme, key: torch.Tensor | None = None,
           scale: torch.Tensor | None = None, backend=None) -> QTensor:
    """Quantize ``x`` under ``scheme`` (the reference's ``encode_jnp``
    numerics). The int grid takes nearest rounding (int8 codes; packed uint8
    nibbles at ``packed=True``); the zipml grid stochastic rounding (``key``
    required) or nearest; ``rounding='ds'`` draws the §2.2 pair through
    :func:`ds_pair`. ``scale=None`` computes the scheme's own scale."""
    if scheme.rounding == "ds":
        return ds_pair(x, scheme, key, scale=scale, backend=backend)
    if scheme.grid == "int" and scheme.rounding != "nearest":
        _todo(f"{scheme.rounding!r} rounding on the int grid", "A1")
    if scheme.rounding == "stochastic" and key is None:
        raise ValueError("stochastic rounding requires a PRNG key")
    if scale is None:
        scale = compute_scale(x, scheme)
    else:
        scale = torch.as_tensor(scale, dtype=torch.float32, device=x.device)
    if scheme.grid == "zipml":
        return _encode_zipml(x, scheme, scale,
                             None if scheme.rounding == "nearest" else key)
    qmax = float(scheme.qmax)
    t = x.to(torch.float32) / scale
    codes = torch.clamp(torch.round(t), -qmax, qmax).to(_code_dtype(scheme.qmax))
    if scheme.packed:
        codes = pack_int4(codes)
    return QTensor(codes, scale, scheme)


def _encode_zipml(x, scheme: QScheme, scale, key) -> QTensor:
    if scheme.layout != "dense":
        _todo(f"layout {scheme.layout!r}", "A1")
    s = scheme.s
    xn = (x / scale).to(torch.float32)
    mag = torch.clamp(xn.abs() if scheme.signed else xn, 0.0, 1.0)
    codes = _round(mag * s, key)
    if scheme.signed:
        codes = codes * torch.sign(xn)
    return QTensor(codes.to(_code_dtype(s)), scale, scheme)


def ds_pair_plain(x: torch.Tensor, scheme: QScheme, key: torch.Tensor,
                  scale: torch.Tensor | None = None) -> QTensor:
    """Two independent stochastic planes from one split key — the
    reference's ``ds_pair_jnp`` draw (the fused ``cuda`` path shares the
    base level instead)."""
    if key is None:
        raise ValueError("double-sampling ('ds' rounding) requires a PRNG key")
    if scale is None:
        scale = compute_scale(x, scheme)
    one = scheme.with_rounding("stochastic")
    k1, k2 = prng.split(key)
    q1 = encode(x, one, k1, scale=scale)
    q2 = encode(x, one, k2, scale=scale)
    return QTensor(q1.codes, q1.scale, scheme.with_rounding("ds"), codes2=q2.codes)


def _backend(backend, device):
    from repro_torch.kernels import registry

    return registry.resolve(backend, device)


def decode(qt: QTensor, dtype=None) -> torch.Tensor:
    return qt.decode(dtype)


def ds_pair(x: torch.Tensor, scheme: QScheme, key: torch.Tensor,
            scale: torch.Tensor | None = None, backend=None) -> QTensor:
    """Draw the §2.2 double-sampling pair as one QTensor (codes + codes2)."""
    if key is None:
        raise ValueError("double-sampling ('ds' rounding) requires a PRNG key")
    return _backend(backend, x.device).ds_pair(x, scheme, key, scale=scale)


def dot(qt: QTensor, v: torch.Tensor, backend=None) -> torch.Tensor:
    """decode(qt) @ v — backends may compute it from the codes."""
    return _backend(backend, qt.codes.device).qt_dot(qt, v)


def tree_nbytes(tree) -> int:
    """Logical HBM bytes of a nested dict of tensors / QTensors."""
    if isinstance(tree, QTensor):
        return tree.nbytes
    if isinstance(tree, dict):
        return sum(tree_nbytes(v) for v in tree.values())
    return tree.numel() * tree.element_size()
