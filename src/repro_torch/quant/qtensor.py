"""QTensor — codes + scale + scheme (port of ``repro.quant.qtensor``).

The arithmetic is byte-identical to the reference for the int grid:
scale = absmax/qmax (absmax 0 → 1), codes = clip(round(x / scale), ±qmax)
— a *division*, and ``torch.round`` rounds half to even as ``jnp.round``
does; stochastic rounding ⌊t⌋ + [u < t − ⌊t⌋] draws u bit-exact with
``jax.random.uniform`` (:mod:`repro_torch.prng`). Packed int4 is offset-binary (code + 8), the low nibble holding the
even element; only ``uint8`` is shifted (torch on the CPU cannot shift
``uint32``).

The paper's interval grid (``grid='zipml'``) follows ``encode_jnp``: codes =
sign(x) · round(clip(|x|/scale, 0, 1) · s) with stochastic rounding
⌊t⌋ + [u < t − ⌊t⌋] on a ``jax.random.uniform``-exact draw
(:mod:`repro_torch.prng`), or nearest rounding; decode = codes / s · scale.
A double-sampled pair (``rounding='ds'``) carries its second plane in
``codes2``.

The bitplane layout (``QScheme.bitplane``) stores a sign plane and
``bits`` magnitude planes, MSB first, 32 elements per word: bit ``j`` of
word ``w`` is element ``32·w + j``, the tail word zero-padded. The magnitude
is truncated (⌊|x|·2^B/scale⌋, scale = absmax), so the top-k planes decode
to exactly the direct k-bit encoding (:meth:`QTensor.slice_planes`). The
words are the reference's ``uint32`` words held as ``int32`` (the same 32
bits): torch on the CPU cannot shift ``uint32`` (ROADMAP C3), while an
arithmetic shift of an ``int32`` followed by ``& 1`` reads every bit, bit
31 included.

The level grid (``grid='levels'``, C4) stores indices into a sorted level
table carried as ``levels``: :func:`quantize_to_levels` rounds onto it
(``searchsorted(side='right')`` as ``torch.searchsorted(right=True)``, the
up-draw ``jax.random.uniform``-exact), and decode looks the codes up — in a
per-slice table for stacked weights, whose ``levels`` are (L, n_levels).

Stacked layer weights keep their leading layer axis — codes (L, K, N) with
(L, 1, N) channel scales, bitplane codes (L, P, K, W) — and
:meth:`QTensor.index` hands out the per-layer view without copying.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch import prng

from .scheme import QScheme


def _code_dtype(s: int):
    return torch.int8 if s <= 127 else torch.int32


def stochastic_round(t: torch.Tensor, key: torch.Tensor | None,
                     u: torch.Tensor | None = None) -> torch.Tensor:
    """Unbiased stochastic rounding ⌊t⌋ + Bernoulli(t − ⌊t⌋) (Lemma 6), the
    uniform draw bit-exact with ``jax.random.uniform(key, t.shape)`` — or
    the plane ``u`` drawn beforehand from that key."""
    lo = torch.floor(t)
    if u is None:
        u = prng.uniform(key, t.shape, device=t.device)
    return lo + (u < (t - lo)).to(torch.float32)


def _round(t: torch.Tensor, key, u=None) -> torch.Tensor:
    if key is None and u is None:
        return torch.round(t)
    return stochastic_round(t, key, u)


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


# bit j of a packed word as an int32: 1 << j, and -2^31 for bit 31 (the
# same 32 bits as the reference's uint32 word)
_BIT_WEIGHTS = [1 << j for j in range(31)] + [-(1 << 31)]


def pack_bitplanes(planes: torch.Tensor) -> torch.Tensor:
    """0/1 planes ``(…, D)`` → int32 words ``(…, ⌈D/32⌉)``: bit ``j`` of
    word ``w`` holds element ``32·w + j``, the tail word zero-padded — the
    reference's uint32 words, bit for bit."""
    d = planes.shape[-1]
    b = planes.to(torch.int32)
    pad = (-d) % 32
    if pad:
        b = F.pad(b, (0, pad))
    b = b.reshape(*b.shape[:-1], -1, 32)
    w = torch.tensor(_BIT_WEIGHTS, dtype=torch.int32, device=b.device)
    # distinct bits: the int64 sum stays inside int32 in any order
    return (b * w).sum(dim=-1).to(torch.int32)


def unpack_bitplanes(words: torch.Tensor, d: int) -> torch.Tensor:
    """int32 (or uint32) words ``(…, ⌈d/32⌉)`` → int32 0/1 planes ``(…, d)``
    (inverse of :func:`pack_bitplanes`)."""
    if words.dtype == torch.uint32:
        words = words.view(torch.int32)
    shifts = torch.arange(32, dtype=torch.int32, device=words.device)
    bits = (words[..., None] >> shifts) & 1
    return bits.reshape(*words.shape[:-1], words.shape[-1] * 32)[..., :d]


def decode_bitplanes(words: torch.Tensor, scale: torch.Tensor, d: int,
                     dtype=torch.float32) -> torch.Tensor:
    """Bitplane words ``(*lead, P, R, ⌈d/32⌉)`` → values ``(*lead, R, d)`` in
    ``dtype``: sign · mag · scale · 2^−k with k = P − 1 read off the plane
    axis, so one decode serves every ``slice_planes(k)`` view (the
    reference's operation order; the integer magnitude is exact)."""
    k = words.shape[-3] - 1
    bits = unpack_bitplanes(words, d).movedim(-3, 0)
    mag = torch.zeros_like(bits[0])
    for p in range(k):
        mag = mag * 2 + bits[1 + p]
    sign = 1.0 - 2.0 * bits[0].to(dtype)
    return sign * mag.to(dtype) * scale.to(dtype) * (2.0 ** -k)


def _encode_bitplane(x: torch.Tensor, scheme: QScheme,
                     scale: torch.Tensor) -> "QTensor":
    """Bit-serial encode: codes ``(*lead, B+1, R, ⌈D/32⌉)`` for x
    ``(*lead, R, D)`` — the plane axis at −3, as in the reference. The
    magnitude is truncated, ⌊|x|/scale · 2^B⌋ clipped to 2^B − 1, so the
    top-k planes are the direct k-bit encoding. Planes are packed one at a
    time (a stacked whole-plane int expansion of a large weight would not
    fit)."""
    if x.ndim < 2:
        raise ValueError(
            f"bitplane layout packs matrices (ndim >= 2), got {tuple(x.shape)}")
    b = scheme.bits
    x32 = x.to(torch.float32)
    mag = torch.clamp(torch.floor(x32.abs() / scale * (2.0 ** b)), 0.0,
                      float(2 ** b - 1)).to(torch.int32)
    planes = [pack_bitplanes(x32 < 0)]
    planes += [pack_bitplanes((mag >> (b - 1 - p)) & 1) for p in range(b)]
    scheme = dataclasses.replace(scheme, vec_dim=int(x.shape[-1]))
    return QTensor(torch.stack(planes, dim=-3), scale, scheme)


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


def div_exact(t: torch.Tensor, c: float) -> torch.Tensor:
    """t / c as an IEEE division on every device: torch on CUDA divides by a
    Python scalar as a multiplication by its reciprocal, one ulp off the
    quotient for a few percent of values (ROADMAP C17), so the divisor goes
    in as a tensor."""
    return t / torch.full_like(t, float(c))


def compute_scale(x: torch.Tensor, scheme: QScheme) -> torch.Tensor:
    """The decode multiplier of ``x`` under ``scheme``'s scaling family:
    absmax/qmax on the int grid, absmax itself on the zipml grid and the
    bitplane layout, with an
    all-zero group mapped to scale 1 (so its decode is exact)."""
    if scheme.grid == "levels":
        raise ValueError("grid='levels' has no scale: its codes index a level table")
    m = _absmax(x.detach().to(torch.float32), scheme)
    if scheme.grid == "int" and scheme.layout == "bitplane":
        # magnitudes live on [0, 1): the scale is the absmax itself, the
        # same for every plane slice
        return torch.where(m == 0, torch.ones_like(m), m)
    if scheme.grid == "int":
        return torch.where(m == 0, torch.ones_like(m), div_exact(m, scheme.qmax))
    return torch.where(m == 0, torch.ones_like(m), m)


class QTensor:
    """codes + scale(s) + scheme, plus the second double-sampling plane
    ``codes2`` of a §2.2 pair (Q₁ and Q₂ share the base level, so the pair
    costs one extra bit) and the ``levels`` table of the level grid."""

    __slots__ = ("codes", "scale", "scheme", "codes2", "levels")

    def __init__(self, codes: torch.Tensor, scale: torch.Tensor, scheme: QScheme,
                 codes2: torch.Tensor | None = None,
                 levels: torch.Tensor | None = None):
        self.codes = codes
        self.scale = scale
        self.scheme = scheme
        self.codes2 = codes2
        self.levels = levels

    @property
    def shape(self):
        """Logical shape: bitplane codes (*lead, P, R, W) report the decoded
        (*lead, R, vec_dim)."""
        s = tuple(self.codes.shape)
        if self.scheme.layout == "bitplane":
            return (*s[:-3], s[-2], self.scheme.vec_dim)
        return s

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def is_ds(self) -> bool:
        return self.codes2 is not None

    @property
    def nbits(self) -> int:
        """Storage bits per element; a double-sampled pair pays +1."""
        return self.scheme.code_bits + (1 if self.is_ds else 0)

    @property
    def nbytes(self) -> int:
        """Logical HBM bytes: packed codes + f32 scales + f32 level table
        (the reference's ``QTensor.nbytes`` accounting). Bitplane codes
        count their 32-bit words, so a ``slice_planes(k)`` view costs bytes
        linear in k + 1."""
        if self.scheme.layout == "bitplane":
            return 4 * math.prod(self.codes.shape) + 4 * math.prod(self.scale.shape)
        n = math.prod(self.codes.shape)
        if self.scheme.packed:
            n *= 2                               # two logical codes per byte
        total = -(-n * self.nbits // 8) + math.prod(self.scale.shape) * 4
        if self.levels is not None:
            total += 4 * math.prod(self.levels.shape)
        return total

    def _decode_plane(self, codes, dtype=None) -> torch.Tensor:
        sch = self.scheme
        if sch.grid == "levels":
            return decode_levels(codes, self.levels, dtype)
        ct = torch.float32 if dtype is None else dtype
        if sch.layout == "bitplane":
            return decode_bitplanes(codes, self.scale, sch.vec_dim, ct)
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

    def slice_planes(self, k: int) -> "QTensor":
        """Top-k-bit view of a bitplane QTensor: the sign plane + the k most
        significant magnitude planes — a slice, no repacking — whose decode
        equals encoding the original tensor directly at k bits."""
        if self.scheme.layout != "bitplane":
            raise ValueError("slice_planes needs layout='bitplane', got "
                             f"{self.scheme.layout!r}")
        if not 1 <= k <= self.scheme.bits:
            raise ValueError(f"k must be in 1..{self.scheme.bits}, got {k}")
        if k == self.scheme.bits:
            return self
        return QTensor(self.codes[..., :k + 1, :, :], self.scale,
                       dataclasses.replace(self.scheme, bits=k))

    def dot(self, v: torch.Tensor, backend=None) -> torch.Tensor:
        """decode(self) @ v through the kernel-backend registry (the ``cuda``
        backend streams int8 codes through ``qmv``)."""
        return dot(self, v, backend=backend)

    def index(self, i: int) -> "QTensor":
        """Layer ``i`` of a stacked (L, …) QTensor — views, not copies (a
        per-slice level table is sliced with it)."""
        lv = self.levels
        return QTensor(self.codes[i], self.scale[i], self.scheme,
                       None if self.codes2 is None else self.codes2[i],
                       lv[i] if lv is not None and lv.ndim > 1 else lv)

    def to(self, device) -> "QTensor":
        def mv(t):
            return None if t is None else t.to(device)

        return QTensor(self.codes.to(device), self.scale.to(device), self.scheme,
                       mv(self.codes2), mv(self.levels))

    def __repr__(self):
        extra = "+ds" if self.is_ds else ""
        return (f"QTensor({tuple(self.codes.shape)}, {self.scheme.grid}{extra}, "
                f"bits={self.scheme.bits}, scaling={self.scheme.scaling})")


def encode(x: torch.Tensor, scheme: QScheme, key: torch.Tensor | None = None,
           scale: torch.Tensor | None = None, levels: torch.Tensor | None = None,
           backend=None, *, u: torch.Tensor | None = None) -> QTensor:
    """Quantize ``x`` under ``scheme`` (the reference's ``encode_jnp``
    numerics). Both grids take stochastic rounding (``key`` required; the
    uniform draw is ``jax.random.uniform(key, x.shape)``-exact) or nearest:
    the int grid gives int8 codes (packed uint8 nibbles at ``packed=True``),
    the zipml grid codes on s intervals, the bitplane layout its packed
    sign and magnitude planes, the level grid indices into ``levels``
    (scale 1); ``rounding='ds'`` draws the §2.2 pair through
    :func:`ds_pair`. ``scale=None`` computes the scheme's own scale. ``u``
    stands in for the stochastic draw ``prng.uniform(key, x.shape)`` (a
    plane drawn beforehand, in a batch with others)."""
    if scheme.rounding == "ds":
        return ds_pair(x, scheme, key, scale=scale, backend=backend)
    if scheme.rounding == "stochastic" and key is None and u is None:
        raise ValueError("stochastic rounding requires a PRNG key")
    if scheme.grid == "levels":
        if levels is None:
            raise ValueError("grid='levels' requires a level table")
        levels = torch.as_tensor(levels, dtype=torch.float32, device=x.device)
        nearest = scheme.rounding == "nearest"
        codes, _ = quantize_to_levels(x, levels, None if nearest else key,
                                      u=None if nearest else u)
        return QTensor(codes, torch.ones((), dtype=torch.float32, device=x.device),
                       scheme, levels=levels)
    if scale is None:
        scale = compute_scale(x, scheme)
    else:
        scale = torch.as_tensor(scale, dtype=torch.float32, device=x.device)
    if scheme.layout == "bitplane":
        return _encode_bitplane(x, scheme, scale)
    nearest = scheme.rounding == "nearest"
    rkey, ru = (None, None) if nearest else (key, u)
    if scheme.grid == "zipml":
        return _encode_zipml(x, scheme, scale, rkey, ru)
    qmax = float(scheme.qmax)
    t = x.to(torch.float32) / scale
    codes = torch.clamp(_round(t, rkey, ru), -qmax, qmax).to(_code_dtype(scheme.qmax))
    if scheme.packed:
        codes = pack_int4(codes)
    return QTensor(codes, scale, scheme)


def _encode_zipml(x, scheme: QScheme, scale, key, u=None) -> QTensor:
    s = scheme.s
    xn = (x / scale).to(torch.float32)
    mag = torch.clamp(xn.abs() if scheme.signed else xn, 0.0, 1.0)
    codes = _round(mag * s, key, u)
    if scheme.signed:
        codes = codes * torch.sign(xn)
    return QTensor(codes.to(_code_dtype(s)), scale, scheme)


def quantize_to_levels(v: torch.Tensor, levels: torch.Tensor, key=None, *,
                       u: torch.Tensor | None = None):
    """Stochastic (``key`` or a uniform plane ``u``) or nearest (neither)
    rounding onto a sorted level table, unbiased inside its range — the
    reference's ``quantize_to_levels_jnp``. ``levels`` is one table (L,)
    or one per leading slice of ``v`` (…, L) against ``v`` (…, n). Returns
    (codes, values): int8 codes for up to 128 levels, int32 above."""
    lv = levels.to(torch.float32)
    v32 = v.to(torch.float32)
    k = lv.shape[-1]
    vc = torch.clamp(v32, lv[..., :1], lv[..., -1:]) if lv.ndim > 1 else \
        torch.clamp(v32, lv[0], lv[-1])
    if lv.ndim > 1:
        hi_idx = torch.searchsorted(lv.contiguous(), vc.contiguous(), right=True)
    else:
        hi_idx = torch.searchsorted(lv.contiguous(), vc, right=True)
    hi_idx = torch.clamp(hi_idx, 1, k - 1)
    lo_idx = hi_idx - 1
    if lv.ndim > 1:
        lo, hi = torch.gather(lv, -1, lo_idx), torch.gather(lv, -1, hi_idx)
    else:
        lo, hi = lv[lo_idx], lv[hi_idx]
    width = torch.clamp_min(hi - lo, 1e-30)
    p_up = (vc - lo) / width
    if u is None and key is not None:
        u = prng.uniform(key, v32.shape, device=v32.device)
    up = p_up >= 0.5 if u is None else u < p_up
    codes = torch.where(up, hi_idx, lo_idx).to(_code_dtype(k - 1))
    return codes, torch.where(up, hi, lo)


def decode_levels(codes: torch.Tensor, levels: torch.Tensor, dtype=None) -> torch.Tensor:
    """Level-table lookup: one table (L,), or one per leading slice
    (…, L) of codes (…, rows, cols). The table is cast to ``dtype`` first,
    which rounds each value as casting the looked-up values would."""
    lv = levels if dtype is None else levels.to(dtype)
    idx = codes.reshape(-1).to(torch.int32)
    if lv.ndim == 1:
        return torch.index_select(lv, 0, idx).reshape(codes.shape)
    lead = math.prod(lv.shape[:-1])
    flat = lv.reshape(lead, lv.shape[-1])
    per = idx.reshape(lead, -1).to(torch.int64)
    return torch.gather(flat, 1, per).reshape(codes.shape)


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
