"""Model quantization (port of ``repro.precision.qat``).

* :func:`quantize_param_tree` — int storage for serving: every matmul
  weight ``w`` (a leaf named ``"w"`` with ≥ 2 dims) becomes a
  :class:`~repro_torch.quant.QTensor` of int codes with per-out-channel f32
  scales (reduced over d_in, axis −2 — stacked (L, K, N) weights get
  (L, 1, N) scales). 4-bit codes pack two nibbles per byte whenever the
  out-channel dim is even. Embedding tables stay unquantized.
* :func:`ship_quant_tree` — quantize-on-gather for training: each large
  weight becomes a :class:`~repro_torch.quant.ShipWeight` (nearest-rounded
  codes for the matmul + the master for the straight-through gradient).
  The reference's sharding pins are no-ops on one card.
* :func:`fake_quant_tree` — QAT fake quantization: the forward sees the
  stochastically rounded weight, the gradient passes straight through.

``quantize_param_tree(..., layout='bitplane')`` stores each matmul weight
bit-serially (:meth:`~repro_torch.quant.QScheme.bitplane`): one artifact
serves any precision 1..bits through ``QTensor.slice_planes``. Level tables
(``optimal``) and ``include_embedding`` wait for ROADMAP A2.3 and A5.
"""
from __future__ import annotations

import torch

from repro_torch import prng
from repro_torch.quant import QScheme, QTensor, ShipWeight, encode


def _is_weight(key: str, leaf) -> bool:
    """Matmul weights only: 2-D+ leaves named ``w`` (embedding tables stay
    unquantized)."""
    return key == "w" and not isinstance(leaf, (QTensor, ShipWeight)) and leaf.ndim >= 2


def _weight_scheme(bits: int, rounding: str = "nearest", packed: bool = False) -> QScheme:
    return QScheme.int_symmetric(bits, scaling="channel", rounding=rounding,
                                 channel_axis=-2, packed=packed)


def _auto_packed(bits: int, w: torch.Tensor, packed: bool | None) -> bool:
    if packed is not None:
        return packed
    return bits == 4 and w.shape[-1] % 2 == 0


def _map_weights(params, fn):
    """``fn(leaf)`` on every matmul weight, in sorted-key order (the
    reference's ``tree_map_with_path`` order); other leaves pass through."""
    out = {}
    for key in sorted(params):
        leaf = params[key]
        if isinstance(leaf, dict):
            out[key] = _map_weights(leaf, fn)
        else:
            out[key] = fn(leaf) if _is_weight(key, leaf) else leaf
    return out


def quantize_param_tree(params, bits: int = 8, optimal: bool = False,
                        packed: bool | None = None,
                        include_embedding: bool = False,
                        layout: str = "dense"):
    """Convert every matmul weight of a nested-dict param tree to QTensor
    storage (codes and scales byte-identical to the reference).

    ``layout='bitplane'`` stores each weight bit-serially; it excludes
    ``optimal=`` and ``packed=``. A stacked (L, K, N) weight is encoded one
    layer at a time, which bounds the encode's temporaries (several f32 and
    int copies of the leaf) by one layer's — a few GB less per full-width
    MLP weight — and gives the whole-leaf codes, since the channel scales
    reduce within a layer."""
    if layout not in ("dense", "bitplane"):
        raise ValueError(f"layout must be 'dense' or 'bitplane', got {layout!r}")
    if layout == "bitplane" and (optimal or packed):
        raise ValueError("layout='bitplane' excludes optimal= and packed=")
    if optimal or include_embedding:
        raise NotImplementedError(
            "optimal levels / quantized embeddings are not ported "
            "(ROADMAP A2.3, A5)")
    if layout == "bitplane":
        return _map_weights(params, lambda w: _encode_by_layer(w, QScheme.bitplane(bits)))
    return _map_weights(params, lambda w: encode(
        w, _weight_scheme(bits, packed=_auto_packed(bits, w, packed))))


def _encode_by_layer(w: torch.Tensor, scheme: QScheme) -> QTensor:
    """``encode(w, scheme)`` of a 2-D weight, or of a stacked (L, K, N) one
    layer by layer with the per-layer codes and scales stacked."""
    if w.ndim == 2:
        return encode(w, scheme)
    parts = [encode(wi, scheme) for wi in w.unbind(0)]
    return QTensor(torch.stack([q.codes for q in parts]),
                   torch.stack([q.scale for q in parts]), parts[0].scheme)


class _STE(torch.autograd.Function):
    """Forward the quantized value, pass the gradient straight through."""

    @staticmethod
    def forward(ctx, x, xq):
        return xq

    @staticmethod
    def backward(ctx, g):
        return g, None


def fake_quant(w: torch.Tensor, bits: int, key=None) -> torch.Tensor:
    """Per-out-channel fake quantization with a straight-through gradient:
    stochastic rounding with ``key`` (unbiased), nearest without."""
    rounding = "nearest" if key is None else "stochastic"
    qt = encode(w.detach(), _weight_scheme(bits, rounding), key)
    return _STE.apply(w, qt.decode().to(w.dtype))


def fake_quant_tree(params, bits: int, key=None):
    """:func:`fake_quant` on every matmul weight; weight i (counted from 1
    in sorted-key order) draws with ``fold_in(key, i)``."""
    count = [0]

    def go(w):
        k = None
        if key is not None:
            count[0] += 1
            k = prng.fold_in(key, count[0])
        return fake_quant(w, bits, k)

    return _map_weights(params, go)


def ship_quant(w: torch.Tensor, bits: int, packed: bool | None = None) -> ShipWeight:
    """Nearest-rounded int codes of ``w`` (per-out-channel scales; stacked
    weights get per-layer (L, 1, d_out) scales) + ``w`` itself as the
    master the straight-through gradient flows to."""
    scheme = _weight_scheme(bits, packed=_auto_packed(bits, w, packed))
    return ShipWeight(w, encode(w.detach(), scheme))


def ship_quant_tree(params, bits: int, min_size: int = 1 << 16):
    """:func:`ship_quant` on every matmul weight of at least ``min_size``
    elements (smaller ones stay dense, as in the reference)."""
    return _map_weights(params, lambda w: ship_quant(w, bits)
                        if w.numel() >= min_size else w)
