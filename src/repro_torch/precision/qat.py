"""Model quantization (port of ``repro.precision.qat``).

* :func:`quantize_param_tree` — int storage for serving: every matmul
  weight ``w`` (a leaf named ``"w"`` with ≥ 2 dims) becomes a
  :class:`~repro_torch.quant.QTensor` of int codes with per-out-channel f32
  scales (reduced over d_in, axis −2 — stacked (L, K, N) weights get
  (L, 1, N) scales). 4-bit codes pack two nibbles per byte whenever the
  out-channel dim is even. ``include_embedding`` quantizes the embedding
  tables (``table`` leaves) too: ``embed`` then gathers code rows and the
  tied unembed streams the codes through ``qmm_t``.
* :func:`ship_quant_tree` — quantize-on-gather for training: each large
  weight becomes a :class:`~repro_torch.quant.ShipWeight` (nearest-rounded
  codes for the matmul + the master for the straight-through gradient).
  The reference's sharding pins are no-ops on one card.
* :func:`fake_quant_tree` — QAT fake quantization: the forward sees the
  stochastically rounded weight, the gradient passes straight through.

``quantize_param_tree(..., layout='bitplane')`` stores each matmul weight
bit-serially (:meth:`~repro_torch.quant.QScheme.bitplane`): one artifact
serves any precision 1..bits through ``QTensor.slice_planes``.
``optimal=True`` snaps each weight onto its variance-optimal symmetric level
set (§3.3's Optimal5), a ``grid='levels'`` QTensor with int16 codes and its
level table; an embedding table keeps the int scheme there, as in the
reference.
"""
from __future__ import annotations

import itertools

import numpy as np
import torch

from repro_torch import prng
from repro_torch.core import optimal as opt_mod
from repro_torch.quant import QScheme, QTensor, ShipWeight, encode

def _is_weight(key: str, leaf) -> bool:
    """Matmul weights only: 2-D+ leaves named ``w`` (embedding tables stay
    unquantized)."""
    return key == "w" and _is_dense(leaf)


def _is_dense(leaf) -> bool:
    return not isinstance(leaf, (QTensor, ShipWeight)) and leaf.ndim >= 2


def _weight_scheme(bits: int, rounding: str = "nearest", packed: bool = False) -> QScheme:
    return QScheme.int_symmetric(bits, scaling="channel", rounding=rounding,
                                 channel_axis=-2, packed=packed)


def _auto_packed(bits: int, w: torch.Tensor, packed: bool | None) -> bool:
    if packed is not None:
        return packed
    return bits == 4 and w.shape[-1] % 2 == 0


def _store_scheme(bits: int, layout: str, w: torch.Tensor,
                  packed: bool | None = None) -> QScheme:
    """The scheme of matmul weight ``w`` stored at ``bits`` in ``layout``
    (int: 4-bit codes packed where the out-channel dim is even, unless
    ``packed`` says)."""
    if layout == "bitplane":
        return QScheme.bitplane(bits)
    return _weight_scheme(bits, packed=_auto_packed(bits, w, packed))


def _map_weights(params, fn, table_fn=None):
    """``fn(leaf)`` on every matmul weight, in sorted-key order (the
    reference's ``tree_map_with_path`` order), and ``table_fn(leaf)`` on
    every 2-D+ embedding table (a leaf named ``table``) when given; other
    leaves pass through."""
    out = {}
    for key in sorted(params):
        leaf = params[key]
        if isinstance(leaf, dict):
            out[key] = _map_weights(leaf, fn, table_fn)
        elif _is_weight(key, leaf):
            out[key] = fn(leaf)
        elif table_fn is not None and key == "table" and _is_dense(leaf):
            out[key] = table_fn(leaf)
        else:
            out[key] = leaf
    return out


def _optimal_quantize_weight(w: torch.Tensor, bits: int, sample: int = 65536) -> QTensor:
    """C4 + C5: codes snapped to the weight's variance-optimal symmetric
    level set — the discretized DP (M 256) on |w| over the leaf's largest
    magnitude, mirrored around 0 — stored as int16 level indices with the
    f32 table. Leaves above ``sample`` entries fit on ``sample`` of them
    drawn by ``default_rng(0).choice(n, sample, replace=False)``: the
    indices of the reference's ``choice`` on the flattened array (the same
    draw), gathered on the weight's device rather than copying the whole
    leaf to the host. Stacked (L, K, N) weights carry the table per layer,
    (L, n_levels), and encode layer by layer."""
    flat = w.detach().reshape(-1)
    if flat.numel() > sample:
        idx = np.random.default_rng(0).choice(flat.numel(), sample, replace=False)
        flat = flat[torch.from_numpy(idx).to(flat.device)]
    w_np = flat.to(torch.float32).cpu().numpy()
    s = 2 ** (bits - 1) - 1
    hi = float(np.abs(w_np).max()) or 1.0
    lv = opt_mod.optimal_levels_discretized(np.abs(w_np) / hi, s, M=256) * hi
    levels = torch.as_tensor(np.concatenate([-lv[::-1], lv[1:]]),
                             dtype=torch.float32).to(w.device)
    scheme = QScheme.levels(levels.shape[0], rounding="nearest")
    lead = tuple(w.shape[:-2])
    layers = w.reshape(-1, *w.shape[-2:]).unbind(0)
    codes = torch.stack([encode(wi.to(torch.float32), scheme, levels=levels)
                         .codes.to(torch.int16) for wi in layers]).reshape(w.shape)
    if lead:
        levels = levels.expand(*lead, levels.shape[0])
    return QTensor(codes, torch.ones(lead, dtype=torch.float32, device=w.device),
                   scheme, levels=levels)


def migrate_spliced_weights(params, bits: int = 8):
    """The reference's one-shot migration of the old spliced weight dicts
    (``w_q`` + ``w_scale`` int splices, ``w_lvl_codes`` + ``w_levels`` level
    splices) to a QTensor at ``"w"``; a dim-less level table next to
    stacked codes is broadcast per layer. ``bits`` labels the int scheme."""

    def fix(node):
        if not isinstance(node, dict):
            return node
        node = {k: fix(v) for k, v in node.items()}
        if "w_q" in node:
            codes = node.pop("w_q")
            scale = torch.as_tensor(node.pop("w_scale"), dtype=torch.float32)
            node["w"] = QTensor(codes, scale, _weight_scheme(bits))
        elif "w_lvl_codes" in node:
            codes = node.pop("w_lvl_codes")
            levels = torch.as_tensor(node.pop("w_levels"), dtype=torch.float32)
            lead = tuple(codes.shape[:-2])
            if lead and levels.ndim == 1:
                levels = levels.expand(*lead, levels.shape[0])
            node["w"] = QTensor(codes, torch.ones(lead, dtype=torch.float32),
                                QScheme.levels(int(levels.shape[-1])), levels=levels)
        return node

    return fix(params)


def quantize_param_tree(params, bits: int = 8, optimal: bool = False,
                        packed: bool | None = None,
                        include_embedding: bool = False,
                        layout: str = "dense"):
    """Convert every matmul weight of a nested-dict param tree to QTensor
    storage (codes and scales byte-identical to the reference).

    ``layout='bitplane'`` stores each weight bit-serially; it excludes
    ``optimal=`` and ``packed=``. ``optimal=True`` stores each weight on its
    variance-optimal level table. A stacked (L, K, N) weight is encoded one
    layer at a time, which bounds the encode's temporaries (several f32 and
    int copies of the leaf) by one layer's — a few GB less per full-width
    MLP weight — and gives the whole-leaf codes, since the channel scales
    reduce within a layer. ``include_embedding`` also quantizes the
    embedding tables: the int or bitplane scheme of the weights, and the
    int scheme under ``optimal=True``."""
    if layout not in ("dense", "bitplane"):
        raise ValueError(f"layout must be 'dense' or 'bitplane', got {layout!r}")
    if layout == "bitplane" and (optimal or packed):
        raise ValueError("layout='bitplane' excludes optimal= and packed=")

    def codes(w):
        return _encode_by_layer(w, _store_scheme(bits, layout, w, packed))

    def optimal_codes(w):
        return _optimal_quantize_weight(w, bits)

    fn = optimal_codes if optimal else codes
    return _map_weights(params, fn, codes if include_embedding else None)


def _encode_by_layer(w: torch.Tensor, scheme: QScheme) -> QTensor:
    """``encode(w, scheme)`` of a 2-D weight, or of a stacked (L, K, N) one
    layer by layer (:func:`_encode_layers`)."""
    if w.ndim == 2:
        return encode(w, scheme)
    return _encode_layers(iter(w.unbind(0)), w.shape[0], scheme)


def _encode_layers(layers, n: int, scheme: QScheme) -> QTensor:
    """The ``n`` layers of a stacked weight, each encoded as it comes and
    its codes and scales written into (n, …) buffers allocated at the
    first: no stack of the parts, so a stacked leaf's codes exist once."""
    for i, wi in enumerate(layers):
        q = encode(wi, scheme)
        if i == 0:
            codes = q.codes.new_empty((n, *q.codes.shape))
            scale = q.scale.new_empty((n, *q.scale.shape))
            out_scheme = q.scheme
        codes[i], scale[i] = q.codes, q.scale
        del q
    return QTensor(codes, scale, out_scheme)


def quantizing_store(bits: int, layout: str = "dense"):
    """A weight store for ``init_params(cfg, weight=...)`` that encodes each
    matmul weight a layer at a time as it is drawn — codes and scales
    byte-identical to ``quantize_param_tree(init_params(cfg), bits=bits,
    layout=layout)`` — so the compute-dtype tree never exists whole: the
    build holds the codes and one layer's draw and encode temporaries."""
    if layout not in ("dense", "bitplane"):
        raise ValueError(f"layout must be 'dense' or 'bitplane', got {layout!r}")

    def store(layers, lead) -> QTensor:
        first = next(layers)
        scheme = _store_scheme(bits, layout, first)
        if not lead:
            return _encode_by_layer(first, scheme)
        return _encode_layers(itertools.chain([first], layers), lead[0], scheme)

    return store


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
