"""Model quantization for serving (port of ``repro.precision.qat``:
``quantize_param_tree`` for the dense layout).

Every matmul weight ``w`` (a leaf named ``"w"`` with ≥ 2 dims) becomes a
:class:`~repro_torch.quant.QTensor` of int codes with per-out-channel f32
scales (reduced over d_in, axis −2 — stacked (L, K, N) weights get (L, 1, N)
scales). 4-bit codes pack two nibbles per byte whenever the out-channel dim
is even. Embedding tables stay unquantized. Level tables (``optimal``), the
bitplane layout and ``include_embedding`` wait for ROADMAP A4/B11.
"""
from __future__ import annotations

import torch

from repro_torch.quant import QScheme, QTensor, encode


def _weight_scheme(bits: int, packed: bool = False) -> QScheme:
    return QScheme.int_symmetric(bits, scaling="channel", rounding="nearest",
                                 channel_axis=-2, packed=packed)


def _auto_packed(bits: int, w: torch.Tensor, packed: bool | None) -> bool:
    if packed is not None:
        return packed
    return bits == 4 and w.shape[-1] % 2 == 0


def quantize_param_tree(params, bits: int = 8, optimal: bool = False,
                        packed: bool | None = None,
                        include_embedding: bool = False,
                        layout: str = "dense"):
    """Convert every matmul weight of a nested-dict param tree to QTensor
    storage (codes and scales byte-identical to the reference)."""
    if optimal or include_embedding or layout != "dense":
        raise NotImplementedError(
            "optimal levels / quantized embeddings / bitplane layout are not "
            "in slice 1 (ROADMAP A4, B11)")

    def convert(node):
        out = {}
        for key, leaf in node.items():
            if isinstance(leaf, dict):
                out[key] = convert(leaf)
            elif key == "w" and not isinstance(leaf, QTensor) and leaf.ndim >= 2:
                out[key] = encode(
                    leaf, _weight_scheme(bits, _auto_packed(bits, leaf, packed)))
            else:
                out[key] = leaf
        return out

    return convert(params)
