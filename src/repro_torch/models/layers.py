"""Transformer building blocks (port of ``repro.models.layers``): plain
functions over nested dicts of tensors, with the reference's numerics —
compute in ``cfg.dtype``, accumulation and normalisation in f32.

Weights are stored stacked over layers (L, …) exactly as the reference's
``lax.scan`` layout; the forward loops over per-layer views
(:func:`layer_view`).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.quant import QTensor, ShipWeight, mm_f32, quant_dense

Params = dict


def layer_view(tree, i: int):
    """Layer ``i`` of a stacked param tree — views, not copies."""
    if isinstance(tree, dict):
        return {k: layer_view(v, i) for k, v in tree.items()}
    if isinstance(tree, QTensor):
        return tree.index(i)
    return tree[i]


def unstack_layers(tree, n: int) -> list:
    """All ``n`` per-layer views of a stacked param tree at once. Tensors
    split with one ``unbind`` each, so autograd sees one node per stacked
    leaf and the backward stacks the n per-layer gradients once (n ``select``
    views would each scatter into a zero-filled full-size gradient)."""
    if isinstance(tree, dict):
        per_key = {k: unstack_layers(v, n) for k, v in tree.items()}
        return [{k: v[i] for k, v in per_key.items()} for i in range(n)]
    if isinstance(tree, QTensor):
        return [tree.index(i) for i in range(n)]
    if isinstance(tree, ShipWeight):
        return [ShipWeight(m, tree.qt.index(i))
                for i, m in enumerate(tree.master.unbind(0))]
    return list(tree.unbind(0))


def _normal(gen, shape, device):
    return torch.randn(shape, generator=gen, device=device, dtype=torch.float32)


def draw_layers(gen, shape, scale: float, *, lead=(), dtype=torch.bfloat16, device="cpu"):
    """A weight's N(0, 1)·scale draws, each in f32 and then cast to
    ``dtype``: one a layer (index of the first ``lead`` axis, shape
    ``(*lead[1:], *shape)``) of a stacked weight, the whole ``shape`` of an
    unstacked one. Every stacked weight of ``init_params`` is drawn in this
    order, whether it is kept or encoded as it comes."""
    n = lead[0] if lead else 1
    for _ in range(n):
        yield (_normal(gen, (*lead[1:], *shape), device) * scale).to(dtype)


def stack_layers(layers, lead) -> torch.Tensor:
    """The default weight store of the inits: the drawn layers written one
    at a time into one ``(*lead, …)`` tensor (an unstacked weight is its
    one draw)."""
    first = next(layers)
    if not lead:
        return first
    out = first.new_empty((lead[0], *first.shape))
    out[0] = first
    for i, w in enumerate(layers, 1):
        out[i] = w
    return out


def init_dense(gen, d_in: int, d_out: int, *, lead=(), dtype=torch.bfloat16,
               device="cpu", scale: float | None = None, bias: bool = False,
               weight=stack_layers) -> Params:
    """w ~ N(0, 1)·scale (default d_in^-0.5), drawn in f32 a layer at a time
    (:func:`draw_layers`) and stored by ``weight(layers, lead)``;
    ``bias`` adds ``b``, zeros of shape (*lead, d_out) in ``dtype``."""
    scale = scale if scale is not None else d_in ** -0.5
    p = {"w": weight(draw_layers(gen, (d_in, d_out), scale, lead=lead, dtype=dtype,
                                 device=device), lead)}
    if bias:
        p["b"] = torch.zeros((*lead, d_out), dtype=dtype, device=device)
    return p


def dense(p: Params, x: torch.Tensor) -> torch.Tensor:
    """y = x · W in f32, cast back to ``x.dtype``; a QTensor or ShipWeight
    goes through the ``quant_dense`` registry op (codes streamed by the
    kernel on the card; a ShipWeight's gradient flows to its master)."""
    w = p["w"]
    y = quant_dense(x, w) if isinstance(w, (QTensor, ShipWeight)) else mm_f32(x, w)
    y = y.to(x.dtype)
    if "b" in p:
        y = y + p["b"].to(y.dtype)
    return y


def init_embedding(gen, vocab: int, d_model: int, *, dtype=torch.bfloat16,
                   device="cpu") -> Params:
    return {"table": _normal(gen, (vocab, d_model), device).to(dtype)
            * d_model ** -0.5}


def embed(p: Params, ids: torch.Tensor, dtype=None) -> torch.Tensor:
    """Rows of the embedding table at ``ids``. A QTensor table gathers its
    code rows first and decodes only those (decoding the whole (V, d) table
    per step would build a bf16 vocab table to read a few rows); it decodes
    the whole table first only where the scale or the level table carries
    the vocab dimension, as the reference does.

    ``dtype`` is the caller's compute dtype. A QTensor decodes to bf16, as
    the reference does, except for an int-grid table read at f32: there the
    reference's jitted programs keep codes · bf16(scale) in f32 and drop the
    product's bf16 rounding (ROADMAP C4), so the port returns that exact
    product (whose bf16 rounding is the bf16 decode)."""
    table = p["table"]
    idx = ids.to(torch.int64)
    if not isinstance(table, QTensor):
        return table[idx]
    if table.scheme.layout == "bitplane":
        raise ValueError(
            "embed of a bitplane table: the reference gathers the ids along "
            "the plane axis of the (P, V, W) words and returns the wrong "
            "shape (ROADMAP C16); serve bitplane weights with a dense or int "
            "table")
    vdim = table.shape[0]
    scale_rowed = table.scale.ndim > 0 and table.scale.shape[0] == vdim
    levels_rowed = table.levels is not None and table.levels.ndim > 1
    if scale_rowed or levels_rowed:
        return _decode_table(table, dtype)[idx]
    return _decode_table(QTensor(table.codes[idx], table.scale, table.scheme,
                                 levels=table.levels), dtype)


def _decode_table(qt: QTensor, dtype) -> torch.Tensor:
    """A table (or its gathered rows) decoded for a caller at ``dtype``."""
    if dtype == torch.float32 and qt.scheme.grid == "int":
        return QTensor(qt.codes, qt.scale.to(torch.bfloat16), qt.scheme).decode()
    return qt.decode(torch.bfloat16)


def unembed(p: Params, x: torch.Tensor) -> torch.Tensor:
    """Tied readout: logits = x · tableᵀ in f32. A QTensor or ShipWeight
    table streams its codes through the transposed product of
    ``quant_dense`` (``qmm_t`` on the card); a dense one is a plain
    product, as the reference leaves it to XLA."""
    table = p["table"]
    if isinstance(table, (QTensor, ShipWeight)):
        return quant_dense(x, table, transpose=True)
    return mm_f32(x, table.t())


def init_rmsnorm(d: int, *, lead=(), dtype=torch.bfloat16, device="cpu") -> Params:
    return {"g": torch.ones((*lead, d), dtype=dtype, device=device)}


def rmsnorm(p: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    x32 = x.to(torch.float32)
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * (1.0 + p["g"].to(torch.float32))).to(x.dtype)


def rope_frequencies(head_dim: int, theta: float = 10_000.0, device="cpu"):
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10_000.0) -> torch.Tensor:
    """x: (..., S, H, D); positions broadcastable to (..., S). Rotates the
    two halves of the head (not interleaved pairs)."""
    d = x.shape[-1]
    freqs = rope_frequencies(d, theta, x.device)
    angles = positions[..., None].to(torch.float32) * freqs
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def init_mlp(gen, d_model: int, d_ff: int, *, lead=(), dtype=torch.bfloat16,
             device="cpu", weight=stack_layers) -> Params:
    kw = dict(lead=lead, dtype=dtype, device=device, weight=weight)
    return {"up": init_dense(gen, d_model, d_ff, **kw),
            "gate": init_dense(gen, d_model, d_ff, **kw),
            "down": init_dense(gen, d_ff, d_model, scale=d_ff ** -0.5, **kw)}


def _const(v: float, dtype) -> float:
    """``v`` rounded to ``dtype`` on the host (a Python scalar, so using it
    costs no host-to-device copy)."""
    return float(torch.tensor(v, dtype=dtype))


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """tanh-approximate GELU as ``jax.nn.gelu(approximate=True)`` evaluates
    it: the same op sequence, each op and constant in ``x.dtype`` (at bf16
    this rounds after every op, where ``F.gelu`` rounds once)."""
    c1 = _const(0.044715, x.dtype)
    c2 = _const(math.sqrt(2 / math.pi), x.dtype)
    inner = x + c1 * (x * x * x)
    return x * (0.5 * (1.0 + torch.tanh(c2 * inner)))


def mlp(p: Params, x: torch.Tensor, act: str = "silu") -> torch.Tensor:
    h_gate = dense(p["gate"], x)
    h_up = dense(p["up"], x)
    a = F.silu(h_gate) if act == "silu" else gelu_tanh(h_gate)
    return dense(p["down"], a * h_up)
