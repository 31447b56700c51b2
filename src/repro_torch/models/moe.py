"""Mixture-of-Experts block: top-k routing with capacity-bounded local
dispatch (port of ``repro.models.moe``, forward only).

Two execution paths, chosen by token count (:func:`moe_block`):

* ``dense`` (decode, short prompts: at most ``dense_path_max_tokens``
  tokens): every expert runs on every token, and the outputs combine with
  the renormalised top-k gate weights — an f32 sum over all E experts.
* ``dispatch`` (longer prompts): each choice takes a slot in its expert's
  buffer of ``capacity`` rows, earlier tokens first; over-capacity choices
  drop to an overflow row; the experts run as one stacked product over the
  buffers, and each token gathers its kept choices back. On one card there
  is no mesh, so the dispatch is always the single-group (local) one.

Expert MLPs are gated (SwiGLU / GeGLU) like the dense family's. Expert
weights are stacked (E, K, N) — (L, E, K, N) over layers — and every
expert and router product goes through ``quant_dense``'s stacked form:
one ``qmm`` launch per expert slice on the card for int weights. The
reference's sharding hints, its mesh-size probe and the bf16-dW custom
VJP of its grouped einsum are training and multi-device machinery, left
out with MoE training (ROADMAP A6(e)).

The router is f32 in every model (``init_moe``). Top-k follows
``jax.lax.top_k``: descending, and the lower expert index first among
equal probabilities (a stable descending sort), since the dispatch gives
capacity in (token-major, k-minor) order and the order of the k choices
decides which ones drop.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.quant import QTensor, ShipWeight, bmm_f32, mm_f32, quant_dense

from .layers import Params, draw_layers, gelu_tanh, init_dense, stack_layers


@dataclasses.dataclass(frozen=True)
class MoESpec:
    n_experts: int
    top_k: int
    d_model: int
    d_ff: int
    act: str = "silu"
    capacity_factor: float = 1.25
    dense_path_max_tokens: int = 512   # ≤ this many tokens per step → dense path


def init_moe(gen, spec: MoESpec, *, lead=(), dtype=torch.bfloat16, device="cpu",
             weight=stack_layers) -> Params:
    """The router (``d_model`` × E, f32 whatever ``dtype``, N(0, 1/d)) and
    the stacked (*lead, E, K, N) gate, up and down expert matrices in
    ``dtype``, with the reference's distributions, each drawn a layer at a
    time and stored by ``weight`` (``layers.init_dense``)."""
    e, d, f = spec.n_experts, spec.d_model, spec.d_ff

    def expert_mat(din, dout, scale):
        return {"w": weight(draw_layers(gen, (e, din, dout), scale, lead=lead, dtype=dtype,
                                        device=device), lead)}

    return {
        "router": init_dense(gen, d, e, lead=lead, dtype=torch.float32, device=device,
                             scale=d ** -0.5, weight=weight),
        "gate": expert_mat(d, f, d ** -0.5),
        "up": expert_mat(d, f, d ** -0.5),
        "down": expert_mat(f, d, f ** -0.5),
    }


def _qeinsum(x: torch.Tensor, sub: Params) -> torch.Tensor:
    """x (…, E, M, K) · the stacked weight (E, K, N) → f32: a QTensor or
    ShipWeight through ``quant_dense`` (the kernel per expert slice on the
    card), a dense weight as one f32-accumulated batched product."""
    w = sub["w"]
    if isinstance(w, (QTensor, ShipWeight)):
        return quant_dense(x, w)
    return bmm_f32(x, w)


def _act(spec: MoESpec, g: torch.Tensor) -> torch.Tensor:
    return F.silu(g) if spec.act == "silu" else gelu_tanh(g)


def _router_probs(p: Params, x: torch.Tensor, spec: MoESpec):
    """(top-k probabilities renormalised to sum 1, their expert ids, the
    full softmax) of x (…, d): the logits in f32 from a quantized router
    through ``quant_dense``, or from the dense router cast to x's dtype
    with f32 accumulation (no f32 copy of x); the softmax in f32."""
    w = p["router"]["w"]
    if isinstance(w, (QTensor, ShipWeight)):
        logits = quant_dense(x, w)
    else:
        logits = mm_f32(x, w.to(x.dtype))
    probs = torch.softmax(logits.to(torch.float32), dim=-1)
    top_p, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_i = top_p[..., :spec.top_k], top_i[..., :spec.top_k]
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    return top_p, top_i, probs


def _expert_ffn(p: Params, h: torch.Tensor, spec: MoESpec) -> torch.Tensor:
    """h (E, C, d) → (E, C, d): the gated MLP of every expert on its rows."""
    g = _qeinsum(h, p["gate"]).to(h.dtype)
    u = _qeinsum(h, p["up"]).to(h.dtype)
    return _qeinsum(_act(spec, g) * u, p["down"]).to(h.dtype)


def moe_dense(p: Params, x: torch.Tensor, spec: MoESpec) -> torch.Tensor:
    """All-experts path: y = Σ_e gate_e(x) · FFN_e(x), exact for every
    kept token. The E copies of the (B·S, d) input are views of one
    tensor."""
    b, s, d = x.shape
    e = spec.n_experts
    top_p, top_i, _ = _router_probs(p, x, spec)                   # (B, S, k)
    onehot = F.one_hot(top_i, e).to(torch.float32)                # (B, S, k, E)
    weights = (onehot * top_p[..., None]).sum(-2)                 # (B, S, E)
    h = x.reshape(1, b * s, d).expand(e, b * s, d)
    y = _expert_ffn(p, h, spec)                                   # (E, N, d)
    y = torch.einsum("end,ne->nd", y.to(torch.float32), weights.reshape(b * s, e))
    return y.reshape(b, s, d).to(x.dtype)


def moe_dispatch_local(p: Params, x: torch.Tensor, spec: MoESpec) -> torch.Tensor:
    """Single-group dispatch over all B·S tokens."""
    b, s, d = x.shape
    return moe_dispatch_grouped(p, x.reshape(1, b * s, d), spec).reshape(b, s, d)


def moe_dispatch_grouped(p: Params, xg: torch.Tensor, spec: MoESpec) -> torch.Tensor:
    """Capacity-bounded dispatch with an explicit group dim, xg (G, N, d):
    each group routes its own tokens into its own expert buffers of
    ``capacity = max(⌊N·k / E · capacity_factor⌋, 1)`` rows. Earlier
    tokens win capacity; over-capacity choices drop to the overflow row,
    whose output is zero (Switch / GShard semantics)."""
    g, n, d = xg.shape
    e, k = spec.n_experts, spec.top_k
    cap = max(int(n * k / e * spec.capacity_factor), 1)
    dev = xg.device
    top_p, top_i, _ = _router_probs(p, xg, spec)                  # (G, N, k)
    flat_e = top_i.reshape(g, n * k)                              # choice → expert
    flat_p = top_p.reshape(g, n * k).to(torch.float32)
    token_of = torch.arange(n, device=dev).repeat_interleave(k)   # (N·k,)
    # each choice's place in its expert's queue: the choices before it that
    # picked the same expert, a per-group prefix count scanned along the
    # contiguous choice axis of the (G, E, N·k) one-hot (PyTorch's
    # outer-dimension scan of the (G, N·k, E) layout took 181 of 428 device
    # ms of a 4096-token granite-moe prefill on an NVIDIA H100 80GB HBM3)
    onehot = F.one_hot(flat_e, e).to(torch.int32).transpose(1, 2).contiguous()
    count = torch.cumsum(onehot, dim=2, dtype=torch.int32)        # (G, E, N·k)
    my_pos = torch.gather(count, 1, flat_e[:, None, :])[:, 0] - 1
    keep = my_pos < cap
    slot = torch.where(keep, flat_e * cap + my_pos, torch.full_like(flat_e, e * cap))
    # scatter into per-group expert buffers; every kept (expert, position)
    # slot is unique, the overflow row e·cap absorbs the drops
    gi = torch.arange(g, device=dev)[:, None].expand(g, n * k)
    buf = torch.zeros((g, e * cap + 1, d), dtype=xg.dtype, device=dev)
    buf.index_put_((gi, slot), xg[:, token_of], accumulate=True)
    expert_in = buf[:, : e * cap].reshape(g, e, cap, d)
    up = _qeinsum(expert_in, p["up"]).to(xg.dtype)
    gate = _qeinsum(expert_in, p["gate"]).to(xg.dtype)
    out = _qeinsum(_act(spec, gate) * up, p["down"]).to(xg.dtype)
    out_flat = torch.cat([out.reshape(g, e * cap, d),
                          torch.zeros((g, 1, d), dtype=xg.dtype, device=dev)], dim=1)
    gathered = out_flat[gi, slot]                                 # (G, N·k, d)
    gathered = gathered * (flat_p * keep)[..., None].to(xg.dtype)
    # choices are (token-major, k-minor): the combine is a plain k-sum
    return gathered.reshape(g, n, k, d).sum(dim=2).to(xg.dtype)


def moe_block(p: Params, x: torch.Tensor, spec: MoESpec) -> torch.Tensor:
    """The MoE layer on x (B, S, d): the dense path for at most
    ``dense_path_max_tokens`` tokens, else the local dispatch."""
    b, s, _ = x.shape
    if b * s <= spec.dense_path_max_tokens:
        return moe_dense(p, x, spec)
    return moe_dispatch_local(p, x, spec)


def load_balance_loss(p: Params, x: torch.Tensor, spec: MoESpec) -> torch.Tensor:
    """Switch-style auxiliary load-balancing loss E · Σ_e f_e · P_e: f_e the
    share of tokens whose first choice is e, P_e the mean router
    probability of e."""
    _, top_i, probs = _router_probs(p, x, spec)
    e = spec.n_experts
    frac = F.one_hot(top_i[..., 0], e).to(torch.float32).reshape(-1, e).mean(0)
    imp = probs.reshape(-1, e).mean(0)
    return e * torch.sum(frac * imp)
