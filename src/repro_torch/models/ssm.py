"""Mamba2 (SSD — state-space duality, arXiv:2405.21060); port of
``repro.models.ssm``.

The SSD recurrence  h_t = dA_t·h_{t-1} + dt_t·B_t⊗x_t,  y_t = C_t·h_t + D·x_t
runs in the chunked dual form for a whole sequence (:func:`ssd_chunked`, the
registry's ``ssd_chunked`` op: the kernel ``ssd_chunk_scan`` on the card,
the einsum form on the CPU), and as the O(1) recurrence on a persistent
(conv, ssm) cache for decode (:func:`mamba2_decode_step`). The elementwise
ops follow the reference's order and dtypes: the prefill conv sums its K
bf16 products in bf16, softplus is ``logaddexp(x, 0)`` in f32, the skip
term is added in the activation dtype, the gated norm multiplies by
``silu(z)`` cast to that dtype.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from .layers import Params, dense, init_dense, init_rmsnorm, rmsnorm, stack_layers


@dataclasses.dataclass(frozen=True)
class SSMSpec:
    d_model: int
    d_state: int = 128
    head_dim: int = 64
    expand: int = 2
    conv_kernel: int = 4
    chunk: int = 256
    n_groups: int = 1
    dt_min: float = 0.001
    dt_max: float = 0.1

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def n_heads(self) -> int:
        return self.d_inner // self.head_dim

    @property
    def conv_dim(self) -> int:
        return self.d_inner + 2 * self.n_groups * self.d_state


def init_mamba2(gen, spec: SSMSpec, *, lead=(), dtype=torch.bfloat16,
                device="cpu", weight=stack_layers) -> Params:
    """The reference's distributions, drawn from ``gen``: dense projections
    N(0, 1)·d_in^-½ (out_proj d_inner^-½), conv taps N(0, 1)·K^-½, a_log =
    log(1..H), D = 1, and dt_bias the inverse softplus of dt log-uniform in
    [dt_min, dt_max]."""
    kw = dict(lead=lead, dtype=dtype, device=device)
    d_in_proj = 2 * spec.d_inner + 2 * spec.n_groups * spec.d_state + spec.n_heads
    f32 = dict(dtype=torch.float32, device=device)
    u = torch.rand((*lead, spec.n_heads), generator=gen, **f32)
    dt = torch.exp(u * (math.log(spec.dt_max) - math.log(spec.dt_min))
                   + math.log(spec.dt_min))
    conv_w = torch.randn((*lead, spec.conv_kernel, spec.conv_dim), generator=gen, **f32)
    return {
        "in_proj": init_dense(gen, spec.d_model, d_in_proj, weight=weight, **kw),
        "conv_w": (conv_w * spec.conv_kernel ** -0.5).to(dtype),
        "conv_b": torch.zeros((*lead, spec.conv_dim), dtype=dtype, device=device),
        "a_log": torch.log(torch.arange(1, spec.n_heads + 1, **f32)).expand(
            *lead, spec.n_heads).contiguous(),
        "d_skip": torch.ones((*lead, spec.n_heads), **f32),
        "dt_bias": dt + torch.log(-torch.expm1(-dt)),   # inverse softplus
        "norm": init_rmsnorm(spec.d_inner, **kw),
        "out_proj": init_dense(gen, spec.d_inner, spec.d_model,
                               scale=spec.d_inner ** -0.5, weight=weight, **kw),
    }


class MambaCache(NamedTuple):
    conv: torch.Tensor   # (B, K-1, conv_dim) last inputs of the causal conv
    ssm: torch.Tensor    # (B, H, P, N) f32 state


def init_mamba_cache(batch: int, spec: SSMSpec, dtype=torch.bfloat16,
                     device="cpu") -> MambaCache:
    return MambaCache(
        conv=torch.zeros((batch, spec.conv_kernel - 1, spec.conv_dim), dtype=dtype,
                         device=device),
        ssm=torch.zeros((batch, spec.n_heads, spec.head_dim, spec.d_state),
                        dtype=torch.float32, device=device))


def _split_proj(spec: SSMSpec, zxbcdt: torch.Tensor):
    di = spec.d_inner
    return (zxbcdt[..., :di], zxbcdt[..., di: di + spec.conv_dim],
            zxbcdt[..., di + spec.conv_dim:])


def _post_conv_split(spec: SSMSpec, xbc: torch.Tensor):
    di, gn = spec.d_inner, spec.n_groups * spec.d_state
    return xbc[..., :di], xbc[..., di: di + gn], xbc[..., di + gn:]


def _silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus`` = ``logaddexp(x, 0)``: max(x, 0) + log1p(e^-|x|)
    (``F.softplus`` switches to x above a threshold instead)."""
    return torch.clamp_min(x, 0) + torch.log1p(torch.exp(-x.abs()))


def _causal_conv(p: Params, xbc: torch.Tensor, spec: SSMSpec) -> torch.Tensor:
    """Depthwise causal conv over the sequence (K taps, products and sum in
    xbc's dtype), then SiLU in f32."""
    k, s = spec.conv_kernel, xbc.shape[1]
    pad = torch.nn.functional.pad(xbc, (0, 0, k - 1, 0))
    out = pad[:, 0:s, :] * p["conv_w"][0]
    for i in range(1, k):
        out = out + pad[:, i: i + s, :] * p["conv_w"][i]
    return _silu((out + p["conv_b"]).to(torch.float32)).to(xbc.dtype)


def ssd_chunked(xh, dt, a_log, b_mat, c_mat, spec: SSMSpec, init_state=None,
                backend=None):
    """Chunked SSD scan through the registry's ``ssd_chunked`` op.

    xh (B, S, H, P); dt (B, S, H) softplus'd step sizes; b/c (B, S, G, N)
    with G = 1 (the reference's scores sum over the groups, which only
    means one thing for a single group; every config has one). Returns
    y (B, S, H, P) and the final state (B, H, P, N) f32."""
    from repro_torch.kernels import registry

    bsz, s, g, n = b_mat.shape
    if g != 1:
        raise NotImplementedError(
            f"ssd_chunked takes n_groups 1, got {g} (every config of the "
            "reference has one group)")
    kb = registry.resolve(backend, xh.device)
    return kb.ssd_chunked(xh, dt, a_log, b_mat.reshape(bsz, s, n),
                          c_mat.reshape(bsz, s, n), chunk=spec.chunk,
                          init_state=init_state)


def mamba2_forward(p: Params, x: torch.Tensor, spec: SSMSpec, init_state=None,
                   return_state: bool = False, backend=None):
    """Full-sequence forward, x (B, S, d_model) → (B, S, d_model).

    ``return_state=True`` returns (out, MambaCache) — the prefill path: the
    conv cache is the last K−1 pre-conv rows, the SSM state the final chunk
    state, so decode continues exactly where the prefill stopped."""
    bsz, s, _ = x.shape
    z, xbc, dt_raw = _split_proj(spec, dense(p["in_proj"], x))
    # a copy: a view would keep the whole (B, S, ·) projection of every
    # layer alive until the prefill stacks the caches
    conv_tail = xbc[:, -(spec.conv_kernel - 1):, :].clone()
    xbc = _causal_conv(p, xbc, spec)
    xi, b_mat, c_mat = _post_conv_split(spec, xbc)
    h, pd, n, g = spec.n_heads, spec.head_dim, spec.d_state, spec.n_groups
    xh = xi.reshape(bsz, s, h, pd)
    dt = _softplus(dt_raw.to(torch.float32) + p["dt_bias"])
    y, state = ssd_chunked(xh, dt, p["a_log"], b_mat.reshape(bsz, s, g, n),
                           c_mat.reshape(bsz, s, g, n), spec, init_state, backend)
    y = y + (p["d_skip"][:, None] * xh.to(torch.float32)).to(y.dtype)
    y = y.reshape(bsz, s, spec.d_inner)
    y = rmsnorm(p["norm"], y) * _silu(z.to(torch.float32)).to(y.dtype)
    out = dense(p["out_proj"], y)
    if return_state:
        return out, MambaCache(conv=conv_tail, ssm=state)
    return out


def mamba2_decode_step(p: Params, x: torch.Tensor, cache: MambaCache, spec: SSMSpec):
    """Single-token recurrent step, x (B, 1, d_model) → (out, new cache). The
    cache passed in is only read: the new one is made of new tensors."""
    bsz = x.shape[0]
    z, xbc, dt_raw = _split_proj(spec, dense(p["in_proj"], x))
    # conv over the cached window and the new input, in f32
    wdt = torch.promote_types(cache.conv.dtype, xbc.dtype)
    win = torch.cat([cache.conv.to(wdt), xbc.to(wdt)], dim=1)    # (B, K, conv_dim)
    conv = (torch.einsum("bkc,kc->bc", win.to(torch.float32),
                         p["conv_w"].to(torch.float32)) + p["conv_b"].to(torch.float32))
    xbc_t = _silu(conv)[:, None, :].to(x.dtype)                   # (B, 1, conv_dim)
    xi, b_mat, c_mat = _post_conv_split(spec, xbc_t)
    h, pd, n, g = spec.n_heads, spec.head_dim, spec.d_state, spec.n_groups
    xh = xi.reshape(bsz, h, pd).to(torch.float32)
    dt = _softplus(dt_raw[:, 0].to(torch.float32) + p["dt_bias"])
    a = -torch.exp(p["a_log"])
    da = torch.exp(dt * a)                                        # (B, H)
    bv = b_mat.reshape(bsz, g * n).to(torch.float32)              # G = 1 → (B, N)
    cv = c_mat.reshape(bsz, g * n).to(torch.float32)
    new_state = (cache.ssm * da[:, :, None, None]
                 + torch.einsum("bhp,bn->bhpn", xh * dt[..., None], bv))
    y = torch.einsum("bhpn,bn->bhp", new_state, cv)
    y = y + p["d_skip"][None, :, None] * xh
    y = y.reshape(bsz, 1, spec.d_inner).to(x.dtype)
    y = rmsnorm(p["norm"], y) * _silu(z.to(torch.float32)).to(y.dtype)
    out = dense(p["out_proj"], y)
    return out, MambaCache(conv=win[:, 1:, :], ssm=new_state)
