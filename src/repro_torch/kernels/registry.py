"""Kernel-backend registry of the port — one switch for the hot paths.

Two backends:

* ``ref``  — plain PyTorch with the reference's ``ref`` numerics: weights
  decode to bf16, then an f32-accumulated product; paged attention gathers
  and dequantizes pages and runs a one-shot masked softmax.
* ``cuda`` — the hand-written Hopper kernels (``csrc/qmm.cu``,
  ``csrc/paged_attn.cu``). Given CUDA tensors it launches them or raises —
  it never hands work to a plain version; given CPU tensors each kernel
  wrapper computes its plain version (that is how the CPU tests reach it).

Selection precedence: explicit ``backend=`` argument > :func:`select` >
``ZIPML_TORCH_KERNEL_BACKEND`` (a separate name from the JAX package's
``ZIPML_KERNEL_BACKEND``, since the parity tests load both packages) > the
hardware default: ``cuda`` for tensors on the card, ``ref`` on the CPU.
"""
from __future__ import annotations

import contextlib
import os

import torch

_BACKENDS: dict[str, "KernelBackend"] = {}
_ACTIVE: str | None = None

ENV_VAR = "ZIPML_TORCH_KERNEL_BACKEND"


class KernelBackend:
    """The op surface of a backend; the base class is the ``ref`` math."""

    name = "abstract"

    def quant_dense(self, x, qt):
        """y = x · decode(qt), f32 result (callers cast): decode to bf16,
        then an f32-accumulated product — the reference ``ref`` numerics as
        its jitted engine computes them. With an f32 ``x`` the reference's
        XLA program keeps the bf16 product codes · bf16(scale) in f32
        (excess precision: the bf16 rounding between the multiply and the
        f32 dot is dropped), so the port decodes the same way there."""
        from repro_torch.quant import QTensor
        from repro_torch.quant.quant_dense import mm_f32

        if qt.ndim != 2:
            raise NotImplementedError(
                "quant_dense takes 2-D weights; slice stacked layers with "
                "QTensor.index (stacked experts: ROADMAP A5)")
        if x.dtype == torch.float32:
            w = QTensor(qt.codes, qt.scale.to(torch.bfloat16), qt.scheme).decode()
        else:
            w = qt.decode(torch.bfloat16)
        return mm_f32(x, w)

    def paged_attention(self, q, k_pages, v_pages, k_scale, v_scale,
                        block_table, seq_lens, *, softmax_scale):
        from . import ref

        return ref.paged_attention_ref(
            q, k_pages, v_pages, k_scale, v_scale, block_table, seq_lens,
            softmax_scale=softmax_scale)


class _RefBackend(KernelBackend):
    name = "ref"


class _CudaBackend(KernelBackend):
    """Streams codes through the hand-written kernels."""

    name = "cuda"

    def quant_dense(self, x, qt):
        sch = qt.scheme
        if sch.grid != "int" or sch.layout != "dense" or qt.ndim != 2:
            raise NotImplementedError(
                f"cuda quant_dense takes 2-D dense int-grid weights, got {qt!r} "
                "(other storages: ROADMAP B5, B11)")
        packed = bool(sch.packed)
        if qt.codes.dtype != (torch.uint8 if packed else torch.int8):
            raise NotImplementedError(f"cuda quant_dense: codes of {qt.codes.dtype}")
        n = qt.codes.shape[-1] * (2 if packed else 1)
        scale = qt.scale.to(torch.float32)
        if scale.numel() == 1:
            scale = scale.reshape(1, 1).expand(1, n)
        elif scale.numel() != n:
            raise NotImplementedError(
                f"cuda quant_dense needs per-column scales, got {tuple(scale.shape)}")
        from . import ops

        return ops.quant_dense_apply(x, qt.codes, scale.reshape(1, n), packed=packed)

    def paged_attention(self, q, k_pages, v_pages, k_scale, v_scale,
                        block_table, seq_lens, *, softmax_scale):
        from . import ops

        return ops.paged_attention(q, k_pages, v_pages, k_scale, v_scale,
                                   block_table, seq_lens,
                                   softmax_scale=softmax_scale)


def register(backend: KernelBackend) -> KernelBackend:
    _BACKENDS[backend.name] = backend
    return backend


def available() -> list[str]:
    return sorted(_BACKENDS)


def default_name(device=None) -> str:
    """``cuda`` for tensors on the card, ``ref`` on the CPU."""
    return "cuda" if device is not None and torch.device(device).type == "cuda" \
        else "ref"


def select(name: str | None) -> None:
    """Set the process-wide backend (None resets to env/hardware default)."""
    global _ACTIVE
    if name is not None and name not in _BACKENDS:
        raise ValueError(f"unknown kernel backend {name!r}; have {available()}")
    _ACTIVE = name


@contextlib.contextmanager
def using(name: str | None):
    """Temporarily select a backend (``None`` leaves the selection as is)."""
    global _ACTIVE
    prev = _ACTIVE
    if name is not None:
        select(name)
    try:
        yield
    finally:
        _ACTIVE = prev


def get(name: str | None = None, device=None) -> KernelBackend:
    name = name or _ACTIVE or os.environ.get(ENV_VAR) or default_name(device)
    if name not in _BACKENDS:
        raise ValueError(f"unknown kernel backend {name!r}; have {available()}")
    return _BACKENDS[name]


def resolve(backend, device=None) -> KernelBackend:
    """Accept a name, an instance, or None (→ selection/env/hardware)."""
    if isinstance(backend, KernelBackend):
        return backend
    return get(backend, device)


register(_RefBackend())
register(_CudaBackend())
