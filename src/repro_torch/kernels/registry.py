"""Kernel-backend registry of the port — one switch for the hot paths.

Two backends:

* ``ref``  — plain PyTorch with the reference's ``ref`` numerics: weights
  decode to bf16, then an f32-accumulated product; paged attention gathers
  and dequantizes pages and runs a one-shot masked softmax; the
  double-sampling pair is two independent zipml draws from a split key
  (``ds_pair_jnp``), the LSQ gradient f32 matvecs on the decoded pair.
* ``cuda`` — the hand-written Hopper kernels (``csrc/qmm.cu``,
  ``csrc/paged_attn.cu``, ``csrc/ds_quant.cu``, ``csrc/qmv.cu``). Given CUDA
  tensors it launches them or raises — it never hands work to a plain
  version; given CPU tensors each kernel wrapper computes its plain version
  (that is how the CPU tests reach it). Its double-sampling pair shares one
  base level and draws both up-bits from one ``bits`` plane, as the
  reference's ``pallas`` backend does — a different random stream from
  ``ref``'s, so the two agree in distribution, not draw for draw.

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

    def ds_pair(self, x, scheme, key, scale=None):
        """Draw the §2.2 double-sampling pair → QTensor with ``codes2``."""
        from repro_torch.quant.qtensor import ds_pair_plain

        return ds_pair_plain(x, scheme, key, scale=scale)

    def qt_dot(self, qt, v):
        """decode(qt) @ v; backends may stream codes instead."""
        return qt.decode() @ v

    # the tuple-form hot loop of the linear-model path: the two decoded
    # draws, the storage form (codes1, codes2, scale), and the symmetrized
    # estimator ½[Q₁ᵀ(Q₂x−b) + Q₂ᵀ(Q₁x−b)]/B
    def ds_quant_values(self, a, s, key, scale=None):
        raise NotImplementedError

    def ds_quant_codes(self, a, s, key, scale=None):
        raise NotImplementedError

    def lsq_ds_gradient(self, x, a, b, s, key, scale=None):
        raise NotImplementedError


class _RefBackend(KernelBackend):
    """Two independent zipml draws from a split key — the reference ``ref``
    numerics."""

    name = "ref"

    def _zipml_pair(self, a, s, key, scale=None):
        from repro_torch.quant import QScheme
        from repro_torch.quant.qtensor import ds_pair_plain

        return ds_pair_plain(a, QScheme.zipml(s), key, scale=scale)

    def ds_quant_values(self, a, s, key, scale=None):
        qt = self._zipml_pair(a, s, key, scale=scale)
        return qt.decode(), qt.decode2()

    def ds_quant_codes(self, a, s, key, scale=None):
        qt = self._zipml_pair(a, s, key, scale=scale)
        return qt.codes, qt.codes2, qt.scale

    def lsq_ds_gradient(self, x, a, b, s, key, scale=None):
        q1, q2 = self.ds_quant_values(a, s, key, scale=scale)
        B = a.shape[0]
        r2 = q2 @ x - b
        r1 = q1 @ x - b
        return (q1.T @ r2 + q2.T @ r1) / (2.0 * B)


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

    # ------------------------------------------ double sampling (B1, B3) --
    def _resolve_scale(self, a, scale):
        """``scale=None`` → the global-scalar absmax the ``ref`` backend
        uses, so both backends quantize against the same grid; column
        scales (the data-pipeline convention) pass through."""
        if scale is None:
            from repro_torch.core.quantize import row_scale

            return row_scale(a)
        return scale

    def ds_quant_values(self, a, s, key, scale=None):
        c1, c2, sc = self.ds_quant_codes(a, s, key, scale=scale)
        return (c1.to(torch.float32) / s * sc, c2.to(torch.float32) / s * sc)

    def ds_quant_codes(self, a, s, key, scale=None):
        from . import ops

        return ops.ds_quantize(a, s, key, scale=self._resolve_scale(a, scale))

    def lsq_ds_gradient(self, x, a, b, s, key, scale=None):
        from . import ops

        c1, c2, sc = self.ds_quant_codes(a, s, key, scale=scale)
        return ops.ds_gradient_from_codes(c1, c2, x, b, sc, s)

    def ds_pair(self, x, scheme, key, scale=None):
        """The fused single-read pair for the signed 2-D zipml grid with
        s ≤ 127; anything else takes the plain two-draw pair."""
        if scheme.grid != "zipml" or x.ndim != 2 or not scheme.signed \
                or scheme.s > 127:
            return KernelBackend.ds_pair(self, x, scheme, key, scale=scale)
        from repro_torch.quant.qtensor import QTensor, compute_scale

        from . import ops

        if scale is None:
            scale = compute_scale(x, scheme)
        scale = torch.as_tensor(scale, dtype=torch.float32, device=x.device)
        c1, c2, _ = ops.ds_quantize(x, scheme.s, key, scale=scale)
        # the caller's scale, not the broadcast copy: ref and cuda QTensors
        # keep the same structure
        return QTensor(c1, scale, scheme.with_rounding("ds"), codes2=c2)

    def qt_dot(self, qt, v):
        """Stream int8 codes through ``qmv`` when the scale factors out of the
        product (scalar / per-row / per-column families)."""
        codes, scale = qt.codes, qt.scale
        if (codes.ndim != 2 or v.ndim != 1 or codes.dtype != torch.int8
                or qt.scheme.grid == "levels"):
            return KernelBackend.qt_dot(self, qt, v)
        from . import ops

        denom = float(qt.scheme.s) if qt.scheme.grid == "zipml" else 1.0
        r, c = codes.shape
        shp = tuple(scale.shape)
        v32 = v.to(torch.float32)
        if shp in ((), (1,), (1, 1)):
            return ops.int8_matvec(codes, v32) * (scale.reshape(()) / denom)
        if shp == (r, 1):
            return scale.reshape(-1) * ops.int8_matvec(codes, v32) / denom
        if shp in ((c,), (1, c)):
            return ops.int8_matvec(codes, scale.reshape(-1) * v32) / denom
        return KernelBackend.qt_dot(self, qt, v)


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
