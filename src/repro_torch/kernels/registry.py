"""Kernel-backend registry of the port — one switch for the hot paths.

Two backends:

* ``ref``  — plain PyTorch with the reference's ``ref`` numerics: weights
  decode to bf16, then an f32-accumulated product; paged attention gathers
  and dequantizes pages and runs a one-shot masked softmax; the
  double-sampling pair is two independent zipml draws from a split key
  (``ds_pair_jnp``), the LSQ gradient f32 matvecs on the decoded pair; the
  quantized AdamW update decodes, updates and re-encodes each moment with
  its own key; the SSD chunk scan is the einsum form of the reference's
  ``models/ssm.ssd_chunked``.
* ``cuda`` — the hand-written Hopper kernels (``csrc/qmm.cu``,
  ``csrc/qmm_t.cu``, ``csrc/qmm_qout.cu``, ``csrc/qmm_bitplane.cu``,
  ``csrc/paged_attn.cu``, ``csrc/ds_quant.cu``, ``csrc/qmv.cu``,
  ``csrc/quant_adamw.cu``, ``csrc/stoch_quant.cu``, ``csrc/ssd.cu``; level-table
  weights take the reference's decode fallback, as no kernel of the
  reference streams them). Given CUDA
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

    def quant_dense(self, x, qt, *, transpose: bool = False):
        """y = x · decode(qt) (or · decode(qt)ᵀ), f32 result (callers cast):
        decode to bf16, then an f32-accumulated product — the reference
        ``ref`` numerics as its jitted programs compute them. With an f32
        ``x`` the reference's XLA program keeps the bf16 product
        codes · bf16(scale) in f32 (excess precision: the bf16 rounding
        between the multiply and the f32 dot is dropped), so the port
        decodes the same way there. A bitplane weight's decode ends in a
        contraction over its planes, which XLA does not fuse into the dot:
        it stays bf16 for either ``x``, and so does a level-table weight,
        whose decode is a table lookup.

        A stacked (S, K, N) weight (the MoE expert axis) contracts with x
        (…, S, M, K), the stack dimension at x's −3 axis as the reference's
        ``matmul_eq`` has it: one decode of the whole stack, then one
        f32-accumulated batched product."""
        from repro_torch.quant import QTensor
        from repro_torch.quant.quant_dense import bmm_f32, mm_f32

        if qt.ndim not in (2, 3):
            raise NotImplementedError(
                f"quant_dense takes a 2-D weight or a stack (S, K, N), got {qt!r}; "
                "slice stacked layers with QTensor.index")
        if qt.ndim == 3 and x.ndim < 3:
            raise ValueError(f"x {tuple(x.shape)} needs >= 3 dims for the stacked {qt!r}")
        if x.dtype == torch.float32 and qt.scheme.layout == "dense" \
                and qt.scheme.grid != "levels":
            w = QTensor(qt.codes, qt.scale.to(torch.bfloat16), qt.scheme).decode()
        else:
            w = qt.decode(torch.bfloat16)
        if transpose:
            w = w.transpose(-1, -2)
        return mm_f32(x, w) if qt.ndim == 2 else bmm_f32(x, w)

    def quant_dense_out_q(self, x, qt, key, *, bits: int = 8, out_dtype=None):
        """``quant_dense`` with a quantize epilogue: the §2.2 double-sampled
        row-scaled int-grid pair of the output as one QTensor (codes,
        codes2, (…, 1) row scales) instead of the dense y. The base
        implementation is this backend's ``quant_dense`` → cast to the
        activation dtype → two independent draws from the split key
        (``ds_pair_plain``), the reference's unfused numerics."""
        from repro_torch.quant import QScheme
        from repro_torch.quant.qtensor import ds_pair_plain

        dtype = out_dtype or (x.dtype if x.is_floating_point() else torch.float32)
        y = self.quant_dense(x, qt).to(dtype)
        return ds_pair_plain(y, QScheme.int_symmetric(bits, scaling="row", rounding="ds"),
                             key)

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

    def quant_adamw_update(self, p_master, g, m_old, v_old, km, kv, *,
                           bits: int, b1: float, b2: float, eps: float,
                           b1c, b2c, lr, clip, finite, wd: float,
                           uclip: float = 0.0):
        """One quantized-moment AdamW leaf update in plain PyTorch: decode
        the int8 m/√v QTensors, EMA-update, write the f32 master,
        re-encode m and √v stochastically with the keys ``km`` and ``kv``
        (the reference ``ref`` numerics, three full-tensor passes). Returns
        (new_master, new_m: QTensor, new_v: QTensor)."""
        from repro_torch.optim.adamw import decode_moment, encode_moment

        g32 = g.to(torch.float32) * clip
        m_prev = decode_moment(m_old)
        v_prev = decode_moment(v_old, positive=True)
        m = b1 * m_prev + (1 - b1) * g32
        v = b2 * v_prev + (1 - b2) * g32 * g32
        update = (m / b1c) / (torch.sqrt(v / b2c) + eps)
        if uclip:
            update = torch.clamp(update, -uclip, uclip)
        new_master = p_master - lr * (update + wd * p_master)
        new_master = torch.where(finite, new_master, p_master)
        m_q = encode_moment(torch.where(finite, m, m_prev), bits, km)
        v_q = encode_moment(torch.where(finite, v, v_prev), bits, kv, positive=True)
        return new_master, m_q, v_q

    def ssd_chunked(self, xh, dt, a_log, b_mat, c_mat, *, chunk: int,
                    init_state=None):
        """Mamba2's chunked SSD scan, (y, final state): the einsum form
        (``ops.ssd_chunked_plain``), differentiable."""
        from . import ops

        return ops.ssd_chunked_plain(xh, dt, a_log, b_mat, c_mat, chunk, init_state)

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

    def quant_dense(self, x, qt, *, transpose: bool = False):
        """Stream the code plane through ``qmm`` (or ``qmm_t`` for x · Wᵀ,
        the code-domain backward and the tied unembed), bitplane words
        through ``qmm_bitplane``. A weight without a kernel plan
        (:meth:`_qd_plan`: a level table, wide codes, per-row scales) takes
        the reference's decode fallback — decode, then one matmul — as the
        reference's ``pallas`` backend does.

        A stacked (S, K, N) int8 or packed-int4 weight (the MoE expert
        axis) runs one ``qmm`` launch per slice on views of the stack, x's
        slice i at its −3 axis, as the reference's ``pallas`` backend
        does. The stacked weights that have no kernel — bitplane words
        (ROADMAP A1), level tables, or any weight without a plan, and
        ``transpose=True`` (ROADMAP A6) — take the decode path on CPU
        tensors and raise on the card."""
        if qt.ndim == 3:
            return self._quant_dense_stacked(x, qt, transpose)
        if qt.scheme.layout == "bitplane":
            return self._quant_dense_bitplane(x, qt, transpose)
        if qt.ndim != 2:
            raise NotImplementedError(
                f"cuda quant_dense takes a 2-D weight or a stack (S, K, N), got {qt!r}")
        plan = self._qd_plan(qt)
        if plan is None:
            return KernelBackend.quant_dense(self, x, qt, transpose=transpose)
        from . import ops

        codes, scale, packed = plan
        return ops.quant_dense_apply(x, codes, scale, packed=packed, transpose=transpose)

    def _quant_dense_stacked(self, x, qt, transpose: bool):
        """One ``qmm`` launch per slice of a stacked int weight; see
        :meth:`quant_dense` for what raises on the card."""
        plan = None if transpose else self._qd_plan(qt)
        if plan is None:
            if qt.codes.is_cuda:
                item = "A1" if qt.scheme.layout == "bitplane" else "A6"
                raise NotImplementedError(
                    f"cuda quant_dense of the stacked {qt!r} (transpose={transpose}): "
                    "stacked bitplane, level-table and transposed weights have no "
                    f"kernel yet (ROADMAP {item})")
            return KernelBackend.quant_dense(self, x, qt, transpose=transpose)
        if x.ndim < 3:
            raise ValueError(f"x {tuple(x.shape)} needs >= 3 dims for the stacked {qt!r}")
        from . import ops

        codes, scale, packed = plan
        xs = x.movedim(-3, 0)
        return torch.stack([ops.quant_dense_apply(xs[i], codes[i], scale[i], packed=packed)
                            for i in range(codes.shape[0])], dim=x.ndim - 3)

    @staticmethod
    def _qd_plan(qt):
        """Kernel-ready (codes, scale (*S, 1, N) f32, packed) of a 2-D or
        stacked (S, K, N) int or zipml weight, or None where the
        reference's ``pallas`` backend takes the decode fallback: level
        tables, codes of another dtype, scales that are neither scalar nor
        per column (``registry._qd_plan``). A stack's slice i is
        (codes[i], scale[i]): views."""
        sch = qt.scheme
        if sch.grid == "levels" or sch.layout == "bitplane" or qt.ndim not in (2, 3):
            return None
        packed = bool(sch.packed)
        if qt.codes.dtype != (torch.uint8 if packed else torch.int8):
            return None
        stack = tuple(qt.codes.shape[:-2])
        n = qt.codes.shape[-1] * (2 if packed else 1)
        scale = qt.scale.to(torch.float32)
        if tuple(scale.shape) in ((), (1,), (1, 1)):
            scale = scale.reshape((1,) * (len(stack) + 2)).expand(*stack, 1, n)
        elif tuple(scale.shape) in ((n,), (1, n)):
            scale = scale.reshape(1, n).expand(*stack, 1, n)
        elif tuple(scale.shape) != (*stack, 1, n):
            return None
        if sch.grid == "zipml":
            from repro_torch.quant.qtensor import div_exact

            scale = div_exact(scale, sch.s)
        return qt.codes, scale, packed

    def quant_dense_out_q(self, x, qt, key, *, bits: int = 8, out_dtype=None):
        """The fused epilogue (``qmm_qout``): both code planes of the
        output's §2.2 row-scaled pair come from one ``jax.random.bits(key,
        (M, N), uint32)``-exact plane, its high and low 16 bits — the
        reference ``pallas`` backend's draw, a different stream from
        ``ref``'s split-key pair. The weights the reference sends to its
        base path go there here too, and only those: no kernel plan, a
        stacked weight or ``bits > 8``."""
        plan = self._qd_plan(qt)
        if plan is None or qt.ndim != 2 or bits > 8:
            return KernelBackend.quant_dense_out_q(self, x, qt, key, bits=bits,
                                                   out_dtype=out_dtype)
        from repro_torch import prng
        from repro_torch.quant import QScheme, QTensor

        from . import ops

        codes, scale, packed = plan
        dtype = out_dtype or (x.dtype if x.is_floating_point() else torch.float32)
        lead = x.shape[:-1]
        n = codes.shape[-1] * (2 if packed else 1)
        x2 = x.reshape(-1, x.shape[-1])
        rand = prng.bits(key, (x2.shape[0], n), device=x.device, dtype=torch.int32)
        c1, c2, oscale = ops.quant_dense_out_q(x2, codes, scale, rand,
                                               qmax=2 ** (bits - 1) - 1,
                                               packed=packed, out_dtype=dtype)
        scheme = QScheme.int_symmetric(bits, scaling="row", rounding="ds")
        return QTensor(c1.reshape(*lead, n), oscale.reshape(*lead, 1), scheme,
                       codes2=c2.reshape(*lead, n))

    @staticmethod
    def _bitplane_scale(qt):
        """The (1, N) f32 scale of a 2-D bitplane weight, or None for per-row
        scales (they do not factor out of the product over K)."""
        n = qt.scheme.vec_dim
        scale = qt.scale.to(torch.float32)
        if scale.numel() == 1:
            return scale.reshape(1, 1).expand(1, n)
        if tuple(scale.shape) in ((n,), (1, n)):
            return scale.reshape(1, n)
        return None

    def _quant_dense_bitplane(self, x, qt, transpose: bool):
        """2-D bitplane weights with per-column or scalar scales run
        ``qmm_bitplane``. Transposed, stacked or per-row-scaled ones have no
        kernel: on CPU tensors they take the decode path (as the
        reference's ``pallas`` backend does); on the card they raise rather
        than hide the missing kernel — no serving layer reaches them."""
        scale = None if transpose or qt.codes.ndim != 3 else self._bitplane_scale(qt)
        if scale is None:
            if qt.codes.is_cuda:
                raise NotImplementedError(
                    f"cuda quant_dense of {qt!r} (transpose={transpose}): "
                    "transposed, stacked or per-row-scaled bitplane weights "
                    "have no kernel yet (ROADMAP A1)")
            return KernelBackend.quant_dense(self, x, qt, transpose=transpose)
        from . import ops

        return ops.quant_dense_bitplane(x, qt.codes, scale, qt.scheme.vec_dim)

    def ssd_chunked(self, xh, dt, a_log, b_mat, c_mat, *, chunk: int,
                    init_state=None):
        """The SSD kernel (``ssd_chunk_scan``); it has no backward, so inputs
        that require a gradient raise rather than fall back to the plain
        scan."""
        from . import ops

        return ops.ssd_chunked_kernel(xh, dt, a_log, b_mat, c_mat, chunk, init_state)

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

    def quant_adamw_update(self, p_master, g, m_old, v_old, km, kv, *,
                           bits: int, b1: float, b2: float, eps: float,
                           b1c, b2c, lr, clip, finite, wd: float,
                           uclip: float = 0.0):
        """The two-pass fused update (``qadamw_absmax`` + ``qadamw_update``)
        for 2-D+ leaves, flattened to (rows, last dim); the rounding bits
        are those of one ``jax.random.bits(km, shape)``-exact uint32 plane
        whose high and low 16 bits feed the m and √v draws (the reference's
        ``pallas`` backend draw; ``kv`` is unused there). On the card pass 2
        takes ``km`` and hashes those words in registers (the flat index of
        the (rows, last dim) view is the leaf's); on the CPU the plane is
        drawn. Vectors and scalars take the plain path, as in the
        reference."""
        if p_master.ndim < 2 or bits > 8 or km is None:
            return KernelBackend.quant_adamw_update(
                self, p_master, g, m_old, v_old, km, kv, bits=bits, b1=b1,
                b2=b2, eps=eps, b1c=b1c, b2c=b2c, lr=lr, clip=clip,
                finite=finite, wd=wd, uclip=uclip)
        from repro_torch import prng
        from repro_torch.optim.adamw import moment_scheme
        from repro_torch.quant import QTensor

        from . import ops

        shape = p_master.shape
        c = shape[-1]
        rand = None if p_master.is_cuda else prng.bits(
            km, shape, device=p_master.device, dtype=torch.int32).reshape(-1, c)
        nm, mc, msn, vc, vsn = ops.quant_adamw_update(
            p_master.reshape(-1, c), g.reshape(-1, c),
            m_old.codes.reshape(-1, c), m_old.scale,
            v_old.codes.reshape(-1, c), v_old.scale, rand,
            key=km if rand is None else None,
            qmax=2 ** (bits - 1) - 1, b1=b1, b2=b2, eps=eps, wd=wd,
            uclip=uclip, lr=lr, b1c=b1c, b2c=b2c, clip=clip,
            finite=finite.to(torch.float32))
        scheme = moment_scheme(bits, len(shape))
        return (nm.reshape(shape), QTensor(mc.reshape(shape), msn, scheme),
                QTensor(vc.reshape(shape), vsn, scheme))


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
