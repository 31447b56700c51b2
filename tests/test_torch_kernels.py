"""Port parity — the two kernels of slice 1 and their plain versions.

* ``qmm_plain`` (the f32-dequant oracle) against the reference's Pallas
  ``qmm`` in interpret mode, through its padded entry point
  ``ops.quant_dense_apply``: rel ≤ 1e-5 (f32 accumulation order only);
  the port's ``ref`` ``quant_dense`` against the reference ``ref`` backend
  within bf16 epsilon; int8 and packed int4, ragged M, K and N.
* the port's ``paged_attention_ref`` against the reference's: max abs
  ≤ 1e-6 on active rows; the port's plain flash version against the Pallas
  ``paged_decode_attn`` in interpret mode: ≤ 2e-2 (f32 streaming softmax
  against the one-shot bf16 softmax, as tests/test_serve_engine.py pins);
  kv_bits ∈ {0, 8, 4}, Hkv ∈ {1, 2}, lengths across a page boundary.
The CUDA kernels are held against their plain versions in
``test_torch_kernels_gpu.py``.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from torch_bridge import np32

from repro import quant as jquant
from repro.kernels import ops as jops
from repro.kernels import paged_attn as jpa
from repro.kernels import ref as jref
from repro.kernels import registry as jreg
from repro.serve import pages as jpg
from repro_torch import quant as tquant
from repro_torch.kernels import ops as tops
from repro_torch.kernels import paged_attn as tpa
from repro_torch.kernels import qmm as tqmm
from repro_torch.kernels import ref as tref
from repro_torch.kernels import registry as treg

QMM_SHAPES = [(1, 40, 24), (5, 64, 48), (13, 96, 130), (4, 130, 256)]


def _weights(k, n, bits, packed, seed=0):
    rng = np.random.default_rng(seed)
    w = rng.normal(0, 0.05, (k, n)).astype(np.float32)
    kw = dict(scaling="channel", rounding="nearest", packed=packed)
    jq = jquant.encode(jnp.asarray(w), jquant.QScheme.int_symmetric(bits, **kw))
    tq = tquant.encode(torch.from_numpy(w), tquant.QScheme.int_symmetric(bits, **kw))
    return jq, tq


@pytest.mark.parametrize("m,k,n", QMM_SHAPES)
@pytest.mark.parametrize("bits,packed", [(8, False), (4, True)])
def test_qmm_plain_matches_pallas_interpret(m, k, n, bits, packed):
    jq, tq = _weights(k, n, bits, packed)
    x = np.random.default_rng(1).normal(0, 1, (m, k)).astype(np.float32)
    want = np.asarray(jops.quant_dense_apply(jnp.asarray(x), jq.codes, jq.scale,
                                             packed=packed))
    got = tqmm.qmm_plain(torch.from_numpy(x), tq.codes, tq.scale, packed=packed)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())
    oracle = tref.qmm_ref(torch.from_numpy(x), tquant.unpack_int4(tq.codes)
                          if packed else tq.codes, tq.scale)
    np.testing.assert_allclose(got.numpy(), oracle.numpy(), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("m,k,n", QMM_SHAPES)
@pytest.mark.parametrize("bits,packed", [(8, False), (4, True)])
@pytest.mark.parametrize("xdtype", ["f32", "bf16"])
def test_ref_quant_dense_matches_reference_ref(m, k, n, bits, packed, xdtype):
    jq, tq = _weights(k, n, bits, packed)
    x = np.random.default_rng(2).normal(0, 1, (m, k)).astype(np.float32)
    jx = jnp.asarray(x, jnp.bfloat16 if xdtype == "bf16" else jnp.float32)
    tx = torch.from_numpy(np32(jx))
    if xdtype == "bf16":
        tx = tx.to(torch.bfloat16)
    want = np.asarray(jax.jit(jreg.get("ref").quant_dense)(jx, jq))
    got = treg.get("ref").quant_dense(tx, tq).numpy()
    np.testing.assert_allclose(got, want, rtol=2.0 ** -8,
                               atol=2.0 ** -8 * np.abs(want).max())


def test_cuda_backend_on_cpu_uses_the_plain_version():
    jq, tq = _weights(64, 48, 8, False)
    x = torch.randn(3, 2, 64)
    got = treg.get("cuda").quant_dense(x, tq)
    want = tqmm.qmm_plain(x.reshape(6, 64), tq.codes, tq.scale).reshape(3, 2, 48)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert tqmm.launches == 0


def _pool(kv_bits, g, n_pages=12, page=8, d=16, seed=0):
    kv = np.random.default_rng(seed).normal(0, 1, (2, n_pages, page, g, d)).astype(np.float32)
    if kv_bits:
        sch = jpg.kv_scheme(kv_bits)
        qk = jquant.encode(jnp.asarray(kv[0]), sch)
        qv = jquant.encode(jnp.asarray(kv[1]), sch)
        jargs = (qk.codes, qv.codes, qk.scale, qv.scale)
        targs = tuple(torch.from_numpy(np.array(a)) for a in jargs)
    else:
        jargs = (jnp.asarray(kv[0], jnp.bfloat16), jnp.asarray(kv[1], jnp.bfloat16),
                 None, None)
        targs = (torch.from_numpy(np32(jargs[0])).to(torch.bfloat16),
                 torch.from_numpy(np32(jargs[1])).to(torch.bfloat16), None, None)
    return jargs, targs


def _case(seed=0, b=4, h=4, d=16, maxp=4, n_pages=12):
    rng = np.random.default_rng(seed)
    q = rng.normal(0, 1, (b, h, d)).astype(np.float32)
    lens = np.asarray([17, 3, 16, 0][:b], np.int32)   # 16 = a page boundary
    bt = rng.integers(1, n_pages, (b, maxp)).astype(np.int32)
    return q, lens, bt


@pytest.mark.parametrize("kv_bits", [0, 8, 4])
@pytest.mark.parametrize("g", [1, 2])
@pytest.mark.parametrize("qdtype", ["f32", "bf16"])
def test_paged_attention_ref_matches_reference(kv_bits, g, qdtype):
    jargs, targs = _pool(kv_bits, g)
    q, lens, bt = _case()
    jqv = jnp.asarray(q, jnp.bfloat16 if qdtype == "bf16" else jnp.float32)
    tq = torch.from_numpy(np32(jqv))
    if qdtype == "bf16":
        tq = tq.to(torch.bfloat16)
    want = np32(jref.paged_attention_ref(jqv, *jargs, jnp.asarray(bt), jnp.asarray(lens),
                                         softmax_scale=16 ** -0.5))
    got = np32(tref.paged_attention_ref(tq, *targs, torch.from_numpy(bt),
                                        torch.from_numpy(lens), softmax_scale=16 ** -0.5))
    active = lens > 0
    np.testing.assert_allclose(got[active], want[active], rtol=0, atol=1e-6)


@pytest.mark.parametrize("kv_bits", [0, 8, 4])
@pytest.mark.parametrize("g", [1, 2])
def test_plain_flash_matches_pallas_interpret(kv_bits, g):
    jargs, targs = _pool(kv_bits, g)
    q, lens, bt = _case(seed=1)
    jk_scale = jargs[2] if kv_bits else jnp.ones((1, 1, g, 1), jnp.float32)
    jv_scale = jargs[3] if kv_bits else jnp.ones((1, 1, g, 1), jnp.float32)
    want = np.asarray(jpa.paged_decode_attn(
        jnp.asarray(q), jargs[0], jargs[1], jk_scale, jv_scale, jnp.asarray(bt),
        jnp.asarray(lens), softmax_scale=16 ** -0.5, kv_bits=kv_bits))
    got = tpa.paged_decode_attn(torch.from_numpy(q), *targs, torch.from_numpy(bt),
                                torch.from_numpy(lens), softmax_scale=16 ** -0.5,
                                kv_bits=kv_bits)
    assert got.dtype == torch.float32
    assert tpa.launches == 0                     # CPU tensors: the plain version
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-2)
    np.testing.assert_array_equal(got.numpy()[lens == 0], 0.0)
    # and the port's ref backend, on the active rows
    ref = tref.paged_attention_ref(torch.from_numpy(q), *targs, torch.from_numpy(bt),
                                   torch.from_numpy(lens), softmax_scale=16 ** -0.5)
    np.testing.assert_allclose(got.numpy()[lens > 0], ref.numpy()[lens > 0],
                               rtol=0, atol=2e-2)


def test_ops_paged_attention_casts_to_q_dtype():
    _, targs = _pool(8, 1)
    q, lens, bt = _case()
    out = tops.paged_attention(torch.from_numpy(q).to(torch.bfloat16), *targs,
                               torch.from_numpy(bt), torch.from_numpy(lens),
                               softmax_scale=0.25)
    assert out.dtype == torch.bfloat16
    assert tops.kv_bits_of(targs[0]) == 8


def test_backend_selection_order(monkeypatch):
    monkeypatch.delenv(treg.ENV_VAR, raising=False)
    assert treg.get(device="cpu").name == "ref"
    assert treg.get(device="cuda").name == "cuda"
    monkeypatch.setenv(treg.ENV_VAR, "cuda")
    assert treg.get(device="cpu").name == "cuda"
    with treg.using("ref"):
        assert treg.get(device="cuda").name == "ref"
        assert treg.get("cuda", device="cpu").name == "cuda"
    with pytest.raises(ValueError, match="unknown kernel backend"):
        treg.select("pallas")
