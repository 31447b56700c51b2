"""Port parity — quantized embedding tables and the transposed product
(``quantize_param_tree(include_embedding=True)``, ``layers.embed`` /
``unembed``, ``quant_dense(..., transpose=True)``) against the reference.

* (f) ``quantize_param_tree(include_embedding=True)`` on the reduced
  gemma-2b: codes and scales byte-identical for int8, packed int4,
  bitplane and optimal levels (whose table keeps the int scheme).
* (g) ``embed`` of int8 and packed-int4 tables: the gathered rows equal
  the reference's bit for bit (both decode the gathered codes to bf16);
  ``unembed``: the ``ref`` backend against the reference's jitted ``ref``
  within rel 1e-5 of the largest logit (bf16 operands, products exact in
  f32: summation order only), the ``cuda`` backend's plain ``qmm_t`` against
  the reference's Pallas ``qmm_t`` in interpret mode within the same.
* (h) the reduced gemma-2b with quantized tables: ``forward`` and
  ``loss_fn`` against the reference's jitted ones at f32 (≤ 1e-4, the
  model tests' f32 tolerance), and the greedy tokens of 8 served requests
  equal to the reference engine's (monolithic admission on both sides,
  ROADMAP C2).
* (i) ROADMAP C16: the reference's ``embed`` of a bitplane table gathers
  along the plane axis and returns the wrong shape; the port raises a
  ``ValueError`` that names C16.
* (j) ``quant_dense(x, w, transpose=True)`` on a QTensor, a ShipWeight (with
  its straight-through gradients) and a dense weight against the reference
  (rel 1e-5 of the largest output).
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from torch_bridge import bridge, np32, serve_both

from repro import configs as jconfigs
from repro import quant as jquant
from repro.models import layers as jlayers
from repro.models import transformer as JT
from repro.precision import qat as jqat
from repro.quant import PrecisionPlan as JPlan
from repro_torch import configs as tconfigs
from repro_torch import quant as tquant
from repro_torch.models import layers as tlayers
from repro_torch.models import transformer as TT
from repro_torch.precision import qat as tqat
from repro_torch.quant import PrecisionPlan as TPlan

KEY = jax.random.PRNGKey(0)
LAYOUTS = [dict(bits=8), dict(bits=4), dict(bits=8, layout="bitplane"),
           dict(bits=4, optimal=True)]


def _reduced(dtype=jnp.float32, seed=0):
    jcfg = dataclasses.replace(jconfigs.get_reduced("gemma-2b"), dtype=dtype)
    return jcfg, JT.init_params(jax.random.PRNGKey(seed), jcfg)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], (*path, k))
    else:
        yield path, tree


@pytest.mark.parametrize("kw", LAYOUTS, ids=["int8", "int4", "bitplane8", "optimal4"])
def test_quantize_param_tree_tables_byte_identical(kw):
    _, jp = _reduced()
    jq = jqat.quantize_param_tree(jp, include_embedding=True, **kw)
    tq = tqat.quantize_param_tree(bridge(jp), include_embedding=True, **kw)
    want = dict(_leaves(bridge(jq)))
    got = dict(_leaves(tq))
    assert sorted(got) == sorted(want)
    table = got[("embed", "table")]
    assert isinstance(table, tquant.QTensor)
    assert table.scheme.grid == "int"
    assert table.scheme == want[("embed", "table")].scheme
    for path, w in want.items():
        g = got[path]
        assert type(g) is type(w), path
        if isinstance(w, tquant.QTensor):
            assert g.scheme == w.scheme, path
            assert g.codes.dtype == w.codes.dtype, path
            assert torch.equal(g.codes, w.codes), path
            assert torch.equal(g.scale, w.scale), path
            assert (g.levels is None) == (w.levels is None), path
            if w.levels is not None:
                assert torch.equal(g.levels, w.levels), path
        else:
            assert torch.equal(g, w), path


@pytest.mark.parametrize("bits", [8, 4])
def test_embed_rows_equal_reference(bits):
    _, jp = _reduced(jnp.bfloat16)
    jq = jqat.quantize_param_tree(jp, bits=bits, include_embedding=True)
    tq = bridge(jq)
    ids = np.random.default_rng(bits).integers(0, 512, (3, 7)).astype(np.int32)
    want = jlayers.embed(jq["embed"], jnp.asarray(ids))
    got = tlayers.embed(tq["embed"], torch.from_numpy(ids))
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(np32(got), np32(want))
    # only the gathered rows are decoded
    full = tq["embed"]["table"].decode(torch.bfloat16)
    assert torch.equal(got, full[torch.from_numpy(ids).long()])


def test_embed_decodes_whole_table_when_scales_are_per_row():
    t = torch.randn(16, 8)
    qt = tquant.encode(t, tquant.QScheme.int_symmetric(8, scaling="row",
                                                       rounding="nearest"))
    ids = torch.tensor([[3, 0, 15]])
    got = tlayers.embed({"table": qt}, ids)
    assert torch.equal(got, qt.decode(torch.bfloat16)[ids])


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("backend", ["ref", "cuda"])
def test_unembed_matches_reference(bits, backend):
    _, jp = _reduced(jnp.bfloat16)
    jq = jqat.quantize_param_tree(jp, bits=bits, include_embedding=True)
    tq = bridge(jq)
    x = np.random.default_rng(5).normal(0, 1, (2, 5, 64)).astype(np.float32)
    jx = jnp.asarray(x, jnp.bfloat16)
    jbe = "ref" if backend == "ref" else "pallas"
    want = np.asarray(jax.jit(lambda h: jquant.quant_dense(
        h, jq["embed"]["table"], transpose=True, backend=jbe))(jx))
    from repro_torch.kernels import registry as treg
    with treg.using(backend):
        got = tlayers.unembed(tq["embed"], torch.from_numpy(np32(jx)).to(torch.bfloat16))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape == (2, 5, 512)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_forward_and_loss_with_quantized_tables_match_reference():
    jplan = JPlan(model_bits=8, model_storage="int")
    jcfg = dataclasses.replace(jconfigs.get_reduced("gemma-2b"), dtype=jnp.float32,
                               precision=jplan)
    tcfg = tconfigs.get_reduced("gemma-2b", dtype=torch.float32,
                                precision=TPlan(model_bits=8, model_storage="int"))
    jp = jqat.quantize_param_tree(JT.init_params(jax.random.PRNGKey(2), jcfg), bits=8,
                                  include_embedding=True)
    tp = bridge(jp)
    rng = np.random.default_rng(3)
    toks = rng.integers(0, jcfg.vocab_size, (2, 16)).astype(np.int32)
    tgts = rng.integers(0, jcfg.vocab_size, (2, 16)).astype(np.int32)
    jh = jax.jit(lambda p, t: JT.forward(p, t, jcfg))(jp, jnp.asarray(toks))
    jl = jax.jit(lambda p, t, y: JT.loss_fn(p, t, y, jcfg))(jp, jnp.asarray(toks),
                                                            jnp.asarray(tgts))
    th = TT.forward(tp, torch.from_numpy(toks), tcfg)
    tl = TT.loss_fn(tp, torch.from_numpy(toks), torch.from_numpy(tgts), tcfg)
    np.testing.assert_allclose(np32(th), np32(jh), rtol=0, atol=1e-4)
    jl = float(jl[0] if isinstance(jl, tuple) else jl)
    np.testing.assert_allclose(float(tl), jl, rtol=1e-4)


@pytest.mark.parametrize("bits", [8, 4])
def test_served_tokens_with_quantized_tables_match_reference(bits):
    jeng, teng, jres, tres = serve_both("f32", bits, bits, include_embedding=True)
    assert isinstance(teng.params["embed"]["table"], tquant.QTensor)
    assert sorted(tres) == sorted(jres) == list(range(8))
    for rid, want in jres.items():
        np.testing.assert_array_equal(tres[rid].tokens, want.tokens)
    assert teng.weight_nbytes() == jquant.tree_nbytes(jeng.params)


def test_bitplane_table_embed_c16():
    t = jax.random.normal(KEY, (512, 64))
    jq = jqat.quantize_param_tree({"embed": {"table": t}}, include_embedding=True,
                                  layout="bitplane")
    ids = jnp.array([1, 2, 3])
    # the reference's defect: the gather runs over the plane axis
    assert jlayers.embed(jq["embed"], ids).shape == (512, 64)
    tq = bridge(jq)
    with pytest.raises(ValueError, match="C16"):
        tlayers.embed(tq["embed"], torch.tensor([1, 2, 3]))


# ------------------------------------------------------- quant_dense(transpose)
def _weight(k, n, bits):
    w = np.random.default_rng(k + n).normal(0, 0.1, (k, n)).astype(np.float32)
    scheme = dict(scaling="channel", rounding="nearest", packed=bits == 4)
    jq = jquant.encode(jnp.asarray(w), jquant.QScheme.int_symmetric(bits, **scheme))
    return w, jq, bridge({"w": jq})["w"]


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("backend", ["ref", "cuda"])
def test_quant_dense_transpose_qtensor(bits, backend):
    _, jq, tq = _weight(48, 40, bits)
    x = np.random.default_rng(1).normal(0, 1, (3, 4, 40)).astype(np.float32)
    jx = jnp.asarray(x, jnp.bfloat16)
    jbe = "ref" if backend == "ref" else "pallas"
    want = np.asarray(jax.jit(lambda h: jquant.quant_dense(h, jq, transpose=True,
                                                           backend=jbe))(jx))
    got = tquant.quant_dense(torch.from_numpy(np32(jx)).to(torch.bfloat16), tq,
                             transpose=True, backend=backend)
    assert tuple(got.shape) == want.shape == (3, 4, 48)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_quant_dense_transpose_dense_weight():
    w, _, _ = _weight(48, 40, 8)
    x = np.random.default_rng(2).normal(0, 1, (5, 40)).astype(np.float32)
    want = np.asarray(jquant.quant_dense(jnp.asarray(x), jnp.asarray(w), transpose=True))
    got = tquant.quant_dense(torch.from_numpy(x), torch.from_numpy(w), transpose=True)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("transpose", [False, True])
def test_quant_dense_shipweight_grads_match_reference(transpose):
    w, jq, tq = _weight(48, 40, 8)
    rng = np.random.default_rng(4)
    x = rng.normal(0, 1, (6, 40 if transpose else 48)).astype(np.float32)
    c = rng.normal(0, 1, (6, 48 if transpose else 40)).astype(np.float32)

    def jloss(x_, m_):
        sw = jquant.ShipWeight(m_, jq)
        return jnp.sum(jquant.quant_dense(x_, sw, transpose=transpose, backend="ref") * c)

    jy = jax.jit(lambda x_, m_: jquant.quant_dense(
        x_, jquant.ShipWeight(m_, jq), transpose=transpose, backend="ref"))(
            jnp.asarray(x), jnp.asarray(w))
    jgx, jgw = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jnp.asarray(x), jnp.asarray(w))
    tx = torch.from_numpy(x).requires_grad_()
    tm = torch.from_numpy(w).requires_grad_()
    ty = tquant.quant_dense(tx, tquant.ShipWeight(tm, tq), transpose=transpose,
                            backend="ref")
    (ty * torch.from_numpy(c)).sum().backward()
    for got, want in ((ty.detach(), jy), (tx.grad, jgx), (tm.grad, jgw)):
        want = np.asarray(want)
        assert tuple(got.shape) == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())
