"""Port parity — quantization storage (repro_torch.quant vs repro.quant).

The int-grid encode (codes and scales), decode, and the int4 nibble layout
must be byte-identical to the reference, for weights (channel scaling over
axis −2, stacked (L, 1, N) scales) and KV rows (row scaling), and
``quantize_param_tree`` must produce the reference's codes on the reduced
gemma-2b tree.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from torch_bridge import bridge, np32

from repro import configs as jconfigs
from repro import quant as jquant
from repro.models import transformer as JT
from repro.precision import qat as jqat
from repro_torch import quant as tquant
from repro_torch.precision import qat as tqat

SHAPES = [(24, 40), (3, 16, 32), (5, 7, 2, 16)]


def _x(shape, dtype, seed=0):
    x = np.random.default_rng(seed).normal(0, 0.7, shape).astype(np.float32)
    x[..., 0] = 0.0                                  # an all-zero row/col too
    x.flat[1] = 3.5                                  # exact .5 ties after scaling
    jx = jnp.asarray(x, dtype)
    tx = torch.from_numpy(np.asarray(jx.astype(jnp.float32)))
    return jx, tx.to(torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32)


def _schemes(bits, scaling, packed):
    kw = dict(scaling=scaling, rounding="nearest", packed=packed)
    return (jquant.QScheme.int_symmetric(bits, **kw),
            tquant.QScheme.int_symmetric(bits, **kw))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("bits,packed", [(8, False), (4, False), (4, True)])
@pytest.mark.parametrize("scaling", ["channel", "row"])
def test_encode_decode_byte_identical(shape, dtype, bits, packed, scaling):
    jx, tx = _x(shape, dtype)
    js, ts = _schemes(bits, scaling, packed)
    jq = jquant.encode(jx, js)
    tq = tquant.encode(tx, ts)
    assert tq.codes.dtype == (torch.uint8 if packed else torch.int8)
    np.testing.assert_array_equal(tq.codes.numpy(), np.asarray(jq.codes))
    np.testing.assert_array_equal(tq.scale.numpy(), np.asarray(jq.scale))
    assert tq.nbytes == jq.nbytes
    np.testing.assert_array_equal(np32(tq.decode()), np32(jq.decode()))
    np.testing.assert_array_equal(np32(tq.decode(torch.bfloat16)),
                                  np32(jq.decode(jnp.bfloat16)))


@pytest.mark.parametrize("shape", [(6, 8), (2, 3, 16)])
def test_pack_unpack_int4_identical(shape):
    codes = np.random.default_rng(1).integers(-7, 8, shape).astype(np.int8)
    jp = np.asarray(jquant.pack_int4(jnp.asarray(codes)))
    tp = tquant.pack_int4(torch.from_numpy(codes))
    np.testing.assert_array_equal(tp.numpy(), jp)
    np.testing.assert_array_equal(tquant.unpack_int4(tp).numpy(),
                                  np.asarray(jquant.unpack_int4(jnp.asarray(jp))))
    np.testing.assert_array_equal(tquant.unpack_int4(tp).numpy(), codes)


def test_pack_int4_rejects_odd_dim():
    with pytest.raises(ValueError):
        tquant.pack_int4(torch.zeros((2, 3), dtype=torch.int8))


def test_compute_scale_zero_group_is_one():
    s = tquant.compute_scale(torch.zeros((4, 3)),
                             tquant.QScheme.int_symmetric(8, scaling="row"))
    np.testing.assert_array_equal(s.numpy(), np.ones((4, 1), np.float32))


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("dtype", [jnp.bfloat16, jnp.float32])
def test_quantize_param_tree_identical(bits, dtype):
    cfg = dataclasses.replace(jconfigs.get_reduced("gemma-2b"), dtype=dtype)
    jp = JT.init_params(jax.random.PRNGKey(3), cfg)
    jq = jqat.quantize_param_tree(jp, bits=bits)
    tq = tqat.quantize_param_tree(bridge(jp), bits=bits)
    assert tquant.tree_nbytes(tq) == jquant.tree_nbytes(jq)
    for name in ("q", "k", "v", "o"):
        j, t = jq["layers"]["attn"][name]["w"], tq["layers"]["attn"][name]["w"]
        assert t.scheme == tquant.QScheme(**dataclasses.asdict(j.scheme))
        assert tuple(t.scale.shape) == (cfg.n_layers, 1, t.scale.shape[-1])
        np.testing.assert_array_equal(t.codes.numpy(), np.asarray(j.codes))
        np.testing.assert_array_equal(t.scale.numpy(), np.asarray(j.scale))
    for name in ("up", "gate", "down"):
        j, t = jq["layers"]["mlp"][name]["w"], tq["layers"]["mlp"][name]["w"]
        np.testing.assert_array_equal(t.codes.numpy(), np.asarray(j.codes))
        np.testing.assert_array_equal(t.scale.numpy(), np.asarray(j.scale))
    # embeddings and norms stay unquantized
    np.testing.assert_array_equal(np32(tq["embed"]["table"]), np32(jq["embed"]["table"]))


def test_layer_index_is_a_view():
    w = torch.randn(3, 8, 6)
    qt = tquant.encode(w, tquant.QScheme.int_symmetric(8, scaling="channel",
                                                       rounding="nearest"))
    one = qt.index(1)
    assert one.codes.data_ptr() == qt.codes[1].data_ptr()
    assert tuple(one.scale.shape) == (1, 6)


def test_unported_paths_name_the_roadmap():
    """Quantized embedding tables are ported (ROADMAP A5, ``include_embedding``
    quantizes only ``table`` leaves), and so are stacked (S, K, N) expert
    weights (ROADMAP A6(a)): x (S, M, K) contracts slice by slice, on both
    backends, as the 2-D product of each slice. A weight with two stack
    dimensions still raises (stacked bitplane weights on the card raise
    naming ROADMAP A1: ``test_torch_kernels_gpu.py``)."""
    x = torch.randn(4, 4)
    out = tqat.quantize_param_tree({"w": x}, bits=8, include_embedding=True)
    assert isinstance(out["w"], tquant.QTensor)
    stacked = tquant.encode(torch.randn(2, 4, 4), tquant.QScheme.int_symmetric(
        8, scaling="channel", rounding="nearest"))
    xs = torch.randn(2, 3, 4)
    for be in ("ref", "cuda"):
        got = tquant.quant_dense(xs, stacked, backend=be)
        want = torch.stack([tquant.quant_dense(xs[i], stacked.index(i), backend=be)
                            for i in range(2)])
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6, atol=1e-6)
    twice = tquant.encode(torch.randn(2, 2, 4, 4), tquant.QScheme.int_symmetric(
        8, scaling="channel", rounding="nearest"))
    for be in ("ref", "cuda"):
        with pytest.raises(NotImplementedError, match="stack"):
            tquant.quant_dense(torch.randn(2, 2, 3, 4), twice, backend=be)


def test_levels_grid_encode_matches_reference():
    """The level grid (formerly a ROADMAP A2.3 raise): codes, decode and
    bytes of a nearest-rounded ``grid='levels'`` QTensor."""
    jx, tx = _x((6, 10), jnp.float32, seed=2)
    lv = np.array([-1.5, -0.4, 0.0, 0.3, 1.2], np.float32)
    j = jquant.encode(jx, jquant.QScheme(bits=4, grid="levels", rounding="nearest"),
                      levels=jnp.asarray(lv))
    t = tquant.encode(tx, tquant.QScheme(bits=4, grid="levels", rounding="nearest"),
                      levels=torch.from_numpy(lv))
    np.testing.assert_array_equal(t.codes.numpy(), np.asarray(j.codes))
    np.testing.assert_array_equal(t.decode().numpy(), np.asarray(j.decode()))
    assert t.nbytes == j.nbytes
    with pytest.raises(ValueError, match="level table"):
        tquant.encode(tx, tquant.QScheme(bits=4, grid="levels", rounding="nearest"))


def test_optimal_param_tree_matches_reference():
    """``quantize_param_tree(optimal=True)`` (formerly a ROADMAP A2.3
    raise) on one 2-D weight: int16 codes, table, scale and bytes."""
    w = np.random.default_rng(8).normal(0, 0.05, (48, 40)).astype(np.float32)
    jq = jqat.quantize_param_tree({"w": jnp.asarray(w)}, bits=4, optimal=True)["w"]
    tq = tqat.quantize_param_tree({"w": torch.from_numpy(w)}, bits=4, optimal=True)["w"]
    assert tq.codes.dtype == torch.int16 and tq.scheme.grid == "levels"
    np.testing.assert_array_equal(tq.codes.numpy(), np.asarray(jq.codes))
    np.testing.assert_array_equal(tq.levels.numpy(), np.asarray(jq.levels))
    np.testing.assert_array_equal(tq.scale.numpy(), np.asarray(jq.scale))
    assert tq.nbytes == jq.nbytes


def test_precision_plan_legacy_kwargs_warn():
    with pytest.warns(DeprecationWarning):
        plan = tquant.PrecisionPlan(weight_bits=8)
    assert plan.model_bits == 8
    assert tquant.PrecisionPlan.from_dict(plan.to_dict()) == plan
