"""Port parity — kernels B2 (``row_absmax``) and B4 (``stoch_quant``) and the
entry points behind them: the plain versions (what the wrappers run on CPU
tensors) against the reference's Pallas kernels in interpret mode, as
``tests/test_kernels.py`` runs them, and ``ops.quantize_rows``,
``ops.dequantize_rows`` and ``ops.ds_quantize(scale=None)`` against the
reference's ``ops`` under the same key.

Tolerance: bit-exact everywhere — a max is exact in any order, the rounding
repeats the reference's f32 operations one by one, and the rand plane is the
same threefry words.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from torch_bridge import key as bridge_key

from repro.kernels import ops as jops
from repro.kernels import stoch_quant as jsq
from repro_torch import prng
from repro_torch.kernels import ops as tops
from repro_torch.kernels import stoch_quant as tsq

SHAPES = [(13, 1001), (16, 64), (8, 256), (3, 5)]
DTYPES = ["f32", "bf16"]


def _x(shape, dtype, seed):
    x = (np.random.default_rng(seed).normal(0, 2, shape)).astype(np.float32)
    x[0] = 0.0                                        # an all-zero row
    x[-1, 0] = -0.0
    jx = jnp.asarray(x) if dtype == "f32" else jnp.asarray(x).astype(jnp.bfloat16)
    tx = torch.from_numpy(x) if dtype == "f32" else torch.from_numpy(x).to(torch.bfloat16)
    return jx, tx


def _rand(shape, seed):
    r = np.random.default_rng(seed).integers(0, 2**32, shape, dtype=np.uint32)
    r.flat[:4] = [0, 0xFFFFFFFF, 0x80000000, 0xFF]    # the ends of u's range
    return jnp.asarray(r), torch.from_numpy(r.view(np.int32))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_row_absmax_plain_bit_exact_with_pallas(shape, dtype):
    jx, tx = _x(shape, dtype, 1)
    want = jsq.row_absmax(jx, interpret=True)
    got = tsq.row_absmax(tx)
    assert got.shape == shape[:1] + (1,) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert not torch.signbit(got).any()


def test_row_absmax_propagates_nan():
    x = np.ones((3, 40), np.float32)
    x[1, 17] = np.nan
    want = np.asarray(jsq.row_absmax(jnp.asarray(x), interpret=True))
    got = tsq.row_absmax(torch.from_numpy(x)).numpy()
    assert np.isnan(want[1, 0]) and np.isnan(got[1, 0])
    np.testing.assert_array_equal(got[[0, 2]], want[[0, 2]])


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("s", [1, 3, 15, 127])
def test_stoch_quant_plain_bit_exact_with_pallas(shape, dtype, s):
    jx, tx = _x(shape, dtype, s)
    jr, tr = _rand(shape, s + 1)
    jscale = jsq.row_absmax(jx, interpret=True)
    want = jsq.stoch_quant(jx, jr, jscale, s=s, interpret=True)
    got = tsq.stoch_quant(tx, tr, tsq.row_absmax(tx), s=s)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(got.abs().max()) <= s


def test_stoch_quant_rejects_bad_operands():
    x = torch.ones(4, 8)
    rand = torch.zeros(4, 8, dtype=torch.int32)
    scale = torch.ones(4, 1)
    with pytest.raises(ValueError, match="s <= 127"):
        tsq.stoch_quant(x, rand, scale, s=255)
    with pytest.raises(TypeError):
        tsq.stoch_quant(x, rand.to(torch.int64), scale, s=7)
    with pytest.raises(ValueError):
        tsq.stoch_quant(x, rand[:2], scale, s=7)
    with pytest.raises(ValueError):
        tsq.stoch_quant(x, rand, torch.ones(1, 8), s=7)
    with pytest.raises(ValueError):
        tsq.row_absmax(torch.ones(4))


@pytest.mark.parametrize("dtype", DTYPES)
def test_nan_gives_code_zero_as_in_reference(dtype):
    """A NaN x, or the NaN scale that ``row_absmax`` gives a row holding one,
    quantizes to code 0 in ``stoch_quant`` and both ``ds_quant`` planes —
    what the reference's cast of NaN to int8 gives."""
    x = np.random.default_rng(5).normal(0, 2, (5, 40)).astype(np.float32)
    x[1, 17] = np.nan                                  # row 1: NaN scale
    x[2, 3] = np.nan                                   # row 2: NaN x, finite scale
    jx = jnp.asarray(x) if dtype == "f32" else jnp.asarray(x).astype(jnp.bfloat16)
    tx = torch.from_numpy(x) if dtype == "f32" else torch.from_numpy(x).to(torch.bfloat16)
    jr, tr = _rand(x.shape, 6)
    jscale = jsq.row_absmax(jx, interpret=True).at[2].set(3.0)
    tscale = tsq.row_absmax(tx)
    tscale[2] = 3.0
    want = np.asarray(jsq.stoch_quant(jx, jr, jscale, s=15, interpret=True))
    got = tsq.stoch_quant(tx, tr, tscale, s=15).numpy()
    np.testing.assert_array_equal(got, want)
    assert not got[1].any() and got[2, 3] == 0 and got[2].any()
    jkey = jax.random.PRNGKey(2)
    for g, w in zip(tops.ds_quantize(tx, 15, bridge_key(jkey)), jops.ds_quantize(jx, 15, jkey)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    jc, _ = jops.quantize_rows(jx, 15, jkey)
    tc, _ = tops.quantize_rows(tx, 15, bridge_key(jkey))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


@pytest.mark.parametrize("shape", [(13, 1001), (16, 100)])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("s", [3, 15])
def test_quantize_and_dequantize_rows_match_reference_ops(shape, dtype, s):
    jx, tx = _x(shape, dtype, 7)
    jkey = jax.random.PRNGKey(s)
    jc, js = jops.quantize_rows(jx, s, jkey)
    tc, ts = tops.quantize_rows(tx, s, bridge_key(jkey))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tops.dequantize_rows(tc, ts, s).numpy(),
                                  np.asarray(jops.dequantize_rows(jc, js, s)))


@pytest.mark.parametrize("shape", [(13, 1001), (16, 100)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_ds_quantize_without_scale_matches_reference_ops(shape, dtype):
    """``scale=None`` takes the row scales from ``row_absmax``."""
    jx, tx = _x(shape, dtype, 9)
    jkey = jax.random.PRNGKey(4)
    want = jops.ds_quantize(jx, 15, jkey)
    got = tops.ds_quantize(tx, 15, bridge_key(jkey), None)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert tuple(got[2].shape) == (shape[0], 1)


def test_entry_points_on_cpu_launch_nothing():
    before = (tsq.launches, tsq.row_absmax_launches, tsq.stoch_quant_launches,
              sum(tsq.shape_launches.values()))
    x = torch.randn(16, 50)
    tops.quantize_rows(x, 7, prng.PRNGKey(0))
    tops.ds_quantize(x, 7, prng.PRNGKey(0))
    assert (tsq.launches, tsq.row_absmax_launches, tsq.stoch_quant_launches,
            sum(tsq.shape_launches.values())) == before


def test_quantize_rows_is_unbiased():
    """E[codes/s·scale] = x over the rounding's own randomness: the mean of
    512 draws within 6 standard errors of x."""
    x = torch.from_numpy(np.random.default_rng(3).normal(0, 1, (4, 64)).astype(np.float32))
    draws = torch.stack([tops.dequantize_rows(*tops.quantize_rows(x, 3, prng.PRNGKey(i)), 3)
                         for i in range(512)])
    se = draws.std(0) / np.sqrt(512) + 1e-6
    assert bool(((draws.mean(0) - x).abs() <= 6 * se + 1e-6).all())
