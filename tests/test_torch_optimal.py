"""Port parity — §3 variance-optimal levels: ``core/optimal.py``, the level
grid (``quantize_to_levels``, ``grid='levels'`` QTensors), the deprecated
constructors, ``quantize_param_tree(optimal=True)`` and serving with
optimal-level weights, against the JAX reference on the CPU.

Tolerances, with their reasons: the solvers are numpy float64 on both
sides and the port keeps each element's operations in the reference's
order, so levels are ``np.array_equal``; level codes and values are
bit-equal (the same f32 operations, the same threefry words); the served
greedy tokens are equal (the reference engine's ``ref`` backend against
the port's, in the same monolithic admission mode, ROADMAP C2).
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from torch_bridge import bridge
from torch_bridge import key as bridge_key

from repro.core import linear as jlin
from repro.core import optimal as jopt
from repro.core import quantize as jqz
from repro.quant import QScheme as JScheme
from repro.quant import qtensor as jqt
from repro.quant import tree_nbytes as jtree_nbytes
from repro_torch.core import linear as tlin
from repro_torch.core import optimal as topt
from repro_torch.core import quantize as tqz
from repro_torch.precision import qat as tqat
from repro_torch.quant import QScheme as TScheme
from repro_torch.quant import qtensor as tqt
from repro_torch.quant import tree_nbytes as ttree_nbytes


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True))


def _data(kind: str, n: int, seed: int) -> np.ndarray:
    """Distributions in [0, 1], with ties where the kind says so."""
    rng = np.random.default_rng(seed)
    if kind == "gauss":
        x = np.abs(rng.normal(size=n))
    elif kind == "beta":
        x = rng.beta(0.7, 2.0, n)
    elif kind == "repeated":        # many exact ties
        x = np.repeat(rng.uniform(size=max(n // 8, 1)), 8)
    elif kind == "grid":            # values on bucket edges
        x = rng.integers(0, 5, n) / 4.0
    elif kind == "constant":
        x = np.full(n, 0.375)
    else:                           # zeros
        x = np.zeros(n)
    return x / max(x.max(), 1e-12)


KINDS = ["gauss", "beta", "repeated", "grid", "constant", "zeros"]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("s", [1, 3, 7])
@pytest.mark.parametrize("M", [64, 128])
def test_discretized_levels_equal(kind, s, M):
    x = _data(kind, 300, s + M)
    np.testing.assert_array_equal(topt.optimal_levels_discretized(x, s, M),
                                  jopt.optimal_levels_discretized(x, s, M))


def test_discretized_levels_c7_case_is_the_references():
    """ROADMAP C7: at s 3, M 64 the grid k/64 holds neither 1/3 nor 2/3, so
    the DP's levels can lose to uniform ones; the port keeps the
    reference's output, defect included."""
    x = np.random.default_rng(0).beta(0.7, 2.0, 56)
    want = jopt.optimal_levels_discretized(x, 3, M=64)
    got = topt.optimal_levels_discretized(x, 3, M=64)
    np.testing.assert_array_equal(got, want)
    assert np.all(np.isin(got * 64, np.arange(65)))       # on the k/64 grid


def test_discretized_levels_at_weight_size_equal():
    """The qat configuration: 65,536 samples, s 127, M 256."""
    x = _data("gauss", 65536, 1)
    np.testing.assert_array_equal(topt.optimal_levels_discretized(x, 127, M=256),
                                  jopt.optimal_levels_discretized(x, 127, M=256))


def test_discretized_levels_batch_equals_columns():
    z = np.stack([_data(k, 200, i) for i, k in enumerate(KINDS)], axis=1)
    got = topt.discretized_levels_batch(z, 7, M=128, chunk_elems=2 * 129 * 129)
    for f in range(z.shape[1]):
        np.testing.assert_array_equal(got[f], jopt.optimal_levels_discretized(z[:, f], 7, 128))


@pytest.mark.parametrize("kind", ["gauss", "beta", "repeated", "grid", "constant"])
@pytest.mark.parametrize("s", [1, 3])
def test_exact_and_2approx_and_adaquant_equal(kind, s):
    x = _data(kind, 60, s)
    np.testing.assert_array_equal(topt.optimal_levels_exact(x, s),
                                  jopt.optimal_levels_exact(x, s))
    np.testing.assert_array_equal(topt.optimal_levels_2approx(x, s),
                                  jopt.optimal_levels_2approx(x, s))
    np.testing.assert_array_equal(topt.adaquant(x, s), jopt.adaquant(x, s))
    lv = jopt.optimal_levels_exact(x, s)
    assert topt.mean_variance(x, lv) == jopt.mean_variance(x, lv)


@pytest.mark.parametrize("method", ["discretized", "exact", "2approx"])
@pytest.mark.parametrize("symmetric", [False, True])
def test_fit_levels_equal(method, symmetric):
    rng = np.random.default_rng(3)
    data = np.concatenate([rng.normal(0.2, 1.0, 80), [np.nan, np.inf]])
    np.testing.assert_array_equal(
        topt.fit_levels(data, 7, method=method, M=64, symmetric=symmetric),
        jopt.fit_levels(data, 7, method=method, M=64, symmetric=symmetric))
    np.testing.assert_array_equal(topt.fit_levels([], 3, symmetric=symmetric),
                                  jopt.fit_levels([], 3, symmetric=symmetric))
    np.testing.assert_array_equal(topt.uniform_levels(5, -1.0, 2.0),
                                  jopt.uniform_levels(5, -1.0, 2.0))


@pytest.mark.parametrize("bits", [3, 5])
def test_fit_feature_levels_equal(bits):
    a = jlin.make_dataset("cod-rna", n_train=64, n_test=16).a_train[:300]
    a = np.concatenate([a, np.zeros((300, 1)), np.full((300, 1), -0.5)], axis=1)
    np.testing.assert_array_equal(tlin.fit_feature_levels(a, bits),
                                  jlin.fit_feature_levels(a, bits))


# ----------------------------------------------------------- level grid --

@pytest.mark.parametrize("with_key", [False, True])
def test_quantize_to_levels_bit_equal(with_key):
    rng = np.random.default_rng(1)
    v = rng.uniform(-0.3, 1.3, (33, 17)).astype(np.float32)
    v[0, :4] = [0.0, 1.0, 0.5, 0.25]                       # on and between levels
    lv = np.array([0.0, 0.1, 0.25, 0.5, 0.9, 1.0], np.float32)
    jkey = jax.random.PRNGKey(7) if with_key else None
    jc, jv = jqz.quantize_to_levels(jnp.asarray(v), jnp.asarray(lv), jkey)
    tc, tv = tqz.quantize_to_levels(_t(v), _t(lv), bridge_key(jkey) if with_key else None)
    assert tc.dtype == torch.int8
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_quantize_to_levels_wide_table_is_int32():
    lv = np.linspace(-1, 1, 255).astype(np.float32)
    v = np.random.default_rng(2).normal(0, 0.5, 64).astype(np.float32)
    jc, _ = jqz.quantize_to_levels(jnp.asarray(v), jnp.asarray(lv))
    tc, _ = tqz.quantize_to_levels(_t(v), _t(lv))
    assert tc.dtype == torch.int32
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


@pytest.mark.parametrize("rounding", ["nearest", "stochastic"])
@pytest.mark.parametrize("stacked", [False, True])
def test_levels_qtensor_encode_decode_nbytes(rounding, stacked):
    rng = np.random.default_rng(4)
    shape = (3, 12, 10) if stacked else (12, 10)
    w = rng.normal(0, 1, shape).astype(np.float32)
    lv = np.sort(rng.normal(0, 1, 9)).astype(np.float32)
    scheme_j = JScheme.levels(9, rounding=rounding)
    scheme_t = TScheme.levels(9, rounding=rounding)
    assert dataclasses.asdict(scheme_t) == dataclasses.asdict(scheme_j)
    jkey = jax.random.PRNGKey(2) if rounding == "stochastic" else None
    j = jqt.encode_jnp(jnp.asarray(w), scheme_j, jkey, levels=jnp.asarray(lv))
    t = tqt.encode(_t(w), scheme_t, None if jkey is None else bridge_key(jkey), levels=_t(lv))
    np.testing.assert_array_equal(t.codes.numpy(), np.asarray(j.codes))
    np.testing.assert_array_equal(t.decode().numpy(), np.asarray(j.decode()))
    assert t.nbytes == j.nbytes
    if stacked:
        # per-slice tables, the layout quantize_param_tree gives stacked weights
        tables = np.stack([lv, lv * 2, lv - 1]).astype(np.float32)
        jq = jqt.QTensor(j.codes, jnp.ones((3,), jnp.float32), scheme_j,
                         levels=jnp.asarray(tables))
        tq = tqt.QTensor(t.codes, torch.ones(3), scheme_t, levels=_t(tables))
        np.testing.assert_array_equal(tq.decode().numpy(), np.asarray(jq.decode()))
        np.testing.assert_array_equal(tq.decode(torch.bfloat16).float().numpy(),
                                      np.asarray(jq.decode(jnp.bfloat16).astype(jnp.float32)))
        assert tq.nbytes == jq.nbytes
        one = tq.index(1)
        np.testing.assert_array_equal(one.decode().numpy(), np.asarray(jq.decode())[1])


def test_deprecated_constructors_warn_and_match():
    codes = np.array([[1, -2], [3, 0]], np.int8)
    with pytest.warns(DeprecationWarning):
        tq = tqz.Quantized(_t(codes), torch.tensor(2.0), 3)
    with pytest.warns(DeprecationWarning):
        jq = jqz.Quantized(jnp.asarray(codes), 2.0, 3)
    np.testing.assert_array_equal(tq.dequantize().numpy(), np.asarray(jq.dequantize()))
    with pytest.warns(DeprecationWarning):
        ti = tqz.IntTensor(_t(codes), torch.tensor(0.5), 8)
    with pytest.warns(DeprecationWarning):
        ji = jqz.IntTensor(jnp.asarray(codes), 0.5, 8)
    np.testing.assert_array_equal(ti.dequantize().numpy(), np.asarray(ji.dequantize()))
    v = np.random.default_rng(5).normal(0, 1, (6, 9)).astype(np.float32)
    jkey = jax.random.PRNGKey(1)
    for axis, key in ((None, None), (0, None), (1, jkey)):
        j = jqz.int_quantize(jnp.asarray(v), 4, axis, key)
        t = tqz.int_quantize(_t(v), 4, axis, None if key is None else bridge_key(key))
        np.testing.assert_array_equal(t.codes.numpy(), np.asarray(j.codes))
        np.testing.assert_array_equal(t.scale.numpy(), np.asarray(j.scale))


# ------------------------------------------------- optimal weights (qat) --

def test_choice_on_length_is_the_references_draw():
    """The port samples a leaf by ``choice(n, ...)`` indices gathered on the
    device; the reference calls ``choice`` on the flattened array. Both
    branches of numpy's sampler (tail shuffle, Floyd) give the same draw."""
    for n in (300_000, 1_000_003):
        a = np.random.default_rng(5).normal(size=n).astype(np.float32)
        idx = np.random.default_rng(0).choice(n, 65536, replace=False)
        np.testing.assert_array_equal(a[idx],
                                      np.random.default_rng(0).choice(a, 65536, replace=False))


def _compare_trees(tq, jq):
    """Leaf by leaf: codes, scales and level tables equal."""
    for k, jv in jq.items():
        tv = tq[k]
        if isinstance(jv, dict):
            _compare_trees(tv, jv)
        elif isinstance(jv, jqt.QTensor):
            assert isinstance(tv, tqt.QTensor) and tv.scheme.grid == "levels"
            assert dataclasses.asdict(tv.scheme) == dataclasses.asdict(jv.scheme)
            assert tv.codes.dtype == torch.int16
            np.testing.assert_array_equal(tv.codes.numpy(), np.asarray(jv.codes))
            np.testing.assert_array_equal(tv.scale.numpy(), np.asarray(jv.scale))
            np.testing.assert_array_equal(tv.levels.numpy(), np.asarray(jv.levels))
        else:
            np.testing.assert_array_equal(tv.float().numpy(),
                                          np.asarray(jv, np.float32))


def _reduced(dtype):
    from repro import configs as jconfigs
    from repro.models import transformer as JT
    from repro_torch import configs as tconfigs

    jd, td = (jnp.float32, torch.float32) if dtype == "f32" else \
        (jnp.bfloat16, torch.bfloat16)
    jcfg = dataclasses.replace(jconfigs.get_reduced("gemma-2b"), dtype=jd)
    tcfg = tconfigs.get_reduced("gemma-2b", dtype=td)
    return jcfg, tcfg, JT.init_params(jax.random.PRNGKey(0), jcfg)


@pytest.fixture(scope="module")
def optimal8_bf16():
    """The reduced gemma-2b (bf16) with 8-bit optimal-level weights, from
    the reference (its DP loop takes ~40 s here)."""
    from repro.precision.qat import quantize_param_tree

    jcfg, tcfg, params = _reduced("bf16")
    return jcfg, tcfg, params, quantize_param_tree(params, bits=8, optimal=True)


def test_quantize_param_tree_optimal8_matches(optimal8_bf16, monkeypatch):
    _, _, params, jq = optimal8_bf16
    fits = []
    fit = tqat._optimal_quantize_weight
    monkeypatch.setattr(tqat, "_optimal_quantize_weight",
                        lambda w, bits: fits.append(w.shape) or fit(w, bits))
    tq = tqat.quantize_param_tree(bridge(params), bits=8, optimal=True)
    _compare_trees(tq, jq)
    assert ttree_nbytes(tq) == jtree_nbytes(jq)
    assert len(fits) == 7                         # one fit per stacked weight


def test_quantize_param_tree_optimal4_f32_matches():
    from repro.precision.qat import quantize_param_tree

    _, _, params = _reduced("f32")
    jq = quantize_param_tree(params, bits=4, optimal=True)
    tq = tqat.quantize_param_tree(bridge(params), bits=4, optimal=True)
    _compare_trees(tq, jq)
    assert ttree_nbytes(tq) == jtree_nbytes(jq)
    # the bridged reference tree decodes like the port's own
    _compare_trees(bridge(jq), jq)


def test_migrate_spliced_level_weights():
    from repro.precision.qat import migrate_spliced_weights as jmig

    rng = np.random.default_rng(6)
    codes = rng.integers(0, 7, (2, 5, 4)).astype(np.int16)
    table = np.linspace(-1, 1, 7).astype(np.float32)
    j = jmig({"mlp": {"w_lvl_codes": jnp.asarray(codes), "w_levels": jnp.asarray(table)}})
    t = tqat.migrate_spliced_weights({"mlp": {"w_lvl_codes": _t(codes),
                                              "w_levels": _t(table)}})
    jw, tw = j["mlp"]["w"], t["mlp"]["w"]
    np.testing.assert_array_equal(tw.decode().numpy(), np.asarray(jw.decode()))
    assert tw.nbytes == jw.nbytes


def _serve_both(jcfg, tcfg, jq, weight_bits):
    from repro.launch.serve import make_trace as jtrace
    from repro.quant import PrecisionPlan as JPlan
    from repro.serve import ServeEngine as JEngine
    from repro_torch.launch.serve import make_trace as ttrace
    from repro_torch.quant import PrecisionPlan as TPlan
    from repro_torch.serve import ServeEngine as TEngine

    kw = dict(kv_bits=8, model_bits=weight_bits, model_storage="int", optimal_levels=True)
    ekw = dict(max_slots=4, page_size=8, max_seq_len=32)
    jeng = JEngine(jq, jcfg, plan=JPlan(**kw), backend="ref", **ekw)
    teng = TEngine(bridge(jq), tcfg, plan=TPlan(**kw), device="cpu", backend="cuda", **ekw)
    tkw = dict(max_new=8, max_prompt=16, seed=0)
    jres = jeng.run(jtrace(8, jcfg.vocab_size, **tkw))
    tres = teng.run(ttrace(8, tcfg.vocab_size, **tkw))
    assert sorted(tres) == sorted(jres)
    for r in jres:
        np.testing.assert_array_equal(np.asarray(tres[r].tokens), np.asarray(jres[r].tokens))
    assert teng.weight_nbytes() == jtree_nbytes(jq)


def test_serve_optimal8_bf16_tokens_equal(optimal8_bf16):
    """8-bit optimal-level weights, KV 8, bf16: the port's engine (the
    ``cuda`` backend's decode fallback on CPU tensors) against the
    reference engine."""
    from repro_torch.kernels import qmm as tqmm

    jcfg, tcfg, _, jq = optimal8_bf16
    before = tqmm.launches
    _serve_both(jcfg, tcfg, jq, 8)
    assert tqmm.launches == before


def test_serve_optimal4_f32_tokens_equal():
    from repro.precision.qat import quantize_param_tree

    jcfg, tcfg, params = _reduced("f32")
    _serve_both(jcfg, tcfg, quantize_param_tree(params, bits=4, optimal=True), 4)


def test_serve_engine_optimal_levels_flag():
    from repro_torch.launch.serve import serve_engine

    engine, results = serve_engine("gemma-2b", n_requests=2, max_new=4, weight_bits=4,
                                   kv_bits=8, optimal_levels=True, device="cpu")
    assert len(results) == 2
    w = engine.params["layers"]["mlp"]["up"]["w"]
    assert w.scheme.grid == "levels" and w.levels.shape[-1] == 15
