"""Port parity — slice 2, the paper's linear-model path: the two kernels'
plain versions, the zipml quantization, double sampling and ``train_linear``.

Which reference each port path is held against: the two JAX backends draw
different random streams, so

* the port's ``ref`` backend is compared with the JAX ``ref`` backend (two
  ``uniform`` draws from a split key);
* the port's ``cuda`` backend on CPU tensors — which runs the kernels' plain
  versions — with the JAX ``pallas`` backend in interpret mode (one ``bits``
  plane, the high and low 16 bits).

Tolerances, with their reasons:

* codes and key-driven draws: bit-exact (same threefry words, same f32
  operations in the same order);
* ``ds_quant`` plain against the Pallas kernel: bit-exact;
* ``qmv`` plain and every f32 matvec or gradient: rel 1e-5 of the largest
  output — torch and XLA sum in another order;
* ``train_linear`` per-epoch losses: rtol 1e-4. The two epochs take 32 SGD
  steps whose gradients differ in the last bits (summation order), and the
  drift compounds through the iterates; measured on this configuration it
  stays below 1e-5, the margin covers the rare stochastic-rounding code that
  such a drift flips in the quantized modes. The reference is jitted
  (``run_epoch`` is ``jax.jit`` over ``lax.scan``), as ROADMAP C4 asks.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from torch_bridge import key as bridge_key

from repro.core import double_sampling as jds
from repro.core import linear as jlin
from repro.core import quantize as jqz
from repro.kernels import ops as jops
from repro.kernels import qmm as jqmm
from repro.kernels import ref as jref
from repro.kernels import registry as jreg
from repro.kernels import stoch_quant as jsq
from repro.quant import PrecisionPlan as JPlan
from repro.quant import QScheme as JScheme
from repro.quant import qtensor as jqt
from repro_torch import prng
from repro_torch.core import double_sampling as tds
from repro_torch.core import linear as tlin
from repro_torch.core import quantize as tqz
from repro_torch.kernels import ops as tops
from repro_torch.kernels import qmv as tqmv
from repro_torch.kernels import registry as treg
from repro_torch.kernels import stoch_quant as tsq
from repro_torch.quant import PrecisionPlan as TPlan
from repro_torch.quant import QScheme as TScheme
from repro_torch.quant import qtensor as tqt

PAIRINGS = [("ref", "ref"), ("pallas", "cuda")]    # (JAX backend, port backend)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True))


def _close(got, want, rtol=1e-5):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * np.abs(want).max())


def _problem(B=16, n=100, seed=0):
    rng = np.random.default_rng(seed)
    a = (rng.uniform(-1, 1, (B, n)) * np.linspace(1.0, 0.2, n)).astype(np.float32)
    x = rng.normal(0, 1, n).astype(np.float32)
    b = rng.normal(0, 1, B).astype(np.float32)
    col = np.maximum(np.abs(a).max(axis=0), 1e-12).astype(np.float32)
    return a, x, b, col


# ----------------------------------------------------------------- kernels --

@pytest.mark.parametrize("shape", [(8, 128), (13, 100)])
@pytest.mark.parametrize("s,dtype", [(1, "f32"), (7, "f32"), (127, "f32"), (127, "bf16")])
@pytest.mark.parametrize("axis", ["row", "col"])
def test_ds_quant_plain_bit_exact_with_pallas(shape, s, axis, dtype):
    jkey = jax.random.PRNGKey(s)
    x = jax.random.normal(jkey, shape) * 3
    if dtype == "bf16":
        x = x.astype(jnp.bfloat16)
    rand = jax.random.bits(jax.random.fold_in(jkey, 1), shape, jnp.uint32)
    ax = 1 if axis == "row" else 0
    scale = jnp.max(jnp.abs(x.astype(jnp.float32)), axis=ax, keepdims=True)
    want = jsq.ds_quant(x, rand, scale, s=s, scale_axis=axis, interpret=True)
    tx = _t(np.asarray(x.astype(jnp.float32)))
    if dtype == "bf16":
        tx = tx.to(torch.bfloat16)
    tr = _t(np.asarray(rand).view(np.int32))
    got = tsq.ds_quant(tx, tr, _t(np.asarray(scale)), s=s, scale_axis=axis)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    with pytest.raises(TypeError):
        tsq.ds_quant(tx, tr.to(torch.int64), _t(np.asarray(scale)), s=s, scale_axis=axis)


def test_ds_quant_rejects_s_over_127():
    with pytest.raises(ValueError):
        jsq.ds_quant(jnp.ones((8, 128)), jnp.zeros((8, 128), jnp.uint32),
                     jnp.ones((8, 1)), s=255, interpret=True)
    with pytest.raises(ValueError):
        tsq.ds_quant(torch.ones(8, 128), torch.zeros(8, 128, dtype=torch.int32),
                     torch.ones(8, 1), s=255)


@pytest.mark.parametrize("shape,transposed", [((16, 100), False), ((16, 100), True),
                                              ((128, 256), False), ((13, 600), True)])
def test_qmv_plain_matches_pallas(shape, transposed):
    rng = np.random.default_rng(shape[0])
    plane = rng.integers(-127, 128, shape).astype(np.int8)
    codes = plane.T if transposed else plane
    v = rng.normal(0, 1, codes.shape[1]).astype(np.float32)
    want = np.asarray(jops.int8_matvec(jnp.asarray(codes), jnp.asarray(v)))
    tplane = _t(plane)
    got = tqmv.qmv(tplane.T if transposed else tplane, _t(v))
    _close(got.numpy(), want)
    _close(got.numpy(), np.asarray(jref.qmv_ref(jnp.asarray(codes), jnp.asarray(v))))
    if not transposed and shape[0] % 128 == 0:     # the unpadded kernel itself
        direct = jqmm.qmv(jnp.asarray(codes), jnp.asarray(v).reshape(-1, 1),
                          interpret=True)
        _close(got.numpy(), np.asarray(direct)[:, 0])


@pytest.mark.parametrize("scale_kind", ["column", "row", "scalar"])
@pytest.mark.parametrize("s", [3, 31])
def test_ds_quantize_and_gradient_match_reference_ops(scale_kind, s):
    a, x, b, col = _problem(seed=s)
    scale = {"column": col, "row": np.abs(a).max(axis=1, keepdims=True),
             "scalar": np.float32(np.abs(a).max())}[scale_kind]
    jkey = jax.random.PRNGKey(7 + s)
    j1, j2, jsc = jops.ds_quantize(jnp.asarray(a), s, jkey, scale=jnp.asarray(scale))
    t1, t2, tsc = tops.ds_quantize(_t(a), s, bridge_key(jkey), _t(scale))
    np.testing.assert_array_equal(t1.numpy(), np.asarray(j1))
    np.testing.assert_array_equal(t2.numpy(), np.asarray(j2))
    np.testing.assert_array_equal(tsc.numpy(), np.asarray(jsc))
    if scale_kind != "row":     # the codes gradient takes column scales
        want = jops.ds_gradient_from_codes(j1, j2, jnp.asarray(x), jnp.asarray(b), jsc, s)
        got = tops.ds_gradient_from_codes(t1, t2, _t(x), _t(b), tsc, s)
        _close(got.numpy(), np.asarray(want))


def test_ds_quantize_without_scale_names_b2():
    with pytest.raises(NotImplementedError, match="B2"):
        tops.ds_quantize(torch.ones(4, 8), 7, prng.PRNGKey(0), None)


def test_cuda_backend_on_cpu_launches_nothing():
    a, x, b, col = _problem()
    before = (tsq.launches, tqmv.launches)
    treg.get("cuda").lsq_ds_gradient(_t(x), _t(a), _t(b), 7, prng.PRNGKey(0), _t(col))
    assert (tsq.launches, tqmv.launches) == before


# ------------------------------------------------------ quantize (core C1) --

@pytest.mark.parametrize("s", [1, 15, 255])
@pytest.mark.parametrize("scaling", ["tensor", "column", "row"])
def test_zipml_encode_matches_reference(s, scaling):
    a, *_ = _problem(B=6, n=20, seed=s)
    a[0, 0] = 0.0
    jkey = jax.random.PRNGKey(s)
    for rounding, key in (("stochastic", jkey), ("nearest", None)):
        js = JScheme.zipml(s, scaling=scaling, rounding=rounding)
        ts = TScheme.zipml(s, scaling=scaling, rounding=rounding)
        assert ts == TScheme(**{f: getattr(js, f) for f in js.__dataclass_fields__})
        j = jqt.encode_jnp(jnp.asarray(a), js, key)
        t = tqt.encode(_t(a), ts, None if key is None else bridge_key(key))
        assert t.codes.dtype == (torch.int8 if s <= 127 else torch.int32)
        np.testing.assert_array_equal(t.codes.numpy(), np.asarray(j.codes))
        np.testing.assert_array_equal(t.scale.numpy(), np.asarray(j.scale))
        np.testing.assert_array_equal(t.decode().numpy(), np.asarray(j.decode()))
        assert t.nbytes == j.nbytes


def test_stochastic_round_matches_reference():
    t = np.random.default_rng(3).uniform(-4, 9, (7, 33)).astype(np.float32)
    jkey = jax.random.PRNGKey(5)
    want = jqt.stochastic_round(jnp.asarray(t), jkey)
    got = tqt.stochastic_round(_t(t), bridge_key(jkey))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("pairing", PAIRINGS)
def test_ds_pair_matches_reference(pairing):
    jb, tb = pairing
    a, *_ = _problem(B=8, n=40)
    jkey = jax.random.PRNGKey(2)
    for scale in (None, np.abs(a).max(axis=0)):
        js, ts = JScheme.zipml(7, rounding="ds"), TScheme.zipml(7, rounding="ds")
        j = jqt.ds_pair(jnp.asarray(a), js, jkey, None if scale is None else jnp.asarray(scale),
                        backend=jb)
        t = tqt.encode(_t(a), ts, bridge_key(jkey), None if scale is None else _t(scale),
                       backend=tb)
        assert t.is_ds and t.nbits == j.nbits and t.nbytes == j.nbytes
        np.testing.assert_array_equal(t.codes.numpy(), np.asarray(j.codes))
        np.testing.assert_array_equal(t.codes2.numpy(), np.asarray(j.codes2))
        np.testing.assert_array_equal(t.decode2().numpy(), np.asarray(j.decode2()))


@pytest.mark.parametrize("pairing", PAIRINGS)
@pytest.mark.parametrize("scale_kind", ["tensor", "row", "column"])
def test_qt_dot_matches_reference(pairing, scale_kind):
    jb, tb = pairing
    a, x, *_ = _problem(B=12, n=30)
    js = JScheme.zipml(15, scaling=scale_kind, rounding="nearest")
    j = jqt.encode_jnp(jnp.asarray(a), js)
    t = tqt.encode(_t(a), TScheme.zipml(15, scaling=scale_kind, rounding="nearest"))
    _close(tqt.dot(t, _t(x), backend=tb).numpy(),
           np.asarray(jqt.dot(j, jnp.asarray(x), backend=jb)))


def test_core_quantize_matches_reference():
    a, x, *_ = _problem(B=9, n=50, seed=4)
    jkey = jax.random.PRNGKey(9)
    key = bridge_key(jkey)
    for norm in ("linf", "l2"):
        _close(tqz.row_scale(_t(x), norm).numpy(), np.asarray(jqz.row_scale(jnp.asarray(x), norm)))
    np.testing.assert_array_equal(tqz.column_scale(_t(a)).numpy(),
                                  np.asarray(jqz.column_scale(jnp.asarray(a))))
    for s in (3, 255):
        j = jqz.quantize(jnp.asarray(x), s, jkey)
        t = tqz.quantize(_t(x), s, key)
        np.testing.assert_array_equal(t.codes.numpy(), np.asarray(j.codes))
        np.testing.assert_array_equal(tqz.dequantize(t).numpy(), np.asarray(jqz.dequantize(j)))
        np.testing.assert_array_equal(
            tqz.stochastic_quantize(_t(a), s, key, scale=_t(np.abs(a).max(0))).numpy(),
            np.asarray(jqz.stochastic_quantize(jnp.asarray(a), s, jkey,
                                               scale=jnp.asarray(np.abs(a).max(0)))))
        np.testing.assert_array_equal(
            tqz.quantize_nearest(_t(x), s).codes.numpy(),
            np.asarray(jqz.quantize_nearest(jnp.asarray(x), s).codes))
        _close(tqz.tv_variance(_t(x), s).numpy(), np.asarray(jqz.tv_variance(jnp.asarray(x), s)))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tqz.quantize_to_levels(_t(x), torch.linspace(0, 1, 4))


# ----------------------------------------------- double sampling (C2, C3) --

@pytest.mark.parametrize("pairing", PAIRINGS)
def test_double_sampling_matches_reference(pairing):
    jb, tb = pairing
    a, x, b, col = _problem()
    ja, jx, jb_, jcol = map(jnp.asarray, (a, x, b, col))
    ta, tx, tb_, tcol = map(_t, (a, x, b, col))
    jkey = jax.random.PRNGKey(21)
    key = bridge_key(jkey)
    for scale_j, scale_t in ((jcol, tcol), (None, None)):
        jq = jds.double_sample_pair(ja, 15, jkey, scale=scale_j, backend=jb)
        tq = tds.double_sample_pair(ta, 15, key, scale=scale_t, backend=tb)
        for g, w in zip(tq, jq):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    _close(tds.lsq_gradient_double_sampling(tx, ta, tb_, 15, key, scale=tcol, backend=tb),
           jds.lsq_gradient_double_sampling(jx, ja, jb_, 15, jkey, scale=jcol, backend=jb))
    cfg = JPlan("e2e", sample_bits=6, model_bits=8, grad_bits=8).ds_config()
    tcfg = TPlan("e2e", sample_bits=6, model_bits=8, grad_bits=8).ds_config()
    assert tuple(tcfg) == tuple(cfg)
    _close(tds.lsq_gradient_e2e(tx, ta, tb_, tcfg, key, sample_scale=tcol, backend=tb),
           jds.lsq_gradient_e2e(jx, ja, jb_, cfg, jkey, sample_scale=jcol, backend=jb))


def test_fullprec_and_naive_gradients_match_reference():
    a, x, b, col = _problem(seed=3)
    jkey = jax.random.PRNGKey(4)
    _close(tds.lsq_gradient_fullprec(_t(x), _t(a), _t(b)),
           jds.lsq_gradient_fullprec(jnp.asarray(x), jnp.asarray(a), jnp.asarray(b)))
    _close(tds.lsq_gradient_naive_quant(_t(x), _t(a), _t(b), 15, bridge_key(jkey), _t(col)),
           jds.lsq_gradient_naive_quant(jnp.asarray(x), jnp.asarray(a), jnp.asarray(b), 15,
                                        jkey, jnp.asarray(col)))


def test_cuda_path_gradient_unbiased():
    """E[g] = g_full over the fused estimator's own randomness (shared base,
    independent 16-bit up-draws): the mean of 4096 gradients of the port's
    cuda path (plain ``ds_quant`` + four ``qmv``) within 6 standard errors,
    as tests/test_ds_fused.py holds the reference's."""
    rng = np.random.default_rng(5)
    B, n, s = 8, 24, 3
    a = _t(rng.normal(0, 1, (B, n)).astype(np.float32))
    x = _t(rng.normal(0, 1, n).astype(np.float32))
    b = _t(rng.normal(0, 1, B).astype(np.float32))
    sc = a.abs().amax(0, keepdim=True)
    g_full = tds.lsq_gradient_fullprec(x, a, b).numpy()
    rands = prng.bits(prng.PRNGKey(11), (4096, B, n)).to(torch.int32)
    gs = []
    for r in rands:
        c1, c2 = tsq.ds_quant(a, r, sc, s=s, scale_axis="col")
        gs.append(tops.ds_gradient_from_codes(c1, c2, x, b, sc, s).numpy())
    gs = np.stack(gs)
    se = gs.std(0) / np.sqrt(gs.shape[0]) + 1e-6
    np.testing.assert_array_less(np.abs(gs.mean(0) - g_full), 6 * se + 1e-3)


# ------------------------------------------------------------ train_linear --

def test_make_dataset_identical_and_evals():
    for kind in ("synthetic100", "cadata", "cod-rna"):
        j, t = jlin.make_dataset(kind, n_train=64, n_test=32), tlin.make_dataset(
            kind, n_train=64, n_test=32)
        for f in ("a_train", "b_train", "a_test", "b_test"):
            np.testing.assert_array_equal(getattr(t, f), getattr(j, f))
    x = np.random.default_rng(0).normal(0, 0.1, t.n_features)
    assert tlin.eval_accuracy(t, x) == jlin.eval_accuracy(j, x)
    assert tlin.eval_mse(t, x) == jlin.eval_mse(j, x)


MODES = ["full", "naive", "nearest", "double", "e2e"]


@pytest.fixture(scope="module")
def synth():
    return (jlin.make_dataset("synthetic100", n_train=256, n_test=64),
            tlin.make_dataset("synthetic100", n_train=256, n_test=64))


@pytest.mark.parametrize("pairing", PAIRINGS)
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("model", ["linreg", "lssvm"])
def test_train_linear_loss_curves_match_reference(synth, model, mode, pairing):
    jb, tb = pairing
    jds_, tds_ = synth
    bits = dict(sample_bits=6, model_bits=8, grad_bits=8) if mode == "e2e" else {}
    j = jlin.train_linear(jds_, JPlan(mode, backend=jb, **bits), model=model,
                          epochs=2, lr=0.3)
    t = tlin.train_linear(tds_, TPlan(mode, backend=tb, **bits), model=model,
                          epochs=2, lr=0.3, device="cpu")
    assert t.losses.shape == (2,) and np.isfinite(t.losses).all()
    np.testing.assert_allclose(t.losses, j.losses, rtol=1e-4)
    np.testing.assert_allclose(t.x, j.x, rtol=0, atol=1e-4 * np.abs(j.x).max())


@pytest.mark.parametrize("kw", [dict(model="svm"), dict(model="logistic"),
                                dict(refetch="l1"),
                                dict(prec=TPlan("double", optimal_levels=True))])
def test_unported_options_name_the_roadmap(synth, kw):
    prec = kw.pop("prec", TPlan("double"))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tlin.train_linear(synth[1], prec, epochs=1, device="cpu", **kw)


def test_train_linear_defaults_to_the_card(synth):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="cuda"):
        tlin.train_linear(synth[1], TPlan("full"), epochs=1)


def test_registry_env_selection_is_scoped(monkeypatch):
    """The port's selection env var picks the backend and is undone by
    monkeypatch; the reference's registry is untouched."""
    monkeypatch.setenv(treg.ENV_VAR, "cuda")
    assert treg.get().name == "cuda"
    monkeypatch.setenv(treg.ENV_VAR, "ref")
    assert treg.get().name == "ref"
    assert jreg.get("ref").name == "ref"
