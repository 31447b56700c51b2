"""Port parity — §4 Chebyshev gradients and the rest of ``train_linear``:
coefficients, ``polynomial_estimator``, ``quantized_poly_gradient``, the
logistic and SVM models with their straw men and ℓ1 refetching, and
``double`` with variance-optimal levels, against jitted JAX on the CPU.

Tolerances, with their reasons:

* coefficients: ``np.array_equal`` in float64 and after the f32 cast (the
  same numpy calls);
* sample codes: bit-equal (the same threefry words; the port draws the
  d+1 planes of a gradient in one batched call);
* ``polynomial_estimator`` / ``quantized_poly_gradient``: rel 1e-4 of the
  largest output. Degree 15 in the monomial basis over [−16, 16] is badly
  conditioned: terms reach mᵢ·16ⁱ and cancel, so a last-bit difference in
  ``qa @ x`` (torch and XLA sum in another order) grows. Measured over 80
  draws at the R-ball's boundary (n 8 and 100, R 16 logistic and R 4
  step): at most 1.13e-5;
* per-step gradients from the reference's own iterate: rel 1e-4, as above;
* ``train_linear`` per-epoch losses rtol 1e-4, final x atol 1e-4 of its
  largest entry, ``refetch_frac`` equal. Free runs measured on these
  configurations: losses within rel 1.5e-7, x within 7.3e-6 of its largest
  entry (the naive logistic straw man on synthetic100).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from torch_bridge import key as bridge_key

from repro.core import chebyshev as jch
from repro.core import double_sampling as jds
from repro.core import linear as jlin
from repro.core import quantize as jqz
from repro.quant import PrecisionPlan as JPlan
from repro_torch import prng
from repro_torch.core import chebyshev as tch
from repro_torch.core import double_sampling as tds
from repro_torch.core import linear as tlin
from repro_torch.core import quantize as tqz
from repro_torch.quant import PrecisionPlan as TPlan

POLY_TOL = 1e-4
PAIRINGS = [("ref", "ref"), ("pallas", "cuda")]    # (JAX backend, port backend)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True))


def _close(got, want, rtol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * np.abs(want).max())


@pytest.mark.parametrize("degree", [1, 5, 15])
@pytest.mark.parametrize("R", [1.0, 4.0, 16.0])
def test_coefficients_equal(degree, R):
    for fn, args in ((tch.sigmoid_prime_coeffs, ()), (tch.step_coeffs, ()),
                     (tch.step_coeffs, (0.2,))):
        want = getattr(jch, fn.__name__)(degree, R, *args)
        got = fn(degree, R, *args)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got.astype(np.float32), want.astype(np.float32))
    z = np.linspace(-R, R, 11)
    c = jch.sigmoid_prime_coeffs(degree, R)
    np.testing.assert_array_equal(tch.poly_eval(c, z), jch.poly_eval(c, z))
    cos = lambda v: np.cos(v / R)  # noqa: E731
    np.testing.assert_array_equal(tch.chebyshev_coeffs(cos, degree, R, 65),
                                  jch.chebyshev_coeffs(cos, degree, R, 65))
    assert tuple(tch.ChebGradConfig()) == tuple(jch.ChebGradConfig())


def _poly_problem(seed, n, R):
    rng = np.random.default_rng(seed)
    a = (rng.uniform(-1, 1, (16, n)) * np.linspace(1, 0.2, n)).astype(np.float32)
    b = np.sign(rng.normal(size=16)).astype(np.float32)
    col = np.abs(a).max(0).astype(np.float32)
    # on the §4.2 ball's boundary: |aᵀx| up to R, the worst conditioning
    x = rng.normal(size=n)
    x = (x / np.linalg.norm(x) * R / np.linalg.norm(a, axis=1).max()).astype(np.float32)
    return a, b, x, col


_JPOLY = jax.jit(lambda c, a, x, k, sc: jds.polynomial_estimator(c, a, x, 15, k, scale=sc))
_JGRAD = jax.jit(lambda c, x, a, b, k, sc: jch.quantized_poly_gradient(
    c, x, a, b, 15, k, scale=sc))


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("model", ["logistic", "svm"])
def test_polynomial_estimator_and_gradient_match(seed, model):
    R = 16.0 if model == "logistic" else 4.0
    c64 = jch.sigmoid_prime_coeffs(15, R) if model == "logistic" else -jch.step_coeffs(15, R)
    c = c64.astype(np.float32)
    a, b, x, col = _poly_problem(seed, 8 if seed % 2 else 100, R)
    jkey = jax.random.PRNGKey(seed)
    key = bridge_key(jkey)
    want = _JPOLY(jnp.asarray(c), jnp.asarray(a), jnp.asarray(x), jkey, jnp.asarray(col))
    got = tds.polynomial_estimator(_t(c), _t(a), _t(x), 15, key, scale=_t(col))
    _close(got.numpy(), np.asarray(want), POLY_TOL)
    want = _JGRAD(jnp.asarray(c), jnp.asarray(x), jnp.asarray(a), jnp.asarray(b), jkey,
                  jnp.asarray(col))
    got = tch.quantized_poly_gradient(_t(c), _t(x), _t(a), _t(b), 15, key, scale=_t(col))
    _close(got.numpy(), np.asarray(want), POLY_TOL)


def test_poly_planes_use_the_references_codes():
    """The batched draw gives each monomial the reference's own key: the
    quantization of monomial i is ``stochastic_quantize(a, s, split(k_poly,
    d)[i])`` and the outer one that of k_outer, bit for bit."""
    a, b, x, col = _poly_problem(0, 12, 16.0)
    jkey = jax.random.PRNGKey(3)
    keys = tch.poly_gradient_keys(bridge_key(jkey), 15)
    u = prng.uniform(keys, a.shape)
    k_poly, k_outer = jax.random.split(jkey)
    jkeys = list(jax.random.split(k_poly, 15)) + [k_outer]
    ab = a * b[:, None]
    for i, jk in enumerate(jkeys):
        src = ab if i < 15 else a
        want = jqz.stochastic_quantize(jnp.asarray(src), 15, jk, scale=jnp.asarray(col))
        got = tqz.stochastic_quantize(_t(src), 15, None, scale=_t(col), u=u[i])
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # degree 0: no plane, the constant term only
    c0 = np.array([0.25], np.float32)
    np.testing.assert_array_equal(
        tds.polynomial_estimator(_t(c0), _t(a), _t(x), 15, bridge_key(jkey)).numpy(),
        np.asarray(jds.polynomial_estimator(jnp.asarray(c0), jnp.asarray(a),
                                            jnp.asarray(x), 15, jkey)))


@pytest.mark.parametrize("model", ["logistic", "svm"])
def test_gradients_per_step_from_the_references_iterate(model):
    """32 steps of the reference's own SGD (its keys and batches, jitted
    gradient); at each step the port's gradient from the same iterate
    within POLY_TOL: a free run cannot hide a drift this way."""
    ds = jlin.make_dataset("cod-rna", n_test=16)
    a_all, b_all = ds.a_train[:512].astype(np.float32), ds.b_train[:512].astype(np.float32)
    col = np.maximum(np.abs(a_all).max(0), 1e-12).astype(np.float32)
    R = 16.0 if model == "logistic" else 4.0
    c64 = jch.sigmoid_prime_coeffs(15, R) if model == "logistic" else -jch.step_coeffs(15, R)
    c = c64.astype(np.float32)
    radius = R / np.linalg.norm(a_all, axis=1).max()
    x = np.zeros(8, np.float32)
    keys = jax.random.split(jax.random.PRNGKey(0), 32)
    for t in range(32):
        kb, kg = jax.random.split(keys[t])
        idx = np.asarray(jax.random.randint(kb, (16,), 0, 512))
        a, b = a_all[idx], b_all[idx]
        want = np.asarray(_JGRAD(jnp.asarray(c), jnp.asarray(x), jnp.asarray(a),
                                 jnp.asarray(b), kg, jnp.asarray(col)))
        got = tch.quantized_poly_gradient(_t(c), _t(x), _t(a), _t(b), 15, bridge_key(kg),
                                          scale=_t(col)).numpy()
        _close(got, want, POLY_TOL)
        x = np.asarray(jlin.prox_l2_ball(jnp.asarray(x - 0.4 * want), 0.4, radius=radius))


def _cut(mod, kind, n=512):
    """The preset's rows cut to ``n`` (make_dataset's presets ignore
    n_train for cod-rna and gisette)."""
    d = mod.make_dataset(kind, n_test=64)
    return mod.Dataset(d.a_train[:n], d.b_train[:n], d.a_test, d.b_test, d.name)


@pytest.fixture(scope="module")
def data():
    return {k: (_cut(jlin, k), _cut(tlin, k)) for k in ("cod-rna", "synthetic100")}


def _check(j, t):
    assert t.losses.shape == j.losses.shape and np.isfinite(t.losses).all()
    np.testing.assert_allclose(t.losses, j.losses, rtol=1e-4)
    np.testing.assert_allclose(t.x, j.x, rtol=0, atol=1e-4 * np.abs(j.x).max())


MODES = [("full", 8), ("nearest", 8), ("naive", 8), ("double", 4)]


@pytest.mark.parametrize("pairing", PAIRINGS)
@pytest.mark.parametrize("mode,bits", MODES)
@pytest.mark.parametrize("model", ["logistic", "svm"])
@pytest.mark.parametrize("kind", ["cod-rna", "synthetic100"])
def test_train_linear_chebyshev_models_match(data, kind, model, mode, bits, pairing):
    jb, tb = pairing
    jd, td = data[kind]
    lr, reg = (0.4, "none") if model == "logistic" else (0.2, "ball")
    j = jlin.train_linear(jd, JPlan(mode, sample_bits=bits, backend=jb), model=model,
                          epochs=2, lr=lr, reg=reg)
    t = tlin.train_linear(td, TPlan(mode, sample_bits=bits, backend=tb), model=model,
                          epochs=2, lr=lr, reg=reg, device="cpu")
    _check(j, t)
    assert t.extra is None and j.extra is None


@pytest.mark.parametrize("pairing", PAIRINGS)
@pytest.mark.parametrize("kind", ["cod-rna", "synthetic100"])
def test_train_linear_svm_refetch_matches(data, kind, pairing):
    jb, tb = pairing
    jd, td = data[kind]
    kw = dict(model="svm", epochs=3, lr=0.2, reg="ball", refetch="l1")
    j = jlin.train_linear(jd, JPlan("double", sample_bits=8, backend=jb), **kw)
    t = tlin.train_linear(td, TPlan("double", sample_bits=8, backend=tb), device="cpu", **kw)
    _check(j, t)
    assert t.extra == j.extra and len(t.extra["refetch_frac"]) == 3


def test_train_linear_e2e_chebyshev_and_custom_config(data):
    jd, td = data["cod-rna"]
    cfg = dict(degree=7, R=8.0, s=7)
    kw = dict(model="logistic", epochs=2, lr=0.4)
    j = jlin.train_linear(jd, JPlan("e2e", sample_bits=6, model_bits=8, grad_bits=8),
                          cheb=jch.ChebGradConfig(**cfg), **kw)
    t = tlin.train_linear(td, TPlan("e2e", sample_bits=6, model_bits=8, grad_bits=8),
                          cheb=tch.ChebGradConfig(**cfg), device="cpu", **kw)
    _check(j, t)


@pytest.fixture(scope="module")
def optimal_ref(data):
    """The reference's optimal-level runs, once per configuration (its DP
    loop takes ~12 s per 3-bit synthetic100 fit)."""
    out = {}
    for kind, bits in (("cod-rna", 3), ("cod-rna", 5), ("synthetic100", 3)):
        out[kind, bits] = jlin.train_linear(
            data[kind][0], JPlan("double", sample_bits=bits, optimal_levels=True),
            epochs=2, lr=0.1)
    return out


@pytest.mark.parametrize("backend", ["ref", "cuda"])
@pytest.mark.parametrize("kind,bits", [("cod-rna", 3), ("cod-rna", 5), ("synthetic100", 3)])
def test_train_linear_optimal_levels_match(data, optimal_ref, kind, bits, backend):
    t = tlin.train_linear(data[kind][1], TPlan("double", sample_bits=bits, optimal_levels=True,
                                               backend=backend), epochs=2, lr=0.1, device="cpu")
    _check(optimal_ref[kind, bits], t)


def test_optimal_level_planes_are_the_references_draws(data):
    """``_quantize_with_levels`` with its batched per-feature draw equals
    the reference's vmap over ``split(fold_in(key, 7), n)`` keys."""
    a = data["cod-rna"][0].a_train[:16].astype(np.float32)
    col = np.abs(a).max(0).astype(np.float32)
    levels = jlin.fit_feature_levels(data["cod-rna"][0].a_train, 3).astype(np.float32)
    jkey = jax.random.PRNGKey(11)
    want = jlin._quantize_with_levels(jnp.asarray(a), jnp.asarray(levels), jnp.asarray(col),
                                      jkey)
    got = tlin._quantize_with_levels(_t(a), _t(levels), _t(col), bridge_key(jkey))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_train_linear_rejects_unknown_model(data):
    with pytest.raises(ValueError):
        tlin.train_linear(data["cod-rna"][1], TPlan("full"), model="ridge", epochs=1,
                          device="cpu")


@pytest.mark.parametrize("mode", ["naive", "nearest"])
def test_refetch_of_a_straw_man_raises_as_in_the_reference(data, mode):
    """ROADMAP C13: the reference fails on ``refetch='l1'`` with a straw-man
    mode (it unpacks the plain gradient as a pair); the port says why."""
    jd, td = data["cod-rna"]
    with pytest.raises(ValueError):
        jlin.train_linear(jd, JPlan(mode, sample_bits=8), model="svm", epochs=1,
                          refetch="l1")
    with pytest.raises(ValueError, match="refetch"):
        tlin.train_linear(td, TPlan(mode, sample_bits=8), model="svm", epochs=1,
                          refetch="l1", device="cpu")
