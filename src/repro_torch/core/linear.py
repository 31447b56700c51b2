"""ZipML linear-model suite — the paper's own loop (port of
``repro.core.linear``; §2, §4, §5, App. F, G).

    min_x  1/(2K) Σ l(a_kᵀx, b_k)² + R(x)
    x_{t+1} ← prox_{γR}( x_t − γ Q_g(g_k(Q_m(x_t), Q_s(a_t))) )

for the paper's four models under every ``PrecisionPlan.mode``: 'full'
(fp32), 'naive' (one quantization reused, the biased straw man), 'nearest'
(§5.4 deterministic rounding), 'double' (§2.2 double sampling) and 'e2e'
(samples, model and gradient quantized, App. E).

* linear regression and the least-squares SVM (App. F.1: the same gradient
  plus a c·x ridge term) take the LSQ gradients; ``double`` with
  ``optimal_levels`` quantizes every feature onto its own variance-optimal
  levels (§3, Fig. 7a);
* logistic regression and the SVM take Chebyshev polynomial gradients in
  'double'/'e2e' (§4, with the R-ball prox that keeps |aᵀx| ≤ R) and the
  §5.4 straw men in 'naive'/'nearest'; the SVM's ``refetch='l1'`` (App.
  G.4) refetches the rows whose margin sign a quantized sample cannot
  certify, and reports the refetched fraction per epoch.

The reference runs an epoch as ``jax.jit`` over ``lax.scan``; here it is a
Python loop on the device. Keys follow the reference exactly —
``PRNGKey(seed)``, a split per epoch, ``split(sub, steps)``, a split per
step into batch and gradient keys — so the batches and every quantization
draw are the reference's own. The batch indices of an epoch are drawn in
one go on the host; the uniform planes of the Chebyshev, straw-man and
optimal-level gradients are drawn for a chunk of steps in one batched
threefry call (each plane's bits depend only on its key); the loss is read
back once per epoch.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch import prng, resolve_device
from repro_torch.quant import PrecisionPlan

from . import optimal
from .chebyshev import (ChebGradConfig, poly_gradient_keys, quantized_poly_gradient,
                        sigmoid_prime_coeffs, step_coeffs)
from .double_sampling import (
    lsq_gradient_double_sampling,
    lsq_gradient_e2e,
    lsq_gradient_fullprec,
    lsq_gradient_naive_quant,
)
from .quantize import quantize_nearest, quantize_to_levels, stochastic_quantize

MODELS = ("linreg", "lssvm", "svm", "logistic")
PLANE_ELEMS = 1 << 24    # uniform-plane elements drawn per batched threefry call

# ---------------------------------------------------------------------------
# Datasets (pure numpy, the reference's exact RNG calls: identical arrays)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Dataset:
    a_train: np.ndarray
    b_train: np.ndarray
    a_test: np.ndarray
    b_test: np.ndarray
    name: str = "synthetic"

    @property
    def n_features(self) -> int:
        return self.a_train.shape[1]


def make_dataset(
    kind: str, n_train: int = 10_000, n_test: int = 10_000, n_features: int = 100,
    noise: float = 0.1, seed: int = 0, classification: bool = False,
) -> Dataset:
    """Synthetic proxies for Table 1 datasets.

    ``kind``: 'synthetic10'/'synthetic100'/'synthetic1000' (regression),
    'yearprediction' (90 features), 'cadata'(8), 'cpusmall'(12),
    'cod-rna'(8, classification), 'gisette'(5000, classification).
    """
    presets = {
        "synthetic10": (10, False), "synthetic100": (100, False),
        "synthetic1000": (1000, False), "yearprediction": (90, False),
        "cadata": (8, False), "cpusmall": (12, False),
        "cod-rna": (8, True), "gisette": (5000, True),
    }
    if kind in presets:
        n_features, classification = presets[kind]
        if kind == "gisette":
            n_train, n_test = 6000, 1000
        if kind == "cod-rna":
            n_train, n_test = 20000, 10000
    rng = np.random.default_rng(seed)
    n = n_train + n_test
    spectrum = np.linspace(1.0, 0.2, n_features)
    a = rng.uniform(-1, 1, (n, n_features)) * spectrum
    x_true = rng.normal(0, 1, n_features) / np.sqrt(n_features)
    logits = a @ x_true
    if classification:
        p = 1 / (1 + np.exp(-4 * logits / max(np.std(logits), 1e-9)))
        b = (rng.uniform(size=n) < p).astype(np.float64) * 2 - 1
    else:
        b = logits + noise * rng.normal(size=n)
    return Dataset(a[:n_train], b[:n_train], a[n_train:], b[n_train:], name=kind)


# ---------------------------------------------------------------------------
# Regularizers / prox operators (Eq. 2)
# ---------------------------------------------------------------------------

def prox_none(x, gamma):
    return x


def prox_l2(x, gamma, lam=1e-4):
    return x / (1.0 + gamma * lam)


def prox_l1(x, gamma, lam=1e-4):
    t = gamma * lam
    return torch.sign(x) * torch.clamp_min(x.abs() - t, 0.0)


def prox_l2_ball(x, gamma, radius=10.0):
    nrm = torch.linalg.vector_norm(x)
    return torch.where(nrm > radius, x * (radius / nrm), x)


PROX = {"none": prox_none, "l2": prox_l2, "l1": prox_l1, "ball": prox_l2_ball}


# ---------------------------------------------------------------------------
# Variance-optimal sample levels (§3, Fig. 7a)
# ---------------------------------------------------------------------------

def fit_feature_levels(a_train: np.ndarray, bits: int, method: str = "discretized",
                       max_features_exact: int = 2000) -> np.ndarray:
    """Per-feature variance-optimal levels (Fig. 7a: 'quantization points
    are calculated for each feature') → (n_features, s+1) in [0,1] units of
    the column scale. As in the reference, ``method`` is not read: every
    feature takes the discretized DP at M 128 (all features at once)."""
    s = 2**bits - 1
    scale = np.maximum(np.abs(a_train).max(axis=0), 1e-12)
    z = np.abs(a_train) / scale  # fold to [0,1]; signed handled by symmetric map
    return optimal.discretized_levels_batch(z, s, M=128)


def level_keys(key: torch.Tensor, n_features: int) -> torch.Tensor:
    """The per-feature keys of :func:`_quantize_with_levels`:
    ``split(fold_in(key, 7), n_features)``, for a key or a batch of keys."""
    return prng.split(prng.fold_in(key, 7), n_features)


def _quantize_with_levels(a, levels, scale, key, u=None):
    """Per-feature optimal-level quantization (signed, folded; unbiased).
    Feature f rounds |a[:, f]|/scale onto ``levels[f]`` with the uniform
    plane of its own key (``u`` (n, B): those planes, drawn beforehand)."""
    if u is None:
        u = prng.uniform(level_keys(key, a.shape[1]), (a.shape[0],), device=a.device)
    z = a.abs() / scale
    _, vals = quantize_to_levels(z.T, levels, u=u)
    return torch.sign(a) * vals.T * scale


# ---------------------------------------------------------------------------
# Gradients
# ---------------------------------------------------------------------------

def make_lsq_grad(prec: PrecisionPlan, sample_scale, levels=None):
    """Gradient fn(x, a, b, key, u) for least-squares objectives under
    ``prec``: the uniform-grid estimators draw from ``key``; ``double`` on
    ``levels`` reads ``u``, its (2, n, B) planes drawn beforehand from the
    keys of :func:`_plane_keys`."""

    def grad(x, a, b, key, u):
        if prec.mode == "full":
            return lsq_gradient_fullprec(x, a, b)
        if prec.mode == "naive":
            return lsq_gradient_naive_quant(x, a, b, prec.s_sample, key, scale=sample_scale)
        if prec.mode == "nearest":
            qa = quantize_nearest(a, prec.s_sample, scale=sample_scale).dequantize()
            return lsq_gradient_fullprec(x, qa, b)
        if prec.mode == "double":
            if levels is not None:
                q1 = _quantize_with_levels(a, levels, sample_scale, None, u[0])
                q2 = _quantize_with_levels(a, levels, sample_scale, None, u[1])
                B = a.shape[0]
                return (q1.T @ (q2 @ x - b) + q2.T @ (q1 @ x - b)) / (2.0 * B)
            return lsq_gradient_double_sampling(x, a, b, prec.s_sample, key,
                                                scale=sample_scale,
                                                backend=prec.backend)
        if prec.mode == "e2e":
            return lsq_gradient_e2e(x, a, b, prec.ds_config(), key,
                                    sample_scale=sample_scale,
                                    backend=prec.backend)
        raise ValueError(prec.mode)

    return grad


def _straw_man_samples(prec: PrecisionPlan, a, col_scale, u):
    """§5.4 straw men: nearest rounding, or one stochastic quantization."""
    if prec.mode == "nearest":
        return quantize_nearest(a, prec.s_sample, scale=col_scale).dequantize()
    return stochastic_quantize(a, prec.s_sample, None, scale=col_scale, u=u[0])


def make_logistic_grad(prec: PrecisionPlan, cheb: ChebGradConfig, coeffs, col_scale):
    """Gradient fn(x, a, b, key, u) of the logistic loss: exact ('full'),
    the straw men on quantized samples ('naive', 'nearest'), else the
    Chebyshev polynomial gradient. ``key`` is not read: every draw comes
    from ``u``, the step's planes drawn beforehand from the keys of
    :func:`_plane_keys`."""

    def grad(x, a, b, key, u):
        if prec.mode == "full":
            z = b * (a @ x)
            return (a * (b * (-torch.sigmoid(-z)))[:, None]).mean(0)
        if prec.mode in ("nearest", "naive"):
            qa = _straw_man_samples(prec, a, col_scale, u)
            z = b * (qa @ x)
            return (qa * (b * (-torch.sigmoid(-z)))[:, None]).mean(0)
        return quantized_poly_gradient(coeffs, x, a, b, cheb.s, None, scale=col_scale, u=u)

    return grad


def make_svm_grad(prec: PrecisionPlan, cheb: ChebGradConfig, coeffs, col_scale,
                  refetch: str | None):
    """Subgradient fn(x, a, b, key, u) of the hinge loss: exact ('full'),
    the straw men ('naive', 'nearest'), the App. G.4 ℓ1 refetch (returns
    the gradient and the refetched fraction of the batch), else the
    Chebyshev step polynomial. As for :func:`make_logistic_grad`, ``key``
    is not read and every draw comes from ``u``."""

    def grad(x, a, b, key, u):
        if prec.mode == "full":
            z = b * (a @ x)
            active = (z < 1.0).to(torch.float32)
            return (a * (-b * active)[:, None]).mean(0)
        if prec.mode in ("nearest", "naive"):
            qa = _straw_man_samples(prec, a, col_scale, u)
            z = b * (qa @ x)
            active = (z < 1.0).to(torch.float32)
            return (qa * (-b * active)[:, None]).mean(0)
        if refetch == "l1":
            # App. G.4: bounds on 1 − b aᵀx from one quantization; rows whose
            # margin sign the bound cannot certify take the exact subgradient
            qa = stochastic_quantize(a, prec.s_sample, None, scale=col_scale, u=u[0])
            margin_q = 1.0 - b * (qa @ x)
            slack = torch.sum(x.abs() * col_scale) / prec.s_sample
            certain = margin_q.abs() > slack
            active_q = (margin_q > 0).to(torch.float32)
            g_q = qa * (-b * active_q)[:, None]
            z = b * (a @ x)
            g_f = a * (-b * (z < 1.0).to(torch.float32))[:, None]
            g = torch.where(certain[:, None], g_q, g_f)
            return g.mean(0), (1.0 - certain.to(torch.float32)).mean()
        return quantized_poly_gradient(coeffs, x, a, b, cheb.s, None, scale=col_scale, u=u)

    return grad


def _plane_keys(model: str, prec: PrecisionPlan, cheb: ChebGradConfig,
                refetch: str | None, n_features: int, levels: bool):
    """How a step's uniform planes come from its gradient key: ``(keys_fn,
    P)`` with ``keys_fn(kg)`` mapping the (T, 2) gradient keys of T steps
    to their (T, P, 2) plane keys, or None where the step draws for itself
    (the LSQ estimators) or draws nothing."""
    mode = prec.mode
    if mode in ("full", "nearest"):
        return None
    if model in ("linreg", "lssvm"):
        if mode != "double" or not levels:
            return None
        # (k1, k2) = split(kg); feature f of qᵢ draws from split(fold_in(kᵢ, 7), n)[f]
        return (lambda kg: level_keys(prng.split(kg), n_features).reshape(
            kg.shape[0], 2 * n_features, 2)), 2 * n_features
    if mode == "naive":
        fold = 3 if model == "logistic" else 5
        return (lambda kg: prng.fold_in(kg, fold)[:, None]), 1
    if model == "svm" and refetch == "l1":        # k_q of (k_q, k_p) = split(kg)
        return (lambda kg: prng.split(kg)[:, :1]), 1
    if model == "svm":                            # the polynomial's planes from k_p
        return (lambda kg: poly_gradient_keys(prng.split(kg)[:, 1], cheb.degree)), \
            cheb.degree + 1
    return (lambda kg: poly_gradient_keys(kg, cheb.degree)), cheb.degree + 1


# ---------------------------------------------------------------------------
# Training driver
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TrainResult:
    x: np.ndarray
    losses: np.ndarray          # training loss per epoch
    extra: dict | None = None


def train_linear(
    ds: Dataset, prec: PrecisionPlan = PrecisionPlan(), *, model: str = "linreg",
    epochs: int = 20, batch: int = 16, lr: float = 0.1, reg: str = "none",
    ridge_c: float = 1e-3, seed: int = 0, cheb: ChebGradConfig | None = None,
    refetch: str | None = None, device="cuda",
) -> TrainResult:
    """SGD for ``model`` ∈ {'linreg', 'lssvm', 'svm', 'logistic'} with the
    diminishing step lr/epoch (paper §5 setup), on ``device`` (``"cpu"``
    runs the plain PyTorch path).

    svm/logistic in 'double'/'e2e' take Chebyshev polynomial gradients
    (``cheb``; default degree 15, R 16 for logistic, R 4 for the SVM) and
    the §4.2 R-ball prox; ``refetch='l1'`` turns on the SVM's App. G.4
    refetching, and ``extra={"refetch_frac": [...]}`` reports it per
    epoch."""
    if model not in MODELS:
        raise ValueError(model)
    if model == "svm" and refetch == "l1" and prec.mode in ("naive", "nearest"):
        # the reference fails here too, unpacking the straw man's gradient
        # as (gradient, fraction) (ROADMAP C13)
        raise ValueError(f"refetch='l1' refines the Chebyshev SVM: it needs mode "
                         f"'double' or 'e2e', not {prec.mode!r}")
    dev = resolve_device(device)
    a_np, b_np = ds.a_train, ds.b_train
    a = torch.as_tensor(a_np, dtype=torch.float32).to(dev)
    b = torch.as_tensor(b_np, dtype=torch.float32).to(dev)
    col_scale = torch.as_tensor(np.maximum(np.abs(a_np).max(axis=0), 1e-12),
                                dtype=torch.float32).to(dev)
    prox = PROX[reg]

    # the logistic optimum can have a large ‖x‖, so it needs a wide fit
    # range (R 16); the SVM's step fit degrades on wide ranges (R 4)
    if cheb is None:
        cheb = ChebGradConfig(R=16.0) if model == "logistic" else ChebGradConfig(R=4.0)

    # §4.2: constrain ‖x‖₂ so that |aᵀx| ≤ R, where the polynomial is valid
    if model in ("logistic", "svm") and prec.mode in ("double", "e2e"):
        a_norm_max = float(np.linalg.norm(a_np, axis=1).max())
        radius = cheb.R / max(a_norm_max, 1e-9)
        inner_prox = prox
        prox = lambda x, g: prox_l2_ball(inner_prox(x, g), g, radius=radius)  # noqa: E731

    levels = None
    if prec.optimal_levels and prec.mode == "double" and model in ("linreg", "lssvm"):
        levels = torch.as_tensor(
            fit_feature_levels(a_np, prec.sample_bits, prec.optimal_method),
            dtype=torch.float32).to(dev)

    ridge = ridge_c if model == "lssvm" else 0.0   # LS-SVM: ridge on ±1 labels
    lsq = model in ("linreg", "lssvm")
    if lsq:
        grad_fn = make_lsq_grad(prec, col_scale, levels)

        def loss_fn(x):
            r = a @ x - b
            return 0.5 * torch.mean(r * r) + 0.5 * ridge * torch.sum(x * x)
    elif model == "logistic":
        coeffs = torch.as_tensor(sigmoid_prime_coeffs(cheb.degree, cheb.R),
                                 dtype=torch.float32).to(dev)
        grad_fn = make_logistic_grad(prec, cheb, coeffs, col_scale)

        def loss_fn(x):
            z = b * (a @ x)
            return torch.mean(torch.logaddexp(torch.zeros_like(z), -z))
    else:
        # ℓ'(z) = −H(1 − z): the negated step fit
        coeffs = torch.as_tensor(-step_coeffs(cheb.degree, cheb.R, cheb.delta),
                                 dtype=torch.float32).to(dev)
        grad_fn = make_svm_grad(prec, cheb, coeffs, col_scale, refetch)

        def loss_fn(x):
            return torch.mean(torch.clamp_min(1.0 - b * (a @ x), 0.0))

    n = a.shape[0]
    steps = max(n // batch, 1)
    refetch_mode = model == "svm" and refetch == "l1" and prec.mode != "full"
    draw = _plane_keys(model, prec, cheb, refetch, ds.n_features, levels is not None)
    plane_keys, chunk = None, steps
    if draw is not None:
        plane_keys, n_planes = draw
        shape = (batch,) if levels is not None else (batch, ds.n_features)
        chunk = max(1, PLANE_ELEMS // (n_planes * math.prod(shape)))
    x = torch.zeros(ds.n_features, dtype=torch.float32, device=dev)
    key = prng.PRNGKey(seed)
    losses, refetch_fracs = [], []
    for ep in range(epochs):
        key, sub = prng.split(key)
        gamma = lr / (ep + 1.0)
        step_keys = prng.split(prng.split(sub, steps))    # (steps, 2, 2)
        kg = step_keys[:, 1]
        idx = prng.randint(step_keys[:, 0], (batch,), 0, n).to(dev)
        rf = torch.zeros((), dtype=torch.float32, device=dev)
        for t0 in range(0, steps, chunk):
            t1 = min(steps, t0 + chunk)
            planes = None
            if plane_keys is not None:
                planes = prng.uniform(plane_keys(kg[t0:t1]), shape, device=dev)
                if levels is not None:
                    planes = planes.reshape(t1 - t0, 2, ds.n_features, batch)
            for t in range(t0, t1):
                i = idx[t]
                u = None if planes is None else planes[t - t0]
                g = grad_fn(x, a[i], b[i], kg[t], u)
                if refetch_mode:
                    g, frac = g
                    rf = rf + frac
                if lsq:
                    g = g + ridge * x
                x = prox(x - gamma * g, gamma)
        refetch_fracs.append(float(rf / steps))
        losses.append(float(loss_fn(x)))
    extra = {"refetch_frac": refetch_fracs} if refetch_mode else None
    return TrainResult(x.cpu().numpy(), np.asarray(losses), extra)


def eval_accuracy(ds: Dataset, x: np.ndarray) -> float:
    pred = np.sign(ds.a_test @ x)
    return float((pred == np.sign(ds.b_test)).mean())


def eval_mse(ds: Dataset, x: np.ndarray) -> float:
    r = ds.a_test @ x - ds.b_test
    return float(0.5 * np.mean(r * r))
