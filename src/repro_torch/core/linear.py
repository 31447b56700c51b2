"""ZipML linear-model suite — the paper's own loop (port of
``repro.core.linear``; §2, §5, App. F).

    min_x  1/(2K) Σ (a_kᵀx − b_k)² + R(x)
    x_{t+1} ← prox_{γR}( x_t − γ Q_g(g_k(Q_m(x_t), Q_s(a_t))) )

for linear regression and the least-squares SVM (App. F.1: the same
gradient plus a c·x ridge term) under every ``PrecisionPlan.mode``:
'full' (fp32), 'naive' (one quantization reused, the biased straw man),
'nearest' (§5.4 deterministic rounding), 'double' (§2.2 double sampling)
and 'e2e' (samples, model and gradient quantized, App. E).

The reference runs an epoch as ``jax.jit`` over ``lax.scan``; here it is a
Python loop on the device. Keys follow the reference exactly —
``PRNGKey(seed)``, a split per epoch, ``split(sub, steps)``, a split per
step into batch and gradient keys — so the batches and every quantization
draw are the reference's own. The batch indices of an epoch are drawn in
one go on the host; the loss is read back once per epoch.

The SVM and logistic models (Chebyshev gradients, ``refetch``) and
variance-optimal levels raise ``NotImplementedError`` naming their ROADMAP
items.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import prng, resolve_device
from repro_torch.quant import PrecisionPlan

from .double_sampling import (
    lsq_gradient_double_sampling,
    lsq_gradient_e2e,
    lsq_gradient_fullprec,
    lsq_gradient_naive_quant,
)
from .quantize import quantize_nearest

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
# Gradients
# ---------------------------------------------------------------------------

def make_lsq_grad(prec: PrecisionPlan, sample_scale):
    """Gradient fn(x, a, b, key) for least-squares objectives under ``prec``."""

    def grad(x, a, b, key):
        if prec.mode == "full":
            return lsq_gradient_fullprec(x, a, b)
        if prec.mode == "naive":
            return lsq_gradient_naive_quant(x, a, b, prec.s_sample, key, scale=sample_scale)
        if prec.mode == "nearest":
            qa = quantize_nearest(a, prec.s_sample, scale=sample_scale).dequantize()
            return lsq_gradient_fullprec(x, qa, b)
        if prec.mode == "double":
            return lsq_gradient_double_sampling(x, a, b, prec.s_sample, key,
                                                scale=sample_scale,
                                                backend=prec.backend)
        if prec.mode == "e2e":
            return lsq_gradient_e2e(x, a, b, prec.ds_config(), key,
                                    sample_scale=sample_scale,
                                    backend=prec.backend)
        raise ValueError(prec.mode)

    return grad


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
    ridge_c: float = 1e-3, seed: int = 0, cheb=None, refetch: str | None = None,
    device="cuda",
) -> TrainResult:
    """SGD for ``model`` ∈ {'linreg', 'lssvm'} with the diminishing step
    lr/epoch (paper §5 setup), on ``device`` (``"cpu"`` runs the plain
    PyTorch path). ``cheb`` only shapes the Chebyshev models and is ignored
    here, as in the reference."""
    if model in ("svm", "logistic"):
        raise NotImplementedError(
            f"model {model!r} needs the Chebyshev gradients (ROADMAP A2.2)")
    if model not in ("linreg", "lssvm"):
        raise ValueError(model)
    if refetch is not None:
        raise NotImplementedError("refetch is an SVM option (ROADMAP A2.2)")
    if prec.optimal_levels and prec.mode == "double":
        raise NotImplementedError(
            "variance-optimal sample levels are not ported yet (ROADMAP A2.3)")
    dev = resolve_device(device)
    a_np, b_np = ds.a_train, ds.b_train
    a = torch.as_tensor(a_np, dtype=torch.float32).to(dev)
    b = torch.as_tensor(b_np, dtype=torch.float32).to(dev)
    col_scale = torch.as_tensor(np.maximum(np.abs(a_np).max(axis=0), 1e-12),
                                dtype=torch.float32).to(dev)
    prox = PROX[reg]
    base_grad = make_lsq_grad(prec, col_scale)
    ridge = ridge_c if model == "lssvm" else 0.0   # LS-SVM: ridge on ±1 labels

    def loss_fn(x):
        r = a @ x - b
        return 0.5 * torch.mean(r * r) + 0.5 * ridge * torch.sum(x * x)

    n = a.shape[0]
    steps = max(n // batch, 1)
    x = torch.zeros(ds.n_features, dtype=torch.float32, device=dev)
    key = prng.PRNGKey(seed)
    losses = []
    for ep in range(epochs):
        key, sub = prng.split(key)
        gamma = lr / (ep + 1.0)
        step_keys = prng.split(prng.split(sub, steps))    # (steps, 2, 2)
        kg = step_keys[:, 1]
        idx = prng.randint(step_keys[:, 0], (batch,), 0, n).to(dev)
        for t in range(steps):
            i = idx[t]
            g = base_grad(x, a[i], b[i], kg[t]) + ridge * x
            x = prox(x - gamma * g, gamma)
        losses.append(float(loss_fn(x)))
    return TrainResult(x.cpu().numpy(), np.asarray(losses))


def eval_accuracy(ds: Dataset, x: np.ndarray) -> float:
    pred = np.sign(ds.a_test @ x)
    return float((pred == np.sign(ds.b_test)).mean())


def eval_mse(ds: Dataset, x: np.ndarray) -> float:
    r = ds.a_test @ x - ds.b_test
    return float(0.5 * np.mean(r * r))
