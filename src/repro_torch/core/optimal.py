"""C4 — variance-optimal quantization levels (port of ``repro.core.optimal``;
ZipML §3, App. H/I). Pure numpy, run once at set-up time.

Given an empirical distribution Ω = {x_1..x_N} ⊂ [0,1], choose s+1 levels
(s intervals) minimizing the mean stochastic-rounding variance

    MV(I) = (1/N) Σ_j Σ_{x∈I_j} (b_j − x)(x − a_j).

* ``optimal_levels_exact``       — O(kN²) DP over the data points (Lemma 3).
* ``optimal_levels_discretized`` — histogram into M buckets, DP over the M+1
                                   bucket edges (Thm 2: error O(1/Mk)).
* ``adaquant``                   — App. I greedy merge, the candidates of
                                   ``optimal_levels_2approx``.

Every result equals the reference's array for array. The discretized DP
keeps the reference's float64 operations per element — V(j, m) =
(a+b)·ΔC1 − a·b·n − ΔC2, then T[k−1, j] + V — but evaluates all j of a
column at once, and all features at once in :func:`discretized_levels_batch`:
the reference's triple Python loop takes ~6 s per 8-bit weight tensor at
M 256. The minimum's first index is the reference's strict ``<`` scan; an
empty column keeps parent 0. The grid k/M is searched as the reference
searches it, so its defect stays (ROADMAP C7: at s 3, M 64 neither 1/3 nor
2/3 is a candidate). The exact and 2-approx solvers stay loops.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np


class _Prefix(NamedTuple):
    xs: np.ndarray       # sorted values
    c1: np.ndarray       # prefix sum of x    (c1[i] = sum xs[:i])
    c2: np.ndarray       # prefix sum of x^2


def _prefix(xs: np.ndarray) -> _Prefix:
    xs = np.sort(np.asarray(xs, np.float64))
    return _Prefix(xs, np.concatenate([[0.0], np.cumsum(xs)]),
                   np.concatenate([[0.0], np.cumsum(xs * xs)]))


def _interval_err(p: _Prefix, i: int, j: int, a: float, b: float) -> float:
    """Σ_{x in xs[i:j]} (b-x)(x-a) using prefix sums — O(1)."""
    cnt = j - i
    if cnt <= 0:
        return 0.0
    s1 = p.c1[j] - p.c1[i]
    s2 = p.c2[j] - p.c2[i]
    return (a + b) * s1 - a * b * cnt - s2


def mean_variance(xs: np.ndarray, levels: np.ndarray) -> float:
    """MV(I): mean stochastic-quantization variance of xs under ``levels``."""
    p = _prefix(xs)
    levels = np.sort(np.asarray(levels, np.float64))
    total = 0.0
    idx = np.searchsorted(p.xs, levels)
    for k in range(len(levels) - 1):
        total += _interval_err(p, idx[k], idx[k + 1], levels[k], levels[k + 1])
    return total / max(len(p.xs), 1)


def _candidate_dp(p: _Prefix, cand: np.ndarray, s: int) -> np.ndarray:
    """The O(s·C²) DP over candidate endpoints ``cand`` (the reference's
    loop, shared by the exact and 2-approx solvers); levels with the ends
    pinned to 0 and 1."""
    cidx = np.searchsorted(p.xs, cand)
    C = len(cand)

    def V(j: int, m: int) -> float:
        return _interval_err(p, cidx[j], cidx[m], cand[j], cand[m])

    INF = float("inf")
    T = np.full((s + 1, C), INF)
    parent = np.zeros((s + 1, C), np.int64)
    T[0, 0] = 0.0
    for k in range(1, s + 1):
        for m in range(1, C):
            best, bestj = INF, 0
            for j in range(0, m):
                if T[k - 1, j] == INF:
                    continue
                val = T[k - 1, j] + V(j, m)
                if val < best:
                    best, bestj = val, j
            T[k, m] = best
            parent[k, m] = bestj
    levels = [cand[C - 1]]
    m = C - 1
    for k in range(s, 0, -1):
        m = parent[k, m]
        levels.append(cand[m])
    levels = np.array(levels[::-1])
    levels[0], levels[-1] = 0.0, 1.0  # cover the full range
    return levels


def optimal_levels_exact(xs: np.ndarray, s: int) -> np.ndarray:
    """Exact O(kN²) DP (App. H): s+1 levels in [0,1], endpoints ⊂ Ω ∪ {0,1}."""
    p = _prefix(np.clip(xs, 0.0, 1.0))
    cand = np.unique(np.concatenate([[0.0], p.xs, [1.0]]))
    return _candidate_dp(p, cand, s)


def discretized_levels_batch(z: np.ndarray, s: int, M: int = 256,
                             chunk_elems: int = 1 << 22) -> np.ndarray:
    """``optimal_levels_discretized`` of every column of ``z`` (N, F) at
    once → (F, s+1), equal to the per-column calls."""
    z = np.clip(np.asarray(z, np.float64), 0.0, 1.0)
    if z.ndim != 2:
        raise ValueError(f"z must be (N, F), got {z.shape}")
    n, F = z.shape
    if n == 0:
        return np.tile(np.linspace(0.0, 1.0, s + 1), (F, 1))
    edges = np.linspace(0.0, 1.0, M + 1)
    # per-feature bucket counts and moments: one bincount over feature-major
    # offsets accumulates each bucket in row order, as the 1-D calls do
    zt = np.ascontiguousarray(z.T)
    which = np.clip((zt * M).astype(np.int64), 0, M - 1)
    flat = (which + np.arange(F)[:, None] * M).ravel()
    cnt = np.bincount(flat, minlength=F * M).astype(np.float64).reshape(F, M)
    s1 = np.bincount(flat, weights=zt.ravel(), minlength=F * M).reshape(F, M)
    s2 = np.bincount(flat, weights=(zt * zt).ravel(), minlength=F * M).reshape(F, M)
    zero = np.zeros((F, 1))
    C1 = np.concatenate([zero, np.cumsum(s1, axis=1)], axis=1)
    C2 = np.concatenate([zero, np.cumsum(s2, axis=1)], axis=1)
    CN = np.concatenate([zero, np.cumsum(cnt, axis=1)], axis=1)
    out = np.empty((F, s + 1))
    step = max(1, chunk_elems // ((M + 1) * (M + 1)))
    for f0 in range(0, F, step):
        sl = slice(f0, min(F, f0 + step))
        out[sl] = _discretized_dp(C1[sl], C2[sl], CN[sl], edges, s, M)
    return out


def _discretized_dp(C1, C2, CN, edges, s: int, M: int) -> np.ndarray:
    """The discretized DP for a block of features (prefix sums (F, M+1));
    levels (F, s+1)."""
    F = C1.shape[0]
    a = edges[None, :, None]                 # edges[j]   (j on axis 1)
    b = edges[None, None, :]                 # edges[m]   (m on axis 2)
    # V[f, j, m] = (a+b)·(C1[m]−C1[j]) − a·b·n − (C2[m]−C2[j]), op for op
    n = CN[:, None, :] - CN[:, :, None]
    V = (a + b) * (C1[:, None, :] - C1[:, :, None]) - a * b * n \
        - (C2[:, None, :] - C2[:, :, None])
    INF = float("inf")
    T = np.full((s + 1, F, M + 1), INF)
    parent = np.zeros((s + 1, F, M + 1), np.int64)
    T[0, :, 0] = 0.0
    j_idx = np.arange(M + 1)
    for k in range(1, s + 1):
        lo = k - 1
        # vals[f, j, m] over j in [lo, m); T[k−1, j] = inf is skipped by the
        # reference, and inf + finite V stays inf, so it never wins
        vals = T[k - 1][:, :, None] + V
        vals = np.where((j_idx[:, None] >= lo) & (j_idx[:, None] < j_idx[None, :]),
                        vals, INF)
        vals = np.where(np.isnan(vals), INF, vals)
        best = np.argmin(vals, axis=1)                       # first minimum
        bval = np.take_along_axis(vals, best[:, None, :], axis=1)[:, 0, :]
        found = bval < INF
        T[k] = np.where(found, bval, INF)
        parent[k] = np.where(found, best, 0)
        T[k, :, 0] = INF
        parent[k, :, 0] = 0
    levels = np.empty((F, s + 1))
    levels[:, s] = 1.0
    m = np.full(F, M)
    rows = np.arange(F)
    for k in range(s, 0, -1):
        m = parent[k, rows, m]
        levels[:, k - 1] = edges[m]
    return levels


def optimal_levels_discretized(xs: np.ndarray, s: int, M: int = 256) -> np.ndarray:
    """§3.2 heuristic: one pass to histogram into M buckets, DP over the
    M+1 bucket edges. O((s+1)M² + N); error O(1/Ms) by Thm 2."""
    xs = np.asarray(xs, np.float64)
    if len(xs) == 0:
        return np.linspace(0.0, 1.0, s + 1)
    return discretized_levels_batch(xs.reshape(-1, 1), s, M)[0]


def adaquant(xs: np.ndarray, k: int, gamma: float = 1.0, delta: int = 2) -> np.ndarray:
    """App. I greedy merging — ADAQUANT(Ω, k, γ, δ): ≤ 2(1+γ)k+δ intervals
    with err ≤ (1+1/γ)·OPT_k (Thm 9). Returns the endpoint array."""
    p = _prefix(np.clip(xs, 0.0, 1.0))
    pts = np.unique(np.concatenate([[0.0], p.xs, [1.0]]))
    target = int(2 * (1 + gamma) * k + delta)
    while len(pts) - 1 > target:
        # pair up consecutive intervals -> candidate merged intervals
        ends = pts
        merged_err = []
        merged = []  # (start_idx_in_pts, end_idx_in_pts)
        i = 0
        while i + 2 < len(ends):
            a, b = ends[i], ends[i + 2]
            ia, ib = np.searchsorted(p.xs, a), np.searchsorted(p.xs, b)
            merged_err.append(_interval_err(p, ia, ib, a, b))
            merged.append((i, i + 2))
            i += 2
        if not merged:
            break
        merged_err = np.asarray(merged_err)
        keep_split = set()
        n_split = min(int((1 + gamma) * k), len(merged))
        for idx in np.argsort(merged_err)[::-1][:n_split]:
            keep_split.add(idx)
        new_pts = [ends[0]]
        for mi, (i0, i1) in enumerate(merged):
            if mi in keep_split:
                new_pts.append(ends[i0 + 1])
            new_pts.append(ends[i1])
        if len(ends) % 2 == 0:  # odd interval count leaves a trailing interval
            new_pts.append(ends[-1])
        pts = np.unique(np.asarray(new_pts))
    return pts


def optimal_levels_2approx(xs: np.ndarray, s: int, gamma: float = 1.0) -> np.ndarray:
    """ADAQUANT candidates + the DP restricted to them: a 2-approximation in
    O(N log N + s·c²)."""
    cand = adaquant(xs, s, gamma=gamma)
    return _candidate_dp(_prefix(np.clip(xs, 0.0, 1.0)), cand, s)


def _solver(method: str, M: int):
    return {"exact": optimal_levels_exact,
            "discretized": lambda d, k: optimal_levels_discretized(d, k, M),
            "2approx": optimal_levels_2approx}[method]


def fit_levels(data, s: int, method: str = "discretized", M: int = 256,
               symmetric: bool = False) -> np.ndarray:
    """Fit s-interval optimal levels to arbitrary-range data, returned in
    the data's units (affine unmap of the [0,1] solution). ``symmetric``
    fits s//2 intervals on |x| and mirrors them around 0 (§3.3's Optimal5
    weight quantizer)."""
    x = np.asarray(data, np.float64).ravel()
    x = x[np.isfinite(x)]
    if x.size == 0:
        return np.linspace(-1.0 if symmetric else 0.0, 1.0, s + 1)
    if symmetric:
        hi = np.max(np.abs(x)) or 1.0
        lv = _solver(method, M)(np.abs(x) / hi, max(s // 2, 1))
        pos = lv * hi
        return np.unique(np.concatenate([-pos[::-1], pos]))
    lo, hi = float(np.min(x)), float(np.max(x))
    span = (hi - lo) or 1.0
    lv = _solver(method, M)((x - lo) / span, s)
    return lv * span + lo


def uniform_levels(s: int, lo: float = 0.0, hi: float = 1.0) -> np.ndarray:
    """The baseline the paper beats: s+1 uniformly spaced levels."""
    return np.linspace(lo, hi, s + 1)
