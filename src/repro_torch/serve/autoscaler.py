"""Load-adaptive precision governor for the serving engine (port of
``repro.serve.autoscaler``; pure Python, the same decisions on the same
observations).

Bit-plane weights (``repro_torch.quant`` ``layout='bitplane'``) make serving
precision a *runtime dial*: ``QTensor.slice_planes(k)`` is a zero-copy view
of the top-k magnitude planes, so the engine can drop weight bits under
pressure — decode streams (k+1)/(B+1) of the code bytes, no weight reload,
no repacking — and restore them when the burst passes. Self-speculative
decoding (``ServeEngine(spec_decode=k, draft_bits=b)``) reuses the same
views for its draft pass; the two compose, with two engine-side rules:
rung moves are actuated at the top of ``step()`` only — never inside a
draft/verify window, so a window always runs under one weight precision —
and whenever the governor has walked the serving bits down to or below
``draft_bits`` the engine falls back to vanilla decode (a draft at-or-above
the target's precision predicts nothing the target step wouldn't).

This module is the control loop. :class:`PrecisionAutoscaler` watches the
admission signal the engine already measures (head-of-line queue wait, queue
depth) against an SLO and walks a bits ladder (default 8→4→2→1) with
hysteresis. Under chunked prefill the engine's ``queue_depth`` counts
queued requests **plus** slots still chunk-prefilling — admitted-but-not-
yet-decoding work is load the governor must see, or a burst of long
prompts would read as an empty queue. The engine may also *defer* acting
on the returned bits while a preemption replay is in flight (replayed KV
must be rebuilt under the original weights); the governor itself is
oblivious — it keeps observing every step and the rung move lands on the
first replay-free step:

* ``breach_patience`` consecutive SLO breaches → drop one rung (fewer bits,
  faster decode, more admission throughput).
* ``restore_patience`` consecutive *healthy* observations — wait under
  ``restore_frac × slo`` — → restore one rung.
* anything in between (the dead band) resets both counters, so the governor
  never oscillates across the SLO boundary.

Every rung move is appended to ``decisions`` — a **ring buffer** of the
last ``decision_log_max`` moves (a long-running serve loop must not grow
its audit log unboundedly; ``n_moves`` keeps the lifetime count) — for
offline audit/replay. Time is injected via ``observe(..., now=)`` so tests
run on a virtual clock.

The governor is engine-agnostic on purpose: it maps observations → bits and
nothing else. The engine owns the actuation (``ServeEngine.set_weight_bits``
swaps in the cached per-k sliced param tree).
"""
from __future__ import annotations

import collections
import dataclasses
import os

SLO_ENV = "ZIPML_SLO_ADMIT_MS"           # default admission-latency SLO (ms)


@dataclasses.dataclass(frozen=True)
class AutoscalerConfig:
    """Knobs for :class:`PrecisionAutoscaler`.

    ``slo_admit_ms`` — the admission-latency SLO: head-of-line queue wait a
    request may accumulate before the governor calls it a breach.
    ``bits_ladder`` — precisions to walk, most→least bits; every entry must
    be servable by the weights' ``slice_planes`` (≤ their stored bits).
    ``queue_high`` — optional depth guard: a queue deeper than this breaches
    even before its head's wait crosses the SLO (None disables).
    """

    slo_admit_ms: float = 50.0
    bits_ladder: tuple[int, ...] = (8, 4, 2, 1)
    breach_patience: int = 2
    restore_patience: int = 4
    restore_frac: float = 0.5
    queue_high: int | None = None
    decision_log_max: int = 256

    def __post_init__(self):
        if self.slo_admit_ms <= 0:
            raise ValueError(f"slo_admit_ms must be > 0, got {self.slo_admit_ms}")
        if not self.bits_ladder:
            raise ValueError("bits_ladder must not be empty")
        if list(self.bits_ladder) != sorted(set(self.bits_ladder), reverse=True):
            raise ValueError(
                f"bits_ladder must be strictly decreasing, got {self.bits_ladder}")
        if not 0.0 < self.restore_frac < 1.0:
            raise ValueError(
                f"restore_frac must be in (0, 1) — it is the hysteresis dead "
                f"band's lower edge — got {self.restore_frac}")
        if self.breach_patience < 1 or self.restore_patience < 1:
            raise ValueError("patience counts must be >= 1")
        if self.decision_log_max < 1:
            raise ValueError(
                f"decision_log_max must be >= 1, got {self.decision_log_max}")

    @classmethod
    def from_env(cls, **overrides) -> "AutoscalerConfig":
        """Config with ``slo_admit_ms`` from ``$ZIPML_SLO_ADMIT_MS`` (if set);
        explicit keyword overrides win."""
        env = os.environ.get(SLO_ENV)
        if env and "slo_admit_ms" not in overrides:
            overrides["slo_admit_ms"] = float(env)
        return cls(**overrides)


class PrecisionAutoscaler:
    """Maps (admit wait, queue depth) observations → serving weight bits.

    Stateless w.r.t. the engine: call :meth:`observe` once per scheduler
    step and actuate when the returned bits change. ``decisions`` logs every
    rung move as ``{"t", "admit_wait_ms", "queue_depth", "bits", "action"}``.
    """

    def __init__(self, config: AutoscalerConfig | None = None):
        self.config = config or AutoscalerConfig.from_env()
        self._idx = 0                        # rung: index into bits_ladder
        self._breach = 0
        self._healthy = 0
        self.n_observations = 0
        # bounded audit trail: a long-running serve loop observes every
        # step forever, so the log is a ring buffer of the last
        # ``decision_log_max`` rung moves; ``n_moves`` keeps the lifetime
        # count after old entries age out
        self.decisions: collections.deque = collections.deque(
            maxlen=self.config.decision_log_max)
        self.n_moves = 0

    @property
    def bits(self) -> int:
        return self.config.bits_ladder[self._idx]

    def observe(self, *, admit_wait_ms: float, queue_depth: int = 0,
                now: float | None = None) -> int:
        """One control-loop tick; returns the bits to serve the next batch."""
        cfg = self.config
        self.n_observations += 1
        deep = cfg.queue_high is not None and queue_depth > cfg.queue_high
        breach = admit_wait_ms > cfg.slo_admit_ms or deep
        healthy = (admit_wait_ms < cfg.restore_frac * cfg.slo_admit_ms
                   and not deep)
        if breach:
            self._healthy = 0
            self._breach += 1
            if (self._breach >= cfg.breach_patience
                    and self._idx + 1 < len(cfg.bits_ladder)):
                self._idx += 1
                self._breach = 0
                self._log("drop", admit_wait_ms, queue_depth, now)
        elif healthy:
            self._breach = 0
            self._healthy += 1
            if self._healthy >= cfg.restore_patience and self._idx > 0:
                self._idx -= 1
                self._healthy = 0
                self._log("restore", admit_wait_ms, queue_depth, now)
        else:                                # dead band: hold the rung
            self._breach = 0
            self._healthy = 0
        return self.bits

    def _log(self, action: str, wait_ms: float, depth: int,
             now: float | None) -> None:
        self.n_moves += 1
        self.decisions.append({
            "t": now, "admit_wait_ms": round(float(wait_ms), 3),
            "queue_depth": int(depth), "bits": self.bits, "action": action})


__all__ = ["SLO_ENV", "AutoscalerConfig", "PrecisionAutoscaler"]
