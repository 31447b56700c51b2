"""Deterministic fault injection for the serving stack (port of
``repro.serve.faults``).

Every failure the serving fleet must survive — a replica raising mid-step
(device loss), a stalled step, non-finite logits for one request, bit
flips in KV code planes, a truncated ship artifact — is injectable as a
seeded event addressed by scheduler step, so a chaos trace replays bit for
bit on the injected clock.

* :class:`VirtualClock` — an injectable clock (``clock()`` reads,
  ``advance`` moves), the protocol ``ServeEngine(clock=)`` and the
  autoscaler use: a "30 s stall" costs no wall time.
* :class:`FaultSpec` / :class:`FaultInjector` — the armed fault list.
  Components poll it at their seam (``poll(kind, step=, replica=)``); each
  spec fires exactly once, at the first poll whose step reaches
  ``at_step`` on its replica, and lands in the ``fired`` log.
* :func:`flip_bits` / :func:`corrupt_kv_page` — seeded bit flips in KV
  code planes (the prefix trie's checksums are their adversary).
* :func:`truncate_ship_artifact` — cut a committed artifact's
  ``arrays.npz`` short (``load_ship_weights`` must raise cleanly).

Fault kinds and where they fire: ``replica_raise`` (ReplicaSet: the
replica's step raises :class:`ReplicaDeviceLost`), ``replica_stall``
(ReplicaSet: ``stall_s`` elapse inside the step), ``nan_logits``
(ServeEngine: request ``rid``'s logits read as non-finite → quarantine),
``kv_flip`` (ServeEngine: ``n_flips`` seeded flips in pool page ``page``
or a seeded pick of an allocated page), ``ship_truncate`` (ReplicaSet:
applied to ``ship_dir`` before a restart).
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

FAULT_KINDS = ("replica_raise", "replica_stall", "nan_logits", "kv_flip",
               "ship_truncate")


class ReplicaDeviceLost(RuntimeError):
    """An injected replica device loss surfaced from ``step()``."""


class VirtualClock:
    """A deterministic injectable clock: ``clock()`` reads, ``advance``
    moves (forward only)."""

    def __init__(self, t0: float = 0.0):
        self._t = float(t0)

    def __call__(self) -> float:
        return self._t

    def advance(self, dt: float) -> None:
        if dt < 0:
            raise ValueError(f"clocks only move forward, got dt={dt}")
        self._t += float(dt)


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One armed fault: ``kind`` fires once at the first poll of matching
    ``replica`` whose scheduler step reaches ``at_step``. ``rid`` targets
    one request (``nan_logits``); ``page`` one pool page (``kv_flip``; None
    = a seeded pick of an allocated page); ``stall_s`` is the injected step
    duration (``replica_stall``); ``seed`` drives every random choice."""

    kind: str
    at_step: int
    replica: int = 0
    rid: int | None = None
    page: int | None = None
    stall_s: float = 0.0
    n_flips: int = 1
    seed: int = 0

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; expected one of "
                             f"{FAULT_KINDS}")
        if self.at_step < 0:
            raise ValueError(f"at_step must be >= 0, got {self.at_step}")


class FaultInjector:
    """The armed fault list components poll at their seams.
    ``poll(kind, step=, replica=)`` returns and disarms the specs of that
    kind due now (``step >= at_step``, and ``spec.replica == replica``
    unless ``replica`` is None); each firing is appended to ``fired``
    (kind, step, replica, clock time, spec) — the replayable chaos trace."""

    def __init__(self, specs=(), *, clock=None):
        self._armed: list[FaultSpec] = [
            sp if isinstance(sp, FaultSpec) else FaultSpec(**sp) for sp in specs]
        self.clock = clock
        self.fired: list[dict] = []

    @property
    def n_armed(self) -> int:
        return len(self._armed)

    def arm(self, spec: FaultSpec) -> None:
        self._armed.append(spec)

    def poll(self, kind: str, *, step: int, replica: int | None = None) -> list[FaultSpec]:
        if kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {kind!r}")
        due, rest = [], []
        for sp in self._armed:
            if (sp.kind == kind and step >= sp.at_step
                    and (replica is None or sp.replica == replica)):
                due.append(sp)
                self.fired.append({
                    "kind": kind, "step": int(step), "replica": replica,
                    "t": self.clock() if self.clock is not None else None,
                    "spec": sp})
            else:
                rest.append(sp)
        self._armed = rest
        return due


def flip_bits(arr: np.ndarray, n_flips: int = 1, seed: int = 0) -> np.ndarray:
    """A copy of ``arr`` with ``n_flips`` seeded single-bit flips at
    uniformly random bit positions (byte-granular XOR, any dtype)."""
    out = np.ascontiguousarray(np.asarray(arr)).copy()
    flat = out.reshape(-1).view(np.uint8)
    rng = np.random.default_rng(seed)
    for pos in rng.integers(0, flat.size * 8, size=int(n_flips)):
        flat[pos // 8] ^= np.uint8(1 << (pos % 8))
    return out


def corrupt_kv_page(pool, page: int, *, n_flips: int = 4, seed: int = 0):
    """Flip ``n_flips`` seeded bits in pool page ``page``'s K code plane
    (all layers, the same bytes the reference flips), in place; returns the
    pool."""
    page = int(page)
    if not 0 <= page < pool.n_pages:
        raise ValueError(f"page {page} outside pool of {pool.n_pages}")
    plane = pool.k_pages[:, page]
    raw = plane.contiguous().cpu().view(torch.uint8).numpy()
    flipped = torch.from_numpy(flip_bits(raw, n_flips=n_flips, seed=seed))
    plane.copy_(flipped.view(plane.dtype).to(plane.device))
    return pool


def truncate_ship_artifact(directory: str, keep_bytes: int = 128) -> str:
    """Truncate a committed ship artifact's ``arrays.npz`` to
    ``keep_bytes``, leaving its ``.complete`` marker: corruption after the
    commit, which only a clean loader error can surface."""
    path = os.path.join(directory, "arrays.npz")
    size = os.path.getsize(path)
    if keep_bytes >= size:
        raise ValueError(f"keep_bytes={keep_bytes} >= file size {size} — nothing truncated")
    with open(path, "r+b") as f:
        f.truncate(int(keep_bytes))
    return path


__all__ = ["FAULT_KINDS", "FaultInjector", "FaultSpec", "ReplicaDeviceLost",
           "VirtualClock", "corrupt_kv_page", "flip_bits", "truncate_ship_artifact"]
