"""Deterministic host-sharded token streams with resumable cursors (port of
``repro.data.pipeline``: ``Cursor``, ``TokenStreamConfig``, ``TokenStream``;
numpy only, so batches are identical to the reference's).

Determinism contract: batch i of host h is a pure function of (seed, i, h),
so restore-from-checkpoint = set cursor. The paper's pre-quantized
``QuantizedSampleStore`` belongs to the linear-model path and is not ported.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class Cursor:
    """Checkpointable pipeline position."""
    step: int = 0
    epoch: int = 0

    def to_dict(self):
        return {"step": self.step, "epoch": self.epoch}

    @staticmethod
    def from_dict(d):
        return Cursor(int(d["step"]), int(d["epoch"]))


@dataclasses.dataclass(frozen=True)
class TokenStreamConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_hosts: int = 1
    host_id: int = 0
    # synthetic stream statistics: zipf-ish unigram + short-range repetition,
    # so the loss has learnable structure
    zipf_a: float = 1.2
    repeat_p: float = 0.3


class TokenStream:
    """Deterministic, host-sharded synthetic LM token stream."""

    def __init__(self, cfg: TokenStreamConfig, cursor: Cursor = Cursor()):
        self.cfg = cfg
        self.cursor = cursor
        ranks = np.arange(1, cfg.vocab_size + 1, dtype=np.float64)
        probs = ranks ** -cfg.zipf_a
        self._probs = probs / probs.sum()
        if cfg.global_batch % cfg.n_hosts:
            raise ValueError("global_batch must divide across hosts")
        self._host_batch = cfg.global_batch // cfg.n_hosts

    def _batch_at(self, step: int) -> dict:
        cfg = self.cfg
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, step, cfg.host_id]))
        b, s = self._host_batch, cfg.seq_len
        toks = rng.choice(cfg.vocab_size, size=(b, s + 1), p=self._probs)
        # short-range repetition: with prob p, copy the token 2 back
        rep = rng.random((b, s + 1)) < cfg.repeat_p
        toks[:, 2:] = np.where(rep[:, 2:], toks[:, :-2], toks[:, 2:])
        return {"tokens": toks[:, :-1].astype(np.int32),
                "targets": toks[:, 1:].astype(np.int32)}

    def __iter__(self) -> Iterator[dict]:
        while True:
            yield self.next_batch()

    def next_batch(self) -> dict:
        batch = self._batch_at(self.cursor.step)
        self.cursor = Cursor(self.cursor.step + 1, self.cursor.epoch)
        return batch

    def skip_to(self, cursor: Cursor):
        self.cursor = cursor
