"""Serving launcher of the port — a thin CLI over the continuous-batching
engine (port of ``repro.launch.serve``: the legacy ``serve``,
``make_trace``, ``serve_engine``, the multi-replica ``ReplicaSet`` with its
health machine, and ``main``).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma-2b \
      --device cpu --requests 4

serves a mixed-length synthetic trace at the reduced size on the CPU; on
the card (the default device) ``--no-reduced`` serves full-width gemma-2b
with random weights:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma-2b \
      --no-reduced --weight-bits 8 --kv-bits 8 --page-size 16 \
      --max-prompt 128 --max-new 32 --requests 8

Bitplane weights serve any precision from one artifact, and
self-speculative decoding drafts through their low-bit view (the output is
token-identical to vanilla decode):

  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma-2b \
      --device cpu --weight-bits 8 --kv-bits 8 --weight-layout bitplane \
      --spec-decode 3 --draft-bits 4

``--optimal-levels`` stores the weights on variance-optimal level tables
(§3.3; ``--weight-bits 8`` gives 255 levels per weight):

  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma-2b \
      --device cpu --requests 4 --weight-bits 8 --kv-bits 8 --optimal-levels

Legacy single-shot mode (``serve``: one fixed random prompt batch, prefill,
then greedy decode) serves every ported family. A dense model decodes on a
ring-buffer KV cache of prompt + gen rows, attending in plain PyTorch as the
reference does; mamba2-780m's prefill runs the SSD kernel, its decode the
O(1) recurrence on the (conv, ssm) cache, which the paged engine does not
take; the hybrid zamba2-2.7b runs both — its Mamba2 layers as mamba2's, its
shared attention block (after every 9 layers) on one ring KV cache of
prompt + gen rows per application, at ``--kv-bits``:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-14b \
      --device cpu --legacy --kv-bits 8 --weight-bits 8 --batch 2 \
      --prompt-len 16 --gen 8
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-780m \
      --device cpu --legacy --batch 2 --prompt-len 16 --gen 8
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-780m \
      --legacy --no-reduced --weight-bits 8 --batch 4 --prompt-len 1024 --gen 32
  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-2.7b \
      --device cpu --legacy --kv-bits 8 --weight-bits 8 --batch 2 \
      --prompt-len 16 --gen 8
  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-2.7b \
      --legacy --no-reduced --kv-bits 8 --weight-bits 8 --batch 4 \
      --prompt-len 1024 --gen 32

The moe granite-moe-3b-a800m serves through both: the paged engine, whose
steps take the MoE block's dense path (every expert on every token), and
the legacy loop, whose prefill above 512 tokens takes the
capacity-bounded dispatch; every stacked expert weight runs one ``qmm``
launch per expert slice on the card:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-moe-3b-a800m \
      --device cpu --requests 4 --weight-bits 8 --kv-bits 8
  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-moe-3b-a800m \
      --device cpu --legacy --weight-bits 8 --kv-bits 8 --batch 2 \
      --prompt-len 300 --gen 4
  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-moe-3b-a800m \
      --no-reduced --weight-bits 8 --kv-bits 8 --page-size 16 \
      --max-prompt 128 --max-new 32 --requests 8

mixtral-8x7b (8 experts, top 2, sliding window 4096) serves through the
legacy loop alone — the paged engine rejects windows, as the reference's
does: each layer's ring cache keeps the prompt's last ``window`` rows and
decode writes at ``length % window``, which holds the window only where
the prompt is longer than the window and a multiple of it (ROADMAP C24).
Its 46.6 B parameters fit the card only as int codes; every weight is
encoded a layer at a time as it is drawn:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch mixtral-8x7b \
      --device cpu --legacy --weight-bits 8 --kv-bits 8 --batch 2 \
      --prompt-len 64 --gen 8
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mixtral-8x7b \
      --legacy --no-reduced --weight-bits 8 --kv-bits 8 --batch 2 \
      --prompt-len 8192 --gen 32

llama-3.2-vision-11b (a cross-attention block over 4096 vision tokens
after every 5 of its 40 layers) serves through the legacy loop alone, as
in the reference, whose loop feeds it zero vision tokens (ROADMAP C25):
its cross K/V are cached raw in the compute dtype whatever ``--kv-bits``.
musicgen-medium (the audio family: the dense layer with a gelu MLP)
serves through both:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama-3.2-vision-11b \
      --device cpu --legacy --weight-bits 8 --kv-bits 8 --batch 2 \
      --prompt-len 16 --gen 8
  PYTHONPATH=src python -m repro_torch.launch.serve --arch musicgen-medium \
      --device cpu --requests 4

The engine's serving features: temperature / top-k sampling, chunked
prefill (``--chunk-pages``), the prefix cache (``--prefix-cache``), and
several engines behind one shared queue (``--replicas``, routed by
``--dispatch``; on one card every replica shares it):

  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma-2b \
      --device cpu --requests 8 --kv-bits 8 --prefix-cache --chunk-pages 2 \
      --temperature 0.8 --top-k 40 --replicas 2
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import time

import numpy as np
import torch

from repro_torch import configs, prng, resolve_device
from repro_torch.launch.steps import make_prefill_step, make_serve_step
from repro_torch.models import transformer as T
from repro_torch.precision.qat import quantize_param_tree, quantizing_store
from repro_torch.quant import PrecisionPlan
from repro_torch.serve.faults import ReplicaDeviceLost


def _resolve_plan(plan, kv_bits, weight_bits, optimal_levels=False) -> PrecisionPlan:
    if plan is None:
        plan = PrecisionPlan(kv_bits=kv_bits, model_bits=weight_bits,
                             model_storage="int" if weight_bits else "fake",
                             optimal_levels=optimal_levels)
    if plan.model_bits and plan.model_storage != "int":
        plan = dataclasses.replace(plan, model_storage="int")
    return plan


def _build(arch: str, *, reduced: bool, plan: PrecisionPlan, seed: int, device,
           weight_layout: str = "dense"):
    """The config and random weights from ``seed``. Int and bitplane
    weights are encoded a layer at a time as they are drawn
    (``quantizing_store``), so the compute-dtype tree never exists whole;
    variance-optimal level tables fit each whole leaf, so that build draws
    the tree first."""
    get = configs.get_reduced if reduced else configs.get_config
    cfg = get(arch, precision=plan)
    optimal = plan.optimal_levels and weight_layout == "dense"
    if plan.model_bits and not optimal:
        store = quantizing_store(plan.model_bits, layout=weight_layout)
        return cfg, T.init_params(cfg, seed=seed, device=device, weight=store)
    params = T.init_params(cfg, seed=seed, device=device)
    if plan.model_bits:
        params = quantize_param_tree(params, bits=plan.model_bits, optimal=True)
    return cfg, params


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def serve(arch: str, *, reduced: bool = True, batch: int = 4,
          prompt_len: int = 32, gen: int = 16, kv_bits: int = 0,
          weight_bits: int = 0, optimal_levels: bool = False, seed: int = 0,
          plan: PrecisionPlan | None = None, device=None):
    """Legacy single-shot serve on ``device`` (default ``cuda``): greedy-decode
    ``gen`` tokens for one random fixed-length prompt batch (the reference's
    ``randint(fold_in(PRNGKey(seed), 1))`` draw) with random weights from
    ``seed``. A warm-up decode step runs and is thrown away before the
    clock starts (``decode_step`` never writes into the state it is given).
    Returns (tokens (B, prompt+gen) numpy int32, steady-state tokens/s over
    the ``gen − 1`` timed steps; NaN when ``gen`` is 1).

    A dense, moe, audio or vlm model's ring cache, and each of a hybrid
    model's shared caches, holds ``prompt_len + gen`` rows, as the
    reference's; a sliding-window model's the last ``window`` prompt rows
    where the prompt is longer than the window. A vlm model attends zero
    vision tokens, as the reference's loop feeds it, so its cross blocks
    add exactly 0 (ROADMAP C25)."""
    dev = resolve_device(device)
    plan = _resolve_plan(plan, kv_bits, weight_bits, optimal_levels)
    cfg, params = _build(arch, reduced=reduced, plan=plan, seed=seed, device=dev)
    prompts = prng.randint(prng.fold_in(prng.PRNGKey(seed), 1), (batch, prompt_len),
                           0, cfg.vocab_size, device=dev)
    inputs = {"tokens": prompts}
    if cfg.family == "vlm":
        # the reference's legacy loop feeds zero vision tokens: every cross
        # k and v is then 0 and every cross block adds exactly 0 (ROADMAP C25)
        inputs["vision"] = torch.zeros((batch, cfg.n_vis_tokens, cfg.d_model),
                                       dtype=torch.float32, device=dev)
    logits, state = make_prefill_step(cfg, pad_to=prompt_len + gen)(params, inputs)
    next_tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
    step_fn = make_serve_step(cfg)
    step_fn(params, state, next_tok)                    # warm-up, thrown away
    _sync(dev)

    out = [prompts, next_tok]
    t0 = time.perf_counter()
    for _ in range(gen - 1):
        _, nxt, state = step_fn(params, state, out[-1])
        out.append(nxt[:, None])
    tokens = torch.cat(out, dim=1)
    _sync(dev)
    decode_s = time.perf_counter() - t0
    tps = batch * (gen - 1) / decode_s if gen > 1 else float("nan")
    return tokens.cpu().numpy(), tps


def make_trace(n_requests: int, vocab_size: int, *, max_new: int = 16,
               min_prompt: int = 4, max_prompt: int = 32, seed: int = 0,
               temperature: float = 0.0, top_k: int = 0):
    """A mixed-length synthetic request trace — the same numpy draws as the
    reference, so both engines serve identical requests."""
    from repro_torch.serve import Request

    rng = np.random.default_rng(seed)
    reqs = []
    for rid in range(n_requests):
        s = int(rng.integers(min_prompt, max_prompt + 1))
        g = int(rng.integers(max(1, max_new // 4), max_new + 1))
        reqs.append(Request(
            rid=rid, prompt=rng.integers(0, vocab_size, s),
            max_new_tokens=g, temperature=temperature, top_k=top_k, seed=seed))
    return reqs


@dataclasses.dataclass(frozen=True)
class HealthConfig:
    """Knobs of the per-replica health state machine: a step slower than
    ``step_deadline_s`` (on the injected clock) counts as a failure;
    ``dead_after`` consecutive failures declare the replica dead (healthy →
    suspect on the first); a restart is tried after a capped exponential
    backoff (``restart_backoff_s × 2^restarts``, at most ``backoff_cap_s``);
    after ``max_restarts`` attempts the replica is failed for good."""

    step_deadline_s: float = 30.0
    dead_after: int = 2
    restart_backoff_s: float = 0.5
    backoff_cap_s: float = 30.0
    max_restarts: int = 5

    def __post_init__(self):
        if self.step_deadline_s <= 0:
            raise ValueError(f"step_deadline_s must be > 0, got {self.step_deadline_s}")
        if self.dead_after < 1:
            raise ValueError(f"dead_after must be >= 1, got {self.dead_after}")
        if self.restart_backoff_s < 0 or self.backoff_cap_s < 0:
            raise ValueError("backoff times must be >= 0")
        if self.max_restarts < 0:
            raise ValueError(f"max_restarts must be >= 0, got {self.max_restarts}")


class ReplicaHealth:
    """One replica's health record: its state, failure counters, restart
    bookkeeping and the transitions ``(t, from, to, why)`` on the injected
    clock."""

    STATES = ("healthy", "suspect", "dead", "recovering", "failed")

    def __init__(self):
        self.state = "healthy"
        self.consecutive_failures = 0
        self.restarts = 0
        self.restart_at = 0.0
        self.last_error: str | None = None
        self.transitions: list[tuple] = []

    def to(self, state: str, now: float, why: str = "") -> None:
        if state not in self.STATES:
            raise ValueError(f"unknown health state {state!r}")
        if state != self.state:
            self.transitions.append((round(float(now), 6), self.state, state, why))
            self.state = state

    def __repr__(self):
        return (f"ReplicaHealth({self.state!r}, failures={self.consecutive_failures}, "
                f"restarts={self.restarts})")


class ReplicaSet:
    """N serving engines behind one shared submit queue (request-level data
    parallelism). Each replica is a full
    :class:`~repro_torch.serve.ServeEngine` with its own pool and prefix
    cache, built by ``factory(i)``; ``devices`` (torch devices) makes the
    replica's device current while it is built and stepped. On one card
    every replica shares it (and may share one weight tree).

    Dispatch (a replica with ``2 × max_slots`` requests in flight or queued
    takes no more): ``least_loaded`` (default); ``round_robin``; ``prefix``
    — the head request goes to the healthy replica whose trie holds its
    deepest page match, else to the least loaded.

    Faults: each replica has a :class:`ReplicaHealth` (healthy → suspect →
    dead → recovering, or failed for good) driven by step deadlines and
    consecutive failures on the injected ``clock``. A dead replica's
    in-flight and queued requests are harvested to the front of the shared
    queue and replay on survivors from prompt + committed tokens (the
    engine's recompute machinery: the outputs do not change). A restart
    rebuilds the engine through ``factory`` after a capped exponential
    backoff; with ``ship_dir`` the ``ship_truncate`` fault corrupts the
    artifact first. The only error a step absorbs is
    :class:`~repro_torch.serve.ReplicaDeviceLost`: any other — a kernel's
    build or launch error among them — propagates."""

    def __init__(self, factory, n_replicas: int, *, devices=None,
                 dispatch: str = "least_loaded", clock=None, fault_injector=None,
                 health: HealthConfig | None = None, ship_dir: str | None = None):
        if n_replicas < 1:
            raise ValueError(f"n_replicas must be >= 1, got {n_replicas}")
        if dispatch not in ("least_loaded", "round_robin", "prefix"):
            raise ValueError("dispatch must be 'least_loaded', 'round_robin' or "
                             f"'prefix', got {dispatch!r}")
        self.devices = [torch.device(d) for d in devices] if devices else None
        self.dispatch = dispatch
        self._factory = factory
        self._clock = clock if clock is not None else time.perf_counter
        self._faults = fault_injector
        self.health_cfg = health or HealthConfig()
        self.ship_dir = ship_dir
        self.engines = []
        for i in range(n_replicas):
            with self._device_ctx(i):
                self.engines.append(factory(i))
        if dispatch == "prefix" and any(e.prefix is None for e in self.engines):
            raise ValueError("dispatch='prefix' needs prefix_cache=True engines "
                             "(nothing to match against otherwise)")
        self._queue: collections.deque = collections.deque()
        self.dispatched = [0] * n_replicas
        self._rr = 0
        self._step_no = 0
        self.health = [ReplicaHealth() for _ in range(n_replicas)]
        self.stats = {"rejected": 0, "migrated": 0, "deaths": 0, "restarts": 0,
                      "step_failures": 0}

    def _device_ctx(self, i: int):
        if self.devices is None:
            return contextlib.nullcontext()
        dev = self.devices[i % len(self.devices)]
        return torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()

    def submit(self, req) -> None:
        """Queue a request, or reject it at once (``ValueError``, stat
        ``rejected``) when no replica could ever admit its shape."""
        prompt = np.asarray(req.prompt, np.int32).reshape(-1)
        reasons = {e.admit_impossible(prompt.size, req.max_new_tokens)
                   for e in self.engines}
        if None not in reasons:
            self.stats["rejected"] += 1
            raise ValueError(f"request {req.rid} rejected: no replica can ever admit "
                             f"it ({'; '.join(sorted(reasons))})")
        self._queue.append({"req": req, "prompt": prompt,
                            "replay": np.zeros((0,), np.int32),
                            "t_submit": self._clock(), "retries": 0})

    @property
    def n_pending(self) -> int:
        return len(self._queue) + sum(e.n_pending for e in self.engines)

    def _dispatch(self) -> None:
        n = len(self.engines)
        while self._queue:
            loads = [e.n_active + e.n_prefilling + e.n_pending for e in self.engines]
            ok = [self.health[j].state == "healthy"
                  and loads[j] < 2 * self.engines[j].max_slots for j in range(n)]
            if not any(self.health[j].state == "healthy" for j in range(n)):
                return
            i = None
            entry = self._queue[0]
            if self.dispatch == "prefix":
                prompt = np.asarray(entry["prompt"], np.int32).reshape(-1)
                best = 0
                for j, e in enumerate(self.engines):
                    if not ok[j] or e.prefix is None:
                        continue
                    depth = len(e.prefix.match(prompt))
                    if depth > best:
                        best, i = depth, j
            elif self.dispatch == "round_robin":
                for off in range(n):
                    j = (self._rr + off) % n
                    if self.health[j].state != "healthy":
                        continue          # the rotation skips dead replicas
                    if not ok[j]:
                        return            # a healthy target backlogged: wait
                    i = j
                    self._rr = j + 1
                    break
                if i is None:
                    return
            if i is None:                 # a miss: least loaded
                cand = [j for j in range(n) if ok[j]]
                if not cand:
                    return
                i = min(cand, key=lambda j: loads[j])
            with self._device_ctx(i):
                self.engines[i].submit_entry(self._queue.popleft())
            self.dispatched[i] += 1

    def step(self) -> dict:
        """One restart and dispatch pass, then one scheduler step of every
        busy live replica, with deadline and failure accounting."""
        self._step_no += 1
        self._maybe_skip_idle_wait()
        self._maybe_restart(self._clock())
        self._dispatch()
        finished = {}
        hc = self.health_cfg
        for i, eng in enumerate(self.engines):
            h = self.health[i]
            if h.state in ("dead", "recovering", "failed") or not eng.busy:
                continue
            t0 = self._clock()
            try:
                if self._faults is not None:
                    for sp in self._faults.poll("replica_stall", step=self._step_no,
                                                replica=i):
                        self._advance_or_sleep(sp.stall_s)
                    for sp in self._faults.poll("replica_raise", step=self._step_no,
                                                replica=i):
                        raise ReplicaDeviceLost(f"replica {i}: injected device loss "
                                                f"at set step {self._step_no}")
                with self._device_ctx(i):
                    for f in eng.step():
                        finished[f.rid] = f
            except ReplicaDeviceLost as e:
                self._record_failure(i, e)
                continue
            dt = self._clock() - t0
            if dt > hc.step_deadline_s:
                self._record_failure(i, TimeoutError(
                    f"replica {i}: step took {dt:.3f}s > deadline {hc.step_deadline_s}s"))
            else:
                h.consecutive_failures = 0
                if h.state == "suspect":
                    h.to("healthy", self._clock(), "step within deadline")
        return finished

    def _advance_or_sleep(self, dt: float) -> None:
        adv = getattr(self._clock, "advance", None)
        if adv is not None:
            adv(float(dt))                   # a virtual stall: no wall time
        else:
            time.sleep(float(dt))

    def _record_failure(self, i: int, err: BaseException) -> None:
        h = self.health[i]
        now = self._clock()
        h.consecutive_failures += 1
        h.last_error = f"{type(err).__name__}: {err}"
        self.stats["step_failures"] += 1
        if h.consecutive_failures >= self.health_cfg.dead_after:
            self._kill(i, now)
        elif h.state == "healthy":
            h.to("suspect", now, h.last_error)

    def _backoff(self, h: ReplicaHealth) -> float:
        hc = self.health_cfg
        return min(hc.backoff_cap_s, hc.restart_backoff_s * (2.0 ** h.restarts))

    def _kill(self, i: int, now: float) -> None:
        """Declare replica ``i`` dead: its in-flight and queued requests go
        back to the front of the shared queue (in order) to replay on
        survivors, and its restart is scheduled."""
        h = self.health[i]
        h.to("dead", now, h.last_error or "killed")
        self.stats["deaths"] += 1
        entries = self.engines[i].harvest()
        for e in reversed(entries):
            self._queue.appendleft(e)
        self.stats["migrated"] += len(entries)
        h.restart_at = now + self._backoff(h)

    def _maybe_restart(self, now: float) -> None:
        for i, h in enumerate(self.health):
            if h.state != "dead" or now < h.restart_at:
                continue
            if h.restarts >= self.health_cfg.max_restarts:
                h.to("failed", now, f"max_restarts={self.health_cfg.max_restarts} "
                                    f"exhausted; last error: {h.last_error}")
                continue
            h.to("recovering", now, "backoff elapsed")
            h.restarts += 1
            self.stats["restarts"] += 1
            if self._faults is not None and self.ship_dir is not None:
                from repro_torch.serve.faults import truncate_ship_artifact

                for _ in self._faults.poll("ship_truncate", step=self._step_no, replica=i):
                    truncate_ship_artifact(self.ship_dir)
            try:
                with self._device_ctx(i):
                    self.engines[i] = self._factory(i)
            except Exception as e:           # a bad artifact, no memory, ...: retry
                h.last_error = f"{type(e).__name__}: {e}"
                h.to("dead", self._clock(), f"restart failed: {h.last_error}")
                h.restart_at = self._clock() + self._backoff(h)
            else:
                h.consecutive_failures = 0
                h.to("healthy", self._clock(), "engine rebuilt")

    def _maybe_skip_idle_wait(self) -> None:
        """On a virtual clock with every replica down, jump to the earliest
        restart instead of spinning through empty steps."""
        adv = getattr(self._clock, "advance", None)
        if adv is None or any(h.state in ("healthy", "suspect") for h in self.health):
            return
        due = [h.restart_at for h in self.health if h.state == "dead"]
        if due and min(due) > self._clock():
            adv(min(due) - self._clock())

    def run(self, requests=None, max_steps: int = 100_000) -> dict:
        for r in requests or ():
            self.submit(r)
        out: dict = {}
        for _ in range(max_steps):
            if not self._queue and not any(e.busy for e in self.engines):
                return out
            if all(h.state == "failed" for h in self.health):
                errs = "; ".join(f"replica {i}: {h.last_error}"
                                 for i, h in enumerate(self.health))
                raise RuntimeError(f"all {len(self.health)} replicas failed permanently "
                                   f"with work outstanding — {errs}")
            before = self._progress()
            out.update(self.step())
            # a dead or recovering replica makes no progress while its
            # backoff runs down: a wait, not a stall
            if (self._progress() == before
                    and not any(h.state in ("dead", "recovering") for h in self.health)):
                raise RuntimeError("replica set stalled — no engine admitted, "
                                   "prefilled, decoded, or finished")
        raise RuntimeError(f"ReplicaSet.run exceeded {max_steps} steps")

    def _progress(self) -> tuple:
        return (len(self._queue), self.stats["step_failures"],
                tuple((h.state, h.consecutive_failures, h.restarts) for h in self.health),
                tuple((e.n_pending, e.n_active, e.n_prefilling, e.stats["decode_steps"],
                       e.stats["prefill_tokens"]) for e in self.engines))

    def stats_sum(self, key: str):
        return sum(e.stats[key] for e in self.engines)

    def throughput(self) -> float:
        """Aggregate steady-state decode tokens/s across replicas."""
        tps = [t for t in (e.throughput() for e in self.engines) if t == t]
        return sum(tps) if tps else float("nan")


def serve_engine(arch: str, *, reduced: bool = True, n_requests: int = 16,
                 max_new: int = 16, min_prompt: int = 4, max_prompt: int = 32,
                 kv_bits: int = 0, weight_bits: int = 0, seed: int = 0,
                 plan: PrecisionPlan | None = None, max_slots: int = 4,
                 page_size: int = 8, temperature: float = 0.0, top_k: int = 0,
                 backend: str | None = None, device=None, replicas: int = 1,
                 devices=None, dispatch: str = "least_loaded",
                 weight_layout: str = "dense", autoscale: bool = False,
                 slo_admit_ms: float | None = None, prefix_cache: bool = False,
                 chunk_pages: int | None = None, spec_decode: int = 0,
                 draft_bits: int | None = None, ship_dir: str | None = None,
                 optimal_levels: bool = False, clock=None, fault_injector=None,
                 health: HealthConfig | None = None, retry_budget: int = 32):
    """Serve a mixed-length trace through the engine on ``device`` (default
    ``cuda``) with random weights from ``seed``. Returns (engine or
    ReplicaSet, results dict rid → Finished).

    ``weight_layout='bitplane'`` stores the weights bit-serially (one
    artifact, any precision); ``autoscale=True`` then attaches a
    :class:`~repro_torch.serve.PrecisionAutoscaler` (SLO ``slo_admit_ms``,
    default ``$ZIPML_SLO_ADMIT_MS`` or 50 ms) over the bits ladder 8 → 4 →
    2 → 1 cut at ``weight_bits``; ``spec_decode=k, draft_bits=b`` turns on
    self-speculative decoding through the b-bit view; ``ship_dir`` writes
    the bitplane weights as a ``weights-bitplane-v1`` artifact there and
    builds every engine (restarts included) from the artifact loaded back.
    The last three need ``weight_layout='bitplane'`` with ``weight_bits >
    0``. ``optimal_levels=True`` stores the dense weights on
    variance-optimal level tables (§3.3). ``plan``, when given, overrides
    ``kv_bits``, ``weight_bits`` and ``optimal_levels``.
    ``temperature``/``top_k`` sample every request; ``prefix_cache`` and
    ``chunk_pages`` turn on prefix sharing and chunked prefill;
    ``retry_budget`` bounds a request's preemptions and migrations.
    ``replicas > 1`` serves the trace through a :class:`ReplicaSet`
    (``devices``: replica i on ``devices[i % len(devices)]``, default all on
    ``device`` sharing one weight tree; ``dispatch`` routes, ``health``
    tunes the state machine); ``clock`` and ``fault_injector`` go to every
    engine and the set."""
    from repro_torch.ckpt import load_ship_weights, save_ship_weights
    from repro_torch.serve import AutoscalerConfig, PrecisionAutoscaler, ServeEngine

    dev = resolve_device(device)
    plan = _resolve_plan(plan, kv_bits, weight_bits, optimal_levels)
    bitplane = weight_layout == "bitplane" and plan.model_bits
    if spec_decode and not bitplane:
        raise ValueError(
            "spec_decode needs --weight-layout bitplane with weight_bits > 0 "
            "(the draft is a slice_planes view of the served artifact)")
    if ship_dir is not None and not bitplane:
        raise ValueError("ship_dir needs --weight-layout bitplane with weight_bits > 0")
    if autoscale and not bitplane:
        raise ValueError("autoscale needs --weight-layout bitplane with weight_bits > 0")
    cfg, params = _build(arch, reduced=reduced, plan=plan, seed=seed, device=dev,
                         weight_layout=weight_layout)
    if ship_dir is not None:
        save_ship_weights(ship_dir, params)
        params = None
    devs = [resolve_device(d) for d in devices] if devices else [dev]

    def mk_autoscaler():
        if not autoscale:
            return None
        over = {} if slo_admit_ms is None else {"slo_admit_ms": slo_admit_ms}
        ladder = tuple(b for b in (8, 4, 2, 1) if b <= plan.model_bits)
        return PrecisionAutoscaler(AutoscalerConfig.from_env(bits_ladder=ladder, **over))

    def factory(i):
        d = devs[i % len(devs)]
        p = params if ship_dir is None else load_ship_weights(
            ship_dir, bits=plan.model_bits, device=d)
        return ServeEngine(p, cfg, plan=plan, max_slots=max_slots, page_size=page_size,
                           max_seq_len=max_prompt + max_new + page_size,
                           backend=backend, device=d, autoscaler=mk_autoscaler(),
                           prefix_cache=prefix_cache, chunk_pages=chunk_pages,
                           spec_decode=spec_decode, draft_bits=draft_bits, clock=clock,
                           fault_injector=fault_injector, replica_id=i,
                           retry_budget=retry_budget)

    trace = make_trace(n_requests, cfg.vocab_size, max_new=max_new,
                       min_prompt=min_prompt, max_prompt=max_prompt, seed=seed,
                       temperature=temperature, top_k=top_k)
    if replicas > 1:
        rs = ReplicaSet(factory, replicas, devices=devs if devices else None,
                        dispatch=dispatch, clock=clock, fault_injector=fault_injector,
                        health=health, ship_dir=ship_dir)
        return rs, rs.run(trace)
    engine = factory(0)
    return engine, engine.run(trace)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=configs.ARCH_IDS)
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=True, help="--no-reduced serves full width")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; cuda without a card raises")
    ap.add_argument("--kv-bits", type=int, default=0, choices=(0, 4, 8))
    ap.add_argument("--weight-bits", type=int, default=0,
                    help="0, 4 or 8 (dense layout); 1..8 with --weight-layout bitplane")
    ap.add_argument("--weight-layout", default="dense", choices=("dense", "bitplane"),
                    help="bitplane = bit-serial any-precision weight storage")
    ap.add_argument("--spec-decode", type=int, default=0, metavar="K",
                    help="speculative decoding: draft K tokens per slot through "
                         "the low-bit weight view, verify in one full-precision "
                         "step (needs bitplane layout)")
    ap.add_argument("--draft-bits", type=int, default=None,
                    help="weight bits of the speculative draft view (below the "
                         "serving bits)")
    ap.add_argument("--optimal-levels", action="store_true",
                    help="store the weights on variance-optimal level tables "
                         "(dense layout)")
    ap.add_argument("--autoscale", action="store_true",
                    help="adapt weight bits to load (needs bitplane layout)")
    ap.add_argument("--slo-admit-ms", type=float, default=None,
                    help="admission-latency SLO for --autoscale "
                         "(default $ZIPML_SLO_ADMIT_MS or 50)")
    ap.add_argument("--kernel-backend", default=None, choices=(None, "ref", "cuda"))
    ap.add_argument("--prefix-cache", action="store_true",
                    help="share page-aligned prompt prefixes across requests")
    ap.add_argument("--chunk-pages", type=int, default=None,
                    help="chunked prefill: pages per prefill chunk (interleaved "
                         "with decode)")
    ap.add_argument("--replicas", type=int, default=1,
                    help="engine replicas behind a shared submit queue")
    ap.add_argument("--dispatch", default="least_loaded",
                    choices=("least_loaded", "round_robin", "prefix"),
                    help="replica routing: prefix = route prompt families to the "
                         "replica owning their trie pages")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--min-prompt", type=int, default=4)
    ap.add_argument("--max-prompt", type=int, default=32)
    ap.add_argument("--max-slots", type=int, default=4)
    ap.add_argument("--page-size", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    # legacy single-shot mode
    ap.add_argument("--legacy", action="store_true",
                    help="fixed-batch greedy loop (ring KV cache, the ssm "
                         "recurrent cache, or the hybrid's both)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    args = ap.parse_args(argv)
    allowed = range(1, 9) if args.weight_layout == "bitplane" else (4, 8)
    if args.weight_bits and args.weight_bits not in allowed:
        ap.error(f"--weight-bits {args.weight_bits} is not servable with "
                 f"--weight-layout {args.weight_layout} (allowed: 0, "
                 f"{', '.join(map(str, allowed))})")

    if args.legacy:
        tokens, tps = serve(args.arch, reduced=args.reduced, batch=args.batch,
                            prompt_len=args.prompt_len, gen=args.gen,
                            kv_bits=args.kv_bits, weight_bits=args.weight_bits,
                            optimal_levels=args.optimal_levels, seed=args.seed,
                            device=args.device)
        print(f"[serve] generated {tokens.shape} tokens at {tps:.1f} tok/s "
              f"steady-state (kv_bits={args.kv_bits}, "
              f"weight_bits={args.weight_bits}) on {args.device}")
        return

    engine, results = serve_engine(
        args.arch, reduced=args.reduced, n_requests=args.requests,
        max_new=args.max_new, min_prompt=args.min_prompt,
        max_prompt=args.max_prompt, kv_bits=args.kv_bits,
        weight_bits=args.weight_bits, seed=args.seed, max_slots=args.max_slots,
        page_size=args.page_size, temperature=args.temperature, top_k=args.top_k,
        backend=args.kernel_backend, device=args.device, replicas=args.replicas,
        dispatch=args.dispatch, weight_layout=args.weight_layout,
        autoscale=args.autoscale, slo_admit_ms=args.slo_admit_ms,
        prefix_cache=args.prefix_cache, chunk_pages=args.chunk_pages,
        spec_decode=args.spec_decode, draft_bits=args.draft_bits,
        optimal_levels=args.optimal_levels)
    gen_total = sum(f.n_generated for f in results.values())
    if isinstance(engine, ReplicaSet):
        rs = engine
        print(f"[serve-engine] {len(results)} requests across {len(rs.engines)} "
              f"replicas, {gen_total} tokens generated (dispatch={rs.dispatched}) on "
              f"{rs.engines[0].device}")
        print(f"[serve-engine] aggregate steady-state decode: {rs.throughput():.1f} "
              f"tok/s; preemptions={rs.stats_sum('preemptions')}")
        for i, eng in enumerate(rs.engines):
            st = eng.stats
            line = (f"[serve-engine]   replica {i}: {st['decode_steps']} decode steps, "
                    f"{st['prefill_tokens']} prefill tokens [{rs.health[i].state}]")
            if args.prefix_cache:
                line += (f", prefix hits={st['prefix_hits']} "
                         f"({st['prefix_hit_tokens']} tokens skipped)")
            print(line)
        if any(rs.stats.values()):
            print(f"[serve-engine] fault tolerance: {rs.stats['deaths']} deaths, "
                  f"{rs.stats['migrated']} migrations, {rs.stats['restarts']} restarts, "
                  f"{rs.stats['step_failures']} step failures, "
                  f"{rs.stats['rejected']} rejected")
        return
    st = engine.stats
    print(f"[serve-engine] {len(results)} requests, {gen_total} tokens "
          f"generated in {st['decode_steps']} decode steps "
          f"(+{st['prefill_tokens']} prefill tokens) on {engine.device}")
    print(f"[serve-engine] steady-state decode: {engine.throughput():.1f} tok/s; "
          f"preemptions={st['preemptions']}")
    if args.prefix_cache:
        print(f"[serve-engine] prefix cache: {st['prefix_hits']} hits / "
              f"{st['prefix_misses']} misses, {st['prefix_hit_tokens']} prefill tokens "
              f"skipped ({engine.prefix.n_pages} pages cached)")
    if args.chunk_pages or args.prefix_cache:
        print(f"[serve-engine] chunked prefill: {st['prefill_chunks']} chunks, max "
              f"{st['max_prefill_tokens_per_step']} prefill tokens/step")
    print(f"[serve-engine] KV pool: {engine.kv_pool_nbytes():,} bytes "
          f"(kv_bits={args.kv_bits or 'bf16'}, page_size={args.page_size}) "
          f"via QTensor.nbytes")
    print(f"[serve-engine] weights: {engine.weight_nbytes():,} bytes "
          f"(layout={args.weight_layout}, served bits "
          f"{engine.weight_bits or args.weight_bits or 'bf16'})")
    if args.spec_decode:
        print(f"[serve-engine] speculative: {st['spec_steps']} windows, acceptance "
              f"{engine.acceptance_rate():.2f} (k={args.spec_decode}, "
              f"draft_bits={args.draft_bits})")
    if engine.autoscaler is not None:
        asc = engine.autoscaler
        print(f"[serve-engine] autoscaler: bits={asc.bits} after "
              f"{asc.n_observations} observations, {asc.n_moves} moves "
              f"(slo_admit_ms={asc.config.slo_admit_ms})")

if __name__ == "__main__":
    main()
