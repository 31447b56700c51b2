"""Continuous-batching serving engine over the paged quantized KV pool
(port of ``repro.serve.engine``, slice 1).

Scheduling is the reference's: ``submit()`` queues requests FIFO; ``step()``
admits what fits (``reserve='full'``: a request takes its worst-case page
count up front, so nothing is ever evicted), prefills each admission
monolithically at its page-bucketed prompt length, then runs one batched
greedy decode step over every live slot.

* **prefill** runs the model with raw K/V (``kv_bits=0``); the post-RoPE
  rows are then quantized per (token, head) into the request's pages.
* **decode** embeds each slot's last token, and per layer appends the new
  K/V row into the slot's current page (inactive slots write to the null
  page 0) *before* attending, through the ``paged_attention`` registry op —
  the hand-written CUDA kernel on the card. ``new_lens = pos + active``.

On the card the whole path runs the ``cuda`` backend: every quantized
matmul is the ``qmm`` kernel and every decode attention the
``paged_decode_attn`` kernel. Prefix caching, chunked prefill, speculative
decoding, the autoscaler, fault injection, ``reserve='none'`` and sampling
(``temperature > 0``) raise ``NotImplementedError`` until ROADMAP A8.

``stats['decode_seconds']`` is steady state only: the first decode call
(kernel build and load, library warm-up) is not billed.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.kernels import registry
from repro_torch.models import attention as attn
from repro_torch.models import transformer as T
from repro_torch.models.layers import dense, embed
from repro_torch.quant import PrecisionPlan, tree_nbytes
from repro_torch.serve import pages as pg

SUPPORTED_FAMILIES = ("dense",)


@dataclasses.dataclass(frozen=True)
class Request:
    """One serving request. ``temperature<=0`` → greedy; ``eos_id=None`` →
    length-only stopping."""

    rid: int
    prompt: Any                      # 1-D int array-like of token ids
    max_new_tokens: int = 16
    temperature: float = 0.0
    top_k: int = 0
    eos_id: int | None = None
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class Finished:
    rid: int
    tokens: np.ndarray               # prompt + generated, 1-D int32
    prompt_len: int
    n_generated: int
    reason: str                      # 'eos' | 'length'


def _not_ported(what: str):
    raise NotImplementedError(f"{what} is not in slice 1 of the port (ROADMAP A8)")


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device)


class ServeEngine:
    def __init__(self, params, cfg, *, plan: PrecisionPlan | None = None,
                 max_slots: int = 4, page_size: int = 8,
                 max_seq_len: int = 128, n_pages: int | None = None,
                 reserve: str = "full", backend: str | None = None,
                 device=None, autoscaler=None, clock=None,
                 prefix_cache: bool = False, chunk_pages: int | None = None,
                 spec_decode: int = 0, draft_bits: int | None = None,
                 fault_injector=None):
        if cfg.family not in SUPPORTED_FAMILIES:
            raise NotImplementedError(
                f"ServeEngine serves {SUPPORTED_FAMILIES} in slice 1, got "
                f"{cfg.family!r} (ROADMAP A5)")
        if cfg.window:
            raise ValueError("sliding-window models are not paged yet")
        if reserve == "none":
            _not_ported("reserve='none' (preemption and replay)")
        if reserve != "full":
            raise ValueError(f"reserve must be 'full' or 'none', got {reserve!r}")
        for flag, what in ((prefix_cache, "prefix_cache"),
                           (chunk_pages is not None, "chunk_pages"),
                           (spec_decode, "spec_decode"),
                           (draft_bits is not None, "draft_bits"),
                           (autoscaler is not None, "autoscaler"),
                           (fault_injector is not None, "fault_injector")):
            if flag:
                _not_ported(what)
        self.device = resolve_device(device)
        plan = plan if plan is not None else cfg.precision
        self.cfg = dataclasses.replace(cfg, precision=plan)
        # prefill runs with kv_bits=0: it returns the raw post-RoPE K/V,
        # which the pool quantizes page-wise itself
        self._cfg_fp = dataclasses.replace(
            cfg, precision=dataclasses.replace(plan, kv_bits=0))
        self.params = _to_device(params, self.device)
        self._layers = T.layer_views(self.params, self.cfg)
        self.backend = backend
        self.page_size = int(page_size)
        self.max_slots = int(max_slots)
        self.max_seq_len = int(max_seq_len)
        self.max_pages_per_seq = pg.pages_needed(max_seq_len, page_size)
        if n_pages is None:
            n_pages = self.max_slots * self.max_pages_per_seq + 1
        self.allocator = pg.PageAllocator(n_pages)
        self.pool = pg.init_pool(
            cfg.n_layers, n_pages, page_size, cfg.n_kv_heads, cfg.head_dim,
            kv_bits=plan.kv_bits, dtype=cfg.dtype, device=self.device)

        B, MP = self.max_slots, self.max_pages_per_seq
        self._bt = np.zeros((B, MP), np.int32)
        self._lens = np.zeros((B,), np.int32)
        self._active = np.zeros((B,), bool)
        self._last_tok = np.zeros((B,), np.int32)
        self._slots: list[dict | None] = [None] * B
        self._queue: collections.deque = collections.deque()
        self._warm = False
        self.stats = {"admitted": 0, "finished": 0, "decode_steps": 0,
                      "decode_tokens": 0, "decode_seconds": 0.0,
                      "steady_decode_tokens": 0, "prefill_tokens": 0,
                      "admit_wait_seconds": 0.0}
        self.admit_waits: list[float] = []
        self.decode_times: list[float] = []
        self._clock = clock if clock is not None else time.perf_counter

    # ------------------------------------------------------------ device fns
    def _prefill(self, tokens: np.ndarray, last_pos: int, page_ids: list[int]):
        """Prefill one page-bucketed prompt and write its pages; returns the
        logits (V,) at ``last_pos``."""
        toks = torch.as_tensor(tokens, dtype=torch.int64, device=self.device)[None]
        with registry.using(self.backend):
            logits, (k, v) = T.prefill(self.params, toks, self._cfg_fp,
                                       last_pos=last_pos, layers=self._layers)
        ids = torch.as_tensor(page_ids, dtype=torch.int64, device=self.device)
        pg.write_prompt(self.pool, k[:, 0], v[:, 0], ids)
        return logits[0]

    def decode_logits(self, tokens, positions, block_table, active):
        """One batched decode step over every slot: append each slot's K/V
        row, attend its pages, return the (B, V) f32 logits. Host arrays in,
        device logits out."""
        cfg, spec, dev = self.cfg, self.cfg.attn_spec, self.device
        page = self.page_size
        pos_np = np.asarray(positions, np.int32)
        act_np = np.asarray(active, bool)
        bt_np = np.asarray(block_table, np.int32)
        page_ids = np.where(act_np, bt_np[np.arange(len(pos_np)), pos_np // page], 0)
        host = np.stack([np.asarray(tokens, np.int32), pos_np,
                         page_ids.astype(np.int32), pos_np % page,
                         pos_np + act_np.astype(np.int32)])
        tok, pos, pids, offs, new_lens = torch.from_numpy(host).to(dev).unbind(0)
        bt = torch.from_numpy(bt_np).to(dev)
        b = pos.shape[0]
        with registry.using(self.backend):
            kb = registry.get(device=dev)
            x = embed(self.params["embed"], tok[:, None]).to(cfg.dtype)
            for li, layer in enumerate(self._layers):
                kp, vp, ks, vs = self.pool.layer(li)

                def attend(z, layer=layer, kp=kp, vp=vp, ks=ks, vs=vs):
                    q, k, v = attn.decode_qkv(layer["attn"], z, spec, pos[:, None])
                    pg.append_rows(kp, vp, ks, vs, k[:, 0], v[:, 0], pids, offs)
                    out = kb.paged_attention(q[:, 0], kp, vp, ks, vs, bt, new_lens,
                                             softmax_scale=spec.scale)
                    return dense(layer["attn"]["o"],
                                 out.reshape(b, 1, spec.n_heads * spec.head_dim))

                x = T.decode_layer_block(cfg, layer, x, attend)
            return T.final_logits(self.params, cfg, x)[:, 0]

    # ----------------------------------------------------------------- API
    def submit(self, req: Request) -> None:
        if req.temperature > 0:
            _not_ported("sampling with temperature > 0 (needs the threefry port)")
        prompt = np.asarray(req.prompt, np.int32).reshape(-1)
        why = self.admit_impossible(prompt.size, req.max_new_tokens)
        if why is not None:
            raise ValueError(f"request {req.rid} can never fit: {why}")
        self._queue.append({"req": req, "prompt": prompt,
                            "t_submit": self._clock()})

    def admit_impossible(self, prompt_len: int, max_new_tokens: int) -> str | None:
        prompt_len = int(prompt_len)
        if prompt_len == 0:
            return "empty prompt"
        if prompt_len >= self.max_seq_len:
            return (f"prompt of {prompt_len} tokens needs max_seq_len > "
                    f"that (engine has {self.max_seq_len})")
        worst = pg.pages_needed(min(prompt_len + max_new_tokens, self.max_seq_len),
                                self.page_size)
        if worst > self.allocator.n_pages - 1:
            return f"needs {worst} pages, pool has {self.allocator.n_pages - 1}"
        return None

    @property
    def n_active(self) -> int:
        return int(self._active.sum())

    @property
    def busy(self) -> bool:
        return bool(self._queue) or any(s is not None for s in self._slots)

    def kv_pool_nbytes(self) -> int:
        """Logical KV HBM bytes of the pool (QTensor.nbytes accounting)."""
        return pg.pool_nbytes(self.pool)

    def weight_nbytes(self) -> int:
        """Logical HBM bytes of the served params (QTensor.nbytes accounting)."""
        return tree_nbytes(self.params)

    # ------------------------------------------------------------- scheduler
    def _budget(self, entry) -> int:
        return min(entry["req"].max_new_tokens,
                   self.max_seq_len - len(entry["prompt"]))

    def _bucket(self, s: int) -> int:
        return pg.pages_needed(max(s, 1), self.page_size) * self.page_size

    def _admit(self, finished: list) -> None:
        while self._queue:
            slot = next((i for i, s in enumerate(self._slots) if s is None), None)
            if slot is None:
                return
            entry = self._queue[0]
            prompt = entry["prompt"]
            s = int(prompt.size)
            budget = self._budget(entry)
            n_res = pg.pages_needed(min(s + budget, self.max_seq_len), self.page_size)
            ids = self.allocator.alloc(max(n_res, pg.pages_needed(s + 1, self.page_size)))
            if ids is None:
                return                             # FIFO head-of-line wait
            self._queue.popleft()
            wait = max(0.0, self._clock() - entry["t_submit"])
            self.stats["admit_wait_seconds"] += wait
            self.admit_waits.append(wait)
            self._bt[slot] = 0
            self._bt[slot, :len(ids)] = ids
            self._slots[slot] = {"req": entry["req"], "prompt": prompt, "gen": [],
                                 "pages": ids}
            self.stats["admitted"] += 1
            bucket = self._bucket(s)
            padded = np.zeros((bucket,), np.int32)
            padded[:s] = prompt
            logits = self._prefill(padded, s - 1, ids[:bucket // self.page_size])
            self._lens[slot] = s
            self.stats["prefill_tokens"] += s
            tok = int(torch.argmax(logits))
            self._slots[slot]["gen"] = [tok]
            self._active[slot] = True
            self._last_tok[slot] = tok
            self._maybe_finish(slot, finished)

    def _maybe_finish(self, slot: int, finished: list) -> bool:
        state = self._slots[slot]
        req = state["req"]
        n_gen = len(state["gen"])
        reason = None
        if req.eos_id is not None and state["gen"][-1] == req.eos_id:
            reason = "eos"
        elif n_gen >= self._budget(state) \
                or len(state["prompt"]) + n_gen >= self.max_seq_len:
            reason = "length"
        if reason is None:
            return False
        self.allocator.free(state["pages"])
        self._active[slot] = False
        self._bt[slot] = 0
        self._lens[slot] = 0
        self._slots[slot] = None
        self.stats["finished"] += 1
        finished.append(Finished(
            rid=req.rid, tokens=np.concatenate(
                [state["prompt"], np.asarray(state["gen"], np.int32)]),
            prompt_len=len(state["prompt"]), n_generated=n_gen, reason=reason))
        return True

    def step(self) -> list[Finished]:
        """One scheduler iteration: admit what fits, then decode one token
        for every live sequence. Returns the requests that finished."""
        finished: list[Finished] = []
        self._admit(finished)
        if not self._active.any():
            return finished
        for slot in np.flatnonzero(self._active):   # reserve='full' owns them
            if self._bt[slot, self._lens[slot] // self.page_size] == 0:
                raise RuntimeError(f"slot {slot} has no page for row {self._lens[slot]}")
        t0 = self._clock()
        logits = self.decode_logits(self._last_tok, self._lens, self._bt, self._active)
        tok_np = torch.argmax(logits, dim=-1).to(torch.int32).cpu().numpy()
        dt = self._clock() - t0
        n_live = int(self._active.sum())
        self.stats["decode_steps"] += 1
        self.stats["decode_tokens"] += n_live
        if self._warm:                         # steady state: first call excluded
            self.stats["decode_seconds"] += dt
            self.stats["steady_decode_tokens"] += n_live
            self.decode_times.append(dt)
        self._warm = True
        for slot in np.flatnonzero(self._active):
            tok = int(tok_np[slot])
            self._lens[slot] += 1
            self._slots[slot]["gen"].append(tok)
            self._last_tok[slot] = tok
            self._maybe_finish(slot, finished)
        return finished

    def run(self, requests=None, max_steps: int = 100_000) -> dict[int, Finished]:
        """Serve until the queue drains and every sequence finishes."""
        for r in requests or ():
            self.submit(r)
        out: dict[int, Finished] = {}
        for _ in range(max_steps):
            if not self.busy:
                break
            before = (len(self._queue), self.n_active, self.stats["decode_steps"])
            for f in self.step():
                out[f.rid] = f
            if before == (len(self._queue), self.n_active, self.stats["decode_steps"]):
                raise RuntimeError("scheduler stalled (pool too small for any "
                                   "queued request?)")
        else:
            raise RuntimeError(f"run() exceeded {max_steps} steps")
        return out

    def throughput(self) -> float:
        """Steady-state decode tokens/s (first decode call excluded)."""
        if self.stats["decode_seconds"] == 0:
            return float("nan")
        return self.stats["steady_decode_tokens"] / self.stats["decode_seconds"]


__all__ = ["Request", "Finished", "ServeEngine", "SUPPORTED_FAMILIES"]
