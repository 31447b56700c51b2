"""Continuous-batching serving engine over the paged quantized KV pool
(port of ``repro.serve.engine``: monolithic admission, ``reserve='full'``,
greedy decode, bitplane weights at any precision, self-speculative
decoding and the precision autoscaler).

Scheduling is the reference's: ``submit()`` queues requests FIFO; ``step()``
admits what fits (``reserve='full'``: a request takes its worst-case page
count up front, so nothing is ever evicted), prefills each admission
monolithically at its page-bucketed prompt length, then runs one batched
greedy decode step over every live slot — or one speculative window.

* **prefill** runs the model with raw K/V (``kv_bits=0``); the post-RoPE
  rows are then quantized per (token, head) into the request's pages.
* **decode** embeds each slot's last token, and per layer appends the new
  K/V row into the slot's current page (inactive slots write to the null
  page 0) *before* attending, through the ``paged_attention`` registry op —
  the hand-written CUDA kernel on the card. ``new_lens = pos + active``.
* **any precision** (``quantize_param_tree(..., layout='bitplane')``):
  ``set_weight_bits(k)`` swaps in a cached tree of ``slice_planes(k)``
  views of every weight — no repacking, no reload; the matmuls then stream
  k + 1 planes. A :class:`~repro_torch.serve.PrecisionAutoscaler` attached
  as ``autoscaler`` is fed the head-of-line admission wait and the queue
  depth at the top of every ``step()`` (on the injectable ``clock``) and
  the engine actuates the bits it returns, so a bits change never lands
  inside a speculative window.
* **self-speculative decoding** (``spec_decode=k, draft_bits=b``): the
  ``slice_planes(b)`` view of the served weights drafts k greedy tokens per
  slot through k ordinary decode steps, writing scratch KV rows past each
  slot's committed length; one batched full-precision verify then runs all
  k + 1 window positions (the pending token and the k drafts) through the
  model, **writing** each layer's window K/V rows into the pages (over the
  draft's scratch rows) **before attending**. The longest draft prefix that
  matches the verify chain is committed, plus the verify token at the first
  mismatch. The verify window attends through the same ``paged_attention``
  op as decode — one query per (slot, window row), each with its slot's
  block table and ``seq_len = position + 1`` — and every other op of the
  window is row-local (the ``qmm_bitplane`` kernel sums each row in an
  order independent of M), so each window row computes exactly what a
  sequential decode step at that position computes, on the CPU and on the
  card: greedy output is token-identical to vanilla decode. Speculation
  pauses while the serving bits are at or below ``draft_bits``, and when a
  slot lacks k + 1 rows of runway.

On the card the whole path runs the ``cuda`` backend: every quantized
matmul is ``qmm`` (int weights) or ``qmm_bitplane`` (bitplane weights) and
every decode and verify attention the ``paged_decode_attn`` kernel. Prefix
caching, chunked prefill, fault injection, ``reserve='none'`` and sampling
(``temperature > 0``) raise ``NotImplementedError`` until ROADMAP A3.

``stats['decode_seconds']`` is steady state only: the first decode call of
each variant (greedy or speculative, at each weight precision: kernel
build and load, library warm-up) is not billed.
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
from repro_torch.models.layers import apply_rope, dense, embed
from repro_torch.quant import PrecisionPlan, QTensor, tree_nbytes
from repro_torch.serve import pages as pg

# the other families' caches the reference's engine does not page either
# (it raises the same ValueError); they serve through the legacy loop,
# ``launch.serve.serve``
SUPPORTED_FAMILIES = ("dense", "moe", "audio")


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
    raise NotImplementedError(f"{what} is not in the port yet (ROADMAP A3)")


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
            raise ValueError(
                f"ServeEngine supports {SUPPORTED_FAMILIES} families, "
                f"got {cfg.family!r} (SSM/hybrid/VLM caches are not paged yet)")
        if cfg.window:
            raise ValueError("sliding-window models are not paged yet")
        if reserve == "none":
            _not_ported("reserve='none' (preemption and replay)")
        if reserve != "full":
            raise ValueError(f"reserve must be 'full' or 'none', got {reserve!r}")
        for flag, what in ((prefix_cache, "prefix_cache"),
                           (chunk_pages is not None, "chunk_pages"),
                           (fault_injector is not None, "fault_injector")):
            if flag:
                _not_ported(what)
        if int(spec_decode) < 0:
            raise ValueError(f"spec_decode must be >= 0, got {spec_decode}")
        if spec_decode and draft_bits is None:
            raise ValueError("spec_decode needs draft_bits (the low-bit draft "
                             "view, e.g. draft_bits=4)")
        if draft_bits is not None and not spec_decode:
            raise ValueError("draft_bits without spec_decode has no effect")
        self.device = resolve_device(device)
        plan = plan if plan is not None else cfg.precision
        self.cfg = dataclasses.replace(cfg, precision=plan)
        # prefill runs with kv_bits=0: it returns the raw post-RoPE K/V,
        # which the pool quantizes page-wise itself
        self._cfg_fp = dataclasses.replace(
            cfg, precision=dataclasses.replace(plan, kv_bits=0))
        # a served tree travels with its per-layer views: (tree, views)
        full = _to_device(params, self.device)
        self._params_by_bits: dict[int, tuple] = {}   # k → slice_planes(k) pair
        self.weight_bits: int | None = None     # None until set_weight_bits
        # the draft is a slice_planes view of the served weights, built (and
        # validated) first so that dense weights fail at construction
        self.spec_decode = int(spec_decode)
        self.draft_bits = int(draft_bits) if draft_bits is not None else None
        self._params_draft = (self._sliced_tree(full, self.draft_bits)
                              if self.spec_decode else None)
        self._params_full = self._served = (full, T.layer_views(full, self.cfg))
        self.autoscaler = autoscaler
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
        self._compiled_variants: set[tuple] = set()
        self.stats = {"admitted": 0, "finished": 0, "decode_steps": 0,
                      "decode_tokens": 0, "decode_seconds": 0.0,
                      "steady_decode_tokens": 0, "prefill_tokens": 0,
                      "admit_wait_seconds": 0.0, "spec_steps": 0,
                      "spec_draft_tokens": 0, "spec_accepted_tokens": 0}
        self.admit_waits: list[float] = []
        self.decode_times: list[float] = []
        self._clock = clock if clock is not None else time.perf_counter

    # ------------------------------------------------------------ device fns
    @property
    def params(self):
        """The served parameter tree (a ``slice_planes`` view under
        :meth:`set_weight_bits`)."""
        return self._served[0]

    def _prefill(self, tokens: np.ndarray, last_pos: int, page_ids: list[int]):
        """Prefill one page-bucketed prompt and write its pages; returns the
        logits (V,) at ``last_pos``."""
        toks = torch.as_tensor(tokens, dtype=torch.int64, device=self.device)[None]
        with registry.using(self.backend):
            tree, layers = self._served
            logits, (k, v) = T.prefill(tree, toks, self._cfg_fp,
                                       last_pos=last_pos, layers=layers)
        ids = torch.as_tensor(page_ids, dtype=torch.int64, device=self.device)
        pg.write_prompt(self.pool, k[:, 0], v[:, 0], ids)
        return logits[0]

    def decode_logits(self, tokens, positions, block_table, active, weights=None):
        """One batched decode step over every slot under ``weights``, a
        (tree, per-layer views) pair (default the served one): append each slot's K/V row, attend its pages,
        return the (B, V) f32 logits. Host arrays in (``tokens`` may also
        be a tensor on the device), device logits out."""
        params, layers = self._served if weights is None else weights
        cfg, spec, dev = self.cfg, self.cfg.attn_spec, self.device
        page = self.page_size
        pos_np = np.asarray(positions, np.int32)
        act_np = np.asarray(active, bool)
        bt_np = np.asarray(block_table, np.int32)
        page_ids = np.where(act_np, bt_np[np.arange(len(pos_np)), pos_np // page], 0)
        rows = [pos_np, page_ids.astype(np.int32), pos_np % page,
                pos_np + act_np.astype(np.int32)]
        on_device = torch.is_tensor(tokens)
        if not on_device:
            rows.insert(0, np.asarray(tokens, np.int32))
        host = torch.from_numpy(np.stack(rows)).to(dev).unbind(0)
        tok = tokens if on_device else host[0]
        pos, pids, offs, new_lens = host[-4:]
        bt = torch.from_numpy(bt_np).to(dev)
        b = pos.shape[0]
        with registry.using(self.backend):
            kb = registry.get(device=dev)
            x = embed(params["embed"], tok[:, None], cfg.dtype).to(cfg.dtype)
            for li, layer in enumerate(layers):
                kp, vp, ks, vs = self.pool.layer(li)

                def attend(z, layer=layer, kp=kp, vp=vp, ks=ks, vs=vs):
                    q, k, v = attn.decode_qkv(layer["attn"], z, spec, pos[:, None])
                    pg.append_rows(kp, vp, ks, vs, k[:, 0], v[:, 0], pids, offs)
                    out = kb.paged_attention(q[:, 0], kp, vp, ks, vs, bt, new_lens,
                                             softmax_scale=spec.scale)
                    return dense(layer["attn"]["o"],
                                 out.reshape(b, 1, spec.n_heads * spec.head_dim))

                x = T.decode_layer_block(cfg, layer, x, attend)
            return T.final_logits(params, cfg, x)[:, 0]

    def _draft(self) -> torch.Tensor:
        """``spec_decode`` greedy decode steps under the ``draft_bits`` view,
        each writing its scratch KV row past the committed length (the
        verify pass overwrites every window row before it attends, so no
        draft bit reaches committed state). Returns the (B, k) draft tokens
        on the device."""
        tok, lens, toks = self._last_tok, self._lens.copy(), []
        for _ in range(self.spec_decode):
            logits = self.decode_logits(tok, lens, self._bt, self._active,
                                        weights=self._params_draft)
            tok = torch.argmax(logits, dim=-1)
            toks.append(tok)
            lens = lens + self._active.astype(np.int32)
        return torch.stack(toks, dim=1)

    def verify_logits(self, draft: torch.Tensor) -> torch.Tensor:
        """Score all ``W = spec_decode + 1`` window positions of every slot
        (the pending token + its k draft tokens) in one batched forward under
        the served weights: per layer, write the window's K/V rows into the
        pages first (:func:`~repro_torch.serve.pages.write_rows`), then
        attend through the ``paged_attention`` op with one query per
        (slot, row) and ``seq_len = position + 1`` — what a sequential
        decode step at that position attends. Returns (B, W, V) f32 logits."""
        cfg, spec, dev = self.cfg, self.cfg.attn_spec, self.device
        page, (params, layers) = self.page_size, self._served
        W = self.spec_decode + 1
        b = self.max_slots
        act = self._active[:, None]
        positions = self._lens[:, None] + np.arange(W, dtype=np.int32)
        page_ids = np.where(act, np.take_along_axis(self._bt, positions // page, 1), 0)
        seq_lens = np.where(act, positions + 1, 0)
        host = torch.from_numpy(np.stack([
            np.broadcast_to(self._last_tok[:, None], (b, W)), positions,
            page_ids.astype(np.int32), positions % page,
            seq_lens.astype(np.int32)])).to(dev).unbind(0)
        last, pos, pids, offs, lens = host
        toks = torch.cat([last[:, :1].to(draft.dtype), draft], dim=1)
        bt = torch.from_numpy(np.repeat(self._bt, W, axis=0)).to(dev)
        g, h, d = spec.n_kv_heads, spec.n_heads, spec.head_dim
        with registry.using(self.backend):
            kb = registry.get(device=dev)
            x = embed(params["embed"], toks, cfg.dtype).to(cfg.dtype)           # (B, W, d)
            for li, layer in enumerate(layers):
                kp, vp, ks, vs = self.pool.layer(li)

                def attend(z, pa=layer["attn"], kp=kp, vp=vp, ks=ks, vs=vs):
                    q = apply_rope(dense(pa["q"], z).reshape(b, W, h, d), pos,
                                   spec.rope_theta)
                    k = apply_rope(dense(pa["k"], z).reshape(b, W, g, d), pos,
                                   spec.rope_theta)
                    v = dense(pa["v"], z).reshape(b, W, g, d)
                    pg.write_rows(kp, vp, ks, vs, k, v, pids, offs)
                    out = kb.paged_attention(q.reshape(b * W, h, d), kp, vp, ks, vs,
                                             bt, lens.reshape(-1),
                                             softmax_scale=spec.scale)
                    return dense(pa["o"], out.reshape(b, W, h * d))

                x = T.decode_layer_block(cfg, layer, x, attend)
            return T.final_logits(params, cfg, x)

    # ----------------------------------------------------------------- API
    def submit(self, req: Request) -> None:
        if req.temperature > 0:
            _not_ported("sampling with temperature > 0")
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
        """Logical HBM bytes of the served params (QTensor.nbytes accounting):
        under ``set_weight_bits(k)`` the planes a decode step streams."""
        return tree_nbytes(self.params)

    def set_weight_bits(self, k: int) -> None:
        """Serve the next batches at ``k`` weight bits: swap in the cached
        tree of ``slice_planes(k)`` views of the full artifact — no reload,
        no repacking; the matmuls stream k + 1 planes. Needs bitplane
        weights (``quantize_param_tree(..., layout='bitplane')``)."""
        self._served = self._sliced_tree(self._params_full[0], k)
        self.weight_bits = int(k)

    def _sliced_tree(self, full, k: int):
        """The cached ``slice_planes(k)`` view of the full artifact ``full``
        and its per-layer views, shared by :meth:`set_weight_bits` and the
        speculative draft."""
        pair = self._params_by_bits.get(k)
        if pair is None:
            hit = [0]

            def go(node):
                if isinstance(node, dict):
                    return {key: go(v) for key, v in node.items()}
                if isinstance(node, QTensor) and node.scheme.layout == "bitplane":
                    hit[0] += 1
                    return node.slice_planes(min(int(k), node.scheme.bits))
                return node

            tree = go(full)
            if not hit[0]:
                raise ValueError(
                    "k-bit weight views need layout='bitplane' QTensor weights "
                    "— quantize with quantize_param_tree(..., layout='bitplane')")
            pair = self._params_by_bits[k] = (tree, T.layer_views(tree, self.cfg))
        return pair

    def acceptance_rate(self) -> float:
        """Fraction of drafted tokens the full-precision verify accepted
        (NaN before the first speculative window)."""
        drafted = self.stats["spec_draft_tokens"]
        if not drafted:
            return float("nan")
        return self.stats["spec_accepted_tokens"] / drafted

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

    def _spec_ready(self) -> bool:
        """Can this step run a speculative window? A draft at or above the
        serving precision predicts nothing, so an autoscaler drop to (or
        below) ``draft_bits`` pauses speculation until bits are restored."""
        if not self.spec_decode:
            return False
        return self.weight_bits is None or self.weight_bits > self.draft_bits

    def _ensure_spec_pages(self) -> bool:
        """Extend every active slot's block table over the window rows
        (positions lens .. lens + k). Speculation never takes pages from
        anyone: without runway (a sequence near ``max_seq_len``) or free
        pages, the step decodes the vanilla way. Pages allocated here join
        the slot's ``pages`` and are freed with it."""
        k = self.spec_decode
        for slot in np.flatnonzero(self._active):
            n = int(self._lens[slot])
            if n + k + 1 > self.max_seq_len:
                return False
            for pidx in range(n // self.page_size, (n + k) // self.page_size + 1):
                if self._bt[slot, pidx] != 0:
                    continue
                ids = self.allocator.alloc(1)
                if ids is None:
                    return False
                self._bt[slot, pidx] = ids[0]
                self._slots[slot]["pages"].append(ids[0])
        return True

    def _spec_step(self, finished: list) -> None:
        """One speculative window: k draft steps at ``draft_bits`` + one
        batched verify at the serving bits, then commit per slot the longest
        accepted draft prefix and the verify token after it. A token counts
        when it is committed, and committing stops when the slot finishes,
        so ``decode_tokens == Σ (n_generated − 1)`` holds with speculation
        too. One ``decode_times`` entry (draft + verify) per window."""
        k = self.spec_decode
        t0 = self._clock()
        draft = self._draft()
        tgt = torch.argmax(self.verify_logits(draft), dim=-1)
        draft_np = draft.to(torch.int32).cpu().numpy()
        tgt_np = tgt.to(torch.int32).cpu().numpy()
        dt = self._clock() - t0
        committed = 0
        for slot in np.flatnonzero(self._active):
            state = self._slots[slot]
            m = 0
            while m < k and draft_np[slot, m] == tgt_np[slot, m]:
                m += 1
            self.stats["spec_draft_tokens"] += k
            self.stats["spec_accepted_tokens"] += m
            for tok in tgt_np[slot, :m + 1]:
                tok = int(tok)
                self._lens[slot] += 1
                state["gen"].append(tok)
                self._last_tok[slot] = tok
                committed += 1
                if self._maybe_finish(slot, finished):
                    break
        self.stats["decode_steps"] += 1
        self.stats["spec_steps"] += 1
        self.stats["decode_tokens"] += committed
        self._bill(("spec", self.weight_bits), dt, committed)

    def _bill(self, variant: tuple, dt: float, tokens: int) -> None:
        """Steady-state accounting: the first call of each variant (kernel
        build and load, warm-up) is not billed."""
        if variant in self._compiled_variants:
            self.stats["decode_seconds"] += dt
            self.stats["steady_decode_tokens"] += tokens
            self.decode_times.append(dt)
        self._compiled_variants.add(variant)

    def step(self) -> list[Finished]:
        """One scheduler iteration: actuate the autoscaler's bits, admit what
        fits, then decode one token for every live sequence — or, with
        ``spec_decode``, run one speculative window (up to k + 1 tokens per
        slot). Returns the requests that finished."""
        finished: list[Finished] = []
        if self.autoscaler is not None:
            now = self._clock()
            wait = (max(0.0, now - self._queue[0]["t_submit"])
                    if self._queue else 0.0)
            bits = self.autoscaler.observe(admit_wait_ms=wait * 1e3,
                                           queue_depth=len(self._queue), now=now)
            if bits != self.weight_bits:
                self.set_weight_bits(bits)
        self._admit(finished)
        if not self._active.any():
            return finished
        for slot in np.flatnonzero(self._active):   # reserve='full' owns them
            if self._bt[slot, self._lens[slot] // self.page_size] == 0:
                raise RuntimeError(f"slot {slot} has no page for row {self._lens[slot]}")
        if self._spec_ready() and self._ensure_spec_pages():
            self._spec_step(finished)
            return finished
        t0 = self._clock()
        logits = self.decode_logits(self._last_tok, self._lens, self._bt, self._active)
        tok_np = torch.argmax(logits, dim=-1).to(torch.int32).cpu().numpy()
        dt = self._clock() - t0
        n_live = int(self._active.sum())
        self.stats["decode_steps"] += 1
        self.stats["decode_tokens"] += n_live
        self._bill((False, self.weight_bits), dt, n_live)
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
