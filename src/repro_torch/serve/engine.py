"""Continuous-batching serving engine over the paged quantized KV pool
(port of ``repro.serve.engine``, every feature of it).

Scheduling is the reference's (Orca-style iteration-level batching):
``submit()`` queues requests FIFO; ``step()`` = admit → one prefill chunk
→ ensure pages → one batched decode step (or one speculative window).

* **admission**: a request is admitted when a decode slot is free and the
  allocator can hand it its pages — ``reserve='full'`` takes the worst-case
  page count up front (nothing is ever evicted); ``reserve='none'`` takes
  only the prompt's pages and grows on demand.
* **prefill**, monolithic (the default): the model runs at the prompt's
  page-bucketed length with raw K/V (``kv_bits=0``), and the post-RoPE rows
  are then quantized per (token, head) into the request's pages.
  **Chunked** (``chunk_pages=N``, or ``prefix_cache=True``): the prompt runs
  through chunks of ``N × page_size`` tokens at absolute page-aligned
  offsets, one chunk a scheduler step, interleaved with decode. Each chunk
  **writes its quantized K/V rows into the pages first, then attends**
  through the ``paged_attention`` op with one query per chunk position
  (``seq_len = min(position + 1, prompt length)``) — the decode step's
  append-then-attend order, so a token's codes are the same whether
  chunked prefill, decode or a replay wrote them.
* **prefix reuse** (``prefix_cache=True``): a trie
  (:class:`~repro_torch.serve.prefix.PrefixCache`) maps page-aligned token
  runs of completed prompts to their pages. Admission points the new
  block-table row at the shared pages (refcounted; full pages are
  immutable), skips the chunks the hit covers whole, and recomputes a
  partly covered chunk at the same shapes with its shared pages' rows
  parked on the null page — a warm admission runs the same chunk calls as
  a cold one, so its tokens equal the cold run's at every KV precision.
* **decode**: per layer, each slot's new K/V row is appended into its
  current page (inactive slots write to the null page 0) *before* attending
  through ``paged_attention``; then greedy argmax, or per-slot temperature
  / top-k sampling with the key ``fold_in(fold_in(PRNGKey(seed), rid),
  position)`` (:mod:`~repro_torch.serve.sampling`).
* **preemption** (``reserve='none'``): a slot that needs a page when none
  is free first evicts idle prefix-cache leaves, then preempts the
  youngest slot, whose pages return to the pool; it is requeued at the
  front with its original ``t_submit`` and its generated tokens as a
  **replay list**. Re-admission prefills the prompt again (the same calls
  as the first time) and force-feeds the replayed tokens through ordinary
  decode steps, which rebuilds the same quantized KV: the continuation is
  the never-preempted run's.
* **any precision** (``quantize_param_tree(..., layout='bitplane')``):
  ``set_weight_bits(k)`` swaps in a cached tree of ``slice_planes(k)``
  views of every weight. A :class:`~repro_torch.serve.PrecisionAutoscaler`
  attached as ``autoscaler`` is fed the head-of-line admission wait and
  the queue depth (queued requests plus slots still prefilling) at the top
  of every ``step()``, on the injectable ``clock``; the engine actuates the
  bits it returns, except while a replay is in flight (replayed KV must be
  rebuilt under the weights that made it). A bits change flushes the
  prefix cache and keeps in-flight prefills out of it.
* **self-speculative decoding** (``spec_decode=k, draft_bits=b``): the
  ``slice_planes(b)`` view drafts k greedy tokens per slot through k
  ordinary decode steps, writing scratch KV rows past each slot's committed
  length; one batched verify at the served bits then runs all k + 1 window
  positions, **writing** each layer's window rows over the scratch rows
  **before attending** through ``paged_attention`` (one query per (slot,
  row), ``seq_len = position + 1``). The longest draft prefix that matches
  the verify chain is committed, plus the verify token at the first
  mismatch. Every other op of the window is row-local (``qmm_bitplane``
  sums each row in an order independent of M), so each window row
  computes what a sequential decode step at that position computes, on the
  CPU and on the card; a sampled slot draws every window position with the
  key sequential decode would use, so outputs are token-identical to
  vanilla decode. Speculation pauses while a replay is in flight, while the serving
  bits are at or below ``draft_bits``, and when a slot lacks k + 1 rows of
  runway.
* **faults** (``fault_injector``, :mod:`~repro_torch.serve.faults`): polled
  once a step for ``nan_logits`` (the request's logits read as non-finite)
  and ``kv_flip`` (seeded bit flips in a pool page). A slot whose logits
  are non-finite is quarantined — failed with reason ``'nan'``, its private
  pages scrubbed and freed — and the batch goes on. Trie pages carry a
  CRC32 of their codes and scales across layers, stamped at insert and
  checked at use. A request preempted or migrated more than
  ``retry_budget`` times fails with reason ``'retries'``.

On the card the whole path runs the ``cuda`` backend: every quantized
matmul is ``qmm`` (int weights) or ``qmm_bitplane`` (bitplane weights),
every decode, verify and prefill-chunk attention the ``paged_decode_attn``
kernel, and every sampling plane the threefry kernel.

``stats['decode_seconds']`` is steady state only: the first decode call of
each variant (greedy or sampled, speculative or not, at each weight
precision: kernel build and load, library warm-up) is not billed.
"""
from __future__ import annotations

import collections
import dataclasses
import time
import zlib
from typing import Any

import numpy as np
import torch

from repro_torch import prng, resolve_device
from repro_torch.kernels import registry
from repro_torch.models import attention as attn
from repro_torch.models import transformer as T
from repro_torch.models.layers import apply_rope, dense, embed
from repro_torch.quant import PrecisionPlan, QTensor, tree_nbytes
from repro_torch.serve import pages as pg
from repro_torch.serve import sampling
from repro_torch.serve.prefix import PrefixCache

# the other families' caches the reference's engine does not page either
# (it raises the same ValueError); they serve through the legacy loop,
# ``launch.serve.serve``
SUPPORTED_FAMILIES = ("dense", "moe", "audio")


@dataclasses.dataclass(frozen=True)
class Request:
    """One serving request. ``temperature<=0`` → greedy; ``top_k<=0`` → no
    top-k filter; ``eos_id=None`` → length-only stopping."""

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
    reason: str                      # 'eos' | 'length' | 'nan' | 'retries'


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device)


def _raw_bytes(t: torch.Tensor) -> bytes:
    return t.contiguous().cpu().view(torch.uint8).numpy().tobytes()


class ServeEngine:
    def __init__(self, params, cfg, *, plan: PrecisionPlan | None = None,
                 max_slots: int = 4, page_size: int = 8,
                 max_seq_len: int = 128, n_pages: int | None = None,
                 reserve: str = "full", backend: str | None = None,
                 device=None, autoscaler=None, clock=None,
                 prefix_cache: bool = False, chunk_pages: int | None = None,
                 spec_decode: int = 0, draft_bits: int | None = None,
                 fault_injector=None, replica_id: int = 0, retry_budget: int = 32):
        if cfg.family not in SUPPORTED_FAMILIES:
            raise ValueError(
                f"ServeEngine supports {SUPPORTED_FAMILIES} families, "
                f"got {cfg.family!r} (SSM/hybrid/VLM caches are not paged yet)")
        if cfg.window:
            raise ValueError("sliding-window models are not paged yet")
        if reserve not in ("full", "none"):
            raise ValueError(f"reserve must be 'full' or 'none', got {reserve!r}")
        if chunk_pages is not None and int(chunk_pages) < 1:
            raise ValueError(f"chunk_pages must be >= 1, got {chunk_pages}")
        if retry_budget < 1:
            raise ValueError(f"retry_budget must be >= 1, got {retry_budget}")
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
        self.plan = plan
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
        self.reserve = reserve
        if n_pages is None:
            n_pages = self.max_slots * self.max_pages_per_seq + 1
        self.allocator = pg.PageAllocator(n_pages)
        self.pool = pg.init_pool(
            cfg.n_layers, n_pages, page_size, cfg.n_kv_heads, cfg.head_dim,
            kv_bits=plan.kv_bits, dtype=cfg.dtype, device=self.device)
        # prefix sharing needs the chunked path: a hit attends quantized
        # shared pages, so the run that minted them must have attended its
        # own quantized pages the same way
        self.chunk_pages = (min(int(chunk_pages), self.max_pages_per_seq)
                            if chunk_pages is not None
                            else (self.max_pages_per_seq if prefix_cache else None))
        self._chunked = self.chunk_pages is not None
        self.prefix = (PrefixCache(self.page_size, self.allocator,
                                   checksum_fn=self._page_checksum)
                       if prefix_cache else None)

        B, MP = self.max_slots, self.max_pages_per_seq
        self._bt = np.zeros((B, MP), np.int32)
        self._lens = np.zeros((B,), np.int32)
        self._active = np.zeros((B,), bool)
        self._temps = np.zeros((B,), np.float32)
        self._topks = np.zeros((B,), np.int32)
        self._base_keys = np.zeros((B, 2), np.int64)
        self._last_tok = np.zeros((B,), np.int32)
        self._slots: list[dict | None] = [None] * B
        self._queue: collections.deque = collections.deque()
        self._admit_seq = 0
        self._compiled_variants: set[tuple] = set()
        self.stats = {"admitted": 0, "finished": 0, "preemptions": 0,
                      "decode_steps": 0, "decode_tokens": 0,
                      "decode_seconds": 0.0, "steady_decode_tokens": 0,
                      "prefill_tokens": 0, "admit_wait_seconds": 0.0,
                      "prefill_chunks": 0, "max_prefill_tokens_per_step": 0,
                      "prefix_hits": 0, "prefix_misses": 0,
                      "prefix_hit_tokens": 0, "spec_steps": 0,
                      "spec_draft_tokens": 0, "spec_accepted_tokens": 0,
                      "quarantined": 0, "retries_exhausted": 0, "kv_flips": 0}
        self.admit_waits: list[float] = []
        self.decode_times: list[float] = []
        self._clock = clock if clock is not None else time.perf_counter
        self._faults = fault_injector
        self.replica_id = int(replica_id)
        self.retry_budget = int(retry_budget)
        self._poison_rids: set[int] = set()
        self._step_no = 0

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
        (tree, per-layer views) pair (default the served one): append each
        slot's K/V row, attend its pages, return the (B, V) f32 logits. Host
        arrays in (``tokens`` may also be a tensor on the device), device
        logits out."""
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

    def _window_forward(self, toks, positions, page_ids, seq_lens, block_table):
        """A batched forward of W tokens per row under the served weights,
        write-then-attend: per layer the rows' K/V are quantized into
        ``page_ids``/``positions % page`` first, then each (row, position)
        attends its block table through ``paged_attention`` with its own
        ``seq_lens`` entry. ``toks`` (B, W) is a device tensor; the rest are
        host (B, W) arrays and the (B, MP) block table. Returns the final
        hidden states (B, W, d)."""
        cfg, spec, dev = self.cfg, self.cfg.attn_spec, self.device
        params, layers = self._served
        b, w = positions.shape
        host = torch.from_numpy(np.stack([
            positions, page_ids, positions % self.page_size,
            seq_lens]).astype(np.int32)).to(dev).unbind(0)
        pos, pids, offs, lens = host
        bt = torch.from_numpy(np.repeat(np.asarray(block_table, np.int32), w, axis=0)).to(dev)
        g, h, d = spec.n_kv_heads, spec.n_heads, spec.head_dim
        with registry.using(self.backend):
            kb = registry.get(device=dev)
            x = embed(params["embed"], toks, cfg.dtype).to(cfg.dtype)          # (B, W, d)
            for li, layer in enumerate(layers):
                kp, vp, ks, vs = self.pool.layer(li)

                def attend(z, pa=layer["attn"], kp=kp, vp=vp, ks=ks, vs=vs):
                    q = apply_rope(dense(pa["q"], z).reshape(b, w, h, d), pos,
                                   spec.rope_theta)
                    k = apply_rope(dense(pa["k"], z).reshape(b, w, g, d), pos,
                                   spec.rope_theta)
                    v = dense(pa["v"], z).reshape(b, w, g, d)
                    pg.write_rows(kp, vp, ks, vs, k, v, pids, offs)
                    out = kb.paged_attention(q.reshape(b * w, h, d), kp, vp, ks, vs,
                                             bt, lens.reshape(-1),
                                             softmax_scale=spec.scale)
                    return dense(pa["o"], out.reshape(b, w, h * d))

                x = T.decode_layer_block(cfg, layer, x, attend)
        return x

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
        W = self.spec_decode + 1
        act = self._active[:, None]
        positions = self._lens[:, None] + np.arange(W, dtype=np.int32)
        page_ids = np.where(act, np.take_along_axis(self._bt, positions // self.page_size,
                                                    1), 0)
        last = torch.from_numpy(self._last_tok[:, None]).to(self.device)
        toks = torch.cat([last.to(draft.dtype), draft], dim=1)
        x = self._window_forward(toks, positions, page_ids,
                                np.where(act, positions + 1, 0), self._bt)
        return T.final_logits(self._served[0], self.cfg, x)

    def chunk_logits(self, tokens: np.ndarray, pos0: int, page_ids: np.ndarray,
                     true_len: int, bt_row: np.ndarray, last_rel: int) -> torch.Tensor:
        """One prefill chunk of ``C = chunk_pages × page_size`` tokens at the
        page-aligned offset ``pos0``: per layer, the chunk's K/V rows are
        written into ``page_ids`` (one id a page of the chunk; 0, the null
        page, parks a shared page's recomputed rows) first, then every
        position attends the slot's pages through ``paged_attention`` with
        ``seq_len = min(position + 1, true_len)`` (a pad position past the
        prompt sees the whole prompt, never an empty row). Returns the (V,)
        f32 logits at chunk row ``last_rel``."""
        C = self.chunk_pages * self.page_size
        positions = (pos0 + np.arange(C, dtype=np.int32))[None]
        pids = np.repeat(np.asarray(page_ids, np.int32), self.page_size)[None]
        toks = torch.from_numpy(np.asarray(tokens, np.int32)[None]).to(self.device)
        x = self._window_forward(toks, positions, pids,
                                np.minimum(positions + 1, true_len), bt_row[None])
        return T.final_logits(self._served[0], self.cfg,
                              x[:, last_rel:last_rel + 1])[0, 0]

    # ----------------------------------------------------------------- API
    def admit_impossible(self, prompt_len: int, max_new_tokens: int) -> str | None:
        """Why a request of this shape can never be admitted here (None:
        admissible once capacity frees up)."""
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

    def submit(self, req: Request) -> None:
        prompt = np.asarray(req.prompt, np.int32).reshape(-1)
        why = self.admit_impossible(prompt.size, req.max_new_tokens)
        if why is not None:
            raise ValueError(f"request {req.rid} can never fit: {why}")
        self._queue.append({"req": req, "prompt": prompt,
                            "replay": np.zeros((0,), np.int32),
                            "t_submit": self._clock(), "retries": 0})

    def submit_entry(self, entry: dict) -> None:
        """Queue a prepared entry — the migration path: a request harvested
        off a dead replica comes back with its original ``t_submit``, its
        committed tokens as the replay list and its retry count."""
        self._queue.append({
            "req": entry["req"],
            "prompt": np.asarray(entry["prompt"], np.int32).reshape(-1),
            "replay": np.asarray(entry.get("replay", np.zeros((0,), np.int32)),
                                 np.int32).reshape(-1),
            "t_submit": entry["t_submit"],
            "retries": int(entry.get("retries", 0))})

    def harvest(self) -> list[dict]:
        """Strip every in-flight and queued request out of the engine for
        dispatch elsewhere (replica death): in-flight requests in admission
        order, then the queue, each with its committed tokens as the replay
        list and its retry count plus one. No page is freed: the pool died
        with the replica."""
        entries = []
        for _, slot in sorted((s["admit_seq"], i)
                              for i, s in enumerate(self._slots) if s):
            st = self._slots[slot]
            replay = np.concatenate([np.asarray(st["gen"], np.int32),
                                     np.asarray(st["replay_left"], np.int32)])
            entries.append({"req": st["req"], "prompt": st["prompt"],
                            "replay": replay, "t_submit": st["t_submit"],
                            "retries": int(st.get("retries", 0)) + 1})
        for e in self._queue:
            entries.append({**e, "retries": int(e.get("retries", 0)) + 1})
        self._queue.clear()
        self._slots = [None] * self.max_slots
        self._active[:] = False
        self._bt[:] = 0
        self._lens[:] = 0
        return entries

    @property
    def n_pending(self) -> int:
        return len(self._queue)

    @property
    def n_active(self) -> int:
        return int(self._active.sum())

    @property
    def n_prefilling(self) -> int:
        """Slots admitted but still chunk-prefilling (not yet decoding)."""
        return sum(1 for s in self._slots if s is not None and "prefill_pos" in s)

    @property
    def busy(self) -> bool:
        return bool(self._queue) or any(s is not None for s in self._slots)

    def kv_pool_nbytes(self, used_only: bool = False) -> int:
        """Logical KV HBM bytes (QTensor.nbytes accounting); ``used_only``
        counts the unique referenced pages (a shared prefix page once)."""
        if used_only:
            return pg.pool_nbytes(self.pool, n_pages=self.allocator.n_used)
        return pg.pool_nbytes(self.pool)

    def weight_nbytes(self) -> int:
        """Logical HBM bytes of the served params (QTensor.nbytes accounting):
        under ``set_weight_bits(k)`` the planes a decode step streams."""
        return tree_nbytes(self.params)

    def release_prefix_cache(self) -> int:
        """Drop every trie-held page reference (drain); returns pages
        released. In-flight sharers keep theirs."""
        return self.prefix.release_all() if self.prefix is not None else 0

    def set_weight_bits(self, k: int) -> None:
        """Serve the next batches at ``k`` weight bits: swap in the cached
        tree of ``slice_planes(k)`` views of the full artifact — no reload,
        no repacking; the matmuls stream k + 1 planes. Needs bitplane
        weights (``quantize_param_tree(..., layout='bitplane')``). A change
        flushes the prefix cache and keeps in-flight prefills out of it:
        pages minted under other weights never serve a hit."""
        pair = self._sliced_tree(self._params_full[0], k)
        if pair is not self._served:
            if self.prefix is not None:
                self.prefix.release_all()
            for st in self._slots:
                if st is not None and "prefill_pos" in st:
                    st["no_insert"] = True
        self._served = pair
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
    def _free_slot(self) -> int | None:
        # occupied ≠ active: a chunk-prefilling slot is occupied, not decoding
        return next((i for i, s in enumerate(self._slots) if s is None), None)

    def _budget(self, entry) -> int:
        return min(entry["req"].max_new_tokens,
                   self.max_seq_len - len(entry["prompt"]))

    def _bucket(self, s: int) -> int:
        return pg.pages_needed(max(s, 1), self.page_size) * self.page_size

    def _alloc_pages(self, n: int) -> list[int] | None:
        """Allocate ``n`` pages, evicting idle prefix-cache leaves (LRU)
        under pressure before giving up."""
        ids = self.allocator.alloc(n)
        while ids is None and self.prefix is not None and self.prefix.evict(1):
            ids = self.allocator.alloc(n)
        return ids

    def _replaying(self) -> bool:
        """True while a replay is in flight (in a slot or still queued)."""
        return (any(s is not None and s["replay_left"] for s in self._slots)
                or any(e["replay"].size for e in self._queue))

    def _admit(self, finished: list) -> None:
        while self._queue:
            entry = self._queue[0]
            if int(entry.get("retries", 0)) > self.retry_budget:
                # preempted or migrated past the budget: fail it with a status
                # (its committed tokens ride along)
                self._queue.popleft()
                self.stats["retries_exhausted"] += 1
                finished.append(self._finish_entry(entry, reason="retries"))
                continue
            slot = self._free_slot()
            if slot is None:
                return
            prompt, replay = entry["prompt"], entry["replay"]
            s = int(prompt.size)
            budget = self._budget(entry)
            if budget <= 0:                        # context already full
                self._queue.popleft()
                finished.append(self._finish_entry(entry, reason="length"))
                continue
            n_now = pg.pages_needed(s + 1, self.page_size)
            n_res = (pg.pages_needed(min(s + budget, self.max_seq_len), self.page_size)
                     if self.reserve == "full" else n_now)
            # a prefix hit: the first m pages come shared from the trie (one
            # reference each, ours now), taken before _alloc_pages so that
            # its eviction cannot free them
            shared = self.prefix.use(prompt) if self.prefix is not None else []
            m = len(shared)
            ids = self._alloc_pages(max(n_res, n_now) - m)
            if ids is None:
                if shared:
                    self.allocator.free(shared)    # hand the references back
                return                             # FIFO head-of-line wait
            self._queue.popleft()
            wait = max(0.0, self._clock() - entry["t_submit"])
            self.stats["admit_wait_seconds"] += wait
            self.admit_waits.append(wait)
            req = entry["req"]
            all_ids = shared + ids
            self._bt[slot] = 0
            self._bt[slot, :len(all_ids)] = all_ids
            self._temps[slot] = req.temperature
            self._topks[slot] = req.top_k
            self._base_keys[slot] = prng.fold_in(prng.PRNGKey(req.seed), req.rid).numpy()
            if self.prefix is not None:
                if m:
                    self.stats["prefix_hits"] += 1
                    self.stats["prefix_hit_tokens"] += m * self.page_size
                else:
                    self.stats["prefix_misses"] += 1
            state = {"req": req, "prompt": prompt, "gen": [],
                     "replay_left": [int(t) for t in replay], "pages": all_ids,
                     "admit_seq": self._admit_seq, "t_submit": entry["t_submit"],
                     "retries": int(entry.get("retries", 0))}
            self._admit_seq += 1
            self.stats["admitted"] += 1
            if self._chunked:
                # chunks the hit covers whole are skipped; a partly covered
                # one recomputes at the same shapes (see chunk_logits)
                state["prefill_pos"] = (m // self.chunk_pages) * self.chunk_pages \
                    * self.page_size
                state["shared_pages"] = m
                self._lens[slot] = 0
                self._slots[slot] = state
                continue
            bucket = self._bucket(s)
            padded = np.zeros((bucket,), np.int32)
            padded[:s] = prompt
            logits = self._prefill(padded, s - 1, all_ids[:bucket // self.page_size])
            self._lens[slot] = s
            self._slots[slot] = state
            self.stats["prefill_tokens"] += s
            self._start_decode(slot, logits, finished)

    def _start_decode(self, slot: int, last_logits, finished: list) -> None:
        """The prompt is prefilled: take the first token (sampled, or the
        replay's head after a preemption) and activate the slot."""
        state = self._slots[slot]
        req = state["req"]
        if state["replay_left"]:
            tok = int(state["replay_left"].pop(0))
        else:
            if req.rid in self._poison_rids \
                    or not bool(torch.isfinite(last_logits).all()):
                # non-finite prefill logits: quarantine before the slot
                # commits a garbage first token
                self._poison_rids.discard(req.rid)
                self._quarantine_slot(slot, finished)
                return
            if req.temperature > 0:
                key = sampling.slot_key(self._base_keys[slot], len(state["prompt"]))
                tok = int(sampling.sample_tokens(last_logits[None], [req.temperature],
                                                 [req.top_k], key[None])[0])
            else:
                tok = int(torch.argmax(last_logits))
        state["gen"] = [tok]
        self._active[slot] = True
        self._last_tok[slot] = tok
        self._maybe_finish(slot, finished)

    def _advance_prefills(self, finished: list) -> None:
        """Run ONE chunk for the oldest prefilling slot: a step's prefill
        work is bounded by ``chunk_pages × page_size`` tokens."""
        cands = [(st["admit_seq"], i) for i, st in enumerate(self._slots)
                 if st is not None and "prefill_pos" in st]
        if not cands:
            return
        _, slot = min(cands)
        st = self._slots[slot]
        prompt = st["prompt"]
        s = int(prompt.size)
        page, cp = self.page_size, self.chunk_pages
        C = cp * page
        start = st["prefill_pos"]
        end = min(s, start + C)
        toks = np.zeros((C,), np.int32)
        toks[:end - start] = prompt[start:end]
        m = st["shared_pages"]
        pids = np.zeros((cp,), np.int32)
        p0 = start // page
        for j in range(cp):
            gp = p0 + j
            if m <= gp < self.max_pages_per_seq:
                pids[j] = self._bt[slot, gp]      # 0 (null) when shared
        logits = self.chunk_logits(toks, start, pids, end, self._bt[slot],
                                   min(s - 1 - start, C - 1))
        self.stats["prefill_tokens"] += end - start
        self.stats["prefill_chunks"] += 1
        st["prefill_pos"] = start + C
        if end < s:
            return
        del st["prefill_pos"]
        self._lens[slot] = s
        if self.prefix is not None and not st.get("no_insert"):
            self.prefix.insert(prompt, [int(p) for p in self._bt[slot, :s // page]])
        self._start_decode(slot, logits, finished)

    def _full_tokens(self, state) -> np.ndarray:
        return np.concatenate([state["prompt"], np.asarray(state["gen"], np.int32)])

    def _finish_entry(self, entry, *, reason: str) -> Finished:
        """A queue entry finished without (re-)admission."""
        replay = entry["replay"]
        self.stats["finished"] += 1
        return Finished(rid=entry["req"].rid,
                        tokens=np.concatenate([entry["prompt"], replay]),
                        prompt_len=len(entry["prompt"]), n_generated=int(replay.size),
                        reason=reason)

    def _release_slot(self, slot: int) -> None:
        self._active[slot] = False
        self._bt[slot] = 0
        self._lens[slot] = 0
        self._slots[slot] = None

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
        self.allocator.free(state["pages"])        # decref: shared pages survive
        self._release_slot(slot)
        self.stats["finished"] += 1
        finished.append(Finished(rid=req.rid, tokens=self._full_tokens(state),
                                 prompt_len=len(state["prompt"]), n_generated=n_gen,
                                 reason=reason))
        return True

    def _quarantine_slot(self, slot: int, finished: list) -> None:
        """Fail ONE request whose logits went non-finite, with reason
        ``'nan'``, and leave the rest of the batch untouched. Its private
        (refcount-1) pages are scrubbed before the free — a NaN row in a
        recycled page would poison its next owner through 0 × NaN; shared
        pages were minted before the poison and stay."""
        state = self._slots[slot]
        req = state["req"]
        private = [p for p in state["pages"] if self.allocator.refcount(p) == 1]
        if private:
            pg.scrub_pages(self.pool, private)
        self.allocator.free(state["pages"])
        self._release_slot(slot)
        self.stats["quarantined"] += 1
        self.stats["finished"] += 1
        finished.append(Finished(rid=req.rid, tokens=self._full_tokens(state),
                                 prompt_len=len(state["prompt"]),
                                 n_generated=len(state["gen"]), reason="nan"))

    def _page_checksum(self, pid: int) -> int:
        """CRC32 over one pool page's raw code (and scale) bytes across all
        layers: the prefix trie stamps it at insert and re-checks it at use."""
        pid = int(pid)
        parts = [self.pool.k_pages[:, pid], self.pool.v_pages[:, pid]]
        if self.plan.kv_bits:
            parts += [self.pool.k_scale[:, pid], self.pool.v_scale[:, pid]]
        crc = 0
        for a in parts:
            crc = zlib.crc32(_raw_bytes(a), crc)
        return crc

    def _inject_kv_flip(self, spec) -> None:
        """Apply one ``kv_flip`` fault: seeded bit flips in a pool page's K
        codes (``spec.page``, or a seeded pick of an allocated page)."""
        from repro_torch.serve.faults import corrupt_kv_page

        page = spec.page
        if page is None:
            used = self.allocator.used_pages()
            if not used:
                return
            rng = np.random.default_rng(spec.seed)
            page = int(used[int(rng.integers(len(used)))])
        corrupt_kv_page(self.pool, page, n_flips=spec.n_flips, seed=spec.seed)
        self.stats["kv_flips"] += 1

    def _preempt_one(self) -> int | None:
        """Evict the youngest occupied slot (decoding or still prefilling)
        and requeue it at the front with its generated tokens as the replay
        list and its original ``t_submit``. Returns the freed slot."""
        cands = [(s["admit_seq"], i) for i, s in enumerate(self._slots) if s]
        if not cands:
            return None
        _, slot = max(cands)
        state = self._slots[slot]
        self.allocator.free(state["pages"])
        self._release_slot(slot)
        replay = np.concatenate([np.asarray(state["gen"], np.int32),
                                 np.asarray(state["replay_left"], np.int32)])
        self._queue.appendleft({"req": state["req"], "prompt": state["prompt"],
                                "replay": replay, "t_submit": state["t_submit"],
                                "retries": int(state.get("retries", 0)) + 1})
        self.stats["preemptions"] += 1
        return slot

    def _ensure_pages(self) -> None:
        """Before decode every active slot must own the page its next KV row
        lands in: grow on demand, evicting idle prefix-cache pages first,
        then preempting (youngest first) when the pool is exhausted."""
        for slot in range(self.max_slots):
            while self._active[slot] and self._slots[slot] is not None:
                pidx = int(self._lens[slot]) // self.page_size
                if self._bt[slot, pidx] != 0:
                    break
                ids = self._alloc_pages(1)
                if ids is not None:
                    self._bt[slot, pidx] = ids[0]
                    self._slots[slot]["pages"].append(ids[0])
                    break
                victim = self._preempt_one()
                if victim is None or victim == slot:
                    break                      # this slot itself was evicted

    def _spec_ready(self) -> bool:
        """Can this step run a speculative window? Not while a replay is in
        flight, nor while the serving bits are at or below ``draft_bits``
        (the draft would predict nothing)."""
        if not self.spec_decode or self._replaying():
            return False
        return self.weight_bits is None or self.weight_bits > self.draft_bits

    def _ensure_spec_pages(self) -> bool:
        """Extend every active slot's block table over the window rows
        (positions lens .. lens + k). Speculation never preempts: without
        runway (a sequence near ``max_seq_len``) or free pages, the step
        decodes the vanilla way. Pages allocated here join the slot's
        ``pages`` and are freed with it."""
        k = self.spec_decode
        for slot in range(self.max_slots):
            if not self._active[slot] or self._slots[slot] is None:
                continue
            n = int(self._lens[slot])
            if n + k + 1 > self.max_seq_len:
                return False
            for pidx in range(n // self.page_size, (n + k) // self.page_size + 1):
                if self._bt[slot, pidx] != 0:
                    continue
                ids = self._alloc_pages(1)
                if ids is None:
                    return False
                self._bt[slot, pidx] = ids[0]
                self._slots[slot]["pages"].append(ids[0])
        return True

    def _commit(self, slot: int, tokens, finished: list) -> int:
        """Append ``tokens`` to a slot's generation one at a time, stopping
        when it finishes; returns the number committed."""
        state, n = self._slots[slot], 0
        for tok in tokens:
            tok = int(tok)
            self._lens[slot] += 1
            state["gen"].append(tok)
            self._last_tok[slot] = tok
            n += 1
            if self._maybe_finish(slot, finished):
                break
        return n

    def _poisoned(self, slot: int, ok: bool) -> bool:
        """Quarantine the slot if its logits are non-finite or an injected
        ``nan_logits`` names its request."""
        rid = self._slots[slot]["req"].rid
        if rid in self._poison_rids or not ok:
            self._poison_rids.discard(rid)
            return True
        return False

    def _spec_step(self, finished: list) -> None:
        """One speculative window: k draft steps at ``draft_bits`` + one
        batched verify at the serving bits, then commit per slot the longest
        accepted draft prefix and the verify token after it. A token counts
        when it is committed, and committing stops when the slot finishes,
        so ``decode_tokens == Σ (n_generated − 1)`` holds with speculation
        too. One ``decode_times`` entry (draft + verify) per window."""
        k, W, b = self.spec_decode, self.spec_decode + 1, self.max_slots
        sampled = bool((self._temps[self._active] > 0).any())
        t0 = self._clock()
        draft = self._draft()
        logits = self.verify_logits(draft)
        if sampled:
            keys = sampling.window_keys(self._base_keys,
                                        self._lens[:, None] + np.arange(W) + 1)
            tgt = sampling.sample_tokens(
                logits.reshape(b * W, -1), np.repeat(self._temps, W),
                np.repeat(self._topks, W), keys.reshape(b * W, 2)).reshape(b, W)
        else:
            tgt = torch.argmax(logits, dim=-1)
        ok = torch.isfinite(logits).all(dim=-1).all(dim=-1)
        host = torch.cat([draft.to(torch.int32), tgt.to(torch.int32),
                          ok.to(torch.int32)[:, None]], dim=1).cpu().numpy()
        draft_np, tgt_np, ok_np = host[:, :k], host[:, k:k + W], host[:, -1]
        dt = self._clock() - t0
        committed = 0
        for slot in np.flatnonzero(self._active):
            if self._poisoned(slot, bool(ok_np[slot])):
                self._quarantine_slot(slot, finished)
                continue
            m = 0
            while m < k and draft_np[slot, m] == tgt_np[slot, m]:
                m += 1
            self.stats["spec_draft_tokens"] += k
            self.stats["spec_accepted_tokens"] += m
            # the m accepted drafts and the verify token at the first
            # mismatch: what sequential decode would have produced
            committed += self._commit(slot, tgt_np[slot, :m + 1], finished)
        self.stats["decode_steps"] += 1
        self.stats["spec_steps"] += 1
        self.stats["decode_tokens"] += committed
        self._bill(("spec", sampled, self.weight_bits), dt, committed)

    def _bill(self, variant: tuple, dt: float, tokens: int) -> None:
        """Steady-state accounting: the first call of each variant (kernel
        build and load, warm-up) is not billed."""
        if variant in self._compiled_variants:
            self.stats["decode_seconds"] += dt
            self.stats["steady_decode_tokens"] += tokens
            self.decode_times.append(dt)
        self._compiled_variants.add(variant)

    def step(self) -> list[Finished]:
        """One scheduler iteration: poll the faults, actuate the
        autoscaler's bits, admit what fits, advance one prefill chunk, then
        decode one token for every live sequence — or, with
        ``spec_decode``, run one speculative window (up to k + 1 tokens per
        slot). Returns the requests that finished."""
        finished: list[Finished] = []
        self._step_no += 1
        if self._faults is not None:
            for sp in self._faults.poll("nan_logits", step=self._step_no,
                                        replica=self.replica_id):
                self._poison_rids.add(sp.rid)
            for sp in self._faults.poll("kv_flip", step=self._step_no,
                                        replica=self.replica_id):
                self._inject_kv_flip(sp)
        if self.autoscaler is not None:
            now = self._clock()
            wait = (max(0.0, now - self._queue[0]["t_submit"]) if self._queue else 0.0)
            bits = self.autoscaler.observe(admit_wait_ms=wait * 1e3,
                                           queue_depth=len(self._queue) + self.n_prefilling,
                                           now=now)
            # deferred while a replay is in flight: replayed KV must be
            # rebuilt under the weights of the original decode
            if bits != self.weight_bits and not self._replaying():
                self.set_weight_bits(bits)
        pt0 = self.stats["prefill_tokens"]
        self._admit(finished)
        if self._chunked:
            self._advance_prefills(finished)
        self._ensure_pages()
        step_prefill = self.stats["prefill_tokens"] - pt0
        if step_prefill > self.stats["max_prefill_tokens_per_step"]:
            self.stats["max_prefill_tokens_per_step"] = step_prefill
        if not self._active.any():
            return finished
        if self._spec_ready() and self._ensure_spec_pages():
            self._spec_step(finished)
            return finished
        sampled = bool((self._temps[self._active] > 0).any())
        t0 = self._clock()
        logits = self.decode_logits(self._last_tok, self._lens, self._bt, self._active)
        if sampled:
            keys = sampling.slot_key(self._base_keys, self._lens + 1)
            tok = sampling.sample_tokens(logits, self._temps, self._topks, keys)
        else:
            tok = torch.argmax(logits, dim=-1).to(torch.int32)
        ok = torch.isfinite(logits).all(dim=-1)
        tok_np, ok_np = torch.stack([tok, ok.to(torch.int32)]).cpu().numpy()
        dt = self._clock() - t0
        n_live = int(self._active.sum())
        self.stats["decode_steps"] += 1
        self.stats["decode_tokens"] += n_live
        self._bill((sampled, self.weight_bits), dt, n_live)
        for slot in np.flatnonzero(self._active):
            if self._poisoned(slot, bool(ok_np[slot])):
                # scrub and free its pages so the NaN rows cannot reach the
                # next owner; every other slot goes on
                self._quarantine_slot(slot, finished)
                continue
            state = self._slots[slot]
            # a replay: this step rebuilt the position's KV, the token is known
            tok = state["replay_left"].pop(0) if state["replay_left"] else tok_np[slot]
            self._commit(slot, [tok], finished)
        return finished

    def run(self, requests=None, max_steps: int = 100_000) -> dict[int, Finished]:
        """Serve until the queue drains and every sequence finishes."""
        for r in requests or ():
            self.submit(r)
        out: dict[int, Finished] = {}
        for _ in range(max_steps):
            if not self.busy:
                break
            before = (len(self._queue), self.n_active, self.n_prefilling,
                      self.stats["decode_steps"], self.stats["prefill_tokens"])
            for f in self.step():
                out[f.rid] = f
            after = (len(self._queue), self.n_active, self.n_prefilling,
                     self.stats["decode_steps"], self.stats["prefill_tokens"])
            if before == after:
                raise RuntimeError("scheduler stalled (pool too small for any "
                                   "queued request?) — nothing admitted, "
                                   "prefilled, decoded, or finished")
        else:
            raise RuntimeError(f"run() exceeded {max_steps} steps")
        return out

    def throughput(self) -> float:
        """Steady-state decode tokens/s (first decode call excluded)."""
        if self.stats["decode_seconds"] == 0:
            return float("nan")
        return self.stats["steady_decode_tokens"] / self.stats["decode_seconds"]


__all__ = ["Request", "Finished", "ServeEngine", "SUPPORTED_FAMILIES"]
