"""Port parity — the refcounting page allocator, the prefix cache, chunked
prefill and ``reserve='none'`` preemption with replay (repro_torch.serve vs
repro.serve), on the CPU with the reduced gemma-2b at f32, the reference's
weights bridged across.

* unit mirrors: the operation sequences of the reference's
  ``TestPageAllocatorRefcount`` and ``TestPrefixCache`` run on both
  packages' allocator and trie give the same page ids, refcounts, return
  values and raises;
* a shared-prefix trace through ``prefix_cache=True, chunk_pages=2`` gives
  the reference's chunked engine's tokens and prefix hits at kv 0/8/4 —
  held against the chunked reference, never the monolithic one
  (monolithic and chunked admission are different numerics at quantized
  KV, ROADMAP C2); a warm run equals a cold chunked run;
* ``reserve='none'`` traces that preempt (monolithic; and chunked with the
  prefix cache, the reference's C2 case) give the reference's tokens and
  preemption counts and drain leak-free.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from torch_bridge import bridge, ref_engine

from repro import configs as jconfigs
from repro.models import transformer as JT
from repro.quant import PrecisionPlan as JPlan
from repro.serve import PageAllocator as JAlloc
from repro.serve import PrefixCache as JCache
from repro.serve import Request as JRequest
from repro_torch import configs as tconfigs
from repro_torch.quant import PrecisionPlan as TPlan
from repro_torch.serve import PageAllocator as TAlloc
from repro_torch.serve import PrefixCache as TCache
from repro_torch.serve import Request, ServeEngine
from repro_torch.serve import pages as pg


# ------------------------------------------------------------ unit mirrors
def _try(log, fn):
    try:
        log.append(("ok", fn()))
    except ValueError as e:
        log.append(("raise", str(e)))


def _alloc_order(A, C):
    a = A(5)
    return [a.alloc(3), a.n_used, a.n_free]


def _incref_decref(A, C):
    a = A(6)
    ids = a.alloc(2)
    a.incref(ids)
    log = [ids, a.refcount(ids[0]), a.n_used]
    a.free(ids)
    log += [a.refcount(ids[0]), a.n_used]
    a.free(ids)
    log += [a.n_used, a.refcount(ids[0]), a.used_pages()]
    a.check_leaks(0)
    return log


def _incref_free_page(A, C):
    a, log = A(4), []
    _try(log, lambda: a.incref([2]))
    (pid,) = a.alloc(1)
    a.free([pid])
    _try(log, lambda: a.incref([pid]))
    _try(log, lambda: a.incref([0]))
    return log


def _double_free(A, C):
    a, log = A(4), []
    (pid,) = a.alloc(1)
    a.incref([pid])
    a.free([pid])
    a.free([pid])
    _try(log, lambda: a.free([pid]))
    _try(log, lambda: a.free([0]))
    return log + [a.n_free]


def _cached(a, cache, prompt):
    ids = a.alloc(len(prompt) // cache.page_size)
    cache.insert(prompt, ids)
    a.free(ids)
    return ids


def _match_capped(A, C):
    a = A(8)
    cache = C(4, a)
    prompt = np.arange(8, dtype=np.int32)
    ids = _cached(a, cache, prompt)
    return [ids, cache.match(prompt), cache.match(np.arange(9, dtype=np.int32)),
            cache.match(np.arange(4, 12, dtype=np.int32))]


def _use_takes_refs(A, C):
    a = A(8)
    cache = C(4, a)
    prompt = np.arange(9, dtype=np.int32)
    ids = _cached(a, cache, prompt)
    log = [ids, [a.refcount(i) for i in ids]]
    cache.match(prompt)
    log.append([a.refcount(i) for i in ids])
    got = cache.use(prompt)
    log += [got, [a.refcount(i) for i in ids]]
    a.free(got)
    return log


def _evict_lru(A, C):
    a = A(16)
    cache = C(4, a)
    p1, p2 = np.arange(0, 5, dtype=np.int32), np.arange(100, 105, dtype=np.int32)
    (id1,), (id2,) = _cached(a, cache, p1), _cached(a, cache, p2)
    held = cache.use(p1)
    log = [id1, id2, cache.evict(2), a.refcount(id2), a.refcount(id1), cache.evict(1)]
    a.free(held)
    log += [cache.evict(1), cache.evictions]
    a.check_leaks(0)
    return log


def _lru_stalest(A, C):
    a = A(16)
    cache = C(4, a)
    p1, p2 = np.arange(0, 5, dtype=np.int32), np.arange(100, 105, dtype=np.int32)
    (id1,), (id2,) = _cached(a, cache, p1), _cached(a, cache, p2)
    cache.use(p1) and a.free(cache.match(p1))
    return [cache.evict(1), a.refcount(id2), a.refcount(id1)]


def _release_all(A, C):
    a = A(16)
    cache = C(4, a)
    _cached(a, cache, np.arange(9, dtype=np.int32))
    _cached(a, cache, np.arange(50, 63, dtype=np.int32))
    log = [cache.n_pages, cache.release_all(), cache.n_pages, a.n_used]
    a.check_leaks(0)
    return log


def _shared_tail_and_checksum(A, C):
    """Two prompts sharing one page, then a corrupt page found at use: the
    subtree goes, the match is cut there."""
    a = A(16)
    sums = {}
    cache = C(4, a, checksum_fn=lambda p: sums.get(p, 0))
    ids1 = _cached(a, cache, np.arange(12, dtype=np.int32))
    b = np.concatenate([np.arange(4), np.arange(70, 78)]).astype(np.int32)
    ids2 = a.alloc(3)
    fresh = cache.insert(b, ids2)
    a.free(ids2)
    sums[ids1[1]] = 99                       # page 2 of prompt 1 changed
    got = cache.use(np.arange(13, dtype=np.int32))
    log = [ids1, ids2, fresh, got, cache.corrupt_evictions, cache.n_pages,
           a.used_pages()]
    a.free(got)
    log.append(cache.release_all())
    a.check_leaks(0)
    return log


SCENARIOS = {f.__name__[1:]: f for f in (
    _alloc_order, _incref_decref, _incref_free_page, _double_free, _match_capped,
    _use_takes_refs, _evict_lru, _lru_stalest, _release_all, _shared_tail_and_checksum)}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_allocator_and_trie_mirror_reference(name):
    assert SCENARIOS[name](TAlloc, TCache) == SCENARIOS[name](JAlloc, JCache)


def test_pool_nbytes_and_scrub():
    kw = dict(n_layers=2, n_pages=8, page_size=8, n_kv=2, head_dim=64)
    for bits in (0, 8, 4):
        pool = pg.init_pool(**kw, kv_bits=bits)
        assert pg.pool_nbytes(pool, n_pages=3) * 8 == pg.pool_nbytes(pool) * 3
        pool.k_pages.fill_(1)
        if bits:
            pool.k_scale.fill_(2.0)
        assert pg.scrub_pages(pool, [2, 5]) is pool
        assert int(pool.k_pages[:, [2, 5]].abs().sum()) == 0
        assert int(pool.k_pages[:, 3].ne(0).sum()) == pool.k_pages[:, 3].numel()
        if bits:
            assert bool((pool.k_scale[:, [2, 5]] == 1).all())


# ----------------------------------------------------------------- engines
@pytest.fixture(scope="module")
def model():
    jcfg = dataclasses.replace(jconfigs.get_reduced("gemma-2b"), dtype=jnp.float32)
    tcfg = tconfigs.get_reduced("gemma-2b", dtype=torch.float32)
    params = jax.jit(lambda k: JT.init_params(k, jcfg))(jax.random.PRNGKey(0))
    return {"jcfg": jcfg, "tcfg": tcfg, "jp": params, "tp": bridge(params)}


def _family(cls, n, *, sys_len=8, n_families=2, max_new=4, seed=5, vocab=512):
    """The reference's ``_family_trace``: shared system prompts + unique tails."""
    rng = np.random.default_rng(seed)
    fams = [rng.integers(0, vocab, sys_len) for _ in range(n_families)]
    return [cls(rid=i, prompt=np.concatenate(
                [fams[i % n_families], rng.integers(0, vocab, int(rng.integers(2, 6)))]),
                max_new_tokens=max_new)
            for i in range(n)]


def _both(m, kv_bits, reqs_fn, **kw):
    jeng = ref_engine(m["jp"], m["jcfg"], plan=JPlan(kv_bits=kv_bits), backend="ref", **kw)
    teng = ServeEngine(m["tp"], m["tcfg"], plan=TPlan(kv_bits=kv_bits), device="cpu", **kw)
    want = {r: f.tokens.tolist() for r, f in jeng.run(reqs_fn(JRequest)).items()}
    got = {r: f.tokens.tolist() for r, f in teng.run(reqs_fn(Request)).items()}
    return jeng, teng, want, got


PREFIX_KW = dict(max_slots=3, page_size=4, max_seq_len=32, chunk_pages=2)


@pytest.mark.parametrize("kv_bits", [0, 8, 4])
def test_prefix_chunked_trace_equals_reference_chunked(model, kv_bits):
    jeng, teng, want, got = _both(model, kv_bits, lambda c: _family(c, 6),
                                  prefix_cache=True, **PREFIX_KW)
    assert got == want and sorted(got) == list(range(6))
    assert teng.stats["prefix_hits"] == jeng.stats["prefix_hits"] >= 1
    for key in ("prefix_misses", "prefix_hit_tokens", "prefill_chunks", "prefill_tokens",
                "max_prefill_tokens_per_step", "decode_steps"):
        assert teng.stats[key] == jeng.stats[key], key
    assert teng.kv_pool_nbytes(used_only=True) == jeng.kv_pool_nbytes(used_only=True)
    cold = ServeEngine(model["tp"], model["tcfg"], plan=TPlan(kv_bits=kv_bits),
                       device="cpu", **PREFIX_KW).run(_family(Request, 6))
    assert {r: f.tokens.tolist() for r, f in cold.items()} == got
    assert teng.release_prefix_cache() >= 1
    teng.allocator.check_leaks(0)


def test_chunked_matches_monolithic_at_raw_kv(model):
    """Raw KV: write-then-attend is lossless, so chunks of one page give the
    monolithic engine's tokens; decode interleaves with a long prompt."""
    kw = dict(max_slots=2, page_size=4, max_seq_len=64)
    reqs = _family(Request, 4, sys_len=9)
    rng = np.random.default_rng(9)
    reqs.append(Request(rid=9, prompt=rng.integers(0, 512, 40), max_new_tokens=4))
    mono = ServeEngine(model["tp"], model["tcfg"], device="cpu", **kw).run(reqs)
    eng = ServeEngine(model["tp"], model["tcfg"], device="cpu", chunk_pages=1, **kw)
    both = 0
    for r in reqs:
        eng.submit(r)
    out = {}
    while eng.busy:
        pf0, ds0 = eng.stats["prefill_tokens"], eng.stats["decode_steps"]
        out.update({f.rid: f for f in eng.step()})
        both += eng.stats["prefill_tokens"] > pf0 and eng.stats["decode_steps"] > ds0
    for rid in mono:
        np.testing.assert_array_equal(mono[rid].tokens, out[rid].tokens)
    assert eng.stats["max_prefill_tokens_per_step"] <= 4 and both >= 3
    eng.allocator.check_leaks(0)


def _preempt_trace(cls, n=4, seed=4):
    rng = np.random.default_rng(seed)
    return [cls(rid=i, prompt=rng.integers(0, 512, 6), max_new_tokens=8) for i in range(n)]


@pytest.mark.parametrize("kv_bits", [0, 8, 4])
def test_reserve_none_preempts_like_reference(model, kv_bits):
    kw = dict(max_slots=3, page_size=4, max_seq_len=32, n_pages=8, reserve="none")
    jeng, teng, want, got = _both(model, kv_bits, _preempt_trace, **kw)
    assert got == want
    assert teng.stats["preemptions"] == jeng.stats["preemptions"] >= 1
    full = ServeEngine(model["tp"], model["tcfg"], plan=TPlan(kv_bits=kv_bits),
                       device="cpu", max_slots=3, page_size=4, max_seq_len=32)
    assert {r: f.tokens.tolist() for r, f in full.run(_preempt_trace(Request)).items()} \
        == got
    teng.allocator.check_leaks(0)


def test_prefix_sharer_preemption_like_reference(model):
    """The reference's C2 case, held against the reference's own
    prefix + chunked engine under the same pool pressure."""
    kw = dict(max_slots=3, page_size=4, max_seq_len=32, n_pages=10, reserve="none",
              prefix_cache=True, chunk_pages=1)
    jeng, teng, want, got = _both(
        model, 8, lambda c: _family(c, 5, n_families=1, max_new=6), **kw)
    assert got == want
    for key in ("preemptions", "prefix_hits", "prefix_hit_tokens", "decode_steps"):
        assert teng.stats[key] == jeng.stats[key], key
    assert teng.stats["preemptions"] >= 1
    teng.release_prefix_cache()
    teng.allocator.check_leaks(0)


def test_t_submit_kept_and_autoscaler_deferred_during_replay(model):
    """A requeued victim keeps its submit time; a governor that asks for 4
    bits exactly while a replay is in flight never gets them."""
    from repro_torch.precision.qat import quantize_param_tree

    bp = quantize_param_tree(model["tp"], bits=8, layout="bitplane")

    class Dip:
        def __init__(self):
            self.calls, self.eng = [], None

        def observe(self, *, admit_wait_ms, queue_depth, now=None):
            self.calls.append(self.eng._replaying())
            return 4 if self.calls[-1] else 8

    clk, gov = [0.0], Dip()
    kw = dict(plan=TPlan(kv_bits=8), max_slots=3, page_size=4, max_seq_len=32,
              n_pages=8, reserve="none", device="cpu")
    eng = gov.eng = ServeEngine(bp, model["tcfg"], autoscaler=gov, clock=lambda: clk[0],
                                **kw)
    submit_t, seen = {}, False
    for i, r in enumerate(_preempt_trace(Request)):
        clk[0] = float(i)
        eng.submit(r)
        submit_t[r.rid] = clk[0]
    out = {}
    while eng.busy:
        clk[0] += 1.0
        out.update({f.rid: f for f in eng.step()})
        if eng._queue and eng._queue[0]["replay"].size:
            seen = True
            assert eng._queue[0]["t_submit"] == submit_t[eng._queue[0]["req"].rid]
    assert seen and any(gov.calls) and eng.weight_bits == 8
    fixed = ServeEngine(bp, model["tcfg"], **kw).run(_preempt_trace(Request))
    for rid in out:
        np.testing.assert_array_equal(out[rid].tokens, fixed[rid].tokens)
    eng.allocator.check_leaks(0)
