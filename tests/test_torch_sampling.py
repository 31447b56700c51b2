"""Port parity — sampling (repro_torch.serve.sampling vs repro.serve.sampling,
and the engine's sampled decode and sampled verify against the reference
engine's), on the CPU with the reduced gemma-2b at f32, the reference's
weights bridged across.

* ``slot_key`` and ``window_keys`` are bit-equal to the reference's
  ``fold_in``; the uniform plane under each key is bit-equal to
  ``jax.random.uniform(minval=tiny)``; the Gumbel noise ``-log(-log(u))``
  differs from XLA's in the last bits of ~23 % of elements (at most
  9.5e-7 absolute in the measurement that set the bound below), torch's
  ``log`` not being XLA's;
* ``sample_tokens`` gives the reference's tokens on (8, 1000) f32 logits
  over temperatures {0, 0.5, 1, 2} × top-k {0, 1, 5, 50} × 64 keys, with
  ties at the k-th logit: the measured flip rate was 0 of 8192 draws, so
  the tests hold tokens equal;
* the engine: a mixed greedy / sampled trace through monolithic admission
  at kv 0/8/4, and self-speculative decoding of bitplane weights at
  temperature 0.8 at kv 0/8/4, give the reference engine's tokens; a sampled request
  served alone gives the tokens it gets in the batch.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from torch_bridge import bridge, key as tkey, ref_engine

from repro import configs as jconfigs
from repro.models import transformer as JT
from repro.precision.qat import quantize_param_tree as jquantize
from repro.quant import PrecisionPlan as JPlan
from repro.serve import Request as JRequest
from repro.serve import sampling as JS
from repro_torch import configs as tconfigs
from repro_torch import prng
from repro_torch.quant import PrecisionPlan as TPlan
from repro_torch.serve import Request, ServeEngine
from repro_torch.serve import sampling as TS

NOISE_ABS = 2e-6          # measured max |torch − XLA| Gumbel noise: 9.5e-7
EKW = dict(max_slots=3, page_size=8, max_seq_len=40)


def _keys(seed, n=8):
    base = jax.random.fold_in(jax.random.PRNGKey(seed), 3)
    jk = jax.vmap(lambda p: JS.slot_key(base, p))(jnp.arange(n) + 5)
    return jk, TS.slot_key(tkey(base), torch.arange(n) + 5)


@pytest.mark.parametrize("seed", [0, 1, 2**31 - 1])
def test_slot_and_window_keys_bit_equal(seed):
    jk, tk = _keys(seed)
    np.testing.assert_array_equal(np.asarray(jk).astype(np.int64), tk.numpy())
    bases = jax.random.split(jax.random.PRNGKey(seed), 3)
    pos = np.arange(12, dtype=np.int32).reshape(3, 4) * 7
    jw = np.asarray(JS.window_keys(bases, jnp.asarray(pos))).astype(np.int64)
    tw = TS.window_keys(np.asarray(bases).astype(np.int64), pos)
    assert tw.shape == (3, 4, 2)
    np.testing.assert_array_equal(jw, tw.numpy())
    # one key, one position: the engine's first-token key
    np.testing.assert_array_equal(
        np.asarray(JS.slot_key(bases[0], 9)).astype(np.int64),
        TS.slot_key(np.asarray(bases[0]).astype(np.int64), 9).numpy())


def test_uniform_plane_bit_equal_and_noise_close():
    jk, tk = _keys(4)
    tiny = jnp.finfo(jnp.float32).tiny
    ju = jax.vmap(lambda k: jax.random.uniform(k, (1000,), jnp.float32, tiny, 1.0))(jk)
    tu = prng.uniform(tk, (1000,)).clamp_min(TS.TINY)
    np.testing.assert_array_equal(np.asarray(ju), tu.numpy())
    jg = np.asarray(jax.vmap(lambda k: jax.random.gumbel(k, (1000,), jnp.float32))(jk))
    tg = (-torch.log(-torch.log(tu))).numpy()
    assert np.abs(jg - tg).max() <= NOISE_ABS


@pytest.fixture(scope="module")
def jsample():
    return jax.jit(JS.sample_tokens)


@pytest.mark.parametrize("top_k", [0, 1, 5, 50])
@pytest.mark.parametrize("temperature", [0.0, 0.5, 1.0, 2.0])
def test_sample_tokens_equal(jsample, temperature, top_k):
    """8 seeds × 8 rows = 64 keys; each row's logits carry ties (column 7
    repeats column 3, and rows 0–1 repeat their 5th-largest value), so the
    k-th logit is tied for some k: every tied logit is kept."""
    for seed in range(8):
        rng = np.random.default_rng(seed)
        logits = (rng.normal(size=(8, 1000)) * 3).astype(np.float32)
        logits[:, 7] = logits[:, 3]
        for r in (0, 1):
            logits[r, 11] = np.sort(logits[r])[-5]
        jk, tk = _keys(seed)
        temps = np.full(8, temperature, np.float32)
        temps[::3] = 0.0 if temperature else temps[::3]       # greedy rows mixed in
        tks = np.full(8, top_k, np.int32)
        want = np.asarray(jsample(jnp.asarray(logits), jnp.asarray(temps),
                                  jnp.asarray(tks), jk))
        got = TS.sample_tokens(torch.from_numpy(logits), temps, tks, tk)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.fixture(scope="module")
def model():
    jcfg = dataclasses.replace(jconfigs.get_reduced("gemma-2b"), dtype=jnp.float32)
    tcfg = tconfigs.get_reduced("gemma-2b", dtype=torch.float32)
    params = jax.jit(lambda k: JT.init_params(k, jcfg))(jax.random.PRNGKey(0))
    return {"jcfg": jcfg, "tcfg": tcfg, "jp": params, "tp": bridge(params)}


def _mixed(cls, n=6, seed=3, vocab=512):
    """Alternating greedy and sampled requests (temperature 0.8, top-k 5 /
    none), the reference's sampled-verify trace's shape."""
    rng = np.random.default_rng(seed)
    return [cls(rid=i, prompt=rng.integers(0, vocab, 4 + 3 * i), max_new_tokens=8,
                temperature=0.8 if i % 2 else 0.0,
                top_k=(5 if i % 4 == 1 else 0) if i % 2 else 0, seed=7)
            for i in range(n)]


def _toks(res):
    return {rid: f.tokens.tolist() for rid, f in res.items()}


@pytest.mark.parametrize("kv_bits", [0, 8, 4])
def test_engine_mixed_sampled_trace_equals_reference(model, kv_bits):
    jeng = ref_engine(model["jp"], model["jcfg"], plan=JPlan(kv_bits=kv_bits),
                      backend="ref", **EKW)
    teng = ServeEngine(model["tp"], model["tcfg"], plan=TPlan(kv_bits=kv_bits),
                       device="cpu", **EKW)
    want = _toks(jeng.run(_mixed(JRequest)))
    got = _toks(teng.run(_mixed(Request)))
    assert got == want
    for key in ("decode_steps", "decode_tokens", "prefill_tokens"):
        assert teng.stats[key] == jeng.stats[key], key
    teng.allocator.check_leaks(0)


def test_sampled_request_alone_equals_batched(model):
    """The key is (seed, rid, position): a sampled request's tokens do not
    depend on what shares its batch."""
    reqs = _mixed(Request)
    batched = ServeEngine(model["tp"], model["tcfg"], plan=TPlan(kv_bits=8),
                          device="cpu", **EKW).run(reqs)
    for r in reqs[1::2]:
        solo = ServeEngine(model["tp"], model["tcfg"], plan=TPlan(kv_bits=8),
                           device="cpu", **{**EKW, "max_slots": 1}).run([r])
        np.testing.assert_array_equal(solo[r.rid].tokens, batched[r.rid].tokens)


@pytest.mark.parametrize("kv_bits", [0, 8, 4])
def test_sampled_spec_decode_equals_vanilla_and_reference(model, kv_bits):
    """Bitplane weights, spec_decode 3 with a 4-bit draft, temperature 0.8:
    the verify window samples each position with sequential decode's key."""
    j8 = jax.jit(lambda p: jquantize(p, bits=8, layout="bitplane"))(model["jp"])
    t8 = bridge(j8)
    kw = dict(EKW, max_slots=2)
    reqs = _mixed(Request, n=4)
    vanilla = _toks(ServeEngine(t8, model["tcfg"], plan=TPlan(kv_bits=kv_bits), device="cpu",
                                **kw).run(reqs))
    teng = ServeEngine(t8, model["tcfg"], plan=TPlan(kv_bits=kv_bits), device="cpu",
                       spec_decode=3, draft_bits=4, **kw)
    jeng = ref_engine(j8, model["jcfg"], plan=JPlan(kv_bits=kv_bits), backend="ref",
                      spec_decode=3, draft_bits=4, **kw)
    got = _toks(teng.run(reqs))
    want = _toks(jeng.run(_mixed(JRequest, n=4)))
    assert got == vanilla == want
    assert teng.stats["spec_steps"] >= 1
    for key in ("spec_steps", "spec_draft_tokens", "spec_accepted_tokens"):
        assert teng.stats[key] == jeng.stats[key], key
    teng.allocator.check_leaks(0)
