"""Port parity — the rest of the dense family (repro_torch vs repro).

gemma-7b (MHA), granite-3-8b (GQA, vocab 49155 padded to 49408 at full
width) and qwen2.5-14b (GQA with q/k/v bias) at the reference's ``REDUCED``
configs, f32 compute, with the reference's params bridged across as numpy
and nonzero q/k/v biases drawn from a numpy seed into both trees (the
reference initialises them at zero, so a bias never added would pass):

* the paged engine: the same ``make_trace`` through the reference
  ``ServeEngine(backend="ref")`` and the port's at weight/KV bits (0, 0),
  (8, 8) and (4, 4) — greedy tokens identical, the same stats and KV
  bytes, no page leaked;
* the legacy loop's ring-buffer KV cache: ``prefill_state`` + 8 greedy
  ``decode_step`` calls against the reference's jitted ``prefill(...,
  pad_to=)`` + ``decode_step`` at KV bits 0, 8 and 4 — logits within rtol
  1e-5 of the largest (f32 sums in another order), greedy tokens
  identical, and the cache's codes, scales and lengths equal after the
  prefill and after the last step (its raw f32 rows at KV bits 0 within
  the logits' tolerance).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_bridge import bridge, np32, serve_both, with_biases

from repro import configs as jconfigs
from repro.models import transformer as JT
from repro.precision.qat import quantize_param_tree as jquantize
from repro.quant import PrecisionPlan as JPlan
from repro_torch import configs as tconfigs
from repro_torch.launch.steps import make_prefill_step, make_serve_step
from repro_torch.models import transformer as TT
from repro_torch.quant import PrecisionPlan as TPlan

ARCHS = ["gemma-7b", "granite-3-8b", "qwen2.5-14b"]
BIAS_SEED = 5
RTOL = 1e-5
STEPS = 8


@pytest.mark.parametrize("bits", [0, 8, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_engine_tokens_identical_f32(arch, bits):
    jeng, teng, jres, tres = serve_both("f32", bits, bits, arch=arch,
                                        bias_seed=BIAS_SEED)
    assert sorted(tres) == sorted(jres) == list(range(8))
    for rid, want in jres.items():
        got = tres[rid]
        np.testing.assert_array_equal(got.tokens, want.tokens)
        assert (got.prompt_len, got.n_generated, got.reason) == \
            (want.prompt_len, want.n_generated, want.reason)
    assert teng.stats["finished"] == teng.stats["admitted"] == 8
    teng.allocator.check_leaks(0)
    for key in ("decode_steps", "decode_tokens", "prefill_tokens"):
        assert teng.stats[key] == jeng.stats[key], key
    assert teng.kv_pool_nbytes() == jeng.kv_pool_nbytes()


def _ring_pair(arch, bits, batch=2, prompt=9):
    """Both models at ``bits`` weight/KV bits with biased params, the
    prompts, and the cache size prompt + STEPS + 2 (spare rows)."""
    plan = dict(kv_bits=bits, model_bits=bits, model_storage="int" if bits else "fake")
    jcfg = dataclasses.replace(jconfigs.get_reduced(arch), dtype=jnp.float32,
                               precision=JPlan(**plan))
    tcfg = tconfigs.get_reduced(arch, dtype=torch.float32, precision=TPlan(**plan))
    params = with_biases(JT.init_params(jax.random.PRNGKey(1), jcfg), BIAS_SEED)
    if bits:
        params = jquantize(params, bits=bits)
    tokens = np.random.default_rng(3).integers(0, jcfg.vocab_size, (batch, prompt))
    return jcfg, tcfg, params, tokens, prompt + STEPS + 2


def _assert_cache_equal(jstate, tstate):
    jc, tc = jstate.layers, tstate.layers
    np.testing.assert_array_equal(np.asarray(jc.length), tc.length.numpy())
    assert (jc.k_scale is None) == (tc.k_scale is None)
    for name in ("k", "v", "k_scale", "v_scale"):
        want = getattr(jc, name)
        if want is None:
            continue
        got = getattr(tc, name)
        assert got.shape == want.shape, name
        if got.dtype in (torch.int8, torch.uint8):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=name)
        else:
            want = np32(want)
            np.testing.assert_allclose(np32(got), want, rtol=RTOL,
                                       atol=RTOL * float(np.abs(want).max()), err_msg=name)


@pytest.mark.parametrize("bits", [0, 8, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_ring_cache_prefill_and_decode_match_reference(arch, bits):
    jcfg, tcfg, jparams, tokens, smax = _ring_pair(arch, bits)
    tparams = bridge(jparams)
    jprefill = jax.jit(lambda p, t: JT.prefill(p, t, jcfg, pad_to=smax))
    jstep = jax.jit(lambda p, s, t: JT.decode_step(p, s, t, jcfg))
    tstep = make_serve_step(tcfg)

    jlog, jstate = jprefill(jparams, jnp.asarray(tokens, jnp.int32))
    tlog, tstate = make_prefill_step(tcfg, pad_to=smax)(
        tparams, {"tokens": torch.from_numpy(tokens)})
    assert tstate.layers.k.shape[:3] == (tcfg.n_layers, tokens.shape[0], smax)
    np.testing.assert_allclose(np32(tlog), np32(jlog), rtol=RTOL,
                               atol=RTOL * float(np.abs(np32(jlog)).max()))
    _assert_cache_equal(jstate, tstate)

    jtok = jnp.argmax(jlog, -1).astype(jnp.int32)[:, None]
    ttok = torch.argmax(tlog, -1).to(torch.int32)[:, None]
    for _ in range(STEPS):
        np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
        jl, jstate = jstep(jparams, jstate, jtok)
        tl, ttok_next, tstate = tstep(tparams, tstate, ttok)
        want = np32(jl)
        np.testing.assert_allclose(np32(tl), want, rtol=RTOL,
                                   atol=RTOL * float(np.abs(want).max()))
        jtok = jnp.argmax(jl[:, -1], -1).astype(jnp.int32)[:, None]
        ttok = ttok_next[:, None]
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    _assert_cache_equal(jstate, tstate)
    assert tstate.step == jstate.step == tokens.shape[1] + STEPS


def test_decode_step_leaves_its_state_as_it_was():
    """The legacy loop's warm-up step is thrown away: a step must not write
    into the ring cache it was given."""
    cfg = tconfigs.get_reduced("qwen2.5-14b", dtype=torch.float32,
                               precision=TPlan(kv_bits=8))
    params = TT.init_params(cfg, seed=0, device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 5), generator=torch.Generator().manual_seed(0))
    _, state = TT.prefill_state(params, tokens, cfg, pad_to=9)
    before = [t.clone() for t in state.layers]
    _, _, new = make_serve_step(cfg)(params, state, tokens[:, -1:].to(torch.int32))
    for was, now in zip(before, state.layers):
        assert torch.equal(was, now)
    assert int(new.layers.length[0, 0]) == 6 and int(state.layers.length[0, 0]) == 5


def test_init_decode_state_is_an_empty_ring_cache():
    for bits, dt, d in ((0, torch.bfloat16, 16), (8, torch.int8, 16), (4, torch.uint8, 8)):
        cfg = tconfigs.get_reduced("granite-3-8b", precision=TPlan(kv_bits=bits))
        st = TT.init_decode_state(cfg, 3, 12, device="cpu")
        assert st.layers.k.shape == (cfg.n_layers, 3, 12, cfg.n_kv_heads, d)
        assert st.layers.k.dtype == dt and st.step == 0
        assert not st.layers.length.any()
        assert (st.layers.k_scale is None) == (bits == 0)
