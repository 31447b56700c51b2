"""Port parity — the reduced gemma-2b model (repro_torch.models vs
repro.models), with the reference's params bridged across.

* prefill logits at ``last_pos`` (prompts right-padded to a page multiple,
  as the engine pads them) and every layer's post-RoPE K/V match the
  reference's jitted ``T.prefill``;
* one paged decode step from engines admitted with the same requests gives
  the same logits.

Tolerances: ≤ 1e-4 at f32 compute dtype (summation order only); at bf16
≤ 3e-2 of the reference's largest magnitude, because XLA drops some bf16
roundings inside a fused layer (excess precision) that eager PyTorch keeps,
so values differ by bf16 ulps. At f32 a quantized KV code can still flip at
an exact rounding tie (one flip moves a logit by ~1e-3), and at bf16 an ulp
of difference flips 4-bit codes often: the decode test checks that the f32
pages agree, then starts both engines' step from the reference's pages.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from torch_bridge import (bridge, jax_decode_fn, jax_decode_logits, np32,
                          pool_from_jax)

from repro import configs as jconfigs
from repro.models import transformer as JT
from repro.precision import qat as jqat
from repro.quant import PrecisionPlan as JPlan
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JEngine
from repro_torch import configs as tconfigs
from repro_torch.models import transformer as TT
from repro_torch.quant import PrecisionPlan as TPlan
from repro_torch.serve import Request as TRequest
from repro_torch.serve import ServeEngine as TEngine

TOL = {"f32": 1e-4, "bf16": 3e-2}


def _setup(dtype: str, weight_bits: int, kv_bits: int = 0, seed: int = 0):
    jd, td = (jnp.float32, torch.float32) if dtype == "f32" else \
        (jnp.bfloat16, torch.bfloat16)
    jplan = JPlan(kv_bits=kv_bits, model_bits=weight_bits,
                  model_storage="int" if weight_bits else "fake")
    tplan = TPlan(kv_bits=kv_bits, model_bits=weight_bits,
                  model_storage="int" if weight_bits else "fake")
    jcfg = dataclasses.replace(jconfigs.get_reduced("gemma-2b"), dtype=jd,
                               precision=jplan)
    tcfg = tconfigs.get_reduced("gemma-2b", dtype=td, precision=tplan)
    jp = JT.init_params(jax.random.PRNGKey(seed), jcfg)
    if weight_bits:
        jp = jqat.quantize_param_tree(jp, bits=weight_bits)
    return jcfg, tcfg, jp, bridge(jp), jplan, tplan


def _close(got, want, dtype):
    want = np32(want)
    scale = 1.0 if dtype == "f32" else float(np.abs(want).max())
    np.testing.assert_allclose(np32(got), want, rtol=0, atol=TOL[dtype] * scale)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("weight_bits", [0, 8, 4])
def test_prefill_matches_reference(dtype, weight_bits):
    jcfg, tcfg, jp, tp, _, _ = _setup(dtype, weight_bits)
    rng = np.random.default_rng(1)
    s, bucket = 13, 16
    toks = np.zeros((2, bucket), np.int32)
    toks[:, :s] = rng.integers(0, jcfg.vocab_size, (2, s))
    jlogits, jstate = jax.jit(lambda p, t: JT.prefill(p, t, jcfg, last_pos=s - 1))(
        jp, jnp.asarray(toks))
    tlogits, (tk, tv) = TT.prefill(tp, torch.from_numpy(toks), tcfg, last_pos=s - 1)
    v = jcfg.vocab_size
    _close(tlogits[:, :v], jlogits[:, :v], dtype)
    assert tk.shape == jstate.layers.k.shape and tk.dtype == tcfg.dtype
    _close(tk, jstate.layers.k, dtype)
    _close(tv, jstate.layers.v, dtype)
    if dtype == "f32":
        assert np.array_equal(np32(tlogits).argmax(-1), np32(jlogits).argmax(-1))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("weight_bits,kv_bits", [(0, 0), (8, 8), (4, 4)])
def test_one_paged_decode_step_matches_reference(dtype, weight_bits, kv_bits):
    jcfg, tcfg, jp, tp, jplan, tplan = _setup(dtype, weight_bits, kv_bits, seed=4)
    kw = dict(max_slots=4, page_size=8, max_seq_len=40)
    jeng = JEngine(jp, jcfg, plan=jplan, backend="ref", **kw)
    teng = TEngine(tp, tcfg, plan=tplan, device="cpu", **kw)
    rng = np.random.default_rng(3)
    for rid, s in enumerate((5, 16, 11)):          # slot 3 stays inactive
        prompt = rng.integers(0, jcfg.vocab_size, s)
        jeng.submit(JRequest(rid=rid, prompt=prompt, max_new_tokens=8))
        teng.submit(TRequest(rid=rid, prompt=prompt, max_new_tokens=8))
    jeng._admit([])
    teng._admit([])
    np.testing.assert_array_equal(teng._bt, jeng._bt)
    np.testing.assert_array_equal(teng._lens, jeng._lens)
    if dtype == "f32":
        np.testing.assert_array_equal(teng._last_tok, jeng._last_tok)  # prefill argmax
    if kv_bits and dtype == "f32":
        for name in ("k_pages", "v_pages"):
            np.testing.assert_array_equal(np32(getattr(teng.pool, name)),
                                          np32(getattr(jeng.pool, name)))
        for name in ("k_scale", "v_scale"):
            np.testing.assert_allclose(np32(getattr(teng.pool, name)),
                                       np32(getattr(jeng.pool, name)), rtol=1e-5)
    # the step starts from the reference's pages: at bf16 an ulp of
    # difference in a prompt row can flip a 4-bit code
    teng.pool = pool_from_jax(jeng.pool)
    args = (jeng._last_tok, jeng._lens, jeng._bt, jeng._active)
    want = jax_decode_logits(jeng, jax_decode_fn(jeng), *args)
    got = teng.decode_logits(*args)
    v = jcfg.vocab_size
    act = jeng._active
    _close(got[act, :v], np32(want)[act, :v], dtype)
    if dtype == "f32":
        assert np.array_equal(np32(got)[act].argmax(-1), np32(want)[act].argmax(-1))
