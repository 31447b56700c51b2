"""Port parity — slice 12, the audio family (musicgen-medium: 48 layers,
d_model 1536, 24 MHA heads of 64, a gelu MLP of 6144, vocab 2048;
reduced: 2 layers, 4 heads of 16) — the dense layer under another family
name, so the paged engine and the legacy ring loop serve it and the
training loss runs the dense code — against the reference at its
``REDUCED`` config, at f32 (ROADMAP C1), with the reference's params
bridged across and its programs jitted (C4).

Tolerances: engine tokens, stats and KV pool bytes identical; the legacy
loop's logits and ``loss_fn`` within ``RTOL`` = 1e-5 of the reference's
largest magnitude (f32 sums in another order); greedy tokens equal.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_bridge import bridge, np32, serve_both

from repro import configs as jconfigs
from repro.models import transformer as JT
from repro.precision.qat import quantize_param_tree as jquantize
from repro.quant import PrecisionPlan as JPlan
from repro_torch import configs as tconfigs
from repro_torch.launch.steps import make_prefill_step, make_serve_step
from repro_torch.models import transformer as TT
from repro_torch.quant import PrecisionPlan as TPlan
from repro_torch.serve.engine import SUPPORTED_FAMILIES

ARCH = "musicgen-medium"
RTOL = 1e-5
STEPS = 8


def _pair(bits=0, kv_bits=0):
    plan = dict(kv_bits=kv_bits, model_bits=bits, model_storage="int" if bits else "fake")
    jcfg = dataclasses.replace(jconfigs.get_reduced(ARCH), dtype=jnp.float32,
                               precision=JPlan(**plan))
    tcfg = tconfigs.get_reduced(ARCH, dtype=torch.float32, precision=TPlan(**plan))
    jp = _jinit(bits)
    return jcfg, tcfg, jp, bridge(jp)


@functools.lru_cache(maxsize=None)
def _jinit(bits):
    """The reference's f32 params from ``PRNGKey(2)``, int codes at
    ``bits``: the draw and the encode each one jitted program, made once a
    file (eager, they compile op by op)."""
    jcfg = dataclasses.replace(jconfigs.get_reduced(ARCH), dtype=jnp.float32)
    jp = jax.jit(lambda k: JT.init_params(k, jcfg))(jax.random.PRNGKey(2))
    return jax.jit(lambda p: jquantize(p, bits=bits))(jp) if bits else jp


def _close(got, want):
    want = np32(want)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(np32(got), want, rtol=RTOL,
                               atol=RTOL * float(np.abs(want).max()))


def test_config_fields_match_reference():
    """Every field of the port's ``ModelConfig``, full size and reduced,
    equals the reference's (the dtype by name); audio is a family the
    engine serves, as in the reference."""
    skip = {"dtype", "precision"}
    for get in ("get_config", "get_reduced"):
        jcfg, tcfg = getattr(jconfigs, get)(ARCH), getattr(tconfigs, get)(ARCH)
        for f in dataclasses.fields(tcfg):
            if f.name not in skip:
                assert getattr(tcfg, f.name) == getattr(jcfg, f.name), (get, f.name)
        assert str(tcfg.dtype).removeprefix("torch.") == jnp.dtype(jcfg.dtype).name
    cfg = tconfigs.get_config(ARCH)
    assert (cfg.family, cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.head_dim, cfg.d_ff, cfg.vocab_size, cfg.mlp_act) == \
        ("audio", 48, 1536, 24, 24, 64, 6144, 2048, "gelu")
    assert ARCH in tconfigs.ARCH_IDS and "audio" in SUPPORTED_FAMILIES


@pytest.mark.parametrize("bits", [0, 8, 4])
def test_engine_tokens_identical_f32(bits):
    """``serve_engine``'s engine on the reduced model at weight/KV bits
    ``bits`` against the reference's engine on the same trace: every
    request's tokens, the stats and the KV pool's bytes identical, no page
    leaked."""
    jeng, teng, jres, tres = serve_both("f32", bits, bits, arch=ARCH)
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


@pytest.mark.parametrize("kv_bits", [0, 8, 4])
def test_legacy_ring_loop_matches_reference(kv_bits):
    """The legacy loop's ring path at KV bits ``kv_bits`` (8-bit weights):
    ``prefill_state`` of 2 × 12 tokens (``pad_to`` 12 + 8) and 8 greedy
    steps against the reference's jitted ``prefill`` and ``decode_step``:
    logits within ``RTOL`` after the prefill and every step, tokens equal,
    the ring's lengths equal."""
    jcfg, tcfg, jp, tp = _pair(8, kv_bits)
    toks = np.random.default_rng(4).integers(0, jcfg.vocab_size, (2, 12)).astype(np.int32)
    pad = toks.shape[1] + STEPS
    jl, js = jax.jit(lambda p, t: JT.prefill(p, t, jcfg, pad_to=pad))(jp, jnp.asarray(toks))
    tl, ts = make_prefill_step(tcfg, pad_to=pad)(tp, {"tokens": torch.from_numpy(toks)})
    _close(tl, jl)
    jstep = jax.jit(lambda p, s, t: JT.decode_step(p, s, t, jcfg))
    tstep = make_serve_step(tcfg)
    jtok = jnp.argmax(jl, -1).astype(jnp.int32)[:, None]
    ttok = torch.argmax(tl, -1).to(torch.int32)[:, None]
    for _ in range(STEPS):
        np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
        jlg, js = jstep(jp, js, jtok)
        tlg, tn, ts = tstep(tp, ts, ttok)
        _close(tlg, jlg)
        jtok = jnp.argmax(jlg[:, -1], -1).astype(jnp.int32)[:, None]
        ttok = tn[:, None]
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    np.testing.assert_array_equal(ts.layers.length.numpy(), np.asarray(js.layers.length))
    assert (ts.layers.k_scale is None) == (kv_bits == 0)


@pytest.mark.parametrize("bits", [0, 8])
def test_loss_matches_reference(bits):
    """``loss_fn`` (the training loss: the dense forward, gelu MLP, chunked
    cross-entropy over 2 × 32 tokens, two logit chunks) at weight bits
    ``bits`` within ``RTOL`` of the reference's, relative; at dense weights its
    gradient reaches the MLP's gate."""
    jcfg, tcfg, jp, tp = _pair(bits)
    toks = np.random.default_rng(5).integers(0, jcfg.vocab_size, (2, 33)).astype(np.int32)
    x, y = toks[:, :-1], toks[:, 1:]
    want = float(jax.jit(lambda p, a, b: JT.loss_fn(p, a, b, jcfg))(
        jp, jnp.asarray(x), jnp.asarray(y)))
    if bits:
        got = float(TT.loss_fn(tp, torch.from_numpy(x), torch.from_numpy(y), tcfg))
    else:
        w = tp["layers"]["mlp"]["gate"]["w"].requires_grad_()
        loss = TT.loss_fn(tp, torch.from_numpy(x), torch.from_numpy(y), tcfg)
        loss.backward()
        got = float(loss.detach())
        assert torch.isfinite(w.grad).all() and w.grad.abs().sum() > 0
    assert abs(got - want) <= RTOL * abs(want)
