"""Port parity — slice 9: the hybrid family (zamba2-2.7b: Mamba2 layers with
one shared attention block after every ``shared_attn_every`` of them)
served through the legacy loop (the hybrid branches of
repro_torch.models.transformer, launch.serve.serve) against the reference,
at the reduced size, with the reference's params bridged across and inputs
made with numpy.

Tolerances: the model 1e-4 of the reference's largest magnitude at f32 and
2e-2 at bf16 (XLA's fused bf16 roundings against eager PyTorch's, as
``test_torch_ssm.py``); the weight codes and scales of
``quantize_param_tree`` byte-identical; greedy tokens equal; the ported
bookkeeping tests of ``tests/test_arch_smoke.py`` 2e-3, as there. The
shared KV caches: lengths, dtypes and shapes equal, f32 scales and raw rows
within the model's f32 tolerance, and the int8 / packed-int4 codes equal
but where a row lies within f32 noise of a rounding boundary — the rows
come out of Mamba2 layers whose f32 sums run in another order than XLA's —
there a code may differ by one step: at most ``CODE_FLIPS`` of the codes,
none by more than one. A decode step whose new K/V row rounds a code apart
so (measured: 1.04e-4 of the largest logit after one int8 flip) is held to
``FLIP_TOL`` instead of 1e-4; every other step to 1e-4.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_bridge import bridge, np32

from repro import configs as jconfigs
from repro.launch.steps import make_serve_step as jmake_serve_step
from repro.models import transformer as JT
from repro.precision.qat import quantize_param_tree as jquantize
from repro.quant import PrecisionPlan as JPlan
from repro_torch import configs as tconfigs
from repro_torch import prng
from repro_torch.launch.serve import serve, serve_engine
from repro_torch.launch.steps import make_prefill_step, make_serve_step
from repro_torch.models import transformer as TT
from repro_torch.precision.qat import quantize_param_tree as tquantize
from repro_torch.quant import PrecisionPlan as TPlan
from repro_torch.quant import QTensor
from repro_torch.serve import ServeEngine

ARCH = "zamba2-2.7b"
ROOT = Path(__file__).resolve().parents[1]
ENV = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
TOL = {"f32": 1e-4, "bf16": 2e-2}
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
# the reduced config, and one whose attention heads are 80 wide as the full
# model's (RoPE halves of 40, packed int4 rows of 40 bytes: no power of two)
SHAPES = {"reduced": {}, "head_dim 80": dict(head_dim=80, n_heads=2, n_kv_heads=2)}
STEPS = 4
CODE_FLIPS = 1e-3
FLIP_TOL = 1e-3


def _pair(dtype="f32", weight_bits=0, kv_bits=0, seed=0, **over):
    """Both reduced configs at ``dtype`` and bits, the reference's params
    (int codes at ``weight_bits``) and their bridge."""
    jd, td = DTYPES[dtype]
    plan = dict(kv_bits=kv_bits, model_bits=weight_bits,
                model_storage="int" if weight_bits else "fake")
    jcfg = dataclasses.replace(jconfigs.get_reduced(ARCH), dtype=jd,
                               precision=JPlan(**plan), **over)
    tcfg = tconfigs.get_reduced(ARCH, dtype=td, precision=TPlan(**plan), **over)
    jp = JT.init_params(jax.random.PRNGKey(seed), jcfg)
    if weight_bits:
        jp = jquantize(jp, bits=weight_bits)
    return jcfg, tcfg, jp, bridge(jp)


def _close(got, want, tol):
    want = np32(want)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(np32(got), want, rtol=0,
                               atol=tol * float(np.abs(want).max()))


def _assert_codes(got, want, name) -> int:
    """Cache codes (int8, or packed int4 as uint8) equal but for at most
    ``CODE_FLIPS`` of them one step apart; returns how many differ."""
    from repro_torch.quant.qtensor import unpack_int4

    want = torch.from_numpy(np.array(want))
    assert got.shape == want.shape and got.dtype == want.dtype, name
    if got.dtype == torch.uint8:
        got, want = unpack_int4(got), unpack_int4(want)
    diff = (got.to(torch.int32) - want.to(torch.int32)).abs()
    assert int(diff.max()) <= 1, name
    flips = int((diff > 0).sum())
    assert flips <= CODE_FLIPS * diff.numel(), (name, flips)
    return flips


def _assert_state(tstate, jstate, tol=TOL["f32"]) -> int:
    """Every Mamba2 cache within ``tol`` of the largest magnitude; every
    shared KV cache's lengths equal, its codes as ``_assert_codes``, its
    scales and raw rows within ``tol``; returns how many codes differ."""
    _close(tstate.layers.conv, jstate.layers.conv, tol)
    _close(tstate.layers.ssm, jstate.layers.ssm, tol)
    jc, tc = jstate.shared, tstate.shared
    np.testing.assert_array_equal(tc.length.numpy(), np.asarray(jc.length))
    assert (tc.k_scale is None) == (jc.k_scale is None)
    flips = 0
    for name in ("k", "v", "k_scale", "v_scale"):
        want = getattr(jc, name)
        if want is None:
            continue
        got = getattr(tc, name)
        if got.dtype in (torch.int8, torch.uint8):
            flips += _assert_codes(got, want, name)
        else:
            _close(got, want, tol)
    return flips


def test_config_fields_match_reference():
    """Every field the port's ``ModelConfig`` has, at full size and
    reduced, equals the reference's (the dtype by name); the full model's
    width and the registry's entry."""
    skip = {"dtype", "precision"}
    for get in ("get_config", "get_reduced"):
        jcfg, tcfg = getattr(jconfigs, get)(ARCH), getattr(tconfigs, get)(ARCH)
        for f in dataclasses.fields(tcfg):
            if f.name not in skip:
                assert getattr(tcfg, f.name) == getattr(jcfg, f.name), (get, f.name)
        assert str(tcfg.dtype).removeprefix("torch.") == jnp.dtype(jcfg.dtype).name
        assert tcfg.vocab_padded == jcfg.vocab_padded
    cfg = tconfigs.get_config(ARCH)
    spec = cfg.ssm_spec
    assert (cfg.n_layers, cfg.d_model, spec.n_heads, spec.head_dim, spec.d_state,
            cfg.shared_attn_every) == (54, 2560, 80, 64, 64, 9)
    assert ARCH in tconfigs.ARCH_IDS


def test_init_params_tree_matches_reference():
    """The port's own init has the reference's tree, shapes and dtypes:
    the stacked ``{"norm", "mamba"}`` layers and one unstacked
    ``shared_attn`` block."""
    jcfg, tcfg = jconfigs.get_reduced(ARCH), tconfigs.get_reduced(ARCH)
    jraw = JT.init_params(jax.random.PRNGKey(0), jcfg)
    traw = TT.init_params(tcfg, seed=0, device="cpu")
    want = {jax.tree_util.keystr(k): (tuple(v.shape), str(v.dtype))
            for k, v in jax.tree_util.tree_leaves_with_path(jraw)}
    got = {jax.tree_util.keystr(k): (tuple(v.shape), str(v.dtype).removeprefix("torch."))
           for k, v in jax.tree_util.tree_leaves_with_path(traw)}
    assert got == want
    assert sorted(traw["shared_attn"]) == ["attn", "ln1", "ln2", "mlp"]
    assert traw["shared_attn"]["attn"]["q"]["w"].shape == (tcfg.d_model,
                                                           tcfg.n_heads * tcfg.head_dim)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_forward_matches_reference(dtype):
    """The training forward (hidden states after the final norm) with
    bridged params against the reference's jitted ``forward``."""
    jcfg, tcfg, jp, tp = _pair(dtype)
    toks = np.random.default_rng(1).integers(0, jcfg.vocab_size, (2, 24)).astype(np.int32)
    want = jax.jit(lambda p, t: JT.forward(p, t, jcfg))(jp, jnp.asarray(toks))
    with torch.no_grad():
        got = TT.forward(tp, torch.from_numpy(toks), tcfg)
    assert got.dtype == DTYPES[dtype][1]
    _close(got, want, TOL[dtype])


def _prefill_both(kv_bits, shape, pad_to):
    jcfg, tcfg, jp, tp = _pair("f32", 0, kv_bits, **SHAPES[shape])
    toks = np.random.default_rng(2).integers(0, jcfg.vocab_size, (2, 20)).astype(np.int32)
    jl, js = jax.jit(lambda p, t: JT.prefill(p, t, jcfg, pad_to=pad_to))(
        jp, jnp.asarray(toks))
    tl, ts = TT.prefill_state(tp, torch.from_numpy(toks), tcfg, pad_to=pad_to)
    return jcfg, tcfg, jp, tp, (jl, js), (tl, ts)


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("kv_bits", [0, 8, 4])
def test_prefill_state_matches_reference(kv_bits, shape):
    """``prefill_state(pad_to=)`` against the reference's jitted
    ``prefill(pad_to=)``: the logits, every layer's conv and ssm cache, and
    the shared block's ring caches (one per application, ``pad_to`` rows)."""
    jcfg, tcfg, _, _, (jl, js), (tl, ts) = _prefill_both(kv_bits, shape, pad_to=28)
    _close(tl, jl, TOL["f32"])
    n_seg = tcfg.n_layers // tcfg.shared_attn_every
    assert ts.shared.k.shape[:3] == (n_seg, 2, 28) and ts.step == js.step == 20
    assert ts.layers.ssm.shape[0] == tcfg.n_layers
    _assert_state(ts, js)


def _state_from_jax(js) -> TT.DecodeState:
    """A reference hybrid ``DecodeState`` as the port's (copies)."""
    from repro_torch.interop import tensor_from_numpy as t
    from repro_torch.models.attention import KVCache
    from repro_torch.models.ssm import MambaCache

    return TT.DecodeState(MambaCache(t(js.layers.conv), t(js.layers.ssm)),
                          shared=KVCache(*[None if a is None else t(a) for a in js.shared]),
                          step=int(js.step))


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("kv_bits", [0, 8, 4])
def test_decode_steps_match_reference(kv_bits, shape):
    """``STEPS`` greedy ``decode_step`` calls, each from the reference's
    own state after the prefill or its previous step, bridged across (so a
    code that the two prefills round apart does not carry into the next
    step): every new cache (the shared caches' cursor one row further), the
    logits (within ``FLIP_TOL`` where the step's new row rounds a code
    apart) and the greedy token."""
    jcfg, tcfg, jp, tp, (jl, js), _ = _prefill_both(kv_bits, shape, pad_to=28)
    jstep = jax.jit(lambda p, s, t: JT.decode_step(p, s, t, jcfg))
    jtok = jnp.argmax(jl, -1).astype(jnp.int32)[:, None]
    for i in range(STEPS):
        tlg, ts = TT.decode_step(tp, _state_from_jax(js), torch.from_numpy(np.array(jtok)),
                                 tcfg)
        jlg, js = jstep(jp, js, jtok)
        assert ts.step == int(js.step) == 21 + i
        assert ts.shared.length.tolist() == [[21 + i] * 2] * 2
        flips = _assert_state(ts, js)
        _close(tlg, jlg, FLIP_TOL if flips else TOL["f32"])
        jtok = jnp.argmax(jlg[:, -1], -1).astype(jnp.int32)[:, None]
        np.testing.assert_array_equal(torch.argmax(tlg[:, -1], -1).numpy(),
                                      np.asarray(jtok[:, 0]))


def test_kv_divergence_starts_in_the_mamba2_sums():
    """Where the shared block's int KV codes start to part from the
    reference's (ROADMAP C22; ``scripts/hybrid_kv_divergence.py`` prints the
    whole table): the embedding is bit-equal; the first Mamba2 segment, fed
    the same input, already parts (its f32 sums run in another order than
    XLA's); and the shared block itself, fed the reference's own input,
    rounds every int8 and int4 K/V code as the reference does — so the
    codes that ``CODE_FLIPS`` allows come from the Mamba2 stream, not from
    the block."""
    from repro.models import attention as jattn
    from repro.models import ssm as jssm
    from repro.models.layers import embed as jembed
    from repro.models.layers import rmsnorm as jrmsnorm
    from repro_torch.models import ssm as tssm
    from repro_torch.models.layers import embed as tembed
    from repro_torch.models.layers import layer_view, rmsnorm
    from repro_torch.quant.qtensor import unpack_int4
    from repro_torch.serve.pages import quant_rows

    jcfg, tcfg, jp, tp = _pair("f32")
    toks = np.random.default_rng(2).integers(0, jcfg.vocab_size, (2, 20))
    k = jcfg.shared_attn_every
    hj = jembed(jp["embed"], jnp.asarray(toks, jnp.int32)).astype(jnp.float32)
    with torch.no_grad():
        ht = tembed(tp["embed"], torch.from_numpy(toks), torch.float32).to(torch.float32)
        np.testing.assert_array_equal(np32(ht), np32(hj))

        def jbody(h, layer):
            out, _ = jssm.mamba2_forward(layer["mamba"], jrmsnorm(layer["norm"], h),
                                         jcfg.ssm_spec, return_state=True)
            return h + out, None

        seg = jax.tree.map(lambda a: a[:k], jp["layers"])
        hj = jax.jit(lambda s, h: jax.lax.scan(jbody, h, s)[0])(seg, hj)
        for i in range(k):
            layer = layer_view(tp["layers"], i)
            out, _ = tssm.mamba2_forward(layer["mamba"], rmsnorm(layer["norm"], ht),
                                         tcfg.ssm_spec, return_state=True)
            ht = ht + out
        gap = float(np.abs(np32(ht) - np32(hj)).max() / np.abs(np32(hj)).max())
        assert 0 < gap < TOL["f32"]

        blk = jp["shared_attn"]
        _, (kj, vj) = jax.jit(lambda b, h: jattn.attention_block(
            b["attn"], jrmsnorm(b["ln1"], h), jcfg.attn_spec, return_kv=True))(blk, hj)
        _, kt, vt = TT._attn_block_kv(tcfg, tp["shared_attn"], torch.from_numpy(np32(hj)))
        for bits in (8, 4):
            for got, want in ((kt, kj), (vt, vj)):
                a = quant_rows(got, bits)[0]
                b = quant_rows(torch.from_numpy(np32(want)), bits)[0]
                if bits == 4:
                    a, b = unpack_int4(a), unpack_int4(b)
                assert torch.equal(a, b), bits


@pytest.mark.parametrize("shape", list(SHAPES))
def test_decode_chain_matches_reference(shape):
    """The port's own state carried through ``STEPS`` greedy steps from its
    prefill, against the reference's, at KV bits 0 (raw f32 rows: no code
    to round apart): logits, tokens and, after the last step, every cache."""
    jcfg, tcfg, jp, tp, (jl, js), (tl, ts) = _prefill_both(0, shape, pad_to=28)
    jstep = jax.jit(lambda p, s, t: JT.decode_step(p, s, t, jcfg))
    jtok = jnp.argmax(jl, -1).astype(jnp.int32)[:, None]
    ttok = torch.argmax(tl, -1).to(torch.int32)[:, None]
    for _ in range(STEPS):
        np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
        jlg, js = jstep(jp, js, jtok)
        tlg, ts = TT.decode_step(tp, ts, ttok, tcfg)
        _close(tlg, jlg, TOL["f32"])
        jtok = jnp.argmax(jlg[:, -1], -1).astype(jnp.int32)[:, None]
        ttok = torch.argmax(tlg[:, -1], -1).to(torch.int32)[:, None]
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    assert ts.step == int(js.step) == 20 + STEPS
    _assert_state(ts, js)


@pytest.mark.parametrize("bits", [0, 8])
def test_legacy_loop_greedy_tokens_equal(bits):
    """The legacy loop as ``serve`` runs it — the reference's prompts
    (``randint(fold_in(key, 1))``), a prefill whose shared caches hold
    prompt + gen rows, then greedy steps — at bf16 with weight and KV bits
    ``bits``, on bridged params: the reference's tokens."""
    batch, plen, gen = 2, 16, 8
    jcfg, tcfg, jp, tp = _pair("bf16", bits, bits)
    key = jax.random.PRNGKey(0)
    jprompts = jax.random.randint(jax.random.fold_in(key, 1), (batch, plen), 0,
                                  jcfg.vocab_size)
    tprompts = prng.randint(prng.fold_in(prng.PRNGKey(0), 1), (batch, plen), 0,
                            tcfg.vocab_size, device="cpu")
    np.testing.assert_array_equal(tprompts.numpy(), np.asarray(jprompts))
    jl, js = JT.prefill(jp, jprompts, jcfg, pad_to=plen + gen)
    jstep = jax.jit(jmake_serve_step(jcfg))
    jout = [jnp.argmax(jl, -1).astype(jnp.int32)[:, None]]
    tl, ts = make_prefill_step(tcfg, pad_to=plen + gen)(tp, {"tokens": tprompts})
    tstep = make_serve_step(tcfg)
    tout = [torch.argmax(tl, -1).to(torch.int32)[:, None]]
    for _ in range(gen - 1):
        _, jn, js = jstep(jp, js, jout[-1])
        jout.append(jn[:, None])
        _, tn, ts = tstep(tp, ts, tout[-1])
        tout.append(tn[:, None])
    np.testing.assert_array_equal(torch.cat(tout, 1).numpy(),
                                  np.asarray(jnp.concatenate(jout, 1)))
    assert ts.shared.k.shape[2] == plen + gen
    assert ts.shared.k.dtype == (torch.int8 if bits else torch.bfloat16)


@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_param_tree_codes_identical(bits):
    """``quantize_param_tree`` on the bridged bf16 tree against the
    reference's: the same leaves quantized, codes and scales byte-identical
    — the stacked Mamba2 projections and the shared block's 2-D ones."""
    jcfg = jconfigs.get_reduced(ARCH)
    jraw = JT.init_params(jax.random.PRNGKey(3), jcfg)
    want = jquantize(jraw, bits=bits)
    got = tquantize(bridge(jraw), bits=bits)
    wl = jax.tree_util.tree_leaves_with_path(
        want, is_leaf=lambda x: not isinstance(x, dict))
    gl = dict(jax.tree_util.tree_leaves_with_path(
        got, is_leaf=lambda x: not isinstance(x, dict)))
    assert len(gl) == len(wl)
    n_q = 0
    for path, w in wl:
        g = gl[path]
        if isinstance(g, QTensor):
            n_q += 1
            assert g.scheme.packed == w.scheme.packed, path
            np.testing.assert_array_equal(g.codes.numpy(), np.asarray(w.codes),
                                          err_msg=str(path))
            np.testing.assert_array_equal(g.scale.numpy(), np.asarray(w.scale),
                                          err_msg=str(path))
        else:
            assert not hasattr(w, "codes"), path
    # in_proj and out_proj stacked; the shared block's q, k, v, o, gate, up, down
    assert n_q == 2 + 7
    assert isinstance(got["shared_attn"]["mlp"]["down"]["w"], QTensor)
    assert got["shared_attn"]["attn"]["q"]["w"].codes.ndim == 2


def test_decode_matches_forward():
    """The reference's ``test_decode_matches_forward`` for zamba2 on the
    port alone: decode from empty caches (8 rows), token by token, equals
    the teacher-forced forward at f32 (2e-3)."""
    cfg = tconfigs.get_reduced(ARCH, dtype=torch.float32)
    params = TT.init_params(cfg, seed=0, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(2).integers(0, cfg.vocab_size, (1, 8)))
    with torch.no_grad():
        full = TT._readout(params, cfg, TT.forward(params, toks, cfg))
        state = TT.init_decode_state(cfg, 1, smax=8, device="cpu")
        outs = []
        for t in range(8):
            lg, state = TT.decode_step(params, state, toks[:, t:t + 1], cfg)
            outs.append(lg[:, 0])
    assert state.step == 8 and state.shared.length.tolist() == [[8], [8]]
    np.testing.assert_allclose(np32(torch.stack(outs, 1)), np32(full), rtol=2e-3, atol=2e-3)


def test_prefill_then_decode_matches_forward():
    """The reference's ``test_prefill_then_decode_matches_forward`` for
    zamba2 on the port alone: ``prefill_state(prompt[:7], pad_to=8)`` +
    ``decode_step(token 7)`` equal the teacher-forced forward at positions
    6 and 7 (f32, 2e-3)."""
    cfg = tconfigs.get_reduced(ARCH, dtype=torch.float32)
    params = TT.init_params(cfg, seed=1, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab_size, (1, 8)))
    with torch.no_grad():
        full = TT._readout(params, cfg, TT.forward(params, toks, cfg))
        pre, state = TT.prefill_state(params, toks[:, :7], cfg, pad_to=8)
        lg, _ = TT.decode_step(params, state, toks[:, 7:8], cfg)
    np.testing.assert_allclose(np32(pre), np32(full[:, 6]), rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(np32(lg[:, 0]), np32(full[:, 7]), rtol=2e-3, atol=2e-3)


def test_prefill_without_pad_overwrites_the_last_prompt_row():
    """The ring cursor, as the reference's ``update_kv_cache``: a cache of
    exactly S rows has no row for the next token, so the step writes at
    row S − 1 and the shared caches' last prompt row is lost."""
    cfg = tconfigs.get_reduced(ARCH, dtype=torch.float32)
    params = TT.init_params(cfg, seed=1, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab_size, (1, 8)))
    _, state = TT.prefill(params, toks[:, :7], cfg)
    assert state.shared.k.shape[2] == 7
    _, new = TT.decode_step(params, state, toks[:, 7:8], cfg)
    assert torch.equal(new.shared.k[:, :, :6], state.shared.k[:, :, :6])
    assert not torch.equal(new.shared.k[:, :, 6], state.shared.k[:, :, 6])


def test_decode_step_leaves_its_state_unchanged():
    """``serve``'s warm-up step is thrown away: a step writes into no tensor
    of the state it is given; the caches' shapes and dtypes."""
    cfg = tconfigs.get_reduced(ARCH, precision=TPlan(kv_bits=8))
    params = TT.init_params(cfg, seed=0, device="cpu")
    _, state = TT.prefill_state(params, torch.zeros((2, 12), dtype=torch.int64) + 3, cfg,
                                pad_to=16)
    spec = cfg.ssm_spec
    assert state.layers.conv.shape == (cfg.n_layers, 2, spec.conv_kernel - 1, spec.conv_dim)
    assert state.layers.ssm.dtype == torch.float32
    assert state.shared.k.shape == (2, 2, 16, cfg.n_kv_heads, cfg.head_dim)
    assert state.shared.k.dtype == torch.int8
    before = [t.clone() for t in (*state.layers, *state.shared)]
    _, new = TT.decode_step(params, state, torch.ones((2, 1), dtype=torch.int64), cfg)
    for a, b in zip((*state.layers, *state.shared), before):
        assert torch.equal(a, b)
    assert new.step == 13 and new.shared.length.tolist() == [[13, 13]] * 2


@pytest.mark.parametrize("kv_bits", [0, 8, 4])
def test_init_decode_state_is_empty(kv_bits):
    cfg = tconfigs.get_reduced(ARCH, precision=TPlan(kv_bits=kv_bits))
    st = TT.init_decode_state(cfg, 3, 10, device="cpu")
    d = cfg.head_dim // 2 if kv_bits == 4 else cfg.head_dim
    assert st.shared.k.shape == (2, 3, 10, cfg.n_kv_heads, d)
    assert (st.shared.k_scale is None) == (kv_bits == 0)
    assert not st.shared.k.any() and not st.shared.length.any() and not st.layers.ssm.any()
    assert st.layers.conv.shape[:2] == (cfg.n_layers, 3) and st.step == 0


def test_legacy_serve_on_cpu():
    """``serve`` on the reduced zamba2 at 8-bit weights and KV (the hybrid
    has KV caches: no C18 raise) returns the reference's prompts, in-vocab
    tokens of shape (B, prompt + gen) and a finite rate."""
    tokens, tps = serve(ARCH, batch=2, prompt_len=16, gen=8, weight_bits=8, kv_bits=8,
                        device="cpu")
    cfg = tconfigs.get_reduced(ARCH)
    want = jax.random.randint(jax.random.fold_in(jax.random.PRNGKey(0), 1), (2, 16), 0,
                              cfg.vocab_size)
    assert tokens.shape == (2, 24) and tokens.dtype == np.int32
    np.testing.assert_array_equal(tokens[:, :16], np.asarray(want))
    assert tokens.min() >= 0 and tokens.max() < cfg.vocab_size
    assert np.isfinite(tps) and tps > 0


def test_legacy_cli_on_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", ARCH, "--device", "cpu",
         "--legacy", "--batch", "2", "--prompt-len", "16", "--gen", "8", "--kv-bits", "4",
         "--weight-bits", "4"],
        env=ENV, capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert "[serve] generated (2, 24) tokens" in out.stdout


def test_engine_rejects_zamba2():
    """As the reference's engine: the hybrid's caches are not paged, so
    ``serve_engine`` and ``ServeEngine`` raise its ``ValueError``."""
    from repro.serve import ServeEngine as JEngine

    msg = "SSM/hybrid/VLM caches are not paged"
    jcfg = jconfigs.get_reduced(ARCH)
    with pytest.raises(ValueError, match=msg):
        JEngine(JT.init_params(jax.random.PRNGKey(0), jcfg), jcfg)
    with pytest.raises(ValueError, match=msg):
        serve_engine(ARCH, device="cpu", n_requests=2)
    cfg = tconfigs.get_reduced(ARCH)
    with pytest.raises(ValueError, match=msg):
        ServeEngine(TT.init_params(cfg, device="cpu"), cfg, device="cpu")


@pytest.mark.parametrize("every", [0, 3, -2])
def test_shared_attn_every_must_divide_the_layers(every):
    cfg = tconfigs.get_reduced(ARCH, shared_attn_every=every)
    with pytest.raises(ValueError, match="shared_attn_every"):
        TT.init_params(cfg, device="cpu")
    with pytest.raises(ValueError, match="shared_attn_every"):
        TT.init_decode_state(cfg, 1, 4, device="cpu")
