"""Port parity — slice 7: mamba2-780m served through the legacy loop
(repro_torch.models.ssm, the ssm branches of models.transformer, the SSD
scan behind kernel B12, launch.serve.serve) against the reference, at the
reduced size, with the reference's params bridged across and inputs made
with numpy.

Tolerances: the SSD scans 1e-4 (rtol and atol) at f32 and 2e-2 at bf16, the
reference's own for its Pallas kernel (``tests/test_kernels.py``): f32 sums
in another order, and at bf16 y rounds once more; the model 1e-4 of the
reference's largest magnitude at f32 and 2e-2 at bf16 (XLA's fused bf16
roundings against eager PyTorch's); greedy tokens equal; the ported
bookkeeping tests of ``tests/test_arch_smoke.py`` 2e-3, as there.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from torch_bridge import bridge, np32

from repro import configs as jconfigs
from repro.kernels import ref as jref
from repro.kernels import ssd as jssd
from repro.models import ssm as jssm
from repro.models import transformer as JT
from repro.precision.qat import quantize_param_tree
from repro_torch import configs as tconfigs
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import registry as treg
from repro_torch.kernels import ssd as tssd
from repro_torch.launch.serve import serve
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as TT
from repro_torch.quant import PrecisionPlan as TPlan
from repro_torch.quant import QTensor
from repro_torch.serve import ServeEngine

ROOT = Path(__file__).resolve().parents[1]
ENV = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
SCAN_TOL = {"f32": 1e-4, "bf16": 2e-2}
MODEL_TOL = {"f32": 1e-4, "bf16": 2e-2}
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _scan_inputs(b, nc, L, h, p, n, dtype, seed=0):
    """The reference test's laws: x N(0, .25), dt = softplus(N(0,1) − 1),
    a_log = log(1..H), B and C N(0, .09); x, B and C in ``dtype``."""
    rng = np.random.default_rng(seed)
    jd = DTYPES[dtype][0]
    x = rng.normal(0, 0.5, (b, nc, L, h, p)).astype(np.float32)
    dt = np.asarray(jax.nn.softplus(rng.normal(0, 1, (b, nc, L, h)).astype(np.float32) - 1))
    a = -np.arange(1, h + 1, dtype=np.float32)
    logdec = (dt * a).astype(np.float32)
    bm = (rng.normal(0, 1, (b, nc, L, n)) * 0.3).astype(np.float32)
    cm = (rng.normal(0, 1, (b, nc, L, n)) * 0.3).astype(np.float32)
    j = [jnp.asarray(x, jd), jnp.asarray(dt), jnp.asarray(logdec), jnp.asarray(bm, jd),
         jnp.asarray(cm, jd)]
    return j, [torch.from_numpy(np32(v)).to(
        DTYPES[dtype][1] if k in (0, 3, 4) else torch.float32) for k, v in enumerate(j)]


def _close(got, want, tol, scale=1.0):
    np.testing.assert_allclose(np32(got), np32(want), rtol=tol, atol=tol * scale)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_ssd_chunk_scan_plain_matches_reference(dtype):
    """B12's plain version and the port's wrapper on CPU tensors against the
    Pallas kernel in interpret mode and the reference's plain scan, at the
    reference test's dims (2, 4, 32, 4, 8, 16)."""
    j, t = _scan_inputs(2, 4, 32, 4, 8, 16, dtype)
    y_pl, st_pl = jssd.ssd_chunk_scan(*j, interpret=True)
    y_ref, st_ref = jref.ssd_chunk_scan_ref(*j)
    tol = SCAN_TOL[dtype]
    for fn in (tref.ssd_chunk_scan_ref, tssd.ssd_chunk_scan):
        y, st = fn(*t)
        assert y.dtype == t[0].dtype and st.dtype == torch.float32
        for want_y, want_st in ((y_pl, st_pl), (y_ref, st_ref)):
            _close(y, want_y, tol)
            _close(st, want_st, tol)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_ssd_single_chunk_with_initial_state(dtype):
    """S 40 with chunk 16 is one chunk as long as the sequence; the initial
    state is non-zero: the port's kernel drop-in (plain scan on the CPU)
    against the reference model's ``ssd_chunked(..., init_state=)``."""
    b, s, h, p, n = 2, 40, 4, 8, 16
    j, t = _scan_inputs(b, 1, s, h, p, n, dtype, seed=3)
    rng = np.random.default_rng(4)
    init = (rng.normal(0, 1, (b, h, p, n))).astype(np.float32)
    a_log = np.log(np.arange(1, h + 1, dtype=np.float32))
    spec = jssm.SSMSpec(d_model=h * p // 2, d_state=n, head_dim=p, chunk=16)
    want_y, want_st = jax.jit(lambda x, dt, bm, cm, st: jssm.ssd_chunked(
        x, dt, jnp.asarray(a_log), bm, cm, spec, st))(
        j[0][:, 0], j[1][:, 0], j[3][:, 0, :, None, :], j[4][:, 0, :, None, :],
        jnp.asarray(init))
    y, st = tops.ssd_chunked_kernel(t[0][:, 0], t[1][:, 0], torch.from_numpy(a_log),
                                    t[3][:, 0], t[4][:, 0], chunk=16,
                                    init_state=torch.from_numpy(init))
    _close(y, want_y, SCAN_TOL[dtype])
    _close(st, want_st, SCAN_TOL[dtype])


def test_ssd_chunked_kernel_matches_model_ssd():
    """``ops.ssd_chunked_kernel`` (B12's wrapper; its plain version on the
    CPU) against the port's ``models/ssm.ssd_chunked`` (the registry's ref
    einsum form), four chunks of 32, f32."""
    b, s, h, p, n = 2, 128, 4, 16, 32
    rng = np.random.default_rng(9)
    xh = torch.from_numpy(rng.normal(0, 0.5, (b, s, h, p)).astype(np.float32))
    dt = torch.nn.functional.softplus(torch.from_numpy(rng.normal(0, 1, (b, s, h)).astype(np.float32)))
    a_log = torch.log(torch.arange(1, h + 1, dtype=torch.float32))
    bm = torch.from_numpy((rng.normal(0, 1, (b, s, 1, n)) * 0.3).astype(np.float32))
    cm = torch.from_numpy((rng.normal(0, 1, (b, s, 1, n)) * 0.3).astype(np.float32))
    spec = tssm.SSMSpec(d_model=h * p // 2, d_state=n, head_dim=p, chunk=32)
    y_model, st_model = tssm.ssd_chunked(xh, dt, a_log, bm, cm, spec, backend="ref")
    y_kern, st_kern = tops.ssd_chunked_kernel(xh, dt, a_log, bm.reshape(b, s, n),
                                              cm.reshape(b, s, n), chunk=32)
    _close(y_kern, y_model, 1e-4)
    _close(st_kern, st_model, 1e-4)


def _models(dtype: str, weight_bits: int, seed: int = 0):
    jd, td = DTYPES[dtype]
    jcfg = dataclasses.replace(jconfigs.get_reduced("mamba2-780m"), dtype=jd)
    tcfg = tconfigs.get_reduced("mamba2-780m", dtype=td)
    jp = JT.init_params(jax.random.PRNGKey(seed), jcfg)
    if weight_bits:
        jp = quantize_param_tree(jp, bits=weight_bits)
    return jcfg, tcfg, jp, bridge(jp)


def _layer0(params):
    return jax.tree.map(lambda a: a[0], params["layers"]["mamba"])


def test_bridged_tree_dtypes():
    """A bridged int8 reduced mamba2 tree: the SSM vectors f32, conv and
    norms bf16, the in/out projections QTensors, conv_w dense; and the
    port's own init has the reference's tree, shapes and dtypes."""
    _, tcfg, jp, tp = _models("bf16", 8)
    m = tp["layers"]["mamba"]
    for k in ("a_log", "d_skip", "dt_bias"):
        assert m[k].dtype == torch.float32, k
    for leaf in (m["conv_w"], m["conv_b"], m["norm"]["g"], tp["layers"]["norm"]["g"]):
        assert leaf.dtype == torch.bfloat16
    assert isinstance(m["in_proj"]["w"], QTensor) and isinstance(m["out_proj"]["w"], QTensor)
    assert m["in_proj"]["w"].shape == (2, 64, 296)
    jraw = JT.init_params(jax.random.PRNGKey(0), jconfigs.get_reduced("mamba2-780m"))
    traw = TT.init_params(tcfg, seed=0, device="cpu")
    want = {jax.tree_util.keystr(k): (tuple(v.shape), str(v.dtype))
            for k, v in jax.tree_util.tree_leaves_with_path(jraw)}
    got = {jax.tree_util.keystr(k): (tuple(v.shape), str(v.dtype).removeprefix("torch."))
           for k, v in jax.tree_util.tree_leaves_with_path(traw)}
    assert got == want
    # log(1..H): torch's and XLA's log may part in the last ulp
    np.testing.assert_allclose(np32(traw["layers"]["mamba"]["a_log"]),
                               np32(jraw["layers"]["mamba"]["a_log"]), rtol=1e-6)


@pytest.mark.parametrize("dtype,weight_bits", [("f32", 0), ("bf16", 0), ("f32", 8),
                                               ("bf16", 8)])
def test_mamba2_forward_and_decode_step_match_reference(dtype, weight_bits):
    """One mamba2 block (layer 0) with bridged params: ``mamba2_forward``
    with its state and ``mamba2_decode_step`` from that state, against the
    reference's jitted functions."""
    jcfg, tcfg, jp, tp = _models(dtype, weight_bits)
    spec_j, spec_t = jcfg.ssm_spec, tcfg.ssm_spec
    jd, td = DTYPES[dtype]
    rng = np.random.default_rng(5)
    x = rng.normal(0, 1, (2, 40, 64)).astype(np.float32)
    x1 = rng.normal(0, 1, (2, 1, 64)).astype(np.float32)
    jl, tl = _layer0(jp), TT.layer_views(tp, tcfg)[0]["mamba"]

    def jfn(p, x, x1):
        out, cache = jssm.mamba2_forward(p, x, spec_j, return_state=True)
        out1, cache1 = jssm.mamba2_decode_step(p, x1, cache, spec_j)
        return out, cache, out1, cache1

    want = jax.jit(jfn)(jl, jnp.asarray(x, jd), jnp.asarray(x1, jd))
    xt, x1t = torch.from_numpy(x).to(td), torch.from_numpy(x1).to(td)
    out, cache = tssm.mamba2_forward(tl, xt, spec_t, return_state=True)
    out1, cache1 = tssm.mamba2_decode_step(tl, x1t, cache, spec_t)
    tol = MODEL_TOL[dtype]
    for got, ref in ((out, want[0]), (cache.conv, want[1].conv), (cache.ssm, want[1].ssm),
                     (out1, want[2]), (cache1.conv, want[3].conv),
                     (cache1.ssm, want[3].ssm)):
        assert got.shape == ref.shape
        scale = float(np.abs(np32(ref)).max())
        np.testing.assert_allclose(np32(got), np32(ref), rtol=0, atol=tol * scale)


def _run_both(dtype, weight_bits, steps):
    jcfg, tcfg, jp, tp = _models(dtype, weight_bits)
    toks = np.random.default_rng(1).integers(0, jcfg.vocab_size, (2, 40)).astype(np.int32)
    jl, js = jax.jit(lambda p, t: JT.prefill(p, t, jcfg))(jp, jnp.asarray(toks))
    tl, ts = TT.prefill(tp, torch.from_numpy(toks), tcfg)
    assert ts.step == 40
    jstep = jax.jit(lambda p, s, t: JT.decode_step(p, s, t, jcfg))
    out = [(jl, tl, js, ts)]
    jt = jnp.argmax(jl, -1).astype(jnp.int32)[:, None]
    tt = torch.argmax(tl, -1).to(torch.int32)[:, None]
    for _ in range(steps):
        jlg, js = jstep(jp, js, jt)
        tlg, ts = TT.decode_step(tp, ts, tt, tcfg)
        out.append((jlg[:, 0], tlg[:, 0], js, ts))
        jt = jnp.argmax(jlg[:, -1], -1).astype(jnp.int32)[:, None]
        tt = torch.argmax(tlg[:, -1], -1).to(torch.int32)[:, None]
    return out


@pytest.mark.parametrize("weight_bits", [0, 8])
def test_prefill_and_decode_logits_match_reference_f32(weight_bits):
    """Reduced model at f32: prefill logits and caches, then 4 decode steps'
    logits, against the reference's jitted ``T.prefill`` + ``T.decode_step``."""
    for jl, tl, js, ts in _run_both("f32", weight_bits, 4):
        scale = float(np.abs(np32(jl)).max())
        np.testing.assert_allclose(np32(tl), np32(jl), rtol=0, atol=1e-4 * scale)
        for a, b in ((ts.layers.conv, js.layers.conv), (ts.layers.ssm, js.layers.ssm)):
            np.testing.assert_allclose(np32(a), np32(b), rtol=0,
                                       atol=1e-4 * float(np.abs(np32(b)).max()))


@pytest.mark.parametrize("weight_bits", [0, 8])
def test_greedy_tokens_equal_bf16(weight_bits):
    """Reduced model at bf16: the greedy token after the prefill and after
    each of 8 decode steps equals the reference's."""
    for jl, tl, _, _ in _run_both("bf16", weight_bits, 8):
        np.testing.assert_array_equal(np.argmax(np32(jl), -1),
                                      torch.argmax(tl.float(), -1).numpy())


def test_decode_matches_forward():
    """The reference's ``test_decode_matches_forward`` on the port alone:
    decode from zero caches, token by token, equals the teacher-forced
    forward at f32 (2e-3)."""
    cfg = tconfigs.get_reduced("mamba2-780m", dtype=torch.float32)
    params = TT.init_params(cfg, seed=0, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(2).integers(0, cfg.vocab_size, (1, 8)))
    with torch.no_grad():
        full = TT._readout(params, cfg, TT.forward(params, toks, cfg))
        state = TT.init_decode_state(cfg, 1, smax=8, device="cpu")
        outs = []
        for t in range(8):
            lg, state = TT.decode_step(params, state, toks[:, t:t + 1], cfg)
            outs.append(lg[:, 0])
    assert state.step == 8
    np.testing.assert_allclose(np32(torch.stack(outs, 1)), np32(full), rtol=2e-3, atol=2e-3)


def test_prefill_then_decode_matches_forward():
    """The reference's ``test_prefill_then_decode_matches_forward`` on the
    port alone: prefill(prompt[:7]) + decode_step(token 7) equal the
    teacher-forced forward at positions 6 and 7 (f32, 2e-3)."""
    cfg = tconfigs.get_reduced("mamba2-780m", dtype=torch.float32)
    params = TT.init_params(cfg, seed=1, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab_size, (1, 8)))
    with torch.no_grad():
        full = TT._readout(params, cfg, TT.forward(params, toks, cfg))
        pre, state = TT.prefill(params, toks[:, :7], cfg)
        lg, _ = TT.decode_step(params, state, toks[:, 7:8], cfg)
    np.testing.assert_allclose(np32(pre), np32(full[:, 6]), rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(np32(lg[:, 0]), np32(full[:, 7]), rtol=2e-3, atol=2e-3)


def test_decode_step_leaves_its_state_unchanged():
    """The warm-up step of ``serve`` is thrown away: a step must not write
    into the state it is given. The cache is O(1): (K−1) bf16 conv rows and
    the f32 (H, P, N) state per layer, whatever the prompt length."""
    cfg = tconfigs.get_reduced("mamba2-780m")
    params = TT.init_params(cfg, seed=0, device="cpu")
    _, state = TT.prefill(params, torch.zeros((2, 12), dtype=torch.int64) + 3, cfg)
    spec = cfg.ssm_spec
    assert state.layers.conv.shape == (cfg.n_layers, 2, spec.conv_kernel - 1, spec.conv_dim)
    assert state.layers.ssm.shape == (cfg.n_layers, 2, spec.n_heads, spec.head_dim,
                                      spec.d_state)
    assert state.layers.conv.dtype == torch.bfloat16 and state.layers.ssm.dtype == torch.float32
    before = [t.clone() for t in state.layers]
    _, new = TT.decode_step(params, state, torch.ones((2, 1), dtype=torch.int64), cfg)
    for a, b in zip(state.layers, before):
        assert torch.equal(a, b)
    assert new.step == state.step + 1 and not torch.equal(new.layers.ssm, state.layers.ssm)


def test_legacy_serve_on_cpu():
    """``serve`` draws the reference's prompts (``randint(fold_in(key, 1))``),
    returns in-vocab tokens of shape (B, prompt + gen) and a finite rate."""
    tokens, tps = serve("mamba2-780m", batch=2, prompt_len=16, gen=8, weight_bits=8,
                        device="cpu")
    cfg = tconfigs.get_reduced("mamba2-780m")
    want = jax.random.randint(jax.random.fold_in(jax.random.PRNGKey(0), 1), (2, 16), 0,
                              cfg.vocab_size)
    assert tokens.shape == (2, 24) and tokens.dtype == np.int32
    np.testing.assert_array_equal(tokens[:, :16], np.asarray(want))
    assert tokens.min() >= 0 and tokens.max() < cfg.vocab_size
    assert np.isfinite(tps) and tps > 0


def test_legacy_cli_on_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "mamba2-780m",
         "--device", "cpu", "--legacy", "--batch", "2", "--prompt-len", "16", "--gen", "8"],
        env=ENV, capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert "[serve] generated (2, 24) tokens" in out.stdout


def test_ssd_gradient_on_the_kernel_path_raises():
    """The kernel has no backward: the cuda backend and the wrapper raise on
    inputs that need a gradient (never a silent plain fallback); the ref
    backend's einsum form is differentiable."""
    _, t = _scan_inputs(1, 2, 8, 2, 4, 8, "f32")
    x = t[0].clone().requires_grad_()
    with pytest.raises(NotImplementedError, match="ROADMAP A6"):
        tssd.ssd_chunk_scan(x, *t[1:])
    xs = x.reshape(1, 16, 2, 4)
    args = (t[1].reshape(1, 16, 2), torch.log(torch.arange(1.0, 3.0)),
            t[3].reshape(1, 16, 8), t[4].reshape(1, 16, 8))
    with pytest.raises(NotImplementedError, match="ssm training"):
        treg.get("cuda").ssd_chunked(xs, *args, chunk=8)
    y, st = treg.get("ref").ssd_chunked(xs, *args, chunk=8)
    (y.sum() + st.sum()).backward()
    assert torch.isfinite(x.grad).all() and x.grad.abs().sum() > 0


def test_kv_bits_on_ssm_raises():
    plan = TPlan(kv_bits=8)
    cfg = tconfigs.get_reduced("mamba2-780m", precision=plan)
    with pytest.raises(ValueError, match="C18"):
        TT.init_params(cfg, device="cpu")
    with pytest.raises(ValueError, match="no KV cache"):
        serve("mamba2-780m", kv_bits=8, device="cpu")


def test_more_than_one_group_raises():
    spec = tssm.SSMSpec(d_model=16, d_state=8, head_dim=8, chunk=4)
    bm = torch.zeros((1, 8, 2, 8))
    with pytest.raises(NotImplementedError, match="n_groups"):
        tssm.ssd_chunked(torch.zeros((1, 8, 4, 8)), torch.ones((1, 8, 4)),
                         torch.zeros(4), bm, bm, spec)


@pytest.mark.parametrize("over,exc,match", [
    (dict(family="moe"), ValueError, "n_experts"),
    (dict(family="hybrid", shared_attn_every=1, window=8), NotImplementedError,
     "ROADMAP A6"),
    (dict(family="vlm"), ValueError, "cross_attn_every"),
    (dict(tie_embeddings=False), NotImplementedError, "ROADMAP A6")],
    ids=["over0", "over1", "over2", "over3"])
def test_unported_families_name_a6(over, exc, match):
    """A window on the hybrid and untied embeddings wait for ROADMAP A6;
    the moe family is ported (slice 10), and the reduced gemma-2b as an
    moe model has no experts (``n_experts=0``), which raises a
    ValueError; the vlm family is ported (slice 12), and the reduced
    gemma-2b as a vlm model has no cross-attention cadence
    (``cross_attn_every=0``), which raises a ValueError. Windows on the
    dense and moe families are ported (slice 11,
    ``test_torch_window.py``), the audio family too (slice 12,
    ``test_torch_audio.py``)."""
    cfg = tconfigs.get_reduced("gemma-2b", **over)
    with pytest.raises(exc, match=match):
        TT.init_params(cfg, device="cpu")


def test_hybrid_without_shared_attn_every_raises():
    """The hybrid family is ported (slice 9); a hybrid config without a
    shared attention cadence that divides its layers raises ValueError."""
    cfg = tconfigs.get_reduced("gemma-2b", family="hybrid")
    assert cfg.shared_attn_every == 0
    with pytest.raises(ValueError, match="shared_attn_every"):
        TT.init_params(cfg, device="cpu")


def test_dense_legacy_paths_name_a6():
    """What the legacy loop still lacks names A6: a window on the hybrid's
    shared ring caches and untied embeddings (the dense and moe families'
    sliding-window ring is slice 11's; every architecture of the
    reference serves since slice 12)."""
    cfg = tconfigs.get_reduced("zamba2-2.7b", window=8)
    with pytest.raises(NotImplementedError, match="ROADMAP A6"):
        TT.init_decode_state(cfg, 2, 16, device="cpu")
    cfg = tconfigs.get_reduced("gemma-2b", tie_embeddings=False)
    with pytest.raises(NotImplementedError, match="ROADMAP A6"):
        TT.init_decode_state(cfg, 2, 16, device="cpu")


def test_qkv_bias_inits_zero_biases_on_q_k_v():
    cfg = tconfigs.get_reduced("gemma-2b", qkv_bias=True)
    p = TT.init_params(cfg, device="cpu")["layers"]["attn"]
    for name, width in (("q", cfg.n_heads), ("k", cfg.n_kv_heads), ("v", cfg.n_kv_heads)):
        b = p[name]["b"]
        assert b.shape == (cfg.n_layers, width * cfg.head_dim) and b.dtype == cfg.dtype
        assert not b.any()
    assert "b" not in p["o"]


@pytest.mark.parametrize("kv_bits", [0, 8])
def test_dense_legacy_paths_serve(kv_bits):
    cfg = tconfigs.get_reduced("gemma-2b")
    st = TT.init_decode_state(cfg, 2, 16, device="cpu")
    assert st.layers.k.shape[:3] == (cfg.n_layers, 2, 16)
    tokens, tps = serve("gemma-2b", device="cpu", batch=2, prompt_len=8, gen=3,
                        kv_bits=kv_bits, weight_bits=8)
    assert tokens.shape == (2, 11) and tokens.dtype == np.int32
    assert ((0 <= tokens) & (tokens < cfg.vocab_size)).all() and tps > 0


@pytest.mark.parametrize("family", ["ssm", "hybrid", "vlm"])
def test_engine_rejects_unpaged_families(family):
    """As the reference's engine (``tests/test_serve_engine.py``): the SSM,
    hybrid and VLM caches are not paged."""
    cfg = dataclasses.replace(tconfigs.get_reduced("mamba2-780m"), family=family)
    with pytest.raises(ValueError, match="SSM"):
        ServeEngine({}, cfg, device="cpu")
