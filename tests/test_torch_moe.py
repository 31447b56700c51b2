"""Port parity — slice 10: the moe family (granite-moe-3b-a800m: 40
experts, top 8; reduced: 8 experts, top 4) — ``models/moe``, the stacked
(E, K, N) ``quant_dense`` and both serving paths — against the reference,
at the reference's ``REDUCED`` config and at f32 (the reference's stacked
bf16 product does not run on this CPU stack, ROADMAP C1), with the
reference's params bridged across and inputs made with numpy.

Tolerances: the router's probabilities 1e-6 (f32 softmax of the same f32
logits, sums in another order), its top-k ids equal; every MoE output,
forward and logit within ``RTOL`` = 1e-5 of the reference's largest
magnitude (f32 sums in another order) — ``FLIP_TOL`` = 1e-3 on a decode
step whose new ring-cache row rounds a code one step apart, at most
``CODE_FLIPS`` = 1e-3 of the codes (a row within f32 noise of a rounding
boundary, as ROADMAP C22 has it for the hybrid); the stacked
``quant_dense`` of the
``ref`` backend within 1e-5 of the reference's jitted ``ref`` and of the
``cuda`` backend's plain path (``qmm_plain`` a slice) within 1e-5 of the
reference's ``pallas`` backend (Pallas ``qmm`` a slice, interpret mode);
codes and scales of ``quantize_param_tree`` byte-identical; greedy tokens,
engine stats and KV bytes equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_bridge import bridge, np32, serve_both

from repro import configs as jconfigs
from repro import quant as jquant
from repro.kernels import registry as jreg
from repro.models import moe as jmoe
from repro.models import transformer as JT
from repro.precision.qat import quantize_param_tree as jquantize
from repro.quant import PrecisionPlan as JPlan
from repro_torch import configs as tconfigs
from repro_torch import quant as tquant
from repro_torch.kernels import qmm as tqmm
from repro_torch.kernels import registry as treg
from repro_torch.launch.serve import main as serve_main
from repro_torch.launch.steps import make_prefill_step, make_serve_step
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as TT
from repro_torch.precision.qat import quantize_param_tree as tquantize
from repro_torch.quant import PrecisionPlan as TPlan
from repro_torch.quant import QTensor

ARCH = "granite-moe-3b-a800m"
RTOL = 1e-5
PROB_TOL = 1e-6
STEPS = 8
CODE_FLIPS = 1e-3
FLIP_TOL = 1e-3
LONG_TOL = 1e-4
TSPEC = tconfigs.get_reduced(ARCH).moe_spec


def _cfgs(bits=0, kv_bits=0):
    plan = dict(kv_bits=kv_bits, model_bits=bits, model_storage="int" if bits else "fake")
    jcfg = dataclasses.replace(jconfigs.get_reduced(ARCH), dtype=jnp.float32,
                               precision=JPlan(**plan))
    tcfg = tconfigs.get_reduced(ARCH, dtype=torch.float32, precision=TPlan(**plan))
    return jcfg, tcfg


def _close(got, want, tol=RTOL):
    want = np32(want)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(np32(got), want, rtol=0,
                               atol=tol * float(np.abs(want).max()))


def _moe_pair(router="dense", bits=0, seed=0):
    """Layer 0's MoE params of the reference's reduced model (at ``bits``
    int codes), and their bridge. ``router``: the init's ("dense"), all
    zeros ("zeros": every probability ties), or one that sends every token
    to the same experts ("skewed": feature 0 of ``_x`` pushes experts 0..3)."""
    jcfg, _ = _cfgs()
    p = JT.init_params(jax.random.PRNGKey(seed), jcfg)["layers"]["moe"]
    p = jax.tree.map(lambda a: a[0], p)
    w = np.asarray(p["router"]["w"])
    if router == "zeros":
        w = np.zeros_like(w)
    elif router == "skewed":
        w = w.copy()
        w[0, :4] += 2.0
    p = {**p, "router": {"w": jnp.asarray(w)}}
    if bits:
        p = jquantize(p, bits=bits)
    return jcfg.moe_spec, p, bridge(p)


def _x(shape, seed=1):
    x = np.random.default_rng(seed).normal(0, 1, shape).astype(np.float32)
    x[..., 0] = np.abs(x[..., 0]) + 1.0
    return x


def test_config_fields_match_reference():
    """Every field of the port's ``ModelConfig``, full size and reduced,
    equals the reference's (the dtype by name), and the MoE spec too."""
    skip = {"dtype", "precision"}
    for get in ("get_config", "get_reduced"):
        jcfg, tcfg = getattr(jconfigs, get)(ARCH), getattr(tconfigs, get)(ARCH)
        for f in dataclasses.fields(tcfg):
            if f.name not in skip:
                assert getattr(tcfg, f.name) == getattr(jcfg, f.name), (get, f.name)
        assert str(tcfg.dtype).removeprefix("torch.") == jnp.dtype(jcfg.dtype).name
        js, ts = jcfg.moe_spec, tcfg.moe_spec
        for f in dataclasses.fields(ts):
            assert getattr(ts, f.name) == getattr(js, f.name), (get, f.name)
    cfg = tconfigs.get_config(ARCH)
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_ff,
            cfg.n_experts, cfg.top_k, cfg.vocab_padded) == (32, 1536, 24, 8, 64, 512, 40, 8,
                                                            49408)
    assert ARCH in tconfigs.ARCH_IDS


@pytest.mark.parametrize("over", [dict(n_experts=0), dict(top_k=0),
                                  dict(n_experts=4, top_k=5)])
def test_bad_expert_counts_raise(over):
    cfg = tconfigs.get_reduced(ARCH, **over)
    with pytest.raises(ValueError, match="top_k"):
        TT.init_params(cfg, device="cpu")


def test_init_params_tree_matches_reference():
    """The port's own init has the reference's tree, shapes and dtypes: the
    MoE block in place of the MLP, stacked (L, E, K, N) experts and an f32
    router in a bf16 model."""
    jcfg, tcfg = jconfigs.get_reduced(ARCH), tconfigs.get_reduced(ARCH)
    jraw = JT.init_params(jax.random.PRNGKey(0), jcfg)
    traw = TT.init_params(tcfg, seed=0, device="cpu")
    want = {jax.tree_util.keystr(k): (tuple(v.shape), str(v.dtype))
            for k, v in jax.tree_util.tree_leaves_with_path(jraw)}
    got = {jax.tree_util.keystr(k): (tuple(v.shape), str(v.dtype).removeprefix("torch."))
           for k, v in jax.tree_util.tree_leaves_with_path(traw)}
    assert got == want
    assert traw["layers"]["moe"]["router"]["w"].dtype == torch.float32
    assert traw["layers"]["moe"]["gate"]["w"].shape == (2, 8, 64, 32)


@pytest.mark.parametrize("router,bits", [("dense", 0), ("dense", 8), ("zeros", 0),
                                         ("skewed", 4)])
def test_router_probs_match_reference(router, bits):
    spec, jp, tp = _moe_pair(router, bits)
    x = _x((2, 24, 64))
    jtop_p, jtop_i, jprobs = jax.jit(lambda p, x: jmoe._router_probs(p, x, spec))(
        jp, jnp.asarray(x))
    ttop_p, ttop_i, tprobs = tmoe._router_probs(tp, torch.from_numpy(x), TSPEC)
    np.testing.assert_array_equal(ttop_i.numpy(), np.asarray(jtop_i))
    np.testing.assert_allclose(ttop_p.numpy(), np.asarray(jtop_p), rtol=0, atol=PROB_TOL)
    np.testing.assert_allclose(tprobs.numpy(), np.asarray(jprobs), rtol=0, atol=PROB_TOL)
    if router == "zeros":
        # every probability ties: the lower expert index first, as lax.top_k
        assert (ttop_i.numpy() == np.arange(spec.top_k)).all()


def _drops(tp, x, spec) -> int:
    """How many of the B·S·k choices the local dispatch drops at capacity."""
    n = x.shape[0] * x.shape[1]
    cap = max(int(n * spec.top_k / spec.n_experts * spec.capacity_factor), 1)
    _, top_i, _ = tmoe._router_probs(tp, torch.from_numpy(x), TSPEC)
    counts = np.bincount(top_i.numpy().reshape(-1), minlength=spec.n_experts)
    return int(np.maximum(counts - cap, 0).sum())


@pytest.mark.parametrize("router", ["dense", "skewed"])
@pytest.mark.parametrize("bits", [0, 8, 4])
@pytest.mark.parametrize("path", ["dense", "local", "grouped"])
def test_moe_paths_match_reference(path, bits, router):
    """``moe_dense``, ``moe_dispatch_local`` and ``moe_dispatch_grouped``
    (G 2) on dense, int8 and packed-int4 experts; the skewed router sends
    every token to experts 0..3, so the dispatch drops choices at capacity
    and the same ones must drop on both sides."""
    spec, jp, tp = _moe_pair(router, bits)
    x = _x((2, 40, 64))
    if path == "grouped":
        fn = jmoe.moe_dispatch_grouped
        tfn = tmoe.moe_dispatch_grouped
    else:
        fn = {"dense": jmoe.moe_dense, "local": jmoe.moe_dispatch_local}[path]
        tfn = {"dense": tmoe.moe_dense, "local": tmoe.moe_dispatch_local}[path]
    want = jax.jit(lambda p, x: fn(p, x, spec))(jp, jnp.asarray(x))
    got = tfn(tp, torch.from_numpy(x), TSPEC)
    _close(got, want)
    if router == "skewed" and path == "local":
        assert _drops(tp, x, spec) > 0


@pytest.mark.parametrize("tokens", [(2, 100), (2, 300)])
def test_moe_block_matches_reference_on_both_paths(tokens):
    """200 tokens take the dense path, 600 the dispatch (above
    ``dense_path_max_tokens`` = 512)."""
    spec, jp, tp = _moe_pair("dense", 8)
    x = _x((*tokens, 64), seed=3)
    want = jax.jit(lambda p, x: jmoe.moe_block(p, x, spec))(jp, jnp.asarray(x))
    got = tmoe.moe_block(tp, torch.from_numpy(x), TSPEC)
    _close(got, want)
    dense = tmoe.moe_dense(tp, torch.from_numpy(x), TSPEC)
    assert torch.equal(got, dense) == (tokens[0] * tokens[1] <= 512)


def test_load_balance_loss_matches_reference():
    spec, jp, tp = _moe_pair("skewed")
    x = _x((2, 24, 64))
    want = jax.jit(lambda p, x: jmoe.load_balance_loss(p, x, spec))(jp, jnp.asarray(x))
    got = tmoe.load_balance_loss(tp, torch.from_numpy(x), TSPEC)
    np.testing.assert_allclose(float(got), float(want), rtol=RTOL)


def _stacked(bits, packed, e=3, k=40, n=24, seed=0):
    w = np.random.default_rng(seed).normal(0, 0.05, (e, k, n)).astype(np.float32)
    kw = dict(scaling="channel", rounding="nearest", packed=packed)
    jq = jquant.encode(jnp.asarray(w), jquant.QScheme.int_symmetric(bits, **kw))
    tq = tquant.encode(torch.from_numpy(w), tquant.QScheme.int_symmetric(bits, **kw))
    np.testing.assert_array_equal(tq.codes.numpy(), np.asarray(jq.codes))
    assert tuple(tq.scale.shape) == (e, 1, n)
    return jq, tq


@pytest.mark.parametrize("xshape", [(3, 5, 40), (2, 3, 7, 40)])
@pytest.mark.parametrize("bits,packed", [(8, False), (4, True)])
def test_stacked_quant_dense_matches_reference(bits, packed, xshape):
    """x (…, E, M, K) · (E, K, N) int8 / packed-int4 codes: the ``ref``
    backend against the reference's jitted ``ref``, the ``cuda`` backend's
    CPU path (``qmm_plain`` a slice, no launch) against the reference's
    ``pallas`` backend (the Pallas ``qmm`` a slice, interpret mode)."""
    jq, tq = _stacked(bits, packed)
    x = np.random.default_rng(2).normal(0, 1, xshape).astype(np.float32)
    want = np.asarray(jax.jit(jreg.get("ref").quant_dense)(jnp.asarray(x), jq))
    got = treg.get("ref").quant_dense(torch.from_numpy(x), tq)
    _close(got, want)
    want = np.asarray(jreg.get("pallas").quant_dense(jnp.asarray(x), jq))
    before = tqmm.launches
    got = treg.get("cuda").quant_dense(torch.from_numpy(x), tq)
    assert tqmm.launches == before
    _close(got, want)
    plain = torch.stack([tqmm.qmm_plain(torch.from_numpy(x).movedim(-3, 0)[i].reshape(-1, 40),
                                        tq.codes[i], tq.scale[i], packed=packed)
                         for i in range(3)]).reshape(3, *xshape[:-3], xshape[-2], 24)
    assert torch.equal(got, plain.movedim(0, -3))


def test_stacked_weights_without_a_kernel_take_the_decode_path_on_the_cpu():
    """Stacked bitplane and level-table weights and ``transpose=True`` have
    no kernel: on CPU tensors the ``cuda`` backend decodes them as the
    ``ref`` backend does (on the card it raises, naming A1 or A6 —
    ``test_torch_kernels_gpu.py``)."""
    w = torch.randn(3, 40, 24) * 0.05
    x = torch.randn(3, 5, 40)
    for qt in (tquant.encode(w, tquant.QScheme.bitplane(4)),
               tquant.encode(w, tquant.QScheme.levels(5, rounding="nearest"),
                             levels=torch.tensor([-0.1, -0.05, 0.0, 0.05, 0.1]))):
        assert qt.ndim == 3
        want = treg.get("ref").quant_dense(x, qt)
        assert torch.equal(treg.get("cuda").quant_dense(x, qt), want)
    _, tq = _stacked(8, False)
    g = torch.randn(3, 5, 24)
    want = torch.matmul(g, tquant.QTensor(tq.codes, tq.scale.to(torch.bfloat16), tq.scheme)
                        .decode().transpose(-1, -2))
    _close(treg.get("cuda").quant_dense(g, tq, transpose=True), want)


@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_param_tree_matches_reference(bits):
    """Every matmul weight of the MoE tree — the f32 (L, d, E) router and
    the (L, E, K, N) experts, encoded a layer at a time — as the
    reference's codes and (L, E, 1, N) scales, byte for byte."""
    jcfg, tcfg = _cfgs()
    jp = JT.init_params(jax.random.PRNGKey(0), jcfg)
    jq = jquantize(jp, bits=bits)
    tq = tquantize(bridge(jp), bits=bits)
    jm, tm = jq["layers"]["moe"], tq["layers"]["moe"]
    for name in ("router", "gate", "up", "down"):
        j, t = jm[name]["w"], tm[name]["w"]
        assert isinstance(t, QTensor) and t.scheme.packed == j.scheme.packed, name
        np.testing.assert_array_equal(t.codes.numpy(), np.asarray(j.codes), err_msg=name)
        np.testing.assert_array_equal(t.scale.numpy(), np.asarray(j.scale), err_msg=name)
    assert tuple(tm["gate"]["w"].scale.shape) == (2, 8, 1, 32)


def test_forward_matches_reference():
    jcfg, tcfg = _cfgs()
    jp = JT.init_params(jax.random.PRNGKey(0), jcfg)
    toks = np.random.default_rng(1).integers(0, jcfg.vocab_size, (2, 24)).astype(np.int32)
    want = jax.jit(lambda p, t: JT.forward(p, t, jcfg))(jp, jnp.asarray(toks))
    with torch.no_grad():
        got = TT.forward(bridge(jp), torch.from_numpy(toks), tcfg)
    _close(got, want)


@pytest.mark.parametrize("bits", [0, 8, 4])
def test_engine_tokens_identical_f32(bits):
    """The paged engine against the reference ``ServeEngine(backend="ref")``
    on the same trace: tokens, stats and KV bytes equal, no page leaked."""
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


def _assert_codes(got, want, name) -> int:
    """Ring-cache codes (int8, or packed int4 as uint8) equal but for at
    most ``CODE_FLIPS`` of them one step apart; returns how many differ."""
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


def _assert_cache(tc, jc) -> int:
    """Lengths equal, codes as :func:`_assert_codes`, scales and raw rows
    within ``RTOL``; returns how many codes differ."""
    np.testing.assert_array_equal(tc.length.numpy(), np.asarray(jc.length))
    flips = 0
    for name in ("k", "v", "k_scale", "v_scale"):
        want = getattr(jc, name)
        if want is None:
            assert getattr(tc, name) is None, name
            continue
        got = getattr(tc, name)
        if got.dtype in (torch.int8, torch.uint8):
            flips += _assert_codes(got, want, name)
        else:
            _close(got, want)
    return flips


def _state_from_jax(js) -> TT.DecodeState:
    """A reference ring-cache ``DecodeState`` as the port's (copies)."""
    from repro_torch.interop import tensor_from_numpy as t
    from repro_torch.models.attention import KVCache

    c = js.layers
    return TT.DecodeState(KVCache(t(c.k), t(c.v), t(c.length),
                                  *[None if a is None else t(a) for a in (c.k_scale,
                                                                           c.v_scale)]),
                          step=int(js.step))


@pytest.mark.parametrize("bits", [0, 8, 4])
def test_ring_cache_prefill_and_decode_match_reference(bits):
    """The legacy loop: ``prefill_state`` on 2 × 300 prompts (600 tokens:
    the MoE layers take the dispatch) against the reference's jitted
    ``prefill(pad_to=)`` — logits within ``RTOL``, the ring cache as
    :func:`_assert_cache` (a row within f32 noise of a rounding boundary
    may round a code one step apart: measured 1 of 39680 V codes at 8 and
    at 4 bits) — then ``STEPS`` greedy ``decode_step`` calls (2 tokens: the
    dense path), each from the reference's own state, bridged across, so
    that a code rounded apart in the prefill does not carry into the step:
    the logits within ``LONG_TOL`` = 1e-4 — the f32 tolerance of the ssm
    and hybrid tests: each step attends over 300 rows whose f32 sums part
    a few ulp, measured up to 3.1e-5 at 4/4 — (``FLIP_TOL`` on a step
    whose new row rounds a code apart), the new cache, and the greedy
    token; and the port's own chain of ``STEPS`` steps from its own prefill
    gives the reference's greedy tokens."""
    jcfg, tcfg = _cfgs(bits, bits)
    jp = JT.init_params(jax.random.PRNGKey(1), jcfg)
    if bits:
        jp = jquantize(jp, bits=bits)
    tp = bridge(jp)
    tokens = np.random.default_rng(3).integers(0, jcfg.vocab_size, (2, 300))
    smax = 300 + STEPS + 2
    jl, js = jax.jit(lambda p, t: JT.prefill(p, t, jcfg, pad_to=smax))(
        jp, jnp.asarray(tokens, jnp.int32))
    tl, ts = make_prefill_step(tcfg, pad_to=smax)(tp, {"tokens": torch.from_numpy(tokens)})
    _close(tl, jl)
    _assert_cache(ts.layers, js.layers)
    jstep = jax.jit(lambda p, s, t: JT.decode_step(p, s, t, jcfg))
    tstep = make_serve_step(tcfg)
    tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)[:, None]
    np.testing.assert_array_equal(torch.argmax(tl, -1).numpy(), tok[:, 0])
    jtoks, ttoks, tok_t = [], [], torch.from_numpy(tok)
    for _ in range(STEPS):
        tlg, _, tnew = tstep(tp, _state_from_jax(js), torch.from_numpy(tok))
        jlg, js = jstep(jp, js, jnp.asarray(tok))
        flips = _assert_cache(tnew.layers, js.layers)
        _close(tlg, jlg, FLIP_TOL if flips else LONG_TOL)
        assert tnew.step == int(js.step)
        tok = np.asarray(jnp.argmax(jlg[:, -1], -1)).astype(np.int32)[:, None]
        np.testing.assert_array_equal(torch.argmax(tlg[:, -1], -1).numpy(), tok[:, 0])
        jtoks.append(tok[:, 0])
        _, tok_t, ts = tstep(tp, ts, tok_t[:, None] if tok_t.ndim == 1 else tok_t)
        ttoks.append(tok_t.numpy())
    np.testing.assert_array_equal(np.stack(ttoks), np.stack(jtoks))
    assert ts.step == int(js.step) == 300 + STEPS


def test_training_an_moe_model_raises_a6e():
    from repro_torch.train import make_step
    from repro_torch.optim import adamw

    with pytest.raises(NotImplementedError, match=r"A6\(e\)"):
        make_step(tconfigs.get_reduced(ARCH), adamw.AdamWConfig())


@pytest.mark.parametrize("extra", [[], ["--legacy", "--batch", "2", "--prompt-len", "300",
                                        "--gen", "3"]])
def test_serve_cli_serves_the_reduced_model(extra, capsys):
    serve_main(["--arch", ARCH, "--device", "cpu", "--requests", "3", "--weight-bits", "8",
                "--kv-bits", "8", *extra])
    out = capsys.readouterr().out
    assert ("[serve] generated (2, 303)" in out) if extra else ("3 requests" in out)
