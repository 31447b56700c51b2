"""Port parity — slice 12, the vlm family (llama-3.2-vision-11b: 40
self-attention layers and a cross-attention block over 4096 vision tokens
after every 5; reduced: 4 layers, a cross block after every 2, 16 vision
tokens, query blocks of 16) — cross attention, ``forward``,
``prefill_state`` and ``decode_step`` with their ring and cross caches,
``init_decode_state``, the legacy ``serve`` — against the reference at its
``REDUCED`` config, at f32 (ROADMAP C1), with the reference's params
bridged across (its ``blocks.self`` (n_cross, per, …) stack arrives as the
port's (L, …) ``layers``) and the reference's programs jitted (C4);
vision tokens and prompts made with numpy.

Tolerances: hidden states, logits, raw K/V rows (the ring's at KV bits
0, the cross caches') and KV scales within ``RTOL`` = 1e-5 of the
reference's largest magnitude (f32 sums in another order); ring-cache
codes and lengths byte-identical but where a K/V row lies within f32
noise of a rounding boundary (ROADMAP C22): there a code may round one
step apart, on at most ``CODE_FLIPS`` of the codes, and the logits from
then on are held to ``FLIP_TOL`` (measured: one int8 code of 8192 after
the prefill); greedy tokens equal.

ROADMAP C25: the reference's legacy ``serve`` feeds zero vision tokens,
under which every cross k and v is 0 and every cross block adds exactly
0; the port follows, and ``test_serve_matches_reference`` pins it.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_bridge import bridge, np32

from repro import configs as jconfigs
from repro.launch.serve import serve as jserve
from repro.launch.steps import make_serve_step as jmake_serve_step
from repro.models import attention as jattn
from repro.models import transformer as JT
from repro.precision.qat import quantize_param_tree as jquantize
from repro.quant import PrecisionPlan as JPlan
from repro_torch import configs as tconfigs
from repro_torch.launch.serve import serve
from repro_torch.launch.steps import make_prefill_step, make_serve_step
from repro_torch.models import attention as tattn
from repro_torch.models import transformer as TT
from repro_torch.quant import PrecisionPlan as TPlan

ARCH = "llama-3.2-vision-11b"
RTOL = 1e-5
STEPS = 8
BITS = [0, 8, 4]
CODE_FLIPS = 1e-3
FLIP_TOL = 1e-3


def _cfgs(bits=0, kv_bits=0):
    plan = dict(kv_bits=kv_bits, model_bits=bits, model_storage="int" if bits else "fake")
    jcfg = dataclasses.replace(jconfigs.get_reduced(ARCH), dtype=jnp.float32,
                               precision=JPlan(**plan))
    tcfg = tconfigs.get_reduced(ARCH, dtype=torch.float32, precision=TPlan(**plan))
    return jcfg, tcfg


def _pair(bits=0, kv_bits=0, seed=0):
    """Both reduced configs, the reference's params (int codes at ``bits``)
    and their bridge."""
    jcfg, tcfg = _cfgs(bits, kv_bits)
    jp = _jinit(seed, bits)
    return jcfg, tcfg, jp, bridge(jp)


@functools.lru_cache(maxsize=None)
def _jinit(seed=0, bits=0):
    """The reference's f32 params from ``PRNGKey(seed)``, int codes at
    ``bits`` (the precision plan does not enter the draw): the draw and
    the encode each one jitted program, made once a file (eager, they
    compile op by op)."""
    jcfg = _cfgs()[0]
    jp = jax.jit(lambda k: JT.init_params(k, jcfg))(jax.random.PRNGKey(seed))
    return jax.jit(lambda p: jquantize(p, bits=bits))(jp) if bits else jp


def _inputs(cfg, b=2, s=24, seed=1):
    """Prompts and f32 normal vision tokens (B, n_vis, d) from a numpy seed."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    vis = rng.normal(0, 1, (b, cfg.n_vis_tokens, cfg.d_model)).astype(np.float32)
    return toks, vis


def _gap(got, want) -> float:
    """max |got − want| over the largest |want|."""
    want = np32(want)
    return float(np.abs(np32(got) - want).max() / np.abs(want).max())


def _close(got, want, tol=RTOL):
    assert tuple(got.shape) == np32(want).shape
    assert _gap(got, want) <= tol


def test_config_fields_match_reference():
    """Every field of the port's ``ModelConfig``, full size and reduced,
    equals the reference's (the dtype by name), the attention spec too;
    the full size is the published backbone with 8 cross blocks."""
    skip = {"dtype", "precision"}
    for get in ("get_config", "get_reduced"):
        jcfg, tcfg = getattr(jconfigs, get)(ARCH), getattr(tconfigs, get)(ARCH)
        for f in dataclasses.fields(tcfg):
            if f.name not in skip:
                assert getattr(tcfg, f.name) == getattr(jcfg, f.name), (get, f.name)
        assert str(tcfg.dtype).removeprefix("torch.") == jnp.dtype(jcfg.dtype).name
        for f in dataclasses.fields(tcfg.attn_spec):
            assert getattr(tcfg.attn_spec, f.name) == getattr(jcfg.attn_spec, f.name)
    cfg = tconfigs.get_config(ARCH)
    assert (cfg.family, cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.head_dim, cfg.d_ff, cfg.vocab_size, cfg.cross_attn_every,
            cfg.n_vis_tokens, cfg.rope_theta, cfg.tie_embeddings) == \
        ("vlm", 40, 4096, 32, 8, 128, 14336, 128256, 5, 4096, 5e5, True)
    assert ARCH in tconfigs.ARCH_IDS


def test_init_params_tree_is_the_reference_tree_reshaped():
    """The port's tree is the reference's with ``blocks.self`` (n_cross,
    per, …) as ``layers`` (L, …) and ``blocks.cross`` as ``cross``; the
    bridge reshapes every leaf, int codes and scales included, keeping
    the layer order (block i, layer j is layer i · per + j)."""
    jcfg, tcfg = _cfgs()
    jraw = _jinit()
    traw = TT.init_params(tcfg, seed=0, device="cpu")
    per = tcfg.cross_attn_every

    def shapes(tree):
        return {jax.tree_util.keystr(k): tuple(v.shape)
                for k, v in jax.tree_util.tree_leaves_with_path(tree)}

    want = {}
    for k, v in shapes(jraw).items():
        if k.startswith("['blocks']['self']"):
            want[k.replace("['blocks']['self']", "['layers']")] = (v[0] * v[1], *v[2:])
        else:
            want[k.replace("['blocks']['cross']", "['cross']")] = v
    assert shapes(traw) == want
    jq = _jinit(bits=4)
    tq = bridge(jq)
    jw, tw = jq["blocks"]["self"]["mlp"]["down"]["w"], tq["layers"]["mlp"]["down"]["w"]
    codes, scale = np.asarray(jw.codes), np.asarray(jw.scale)
    for i in range(tcfg.n_layers // per):
        for j in range(per):
            np.testing.assert_array_equal(tw.codes[i * per + j].numpy(), codes[i, j])
            np.testing.assert_array_equal(tw.scale[i * per + j].numpy(), scale[i, j])
    assert tq["cross"]["attn"]["q"]["w"].codes.shape[0] == tcfg.n_layers // per


@pytest.mark.parametrize("s,q_chunk", [(24, 16), (40, 16), (7, 16)])
def test_cross_attention_matches_reference(s, q_chunk):
    """``chunked_attention(causal=False)``: query blocks of 16 (24 and 40
    rows pad the reference's last block; 7 is one block) against 16 keys,
    every query seeing every key, no mask built."""
    rng = np.random.default_rng(s)
    q = rng.normal(0, 1, (2, s, 4, 16)).astype(np.float32)
    k, v = (rng.normal(0, 1, (2, 16, 2, 16)).astype(np.float32) for _ in range(2))
    jspec = jattn.AttnSpec(4, 2, 16, q_chunk=q_chunk)
    tspec = tattn.AttnSpec(4, 2, 16, q_chunk=q_chunk)
    want = jax.jit(lambda q, k, v: jattn.chunked_attention(q, k, v, jspec,
                                                           causal=False))(q, k, v)
    got = tattn.chunked_attention(*map(torch.from_numpy, (q, k, v)), tspec, causal=False)
    _close(got, want)


def test_cross_attention_never_builds_whole_prompt_scores(monkeypatch):
    """Each query block attends every key, one block of ``q_chunk`` rows at
    a time, with no mask."""
    seen = []
    orig = tattn._attend_block

    def spy(q, k, v, scale, mask):
        seen.append((q.shape[1], k.shape[1], mask))
        return orig(q, k, v, scale, mask)

    monkeypatch.setattr(tattn, "_attend_block", spy)
    q = torch.randn(1, 40, 4, 16)
    kv = torch.randn(1, 100, 2, 16)
    tattn.chunked_attention(q, kv, kv, tattn.AttnSpec(4, 2, 16, q_chunk=16), causal=False)
    assert seen == [(16, 100, None), (16, 100, None), (8, 100, None)]


@pytest.mark.parametrize("bits", BITS)
def test_forward_matches_reference(bits):
    """The whole reduced model over 24 tokens (two query blocks) with
    seeded vision tokens, at int weights ``bits``: final hidden states
    within ``RTOL``."""
    jcfg, tcfg, jp, tp = _pair(bits)
    toks, vis = _inputs(tcfg)
    want = jax.jit(lambda p, t, v: JT.forward(p, t, jcfg, vision_tokens=v))(
        jp, jnp.asarray(toks), jnp.asarray(vis))
    with torch.no_grad():
        got = TT.forward(tp, torch.from_numpy(toks), tcfg,
                         vision_tokens=torch.from_numpy(vis))
    _close(got, want)


def _assert_planes_close(got, want, name, tol=RTOL) -> int:
    """An int code plane equal but for at most ``CODE_FLIPS`` of its codes
    one step apart (C22; packed int4 compared code by code); a float plane
    (raw rows, scales) in the same dtype and within ``tol`` of its largest
    magnitude. Returns how many codes differ."""
    from repro_torch.quant.qtensor import unpack_int4

    assert str(got.dtype).removeprefix("torch.") == str(want.dtype), name
    assert tuple(got.shape) == tuple(want.shape), name
    if got.dtype in (torch.int8, torch.uint8):
        want = torch.from_numpy(np.array(want))
        if got.dtype == torch.uint8:
            got, want = unpack_int4(got), unpack_int4(want)
        diff = (got.to(torch.int32) - want.to(torch.int32)).abs()
        flips = int((diff > 0).sum())
        assert int(diff.max()) <= 1 and flips <= CODE_FLIPS * diff.numel(), (name, flips)
        return flips
    want = np32(want)
    np.testing.assert_allclose(np32(got), want, rtol=tol,
                               atol=tol * float(np.abs(want).max()), err_msg=name)
    return 0


def _assert_ring_equal(tc, jc, flips: int = 0) -> int:
    """Lengths equal, codes as :func:`_assert_planes_close`, raw rows and
    scales within ``RTOL`` — ``FLIP_TOL`` once ``flips`` codes, these
    included, rounded apart (a flipped row moves every later layer's
    rows); returns the codes apart so far."""
    np.testing.assert_array_equal(tc.length.numpy(), np.asarray(jc.length))
    for name in ("k", "v", "k_scale", "v_scale"):
        want = getattr(jc, name)
        if want is None:
            assert getattr(tc, name) is None, name
            continue
        flips += _assert_planes_close(getattr(tc, name), want, name,
                                      FLIP_TOL if flips else RTOL)
    return flips


def _assert_cross_equal(tcross, jcross, cfg):
    """The cross caches raw, in ``cfg.dtype``, and close."""
    for name in ("k", "v"):
        assert tcross[name].dtype == cfg.dtype, name
        _assert_planes_close(tcross[name], jcross[name], name)


@pytest.mark.parametrize("bits", BITS)
def test_prefill_and_decode_match_reference(bits):
    """``prefill_state`` (24 tokens, ``pad_to`` 24 + 8) and 8 greedy
    ``decode_step``s at weight and KV bits ``bits`` against the reference's
    jitted ``prefill(pad_to=)`` and serve step, each fed its own greedy
    tokens: logits within ``RTOL`` after the prefill and every step
    (``FLIP_TOL`` once a code rounded apart, C22), tokens equal, the ring
    caches' lengths equal, codes equal (C22 aside) and scales close after
    the prefill and every step, the cross caches raw in ``cfg.dtype`` and
    close whatever ``kv_bits``."""
    jcfg, tcfg, jp, tp = _pair(bits, bits)
    toks, vis = _inputs(tcfg)
    pad = toks.shape[1] + STEPS
    jl, js = jax.jit(lambda p, t, v: JT.prefill(p, t, jcfg, vision_tokens=v, pad_to=pad))(
        jp, jnp.asarray(toks), jnp.asarray(vis))
    tl, ts = make_prefill_step(tcfg, pad_to=pad)(
        tp, {"tokens": torch.from_numpy(toks), "vision": torch.from_numpy(vis)})
    _close(tl, jl)
    flips = _assert_ring_equal(ts.layers, js.layers)
    _assert_cross_equal(ts.cross, js.cross, tcfg)
    n_cross = tcfg.n_layers // tcfg.cross_attn_every
    assert ts.cross["k"].shape == (n_cross, 2, tcfg.n_vis_tokens, tcfg.n_kv_heads,
                                   tcfg.head_dim)
    jstep, tstep = jax.jit(jmake_serve_step(jcfg)), make_serve_step(tcfg)
    jtok = jnp.argmax(jl, -1).astype(jnp.int32)[:, None]
    ttok = torch.argmax(tl, -1).to(torch.int32)[:, None]
    for _ in range(STEPS):
        np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
        jlg, jn, js = jstep(jp, js, jtok)
        tlg, tn, ts = tstep(tp, ts, ttok)
        flips = _assert_ring_equal(ts.layers, js.layers, flips)
        _close(tlg, jlg, FLIP_TOL if flips else RTOL)
        jtok, ttok = jn[:, None], tn[:, None]
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    assert ts.step == int(js.step) == toks.shape[1] + STEPS
    _assert_cross_equal(ts.cross, js.cross, tcfg)


@pytest.mark.parametrize("kv_bits", BITS)
def test_init_decode_state_matches_reference(kv_bits):
    """``init_decode_state(params=, vision_tokens=)``: each cross block's
    K/V projection of the vision tokens, raw in ``cfg.dtype`` whatever
    ``kv_bits``, close to the reference's; without them zero caches of
    ``n_vis_tokens`` rows; the ring as the reference's."""
    jcfg, tcfg, jp, tp = _pair(8, kv_bits)
    _, vis = _inputs(tcfg)
    js = jax.jit(lambda p, v: JT.init_decode_state(jcfg, 2, 20, params=p, vision_tokens=v))(
        jp, jnp.asarray(vis))
    ts = TT.init_decode_state(tcfg, 2, 20, params=tp, vision_tokens=torch.from_numpy(vis),
                              device="cpu")
    _assert_cross_equal(ts.cross, js.cross, tcfg)
    _assert_ring_equal(ts.layers, js.layers)
    zero = TT.init_decode_state(tcfg, 2, 20, device="cpu")
    _assert_cross_equal(zero.cross, JT.init_decode_state(jcfg, 2, 20).cross, tcfg)
    assert not zero.cross["k"].any() and ts.cross["k"].any()


def test_prefill_then_decode_matches_forward():
    """The reference's own check (``tests/test_arch_smoke.py``), in the
    port: prefill(prompt[:, :7]) and one decode step of token 7 give the
    teacher-forced forward's logits at positions 6 and 7 (rtol = atol =
    2e-3, the reference's; f32), with the reference's ``_batch`` shapes."""
    cfg = tconfigs.get_reduced(ARCH, dtype=torch.float32)
    params = TT.init_params(cfg, seed=0, device="cpu")
    toks, vis = _inputs(cfg, b=1, s=8, seed=2)
    tokens, vision = torch.from_numpy(toks), torch.from_numpy(vis)
    with torch.no_grad():
        full = TT._readout(params, cfg, TT.forward(params, tokens, cfg,
                                                   vision_tokens=vision))
        pre, _ = TT.prefill(params, tokens[:, :7], cfg, vision_tokens=vision)
    torch.testing.assert_close(pre, full[:, 6], rtol=2e-3, atol=2e-3)
    _, state = TT.prefill_state(params, tokens[:, :7], cfg, vision_tokens=vision, pad_to=8)
    lg, _ = TT.decode_step(params, state, tokens[:, 7:8], cfg)
    torch.testing.assert_close(lg[:, 0], full[:, 7], rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("bits", BITS)
def test_serve_matches_reference(bits, monkeypatch):
    """The legacy ``serve`` at weight/KV bits ``bits`` (the reference's
    prompts and zero vision tokens, ``pad_to`` = prompt + gen) against the
    reference's ``serve()``, both building the same f32 model (each
    package's ``_build`` handed the reference's params, bridged for the
    port): tokens equal. Every cross block adds exactly 0 there (ROADMAP
    C25): the cross caches the prefill leaves are all zero, and the tokens
    are those of the model with every cross block's output dropped."""
    import repro.launch.serve as jlaunch

    jcfg, tcfg, jp, tp = _pair(bits, bits)
    monkeypatch.setattr(jlaunch, "_build",
                        lambda arch, **kw: (jcfg, jp, jax.random.PRNGKey(kw["seed"])))
    monkeypatch.setattr("repro_torch.launch.serve._build", lambda arch, **kw: (tcfg, tp))
    kw = dict(batch=2, prompt_len=12, gen=6, kv_bits=bits, weight_bits=bits)
    got, _ = serve(ARCH, device="cpu", **kw)
    want, _ = jserve(ARCH, **kw)
    np.testing.assert_array_equal(got, np.asarray(want))
    states = []
    prefill_state, cross_block = TT.prefill_state, TT._cross_block_kv

    def keep(*a, **k):
        out = prefill_state(*a, **k)
        states.append(out[1])
        return out

    monkeypatch.setattr(TT, "prefill_state", keep)
    monkeypatch.setattr(TT, "_cross_block_kv",
                        lambda cfg, blk, x, vis: (x, *cross_block(cfg, blk, x, vis)[1:]))
    monkeypatch.setattr(TT, "_cross_decode", lambda cfg, blk, x, ck, cv: x)
    dropped, _ = serve(ARCH, device="cpu", **kw)
    np.testing.assert_array_equal(dropped, got)
    assert not states[0].cross["k"].any() and not states[0].cross["v"].any()


def test_cross_blocks_add_nothing_on_zero_vision():
    """C25 at the block: a cross block on zero vision tokens adds exactly
    0 to the stream, on seeded ones it adds something."""
    cfg = tconfigs.get_reduced(ARCH, dtype=torch.float32)
    params = TT.init_params(cfg, seed=0, device="cpu")
    blk = TT.cross_views(params, cfg)[0]
    x = torch.randn(2, 5, cfg.d_model)
    _, vis = _inputs(cfg)
    out, _, _ = TT._cross_block_kv(cfg, blk, x, torch.zeros(2, cfg.n_vis_tokens, cfg.d_model))
    assert torch.equal(out, x)
    out, _, _ = TT._cross_block_kv(cfg, blk, x, torch.from_numpy(vis))
    assert not torch.equal(out, x)


def test_engine_rejects_vlm():
    """As the reference's engine: the vlm caches are not paged."""
    from repro.serve import ServeEngine as JEngine
    from repro_torch.serve import ServeEngine

    jcfg, tcfg = _cfgs()
    with pytest.raises(ValueError, match="not paged"):
        JEngine(_jinit(), jcfg)
    with pytest.raises(ValueError, match="not paged"):
        ServeEngine(TT.init_params(tcfg, device="cpu"), tcfg, device="cpu")


def test_training_vlm_raises_a6f():
    from repro_torch.optim import adamw
    from repro_torch.train import make_step

    with pytest.raises(NotImplementedError, match=r"A6\(f\)"):
        make_step(tconfigs.get_reduced(ARCH), adamw.AdamWConfig())


@pytest.mark.parametrize("over,match", [(dict(cross_attn_every=3), "cross_attn_every"),
                                        (dict(cross_attn_every=0), "cross_attn_every")])
def test_cross_cadence_must_divide_the_layers(over, match):
    cfg = tconfigs.get_reduced(ARCH, **over)
    with pytest.raises(ValueError, match=match):
        TT.init_params(cfg, device="cpu")


def test_vlm_forward_needs_vision_tokens():
    cfg = tconfigs.get_reduced(ARCH)
    params = TT.init_params(cfg, device="cpu")
    with pytest.raises(ValueError, match="vision_tokens"):
        TT.forward(params, torch.zeros((1, 4), dtype=torch.int64), cfg)
