"""Port parity — slice 11: sliding-window attention and its ring KV cache
(mixtral-8x7b: 8 experts, top 2, window 4096; reduced: 4 experts, top 2,
window 32, query blocks of 16) — ``chunked_attention`` with a window,
``prefill_cache_from_kv`` / ``update_kv_cache(window=)``, the legacy loop
— against the reference at its ``REDUCED`` config, at f32 (the reference's
stacked bf16 product does not run on this CPU stack, ROADMAP C1), with the
reference's params bridged across and inputs made with numpy; and the
build that encodes each weight a layer at a time as it is drawn.

Tolerances: windowed attention, forward and the raw-KV logits within
``RTOL`` = 1e-5 of the reference's largest magnitude (f32 sums in another
order); ring-cache codes, scales, lengths and cursors byte-identical (the
rows are the same f32 inputs); greedy tokens equal; the streamed build's
codes and scales byte-identical to ``quantize_param_tree(init_params())``.

ROADMAP C24, the reference's ring: the cache keeps the prompt's last W
rows and decode writes at ``length % rows``, so the ring holds the window
only where the prompt is longer than W and a multiple of it. The port
follows; ``test_ring_follows_the_reference_c24`` pins both faulty cases.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_bridge import bridge, np32

from repro import configs as jconfigs
from repro.launch.steps import make_serve_step as jmake_serve_step
from repro.models import attention as jattn
from repro.models import transformer as JT
from repro.precision.qat import quantize_param_tree as jquantize
from repro.quant import PrecisionPlan as JPlan
from repro_torch import configs as tconfigs
from repro_torch import prng
from repro_torch.launch.serve import _build, main as serve_main, serve, serve_engine
from repro_torch.launch.steps import make_prefill_step, make_serve_step
from repro_torch.models import attention as tattn
from repro_torch.models import transformer as TT
from repro_torch.precision.qat import quantize_param_tree, quantizing_store
from repro_torch.quant import PrecisionPlan as TPlan
from repro_torch.quant import QTensor

ARCH = "mixtral-8x7b"
RTOL = 1e-5
W = 32                          # the reduced window
GEN = 16


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
    jp = JT.init_params(jax.random.PRNGKey(seed), jcfg)
    if bits:
        jp = jquantize(jp, bits=bits)
    return jcfg, tcfg, jp, bridge(jp)


def _gap(got, want) -> float:
    """max |got − want| over the largest |want|."""
    want = np32(want)
    return float(np.abs(np32(got) - want).max() / np.abs(want).max())


def _close(got, want, tol=RTOL):
    assert tuple(got.shape) == np32(want).shape
    assert _gap(got, want) <= tol


def test_config_fields_match_reference():
    """Every field of the port's ``ModelConfig``, full size and reduced,
    equals the reference's (the dtype by name), the attention and MoE
    specs too; mixtral is registered."""
    skip = {"dtype", "precision"}
    for get in ("get_config", "get_reduced"):
        jcfg, tcfg = getattr(jconfigs, get)(ARCH), getattr(tconfigs, get)(ARCH)
        for f in dataclasses.fields(tcfg):
            if f.name not in skip:
                assert getattr(tcfg, f.name) == getattr(jcfg, f.name), (get, f.name)
        assert str(tcfg.dtype).removeprefix("torch.") == jnp.dtype(jcfg.dtype).name
        for js, ts in ((jcfg.moe_spec, tcfg.moe_spec), (jcfg.attn_spec, tcfg.attn_spec)):
            for f in dataclasses.fields(ts):
                assert getattr(ts, f.name) == getattr(js, f.name), (get, f.name)
    cfg = tconfigs.get_config(ARCH)
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_ff,
            cfg.n_experts, cfg.top_k, cfg.window, cfg.rope_theta, cfg.vocab_padded) == \
        (32, 4096, 32, 8, 128, 14336, 8, 2, 4096, 1e6, 32000)
    assert ARCH in tconfigs.ARCH_IDS


def test_init_params_tree_matches_reference():
    jcfg, tcfg = jconfigs.get_reduced(ARCH), tconfigs.get_reduced(ARCH)
    jraw = JT.init_params(jax.random.PRNGKey(0), jcfg)
    traw = TT.init_params(tcfg, seed=0, device="cpu")
    want = {jax.tree_util.keystr(k): (tuple(v.shape), str(v.dtype))
            for k, v in jax.tree_util.tree_leaves_with_path(jraw)}
    got = {jax.tree_util.keystr(k): (tuple(v.shape), str(v.dtype).removeprefix("torch."))
           for k, v in jax.tree_util.tree_leaves_with_path(traw)}
    assert got == want


def _qkv(s, seed=0, b=2, h=4, hkv=2, d=16):
    rng = np.random.default_rng(seed)
    return [rng.normal(0, 1, (b, s, n, d)).astype(np.float32) for n in (h, hkv, hkv)]


@pytest.mark.parametrize("q_chunk", [16, 128], ids=["blocks", "full block"])
@pytest.mark.parametrize("s", [20, 32, 33, 64, 100])
def test_chunked_attention_window_matches_reference(s, q_chunk):
    """``chunked_attention`` with window 32 against the reference's: query
    blocks of 16 (s 20, 33 and 100 pad the reference's last block; s 64
    and 100 bind the window over several blocks) and one block of 128
    (the whole sequence at once, the window a mask only)."""
    q, k, v = _qkv(s, seed=s)
    jspec = jattn.AttnSpec(4, 2, 16, window=W, q_chunk=q_chunk)
    tspec = tattn.AttnSpec(4, 2, 16, window=W, q_chunk=q_chunk)
    want = jax.jit(lambda q, k, v: jattn.chunked_attention(q, k, v, jspec))(q, k, v)
    got = tattn.chunked_attention(*map(torch.from_numpy, (q, k, v)), tspec)
    _close(got, want)
    if W < s:
        # the window binds: unwindowed attention gives another answer
        full = tattn.chunked_attention(*map(torch.from_numpy, (q, k, v)),
                                       dataclasses.replace(tspec, window=0))
        assert _gap(full, want) > 100 * RTOL


def test_windowed_attention_never_builds_s_by_s_scores(monkeypatch):
    """Each block's scores span at most W + q_chunk keys."""
    seen = []
    orig = tattn._attend_block

    def spy(q, k, v, scale, mask):
        seen.append(tuple(mask.shape))
        return orig(q, k, v, scale, mask)

    monkeypatch.setattr(tattn, "_attend_block", spy)
    q, k, v = _qkv(100)
    tattn.chunked_attention(*map(torch.from_numpy, (q, k, v)),
                            tattn.AttnSpec(4, 2, 16, window=W, q_chunk=16))
    assert seen == [(16, 48)] * 6 + [(4, 48)]


def _assert_cache_equal(tc, jc):
    """Lengths, codes, scales and raw rows byte-identical."""
    np.testing.assert_array_equal(tc.length.numpy(), np.asarray(jc.length))
    for name in ("k", "v", "k_scale", "v_scale"):
        want = getattr(jc, name)
        if want is None:
            assert getattr(tc, name) is None, name
            continue
        got = getattr(tc, name)
        assert str(got.dtype).removeprefix("torch.") == str(want.dtype), name
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=name)


@pytest.mark.parametrize("s,pad_to", [(40, 48), (64, 72), (32, 48), (20, 44)])
@pytest.mark.parametrize("kv_bits", [0, 8, 4])
def test_ring_cache_matches_reference(kv_bits, s, pad_to):
    """``prefill_cache_from_kv(window=32)`` then 20 ``update_kv_cache``
    appends (the cursor wraps the ring in every case) against the
    reference's: every plane byte-identical after each step."""
    _, k, v = _qkv(s, seed=7)
    jc = jattn.prefill_cache_from_kv(jnp.asarray(k), jnp.asarray(v), window=W,
                                     kv_bits=kv_bits, pad_to=pad_to)
    tc = tattn.prefill_cache_from_kv(torch.from_numpy(k), torch.from_numpy(v), window=W,
                                     kv_bits=kv_bits, pad_to=pad_to)
    assert tc.k.shape[1] == (W if W < s else max(s, pad_to))
    _assert_cache_equal(tc, jc)
    for step in range(20):
        _, kn, vn = _qkv(1, seed=100 + step)
        jc = jattn.update_kv_cache(jc, jnp.asarray(kn), jnp.asarray(vn), window=W,
                                   kv_bits=kv_bits)
        tc = tattn.update_kv_cache(tc, torch.from_numpy(kn), torch.from_numpy(vn), window=W)
        _assert_cache_equal(tc, jc)


def test_init_decode_state_holds_the_window():
    cfg = tconfigs.get_reduced(ARCH, precision=TPlan(kv_bits=8))
    assert TT.init_decode_state(cfg, 2, 100, device="cpu").layers.k.shape[2] == W
    assert TT.init_decode_state(cfg, 2, 20, device="cpu").layers.k.shape[2] == 20


def test_forward_matches_reference():
    """The whole reduced model over 100 tokens (7 query blocks, the window
    binding in all but the first two)."""
    jcfg, tcfg, jp, tp = _pair()
    toks = np.random.default_rng(1).integers(0, jcfg.vocab_size, (2, 100)).astype(np.int32)
    want = jax.jit(lambda p, t: JT.forward(p, t, jcfg))(jp, jnp.asarray(toks))
    with torch.no_grad():
        got = TT.forward(tp, torch.from_numpy(toks), tcfg)
    _close(got, want)


@pytest.mark.parametrize("plen", [64, 40], ids=["ring identity", "C24"])
@pytest.mark.parametrize("bits", [0, 8, 4])
def test_legacy_loop_matches_reference(bits, plen):
    """The legacy loop as ``serve`` runs it — the reference's prompts
    (``randint(fold_in(key, 1))``), a prefill with ``pad_to = prompt +
    gen`` (the window keeps the last 32 rows instead), then ``GEN`` greedy
    steps — at weight and KV bits ``bits`` on bridged params: greedy
    tokens equal at every step, and at raw KV the logits within ``RTOL``
    after the prefill and every step."""
    batch = 2
    jcfg, tcfg, jp, tp = _pair(bits, bits)
    jprompts = jax.random.randint(jax.random.fold_in(jax.random.PRNGKey(0), 1),
                                  (batch, plen), 0, jcfg.vocab_size)
    tprompts = prng.randint(prng.fold_in(prng.PRNGKey(0), 1), (batch, plen), 0,
                            tcfg.vocab_size, device="cpu")
    np.testing.assert_array_equal(tprompts.numpy(), np.asarray(jprompts))
    jl, js = jax.jit(lambda p, t: JT.prefill(p, t, jcfg, pad_to=plen + GEN))(jp, jprompts)
    tl, ts = make_prefill_step(tcfg, pad_to=plen + GEN)(tp, {"tokens": tprompts})
    assert ts.layers.k.shape[2] == js.layers.k.shape[2] == W
    jstep = jax.jit(jmake_serve_step(jcfg))
    tstep = make_serve_step(tcfg)
    jtok = jnp.argmax(jl, -1).astype(jnp.int32)[:, None]
    ttok = torch.argmax(tl, -1).to(torch.int32)[:, None]
    pairs = [(tl, jl)]
    for _ in range(GEN - 1):
        np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
        jlg, jn, js = jstep(jp, js, jtok)
        tlg, tn, ts = tstep(tp, ts, ttok)
        pairs.append((tlg, jlg))
        jtok, ttok = jn[:, None], tn[:, None]
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    assert ts.step == int(js.step) == plen + GEN - 1
    np.testing.assert_array_equal(ts.layers.length.numpy(), np.asarray(js.layers.length))
    if not bits:
        for got, want in pairs:
            _close(got, want)


def _consistency(params, cfg, tokens, pad_to, prefill, step):
    """prefill(prompt) + one decode step of the last token against
    prefill(prompt + that token)'s last logits: their gap over the largest,
    and the two states."""
    _, state = prefill(params, tokens[:, :-1], pad_to)
    lg, new = step(params, state, tokens[:, -1:])
    want, _ = prefill(params, tokens, 0)
    return _gap(lg[:, -1], want), state, new


@pytest.mark.parametrize("plen,pad_to,band", [(64, 72, (0.0, 1e-5)),
                                              (40, 48, (1e-2, np.inf)),
                                              (32, 48, (1e-2, np.inf))],
                         ids=["ring identity", "ring out of order", "padded, never cut"])
def test_ring_follows_the_reference_c24(plen, pad_to, band):
    """ROADMAP C24, as the reference: prefill(prompt) + one decode step
    equals prefill(prompt + 1 token) only where the prompt is longer than
    W and a multiple of it. A prompt of 40 keeps positions 8..39 and the
    first step overwrites slot 40 % 32 = 8, which holds position 16, while
    position 8 stays; a prompt of 32 (= W) keeps a padded cache of 48 rows,
    never cut back to W, so the step attends 33 rows. The port's gap equals
    the reference's (f32, ``PRNGKey(0)``, tokens from ``default_rng(0)``)."""
    jcfg, tcfg, jp, tp = _pair()
    toks = np.random.default_rng(0).integers(0, jcfg.vocab_size, (2, plen + 1))
    jgap, _, _ = _consistency(
        jp, jcfg, jnp.asarray(toks, jnp.int32),
        pad_to, lambda p, t, n: JT.prefill(p, t, jcfg, pad_to=n),
        lambda p, s, t: JT.decode_step(p, s, t, jcfg))
    tgap, state, new = _consistency(
        tp, tcfg, torch.from_numpy(toks), pad_to,
        lambda p, t, n: TT.prefill_state(p, t, tcfg, pad_to=n),
        lambda p, s, t: TT.decode_step(p, s, t, tcfg))
    assert band[0] <= jgap < band[1]
    assert abs(tgap - jgap) <= RTOL
    rows = state.layers.k.shape[2]
    assert rows == (W if plen > W else pad_to)
    # layer 0's ring against its rows without a window (layer 0's K does
    # not depend on the window): the last W prompt rows in order, or the
    # whole prompt and zero rows
    full = TT.prefill_state(tp, torch.from_numpy(toks[:, :-1]),
                            dataclasses.replace(tcfg, window=0))[1].layers.k[0]
    ring = state.layers.k[0]
    if plen > W:
        assert torch.equal(ring, full[:, plen - W:])
    else:
        assert torch.equal(ring[:, :plen], full) and not ring[:, plen:].any()
    slot = plen % rows
    changed = (new.layers.k != state.layers.k).flatten(3).any(-1)   # (L, B, rows)
    assert changed[:, :, slot].all()
    assert not changed[:, :, :slot].any() and not changed[:, :, slot + 1:].any()


def test_engine_rejects_windows():
    """As the reference's engine: sliding-window models are not paged, so
    ``serve_engine`` and ``ServeEngine`` raise its ``ValueError``."""
    from repro.serve import ServeEngine as JEngine
    from repro_torch.serve import ServeEngine

    msg = "sliding-window models are not paged yet"
    jcfg = jconfigs.get_reduced(ARCH)
    with pytest.raises(ValueError, match=msg):
        JEngine(JT.init_params(jax.random.PRNGKey(0), jcfg), jcfg)
    with pytest.raises(ValueError, match=msg):
        serve_engine(ARCH, device="cpu", n_requests=2)
    cfg = tconfigs.get_reduced(ARCH)
    with pytest.raises(ValueError, match=msg):
        ServeEngine(TT.init_params(cfg, device="cpu"), cfg, device="cpu")


def test_training_mixtral_raises_a6e():
    from repro_torch.optim import adamw
    from repro_torch.train import make_step

    with pytest.raises(NotImplementedError, match=r"A6\(e\)"):
        make_step(tconfigs.get_reduced(ARCH), adamw.AdamWConfig())


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _leaves(tree[key], (*path, key))
    else:
        yield path, tree


def _assert_trees_identical(got, want) -> int:
    """Same paths; QTensors' schemes, codes and scales and every other
    leaf byte-identical. Returns the number of QTensors."""
    g, w = dict(_leaves(got)), dict(_leaves(want))
    assert g.keys() == w.keys()
    n = 0
    for path, leaf in w.items():
        if isinstance(leaf, QTensor):
            n += 1
            assert isinstance(g[path], QTensor) and g[path].scheme == leaf.scheme, path
            assert torch.equal(g[path].codes, leaf.codes), path
            assert torch.equal(g[path].scale, leaf.scale), path
        else:
            assert g[path].dtype == leaf.dtype and torch.equal(g[path], leaf), path
    return n


@pytest.mark.parametrize("bits,layout", [(8, "dense"), (4, "dense"), (4, "bitplane")])
@pytest.mark.parametrize("arch", tconfigs.ARCH_IDS)
def test_streamed_build_codes_identical(arch, bits, layout):
    """Every family at the reduced size: the weights encoded a layer at a
    time as they are drawn (``quantizing_store``, what ``_build`` serves)
    give the codes and scales of ``quantize_param_tree(init_params())``,
    byte for byte, and every other leaf equal."""
    cfg = tconfigs.get_reduced(arch)
    want = quantize_param_tree(TT.init_params(cfg, seed=3, device="cpu"), bits=bits,
                               layout=layout)
    got = TT.init_params(cfg, seed=3, device="cpu", weight=quantizing_store(bits, layout))
    assert _assert_trees_identical(got, want) >= 2
    if layout == "dense":
        plan = TPlan(model_bits=bits, model_storage="int")
        _, built = _build(arch, reduced=True, plan=plan, seed=3, device="cpu")
        _assert_trees_identical(built, want)


def test_stacked_draws_come_a_layer_at_a_time():
    """``init_params`` draws each stacked weight one layer at a time, so the
    stored tree and the streamed one share their draws: layer i of a
    stacked leaf is the generator's i-th draw of that leaf's layer shape."""
    from repro_torch.models.layers import draw_layers, stack_layers

    gen = torch.Generator().manual_seed(4)
    w = stack_layers(draw_layers(gen, (5, 6), 0.5, lead=(3, 2)), (3, 2))
    gen.manual_seed(4)
    for i in range(3):
        want = (torch.randn((2, 5, 6), generator=gen) * 0.5).to(torch.bfloat16)
        assert torch.equal(w[i], want)
    assert w.shape == (3, 2, 5, 6) and w.dtype == torch.bfloat16


def test_legacy_serve_on_cpu():
    """``serve`` on the reduced mixtral from its streamed int8 build: the
    reference's prompts, in-vocab tokens of shape (B, prompt + gen)."""
    tokens, tps = serve(ARCH, batch=2, prompt_len=40, gen=4, weight_bits=8, kv_bits=8,
                        device="cpu")
    want = jax.random.randint(jax.random.fold_in(jax.random.PRNGKey(0), 1), (2, 40), 0, 256)
    assert tokens.shape == (2, 44)
    np.testing.assert_array_equal(tokens[:, :40], np.asarray(want))
    assert tokens.min() >= 0 and tokens.max() < 256 and np.isfinite(tps)


@pytest.mark.parametrize("bits", ["0", "4"])
def test_serve_cli_serves_the_reduced_model(bits, capsys):
    serve_main(["--arch", ARCH, "--device", "cpu", "--legacy", "--batch", "2",
                "--prompt-len", "64", "--gen", "3", "--weight-bits", bits,
                "--kv-bits", bits])
    assert "[serve] generated (2, 67)" in capsys.readouterr().out
