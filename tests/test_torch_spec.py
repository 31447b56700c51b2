"""Port parity — any-precision bitplane serving, self-speculative decoding
and the precision autoscaler in the engine (repro_torch.serve vs
repro.serve, on the CPU, reduced gemma-2b at f32 with the reference's
8-bit bitplane weights bridged across).

* the port's bitplane engine emits the reference engine's greedy tokens
  (``ref`` backends), at kv 0/8/4;
* ``set_weight_bits(2)`` serves exactly what a direct 2-bit quantization
  serves, and what the reference's sliced engine serves;
* speculative decoding (``spec_decode=3``) is token-identical to vanilla
  decode for kv 0/8/4 × draft 4/2 and to the reference's speculative engine,
  with no page leak; ``spec_decode=0`` is vanilla; serving at
  ``draft_bits`` pauses speculation and a restore resumes it; tokens are
  counted exactly once; windows that cross a page boundary;
* the autoscaler drives the engine on a virtual clock to the reference's
  decisions;
* ``serve_engine``'s ship artifact, validation and the CLI.

Every comparison is of greedy token ids: exact.
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

from torch_bridge import bridge

from repro import configs as jconfigs
from repro.launch.serve import make_trace as jtrace
from repro.models import transformer as JT
from repro.precision.qat import quantize_param_tree as jquantize
from repro.quant import PrecisionPlan as JPlan
from repro.serve import AutoscalerConfig as JAscCfg
from repro.serve import PrecisionAutoscaler as JAsc
from repro.serve import ServeEngine as JEngine
from repro_torch import configs as tconfigs
from repro_torch.launch.serve import make_trace as ttrace
from repro_torch.launch.serve import serve_engine
from repro_torch.quant import PrecisionPlan as TPlan
from repro_torch.serve import AutoscalerConfig as TAscCfg
from repro_torch.serve import PrecisionAutoscaler as TAsc
from repro_torch.serve import Request, ServeEngine

ROOT = Path(__file__).resolve().parents[1]
ENV = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
TRACE = dict(max_new=10, max_prompt=14, seed=0)
EKW = dict(max_slots=2, page_size=4, max_seq_len=32)


@pytest.fixture(scope="module")
def models():
    """Reduced gemma-2b at f32: the reference's dense params and their 8-bit
    and 2-bit bitplane trees, on both sides."""
    jcfg = dataclasses.replace(jconfigs.get_reduced("gemma-2b"), dtype=jnp.float32)
    tcfg = tconfigs.get_reduced("gemma-2b", dtype=torch.float32)
    params = JT.init_params(jax.random.PRNGKey(0), jcfg)
    bp8 = jquantize(params, bits=8, layout="bitplane")
    bp2 = jquantize(params, bits=2, layout="bitplane")
    return {"jcfg": jcfg, "tcfg": tcfg, "j8": bp8, "j2": bp2, "t8": bridge(bp8),
            "t2": bridge(bp2), "dense": bridge(params)}


def _port(m, kv_bits, params="t8", **kw):
    return ServeEngine(m[params], m["tcfg"], plan=TPlan(kv_bits=kv_bits), device="cpu",
                       **{**EKW, **kw})


def _ref(m, kv_bits, params="j8", **kw):
    return JEngine(m[params], m["jcfg"], plan=JPlan(kv_bits=kv_bits), backend="ref",
                   **{**EKW, **kw})


def _tokens(results):
    return {rid: f.tokens.tolist() for rid, f in results.items()}


def _run_both(teng, jeng, n=5):
    tres = teng.run(ttrace(n, 512, **TRACE))
    jres = jeng.run(jtrace(n, 512, **TRACE))
    return _tokens(tres), _tokens(jres)


@pytest.mark.parametrize("kv_bits", [0, 8, 4])
def test_bitplane_engine_tokens_equal_reference(models, kv_bits):
    teng, jeng = _port(models, kv_bits), _ref(models, kv_bits)
    got, want = _run_both(teng, jeng)
    assert got == want and sorted(got) == list(range(5))
    for key in ("decode_steps", "decode_tokens", "prefill_tokens"):
        assert teng.stats[key] == jeng.stats[key], key
    assert teng.weight_nbytes() == sum(
        leaf.nbytes if hasattr(leaf, "scheme") else leaf.size * leaf.dtype.itemsize
        for leaf in jax.tree.leaves(models["j8"], is_leaf=lambda x: hasattr(x, "scheme")))
    teng.allocator.check_leaks(0)


def test_set_weight_bits_equals_direct_quantization(models):
    teng = _port(models, 8)
    teng.set_weight_bits(2)
    assert teng.weight_bits == 2 and sorted(teng._params_by_bits) == [2]
    direct = _port(models, 8, params="t2")
    jeng = _ref(models, 8)
    jeng.set_weight_bits(2)
    got, want = _run_both(teng, jeng)
    assert got == want
    assert _tokens(direct.run(ttrace(5, 512, **TRACE))) == got
    # the 2-bit view streams 3 of the 9 planes
    w8, w2 = (e.weight_nbytes() for e in (_port(models, 8), teng))
    assert w2 < w8 and teng.weight_nbytes() == direct.weight_nbytes()
    teng.allocator.check_leaks(0)


def test_set_weight_bits_needs_bitplane_weights(models):
    eng = _port(models, 8, params="dense")
    with pytest.raises(ValueError, match="bitplane"):
        eng.set_weight_bits(4)


@pytest.mark.parametrize("draft_bits", [4, 2])
@pytest.mark.parametrize("kv_bits", [0, 8, 4])
def test_spec_tokens_equal_vanilla_and_reference(models, kv_bits, draft_bits):
    vanilla = _tokens(_port(models, kv_bits).run(ttrace(5, 512, **TRACE)))
    teng = _port(models, kv_bits, spec_decode=3, draft_bits=draft_bits)
    jeng = _ref(models, kv_bits, spec_decode=3, draft_bits=draft_bits)
    got, want = _run_both(teng, jeng)
    assert got == vanilla == want
    assert teng.stats["spec_steps"] >= 1 and teng.stats["spec_draft_tokens"] > 0
    for key in ("spec_steps", "spec_draft_tokens", "spec_accepted_tokens",
                "decode_steps", "decode_tokens"):
        assert teng.stats[key] == jeng.stats[key], key
    assert 0.0 <= teng.acceptance_rate() <= 1.0
    teng.allocator.check_leaks(0)


def test_spec_zero_degenerates_to_vanilla(models):
    vanilla = _tokens(_port(models, 8).run(ttrace(5, 512, **TRACE)))
    eng = _port(models, 8, spec_decode=0)
    assert _tokens(eng.run(ttrace(5, 512, **TRACE))) == vanilla
    assert eng.stats["spec_steps"] == eng.stats["spec_draft_tokens"] == 0
    assert np.isnan(eng.acceptance_rate())


def test_serving_at_draft_bits_pauses_speculation(models):
    eng = _port(models, 8, spec_decode=3, draft_bits=4, max_seq_len=64)
    rng = np.random.default_rng(23)
    eng.submit(Request(rid=0, prompt=rng.integers(0, 512, 6), max_new_tokens=40))
    while eng.busy and not eng.stats["spec_steps"]:
        eng.step()
    assert eng.stats["spec_steps"] >= 1
    eng.set_weight_bits(4)                  # == draft_bits → speculation off
    frozen = eng.stats["spec_steps"]
    for _ in range(4):
        eng.step()
    assert eng.stats["spec_steps"] == frozen
    eng.set_weight_bits(8)                  # restored → speculation resumes
    while eng.busy:
        eng.step()
    assert eng.stats["spec_steps"] > frozen
    eng.allocator.check_leaks(0)


def test_spec_window_crosses_page_boundary(models):
    """k + 1 == page_size: most windows span two pages."""
    rng = np.random.default_rng(17)
    req = [Request(rid=0, prompt=rng.integers(0, 512, 7), max_new_tokens=10)]
    kw = dict(max_slots=1)
    vanilla = _port(models, 4, **kw).run(req)
    eng = _port(models, 4, spec_decode=3, draft_bits=4, **kw)
    out = eng.run(req)
    assert eng.stats["spec_steps"] >= 2
    np.testing.assert_array_equal(out[0].tokens, vanilla[0].tokens)
    eng.allocator.check_leaks(0)


def test_spec_tokens_counted_exactly_once(models):
    """A slot finishing (eos) mid-window discards the rest of the window:
    ``decode_tokens`` equals Σ (n_generated − 1); a frozen clock bills 0 s."""
    rng = np.random.default_rng(19)
    reqs = [Request(rid=i, prompt=rng.integers(0, 512, int(rng.integers(4, 12))),
                    max_new_tokens=10) for i in range(4)]
    probe = _port(models, 8, max_slots=1, max_seq_len=48).run([reqs[0]])
    eos = int(probe[0].tokens[-4])
    eng = _port(models, 8, max_seq_len=48, spec_decode=3, draft_bits=4,
                clock=lambda: 0.0)
    out = eng.run([dataclasses.replace(r, eos_id=eos) for r in reqs])
    assert eng.stats["spec_steps"] >= 1
    assert any(f.reason == "eos" for f in out.values())
    assert eng.stats["decode_tokens"] == sum(f.n_generated - 1 for f in out.values())
    assert eng.stats["decode_seconds"] == 0.0
    eng.allocator.check_leaks(0)


def test_autoscaler_drives_engine_like_reference(models):
    """The reference's virtual-clock test, run on both engines: the same
    rung moves, the same served bits, the same tokens."""
    out = {}
    for side, mk, asc_cls, cfg_cls in (("port", _port, TAsc, TAscCfg),
                                       ("ref", _ref, JAsc, JAscCfg)):
        clk = [0.0]
        asc = asc_cls(cfg_cls(slo_admit_ms=10.0, breach_patience=1, restore_patience=2))
        eng = mk(models, 8, autoscaler=asc, clock=lambda c=clk: c[0])
        req_cls = Request if side == "port" else __import__(
            "repro.serve", fromlist=["Request"]).Request
        for i in range(4):
            eng.submit(req_cls(rid=i, prompt=np.arange(1, 6), max_new_tokens=4))
        clk[0] = 0.5                        # a 500 ms head-of-line wait: breach
        done, bits = {}, []
        for _ in range(60):
            clk[0] += 0.001
            for f in eng.step():
                done[f.rid] = f.tokens.tolist()
            bits.append(eng.weight_bits)
            if not eng.busy:
                break
        out[side] = (done, bits, list(asc.decisions), list(eng.admit_waits))
        assert sorted(done) == [0, 1, 2, 3]
        assert any(d["action"] == "drop" for d in asc.decisions)
        assert eng.weight_bits == asc.bits
        eng.allocator.check_leaks(0)
    assert out["port"][:3] == out["ref"][:3]
    np.testing.assert_allclose(out["port"][3], out["ref"][3], rtol=0, atol=1e-12)


def test_constructor_and_serve_engine_validation(models):
    cfg = models["tcfg"]
    with pytest.raises(ValueError, match="spec_decode"):
        ServeEngine(models["t8"], cfg, device="cpu", spec_decode=-1, draft_bits=4)
    with pytest.raises(ValueError, match="draft_bits"):
        ServeEngine(models["t8"], cfg, device="cpu", spec_decode=2)
    with pytest.raises(ValueError, match="draft_bits"):
        ServeEngine(models["t8"], cfg, device="cpu", draft_bits=4)
    with pytest.raises(ValueError, match="bitplane"):
        ServeEngine(models["dense"], cfg, device="cpu", spec_decode=2, draft_bits=4)
    kw = dict(device="cpu", n_requests=2, weight_bits=8)
    for bad in (dict(spec_decode=2, draft_bits=4), dict(autoscale=True),
                dict(ship_dir="unused")):
        with pytest.raises(ValueError, match="bitplane"):
            serve_engine("gemma-2b", **kw, **bad)
    # replicas and sampling are ported: two replicas serve the trace, and a
    # sampled request through speculation gives vanilla decode's tokens
    rs, res = serve_engine("gemma-2b", **kw, weight_layout="bitplane", replicas=2)
    assert len(rs.engines) == 2 and sorted(res) == [0, 1]
    req = Request(rid=0, prompt=[1, 2, 3], temperature=0.8, max_new_tokens=6)
    sampled = _port(models, 8, spec_decode=3, draft_bits=4)
    np.testing.assert_array_equal(sampled.run([req])[0].tokens,
                                  _port(models, 8).run([req])[0].tokens)
    assert sampled.stats["spec_steps"] >= 1


def test_serve_engine_from_ship_artifact(tmp_path):
    """``ship_dir``: the weights are written as a weights-bitplane-v1
    artifact and served from the artifact loaded back — the same tokens as
    serving the quantized tree directly, with speculation on top."""
    kw = dict(device="cpu", n_requests=4, weight_bits=8, kv_bits=8,
              weight_layout="bitplane", max_new=8)
    direct, want = serve_engine("gemma-2b", **kw)
    d = str(tmp_path / "ship")
    eng, got = serve_engine("gemma-2b", **kw, ship_dir=d, spec_decode=3, draft_bits=4)
    assert sorted(os.listdir(d)) == [".complete", "arrays.npz", "manifest.json"]
    assert _tokens(got) == _tokens(want)
    assert eng.stats["spec_steps"] >= 1
    assert eng.weight_nbytes() == direct.weight_nbytes()


def test_cli_serves_bitplane_spec_on_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "gemma-2b",
         "--device", "cpu", "--requests", "4", "--weight-bits", "8", "--kv-bits", "8",
         "--weight-layout", "bitplane", "--spec-decode", "3", "--draft-bits", "4"],
        env=ENV, capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert "[serve-engine] 4 requests" in out.stdout
    assert "speculative:" in out.stdout and "layout=bitplane" in out.stdout
    bad = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "gemma-2b",
         "--device", "cpu", "--weight-bits", "3"],
        env=ENV, capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert bad.returncode != 0 and "--weight-layout dense" in bad.stderr
