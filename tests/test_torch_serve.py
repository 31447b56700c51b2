"""Port parity — the serving engine (repro_torch.serve vs repro.serve).

The same ``make_trace`` (8 requests) runs through the reference
``ServeEngine(backend="ref")`` and the port's engine on the CPU with the
reference's params bridged across, for weight_bits ∈ {0, 8, 4} × kv_bits ∈
{0, 8, 4}. At f32 compute dtype the greedy tokens are identical; the engine
invariants hold (every request finishes, no page leaks, the same KV bytes).
Also: the CLI on the CPU, the engine features' configuration, and that the
port imports neither ``jax`` nor ``repro``. The bf16 comparison is in
``test_torch_serve_bf16.py``.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import jax
import pytest
import torch

from torch_bridge import serve_both

from repro_torch import configs as tconfigs
from repro_torch.serve import ServeEngine

ROOT = Path(__file__).resolve().parents[1]
ENV = {**os.environ, "PYTHONPATH": str(ROOT / "src")}


@pytest.mark.parametrize("kv_bits", [0, 8, 4])
@pytest.mark.parametrize("weight_bits", [0, 8, 4])
def test_greedy_tokens_identical_f32(weight_bits, kv_bits):
    jeng, teng, jres, tres = serve_both("f32", weight_bits, kv_bits)
    assert sorted(tres) == sorted(jres) == list(range(8))
    for rid, want in jres.items():
        got = tres[rid]
        np.testing.assert_array_equal(got.tokens, want.tokens)
        assert (got.prompt_len, got.n_generated, got.reason) == \
            (want.prompt_len, want.n_generated, want.reason)
    assert teng.stats["finished"] == teng.stats["admitted"] == 8
    teng.allocator.check_leaks(0)
    assert not teng.busy
    for key in ("decode_steps", "decode_tokens", "prefill_tokens"):
        assert teng.stats[key] == jeng.stats[key], key
    assert teng.kv_pool_nbytes() == jeng.kv_pool_nbytes()


def test_cli_serves_on_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "gemma-2b",
         "--device", "cpu", "--requests", "4", "--weight-bits", "8",
         "--kv-bits", "8"],
        env=ENV, capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert "[serve-engine] 4 requests" in out.stdout
    assert "KV pool:" in out.stdout


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="cuda"):
        ServeEngine({}, tconfigs.get_reduced("gemma-2b"))


@pytest.mark.parametrize("kw,err,match", [
    (dict(prefix_cache=True), None, "chunk_pages"),
    (dict(chunk_pages=2), None, "chunk_pages"),
    # on weights without bitplanes speculation raises the reference's
    # ValueError
    (dict(spec_decode=2, draft_bits=4), ValueError, "bitplane"),
    (dict(reserve="none"), None, "reserve")],
    ids=["kw0-NotImplementedError-ROADMAP A3", "kw1-NotImplementedError-ROADMAP A3",
         "kw2-ValueError-bitplane", "kw3-NotImplementedError-ROADMAP A3"])
def test_unported_engine_features_raise(kw, err, match):
    """Every engine feature of the reference is ported: the prefix cache
    (chunked over the whole context unless ``chunk_pages`` says otherwise),
    chunked prefill and ``reserve='none'`` configure the engine as the
    reference's does; speculation on dense weights raises as the
    reference's does. The test's name and case ids are historical (they
    date from when these features raised ``NotImplementedError``) and are
    kept so that each case keeps its identity."""
    from repro import configs as jconfigs
    from repro.models import transformer as JT
    from repro.serve import ServeEngine as JEngine
    from repro_torch.models import transformer as T

    cfg = tconfigs.get_reduced("gemma-2b")
    if err is not None:
        with pytest.raises(err, match=match):
            ServeEngine(T.init_params(cfg, seed=0, device="cpu"), cfg, device="cpu", **kw)
        return
    eng = ServeEngine(T.init_params(cfg, seed=0, device="cpu"), cfg, device="cpu", **kw)
    jcfg = jconfigs.get_reduced("gemma-2b")
    ref = JEngine(JT.init_params(jax.random.PRNGKey(0), jcfg), jcfg, **kw)
    for attr in ("chunk_pages", "reserve", "max_pages_per_seq"):
        assert getattr(eng, attr) == getattr(ref, attr), attr
    assert (eng.prefix is None) == (ref.prefix is None)


def test_port_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [n for n in sys.modules if n == 'jax' or n.startswith('jax.')\n"
        "       or n == 'repro' or n.startswith('repro.')]\n"
        "assert not bad, bad\n"
        "print('ok', len([n for n in sys.modules if n.startswith('repro_torch')]))\n")
    out = subprocess.run([sys.executable, "-c", code], env=ENV, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")
