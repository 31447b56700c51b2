"""Port parity — bit-plane (any-precision) storage, the ``qmm_bitplane``
plain version, the bitplane ``quant_dense`` on both backends, the
``weights-bitplane-v1`` ship artifact and the precision autoscaler
(repro_torch against repro, on the CPU, inputs made by numpy from a seed).

Tolerances: codes, scales, plane slices and the f32 decode are bit-equal
(integer planes; the reference's operation order); the bf16 decode is
bit-equal to jitted JAX (the decode ends in a contraction XLA keeps in
bf16); ``qmm_bitplane_ref`` is within rtol 1e-6 / atol 1e-6 of the Pallas
kernel in interpret mode (f32 accumulation order only — the reference's
own kernel contract, tests/test_bitplane.py); ``quant_dense`` keeps the
reference's tolerances against the f32 decode (``ref`` atol 2e-2, the
kernel path 1e-4, rtol 5e-3) and matches the JAX backend it mirrors within
rtol 2e-6 / atol 1e-6 (``ref``: f32 sums of the same bf16 weight in another
order) or rtol 1e-6 / atol 1e-6 (the kernel path). Autoscaler decisions are
equal on the same virtual-clock trace.
"""
import dataclasses
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from torch_bridge import bridge, jax_to_numpy, np32

from repro import quant as jquant
from repro.kernels import ops as jops
from repro.precision import qat as jqat
from repro.serve import autoscaler as jasc
from repro_torch import quant as tquant
from repro_torch.ckpt import ShipArtifactError, load_ship_weights, save_ship_weights
from repro_torch.kernels import ops as tops
from repro_torch.kernels import qmm_bitplane as tqbp
from repro_torch.kernels import ref as tref
from repro_torch.precision import qat as tqat
from repro_torch.serve import autoscaler as tasc

SHAPES = [(6, 70), (16, 64), (3, 8, 33), (2, 5, 96)]


def _w(shape, seed=0, sd=1.0):
    return np.random.default_rng(seed).normal(0, sd, shape).astype(np.float32)


def _both(w, bits):
    return (jquant.encode(jnp.asarray(w), jquant.QScheme.bitplane(bits)),
            tquant.encode(torch.from_numpy(w), tquant.QScheme.bitplane(bits)))


def _words(t):
    return t.numpy().view(np.uint32)


@pytest.mark.parametrize("shape", [(7, 1), (3, 32), (2, 4, 65), (5, 100)])
def test_pack_unpack_round_trip_equals_jax(shape):
    bits = np.random.default_rng(1).integers(0, 2, shape)
    jw = np.asarray(jquant.pack_bitplanes(jnp.asarray(bits)))
    tw = tquant.pack_bitplanes(torch.from_numpy(bits))
    assert tw.dtype == torch.int32 and jw.dtype == np.uint32
    np.testing.assert_array_equal(_words(tw), jw)
    back = tquant.unpack_bitplanes(tw, shape[-1])
    np.testing.assert_array_equal(back.numpy(), bits)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jquant.unpack_bitplanes(jnp.asarray(jw), shape[-1])))
    # uint32 words (as numpy hands them over) unpack the same
    np.testing.assert_array_equal(
        tquant.unpack_bitplanes(torch.from_numpy(jw.copy()), shape[-1]).numpy(), bits)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("bits", range(1, 9))
def test_encode_codes_and_scales_bit_equal(shape, bits):
    jq, tq = _both(_w(shape, seed=bits), bits)
    np.testing.assert_array_equal(_words(tq.codes), np.asarray(jq.codes))
    np.testing.assert_array_equal(tq.scale.numpy(), np.asarray(jq.scale))
    assert dataclasses.asdict(tq.scheme) == dataclasses.asdict(jq.scheme)
    assert tq.shape == tuple(jq.shape) and tq.ndim == jq.ndim
    assert tq.nbytes == jq.nbytes


@pytest.mark.parametrize("bits", [2, 5, 8])
def test_slice_planes_equals_direct_encode(bits):
    w = _w((3, 16, 48), seed=2)
    full = tquant.encode(torch.from_numpy(w), tquant.QScheme.bitplane(bits))
    for k in range(1, bits + 1):
        direct = tquant.encode(torch.from_numpy(w), tquant.QScheme.bitplane(k))
        sliced = full.slice_planes(k)
        assert torch.equal(sliced.codes, direct.codes)
        assert torch.equal(sliced.decode(), direct.decode())
        assert sliced.nbytes == direct.nbytes
        jfull = jquant.encode(jnp.asarray(w), jquant.QScheme.bitplane(bits))
        np.testing.assert_array_equal(_words(sliced.codes.contiguous()),
                                      np.asarray(jfull.slice_planes(k).codes))
    assert full.slice_planes(bits) is full
    for bad in (0, bits + 1):
        with pytest.raises(ValueError):
            full.slice_planes(bad)
    dense = tquant.encode(torch.from_numpy(w), tquant.QScheme.int_symmetric(
        8, rounding="nearest"))
    with pytest.raises(ValueError, match="bitplane"):
        dense.slice_planes(4)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("bits", [1, 3, 8])
def test_decode_equals_jitted_jax(shape, bits):
    jq, tq = _both(_w(shape, seed=3), bits)
    for jdt, tdt in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        want = np32(jax.jit(lambda q, d=jdt: q.decode(d))(jq))
        np.testing.assert_array_equal(np32(tq.decode(tdt)), want)


def test_scheme_validation_matches_reference():
    sch = tquant.QScheme.bitplane(4)
    assert sch.layout == "bitplane" and sch.code_bits == 5
    assert dataclasses.asdict(sch) == dataclasses.asdict(jquant.QScheme.bitplane(4))
    for kw in (dict(bits=9, layout="bitplane", rounding="nearest"),
               dict(bits=4, grid="levels", layout="bitplane"),
               dict(bits=4, packed=True, layout="bitplane", rounding="nearest"),
               dict(bits=4, layout="bitplane", rounding="stochastic")):
        with pytest.raises(ValueError):
            tquant.QScheme(**kw)
        with pytest.raises(ValueError):
            jquant.QScheme(**kw)


@pytest.mark.parametrize("m,k,n", [(5, 96, 200), (13, 100, 70), (1, 33, 31),
                                   (16, 64, 256)])
@pytest.mark.parametrize("bits", [1, 4, 8])
def test_qmm_bitplane_plain_matches_pallas(m, k, n, bits):
    """``qmm_bitplane_ref`` against the Pallas kernel in interpret mode
    through the reference's padded entry point: rtol 1e-6, atol 1e-6."""
    jq, tq = _both(_w((k, n), seed=m + k, sd=0.3), bits)
    x = _w((m, k), seed=n)
    scale = np.array(jq.scale, np.float32).reshape(1, n)
    want = np.asarray(jops.quant_dense_bitplane(jnp.asarray(x), jq.codes,
                                                jnp.asarray(scale), n))
    got = tref.qmm_bitplane_ref(torch.from_numpy(x), tq.codes, torch.from_numpy(scale))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    # the wrapper on CPU tensors is the plain version; the op folds lead dims
    before = tqbp.launches
    got2 = tops.quant_dense_bitplane(torch.from_numpy(x)[None], tq.codes,
                                     torch.from_numpy(scale), n)
    assert got2.shape == (1, m, n) and tqbp.launches == before
    assert torch.equal(got2[0], got)


def test_qmm_bitplane_plain_any_plane_count():
    """P = 1 (the sign plane alone) decodes to zeros; P = 1..9 match the
    decode of the same planes."""
    w = _w((40, 70), seed=5)
    full = tquant.encode(torch.from_numpy(w), tquant.QScheme.bitplane(8))
    x = torch.from_numpy(_w((3, 40), seed=6))
    for p in range(1, 10):
        y = tref.qmm_bitplane_ref(x, full.codes[:p], full.scale)
        if p == 1:
            assert not y.any()
        else:
            torch.testing.assert_close(y, x @ full.slice_planes(p - 1).decode(),
                                       rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("xdt", ["f32", "bf16"])
@pytest.mark.parametrize("bits", [2, 4, 8])
def test_quant_dense_both_backends_match_reference(xdt, bits):
    jq, tq = _both(_w((96, 200), sd=0.1), bits)
    x = _w((5, 96), seed=2)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    if xdt == "bf16":
        jx, tx = jx.astype(jnp.bfloat16), tx.to(torch.bfloat16)
    f32_decode = np32(tx) @ tq.decode().numpy()
    for jbe, tbe, atol, tol_jax in (("ref", "ref", 2e-2, dict(rtol=2e-6, atol=1e-6)),
                                    ("pallas", "cuda", 1e-4, dict(rtol=1e-6, atol=1e-6))):
        want = np.asarray(jax.jit(lambda a, q, b=jbe: jquant.quant_dense(a, q, backend=b))(
            jx, jq))
        got = tquant.quant_dense(tx, tq, backend=tbe).numpy()
        assert got.shape == (5, 200)
        np.testing.assert_allclose(got, f32_decode, atol=atol, rtol=5e-3)
        np.testing.assert_allclose(got, want, **tol_jax)


@pytest.mark.parametrize("backend", ["ref", "cuda"])
def test_quant_dense_transpose_and_stacked_fall_back_on_cpu(backend):
    """Transposed and stacked bitplane weights have no kernel: on CPU tensors
    they take the decode path (the reference's fallback; on the card they
    raise naming ROADMAP A1, ``test_torch_kernels_gpu.py``). A stacked
    (S, K, N) weight contracts x (S, M, K) slice by slice, as the
    reference's ``matmul_eq`` has it (ROADMAP A6(a))."""
    from repro_torch.kernels import registry as treg

    jq, tq = _both(_w((32, 64), sd=0.1), 4)
    g = _w((5, 64), seed=3)
    want = np.asarray(jquant.quant_dense(jnp.asarray(g), jq, transpose=True,
                                         backend="ref"))
    got = treg.get(backend).quant_dense(torch.from_numpy(g), tq, transpose=True)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-6, atol=1e-6)
    jstacked, stacked = _both(_w((2, 32, 64), sd=0.1), 4)
    x = _w((2, 5, 32), seed=4)
    want = np.asarray(jquant.quant_dense(jnp.asarray(x), jstacked, backend="ref"))
    got = treg.get(backend).quant_dense(torch.from_numpy(x), stacked)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-6, atol=1e-6)


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(0, 0.2, s).astype(np.float32)  # noqa: E731
    return {"embed": {"table": f(40, 16)},
            "layers": {"attn": {"q": {"w": f(3, 16, 48)}, "o": {"w": f(3, 48, 16)}},
                       "ln1": {"g": f(3, 16)}}}


def _tree_jax(np_tree):
    return jax.tree.map(jnp.asarray, np_tree)


def _tree_torch(np_tree):
    if isinstance(np_tree, dict):
        return {k: _tree_torch(v) for k, v in np_tree.items()}
    return torch.from_numpy(np_tree)


def _assert_trees_equal(tq_tree, jq_tree):
    want = jax_to_numpy(jq_tree)

    def go(t, w):
        if isinstance(w, dict) and set(w) == {"codes", "scale", "scheme"}:
            np.testing.assert_array_equal(_words(t.codes.contiguous()), w["codes"])
            np.testing.assert_array_equal(t.scale.numpy(), w["scale"])
            assert dataclasses.asdict(t.scheme) == w["scheme"]
        elif isinstance(w, dict):
            assert sorted(t) == sorted(w)
            for k in w:
                go(t[k], w[k])
        else:
            np.testing.assert_array_equal(np32(t), np.asarray(w, np.float32))

    go(tq_tree, want)


@pytest.mark.parametrize("bits", [8, 3])
def test_quantize_param_tree_bitplane_matches_reference(bits):
    """Stacked (L, K, N) weights are encoded layer by layer; the codes equal
    the reference's whole-leaf encode."""
    tree = _tree()
    jt = jqat.quantize_param_tree(_tree_jax(tree), bits=bits, layout="bitplane")
    tt = tqat.quantize_param_tree(_tree_torch(tree), bits=bits, layout="bitplane")
    _assert_trees_equal(tt, jt)
    assert tt["layers"]["attn"]["q"]["w"].codes.shape == (3, bits + 1, 16, 2)
    assert tquant.tree_nbytes(tt) == jquant.tree_nbytes(jt)
    for kw in (dict(optimal=True), dict(packed=True)):
        with pytest.raises(ValueError, match="bitplane"):
            tqat.quantize_param_tree(_tree_torch(tree), bits=4, layout="bitplane", **kw)
    with pytest.raises(ValueError, match="layout"):
        tqat.quantize_param_tree(_tree_torch(tree), layout="planes")


@pytest.mark.parametrize("bits", [None, 4, 2])
def test_ship_artifact_from_jax_loads_in_the_port(tmp_path, bits):
    from repro.ckpt import save_ship_weights as jsave

    tree = _tree(1)
    jt = jqat.quantize_param_tree(_tree_jax(tree), bits=8, layout="bitplane")
    jt["embed"]["table"] = jt["embed"]["table"].astype(jnp.bfloat16)
    jsave(str(tmp_path / "ship"), jt, extra={"arch": "test"})
    got = load_ship_weights(str(tmp_path / "ship"), bits=bits, device="cpu")
    want = jt if bits is None else jqat.quantize_param_tree(
        _tree_jax(tree), bits=bits, layout="bitplane")
    want["embed"]["table"] = jt["embed"]["table"]
    _assert_trees_equal(got, want)
    assert got["embed"]["table"].dtype == torch.bfloat16


@pytest.mark.parametrize("bits", [None, 4, 2])
def test_ship_artifact_from_the_port_loads_in_jax(tmp_path, bits):
    from repro.ckpt import load_ship_weights as jload

    tree = _tree(2)
    tt = tqat.quantize_param_tree(_tree_torch(tree), bits=8, layout="bitplane")
    tt["embed"]["table"] = tt["embed"]["table"].to(torch.bfloat16)
    d = save_ship_weights(str(tmp_path / "ship"), tt)
    assert sorted(os.listdir(d)) == [".complete", "arrays.npz", "manifest.json"]
    got = jload(d, bits=bits)
    want = tt if bits is None else tqat.quantize_param_tree(
        _tree_torch(tree), bits=bits, layout="bitplane")
    want["embed"]["table"] = tt["embed"]["table"]
    _assert_trees_equal(want, got)
    assert got["embed"]["table"].dtype == jnp.bfloat16
    # and back into the port: the same tree
    again = load_ship_weights(d, bits=bits, device="cpu")
    _assert_trees_equal(again, got)


def test_ship_artifact_errors(tmp_path):
    tree = _tree(3)
    with pytest.raises(ValueError, match="bitplane"):
        save_ship_weights(str(tmp_path / "a"), _tree_torch(tree))
    with pytest.raises(ValueError, match="layout"):
        save_ship_weights(str(tmp_path / "b"),
                          tqat.quantize_param_tree(_tree_torch(tree), bits=8))
    bp = tqat.quantize_param_tree(_tree_torch(tree), bits=8, layout="bitplane")
    d = save_ship_weights(str(tmp_path / "ship"), bp)
    with pytest.raises(ValueError, match="not servable"):
        load_ship_weights(d, bits=9, device="cpu")
    with pytest.raises(FileNotFoundError):
        load_ship_weights(str(tmp_path / "missing"), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            load_ship_weights(d)
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = f.read()
    with open(os.path.join(d, "manifest.json"), "w") as f:
        f.write("{ not json")
    with pytest.raises(ShipArtifactError, match="manifest.json"):
        load_ship_weights(d, device="cpu")
    with open(os.path.join(d, "manifest.json"), "w") as f:
        f.write(manifest)
    from repro.serve.faults import truncate_ship_artifact

    truncate_ship_artifact(d, keep_bytes=128)
    with pytest.raises(ShipArtifactError, match="corrupt or truncated") as ei:
        load_ship_weights(d, device="cpu")
    assert "save_ship_weights" in str(ei.value)


def _observations(n=80, seed=0):
    rng = np.random.default_rng(seed)
    waits = np.concatenate([rng.uniform(0, 4, n // 4), rng.uniform(8, 60, n // 4),
                            rng.uniform(3, 9, n // 4), rng.uniform(0, 2, n // 4)])
    depth = rng.integers(0, 12, n)
    return [(float(w), int(d), 0.01 * i) for i, (w, d) in enumerate(zip(waits, depth))]


@pytest.mark.parametrize("cfg", [
    dict(slo_admit_ms=10.0, breach_patience=2, restore_patience=3, restore_frac=0.5),
    dict(slo_admit_ms=5.0, breach_patience=1, restore_patience=1, queue_high=8,
         bits_ladder=(8, 4, 2)),
    dict(slo_admit_ms=20.0, decision_log_max=2, breach_patience=1)])
def test_autoscaler_decisions_equal_reference(cfg):
    ja = jasc.PrecisionAutoscaler(jasc.AutoscalerConfig(**cfg))
    ta = tasc.PrecisionAutoscaler(tasc.AutoscalerConfig(**cfg))
    for wait, depth, now in _observations():
        assert ta.observe(admit_wait_ms=wait, queue_depth=depth, now=now) == \
            ja.observe(admit_wait_ms=wait, queue_depth=depth, now=now)
    assert list(ta.decisions) == list(ja.decisions)
    assert (ta.n_moves, ta.n_observations, ta.bits) == (ja.n_moves, ja.n_observations, ja.bits)
    assert ta.n_moves > 0


def test_autoscaler_config_validation_and_env(monkeypatch):
    for kw in (dict(slo_admit_ms=0), dict(bits_ladder=()), dict(bits_ladder=(4, 8)),
               dict(restore_frac=1.5), dict(breach_patience=0), dict(decision_log_max=0)):
        with pytest.raises(ValueError):
            tasc.AutoscalerConfig(**kw)
    monkeypatch.setenv("ZIPML_SLO_ADMIT_MS", "123.5")
    assert tasc.AutoscalerConfig.from_env().slo_admit_ms == 123.5
    assert tasc.AutoscalerConfig.from_env(slo_admit_ms=7.0).slo_admit_ms == 7.0


def test_bridge_carries_bitplane_qtensors():
    tree = _tree(4)
    jt = jqat.quantize_param_tree(_tree_jax(tree), bits=5, layout="bitplane")
    tt = bridge(jt)
    q = tt["layers"]["attn"]["o"]["w"]
    assert q.codes.dtype == torch.int32 and q.scheme.vec_dim == 16
    _assert_trees_equal(tt, jt)
    np.testing.assert_array_equal(q.decode().numpy(),
                                  np.asarray(jt["layers"]["attn"]["o"]["w"].decode()))
