"""Port parity — the §3.4 activation channel (``repro_torch.precision.
act_quant``, ``quant.quant_dense_q``, kernel B7's plain version) against
the reference's.

* (a) ``qmm_qout_plain`` and the port's ``cuda`` backend on CPU tensors
  against the reference's ``quant_dense_q(..., backend="pallas")`` (the
  Pallas ``qmm_qout`` in interpret mode) on the same key: both code planes
  equal, scales rel 1e-6. The inputs lie on a dyadic grid — x a multiple of
  1/8 below 8 in magnitude, scales powers of two — so every product and
  partial sum of y = x·W is exact in f32 in any order: the test then pins
  the epilogue's bits (cast, row absmax, encode), which a summation order
  could otherwise flip wherever a rand word sits next to a fraction.
* (b) the port's ``ref`` ``quant_dense_q`` against the reference's jitted
  ``ref`` (ROADMAP C4): equal codes and scales, on the same grid.
* (c) the ports of ``TestEpilogue`` (``tests/test_quant_dense.py``): ``ref``
  equals the unfused pair, the fused path equals the unfused kernel
  pipeline from the same rand plane, ``ds_project`` is unbiased (within a
  quarter of a 4-bit step after 200 draws), lead dims round-trip.
* (d) ``ds_dense``: forward, gx and gW against ``jax.grad`` of the
  reference with the same key (f32: rel 1e-5, summation order only; the
  codes are equal, so the forward is equal to 1e-6), and the no-grad
  primal's Q₁ equal to the pair's Q₁ (bit for bit).
* (e) ``ds_mlp`` (tanh GELU) loss and gradients at reduced width against
  the reference (rel 1e-5 loss, 1e-4 of each gradient's norm: f32 tanh may
  differ by an ulp, which can move a code of the down projection's input),
  and the ports of ``TestActDoubleSampling`` (``tests/test_system.py``):
  forward within 2 % of x·W, E[∂W] within 6 standard errors + 1e-3 over 8192
  keys, and a gated MLP whose loss falls by 10 % in 60 SGD steps.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from torch_bridge import key as tkey
from torch_bridge import np32

from repro import quant as jquant
from repro.precision import act_quant as jact
from repro_torch import prng
from repro_torch import quant as tquant
from repro_torch.kernels import qmm_qout as tqout
from repro_torch.kernels import registry as treg
from repro_torch.precision import act_quant as tact

KEY = jax.random.PRNGKey(0)
SHAPES = [(1, 40, 24), (13, 96, 130), (9, 130, 256)]


def _dyadic(m, k, n, wbits, xdtype, seed=0):
    """(x numpy f32, the JAX and port weight QTensors): x on the 1/8 grid in
    (-8, 8), codes in ±qmax(wbits), per-column scales 2⁻³…2⁻⁶."""
    rng = np.random.default_rng(seed)
    x = (rng.integers(-63, 64, (m, k)) / 8.0).astype(np.float32)
    q = 2 ** (wbits - 1) - 1
    codes = rng.integers(-q, q + 1, (k, n)).astype(np.int8)
    scale = (2.0 ** -rng.integers(3, 7, (1, n))).astype(np.float32)
    packed = wbits == 4
    scheme = dict(scaling="channel", rounding="nearest", packed=packed)
    tcodes = torch.from_numpy(codes)
    if packed:
        tcodes = tquant.pack_int4(tcodes)
    tq = tquant.QTensor(tcodes, torch.from_numpy(scale),
                        tquant.QScheme.int_symmetric(wbits, **scheme))
    jq = jquant.QTensor(jnp.asarray(tcodes.numpy()), jnp.asarray(scale),
                        jquant.QScheme.int_symmetric(wbits, **scheme))
    jd = jnp.bfloat16 if xdtype == "bf16" else jnp.float32
    td = torch.bfloat16 if xdtype == "bf16" else torch.float32
    return jnp.asarray(x, jd), torch.from_numpy(x).to(td), jq, tq


def _equal_pairs(got, want, rtol=1e-6):
    np.testing.assert_array_equal(got.codes.numpy(), np.asarray(want.codes))
    np.testing.assert_array_equal(got.codes2.numpy(), np.asarray(want.codes2))
    np.testing.assert_allclose(got.scale.numpy(), np.asarray(want.scale), rtol=rtol)


@pytest.mark.parametrize("m,k,n", SHAPES)
@pytest.mark.parametrize("wbits", [8, 4])
@pytest.mark.parametrize("xdtype", ["bf16", "f32"])
@pytest.mark.parametrize("bits", [8, 4])
def test_qmm_qout_plain_matches_pallas_interpret(m, k, n, wbits, xdtype, bits):
    jx, tx, jq, tq = _dyadic(m, k, n, wbits, xdtype, seed=m + k)
    want = jquant.quant_dense_q(jx, jq, KEY, bits=bits, backend="pallas")
    got = tquant.quant_dense_q(tx, tq, tkey(KEY), bits=bits, backend="cuda")
    _equal_pairs(got, want)
    assert got.codes.shape == (m, n) and got.scale.shape == (m, 1) and got.is_ds
    # the plain kernel itself, on the reference's rand plane
    rand = torch.from_numpy(np.array(jax.random.bits(KEY, (m, n), jnp.uint32))
                            .view(np.int32))
    c1, c2, sc = tqout.qmm_qout_plain(tx, tq.codes, tq.scale, rand,
                                      qmax=2 ** (bits - 1) - 1, packed=wbits == 4,
                                      out_dtype=tx.dtype)
    np.testing.assert_array_equal(c1.numpy(), np.asarray(want.codes))
    np.testing.assert_array_equal(c2.numpy(), np.asarray(want.codes2))
    np.testing.assert_allclose(sc.numpy(), np.asarray(want.scale), rtol=1e-6)


@pytest.mark.parametrize("m,k,n", SHAPES)
@pytest.mark.parametrize("wbits", [8, 4])
@pytest.mark.parametrize("xdtype", ["bf16", "f32"])
def test_ref_quant_dense_q_matches_reference_ref(m, k, n, wbits, xdtype):
    jx, tx, jq, tq = _dyadic(m, k, n, wbits, xdtype, seed=m * k)
    want = jax.jit(lambda x, key: jquant.quant_dense_q(x, jq, key, bits=8,
                                                       backend="ref"))(jx, KEY)
    got = tquant.quant_dense_q(tx, tq, tkey(KEY), bits=8, backend="ref")
    _equal_pairs(got, want)


def test_quant_dense_q_dense_weight_matches_reference():
    jx, tx, jq, tq = _dyadic(6, 32, 24, 8, "bf16")
    jw = jq.decode(jnp.bfloat16)
    want = jax.jit(lambda x, key: jquant.quant_dense_q(x, jw, key, bits=8))(jx, KEY)
    got = tquant.quant_dense_q(tx, torch.from_numpy(np32(jw)).to(torch.bfloat16),
                               tkey(KEY), bits=8)
    _equal_pairs(got, want)


def test_quant_dense_q_is_exported():
    assert "quant_dense_q" in tquant.__all__
    assert tquant.quant_dense_q is tact.quant_dense_q


def test_cuda_backend_takes_the_base_path_where_the_reference_does():
    """bits > 8 and a level-table weight go to the base path (quant_dense →
    cast → the split-key pair), as in the reference's pallas backend."""
    _, tx, _, tq = _dyadic(5, 32, 24, 8, "f32")
    for qt, bits in ((tq, 12), (tquant.QTensor(torch.zeros(32, 24, dtype=torch.int8),
                                               torch.ones(()),
                                               tquant.QScheme.levels(4),
                                               levels=torch.tensor([-1.0, -0.2, 0.3, 1.0])),
                                8)):
        got = treg.get("cuda").quant_dense_out_q(tx, qt, tkey(KEY), bits=bits)
        want = treg.KernelBackend.quant_dense_out_q(treg.get("cuda"), tx, qt, tkey(KEY),
                                                    bits=bits)
        np.testing.assert_array_equal(got.codes.numpy(), want.codes.numpy())
        np.testing.assert_array_equal(got.codes2.numpy(), want.codes2.numpy())


# ---------------------------------------------------------------- TestEpilogue
def _wq(shape, seed=0):
    w = np.random.default_rng(seed).normal(0, 0.1, shape).astype(np.float32)
    return tquant.encode(torch.from_numpy(w), tquant.QScheme.int_symmetric(
        8, scaling="channel", rounding="nearest"))


def _x(shape, seed=1):
    return torch.from_numpy(np.random.default_rng(seed).normal(0, 1, shape)
                            .astype(np.float32)).to(torch.bfloat16)


def test_ref_equals_unfused_ds_pair():
    qt = _wq((32, 24))
    x = _x((6, 32))
    k = prng.PRNGKey(0)
    got = tquant.quant_dense_q(x, qt, k, bits=8, backend="ref")
    y = tquant.quant_dense(x, qt, backend="ref").to(x.dtype)
    from repro_torch.quant.qtensor import ds_pair_plain
    want = ds_pair_plain(y, tquant.QScheme.int_symmetric(8, scaling="row", rounding="ds"), k)
    assert torch.equal(got.codes, want.codes) and torch.equal(got.codes2, want.codes2)
    assert torch.equal(got.scale, want.scale)


def test_fused_bit_exact_vs_unfused_kernel_path():
    """Same rand bits → the fused path emits exactly the codes of the
    unfused pipeline (qmm → cast → the DS row quantize written out)."""
    qt = _wq((64, 40))
    x = _x((9, 64))
    k = prng.PRNGKey(0)
    fused = tquant.quant_dense_q(x, qt, k, bits=8, backend="cuda")
    rand = prng.bits(k, (9, 40))
    yb = treg.get("cuda").quant_dense(x, qt).to(x.dtype).to(torch.float32)
    absmax = yb.abs().amax(dim=1, keepdim=True)
    sc = torch.where(absmax == 0, torch.ones_like(absmax), absmax / 127)
    t = yb / sc
    base = torch.floor(t)
    u1 = (rand >> 16).to(torch.float32) / (1 << 16)
    u2 = (rand & 0xFFFF).to(torch.float32) / (1 << 16)
    c1 = torch.clamp(base + (u1 < t - base), -127, 127).to(torch.int8)
    c2 = torch.clamp(base + (u2 < t - base), -127, 127).to(torch.int8)
    assert torch.equal(fused.codes, c1) and torch.equal(fused.codes2, c2)
    torch.testing.assert_close(fused.scale, sc, rtol=1e-6, atol=0)


def test_ds_project_unbiased():
    """E[decode(Q₁)] ≈ y: the epilogue pair stays an unbiased estimator of
    the activation it replaces."""
    qt = _wq((16, 8))
    x = torch.full((4, 16), 0.3, dtype=torch.bfloat16)
    y = tquant.quant_dense(x, qt, backend="ref")
    acc = torch.zeros_like(y)
    n = 200
    for i in range(n):
        pair = tact.ds_project(x, qt, prng.fold_in(prng.PRNGKey(0), i), bits=4,
                               backend="ref")
        acc = acc + pair.decode()
    err = float((acc / n - y).abs().max())
    width = float(y.abs().max()) / 7                  # one 4-bit step
    assert err < 0.25 * width, (err, width)


@pytest.mark.parametrize("backend", ["ref", "cuda"])
def test_lead_dims_roundtrip(backend):
    qt = _wq((32, 24))
    x = _x((2, 3, 32))
    out = tquant.quant_dense_q(x, qt, prng.PRNGKey(0), bits=8, backend=backend)
    assert out.codes.shape == (2, 3, 24)
    assert out.scale.shape == (2, 3, 1)
    assert out.is_ds


# ------------------------------------------------------------------ ds_dense
@pytest.mark.parametrize("bits", [8, 4])
def test_ds_dense_forward_and_grads_match_reference(bits):
    rng = np.random.default_rng(bits)
    x = rng.normal(0, 1, (12, 48)).astype(np.float32)
    w = (rng.normal(0, 1, (48, 20)) * 0.2).astype(np.float32)
    c = rng.normal(0, 1, (12, 20)).astype(np.float32)

    def jloss(x_, w_):
        return jnp.sum(jact.ds_dense(x_, w_, KEY, bits) * c)

    jy = np.asarray(jact.ds_dense(jnp.asarray(x), jnp.asarray(w), KEY, bits))
    jgx, jgw = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    tx = torch.from_numpy(x).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    ty = tact.ds_dense(tx, tw, tkey(KEY), bits)
    (ty * torch.from_numpy(c)).sum().backward()
    np.testing.assert_allclose(ty.detach().numpy(), jy, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jgw), rtol=1e-5, atol=1e-5)
    # the primal (no gradient) draws Q₁ alone, with the pair's first key
    with torch.no_grad():
        primal = tact.ds_dense(torch.from_numpy(x), torch.from_numpy(w), tkey(KEY), bits)
    assert torch.equal(primal, ty.detach())
    k1, _ = prng.split(tkey(KEY))
    scheme = tact._act_scheme(bits)
    q1 = tquant.encode(torch.from_numpy(x), scheme.with_rounding("stochastic"), k1)
    pair = tquant.ds_pair(torch.from_numpy(x), scheme, tkey(KEY))
    assert torch.equal(q1.codes, pair.codes)


def test_ds_dense_saves_only_the_q2_codes():
    x = torch.randn(8, 16, requires_grad=True)
    w = torch.randn(16, 4, requires_grad=True)
    y = tact.ds_dense(x, w, prng.PRNGKey(3), 8)
    saved = y.grad_fn.saved_tensors
    assert [t.dtype for t in saved] == [torch.int8, torch.float32, torch.float32]
    assert saved[0].shape == x.shape and saved[2] is not None


# -------------------------------------------------------------------- ds_mlp
def _mlp_params(d=16, f=32, seed=0):
    rng = np.random.default_rng(seed)
    return {k: {"w": (rng.normal(0, 1, shp) * 0.25).astype(np.float32)}
            for k, shp in (("gate", (d, f)), ("up", (d, f)), ("down", (f, d)))}


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_ds_mlp_loss_and_grads_match_reference(act):
    p = _mlp_params(24, 40)
    x = np.random.default_rng(9).normal(0, 1, (32, 24)).astype(np.float32)
    target = np.roll(x, 1, axis=1)

    def jloss(pp):
        return jnp.mean((jact.ds_mlp(pp, jnp.asarray(x), KEY, act=act) - target) ** 2)

    jp = {k: {"w": jnp.asarray(v["w"])} for k, v in p.items()}
    jl, jg = jax.value_and_grad(jloss)(jp)
    tp = {k: {"w": torch.from_numpy(v["w"]).requires_grad_()} for k, v in p.items()}
    tl = torch.mean((tact.ds_mlp(tp, torch.from_numpy(x), tkey(KEY), act=act)
                     - torch.from_numpy(target)) ** 2)
    tl.backward()
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    for k in p:
        want = np.asarray(jg[k]["w"])
        diff = np.linalg.norm(tp[k]["w"].grad.numpy() - want)
        assert diff <= 1e-4 * np.linalg.norm(want), (k, diff)


def test_forward_close():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(0, 1, (32, 64)).astype(np.float32))
    w = torch.from_numpy((rng.normal(0, 1, (64, 16)) * 0.1).astype(np.float32))
    y = tact.ds_dense(x, w, prng.PRNGKey(0), 8)
    y_ref = x @ w
    rel = float(torch.linalg.norm(y - y_ref) / torch.linalg.norm(y_ref))
    assert rel < 0.02, rel


def test_weight_grad_unbiased():
    """E[∂W] under double-sampled activations equals the exact ∂W."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(0, 1, (8, 16)).astype(np.float32))
    w0 = torch.from_numpy((rng.normal(0, 1, (16, 4)) * 0.1).astype(np.float32))
    exact = x.sum(0)[:, None].expand(16, 4)
    keys = prng.split(prng.PRNGKey(0), 8192)
    grads = []
    for k in keys:
        w = w0.clone().requires_grad_()
        tact.ds_dense(x, w, k, 4).sum().backward()
        grads.append(w.grad)
    grads = torch.stack(grads)
    se = grads.std(0) / np.sqrt(len(keys)) + 1e-6
    assert bool(((grads.mean(0) - exact).abs() < 6 * se + 1e-3).all())


def test_mlp_trains():
    p = {k: {"w": torch.from_numpy(v["w"])} for k, v in _mlp_params().items()}
    x = torch.from_numpy(np.random.default_rng(2).normal(0, 1, (64, 16)).astype(np.float32))
    target = torch.roll(x, 1, dims=1)
    key = prng.PRNGKey(0)

    def loss(pp, k):
        return torch.mean((tact.ds_mlp(pp, x, k) - target) ** 2)

    l0 = float(loss(p, key))
    for i in range(60):
        pp = {k: {"w": v["w"].clone().requires_grad_()} for k, v in p.items()}
        loss(pp, prng.fold_in(key, i)).backward()
        p = {k: {"w": (v["w"] - 0.3 * v["w"].grad).detach()} for k, v in pp.items()}
    l1 = float(loss(p, prng.fold_in(key, 999)))
    assert l1 < l0 * 0.9
