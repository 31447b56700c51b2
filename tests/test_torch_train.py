"""Port parity — slice 3, the training path: ``qmm_t`` and ``quant_adamw``
plain versions against the Pallas kernels in interpret mode, the
``quant_dense`` straight-through VJP, the channels' codes, and
``make_step`` on the reduced gemma-2b with all three ZipML channels at 8
bits (ship-quantized weights with ``ship_min_size=0``, so every weight of
the small model streams codes, int8 gradients with error feedback, int8
AdamW moments).

Which reference each port path is held against, as in slice 2: the port's
``ref`` backend with the JAX ``ref`` backend, and the port's ``cuda``
backend on CPU tensors (the kernels' plain versions) with the JAX
``pallas`` backend in interpret mode — the two draw the moments' rounding
bits differently (two keyed ``uniform`` planes, or one ``bits`` plane split
into high and low 16 bits).

Tolerances, with their reasons:

* ``qmm_t`` plain against the Pallas kernel: ≤ 1e-5 of the largest |dx| (f32
  dequant, f32 accumulation in another order) — the reference's own
  contract (``tests/test_quant_dense.py``);
* ``quant_adamw``: masters rtol 2e-6 / atol 2e-6, scales rtol 1e-6, ≥ 99.9 %
  of codes equal, a disagreeing code off by one level — the reference's
  contract for its kernel (``tests/test_quant_adamw.py``);
* the VJP: dx and dW rel 1e-5 of their largest entry at f32;
* codes drawn from identical inputs with the same keys: bit-exact;
* ``make_step`` at f32, lr 1e-3 from the first step (``OPT``): the masters
  are held by their update (master after − master before), against the
  reference's update, so a port that updated nothing, or with another lr,
  would fail. Each step started from the reference's state: ≥ 99.9 % of all
  the model's update entries within 1e-4 of their leaf's largest update
  (and no leaf with more than 2 + 0.1 % of its entries off),
  ≥ 99.9 % of its moment codes, and of its gradient codes as read from the
  error-feedback residual, equal, moment scales — absmaxes of gradient EMAs,
  whose small entries carry the gradients' summation-order differences —
  rtol 1e-4. Torch and XLA round the forward and backward differently in the
  last bits, so about one gradient code in 10⁴ flips (its stochastic draw
  sits next to the threshold), and within a free run such a flip can move a
  column's moment scale and re-draw the whole column on the next step — a
  divergence of the random stream, not of the arithmetic. So a free run of
  three steps from one state carried across holds its losses to rtol 1e-4
  and its masters' update to a relative L2 distance of 5e-2 (a frozen
  master gives 1). At bf16 the losses agree to rtol 2e-2 (bf16 rounds at other
  places in the two frameworks).

Every test sets its backends through arguments or ``monkeypatch``.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from torch_bridge import bridge, key as bridge_key, np32, train_state_to_numpy

from repro import configs as jconfigs
from repro.data.pipeline import TokenStream as JStream
from repro.data.pipeline import TokenStreamConfig as JStreamCfg
from repro.kernels import ops as jops
from repro.kernels import quant_adamw as jqa
from repro.kernels import registry as jreg
from repro.models import transformer as JT
from repro.optim import adamw as jadamw
from repro.precision import gradcomp as jgc
from repro.precision import qat as jqat
from repro.quant import PrecisionPlan as JPlan
from repro.quant import QScheme as JScheme
from repro.quant import QTensor as JQTensor
from repro.quant import ShipWeight as JShip
from repro.quant import quant_dense as jquant_dense
from repro.quant import qtensor as jqt
from repro.train import channels as jch
from repro.train import step as jstep
from repro.train.trainer import Trainer as JTrainer
from repro_torch import configs as tconfigs
from repro_torch import prng
from repro_torch.kernels import threefry as ttf
from repro_torch.data.pipeline import TokenStream as TStream
from repro_torch.data.pipeline import TokenStreamConfig as TStreamCfg
from repro_torch.interop import train_state_from_numpy
from repro_torch.kernels import ops as tops
from repro_torch.kernels import qmm_t as tqmm_t
from repro_torch.kernels import quant_adamw as tqa
from repro_torch.kernels import ref as tref
from repro_torch.launch import train as tlaunch
from repro_torch.optim import adamw as tadamw
from repro_torch.precision import gradcomp as tgc
from repro_torch.precision import qat as tqat
from repro_torch.quant import PrecisionPlan as TPlan
from repro_torch.quant import QScheme as TScheme
from repro_torch.quant import ShipWeight as TShip
from repro_torch.quant import encode as tencode
from repro_torch.quant import quant_dense as tquant_dense
from repro_torch.train import Trainer as TTrainer
from repro_torch.train import channels as tch
from repro_torch.train import make_step as tmake_step
from repro_torch.tree import tree_leaves

PAIRINGS = [("ref", "ref"), ("pallas", "cuda")]    # (JAX backend, port backend)
ALL8 = dict(model_bits=8, model_storage="ship", grad_bits=8)
STEPS, BATCH, SEQ = 3, 2, 16
# lr 1e-3 from the first step: three steps move a master by ~3e-3, 10⁴ × the
# f32 ulp of the largest masters (1.0), so a 1e-4 comparison of the update
# sees it. The default warmup of 100 steps would move one by < 2e-5, less
# than a 1e-4 tolerance on the master itself.
OPT = dict(lr=1e-3, warmup_steps=1)
FREE_RUN_UPDATE_L2 = 5e-2


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _is_q(x):
    return isinstance(x, JQTensor)


# ----------------------------------------------------------------- kernels --

QMM_T_CASES = [(32, 64, 128), (7, 96, 40), (13, 130, 258), (5, 33, 64)]


@pytest.mark.parametrize("m,k,n", QMM_T_CASES)
@pytest.mark.parametrize("bits", [8, 4])
def test_qmm_t_plain_matches_pallas(m, k, n, bits):
    packed = bits == 4
    rng = np.random.default_rng(m + k + n)
    w = rng.normal(0, 0.05, (k, n)).astype(np.float32)
    g = rng.normal(0, 1, (m, n)).astype(np.float32)
    qt = jqt.encode_jnp(jnp.asarray(w), JScheme.int_symmetric(
        bits, scaling="channel", rounding="nearest", packed=packed))
    want = jops.quant_dense_apply(jnp.asarray(g), qt.codes, qt.scale.reshape(1, n),
                                  packed=packed, transpose=True)
    got = tqmm_t.qmm_t(_t(g), _t(qt.codes), _t(qt.scale), packed=packed)
    assert got.shape == (m, k) and got.dtype == torch.float32
    assert _rel(got.numpy(), want) <= 1e-5
    assert tqmm_t.launches == 0             # CPU tensors: the plain version


@pytest.mark.parametrize("m,k,n", QMM_T_CASES)
@pytest.mark.parametrize("bits", [8, 4])
def test_qmm_t_three_piece_product_matches_pallas(m, k, n, bits):
    # the arithmetic of qmm_t's tensor-core core: v = g · scale rounded to
    # f32, split into three bf16 pieces, each piece times the integer codes
    # (exact products, summed here in f64), rounded once to f32
    from repro_torch.quant.qtensor import unpack_int4

    packed = bits == 4
    rng = np.random.default_rng(m + k + n)
    w = rng.normal(0, 0.05, (k, n)).astype(np.float32)
    g = rng.normal(0, 1, (m, n)).astype(np.float32)
    qt = jqt.encode_jnp(jnp.asarray(w), JScheme.int_symmetric(
        bits, scaling="channel", rounding="nearest", packed=packed))
    want = jops.quant_dense_apply(jnp.asarray(g), qt.codes, qt.scale.reshape(1, n),
                                  packed=packed, transpose=True)
    codes = _t(qt.codes)
    c = (unpack_int4(codes) if packed else codes).to(torch.float64)
    v = _t(g) * _t(qt.scale).reshape(1, n)
    got = sum(p.to(torch.float64) @ c.t() for p in tqmm_t.split_bf16x3(v)).float()
    assert got.shape == (m, k)
    assert _rel(got.numpy(), want) <= 1e-5


def _adamw_leaf(r, c, seed):
    rng = np.random.default_rng(seed)
    master = rng.normal(0, 1, (r, c)).astype(np.float32)
    g = (rng.normal(0, 1, (r, c)) * 0.1).astype(np.float32)
    mc = rng.integers(-127, 128, (r, c)).astype(np.int8)
    vc = rng.integers(0, 128, (r, c)).astype(np.int8)
    ms = (np.abs(rng.normal(0, 1, c)) * 0.01 + 1e-4).astype(np.float32)
    vs = (np.abs(rng.normal(0, 1, c)) * 0.01 + 1e-4).astype(np.float32)
    rand = rng.integers(0, 2 ** 32, (r, c), dtype=np.uint32)
    return master, g, mc, ms, vc, vs, rand


OPK = dict(qmax=127, b1=0.9, b2=0.95, eps=1e-8, wd=0.1, lr=1e-3, b1c=0.1,
           b2c=0.05, clip=1.0, finite=1.0, uclip=10.0)


def _adamw_contract(got, want):
    nm_t, mc_t, ms_t, vc_t, vs_t = [np.asarray(x) for x in got]
    nm_j, mc_j, ms_j, vc_j, vs_j = [np.asarray(x) for x in want]
    np.testing.assert_allclose(nm_t, nm_j, rtol=2e-6, atol=2e-6)
    np.testing.assert_allclose(ms_t, ms_j, rtol=1e-6)
    np.testing.assert_allclose(vs_t, vs_j, rtol=1e-6)
    for ct, cj in ((mc_t, mc_j), (vc_t, vc_j)):
        assert (ct == cj).mean() >= 0.999
        assert np.abs(ct.astype(int) - cj.astype(int)).max() <= 1


@pytest.mark.parametrize("shape", [(96, 160), (100, 130), (300, 64)])
@pytest.mark.parametrize("finite", [1.0, 0.0])
def test_quant_adamw_plain_matches_pallas(shape, finite):
    master, g, mc, ms, vc, vs, rand = _adamw_leaf(*shape, seed=shape[0])
    kw = dict(OPK, finite=finite)
    want = jops.quant_adamw_update(*(jnp.asarray(a) for a in
                                     (master, g, mc, ms, vc, vs, rand)), **kw)
    targs = [_t(a) for a in (master, g, mc, ms, vc, vs)] + [_t(rand.view(np.int32))]
    _adamw_contract(tref.quant_adamw_ref(*targs, **kw), want)
    # the two-pass wrappers on CPU tensors (what the cuda backend runs there)
    before = (tqa.scales_launches, tqa.absmax_launches, tqa.update_launches)
    _adamw_contract(tops.quant_adamw_update(*targs, **kw), want)
    assert (tqa.scales_launches, tqa.absmax_launches, tqa.update_launches) == before
    if not finite:
        np.testing.assert_array_equal(np32(tops.quant_adamw_update(*targs, **kw)[0]),
                                      master)


def _pallas_scales(g, mc, ms, vc, vs, params, qmax):
    """The reference's new scales: its pass-1 Pallas kernel in interpret
    mode over the leaf padded to 128 as ``ops.quant_adamw_update`` pads
    it, the max of the partials, absmax / qmax (0 → 1)."""
    r, c = g.shape
    pr, pc = -r % 128, -c % 128
    pad2 = lambda a: jnp.asarray(np.pad(a, ((0, pr), (0, pc))))
    pad1 = lambda a: jnp.asarray(np.pad(a, (0, pc)).reshape(1, -1))
    mx, vx = jqa.qadamw_absmax(pad2(g), pad2(mc), pad1(ms), pad2(vc), pad1(vs),
                               jnp.asarray(params), b1=0.9, b2=0.95, interpret=True)
    out = []
    for x in (jnp.max(mx, axis=0), jnp.max(vx, axis=0)):
        out.append(np.asarray(jnp.where(x == 0, 1.0, x / qmax).astype(jnp.float32))[:c])
    return out


# pass 1's path entry (``qadamw_scales``, one launch on the card): its plain
# version — the max of the parity entry's partials, then the scale — against
# the reference's Pallas pass 1 and scale; XLA may contract the moments'
# adds of products into FMAs, so one ulp
@pytest.mark.parametrize("shape", [(96, 160), (300, 64), (513, 130)])
@pytest.mark.parametrize("finite", [1.0, 0.0])
def test_qadamw_scales_plain_matches_pallas(shape, finite):
    _, g, mc, ms, vc, vs, _ = _adamw_leaf(*shape, seed=shape[1])
    vc[:, 3] = 0
    mc[:, 3] = 0
    g[:, 3] = 0                                     # an all-zero column: scale 1
    params = np.array([0.5, finite, 1e-3, 0.1, 0.05, 0, 0, 0], np.float32)
    got = tqa.qadamw_scales_plain(*(_t(a) for a in (g, mc, ms, vc, vs, params)),
                                  b1=0.9, b2=0.95, qmax=127)
    want = _pallas_scales(g, mc, ms, vc, vs, params, 127)
    for a, b in zip(got, want):
        np.testing.assert_array_max_ulp(a.numpy(), b, maxulp=1)
        assert a[3] == b[3] == 1


def test_nan_gradient_reaches_the_scales_in_both_packages():
    # a NaN in g at finite = 1 makes that column's new m and v NaN; jnp.max
    # keeps it, and so must the port's pass 1 (ROADMAP B8)
    _, g, mc, ms, vc, vs, _ = _adamw_leaf(300, 64, seed=7)
    g[260, 5] = np.nan
    params = np.array([1.0, 1.0, 1e-3, 0.1, 0.05, 0, 0, 0], np.float32)
    targs = [_t(a) for a in (g, mc, ms, vc, vs, params)]
    got = tqa.qadamw_scales_plain(*targs, b1=0.9, b2=0.95, qmax=127)
    want = _pallas_scales(g, mc, ms, vc, vs, params, 127)
    keep = np.arange(64) != 5
    for a, b in zip(got, want):
        a = a.numpy()
        assert np.isnan(a[5]) and np.isnan(b[5])
        np.testing.assert_array_max_ulp(a[keep], b[keep], maxulp=1)
    mx, vx = tqa.qadamw_absmax(*targs, b1=0.9, b2=0.95)
    assert np.isnan(mx[1, 5].item()) and np.isnan(vx[1, 5].item())
    # the two-pass wrapper on CPU tensors hands pass 2 the same NaN scales
    out = tops.quant_adamw_update(_t(np.zeros_like(g)), *targs[:5], None, key=prng.PRNGKey(1),
                                  **OPK)
    assert np.isnan(out[2][5].item()) and np.isnan(out[4][5].item())


# ------------------------------------------------------------- VJP, codes --

@pytest.mark.parametrize("pairing", PAIRINGS)
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("lead", [(2, 5), (11,)])
def test_ship_quant_dense_vjp_matches_reference(pairing, bits, lead):
    jb, tb = pairing
    rng = np.random.default_rng(bits)
    k, n = 48, 40
    w = rng.normal(0, 0.1, (k, n)).astype(np.float32)
    x = rng.normal(0, 1, (*lead, k)).astype(np.float32)
    g = rng.normal(0, 1, (*lead, n)).astype(np.float32)
    jsw = jqat.ship_quant(jnp.asarray(w), bits)

    @jax.jit              # the reference's jitted numerics (ROADMAP C4)
    def fwd_bwd(xx, mm, gg):
        y, vjp = jax.vjp(lambda a, b: jquant_dense(
            a, JShip(b, jsw.qt), backend=jb), xx, mm)
        return (y, *vjp(gg))

    y, dx, dw = fwd_bwd(jnp.asarray(x), jnp.asarray(w), jnp.asarray(g))
    tsw = tqat.ship_quant(_t(w), bits)
    np.testing.assert_array_equal(tsw.qt.codes.numpy(), np.asarray(jsw.qt.codes))
    tx, tw = _t(x).requires_grad_(), _t(w).requires_grad_()
    ty = tquant_dense(tx, TShip(tw, tsw.qt), backend=tb)
    ty.backward(_t(g))
    assert _rel(ty.detach().numpy(), y) <= 1e-5
    assert tx.grad.dtype == torch.float32 and tw.grad.dtype == torch.float32
    assert _rel(tx.grad.numpy(), dx) <= 1e-5
    assert _rel(tw.grad.numpy(), dw) <= 1e-5


def test_ship_and_fake_quant_trees_match_reference():
    jcfg = dataclasses.replace(jconfigs.get_reduced("gemma-2b"), dtype=jnp.float32)
    jp = JT.init_params(jax.random.PRNGKey(3), jcfg)
    tp = bridge(jp)
    js = jqat.ship_quant_tree(jp, 8, min_size=0)
    ts = tqat.ship_quant_tree(tp, 8, min_size=0)
    jl = jax.tree.leaves(js, is_leaf=lambda v: isinstance(v, JShip))
    tl = tree_leaves(ts)
    assert len(jl) == len(tl) == 11
    for a, b in zip(jl, tl):
        assert isinstance(a, JShip) == isinstance(b, TShip)
        if isinstance(b, TShip):
            np.testing.assert_array_equal(b.qt.codes.numpy(), np.asarray(a.qt.codes))
            np.testing.assert_array_equal(b.qt.scale.numpy(), np.asarray(a.qt.scale))
            assert b.qt.scale.shape[-2] == 1         # per-layer (L, 1, N) scales
            assert b.master is not None
    key = jax.random.PRNGKey(4)
    jf = jqat.fake_quant_tree(jp, 8, key)
    tf = tqat.fake_quant_tree(tp, 8, bridge_key(key))
    for a, b in zip(jax.tree.leaves(jf), tree_leaves(tf)):
        np.testing.assert_array_equal(np32(b), np.asarray(a, np.float32))


@pytest.mark.parametrize("error_feedback", [False, True])
def test_compress_tree_matches_reference(error_feedback):
    rng = np.random.default_rng(5)
    tree = {"b": {"w": rng.normal(0, 1e-2, (3, 20, 8)).astype(np.float32)},
            "a": rng.normal(0, 1, (33,)).astype(np.float32)}
    err = {"b": {"w": rng.normal(0, 1e-4, (3, 20, 8)).astype(np.float32)},
           "a": rng.normal(0, 1e-3, (33,)).astype(np.float32)} if error_feedback else None
    key = jax.random.PRNGKey(6)
    jt = jax.tree.map(jnp.asarray, tree)
    jc, je = jgc.compress_tree(jt, 8, key, error=None if err is None
                               else jax.tree.map(jnp.asarray, err))
    tt = jax.tree.map(_t, tree)
    tc, te = tgc.compress_tree(tt, 8, bridge_key(key), error=None if err is None
                               else jax.tree.map(_t, err))
    for a, b in zip(jax.tree.leaves(jc, is_leaf=_is_q), tree_leaves(tc)):
        np.testing.assert_array_equal(b.codes.numpy(), np.asarray(a.codes))
        np.testing.assert_array_equal(b.scale.numpy(), np.asarray(a.scale))
    if error_feedback:
        for a, b in zip(jax.tree.leaves(je), tree_leaves(te)):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    for a, b in zip(jax.tree.leaves(jgc.decompress_tree(jc)),
                    tree_leaves(tgc.decompress_tree(tc))):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_big_planes_hash_in_chunks_bit_exact(monkeypatch):
    k = jax.random.PRNGKey(11)
    want_b = np.asarray(jax.random.bits(k, (37, 51), jnp.uint32))
    want_u = np.asarray(jax.random.uniform(k, (37, 51)))
    monkeypatch.setattr(ttf, "CHUNK", 100)
    tk = bridge_key(k)
    np.testing.assert_array_equal(prng.bits(tk, (37, 51)).numpy(), want_b)
    np.testing.assert_array_equal(
        prng.bits(tk, (37, 51), dtype=torch.int32).numpy().view(np.uint32), want_b)
    np.testing.assert_array_equal(prng.uniform(tk, (37, 51)).numpy(), want_u)


def test_token_stream_matches_reference():
    js = JStream(JStreamCfg(512, 16, 4, seed=3))
    ts = TStream(TStreamCfg(512, 16, 4, seed=3))
    for _ in range(3):
        a, b = js.next_batch(), ts.next_batch()
        for k in ("tokens", "targets"):
            np.testing.assert_array_equal(a[k], b[k])
    assert ts.cursor.step == 3


# --------------------------------------------------------------- make_step --

def _configs(dtype, pairing, plan_kw, moment_bits):
    jb, tb = pairing
    jd, td = (jnp.float32, torch.float32) if dtype == "f32" else \
        (jnp.bfloat16, torch.bfloat16)
    jplan, tplan = JPlan(**plan_kw), TPlan(backend=tb, **plan_kw)
    jcfg = dataclasses.replace(jconfigs.get_reduced("gemma-2b"), dtype=jd,
                               precision=jplan)
    tcfg = tconfigs.get_reduced("gemma-2b", dtype=td, precision=tplan)
    jchans = {"sample": jch.SampleChannel(jplan),
              "model": jch.ModelChannel(jplan, ship_min_size=0),
              "grad": jch.GradChannel(jplan), "act": jch.ActChannel(jplan)}
    tchans = {"sample": tch.SampleChannel(tplan),
              "model": tch.ModelChannel(tplan, ship_min_size=0),
              "grad": tch.GradChannel(tplan), "act": tch.ActChannel(tplan)}
    return (jcfg, jadamw.AdamWConfig(moment_bits=moment_bits, **OPT), jchans,
            tcfg, tadamw.AdamWConfig(moment_bits=moment_bits, **OPT), tchans)


def run_reference(dtype, pairing, plan_kw=ALL8, moment_bits=8):
    """The reference's jitted make_step for STEPS steps on the reduced
    gemma-2b: the numpy state before every step and after the last, the
    losses, and the batches."""
    jb, _ = pairing
    jcfg, jopt, jchans, *_ = _configs(dtype, pairing, plan_kw, moment_bits)
    stream = JStream(JStreamCfg(jcfg.vocab_size, SEQ, BATCH))
    batches = [stream.next_batch() for _ in range(STEPS)]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jreg, "_ACTIVE", jb)
        state = JTrainer(jcfg, jopt, channels=jchans).init_state()
        fn = jax.jit(jstep.make_step(jcfg, jopt, jchans))
        states, losses = [train_state_to_numpy(state)], []
        for b in batches:
            state, m = fn(state, {k: jnp.asarray(v) for k, v in b.items()})
            losses.append(float(m["loss"]))
            assert float(m["skipped"]) == 0.0
            states.append(train_state_to_numpy(state))
    return states, losses, batches


@pytest.fixture(scope="module")
def reference_runs():
    return {p: run_reference("f32", p) for p in PAIRINGS}


def _port_step(pairing, dtype="f32", plan_kw=ALL8, moment_bits=8):
    *_, tcfg, topt, tchans = _configs(dtype, pairing, plan_kw, moment_bits)
    return tmake_step(tcfg, topt, tchans)


def _tbatch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def master_updates(port_state, before, after):
    """The port's master update (port − before) against the reference's
    (after − before): per leaf, the entries off by more than 1e-4 of the
    leaf's largest update and the leaf's size; and the relative L2 distance
    of the two updates over the model."""
    got = [np32(x) for x in tree_leaves(port_state.opt.master)]
    want = jax.tree.leaves(after["opt"]["master"])
    start = jax.tree.leaves(before["opt"]["master"])
    assert len(got) == len(want) == len(start) == 11
    off, num, den = [], 0.0, 0.0
    for a, b, z in zip(got, want, start):
        du_t, du_j = a.astype(np.float64) - z, b.astype(np.float64) - z
        assert np.abs(du_j).max() > 0
        off.append((int((np.abs(du_t - du_j) > 1e-4 * np.abs(du_j).max()).sum()), z.size))
        num, den = num + ((du_t - du_j) ** 2).sum(), den + (du_j ** 2).sum()
    return off, float(np.sqrt(num / den))


def assert_step_updates_close(off):
    """≥ 99.9 % of the model's update entries agree, and no leaf has more
    than 2 + 0.1 % of its entries off: a flipped gradient code moves one
    entry, a fault in a leaf's update (its lr, its decay) moves them all."""
    assert sum(o for o, _ in off) <= 1e-3 * sum(n for _, n in off)
    assert all(o <= 2 + n // 1000 for o, n in off), off


@pytest.mark.parametrize("pairing", PAIRINGS)
def test_make_step_losses_and_masters_match_reference(reference_runs, pairing):
    states, losses, batches = reference_runs[pairing]
    step = _port_step(pairing)
    state = train_state_from_numpy(states[0])
    got = []
    for b in batches:
        state, m = step(state, _tbatch(b))
        got.append(float(m["loss"]))
        assert float(m["skipped"]) == 0.0
    np.testing.assert_allclose(got, losses, rtol=1e-4)
    assert state.step == STEPS and int(state.opt.step) == STEPS
    assert master_updates(state, states[0], states[-1])[1] <= FREE_RUN_UPDATE_L2


def _code_leaves(tree):
    return jax.tree.leaves(tree, is_leaf=lambda v: isinstance(v, dict) and "codes" in v)


@pytest.mark.parametrize("pairing", PAIRINGS)
def test_make_step_codes_match_reference_each_step(reference_runs, pairing):
    states, losses, batches = reference_runs[pairing]
    step = _port_step(pairing)
    for i, b in enumerate(batches):
        state, m = step(train_state_from_numpy(states[i]), _tbatch(b))
        want = states[i + 1]
        np.testing.assert_allclose(float(m["loss"]), losses[i], rtol=1e-4)
        assert_step_updates_close(master_updates(state, states[i], want)[0])
        for name in ("m", "v"):
            got_q = tree_leaves(getattr(state.opt, name))
            want_q = _code_leaves(want["opt"][name])
            assert len(got_q) == len(want_q) == 11
            same = [a.codes.numpy() == q["codes"] for a, q in zip(got_q, want_q)]
            assert np.concatenate([e.ravel() for e in same]).mean() >= 0.999
            for a, q in zip(got_q, want_q):
                np.testing.assert_allclose(a.scale.numpy(), q["scale"], rtol=1e-4)
        # the error-feedback residual moves by one gradient step where a
        # gradient code differs: ≥ 99.9 % of its entries agree far closer
        close = [np.abs(np32(a) - e) <= 0.25 * max(np.abs(e).max(), 1e-30)
                 for a, e in zip(tree_leaves(state.channels["grad"]["ef"]),
                                 jax.tree.leaves(want["channels"]["grad"]["ef"]))]
        assert np.concatenate([c.ravel() for c in close]).mean() >= 0.999


def test_cuda_backend_on_cpu_launches_no_kernel(reference_runs):
    from repro_torch.kernels import qmm as tqmm

    states, _, batches = reference_runs[("pallas", "cuda")]
    before = (tqmm.launches, tqmm_t.launches, tqa.scales_launches, tqa.absmax_launches,
              tqa.update_launches)
    _port_step(("pallas", "cuda"))(train_state_from_numpy(states[0]), _tbatch(batches[0]))
    assert (tqmm.launches, tqmm_t.launches, tqa.scales_launches, tqa.absmax_launches,
            tqa.update_launches) == before


# ---------------------------------------------------------- trainer + CLI --

def test_cli_trains_on_cpu(capsys):
    tlaunch.main(["--arch", "gemma-2b", "--reduced", "--device", "cpu", "--steps", "3",
                  "--batch", "2", "--seq", "16", "--weight-storage", "ship",
                  "--weight-bits", "8", "--grad-bits", "8", "--moment-bits", "8",
                  "--log-every", "1"])
    out = capsys.readouterr().out
    assert out.count("[train] step") == 3 and "done: first loss" in out


def test_trainer_history_and_state():
    tr = tlaunch.make_trainer("gemma-2b", batch=2, seq=16, steps=2, device="cpu",
                              precision=TPlan(**ALL8), moment_bits=8)
    state, losses = tr.run(2)
    assert state.step == 2 and len(losses) == 2 and np.isfinite(losses).all()
    assert [h["skipped"] for h in tr.history] == [0.0, 0.0]
    assert "ef" in state.channels["grad"]


@pytest.mark.parametrize("kw", [dict(ckpt_dir="x"), dict(accum_steps=2)])
def test_unported_trainer_options_name_the_roadmap(kw):
    cfg = tconfigs.get_reduced("gemma-2b")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TTrainer(cfg, device="cpu", **kw)


def test_fault_injection_and_act_channel_name_the_roadmap():
    tr = tlaunch.make_trainer("gemma-2b", batch=2, seq=16, steps=2, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP A8"):
        tr.run(2, fail_at=1)
    with pytest.raises(NotImplementedError, match="does not wire act_bits.*ROADMAP C9"):
        tch.ActChannel(TPlan(act_bits=8))


def test_trainer_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="cuda"):
        TTrainer(tconfigs.get_reduced("gemma-2b"))


def test_int_grid_stochastic_encode_matches_reference():
    rng = np.random.default_rng(8)
    x = rng.normal(0, 1, (7, 33)).astype(np.float32)
    key = jax.random.PRNGKey(9)
    for scaling in ("tensor", "column", "channel"):
        js = JScheme.int_symmetric(8, scaling=scaling, rounding="stochastic")
        ts = TScheme.int_symmetric(8, scaling=scaling, rounding="stochastic")
        j = jqt.encode_jnp(jnp.asarray(x), js, key)
        t = tencode(_t(x), ts, bridge_key(key))
        np.testing.assert_array_equal(t.codes.numpy(), np.asarray(j.codes))
        np.testing.assert_array_equal(t.scale.numpy(), np.asarray(j.scale))
