"""The port's device threefry on the CPU: the plane kernel's plain version
(``kernels/threefry.threefry_plane`` on the CPU, its int64 path) and
the keyed entries of B1 ``ds_quant`` and B9 ``qadamw_update``, which hash
their rounding words in registers on the card and draw them through
``prng.bits`` here.

* the int64 hash at the counters (start + i >> 32, start + i mod 2³²) the
  kernel forms, at windows across 2³², equals ``jax._src.prng.threefry_2x32``
  on the same counters, bit for bit; planes of one key and of a batch of
  keys, in every output kind, equal ``jax.random.bits`` / ``uniform``;
* ``ds_quant_keyed`` equals its rand entry on ``prng.bits(key, shape)`` and
  the reference's ``repro.kernels.ops.ds_quantize`` (its Pallas kernel in
  interpret mode) bit for bit;
* keyed ``qadamw_update`` equals its rand entry bit for bit, and the port's
  update holds the reference's contract (masters rtol/atol 2e-6, scales rtol
  1e-6, ≥ 99.9 % of codes equal, off by at most one level) against the
  reference registry's ``pallas`` backend (one ``bits(km, shape)`` plane,
  its kernels in interpret mode), on a 3-D leaf whose (rows, last dim) view
  has the leaf's flat indices;
* a key of the wrong shape, and both or neither of ``rand`` and ``key``,
  raise ``ValueError``.

The kernels themselves run only on the card (``tests/test_torch_kernels_gpu.py``).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax._src import prng as jprng

from torch_bridge import key as bridge_key
from repro.kernels import ops as jops
from repro.kernels import registry as jreg
from repro.optim import adamw as jadamw
from repro.quant import QTensor as JQTensor
from repro_torch import prng
from repro_torch.kernels import ops as tops
from repro_torch.kernels import quant_adamw as tqa
from repro_torch.kernels import registry as treg
from repro_torch.kernels import stoch_quant as tsq
from repro_torch.kernels import threefry as ttf
from repro_torch.optim import adamw as tadamw
from repro_torch.quant import QTensor as TQTensor

MASK = 0xFFFFFFFF
SEEDS = [0, 5, 2 ** 31 + 11]
# counter windows: from 0, ending at 2³², across it, past it, across 2·2³²
WINDOWS = [(0, 37), (2 ** 32 - 40, 40), (2 ** 32 - 17, 50), (2 ** 32 + 3, 20),
           (2 * 2 ** 32 - 7, 31)]


def _jkey(seed):
    return jax.random.PRNGKey(seed)


def _jwords(jkey, start, n):
    """JAX's threefry2x32 on the counters (hi, lo) of start .. start + n − 1:
    ``threefry_2x32`` hashes the first half of its count as x1, the second
    as x2."""
    cnt = np.arange(start, start + n, dtype=np.uint64)
    hi = (cnt >> np.uint64(32)).astype(np.uint32)
    lo = (cnt & np.uint64(MASK)).astype(np.uint32)
    out = np.asarray(jprng.threefry_2x32(jkey, jnp.asarray(np.concatenate([hi, lo]))))
    return out[:n].astype(np.int64), out[n:].astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("start,n", WINDOWS)
def test_int64_hash_matches_jax_threefry_across_2_32(seed, start, n):
    jkey = _jkey(seed)
    k1, k2 = (int(w) for w in np.asarray(jkey))
    cnt = torch.arange(start, start + n, dtype=torch.int64)
    y1, y2 = prng.threefry2x32(k1, k2, cnt >> 32, cnt & MASK)
    w1, w2 = _jwords(jkey, start, n)
    np.testing.assert_array_equal(y1.numpy(), w1)
    np.testing.assert_array_equal(y2.numpy(), w2)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("start,n", WINDOWS)
@pytest.mark.parametrize("out", ["int32", "int64", "f32"])
def test_plane_window_matches_jax_threefry(seed, start, n, out):
    jkey = _jkey(seed)
    w1, w2 = _jwords(jkey, start, n)
    bits = w1 ^ w2
    before = ttf.launches
    got = ttf.threefry_plane(bridge_key(jkey), (n,), out=out, start=start)
    assert ttf.launches == before            # CPU: the plain version
    assert got.dtype == ttf.OUTS[out] and tuple(got.shape) == (n,)
    if out == "int32":
        np.testing.assert_array_equal(got.numpy(), bits.astype(np.uint32).view(np.int32))
    elif out == "int64":
        np.testing.assert_array_equal(got.numpy(), bits)
    else:
        want = ((bits >> 9) | 0x3F800000).astype(np.uint32).view(np.float32) - np.float32(1)
        np.testing.assert_array_equal(got.numpy().view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", [(1,), (7,), (16, 90), (3, 5, 7)])
def test_plane_matches_jax_random(seed, shape):
    jkey = _jkey(seed)
    key = bridge_key(jkey)
    want_bits = np.asarray(jax.random.bits(jkey, shape, jnp.uint32))
    want_u = np.asarray(jax.random.uniform(jkey, shape, jnp.float32))
    np.testing.assert_array_equal(ttf.threefry_plane(key, shape, out="int64").numpy(),
                                  want_bits.astype(np.int64))
    np.testing.assert_array_equal(ttf.threefry_plane(key, shape, out="int32").numpy(),
                                  want_bits.view(np.int32))
    np.testing.assert_array_equal(ttf.threefry_plane(key, shape, out="f32").numpy(), want_u)


@pytest.mark.parametrize("nkeys", [1, 3, 40])
@pytest.mark.parametrize("shape", [(5,), (16, 3)])
@pytest.mark.parametrize("out", ["int32", "int64", "f32"])
def test_batched_key_planes_match_vmap(nkeys, shape, out):
    jkeys = jax.random.split(_jkey(9), nkeys)
    keys = bridge_key(jkeys)
    got = ttf.threefry_plane(keys, shape, out=out)
    assert tuple(got.shape) == (nkeys, *shape)
    if out == "f32":
        want = np.asarray(jax.vmap(lambda k: jax.random.uniform(k, shape))(jkeys))
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        want = np.asarray(jax.vmap(lambda k: jax.random.bits(k, shape, jnp.uint32))(jkeys))
        np.testing.assert_array_equal(
            got.numpy(), want.view(np.int32) if out == "int32" else want.astype(np.int64))
    # the same plane window by window, one key at a time
    for k in range(nkeys):
        np.testing.assert_array_equal(got[k].numpy(),
                                      ttf.threefry_plane(keys[k], shape, out=out).numpy())


def test_plane_rejects_bad_arguments():
    key = prng.PRNGKey(0)
    with pytest.raises(ValueError):
        ttf.threefry_plane(torch.zeros(3, dtype=torch.int64), (4,))
    with pytest.raises(ValueError):
        ttf.threefry_plane(key, (4,), out="f64")
    with pytest.raises(ValueError):
        ttf.threefry_plane(key, (4,), start=-1)


def test_prng_counts_no_int64_hash_on_the_cpu():
    before = ttf.int64_cuda_planes
    prng.bits(prng.PRNGKey(1), (4, 5))
    prng.uniform(prng.split(prng.PRNGKey(2), 3), (6,))
    prng.randint(prng.PRNGKey(3), (9,), 0, 17)
    assert ttf.int64_cuda_planes == before


# ------------------------------------------------------------ B1 keyed --

DS_KEYED = [((16, 90), "col", 7), ((16, 5000), "col", 63), ((13, 100), "row", 15),
            ((8, 128), "row", 127), ((1, 7), "col", 1)]


@pytest.mark.parametrize("shape,axis,s", DS_KEYED)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_ds_quant_keyed_matches_rand_entry_and_reference(shape, axis, s, dtype):
    jkey = jax.random.PRNGKey(s + shape[1])
    x = jax.random.normal(jax.random.fold_in(jkey, 1), shape) * 3
    if dtype == "bf16":
        x = x.astype(jnp.bfloat16)
    ax = 1 if axis == "row" else 0
    scale = jnp.max(jnp.abs(x.astype(jnp.float32)), axis=ax, keepdims=True)
    want = jops.ds_quantize(x, s, jkey, scale)
    tx = torch.from_numpy(np.array(x.astype(jnp.float32)))
    if dtype == "bf16":
        tx = tx.to(torch.bfloat16)
    tscale = torch.from_numpy(np.array(scale))
    key = bridge_key(jkey)
    before = (tsq.launches, tsq.keyed_launches)
    got = tsq.ds_quant_keyed(tx, key, tscale, s=s, scale_axis=axis)
    rand = prng.bits(key, shape, dtype=torch.int32)
    plane = tsq.ds_quant(tx, rand, tscale, s=s, scale_axis=axis)
    assert (tsq.launches, tsq.keyed_launches) == before     # CPU: plain versions
    for g, p, w in zip(got, plane, want[:2]):
        assert g.dtype == torch.int8
        assert torch.equal(g, p)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # and the public wrapper, which takes the keyed entry
    for g, w in zip(tops.ds_quantize(tx, s, key, tscale), want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_ds_quant_keyed_rejects_bad_keys():
    x, scale = torch.ones(4, 8), torch.ones(4, 1)
    for bad in (torch.zeros(3, dtype=torch.int64), torch.zeros(2, 2, dtype=torch.int64),
                torch.zeros(2)):
        with pytest.raises(ValueError):
            tsq.ds_quant_keyed(x, bad, scale, s=7)
    with pytest.raises(ValueError):
        tsq.ds_quant_keyed(x, prng.PRNGKey(0), scale, s=255)


# ------------------------------------------------------------ B9 keyed --

OPK = dict(qmax=127, b1=0.9, b2=0.95, eps=1e-8, wd=0.1, lr=1e-3, b1c=0.1,
           b2c=0.05, clip=1.0, finite=1.0, uclip=10.0)


def _leaf(shape, seed):
    rng = np.random.default_rng(seed)
    c = shape[-1]
    return (rng.normal(0, 1, shape).astype(np.float32),
            (rng.normal(0, 1, shape) * 0.1).astype(np.float32),
            rng.integers(-127, 128, shape).astype(np.int8),
            (np.abs(rng.normal(0, 1, c)) * 0.01 + 1e-4).astype(np.float32),
            rng.integers(0, 128, shape).astype(np.int8),
            (np.abs(rng.normal(0, 1, c)) * 0.01 + 1e-4).astype(np.float32))


def _params(kw):
    return torch.tensor([kw["clip"], kw["finite"], kw["lr"], kw["b1c"], kw["b2c"], 0, 0, 0],
                        dtype=torch.float32)


@pytest.mark.parametrize("shape", [(96, 160), (100, 130), (7, 4)])
@pytest.mark.parametrize("finite", [1.0, 0.0])
def test_qadamw_update_keyed_equals_rand_entry(shape, finite):
    master, g, mc, ms, vc, vs = (torch.from_numpy(a) for a in _leaf(shape, shape[0]))
    kw = dict(OPK, finite=finite)
    params = _params(kw)
    ukw = dict(b1=kw["b1"], b2=kw["b2"], eps=kw["eps"], wd=kw["wd"], qmax=kw["qmax"],
               uclip=kw["uclip"])
    mx, vx = tqa.qadamw_absmax(g, mc, ms, vc, vs, params, b1=kw["b1"], b2=kw["b2"])
    msn = torch.clamp_min(mx.amax(0) / 127, 0) + 1e-6
    vsn = torch.clamp_min(vx.amax(0) / 127, 0) + 1e-6
    key = prng.fold_in(prng.PRNGKey(4), shape[1])
    rand = prng.bits(key, shape, dtype=torch.int32)
    before = (tqa.update_launches, tqa.keyed_update_launches)
    got = tqa.qadamw_update(master, g, mc, ms, vc, vs, msn, vsn, None, params, key=key, **ukw)
    want = tqa.qadamw_update(master, g, mc, ms, vc, vs, msn, vsn, rand, params, **ukw)
    assert (tqa.update_launches, tqa.keyed_update_launches) == before
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
    # the public two-pass wrapper forwards the key
    ops_kw = dict(kw)
    full = tops.quant_adamw_update(master, g, mc, ms, vc, vs, key=key, **ops_kw)
    plane = tops.quant_adamw_update(master, g, mc, ms, vc, vs, rand, **ops_kw)
    for a, b in zip(full, plane):
        assert torch.equal(a, b)


def _adamw_contract(got, want):
    nm_t, mc_t, ms_t, vc_t, vs_t = [np.asarray(x) for x in got]
    nm_j, mc_j, ms_j, vc_j, vs_j = [np.asarray(x) for x in want]
    np.testing.assert_allclose(nm_t, nm_j, rtol=2e-6, atol=2e-6)
    np.testing.assert_allclose(ms_t, ms_j, rtol=1e-6)
    np.testing.assert_allclose(vs_t, vs_j, rtol=1e-6)
    for ct, cj in ((mc_t, mc_j), (vc_t, vc_j)):
        assert (ct == cj).mean() >= 0.999
        assert np.abs(ct.astype(int) - cj.astype(int)).max() <= 1


@pytest.mark.parametrize("shape", [(96, 160), (2, 48, 64)])
def test_qadamw_update_keyed_holds_the_reference_pallas_draw(shape):
    master, g, mc, ms, vc, vs = _leaf(shape, 7)
    jkm, jkv = jax.random.split(jax.random.PRNGKey(21))
    nd = len(shape)
    jsch = jadamw.moment_scheme(8, nd)
    kw = dict(bits=8, b1=0.9, b2=0.95, eps=1e-8, wd=0.1, uclip=10.0)
    jscal = dict(b1c=jnp.float32(0.1), b2c=jnp.float32(0.05), lr=jnp.float32(1e-3),
                 clip=jnp.float32(1.0), finite=jnp.bool_(True))
    jm, jv = JQTensor(jnp.asarray(mc), jnp.asarray(ms), jsch), \
        JQTensor(jnp.asarray(vc), jnp.asarray(vs), jsch)
    nm_j, mq_j, vq_j = jreg.get("pallas").quant_adamw_update(
        jnp.asarray(master), jnp.asarray(g), jm, jv, jkm, jkv, **kw, **jscal)
    want = (nm_j, mq_j.codes, mq_j.scale, vq_j.codes, vq_j.scale)

    t = torch.from_numpy
    km, kv = bridge_key(jkm), bridge_key(jkv)
    c = shape[-1]
    # the keyed entry on the (rows, last dim) view: the leaf's flat indices
    opk = dict(OPK)
    got = tops.quant_adamw_update(t(master).reshape(-1, c), t(g).reshape(-1, c),
                                  t(mc).reshape(-1, c), t(ms), t(vc).reshape(-1, c), t(vs),
                                  key=km, **opk)
    _adamw_contract([x.reshape(shape) if x.ndim == 2 else x for x in got], want)
    # the port's registry (cuda backend; on CPU tensors it draws the plane)
    tsch = tadamw.moment_scheme(8, nd)
    nm_t, mq_t, vq_t = treg.get("cuda").quant_adamw_update(
        t(master), t(g), TQTensor(t(mc), t(ms), tsch), TQTensor(t(vc), t(vs), tsch), km, kv,
        **kw, b1c=torch.tensor(0.1), b2c=torch.tensor(0.05), lr=torch.tensor(1e-3),
        clip=torch.tensor(1.0), finite=torch.tensor(True))
    regs = (nm_t, mq_t.codes, mq_t.scale, vq_t.codes, vq_t.scale)
    _adamw_contract(regs, want)
    for a, b in zip(regs, got):
        assert torch.equal(a.reshape(-1), b.reshape(-1))


def test_qadamw_update_rejects_bad_rand_and_key():
    shape = (8, 12)
    master, g, mc, ms, vc, vs = (torch.from_numpy(a) for a in _leaf(shape, 1))
    params = _params(OPK)
    rand = prng.bits(prng.PRNGKey(0), shape, dtype=torch.int32)
    ukw = dict(b1=0.9, b2=0.95, eps=1e-8, wd=0.1, qmax=127)
    args = (master, g, mc, ms, vc, vs, ms, vs)
    with pytest.raises(ValueError):
        tqa.qadamw_update(*args, None, params, **ukw)
    with pytest.raises(ValueError):
        tqa.qadamw_update(*args, rand, params, key=prng.PRNGKey(0), **ukw)
    for bad in (torch.zeros(3, dtype=torch.int64), torch.zeros(2, 2, dtype=torch.int64)):
        with pytest.raises(ValueError):
            tqa.qadamw_update(*args, None, params, key=bad, **ukw)
