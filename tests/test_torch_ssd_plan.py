"""``ssd.plan`` and the wrapper around kernel B12 (``ssd_chunk_scan``): the
core follows x's dtype alone (bf16 on the tensor cores, f32 on the SIMT
kernel), and the output phase's grid covers every (batch, chunk, row tile,
head group) with no empty block. The wrapper's C call is replaced by a stub
that records its arguments; operands at full size are meta tensors.

``ssd_chunk_scan_tc_plain`` — the tensor-core core's three phases written
out in torch, every f32 operand of a product in three bf16 pieces — against
the plain scan (``ssd_chunk_scan_ref``) and the Pallas kernel in interpret
mode, inputs made with numpy. Tolerances: y within ``SSD_TOL`` (rtol and
atol 1e-4 at f32, 2e-2 at bf16: the reference's own for its Pallas kernel,
f32 sums in another order and, at bf16, y rounded once more), and the final
state within 1e-4 at both dtypes (the split is exact, so bf16 inputs leave
only f32 rounding in the state).
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ssd as jssd
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import ssd as tssd

SSD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
STATE_TOL = 1e-4
J = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
# (B, NC, L, H, P, N): mamba2-780m's prefill (4 chunks of 256), the single
# 1023-row chunk of a 1023-token prompt, the GPU tests' ragged L 40 and 33
# and their 3 and 2 heads
SHAPES = [(4, 4, 256, 48, 64, 128), (4, 1, 1023, 48, 64, 128), (2, 3, 40, 3, 16, 16),
          (1, 2, 33, 2, 64, 8)]


class _StubLib:
    """Records the arguments of the C entry point and reports success."""

    def __init__(self):
        self.calls = []

    def ssd_chunk_scan_launch(self, *args):
        self.calls.append(args)
        return 0


@pytest.fixture
def stub(monkeypatch):
    lib = _StubLib()
    monkeypatch.setattr(tssd, "_lib", lambda: lib)
    monkeypatch.setattr(tssd, "_stream", lambda x: 0)
    for name in ("launches", "tc_launches"):
        monkeypatch.setattr(tssd, name, 0)
    monkeypatch.setattr(tssd, "shape_launches", type(tssd.shape_launches)())
    return lib


def _meta(b, nc, L, h, p, n, dtype, init=False):
    """Operands of one call as shapes without storage."""
    m = dict(device="meta")
    f32 = dict(device="meta", dtype=torch.float32)
    return (torch.empty(b, nc, L, h, p, dtype=dtype, **m), torch.empty(b, nc, L, h, **f32),
            torch.empty(b, nc, L, h, **f32), torch.empty(b, nc, L, n, dtype=dtype, **m),
            torch.empty(b, nc, L, n, dtype=dtype, **m),
            torch.empty(b, h, p, n, **f32) if init else None)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_core_follows_the_dtype_alone_and_reaches_c_unchanged(stub, shape, dtype):
    b, nc, L, h, p, n = shape
    pl = tssd.plan(dtype, L, h, p, n)
    assert pl.core == ("tc" if dtype == torch.bfloat16 else "simt")
    y, st = tssd._launch(*_meta(*shape, dtype))
    assert y.shape == (b, nc, L, h, p) and y.dtype == dtype
    assert st.shape == (b, h, p, n) and st.dtype == torch.float32
    (args,) = stub.calls
    assert args[1] == int(dtype == torch.bfloat16)
    assert args[22:28] == (b, nc, L, h, p, n)
    assert args[28:31] == (tssd.CORES[pl.core], pl.row_tiles, pl.head_groups)
    tc = int(pl.core == "tc")
    assert (tssd.launches, tssd.tc_launches) == (1, tc)
    assert dict(tssd.shape_launches) == {(str(dtype)[6:], *shape, False): 1}


@pytest.mark.parametrize("shape", SHAPES)
def test_grid_covers_every_tile_and_head_with_no_empty_block(shape):
    b, nc, L, h, p, n = shape
    pl = tssd.plan(torch.bfloat16, L, h, p, n)
    rt, hg = tssd.ROW_TILE, tssd.HEAD_GROUP
    # every row and head in exactly one block; every block has at least one
    rows = [min(rt, L - k * rt) for k in range(pl.row_tiles)]
    heads = [min(hg, h - k * hg) for k in range(pl.head_groups)]
    assert sum(rows) == L and min(rows) >= 1
    assert sum(heads) == h and min(heads) >= 1
    blocks = b * nc * pl.row_tiles * pl.head_groups
    assert blocks == b * nc * math.ceil(L / rt) * math.ceil(h / hg)
    if shape[:4] == (4, 4, 256, 48):
        assert (pl.row_tiles, pl.head_groups, blocks) == (4, 24, 1536)
    if shape[:4] == (4, 1, 1023, 48):
        assert (pl.row_tiles, pl.head_groups, blocks) == (16, 24, 1536)
    if h == 3:
        assert heads == [2, 1]                    # H not divisible by the head group


def test_simt_grid_is_a_block_per_head():
    assert tssd.plan(torch.float32, 256, 48, 64, 128) == ("simt", 1, 48)


def test_scratch_follows_the_core(stub):
    tssd._launch(*_meta(4, 4, 256, 48, 64, 128, torch.bfloat16))
    tssd._launch(*_meta(4, 4, 256, 48, 64, 128, torch.float32))
    tc, simt = stub.calls
    assert None not in tc[20:22] and simt[20:22] == (None, None)   # bx, state pieces
    assert (tssd.launches, tssd.tc_launches) == (2, 1)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_head_dim_past_the_register_tile_raises(stub, dtype):
    with pytest.raises(ValueError, match="head_dim 65 > 64"):
        tssd._launch(*_meta(1, 1, 8, 2, 65, 16, dtype))
    assert not stub.calls


def test_state_past_the_tensor_cores_tile_raises():
    with pytest.raises(ValueError, match="state 257"):
        tssd.plan(torch.bfloat16, 256, 48, 64, 257)
    assert tssd.plan(torch.float32, 256, 48, 64, 257).core == "simt"
    with pytest.raises(TypeError, match="bf16 or f32"):
        tssd.plan(torch.float16, 256, 48, 64, 128)


def test_cpu_tensors_take_the_plain_version(stub):
    args = _inputs(1, 2, 8, 2, 4, 8, torch.bfloat16)
    y, st = tssd.ssd_chunk_scan(*args)
    y_ref, st_ref = tssd.ssd_chunk_scan_plain(*args)
    assert torch.equal(y, y_ref) and torch.equal(st, st_ref)
    assert not stub.calls and tssd.launches == 0


# ----------------------------------------------- the core's order in torch --

def _inputs(b, nc, L, h, p, n, dtype, init=False, seed=0):
    """The reference test's laws: x N(0, .25), dt = softplus(N(0, 1) − 1),
    logdec = dt · −(1..H), B and C N(0, .09) in ``dtype``; an initial state
    N(0, 1) when ``init``."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 0.5, (b, nc, L, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(0, 1, (b, nc, L, h)) - 1)).astype(np.float32)
    logdec = (dt * -np.arange(1, h + 1, dtype=np.float32)).astype(np.float32)
    bm = (rng.normal(0, 1, (b, nc, L, n)) * 0.3).astype(np.float32)
    cm = (rng.normal(0, 1, (b, nc, L, n)) * 0.3).astype(np.float32)
    st = rng.normal(0, 1, (b, h, p, n)).astype(np.float32) if init else None
    t = torch.from_numpy
    return (t(x).to(dtype), t(dt), t(logdec), t(bm).to(dtype), t(cm).to(dtype),
            None if st is None else t(st))


def _close(got, want, tol):
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


# (B, NC, L, H, P, N): the reference test's dims, the GPU tests' ragged ones
MIRROR_SHAPES = [(2, 4, 32, 4, 8, 16), (2, 3, 40, 3, 16, 16), (1, 2, 33, 2, 64, 8)]


@pytest.mark.parametrize("shape", MIRROR_SHAPES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_tc_order_matches_the_pallas_kernel_and_the_plain_scan(shape, dtype):
    args = _inputs(*shape, dtype, seed=sum(shape))
    y, st = tssd.ssd_chunk_scan_tc_plain(*args)
    assert y.dtype == dtype and st.dtype == torch.float32
    y_ref, st_ref = tref.ssd_chunk_scan_ref(*args)
    to_j = [jnp.asarray(a.float().numpy(), J[dtype] if k in (0, 3, 4) else jnp.float32)
            for k, a in enumerate(args[:5])]
    y_pl, st_pl = jssd.ssd_chunk_scan(*to_j, interpret=True)
    y_pl = torch.from_numpy(np.array(y_pl.astype(jnp.float32)))
    st_pl = torch.from_numpy(np.array(st_pl))
    for want_y, want_st in ((y_ref, st_ref), (y_pl, st_pl)):
        _close(y, want_y, SSD_TOL[dtype])
        _close(st, want_st, STATE_TOL)


@pytest.mark.parametrize("shape", MIRROR_SHAPES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_tc_order_carries_an_initial_state(shape, dtype):
    args = _inputs(*shape, dtype, init=True, seed=7 + sum(shape))
    y, st = tssd.ssd_chunk_scan_tc_plain(*args)
    y_ref, st_ref = tref.ssd_chunk_scan_ref(*args)
    _close(y, y_ref, SSD_TOL[dtype])
    _close(st, st_ref, STATE_TOL)


def test_tc_order_at_a_long_single_chunk():
    # one chunk of 300 rows, 4 heads with decays up to 4 a step: the state
    # is that of the chunk's last rows, y crosses many m tiles of 64
    args = _inputs(1, 1, 300, 4, 16, 16, torch.bfloat16, init=True, seed=11)
    y, st = tssd.ssd_chunk_scan_tc_plain(*args)
    y_ref, st_ref = tref.ssd_chunk_scan_ref(*args)
    _close(y, y_ref, SSD_TOL[torch.bfloat16])
    _close(st, st_ref, STATE_TOL)


def test_tc_order_through_the_chunked_drop_in():
    # ops.ssd_chunked_kernel's chunking around the mirror: (B, S, H, P) in,
    # as the model calls it, one chunk of 16 per four
    args = _inputs(2, 4, 16, 3, 8, 16, torch.bfloat16, seed=5)
    x, dt, _, bm, cm, _ = args
    a_log = torch.log(torch.arange(1.0, 4.0))
    flat = (x.reshape(2, 64, 3, 8), dt.reshape(2, 64, 3), a_log, bm.reshape(2, 64, 16),
            cm.reshape(2, 64, 16))
    got = tops._ssd_chunked(tssd.ssd_chunk_scan_tc_plain, *flat, 16, None)
    want = tops.ssd_chunked_plain(*flat, chunk=16)
    _close(got[0], want[0], SSD_TOL[torch.bfloat16])
    _close(got[1], want[1], STATE_TOL)


def test_tc_order_masks_before_the_exponential():
    # decays of 30 a step: exp(cum_l − cum_m) above the diagonal would be
    # inf (and inf · 0 NaN) had the mask come after the exponential
    x, dt, logdec, bm, cm, _ = _inputs(1, 1, 24, 2, 8, 8, torch.bfloat16, seed=9)
    y, st = tssd.ssd_chunk_scan_tc_plain(x, dt, logdec * 30, bm, cm)
    assert torch.isfinite(y.float()).all() and torch.isfinite(st).all()
    y_ref, st_ref = tref.ssd_chunk_scan_ref(x, dt, logdec * 30, bm, cm)
    _close(y, y_ref, SSD_TOL[torch.bfloat16])
    _close(st, st_ref, STATE_TOL)
