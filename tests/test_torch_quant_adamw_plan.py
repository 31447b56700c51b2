"""``quant_adamw.plan`` and pass 1's wrappers around kernel B8: the path
entry ``qadamw_scales`` (the new scales, merged in one launch through a
kept workspace whose running maxima and arrival counters start at 0) and
the parity entry ``qadamw_absmax`` (256 rows a partial, no merge), one
CUDA launch a call, the layout from the shape and the addresses. Plain
Python: these run on the CPU. The wrapper's C call is replaced by a stub
that records its arguments; operands at full size are meta tensors (shapes
without storage), except where the test needs real addresses."""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops as tops
from repro_torch.kernels import quant_adamw as tqa
from repro_torch.kernels import ref as tref

# every leaf of full-width gemma-2b flattened to (rows, last dim) —
# chip_smoke.py's ADAMW_SHAPES: up/gate, embed.table, k/v, ln1/ln2, q/o,
# down — and the GPU tests' odd shapes
LEAVES = [(36864, 16384), (256000, 2048), (36864, 256), (18, 2048), (36864, 2048),
          (294912, 2048)]
GPU = [(1, 7), (257, 130), (96, 160), (513, 2048), (600, 300), (64, 16384), (96, 2048),
       (257, 256), (3, 5)]


class _StubLib:
    """Records the arguments of the C entry point and reports success."""

    def __init__(self):
        self.calls = []

    def qadamw_absmax_launch(self, *args):
        self.calls.append(args)
        return 0


@pytest.fixture
def stub(monkeypatch):
    lib = _StubLib()
    monkeypatch.setattr(tqa, "_lib", lambda: lib)
    monkeypatch.setattr(tqa, "_stream", lambda x: 0)
    monkeypatch.setattr(tqa, "absmax_launches", 0)
    monkeypatch.setattr(tqa, "scales_launches", 0)
    monkeypatch.setattr(tqa, "shape_launches", type(tqa.shape_launches)())
    monkeypatch.setattr(tqa, "_WORKSPACE", {})
    return lib


def _operands(r, c, device="meta"):
    return (torch.empty(r, c, device=device), torch.empty(r, c, dtype=torch.int8, device=device),
            torch.empty(c, device=device), torch.empty(r, c, dtype=torch.int8, device=device),
            torch.empty(c, device=device), torch.empty(8, device=device))


def _layout(args):
    """(R, C, qmax, width, unroll, rows, tiles, runs, partials) of one call."""
    return args[10:12] + args[16:23]


def _pass1(partials, ops, qmax=127):
    return tqa._pass1("qadamw_scales", *ops, b1=0.9, b2=0.95, qmax=qmax, partials=partials)


@pytest.mark.parametrize("r,c", LEAVES + GPU)
def test_scales_one_launch_with_the_plan_passed_unchanged(stub, r, c):
    msn, vsn = _pass1(False, _operands(r, c))
    assert msn.shape == vsn.shape == (c,) and msn.dtype == torch.float32
    (args,) = stub.calls
    p = tqa.plan(r, c, 0)
    assert _layout(args) == (r, c, 127.0, p.width, p.unroll, p.rows, p.tiles, p.runs, 0)
    assert args[12:16] == pytest.approx((0.9, 0.1, 0.95, 0.05))
    assert (tqa.scales_launches, tqa.absmax_launches) == (1, 0)
    assert dict(tqa.shape_launches) == {("scales", r, c): 1}
    ws, counters = tqa._WORKSPACE[(torch.device("meta"), 0)]
    assert args[8:10] == (ws.data_ptr(), counters.data_ptr())
    assert ws.dtype == torch.int32 and ws.numel() >= p.ws and counters.numel() >= p.counters


@pytest.mark.parametrize("r,c", LEAVES + GPU)
def test_partials_one_launch_of_256_rows_a_block(stub, r, c):
    mx, vx = _pass1(True, _operands(r, c))
    nb = -(-r // tqa.ROWS_PER_BLOCK)
    assert mx.shape == vx.shape == (nb, c)
    (args,) = stub.calls
    p = tqa.plan(r, c, 0, partials=True)
    assert (p.rows, p.runs, p.ws, p.counters) == (tqa.ROWS_PER_BLOCK, nb, 0, 0)
    assert _layout(args)[3:] == (p.width, p.unroll, p.rows, p.tiles, p.runs, 1)
    assert (tqa.scales_launches, tqa.absmax_launches) == (0, 1)
    assert dict(tqa.shape_launches) == {("absmax", r, c): 1}


@pytest.mark.parametrize("r,c", LEAVES + GPU)
@pytest.mark.parametrize("alignment", [0, 4, 8, 16])
def test_plan_covers_the_leaf_and_fills_the_card(r, c, alignment):
    p = tqa.plan(r, c, alignment)
    assert p.width == (4 if c % 4 == 0 and alignment % 16 == 0 else 1)
    assert p.tiles * 32 * p.width >= c > (p.tiles - 1) * 32 * p.width
    assert p.runs * p.rows >= r > (p.runs - 1) * p.rows
    assert p.rows & (p.rows - 1) == 0 and tqa.MIN_ROWS <= p.rows <= tqa.MAX_ROWS
    assert p.unroll in (4, 8) and p.rows >= tqa.WARPS * p.unroll
    # the most rows a block that still gives MIN_BLOCKS blocks; fewer only
    # at the least rows a block
    assert p.tiles * p.runs >= tqa.MIN_BLOCKS or p.rows == tqa.MIN_ROWS
    if p.rows < tqa.MAX_ROWS:
        assert p.tiles * -(-r // (2 * p.rows)) < tqa.MIN_BLOCKS
    merge = p.runs > 1
    assert (p.ws, p.counters) == ((2 * c, p.tiles) if merge else (0, 0))


def test_every_leaf_has_four_blocks_a_sm():
    # every gemma-2b leaf that has 528 column tiles × row runs gets them;
    # ln1/ln2 (18 rows, 16 tiles) is one run: no merge
    for r, c in LEAVES:
        p = tqa.plan(r, c, 0)
        assert p.width == 4 and p.unroll == 4
        if (r, c) == (18, 2048):
            assert (p.tiles, p.runs, p.ws) == (16, 1, 0)
        else:
            assert p.tiles * p.runs >= 4 * tqa.SMS and p.runs > 1
    assert tqa.plan(36864, 16384, 0)[2:5] == (1024, 128, 36)
    assert tqa.plan(256000, 2048, 0)[2:5] == (512, 16, 500)
    assert tqa.plan(36864, 256, 0)[2:5] == (64, 2, 576)
    assert tqa.plan(36864, 2048, 0)[2:5] == (128, 16, 288)
    assert tqa.plan(294912, 2048, 0)[2:5] == (1024, 16, 288)


def test_real_addresses_set_the_width(stub):
    r, c = 40, 600
    base = _operands(r, c, device="cpu")
    flat = torch.zeros(r * c + 4)
    codes = torch.zeros(r * c + 4, dtype=torch.int8)
    for g, mc, want in ((base[0], base[1], 4),
                        (flat[1:1 + r * c].view(r, c), base[1], 1),     # g 4-byte aligned
                        (flat[4:4 + r * c].view(r, c), base[1], 4),
                        (base[0], codes[2:2 + r * c].view(r, c), 1),    # codes 2-byte aligned
                        (base[0], codes[4:4 + r * c].view(r, c), 4)):
        stub.calls.clear()
        tqa._pass1("qadamw_scales", g, mc, *base[2:], b1=0.9, b2=0.95, qmax=127,
                   partials=False)
        (args,) = stub.calls
        assert args[0] == g.data_ptr() and args[1] == mc.data_ptr() and args[17] == want


def test_workspace_is_kept_and_grown_and_starts_at_zero(stub):
    key = (torch.device("cpu"), 0)
    _pass1(False, _operands(300, 64, device="cpu"))
    ws, counters = tqa._WORKSPACE[key]
    p = tqa.plan(300, 64, 0)
    assert p.runs > 1 and ws.numel() == 2 * 64 and counters.numel() == p.tiles
    assert not ws.any() and not counters.any() and ws.dtype == torch.int32
    for _ in range(2):          # a call that merges no more keeps the buffers
        _pass1(False, _operands(18, 64, device="cpu"))
        _pass1(True, _operands(600, 64, device="cpu"))
        assert tqa._WORKSPACE[key][0] is ws and tqa._WORKSPACE[key][1] is counters
    _pass1(False, _operands(2000, 512, device="cpu"))
    ws2, counters2 = tqa._WORKSPACE[key]
    assert ws2.numel() == 2 * 512 and not ws2.any() and not counters2.any()
    assert (tqa.scales_launches, tqa.absmax_launches) == (4, 2)


def _leaf(r, c, seed, nan_at=None):
    rng = np.random.default_rng(seed)
    t = torch.from_numpy
    g = t((rng.normal(0, 1, (r, c)) * 0.1).astype(np.float32))
    if nan_at is not None:
        g[nan_at] = float("nan")
    return (g, t(rng.integers(-127, 128, (r, c)).astype(np.int8)),
            t((np.abs(rng.normal(0, 1, c)) * 0.01 + 1e-4).astype(np.float32)),
            t(rng.integers(0, 128, (r, c)).astype(np.int8)),
            t((np.abs(rng.normal(0, 1, c)) * 0.01 + 1e-4).astype(np.float32)))


@pytest.mark.parametrize("r,c", [(1, 7), (257, 130), (600, 300)])
@pytest.mark.parametrize("finite", [1.0, 0.0])
def test_cpu_tensors_take_the_plain_version(stub, r, c, finite):
    ops = _leaf(r, c, seed=r)
    params = torch.tensor([0.5, finite, 1e-3, 0.1, 0.05, 0, 0, 0])
    msn, vsn = tqa.qadamw_scales(*ops, params, b1=0.9, b2=0.95, qmax=127)
    mx, vx = tqa.qadamw_absmax(*ops, params, b1=0.9, b2=0.95)
    assert not stub.calls and (tqa.scales_launches, tqa.absmax_launches) == (0, 0)
    # the max of the partials, then the scale: bit for bit
    assert torch.equal(msn, tref.adamw_scale_ref(torch.amax(mx, dim=0), 127))
    assert torch.equal(vsn, tref.adamw_scale_ref(torch.amax(vx, dim=0), 127))


def test_nan_reaches_the_scales():
    ops = _leaf(300, 64, seed=1, nan_at=(260, 5))
    params = torch.tensor([1.0, 1.0, 1e-3, 0.1, 0.05, 0, 0, 0])
    msn, vsn = tqa.qadamw_scales(*ops, params, b1=0.9, b2=0.95, qmax=127)
    mx, vx = tqa.qadamw_absmax(*ops, params, b1=0.9, b2=0.95)
    assert torch.isnan(mx[1, 5]) and torch.isnan(vx[1, 5]) and not torch.isnan(mx[0]).any()
    keep = torch.arange(64) != 5
    assert torch.isnan(msn[5]) and torch.isnan(vsn[5])
    assert torch.isfinite(msn[keep]).all() and torch.isfinite(vsn[keep]).all()


def test_the_update_takes_the_path_entry(monkeypatch):
    # ops.quant_adamw_update: pass 1's path entry, then pass 2, nothing
    # between; the parity entry is not called
    seen = []
    for name in ("qadamw_scales", "qadamw_update"):
        fn = getattr(tqa, name)
        monkeypatch.setattr(tqa, name, lambda *a, _f=fn, _n=name, **k: (seen.append(_n),
                                                                        _f(*a, **k))[1])

    def parity(*a, **k):
        raise AssertionError("the parity entry ran on the path")

    monkeypatch.setattr(tqa, "qadamw_absmax", parity)
    g, mc, ms, vc, vs = _leaf(96, 160, seed=2)
    master = torch.zeros_like(g)
    rand = torch.zeros(96, 160, dtype=torch.int32)
    out = tops.quant_adamw_update(master, g, mc, ms, vc, vs, rand, qmax=127, b1=0.9, b2=0.95,
                                  eps=1e-8, wd=0.1, lr=1e-3, b1c=0.1, b2c=0.05, clip=1.0,
                                  finite=1.0)
    assert seen == ["qadamw_scales", "qadamw_update"]
    params = torch.tensor([1.0, 1.0, 1e-3, 0.1, 0.05, 0, 0, 0])
    want = tqa.qadamw_scales_plain(g, mc, ms, vc, vs, params, b1=0.9, b2=0.95, qmax=127)
    assert torch.equal(out[2], want[0]) and torch.equal(out[4], want[1])


def test_empty_or_oversized_leaves_raise():
    with pytest.raises(ValueError, match="empty"):
        tqa.plan(0, 5, 0)
    with pytest.raises(ValueError, match="grid"):
        tqa.plan(tqa.MAX_ROWS * 65535 + 1, 4, 0)
