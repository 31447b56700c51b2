"""``qmv.plan`` and the wrapper around kernel B3 (``qmv``): one CUDA launch
per call at every shape, the layout from the strides, the load width from
the alignment, and the split merged through a kept workspace whose arrival
counters start at 0. Plain Python: these run on the CPU. The wrapper's C
call is replaced by a stub that records its arguments; operands at full
size are meta tensors (shapes without storage), except where the test
needs real addresses."""
import numpy as np
import pytest
import torch

from repro_torch.kernels import qmv as tqmv

# (R, C of the stored plane, transposed view): chip_smoke.py's QMV_CASES
# (gisette's batch, yearprediction's batch, a square and a ragged plane)
# and the GPU tests' extra shapes (long rows and columns that split)
SMOKE = [(16, 5000, False), (16, 5000, True), (16, 90, False), (16, 90, True),
         (1024, 2048, False), (1024, 2048, True), (13, 1001, False), (13, 1001, True)]
GPU = [(1, 5, False), (1, 3, True), (3, 70000, False), (5, 3001, False),
       (300, 5000, True), (7, 1001, True)]


class _StubLib:
    """Records the arguments of the C entry point and reports success."""

    def __init__(self):
        self.calls = []

    def qmv_launch(self, *args):
        self.calls.append(args)
        return 0


@pytest.fixture
def stub(monkeypatch):
    lib = _StubLib()
    monkeypatch.setattr(tqmv, "_lib", lambda: lib)
    monkeypatch.setattr(tqmv, "_stream", lambda x: 0)
    monkeypatch.setattr(tqmv, "launches", 0)
    monkeypatch.setattr(tqmv, "shape_launches", type(tqmv.shape_launches)())
    monkeypatch.setattr(tqmv, "_WORKSPACE", {})
    return lib


def _view(r, c, transposed, device="meta"):
    plane = torch.empty(r, c, dtype=torch.int8, device=device)
    return plane.T if transposed else plane


def _plan_args(args):
    """(R, C, layout, width, unroll, splits, chunk) of one recorded call."""
    return args[7:14]


@pytest.mark.parametrize("r,c,transposed", SMOKE + GPU)
def test_one_launch_with_the_plan_passed_unchanged(stub, r, c, transposed):
    codes = _view(r, c, transposed)
    rr, cc = codes.shape
    out = tqmv._launch(codes, torch.empty(cc, device="meta"))
    assert out.shape == (rr,) and out.dtype == torch.float32
    (args,) = stub.calls
    p = tqmv.plan(rr, cc, *codes.stride(), 0)
    assert _plan_args(args) == (rr, cc, tqmv.LAYOUTS[p.layout], p.width, p.unroll,
                                p.splits, p.chunk)
    assert args[1:3] == codes.stride()
    assert tqmv.launches == 1
    assert dict(tqmv.shape_launches) == {(rr, cc, p.layout == "cols"): 1}


@pytest.mark.parametrize("r,c,transposed", SMOKE + GPU)
def test_plan_covers_the_plane_in_one_step_a_block(r, c, transposed):
    codes = _view(r, c, transposed)
    rr, cc = codes.shape
    for base in (0, 1, 2, 4, 8):
        p = tqmv.plan(rr, cc, *codes.stride(), base)
        assert p.splits * p.chunk >= cc > (p.splits - 1) * p.chunk
        assert p.unroll & (p.unroll - 1) == 0
        if p.layout == "rows":
            assert p.tiles == rr and p.chunk % p.width == 0
            assert p.unroll <= tqmv.MAX_UNROLL
            assert tqmv.THREADS * p.unroll * p.width >= p.chunk    # one step
            assert tqmv.THREADS * p.unroll * p.width < 2 * p.chunk or p.unroll == 1
        else:
            assert p.tiles * tqmv.THREADS * p.width >= rr
            assert p.unroll >= p.chunk and p.chunk <= tqmv.MAX_COLS_STEP
        assert (p.ws, p.counters) == ((p.splits * rr, p.tiles) if p.splits > 1 else (0, 0))


def test_the_path_planes_do_not_split():
    # gisette's (16, 5000) and yearprediction's (16, 90), each way round:
    # one block a row (or a row tile), every load in one step, no merge
    for r, c in ((16, 5000), (16, 90)):
        for transposed in (False, True):
            codes = _view(r, c, transposed)
            p = tqmv.plan(*codes.shape, *codes.stride(), 0)
            assert p.splits == 1 and (p.ws, p.counters) == (0, 0)
    rows = tqmv.plan(16, 5000, 5000, 1, 0)
    assert rows == ("rows", 8, 8, 1, 5000, 16, 0, 0)        # 5000 = 8 · 625
    assert tqmv.plan(5000, 16, 1, 5000, 0) == ("cols", 4, 16, 1, 16, 10, 0, 0)
    assert tqmv.plan(16, 90, 90, 1, 0) == ("rows", 1, 1, 1, 90, 16, 0, 0)
    # yearprediction's view has R 90 <= COLS_MIN_ROWS: a block per row
    assert tqmv.plan(90, 16, 1, 90, 0) == ("rows", 1, 1, 1, 16, 90, 0, 0)


def test_splits_where_a_step_does_not_cover_the_plane():
    p = tqmv.plan(3, 70000, 70000, 1, 0)                      # 16-byte loads
    assert p.layout == "rows" and p.width == 16 and p.splits == 5 and p.unroll == 8
    p = tqmv.plan(5, 3001, 3001, 1, 0)                        # single codes
    assert p.width == 1 and p.splits == 3 and p.chunk == 1001
    p = tqmv.plan(2048, 1024, 1, 2048, 0)                     # the transposed square
    assert p.layout == "cols" and p.splits == 64 and p.tiles == 4
    assert (p.ws, p.counters) == (64 * 2048, 4)


@pytest.mark.parametrize("sr,sc,base,want", [
    (5000, 1, 0, 8), (2048, 1, 0, 16), (2048, 1, 8, 8),
    (2048, 1, 4, 4), (2048, 1, 2, 1), (90, 1, 0, 1), (1001, 1, 0, 1), (600, 3, 0, 1),
    (4, 1, 0, 4), (12, 1, 0, 4), (24, 1, 16, 8)])
def test_rows_load_width_from_alignment(sr, sc, base, want):
    p = tqmv.plan(4, 64, sr, sc, base)
    assert p.layout == "rows" and p.width == want


@pytest.mark.parametrize("sc,base,want", [(5000, 0, 4), (90, 0, 2), (1001, 0, 1),
                                          (2048, 2, 2), (2048, 1, 1), (3, 0, 1), (600, 4, 4)])
def test_cols_rows_per_thread_from_alignment(sc, base, want):
    p = tqmv.plan(tqmv.COLS_MIN_ROWS + 1, 16, 1, sc, base)
    assert p.layout == "cols" and p.width == want


def test_layout_from_strides():
    plane = torch.empty(40, 600, dtype=torch.int8, device="meta")
    # R-contiguous views of more than COLS_MIN_ROWS rows take cols;
    # everything else, short views and single rows included, rows
    assert tqmv.plan(*plane.T.shape, *plane.T.stride(), 0).layout == "cols"
    assert tqmv.plan(*plane.shape, *plane.stride(), 0).layout == "rows"
    v = plane[:, ::3].T                                       # strides (3, 600)
    assert tqmv.plan(*v.shape, *v.stride(), 0).layout == "rows"
    assert tqmv.plan(1, 600, 1, 1, 0).layout == "rows"
    edge = tqmv.COLS_MIN_ROWS
    assert tqmv.plan(edge, 16, 1, edge, 0).layout == "rows"
    assert tqmv.plan(edge + 1, 16, 1, edge + 1, 0).layout == "cols"


def test_real_addresses_set_the_width(stub):
    plane = torch.zeros(40, 600, dtype=torch.int8)
    assert plane.data_ptr() % 16 == 0
    for view, want in ((plane, 8), (plane[1:, 2:], 1), (plane[1:, 4:], 4), (plane.T, 4),
                       (plane[:, 1:].T, 1), (plane[:, 2:].T, 2)):
        stub.calls.clear()
        tqmv._launch(view, torch.zeros(view.shape[1]))
        (args,) = stub.calls
        assert args[0] == view.data_ptr() and args[10] == want


def test_workspace_is_kept_and_grown_and_counters_start_at_zero(stub):
    key = (torch.device("cpu"), 0)
    split = torch.zeros(3, 70000, dtype=torch.int8)
    tqmv._launch(split, torch.zeros(70000))
    ws, counters = tqmv._WORKSPACE[key]
    assert ws.numel() == 5 * 3 and torch.equal(counters, torch.zeros(3, dtype=torch.int32))
    assert stub.calls[-1][5:7] == (ws.data_ptr(), counters.data_ptr())
    for _ in range(2):          # a call that does not split keeps the buffers
        tqmv._launch(torch.zeros(16, 5000, dtype=torch.int8), torch.zeros(5000))
        assert tqmv._WORKSPACE[key][0] is ws and tqmv._WORKSPACE[key][1] is counters
    big = torch.zeros(1024, 2048, dtype=torch.int8).T            # 64 splits, 4 tiles
    tqmv._launch(big, torch.zeros(1024))
    ws2, counters2 = tqmv._WORKSPACE[key]
    assert ws2.numel() == 64 * 2048 > ws.numel()
    assert torch.equal(counters2, torch.zeros(4, dtype=torch.int32))
    tqmv._launch(torch.zeros(9, 70000, dtype=torch.int8), torch.zeros(70000))
    ws3, counters3 = tqmv._WORKSPACE[key]         # more rows: more counters, same partials
    assert ws3 is ws2 and torch.equal(counters3, torch.zeros(9, dtype=torch.int32))
    assert tqmv.launches == 5


def test_cpu_tensors_take_the_plain_version(stub):
    rng = np.random.default_rng(0)
    codes = torch.from_numpy(rng.integers(-127, 128, (7, 24)).astype(np.int8))
    v = torch.from_numpy(rng.normal(0, 1, 24).astype(np.float32))
    for view, vec in ((codes, v), (codes.T, v[:7])):
        got = tqmv.qmv(view, vec)
        torch.testing.assert_close(got, tqmv.qmv_plain(view, vec), rtol=0, atol=0)
    assert not stub.calls and tqmv.launches == 0


def test_empty_or_oversized_planes_raise():
    with pytest.raises(ValueError, match="empty"):
        tqmv.plan(0, 5, 5, 1, 0)
    with pytest.raises(ValueError, match="grid"):
        tqmv.plan(300, 16 * 65536 + 1, 1, 300, 0)
