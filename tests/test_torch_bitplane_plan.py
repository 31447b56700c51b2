"""``qmm_bitplane.plan`` — the one place that chooses the core and the K
split of kernel B11's product. Plain Python: these run on the CPU. The
wrapper's C call is replaced by a stub that records its arguments, so that
the test can see which core and split the wrapper passes to the kernel;
operands at full size are meta tensors (shapes without storage).

What the plan must keep: a row of x gives the same bits at every M (a
decode step, the speculative verify window and every prompt bucket), so
neither the core nor the split may depend on M."""
import inspect
import math

import pytest
import torch

from repro_torch.kernels import qmm_bitplane as tqbp

# decode (the 4 slots), the verify window (4 slots × 4 rows), the served
# trace's prompt buckets (48–112), the largest bucket there can be, and
# beyond one tile of rows
MS = [1, 4, 8, 16, 48, 64, 80, 96, 112, 128, 2048]
# gemma-2b's q/o, k/v, gate/up, down; ragged shapes of the GPU tests
PATH_KNS = [(2048, 2048), (2048, 256), (2048, 16384), (16384, 2048)]
KNS = PATH_KNS + [(1001, 1000), (40, 24), (64, 70)]
DTYPES = [torch.bfloat16, torch.float32]


def test_plan_takes_no_m():
    assert list(inspect.signature(tqbp.plan).parameters) == ["k", "n", "x_dtype"]
    assert list(inspect.signature(tqbp.split_k).parameters) == ["k", "n", "core"]


@pytest.mark.parametrize("k,n", KNS)
@pytest.mark.parametrize("xdtype", DTYPES)
def test_wrapper_passes_one_plan_at_every_m(stub, k, n, xdtype):
    passed = set()
    for m in MS:
        stub.calls.clear()
        tqbp._launch(*_operands(m, k, n, 9, xdtype, "meta"))
        (args,) = stub.calls
        assert args[7:10] == (m, k, n)
        passed.add(args[10:13])
    p = tqbp.plan(k, n, xdtype)
    assert passed == {(tqbp.CORES[p.core], p.splits, p.k_chunk)}


@pytest.mark.parametrize("k,n", KNS)
def test_core_depends_on_the_dtype_alone(k, n):
    assert tqbp.plan(k, n, torch.bfloat16).core == "tc"
    assert tqbp.plan(k, n, torch.float32).core == "simt"


@pytest.mark.parametrize("k,n", KNS)
@pytest.mark.parametrize("xdtype", DTYPES)
def test_plan_covers_k_with_no_empty_split(k, n, xdtype):
    p = tqbp.plan(k, n, xdtype)
    assert p.splits >= 1
    assert p.splits * p.k_chunk >= k > (p.splits - 1) * p.k_chunk
    assert p.k_chunk % tqbp.TILES[p.core][2] == 0
    if p.splits > 1:
        assert k // p.splits >= tqbp.MIN_K_CHUNK[p.core]


@pytest.mark.parametrize("k,n,splits", [(2048, 16384, 2), (2048, 2048, 16), (16384, 2048, 16),
                                        (2048, 256, 16)])
def test_tensor_core_splits_of_the_path(k, n, splits):
    # one wave of one block per SM: gate/up's 64 column tiles in 2 K
    # slices, q/o's and down's 8 in 16, k/v's 1 in 16 (two K steps each)
    p = tqbp.plan(k, n, torch.bfloat16)
    assert p == tqbp.Plan("tc", splits, k // splits)
    blocks = math.ceil(n / tqbp.TILES["tc"][1]) * p.splits
    assert blocks <= tqbp.SMS


@pytest.mark.parametrize("k,n", KNS)
def test_simt_split_is_unchanged(k, n):
    # f32 x keeps the first port's SIMT kernel and its (K, N) split: ~264
    # blocks of 1024 columns, at least 64 k rows each, at most 64 slices
    words = -(-n // 32)
    want = max(1, min(-(-264 // -(-words // 32)), k // 64, 64))
    assert tqbp.plan(k, n, torch.float32) == tqbp.Plan("simt", want, -(-k // want))


@pytest.mark.parametrize("m,k,n", [(4, 2048, 16384), (112, 2048, 2048), (13, 1001, 1000),
                                   (5, 64, 70)])
@pytest.mark.parametrize("planes", [9, 5, 1])
@pytest.mark.parametrize("xdtype", DTYPES)
def test_wrapper_passes_the_plan_to_c_unchanged(stub, m, k, n, planes, xdtype):
    x, codes, scale = _operands(m, k, n, planes, xdtype)
    out = tqbp._launch(x, codes, scale)
    (args,) = stub.calls
    p = tqbp.plan(k, n, xdtype)
    assert args[1] == int(xdtype == torch.bfloat16) and args[3] == planes
    assert args[7:] == (m, k, n, tqbp.CORES[p.core], p.splits, p.k_chunk, 0)
    assert args[5] == out.data_ptr()
    assert (args[6] == out.data_ptr()) == (p.splits == 1)      # part: the split plane
    tc = int(p.core == "tc")
    assert (tqbp.launches, tqbp.simt_launches, tqbp.tc_launches) == (1, 1 - tc, tc)
    assert dict(tqbp.shape_launches) == {(planes, m, k, n): 1}


def test_wrapper_raises_on_a_failed_launch(monkeypatch):
    class Failing(_StubLib):
        def qmm_bitplane_launch(self, *args):
            return 1

        def qmm_bitplane_error_string(self, err):
            return b"invalid argument"

    monkeypatch.setattr(tqbp, "_lib", lambda: Failing())
    monkeypatch.setattr(tqbp, "_stream", lambda x: 0)
    monkeypatch.setattr(tqbp, "launches", 0)
    with pytest.raises(RuntimeError, match="invalid argument"):
        tqbp._launch(*_operands(4, 64, 70, 9, torch.bfloat16))
    assert tqbp.launches == 0


def test_reset_counters(monkeypatch):
    monkeypatch.setattr(tqbp, "shape_launches", type(tqbp.shape_launches)())
    tqbp.launches, tqbp.simt_launches, tqbp.tc_launches = 3, 1, 2
    tqbp.shape_launches[(9, 4, 2048, 256)] += 1
    tqbp.reset_counters()
    assert (tqbp.launches, tqbp.simt_launches, tqbp.tc_launches) == (0, 0, 0)
    assert not tqbp.shape_launches


class _StubLib:
    """Records the arguments of the C entry point and reports success."""

    def __init__(self):
        self.calls = []

    def qmm_bitplane_launch(self, *args):
        self.calls.append(args)
        return 0


@pytest.fixture
def stub(monkeypatch):
    lib = _StubLib()
    monkeypatch.setattr(tqbp, "_lib", lambda: lib)
    monkeypatch.setattr(tqbp, "_stream", lambda x: 0)
    for name in ("launches", "simt_launches", "tc_launches"):
        monkeypatch.setattr(tqbp, name, 0)
    monkeypatch.setattr(tqbp, "shape_launches", type(tqbp.shape_launches)())
    return lib


def _operands(m, k, n, planes, xdtype, device="cpu"):
    """Zero x, bitplane words and a unit scale of one product (``device``
    "meta": shapes only)."""
    return (torch.zeros(m, k, dtype=xdtype, device=device),
            torch.zeros(planes, k, -(-n // 32), dtype=torch.int32, device=device),
            torch.ones(n, device=device))
