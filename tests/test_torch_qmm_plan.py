"""``qmm.plan`` — the one place that chooses the core and the K splits of
the dequantize-matmul product (kernels B5 ``qmm`` and B7 ``qmm_qout``).
Plain Python: these run on the CPU. The wrappers' C calls are replaced by a
stub that records their arguments, so that the test can see which core and
split each wrapper passes to the kernel; operands at full size are meta
tensors (shapes without storage)."""
import math

import pytest
import torch

from repro_torch.kernels import qmm as tqmm
from repro_torch.kernels import qmm_qout as tqout

EDGE = tqmm.TC_THRESHOLD
MS = [1, 4, 8, 16, EDGE, EDGE + 1, 64, 112, 128, 2048, 4092, 4096]
# gemma-2b's q/o, k/v, gate/up, down; mamba2-780m's in_proj and out_proj;
# ragged shapes of the GPU tests
KNS = [(2048, 2048), (2048, 256), (2048, 16384), (16384, 2048), (1536, 6448),
       (3072, 1536), (1001, 1000), (96, 130), (40, 24)]


def test_threshold_lies_below_the_gemma_prefill_buckets():
    assert 1 <= EDGE < 112


def _cores_passed(stub, m, packed, xdtype):
    """The core id that each wrapper passes to its C entry point, for every
    (K, N) of ``KNS`` at ``m`` rows."""
    ids = set()
    for k, n in KNS:
        stub.calls.clear()
        x, codes, scale, rand = _operands(m, k, n, packed, xdtype, "meta")
        tqmm._launch(x, codes, scale, packed)
        tqout._launch(x, codes, scale, rand, 127, packed, torch.bfloat16)
        ids |= {_plan_args(name, args)[3] for name, args in stub.calls}
    return ids


@pytest.mark.parametrize("m", MS)
@pytest.mark.parametrize("packed", [False, True])
def test_f32_x_takes_the_simt_core_at_every_m(stub, m, packed):
    for k, n in KNS:
        assert tqmm.plan(m, k, n, torch.float32).core == "simt"
    assert _cores_passed(stub, m, packed, torch.float32) == {tqmm.CORES["simt"]}


@pytest.mark.parametrize("m", MS)
@pytest.mark.parametrize("packed", [False, True])
def test_bf16_x_takes_the_tensor_cores_above_the_threshold_only(stub, m, packed):
    want = "tc" if m > EDGE else "simt"
    for k, n in KNS:
        assert tqmm.plan(m, k, n, torch.bfloat16).core == want
    assert _cores_passed(stub, m, packed, torch.bfloat16) == {tqmm.CORES[want]}


@pytest.mark.parametrize("m", MS)
@pytest.mark.parametrize("xdtype", [torch.float32, torch.bfloat16])
def test_plan_covers_the_operands_with_no_empty_split(m, xdtype):
    for k, n in KNS:
        p = tqmm.plan(m, k, n, xdtype)
        assert p.splits >= 1
        assert p.splits * p.k_chunk >= k > (p.splits - 1) * p.k_chunk
        bm, bn, step = tqmm.TILES[p.core]
        assert p.k_chunk % step == 0
        if p.splits > 1:
            assert math.ceil(m / bm) * math.ceil(n / bn) < tqmm.SMS
            assert k // p.splits >= tqmm.MIN_K_CHUNK[p.core]


@pytest.mark.parametrize("m,k,n", [(2048, 2048, 256), (112, 2048, 2048),
                                   (112, 2048, 16384), (EDGE + 1, 2048, 2048),
                                   (4, 2048, 16384), (4, 16384, 2048), (4, 1536, 6448)])
@pytest.mark.parametrize("xdtype", [torch.float32, torch.bfloat16])
def test_splits_fill_the_card_where_the_tiles_do_not(m, k, n, xdtype):
    # the main paths' shapes whose (M, N) tiles alone put fewer blocks than
    # SMs on the card: M 2048 × N 256 gives 16 tensor-core tiles, M 112 ×
    # N 2048 gives 8; every decode shape. A SIMT block is small (two and
    # more fit an SM): at least one per SM. A tensor-core block takes a
    # whole SM (193 KB of shared memory): one wave, at least 90 % of the
    # SMs busy (K splits in multiples of the 64-row K step)
    p = tqmm.plan(m, k, n, xdtype)
    bm, bn, _ = tqmm.TILES[p.core]
    blocks = math.ceil(m / bm) * math.ceil(n / bn) * p.splits
    if p.core == "simt":
        assert blocks >= tqmm.SMS, p
    else:
        assert 0.9 * tqmm.SMS <= blocks <= tqmm.SMS, p


def test_tiles_that_fill_the_card_are_not_split():
    assert tqmm.plan(2048, 2048, 16384, torch.bfloat16).splits == 1
    assert tqmm.plan(4096, 1536, 6448, torch.bfloat16).splits == 1
    assert tqmm.plan(4096, 3072, 1536, torch.bfloat16).splits == 1
    assert tqmm.plan(2048, 16384, 2048, torch.float32).splits == 1
    # the down projection: 128 tensor-core tiles, one wave, no split
    assert tqmm.plan(2048, 16384, 2048, torch.bfloat16).splits == 1


class _StubLib:
    """Records the arguments of the C entry points and reports success."""

    def __init__(self):
        self.calls = []

    def qmm_launch(self, *args):
        self.calls.append(("qmm", args))
        return 0

    def qmm_qout_launch(self, *args):
        self.calls.append(("qmm_qout", args))
        return 0


@pytest.fixture
def stub(monkeypatch):
    lib = _StubLib()
    monkeypatch.setattr(tqmm, "_lib", lambda: lib)
    monkeypatch.setattr(tqout, "_lib", lambda: lib)
    monkeypatch.setattr(tqmm, "_stream", lambda x: 0)
    monkeypatch.setattr(tqout, "_stream", lambda x: 0)
    for mod in (tqmm, tqout):
        for name in ("launches", "simt_launches", "tc_launches"):
            monkeypatch.setattr(mod, name, 0)
        monkeypatch.setattr(mod, "shape_launches", type(mod.shape_launches)())
    return lib


def _plan_args(name, args):
    """(M, K, N, core, splits, k_chunk) of one recorded C call."""
    first = 7 if name == "qmm" else 10
    return args[first:first + 6]


def _operands(m, k, n, packed, xdtype, device="cpu"):
    """Zero x, codes, scale and rand of one product (``device`` "meta":
    shapes only)."""
    x = torch.zeros(m, k, dtype=xdtype, device=device)
    codes = torch.zeros(k, n // 2 if packed else n,
                        dtype=torch.uint8 if packed else torch.int8, device=device)
    return (x, codes, torch.ones(n, device=device),
            torch.zeros(m, n, dtype=torch.int32, device=device))


@pytest.mark.parametrize("m,k,n", [(4, 2048, 256), (EDGE, 512, 384), (EDGE + 1, 512, 384),
                                   (112, 2048, 2048), (130, 1001, 1000),
                                   (2048, 2048, 256)])
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("xdtype", [torch.float32, torch.bfloat16])
def test_qmm_qout_asks_plan_for_qmm_s_core_and_splits(stub, m, k, n, packed, xdtype):
    x, codes, scale, rand = _operands(m, k, n, packed, xdtype)
    tqmm._launch(x, codes, scale, packed)
    tqout._launch(x, codes, scale, rand, 127, packed, torch.bfloat16)
    (qname, qargs), (oname, oargs) = stub.calls
    assert (qname, oname) == ("qmm", "qmm_qout")
    p = tqmm.plan(m, k, n, xdtype)
    want = (m, k, n, tqmm.CORES[p.core], p.splits, p.k_chunk)
    assert _plan_args(qname, qargs) == _plan_args(oname, oargs) == want
    tc = int(p.core == "tc")
    for mod in (tqmm, tqout):
        assert (mod.launches, mod.simt_launches, mod.tc_launches) == (1, 1 - tc, tc)
        assert dict(mod.shape_launches) == {(packed, m, k, n): 1}


def test_qmm_passes_a_split_plane_only_when_it_splits(stub):
    x = torch.zeros(4, 2048, dtype=torch.bfloat16)
    codes = torch.zeros(2048, 16384, dtype=torch.int8)
    out = tqmm._launch(x, codes, torch.ones(16384), False)
    (_, args), = stub.calls
    assert args[5] == out.data_ptr() != args[6]          # out, part
    stub.calls.clear()
    x = torch.zeros(2048, 2048, dtype=torch.bfloat16)
    out = tqmm._launch(x, torch.zeros(2048, 2048, dtype=torch.int8),
                       torch.ones(2048), False)
    (_, args), = stub.calls
    assert args[5] == args[6] == out.data_ptr()


def test_reset_counters():
    tqmm.launches, tqmm.tc_launches = 3, 2
    tqmm.shape_launches[(False, 1, 2, 3)] += 1
    tqmm.reset_counters()
    assert (tqmm.launches, tqmm.simt_launches, tqmm.tc_launches) == (0, 0, 0)
    assert not tqmm.shape_launches
    tqout.tc_launches = 1
    tqout.reset_counters()
    assert tqout.tc_launches == 0
