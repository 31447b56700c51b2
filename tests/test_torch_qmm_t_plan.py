"""``qmm_t.plan`` — the one place that chooses the core and the contraction
split of the transposed dequantize-matmul (kernel B6 ``qmm_t``), and
``qmm_t.split_bf16x3``, the plain mirror of the tensor-core core's split of
g · scale into three bf16 pieces. Plain Python: these run on the CPU. The
wrapper's C call is replaced by a stub that records its arguments, so that
the test can see which core and split it passes to the kernel; operands at
full size are meta tensors (shapes without storage)."""
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels import qmm_t as tqt

EDGE = tqt.TC_THRESHOLD
MS = [1, 4, 5, 7, 8, 9, 13, 16, 32, 64, 112, 130, 256, 2048]
# the training path's (K, N): q/o, k/v, gate/up, down; the tied unembed's
# (vocab, d_model); ragged shapes of the GPU tests
KNS = [(2048, 2048), (2048, 256), (2048, 16384), (16384, 2048), (256000, 2048),
       (1001, 1000), (40, 24), (64, 48), (96, 130), (257, 256), (33, 130)]


def test_threshold_lies_between_decode_and_training_m():
    assert 1 <= EDGE < 2048


class _StubLib:
    """Records the arguments of the C entry point and reports success."""

    def __init__(self):
        self.calls = []

    def qmm_t_launch(self, *args):
        self.calls.append(args)
        return 0


@pytest.fixture
def stub(monkeypatch):
    lib = _StubLib()
    monkeypatch.setattr(tqt, "_lib", lambda: lib)
    monkeypatch.setattr(tqt, "_stream", lambda x: 0)
    for name in ("launches", "stream_launches", "tc_launches"):
        monkeypatch.setattr(tqt, name, 0)
    monkeypatch.setattr(tqt, "shape_launches", type(tqt.shape_launches)())
    return lib


def _operands(m, k, n, packed, gdtype, device="cpu"):
    """Zero g, codes and scale of one product (``device`` "meta": shapes
    only)."""
    g = torch.zeros(m, n, dtype=gdtype, device=device)
    codes = torch.zeros(k, n // 2 if packed else n,
                        dtype=torch.uint8 if packed else torch.int8, device=device)
    return g, codes, torch.ones(n, device=device)


def _plan_args(args):
    """(M, K, N, core, splits, n_chunk) of one recorded C call."""
    return args[8:14]


@pytest.mark.parametrize("m", MS)
@pytest.mark.parametrize("gdtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("packed", [False, True])
def test_core_follows_m_alone_and_reaches_c_unchanged(stub, m, gdtype, packed):
    want = "tc" if m > EDGE else "stream"
    for k, n in KNS:
        if packed and n % 2:
            continue
        p = tqt.plan(m, k, n)
        assert p.core == want
        stub.calls.clear()
        g, codes, scale = _operands(m, k, n, packed, gdtype, "meta")
        tqt._launch(g, codes, scale, packed)
        (args,) = stub.calls
        assert _plan_args(args) == (m, k, n, tqt.CORES[p.core], p.splits, p.n_chunk)
        assert args[1] == int(gdtype == torch.bfloat16) and args[3] == int(packed)


@pytest.mark.parametrize("m", MS)
def test_plan_covers_the_contraction_with_no_empty_split(m):
    for k, n in KNS:
        p = tqt.plan(m, k, n)
        assert p.splits >= 1
        assert p.splits * p.n_chunk >= n > (p.splits - 1) * p.n_chunk
        if p.core == "stream":
            assert (p.splits, p.n_chunk) == (1, n)
            continue
        bm, bk, step = tqt.TC_TILE
        assert p.n_chunk % step == 0
        if p.splits > 1:
            assert math.ceil(m / bm) * math.ceil(k / bk) < tqt.SMS
            assert n // p.splits >= tqt.MIN_N_CHUNK
            assert p.n_chunk >= tqt.MIN_N_CHUNK


@pytest.mark.parametrize("m,k,n", [(16, 2048, 2048), (64, 2048, 16384), (9, 16384, 2048),
                                   (112, 2048, 2048), (EDGE + 1, 2048, 256)])
def test_splits_fill_the_card_where_the_tiles_do_not(m, k, n):
    # a tensor-core block takes a whole SM (~193 KB of shared memory): one
    # wave, at least 90 % of the SMs busy where the contraction is long
    # enough; k/v's 256 columns give two slices of the minimum chunk
    p = tqt.plan(m, k, n)
    bm, bk, _ = tqt.TC_TILE
    blocks = math.ceil(m / bm) * math.ceil(k / bk) * p.splits
    assert blocks <= tqt.SMS, p
    if n // tqt.MIN_N_CHUNK * math.ceil(m / bm) * math.ceil(k / bk) >= tqt.SMS:
        assert blocks >= 0.9 * tqt.SMS, p
    else:
        assert p.splits == n // tqt.MIN_N_CHUNK, p


def test_training_shapes_are_not_split():
    # M = B·S = 2048: 16 × 8 tiles (q/o, k/v, gate/up; 128 of the 132 SMs)
    # or 16 × 64 (down)
    for k, n in KNS[:4]:
        assert tqt.plan(2048, k, n) == ("tc", 1, n)


def test_unembed_readouts_stream():
    for m in (1, 4):
        assert tqt.plan(m, 256000, 2048) == ("stream", 1, 2048)


@pytest.mark.parametrize("m,k,n", [(4, 256000, 2048), (1, 40, 24), (EDGE, 96, 130),
                                   (EDGE + 1, 96, 130), (130, 257, 256),
                                   (2048, 2048, 16384)])
@pytest.mark.parametrize("packed", [False, True])
def test_counters_count_the_planned_core(stub, m, k, n, packed):
    g, codes, scale = _operands(m, k, n, packed, torch.float32, "meta")
    tqt._launch(g, codes, scale, packed)
    tc = int(tqt.plan(m, k, n).core == "tc")
    assert (tqt.launches, tqt.stream_launches, tqt.tc_launches) == (1, 1 - tc, tc)
    assert dict(tqt.shape_launches) == {(packed, m, k, n): 1}


def test_split_plane_only_when_it_splits(stub):
    g = torch.zeros(16, 2048)
    codes = torch.zeros(2048, 2048, dtype=torch.int8)
    out = tqt._launch(g, codes, torch.ones(2048), False)
    (args,) = stub.calls
    assert tqt.plan(16, 2048, 2048).splits > 1
    assert args[5] == out.data_ptr() != args[6]          # out, part
    assert args[7] not in (args[5], args[6])             # the pieces of g · scale
    stub.calls.clear()
    g = torch.zeros(2048, 256)
    out = tqt._launch(g, torch.zeros(2048, 256, dtype=torch.int8), torch.ones(256), False)
    (args,) = stub.calls
    assert tqt.plan(2048, 2048, 256).splits == 1
    assert args[5] == args[6] == out.data_ptr() != args[7]


def test_reset_counters():
    tqt.launches, tqt.tc_launches, tqt.stream_launches = 3, 2, 1
    tqt.shape_launches[(False, 1, 2, 3)] += 1
    tqt.reset_counters()
    assert (tqt.launches, tqt.stream_launches, tqt.tc_launches) == (0, 0, 0)
    assert not tqt.shape_launches


def test_cpu_tensors_take_the_plain_version(stub):
    rng = np.random.default_rng(0)
    g = torch.from_numpy(rng.normal(0, 1, (5, 24)).astype(np.float32))
    codes = torch.from_numpy(rng.integers(-127, 128, (7, 24)).astype(np.int8))
    scale = torch.from_numpy(rng.uniform(0.01, 0.1, 24).astype(np.float32))
    got = tqt.qmm_t(g, codes, scale)
    assert not stub.calls and tqt.launches == 0
    torch.testing.assert_close(got, tqt.qmm_t_plain(g, codes, scale), rtol=0, atol=0)


# ------------------------------------------------------------ the split --

def _exact(v):
    hi, mid, lo = tqt.split_bf16x3(v)
    assert hi.dtype == mid.dtype == lo.dtype == torch.bfloat16
    # every partial sum is exact in f32: (hi + mid) + lo rounds nowhere
    return (hi.float() + mid.float()) + lo.float()


def _f32(bits):
    return torch.from_numpy(np.asarray(bits, dtype=np.uint32).view(np.float32).copy())


def test_split_is_exact_on_random_values():
    rng = np.random.default_rng(1)
    v = np.concatenate([rng.normal(0, 1, 100_000),
                        rng.normal(0, 1, 100_000) * 10.0 ** rng.uniform(-30, 30, 100_000)])
    v = torch.from_numpy(v.astype(np.float32))
    v = v[v.abs() >= 2.0 ** -110]
    assert v.numel() > 199_000
    assert torch.equal(_exact(v), v)


def test_split_is_exact_on_every_significand_of_some_exponents():
    # random bit patterns: all 23 mantissa bits, exponents over the range in
    # which the pieces stay normal (|v| ≥ 2^-102) up to 2^127
    rng = np.random.default_rng(2)
    mant = rng.integers(0, 1 << 23, 200_000, dtype=np.uint32)
    exp = rng.integers(127 - 102, 255, 200_000, dtype=np.uint32)
    sign = rng.integers(0, 2, 200_000, dtype=np.uint32) << 31
    v = _f32(sign | (exp << 23) | mant)
    assert torch.isfinite(v).all()
    keep = v.abs() < 3.38e38     # hi rounds past bf16's largest finite above it
    assert torch.equal(_exact(v[keep]), v[keep])


def test_split_is_exact_on_powers_of_two_and_zeros():
    p = torch.tensor([2.0 ** e for e in range(-110, 128)], dtype=torch.float32)
    v = torch.cat([p, -p, torch.tensor([0.0, -0.0])])
    assert torch.equal(_exact(v), v)
    # hi carries the sign of a zero; mid and lo are +0 (the sum of -0 is +0)
    assert torch.equal(torch.signbit(tqt.split_bf16x3(v)[0]), torch.signbit(v))
    hi, mid, lo = tqt.split_bf16x3(p)
    assert torch.equal(hi.float(), p) and not mid.float().any() and not lo.float().any()


def test_split_is_exact_near_bf16_rounding_ties():
    # bf16 keeps the top 16 bits of an f32: a low half of 0x8000 is a tie
    # (to even), 0x7fff / 0x8001 lie one f32 ulp either side of it
    # (the exponents from 2^-102 up; 0x7F7E and below stay finite in bf16);
    # low halves of 0x?080 put the residual after hi at a tie of mid
    rng = np.random.default_rng(3)
    high = rng.integers(0x0C80, 0x7F7F, 50_000, dtype=np.uint32) << 16
    for low in (0x7FFF, 0x8000, 0x8001, 0x0000, 0xFFFF, 0x0001, 0x0080, 0x8080, 0x7F80):
        v = _f32(high | np.uint32(low))
        assert torch.equal(_exact(v), v)
        assert torch.equal(_exact(-v), -v)


def test_split_of_subnormals_loses_at_most_half_of_bf16s_least_step():
    # f32 subnormals (and normals below 2^-110) carry bits under bf16's
    # smallest subnormal, 2^-133: those on its grid split exactly, the rest
    # lose less than 2^-133 (exact below the grid's half step: 0)
    rng = np.random.default_rng(4)
    sub = _f32(rng.integers(1, 1 << 23, 100_000, dtype=np.uint32))
    tiny = _f32(rng.integers(1 << 23, 17 << 23, 100_000, dtype=np.uint32))  # 2^-126..2^-110
    for v in (sub, tiny, -sub):
        err = (_exact(v).double() - v.double()).abs()
        assert (err <= 2.0 ** -134).all()
    on_grid = _f32((rng.integers(1, 1 << 7, 10_000, dtype=np.uint32) << 16))
    assert torch.equal(_exact(on_grid), on_grid)
    assert torch.equal(_exact(-on_grid), -on_grid)
