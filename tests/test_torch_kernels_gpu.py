"""The hand-written CUDA kernels of the port against their plain PyTorch
versions, on the card (marker ``gpu``; every test skips without one — a CUDA
kernel has no interpret mode). This file imports neither JAX nor the
reference, so it runs on the card's machine:

  PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_kernels_gpu.py

Tolerances: ``qmm`` and ``qmv`` rel 1e-5 of the largest output (f32
dequant, f32 accumulation order); paged attention abs 1e-5 (both f32 online
softmax); ``ds_quant`` bit-exact (same rand, IEEE division, no FMA
contraction); ``train_linear`` per-epoch losses rel 1e-5 between the card
and the CPU's plain path (same keys, same codes; sums in another order).
"""
import numpy as np
import pytest
import torch

from repro_torch import quant as tquant
from repro_torch import prng
from repro_torch.kernels import paged_attn as tpa
from repro_torch.kernels import qmm as tqmm
from repro_torch.kernels import qmv as tqmv
from repro_torch.kernels import stoch_quant as tsq
from repro_torch.serve import pages as tpg

QMM_SHAPES = [(1, 40, 24), (5, 64, 48), (13, 96, 130), (4, 130, 256),
              (4, 2048, 256), (128, 2048, 2048)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernel; no interpret mode)")
    return torch.device("cuda")


def _weights(k, n, bits, packed, seed=0):
    w = np.random.default_rng(seed).normal(0, 0.05, (k, n)).astype(np.float32)
    return tquant.encode(torch.from_numpy(w), tquant.QScheme.int_symmetric(
        bits, scaling="channel", rounding="nearest", packed=packed))


def _pool(kv_bits, g, n_pages=12, page=8, d=16, seed=0):
    kv = torch.from_numpy(np.random.default_rng(seed).normal(
        0, 1, (2, n_pages, page, g, d)).astype(np.float32))
    kc, ks = tpg.quant_rows(kv[0], kv_bits)
    vc, vs = tpg.quant_rows(kv[1], kv_bits)
    return kc, vc, ks, vs


def _case(seed=0, b=4, h=4, d=16, maxp=4, n_pages=12):
    rng = np.random.default_rng(seed)
    q = rng.normal(0, 1, (b, h, d)).astype(np.float32)
    lens = np.asarray([17, 3, 16, 0][:b], np.int32)   # 16 = a page boundary
    bt = rng.integers(1, n_pages, (b, maxp)).astype(np.int32)
    return q, lens, bt


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n", QMM_SHAPES)
@pytest.mark.parametrize("bits,packed", [(8, False), (4, True)])
@pytest.mark.parametrize("xdtype", [torch.float32, torch.bfloat16])
def test_qmm_kernel_matches_plain(cuda, m, k, n, bits, packed, xdtype):
    tq = _weights(k, n, bits, packed)
    x = torch.randn(m, k, generator=torch.Generator().manual_seed(0)).to(xdtype)
    codes, scale = tq.codes.to(cuda), tq.scale.to(cuda)
    before = tqmm.launches
    got = tqmm.qmm(x.to(cuda), codes, scale, packed=packed)
    torch.cuda.synchronize()
    assert tqmm.launches == before + 1
    want = tqmm.qmm_plain(x.to(cuda), codes, scale, packed=packed)
    scale_ = want.abs().max().item()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * scale_)


@pytest.mark.gpu
@pytest.mark.parametrize("kv_bits", [0, 8, 4])
@pytest.mark.parametrize("g", [1, 2])
def test_paged_attn_kernel_matches_plain(cuda, kv_bits, g):
    targs = _pool(kv_bits, g)
    q, lens, bt = _case(seed=2)
    dev = [None if t is None else t.to(cuda) for t in targs]
    args = (torch.from_numpy(q).to(cuda), *dev, torch.from_numpy(bt).to(cuda),
            torch.from_numpy(lens).to(cuda))
    before = tpa.launches
    got = tpa.paged_decode_attn(*args, softmax_scale=0.25, kv_bits=kv_bits)
    torch.cuda.synchronize()
    assert tpa.launches == before + 1
    want = tpa.paged_decode_attn_plain(*args, softmax_scale=0.25, kv_bits=kv_bits)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


DS_SHAPES = [(16, 5000), (13, 1001), (64, 384), (1, 7)]


@pytest.mark.gpu
@pytest.mark.parametrize("r,c", DS_SHAPES)
@pytest.mark.parametrize("s", [1, 3, 63, 127])
@pytest.mark.parametrize("axis", ["row", "col"])
@pytest.mark.parametrize("xdtype", [torch.float32, torch.bfloat16])
def test_ds_quant_kernel_bit_exact(cuda, r, c, s, axis, xdtype):
    rng = np.random.default_rng(r * c + s)
    x = torch.from_numpy(rng.normal(0, 2, (r, c)).astype(np.float32)).to(xdtype)
    x[0, 0] = 0.0
    a = x.to(torch.float32).abs()
    scale = a.amax(1, keepdim=True) if axis == "row" else a.amax(0, keepdim=True) * 0.9
    rand = prng.bits(prng.PRNGKey(s), (r, c)).to(torch.int32)
    xd, rd, sd = x.to(cuda), rand.to(cuda), scale.to(cuda)
    before = tsq.launches
    got = tsq.ds_quant(xd, rd, sd, s=s, scale_axis=axis)
    torch.cuda.synchronize()
    assert tsq.launches == before + 1
    want = tsq.ds_quant_plain(xd, rd, sd, s=s)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    cpu = tsq.ds_quant(x, rand, scale, s=s, scale_axis=axis)
    for g, w in zip(got, cpu):
        assert torch.equal(g.cpu(), w)


@pytest.mark.gpu
def test_ds_quant_kernel_rejects_wide_s_and_int64_rand(cuda):
    x = torch.ones(4, 8, device=cuda)
    scale = torch.ones(4, 1, device=cuda)
    with pytest.raises(ValueError):
        tsq.ds_quant(x, torch.zeros(4, 8, dtype=torch.int32, device=cuda), scale, s=255)
    with pytest.raises(TypeError):
        tsq.ds_quant(x, torch.zeros(4, 8, dtype=torch.int64, device=cuda), scale, s=7)


QMV_CASES = [((16, 5000), False), ((16, 5000), True), ((1024, 2048), False),
             ((1024, 2048), True), ((13, 1001), False), ((13, 1001), True),
             ((1, 5), False), ((3, 1), True)]


@pytest.mark.gpu
@pytest.mark.parametrize("shape,transposed", QMV_CASES)
def test_qmv_kernel_matches_plain(cuda, shape, transposed):
    rng = np.random.default_rng(shape[0] + shape[1])
    plane = torch.from_numpy(rng.integers(-127, 128, shape).astype(np.int8)).to(cuda)
    codes = plane.T if transposed else plane            # a view, never copied
    v = torch.from_numpy(rng.normal(0, 1, codes.shape[1]).astype(np.float32)).to(cuda)
    before = tqmv.launches
    got = tqmv.qmv(codes, v)
    torch.cuda.synchronize()
    assert tqmv.launches == before + 1
    want = tqmv.qmv_plain(codes, v)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * want.abs().max().item())
    again = tqmv.qmv(codes, v)
    assert torch.equal(got, again)                      # fixed reduction order


@pytest.mark.gpu
def test_qmv_kernel_strided_views(cuda):
    plane = torch.randint(-127, 128, (40, 600), dtype=torch.int8, device=cuda)
    # every other column, its transpose, and an unaligned offset view
    for codes in (plane[:, ::3], plane[:, ::3].T, plane[1:, 2:]):
        v = torch.randn(codes.shape[1], device=cuda)
        want = tqmv.qmv_plain(codes, v)
        torch.testing.assert_close(tqmv.qmv(codes, v), want, rtol=1e-5,
                                   atol=1e-5 * want.abs().max().item())


@pytest.mark.gpu
def test_train_linear_card_matches_cpu_plain_path(cuda):
    from repro_torch.core.linear import make_dataset, train_linear
    from repro_torch.quant import PrecisionPlan

    ds = make_dataset("synthetic100", n_train=256, n_test=64)
    plan = PrecisionPlan("e2e", sample_bits=6, model_bits=8, grad_bits=8)
    before = (tsq.launches, tqmv.launches)
    card = train_linear(ds, plan, model="lssvm", epochs=2, lr=0.3, device=cuda)
    assert tsq.launches - before[0] == 32 and tqmv.launches - before[1] == 128
    cpu = train_linear(ds, PrecisionPlan("e2e", sample_bits=6, model_bits=8, grad_bits=8,
                                         backend="cuda"),
                       model="lssvm", epochs=2, lr=0.3, device="cpu")
    np.testing.assert_allclose(card.losses, cpu.losses, rtol=1e-5)
