"""The hand-written CUDA kernels of the port against their plain PyTorch
versions, on the card (marker ``gpu``; every test skips without one — a CUDA
kernel has no interpret mode). This file imports neither JAX nor the
reference, so it runs on the card's machine:

  PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_kernels_gpu.py

Tolerances: ``qmm`` rel 1e-5 of the largest output (f32 dequant, f32
accumulation order); paged attention abs 1e-5 (both f32 online softmax).
"""
import numpy as np
import pytest
import torch

from repro_torch import quant as tquant
from repro_torch.kernels import paged_attn as tpa
from repro_torch.kernels import qmm as tqmm
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
