"""The hand-written CUDA kernels of the port against their plain PyTorch
versions, on the card (marker ``gpu``; every test skips without one — a CUDA
kernel has no interpret mode). This file imports neither JAX nor the
reference, so it runs on the card's machine:

  PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_kernels_gpu.py

Tolerances: ``qmm`` and ``qmv`` rel 1e-5 of the largest output (f32
accumulation order; ``qmm`` with bf16 x above ``qmm.TC_THRESHOLD`` rows
multiplies on the tensor cores, exactly, as bf16 holds every code, and
checks that core ran); paged attention abs 1e-5 (both f32 online
softmax); ``ds_quant`` bit-exact (same rand, IEEE division, no FMA
contraction); ``train_linear`` per-epoch losses rel 1e-5 between the card
and the CPU's plain path (same keys, same codes; sums in another order);
``row_absmax`` and ``stoch_quant`` bit-exact (a max is exact in any
order; the rounding as ``ds_quant``'s); ``qmm_t`` rel 1e-5 of the largest
output; ``quant_adamw`` the reference's
contract (masters rtol 2e-6 / atol 2e-6, scales rtol 1e-6, ≥ 99.9 % of
codes equal, off by at most one level); the reduced training step on the
card against the CPU's plain path: losses rtol 1e-4; ``qmm_bitplane`` rel
1e-5 of the largest output, and bit-equal rows at every M; the reduced
bitplane engines (plain, sliced, speculative) on the card against the CPU's
plain path: greedy tokens equal; ``qmm_qout`` bit-exact (both planes, the
row scales) against the unfused pipeline on the card (``qmm`` kernel → cast
→ ``ds_row_pair_ref``, the same rand plane: the kernel shares ``qmm``'s
product), and against its plain version (f32 sums in another order) codes
that differ only where the two y differ after the cast or the row scales
differ, on at most 1e-4 of the elements, and against the pair encoded from
the f64 product within 1e-4 of the codes or no farther than the plain
version; the reduced model with quantized
embedding tables served on the card against the CPU's plain path: greedy
tokens equal; ``ssd_chunk_scan`` 1e-4 (rtol and atol) at f32 and 2e-2 at
bf16 against its plain version, the reference's tolerances for its Pallas
kernel (f32 sums in another order; at bf16 y rounds once more), its state
1e-4 at both (bf16 x, B and C are exact operands of the tensor cores, and
their f32 operands split exactly into three bf16 pieces), the same against
the tensor cores' order in torch, and two calls bit-equal; and the
reduced mamba2-780m served on the card against the CPU's plain path:
greedy tokens equal.
"""
import numpy as np
import pytest
import torch

from repro_torch import quant as tquant
from repro_torch import prng
from repro_torch.kernels import paged_attn as tpa
from repro_torch.kernels import qmm as tqmm
from repro_torch.kernels import ops as tops
from repro_torch.kernels import qmm_qout as tqout
from repro_torch.kernels import qmm_t as tqmm_t
from repro_torch.kernels import ref as tref
from repro_torch.kernels import quant_adamw as tqa
from repro_torch.kernels import qmv as tqmv
from repro_torch.kernels import ssd as tssd
from repro_torch.kernels import stoch_quant as tsq
from repro_torch.serve import pages as tpg
from repro_torch.quant.qtensor import unpack_int4

EDGE = tqmm.TC_THRESHOLD
# ragged and small shapes; both sides of plan's threshold (bf16 x takes the
# tensor cores above it) and M 16; the gemma prefill's gate/up at M 112,
# mamba2's in_proj at the consistency check's M 4092 (N 6448: no multiple
# of 128; packed rows of 3224 bytes: no multiple of 16); a ragged K on the
# tensor cores
QMM_SHAPES = [(1, 40, 24), (5, 64, 48), (13, 96, 130), (4, 130, 256),
              (4, 2048, 256), (128, 2048, 2048), (16, 2048, 2048), (EDGE, 2048, 2048),
              (EDGE + 1, 2048, 2048), (112, 2048, 16384), (4092, 1536, 6448),
              (130, 1001, 1000), (33, 96, 130)]


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
    before = (tqmm.launches, tqmm.simt_launches, tqmm.tc_launches)
    got = tqmm.qmm(x.to(cuda), codes, scale, packed=packed)
    torch.cuda.synchronize()
    tc = int(xdtype == torch.bfloat16 and m > EDGE)
    assert (tqmm.launches, tqmm.simt_launches, tqmm.tc_launches) == (
        before[0] + 1, before[1] + 1 - tc, before[2] + tc)
    want = tqmm.qmm_plain(x.to(cuda), codes, scale, packed=packed)
    scale_ = want.abs().max().item()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * scale_)


def _offset_view(t, offset):
    """``t``'s bytes copied into a contiguous view whose base lies ``offset``
    bytes past a 256-byte-aligned allocation."""
    buf = torch.empty(t.numel() + 64, dtype=t.dtype, device=t.device)
    view = buf[offset:offset + t.numel()].view(t.shape)
    view.copy_(t)
    return view


@pytest.mark.gpu
@pytest.mark.parametrize("m", [4, EDGE + 1, 130])
@pytest.mark.parametrize("bits,packed", [(8, False), (4, True)])
def test_qmm_kernel_reads_unaligned_code_views(cuda, m, bits, packed):
    # a code plane whose base is 4 mod 16 (4-byte loads, not 16) and one
    # that is 1 mod 16 (byte loads), read in place on either core
    tq = _weights(96, 320, bits, packed, seed=3)
    x = torch.randn(m, 96, generator=torch.Generator().manual_seed(1)).to(
        cuda, torch.bfloat16)
    want = tqmm.qmm_plain(x, tq.codes.to(cuda), tq.scale.to(cuda), packed=packed)
    for offset in (4, 1):
        codes = _offset_view(tq.codes.to(cuda), offset)
        assert codes.data_ptr() % 16 == offset
        tc0 = tqmm.tc_launches
        got = tqmm.qmm(x, codes, tq.scale.to(cuda), packed=packed)
        torch.cuda.synchronize()
        assert tqmm.tc_launches - tc0 == int(m > EDGE)
        torch.testing.assert_close(got, want, rtol=1e-5,
                                   atol=1e-5 * want.abs().max().item())


@pytest.mark.gpu
def test_qmm_kernel_reads_unaligned_x_rows(cuda):
    # K 1001: bf16 rows of 2002 bytes, so the tensor-core core copies x in
    # 2-byte pieces; a base 8 bytes past alignment takes 8-byte pieces
    for k, x_off in ((1001, 0), (96, 4)):
        tq = _weights(k, 256, 8, False, seed=4)
        x = torch.randn(130, k, generator=torch.Generator().manual_seed(2)).to(
            cuda, torch.bfloat16)
        x = _offset_view(x, x_off)
        assert x.data_ptr() % 16 == 2 * x_off
        codes, scale = tq.codes.to(cuda), tq.scale.to(cuda)
        got = tqmm.qmm(x, codes, scale)
        want = tqmm.qmm_plain(x, codes, scale)
        torch.testing.assert_close(got, want, rtol=1e-5,
                                   atol=1e-5 * want.abs().max().item())


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


# (H, Hkv, D): gemma-2b's MQA, gemma-7b's MHA, granite-3-8b's GQA and the
# small pools above
ATTN_LAYOUTS = [(8, 1, 256), (16, 16, 256), (32, 8, 128), (4, 1, 16), (4, 2, 16)]


def _attn_lens(page):
    """Lengths at every edge of a page and of a split, and a long row."""
    split = tpa._lib().pages_per_split * page
    return [0, 1, page - 1, page, page + 1, split, split + 1, 1003]


def _attn_inputs(dev, kv_bits, h, hkv, d, page, lens, qdtype, *, seed=0, extra_cols=0):
    """q (B, H, D) and a pool holding each row's pages (distinct, shuffled),
    with block-table columns past a row's pages pointing at other pages."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    need = [-(-n // page) for n in lens]
    maxp = max(need) + extra_cols
    n_pages = sum(need) + 1
    kv = torch.randn(2, n_pages, page, hkv, d, generator=gen, device=dev)
    kc, ks = tpg.quant_rows(kv[0], kv_bits)
    vc, vs = tpg.quant_rows(kv[1], kv_bits)
    perm = torch.randperm(n_pages - 1, generator=gen, device=dev) + 1
    bt = torch.randint(0, n_pages, (len(lens), maxp), generator=gen, device=dev)
    start = 0
    for i, n in enumerate(need):
        bt[i, :n] = perm[start:start + n]
        start += n
    q = torch.randn(len(lens), h, d, generator=gen, device=dev).to(qdtype)
    lens_t = torch.tensor(lens, dtype=torch.int32, device=dev)
    return q, kc, vc, ks, vs, bt.to(torch.int32), lens_t


@pytest.mark.gpu
@pytest.mark.parametrize("h,hkv,d", ATTN_LAYOUTS)
@pytest.mark.parametrize("page", [8, 16])
@pytest.mark.parametrize("qdtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("kv_bits", [0, 8, 4])
def test_paged_attn_split_kernel_matches_plain(cuda, h, hkv, d, page, qdtype, kv_bits):
    args = _attn_inputs(cuda, kv_bits, h, hkv, d, page, _attn_lens(page), qdtype)
    kw = dict(softmax_scale=d ** -0.5, kv_bits=kv_bits)
    before = tpa.launches
    got = tpa.paged_decode_attn(*args, **kw)
    torch.cuda.synchronize()
    assert tpa.launches == before + 1
    want = tpa.paged_decode_attn_plain(*args, **kw)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    assert torch.equal(got[0], torch.zeros_like(got[0]))


@pytest.mark.gpu
@pytest.mark.parametrize("qdtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("kv_bits", [0, 8, 4])
def test_paged_attn_rows_do_not_depend_on_the_call(cuda, qdtype, kv_bits):
    """A row's bits depend on its own length alone: alone (B 1, its own
    block-table columns), in a B 4 call and inside a B 16 call with a wider
    block table and other rows around it — as in a decode step and in the
    verify window, whose rows must agree."""
    lens = [160, 97, 33, 1003]
    for h, hkv, d in ATTN_LAYOUTS[:3]:
        kw = dict(softmax_scale=d ** -0.5, kv_bits=kv_bits)
        q, kc, vc, ks, vs, bt, lens_t = _attn_inputs(cuda, kv_bits, h, hkv, d, 16, lens, qdtype)
        got = tpa.paged_decode_attn(q, kc, vc, ks, vs, bt, lens_t, **kw)
        for i, n in enumerate(lens):
            cols = -(-n // 16)
            alone = tpa.paged_decode_attn(q[i:i + 1], kc, vc, ks, vs, bt[i:i + 1, :cols],
                                          lens_t[i:i + 1], **kw)
            assert torch.equal(alone[0], got[i]), (h, hkv, d, n)
        # B 16: the four rows at 3, 7, 11, 15 among twelve others, 40 more columns
        other = [0, 1, 17, 2000, 15, 300, 64, 5, 1, 96, 1500, 33]
        wide = [*other[:3], lens[0], *other[3:6], lens[1], *other[6:9], lens[2],
                *other[9:], lens[3]]
        q2, _, _, _, _, bt2, lens2 = _attn_inputs(cuda, kv_bits, h, hkv, d, 16, wide, qdtype,
                                                  seed=5, extra_cols=40)
        at = [3, 7, 11, 15]
        q2[at] = q
        bt2[at] = 0
        bt2[at, :bt.shape[1]] = bt
        # the other rows' pages must lie in this pool: fold them into it
        bt2 = torch.where(bt2 >= kc.shape[0], bt2 % kc.shape[0], bt2)
        got16 = tpa.paged_decode_attn(q2, kc, vc, ks, vs, bt2, lens2, **kw)
        for j, i in enumerate(at):
            assert torch.equal(got16[i], got[j]), (h, hkv, d, lens[j])


@pytest.mark.gpu
def test_paged_attn_back_to_back_calls_are_deterministic(cuda):
    """50 calls alternating between a B 4 decode-like call and a B 16 call
    with long rows: each kind gives the same bits every time (the arrival
    counters are back at 0 after every call), one launch each."""
    kw = dict(softmax_scale=256 ** -0.5, kv_bits=8)
    small = _attn_inputs(cuda, 8, 8, 1, 256, 16, [160, 97, 33, 1], torch.bfloat16)
    big = _attn_inputs(cuda, 8, 8, 1, 256, 16,
                       [4096, 1500, 257, 0, 1, 16, 33, 2048, 700, 5, 90, 3000, 17, 64, 128, 1],
                       torch.bfloat16, seed=3)
    before = tpa.launches
    first = {}
    for i in range(50):
        name, args = ("small", small) if i % 2 else ("big", big)
        out = tpa.paged_decode_attn(*args, **kw)
        if name in first:
            assert torch.equal(out, first[name]), i
        else:
            first[name] = out
    torch.cuda.synchronize()
    assert tpa.launches == before + 50
    for name, args in (("small", small), ("big", big)):
        torch.testing.assert_close(first[name], tpa.paged_decode_attn_plain(*args, **kw),
                                   rtol=0, atol=1e-5)
    stream = torch.cuda.current_stream(cuda).cuda_stream
    _, counters = tpa._WORKSPACE[(small[0].device, stream)]
    assert not counters.any()


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


SQ_SHAPES = [(16, 5000), (13, 1001), (64, 384), (1, 7), (7, 3), (5, 1)]


@pytest.mark.gpu
@pytest.mark.parametrize("r,c", SQ_SHAPES)
@pytest.mark.parametrize("xdtype", [torch.float32, torch.bfloat16])
def test_row_absmax_kernel_bit_exact(cuda, r, c, xdtype):
    rng = np.random.default_rng(r * c)
    x = torch.from_numpy(rng.normal(0, 2, (r, c)).astype(np.float32)).to(xdtype)
    x[0] = 0.0                                   # an all-zero row
    x[-1, -1] = -0.0
    xd = x.to(cuda)
    before = tsq.row_absmax_launches
    got = tsq.row_absmax(xd)
    torch.cuda.synchronize()
    assert tsq.row_absmax_launches == before + 1
    assert got.shape == (r, 1) and got.dtype == torch.float32
    assert torch.equal(got, tsq.row_absmax_plain(xd))
    assert torch.equal(got.cpu(), tsq.row_absmax(x))
    assert not torch.signbit(got).any()          # |−0| is +0


@pytest.mark.gpu
@pytest.mark.parametrize("xdtype", [torch.float32, torch.bfloat16])
def test_row_absmax_kernel_propagates_nan(cuda, xdtype):
    x = torch.randn(6, 1001, device=cuda).to(xdtype)
    for j in (0, 500, 1000):                     # head, vector body, tail
        y = x.clone()
        y[3, j] = float("nan")
        got = tsq.row_absmax(y)
        want = tsq.row_absmax_plain(y)
        assert torch.isnan(got[3, 0]) and torch.isnan(want[3, 0])
        keep = torch.arange(6, device=cuda) != 3
        assert torch.equal(got[keep], want[keep])


@pytest.mark.gpu
def test_row_absmax_kernel_unaligned_view(cuda):
    base = torch.randn(9, 1003, device=cuda)
    for x in (base[1:, 1:], base[:, 3:], base[2:7]):
        assert torch.equal(tsq.row_absmax(x), tsq.row_absmax_plain(x))


@pytest.mark.gpu
@pytest.mark.parametrize("r,c", SQ_SHAPES)
@pytest.mark.parametrize("s", [1, 3, 15, 127])
@pytest.mark.parametrize("xdtype", [torch.float32, torch.bfloat16])
def test_stoch_quant_kernel_bit_exact(cuda, r, c, s, xdtype):
    rng = np.random.default_rng(r * c + s)
    x = torch.from_numpy(rng.normal(0, 2, (r, c)).astype(np.float32)).to(xdtype)
    x[0] = 0.0                                   # an all-zero row: scale 0
    rand = prng.bits(prng.PRNGKey(s), (r, c)).to(torch.int32)
    scale = tsq.row_absmax_plain(x)
    xd, rd, sd = x.to(cuda), rand.to(cuda), scale.to(cuda)
    before = tsq.stoch_quant_launches
    got = tsq.stoch_quant(xd, rd, sd, s=s)
    torch.cuda.synchronize()
    assert tsq.stoch_quant_launches == before + 1
    assert torch.equal(got, tsq.stoch_quant_plain(xd, rd, sd, s=s))
    assert torch.equal(got.cpu(), tsq.stoch_quant(x, rand, scale, s=s))
    assert int(got.abs().max()) <= s


@pytest.mark.gpu
def test_stoch_quant_kernel_unaligned_views(cuda):
    x = torch.randn(10, 1001, device=cuda)
    rand = prng.bits(prng.PRNGKey(2), (10, 1001), device=cuda).to(torch.int32)
    for sl in (slice(1, None), slice(3, 8)):
        xs, rs = x[sl], rand[sl]                 # contiguous, offset rows
        sc = tsq.row_absmax_plain(xs)
        assert torch.equal(tsq.stoch_quant(xs, rs, sc, s=15),
                           tsq.stoch_quant_plain(xs, rs, sc, s=15))


@pytest.mark.gpu
def test_stoch_quant_kernel_rejects_bad_operands(cuda):
    x = torch.ones(4, 8, device=cuda)
    scale = torch.ones(4, 1, device=cuda)
    rand = torch.zeros(4, 8, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        tsq.stoch_quant(x, rand, scale, s=128)
    with pytest.raises(TypeError):
        tsq.stoch_quant(x, rand.to(torch.int64), scale, s=7)
    with pytest.raises(ValueError):
        tsq.stoch_quant(x, rand, torch.ones(1, 8, device=cuda), s=7)


@pytest.mark.gpu
@pytest.mark.parametrize("xdtype", [torch.float32, torch.bfloat16])
def test_quantizers_give_zero_codes_on_nan(cuda, xdtype):
    """A row holding a NaN has a NaN scale (row_absmax), and a NaN x or scale
    gives code 0 in stoch_quant and ds_quant, kernel and plain version
    alike (the reference's cast of NaN to int8 gives 0)."""
    x = torch.randn(6, 1001, device=cuda).to(xdtype)
    x[3, 500] = float("nan")                     # row 3: NaN scale
    x[4, 7] = float("nan")                       # row 4: one NaN under a finite scale
    rand = prng.bits(prng.PRNGKey(8), (6, 1001), device=cuda).to(torch.int32)
    scale = tsq.row_absmax(x)
    scale[4] = 3.0
    codes, _ = tops.quantize_rows(x, 15, prng.PRNGKey(8))
    assert not codes[3].any()
    got = tsq.stoch_quant(x, rand, scale, s=15)
    assert torch.equal(got, tsq.stoch_quant_plain(x, rand, scale, s=15))
    assert not got[3].any() and got[4, 7] == 0 and got[4].any()
    col = torch.full((1, 1001), 3.0, device=cuda)
    col[0, 9] = float("nan")                     # column 9: NaN scale
    for axis, sc in (("row", scale), ("col", col)):
        planes = tsq.ds_quant(x, rand, sc, s=15, scale_axis=axis)
        for g, w in zip(planes, tsq.ds_quant_plain(x, rand, sc, s=15)):
            assert torch.equal(g, w)
    assert not planes[0][:, 9].any()
    c1, c2, _ = tops.ds_quantize(x, 15, prng.PRNGKey(8))
    assert not c1[3].any() and not c2[3].any()


@pytest.mark.gpu
def test_quantize_rows_and_ds_quantize_launch_counts(cuda):
    x = torch.randn(16, 5000, device=cuda)
    key = prng.PRNGKey(4)
    tsq.reset_counts()
    codes, scale = tops.quantize_rows(x, 15, key)
    c1, c2, sc = tops.ds_quantize(x, 15, key)
    torch.cuda.synchronize()
    assert (tsq.row_absmax_launches, tsq.stoch_quant_launches, tsq.launches) == (2, 1, 1)
    assert tsq.shape_launches == {("row_absmax", 16, 5000): 2,
                                  ("stoch_quant", 16, 5000): 1,
                                  ("ds_quant", 16, 5000): 1}
    cpu_codes, cpu_scale = tops.quantize_rows(x.cpu(), 15, key)
    assert torch.equal(codes.cpu(), cpu_codes) and torch.equal(scale.cpu(), cpu_scale)
    cpu = tops.ds_quantize(x.cpu(), 15, key)
    for g, w in zip((c1, c2, sc), cpu):
        assert torch.equal(g.cpu(), w)
    assert torch.equal(sc, scale)


QMV_CASES = [((16, 5000), False), ((16, 5000), True), ((16, 90), False), ((16, 90), True),
             ((1024, 2048), False), ((1024, 2048), True), ((13, 1001), False),
             ((13, 1001), True), ((1, 5), False), ((3, 1), True),
             # C past one step of a block: split, merged by the last block
             ((3, 70000), False), ((5, 3001), False), ((5000, 300), True), ((1001, 7), True)]


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
    for _ in range(3):
        assert torch.equal(tqmv.qmv(codes, v), got)     # fixed reduction order


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
@pytest.mark.parametrize("shape,transposed", QMV_CASES)
def test_qmv_is_one_launch_and_no_memset(cuda, shape, transposed):
    """One device kernel per call at every shape, the split ones included
    (the merge is the last block's, the counters reset by it): nothing
    else on the card, no memset."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    plane = torch.randint(-127, 128, shape, dtype=torch.int8, device=cuda)
    codes = plane.T if transposed else plane
    v = torch.randn(codes.shape[1], device=cuda)
    want = tqmv.qmv(codes, v)                           # plans and allocates the workspace
    torch.cuda.synchronize()
    for _ in range(3):      # a session with no device event at all is a failed reading
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            got = [tqmv.qmv(codes, v) for _ in range(5)]
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        if events:
            break
    assert sum(e.count for e in events) == 5, [(e.key, e.count) for e in events]
    assert len(events) == 1 and "qmv_" in events[0].key
    assert all(torch.equal(g, want) for g in got)


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


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["logistic", "svm-refetch", "optimal-levels"])
def test_train_linear_slice5_card_matches_cpu_plain_path(cuda, case):
    """The Chebyshev logistic model, the SVM's ℓ1 refetch and 'double' on
    optimal levels, 512 cod-rna rows: per-epoch losses on the card within
    rel 1e-4 of the CPU's (the same codes; sums in another order)."""
    from repro_torch.core.linear import Dataset, make_dataset, train_linear
    from repro_torch.quant import PrecisionPlan

    d = make_dataset("cod-rna", n_test=64)
    ds = Dataset(d.a_train[:512], d.b_train[:512], d.a_test, d.b_test, d.name)
    plan, kw = {"logistic": (PrecisionPlan("double", sample_bits=4),
                             dict(model="logistic", lr=0.4)),
                "svm-refetch": (PrecisionPlan("double", sample_bits=8),
                                dict(model="svm", lr=0.2, reg="ball", refetch="l1")),
                "optimal-levels": (PrecisionPlan("double", sample_bits=3,
                                                 optimal_levels=True), dict(lr=0.1))}[case]
    card = train_linear(ds, plan, epochs=2, device=cuda, **kw)
    cpu = train_linear(ds, plan, epochs=2, device="cpu", **kw)
    np.testing.assert_allclose(card.losses, cpu.losses, rtol=1e-4)
    if case == "svm-refetch":       # a row whose margin sits on the bound may flip
        np.testing.assert_allclose(card.extra["refetch_frac"], cpu.extra["refetch_frac"],
                                   rtol=0, atol=0.01)


# ragged and small shapes on both sides of qmm_t.plan's threshold (M 8
# streams, M 9 runs on the tensor cores) at q/o's (2048, 2048) and a ragged
# (1001, 1000); a tensor-core case with a ragged tail of N in the last of
# its contraction slices (M 256, N 1000: six slices of 192)
QMM_T_EDGE = tqmm_t.TC_THRESHOLD
QMM_T_SHAPES = [(1, 40, 24), (5, 64, 48), (13, 96, 130), (130, 257, 256),
                (7, 33, 130), (256, 2048, 256),
                (QMM_T_EDGE, 2048, 2048), (QMM_T_EDGE + 1, 2048, 2048),
                (QMM_T_EDGE, 1001, 1000), (QMM_T_EDGE + 1, 1001, 1000), (256, 512, 1000)]


def _qmm_t_run(g, codes, scale, packed):
    """``qmm_t`` on the card; checks that one launch ran, on the core
    ``qmm_t.plan`` gives its shape."""
    m, n = g.shape
    core = tqmm_t.plan(m, codes.shape[0], n).core
    before = (tqmm_t.launches, tqmm_t.stream_launches, tqmm_t.tc_launches)
    got = tqmm_t.qmm_t(g, codes, scale, packed=packed)
    tc = int(core == "tc")
    assert (tqmm_t.launches, tqmm_t.stream_launches, tqmm_t.tc_launches) == (
        before[0] + 1, before[1] + 1 - tc, before[2] + tc)
    return got


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n", QMM_T_SHAPES)
@pytest.mark.parametrize("bits,packed", [(8, False), (4, True)])
@pytest.mark.parametrize("gdtype", [torch.float32, torch.bfloat16])
def test_qmm_t_kernel_matches_plain(cuda, m, k, n, bits, packed, gdtype):
    qt = _weights(k, n, bits, packed).to(cuda)
    g = torch.from_numpy(np.random.default_rng(m).normal(0, 1, (m, n)).astype(
        np.float32)).to(cuda, gdtype)
    got = _qmm_t_run(g, qt.codes, qt.scale, packed)
    want = tqmm_t.qmm_t_plain(g, qt.codes, qt.scale, packed=packed)
    torch.cuda.synchronize()
    assert got.shape == (m, k) and got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5 * want.abs().max().item())


@pytest.mark.gpu
@pytest.mark.parametrize("m", [4, QMM_T_EDGE + 1, 130])
@pytest.mark.parametrize("bits,packed", [(8, False), (4, True)])
def test_qmm_t_kernel_wide_column_scales(cuda, m, bits, packed):
    # f32 g against per-column scales over 2^-20..2^20: g · scale spans 40
    # binades, and every one of its 24 bits must reach the product
    k, n = 300, 520
    rng = np.random.default_rng(7)
    codes = _weights(k, n, bits, packed).codes.to(cuda)
    scale = torch.from_numpy(2.0 ** rng.uniform(-20, 20, (1, n))).float().to(cuda)
    g = torch.from_numpy(rng.normal(0, 1, (m, n)).astype(np.float32)).to(cuda)
    got = _qmm_t_run(g, codes, scale, packed)
    want = tqmm_t.qmm_t_plain(g, codes, scale, packed=packed)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5 * want.abs().max().item())


@pytest.mark.gpu
@pytest.mark.parametrize("m", [4, QMM_T_EDGE + 1, 130])
@pytest.mark.parametrize("bits,packed", [(8, False), (4, True)])
def test_qmm_t_kernel_non_finite_rows(cuda, m, bits, packed):
    # one inf and one nan in g: the trainer's skip flag reads finiteness, so
    # dx must be non-finite exactly where the plain version's is (the split
    # of inf gives nan pieces where the plain version has ±inf)
    k, n = 96, 130
    qt = _weights(k, n, bits, packed).to(cuda)
    g = torch.from_numpy(np.random.default_rng(m).normal(0, 1, (m, n)).astype(
        np.float32)).to(cuda)
    g[1, 5] = float("inf")
    g[m - 1, n - 1] = float("nan")
    got = _qmm_t_run(g, qt.codes, qt.scale, packed)
    want = tqmm_t.qmm_t_plain(g, qt.codes, qt.scale, packed=packed)
    torch.cuda.synchronize()
    bad = ~torch.isfinite(want)
    assert bad[1].any() and bad[m - 1].any()
    assert torch.equal(~torch.isfinite(got), bad)
    fine = ~bad
    scale_ = want[fine].abs().max().item()
    torch.testing.assert_close(got[fine], want[fine], rtol=0, atol=1e-5 * scale_)


def _adamw_leaf(r, c, seed, device):
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(a).to(device)
    return (t(rng.normal(0, 1, (r, c)).astype(np.float32)),
            t((rng.normal(0, 1, (r, c)) * 0.1).astype(np.float32)),
            t(rng.integers(-127, 128, (r, c)).astype(np.int8)),
            t((np.abs(rng.normal(0, 1, c)) * 0.01 + 1e-4).astype(np.float32)),
            t(rng.integers(0, 128, (r, c)).astype(np.int8)),
            t((np.abs(rng.normal(0, 1, c)) * 0.01 + 1e-4).astype(np.float32)),
            t(rng.integers(0, 2 ** 32, (r, c), dtype=np.uint32).view(np.int32)))


OPK = dict(qmax=127, b1=0.9, b2=0.95, eps=1e-8, wd=0.1, lr=1e-3, b1c=0.1,
           b2c=0.05, clip=1.0, finite=1.0, uclip=10.0)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(1, 7), (96, 160), (257, 130), (513, 2048), (18, 2048)])
@pytest.mark.parametrize("finite", [1.0, 0.0])
def test_quant_adamw_kernels_match_plain(cuda, shape, finite):
    args = _adamw_leaf(*shape, seed=shape[0], device=cuda)
    kw = dict(OPK, finite=finite)
    before = (tqa.absmax_launches, tqa.update_launches)
    got = tops.quant_adamw_update(*args, **kw)
    assert (tqa.absmax_launches, tqa.update_launches) == (before[0] + 1, before[1] + 1)
    want = tops.quant_adamw_update(*(a.cpu() for a in args), **kw)
    torch.cuda.synchronize()
    nm, mc, ms, vc, vs = [x.cpu() for x in got]
    nm_p, mc_p, ms_p, vc_p, vs_p = want
    torch.testing.assert_close(nm, nm_p, rtol=2e-6, atol=2e-6)
    torch.testing.assert_close(ms, ms_p, rtol=1e-6, atol=0)
    torch.testing.assert_close(vs, vs_p, rtol=1e-6, atol=0)
    for a, b in ((mc, mc_p), (vc, vc_p)):
        assert (a == b).float().mean().item() >= 0.999
        assert (a.int() - b.int()).abs().max().item() <= 1
    if not finite:
        assert torch.equal(nm, args[0].cpu())


@pytest.mark.gpu
def test_quant_adamw_absmax_blocks_match_plain(cuda):
    args = _adamw_leaf(600, 300, seed=3, device=cuda)
    params = torch.tensor([0.5, 1, 1e-3, 0.1, 0.05, 0, 0, 0], dtype=torch.float32,
                          device=cuda)
    mx, vx = tqa.qadamw_absmax(args[1], *args[2:6], params, b1=0.9, b2=0.95)
    mxp, vxp = tqa.qadamw_absmax(args[1].cpu(), *(a.cpu() for a in args[2:6]),
                                 params.cpu(), b1=0.9, b2=0.95)
    assert mx.shape == (3, 300)
    torch.testing.assert_close(mx.cpu(), mxp, rtol=1e-6, atol=0)
    torch.testing.assert_close(vx.cpu(), vxp, rtol=1e-6, atol=0)


@pytest.mark.gpu
def test_train_step_card_matches_cpu_plain_path(cuda):
    from repro_torch import configs
    from repro_torch.data.pipeline import TokenStreamConfig
    from repro_torch.kernels import qmm as tqmm
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.quant import PrecisionPlan
    from repro_torch.train import Trainer, default_channels
    from repro_torch.train.channels import ModelChannel

    plan = PrecisionPlan(model_bits=8, model_storage="ship", grad_bits=8, backend="cuda")
    cfg = configs.get_reduced("gemma-2b", dtype=torch.float32, precision=plan)
    losses, start = {}, None
    for where in ("cpu", cuda):
        chans = dict(default_channels(plan), model=ModelChannel(plan, ship_min_size=0))
        # lr 1e-3 from the first step: the losses see the updates
        tr = Trainer(cfg, AdamWConfig(moment_bits=8, lr=1e-3, warmup_steps=1),
                     channels=chans, device=where,
                     stream_cfg=TokenStreamConfig(cfg.vocab_size, 16, 2))
        start = tr.init_state() if start is None else start   # one set of weights
        before = (tqmm.launches, tqmm_t.launches, tqa.absmax_launches)
        _, losses[str(where)] = tr.run(3, state=start.to(where))
        launched = [a - b for a, b in zip(
            (tqmm.launches, tqmm_t.launches, tqa.absmax_launches), before)]
        assert all(launched) if where == cuda else not any(launched)
    np.testing.assert_allclose(losses[str(cuda)], losses["cpu"], rtol=1e-4)


# qmm_bitplane at the serving path's (M, K, N): decode (M 4), the verify
# window (M 16) and prefill (M 128; the served trace's largest prompt
# bucket, M 112, at gate/up and down) of gemma-2b's q/o, k/v, gate/up and
# down projections, plus ragged M, K and N (M 130: a full 128-row tile and
# a 2-row one in one launch)
QBP_SHAPES = [(4, 2048, 2048), (16, 2048, 256), (4, 2048, 16384), (4, 16384, 2048),
              (128, 2048, 2048), (112, 2048, 16384), (112, 16384, 2048),
              (13, 1001, 1000), (1, 40, 24), (5, 64, 70), (130, 1001, 1000)]
# the prefill M of the served trace's prompt buckets (chip_smoke.py ·
# _prompt_buckets: its 8 prompts rounded up to 16-token pages)
QBP_BUCKETS = (48, 64, 80, 96, 112)
_QBP_WEIGHTS = {}


def _bitplane_weights(k, n, device):
    """The 8-bit bitplane encoding of a seeded (K, N) weight, made on the
    card once per shape."""
    if (k, n) not in _QBP_WEIGHTS:
        g = torch.Generator(device=device).manual_seed(k * 7 + n)
        w = torch.randn(k, n, generator=g, device=device) * k ** -0.5
        _QBP_WEIGHTS[(k, n)] = tquant.encode(w, tquant.QScheme.bitplane(8))
    return _QBP_WEIGHTS[(k, n)]


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n", QBP_SHAPES)
@pytest.mark.parametrize("planes", range(1, 10))
@pytest.mark.parametrize("xdtype", [torch.float32, torch.bfloat16])
def test_qmm_bitplane_kernel_matches_plain(cuda, m, k, n, planes, xdtype):
    """rel 1e-5 of the largest output against the f32-decode plain version
    (integer codes summed exactly per product, f32 accumulation order)."""
    from repro_torch.kernels import qmm_bitplane as tqbp

    qt = _bitplane_weights(k, n, cuda)
    codes = qt.codes[:planes]
    x = torch.randn(m, k, generator=torch.Generator().manual_seed(m)).to(xdtype).to(cuda)
    before, before_tc = tqbp.launches, tqbp.tc_launches
    got = tqbp.qmm_bitplane(x, codes, qt.scale)
    torch.cuda.synchronize()
    assert tqbp.launches == before + 1 and got.shape == (m, n)
    # bf16 x runs on the tensor cores, f32 x on the SIMT core
    assert tqbp.tc_launches == before_tc + int(xdtype == torch.bfloat16)
    want = tqbp.qmm_bitplane_plain(x, codes, qt.scale)
    if planes == 1:
        assert not got.any()
        return
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * want.abs().max().item())


@pytest.mark.gpu
@pytest.mark.parametrize("k,n", [(2048, 2048), (2048, 256), (16384, 2048), (1001, 1000)])
@pytest.mark.parametrize("planes", [9, 5])
def test_qmm_bitplane_rows_do_not_depend_on_m(cuda, k, n, planes):
    """The core and the K split depend on x's dtype and (K, N) only, and
    each row is summed alone, so a row of x gives the same bits at M = 4 (a
    decode step), 16 (a verify window), every prompt bucket of the served
    trace and 128 (prefill), wherever it lies in the block of rows."""
    from repro_torch.kernels import qmm_bitplane as tqbp

    qt = _bitplane_weights(k, n, cuda)
    codes = qt.codes[:planes]
    x = torch.randn(128, k, generator=torch.Generator().manual_seed(1)).to(
        torch.bfloat16).to(cuda)
    full = tqbp.qmm_bitplane(x, codes, qt.scale)
    for m in (4, 16, *QBP_BUCKETS):
        for start in (0, 4, 64):
            if start + m <= 128:
                part = tqbp.qmm_bitplane(x[start:start + m], codes, qt.scale)
                assert torch.equal(part, full[start:start + m]), (m, start)


@pytest.mark.gpu
def test_bitplane_quant_dense_without_kernel_raises_on_card(cuda):
    from repro_torch.kernels import registry as treg

    be = treg.get("cuda")
    qt = _bitplane_weights(40, 24, cuda)
    with pytest.raises(NotImplementedError, match="ROADMAP A1"):
        be.quant_dense(torch.randn(3, 24, device=cuda), qt, transpose=True)
    w = torch.randn(2, 40, 24, device=cuda)
    stacked = tquant.encode(w, tquant.QScheme.bitplane(4))
    with pytest.raises(NotImplementedError, match="ROADMAP A1"):
        be.quant_dense(torch.randn(3, 40, device=cuda), stacked)
    y = be.quant_dense(torch.randn(2, 3, 40, device=cuda), qt)
    assert y.shape == (2, 3, 24)


@pytest.mark.gpu
def test_bitplane_engines_card_match_cpu_plain_path(cuda):
    """Reduced gemma-2b at f32 with 8-bit bitplane weights, served plain,
    at set_weight_bits(2) and with speculation (k 3, draft 4): greedy tokens
    on the card (kernels) equal the CPU's (plain versions)."""
    from repro_torch import configs
    from repro_torch.launch.serve import make_trace
    from repro_torch.models import transformer as T
    from repro_torch.precision.qat import quantize_param_tree
    from repro_torch.quant import PrecisionPlan
    from repro_torch.serve import ServeEngine

    plan = PrecisionPlan(model_bits=8, kv_bits=8, model_storage="int")
    cfg = configs.get_reduced("gemma-2b", dtype=torch.float32, precision=plan)
    params = quantize_param_tree(T.init_params(cfg, seed=0, device="cpu"), bits=8,
                                 layout="bitplane")
    for name, kw, bits in (("plain", {}, None), ("sliced", {}, 2),
                           ("spec", dict(spec_decode=3, draft_bits=4), None)):
        toks = {}
        for where in (cuda, "cpu"):
            eng = ServeEngine(params, cfg, max_slots=4, page_size=8, max_seq_len=56,
                              backend="cuda", device=where, **kw)
            if bits:
                eng.set_weight_bits(bits)
            res = eng.run(make_trace(8, cfg.vocab_size, max_new=16, max_prompt=32, seed=0))
            toks[str(where)] = {r: f.tokens.tolist() for r, f in res.items()}
            eng.allocator.check_leaks(0)
        assert toks[str(cuda)] == toks["cpu"], name


# ragged; decode and prefill; the training batch; both sides of plan's
# threshold (bf16 x: the SIMT core at it, the tensor cores above), at
# N 2048 so that the share of codes off the plain version counts at least
# 32768 codes (one code in 6144, at N 384, is 1.6e-4)
QOUT_SHAPES = [(13, 1001, 1000), (4, 2048, 256), (128, 2048, 2048), (2048, 2048, 256),
               (EDGE, 2048, 2048), (EDGE + 1, 2048, 2048), (130, 1001, 1000)]


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n", QOUT_SHAPES)
@pytest.mark.parametrize("wbits", [8, 4])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("xdtype", [torch.bfloat16, torch.float32])
def test_qmm_qout_kernel_bit_exact_vs_unfused(cuda, m, k, n, wbits, bits, xdtype):
    packed = wbits == 4
    qmax = 2 ** (bits - 1) - 1
    tq = _weights(k, n, wbits, packed, seed=k).to(cuda)
    rng = np.random.default_rng(m + n)
    x = torch.from_numpy(rng.normal(0, 1, (m, k)).astype(np.float32)).to(cuda, xdtype)
    x[min(2, m - 1)] = float("nan")                  # a NaN row: codes 0, scale NaN
    rand = torch.from_numpy(rng.integers(0, 2 ** 32, (m, n), dtype=np.uint32)
                            .view(np.int32)).to(cuda)
    before = (tqout.launches, tqout.tc_launches)
    c1, c2, sc = tqout.qmm_qout(x, tq.codes, tq.scale, rand, qmax=qmax, packed=packed,
                                out_dtype=xdtype)
    torch.cuda.synchronize()
    tc = int(xdtype == torch.bfloat16 and m > EDGE)
    assert (tqout.launches, tqout.tc_launches) == (before[0] + 1, before[1] + tc)
    y = tqmm.qmm(x, tq.codes, tq.scale, packed=packed).to(xdtype)
    u1, u2, us = tref.ds_row_pair_ref(y, rand, qmax=qmax)
    assert torch.equal(c1, u1) and torch.equal(c2, u2)
    torch.testing.assert_close(sc, us, rtol=1e-6, atol=0, equal_nan=True)
    nan_row = min(2, m - 1)
    assert not c1[nan_row].any() and not c2[nan_row].any() and sc[nan_row].isnan().all()
    # the plain version sums in another order
    p1, p2, ps = tqout.qmm_qout_plain(x, tq.codes, tq.scale, rand, qmax=qmax,
                                      packed=packed, out_dtype=xdtype)
    yp = tqmm.qmm_plain(x, tq.codes, tq.scale, packed=packed).to(xdtype)
    same_y = (y == yp) | (y.isnan() & yp.isnan())
    same_s = (sc == ps) | (sc.isnan() & ps.isnan())
    moved = ~same_y | ~same_s
    diff1, diff2 = c1 != p1, c2 != p2
    assert not (diff1 & ~moved).any() and not (diff2 & ~moved).any()
    share = float((diff1.sum() + diff2.sum()) / (2 * m * n))
    assert share <= 1e-4, share
    # the exact pair: the f64 product of the same x and integer codes (exact
    # to far below an f32 ulp) → cast → encode. The kernel's codes lie within
    # 1e-4 of it, or no farther from it than the plain version's
    c = unpack_int4(tq.codes) if packed else tq.codes
    y64 = (x.double() @ c.double()) * tq.scale.double().reshape(1, -1)
    e1, e2, _ = tref.ds_row_pair_ref(y64.to(xdtype), rand, qmax=qmax)
    off = int((c1 != e1).sum() + (c2 != e2).sum())
    plain_off = int((p1 != e1).sum() + (p2 != e2).sum())
    assert off <= max(plain_off, 1e-4 * 2 * m * n), (off, plain_off)
    assert int((c1.int() - c2.int()).abs().max()) <= 1
    assert int(c1.abs().max()) <= qmax and int(c2.abs().max()) <= qmax


@pytest.mark.gpu
def test_quant_dense_q_on_card_launches_qmm_qout_only(cuda):
    tq = _weights(64, 40, 8, False).to(cuda)
    x = torch.randn(2, 9, 64, device=cuda, dtype=torch.bfloat16)
    q0, o0 = tqmm.launches, tqout.launches
    pair = tquant.quant_dense_q(x, tq, prng.PRNGKey(0), bits=8)
    torch.cuda.synchronize()
    assert (tqmm.launches - q0, tqout.launches - o0) == (0, 1)
    assert pair.codes.shape == (2, 9, 40) and pair.scale.shape == (2, 9, 1)
    cpu = tquant.quant_dense_q(x.cpu(), tq.to("cpu"), prng.PRNGKey(0), bits=8,
                               backend="cuda")
    share = float((pair.codes.cpu() != cpu.codes).float().mean())
    assert share <= 1e-2          # 720 codes; sums reordered card vs CPU


@pytest.mark.gpu
@pytest.mark.parametrize("bits,packed", [(8, False), (4, True)])
def test_qmm_t_kernel_at_unembed_decode_shape(cuda, bits, packed):
    """The tied unembed at decode: M 4 slots against a long vocab axis."""
    m, k, n = 4, 65536, 512
    qt = _weights(k, n, bits, packed, seed=1).to(cuda)
    g = torch.randn(m, n, device=cuda, dtype=torch.bfloat16)
    got = _qmm_t_run(g, qt.codes, qt.scale, packed)
    want = tqmm_t.qmm_t_plain(g, qt.codes, qt.scale, packed=packed)
    torch.cuda.synchronize()
    assert got.shape == (m, k)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5 * want.abs().max().item())


@pytest.mark.gpu
@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_table_engine_card_matches_cpu_plain_path(cuda, bits):
    """Reduced gemma-2b at f32 with quantized embedding tables: greedy
    tokens on the card (qmm, qmm_t for every readout, paged attention) equal
    the CPU's plain path."""
    from repro_torch import configs
    from repro_torch.launch.serve import make_trace
    from repro_torch.models import transformer as T
    from repro_torch.precision.qat import quantize_param_tree
    from repro_torch.quant import PrecisionPlan
    from repro_torch.serve import ServeEngine

    plan = PrecisionPlan(model_bits=bits, kv_bits=bits, model_storage="int")
    cfg = configs.get_reduced("gemma-2b", dtype=torch.float32, precision=plan)
    params = quantize_param_tree(T.init_params(cfg, seed=0, device="cpu"), bits=bits,
                                 include_embedding=True)
    toks = {}
    before = tqmm_t.launches
    for where in (cuda, "cpu"):
        eng = ServeEngine(params, cfg, max_slots=4, page_size=8, max_seq_len=56,
                          backend="cuda", device=where)
        res = eng.run(make_trace(8, cfg.vocab_size, max_new=16, max_prompt=32, seed=0))
        toks[str(where)] = {r: f.tokens.tolist() for r, f in res.items()}
    assert tqmm_t.launches > before
    assert toks[str(cuda)] == toks["cpu"]


SSD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
SSD_STATE_TOL = 1e-4
# (B, NC, L, H, P, N): ragged tiles, mamba2-780m's prefill (4 chunks of 256)
# and the single 1023-row chunk of a 1023-token prompt
SSD_SHAPES = [(2, 3, 40, 3, 16, 16), (1, 2, 33, 2, 64, 8), (4, 4, 256, 48, 64, 128),
              (4, 1, 1023, 48, 64, 128)]


def _ssd_inputs(dev, b, nc, L, h, p, n, dtype, init=False, strided=False, seed=0):
    """x N(0, .25), dt = softplus(N(0, 1) − 1), logdec = dt · −(1..H), B and C
    N(0, .09) in ``dtype``; ``strided`` cuts x, B and C out of one wider
    projection row, as the model's views are."""
    g = torch.Generator(device=dev).manual_seed(seed)
    f32 = dict(device=dev, dtype=torch.float32)
    row = torch.randn(b, nc, L, h * p + 2 * n + 5, generator=g, **f32)
    row[..., :h * p] *= 0.5
    row[..., h * p:] *= 0.3
    row = row.to(dtype)
    x = row[..., :h * p].reshape(b, nc, L, h, p)
    bm, cm = row[..., h * p:h * p + n], row[..., h * p + n:h * p + 2 * n]
    if not strided:
        x, bm, cm = x.contiguous(), bm.contiguous(), cm.contiguous()
    dt = torch.nn.functional.softplus(torch.randn(b, nc, L, h, generator=g, **f32) - 1)
    logdec = dt * -torch.arange(1, h + 1, **f32)
    st = torch.randn(b, h, p, n, generator=g, **f32) if init else None
    return x, dt, logdec, bm, cm, st


@pytest.mark.gpu
@pytest.mark.parametrize("shape", SSD_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("init", [False, True])
def test_ssd_chunk_scan_kernel_matches_plain(cuda, shape, dtype, init):
    args = _ssd_inputs(cuda, *shape, dtype, init=init, strided=shape[0] == 2)
    before = (tssd.launches, tssd.tc_launches)
    y, st = tssd.ssd_chunk_scan(*args)
    # bf16 x on the tensor cores, f32 on the SIMT kernel
    assert (tssd.launches, tssd.tc_launches) == (before[0] + 1,
                                                 before[1] + (dtype == torch.bfloat16))
    y_ref, st_ref = tssd.ssd_chunk_scan_plain(*args)
    torch.cuda.synchronize()
    assert y.dtype == dtype and st.dtype == torch.float32
    assert torch.isfinite(y.float()).all() and torch.isfinite(st).all()
    tol = SSD_TOL[dtype]
    torch.testing.assert_close(y.float(), y_ref.float(), rtol=tol, atol=tol)
    # the state at 1e-4 at both dtypes: bf16 x, B and C split nothing, and
    # the tensor cores' f32 operands are split exactly into three pieces
    torch.testing.assert_close(st, st_ref, rtol=SSD_STATE_TOL, atol=SSD_STATE_TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", SSD_SHAPES)
@pytest.mark.parametrize("init", [False, True])
def test_ssd_tensor_cores_match_their_order_and_repeat(cuda, shape, init):
    """The tensor-core core against its own order written out in torch
    (``ssd_chunk_scan_tc_plain``: y within SSD_TOL, the state within 1e-4),
    and two calls bit-equal (no atomics in any sum)."""
    args = _ssd_inputs(cuda, *shape, torch.bfloat16, init=init, strided=shape[0] == 2, seed=3)
    y, st = tssd.ssd_chunk_scan(*args)
    y_tc, st_tc = tssd.ssd_chunk_scan_tc_plain(*args)
    torch.cuda.synchronize()
    tol = SSD_TOL[torch.bfloat16]
    torch.testing.assert_close(y.float(), y_tc.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(st, st_tc, rtol=SSD_STATE_TOL, atol=SSD_STATE_TOL)
    for _ in range(2):
        y2, st2 = tssd.ssd_chunk_scan(*args)
        assert torch.equal(y2, y) and torch.equal(st2, st)


@pytest.mark.gpu
def test_ssd_gradient_on_card_raises(cuda):
    x, *rest = _ssd_inputs(cuda, 1, 2, 8, 2, 16, 8, torch.float32)
    with pytest.raises(NotImplementedError, match="ROADMAP A6"):
        tssd.ssd_chunk_scan(x.requires_grad_(), *rest)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,bits", [(torch.float32, 0), (torch.float32, 8),
                                        (torch.bfloat16, 8)])
def test_mamba_legacy_path_card_matches_cpu_plain_path(cuda, dtype, bits):
    """Reduced mamba2-780m: prefill (prompt 40 = one chunk, 64 = four of 16)
    and 8 greedy decode steps on the card (``ssd_chunk_scan``, ``qmm``)
    against the CPU's plain path from the same weights: equal tokens, and at
    f32 logits within 1e-4 of the largest. Both run the ``cuda`` backend: on
    the CPU that is the kernels' plain versions (the ``ref`` backend decodes
    an f32 product's weights at bf16 scales, the reference's jitted ``ref``
    numerics, C4)."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.kernels import registry
    from repro_torch.launch.steps import make_serve_step
    from repro_torch.models import transformer as T
    from repro_torch.precision.qat import quantize_param_tree

    cfg = dataclasses.replace(configs.get_reduced("mamba2-780m", dtype=dtype), ssd_chunk=16)
    params = T.init_params(cfg, seed=0, device="cpu")
    if bits:
        params = quantize_param_tree(params, bits=bits)
    step = make_serve_step(cfg)
    for s in (40, 64):
        prompt = torch.from_numpy(np.random.default_rng(s).integers(0, cfg.vocab_size, (2, s)))
        runs = {}
        for where in (cuda, "cpu"):
            p = params if where == "cpu" else _to(params, cuda)
            before = tssd.launches
            with registry.using("cuda"):      # on the CPU: the kernels' plain versions
                logits, state = T.prefill(p, prompt.to(where), cfg)
                toks, lgs = [torch.argmax(logits, -1).to(torch.int32)[:, None]], [logits]
                for _ in range(8):
                    lg, nxt, state = step(p, state, toks[-1])
                    toks.append(nxt[:, None])
                    lgs.append(lg[:, 0])
            runs[str(where)] = (torch.cat(toks, 1).cpu(), [t.float().cpu() for t in lgs])
            if where != "cpu":
                assert tssd.launches == before + cfg.n_layers
        (tc, lc), (tp, lp) = runs[str(cuda)], runs["cpu"]
        assert torch.equal(tc, tp)
        if dtype == torch.float32:
            for a, b in zip(lc, lp):
                torch.testing.assert_close(a, b, rtol=0, atol=1e-4 * b.abs().max().item())


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return tree.to(dev)
