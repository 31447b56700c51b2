"""``paged_attn.plan`` and the wrapper around kernel B10
(``paged_decode_attn``): the split grid, the workspace and the copy width
come from shapes alone, so the wrapper never reads ``seq_lens`` back from
the card. Plain Python: these run on the CPU. The wrapper's C call is
replaced by a stub that records its arguments; operands are meta tensors
(shapes without storage: reading one would raise), except where the test
reads the workspace."""
import pytest
import torch

from repro_torch.kernels import paged_attn as tpa

PPS = 2   # the stub's pages per split (the kernel's is a constant of its source)


class _StubLib:
    """Records the arguments of the C entry point and reports success."""

    pages_per_split = PPS

    def __init__(self):
        self.calls = []

    def paged_attn_launch(self, *args):
        self.calls.append(args)
        return 0


@pytest.fixture
def stub(monkeypatch):
    lib = _StubLib()
    monkeypatch.setattr(tpa, "_lib", lambda: lib)
    monkeypatch.setattr(tpa, "_stream", lambda x: 0)
    monkeypatch.setattr(tpa, "launches", 0)
    monkeypatch.setattr(tpa, "_WORKSPACE", {})
    return lib


def _operands(b, h, hkv, d, page, maxp, kv_bits, device="meta", n_pages=7):
    dk = d // 2 if kv_bits == 4 else d
    pages = torch.empty(n_pages, page, hkv, dk, dtype=tpa._PAGE_DTYPE[kv_bits], device=device)
    scale = torch.empty(n_pages, page, hkv, 1, device=device) if kv_bits else None
    return (torch.empty(b, h, d, dtype=torch.bfloat16, device=device), pages,
            torch.empty_like(pages), scale, None if scale is None else torch.empty_like(scale),
            torch.empty(b, maxp, dtype=torch.int32, device=device),
            torch.empty(b, dtype=torch.int32, device=device))


# (B, H, Hkv, D, page, MAXP): the serving decode step and verify window of
# gemma-2b, gemma-7b's MHA, granite-3-8b's GQA, the tests' small pools
SHAPES = [(4, 8, 1, 256, 16, 11), (16, 8, 1, 256, 16, 11), (4, 16, 16, 256, 16, 257),
          (4, 32, 8, 128, 8, 130), (4, 4, 2, 16, 8, 4), (3, 4, 1, 16, 8, 1), (2, 4, 1, 16, 8, 0)]


@pytest.mark.parametrize("b,h,hkv,d,page,maxp", SHAPES)
@pytest.mark.parametrize("kv_bits", [0, 8, 4])
def test_one_launch_with_grid_and_workspace_from_shapes(stub, b, h, hkv, d, page, maxp,
                                                        kv_bits):
    ops = _operands(b, h, hkv, d, page, maxp, kv_bits)
    out = tpa._launch(*ops, 0.25, kv_bits)
    assert out.shape == (b, h, d) and out.dtype == torch.float32
    assert tpa.launches == 1
    (args,) = stub.calls
    rb = (d // 2 if kv_bits == 4 else d) * (2 if kv_bits == 0 else 1)
    p = tpa.plan(b, h, hkv, d, maxp, rb, 0, PPS)
    splits = max(1, -(-maxp // PPS))
    r = h // hkv
    assert p == (splits, b * hkv * splits * (r * d + 2 * r), b * hkv, 16 if rb % 16 == 0 else 8)
    assert args[11:19] == (b, h, hkv, d, page, maxp, kv_bits, p.copy_w)
    ws, counters = tpa._WORKSPACE[(torch.device("meta"), 0)]
    assert args[9:11] == (ws.data_ptr(), counters.data_ptr())
    assert ws.numel() >= p.ws and counters.numel() >= p.counters


def test_workspace_is_kept_and_grown_and_counters_start_at_zero(stub):
    small = _operands(4, 8, 1, 256, 16, 11, 8, device="cpu")
    tpa._launch(*small, 0.25, 8)
    ws, counters = tpa._WORKSPACE[(torch.device("cpu"), 0)]
    assert torch.equal(counters, torch.zeros(4, dtype=torch.int32))
    tpa._launch(*small, 0.25, 8)
    assert tpa._WORKSPACE[(torch.device("cpu"), 0)][0] is ws       # no allocation per call
    assert tpa._WORKSPACE[(torch.device("cpu"), 0)][1] is counters
    # a wider block table and more sequences grow both
    tpa._launch(*_operands(16, 8, 1, 256, 16, 40, 8, device="cpu"), 0.25, 8)
    ws2, counters2 = tpa._WORKSPACE[(torch.device("cpu"), 0)]
    assert ws2.numel() == 16 * 20 * (8 * 256 + 16) > ws.numel()
    assert torch.equal(counters2, torch.zeros(16, dtype=torch.int32))
    # and a smaller call after it keeps the larger buffers
    tpa._launch(*small, 0.25, 8)
    assert tpa._WORKSPACE[(torch.device("cpu"), 0)][0] is ws2
    assert tpa.launches == 4


@pytest.mark.parametrize("kv_bits,d,base,want", [
    (8, 256, 0, 16), (0, 16, 0, 16), (4, 16, 0, 8), (4, 128, 0, 16), (8, 16, 8, 8),
    (8, 256, 4, 4), (4, 24, 0, 4)])
def test_copy_width_is_the_widest_the_rows_allow(kv_bits, d, base, want):
    rb = (d // 2 if kv_bits == 4 else d) * (2 if kv_bits == 0 else 1)
    assert tpa.plan(4, 8, 1, d, 11, rb, base, PPS).copy_w == want


@pytest.mark.parametrize("d", [12, 20, 520, 1024])
def test_unsupported_head_dim_raises(d):
    with pytest.raises(ValueError, match="multiple of 8"):
        tpa.plan(4, 8, 1, d, 11, d, 0, PPS)


def test_misaligned_rows_raise():
    with pytest.raises(ValueError, match="4-byte aligned"):
        tpa.plan(4, 8, 1, 16, 11, 16, 2, PPS)
