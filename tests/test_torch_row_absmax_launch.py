"""The wrapper around kernel B2 (``row_absmax``): one CUDA launch a call, a
CTA a row, with x's address, dtype and shape passed unchanged, and the plain
version on CPU tensors, bit-exact with the reference's Pallas kernel at the
smoke and GPU tests' shapes (interpret mode), NaN kept and −0 read as +0.
Plain Python: these run on the CPU. The wrapper's C call is replaced by a
stub that records its arguments; operands at full size are meta tensors
(shapes without storage)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import stoch_quant as jsq
from repro_torch import prng
from repro_torch.kernels import ops as tops
from repro_torch.kernels import stoch_quant as tsq

# chip_smoke.py's SQ_CASES (gisette's sample matrix, the linear path's
# batch, a ragged shape) and the GPU tests' shapes (R 1, C 1, odd C)
SMOKE = [(6000, 5000), (16, 5000), (13, 1001)]
GPU = [(64, 384), (1, 7), (7, 3), (5, 1), (1, 1), (1, 100000), (4224, 8), (9, 1002)]
DTYPES = [torch.float32, torch.bfloat16]


class _StubLib:
    """Records the arguments of the C entry point and reports success."""

    def __init__(self):
        self.calls = []

    def row_absmax_launch(self, *args):
        self.calls.append(args)
        return 0


@pytest.fixture
def stub(monkeypatch):
    lib = _StubLib()
    monkeypatch.setattr(tsq, "_sq_lib", lambda: lib)
    monkeypatch.setattr(tsq, "_stream", lambda x: 0)
    monkeypatch.setattr(tsq, "row_absmax_launches", 0)
    monkeypatch.setattr(tsq, "shape_launches", type(tsq.shape_launches)())
    return lib


@pytest.mark.parametrize("r,c", SMOKE + GPU)
@pytest.mark.parametrize("dtype", DTYPES)
def test_one_launch_with_the_shape_passed_unchanged(stub, r, c, dtype):
    x = torch.empty(r, c, dtype=dtype, device="meta")
    out = tsq._absmax_launch(x)
    assert out.shape == (r, 1) and out.dtype == torch.float32
    (args,) = stub.calls
    assert args == (x.data_ptr(), int(dtype == torch.bfloat16), out.data_ptr(), r, c, 0)
    assert tsq.row_absmax_launches == 1
    assert dict(tsq.shape_launches) == {("row_absmax", r, c): 1}


def test_no_rows_launch_nothing(stub):
    out = tsq._absmax_launch(torch.empty(0, 5))
    assert out.shape == (0, 1) and not stub.calls and tsq.row_absmax_launches == 0


@pytest.mark.parametrize("dtype", DTYPES)
def test_cpu_tensors_take_the_plain_version(stub, dtype):
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(0, 2, (13, 1001)).astype(np.float32)).to(dtype)
    x[0] = 0.0
    x[5, 17] = float("nan")
    got = tsq.row_absmax(x)
    assert not stub.calls and tsq.row_absmax_launches == 0
    want = tsq.row_absmax_plain(x)
    assert torch.isnan(got[5, 0]) and torch.isnan(want[5, 0])
    keep = torch.arange(13) != 5
    assert torch.equal(got[keep], want[keep]) and got[0, 0] == 0
    codes, scale = tops.quantize_rows(x, 15, prng.PRNGKey(3))
    assert torch.equal(scale[keep], want[keep]) and not codes[5].any()


# the smoke and GPU tests' shapes that the Pallas kernel's interpret mode
# takes in well under a second
PALLAS = [(13, 1001), (64, 384), (1, 7), (7, 3), (5, 1), (1, 1), (9, 1002), (16, 500)]


@pytest.mark.parametrize("r,c", PALLAS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_plain_bit_exact_with_pallas_nan_and_negative_zero(r, c, dtype):
    x = np.random.default_rng(r * c).normal(0, 2, (r, c)).astype(np.float32)
    x[-1] = -0.0                                 # a row of −0: its max is +0
    if r > 2:
        x[r // 2, c // 2] = np.nan               # a NaN row
    tx = torch.from_numpy(x).to(dtype)
    jx = jnp.asarray(x) if dtype == torch.float32 else jnp.asarray(x).astype(jnp.bfloat16)
    want = np.asarray(jsq.row_absmax(jx, interpret=True))
    got = tsq.row_absmax(tx).numpy()
    np.testing.assert_array_equal(got, want)     # NaN where the reference has it
    assert got[-1, 0] == 0 and not np.signbit(got[-1, 0])


def test_empty_columns_and_bad_rank():
    with pytest.raises(ValueError, match="no columns"):
        tsq.row_absmax(torch.zeros(3, 0))
    with pytest.raises(ValueError, match="2-D"):
        tsq.row_absmax(torch.zeros(3))
