"""QScheme — the frozen spec of *how* a tensor is quantized (port of
``repro.quant.scheme``).

The dataclass carries every field of the reference so a scheme crosses the
numpy bridge unchanged (``QScheme(**fields)``). The port encodes and
decodes the symmetric int grid (``grid='int'``, nearest rounding, nibble-packed
int4) and the paper's interval grid (``grid='zipml'``, stochastic, nearest and
double-sampled rounding) under tensor, row, column and channel scaling; the
level grid, the bitplane layout and stochastic rounding on the int grid raise
in ``qtensor`` until the ROADMAP items that port them.
"""
from __future__ import annotations

import dataclasses

GRIDS = ("int", "zipml", "levels")
SCALINGS = ("tensor", "row", "column", "channel")
ROUNDINGS = ("stochastic", "nearest", "ds")
LAYOUTS = ("dense", "bitplane")


@dataclasses.dataclass(frozen=True)
class QScheme:
    bits: int = 8
    grid: str = "int"
    scaling: str = "tensor"
    rounding: str = "stochastic"
    signed: bool = True
    s: int = 0                 # zipml intervals; 0 → 2**bits − 1
    channel_axis: int = -2     # reduction axis for 'channel' scaling
    packed: bool = False       # nibble-packed storage (int grid, bits=4)
    layout: str = "dense"      # physical storage: 'dense' | 'bitplane'
    vec_dim: int = 0           # bitplane only: logical last-dim length

    def __post_init__(self):
        if self.grid not in GRIDS:
            raise ValueError(f"unknown grid {self.grid!r}; have {GRIDS}")
        if self.scaling not in SCALINGS:
            raise ValueError(f"unknown scaling {self.scaling!r}; have {SCALINGS}")
        if self.rounding not in ROUNDINGS:
            raise ValueError(f"unknown rounding {self.rounding!r}; have {ROUNDINGS}")
        if self.packed and (self.grid != "int" or self.bits != 4 or not self.signed):
            raise ValueError("packed storage is the signed 4-bit int grid only")
        if self.layout not in LAYOUTS:
            raise ValueError(f"unknown layout {self.layout!r}; have {LAYOUTS}")
        if self.grid == "zipml" and self.s == 0:
            object.__setattr__(self, "s", 2 ** self.bits - 1)

    @property
    def qmax(self) -> int:
        """Largest magnitude code of the symmetric int grid."""
        return 2 ** (self.bits - 1) - 1

    @property
    def code_bits(self) -> int:
        """Storage width of one code in bits."""
        if self.grid == "zipml":
            return max(int(self.s).bit_length(), 1)
        if self.layout == "bitplane":
            return self.bits + 1
        return self.bits

    def with_rounding(self, rounding: str) -> "QScheme":
        return dataclasses.replace(self, rounding=rounding)

    @classmethod
    def zipml(cls, s: int, *, scaling: str = "tensor",
              rounding: str = "stochastic", signed: bool = True) -> "QScheme":
        """The paper's Q(v, s): s intervals on [0, 1] (signed: [-1, 1])."""
        return cls(bits=max(int(s).bit_length(), 1), grid="zipml",
                   scaling=scaling, rounding=rounding, signed=signed, s=int(s))

    @classmethod
    def int_symmetric(cls, bits: int, *, scaling: str = "tensor",
                      rounding: str = "stochastic",
                      channel_axis: int = -2, packed: bool = False) -> "QScheme":
        """Symmetric integer grid: value ≈ codes · scale, scale = absmax/qmax.
        ``packed=True`` (bits=4 only) stores two offset-binary nibbles per
        uint8 byte — same values, half the storage bytes."""
        return cls(bits=int(bits), grid="int", scaling=scaling,
                   rounding=rounding, channel_axis=channel_axis, packed=packed)
