"""repro_torch.quant — the quantization API of the port (storage + plan)."""
from .plan import PrecisionPlan
from .qtensor import (QTensor, compute_scale, decode, encode, pack_int4,
                      tree_nbytes, unpack_int4)
from .quant_dense import mm_f32, quant_dense
from .scheme import QScheme

__all__ = ["PrecisionPlan", "QScheme", "QTensor", "compute_scale", "decode",
           "encode", "mm_f32", "pack_int4", "quant_dense", "tree_nbytes",
           "unpack_int4"]
