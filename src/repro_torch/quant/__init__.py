"""repro_torch.quant — the quantization API of the port (storage + plan)."""
from .plan import PrecisionPlan
from .qtensor import (QTensor, compute_scale, decode, dot, ds_pair, encode,
                      pack_int4, stochastic_round, tree_nbytes, unpack_int4)
from .quant_dense import mm_f32, quant_dense
from .scheme import QScheme

__all__ = ["PrecisionPlan", "QScheme", "QTensor", "compute_scale", "decode",
           "dot", "ds_pair", "encode", "mm_f32", "pack_int4", "quant_dense",
           "stochastic_round", "tree_nbytes", "unpack_int4"]
