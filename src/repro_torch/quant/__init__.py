"""repro_torch.quant — the quantization API of the port (storage + plan)."""
from .plan import PrecisionPlan
from .qtensor import (QTensor, compute_scale, decode, dot, ds_pair, encode,
                      pack_bitplanes, pack_int4, stochastic_round, tree_nbytes,
                      unpack_bitplanes, unpack_int4)
from .quant_dense import ShipWeight, bmm_f32, mm_f32, quant_dense, quant_dense_q
from .scheme import QScheme

__all__ = ["PrecisionPlan", "QScheme", "QTensor", "ShipWeight", "compute_scale", "decode",
           "bmm_f32", "dot", "ds_pair", "encode", "mm_f32", "pack_bitplanes", "pack_int4",
           "quant_dense", "quant_dense_q", "stochastic_round", "tree_nbytes", "unpack_bitplanes",
           "unpack_int4"]
