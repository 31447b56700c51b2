"""repro_torch.serve — the continuous-batching serving engine of the port
(monolithic admission, full reservation, greedy decode, bitplane weights
served at any precision, self-speculative decoding) over the paged,
quantized KV pool, and the precision autoscaler."""
from .autoscaler import AutoscalerConfig, PrecisionAutoscaler
from .engine import Finished, Request, ServeEngine
from .pages import PageAllocator, PagedKVPool

__all__ = ["AutoscalerConfig", "Finished", "PageAllocator", "PagedKVPool",
           "PrecisionAutoscaler", "Request", "ServeEngine"]
