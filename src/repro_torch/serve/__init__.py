"""repro_torch.serve — the continuous-batching serving engine of the port
(monolithic admission, full reservation, greedy decode) over the paged,
quantized KV pool."""
from .engine import Finished, Request, ServeEngine
from .pages import PageAllocator, PagedKVPool

__all__ = ["Finished", "PageAllocator", "PagedKVPool", "Request", "ServeEngine"]
