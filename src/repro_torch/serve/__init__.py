"""repro_torch.serve — the continuous-batching serving engine of the port.

* :class:`ServeEngine` / :class:`Request` / :class:`Finished` — the
  iteration-level scheduler (admit / chunked or monolithic prefill /
  batched paged decode / preempt and replay) over a mixed request stream,
  with bitplane weights at any precision, self-speculative decoding and
  fault quarantine (engine.py).
* :class:`PagedKVPool` + :class:`PageAllocator` — the paged KV cache
  (bf16 / int8 / packed int4 pages) and its refcounting allocator
  (pages.py).
* :class:`PrefixCache` — the trie over completed prompt pages behind
  ``ServeEngine(prefix_cache=True)`` (prefix.py).
* :func:`sample_tokens` — greedy / temperature / top-k with per-request
  keys (sampling.py).
* :class:`PrecisionAutoscaler` + :class:`AutoscalerConfig` — the
  load-adaptive precision governor (autoscaler.py).
* :class:`FaultInjector` + :class:`FaultSpec` + :class:`VirtualClock` —
  seeded fault injection at the engine and replica seams (faults.py).
"""
from .autoscaler import AutoscalerConfig, PrecisionAutoscaler
from .faults import FaultInjector, FaultSpec, ReplicaDeviceLost, VirtualClock
from .engine import Finished, Request, ServeEngine
from .pages import PageAllocator, PagedKVPool, init_pool, pool_nbytes, scrub_pages
from .prefix import PrefixCache
from .sampling import sample_tokens

__all__ = [
    "AutoscalerConfig",
    "FaultInjector",
    "FaultSpec",
    "Finished",
    "PageAllocator",
    "PagedKVPool",
    "PrecisionAutoscaler",
    "PrefixCache",
    "ReplicaDeviceLost",
    "Request",
    "ServeEngine",
    "VirtualClock",
    "init_pool",
    "pool_nbytes",
    "sample_tokens",
    "scrub_pages",
]
