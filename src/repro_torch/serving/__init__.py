"""repro_torch.serving — continuous-batching decode runtime (plain path).

A FIFO admission queue (``queue``), a slot-contiguous or block-paged
persistent KV-cache pool (``cache``), the continuous-batching scheduler
whose decode step keeps one fixed input shape as requests churn
(``scheduler``), and per-request/aggregate serving metrics (``metrics``).
``launch/serve.py`` is a thin CLI over this package.
"""
from repro_torch.serving.cache import CachePool, PagedCachePool
from repro_torch.serving.metrics import RequestMetrics, ServingMetrics
from repro_torch.serving.queue import (AdmissionQueue, Request, make_request,
                                       synthetic_requests)
from repro_torch.serving.scheduler import Scheduler, ServingConfig

__all__ = [
    "AdmissionQueue",
    "CachePool",
    "PagedCachePool",
    "Request",
    "RequestMetrics",
    "Scheduler",
    "ServingConfig",
    "ServingMetrics",
    "make_request",
    "synthetic_requests",
]
