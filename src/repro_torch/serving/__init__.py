"""repro_torch.serving — continuous-batching decode runtime.

A policy admission queue (``queue``), a slot-contiguous or block-paged
persistent KV-cache pool with prefix sharing (``cache``), the
continuous-batching scheduler whose decode step keeps one fixed input
shape as requests churn (``scheduler``), self-speculative decoding — a
cheap engine mode drafts ``draft_k - 1`` tokens, the serving mode
verifies the run in one step, greedy acceptance keeps the tokens of plain
decode (``speculative``) — per-request/aggregate serving metrics
(``metrics``), and the multi-replica router that puts N schedulers behind
one admission queue (``router``).
``launch/serve.py`` is a thin CLI over this package.
"""
from repro_torch.serving.cache import CachePool, PagedCachePool
from repro_torch.serving.metrics import RequestMetrics, ServingMetrics
from repro_torch.serving.queue import (AdmissionQueue, Request, make_request,
                                       synthetic_requests)
from repro_torch.serving.router import (FailurePlan, FleetClock, Replica,
                                        Router, RouterConfig)
from repro_torch.serving.scheduler import Scheduler, ServingConfig
from repro_torch.serving.speculative import SpeculativeDecoder, accept_length

__all__ = [
    "AdmissionQueue",
    "CachePool",
    "FailurePlan",
    "FleetClock",
    "PagedCachePool",
    "Replica",
    "Request",
    "RequestMetrics",
    "Router",
    "RouterConfig",
    "Scheduler",
    "ServingConfig",
    "ServingMetrics",
    "SpeculativeDecoder",
    "accept_length",
    "make_request",
    "synthetic_requests",
]
