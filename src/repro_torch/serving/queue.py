"""Request admission: the policy queue feeding the continuous-batching
scheduler (and, one level up, the multi-replica router).

A :class:`Request` is one decode job — a prompt, a generation budget, and
an arrival time — plus the migration bookkeeping the router needs:
``replica_id`` names the engine currently serving it and ``n_migrations``
counts drain-and-requeue hops after replica failures.  Both survive a
requeue untouched except for the migration bump, and ``arrival_time`` is
**never** rewritten: queue-wait and TTFT metrics stay anchored to the
moment the request first entered the system, not to its latest requeue
(a drain must not launder latency).

The :class:`AdmissionQueue` supports two admission policies:

* ``"fifo"`` (default) — strictly submit order; ``pop(now)`` gates on the
  *head's* arrival time only, so a synthetic (e.g. Poisson) trace can be
  loaded up front and replayed against a clock.
* ``"sjf"`` — shortest-prompt-first among the requests that have
  *arrived* by ``now`` (ties break toward the earlier submit).  Prompt
  length is the serving-side proxy for job size: prefill cost is linear
  in it and it is known at admission, unlike the generation length.
  While nothing has arrived yet, ``peek`` reports the earliest-arriving
  request so callers can sleep until it lands.

``requeue`` re-inserts a drained (already-admitted-once) request at the
*front* of the FIFO order — it is, by construction, among the oldest
work in the system — while SJF re-ranks it with everyone else.
"""
from __future__ import annotations

import collections
import dataclasses
import itertools
from typing import Deque, Iterator, List, Optional, Sequence

import numpy as np

__all__ = ["Request", "AdmissionQueue", "synthetic_requests"]

_rid_counter = itertools.count()

QUEUE_POLICIES = ("fifo", "sjf")


@dataclasses.dataclass
class Request:
    """One decode request.

    ``max_new_tokens`` counts every generated token, including the first
    one emitted by prefill.  ``arrival_time`` is on the scheduler's clock
    (``time.monotonic`` unless injected) and is preserved across router
    requeues.  ``n_migrations`` counts drain-and-requeue hops (0 for a
    request that never lost its replica); ``replica_id`` is the serving
    replica currently assigned by the router (-1 outside a router).
    """

    rid: int
    prompt: np.ndarray              # (plen,) int32 token ids
    max_new_tokens: int
    arrival_time: float = 0.0
    n_migrations: int = 0
    replica_id: int = -1

    def __post_init__(self):
        self.prompt = np.asarray(self.prompt, np.int32).reshape(-1)
        if self.prompt.size == 0:
            raise ValueError(f"request {self.rid}: empty prompt")
        if self.max_new_tokens < 1:
            raise ValueError(
                f"request {self.rid}: max_new_tokens must be >= 1")


def make_request(prompt, max_new_tokens: int, *, rid: Optional[int] = None,
                 arrival_time: float = 0.0) -> Request:
    """Build a request, auto-assigning a process-unique rid if not given."""
    return Request(rid=next(_rid_counter) if rid is None else rid,
                   prompt=prompt, max_new_tokens=max_new_tokens,
                   arrival_time=arrival_time)


class AdmissionQueue:
    """Admission queue with pluggable policy (see module docstring).

    ``peek(now)`` must return exactly the request a ``pop(now)`` would
    remove — the scheduler inspects the head (capacity check, prefix
    match) before committing to the pop, so selection is deterministic:
    FIFO is submit order, SJF is ``(prompt length, submit order)`` over
    the arrived subset.
    """

    def __init__(self, policy: str = "fifo"):
        if policy not in QUEUE_POLICIES:
            raise ValueError(f"unknown queue policy {policy!r} "
                             f"(choose from {QUEUE_POLICIES})")
        self.policy = policy
        self._q: Deque[Request] = collections.deque()

    def submit(self, request: Request) -> None:
        self._q.append(request)

    def requeue(self, request: Request) -> None:
        """Re-insert a drained request at the front of the FIFO order
        (it was admitted once already — among the oldest work alive).
        Its ``arrival_time`` is deliberately left alone; queue-wait /
        TTFT metrics must keep measuring from first arrival."""
        self._q.appendleft(request)

    # ---- selection ---------------------------------------------------

    def _select(self, now: Optional[float]) -> Optional[int]:
        """Index of the request ``pop(now)`` would remove, or None."""
        if not self._q:
            return None
        if self.policy == "fifo":
            if now is not None and self._q[0].arrival_time > now:
                return None
            return 0
        # sjf: shortest arrived prompt; ties to the earlier submit
        best = None
        for i, r in enumerate(self._q):
            if now is not None and r.arrival_time > now:
                continue
            key = (r.prompt.shape[0], i)
            if best is None or key < best[0]:
                best = (key, i)
        return None if best is None else best[1]

    def pop(self, now: Optional[float] = None) -> Optional[Request]:
        """The policy's pick among requests arrived by ``now`` (None:
        ignore arrival times), removed from the queue."""
        i = self._select(now)
        if i is None:
            return None
        r = self._q[i]
        del self._q[i]
        return r

    def peek(self, now: Optional[float] = None) -> Optional[Request]:
        """The request ``pop(now)`` would return; when nothing has
        arrived yet, the earliest-arriving request (so callers can wait
        on its ``arrival_time``)."""
        i = self._select(now)
        if i is not None:
            return self._q[i]
        if not self._q:
            return None
        if self.policy == "fifo":
            return self._q[0]
        return min(self._q, key=lambda r: r.arrival_time)

    def take(self, rid: int) -> Request:
        """Remove and return the queued request ``rid`` (the router over
        ranks pops what world rank 0 dispatched)."""
        for i, r in enumerate(self._q):
            if r.rid == rid:
                del self._q[i]
                return r
        raise KeyError(f"request {rid} is not queued")

    def clear(self) -> List[Request]:
        """Remove and return every queued request (drain support)."""
        out = list(self._q)
        self._q.clear()
        return out

    def __len__(self) -> int:
        return len(self._q)

    def __iter__(self) -> Iterator[Request]:
        return iter(self._q)


def synthetic_requests(n: int, *, vocab_size: int, prompt_lens: Sequence[int],
                       max_new_tokens: int = 16, rate: float = 0.0,
                       seed: int = 0, start_time: float = 0.0,
                       shared_prefix_len: int = 0,
                       n_tenants: int = 1) -> List[Request]:
    """A deterministic synthetic trace: random prompts, Poisson arrivals.

    ``rate`` is the arrival rate in requests/second (exponential
    inter-arrival gaps); 0 puts every request at ``start_time`` (a closed
    batch).  Prompt lengths cycle through ``prompt_lens``.

    ``shared_prefix_len`` > 0 prepends one fixed random token run of that
    length to every prompt — a shared system prompt, the prefix-caching
    workload; ``prompt_lens`` then size each request's divergent tail.
    ``n_tenants`` > 1 draws that many *distinct* shared prefixes and
    cycles requests through them (request ``i`` belongs to tenant
    ``i % n_tenants``) — the multi-tenant workload whose per-tenant
    system prompts the router's ``prefix_affinity`` policy keeps pinned
    to one replica's trie.  All shared runs are drawn first, so traces
    built with the same ``seed``/``shared_prefix_len``/``n_tenants``
    share them across calls (warm-up vs measured trace in the
    benchmarks).
    """
    if n_tenants < 1:
        raise ValueError("n_tenants must be >= 1")
    rng = np.random.default_rng(seed)
    shared = (rng.integers(0, vocab_size,
                           size=(n_tenants, shared_prefix_len),
                           dtype=np.int64)
              if shared_prefix_len > 0 else None)
    t = start_time
    out: List[Request] = []
    for i in range(n):
        if rate > 0 and i > 0:
            t += float(rng.exponential(1.0 / rate))
        plen = int(prompt_lens[i % len(prompt_lens)])
        tail = rng.integers(0, vocab_size, size=(plen,), dtype=np.int64)
        out.append(make_request(
            tail if shared is None
            else np.concatenate([shared[i % n_tenants], tail]),
            max_new_tokens, arrival_time=t))
    return out
