"""Serving metrics: per-request latency and aggregate throughput.

Per request the runtime records the standard serving quantities —
TTFT (arrival to first token, which the scheduler emits at prefill) and
TPOT (mean gap between subsequent tokens) — plus the aggregate
tokens/second over the busy window and queue-depth samples taken once per
scheduler step.  Everything is on the scheduler's injected clock, so tests
drive these deterministically with a fake clock.

Under the multi-replica router each replica's scheduler keeps its own
``ServingMetrics``; :meth:`ServingMetrics.merged` folds them (plus the
metrics stashed from killed replicas) into one fleet view — for a request
recorded by several replicas (drained, then re-served) the *finished*
entry wins, so TTFT/queue-wait stay anchored to the original arrival
while token counts come from the replica that completed it.  The router
stamps the merged object with ``router_policy`` /
``rebalanced_requests`` / ``replica_restarts`` / ``per_replica_tok_s``,
which then appear in :meth:`summary`.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence

__all__ = ["RequestMetrics", "ServingMetrics"]


@dataclasses.dataclass
class RequestMetrics:
    rid: int
    arrival_time: float
    admit_time: Optional[float] = None
    first_token_time: Optional[float] = None
    last_token_time: Optional[float] = None
    finish_time: Optional[float] = None
    n_tokens: int = 0
    prefix_tokens: int = 0      # prompt tokens served from the prefix index

    @property
    def ttft(self) -> float:
        """Time to first token: arrival -> first emitted token."""
        if self.first_token_time is None:
            return math.nan
        return self.first_token_time - self.arrival_time

    @property
    def tpot(self) -> float:
        """Mean time per output token after the first (decode cadence)."""
        if self.last_token_time is None or self.n_tokens < 2:
            return math.nan
        return ((self.last_token_time - self.first_token_time)
                / (self.n_tokens - 1))

    @property
    def queue_wait(self) -> float:
        if self.admit_time is None:
            return math.nan
        return self.admit_time - self.arrival_time


class ServingMetrics:
    """Aggregates RequestMetrics + queue-depth samples into a summary."""

    def __init__(self):
        self.requests: Dict[int, RequestMetrics] = {}
        self.queue_depth_samples: List[int] = []
        self.active_samples: List[int] = []
        self.pool_samples: List[Dict[str, float]] = []
        self.tpot_samples: List[float] = []   # every inter-token gap
        self.deferred_admits = 0
        self.prefill_chunks = 0     # chunked-prefill calls (first + resumed)
        self.packed_prefills = 0    # multi-segment packed prefill calls
        # speculative decode (one on_spec_round per active slot per round):
        # acceptance lengths (pre-clip verify agreement, 1..draft_k) are
        # accumulated as a bounded counter keyed by length — draft_k is
        # small and fixed, so unlike a per-sample list this never grows
        # with server lifetime; drafted/verified/accepted token counters
        # give the draft hit rate and the per-verify-step yield
        self.accept_len_counts: Dict[int, int] = {}
        self.spec_rounds = 0
        self.drafted_tokens = 0     # tokens the cheap draft mode proposed
        self.verified_tokens = 0    # positions the verify step checked
        self.accepted_tokens = 0    # tokens actually committed (clipped)
        # router-level fields; the router stamps these on the merged
        # fleet metrics (router_policy None => single-scheduler summary)
        self.router_policy: Optional[str] = None
        self.rebalanced_requests = 0
        self.replica_restarts = 0
        self.per_replica_tok_s: Dict[int, float] = {}

    def on_submit(self, rid: int, now: float) -> None:
        self.requests[rid] = RequestMetrics(rid=rid, arrival_time=now)

    def on_admit(self, rid: int, now: float,
                 prefix_tokens: int = 0) -> None:
        r = self.requests[rid]
        r.admit_time = now
        r.prefix_tokens = prefix_tokens

    def on_token(self, rid: int, now: float) -> None:
        r = self.requests[rid]
        if r.first_token_time is None:
            r.first_token_time = now
        else:
            # inter-token gap (the TPOT population p99 is computed over):
            # a decode step stalled behind a long prefill shows up here as
            # one large gap — exactly what chunking is meant to bound
            self.tpot_samples.append(now - r.last_token_time)
        r.last_token_time = now
        r.n_tokens += 1

    def on_finish(self, rid: int, now: float) -> None:
        self.requests[rid].finish_time = now

    def sample_queue(self, depth: int, active: int) -> None:
        self.queue_depth_samples.append(depth)
        self.active_samples.append(active)

    def sample_pool(self, stats: Dict[str, float],
                    tokens_live: float = math.nan) -> None:
        """Record one cache-pool occupancy snapshot (``*Pool.stats()``
        shape: kv_bytes_in_use/reserved, blocks_in_use/total,
        ``tokens_reserved`` — the *logical* per-slot reservation, a shared
        block counted once per referencing slot — and ``tokens_in_use`` —
        physical, each allocated block once; the paged pool adds
        blocks_shared / prefix_blocks / cow_copies).  ``tokens_live`` —
        positions actually written — lets the summary report internal
        fragmentation (reserved-but-unwritten token slots inside allocated
        blocks; the logical reservation is the right denominator, a trie
        hit must not read as fragmentation)."""
        self.pool_samples.append(dict(stats, tokens_live=tokens_live))

    def on_deferred_admit(self) -> None:
        """An arrived request stayed queued because the pool's free list
        could not cover its reservation (paged-pool back-pressure)."""
        self.deferred_admits += 1

    def on_prefill_chunk(self) -> None:
        """One chunked-prefill call ran (first chunk or a resumed one)."""
        self.prefill_chunks += 1

    def on_packed_prefill(self) -> None:
        """One packed prefill call served several queued prompts."""
        self.packed_prefills += 1

    def on_spec_round(self, *, drafted: int, verified: int, accepted: int,
                      accept_len: int) -> None:
        """One slot finished one speculative draft/verify round:
        ``drafted`` cheap-mode proposals, ``verified`` positions checked
        in the batched verify step, ``accepted`` tokens committed (after
        budget/EOS clipping), ``accept_len`` the raw verify agreement
        (1..draft_k — what the acceptance histogram is over)."""
        self.spec_rounds += 1
        self.drafted_tokens += drafted
        self.verified_tokens += verified
        self.accepted_tokens += accepted
        self.accept_len_counts[accept_len] = (
            self.accept_len_counts.get(accept_len, 0) + 1)

    # ------------------------------------------------------------------

    @classmethod
    def merged(cls, parts: Sequence["ServingMetrics"]) -> "ServingMetrics":
        """Fold several per-replica metrics into one fleet view.

        A request drained from a killed replica appears in two parts: an
        unfinished entry on the dead replica and (eventually) a finished
        one on its new home.  The finished entry wins; among unfinished
        duplicates the later-touched one does.  Samples concatenate and
        ``deferred_admits`` sum — fleet-wide totals, not averages.
        """
        out = cls()
        for m in parts:
            for rid, r in m.requests.items():
                cur = out.requests.get(rid)
                if cur is None or (cur.finish_time is None
                                   and r.finish_time is not None):
                    out.requests[rid] = r
            out.queue_depth_samples.extend(m.queue_depth_samples)
            out.active_samples.extend(m.active_samples)
            out.pool_samples.extend(m.pool_samples)
            out.tpot_samples.extend(m.tpot_samples)
            out.deferred_admits += m.deferred_admits
            out.prefill_chunks += m.prefill_chunks
            out.packed_prefills += m.packed_prefills
            for k, v in m.accept_len_counts.items():
                out.accept_len_counts[k] = out.accept_len_counts.get(k, 0) + v
            out.spec_rounds += m.spec_rounds
            out.drafted_tokens += m.drafted_tokens
            out.verified_tokens += m.verified_tokens
            out.accepted_tokens += m.accepted_tokens
        return out

    @staticmethod
    def _mean(xs: List[float]) -> float:
        xs = [x for x in xs if not math.isnan(x)]
        return sum(xs) / len(xs) if xs else math.nan

    @staticmethod
    def _p50(xs: List[float]) -> float:
        xs = sorted(x for x in xs if not math.isnan(x))
        if not xs:
            return math.nan
        n = len(xs)
        mid = n // 2
        return xs[mid] if n % 2 else 0.5 * (xs[mid - 1] + xs[mid])

    @staticmethod
    def _p99(xs: List[float]) -> float:
        """99th percentile (nearest-rank) — the chunked-prefill gate's
        tail-latency view of the inter-token-gap population."""
        xs = sorted(x for x in xs if not math.isnan(x))
        if not xs:
            return math.nan
        return xs[min(len(xs) - 1, math.ceil(0.99 * len(xs)) - 1)]

    def summary(self) -> Dict[str, float]:
        rs = list(self.requests.values())
        done = [r for r in rs if r.finish_time is not None]
        total_tokens = sum(r.n_tokens for r in rs)
        t0 = min((r.admit_time for r in rs if r.admit_time is not None),
                 default=math.nan)
        t1 = max((r.finish_time for r in done), default=math.nan)
        busy = t1 - t0 if not (math.isnan(t0) or math.isnan(t1)) else math.nan
        peak_bytes = max((p["kv_bytes_in_use"] for p in self.pool_samples),
                         default=math.nan)
        peak_blocks = max((p["blocks_in_use"] for p in self.pool_samples),
                          default=math.nan)
        occ = self._mean([p["blocks_in_use"] / p["blocks_total"]
                          for p in self.pool_samples if p["blocks_total"]])
        frag = self._mean(
            [1.0 - p["tokens_live"] / p["tokens_reserved"]
             for p in self.pool_samples
             if p["tokens_reserved"] and not math.isnan(p["tokens_live"])])
        admitted = [r for r in rs if r.admit_time is not None]
        hits = [r for r in admitted if r.prefix_tokens > 0]
        misses = [r for r in admitted if r.prefix_tokens == 0]
        peak_shared = max((p.get("blocks_shared", 0.0)
                           for p in self.pool_samples), default=0.0)
        cow = max((p.get("cow_copies", 0.0)
                   for p in self.pool_samples), default=0.0)
        out = {
            "n_requests": len(rs),
            "n_finished": len(done),
            "total_tokens": total_tokens,
            "tokens_per_s": (total_tokens / busy
                             if busy and not math.isnan(busy) else math.nan),
            "mean_ttft_s": self._mean([r.ttft for r in rs]),
            "mean_tpot_s": self._mean([r.tpot for r in rs]),
            # tail of the raw inter-token-gap population (not per-request
            # means): a decode stall behind a monolithic prefill is one
            # huge gap, so this is what chunked prefill improves
            "p99_tpot_s": self._p99(self.tpot_samples),
            "mean_queue_wait_s": self._mean([r.queue_wait for r in rs]),
            "p50_queue_wait_s": self._p50([r.queue_wait for r in rs]),
            "max_queue_depth": max(self.queue_depth_samples, default=0),
            "mean_active_slots": self._mean(
                [float(a) for a in self.active_samples]),
            # cache-pool occupancy (sampled once per scheduler step):
            # peak bytes is the headline paged-vs-contiguous comparison —
            # the contiguous pool reports its static reservation here.
            "peak_kv_bytes": peak_bytes,
            "peak_pool_blocks": peak_blocks,
            "mean_block_occupancy": occ,
            "mean_internal_frag": frag,
            "deferred_admits": self.deferred_admits,
            "prefill_chunks": self.prefill_chunks,
            "packed_prefills": self.packed_prefills,
            # speculative decode: committed tokens per verify round (the
            # speedup driver — plain decode is exactly 1.0), the mean and
            # histogram of raw verify agreement, and the draft/verify
            # token totals behind them (merged() sums across replicas)
            "spec_rounds": self.spec_rounds,
            "drafted_tokens": self.drafted_tokens,
            "verified_tokens": self.verified_tokens,
            "accepted_tokens": self.accepted_tokens,
            "accepted_per_step": (self.accepted_tokens / self.spec_rounds
                                  if self.spec_rounds else math.nan),
            "mean_accept_len": (
                sum(k * v for k, v in self.accept_len_counts.items())
                / sum(self.accept_len_counts.values())
                if self.accept_len_counts else math.nan),
            "accept_len_hist": {
                k: self.accept_len_counts[k]
                for k in sorted(self.accept_len_counts)},
            # prefix caching: hit rate over admitted requests, prompt
            # tokens served straight from the index (no prefill compute),
            # and the TTFT split that the warm/cold benchmark gate reads
            "prefix_hit_rate": (len(hits) / len(admitted) if admitted
                                else math.nan),
            "prefix_tokens_reused": float(sum(r.prefix_tokens
                                              for r in admitted)),
            "mean_ttft_hit_s": self._mean([r.ttft for r in hits]),
            "mean_ttft_miss_s": self._mean([r.ttft for r in misses]),
            "peak_blocks_shared": peak_shared,
            "cow_copies": cow,
        }
        if self.router_policy is not None:
            out.update({
                "router_policy": self.router_policy,
                "rebalanced_requests": self.rebalanced_requests,
                "replica_restarts": self.replica_restarts,
                "per_replica_tok_s": dict(self.per_replica_tok_s),
            })
        return out
