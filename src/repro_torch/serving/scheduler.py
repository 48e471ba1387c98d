"""Continuous-batching decode scheduler (the plain path).

The runtime keeps one fixed-size decode batch of ``max_batch`` *slots*
stepping together under a single ``decode_step_slots`` — per-slot
positions, per-slot masks, and an active-slot mask mean the step's input
shapes never change however requests churn (``decode_traces`` counts the
distinct decode input shapes; tests pin it to 1).  Each scheduler step:

1. *backfill* — every free slot is filled from the admission queue
   (lowest-numbered slot first, FIFO requests): the prompt is right-padded
   to a ``prompt_bucket`` multiple, prefilled in one shot (logits read at
   the true last token via ``prefill(last_index=...)``), the resulting
   cache written into the slot of the persistent pool, and the first
   token emitted — that's the request's TTFT.
2. *decode* — one batched step advances every active slot by one token;
   finished slots (budget exhausted or EOS) are evicted and become
   backfill targets on the next step.

With ``ServingConfig(paged=True)`` the KV pool is block-paged (see
:mod:`repro_torch.serving.cache`): admits reserve blocks from a free list
and *defer* when it runs short, evictions return blocks, and the decode
step reads through a fixed-shape block table.

Under ``pim_mode="pim_sim"`` the step's crossbar GEMMs run through the
engine's persistent :class:`ExecutionSession` pool: crossbar state is
uploaded once per (artifact, weight) and only activation columns are
written per token.

Not ported yet (ROADMAP queue 1): prefix caching, chunked and packed
prefill, speculative decoding, the autotuner and the router.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import model_lib as M
from repro_torch.models.config import ModelConfig
from repro_torch.serving.cache import CachePool, PagedCachePool
from repro_torch.serving.metrics import ServingMetrics
from repro_torch.serving.queue import AdmissionQueue, Request, make_request

__all__ = ["ServingConfig", "Scheduler"]


def _idle_sleep(clock, arrival: float, stalls: int,
                cap: float = 0.25) -> int:
    """Sleep toward ``arrival`` on a real clock; returns the stall count.

    One short (1 ms) probe first distinguishes an advancing wall clock
    from an injected test clock (which never moves while we sleep) — once
    the clock demonstrably advances, the rest of the gap is slept in one
    ``cap``-bounded slice instead of thousands of 1 ms spins.
    """
    before = clock()
    time.sleep(min(max(arrival - before, 0.0), 1e-3))
    now = clock()
    if now == before:
        return stalls + 1
    remaining = arrival - now
    if remaining > 0:
        time.sleep(min(remaining, cap))
    return 0


@dataclasses.dataclass(frozen=True)
class ServingConfig:
    """Knobs of the continuous-batching runtime.  Per-slot cache capacity
    is ``cfg.max_seq_len`` (prefill emits caches at exactly that capacity,
    so the pool cannot be sized independently).

    ``paged=True`` swaps the slot-contiguous pool for the block-paged
    :class:`PagedCachePool` (``block_size`` tokens per block;
    ``num_blocks`` physical blocks, default full parity + trash block):
    admits reserve exactly the request's block need from a free list and
    defer when it runs short.
    """

    max_batch: int = 4          # decode slots
    prompt_bucket: int = 16     # prompts pad up to a multiple of this
    pad_id: int = 0
    eos_id: Optional[int] = None   # stop early on this token (None: never)
    paged: bool = False         # block-paged KV pool
    block_size: int = 16        # tokens per KV block (paged pool)
    num_blocks: Optional[int] = None   # physical blocks (None: full parity)


class Scheduler:
    """Continuous-batching scheduler over a persistent cache pool.

    ``params`` must live on ``device`` (default ``"cuda"``)."""

    def __init__(self, params, cfg: ModelConfig, scfg: ServingConfig, *,
                 clock=time.monotonic, device="cuda"):
        if scfg.max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self.device = resolve_device(device)
        self.params = params
        self.cfg = cfg
        self.scfg = scfg
        self.clock = clock
        self.queue = AdmissionQueue()
        self.metrics = ServingMetrics()
        if scfg.paged:
            self.pool = PagedCachePool(
                cfg, scfg.max_batch, cfg.max_seq_len,
                block_size=scfg.block_size, num_blocks=scfg.num_blocks,
                device=self.device)
        else:
            self.pool = CachePool(cfg, scfg.max_batch, cfg.max_seq_len,
                                  device=self.device)

        B = scfg.max_batch
        self._slot_rid = np.full(B, -1, np.int64)
        self._pos = np.zeros(B, np.int32)
        self._tokens = np.zeros((B, 1), np.int32)
        self._remaining = np.zeros(B, np.int64)
        self._outputs: Dict[int, List[int]] = {}
        self._active_req: Dict[int, Request] = {}   # rid -> in-slot request
        # one deferral count per request per wait
        self._deferred_rids: set = set()
        # distinct decode input shapes (the reference counts jit retraces)
        self._decode_shapes: set = set()

    # ------------------------------------------------------------------

    @property
    def active_slots(self) -> np.ndarray:
        """Occupied slots (the decode step's active mask)."""
        return self._slot_rid >= 0

    @property
    def n_active(self) -> int:
        return int(self.active_slots.sum())

    @property
    def decode_traces(self) -> int:
        """Distinct input shapes the batched decode step has seen.  The
        reference counts retraces of its jitted step; eager PyTorch does
        not retrace, so the port counts what a trace would key on.  Tests
        pin this to 1."""
        return len(self._decode_shapes)

    def submit(self, prompt, max_new_tokens: int, *,
               arrival_time: Optional[float] = None) -> int:
        """Enqueue one request; returns its rid."""
        req = make_request(prompt, max_new_tokens,
                           arrival_time=self.clock() if arrival_time is None
                           else arrival_time)
        return self.submit_request(req)

    def validate_request(self, req: Request) -> None:
        """Raise if ``req`` can never be served by this scheduler's pool."""
        plen = req.prompt.shape[0]
        cap = self.pool.max_tokens
        if plen + req.max_new_tokens > cap:
            raise ValueError(
                f"request {req.rid}: prompt {plen} + budget "
                f"{req.max_new_tokens} exceeds cache capacity {cap}")
        if self.pool.paged:
            # a need beyond the whole pool would defer forever
            need = self.pool.blocks_needed(plen + req.max_new_tokens)
            if need > self.pool.num_blocks - 1:
                raise ValueError(
                    f"request {req.rid}: needs {need} KV blocks but the "
                    f"pool holds {self.pool.num_blocks - 1}")

    def submit_request(self, req: Request) -> int:
        self.validate_request(req)
        self.queue.submit(req)
        self.metrics.on_submit(req.rid, req.arrival_time)
        return req.rid

    # ------------------------------------------------------------------

    def _bucket(self, plen: int) -> int:
        bq = max(1, self.scfg.prompt_bucket)
        b = ((plen + bq - 1) // bq) * bq
        return min(b, self.pool.max_len)

    def _finish(self, slot: int, now: float) -> None:
        rid = int(self._slot_rid[slot])
        self.metrics.on_finish(rid, now)
        self._active_req.pop(rid, None)
        self._slot_rid[slot] = -1
        self.pool.evict(slot)

    def _admit(self, emitted: List[Tuple[int, int]]) -> None:
        """Backfill free slots from the queue; appends (rid, token) firsts
        to ``emitted``.

        FIFO with back-pressure: when the paged pool's free list cannot
        cover the head request's block reservation, admission *defers*
        (the head stays queued — no skip-ahead, no crash) until evictions
        return enough blocks.  A request that finishes at admit (budget 1,
        or EOS as its first token) never occupies a slot, so the *same*
        slot is retried with the next queued request.
        """
        free = [int(s) for s in np.flatnonzero(~self.active_slots)]
        while free:
            now = self.clock()
            head = self.queue.peek(now)
            if head is None or head.arrival_time > now:
                break
            plen = head.prompt.shape[0]
            n_tok = plen + head.max_new_tokens
            if not self.pool.can_admit(n_tok):
                if head.rid not in self._deferred_rids:  # count requests,
                    self._deferred_rids.add(head.rid)    # not steps waiting
                    self.metrics.on_deferred_admit()
                break
            req = self.queue.pop(now)
            assert req is head, "peek/pop selection must agree"
            self._deferred_rids.discard(req.rid)
            bucket = self._bucket(plen)
            toks = np.full((1, bucket), self.scfg.pad_id, np.int64)
            toks[0, :plen] = req.prompt
            logits, cache = M.prefill(
                self.params, {"tokens": torch.as_tensor(toks).to(self.device)},
                self.cfg, last_index=torch.tensor([plen - 1],
                                                  device=self.device))
            first = int(torch.argmax(logits, dim=-1)[0])
            now = self.clock()
            self.metrics.on_admit(req.rid, now)
            self.metrics.on_token(req.rid, now)
            self._outputs[req.rid] = [first]
            emitted.append((req.rid, first))
            if req.max_new_tokens <= 1 or first == self.scfg.eos_id:
                # finished at admit: never touches a slot; retry the same
                # slot with the next queued request
                self.metrics.on_finish(req.rid, now)
                continue
            slot = free.pop(0)
            self.pool.admit(slot, cache, plen, n_tok)
            self._slot_rid[slot] = req.rid
            self._active_req[req.rid] = req
            self._tokens[slot, 0] = first
            self._pos[slot] = plen
            self._remaining[slot] = req.max_new_tokens - 1

    def _decode(self, active: np.ndarray):
        dev = self.device
        tokens = torch.as_tensor(self._tokens).to(dev)
        pos = torch.as_tensor(self._pos).to(dev)
        act = torch.as_tensor(active).to(dev)
        tables = self.pool.block_tables
        self._decode_shapes.add(
            (tuple(tokens.shape), tuple(pos.shape), tuple(act.shape),
             None if tables is None else tuple(tables.shape)))
        next_tok, _, new_caches = M.decode_step_slots(
            self.params, tokens, pos, act, self.pool.caches, self.cfg,
            block_tables=tables)
        self.pool.caches = new_caches
        return next_tok.cpu().numpy()

    @torch.no_grad()
    def step(self) -> List[Tuple[int, int]]:
        """One scheduler step: backfill, then one batched decode step over
        the active slots.  Returns the (rid, token) pairs emitted."""
        emitted: List[Tuple[int, int]] = []
        self._admit(emitted)
        active = self.active_slots
        if active.any():
            toks = self._decode(active)
            now = self.clock()
            for slot in np.flatnonzero(active):
                rid = int(self._slot_rid[slot])
                tok = int(toks[slot, 0])
                self._outputs[rid].append(tok)
                self.metrics.on_token(rid, now)
                emitted.append((rid, tok))
                self._tokens[slot, 0] = tok
                self._pos[slot] += 1
                self._remaining[slot] -= 1
                if (self._remaining[slot] <= 0
                        or tok == self.scfg.eos_id):
                    self._finish(int(slot), now)
        self.metrics.sample_queue(len(self.queue), self.n_active)
        self.metrics.sample_pool(self.pool.stats(), self._tokens_live())
        return emitted

    def output(self, rid: int) -> np.ndarray:
        """Generated tokens recorded so far for ``rid``."""
        return np.asarray(self._outputs[rid], np.int32)

    def _tokens_live(self) -> float:
        """Positions actually written across active slots (for the
        internal-fragmentation metric; ``_pos`` is the next write index)."""
        cap = getattr(self.pool, "lcap", self.pool.max_len)
        return float(np.minimum(self._pos[self.active_slots], cap).sum())

    def run(self) -> Dict[int, np.ndarray]:
        """Step until the queue drains and every slot finishes.

        Returns rid -> generated tokens (prefill's first token included).
        With an injected clock that does not advance on its own, drive
        ``step()`` manually instead of waiting on future arrivals here —
        ``run`` detects a non-advancing clock and raises rather than spin.
        """
        stalls = 0
        while len(self.queue) or self.active_slots.any():
            progressed = bool(self.step())
            if progressed or self.active_slots.any():
                stalls = 0
                continue
            head = self.queue.peek(self.clock())
            if head is None:
                continue
            stalls = _idle_sleep(self.clock, head.arrival_time, stalls)
            if stalls > 1000:
                raise RuntimeError(
                    "run(): clock is not advancing while requests wait "
                    "to arrive; with an injected test clock, advance it "
                    "and call step() yourself")
        return {rid: np.asarray(toks, np.int32)
                for rid, toks in self._outputs.items()}
