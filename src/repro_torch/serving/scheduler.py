"""Continuous-batching decode scheduler.

The runtime keeps one fixed-size decode batch of ``max_batch`` *slots*
stepping together under a single ``decode_step_slots`` — per-slot
positions, per-slot masks, and an active-slot mask mean the step's input
shapes never change however requests churn (``decode_traces`` counts the
distinct decode input shapes; tests pin it to 1).  Each scheduler step:

1. *resume* — every mid-prefill slot advances by one prompt chunk
   (chunked prefill, below); a prompt whose last chunk lands emits its
   first token and joins the decode batch.
2. *backfill* — every free slot is filled from the admission queue
   (lowest-numbered slot first, in queue-policy order): the prompt is
   right-padded to a ``prompt_bucket`` multiple, prefilled in one shot
   (logits read at the true last token via ``prefill(last_index=...)``),
   the resulting cache written into the slot of the persistent pool, and
   the first token emitted — that's the request's TTFT.
3. *decode* — one batched step advances every decoding slot by one token;
   finished slots (budget exhausted or EOS) are evicted and become
   backfill targets on the next step.

With ``ServingConfig(paged=True)`` the KV pool is block-paged (see
:mod:`repro_torch.serving.cache`): admits reserve blocks from a free list
and *defer* when it runs short, evictions return blocks, and the decode
step reads through a fixed-shape block table.  Sliding-window configs
serve as rings over their block lists and page unconditionally (prompts
bucket only while the padded length stays inside the window).  A stack
with recurrent blocks (Mamba, Mamba-2, xLSTM) folds padding into its
state, so it serves only at ``prompt_bucket=1``; its per-slot state stays
slot-indexed in either pool.

``ServingConfig(prefix_cache=True)`` attaches the pool's prefix index:
admission walks a trie over the prompt tokens, maps every fully matched
block into the slot by reference, and prefills only the divergent tail
(``prefill(prefix=...)`` resumed at the block-aligned match length).
Shared blocks are copy-on-write: before each decode step the scheduler
upgrades any slot about to write into one (``ensure_writable``).

**Chunked prefill** (``ServingConfig(prefill_chunk=, step_token_budget=)``)
splits a long prompt across steps: the first chunk admits normally
(reserving the request's *full* block need up front), the slot is marked
mid-prefill — occupied but excluded from the decode batch's active mask —
and each later step resumes one more chunk through the block-aligned
``prefill(prefix=...)`` path, reading the slot's own already-written
blocks back as the prefix.  The last chunk emits the first token.
``step_token_budget`` caps the prefill tokens (resumed chunks + new
admissions) any single step processes; the first work item of a step is
always allowed.

**Packed prefill** (``ServingConfig(packed_prefill=True)``) batches a
burst of short queued prompts into *one* ``prefill_packed`` call:
segments ride a single (1, L) token stream with per-segment positions and
a block-diagonal segment mask.  Heads are popped in queue-policy order and
packing stops at the first ineligible head — no skip-ahead.

All three need the paged pool (and turn it on) and KV that depends only on
the tokens before it: no recurrent blocks, no MoE.  A windowed prompt
chunks or packs only while it fits inside the window, where its ring
layout is the dense one; a longer one takes the cold whole prefill, which
lays the ring out directly.

Under ``pim_mode="pim_sim"`` the decode step's crossbar GEMMs run through
the engine's persistent :class:`ExecutionSession` pool: crossbar state is
uploaded once per (artifact, weight) and only activation columns are
written per token; prefill runs on transient state
(``pim.engine.transient``).

**Speculative decoding** (``ServingConfig(speculative=True,
draft_mode=, draft_k=)``): each decode step becomes one round of
:class:`~repro_torch.serving.speculative.SpeculativeDecoder` — ``draft_k
- 1`` single-token steps in the cheap ``draft_mode``, one ``(B, draft_k)``
verify step in the serving mode, and the longest exactly matching prefix
committed per slot.  Tokens stay those of plain decode.  It is active
only when ``draft_k > 1`` and the draft mode differs from the serving
mode; otherwise the scheduler decodes plainly.

**Autotuning** (``ServingConfig(autotune=True, autotune_trials=)``):
under ``pim_sim`` the scheduler's construction plans every distinct
linear shape of the parameter tree at the decode batch bucket
(``pim.autotune.plan_for_params``, on the scheduler's device) and turns
ambient plan lookup on, so the decode loop's GEMMs run the tuned
configuration from the first token; tokens are those of an untuned serve.

:meth:`Scheduler.drain` empties a scheduler for the fleet router
(:mod:`repro_torch.serving.router`): every in-flight request comes back
for requeueing and nothing of it stays in the pool.
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
from repro_torch.pim import engine
from repro_torch.runtime.trace import span
from repro_torch.serving.cache import CachePool, PagedCachePool
from repro_torch.serving.metrics import ServingMetrics
from repro_torch.serving.queue import AdmissionQueue, Request, make_request
from repro_torch.serving.speculative import SpeculativeDecoder, accept_length

__all__ = ["ServingConfig", "Scheduler"]

#: Packed-prefill stream cap: keeping the packed length inside one flash
#: key block (block_k = 512) means every segment's online-softmax pass
#: sees a single-block reduction, as its unpacked prefill does.  Longer
#: prompts chunk instead.
_PACK_MAX_TOKENS = 512


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

    ``prefix_cache=True`` attaches the trie prefix index with
    copy-on-write block sharing.  ``prefill_chunk=N`` splits every long
    prompt's prefill into N-token chunks interleaved with decode steps (N
    must be a ``block_size`` multiple — chunk resumes ride the
    block-aligned prefix-resume path); ``step_token_budget=B`` caps the
    prefill tokens one step may process; ``packed_prefill=True`` batches
    short queued prompts into one segment-masked prefill call.  All of
    them imply the paged pool.  ``queue_policy`` orders admission
    (``"fifo"`` or ``"sjf"``, shortest prompt first).  ``speculative=True``
    decodes in rounds of ``draft_k - 1`` ``draft_mode`` drafts and one
    verify step (see :mod:`repro_torch.serving.speculative`).

    ``autotune=True`` runs the partition autotuner at construction when the
    model decodes on the crossbar simulator (``cfg.pim_mode == "pim_sim"``):
    every distinct linear shape in the parameter tree is planned at the
    decode batch bucket (``pim.autotune.plan_for_params``, with
    ``autotune_trials`` timed trials per raced candidate) and ambient plan
    lookup is switched on, so the decode loop's GEMMs run the tuned
    configuration.  Shapes already in the tuner table (e.g. reloaded via
    ``serve.py --autotune-table``) are warmup hits — no re-search.
    """

    max_batch: int = 4          # decode slots
    prompt_bucket: int = 16     # prompts pad up to a multiple of this
    pad_id: int = 0
    eos_id: Optional[int] = None   # stop early on this token (None: never)
    paged: bool = False         # block-paged KV pool
    block_size: int = 16        # tokens per KV block (paged pool)
    num_blocks: Optional[int] = None   # physical blocks (None: full parity)
    prefix_cache: bool = False  # trie prefix sharing + COW (implies paged)
    queue_policy: str = "fifo"  # admission order: "fifo" | "sjf"
    autotune: bool = False      # plan crossbar GEMMs at warmup (pim_sim)
    autotune_trials: int = 1    # timed trials per candidate during warmup
    prefill_chunk: Optional[int] = None  # split prefill into chunks of this
    #   many tokens (block_size multiple; implies paged)
    step_token_budget: Optional[int] = None  # max prefill tokens per step
    packed_prefill: bool = False  # pack short prompts into one prefill call
    #   (implies paged)
    speculative: bool = False   # self-speculative decode: a cheap draft
    #   mode proposes, the serving mode verifies, greedy acceptance is
    #   exact (see serving.speculative) — tokens stay those of plain decode
    draft_mode: str = "quant"   # the drafting lowering; how often its
    #   drafts are accepted depends on the pair and is measured, not
    #   assumed (quant rounds to 8 bits, pim_sim to 7)
    draft_k: int = 4            # verify width: tokens fed per verify step
    #   (the draft pass proposes draft_k - 1; draft_k=1 is plain decode)


def _validate(cfg: ModelConfig, scfg: ServingConfig) -> None:
    """The reference's configuration checks: prefix sharing, chunked and
    packed prefill rebuild a slot's KV from per-token caches laid out by
    absolute position, so a token's KV must depend only on the tokens
    before it — recurrent state folds the whole prefix into one vector,
    and MoE capacity dropping couples a token's KV to its batch-mates.
    The same folding makes a recurrent stack refuse padded prompts."""
    # recurrent state folds right-padding into the prefix: bucketed
    # prefill would silently change generations
    if cfg.has_recurrent_blocks and scfg.prompt_bucket != 1:
        raise ValueError(
            f"{cfg.name}: SSM/xLSTM blocks require prompt_bucket=1 "
            "(padding folds into the recurrent state)")
    chunked = scfg.prefill_chunk is not None
    for what, on in (("prefix_cache", scfg.prefix_cache),
                     ("prefill_chunk", chunked),
                     ("packed_prefill", scfg.packed_prefill)):
        if not on:
            continue
        if cfg.has_recurrent_blocks:
            raise ValueError(
                f"{cfg.name}: {what} is incompatible with SSM/xLSTM blocks "
                "(recurrent state is not prefix-separable)")
        if cfg.n_experts:
            raise ValueError(
                f"{cfg.name}: {what} is incompatible with MoE (capacity "
                "dropping couples a token's KV to its batch-mates)")
    if chunked and (scfg.prefill_chunk < 1
                    or scfg.prefill_chunk % scfg.block_size):
        raise ValueError(
            f"prefill_chunk={scfg.prefill_chunk} must be a positive "
            f"multiple of block_size={scfg.block_size} (chunk resumes are "
            "block-aligned)")
    if scfg.step_token_budget is not None:
        if scfg.step_token_budget < 1:
            raise ValueError("step_token_budget must be >= 1")
        if chunked and scfg.step_token_budget < scfg.prefill_chunk:
            raise ValueError(
                f"step_token_budget={scfg.step_token_budget} below "
                f"prefill_chunk={scfg.prefill_chunk}: no step could ever "
                "schedule a chunk")
    if scfg.speculative:
        if scfg.draft_k < 1:
            raise ValueError(f"draft_k={scfg.draft_k} must be >= 1")
        if scfg.draft_mode not in engine.MODES:
            raise ValueError(
                f"unknown draft_mode {scfg.draft_mode!r}; expected one of "
                f"{engine.MODES}")
        if cfg.sliding_window:
            # a windowed slot is a ring: the verify run's writes destroy
            # rows a rejected draft must roll back to
            raise ValueError(
                f"{cfg.name}: speculative decode is incompatible with "
                "sliding_window (ring writes destroy rows a rejected draft "
                "must roll back to)")
        if cfg.has_recurrent_blocks:
            raise ValueError(
                f"{cfg.name}: speculative decode is incompatible with "
                "SSM/xLSTM blocks (recurrent state cannot roll back a "
                "rejected draft)")
        if cfg.n_experts:
            raise ValueError(
                f"{cfg.name}: speculative decode is incompatible with MoE "
                "(capacity dropping couples the verify run's positions)")


def _rank0_clock(clock, mesh):
    """``clock`` as rank 0 reads it, on every rank of ``mesh``.

    Every rank must run the same sequence of linears, and so admit the
    same requests on the same step; a rank that read its own clock could
    admit on another step and wait forever in the next collective.  Each
    reading is rank 0's, broadcast, so rank 0 decides which requests have
    arrived and every later decision is the same on every rank (greedy
    tokens come from bit-identical replicated logits)."""
    from repro_torch.dist import context as dctx

    def read() -> float:
        return dctx.broadcast_float(clock(), mesh)

    return read


class Scheduler:
    """Continuous-batching scheduler over a persistent cache pool.

    ``params`` must live on ``device`` (default ``"cuda"``).  Run the
    scheduler inside ``dist.context.use_mesh``: the steps' linears split
    over the active mesh, as in the reference, and when the mesh active at
    construction spans more than one process, every reading of ``clock``
    is rank 0's (:func:`_rank0_clock`)."""

    def __init__(self, params, cfg: ModelConfig, scfg: ServingConfig, *,
                 clock=time.monotonic, device="cuda"):
        if scfg.max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        # enc-dec / vision prefill needs frames/patches carried per request
        # and their cross-attention caches pooled; the reference serves
        # neither, so neither does the port
        if cfg.is_encoder_decoder or cfg.vision_dim:
            raise NotImplementedError(
                f"{cfg.name}: multimodal serving (frames/patches on the "
                "request) is a ROADMAP follow-on; decoder-only stacks only")
        _validate(cfg, scfg)
        self.device = resolve_device(device)
        self.params = params
        self.cfg = cfg
        self.scfg = scfg
        from repro_torch.dist import context as dctx

        mesh = dctx.current_mesh()
        self.clock = (_rank0_clock(clock, mesh) if mesh is not None
                      and mesh.size > 1 else clock)
        self.queue = AdmissionQueue(policy=scfg.queue_policy)
        self.metrics = ServingMetrics()
        # autotune warmup: plan every linear shape at the decode batch
        # bucket before the first prefill, so steady-state decode runs the
        # tuned configuration from token one.  Table hits (a reloaded
        # tuning table) make this free.
        self.autotuned_shapes = 0
        if scfg.autotune and cfg.pim_mode == "pim_sim":
            from repro_torch.pim import autotune

            autotune.enable(True)
            self.autotuned_shapes = autotune.plan_for_params(
                params, scfg.max_batch, trials=scfg.autotune_trials,
                device=self.device)
        # sliding-window slots are rings over their block list — only the
        # paged pool lays them out, so windowed configs page
        # unconditionally; chunked/packed prefill scatter per-chunk /
        # per-segment caches at block offsets, which only the paged layout
        # supports
        if (scfg.paged or scfg.prefix_cache or cfg.sliding_window
                or scfg.packed_prefill or scfg.prefill_chunk is not None):
            self.pool = PagedCachePool(
                cfg, scfg.max_batch, cfg.max_seq_len,
                block_size=scfg.block_size, num_blocks=scfg.num_blocks,
                device=self.device, prefix_cache=scfg.prefix_cache)
        else:
            self.pool = CachePool(cfg, scfg.max_batch, cfg.max_seq_len,
                                  device=self.device)
        self._prefix_on = (scfg.prefix_cache
                           and getattr(self.pool, "prefix", None) is not None)

        B = scfg.max_batch
        self._slot_rid = np.full(B, -1, np.int64)
        self._pos = np.zeros(B, np.int32)
        self._tokens = np.zeros((B, 1), np.int32)
        self._remaining = np.zeros(B, np.int64)
        self._outputs: Dict[int, List[int]] = {}
        self._active_req: Dict[int, Request] = {}   # rid -> in-slot request
        # chunked prefill: a slot can be occupied but still mid-prefill —
        # excluded from the decode batch until its last chunk lands
        self._prefilling = np.zeros(B, bool)
        self._prefill_done = np.zeros(B, np.int64)  # prompt tokens cached
        # one deferral count per request per wait
        self._deferred_rids: set = set()
        # distinct decode input shapes (the reference counts jit retraces)
        self._decode_shapes: set = set()
        # speculative decode: active only when a round can beat plain
        # decode — draft_k=1 drafts nothing and a draft mode equal to the
        # verify mode would run the full-price model twice per token; both
        # decode plainly, with the same tokens
        self._spec: Optional[SpeculativeDecoder] = None
        if (scfg.speculative and scfg.draft_k > 1
                and scfg.draft_mode != (cfg.pim_mode or "xla")):
            self._spec = SpeculativeDecoder(cfg, scfg.draft_mode,
                                            scfg.draft_k)

    # ------------------------------------------------------------------

    @property
    def active_slots(self) -> np.ndarray:
        """Occupied slots, mid-prefill ones included."""
        return self._slot_rid >= 0

    @property
    def decoding_slots(self) -> np.ndarray:
        """Occupied slots past prefill: the decode step's active mask."""
        return self.active_slots & ~self._prefilling

    @property
    def n_active(self) -> int:
        return int(self.active_slots.sum())

    @property
    def decode_traces(self) -> int:
        """Distinct input shapes the batched decode step has seen — the
        plain (B, 1) step's plus, under speculation, the (B, k) verify
        step's (it *is* the decode step there).  The reference counts
        retraces of its jitted steps; eager PyTorch does not retrace, so
        the port counts what a trace would key on.  Tests pin this to 1."""
        return len(self._decode_shapes) + self.verify_traces

    @property
    def draft_traces(self) -> int:
        """Distinct input shapes of the speculative draft step (0 when
        speculation is off or short-circuited)."""
        return self._spec.draft_traces if self._spec is not None else 0

    @property
    def verify_traces(self) -> int:
        """Distinct input shapes of the speculative verify step (0 when
        speculation is off or short-circuited)."""
        return self._spec.verify_traces if self._spec is not None else 0

    @property
    def verify_steps(self) -> int:
        """Speculative rounds run: one verify step each (0 when speculation
        is off or short-circuited)."""
        return self._spec.rounds if self._spec is not None else 0

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
        cap = self.pool.max_tokens      # None: windowed ring, unbounded
        if cap is not None and plen + req.max_new_tokens > cap:
            raise ValueError(
                f"request {req.rid}: prompt {plen} + budget "
                f"{req.max_new_tokens} exceeds cache capacity {cap}")
        if self.pool.paged:
            # a need beyond the whole pool would defer forever;
            # ``blocks_needed`` clamps a windowed request to its ring, so a
            # long windowed request budgets only the ring
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
        w = self.cfg.sliding_window
        if w:
            # bucket padding past the window would evict real KV from the
            # prefill ring; prompts that can't bucket inside it run unpadded
            return b if b <= w else plen
        return min(b, self.pool.max_len)

    def _bucket_tail(self, tlen: int, m: int) -> int:
        """Bucket for the divergent tail of a trie-hit prompt (or a later
        chunk): the tail prefill emits an unpadded cache and the pool masks
        pad positions out at scatter time, so — unlike cold windowed
        prefill — padding past the window is harmless here; only the slot's
        logical capacity beyond the prefix bounds it."""
        bq = max(1, self.scfg.prompt_bucket)
        b = ((tlen + bq - 1) // bq) * bq
        cap = getattr(self.pool, "lcap", self.pool.max_len) - m
        return max(tlen, min(b, cap))

    def _finish(self, slot: int, now: float) -> None:
        rid = int(self._slot_rid[slot])
        self.metrics.on_finish(rid, now)
        self._active_req.pop(rid, None)
        self._slot_rid[slot] = -1
        self.pool.evict(slot)

    def _dense_prefill_ok(self, plen: int) -> bool:
        """Whether chunked prefill may serve a ``plen`` prompt: a windowed
        slot's ring layout equals the dense layout only while the prompt
        fits inside the window — past it, the cold whole-prefill path
        (which lays the ring out directly) is the only exact one."""
        w = self.cfg.sliding_window
        return not w or plen <= w

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.int64)).to(self.device)

    def _prefill(self, toks: np.ndarray, last: int, prefix=None):
        return M.prefill(self.params, {"tokens": self._tensor(toks)},
                         self.cfg, last_index=self._tensor([last]),
                         prefix=prefix)

    def _packable(self, req: Request, m: int) -> bool:
        """Whether ``req`` may join a packed prefill: trie misses only
        (hits resume, they don't prefill the prompt), short enough to stay
        inside one flash key block, below the chunking threshold (long
        prompts chunk instead), and — windowed — inside the window."""
        if m:
            return False
        plen = req.prompt.shape[0]
        b = self._bucket(plen)
        chunk = self.scfg.prefill_chunk
        if chunk is not None and plen > chunk:
            return False
        if b > _PACK_MAX_TOKENS:
            return False
        w = self.cfg.sliding_window
        return not w or b <= w

    def _collect_pack(self, now: float, n_free: int,
                      spent: int) -> List[Request]:
        """Pop the (pre-validated, packable) head plus every immediately
        following packable head that fits the pack — stopping at the first
        ineligible one (no skip-ahead), at ``n_free`` slots, at the flash
        block cap, at the step budget, or when the free list can't cover
        the *cumulative* reservation (``can_admit(extra_reserved=)``)."""
        budget = self.scfg.step_token_budget
        first = self.queue.pop(now)
        self._deferred_rids.discard(first.rid)
        pack = [first]
        total = self._bucket(first.prompt.shape[0])
        reserved = self.pool.blocks_needed(
            first.prompt.shape[0] + first.max_new_tokens)
        while len(pack) < n_free:
            head = self.queue.peek(now)
            if head is None or head.arrival_time > now:
                break
            m = (self.pool.prefix_match(head.prompt)[0] if self._prefix_on
                 else 0)
            if not self._packable(head, m):
                break
            b = self._bucket(head.prompt.shape[0])
            if total + b > _PACK_MAX_TOKENS:
                break
            if budget is not None and spent + total + b > budget:
                break
            n_tok = head.prompt.shape[0] + head.max_new_tokens
            if not self.pool.can_admit(n_tok, extra_reserved=reserved):
                break
            req = self.queue.pop(now)
            assert req is head, "peek/pop selection must agree"
            self._deferred_rids.discard(req.rid)
            pack.append(req)
            total += b
            reserved += self.pool.blocks_needed(n_tok)
        return pack

    def _admit_packed(self, pack: List[Request], free: List[int],
                      emitted: List[Tuple[int, int]]) -> int:
        """One ``prefill_packed`` call for the whole pack; returns the
        packed stream length (the step-budget cost).  Segment ``i``'s
        prompt occupies ``starts[i]..starts[i]+plen-1`` of the stream
        (bucket-aligned widths: the shapes unpacked bucketed prefill
        runs), and its cache is unpacked by
        ``PagedCachePool.admit(start=starts[i])``."""
        widths = [self._bucket(r.prompt.shape[0]) for r in pack]
        starts = np.concatenate([[0], np.cumsum(widths[:-1])]).astype(int)
        L = int(sum(widths))
        toks = np.full((1, L), self.scfg.pad_id, np.int64)
        pos = np.zeros(L, np.int64)
        seg = np.full(L, -1, np.int64)   # padding matches no real segment
        last = np.zeros(len(pack), np.int64)
        for i, (r, s0, w) in enumerate(zip(pack, starts, widths)):
            plen = r.prompt.shape[0]
            toks[0, s0:s0 + plen] = r.prompt
            pos[s0:s0 + w] = np.arange(w)
            seg[s0:s0 + plen] = i
            last[i] = s0 + plen - 1
        with span("sched.prefill", [r.rid for r in pack]):
            logits, cache = M.prefill_packed(
                self.params, self._tensor(toks), self._tensor(pos),
                self._tensor(seg), self._tensor(last), self.cfg)
        self.metrics.on_packed_prefill()
        firsts = torch.argmax(logits, dim=-1).cpu().numpy()
        now = self.clock()
        for i, r in enumerate(pack):
            plen = r.prompt.shape[0]
            first = int(firsts[i])
            self.metrics.on_admit(r.rid, now)
            self.metrics.on_token(r.rid, now)
            self._outputs[r.rid] = [first]
            emitted.append((r.rid, first))
            if r.max_new_tokens <= 1 or first == self.scfg.eos_id:
                # finished at admit: never touches a slot
                self.metrics.on_finish(r.rid, now)
                continue
            slot = int(free.pop(0))
            self.pool.admit(slot, cache, plen, plen + r.max_new_tokens,
                            prompt=r.prompt if self._prefix_on else None,
                            start=int(starts[i]))
            self._occupy(slot, r, first, plen)
        return L

    def _occupy(self, slot: int, req: Request, first: int, plen: int
                ) -> None:
        """Put ``req`` into the decode batch at ``slot``: its first token is
        out and ``plen`` positions are cached."""
        self._slot_rid[slot] = req.rid
        self._active_req[req.rid] = req
        self._tokens[slot, 0] = first
        self._pos[slot] = plen
        self._remaining[slot] = req.max_new_tokens - 1

    def _begin_chunked(self, slot: int, req: Request, m: int,
                       pblocks: List[int]) -> None:
        """Admit ``req``'s *first* prefill chunk into ``slot`` and mark it
        mid-prefill.  The pool reserves the request's full block need up
        front (later chunks extend in place, they never allocate), so a
        mid-prefill slot can always finish without deferring."""
        chunk = self.scfg.prefill_chunk
        plen = req.prompt.shape[0]
        n_tok = plen + req.max_new_tokens
        if m:
            toks = np.full((1, self._bucket_tail(chunk, m)),
                           self.scfg.pad_id, np.int64)
            toks[0, :chunk] = req.prompt[m:m + chunk]
            with span("sched.prefill", [req.rid]):
                _, cache = self._prefill(toks, chunk - 1,
                                         self.pool.read_prefix(pblocks))
            # prompt=None: a half-written prompt must not enter the trie —
            # registration is deferred to the last chunk
            self.pool.admit(slot, cache, m + chunk, n_tok,
                            prefix_blocks=pblocks)
        else:
            toks = np.full((1, self._bucket(chunk)), self.scfg.pad_id,
                           np.int64)
            toks[0, :chunk] = req.prompt[:chunk]
            with span("sched.prefill", [req.rid]):
                _, cache = self._prefill(toks, chunk - 1)
            self.pool.admit(slot, cache, chunk, n_tok)
        self.metrics.on_admit(req.rid, self.clock(), prefix_tokens=m)
        self.metrics.on_prefill_chunk()
        self._slot_rid[slot] = req.rid
        self._active_req[req.rid] = req
        self._prefilling[slot] = True
        self._prefill_done[slot] = m + chunk
        # _pos tracks tokens written; the decode step's garbage write for
        # this (inactive) slot lands at _pos — the exact position the next
        # chunk's extend overwrites with real KV
        self._pos[slot] = m + chunk
        self._tokens[slot, 0] = 0
        self._remaining[slot] = 0

    def _chunk_step(self, slot: int, req: Request, done: int, tlen: int,
                    emitted: List[Tuple[int, int]]) -> None:
        """Resume one more chunk of a mid-prefill slot: the slot's own
        written blocks are read back as the prefix, the chunk's tail cache
        extends them in place, and the *last* chunk emits the first token
        — exactly what whole prefill would have produced."""
        plen = req.prompt.shape[0]
        new_len = done + tlen
        toks = np.full((1, self._bucket_tail(tlen, done)), self.scfg.pad_id,
                       np.int64)
        toks[0, :tlen] = req.prompt[done:new_len]
        prefix = self.pool.read_prefix(
            self.pool.slot_blocks(slot)[:done // self.pool.block_size])
        with span("sched.prefill", [req.rid]):
            logits, cache = self._prefill(toks, tlen - 1, prefix)
        self.pool.extend(slot, cache, done, new_len)
        self.metrics.on_prefill_chunk()
        self._prefill_done[slot] = new_len
        self._pos[slot] = new_len
        if new_len < plen:
            return
        # prompt fully cached: first token (the request's TTFT) and into
        # the decode batch
        first = int(torch.argmax(logits, dim=-1)[0])
        now = self.clock()
        self.metrics.on_token(req.rid, now)
        self._outputs[req.rid] = [first]
        emitted.append((req.rid, first))
        self._prefilling[slot] = False
        self._prefill_done[slot] = 0
        if req.max_new_tokens <= 1 or first == self.scfg.eos_id:
            self._finish(slot, now)
            return
        if self._prefix_on:
            # deferred trie registration (admit passed prompt=None)
            self.pool.register_prefix(slot, req.prompt, plen,
                                      plen + req.max_new_tokens)
        self._tokens[slot, 0] = first
        self._remaining[slot] = req.max_new_tokens - 1

    def _continue_prefills(self, emitted: List[Tuple[int, int]]) -> int:
        """Advance every mid-prefill slot by one chunk (slot order);
        returns the prefill tokens spent.  The first chunk of a step is
        always allowed — further ones only while they fit the step
        budget."""
        if not self._prefilling.any():
            return 0
        spent = 0
        budget = self.scfg.step_token_budget
        chunk = self.scfg.prefill_chunk
        for slot in np.flatnonzero(self._prefilling):
            req = self._active_req[int(self._slot_rid[slot])]
            done = int(self._prefill_done[slot])
            tlen = min(chunk, req.prompt.shape[0] - done)
            if budget is not None and spent and spent + tlen > budget:
                break
            self._chunk_step(int(slot), req, done, tlen, emitted)
            spent += tlen
        return spent

    def _admit(self, emitted: List[Tuple[int, int]], spent: int = 0) -> int:
        """Backfill free slots from the queue; appends (rid, token) firsts
        to ``emitted`` and returns the updated prefill-token spend.

        Queue-policy order with back-pressure: when the paged pool's free
        list cannot cover the head request's block reservation, admission
        *defers* (the head stays queued — no skip-ahead, no crash) until
        evictions return enough blocks.  With ``prefix_cache``, the head's
        prompt is first walked through the pool's trie: matched blocks are
        mapped by reference and only the divergent tail is prefilled.  A
        request that finishes at admit (budget 1, or EOS as its first
        token) never occupies a slot, so the *same* slot is retried with
        the next queued request.

        With ``prefill_chunk``, a prompt whose (post-trie-match) tail
        exceeds the chunk admits its first chunk only and parks the slot
        mid-prefill; with ``packed_prefill``, a run of packable heads is
        popped into one ``prefill_packed`` call.  ``step_token_budget``
        stops further admissions once this step's prefill spend would
        exceed it — the first work item of a step is always allowed.
        """
        with span("sched.admit"):
            budget = self.scfg.step_token_budget
            chunk = self.scfg.prefill_chunk
            free = [int(s) for s in np.flatnonzero(~self.active_slots)]
            while free:
                now = self.clock()
                head = self.queue.peek(now)
                if head is None or head.arrival_time > now:
                    break
                plen = head.prompt.shape[0]
                n_tok = plen + head.max_new_tokens
                if self._prefix_on:
                    m, pblocks = self.pool.prefix_match(head.prompt)
                    ok = self.pool.can_admit(n_tok, prefix_tokens=m)
                else:
                    m, pblocks = 0, []
                    ok = self.pool.can_admit(n_tok)
                if not ok:
                    # count requests, not steps waiting
                    if head.rid not in self._deferred_rids:
                        self._deferred_rids.add(head.rid)
                        self.metrics.on_deferred_admit()
                    break
                chunked = (chunk is not None and plen - m > chunk
                           and self._dense_prefill_ok(plen))
                if chunked:
                    cost = chunk
                elif m:
                    cost = self._bucket_tail(plen - m, m)
                else:
                    cost = self._bucket(plen)
                if budget is not None and spent and spent + cost > budget:
                    break
                if (self.scfg.packed_prefill and not chunked
                        and self._packable(head, m)):
                    pack = self._collect_pack(now, len(free), spent)
                    if len(pack) > 1:
                        spent += self._admit_packed(pack, free, emitted)
                        continue
                    req = pack[0]   # a pack of one admits like any other
                else:
                    req = self.queue.pop(now)
                    assert req is head, "peek/pop selection must agree"
                    self._deferred_rids.discard(req.rid)
                spent += cost
                if chunked:
                    self._begin_chunked(free.pop(0), req, m, pblocks)
                    continue
                if m:
                    tlen = plen - m
                    toks = np.full((1, self._bucket_tail(tlen, m)),
                                   self.scfg.pad_id, np.int64)
                    toks[0, :tlen] = req.prompt[m:]
                    with span("sched.prefill", [req.rid]):
                        logits, cache = self._prefill(
                            toks, tlen - 1, self.pool.read_prefix(pblocks))
                else:
                    toks = np.full((1, self._bucket(plen)), self.scfg.pad_id,
                                   np.int64)
                    toks[0, :plen] = req.prompt
                    with span("sched.prefill", [req.rid]):
                        logits, cache = self._prefill(toks, plen - 1)
                first = int(torch.argmax(logits, dim=-1)[0])
                now = self.clock()
                self.metrics.on_admit(req.rid, now, prefix_tokens=m)
                self.metrics.on_token(req.rid, now)
                self._outputs[req.rid] = [first]
                emitted.append((req.rid, first))
                if req.max_new_tokens <= 1 or first == self.scfg.eos_id:
                    # finished at admit: never touches a slot; retry the same
                    # slot with the next queued request
                    self.metrics.on_finish(req.rid, now)
                    continue
                slot = free.pop(0)
                if self._prefix_on:
                    self.pool.admit(slot, cache, plen, n_tok,
                                    prompt=req.prompt, prefix_blocks=pblocks)
                else:
                    self.pool.admit(slot, cache, plen, n_tok)
                self._occupy(slot, req, first, plen)
            return spent

    def _decode(self, active: np.ndarray):
        with span("sched.decode", self._slot_rid[active]):
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
        """One scheduler step: resume mid-prefill chunks, backfill, then
        one batched decode step over the decoding slots.  Returns the
        (rid, token) pairs emitted."""
        emitted: List[Tuple[int, int]] = []
        spent = self._continue_prefills(emitted)
        self._admit(emitted, spent)
        active = self.decoding_slots
        if active.any():
            if self.pool.paged and self.pool.has_shared:
                # copy-on-write: each decoding slot writes its KV at
                # _pos.._pos+width-1 this step (width > 1 under
                # speculation: draft and verify both write the whole run)
                # — upgrade a shared target block to a private copy first
                # so sibling slots / the prefix index keep their bits
                width = self._spec.k if self._spec is not None else 1
                for slot in np.flatnonzero(active):
                    for i in range(width):
                        self.pool.ensure_writable(int(slot),
                                                  int(self._pos[slot]) + i)
            if self._spec is not None:
                self._spec_step(active, emitted)
            else:
                self._plain_step(active, emitted)
        self.metrics.sample_queue(len(self.queue), self.n_active)
        self.metrics.sample_pool(self.pool.stats(), self._tokens_live())
        return emitted

    def _plain_step(self, active: np.ndarray,
                    emitted: List[Tuple[int, int]]) -> None:
        """One batched decode step: every decoding slot advances one
        token."""
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
            if self._remaining[slot] <= 0 or tok == self.scfg.eos_id:
                self._finish(int(slot), now)

    def _spec_step(self, active: np.ndarray,
                   emitted: List[Tuple[int, int]]) -> None:
        """One speculative round over the decoding slots: draft ``k - 1``
        tokens cheaply, verify the whole run in one step, commit the
        longest exactly matching prefix per slot (clipped at the request's
        budget and EOS), and roll the rest back by not advancing ``_pos``
        past the accepted rows."""
        spec = self._spec
        with span("sched.decode", self._slot_rid[active]):
            toks_run, vt, new_caches = spec.run_round(
                self.params, self._tokens, self._pos, active,
                self.pool.caches, self.pool.block_tables, self.device)
        self.pool.caches = new_caches
        now = self.clock()
        for slot in np.flatnonzero(active):
            rid = int(self._slot_rid[slot])
            n_acc = accept_length(toks_run[slot], vt[slot])
            emit = 0
            for i in range(n_acc):
                tok = int(vt[slot, i])
                self._outputs[rid].append(tok)
                self.metrics.on_token(rid, now)
                emitted.append((rid, tok))
                emit = i + 1
                if (self._remaining[slot] - emit <= 0
                        or tok == self.scfg.eos_id):
                    break
            last = int(vt[slot, emit - 1])
            self._tokens[slot, 0] = last
            self._pos[slot] += emit
            self._remaining[slot] -= emit
            self.metrics.on_spec_round(drafted=spec.k - 1, verified=spec.k,
                                       accepted=emit, accept_len=n_acc)
            if self._remaining[slot] <= 0 or last == self.scfg.eos_id:
                self._finish(int(slot), now)

    def output(self, rid: int) -> np.ndarray:
        """Generated tokens recorded so far for ``rid`` (router harvest)."""
        return np.asarray(self._outputs[rid], np.int32)

    def drain(self) -> List[Request]:
        """Evict every in-flight request and empty the queue; returns the
        unfinished :class:`Request`s (original ``arrival_time`` intact) so
        a router can requeue them elsewhere.  Partial outputs are
        discarded — a migrated request restarts from its prompt, and
        greedy decode makes the rerun bit-identical.

        Nothing of a drained request stays behind: a mid-prefill slot
        (chunked prefill) loses its ``_prefilling`` mark and its progress,
        every slot's blocks go back through ``pool.evict`` (a mapped
        prefix block drops only this slot's reference, so the prefix
        index's refcounts are those of the prompts it cached) and its
        recurrent leaves are zeroed, and the deferral marks and the local
        queue are cleared.  A speculative round runs within one step, so
        a slot killed mid-verify holds no draft state beyond its KV rows,
        which the eviction returns."""
        out: List[Request] = []
        for slot in np.flatnonzero(self.active_slots):
            rid = int(self._slot_rid[slot])
            req = self._active_req.pop(rid)
            self._outputs.pop(rid, None)
            self._slot_rid[slot] = -1
            self._remaining[slot] = 0
            self._prefilling[slot] = False   # a mid-prefill slot drains
            self._prefill_done[slot] = 0     # like any other: full restart
            self.pool.evict(int(slot))
            out.append(req)
        self._deferred_rids.clear()
        out.extend(self.queue.clear())
        return out

    def _tokens_live(self) -> float:
        """Positions actually written across active slots (for the
        internal-fragmentation metric; ``_pos`` is the next write index,
        clipped to the per-slot logical capacity for windowed rings)."""
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
