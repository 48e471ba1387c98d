"""Multi-replica serving router: the data-parallel fleet layer.

One :class:`Scheduler` is the single-engine capacity ceiling; this module
scales *by replica* instead of by ``max_batch`` — PartitionPIM's thesis
one level up: throughput comes from dividing a fixed substrate into
independent concurrently-operating units under one cheap shared
controller.

:class:`Router` owns the **global** :class:`AdmissionQueue` (same
``fifo``/``sjf`` policies as a single engine) and N :class:`Replica`\\ s,
each a full serving engine — its own ``Scheduler``, its own KV pool and
prefix trie.  The scheduler itself stays single-replica-ignorant;
everything fleet-shaped lives here.

**Devices.** ``devices=None`` serves the reference's single-device path:
every replica has no mesh and shares the card (or the CPU, with
``device="cpu"``), one process stepping them in turn.  The replicas
share one ``params`` tree, so under ``pim_sim`` the engine's resident
crossbar state, keyed by weight, serves them all and survives a respawn.

**Over ranks** (``devices`` = world ranks of an initialised
``torch.distributed`` world): each replica owns a contiguous slice of the
ranks (``dist.partitioning.replica_slices``) and a sub-mesh over it
(``ElasticMesh(rcfg.model_parallel).make(ranks)``, so
``model_parallel`` above 1 gives each replica its own ``"model"`` axis).
Every rank runs the router; a rank steps only its own replica's
``Scheduler``, under that replica's mesh.  World rank 0 owns the
admission queue's decisions: each round it decides the fleet time,
whether a planned kill fires, and which arrived request goes to which
replica, and broadcasts them (``dist.context.broadcast_object``); every
rank keeps the same queue and pops what rank 0 dispatched.  At the end
of a round the first rank of each live replica reports its step time,
emitted tokens, finished requests and load signals (``queue_depth``,
``n_active``, ``free_blocks``; a replica's ranks agree by construction)
in one world gather (``dist.context.gather_objects``): every rank
harvests the same results, the round costs the slowest replica's step
on every rank, and rank 0 dispatches the next round from those signals.
``dist.new_group`` is collective over the world, so every rank builds
every replica's sub-mesh, in the same order, at the same round, even
one it is not in; a respawn makes new groups.  Losing ranks
(``lose_devices``) keeps the survivors ``ranks[lose_devices:]``, as the
reference does; a lost rank drops its scheduler and pool but stays in
the world's exchanges to the end (a gloo group cannot shrink), and
world rank 0 decides for the fleet even when it is the one lost.
:meth:`Router.metrics` is collective over the world there.  Without
ranks the round is the same one with local exchanges: this process is
rank 0 and leads every replica, so a broadcast returns its object and a
gather its own reports.

**Dispatch policies** (``RouterConfig.policy``):

* ``round_robin`` — cycle over live replicas; the baseline.
* ``least_loaded`` — fewest ``queued + active`` requests, ties to the
  most free KV blocks (``pool.free_blocks``), then the lowest id.
* ``prefix_affinity`` — hash of the prompt's leading ``block_size``-token
  run → the replica that served that run before (whose trie therefore
  likely holds its blocks), falling back to least-loaded for unseen
  prefixes.

**Fault tolerance**: each replica carries a :class:`StragglerMonitor`
over its per-round step times (``RouterConfig.health_check`` turns EWMA
outlier strikes into kills), and an injectable :class:`FailurePlan`
deterministically kills replica ``r`` at router step ``s``.  A kill
**drains** the replica — its unfinished requests requeue at the *front*
of the global queue with their original ``arrival_time`` and
``n_migrations`` bumped, partial outputs discarded — and **respawns** it
with a fresh scheduler, over the surviving ranks of its slice when it
has one (``respawn=False``, or no rank left, retires it instead).  The dead
scheduler, and with it its pool, becomes garbage before the new one is
built: only its metrics are kept.  A migrated request restarts from its
prompt on its new replica; greedy decode is deterministic given (prompt,
params), so its final tokens are bit-identical to an uninterrupted run.

**The fleet clock.** Replicas model independent hosts, but this process
steps them one after another.  :class:`FleetClock` reconciles the two:
each replica's step runs inside a clock *segment* whose real elapsed
time is measured, and fleet time advances **once per round by the
maximum segment time** — the wall time a data-parallel fleet of
independent hosts would observe.  All throughput/TTFT metrics read this
clock.  Any plain callable clock (e.g. a test ``FakeClock``) also works:
the router then measures step times by consecutive clock reads and never
advances time itself.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.dist import context as dctx
from repro_torch.dist.partitioning import replica_slices
from repro_torch.runtime.fault_tolerance import ElasticMesh, StragglerMonitor
from repro_torch.serving.metrics import ServingMetrics
from repro_torch.serving.queue import AdmissionQueue, Request, make_request
from repro_torch.serving.scheduler import Scheduler, ServingConfig, _idle_sleep

__all__ = ["FleetClock", "FailurePlan", "RouterConfig", "Replica",
           "Router", "ROUTER_POLICIES"]

ROUTER_POLICIES = ("round_robin", "least_loaded", "prefix_affinity")


class FleetClock:
    """Virtual fleet time over sequentially-stepped replicas.

    ``start_segment``/``end_segment`` bracket one replica's step; reads
    inside a segment return fleet time plus the segment's real elapsed
    time (so per-token timestamps inside a step stay ordered), reads
    outside return the round's start time.  ``end_round(dts)`` advances
    fleet time by ``max(dts)`` — every replica of a round starts at the
    same instant and the round costs its slowest member.  ``advance_to``
    jumps idle time to the next arrival.
    """

    def __init__(self, wall=time.monotonic):
        self._wall = wall
        self._v = 0.0
        self._anchor: Optional[float] = None

    def __call__(self) -> float:
        if self._anchor is not None:
            return self._v + (self._wall() - self._anchor)
        return self._v

    def start_segment(self) -> None:
        self._anchor = self._wall()

    def end_segment(self) -> float:
        dt = self._wall() - self._anchor
        self._anchor = None
        return dt

    def end_round(self, dts: Sequence[float]) -> None:
        if dts:
            self._v += max(dts)

    def advance_to(self, t: float) -> None:
        self._v = max(self._v, t)

    def sync(self, t: float) -> None:
        """Set fleet time to ``t`` (outside a segment): the router over
        ranks takes world rank 0's."""
        self._v = t


@dataclasses.dataclass(frozen=True)
class FailurePlan:
    """Deterministic fault injection: kill ``kill_replica`` when the
    router has completed ``at_step`` rounds.  ``lose_devices`` of its
    slice's ranks die with it (the respawn mesh shrinks to the survivors;
    a replica without a slice has none to lose); losing all of them, or
    ``respawn=False``, retires the replica and its load
    redistributes."""

    kill_replica: int
    at_step: int
    lose_devices: int = 0
    respawn: bool = True


@dataclasses.dataclass(frozen=True)
class RouterConfig:
    """Fleet shape + dispatch/health policy (per-engine knobs stay in
    :class:`ServingConfig`, including the shared ``queue_policy``)."""

    n_replicas: int = 2
    policy: str = "least_loaded"    # one of ROUTER_POLICIES
    model_parallel: int = 1         # per-replica mesh "model" axis
    health_check: bool = False      # EWMA straggler strikes -> kill
    straggler_patience: int = 3     # consecutive flagged steps to kill
    straggler_threshold: float = 3.0
    straggler_alpha: float = 0.1

    def __post_init__(self):
        if self.policy not in ROUTER_POLICIES:
            raise ValueError(f"unknown router policy {self.policy!r} "
                             f"(choose from {ROUTER_POLICIES})")
        if self.n_replicas < 1:
            raise ValueError("n_replicas must be >= 1")


class Replica:
    """One serving engine: a :class:`Scheduler` (own pool, trie, metrics)
    with the fleet bookkeeping the router needs — the set of in-flight
    rids, a :class:`StragglerMonitor` with a strike counter, and
    ``rebuild``, the respawn path, which starts a fresh scheduler (the
    drained requests are already back in the router's global queue).

    With ``devices`` (world ranks) the replica has a sub-mesh over them,
    built on every rank of the world; ``sched`` is None on a rank outside
    it."""

    def __init__(self, rid: int, params, cfg, scfg: ServingConfig,
                 rcfg: RouterConfig, *, devices=None, clock=time.monotonic,
                 device="cuda"):
        self.rid = rid
        self.cfg = cfg
        self.scfg = scfg
        self.rcfg = rcfg
        self.clock = clock
        self.device = device
        self.alive = True
        self.pending: set = set()       # rids dispatched, not yet harvested
        self.monitor = StragglerMonitor(alpha=rcfg.straggler_alpha,
                                        threshold=rcfg.straggler_threshold)
        self.strikes = 0
        self.sched: Optional[Scheduler] = None
        self.mesh = None
        self.ranks: Optional[List[int]] = None
        self.rebuild(params, devices)

    def rebuild(self, params, devices) -> None:
        """(Re)build the mesh and scheduler over ``devices`` (None: no
        mesh, the single-device case).  Used at construction and at
        respawn; the old scheduler is dropped first, so two pools of one
        replica never coexist.  Every rank of the world calls it for every
        replica (the mesh's groups are made on all of them); only the
        mesh's members build a scheduler."""
        self.sched = None
        self.ranks = list(devices) if devices is not None else None
        self.mesh = (ElasticMesh(self.rcfg.model_parallel).make(self.ranks)
                     if self.ranks is not None else None)
        if self.mesh is None or self.mesh.member:
            with (dctx.use_mesh(self.mesh) if self.mesh is not None
                  else contextlib.nullcontext()):
                self.sched = Scheduler(params, self.cfg, self.scfg,
                                       clock=self.clock, device=self.device)
        self.monitor.reset()
        self.strikes = 0
        self.alive = True
        self.pending.clear()

    @property
    def lead(self) -> int:
        """The world rank that reports for the replica: its first, or 0
        (this process) for a replica without ranks."""
        return self.ranks[0] if self.ranks is not None else 0

    def step(self):
        """One scheduler step under this replica's mesh."""
        if self.mesh is not None:
            with dctx.use_mesh(self.mesh):
                return self.sched.step()
        return self.sched.step()

    def signals(self) -> List[int]:
        """``[queue_depth, n_active, free_blocks]``: what dispatch reads
        (fewest queued + active first, then most free KV blocks)."""
        return [len(self.sched.queue), self.sched.n_active,
                self.sched.pool.free_blocks]


class Router:
    """N serving replicas behind one admission queue (module docstring
    has the architecture; drive with ``submit``/``step``/``run``).
    ``device`` is every replica's (default ``"cuda"``); ``devices``, when
    given, lists the world ranks the fleet runs over (every rank of the
    world constructs the router, with the same arguments)."""

    def __init__(self, params, cfg, scfg: ServingConfig,
                 rcfg: RouterConfig, *, devices=None,
                 clock: Optional[object] = None,
                 failure_plan: Optional[FailurePlan] = None,
                 device="cuda"):
        self.params = params
        self.cfg = cfg
        self.scfg = scfg
        self.rcfg = rcfg
        self.clock = clock if clock is not None else FleetClock()
        self._fleet = isinstance(self.clock, FleetClock)
        self.queue = AdmissionQueue(policy=scfg.queue_policy)
        self.plan = failure_plan
        self._plan_fired = False
        self.over_ranks = devices is not None
        if self.over_ranks:
            import torch.distributed as dist

            if not dist.is_initialized():
                raise RuntimeError(
                    "a fleet over ranks (devices = world ranks) needs an "
                    "initialised torch.distributed world; devices=None "
                    "serves every replica in this process")
            devices = list(devices)
            if not all(isinstance(r, int) for r in devices):
                raise TypeError(f"devices must be world ranks (ints), got "
                                f"{devices}")
            self.me = dist.get_rank()
            slices = replica_slices(rcfg.n_replicas, devices)
        else:
            if rcfg.model_parallel > 1:
                raise ValueError(
                    "model_parallel > 1 gives each replica a model axis "
                    "over its own ranks: pass devices (world ranks)")
            self.me = 0
            slices = [None] * rcfg.n_replicas
        self.replicas = [
            Replica(i, params, cfg, scfg, rcfg, devices=sl, clock=self.clock,
                    device=device)
            for i, sl in enumerate(slices)]
        self.results: Dict[int, np.ndarray] = {}
        self.step_count = 0
        self.rebalanced_requests = 0
        self.replica_restarts = 0
        self._dead_metrics: List[ServingMetrics] = []
        self._affinity: Dict[bytes, int] = {}   # prefix-run hash -> replica
        self._rr = 0                            # round_robin cursor
        self._requests: Dict[int, Request] = {}  # every submitted request
        # a fresh replica's load signals; rank 0 dispatches from a mirror
        # of every replica's, refreshed by each round's reports
        self._fresh = {}
        for part in self._gather({rep.rid: rep.signals()
                                  for rep in self._led()}):
            self._fresh.update(part)
        self._signals = {k: list(v) for k, v in self._fresh.items()}

    # ---- exchanges: over the world with ranks, local without ----------

    def _broadcast(self, obj, src: int = 0):
        return (dctx.broadcast_object(obj, src=src) if self.over_ranks
                else obj)

    def _gather(self, obj) -> list:
        return dctx.gather_objects(obj) if self.over_ranks else [obj]

    def _led(self) -> List[Replica]:
        """The live replicas this rank steps and reports for."""
        return [r for r in self.replicas if r.alive and r.sched is not None
                and self.me == r.lead]

    # ---- admission ---------------------------------------------------

    def submit(self, prompt, max_new_tokens: int, *,
               arrival_time: Optional[float] = None) -> int:
        req = make_request(prompt, max_new_tokens,
                           arrival_time=self.clock() if arrival_time is None
                           else arrival_time)
        return self.submit_request(req)

    def submit_request(self, req: Request) -> int:
        """Global admission: validate once (every replica's pool has the
        same capacity), then queue for dispatch.  Over ranks every rank
        submits the same requests in the same order; a rank that holds
        no replica any more does not validate."""
        if not any(r.alive for r in self.replicas):
            raise RuntimeError("no live replicas")
        mine = [r for r in self.replicas if r.alive and r.sched is not None]
        if mine:
            mine[0].sched.validate_request(req)
        self.queue.submit(req)
        self._requests[req.rid] = req
        return req.rid

    # ---- dispatch ----------------------------------------------------

    def _affinity_key(self, req: Request) -> bytes:
        bs = self.scfg.block_size
        return req.prompt[:bs].tobytes()

    def _load(self, rep: Replica):
        """Sort key: fewest queued+active, then most free KV blocks, from
        rank 0's mirror of the reported signals."""
        q, a, free = self._signals[rep.rid]
        return (q + a, -free, rep.rid)

    def _pick(self, req: Request) -> Replica:
        live = [r for r in self.replicas if r.alive]
        policy = self.rcfg.policy
        if policy == "round_robin":
            rep = live[self._rr % len(live)]
            self._rr += 1
            return rep
        if policy == "prefix_affinity":
            key = self._affinity_key(req)
            rid = self._affinity.get(key)
            if rid is not None and self.replicas[rid].alive:
                return self.replicas[rid]
            rep = min(live, key=self._load)
            self._affinity[key] = rep.rid
            return rep
        return min(live, key=self._load)

    def _decide_dispatch(self) -> List[Tuple[int, int]]:
        """The policy's ``(request id, replica id)`` for every *arrived*
        queued request, popped from the queue in order; replicas admit
        from their local queues on their next step, so least-loaded sees
        earlier dispatches of the same round.  The replicas this rank
        leads read their own signals; the others, the last reports'."""
        for rep in self._led():
            self._signals[rep.rid] = rep.signals()
        picks = []
        while any(r.alive for r in self.replicas):
            now = self.clock()
            head = self.queue.peek(now)
            if head is None or head.arrival_time > now:
                break
            rep = self._pick(head)
            req = self.queue.pop(now)
            assert req is head, "peek/pop selection must agree"
            picks.append((req.rid, rep.rid))
            self._signals[rep.rid][0] += 1     # one more queued
        return picks

    def _hand(self, req: Request, rep: Replica) -> None:
        req.replica_id = rep.rid
        if rep.sched is not None:
            rep.sched.submit_request(req)
        rep.pending.add(req.rid)

    def _dispatch(self) -> int:
        """Hand every arrived queued request to a replica (the policy's
        pick); returns how many."""
        picks = self._broadcast(
            self._decide_dispatch() if self.me == 0 else None)
        self._apply_dispatch(picks)
        return len(picks)

    def _apply_dispatch(self, picks) -> None:
        """Every rank takes rank 0's picks off its own queue (rank 0
        popped them while deciding)."""
        for rid, rep_id in picks:
            req = (self._requests[rid] if self.me == 0
                   else self.queue.take(rid))
            self._hand(req, self.replicas[rep_id])

    # ---- fault path --------------------------------------------------

    def _kill(self, rep: Replica, *, lose_devices: int = 0,
              respawn: bool = True) -> None:
        """Drain-and-requeue ``rep``, then respawn it over its surviving
        ranks (or retire it when none survive / respawn is off).  Over
        ranks every rank of the world calls it: the replica's members
        drain, its first rank sends the drained order, every rank
        requeues and builds the respawned sub-mesh."""
        drained_ids = None
        if rep.sched is not None:
            drained_ids = [r.rid for r in rep.sched.drain()]
            if self.me == rep.lead:
                self._dead_metrics.append(rep.sched.metrics)
        drained = [self._requests[rid] for rid in
                   self._broadcast(drained_ids, src=rep.lead)]
        for req in reversed(drained):    # keep order; front of the queue
            req.n_migrations += 1
            self.queue.requeue(req)
        self.rebalanced_requests += len(drained)
        rep.pending.clear()
        rep.alive = False
        survivors = (rep.ranks[lose_devices:] if rep.ranks is not None
                     else None)
        if respawn and (rep.ranks is None or survivors):
            rep.rebuild(self.params, survivors)
            self.replica_restarts += 1
            self._signals[rep.rid] = list(self._fresh[rep.rid])
        else:
            rep.sched = None         # a retired replica keeps no pool

    def _plan_due(self) -> Optional[Tuple[int, int, bool]]:
        p = self.plan
        if (p is not None and not self._plan_fired
                and self.step_count >= p.at_step
                and self.replicas[p.kill_replica].alive):
            return (p.kill_replica, p.lose_devices, p.respawn)
        return None

    def _run_kill(self, kill) -> None:
        self._plan_fired = True
        rep_id, lose, respawn = kill
        self._kill(self.replicas[rep_id], lose_devices=lose, respawn=respawn)

    # ---- the round ---------------------------------------------------

    def _finished(self, rep: Replica) -> Dict[int, np.ndarray]:
        return {rid: rep.sched.output(rid) for rid in rep.pending
                if rep.sched.metrics.requests[rid].finish_time is not None}

    def _collect(self, rep: Replica, done: Dict[int, np.ndarray]) -> None:
        for rid, toks in done.items():
            if rid in self.results:
                raise RuntimeError(f"request {rid} completed twice")
            self.results[rid] = toks
            rep.pending.discard(rid)

    def _timed_step(self, rep: Replica):
        if self._fleet:
            self.clock.start_segment()
            out = rep.step()
            return out, self.clock.end_segment()
        t0 = self.clock()
        out = rep.step()
        return out, self.clock() - t0

    def _health(self, rep: Replica, dt: float) -> bool:
        """Record ``dt``; whether the replica has struck out."""
        if not self.rcfg.health_check:
            return False
        rep.strikes = rep.strikes + 1 if rep.monitor.record(dt) else 0
        return rep.strikes >= self.rcfg.straggler_patience

    def step(self) -> int:
        """One fleet round: injected kills, dispatch, then one scheduler
        step per live replica (each in its own clock segment); fleet
        time advances by the slowest segment.  Returns tokens emitted by
        the whole fleet (over ranks every rank calls it)."""
        # 1. rank 0 decides the fleet time, a planned kill and (when no
        # kill changes the queue first) the dispatch; one broadcast
        decision = None
        if self.me == 0:
            kill = self._plan_due()
            decision = {"t": self.clock(), "kill": kill,
                        "dispatch": None if kill else self._decide_dispatch()}
        decision = self._broadcast(decision)
        if self._fleet:
            self.clock.sync(decision["t"])
        if decision["kill"] is not None:
            self._run_kill(decision["kill"])
            self._dispatch()
        else:
            self._apply_dispatch(decision["dispatch"])
        # 2. this rank's replicas step; a replica's first rank reports
        reports = []
        for rep in self.replicas:
            if rep.alive and rep.sched is not None:
                out, dt = self._timed_step(rep)
                if self.me == rep.lead:
                    done = {rid: rep.sched.output(rid) for rid in rep.pending
                            if rep.sched.metrics.requests[rid].finish_time
                            is not None}
                    reports.append((rep.rid, dt, len(out), done,
                                    rep.signals()))
        # 3. every rank: the same harvest, health verdicts and clock
        dts: List[float] = []
        emitted = 0
        to_kill: List[Replica] = []
        for part in self._gather(reports):
            for rep_id, dt, n, done, sig in part:
                rep = self.replicas[rep_id]
                dts.append(dt)
                emitted += n
                self._collect(rep, done)
                self._signals[rep_id] = list(sig)
                if self._health(rep, dt):
                    to_kill.append(rep)
        for rep in to_kill:
            self._kill(rep)
        if self._fleet:
            self.clock.end_round(dts)
        self.step_count += 1
        return emitted

    def run(self) -> Dict[int, np.ndarray]:
        """Step until the queue drains and every replica idles; returns
        rid -> generated tokens (over ranks the same on every rank).  Idle
        gaps before the next arrival jump the fleet clock; with a plain
        injected clock the same stall-guard as ``Scheduler.run``
        applies."""
        stalls = 0
        while len(self.queue) or any(r.pending for r in self.replicas):
            if not any(r.alive for r in self.replicas):
                raise RuntimeError(
                    "all replicas dead with requests outstanding")
            progressed = self.step() > 0
            if progressed or any(r.pending for r in self.replicas):
                stalls = 0
                continue
            head = self.queue.peek(self.clock())
            if head is None:
                continue
            if self._fleet:
                self.clock.advance_to(head.arrival_time)
                continue
            stalls = _idle_sleep(self.clock, head.arrival_time, stalls)
            if stalls > 1000:
                raise RuntimeError(
                    "run(): clock is not advancing while requests "
                    "wait to arrive; with an injected test clock, "
                    "advance it and call step() yourself")
        return dict(self.results)

    # ---- fleet metrics -----------------------------------------------

    def metrics(self) -> ServingMetrics:
        """Merged fleet metrics (live + killed replicas), stamped with
        the router fields ``summary()`` reports.  Over ranks it gathers
        every replica's metrics from its first rank: every rank calls
        it."""
        live, dead = {}, []
        for part_live, part_dead in self._gather(
                ({r.rid: r.sched.metrics for r in self._led()},
                 self._dead_metrics)):
            live.update(part_live)
            dead.extend(part_dead)
        m = ServingMetrics.merged([live[k] for k in sorted(live)] + dead)
        m.router_policy = self.rcfg.policy
        m.rebalanced_requests = self.rebalanced_requests
        m.replica_restarts = self.replica_restarts
        m.per_replica_tok_s = {
            rid: live[rid].summary()["tokens_per_s"] for rid in sorted(live)}
        return m
