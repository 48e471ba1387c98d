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

**Devices.** The port serves the reference's single-device path
(``devices=None``): every replica has no mesh and shares the card (or the
CPU, with ``device="cpu"``), one process stepping them in turn.  The
replicas share one ``params`` tree, so under ``pim_sim`` the engine's
resident crossbar state, keyed by weight, serves them all and survives a
respawn.  A replica over a slice of several devices would need its own
mesh, and a port mesh spans a whole ``torch.distributed`` world of
processes, so a non-``None`` ``devices``, a per-replica
``model_parallel`` above 1 and a ``FailurePlan`` that loses devices all
raise (ROADMAP.md, item D3).

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
with a fresh scheduler (``respawn=False`` retires it instead).  The dead
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

import dataclasses
import time
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.runtime.fault_tolerance import StragglerMonitor
from repro_torch.serving.metrics import ServingMetrics
from repro_torch.serving.queue import AdmissionQueue, Request, make_request
from repro_torch.serving.scheduler import Scheduler, ServingConfig, _idle_sleep

__all__ = ["FleetClock", "FailurePlan", "RouterConfig", "Replica",
           "Router", "ROUTER_POLICIES"]

ROUTER_POLICIES = ("round_robin", "least_loaded", "prefix_affinity")

_D3 = ("a replica over a device slice (devices, model_parallel > 1 or "
       "lose_devices) needs a mesh per replica; a port mesh spans a whole "
       "torch.distributed world, so the router over ranks waits "
       "(ROADMAP.md, item D3): pass devices=None")


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


@dataclasses.dataclass(frozen=True)
class FailurePlan:
    """Deterministic fault injection: kill ``kill_replica`` when the
    router has completed ``at_step`` rounds; ``respawn=False`` retires the
    replica and its load redistributes.  ``lose_devices`` (devices of the
    replica's slice that die with it) is kept for parity with the
    reference; a replica here has no slice, so a plan that loses devices
    is refused (ROADMAP.md, item D3)."""

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
    model_parallel: int = 1         # per-replica mesh "model" axis (D3)
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
    drained requests are already back in the router's global queue)."""

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
        self.rebuild(params, devices)

    def rebuild(self, params, devices) -> None:
        """(Re)build the scheduler (no mesh: ``devices`` must be None).
        Used at construction and at respawn; the old scheduler is dropped
        first, so two pools of one replica never coexist."""
        if devices is not None:
            raise NotImplementedError(_D3)
        self.sched = None
        self.sched = Scheduler(params, self.cfg, self.scfg,
                               clock=self.clock, device=self.device)
        self.monitor.reset()
        self.strikes = 0
        self.alive = True
        self.pending.clear()

    def step(self):
        """One scheduler step."""
        return self.sched.step()

    # ---- load signals (least_loaded dispatch) ------------------------

    @property
    def queue_depth(self) -> int:
        return len(self.sched.queue)

    @property
    def n_active(self) -> int:
        return self.sched.n_active

    @property
    def free_blocks(self) -> int:
        return self.sched.pool.free_blocks

    @property
    def load(self):
        """Sort key: fewest queued+active, then most free KV blocks."""
        return (self.queue_depth + self.n_active, -self.free_blocks,
                self.rid)


class Router:
    """N serving replicas behind one admission queue (module docstring
    has the architecture; drive with ``submit``/``step``/``run``).
    ``device`` is every replica's (default ``"cuda"``)."""

    def __init__(self, params, cfg, scfg: ServingConfig,
                 rcfg: RouterConfig, *, devices=None,
                 clock: Optional[object] = None,
                 failure_plan: Optional[FailurePlan] = None,
                 device="cuda"):
        # a replica here has no device slice: no per-replica model axis,
        # no devices to lose
        if (devices is not None or rcfg.model_parallel > 1
                or (failure_plan is not None
                    and failure_plan.lose_devices > 0)):
            raise NotImplementedError(_D3)
        self.params = params
        self.cfg = cfg
        self.scfg = scfg
        self.rcfg = rcfg
        self.clock = clock if clock is not None else FleetClock()
        self._fleet = isinstance(self.clock, FleetClock)
        self.queue = AdmissionQueue(policy=scfg.queue_policy)
        self.plan = failure_plan
        self._plan_fired = False
        self.replicas = [
            Replica(i, params, cfg, scfg, rcfg, clock=self.clock,
                    device=device)
            for i in range(rcfg.n_replicas)]
        self.results: Dict[int, np.ndarray] = {}
        self.step_count = 0
        self.rebalanced_requests = 0
        self.replica_restarts = 0
        self._dead_metrics: List[ServingMetrics] = []
        self._affinity: Dict[bytes, int] = {}   # prefix-run hash -> replica
        self._rr = 0                            # round_robin cursor

    # ---- admission ---------------------------------------------------

    def submit(self, prompt, max_new_tokens: int, *,
               arrival_time: Optional[float] = None) -> int:
        req = make_request(prompt, max_new_tokens,
                           arrival_time=self.clock() if arrival_time is None
                           else arrival_time)
        return self.submit_request(req)

    def submit_request(self, req: Request) -> int:
        """Global admission: validate once (every replica's pool has the
        same capacity), then queue for dispatch."""
        self._any_live().sched.validate_request(req)
        self.queue.submit(req)
        return req.rid

    def _any_live(self) -> Replica:
        for rep in self.replicas:
            if rep.alive:
                return rep
        raise RuntimeError("no live replicas")

    # ---- dispatch ----------------------------------------------------

    def _affinity_key(self, req: Request) -> bytes:
        bs = self.scfg.block_size
        return req.prompt[:bs].tobytes()

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
            rep = min(live, key=lambda r: r.load)
            self._affinity[key] = rep.rid
            return rep
        return min(live, key=lambda r: r.load)

    def _dispatch(self) -> int:
        """Hand every *arrived* queued request to a replica (the policy's
        pick); replicas admit from their local queues on their next step,
        so least-loaded sees earlier dispatches of the same round."""
        n = 0
        while any(r.alive for r in self.replicas):
            now = self.clock()
            head = self.queue.peek(now)
            if head is None or head.arrival_time > now:
                break
            rep = self._pick(head)
            req = self.queue.pop(now)
            assert req is head, "peek/pop selection must agree"
            req.replica_id = rep.rid
            rep.sched.submit_request(req)
            rep.pending.add(req.rid)
            n += 1
        return n

    # ---- fault path --------------------------------------------------

    def _kill(self, rep: Replica, *, lose_devices: int = 0,
              respawn: bool = True) -> None:
        """Drain-and-requeue ``rep``, then respawn it (or retire it when
        respawn is off).  A replica has no device slice, so losing devices
        is refused."""
        if lose_devices:
            raise NotImplementedError(_D3)
        drained = rep.sched.drain()
        self._dead_metrics.append(rep.sched.metrics)
        for req in reversed(drained):    # keep order; front of the queue
            req.n_migrations += 1
            self.queue.requeue(req)
        self.rebalanced_requests += len(drained)
        rep.pending.clear()
        rep.alive = False
        if respawn:
            rep.rebuild(self.params, None)
            self.replica_restarts += 1
        else:
            rep.sched = None         # a retired replica keeps no pool

    def _maybe_plan_kill(self) -> None:
        p = self.plan
        if (p is not None and not self._plan_fired
                and self.step_count >= p.at_step
                and self.replicas[p.kill_replica].alive):
            self._plan_fired = True
            self._kill(self.replicas[p.kill_replica],
                       lose_devices=p.lose_devices, respawn=p.respawn)

    # ---- the round ---------------------------------------------------

    def _harvest(self, rep: Replica) -> None:
        done = [rid for rid in rep.pending
                if rep.sched.metrics.requests[rid].finish_time is not None]
        for rid in done:
            if rid in self.results:
                raise RuntimeError(f"request {rid} completed twice")
            self.results[rid] = rep.sched.output(rid)
            rep.pending.discard(rid)

    def step(self) -> int:
        """One fleet round: injected kills, dispatch, then one scheduler
        step per live replica (each in its own clock segment); fleet
        time advances by the slowest segment.  Returns tokens emitted."""
        self._maybe_plan_kill()
        self._dispatch()
        dts: List[float] = []
        emitted = 0
        to_kill: List[Replica] = []
        for rep in self.replicas:
            if not rep.alive:
                continue
            if self._fleet:
                self.clock.start_segment()
                out = rep.step()
                dt = self.clock.end_segment()
            else:
                t0 = self.clock()
                out = rep.step()
                dt = self.clock() - t0
            dts.append(dt)
            emitted += len(out)
            self._harvest(rep)
            if self.rcfg.health_check:
                rep.strikes = rep.strikes + 1 if rep.monitor.record(dt) else 0
                if rep.strikes >= self.rcfg.straggler_patience:
                    to_kill.append(rep)
        for rep in to_kill:
            self._kill(rep)
        if self._fleet:
            self.clock.end_round(dts)
        self.step_count += 1
        return emitted

    def run(self) -> Dict[int, np.ndarray]:
        """Step until the queue drains and every replica idles; returns
        rid -> generated tokens.  Idle gaps before the next arrival jump
        the fleet clock; with a plain injected clock the same
        stall-guard as ``Scheduler.run`` applies."""
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
        the router fields ``summary()`` reports."""
        live = [r.sched.metrics for r in self.replicas if r.alive]
        m = ServingMetrics.merged(live + self._dead_metrics)
        m.router_policy = self.rcfg.policy
        m.rebalanced_requests = self.rebalanced_requests
        m.replica_restarts = self.replica_restarts
        m.per_replica_tok_s = {
            r.rid: r.sched.metrics.summary()["tokens_per_s"]
            for r in self.replicas if r.alive}
        return m
