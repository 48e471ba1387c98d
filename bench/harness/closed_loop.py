"""The closed loop over the program's scheduler, and the measured window.

The loop is the clients: it submits each client's requests to
``Scheduler.submit``, calls ``Scheduler.step`` and reads back the (rid,
token) pairs each step emits.  Every time it records is read on its own
clock (``time.perf_counter``) when a step returns, which is when a client
would see the tokens of that step."""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np

from bench.harness.traffic import Spec, Stream

clock = time.perf_counter


@dataclasses.dataclass
class Request:
    rid: int
    spec: Spec
    client: int
    arrival: float
    tokens: List[int] = dataclasses.field(default_factory=list)
    first: Optional[float] = None       # first token seen
    last: Optional[float] = None        # last token seen
    finish: Optional[float] = None      # budget met

    @property
    def plen(self) -> int:
        return int(self.spec.prompt.shape[0])

    @property
    def done(self) -> bool:
        return len(self.tokens) >= self.spec.max_new_tokens

    @property
    def ttft(self) -> float:
        return self.first - self.arrival

    @property
    def tpot(self) -> float:
        """Mean gap between tokens after the first (nan for one token)."""
        n = len(self.tokens)
        return (self.last - self.first) / (n - 1) if n > 1 else float("nan")


@dataclasses.dataclass
class Step:
    t0: float
    t1: float
    prompts: List[int]          # prompt lengths of the requests admitted
    decode_tokens: int          # tokens emitted by the decode step

    @property
    def admitted(self) -> int:
        return len(self.prompts)

    @property
    def prefill_tokens(self) -> int:
        return sum(self.prompts)


class ClosedLoop:
    """``clients`` clients over one scheduler, each sending its next
    request from ``stream`` when its last one has finished."""

    def __init__(self, sched, stream: Stream, clients: int, span=None):
        self.sched = sched
        self.stream = stream
        self.clients = clients
        self.span = span            # a context factory around each step
        self.requests: Dict[int, Request] = {}
        self.steps: List[Step] = []
        self.joined = 0

    def submit(self, client: int, spec: Spec) -> None:
        now = clock()
        rid = self.sched.submit(spec.prompt, spec.max_new_tokens,
                                arrival_time=now)
        self.requests[rid] = Request(rid, spec, client, now)

    def step(self) -> Step:
        t0 = clock()
        if self.span is not None:
            with self.span("bench:step"):
                emitted = self.sched.step()
        else:
            emitted = self.sched.step()
        t1 = clock()
        prompts: List[int] = []
        decode = 0
        finished = []
        for rid, tok in emitted:
            r = self.requests[rid]
            if not r.tokens:
                r.first = t1
                prompts.append(r.plen)
            else:
                decode += 1
            r.tokens.append(int(tok))
            r.last = t1
            if r.done:
                r.finish = t1
                finished.append(r)
        for r in finished:
            if r.client >= 0:
                self.submit(r.client, self.stream.take())
        s = Step(t0, t1, prompts, decode)
        self.steps.append(s)
        return s

    def warm(self, warm_steps: int) -> None:
        """Shape warm-up requests, then the clients joining one per step,
        then steps up to ``warm_steps`` in all."""
        for spec in self.stream.warm():
            self.submit(-1, spec)
        n = 0
        while self.joined < self.clients or n < warm_steps:
            if self.joined < self.clients:
                self.submit(self.joined, self.stream.take())
                self.joined += 1
            self.step()
            n += 1

    def window(self, seconds: float):
        """Steps for ``seconds`` from now; returns the window's (open,
        close) on the harness's clock (each step ends in a sync)."""
        t_open = clock()
        while clock() - t_open < seconds:
            self.step()
        return t_open, clock()


def in_window(requests, t_open: float, t_close: float) -> List[Request]:
    """Requests of the clients that emitted a token inside the window."""
    return [r for r in requests.values() if r.client >= 0 and r.tokens
            and r.last is not None and r.last >= t_open
            and r.arrival <= t_close]


def finished_in(requests, t_open: float, t_close: float) -> List[Request]:
    return [r for r in requests.values() if r.client >= 0
            and r.finish is not None and t_open <= r.finish <= t_close]


def percentile(xs, q: float) -> Optional[float]:
    xs = [x for x in xs if x == x]
    return float(np.percentile(xs, q)) if xs else None
