"""Reduction of a ``torch.profiler`` trace of some steps to what the
per-layer metrics read: device busy time, device time by kernel and by the
benchmark's span it ran under, and the idle gaps by the span the host was
in.

Spans are ``record_function`` ranges named ``bench:<what>`` that the
benchmark opens around its calls into the program (``install``); the
trace keeps them on the host's timeline, which the profiler aligns with
the device's.  Nothing of the trace is written to disk."""
from __future__ import annotations

import bisect
import collections
import contextlib
import dataclasses
from typing import Dict, List, Optional, Tuple
from unittest import mock

SPAN = "bench:"
WINDOW = "bench:window"
PHASES = ("bench:admit", "bench:decode")


@dataclasses.dataclass
class Trace:
    t0: int                     # traced window, ns on the profiler's clock
    t1: int
    busy_ns: int
    kernels: Dict[str, int]     # device ns by operation name
    by_phase: Dict[Tuple[str, str], int]   # (phase span, name) -> ns
    gaps: Dict[str, int]        # idle ns by innermost host span

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e9

    @property
    def busy_s(self) -> float:
        return self.busy_ns / 1e9

    def kernel_s(self, needle: str, phase: Optional[str] = None) -> float:
        if phase is None:
            return sum(v for k, v in self.kernels.items() if needle in k) / 1e9
        return sum(v for (p, k), v in self.by_phase.items()
                   if p == phase and needle in k) / 1e9

    def breakdown(self, top: int = 10) -> Dict:
        ops = sorted(self.kernels.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.gaps.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[k[:120], v / 1e9] for k, v in ops],
                "idle_gaps": [[k, v / 1e9] for k, v in gaps]}


def install(stack: contextlib.ExitStack, record_function) -> None:
    """Open a ``bench:`` span around each call into the program's layers
    (the scheduler's admit, prefill and decode, the model's linear, MoE and
    Mamba calls, the pim engine's execution)."""
    from repro_torch.models import model as model_mod
    from repro_torch.pim import engine
    from repro_torch.serving.scheduler import Scheduler

    def wrap(owner, attr, name):
        real = getattr(owner, attr)

        def call(*a, **kw):
            with record_function(name):
                return real(*a, **kw)

        stack.enter_context(mock.patch.object(owner, attr, call))

    wrap(Scheduler, "_admit", "bench:admit")
    wrap(Scheduler, "_prefill", "bench:prefill")
    wrap(Scheduler, "_decode", "bench:decode")
    wrap(model_mod, "linear", "bench:linear")
    wrap(model_mod, "moe_ffn", "bench:moe_ffn")
    wrap(model_mod, "mamba_mixer", "bench:mamba_mixer")
    wrap(engine.ExecutionSession, "execute", "bench:pim_execute")


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def _innermost(spans: List[Tuple[int, int, str]], times: List[int]
               ) -> List[Optional[str]]:
    """The innermost span open at each of ``times`` (sorted), for nested
    spans of one thread."""
    order = sorted(spans, key=lambda s: (s[0], -s[1]))
    out, stack, i = [], [], 0
    for t in times:
        while i < len(order) and order[i][0] <= t:
            while stack and stack[-1][1] <= order[i][0]:
                stack.pop()
            stack.append(order[i])
            i += 1
        while stack and stack[-1][1] <= t:
            stack.pop()
        out.append(stack[-1][2] if stack else None)
    return out


def summarize(events, device_type_cuda) -> Trace:
    """Reduce the profiler's events (``prof.profiler.kineto_results
    .events()``) of a window traced under a ``bench:window`` span."""
    spans, dev = [], []
    for e in events:
        name = e.name()
        s = e.start_ns()
        end = s + e.duration_ns()
        if e.device_type() == device_type_cuda:
            if name.startswith(SPAN) or e.is_user_annotation():
                continue
            dev.append((s, end, name))
        elif name.startswith(SPAN):
            spans.append((s, end, name))
    win = [sp for sp in spans if sp[2] == WINDOW]
    if not win:
        raise RuntimeError("the trace holds no bench:window span")
    t0, t1 = win[0][0], win[0][1]
    dev = [(max(s, t0), min(e, t1), n) for s, e, n in dev if e > t0 and s < t1]
    busy = _union([(s, e) for s, e, _ in dev])
    kernels: Dict[str, int] = collections.Counter()
    for s, e, n in dev:
        kernels[n] += e - s
    phase_spans = sorted((s, e, n) for s, e, n in spans if n in PHASES)
    starts = [s for s, _, _ in phase_spans]
    by_phase: Dict[Tuple[str, str], int] = collections.Counter()
    for s, e, n in dev:
        i = bisect.bisect_right(starts, s) - 1
        p = (phase_spans[i][2] if i >= 0 and phase_spans[i][1] >= s
             else "other")
        by_phase[(p, n)] += e - s
    gaps_iv, prev = [], t0
    for s, e in busy:
        if s > prev:
            gaps_iv.append((prev, s))
        prev = max(prev, e)
    if t1 > prev:
        gaps_iv.append((prev, t1))
    mids = [(s + e) // 2 for s, e in gaps_iv]
    names = _innermost([sp for sp in spans if sp[2] != WINDOW], mids)
    gaps: Dict[str, int] = collections.Counter()
    for (s, e), n in zip(gaps_iv, names):
        gaps[n or "bench:window"] += e - s
    return Trace(t0, t1, sum(e - s for s, e in busy), dict(kernels),
                 dict(by_phase), dict(gaps))
