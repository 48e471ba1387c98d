"""Device time by the program's own spans: the ``repro:`` ranges that
``repro_torch.runtime.trace.span`` opens while a profiler records.

Each device operation (kernel, copy or set) goes under the innermost
``repro:`` range that was open on the launching thread when the runtime
call that launched it began; the runtime call is the host event that
shares the operation's correlation id.  Where the operation ran on the
device does not matter: with the host running ahead, a kernel launched
under one span often runs while the host is in a later one.  Each idle
gap of the device goes under the innermost range open on the main thread
(the one holding ``bench:window``) at the gap's middle.

A range's name loses its ``|rid=...`` part; a device operation launched
outside every range, or by no runtime call in the trace, goes under
:data:`OUTSIDE`.  A ``--trace 1`` run reduces the same events as
``trace.summarize`` onto ``Run.spans``, which a metric reads with
``run.spans.share(...)``, and writes nothing to disk.  To read one cell's
traced steps by span on the card (JSON on standard output)::

    PYTHONPATH=src python3 -m bench.harness.spans --workload <cell> --seed <n>
"""
from __future__ import annotations

import collections
import dataclasses
import sys
from typing import Dict, FrozenSet, List, Optional, Tuple

from bench.harness import trace as trace_mod

PREFIX = "repro:"
OUTSIDE = "(outside repro:)"
#: Host events of CUDA's launch calls (``cudaLaunchKernel``,
#: ``cudaMemcpyAsync``, ``cuLaunchKernelEx``, ...), paired with the device
#: work they launched by correlation id.
RUNTIME_PREFIX = "cu"
#: The layers' shares of the device's busy time and the spans each reads.
SHARES = {"pim_pack_share": ("pim.pack",), "pim_read_share": ("pim.read",),
          "linear_quant_share": ("linear.quantize", "linear.rescale")}


def strip(name: str) -> str:
    """``repro:pim.pack|rid=3`` -> ``pim.pack``."""
    return name[len(PREFIX):].split("|", 1)[0]


@dataclasses.dataclass
class Spans:
    busy_ns: int                          # union of device intervals
    self_ns: Dict[str, int]               # device ns by innermost span
    under: Dict[FrozenSet[str], int]      # device ns by the spans open
    gaps: Dict[str, int]                  # idle ns by innermost span
    n_ranges: int                         # repro: ranges in the window

    @property
    def device_ns(self) -> int:
        return sum(self.self_ns.values())

    @property
    def names(self) -> FrozenSet[str]:
        return frozenset().union(*self.under) if self.under else frozenset()

    def inclusive_ns(self, *names: str) -> int:
        """Device ns launched under any of ``names`` (nested or not)."""
        want = set(names)
        return sum(v for k, v in self.under.items() if k & want)

    def share(self, *names: str) -> Optional[float]:
        """Device time launched under any of ``names`` over the busy time,
        in %; None where no such span launched device work."""
        if self.busy_ns <= 0 or not self.names & set(names):
            return None
        return 100.0 * self.inclusive_ns(*names) / self.busy_ns

    @property
    def covered(self) -> Optional[float]:
        """Share of device time launched under some ``repro:`` range, %."""
        total = self.device_ns
        if total <= 0:
            return None
        return 100.0 * (total - self.self_ns.get(OUTSIDE, 0)) / total

    def breakdown(self, top: int = 10) -> Dict:
        dev = sorted(self.self_ns.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.gaps.items(), key=lambda kv: -kv[1])[:top]
        return {"program_device": [[k, v / 1e9] for k, v in dev],
                "program_idle_gaps": [[k, v / 1e9] for k, v in gaps]}


class _Thread:
    """One thread's ranges, properly nested: the innermost open at a
    time, and the names of it and every range around it."""

    def __init__(self, ranges: List[Tuple[int, int, str]]):
        self.ranges = sorted(ranges, key=lambda r: (r[0], -r[1]))
        self.parent: List[int] = []
        stack: List[int] = []
        for i, (s, _, _) in enumerate(self.ranges):
            while stack and self.ranges[stack[-1]][1] <= s:
                stack.pop()
            self.parent.append(stack[-1] if stack else -1)
            stack.append(i)
        self._names: Dict[int, FrozenSet[str]] = {}

    def innermost(self, times: List[int]) -> List[int]:
        """Index of the innermost range open at each of ``times`` (any
        order), or -1."""
        order = sorted(range(len(times)), key=times.__getitem__)
        out = [-1] * len(times)
        stack: List[int] = []
        i = 0
        for j in order:
            t = times[j]
            while i < len(self.ranges) and self.ranges[i][0] <= t:
                start = self.ranges[i][0]
                while stack and self.ranges[stack[-1]][1] <= start:
                    stack.pop()
                stack.append(i)
                i += 1
            while stack and self.ranges[stack[-1]][1] <= t:
                stack.pop()
            out[j] = stack[-1] if stack else -1
        return out

    def name(self, i: int) -> str:
        return self.ranges[i][2] if i >= 0 else OUTSIDE

    def open_names(self, i: int) -> FrozenSet[str]:
        """The names of range ``i`` and of every range around it."""
        if i < 0:
            return frozenset()
        if i not in self._names:
            self._names[i] = (frozenset((self.ranges[i][2],))
                              | self.open_names(self.parent[i]))
        return self._names[i]


def reduce(events, device_type_cuda) -> Spans:
    """Reduce the profiler's events (``prof.profiler.kineto_results
    .events()``) of a window traced under a ``bench:window`` span to
    device time by span."""
    ranges: Dict[int, List[Tuple[int, int, str]]] = collections.defaultdict(
        list)
    launches: Dict[int, Tuple[int, int]] = {}    # correlation -> (t, tid)
    dev: List[Tuple[int, int, int]] = []
    window = None
    for e in events:
        name = e.name()
        s = e.start_ns()
        end = s + e.duration_ns()
        if e.device_type() == device_type_cuda:
            if not (e.is_user_annotation() or name.startswith(PREFIX)
                    or name.startswith(trace_mod.SPAN)):
                dev.append((s, end, e.correlation_id()))
        elif name.startswith(PREFIX):
            ranges[e.start_thread_id()].append((s, end, strip(name)))
        elif name == trace_mod.WINDOW:
            window = (s, end, e.start_thread_id())
        elif name.startswith(RUNTIME_PREFIX):
            launches[e.correlation_id()] = (s, e.start_thread_id())
    if window is None:
        raise RuntimeError("the trace holds no bench:window span")
    t0, t1, main = window
    threads = {tid: _Thread(r) for tid, r in ranges.items()}
    none = _Thread([])                      # a thread that opened no range
    dev = [(max(s, t0), min(e, t1), c) for s, e, c in dev
           if e > t0 and s < t1]

    # each device operation under the range open at its launch
    # launching thread -> [(launch time, index in dev)]
    asks: Dict[Optional[int], List[Tuple[int, int]]] = (
        collections.defaultdict(list))
    for k, (_, _, corr) in enumerate(dev):
        t, tid = launches.get(corr, (0, None))
        asks[tid].append((t, k))
    self_ns: Dict[str, int] = collections.Counter()
    under: Dict[FrozenSet[str], int] = collections.Counter()
    for tid, qs in asks.items():
        th = threads.get(tid, none)
        for (_, k), i in zip(qs, th.innermost([t for t, _ in qs])):
            ns = dev[k][1] - dev[k][0]
            self_ns[th.name(i)] += ns
            if i >= 0:
                under[th.open_names(i)] += ns

    # idle gaps under the main thread's range at their middle
    busy = trace_mod._union([(s, e) for s, e, _ in dev])
    gaps_iv, prev = [], t0
    for s, e in busy:
        if s > prev:
            gaps_iv.append((prev, s))
        prev = max(prev, e)
    if t1 > prev:
        gaps_iv.append((prev, t1))
    gaps: Dict[str, int] = collections.Counter()
    th = threads.get(main, none)
    mids = [(s + e) // 2 for s, e in gaps_iv]
    for (s, e), i in zip(gaps_iv, th.innermost(mids)):
        gaps[th.name(i)] += e - s
    n = sum(1 for r in ranges.values() for s, e, _ in r if e > t0 and s < t1)
    return Spans(sum(e - s for s, e in busy), dict(self_ns), dict(under),
                 dict(gaps), n)


def main(argv=None) -> int:
    """Serve one cell with its traced steps, as a ``--trace 1`` run does
    before its window, and print the device time by span as JSON."""
    import argparse
    import json

    import torch

    from bench.harness import closed_loop, main as harness
    from bench.harness.spec import load_cell

    ap = argparse.ArgumentParser(description=main.__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=1.0,
                    help="the untraced window after the traced steps")
    args = ap.parse_args(argv)
    t_start = closed_loop.clock()
    cell = load_cell(args.workload)
    dev = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    run, _ = harness.serve(cell, args.seed, args.seconds, True, dev, t_start)
    sp = run.spans
    steps = len(run.traced_steps)
    print(json.dumps({
        "card": harness.power_limit(), "traced_steps": steps,
        "window_s": run.trace.window_s, "busy_s": run.trace.busy_s,
        "steps_per_s": steps / run.trace.window_s,
        "ranges_per_step": sp.n_ranges / max(steps, 1),
        "covered": sp.covered,
        "crossbar_exec_kernel_s": run.trace.kernel_s("crossbar_exec_kernel"),
        "shares": {k: sp.share(*v) for k, v in SHARES.items()},
        **sp.breakdown()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
