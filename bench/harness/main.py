"""One run of one cell: set up, warm up, measure for ``--seconds``, check
what was served against the plain reference, print one JSON line.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

With ``--trace 0`` the line's metrics are the cell's end-to-end metrics.
With ``--trace 1`` they are its per-layer metrics: ``trace_seconds`` of
steps run under ``torch.profiler`` after the warm-up (the device metrics
read them, by the benchmark's ``bench:`` spans and by the program's
``repro:`` spans), then the window runs untraced (the others read it)."""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import subprocess
import sys
from pathlib import Path
from typing import Dict, List, Optional

from bench.harness import check, closed_loop, spans as spans_mod
from bench.harness import trace as trace_mod
from bench.harness.spec import Cell, load_cell
from bench.harness.traffic import Stream

#: Top-level module names that may not be loaded in a run: the JAX
#: package this program was ported from, and JAX itself.
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class Run:
    """What the metric readers (``bench/metrics/<name>.py``) read."""

    cell: Cell
    setup_s: float
    t_open: float
    t_close: float
    steps: List[closed_loop.Step]       # the window's
    requests: Dict[int, closed_loop.Request]
    program_metrics: object             # the scheduler's ServingMetrics
    active_samples: List[int]           # the window's
    uploads: int                        # pim state uploads in the window
    trace: Optional[trace_mod.Trace]    # the traced steps' (--trace 1)
    traced_steps: List[closed_loop.Step]
    spans: Optional[spans_mod.Spans] = None   # the same steps by repro: span

    @property
    def window_s(self) -> float:
        return self.t_close - self.t_open

    @property
    def finished(self) -> List[closed_loop.Request]:
        return closed_loop.finished_in(self.requests, self.t_open, self.t_close)

    @property
    def decode_steps(self) -> List[closed_loop.Step]:
        return [s for s in self.steps if s.decode_tokens]


def forbidden_modules() -> List[str]:
    return sorted({m for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def power_limit() -> Optional[str]:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None


def program_config(cell: Cell):
    from repro_torch.models.config import ModelConfig

    names = {f.name for f in dataclasses.fields(ModelConfig)}
    kw = {k: v for k, v in cell.config["model"].items() if k in names}
    kw["pattern"] = tuple(kw.get("pattern", ("ad",)))
    kw["pim_mode"] = cell.mode
    return ModelConfig(**kw)


def check_tree(params, cfg) -> None:
    """The drawn tree must be the tree the program takes."""
    from repro_torch.models import model_lib as M
    from repro_torch.tree import leaves

    want, have = ({tuple(p): (tuple(s.shape), s.dtype) for p, s in leaves(t)}
                  for t in (M.param_specs(cfg), params))
    if want != have:
        raise RuntimeError(
            "the program's parameter tree differs from the benchmark's: "
            f"{sorted(set(want.items()) ^ set(have.items()))[:6]}")


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def serve(cell: Cell, seed: int, seconds: float, traced_run: bool, dev,
          t_start: float):
    """Set up, warm up, with ``traced_run`` trace ``trace_seconds`` of
    steps, and run the window; returns (Run, params)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.pim import engine
    from repro_torch.serving.scheduler import Scheduler, ServingConfig

    cfg = program_config(cell)
    params = cell.reference.draw(cell.arch, seed, dev)
    check_tree(params, cfg)
    if dev.type == "cuda":
        from repro_torch.kernels import build

        build.build()
    sched = Scheduler(params, cfg, ServingConfig(**cell.serving),
                      clock=closed_loop.clock, device=dev)
    loop = closed_loop.ClosedLoop(sched, Stream(cell.mix, seed,
                                           cell.arch.vocab_size),
                             cell.mix.clients,
                             span=record_function if traced_run else None)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    trace, program_spans, traced = None, None, []
    with contextlib.ExitStack() as stack:
        if traced_run:
            trace_mod.install(stack, record_function)
        loop.warm(cell.mix.warm_steps)
        sync()
        setup_s = closed_loop.clock() - t_start
        if traced_run:
            # the trace first, then the window its stop would disturb
            n0 = len(loop.steps)
            acts = [ProfilerActivity.CPU]
            if dev.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            with profile(activities=acts) as prof:
                with record_function(trace_mod.WINDOW):
                    loop.window(cell.trace_seconds)
            events = list(prof.profiler.kineto_results.events())
            cuda = torch.autograd.DeviceType.CUDA
            trace = trace_mod.summarize(events, cuda)
            program_spans = spans_mod.reduce(events, cuda)
            traced = loop.steps[n0:]
            del events, prof
        uploads0 = engine.cache_info().exec_uploads
        n_active0 = len(sched.metrics.active_samples)
        n_steps0 = len(loop.steps)
        t_open, t_close = loop.window(seconds)
    run = Run(cell=cell, setup_s=setup_s, t_open=t_open,
              t_close=t_close, steps=loop.steps[n_steps0:],
              requests=loop.requests, program_metrics=sched.metrics,
              active_samples=list(sched.metrics.active_samples[n_active0:]),
              uploads=engine.cache_info().exec_uploads - uploads0,
              trace=trace, traced_steps=traced, spans=program_spans)
    return run, params


def free_program() -> None:
    """Drop what the program holds on the card before the reference runs:
    the scheduler's pool (gone with the scheduler) and the engine's caches
    and resident crossbar state."""
    import torch

    from repro_torch.pim import engine

    engine.clear_cache()
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def main(argv=None, *, root: Optional[Path] = None, device=None,
         t_start: Optional[float] = None) -> int:
    """Run one cell; ``device`` (the tests' hook) skips the look for a card
    and runs there instead, and skips the look for JAX in ``sys.modules``
    (a test process may hold it; ``bench/tests/test_bench_nojax.py`` runs
    that look in a process of its own)."""
    t_start = closed_loop.clock() if t_start is None else t_start
    args = parse(argv)
    cell = load_cell(args.workload, root)
    import torch

    testing = device
    if device is None:
        if not torch.cuda.is_available():
            print("no CUDA device: torch.cuda.is_available() is False",
                  file=sys.stderr)
            return 2
        if torch.cuda.device_count() < cell.chips:
            print(f"{cell.name} needs {cell.chips} cards; "
                  f"{torch.cuda.device_count()} present", file=sys.stderr)
            return 2
        device = "cuda"
    dev = torch.device(device)
    card = power_limit() if dev.type == "cuda" else None
    if card:
        print(f"card (name, power limit): {card}", file=sys.stderr)
    run, params = serve(cell, args.seed, args.seconds, bool(args.trace), dev,
                        t_start)
    peak = (torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0)
    bad = forbidden_modules() if testing is None else []
    if bad:
        print(f"forbidden modules loaded in the run: {bad}", file=sys.stderr)
        return 3
    wanted = run.cell.per_layer if args.trace else run.cell.end_to_end
    metrics = {}
    for m in wanted:
        v = m.read(run)
        if v is not None:
            metrics[m.name] = {"value": v, "unit": m.unit}
    served = closed_loop.in_window(run.requests, run.t_open, run.t_close)
    smp = check.sample(served, cell.sample, args.seed)
    attempted = len(served)
    print(f"window {run.window_s:.3f} s: {len(run.steps)} steps "
          f"({len(run.decode_steps)} decoding), {len(run.finished)} requests "
          f"finished, {sum(s.admitted for s in run.steps)} admitted",
          file=sys.stderr)
    program_metrics = run.program_metrics
    run.program_metrics = None
    del program_metrics
    free_program()
    per_req = check.gaps(params, cell.arch, smp, cell.bits, cell.wide, dev,
                         ref=cell.reference)
    read = check.readings(per_req)
    correct, checks = check.judge(read, cell.limits)
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": (torch.cuda.get_device_name(0)
                            if dev.type == "cuda" else "cpu"),
                   "count": cell.chips, "memory_peak_bytes": int(peak)}
    if card:
        device_info["card"] = card
    result = {"correct": bool(correct), "attempted": attempted,
              "failed": sum(1 for g in per_req
                            if not check.judge(check.readings([g]),
                                               cell.limits)[0]),
              "metrics": metrics, "device": device_info}
    if args.trace and run.trace is not None:
        device_info["busy_s"] = run.trace.busy_s
        device_info["window_s"] = run.trace.window_s
        result["breakdown"] = run.trace.breakdown()
        if run.spans is not None:
            result["breakdown"].update(run.spans.breakdown())
    result["checks"] = checks
    print(f"checked {sum(len(r.tokens) for r in smp)} served tokens of "
          f"{len(smp)} requests; readings {read}; per request "
          f"{[check.readings([g]) for g in per_req]}", file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
