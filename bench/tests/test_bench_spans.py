"""The program's spans as the benchmark reads them: device time goes under
the ``repro:`` range open when its launch began, not where it ran; nested
ranges give self and inclusive time; an idle gap goes under the innermost
range open at its middle; the layers' shares read their spans, and a
traced run's events reach the reduction (``Run.spans``).  On the card, one traced window
of the guarded cell holds the crossbar kernel under ``repro:pim.exec``."""
import dataclasses
from pathlib import Path

import pytest
import torch

from bench.harness import closed_loop, main as harness, readers, spans
from bench.harness.spec import load_cell

CPU, CUDA = "cpu", "cuda"


@dataclasses.dataclass
class Ev:
    """A profiler event as ``kineto_results.events()`` gives it."""
    n: str
    t: int
    d: int
    dev: str = CPU
    corr: int = 0
    linked: int = 0
    tid: int = 1
    annotation: bool = False

    def name(self):
        return self.n

    def start_ns(self):
        return self.t

    def duration_ns(self):
        return self.d

    def device_type(self):
        return self.dev

    def correlation_id(self):
        return self.corr

    def linked_correlation_id(self):
        return self.linked

    def start_thread_id(self):
        return self.tid

    def is_user_annotation(self):
        return self.annotation or self.n.startswith(("repro:", "bench:"))


def _launch(t, corr, run_at, dur, name="k"):
    """A runtime call at ``t`` and the kernel it launched, run on the
    device at ``run_at`` for ``dur`` ns."""
    return [Ev("cudaLaunchKernel", t, 5, corr=corr),
            Ev(name, run_at, dur, dev=CUDA, corr=corr)]


def _window(events, t0=0, t1=10_000):
    return [Ev("bench:window", t0, t1 - t0)] + events


def test_a_kernel_goes_under_the_span_that_launched_it():
    # launched inside pim.pack, run on the device while the host is in
    # pim.exec: it is pim.pack's
    ev = _window([Ev("repro:pim.pack", 100, 100),
                  Ev("repro:pim.exec", 250, 200)]
                 + _launch(150, 7, 300, 100)
                 + _launch(260, 8, 400, 40, "crossbar_exec_kernel"))
    sp = spans.reduce(ev, CUDA)
    assert sp.self_ns == {"pim.pack": 100, "pim.exec": 40}
    assert sp.inclusive_ns("pim.pack") == 100
    assert sp.busy_ns == 140
    assert sp.covered == 100.0


def test_nested_spans_give_self_and_inclusive_time_without_rids():
    ev = _window([Ev("repro:sched.decode|rid=3,7", 0, 5000),
                  Ev("repro:linear", 100, 1000),
                  Ev("repro:pim.pack", 200, 100),
                  Ev("repro:pim.read|rid=3", 600, 100)]
                 + _launch(150, 1, 2000, 10)      # linear itself
                 + _launch(250, 2, 2100, 20)      # pim.pack
                 + _launch(650, 3, 2200, 30)      # pim.read
                 + _launch(3000, 4, 3100, 40)     # sched.decode itself
                 + _launch(6000, 5, 6100, 50))    # outside every range
    sp = spans.reduce(ev, CUDA)
    assert sp.self_ns == {"linear": 10, "pim.pack": 20, "pim.read": 30,
                          "sched.decode": 40, spans.OUTSIDE: 50}
    assert sp.inclusive_ns("linear") == 60
    assert sp.inclusive_ns("sched.decode") == 100
    assert sp.inclusive_ns("pim.pack", "pim.read") == 50
    assert sp.names == {"sched.decode", "linear", "pim.pack", "pim.read"}
    assert sp.covered == pytest.approx(100.0 * 100 / 150)
    assert sp.share("linear") == pytest.approx(100.0 * 60 / 150)
    assert sp.share("moe.ffn") is None
    assert sp.n_ranges == 4
    bd = sp.breakdown()
    assert bd["program_device"][0] == [spans.OUTSIDE, 50e-9]
    assert set(bd) == {"program_device", "program_idle_gaps"}


def test_an_idle_gap_goes_under_the_innermost_open_span():
    # busy 1000-1100 and 3000-3100 inside a window of 0-4000: the gap
    # 1100-3000 has its middle at 2050, inside moe.route inside moe.ffn
    ev = _window([Ev("repro:moe.ffn", 900, 2500),
                  Ev("repro:moe.route", 2000, 200),
                  Ev("repro:ssm.mixer", 3500, 400)]
                 + _launch(950, 1, 1000, 100)
                 + _launch(2100, 2, 3000, 100), t1=4000)
    sp = spans.reduce(ev, CUDA)
    assert sp.gaps == {spans.OUTSIDE: 1000, "moe.route": 1900,
                       "ssm.mixer": 900}


def test_the_window_clips_and_a_launch_on_another_thread_is_found():
    # a kernel of a second thread's span, and one running past the window
    ev = _window([Ev("repro:pim.exec", 100, 100),
                  Ev("repro:pim.pack", 100, 100, tid=2),
                  Ev("cudaLaunchKernel", 150, 5, corr=9, tid=2),
                  Ev("k", 300, 100, dev=CUDA, corr=9)]
                 + _launch(120, 1, 900, 200), t1=1000)
    sp = spans.reduce(ev, CUDA)
    assert sp.self_ns == {"pim.pack": 100, "pim.exec": 100}


def test_no_program_spans_reads_nothing():
    # the program before its spans: the trace has device work but no
    # repro: range, so the metrics are left out rather than read as 0
    sp = spans.reduce(_window(_launch(10, 1, 20, 30)), CUDA)
    assert sp.self_ns == {spans.OUTSIDE: 30}
    assert sp.share("pim.pack") is None


def test_the_layer_shares_read_their_spans():
    ev = _window([Ev("repro:linear", 0, 900),
                  Ev("repro:linear.quantize", 10, 50),
                  Ev("repro:pim.pack", 100, 100),
                  Ev("repro:pim.exec", 200, 100),
                  Ev("repro:pim.read", 300, 100),
                  Ev("repro:linear.rescale", 400, 50)]
                 + _launch(20, 1, 1000, 10) + _launch(150, 2, 1010, 40)
                 + _launch(250, 3, 1050, 30) + _launch(350, 4, 1080, 15)
                 + _launch(410, 5, 1095, 5))
    sp = spans.reduce(ev, CUDA)
    got = {n: sp.share(*names) for n, names in spans.SHARES.items()}
    assert got == pytest.approx({"pim_pack_share": 40.0,
                                 "pim_read_share": 15.0,
                                 "linear_quant_share": 15.0})


@pytest.mark.parametrize("name", sorted(spans.SHARES))
def test_the_share_metrics_read_run_spans(name):
    """Each of the guarded cell's span metrics reads its spans' share of
    ``Run.spans``, and nothing without a trace."""
    cell = load_cell("jamba-pim.decode")
    metric = {m.name: m for m in cell.per_layer}[name]
    names = spans.SHARES[name]
    sp = spans.Spans(800, {n: 10 for n in names} | {"pim.exec": 700},
                     {frozenset({"linear", n}): 10 for n in names}
                     | {frozenset({"linear", "pim.exec"}): 700}, {}, 3)
    run = harness.Run(cell=cell, setup_s=1.0, t_open=0.0, t_close=1.0,
                      steps=[], requests={}, program_metrics=None,
                      active_samples=[], uploads=0, trace=None,
                      traced_steps=[], spans=sp)
    assert metric.read(run) == pytest.approx(100.0 * 10 * len(names) / 800)
    run.spans = None
    assert metric.read(run) is None


def test_capture_reduces_the_events_a_traced_run_summarizes(smoke_root):
    # a traced smoke run on the CPU: the program's ranges are in the
    # window and reach Run.spans, no device work is, and the harness's
    # own summary is intact; an untraced run has no spans
    cell = load_cell("j.pim", Path(smoke_root))
    run, _ = harness.serve(cell, 2147483951, 0.2, True,
                           torch.device("cpu"), closed_loop.clock())
    assert run.trace is not None and run.spans is not None
    assert run.spans.n_ranges > 0
    assert run.spans.busy_ns == 0 and run.spans.share("pim.pack") is None
    run, _ = harness.serve(cell, 2147483951, 0.2, False,
                           torch.device("cpu"), closed_loop.clock())
    assert run.trace is None and run.spans is None


@pytest.mark.card
def test_pim_exec_holds_the_crossbar_kernel(card):
    """A traced window of the guarded cell: device time under
    ``repro:pim.exec`` is the crossbar kernel's within 1 %, and at least
    98 % of the device time falls under some ``repro:`` range."""
    cell = load_cell("jamba-pim.decode")
    run, _ = harness.serve(cell, 2147483951, 1.0, True, card,
                           closed_loop.clock())
    sp = run.spans
    kernel = run.trace.kernel_s(readers.CROSSBAR_KERNEL) * 1e9
    under = sp.inclusive_ns("pim.exec")
    assert kernel > 0
    assert abs(under - kernel) <= 0.01 * kernel, (under, kernel)
    assert sp.covered >= 98.0, sp.breakdown()
