"""Metric arithmetic on synthetic request records: the readers take all
the work and all the time of the window, and a stall inside the window
moves the rate and the tails."""
import dataclasses

import numpy as np
import pytest

from bench.harness import arith, closed_loop, readers
from bench.harness.main import Run
from bench.harness.spec import load_cell
from bench.harness.traffic import Spec
from bench.reference.arch import Arch


def _run(stall: float = 0.0):
    """A window of 20 steps of 0.1 s, each emitting 4 decode tokens, one
    request admitted every other step and finishing 8 steps later; a stall
    of ``stall`` seconds before step 10."""
    cell = load_cell("jamba-pim.decode")
    steps, reqs, t = [], {}, 0.0
    for i in range(20):
        arrival = t          # the end of the step before
        if i == 10:
            t += stall
        t0, t = t, t + 0.1
        prompts = [100] if i % 2 == 0 else []
        steps.append(closed_loop.Step(t0, t, prompts, 4))
        if i % 2 == 0:
            r = closed_loop.Request(i, Spec(i, np.zeros(100, np.int64), 9), 0,
                               arrival)
            r.tokens = [1] * 9
            r.first = t
            reqs[i] = r
    for i, r in reqs.items():
        done = steps[min(i + 8, 19)]
        r.last = r.finish = done.t1
    return Run(cell=cell, setup_s=1.0, t_open=0.0, t_close=t,
               steps=steps, requests=reqs, program_metrics=None,
               active_samples=[2] * 20, uploads=0, trace=None,
               traced_steps=[])


def _read(run, name):
    return {m.name: m for m in run.cell.end_to_end}[name].read(run)


def _p90_ms(run, what):
    return readers.ms_percentile([getattr(r, what) for r in run.finished],
                                 90)


def test_rates_take_the_whole_window():
    run = _run()
    assert _read(run, "tok_s") == pytest.approx((20 * 4 + 10) / 2.0)
    assert _read(run, "setup_s") == 1.0


def test_a_stall_moves_the_rate_and_the_tails():
    calm, stalled = _run(), _run(stall=1.0)
    assert _read(stalled, "tok_s") < 0.7 * _read(calm, "tok_s")
    assert _p90_ms(stalled, "tpot") > _p90_ms(calm, "tpot") + 50
    # a request that arrived just before the stall waits through it
    assert max(r.ttft for r in stalled.finished) > 1.0
    assert _p90_ms(stalled, "ttft") >= _p90_ms(calm, "ttft")


def test_unfinished_requests_are_not_in_the_tails():
    run = _run()
    fin = run.finished
    assert fin and all(r.finish <= run.t_close for r in fin)
    assert len(fin) == len(run.requests)


def test_frozen_arithmetic_matches_the_program():
    from repro_torch import configs
    from repro_torch.launch import roofline
    from repro_torch.models import model_lib as M

    for name, layers in (("jamba-v0.1-52b", 8), ("h2o-danube-1.8b", 24)):
        cfg = configs.get(name).scaled(n_layers=layers)
        a = Arch.from_model(dataclasses.asdict(cfg))
        assert arith.param_count(a) == M.param_count(cfg)
        assert arith.active_params(a) == roofline.active_params(cfg)
        assert arith.recurrence_flops(a, 7) == roofline.recurrence_flops(
            cfg, 7)


def test_kernel_bounds():
    # jamba's w_in at batch 2: 12,432 crossbars, 513.24 us by operations
    assert arith.pim_crossbars(2, 4096, 14336) == 12_432
    assert arith.crossbar_bound_s(2, 4096, 14336) * 1e6 == pytest.approx(
        513.24, abs=0.01)
    assert arith.crossbar_bound_by(2, 4096, 14336) == "operations"
    # danube's w_in at M = 4160: 74.39 us by operations
    assert arith.quant_bound_s(4160, 2560, 6912) * 1e6 == pytest.approx(
        74.39, abs=0.01)
    assert arith.quant_bound_by(4, 4096, 14336) == "bytes"
