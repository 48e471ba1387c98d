"""On the card: each cell's control at the cell's own size, on three
seeds, with a short window, reads above the cell's limit while the
program's own served tokens read below it.  Run on the card with
``python3 -m pytest -m card bench/tests``."""
import json
import os

import pytest

from bench.harness import check, closed_loop, main as harness
from bench.harness.spec import load_cell

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
with open(os.path.join(ROOT, "BENCHMARK.json")) as _f:
    CELLS = [w["name"] for w in json.load(_f)["workloads"]]
SEEDS = (2147483911, 2147483923, 2147483929)


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_and_program_passes(card, name):
    cell = load_cell(name)
    for seed in SEEDS:
        run, params = harness.serve(cell, seed, 5.0, False, card,
                                    closed_loop.clock())
        served = closed_loop.in_window(run.requests, run.t_open, run.t_close)
        smp = check.sample(served, cell.sample, seed)
        run.program_metrics = None
        harness.free_program()
        prog = check.readings(check.gaps(params, cell.arch, smp, cell.bits,
                                         cell.wide, card, cell.reference))
        ctl = check.readings(check.control_gaps(
            params, cell.arch, smp, cell.bits, cell.wide, check.CONTROL_BITS,
            card, cell.reference))
        assert check.judge(prog, cell.limits)[0], (seed, prog)
        assert not check.judge(ctl, cell.limits)[0], (seed, ctl)
        del params, run
        harness.free_program()
