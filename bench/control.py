"""The readings a cell's limits are set from, for many seeds in one process.

    python3 bench/control.py --workload <cell> --seeds 1,2,3 --seconds <s>

For each seed it runs the cell as ``bench/run.py`` does (without a trace)
and prints one JSON line with the readings of the program's served tokens
(``program``: the lower readings) and of the control (``control``: the
plain reference put in the program's place with its linears at
``check.CONTROL_BITS``, reading at each served position the gap of the
token it puts first), both against the reference at the configuration's
own precision.  The benchmark's own runs do not run the control."""
import json
import sys
import time

import run  # noqa: F401  (bench/run.py: the checkout's paths and caches)


def readings(cell, seed, seconds, dev, t_start):
    from bench.harness import check, closed_loop, main

    res, params = main.serve(cell, seed, seconds, False, dev, t_start)
    served = closed_loop.in_window(res.requests, res.t_open, res.t_close)
    smp = check.sample(served, cell.sample, seed)
    res.program_metrics = None
    main.free_program()
    t0 = time.perf_counter()
    prog = check.gaps(params, cell.arch, smp, cell.bits, cell.wide, dev,
                      ref=cell.reference)
    t_ref = time.perf_counter() - t0
    ctl = check.control_gaps(params, cell.arch, smp, cell.bits, cell.wide,
                             check.CONTROL_BITS, dev, ref=cell.reference)
    return {"seed": seed, "program": check.readings(prog),
            "control": check.readings(ctl),
            "program_per_request": [check.readings([g]) for g in prog],
            "control_per_request": [check.readings([g]) for g in ctl],
            "program_gaps_over_0.1": [int((g > 0.1).sum()) for g in prog],
            "requests": len(smp), "tokens": sum(len(r.tokens) for r in smp),
            "setup_s": res.setup_s, "reference_s": t_ref}


def main(argv=None):
    import argparse

    import torch

    from bench.harness.spec import load_cell

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cell = load_cell(args.workload)
    dev = torch.device(args.device)
    t_start = run.T_START
    for s in args.seeds.split(","):
        out = readings(cell, int(s), args.seconds, dev, t_start)
        out["workload"] = cell.name
        print(json.dumps(out), flush=True)
        t_start = time.perf_counter()
    return 0


if __name__ == "__main__":
    sys.exit(main())
