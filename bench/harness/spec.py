"""What one run is asked to do, found by name under the benchmark's root.

``BENCHMARK.json`` names a cell's configuration and traffic mix and the
metrics it reports; ``bench/configs/<config>.json``,
``bench/traffic/<mix>.json``, ``bench/cells/<cell>.json`` and
``bench/metrics/<metric>.py`` hold the rest.  Adding a configuration, a
mix, a cell or a metric is adding files and entries: nothing here names
one."""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List, Optional

from bench.harness.traffic import Mix
from bench.reference.arch import Arch

BENCH_DIR = Path(__file__).resolve().parents[1]

CELL_KEYS = {"mode", "serving", "trace_seconds", "check"}
CHECK_KEYS = {"sample", "limits"}
STATS = ("logit_gap_max", "logit_gap_mean")
MODE_BITS = {"quant": 8, "pim_sim": 7}


@dataclasses.dataclass(frozen=True)
class Metric:
    name: str
    unit: str
    better: str
    source: str
    read: Callable


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    chips: int
    config: Dict            # the configuration file
    arch: Arch
    mix: Mix
    mode: str               # "quant" | "pim_sim"
    serving: Dict           # ServingConfig fields
    trace_seconds: float
    sample: int             # requests the check compares
    limits: Dict[str, float]   # the check's compared numbers and limits
    end_to_end: List[Metric]
    per_layer: List[Metric]

    @property
    def bits(self) -> int:
        return MODE_BITS[self.mode]

    @property
    def wide(self) -> bool:
        """Whether the mode rescales its integer products in float64."""
        return self.mode == "pim_sim"


def _json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def load_metric(bench_dir: Path, name: str) -> Callable:
    """``read(run)`` of ``bench/metrics/<name>.py``."""
    path = bench_dir / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "bench.metrics." + name.replace(".", "_"), path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _metrics(entries: List[Dict], cell: str, bench_dir: Path
             ) -> List[Metric]:
    return [Metric(e["name"], e["unit"], e["better"], e["source"],
                   load_metric(bench_dir, e["name"]))
            for e in entries
            if "workloads" not in e or cell in e["workloads"]]


def load_cell(name: str, root: Optional[Path] = None) -> Cell:
    """The cell ``name`` of ``<root>/BENCHMARK.json`` (root: the checkout
    holding ``bench/``)."""
    root = Path(root) if root is not None else BENCH_DIR.parent
    bench = _json(root / "BENCHMARK.json")
    bench_dir = root / bench["paths"][0]
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r}; have {sorted(cells)}")
    w = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = _json(root / conf["file"])
    mix = Mix.from_json(_json(bench_dir / "traffic" / f"{w['traffic']}.json"))
    own = _json(bench_dir / "cells" / f"{name}.json")
    unknown = set(own) - CELL_KEYS
    if unknown or set(own["check"]) - CHECK_KEYS:
        raise ValueError(f"unknown cell keys in {name}: {sorted(unknown)}")
    limits = {k: float(v) for k, v in own["check"]["limits"].items()}
    if not limits or set(limits) - set(STATS):
        raise ValueError(f"{name}: the check compares one or more of "
                         f"{STATS}, got {sorted(limits)}")
    if own["mode"] not in MODE_BITS:
        raise ValueError(f"{name}: mode {own['mode']!r} is not one of "
                         f"{sorted(MODE_BITS)}")
    arch = Arch.from_model(config["model"])
    if mix.longest_request > arch.max_seq_len:
        raise ValueError(f"{name}: a request of {mix.longest_request} "
                         f"tokens passes the pool's {arch.max_seq_len}")
    return Cell(name=name, chips=int(w["chips"]), config=config, arch=arch,
                mix=mix, mode=own["mode"],
                serving=dict(own["serving"]),
                trace_seconds=float(own["trace_seconds"]),
                sample=int(own["check"]["sample"]),
                limits=limits,
                end_to_end=_metrics(bench["end_to_end"], name, bench_dir),
                per_layer=_metrics(bench["per_layer"], name, bench_dir))
