"""What one run is asked to do, found by name under the benchmark's root.

``BENCHMARK.json`` names a cell's configuration and traffic mix and the
metrics it reports; ``bench/configs/<config>.json``,
``bench/traffic/<mix>.json``, ``bench/cells/<cell>.json`` and
``bench/metrics/<metric>.py`` hold the rest, and a configuration file may
name its plain reference (``"reference": "<module>"``, the module
``bench/reference/<module>.py``; ``default`` without the key).  Adding a
configuration, its reference, a mix, a cell or a metric is adding files
and entries: nothing here names one."""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import sys
from pathlib import Path
from types import ModuleType
from typing import Callable, Dict, List, Optional

from bench.harness.traffic import Mix

BENCH_DIR = Path(__file__).resolve().parents[1]

CELL_KEYS = {"mode", "serving", "trace_seconds", "check"}
CHECK_KEYS = {"sample", "limits"}
STATS = ("logit_gap_max", "logit_gap_mean")
MODE_BITS = {"quant": 8, "pim_sim": 7}
DEFAULT_REFERENCE = "default"


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
    reference: ModuleType   # its plain reference (bench/reference/default.py)
    arch: object            # the reference's Arch of the configuration
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


def load_reference(bench_dir: Path, name: str) -> ModuleType:
    """The plain reference module ``bench/reference/<name>.py``."""
    path = (bench_dir / "reference" / f"{name}.py").resolve()
    if not path.is_file():
        raise FileNotFoundError(f"no reference module {path}")
    if path == (BENCH_DIR / "reference" / f"{name}.py").resolve():
        return importlib.import_module(f"bench.reference.{name}")
    # another checkout's module (the tests' copies of bench/): a name of
    # its own, registered so that the classes it defines can find it
    modname = f"bench.reference._{name}_{abs(hash(str(path))):x}"
    if modname not in sys.modules:
        spec = importlib.util.spec_from_file_location(modname, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[modname] = mod
        try:
            spec.loader.exec_module(mod)
        except BaseException:
            del sys.modules[modname]
            raise
    return sys.modules[modname]


def covered(name: str, model: Dict, ref: ModuleType) -> None:
    """Refuse a configuration its reference would compute otherwise than
    the program: a block kind it does not compute, or a field of
    ``"model"`` that neither its ``Arch`` reads nor it lists as the
    program's alone."""
    kinds = [k for k in model.get("pattern", ["ad"]) if k not in ref.KINDS]
    if kinds:
        raise ValueError(f"{name}: the reference {ref.__name__} computes "
                         f"no block kind {kinds[0]!r} (it computes "
                         f"{list(ref.KINDS)})")
    read = {f.name for f in dataclasses.fields(ref.Arch)}
    unread = sorted(set(model) - read - set(ref.PROGRAM_ONLY))
    if unread:
        raise ValueError(f"{name}: the reference {ref.__name__} does not "
                         f"read the model field {unread[0]!r}")


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
    ref = load_reference(bench_dir, config.get("reference",
                                               DEFAULT_REFERENCE))
    covered(f"{name} ({w['config']})", config["model"], ref)
    arch = ref.Arch.from_model(config["model"])
    if mix.longest_request > arch.max_seq_len:
        raise ValueError(f"{name}: a request of {mix.longest_request} "
                         f"tokens passes the pool's {arch.max_seq_len}")
    return Cell(name=name, chips=int(w["chips"]), config=config,
                reference=ref, arch=arch,
                mix=mix, mode=own["mode"],
                serving=dict(own["serving"]),
                trace_seconds=float(own["trace_seconds"]),
                sample=int(own["check"]["sample"]),
                limits=limits,
                end_to_end=_metrics(bench["end_to_end"], name, bench_dir),
                per_layer=_metrics(bench["per_layer"], name, bench_dir))
