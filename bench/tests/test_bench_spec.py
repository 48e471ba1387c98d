"""BENCHMARK.json and the files it names: every cell, configuration, mix
and metric loads by name, the entries keep to the benchmark file's format,
and an entry added as new files loads with no existing file edited."""
import json
import os
import re
import shutil

import pytest

from bench.harness import spec

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
with open(os.path.join(ROOT, "BENCHMARK.json")) as _f:
    BENCH = json.load(_f)
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("name", CELLS)
def test_cell_loads_by_name(name):
    cell = spec.load_cell(name)
    assert cell.end_to_end and cell.per_layer
    e2e = {m.name for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    moves = {m["name"]: m["moves"] for m in BENCH["per_layer"]}
    for m in cell.per_layer:
        assert moves[m.name] in e2e, (m.name, "moves a metric the cell "
                                      "does not report")
    assert cell.limits and all(v > 0 for v in cell.limits.values())


def test_the_benchmark_file_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"][1].startswith(BENCH["paths"][0] + "/")
    assert 1 <= BENCH["run_seconds"] <= 51
    names = []
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith(BENCH["paths"][0] + "/")
        with open(os.path.join(ROOT, c["file"])) as f:
            conf = json.load(f)
        assert sorted(conf["reduced"]) == sorted(c["reduced"])
        names.append(c["name"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        names.append(w["name"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        names.append(m["name"])
        assert os.path.exists(os.path.join(ROOT, BENCH["paths"][0],
                                           "metrics", m["name"] + ".py"))
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert all(NAME.match(n) for n in names)
    assert len(names) == len(set(names))


def test_an_added_entry_loads_without_editing(tmp_path):
    """A new configuration, mix, cell and per-layer metric are new files
    and new entries only."""
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "bench"), root / "bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = dict(BENCH)
    conf = json.loads((root / "bench/configs/jamba-v0.1-52b.p1.json"
                       ).read_text())
    conf["model"]["n_layers"] = 16
    conf["reduced"] = {"n_layers": {"published": 32, "here": 16}}
    (root / "bench/configs/dummy.json").write_text(json.dumps(conf))
    (root / "bench/traffic/dummy-mix.json").write_text(json.dumps(
        {"clients": 2, "strata": 2, "warm_steps": 0,
         "prompt_len": {"dist": "fixed", "value": 32},
         "new_tokens": {"dist": "fixed", "value": 4}}))
    (root / "bench/cells/dummy.cell.json").write_text(json.dumps(
        {"mode": "quant", "serving": {"max_batch": 2},
         "trace_seconds": 1,
         "check": {"sample": 1, "limits": {"logit_gap_mean": 0.1}}}))
    (root / "bench/metrics/dummy_metric.py").write_text(
        "def read(run):\n    return 42.0\n")
    bench["configs"] = BENCH["configs"] + [
        {"name": "dummy", "source": "test", "file": "bench/configs/dummy.json",
         "reduced": ["n_layers"], "why": "test"}]
    bench["workloads"] = BENCH["workloads"] + [
        {"name": "dummy.cell", "config": "dummy", "traffic": "dummy-mix",
         "chips": 1, "why": "test"}]
    bench["per_layer"] = BENCH["per_layer"] + [
        {"name": "dummy_metric", "unit": "count", "better": "higher",
         "source": "program_counter", "layer": "test", "moves": "tok_s",
         "workloads": ["dummy.cell"]}]
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.load_cell("dummy.cell", root)
    assert cell.arch.n_layers == 16 and cell.mix.clients == 2
    assert "dummy_metric" in {m.name for m in cell.per_layer}
    assert {m.name: m for m in cell.per_layer}["dummy_metric"].read(None) \
        == 42.0
    assert spec.load_cell("jamba-pim.decode", root).mode == "pim_sim"
