"""Test set-up for the benchmark's own tests (``bench/tests``).

Tests that need a card carry the ``card`` marker and take the ``card``
fixture, which skips them when no CUDA device is present; whether there is
one is decided in the fixture, never while a module is imported.  On the
card they run with::

    python3 -m pytest -m card bench/tests
"""
import json
import os
import shutil
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for _p in (os.path.join(ROOT, "src"), ROOT):
    if _p not in sys.path:
        sys.path.insert(0, _p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device; skipped without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda")


SMOKE_MODELS = {
    # the cells' configurations at the CPU tests' size: every block kind
    # of the benchmark's configurations, float32 so that the program and
    # the reference compute the same numbers
    "danube-smoke": {
        "name": "danube-smoke", "family": "dense", "n_layers": 2,
        "d_model": 64, "n_heads": 4, "n_kv_heads": 2, "head_dim": 16,
        "d_ff": 128, "vocab_size": 277, "pattern": ["ad"],
        "sliding_window": 16, "tie_embeddings": False,
        "pad_vocab_multiple": 8, "max_seq_len": 64, "dtype": "float32"},
    "jamba-smoke": {
        "name": "jamba-smoke", "family": "hybrid", "n_layers": 8,
        "d_model": 64, "n_heads": 4, "n_kv_heads": 2, "head_dim": 16,
        "d_ff": 128, "vocab_size": 277,
        "pattern": ["md", "me", "md", "me", "ad", "me", "md", "me"],
        "n_experts": 4, "top_k": 2, "moe_d_ff": 32, "tie_embeddings": False,
        "pad_vocab_multiple": 8, "max_seq_len": 64, "dtype": "float32"},
}

SMOKE_TRAFFIC = {
    # prompts on both sides of danube-smoke's window of 16
    "smoke-mix": {"loop": "closed", "clients": 3,
                  "prompt_len": {"dist": "loguniform", "lo": 4, "hi": 24},
                  "new_tokens": {"dist": "uniform", "lo": 3, "hi": 6},
                  "strata": 4, "warm_steps": 3, "warm_prompts": [24]},
    "smoke-one": {"loop": "closed", "clients": 1,
                  "prompt_len": {"dist": "fixed", "value": 5},
                  "new_tokens": {"dist": "fixed", "value": 3},
                  "strata": 1, "warm_steps": 0, "warm_prompts": []},
}

SMOKE_CELLS = {
    # name: (configuration, mix, mode, serving fields, compared number),
    # comparing what the full-size cell of the same model compares
    "d.quant": ("danube-smoke", "smoke-mix", "quant", {}, "logit_gap_max"),
    "j.quant": ("jamba-smoke", "smoke-mix", "quant", {"prompt_bucket": 1},
                "logit_gap_mean"),
    "j.pim": ("jamba-smoke", "smoke-one", "pim_sim", {"prompt_bucket": 1},
              "logit_gap_mean"),
}


def write_root(path, limit: float = 1e-3):
    """A benchmark root at ``path``: the real metric readers and
    references, the smoke configurations, mixes and cells, and a
    ``BENCHMARK.json`` naming them with the real metrics."""
    bench = os.path.join(path, "bench")
    for d in ("configs", "traffic", "cells"):
        os.makedirs(os.path.join(bench, d), exist_ok=True)
    for d in ("metrics", "reference"):
        shutil.copytree(os.path.join(ROOT, "bench", d),
                        os.path.join(bench, d), dirs_exist_ok=True,
                        ignore=shutil.ignore_patterns("__pycache__"))
    for name, model in SMOKE_MODELS.items():
        with open(os.path.join(bench, "configs", f"{name}.json"), "w") as f:
            json.dump({"name": name, "model": model}, f)
    for name, mix in SMOKE_TRAFFIC.items():
        with open(os.path.join(bench, "traffic", f"{name}.json"), "w") as f:
            json.dump(mix, f)
    for name, (_, _, mode, extra, stat) in SMOKE_CELLS.items():
        with open(os.path.join(bench, "cells", f"{name}.json"), "w") as f:
            json.dump({"mode": mode,
                       "serving": {"max_batch": 2, "paged": True, **extra},
                       "trace_seconds": 0.5,
                       "check": {"sample": 3,
                                 "limits": {stat: limit}}}, f)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        real = json.load(f)
    strip = [{k: v for k, v in e.items() if k != "workloads"}
             for e in real["end_to_end"]]
    layer = [{k: v for k, v in e.items() if k != "workloads"}
             for e in real["per_layer"]]
    bench_json = {
        "command": real["command"], "paths": ["bench"], "run_seconds": 1,
        "configs": [{"name": n, "source": "test",
                     "file": f"bench/configs/{n}.json", "reduced": [],
                     "why": "test"} for n in SMOKE_MODELS],
        "workloads": [{"name": n, "config": c, "traffic": t, "chips": 1,
                       "why": "test"}
                      for n, (c, t, _, _, _) in SMOKE_CELLS.items()],
        "end_to_end": strip, "per_layer": layer}
    with open(os.path.join(path, "BENCHMARK.json"), "w") as f:
        json.dump(bench_json, f)
    return path


@pytest.fixture(scope="session")
def smoke_root(tmp_path_factory):
    return write_root(str(tmp_path_factory.mktemp("bench_root")))
