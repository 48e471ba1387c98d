"""Nothing a run loads is JAX or the JAX package, compared by whole
top-level names (``repro_torch`` begins with ``repro``, so a prefix match
would be wrong), and no module of the references loads anything of the
program."""
import json
import os
import subprocess
import sys
import textwrap

import pytest

from bench.conftest import write_root

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
#: every module of the plain references, a configuration's own included
REFERENCE_MODULES = sorted(
    f[:-3] for f in os.listdir(os.path.join(ROOT, "bench", "reference"))
    if f.endswith(".py") and f != "__init__.py")

BLOCK = textwrap.dedent("""
    import importlib.abc, json, sys
    class Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path, target=None):
            if name.split(".")[0] in ("jax", "jaxlib", "flax"):
                raise ImportError("blocked: " + name)
    sys.meta_path.insert(0, Block())
    sys.path[:0] = [{src!r}, {root!r}]
""")


def _top_levels(body: str):
    code = BLOCK.format(src=os.path.join(ROOT, "src"), root=ROOT) + body
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT,
                         env={**os.environ, "PYTHONPATH": ""})
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax(tmp_path):
    root = write_root(str(tmp_path))
    tops = _top_levels(textwrap.dedent(f"""
        import contextlib, io
        from pathlib import Path
        from bench.harness import main
        from bench.harness.spec import load_cell
        for w in {json.dumps([w["name"] for w in json.load(open(
            os.path.join(ROOT, "BENCHMARK.json")))["workloads"]])}:
            load_cell(w)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = main.main(["--workload", "d.quant", "--seed", "5",
                            "--seconds", "0.5", "--trace", "1"],
                           root=Path({root!r}), device="cpu")
        assert rc == 0, rc
        assert not main.forbidden_modules()
        print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
    """))
    assert "repro_torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "repro"}


@pytest.mark.parametrize("module", REFERENCE_MODULES)
def test_the_reference_loads_nothing_of_the_program(module):
    tops = _top_levels(textwrap.dedent(f"""
        import bench.reference.{module}
        print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
    """))
    assert "bench" in tops
    assert not tops & {"jax", "jaxlib", "flax", "repro", "repro_torch"}


def test_forbidden_names_are_whole_top_levels(monkeypatch):
    from bench.harness import main

    monkeypatch.setitem(sys.modules, "repro_torch_like", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping", sys)
    assert "repro_torch_like" not in main.forbidden_modules()
    assert "jaxtyping" not in main.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.fake", sys)
    assert "repro.fake" in main.forbidden_modules()
