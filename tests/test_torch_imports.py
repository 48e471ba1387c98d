"""The port stands alone: no jax, nothing of ``repro``; explicit devices."""
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.join(os.path.dirname(__file__), "..")

_PROBE = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None          # any `import jax` now raises ImportError
sys.path[:0] = [{src!r}, {root!r}]
import repro_torch
names = ["repro_torch"] + [m.name for m in pkgutil.walk_packages(
    repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke                  # its top-level imports
bad = sorted(m for m in sys.modules
             if m == "repro" or m.startswith("repro.")
             or (m.startswith("jax") and sys.modules[m] is not None))
missing = sorted({{"repro_torch.pim.cost_model", "repro_torch.pim.autotune",
                  "repro_torch.optim.adamw", "repro_torch.data.pipeline",
                  "repro_torch.checkpoint.checkpoint",
                  "repro_torch.runtime.fault_tolerance",
                  "repro_torch.launch.train",
                  "repro_torch.kernels.crossbar_exec.ref",
                  "repro_torch.configs.gemma_7b",
                  "repro_torch.configs.granite_20b",
                  "repro_torch.configs.h2o_danube_1_8b",
                  "repro_torch.models.moe",
                  "repro_torch.configs.granite_moe_1b_a400m",
                  "repro_torch.configs.arctic_480b",
                  "repro_torch.models.ssm", "repro_torch.models.xlstm",
                  "repro_torch.configs.jamba_v0_1_52b",
                  "repro_torch.configs.xlstm_1_3b",
                  "repro_torch.configs.seamless_m4t_medium",
                  "repro_torch.configs.llama_3_2_vision_11b",
                  "repro_torch.dist.context",
                  "repro_torch.dist.partitioning",
                  "repro_torch.kernels.quant_matmul.tp",
                  "repro_torch.launch.mesh",
                  "repro_torch.dist.zero",
                  "repro_torch.serving.router",
                  "repro_torch.launch.dryrun",
                  "repro_torch.launch.roofline"}}
                 - set(names))
print(len(names), bad, missing)
"""


def test_port_imports_without_jax_or_reference():
    code = _PROBE.format(src=os.path.abspath(os.path.join(ROOT, "src")),
                         root=os.path.abspath(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    n, bad, missing = out.stdout.strip().split(" ", 2)
    assert int(n) >= 38            # every module of the port was imported
    assert bad == "[]"
    assert missing == "[]"         # the trainer, the configs and the
    #                                dry-run and roofline tools among them


def test_device_rule_is_explicit():
    from repro_torch.device import resolve_device

    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
    else:
        # no quiet fallback: the default device is CUDA, and without a
        # card asking for it raises
        with pytest.raises(RuntimeError, match="device='cpu'"):
            resolve_device()
        with pytest.raises(RuntimeError):
            resolve_device("cuda")
    with pytest.raises(ValueError):
        resolve_device("meta")


def test_chip_smoke_refuses_without_a_card(tmp_path):
    """Run alone (no repo beside it) or without CUDA, the chip smoke test
    exits non-zero and prints no result line."""
    import shutil

    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    env = dict(os.environ, PYTHONPATH="")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120,
                         env=env)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
