"""Test-suite bootstrap.

Runs before any test module, and therefore before jax initializes: forces a
deterministic 8-device CPU topology so the ``repro.dist`` mesh paths are
exercised everywhere (a mesh-free run would silently no-op every sharding
constraint).  ``launch/dryrun.py`` detects the override and keeps it instead
of forcing its standalone 512-device topology.
"""
import importlib.util
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro.xla_flags import ensure_host_device_count  # noqa: E402

ensure_host_device_count(8)
os.environ.setdefault("JAX_PLATFORMS", "cpu")

# Property-based tests prefer the real hypothesis; fall back to the bundled
# deterministic shim when it is not installed (see tests/_compat).
if importlib.util.find_spec("hypothesis") is None:
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "_compat"))

import pytest  # noqa: E402

# CI's tier-1 matrix pins PIM_TEST_MODE to one engine mode per job
# (.github/workflows/ci.yml) so a backend regression pinpoints its mode;
# locally (unset) the mode-sensitive suites parametrize over every mode.
# Comma lists work too: PIM_TEST_MODE=quant,quant_tp.
_ALL_PIM_MODES = ["xla", "quant", "quant_tp", "pim_sim"]
PIM_TEST_MODES = [m for m in
                  os.environ.get("PIM_TEST_MODE", "").replace(" ", "")
                  .split(",") if m] or _ALL_PIM_MODES


def pytest_generate_tests(metafunc):
    # any test taking a ``pim_test_mode`` argument fans out over the
    # selected engine modes (tests/test_pim_modes.py is the main consumer)
    if "pim_test_mode" in metafunc.fixturenames:
        metafunc.parametrize("pim_test_mode", PIM_TEST_MODES)


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: long-running (hypothesis-heavy) tests; deselect with "
        "-m 'not slow'")
    config.addinivalue_line(
        "markers", "card: needs a CUDA device; skipped without one")


@pytest.fixture(scope="session")
def small_model_config():
    """The smallest dense decoder config that exercises the full stack
    (GQA attention, SwiGLU MLP, scan-over-superblocks, tied embeddings)."""
    import repro.configs as configs

    return configs.get("qwen1.5-0.5b").smoke()
