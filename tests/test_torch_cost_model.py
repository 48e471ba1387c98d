"""The port's ``pim.cost_model`` against the reference's: the reference's
cases (monotonicity, partition scaling, per-design control bits, device
overrides, geometry and chunk pricing, registry-priced serial multipliers),
and every field of ``gemm_cost`` and ``mult_cost`` equal to the
reference's over a grid of models, widths, geometries and chunkings.

The one field that differs is the comparison point: the reference prices
a TPU (``tpu_time_s``), the port one H100 (``gpu_time_s``), so the parity
check leaves those two out and holds the port's to the H100's bf16
roofline."""
import dataclasses

import pytest

from repro.pim import cost_model as R
from repro_torch.pim import cost_model as T
from repro_torch.pim.cost_model import PimDeviceParams, gemm_cost, mult_cost

PARTITIONED = ("unlimited", "standard", "minimal")
MODELS = ("minimal", "standard", "unlimited", "serial_fast", "compressor42",
          "baseline")


# --------------------------------------------------------------------------
# parity with the reference
# --------------------------------------------------------------------------

@pytest.mark.parametrize("model", MODELS)
def test_costs_equal_reference(model):
    for n_bits in (4, 8):
        for n_cols in (1024, 2048):
            assert mult_cost(n_bits, model, n_cols) == \
                R.mult_cost(n_bits, model, n_cols)
            for chunk in (None, 5):
                for m, k, n in ((4, 12, 8), (2, 40, 1024)):
                    got = dataclasses.asdict(gemm_cost(
                        m, k, n, n_bits, model, n_cols=n_cols, chunk=chunk))
                    want = dataclasses.asdict(R.gemm_cost(
                        m, k, n, n_bits, model, n_cols=n_cols, chunk=chunk))
                    got.pop("gpu_time_s")
                    want.pop("tpu_time_s")
                    assert got == want, (n_bits, n_cols, chunk, m, k, n)


def test_comparison_point_is_the_h100_roofline():
    fields = {f.name for f in dataclasses.fields(T.GemmCost)}
    assert "gpu_time_s" in fields and "tpu_time_s" not in fields
    ref = {f.name for f in dataclasses.fields(R.GemmCost)}
    assert fields - {"gpu_time_s"} == ref - {"tpu_time_s"}
    m, k, n = 2, 1024, 2816
    c = gemm_cost(m, k, n, 8, "minimal")
    assert c.gpu_time_s == max(2.0 * m * k * n / T.GPU_PEAK_FLOPS,
                               (m * k + k * n + m * n) * 2 / T.GPU_HBM_BW)
    # bytes-bound at decode widths: 5.78 MB of bf16 operands over 3.35 TB/s
    assert c.gpu_time_s == pytest.approx(1.7261e-6, rel=1e-4)


# --------------------------------------------------------------------------
# monotonicity
# --------------------------------------------------------------------------

@pytest.mark.parametrize("model",
                         ["baseline", "minimal", "serial_fast",
                          "compressor42"])
def test_mult_cost_monotonic_in_bits(model):
    c8 = mult_cost(8, model)
    c16 = mult_cost(16, model)
    c32 = mult_cost(32, model)
    assert c8["cycles"] < c16["cycles"] < c32["cycles"]
    assert c8["gates"] < c16["gates"] < c32["gates"]


@pytest.mark.parametrize("model", PARTITIONED)
def test_gemm_cost_monotonic_in_terms(model):
    times = [gemm_cost(4, k, 8, 8, model).time_s for k in (8, 16, 32)]
    assert times[0] < times[1] < times[2]


def test_gemm_cost_monotonic_in_bits():
    t8 = gemm_cost(4, 16, 8, 8, "minimal").time_s
    t16 = gemm_cost(4, 16, 8, 16, "minimal").time_s
    assert t8 < t16


# --------------------------------------------------------------------------
# partition-count / crossbar scaling
# --------------------------------------------------------------------------

def test_crossbar_count_scales_with_output_rows():
    """One output element per crossbar row: m*n rows -> ceil over n_rows."""
    dev = PimDeviceParams()
    c1 = gemm_cost(256, 16, 4, 8, "minimal", dev)
    assert c1.crossbars == 1
    c2 = gemm_cost(2048, 16, 1024, 8, "minimal", dev)
    assert c2.crossbars == 2048
    c3 = gemm_cost(4096, 16, 1024, 8, "minimal", dev)
    assert c3.crossbars == 2 * c2.crossbars


def test_waves_when_chip_is_smaller_than_the_gemm():
    dev = PimDeviceParams(crossbars=4)
    c = gemm_cost(8 * 1024, 16, 1, 8, "minimal", dev)  # needs 8 crossbars
    assert c.waves == 2 and c.crossbars == 4
    big = gemm_cost(8 * 1024, 16, 1, 8, "minimal", PimDeviceParams())
    assert c.time_s == pytest.approx(2 * big.time_s)


# --------------------------------------------------------------------------
# control bits per partition design (paper section 5.2)
# --------------------------------------------------------------------------

def test_control_bits_per_design():
    want = {"baseline": 30, "unlimited": 607, "standard": 79, "minimal": 36}
    for model, bits in want.items():
        assert mult_cost(32, model)["msg_bits"] == bits
    g = {m: gemm_cost(4, 16, 8, 8, m).control_bits
         for m in ("unlimited", "standard", "minimal")}
    assert g["minimal"] < g["standard"] < g["unlimited"]


# --------------------------------------------------------------------------
# device-parameter overrides
# --------------------------------------------------------------------------

def test_cycle_time_override_scales_time():
    slow = gemm_cost(4, 16, 8, 8, "minimal", PimDeviceParams(cycle_ns=20.0))
    base = gemm_cost(4, 16, 8, 8, "minimal", PimDeviceParams(cycle_ns=10.0))
    assert slow.time_s == pytest.approx(2 * base.time_s)
    assert slow.energy_j == base.energy_j   # energy is cycle-time-free


def test_gate_energy_override_scales_energy():
    hot = gemm_cost(4, 16, 8, 8, "minimal",
                    PimDeviceParams(gate_energy_pj=1.0))
    base = gemm_cost(4, 16, 8, 8, "minimal",
                     PimDeviceParams(gate_energy_pj=0.1))
    assert hot.energy_j == pytest.approx(10 * base.energy_j)
    assert hot.time_s == base.time_s


def test_device_n_cols_sets_default_geometry():
    wide = gemm_cost(4, 16, 8, 8, "minimal", PimDeviceParams(n_cols=2048))
    assert wide.n_cols == 2048
    override = gemm_cost(4, 16, 8, 8, "minimal", n_cols=4096)
    assert override.n_cols == 4096


# --------------------------------------------------------------------------
# geometry + chunk pricing (the autotuner's search axes)
# --------------------------------------------------------------------------

def test_chunk_none_collapses_to_legacy_pricing():
    legacy = gemm_cost(4, 64, 8, 8, "minimal")
    explicit = gemm_cost(4, 64, 8, 8, "minimal", n_cols=1024, chunk=None)
    assert dataclasses.asdict(explicit) == dataclasses.asdict(legacy)


def test_chunking_pays_per_chunk_fixed_cost():
    one = gemm_cost(4, 64, 8, 8, "minimal", n_cols=1024, chunk=64)
    two = gemm_cost(4, 64, 8, 8, "minimal", n_cols=1024, chunk=32)
    assert two.chunks == 2 and one.chunks == 1
    assert two.cycles_per_wave > one.cycles_per_wave


def test_wider_geometry_beats_chunked_narrow_at_k96():
    """max_dot_terms(8, 1024) < 96 <= max_dot_terms(8, 2048): one wide
    program vs three narrow chunks."""
    from repro_torch.pim.matmul import max_dot_terms

    narrow_chunk = max_dot_terms(8, 1024)
    assert narrow_chunk < 96 <= max_dot_terms(8, 2048)
    narrow = gemm_cost(4, 96, 8, 8, "minimal", n_cols=1024,
                       chunk=narrow_chunk)
    wide = gemm_cost(4, 96, 8, 8, "minimal", n_cols=2048, chunk=96)
    assert narrow.chunks == 3 and wide.chunks == 1
    assert wide.cycles_per_wave < narrow.cycles_per_wave


# --------------------------------------------------------------------------
# serial multiplier algorithms price through the engine registry
# --------------------------------------------------------------------------

def test_new_serial_models_priced_and_faster_than_nor_baseline():
    base = mult_cost(32, "baseline")
    for name in ("serial_fast", "compressor42"):
        c = mult_cost(32, name)
        assert c["cycles"] < base["cycles"], name
        assert c["msg_bits"] == base["msg_bits"] == 30


def test_serial_algorithms_still_lose_to_partitioned_gemm():
    t_part = gemm_cost(4, 16, 8, 8, "minimal").time_s
    for name in ("baseline", "serial_fast", "compressor42"):
        assert gemm_cost(4, 16, 8, 8, name).time_s > t_part, name


def test_unknown_model_raises():
    with pytest.raises(Exception):
        gemm_cost(4, 16, 8, 8, "not-a-model")
