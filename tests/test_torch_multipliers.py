"""The port's serial multipliers and lower bounds against ``repro``: each
builder's microcode and I/O columns equal the reference's row for row, the
products are exact on the port's plain executors (a 32-bit product with
bit 63 set included), the paper's bounds agree, and the paper's §5 cycle,
control, area and energy properties hold on the port's programs."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import bounds as r_bounds
from repro.core.operation import PartitionConfig as RPartitionConfig
from repro.pim import engine as r_engine
from repro.pim.compressor42 import build_compressor42_multiplier as r_c42
from repro.pim.mult_serial import build_serial_multiplier as r_serial
from repro.pim.mult_serial_fast import build_fast_serial_multiplier as r_fast
from repro_torch.core import bounds
from repro_torch.core.operation import PartitionConfig
from repro_torch.pim import engine
from repro_torch.pim import executor as ex
from repro_torch.pim.compressor42 import build_compressor42_multiplier
from repro_torch.pim.mult_serial import build_serial_multiplier
from repro_torch.pim.mult_serial_fast import build_fast_serial_multiplier
from repro_torch.pim.multpim import build_multpim

MODELS = ("unlimited", "standard", "minimal")
BUILDERS = {"serial": (build_serial_multiplier, r_serial),
            "serial_fast": (build_fast_serial_multiplier, r_fast),
            "compressor42": (build_compressor42_multiplier, r_c42)}


@pytest.mark.parametrize("n", [2, 3, 4, 5, 8, 16, 32])
@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_microcode_equals_reference(name, n):
    port, ref = BUILDERS[name]
    m, r = port(n), ref(n)
    np.testing.assert_array_equal(m.program.to_microcode(),
                                  r.program.to_microcode())
    assert (m.a_cols, m.b_cols, m.result_cols, m.n_bits) == \
        (r.a_cols, r.b_cols, r.result_cols, r.n_bits)
    assert m.program.name == r.program.name
    assert (dataclasses.asdict(m.program.stats())
            == dataclasses.asdict(r.program.stats()))
    # the registry builds the same program
    built = engine.build_multiplier(name, n)
    np.testing.assert_array_equal(built.program.to_microcode(),
                                  m.program.to_microcode())
    assert r_engine.backend_kind(name) == engine.backend_kind(name) == "mult"


def _check(mult, backend=None, rows=64, crossbars=2, seed=0):
    """Random operands plus the reference's four edge pairs (0 x 0,
    max x max — bit 2n - 1 set — and 1 x max both ways); products read
    through a uint64 view."""
    n = mult.n_bits
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 1 << n, size=(crossbars, rows), dtype=np.uint64)
    b = rng.integers(0, 1 << n, size=(crossbars, rows), dtype=np.uint64)
    a[0, :4] = [0, (1 << n) - 1, 1, (1 << n) - 1]
    b[0, :4] = [0, (1 << n) - 1, (1 << n) - 1, 1]
    state = ex.blank_state(crossbars, mult.program.cfg.n, rows, device="cpu")
    ex.write_numbers(state, mult.a_cols, torch.from_numpy(a.view(np.int64)))
    ex.write_numbers(state, mult.b_cols, torch.from_numpy(b.view(np.int64)))
    mc = mult.program.to_microcode()
    if backend is None:
        state = ex.execute(state, torch.from_numpy(mc))
    else:
        state = engine.execute_state(state, mc, backend=backend)
    got = ex.read_numbers(state, mult.result_cols, rows)
    assert got.dtype == torch.int64
    got = got.numpy().view(np.uint64)
    np.testing.assert_array_equal(got.astype(object),
                                  a.astype(object) * b.astype(object))
    return got


@pytest.mark.parametrize("n", [8, 16, 32])
@pytest.mark.parametrize("name", sorted(BUILDERS) + ["multpim"])
def test_products_exact(name, n):
    """On the kernel's grouped plain version (the CPU route of
    ``executor.execute``)."""
    m = (build_multpim(n, model="minimal") if name == "multpim"
         else engine.build_multiplier(name, n))
    m.program.validate()
    got = _check(m)
    if n == 32:
        # (2**32 - 1)**2 has bit 63 set: the int64 container reads it
        # negative, the uint64 view exactly
        assert got[0, 1] == np.uint64((2 ** 32 - 1) ** 2)
        assert got[0, 1] >> np.uint64(63) == 1


@pytest.mark.parametrize("backend", ["scan", "numpy", "unrolled"])
@pytest.mark.parametrize("name", ["serial_fast", "compressor42"])
def test_products_exact_on_every_state_backend(name, backend):
    _check(engine.build_multiplier(name, 8), backend=backend, rows=32)


@pytest.mark.parametrize("n", [2, 3, 5])
@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_small_widths_exact(name, n):
    _check(BUILDERS[name][0](n), rows=32)


@pytest.mark.parametrize("name", ["serial_fast", "compressor42"])
def test_exhaustive_4bit(name):
    m = BUILDERS[name][0](4)
    a, b = np.meshgrid(np.arange(16), np.arange(16))
    a, b = a.reshape(1, -1), b.reshape(1, -1)
    state = ex.blank_state(1, m.program.cfg.n, a.shape[1], device="cpu")
    ex.write_numbers(state, m.a_cols, torch.from_numpy(a))
    ex.write_numbers(state, m.b_cols, torch.from_numpy(b))
    state = ex.execute(state, torch.from_numpy(m.program.to_microcode()))
    got = ex.read_numbers(state, m.result_cols, a.shape[1])
    np.testing.assert_array_equal(got.numpy(), a * b)


@pytest.mark.parametrize("n,k", [(1024, 32), (256, 8), (512, 16), (64, 4)])
def test_bounds_equal_reference(n, k):
    cfg, rcfg = PartitionConfig(n, k), RPartitionConfig(n, k)
    assert bounds.count_serial(n) == r_bounds.count_serial(n)
    assert bounds.count_parallel(n, k) == r_bounds.count_parallel(n, k)
    for fn in ("unlimited_lower_bound", "standard_lower_bound",
               "minimal_lower_bound"):
        assert getattr(bounds, fn)(cfg) == getattr(r_bounds, fn)(rcfg), fn


def test_bounds_match_the_paper():
    """Paper values at (n=1024, k=32): unlimited over 2**443 operations
    (444 bits), standard >= 46, minimal >= 25; each below the implemented
    message length."""
    from repro_torch.core.control import message_bits

    cfg = PartitionConfig(1024, 32)
    assert bounds.unlimited_lower_bound(cfg) == 444
    assert bounds.standard_lower_bound(cfg) == 46
    assert bounds.minimal_lower_bound(cfg) == 25
    for model in MODELS:
        lb = getattr(bounds, f"{model}_lower_bound")(cfg)
        assert lb <= message_bits(model, cfg)


def test_new_serial_multipliers_beat_nor_baseline_cycles():
    base = build_serial_multiplier(32).program.stats().cycles
    for name in ("serial_fast", "compressor42"):
        c = BUILDERS[name][0](32).program.stats().cycles
        assert c < base, (name, c, base)


def test_paper_speedups_32bit():
    """§5.1: partitions keep ~9x of the serial latency at 32 bits."""
    serial = build_serial_multiplier(32).program.stats().cycles
    cycles = {m: build_multpim(32, model=m).program.stats().cycles
              for m in MODELS}
    for m in MODELS:
        assert 7.0 <= serial / cycles[m] <= 13.0, (m, serial / cycles[m])
    assert cycles["unlimited"] <= cycles["standard"] <= cycles["minimal"]
    assert cycles["minimal"] / cycles["unlimited"] <= 1.35


def test_paper_control_overheads_32bit():
    """§5.2: per-message control = 607/79/36 vs 30 baseline bits."""
    serial = build_serial_multiplier(32).program.stats()
    assert serial.control_bits_per_message == 30
    want = {"unlimited": 607, "standard": 79, "minimal": 36}
    for m, nbits in want.items():
        st = build_multpim(32, model=m).program.stats()
        assert st.control_bits_per_message == nbits
    minimal = build_multpim(32, model="minimal").program.stats()
    assert minimal.total_control_bits < serial.total_control_bits


def test_area_and_energy_overheads():
    """§5.3/§5.4: parallel costs more memristors and more gate switches."""
    s = build_serial_multiplier(32).program.stats()
    p = build_multpim(32, model="minimal").program.stats()
    assert s.area_columns < p.area_columns < 3.5 * s.area_columns
    assert s.energy_gates < p.energy_gates < 3.5 * s.energy_gates


def test_serial_messages_roundtrip():
    build_serial_multiplier(16).program.check_messages(sample_every=17)
