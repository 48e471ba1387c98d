"""The port's engine backend registry and session namespaces against
``repro``: the registered names and kinds, wrong-kind errors, every state
backend on the reference's results, the executor's bit I/O, the one-shot
``execute`` and ``pim_matmul_int``, and the ``"draft"`` namespace that
keeps a drafting pass from evicting verify state.

The reference's own ``"pallas"`` backend fails on this jax version, so
the port is held against the reference's ``"scan"`` and ``"numpy"``."""
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.crossbar_exec import ops as r_ops
from repro.pim import engine as r_engine
from repro.pim import executor as r_ex
from repro.pim import matmul as r_matmul
from repro_torch.kernels.crossbar_exec import ops
from repro_torch.pim import engine
from repro_torch.pim import executor as ex
from repro_torch.pim import matmul as t_matmul

STATE_BACKENDS = ("scan", "jnp", "unrolled", "numpy")


def _random_program(seed, g=400, n=48, c=3, w=2):
    rng = np.random.default_rng(seed)
    state = rng.integers(0, 2 ** 32, (c, n, w), dtype=np.uint64
                         ).astype(np.uint32)
    mc = np.stack([rng.integers(0, 6, g), rng.integers(0, n, g),
                   rng.integers(0, n, g), rng.integers(0, n, g)],
                  axis=1).astype(np.int32)
    return state, mc


def _port_state(state):
    return torch.from_numpy(state.view(np.int32).copy())


def test_backend_names_and_kinds():
    """The reference registers pallas (its TPU kernel); the port registers
    cuda (its CUDA kernel) instead, and the tensor-parallel linear
    ``quant_tp`` as the reference does, of kind ``"linear"``.  Every shared
    name has the reference's kind."""
    ported = set(engine.backends())
    ref = set(r_engine.backends())
    assert ported == (ref - {"pallas"}) | {"cuda"}
    assert ported == {"cuda", "scan", "jnp", "unrolled", "numpy", "serial",
                      "serial_fast", "compressor42", "quant_tp"}
    assert engine.backend_kind("quant_tp") == "linear"
    for name in ported - {"cuda"}:
        assert engine.backend_kind(name) == r_engine.backend_kind(name), name
    assert engine.backend_kind("cuda") == r_engine.backend_kind("pallas")
    assert engine.BACKEND_KINDS == r_engine.BACKEND_KINDS


def test_wrong_kind_errors():
    """Kinds partition the registry: state executors and multiplier
    algorithms reject each other by name, as in the reference."""
    built = engine.build_multiplier("serial_fast", 8)
    assert built.n_bits == 8
    with pytest.raises(ValueError, match="not a multiplier algorithm"):
        engine.build_multiplier("scan", 8)
    with pytest.raises(ValueError, match="not a multiplier algorithm"):
        engine.build_multiplier("cuda", 8)
    with pytest.raises(ValueError, match="unknown backend"):
        engine.build_multiplier("does-not-exist", 8)
    with pytest.raises(ValueError, match="unknown backend"):
        engine.get_backend("does-not-exist")
    with pytest.raises(ValueError, match="not a crossbar-state executor"):
        engine.execute_state(None, None, backend="compressor42")
    with pytest.raises(ValueError, match="backend kind must be one of"):
        engine.register_backend("_bad_kind", lambda *a: None, kind="nope")
    engine.register_backend("_test_linear", lambda x, w: x @ w,
                            kind="linear")
    try:
        with pytest.raises(ValueError, match="linear lowering, not a "
                                             "crossbar-state executor"):
            engine.execute_state(None, None, backend="_test_linear")
        with pytest.raises(ValueError, match="not a multiplier algorithm"):
            engine.build_multiplier("_test_linear", 8)
        with pytest.raises(ValueError, match="not a crossbar-state"):
            engine.ExecutionSession(engine.compile_dot(3, 8),
                                    backend="_test_linear")
    finally:
        engine._backends.pop("_test_linear", None)
        engine._backend_kinds.pop("_test_linear", None)


def test_custom_backend_does_not_suppress_defaults():
    engine.register_backend("_test_backend", lambda s, mc, **kw: s)
    try:
        names = engine.backends()
        assert "_test_backend" in names and "scan" in names
        assert engine.get_backend("scan") is not None
        st = torch.zeros((1, 4, 1), dtype=torch.int32)
        assert engine.execute_state(st, np.zeros((0, 4), np.int32),
                                    backend="_test_backend") is st
    finally:
        engine._backends.pop("_test_backend", None)
        engine._backend_kinds.pop("_test_backend", None)


@pytest.mark.parametrize("backend", STATE_BACKENDS)
def test_state_backends_equal_reference(backend):
    state, mc = _random_program(1)
    want = r_engine._numpy_interpret(state, mc)
    np.testing.assert_array_equal(
        np.asarray(r_engine.execute_state(jnp.asarray(state), mc,
                                          backend="scan")), want)
    for microcode in (mc, torch.from_numpy(mc)):
        got = engine.execute_state(_port_state(state), microcode,
                                   backend=backend)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


@pytest.mark.parametrize("backend", ["scan", "unrolled", "numpy"])
def test_run_program_equals_reference(backend):
    state, mc = _random_program(2, g=300, n=40, c=2, w=3)
    want = np.asarray(r_ops.run_program(jnp.asarray(state), mc,
                                        backend=backend))
    got = ops.run_program(_port_state(state), mc, backend=backend)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    # the default is the reference's: the per-gate oracle
    np.testing.assert_array_equal(
        ops.run_program(_port_state(state), mc).numpy().view(np.uint32),
        want)


def test_execute_unrolled_equals_reference():
    state, mc = _random_program(3, g=200, n=32, c=2, w=1)
    want = np.asarray(r_ex.execute_unrolled(jnp.asarray(state), mc))
    st = _port_state(state)
    got = ex.execute_unrolled(st, mc)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    # a new state: the input keeps its bits
    np.testing.assert_array_equal(st.numpy().view(np.uint32), state)


@pytest.mark.parametrize("rows", [1, 31, 32, 70])
def test_write_and_read_bits_equal_reference(rows):
    rng = np.random.default_rng(rows)
    bits = rng.integers(0, 2, (3, rows)).astype(bool)
    r_state = r_ex.write_bits(r_ex.blank_state(3, 9, rows), 4, bits)
    st = ex.write_bits(ex.blank_state(3, 9, rows, device="cpu"), 4,
                       torch.from_numpy(bits))
    np.testing.assert_array_equal(st.numpy().view(np.uint32),
                                  np.asarray(r_state))
    got = ex.read_bits(st, 4, rows)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(),
                                  r_ex.read_bits(r_state, 4, rows))


def test_read_numbers_holds_uint64_bits():
    """A 64-bit value with bit 63 set reads back negative in the port's
    int64 and equal to the reference's uint64 through a view."""
    vals = np.array([[2 ** 64 - 2 ** 33 + 1, 2 ** 63, 5, 2 ** 64 - 1]],
                    dtype=np.uint64)
    cols = tuple(range(64))
    r_state = r_ex.write_numbers(r_ex.blank_state(1, 64, 4), cols, vals)
    want = r_ex.read_numbers(r_state, cols, 4)
    st = ex.write_numbers(ex.blank_state(1, 64, 4, device="cpu"), cols,
                          torch.from_numpy(vals.view(np.int64)))
    np.testing.assert_array_equal(st.numpy().view(np.uint32),
                                  np.asarray(r_state))
    got = ex.read_numbers(st, cols, 4)
    assert got.dtype == torch.int64 and int(got[0, 0]) < 0
    np.testing.assert_array_equal(got.numpy().view(np.uint64), want)


@pytest.mark.parametrize("backend", [None, "scan", "numpy", "unrolled"])
def test_one_shot_execute_equals_reference(backend):
    rng = np.random.default_rng(4)
    art = engine.compile_dot(4, 8)
    r_art = r_engine.compile_dot(4, 8)
    x = rng.integers(0, 256, (3, 4))
    w = rng.integers(0, 256, (5, 4))
    want = r_engine.execute(r_art, x.astype(np.uint64), w.astype(np.uint64),
                            backend="numpy", rows_per_crossbar=16)
    info = engine.cache_info()
    got = engine.execute(art, torch.from_numpy(x), torch.from_numpy(w),
                         backend=backend, rows_per_crossbar=16)
    np.testing.assert_array_equal(got.numpy().view(np.uint64), want)
    after = engine.cache_info()
    # a one-shot state is transient: nothing kept, nothing uploaded
    assert after.resident_entries == info.resident_entries
    assert after.exec_transient == info.exec_transient + 1
    with pytest.raises(ValueError, match="compiled for 4 terms"):
        engine.execute(art, torch.from_numpy(x[:, :3]),
                       torch.from_numpy(w[:, :3]), backend=backend)


@pytest.mark.parametrize("backend", [None, "numpy"])
def test_pim_matmul_int_equals_reference(backend):
    rng = np.random.default_rng(5)
    x = rng.integers(0, 256, (2, 45))
    w = rng.integers(0, 256, (3, 45))
    want = r_matmul.pim_matmul_int(x.astype(np.uint64), w.astype(np.uint64),
                                   backend="numpy")
    got = t_matmul.pim_matmul_int(torch.from_numpy(x), torch.from_numpy(w),
                                  backend=backend)
    np.testing.assert_array_equal(got.numpy().view(np.uint64), want)
    np.testing.assert_array_equal(got.numpy(), x @ w.T)


def test_cuda_backend_raises_on_a_cpu_state():
    """No fallback: the kernel's backend refuses a state off the card."""
    state, mc = _random_program(6, g=10)
    with pytest.raises(ValueError, match="needs a CUDA state"):
        engine.execute_state(_port_state(state), mc, backend="cuda")
    with pytest.raises(ValueError, match="needs a CUDA state"):
        ops.run_program(_port_state(state), mc, backend="cuda")
    x = torch.ones((1, 3), dtype=torch.long)
    with pytest.raises(ValueError, match="needs a CUDA state"):
        engine.matmul_int(x, x, 8, backend="cuda")


def test_draft_ctx_nests_and_is_restored_on_exception():
    assert engine.current_session_ns() == ""
    with engine.draft_ctx() as name:
        assert name is None
        assert engine.current_session_ns() == "draft"
        assert engine.current_mode() == "xla"
        with engine.draft_ctx("quant") as inner:
            assert inner == "quant"
            assert engine.current_mode() == "quant"
            assert engine.current_session_ns() == "draft"
        assert engine.current_mode() == "xla"
        assert engine.current_session_ns() == "draft"
    assert engine.current_session_ns() == ""
    with pytest.raises(RuntimeError):
        with engine.draft_ctx("pim_sim"):
            raise RuntimeError("boom")
    assert engine.current_session_ns() == ""
    assert engine.current_mode() == "xla"
    with pytest.raises(ValueError):
        with engine.draft_ctx("bogus"):
            pass
    assert engine.current_session_ns() == ""


def test_draft_uploads_never_evict_verify_state():
    """Under a byte bound of two states, a drafting pass that uploads five
    weights evicts only its own namespace's states: every verify state
    stays resident and its next call is a hit."""
    rng = np.random.default_rng(8)
    verify_ws = [torch.from_numpy(rng.integers(0, 256, (3, 20)))
                 for _ in range(2)]
    draft_ws = [torch.from_numpy(rng.integers(0, 256, (3, 20)))
                for _ in range(5)]
    x = torch.from_numpy(rng.integers(0, 256, (2, 20)))
    engine.clear_cache()
    one = 1024 * 8 * 4                           # one crossbar's state
    with mock.patch.object(engine, "MAX_RESIDENT_BYTES", 2 * one):
        for w in verify_ws:
            engine.matmul_int(x, w, 8)
        assert engine.cache_info().resident_entries == 2
        with engine.draft_ctx():
            ns = engine.current_session_ns()
            outs = [engine.matmul_int(x, w, 8, session_ns=ns)
                    for w in draft_ws]
        info = engine.cache_info()
        assert info.exec_uploads == 2 + 5
        # two verify states + the draft namespace's last two
        assert info.resident_entries == 4
        assert info.resident_bytes == 4 * one
        verify = engine._sessions[(engine.compile_matmul(20, 8).key, None,
                                   256, "")]
        assert len(verify._states) == 2
        for w in verify_ws:
            engine.matmul_int(x, w, 8)
        info = engine.cache_info()
        assert info.exec_hits == 2 and info.exec_uploads == 7
    for w, y in zip(draft_ws, outs):
        np.testing.assert_array_equal(y.numpy(), x.numpy() @ w.numpy().T)
    engine.clear_cache()


def test_sim_linear_runs_in_the_draft_namespace():
    """Inside ``draft_ctx`` the pim_sim linear uses the draft pool: its
    resident state lives in a "draft" session, and the result keeps its
    bits."""
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.normal(size=(2, 20)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(20, 6)).astype(np.float32))
    engine.clear_cache()
    plain = engine.sim_linear(x, w)
    with engine.draft_ctx():
        drafted = engine.sim_linear(x, w)
    assert torch.equal(plain, drafted)
    spaces = sorted(key[3] for key in engine._sessions)
    assert spaces == ["", "draft"]
    assert engine.cache_info().exec_uploads == 2
    engine.clear_cache()
