"""The crossbar executor: the port's plain per-gate version (what the CUDA
kernel is held against on the card) and the bit-packed state helpers,
bit-identical to ``repro.pim.executor`` and ``engine._numpy_interpret``.
The reference's Pallas crossbar kernel does not run on this jax (it calls
the removed ``pl.load``), so it is not an oracle here."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.pim import engine as r_engine
from repro.pim import executor as r_ex
from repro.pim.matmul import build_dot as r_build_dot
from repro_torch.kernels.crossbar_exec import (check_microcode,
                                               crossbar_exec,
                                               crossbar_exec_ref)
from repro_torch.pim import executor as ex


def _i32(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32).copy())


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def _random_case(seed, c, n, w, g):
    rng = np.random.default_rng(seed)
    state = rng.integers(0, 2 ** 32, (c, n, w), dtype=np.uint64
                         ).astype(np.uint32)
    mc = np.stack([rng.integers(0, 6, g), rng.integers(0, n, g),
                   rng.integers(0, n, g), rng.integers(0, n, g)], 1
                  ).astype(np.int32)
    return state, mc


@pytest.mark.parametrize("c,n,w,g", [(3, 64, 8, 3000), (2, 1024, 8, 1500),
                                     (1, 17, 3, 400)])
def test_plain_matches_reference_on_random_microcode(c, n, w, g):
    state, mc = _random_case(c * n + g, c, n, w, g)
    assert set(np.unique(mc[:, 0])) == set(range(6))   # all six codes
    want = np.asarray(r_ex.execute(jnp.asarray(state), jnp.asarray(mc)))
    np.testing.assert_array_equal(r_engine._numpy_interpret(state, mc), want)
    got = crossbar_exec(_i32(state), torch.from_numpy(mc))
    np.testing.assert_array_equal(_u32(got), want)
    np.testing.assert_array_equal(
        _u32(crossbar_exec_ref(_i32(state), torch.from_numpy(mc))), want)


def test_plain_matches_reference_on_a_real_dot_program():
    dot = r_build_dot(6, 8)
    mc = dot.program.to_microcode()
    rng = np.random.default_rng(3)
    state = rng.integers(0, 2 ** 32, (2, dot.program.cfg.n, 8),
                         dtype=np.uint64).astype(np.uint32)
    want = r_engine._numpy_interpret(state, mc)
    got = ex.execute(_i32(state), mc)
    np.testing.assert_array_equal(_u32(got), want)


def test_pack_unpack_match_reference():
    rng = np.random.default_rng(0)
    bits = rng.integers(0, 2, (3, 5, 70)).astype(bool)
    want = r_ex.pack_rows(bits)
    got = ex.pack_rows(torch.from_numpy(bits))
    np.testing.assert_array_equal(_u32(got), want)
    np.testing.assert_array_equal(ex.unpack_rows(got, 70).numpy(),
                                  r_ex.unpack_rows(want, 70))


def test_write_read_numbers_match_reference():
    rng = np.random.default_rng(1)
    vals = rng.integers(0, 256, (2, 70)).astype(np.uint64)
    cols = (3, 9, 4, 20, 21, 22, 30, 31)
    want = np.asarray(r_ex.write_numbers(r_ex.blank_state(2, 40, 70), cols,
                                         vals))
    st = ex.write_numbers(ex.blank_state(2, 40, 70, device="cpu"), cols,
                          torch.from_numpy(vals.astype(np.int64)))
    np.testing.assert_array_equal(_u32(st), want)
    np.testing.assert_array_equal(
        ex.read_numbers(st, cols, 70).numpy(),
        r_ex.read_numbers(jnp.asarray(want), cols, 70).astype(np.int64))
    # K terms at once: values (C, rows, K) onto K column tuples
    terms = ((0, 1), (5, 6), (7, 8))
    v3 = rng.integers(0, 4, (2, 70, 3))
    st3 = ex.write_numbers(ex.blank_state(2, 40, 70, device="cpu"), terms,
                           torch.from_numpy(v3))
    for i, c in enumerate(terms):
        np.testing.assert_array_equal(ex.read_numbers(st3, c, 70).numpy(),
                                      v3[:, :, i])


def test_microcode_is_validated():
    st = torch.zeros((1, 8, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="column"):
        crossbar_exec(st, torch.tensor([[2, 0, 8, 1]], dtype=torch.int32))
    with pytest.raises(ValueError, match="code"):
        crossbar_exec(st, torch.tensor([[6, 0, 1, 1]], dtype=torch.int32))
    with pytest.raises(ValueError):
        check_microcode(torch.zeros((3, 3), dtype=torch.int32), 8)
    with pytest.raises(TypeError):
        crossbar_exec(st.to(torch.int64), torch.zeros((1, 4),
                                                      dtype=torch.int32))


def test_cpu_wrapper_runs_the_plain_version_without_counting():
    state, mc = _random_case(5, 2, 16, 2, 50)
    before = crossbar_exec.launches
    crossbar_exec(_i32(state), torch.from_numpy(mc))
    assert crossbar_exec.launches == before
