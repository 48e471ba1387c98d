"""The crossbar kernel's schedule: microcode grouped into independent gates
(``kernels/crossbar_exec/schedule.py``), and the grouped plain version that
runs it in the kernel's order, bit-identical to the per-gate oracle and to
the reference's executors (``repro.pim.executor.execute`` and
``engine._numpy_interpret``) in every column."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.pim import engine as r_engine
from repro.pim import executor as r_ex
from repro_torch.kernels.crossbar_exec import (crossbar_exec,
                                               crossbar_exec_grouped_ref,
                                               crossbar_exec_ref, plan)
from repro_torch.kernels.crossbar_exec import schedule as S
from repro_torch.pim import engine


def _i32(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32).copy())


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def _reads(code, ia, ib):
    return () if code == 0 else (ia,) if code == 1 else (ia, ib)


def _random_microcode(seed, n, g):
    """All six codes, junk ``ib`` on INIT/NOT and ``ia``/``ib`` on INIT,
    some ``ia == dst`` rows, long RAW chains and duplicate destinations
    (a small ``n`` makes many)."""
    rng = np.random.default_rng(seed)
    mc = np.stack([rng.integers(0, 6, g), rng.integers(0, n, g),
                   rng.integers(0, n, g), rng.integers(0, n, g)], 1)
    self_read = rng.random(g) < 0.1
    mc[self_read, 1] = mc[self_read, 3]
    chain = np.arange(g // 3, g // 3 + 40)            # each reads the last
    mc[chain[1:], 0] = 1
    mc[chain[1:], 1] = mc[chain[:-1], 3]
    return mc.astype(np.int32)


def _random_state(seed, c, n, w):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2 ** 32, (c, n, w), dtype=np.uint64
                        ).astype(np.uint32)


def _check_groups(mc, n, rows, offsets, width):
    """Every row once (plus no-op padding), fixed-width groups, and no gate
    of a group writes a column another gate of it reads or writes (no RAW,
    WAR or WAW inside a group, in either order)."""
    assert rows.dtype == np.int32 and rows.shape[1] == 4
    assert np.array_equal(offsets, np.arange(0, len(rows) + 1, width))
    noop = np.all(rows == (5, n, n, n), axis=1)
    real = rows[~noop]
    assert np.array_equal(real[np.lexsort(real.T[::-1])],
                          mc[np.lexsort(mc.T[::-1])])
    for s, e in zip(offsets[:-1], offsets[1:]):
        gates = rows[s:e][~noop[s:e]].tolist()
        dsts = [g[3] for g in gates]
        assert len(set(dsts)) == len(dsts), "WAW in a group"
        for i, (code, ia, ib, dst) in enumerate(gates):
            others = set(dsts[:i] + dsts[i + 1:])
            assert not others & set(_reads(code, ia, ib)), "RAW/WAR in a group"


RANDOM = [(0, 16, 600), (1, 64, 3000), (2, 1024, 2000), (3, 5, 300),
          (4, 300, 1500)]


@pytest.mark.parametrize("seed,n,g", RANDOM)
def test_schedule_groups_are_independent_and_complete(seed, n, g):
    mc = _random_microcode(seed, n, g)
    assert set(np.unique(mc[:, 0])) == set(range(6))
    rows, offsets = S.schedule(mc, n)
    _check_groups(mc, n, rows, offsets, S.GROUP_WIDTH)


@pytest.mark.parametrize("seed,n,g", RANDOM[:3])
def test_schedule_keeps_program_order_inside_a_group(seed, n, g):
    mc = _random_microcode(seed, n, g)
    _, first = np.unique(mc, axis=0, return_index=True)
    mc = mc[np.sort(first)]                       # distinct rows, in order
    index = {tuple(r): i for i, r in enumerate(mc.tolist())}
    rows, offsets = S.schedule(mc, n)
    for s, e in zip(offsets[:-1], offsets[1:]):
        pos = [index[tuple(r)] for r in rows[s:e].tolist()
               if tuple(r) != (5, n, n, n)]
        assert pos == sorted(pos)


@pytest.mark.parametrize("seed,n,g", RANDOM)
@pytest.mark.parametrize("width", [1, 3, 8])
def test_grouped_plain_matches_reference(seed, n, g, width):
    mc = _random_microcode(seed, n, g)
    state = _random_state(seed + 1, 2, n, 3)
    want = np.asarray(r_ex.execute(jnp.asarray(state), jnp.asarray(mc)))
    np.testing.assert_array_equal(r_engine._numpy_interpret(state, mc), want)
    np.testing.assert_array_equal(
        _u32(crossbar_exec_ref(_i32(state), torch.from_numpy(mc))), want)
    rows, offsets = S.schedule(mc, n, width)
    _check_groups(mc, n, rows, offsets, width)
    got = crossbar_exec_grouped_ref(_i32(state), rows, offsets)
    np.testing.assert_array_equal(_u32(got), want)


@pytest.mark.parametrize("terms", [37, 25])
def test_grouped_plain_matches_reference_on_dot_programs(terms):
    art = engine.compile_dot(terms, 8)
    mc, n = art.microcode, art.n_cols
    assert n == 1024
    np.testing.assert_array_equal(mc, r_engine.compile_dot(terms, 8).microcode)
    rows, offsets = S.schedule(mc, n)
    _check_groups(mc, n, rows, offsets, S.GROUP_WIDTH)
    state = _random_state(terms, 2, n, 2)
    want = r_engine._numpy_interpret(state, mc)
    got = crossbar_exec(_i32(state), art.microcode_on("cpu"))
    np.testing.assert_array_equal(_u32(got), want)


@pytest.mark.parametrize("width", [8, 16, S.GROUP_WIDTH])
def test_schedule_cuts_the_chain_sixfold(width):
    mc = engine.compile_dot(37, 8).microcode
    assert len(mc) == 86_320
    rows, offsets = S.schedule(mc, 1024, width)
    assert len(offsets) - 1 <= len(mc) // 6


def test_width_one_is_program_order_and_empty_microcode_is_empty():
    mc = _random_microcode(7, 32, 200)
    rows, offsets = S.schedule(mc, 32, 1)
    np.testing.assert_array_equal(rows, mc)
    assert len(offsets) == len(mc) + 1
    rows, offsets = S.schedule(np.zeros((0, 4), np.int32), 32)
    assert rows.shape == (0, 4) and list(offsets) == [0]
    st = _i32(_random_state(8, 1, 32, 2))
    assert torch.equal(crossbar_exec(st, torch.zeros((0, 4),
                                                     dtype=torch.int32)), st)


def test_pack_lays_out_the_kernel_records():
    mc = np.array([[0, 7, 9, 1], [1, 2, 11, 3], [2, 1, 3, 4],
                   [3, 4, 0, 5], [4, 5, 1, 6], [5, 6, 2, 0]] * 9, np.int32)
    n, width, warps = 12, S.GROUP_WIDTH, S.KERNEL_WARPS
    k = width // warps
    rows, _ = S.schedule(mc, n)
    rec = S.pack(rows, n)
    assert rec.shape == (len(rows) // width, warps, 2, k)
    assert rec.dtype == np.int32
    fields = S.decode(rows, n)
    u = rec.view(np.uint32)
    for g, w, i in np.ndindex(rec.shape[0], warps, k):
        a, b, d, orm, inv = (int(f[g * width + w * k + i]) for f in fields)
        assert u[g, w, 0, i] == a | b << 16
        assert u[g, w, 1, i] == d | (orm & 1) << 30 | (inv & 1) << 31
    a, b, d, orm, inv = fields
    # INIT reads the zero column twice; NOT reads ia twice, never ib
    init, nots = rows[:, 0] == 0, rows[:, 0] == 1
    assert (a[init] == n).all() and (b[init] == n).all()
    assert (a[nots] == rows[nots, 1]).all() and (b[nots] == a[nots]).all()
    codes = {0: (-1, -1), 1: (-1, -1), 2: (-1, -1), 3: (-1, 0),
             4: (0, -1), 5: (0, 0)}
    for i, r in enumerate(rows.tolist()):
        assert (orm[i], inv[i]) == codes[r[0]]
    with pytest.raises(ValueError, match="whole groups"):
        S.pack(rows[:-1], n)
    with pytest.raises(ValueError, match="16-bit"):
        S.pack(rows, 1 << 16)


def test_plan_is_cached_per_microcode_tensor():
    mc = torch.from_numpy(_random_microcode(9, 16, 100))
    p = plan(mc, 16)
    assert plan(mc, 16) is p and p.groups is None
    assert p.n_groups == len(p.rows) // S.GROUP_WIDTH
    mc[0, 0] = (int(mc[0, 0]) + 1) % 6     # in place: a new version
    assert plan(mc, 16) is not p
