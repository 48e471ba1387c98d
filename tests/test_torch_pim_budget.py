"""The launch budget of the port's ``pim_sim`` engine: a GEMM whose
crossbars would take more than ``engine.MAX_LAUNCH_BYTES`` runs as several
launches over contiguous ranges of them (``engine.launch_pieces``), each
packing only its own operand rows.  With the budget cut so that a GEMM
splits, ``matmul_int`` must give the bits of one launch and of the
reference's per-chunk ``repro.pim.engine.matmul_int`` (its numpy
interpreter, as tests/test_torch_engine.py runs it), on transient and on
resident state, one crossbar launch per piece; the port runs on the CPU,
i.e. on the crossbar kernel's grouped plain version.  All exact.
"""
import functools
from unittest import mock

import numpy as np
import pytest
import torch

from repro.pim import engine as r_engine
from repro_torch.kernels import crossbar_exec as xb
from repro_torch.pim import engine

ROWS = 256
SHAPES = [(m, k, o) for m in (1, 3, 17) for k in (37, 38, 79, 200)
          for o in (5, 33)]


def _per_crossbar(itemsize=8):
    art = engine.compile_matmul(37, 8)
    return engine.launch_bytes(art.n_cols, art.n_terms, len(art.acc_cols),
                               ROWS, itemsize)


def _grid_of(m, k, o):
    """(chunks, crossbars per chunk) of an (M, K) x (O, K) GEMM."""
    return -(-k // 37), -(-m * o // ROWS)


@functools.lru_cache(maxsize=None)
def _operands(m, k, o):
    rng = np.random.default_rng(1000 * m + 10 * k + o)
    return rng.integers(0, 256, (m, k)), rng.integers(0, 256, (o, k))


@functools.lru_cache(maxsize=None)
def _reference(m, k, o):
    x, w = _operands(m, k, o)
    return r_engine.matmul_int(x.astype(np.uint64), w.astype(np.uint64), 8,
                               backend="numpy").astype(np.int64)


@functools.lru_cache(maxsize=None)
def _one_launch(m, k, o):
    x, w = _operands(m, k, o)
    p, n_cb = _grid_of(m, k, o)
    assert engine.launch_pieces(p, n_cb, _per_crossbar()) == [(0, p * n_cb)]
    with engine.transient():
        return engine.matmul_int(torch.from_numpy(x), torch.from_numpy(w),
                                 8).numpy()


def _counting():
    """A counting stand-in for the crossbar kernel: the crossbars of each
    launch, appended to its ``seen``."""
    real = xb.crossbar_exec

    def count(state, mc):
        count.seen.append(state.shape[0])
        return real(state, mc)

    count.seen = []
    return count


def _split_budget(p, n_cb):
    """A budget of about a third of the GEMM's crossbars (at least one), so
    that every GEMM of more than one crossbar splits: whole chunks a piece
    where a chunk fits, parts of one chunk where none does."""
    return max(1, p * n_cb // 3) * _per_crossbar()


@pytest.mark.parametrize("kind", ["transient", "resident"])
@pytest.mark.parametrize("m,k,o", SHAPES)
def test_budgeted_matmul_int_is_one_launch_and_the_reference(m, k, o, kind):
    x, w = (torch.from_numpy(a) for a in _operands(m, k, o))
    want, one = _reference(m, k, o), _one_launch(m, k, o)
    np.testing.assert_array_equal(one, want)
    p, n_cb = _grid_of(m, k, o)
    budget = _split_budget(p, n_cb)
    pieces = engine.launch_pieces(p, n_cb, _per_crossbar(), budget)
    assert (len(pieces) > 1) == (p * n_cb > 1)
    count = _counting()
    engine.clear_cache()
    with mock.patch.object(engine, "MAX_LAUNCH_BYTES", budget), \
            mock.patch.object(xb, "crossbar_exec", count):
        if kind == "transient":
            with engine.transient():
                got = engine.matmul_int(x, w, 8)
            assert engine.cache_info().exec_transient == p
        else:
            got = engine.matmul_int(x, w, 8)
            info = engine.cache_info()
            assert (info.exec_uploads, info.resident_entries) == (p, 1)
            assert info.resident_bytes == p * n_cb * _state_bytes()
            again = engine.matmul_int(x, w, 8)
            info2 = engine.cache_info()
            assert info2.exec_uploads == p and info2.exec_hits == p
            np.testing.assert_array_equal(again.numpy(), want)
    assert count.seen == [hi - lo for lo, hi in pieces] * (
        1 if kind == "transient" else 2)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), one)
    np.testing.assert_array_equal(got.numpy(), want)
    engine.clear_cache()


def _state_bytes():
    """One crossbar's state: 1024 columns of 8 32-bit words."""
    return engine.compile_matmul(37, 8).n_cols * (ROWS // 32) * 4


def _states(sess):
    return {key: e.value.clone() for key, e in sess._states.items()}


@pytest.mark.parametrize("m,k,o", [(17, 38, 33), (17, 200, 33),
                                   (3, 79, 5)])
def test_split_resident_state_is_the_one_launch_state(m, k, o):
    """The resident state after a split call and after a hit equals, bit
    for bit, the state one launch leaves: every piece ran on its slice of
    the one state tensor and was written back."""
    x, w = (torch.from_numpy(a) for a in _operands(m, k, o))
    x2 = torch.from_numpy(np.random.default_rng(m).integers(0, 256, (m, k)))
    p, n_cb = _grid_of(m, k, o)
    runs = []
    for budget in (engine.MAX_LAUNCH_BYTES, _split_budget(p, n_cb)):
        engine.clear_cache()
        sess = engine.session_for(engine.compile_matmul(37, 8))
        with mock.patch.object(engine, "MAX_LAUNCH_BYTES", budget):
            first = engine.matmul_int(x, w, 8)
            s1 = _states(sess)
            second = engine.matmul_int(x2, w, 8)
            runs.append((first, s1, second, _states(sess)))
    (a1, as1, a2, as2), (b1, bs1, b2, bs2) = runs
    assert torch.equal(a1, b1) and torch.equal(a2, b2)
    for sa, sb in ((as1, bs1), (as2, bs2)):
        assert len(sa) == len(sb) == 1
        (va,), (vb,) = sa.values(), sb.values()
        assert va.shape == (p * n_cb, 1024, ROWS // 32)
        np.testing.assert_array_equal(va.numpy().view(np.uint32),
                                      vb.numpy().view(np.uint32))
    np.testing.assert_array_equal(
        b2.numpy(), x2.numpy().astype(np.int64) @ w.numpy().T)
    engine.clear_cache()


@pytest.mark.parametrize("p,n_cb,cap", [
    (1, 1, 1), (1, 7, 1), (1, 7, 3), (1, 7, 7), (5, 1, 2), (5, 3, 2),
    (5, 3, 3), (5, 3, 4), (5, 3, 15), (5, 3, 100), (111, 12808, 47259),
    (111, 6404, 47259), (167, 192, 47259), (28, 22, 47259), (4, 1000, 999),
    (3, 2, 5)])
def test_pieces_are_disjoint_and_cover_every_crossbar(p, n_cb, cap):
    per = 1000
    pieces = engine.launch_pieces(p, n_cb, per, cap * per + per - 1)
    assert pieces[0][0] == 0 and pieces[-1][1] == p * n_cb
    for (lo, hi), (lo2, _) in zip(pieces, pieces[1:]):
        assert hi == lo2
    for lo, hi in pieces:
        assert 0 < hi - lo <= cap
        assert (hi - lo) * per <= cap * per + per - 1     # under the budget
        whole = lo % n_cb == 0 and hi % n_cb == 0
        assert whole or lo // n_cb == (hi - 1) // n_cb     # within a chunk
    # as few as the rule allows: whole chunks a piece while one fits
    if p * n_cb <= cap:
        assert pieces == [(0, p * n_cb)]
    elif n_cb <= cap:
        assert len(pieces) == -(-p // (cap // n_cb))
    else:
        assert len(pieces) == p * -(-n_cb // cap)


def test_a_budget_below_one_crossbar_raises():
    per = _per_crossbar()
    with pytest.raises(ValueError, match="over the launch budget"):
        engine.launch_pieces(3, 2, per, per - 1)
    x, w = (torch.from_numpy(a) for a in _operands(3, 38, 5))
    count = _counting()
    with mock.patch.object(engine, "MAX_LAUNCH_BYTES", per - 1), \
            mock.patch.object(xb, "crossbar_exec", count), \
            pytest.raises(ValueError, match="over the launch budget"):
        engine.matmul_int(x, w, 8)
    assert count.seen == []
    engine.clear_cache()


def test_the_default_budget_splits_only_long_gemms():
    """The arithmetic that ``engine.MAX_LAUNCH_BYTES``' note gives: 272,640
    B a crossbar at 1024 columns, 37 uint8 terms and 256 rows; up to
    47,259 crossbars a launch; granite-20b's decode w_in at batch 2
    (167 x 192 crossbars) in one launch, llama-3.2-vision-11b's xwk over
    1601 patches (111 x 6,404) in 16."""
    per = _per_crossbar(itemsize=1)
    assert per == 272_640
    assert engine.MAX_LAUNCH_BYTES // per == 47_259
    assert len(engine.launch_pieces(167, 192, per)) == 1
    assert len(engine.launch_pieces(111, 6404, per)) == 16
    assert len(engine.launch_pieces(111, 2 * 6404, per)) == 37
