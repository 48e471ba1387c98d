"""The ``pim_sim`` engine's bit-plane kernels (``kernels.pim_bits``): the
writer puts an operand of a batch of chunk GEMMs onto crossbar columns
straight from ``x`` (P, M, K) or ``w`` (P, O, K), the reader takes the
accumulators off them.  On the CPU the wrappers run their plain versions,
which are held here bit for bit against what the engine wrote and read
before them, ``executor.write_numbers(part, cols, engine._operand_rows(
...))`` and ``executor.read_numbers``, over whole chunks and parts of one,
both operands, ragged row counts and the column tables of the 1024- and
2048-column dot programs.  The writer kernel's loop (its 32 x 32 bit
transpose and its staging) is emulated in numpy and held to the plain
version too.  The engine takes the kernels only for a CUDA state with
uint8 operands of at most 8 bits and 63 accumulator bits; with that choice
forced on the CPU, its results and resident states equal the plain path's.
The card test holds both kernels to their plain versions on the GPU; it
skips without one (``python3 -m pytest -m card tests/test_torch_pim_bits.py``
runs it there).
"""
import functools
from types import SimpleNamespace
from unittest import mock

import numpy as np
import pytest
import torch

from repro_torch.kernels import pim_bits
from repro_torch.pim import engine
from repro_torch.pim import executor as ex
from repro_torch.pim.matmul import max_dot_terms

P = 2                       # chunks in a batch


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda")


@functools.lru_cache(maxsize=None)
def _artifact(n_cols):
    return engine.compile_matmul(max_dot_terms(8, n_cols), 8, n_cols=n_cols)


def _operand(rows_of, k, seed, device="cpu"):
    """(P, rows_of, k) uint8 as the engine holds a chunked operand: a
    strided view of a zero-padded (rows_of, P * k) matrix."""
    rng = np.random.default_rng(seed)
    flat = torch.from_numpy(rng.integers(0, 256, (rows_of, P * k),
                                         dtype=np.uint8)).to(device)
    return flat.unflatten(1, (P, k)).transpose(0, 1)


def _state(c, n, rows, seed, device="cpu"):
    """A random (c, n, W) int32 state: every word not written must stay."""
    g = torch.Generator().manual_seed(seed)
    return torch.randint(-2 ** 31, 2 ** 31 - 1, (c, n, -(-rows // 32)),
                         dtype=torch.int32, generator=g).to(device)


def _piece(n_cb, kind):
    """[lo, hi) of the batch: all of it, or a part of the second chunk
    (its whole chunk when it has one crossbar)."""
    if kind == "whole":
        return 0, P * n_cb
    first = n_cb // 2
    return n_cb + first, n_cb + min(first + max(1, n_cb // 3), n_cb)


def _plain_write(part, v, cols, lo, hi, n_cb, rows, m, o, of_x):
    return ex.write_numbers(part, cols, engine._operand_rows(
        v, lo, hi, n_cb, rows, m, o, of_x))


@pytest.mark.parametrize("piece", ["whole", "part"])
@pytest.mark.parametrize("n_cols", [1024, 2048])
@pytest.mark.parametrize("of_x", [True, False], ids=["x", "w"])
@pytest.mark.parametrize("rows", [64, 256])
@pytest.mark.parametrize("m", [1, 2, 5])
@pytest.mark.parametrize("o", [1, 3, 33, 256, 300])
def test_writer_is_write_numbers_of_the_operand_rows(o, m, rows, of_x,
                                                     n_cols, piece):
    art = _artifact(n_cols)
    x_cols, w_cols, _ = art.columns_on("cpu")
    cols = x_cols if of_x else w_cols
    v = _operand(m if of_x else o, art.n_terms, 7 * m + o + rows)
    n_cb = -(-m * o // rows)
    lo, hi = _piece(n_cb, piece)
    start = _state(hi - lo, art.n_cols, rows, o + m)
    want = _plain_write(start.clone(), v, cols, lo, hi, n_cb, rows, m, o,
                        of_x)
    got = pim_bits.write_operand(start.clone(), v, cols, lo, hi, n_cb, rows,
                                 m, o, of_x)
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  want.numpy().view(np.uint32))


@pytest.mark.parametrize("of_x", [True, False], ids=["x", "w"])
@pytest.mark.parametrize("m,o", [(1, 3), (2, 33), (5, 7)])
def test_writer_pads_a_row_count_short_of_a_word(m, o, of_x):
    """40 rows a crossbar: the second row-word's last 24 rows are zero."""
    test_writer_is_write_numbers_of_the_operand_rows(o, m, 40, of_x, 1024,
                                                     "part")


# -- the writer kernel's loop, emulated -------------------------------------

_LOWS = (0x0000ffff, 0x00ff00ff, 0x0f0f0f0f, 0x33333333, 0x55555555)
PASS_TERMS = 40             # the kernel's terms a pass


def _transpose32(x):
    """``transpose32`` of csrc/pim_bits.cu over one warp's 32 lanes."""
    lane = np.arange(32)
    for i, low in enumerate(_LOWS):
        s = 16 >> i
        low = np.uint32(low)
        y = x[lane ^ s]
        x = np.where(lane & s, (x & ~low) | ((y >> np.uint32(s)) & low),
                     (x & low) | ((y & low) << np.uint32(s)))
    return x.astype(np.uint32)


def _kernel_write(part, v, cols, lo, hi, n_cb, rows, m, o, of_x):
    """``pim_bits_write_kernel`` block by block, warp by warp, in numpy:
    four terms a lane, the transpose, the staged words at stride W | 1,
    then each column's W words stored."""
    out = part.numpy().view(np.uint32).copy()
    vals, flat = v.numpy(), cols.numpy().reshape(-1)
    _, _, w_words = out.shape
    k, nb = cols.shape
    stride = w_words | 1
    lane = np.arange(32)
    for blk in range(hi - lo):
        c = lo + blk
        q = c // n_cb
        g0 = (c - q * n_cb) * rows
        for k0 in range(0, k, PASS_TERMS):
            kn = min(PASS_TERMS, k - k0)
            words = np.zeros(PASS_TERMS * 8 * stride, np.uint32)
            for wi in range(w_words):
                j = wi * 32 + lane
                g = g0 + j
                live = (j < rows) & (g < m * o)
                r = np.where(live, g // o if of_x else g % o, 0)
                for t0 in range(0, kn, 4):
                    x = np.zeros(32, np.uint32)
                    for t in range(min(4, kn - t0)):
                        byte = vals[q, r, k0 + t0 + t].astype(np.uint32)
                        x |= np.where(live, byte, 0).astype(np.uint32) \
                            << np.uint32(8 * t)
                    x = _transpose32(x)
                    t, b = t0 + lane // 8, lane % 8
                    ok = (t < kn) & (b < nb)
                    words[((t * nb + b) * stride + wi)[ok]] = x[ok]
            for i in range(kn * nb):
                out[blk, flat[k0 * nb + i]] = words[i * stride:
                                                    i * stride + w_words]
    return out


@pytest.mark.parametrize("rows,m,o,of_x,piece,n_cols", [
    (256, 2, 300, True, "whole", 1024), (256, 2, 300, False, "part", 1024),
    (40, 5, 33, True, "part", 1024), (40, 5, 33, False, "whole", 1024),
    (64, 1, 3, False, "whole", 1024), (64, 2, 33, True, "part", 2048)])
def test_writer_kernel_loop_is_the_plain_version(rows, m, o, of_x, piece,
                                                 n_cols):
    art = _artifact(n_cols)
    x_cols, w_cols, _ = art.columns_on("cpu")
    cols = x_cols if of_x else w_cols
    v = _operand(m if of_x else o, art.n_terms, rows + o)
    n_cb = -(-m * o // rows)
    lo, hi = _piece(n_cb, piece)
    start = _state(hi - lo, art.n_cols, rows, 3)
    want = pim_bits.write_operand_ref(start.clone(), v, cols, lo, hi, n_cb,
                                      rows, m, o, of_x)
    got = _kernel_write(start, v, cols, lo, hi, n_cb, rows, m, o, of_x)
    np.testing.assert_array_equal(got, want.numpy().view(np.uint32))


def test_transpose32_transposes():
    rng = np.random.default_rng(0)
    x = rng.integers(0, 2 ** 32, 32, dtype=np.uint64).astype(np.uint32)
    bits = (x[:, None] >> np.arange(32, dtype=np.uint32)) & 1   # [lane, bit]
    y = _transpose32(x)
    np.testing.assert_array_equal(
        (y[:, None] >> np.arange(32, dtype=np.uint32)) & 1, bits.T)


# -- the reader ---------------------------------------------------------------

@pytest.mark.parametrize("rows", [40, 64, 256])
@pytest.mark.parametrize("acc", ["1024", "2048", "63 bits", "1 bit"])
def test_reader_is_read_numbers(acc, rows):
    n = 2048 if acc == "2048" else 1024
    if acc in ("1024", "2048"):
        cols = _artifact(n).columns_on("cpu")[2]
    else:
        width = 63 if acc == "63 bits" else 1
        cols = torch.from_numpy(np.random.default_rng(rows).permutation(n)
                                [:width].astype(np.int32))
    state = _state(5, n, rows, rows)
    want = ex.read_numbers(state, cols, rows)
    got = pim_bits.read_accumulators(state, cols, rows)
    assert got.dtype == torch.int64 and got.shape == (5, rows)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    buf = torch.full((9, rows), -1, dtype=torch.int64)
    assert pim_bits.read_accumulators(state, cols, rows, out=buf[2:7]) \
        .data_ptr() == buf[2:7].data_ptr()
    np.testing.assert_array_equal(buf[2:7].numpy(), want.numpy())
    assert bool((buf[:2] == -1).all() and (buf[7:] == -1).all())


# -- the wrappers' checks ---------------------------------------------------

def test_wrappers_refuse_what_the_kernels_do_not_take():
    art = _artifact(1024)
    x_cols, _, acc = art.columns_on("cpu")
    v = _operand(2, art.n_terms, 0)
    part = _state(2, art.n_cols, 256, 0)
    args = (0, 2, 1, 256, 2, 100, True)
    with pytest.raises(TypeError):
        pim_bits.write_operand(part, v.to(torch.int64), x_cols, *args)
    with pytest.raises(TypeError):
        pim_bits.write_operand(part, v, x_cols.long(), *args)
    wide = torch.arange(art.n_terms * 9, dtype=torch.int32).reshape(-1, 9)
    with pytest.raises(ValueError, match="bits a term"):
        pim_bits.write_operand(part, v, wide, *args)
    with pytest.raises(ValueError, match="outside"):
        pim_bits.write_operand(part, v, x_cols + art.n_cols, *args)
    twice = x_cols.clone()
    twice[1, 0] = twice[0, 0]
    with pytest.raises(ValueError, match="repeats"):
        pim_bits.write_operand(part, v, twice, *args)
    with pytest.raises(ValueError):       # more crossbars than the batch
        pim_bits.write_operand(part, v, x_cols, 3, 5, 1, 256, 2, 100, True)
    with pytest.raises(ValueError, match="at most 63"):
        pim_bits.read_accumulators(part, torch.arange(64, dtype=torch.int32),
                                   256)
    with pytest.raises(TypeError):
        pim_bits.read_accumulators(part, acc, 256,
                                   out=torch.empty((2, 256)))


# -- the engine's choice ------------------------------------------------------

def _like(device, dtype):
    return SimpleNamespace(device=torch.device(device), dtype=dtype)


def test_engine_takes_the_kernels_for_cuda_uint8_and_narrow_widths():
    narrow = engine.compile_matmul(37, 8)
    assert len(narrow.acc_cols) <= 63
    u8 = _like("cuda", torch.uint8)
    assert engine._bit_kernels(u8, u8, narrow)
    # a CPU state, another dtype of either operand
    cpu = _like("cpu", torch.uint8)
    assert not engine._bit_kernels(cpu, cpu, narrow)
    for a, b in ((_like("cuda", torch.int64), u8),
                 (u8, _like("cuda", torch.int64)),
                 (_like("cuda", torch.int32), _like("cuda", torch.int32))):
        assert not engine._bit_kernels(a, b, narrow)
    # wider than 8 bits a term, or more than 63 accumulator bits
    wide = engine.compile_matmul(4, 16)
    assert len(wide.x_cols[0]) == 16
    assert not engine._bit_kernels(u8, u8, wide)
    many = SimpleNamespace(x_cols=narrow.x_cols, w_cols=narrow.w_cols,
                           acc_cols=tuple(range(64)))
    assert not engine._bit_kernels(u8, u8, many)


def _refusing(*a, **kw):
    raise AssertionError("the CPU path called a pim_bits wrapper")


@pytest.mark.parametrize("dtype", [torch.uint8, torch.int64])
def test_engine_on_the_cpu_keeps_the_plain_path(dtype):
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.integers(0, 256, (2, 40))).to(dtype)
    w = torch.from_numpy(rng.integers(0, 256, (7, 40))).to(dtype)
    engine.clear_cache()
    with mock.patch.object(pim_bits, "write_operand", _refusing), \
            mock.patch.object(pim_bits, "read_accumulators", _refusing):
        got = engine.matmul_int(x, w, 8)
    np.testing.assert_array_equal(
        got.numpy(), x.numpy().astype(np.int64) @ w.numpy().T.astype(np.int64))
    engine.clear_cache()


def _spied():
    """Wrappers of the two entry points that count their calls."""
    calls = {"write": 0, "read": 0}
    real_w, real_r = pim_bits.write_operand, pim_bits.read_accumulators

    def write(*a, **kw):
        calls["write"] += 1
        return real_w(*a, **kw)

    def read(*a, **kw):
        calls["read"] += 1
        return real_r(*a, **kw)

    return calls, write, read


@pytest.mark.parametrize("split", [False, True])
def test_engine_on_the_kernel_path_is_the_plain_path(split):
    """With the engine's choice forced on the CPU (the wrappers run their
    plain versions): transient and resident calls, in one launch and in
    parts of chunks, give the plain path's results and resident states."""
    rng = np.random.default_rng(5)
    m, k, o = 2, 60, 300                     # 2 chunks of 3 crossbars
    x1, x2 = (torch.from_numpy(rng.integers(0, 256, (m, k), dtype=np.uint8))
              for _ in range(2))
    w = torch.from_numpy(rng.integers(0, 256, (o, k), dtype=np.uint8))
    art = engine.compile_matmul(37, 8)
    per = engine.launch_bytes(art.n_cols, 37, len(art.acc_cols), 256, 1)
    budget = 2 * per if split else engine.MAX_LAUNCH_BYTES
    runs = []
    for forced in (False, True):
        engine.clear_cache()
        calls, write, read = _spied()
        with mock.patch.object(engine, "MAX_LAUNCH_BYTES", budget), \
                mock.patch.object(engine, "_bit_kernels",
                                  lambda *a: forced), \
                mock.patch.object(pim_bits, "write_operand", write), \
                mock.patch.object(pim_bits, "read_accumulators", read):
            with engine.transient():
                t = engine.matmul_int(x1, w, 8)
            sess = engine.session_for(art)
            r1 = engine.matmul_int(x1, w, 8)
            r2 = engine.matmul_int(x2, w, 8)
            (entry,) = sess._states.values()
            runs.append((t, r1, r2, entry.value.clone(), dict(calls)))
    (pt, p1, p2, ps, pc), (kt, k1, k2, ks, kc) = runs
    pieces = 4 if split else 1               # pieces of 2 crossbars a piece
    assert pc == {"write": 0, "read": 0}
    # transient: w and x per piece; resident: w and x, then x alone
    assert kc == {"write": 5 * pieces, "read": 3 * pieces}
    for a, b in ((pt, kt), (p1, k1), (p2, k2)):
        assert torch.equal(a, b)
    np.testing.assert_array_equal(ps.numpy().view(np.uint32),
                                  ks.numpy().view(np.uint32))
    want = x2.numpy().astype(np.int64) @ w.numpy().T.astype(np.int64)
    np.testing.assert_array_equal(k2.numpy(), want)
    engine.clear_cache()


# -- on the card --------------------------------------------------------------

@pytest.mark.card
def test_kernels_are_their_plain_versions_on_the_card(card):
    """Both kernels against their plain versions (and the writer against
    ``write_numbers`` of the operand rows) at small shapes on the GPU,
    whole chunks and a part of one, x and w, then an engine GEMM."""
    for n_cols in (1024, 2048):
        art = _artifact(n_cols)
        x_cols, w_cols, acc = art.columns_on(card)
        for rows, m, o in ((256, 2, 300), (40, 5, 33), (64, 1, 3)):
            n_cb = -(-m * o // rows)
            for of_x, cols in ((True, x_cols), (False, w_cols)):
                v = _operand(m if of_x else o, art.n_terms, rows + o, card)
                for piece in ("whole", "part"):
                    lo, hi = _piece(n_cb, piece)
                    start = _state(hi - lo, n_cols, rows, o, card)
                    got = pim_bits.write_operand(start.clone(), v, cols, lo,
                                                 hi, n_cb, rows, m, o, of_x)
                    want = _plain_write(start.clone(), v, cols, lo, hi,
                                        n_cb, rows, m, o, of_x)
                    assert torch.equal(got, want), (n_cols, rows, m, o,
                                                    of_x, piece)
            state = _state(7, n_cols, rows, rows, card)
            out = torch.empty((9, rows), dtype=torch.int64, device=card)
            pim_bits.read_accumulators(state, acc, rows, out=out[1:8])
            assert torch.equal(out[1:8], ex.read_numbers(state, acc, rows))
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.integers(0, 128, (2, 100), dtype=np.uint8))
    w = torch.from_numpy(rng.integers(0, 128, (50, 100), dtype=np.uint8))
    before = dict(pim_bits.launches)
    engine.clear_cache()
    got = engine.matmul_int(x.to(card), w.to(card), 8)
    torch.cuda.synchronize()
    assert pim_bits.launches["write"] - before["write"] == 2
    assert pim_bits.launches["read"] - before["read"] == 1
    np.testing.assert_array_equal(
        got.cpu().numpy(),
        x.numpy().astype(np.int64) @ w.numpy().T.astype(np.int64))
    engine.clear_cache()
