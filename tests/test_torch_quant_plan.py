"""The int8 GEMM kernel's launch plan (``quant_matmul.plan``) and its
fragment layout, on the CPU.

The plan's K splits and column tiles must cover the product exactly once,
the split partial sums (summed in split order, as the last block of a
column tile does) must equal the whole product, the path's shapes must
split K only where a block's share exceeds what it stages, and the
workspace and counters must match the plan.  The kernel's fragment layout
(16-byte rows of w turned by ``__byte_perm`` transposes into shared-memory
words, the matching x fragments, the mma and its output layout) is
emulated in numpy, byte for byte, against the product."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.quant_matmul import quant_matmul_int_ref as r_qmm_ref
from repro_torch.kernels.quant_matmul import quant_matmul as qm
from repro_torch.kernels.quant_matmul import quant_matmul_int_ref

# chip_smoke.QUANT_SHAPES_KN: the (K, N) of the served model's linears
SHAPES_KN = ((1024, 1024), (1024, 2816), (2816, 1024))
PATH = [(m, k, n) for m in (1, 4, 16, 64) for k, n in SHAPES_KN]
RAGGED = [(1, 1, 1), (3, 77, 5), (17, 200, 130), (5, 1000, 1001),
          (2, 4097, 3)]


def _covers_once(ranges, total):
    """Ranges in order, contiguous, from 0 to total, none overlapping."""
    pos = 0
    for lo, hi in ranges:
        assert lo == pos and hi >= lo
        pos = hi
    assert pos == total


@pytest.mark.parametrize("m,k,n", PATH + RAGGED)
def test_plan_covers_k_and_n_exactly_once(m, k, n):
    p = qm.plan(m, k, n)
    assert len(p.k_ranges()) == p.splits
    assert len(p.col_ranges()) == p.col_tiles
    _covers_once(p.k_ranges(), k)
    _covers_once(p.col_ranges(), n)
    assert all(hi - lo <= qm.BN for lo, hi in p.col_ranges())
    # each split is whole 32-deep steps (the last one may be cut by K), at
    # most the 1024 k a block stages in shared memory at once
    for lo, hi in p.k_ranges():
        assert lo % qm.KSTEP == 0 and (hi % qm.KSTEP == 0 or hi == k)
        assert hi - lo <= qm.KSTEP * qm.CHUNK


@pytest.mark.parametrize("m,k,n", PATH + RAGGED)
def test_split_partials_sum_to_the_product(m, k, n):
    rng = np.random.default_rng(m * 7919 + k * 31 + n)
    x = rng.integers(-128, 128, (m, k)).astype(np.int8)
    w = rng.integers(-128, 128, (k, n)).astype(np.int8)
    x[0, ::3] = -128                       # the full int8 range
    w[::5, 0] = -128
    want = np.asarray(r_qmm_ref(jnp.asarray(x), jnp.asarray(w)))
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    whole = quant_matmul_int_ref(tx, tw)
    np.testing.assert_array_equal(whole.numpy(), want)
    total = torch.zeros((m, n), dtype=torch.int32)
    for lo, hi in qm.plan(m, k, n).k_ranges():   # split order
        total += quant_matmul_int_ref(tx[:, lo:hi], tw[lo:hi])
    assert torch.equal(total, whole)


@pytest.mark.parametrize("m,k,n", PATH)
def test_path_shapes_load_w_in_one_wave(m, k, n):
    """K splits across blocks only as far as the 1024 k a block stages
    forces (K = 1024: none; K = 2816: 3), so every block loads its share of
    w at once and 64 to 192 blocks hold the whole weight in flight."""
    p = qm.plan(m, k, n)
    assert p.splits == -(-k // (qm.KSTEP * qm.CHUNK))
    assert p.col_tiles == n // 16
    assert 64 <= p.blocks == p.col_tiles * p.splits <= 192
    assert p.workspace_elems == (0 if k <= 1024 else 3 * m * n)


@pytest.mark.parametrize("m,k,n", PATH + RAGGED + [(4096, 4096, 4096)])
def test_workspace_and_counters_match_the_plan(m, k, n):
    p = qm.plan(m, k, n)
    assert 1 <= p.splits <= p.steps == max(1, -(-k // qm.KSTEP))
    assert p.col_tiles == -(-n // qm.BN)
    if p.splits > 1:
        assert p.workspace_elems == p.splits * m * n
        assert p.n_counters == p.col_tiles
    else:
        assert p.workspace_elems == 0 and p.n_counters == 0


def test_plan_rejects_what_the_kernel_cannot_launch():
    for shape in ((0, 4, 4), (4, 4, 0), (1, -1, 1), (1, 1024 * 65536, 1)):
        with pytest.raises(ValueError):
            qm.plan(*shape)


# --------------------------------------------------------------------------
# the kernel's register layout, emulated byte for byte
# --------------------------------------------------------------------------

def _word(b):
    """Four int8 -> one little-endian 32-bit word (as a Python int)."""
    return int.from_bytes(np.asarray(b, np.int8).tobytes(), "little")


def _bytes(v):
    return np.frombuffer(int(v).to_bytes(4, "little"), np.int8)


def _byte_perm(x, y, s):
    """CUDA __byte_perm with selectors 0..7."""
    src = int(x).to_bytes(4, "little") + int(y).to_bytes(4, "little")
    return int.from_bytes(bytes(src[(s >> (4 * i)) & 7] for i in range(4)),
                          "little")


def _transpose4(r0, r1, r2, r3):
    t0, t1 = _byte_perm(r0, r1, 0x5140), _byte_perm(r0, r1, 0x7362)
    t2, t3 = _byte_perm(r2, r3, 0x5140), _byte_perm(r2, r3, 0x7362)
    return (_byte_perm(t0, t2, 0x5410), _byte_perm(t0, t2, 0x7632),
            _byte_perm(t1, t3, 0x5410), _byte_perm(t1, t3, 0x7632))


def _mma_m16n8k32(a, b):
    """mma.sync.m16n8k32.row.col.s32.s8.s8.s32 from the 32 lanes' registers
    (PTX ISA fragment layouts) -> each lane's four accumulators."""
    A = np.zeros((16, 32), np.int64)
    B = np.zeros((32, 8), np.int64)
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        for i in range(4):
            A[g + 8 * (i & 1), 4 * t + 16 * (i >> 1):][:4] = _bytes(a[lane][i])
        for q in range(2):
            B[4 * t + 16 * q:][:4, g] = _bytes(b[lane][q])
    D = A @ B
    return [[D[(lane >> 2) + 8 * (i >> 1), 2 * (lane & 3) + (i & 1)]
             for i in range(4)] for lane in range(32)]


@pytest.mark.parametrize("steps", [1, 3])
def test_fragment_layout_computes_the_product(steps):
    """A block's tile, 16 columns of w by `steps` 32-deep k steps, and one
    16-row tile of x, through the kernel's 16-byte row loads, register
    transposes into shared-memory words, fragment reads, mma and the
    warps' shared-memory reduction layout."""
    rng = np.random.default_rng(steps)
    k = qm.KSTEP * steps
    x = rng.integers(-128, 128, (16, k)).astype(np.int8)
    w = rng.integers(-128, 128, (k, qm.BN)).astype(np.int8)
    x[0], w[:, 3] = -128, -128
    # bs[c][q]: each quad q of 4 rows, loaded as 16-byte rows (4 words of 4
    # columns each) and transposed to one word per column
    bs = np.zeros((qm.BN, 8 * steps), np.int64)
    for q in range(8 * steps):
        rows = [[_word(w[4 * q + r, 4 * j:][:4]) for j in range(4)]
                for r in range(4)]
        for j in range(4):
            bs[4 * j:4 * j + 4, q] = _transpose4(*(rows[r][j]
                                                   for r in range(4)))
    got = np.zeros((16, qm.BN), np.int64)
    for s in range(steps):
        a, b = [], [[], []]
        for lane in range(32):
            g, t = lane >> 2, lane & 3
            k0 = qm.KSTEP * s + 8 * t
            a.append([_word(x[g, k0:][:4]), _word(x[g + 8, k0:][:4]),
                      _word(x[g, k0 + 4:][:4]), _word(x[g + 8, k0 + 4:][:4])])
            for jn in range(2):
                b[jn].append([bs[8 * jn + g, 8 * s + 2 * t],
                              bs[8 * jn + g, 8 * s + 2 * t + 1]])
        for jn in range(2):
            acc = _mma_m16n8k32(a, b[jn])
            for lane in range(32):
                g, t = lane >> 2, lane & 3
                for i in range(4):
                    got[g + 8 * (i >> 1), 8 * jn + 2 * t + (i & 1)] += \
                        acc[lane][i]
    np.testing.assert_array_equal(got, x.astype(np.int64) @ w.astype(np.int64))
