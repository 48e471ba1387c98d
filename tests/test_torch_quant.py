"""``quant`` lowering: the int8 GEMM kernel's plain version and the quantized
linear against ``repro`` (the Pallas kernel in interpret mode and its jnp
oracle).  All integer results are exact; ``quant_linear`` is bit-identical
on float32 (same elementwise float32 ops in the same order)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.quant_matmul import quant_linear as r_quant_linear
from repro.kernels.quant_matmul import quant_matmul_int as r_qmm
from repro.kernels.quant_matmul import quant_matmul_int_ref as r_qmm_ref
from repro.kernels.quant_matmul import quantize_sym as r_quantize_sym
from repro_torch.kernels.quant_matmul import (quant_linear,
                                              quant_matmul_int,
                                              quant_matmul_int_ref,
                                              quant_matmul_ref, quantize_sym)


@pytest.mark.parametrize("m,k,n", [(1, 64, 24), (5, 130, 70), (16, 512, 8),
                                   (3, 7, 129)])
def test_int32_accumulators_match_reference(m, k, n):
    rng = np.random.default_rng(m * 1000 + k)
    x = rng.integers(-128, 128, (m, k)).astype(np.int8)
    w = rng.integers(-128, 128, (k, n)).astype(np.int8)
    x[0, :] = -128                       # the full int8 range
    w[:, 0] = -128
    want = np.asarray(r_qmm(jnp.asarray(x), jnp.asarray(w)))  # interpret
    np.testing.assert_array_equal(want, np.asarray(
        r_qmm_ref(jnp.asarray(x), jnp.asarray(w))))
    got = quant_matmul_int(torch.from_numpy(x), torch.from_numpy(w))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        quant_matmul_int_ref(torch.from_numpy(x), torch.from_numpy(w)).numpy(),
        want)


def test_cpu_wrapper_runs_the_plain_version_without_counting():
    x = torch.ones((2, 3), dtype=torch.int8)
    w = torch.ones((3, 4), dtype=torch.int8)
    before = quant_matmul_int.launches
    assert torch.equal(quant_matmul_int(x, w), torch.full((2, 4), 3,
                                                          dtype=torch.int32))
    assert quant_matmul_int.launches == before     # no kernel launched


def test_wrapper_checks_operands():
    x = torch.ones((2, 3), dtype=torch.int8)
    with pytest.raises(TypeError):
        quant_matmul_int(x.float(), torch.ones((3, 4), dtype=torch.int8))
    with pytest.raises(ValueError):
        quant_matmul_int(x, torch.ones((4, 4), dtype=torch.int8))
    with pytest.raises(ValueError):
        quant_matmul_int(x.to("meta"), torch.ones((3, 4), dtype=torch.int8,
                                                  device="meta"))


@pytest.mark.parametrize("axis", [0, 1])
def test_quantize_sym_bit_identical(axis):
    rng = np.random.default_rng(axis)
    x = (rng.normal(size=(9, 33)) * 3).astype(np.float32)
    x[2] = 0.0                          # an all-zero channel: eps branch
    rq, rs = r_quantize_sym(jnp.asarray(x), axis=axis)
    tq, ts = quantize_sym(torch.from_numpy(x), axis=axis)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(rq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(rs))


@pytest.mark.parametrize("lead", [(4,), (2, 3)])
def test_quant_linear_bit_identical_on_f32(lead):
    rng = np.random.default_rng(len(lead))
    x = rng.normal(size=lead + (96,)).astype(np.float32)
    w = (rng.normal(size=(96, 40)) * 0.1).astype(np.float32)
    want = np.asarray(r_quant_linear(jnp.asarray(x), jnp.asarray(w),
                                     backend="ref"))
    got = quant_linear(torch.from_numpy(x), torch.from_numpy(w))
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


def test_quant_matmul_ref_scales():
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.integers(-127, 128, (3, 20)).astype(np.int8))
    w = torch.from_numpy(rng.integers(-127, 128, (20, 5)).astype(np.int8))
    xs = torch.rand(3)
    ws = torch.rand(5)
    want = (x.double() @ w.double()).float() * xs[:, None] * ws[None, :]
    assert torch.equal(quant_matmul_ref(x, w, xs, ws), want)
