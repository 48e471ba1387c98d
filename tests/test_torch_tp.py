"""``quant_tp`` (``repro_torch.kernels.quant_matmul.tp``) against the
reference's ``repro.kernels.quant_matmul.tp`` — the cases of
tests/test_quant_tp.py, port side.

The reference runs in this process under meshes of the same shape over
the host devices (tests/conftest.py forces 8); the port runs in gloo
processes on the CPU started by ``repro_torch.launch.mesh.spawn`` (one
spawn per world: model = 2, model = 4, and data = 2 x model = 2), whose
per-rank cases are tests/_torch_dist_cases.py.

Exact: every rank's int32 tile against the reference's tile of the same
rank, every output against the reference's ``tp_quant_linear`` (run op
by op) and single-rank ``quant`` (float32, bit for bit), the prefill and
decode logits of ``quant_tp`` against the port's ``quant``, served
tokens against the reference's.  Tolerances: the straight-through gradient
within ``rtol=1e-5`` of the reference's, the loss within ``LOSS_TOL`` =
1e-5 and each gradient leaf within ``GRAD_TOL`` = 2e-5 of its largest
reference entry (tests/test_torch_train.py's), logits within 1e-4 of
their largest entry against the reference's ``quant_tp``
(tests/test_quant_tp.py's).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist_cases as C
import repro.configs as RC
from repro.dist import context as r_dctx
from repro.kernels.quant_matmul import quant_matmul_int_ref as r_qmm_ref
from repro.kernels.quant_matmul import quantize_sym as r_quantize_sym
from repro.kernels.quant_matmul import tp_quant_linear as r_tp_linear
from repro.kernels.quant_matmul.tp import tp_split as r_tp_split
from repro.kernels.quant_matmul.tp import tp_tile_shape as r_tp_tile_shape
from repro.models import model_lib as RM
from repro.pim import engine as r_engine
from repro.serving import Scheduler as RScheduler
from repro.serving import ServingConfig as RServingConfig
from repro_torch.dist import partitioning as dpart
from repro_torch.kernels.quant_matmul import (quant_linear, tp_quant_linear,
                                              tp_split, tp_tile_shape)
from repro_torch.kernels.quant_matmul.tp import tile_summary
from repro_torch.launch.mesh import spawn
from repro_torch.pim import engine

LOSS_TOL = 1e-5
GRAD_TOL = 2e-5
SPAWN_TIMEOUT_S = 90.0

KERNEL_SHAPES = [(4, 64, 128), (4, 128, 64), (5, 60, 52), (3, 33, 56),
                 (2, 8, 8)]
PROMPTS = [([1, 2, 3, 4, 5], 6), ([9, 8], 4), ([3, 1, 4, 1, 5, 9], 5)]
# staggered arrivals (s after the start), on clocks 0.25 s apart per rank
OFFSETS = (0.0, 0.15, 0.3)
SKEW_S = 0.25


def _rand(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def _kernel_inputs():
    cases = []
    for m, k, n in KERNEL_SHAPES:
        rng = np.random.default_rng(m * 100 + n)
        cases.append((_rand(rng, m, k), _rand(rng, k, n)))
    rng = np.random.default_rng(0)
    cases.append((_rand(rng, 2, 3, 64), _rand(rng, 64, 32)))   # lead dims
    rng = np.random.default_rng(2)
    cases.append((_rand(rng, 8, 64), _rand(rng, 64, 32)))      # 8 rows
    return cases


def _ref_mesh(shape, axes):
    n = int(np.prod(shape))
    return jax.sharding.Mesh(np.array(jax.devices()[:n]).reshape(shape),
                             axes)


def _ref_tp(x, w, mesh):
    """The reference's ``tp_quant_linear`` under ``mesh``, run op by op:
    its float32 rescale then matches the port's (and ``quant_linear``'s)
    bit for bit.  Under ``jax.jit`` XLA fuses the rescale and moves about
    a fifth of the entries by an ulp, in the reference's ``quant`` as in
    its ``quant_tp`` (the reference's own test compares jit with jit)."""
    with r_dctx.use_mesh(mesh):
        return np.asarray(r_tp_linear(jnp.asarray(x), jnp.asarray(w)))


def _ref_tiles(x, w, r):
    """Each rank's int32 tile as the reference's shard_map computes it."""
    x2 = jnp.asarray(x.reshape(-1, x.shape[-1]))
    k, n = w.shape
    xq, _ = r_quantize_sym(x2, axis=1)
    if r_tp_split(w.shape, r) == "col":
        wp = np.pad(w, ((0, 0), (0, (-n) % r)))
        nl = wp.shape[1] // r
        return [np.asarray(r_qmm_ref(xq, r_quantize_sym(
            jnp.asarray(wp[:, i * nl:(i + 1) * nl]), axis=0)[0]))
            for i in range(r)]
    wq, _ = r_quantize_sym(jnp.asarray(w), axis=0)
    kl = k // r
    return [np.asarray(r_qmm_ref(xq[:, i * kl:(i + 1) * kl],
                                 wq[i * kl:(i + 1) * kl])) for i in range(r)]


@pytest.fixture(scope="module")
def small():
    cfg_r = RC.get("qwen1.5-0.5b").smoke()
    pr = RM.init_params(cfg_r, jax.random.PRNGKey(0))
    pr1 = RM.init_params(cfg_r.scaled(n_layers=1, pattern=("ad",)),
                         jax.random.PRNGKey(0))
    np_tree = jax.tree.map(np.asarray, pr)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg_r.vocab_size, (2, 9)).astype(np.int64)
    lrng = np.random.default_rng(0)
    loss_toks = lrng.integers(0, cfg_r.vocab_size, (1, 8)).astype(np.int64)
    loss_labels = lrng.integers(0, cfg_r.vocab_size, (1, 8)).astype(np.int64)
    return dict(cfg_r=cfg_r, pr=pr, pr1=pr1, np_tree=np_tree, toks=toks,
                loss=(loss_toks, loss_labels))


@pytest.fixture(scope="module")
def world2(small):
    """Everything at model = 2: kernel tiles, gradient, loss, prefill and
    decode, both pools served with staggered arrivals."""
    grad_in = np.random.default_rng(4)
    gx, gw = _rand(grad_in, 4, 16), _rand(grad_in, 16, 24)
    jobs = [("kernel_cases", (_kernel_inputs(),)),
            ("grad_case", (gx, gw)),
            ("loss_case", (jax.tree.map(np.asarray, small["pr1"]),)
             + small["loss"]),
            ("prefill_decode_case", (small["np_tree"],
                                     small["toks"][:, :8],
                                     small["toks"][:, 8:9])),
            ("serve_case", (small["np_tree"], PROMPTS, OFFSETS, SKEW_S))]
    out = spawn(C.run_jobs, 2, jobs, timeout_s=SPAWN_TIMEOUT_S)
    return dict(zip(("kernel", "grad", "loss", "prefill", "serve"),
                    zip(*out)), grad_in=(gx, gw))


@pytest.fixture(scope="module")
def world4():
    return spawn(C.kernel_cases, 4, _kernel_inputs(),
                 timeout_s=SPAWN_TIMEOUT_S)


@pytest.fixture(scope="module")
def world2x2():
    return spawn(C.kernel_cases, 4, _kernel_inputs(), mesh_shape=(2, 2),
                 axes=("data", "model"), timeout_s=SPAWN_TIMEOUT_S)


def _check_kernel(ranks, r, mesh):
    """Each rank's tiles and outputs against the reference's."""
    inputs = _kernel_inputs()
    for c, (x, w) in enumerate(inputs):
        want = _ref_tp(x, w, mesh)
        tiles = _ref_tiles(x, w, r)
        for rank in ranks:
            got = rank["cases"][c]
            i, j, n_dp = got["where"]
            m = int(np.prod(x.shape[:-1]))
            rows = slice(j * m // n_dp, (j + 1) * m // n_dp) \
                if m % n_dp == 0 else slice(None)
            assert len(got["accs"]) == 1
            np.testing.assert_array_equal(got["accs"][0], tiles[i][rows])
            np.testing.assert_array_equal(got["ref_accs"][i], tiles[i])
            np.testing.assert_array_equal(got["y"], want)
            np.testing.assert_array_equal(got["y"], got["quant"])
            np.testing.assert_array_equal(got["y_ref"], want)


def test_tp_split_matches_param_placement():
    """The tile split follows the dim the reference's ``param_pspecs``
    shards (``tp_shard_dim``), as in the reference."""
    assert dpart.tp_shard_dim((64, 128), 8) == 1
    assert dpart.tp_shard_dim((128, 64), 8) == 0
    assert dpart.tp_shard_dim((64, 64), 8) == 1      # tie -> later (col)
    assert dpart.tp_shard_dim((60, 52), 8) == -1
    assert tp_split((64, 128), 8) == "col"
    assert tp_split((128, 64), 8) == "row"
    assert tp_split((60, 52), 8) == "col"            # pad fallback
    assert tp_tile_shape((64, 128), 8) == (64, 16)
    assert tp_tile_shape((128, 64), 8) == (16, 64)
    assert tp_tile_shape((60, 52), 8) == (60, 7)     # 52 -> 56 padded / 8
    for shape in [(k, n) for _, k, n in KERNEL_SHAPES] + [
            (1024, 1024), (1024, 2816), (2816, 1024), (7168, 4864),
            (4864, 7168), (6, 9)]:
        for r in (1, 2, 3, 4, 8):
            assert tp_split(shape, r) == r_tp_split(shape, r)
            assert tp_tile_shape(shape, r) == r_tp_tile_shape(shape, r)
    cfg = RC.get("qwen1.5-0.5b")
    from repro.kernels.quant_matmul.tp import tile_summary as r_summary
    assert tile_summary(cfg, 2) == r_summary(cfg, 2)


@pytest.mark.parametrize("r", [2, 4])
def test_kernel_bit_exact_vs_single_rank(world2, world4, r):
    """Every shape of the reference's list (column split, row split with
    the int32 sum, the N pad, odd K, one-block tiles), leading dims and
    8 rows: each rank's int32 tile equals the reference's tile of that
    rank, and the output equals the reference's ``tp_quant_linear`` and
    single-rank ``quant`` bit for bit."""
    ranks = world2["kernel"] if r == 2 else world4
    _check_kernel(ranks, r, _ref_mesh((r,), ("model",)))


def test_kernel_leading_batch_dims(world2):
    """(2, 3, 64) @ (64, 32): the result keeps the leading dims and equals
    the reference's on both ranks."""
    x, w = _kernel_inputs()[len(KERNEL_SHAPES)]
    want = _ref_tp(x, w, _ref_mesh((2,), ("model",)))
    assert want.shape == (2, 3, 32)
    for rank in world2["kernel"]:
        np.testing.assert_array_equal(rank["cases"][len(KERNEL_SHAPES)]["y"],
                                      want)


def test_without_mesh_degrades_to_quant_exactly():
    rng = np.random.default_rng(1)
    x, w = (torch.from_numpy(_rand(rng, 4, 16)),
            torch.from_numpy(_rand(rng, 16, 24)))
    assert torch.equal(tp_quant_linear(x, w), quant_linear(x, w))
    assert torch.equal(engine.get_backend("quant_tp")(x, w),
                       quant_linear(x, w))
    np.testing.assert_array_equal(
        tp_quant_linear(x, w).numpy(),
        np.asarray(r_tp_linear(jnp.asarray(x.numpy()),
                               jnp.asarray(w.numpy()))))


def test_data_model_mesh(world2x2):
    """On a (data = 2, model = 2) mesh the tile splits over "model" and
    the rows over "data" where they divide (each data rank's tile holds
    only its rows)."""
    _check_kernel(world2x2, 2, _ref_mesh((2, 2), ("data", "model")))
    # 8 rows split over data: each rank's (row-split) tile has 4 of them;
    # 5 rows do not split
    assert sorted(rank["cases"][-1]["where"][1:] for rank in world2x2) == \
        [(0, 2), (0, 2), (1, 2), (1, 2)]
    assert all(rank["cases"][-1]["accs"][0].shape == (4, 32)
               for rank in world2x2)
    assert all(rank["cases"][2]["accs"][0].shape[0] == 5
               for rank in world2x2)


def test_backend_kinds_guard_execute_state():
    """quant_tp is a linear-kind backend: the state-executor entry point
    rejects it instead of feeding microcode to a GEMM (both packages)."""
    assert engine.backend_kind("quant_tp") == "linear"
    assert r_engine.backend_kind("quant_tp") == "linear"
    assert engine.backend_kind("scan") == "state"
    with pytest.raises(ValueError, match="linear lowering"):
        engine.execute_state(torch.zeros((1, 8, 1), dtype=torch.int32),
                             np.zeros((2, 4), np.int32), backend="quant_tp")
    with pytest.raises(ValueError, match="unknown backend"):
        engine.backend_kind("does-not-exist")


def test_engine_registry_dispatch(world2):
    """The registry entry, ``linear``'s mode dispatch and the ambient mode
    land on the same tile, under the mesh, on every rank."""
    assert "quant_tp" in engine.MODES and "quant_tp" in engine.backends()
    for rank in world2["kernel"]:
        for got in rank["cases"]:
            for y in got["routes"]:
                np.testing.assert_array_equal(y, got["y"])


def test_grad_straight_through_under_mesh(world2):
    """The straight-through gradient on both ranks: within rtol 1e-5 of
    the reference's under its model = 2 mesh and of x.T @ 2y."""
    x, w = world2["grad_in"]

    def loss(w_):
        return jnp.sum(r_tp_linear(jnp.asarray(x), w_) ** 2)

    with r_dctx.use_mesh(_ref_mesh((2,), ("model",))):
        _, want = jax.jit(jax.value_and_grad(loss))(jnp.asarray(w))
    for grad, y in world2["grad"]:
        np.testing.assert_allclose(grad, np.asarray(want), rtol=1e-5)
        np.testing.assert_allclose(grad, x.T @ (2 * y), rtol=1e-5)


def test_trains_through_loss_fn(world2, small):
    """``pim_mode="quant_tp"`` through ``loss_fn`` and its gradients, on
    both ranks, against the reference's under its model = 2 mesh."""
    cfg_r = small["cfg_r"].scaled(n_layers=1, pattern=("ad",), loss_chunk=8,
                                  pim_mode="quant_tp")
    toks, labels = small["loss"]
    batch = {"tokens": jnp.asarray(toks, jnp.int32),
             "labels": jnp.asarray(labels, jnp.int32)}
    with r_dctx.use_mesh(_ref_mesh((2,), ("model",))):
        want_loss, want = jax.jit(jax.value_and_grad(
            lambda p: RM.loss_fn(p, batch, cfg_r)))(small["pr1"])
    want = dict(C._flat(jax.tree.map(np.asarray, want)))
    for loss, grads in world2["loss"]:
        assert np.isfinite(loss)
        assert abs(loss - float(want_loss)) <= LOSS_TOL
        assert set(grads) == set(want)
        gnorm = np.sqrt(sum(float((g.astype(np.float64) ** 2).sum())
                            for g in grads.values()))
        assert np.isfinite(gnorm) and gnorm > 0
        for k, g in grads.items():
            scale = max(float(np.abs(want[k]).max()), 1e-30)
            np.testing.assert_allclose(g, want[k], rtol=0,
                                       atol=GRAD_TOL * scale, err_msg=k)


def test_prefill_and_decode_match_quant(world2, small):
    """Prefill and one decode step in ``quant_tp`` at model = 2: bit for
    bit the port's ``quant`` (one kernel call per linear per rank), and
    within 1e-4 of the reference's ``quant_tp`` under its mesh."""
    ctp = small["cfg_r"].scaled(pim_mode="quant_tp")
    toks = small["toks"]
    batch = {"tokens": jnp.asarray(toks[:, :8], jnp.int32)}
    nxt = jnp.asarray(toks[:, 8:9], jnp.int32)
    with r_dctx.use_mesh(_ref_mesh((2,), ("model",))):
        lg_r, c_r = jax.jit(lambda p, b: RM.prefill(p, b, ctp))(small["pr"],
                                                                batch)
        _, d_r, _ = jax.jit(lambda p, t, c: RM.decode_step(
            p, t, jnp.int32(8), c, ctp))(small["pr"], nxt, c_r)
    for rank in world2["prefill"]:
        lg_q, d_q, n_q = rank["quant"]
        lg_t, d_t, n_t = rank["quant_tp"]
        np.testing.assert_array_equal(lg_t, lg_q)
        np.testing.assert_array_equal(d_t, d_q)
        assert n_t == n_q > 0
        for got, want in ((lg_t, lg_r), (d_t, d_r)):
            want = np.asarray(want)
            assert np.abs(got - want).max() < 1e-4 * np.abs(want).max()


@pytest.mark.parametrize("paged", [False, True])
def test_serving_matches_quant_both_pools(world2, small, paged):
    """Continuous batching at model = 2 with staggered arrivals on rank
    clocks 0.25 s apart (rank 0's clock decides arrivals): greedy tokens
    equal on both ranks and equal to the reference's ``quant_tp`` serve
    under its (data, model = 2) host mesh, one decode trace."""
    cfg_r = small["cfg_r"].scaled(pim_mode="quant_tp")
    mesh = _ref_mesh((4, 2), ("data", "model"))
    with r_dctx.use_mesh(mesh):
        s_r = RScheduler(small["pr"], cfg_r, RServingConfig(
            max_batch=2, prompt_bucket=8, paged=paged, block_size=8),
            mesh=mesh)
        rids = [s_r.submit(p, n) for p, n in PROMPTS]
        out_r = s_r.run()
    want = [np.asarray(out_r[r]).tolist() for r in rids]
    for rank in world2["serve"]:
        tokens, traces = rank[paged]
        assert tokens == want
        assert traces == 1
