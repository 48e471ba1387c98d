"""``repro_torch.dist`` and the expert-parallel ``moe_ffn`` against the
reference's ``repro.dist`` and ``repro.models.moe`` — the context cases of
tests/test_dist.py, port side, and the MoE block's ``shard_map`` branch.

The port's meshes need a ``torch.distributed`` world, so every case runs
in gloo processes on the CPU started by ``repro_torch.launch.mesh.spawn``
(tests/_torch_dist_cases.py): one world of 2 ranks (model = 2) and one
of 4 (data = 2 x model = 2; the context cases build their other meshes
over the same 4 ranks, with ``("pod", "data", "model")`` at (1, 2, 2)
where the reference's test uses (2, 2, 2)).  The reference runs in this
process under meshes of the same shapes over the host devices.

Exact: axis resolution against the reference's for the same axis names,
the groups' ranks, the collectives' results, the MoE block's top-k
expert ids and every rank's capacity.  Tolerances: the MoE output within
``MOE_TOL`` = 1e-5 in float32 (both sum the same float32 partials in the
same order) and within ``MOE_BF16_TOL`` = 2**-6 of the largest entry in
bfloat16 (the experts' products round to bf16 in both; tests/
test_torch_moe.py's tolerances).
"""
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist_cases as C
import repro.configs as RC
from repro.dist import context as r_dctx
from repro.models import model_lib as RM
from repro.models import moe as r_moe
from repro_torch.dist import context as dctx
from repro_torch.launch.mesh import spawn

MOE_TOL = 1e-5
MOE_BF16_TOL = 2.0 ** -6
SPAWN_TIMEOUT_S = 90.0
MOE_NAMES = ("granite-moe-1b-a400m", "arctic-480b")
# (B, S): 18 tokens; 120, which overflow the capacity; 9, which the data
# axis does not divide
MOE_TOKENS = ((2, 9), (3, 40), (1, 9))


def _ref_mesh(shape, axes):
    n = int(np.prod(shape))
    return jax.sharding.Mesh(np.array(jax.devices()[:n]).reshape(shape),
                             axes)


@pytest.fixture(scope="module")
def layers_np():
    out = {}
    for name in MOE_NAMES:
        cfg = RC.get(name).smoke()
        pr = RM.init_params(cfg, jax.random.PRNGKey(5))
        out[name] = {k: np.asarray(pr["blocks"]["0"][k][0])
                     for k in ("router", "w1", "w2", "w3")}
    return out


def _moe_inputs(cfg, dtype):
    rng = np.random.default_rng(1)
    return [rng.standard_normal(t + (cfg.d_model,), dtype=np.float32)
            for t in MOE_TOKENS]


def _moe_jobs(layers_np, dtypes):
    jobs = []
    for name in MOE_NAMES:
        cfg = RC.get(name).smoke()
        for dtype in dtypes:
            jobs.append(("moe_case", (name, dtype, layers_np[name],
                                      _moe_inputs(cfg, dtype))))
    return jobs


@pytest.fixture(scope="module")
def world2(layers_np):
    return spawn(C.run_jobs, 2, _moe_jobs(layers_np, ("float32",
                                                      "bfloat16")),
                 timeout_s=SPAWN_TIMEOUT_S)


@pytest.fixture(scope="module")
def world2x2(layers_np):
    jobs = [("context_case", ())] + _moe_jobs(layers_np, ("float32",))
    cfg = RC.get("granite-moe-1b-a400m").smoke()
    jobs.append(("moe_zero3_case", (layers_np["granite-moe-1b-a400m"],
                                    *_zero3_inputs(cfg))))
    return spawn(C.run_jobs, 4, jobs, mesh_shape=(2, 2),
                 axes=("data", "model"), timeout_s=SPAWN_TIMEOUT_S)


# ---------------------------------------------------------------------------
# context
# ---------------------------------------------------------------------------

def test_no_mesh_is_total_noop(world2x2):
    assert dctx.current_mesh() is None
    assert dctx.dp_axes() == () and dctx.tp_axis() is None
    x = torch.ones(4, 4)
    assert dctx.shard(x, "data", "model") is x
    assert dctx.shard_batch_dim(x) is x
    for rank in world2x2:
        assert rank[0]["no_mesh"] == (True, (), None, True, True)


def test_use_mesh_nesting_restores_outer(world2x2):
    for rank in world2x2:
        assert rank[0]["nesting"] == [(True, ("data",), "model"),
                                      (True, ("data",), None),
                                      (True, ("data",), "model"), (True,)]


def _fake_mesh(**shape):
    """Axis names and sizes alone: all ``use_mesh`` and the axis rules
    read, so the test process needs no process group for them."""
    return type("FakeMesh", (), {"axis_names": tuple(shape),
                                 "shape": dict(shape)})()


def test_use_mesh_restores_on_exception(world2x2):
    with pytest.raises(RuntimeError):
        with dctx.use_mesh(_fake_mesh(data=2, model=2)):
            raise RuntimeError("boom")
    assert dctx.current_mesh() is None
    for rank in world2x2:
        assert rank[0]["restored"] is True


@pytest.mark.parametrize("axes", ["data", "model", "data,model",
                                  "pod,data,model"])
def test_axis_resolution(world2x2, axes):
    """The port's (dp axes, tp axis) equal the reference's for the same
    axis names; ``shard`` is the identity under every mesh."""
    names = tuple(axes.split(","))
    shape = {1: (8,), 2: (4, 2), 3: (2, 2, 2)}[len(names)]
    with r_dctx.use_mesh(_ref_mesh(shape, names)):
        want = (r_dctx.dp_axes(), r_dctx.tp_axis())
    for rank in world2x2:
        assert rank[0]["axes"][axes] == want + (True,)


def test_dp_axes_override_dp_only_policy(world2x2):
    mesh = _ref_mesh((2, 2, 2), ("pod", "data", "model"))
    with r_dctx.use_mesh(mesh, dp_axes=("pod", "data", "model")):
        want = (r_dctx.dp_axes(), r_dctx.tp_axis())
        other = _ref_mesh((4, 2), ("data", "model"))
        want_foreign = (r_dctx.mesh_axes(mesh), r_dctx.mesh_axes(other))
    for rank in world2x2:
        assert rank[0]["dp_only"] == want
        assert rank[0]["foreign"] == want_foreign
        assert "not in mesh axes" in rank[0]["bad_override"]


def test_normalize_drops_non_dividing_axes(world2x2):
    """Absent axes, size-1 axes and axes that do not divide the dim are
    dropped, as the reference's ``_normalize_entry`` drops them."""
    ref = r_dctx._normalize_entry
    m4 = _ref_mesh((4,), ("data",))
    m22 = _ref_mesh((2, 2), ("data", "model"))
    m122 = _ref_mesh((1, 2, 2), ("pod", "data", "model"))
    want = (ref(m4, 6, "data"), ref(m4, 8, "data"),
            ref(m22, 6, ("data", "model")), ref(m22, 8, ("data", "model")),
            ref(m122, 4, ("pod", "data")), ref(m22, 4, "nope"),
            ref(m22, 4, None))
    assert want == (None, "data", None, ("data", "model"), "data", None,
                    None)
    for rank in world2x2:
        assert rank[0]["normalize"] == want


def test_mesh_groups_and_collectives(world2x2):
    """Rank-major layout, "model" fastest: each slice's group gathers its
    ranks in order; sums, maxes and the broadcast reach every rank."""
    for rank in world2x2:
        r = rank[0]
        d, m = r["coords"]["data"], r["coords"]["model"]
        me = 2 * d + m
        assert r["groups"]["data"] == ([m, 2 + m], d, 2)
        assert r["groups"]["model"] == ([2 * d, 2 * d + 1], m, 2)
        assert r["groups"]["data,model"] == ([0, 1, 2, 3], me, 4)
        assert r["collectives"] == ([10], [float(2 * d + 1)], 10.0)


# ---------------------------------------------------------------------------
# the MoE block, expert-parallel
# ---------------------------------------------------------------------------

def _ref_moe_under(mesh, x, p, cfg):
    """The reference's ``moe_ffn`` under ``mesh`` (its shard_map branch,
    jitted: run op by op it takes seconds a call) and the capacity its
    expert loop got."""
    caps = []
    real = r_moe._local_moe

    def rec(*a, capacity, **kw):
        caps.append(capacity)
        return real(*a, capacity=capacity, **kw)

    with mock.patch.object(r_moe, "_local_moe", rec), \
            r_dctx.use_mesh(mesh):
        y = jax.jit(lambda a, q: r_moe.moe_ffn(a, q, cfg))(
            jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()})
    return np.asarray(y.astype(jnp.float32)), set(caps)


def _check_moe(ranks, first_job, dtypes, layers_np, ref_mesh, n_data):
    """Each rank's results of the ``moe_case`` jobs from ``first_job`` on
    (one per config and dtype, in ``_moe_jobs``' order) against the
    reference's under ``ref_mesh``."""
    j = first_job
    for name in MOE_NAMES:
        for dtype in dtypes:
            cfg = RC.get(name).smoke().scaled(dtype=dtype)
            p = dict(layers_np[name])
            if dtype == "bfloat16":
                p = {k: (v.astype(jnp.bfloat16) if k != "router" else v)
                     for k, v in p.items()}
            e_loc = cfg.n_experts // 2
            for c, x in enumerate(_moe_inputs(cfg, dtype)):
                xr = x.astype(jnp.bfloat16) if dtype == "bfloat16" else x
                want, caps = _ref_moe_under(ref_mesh, xr, p, cfg)
                t = int(np.prod(x.shape[:-1]))
                split = n_data if t % n_data == 0 else 1
                logits = (jnp.asarray(xr, jnp.float32).reshape(
                    t, cfg.d_model) @ jnp.asarray(p["router"], jnp.float32))
                ids = np.asarray(jax.lax.top_k(logits, cfg.top_k)[1])
                tol = MOE_TOL if dtype == "float32" else \
                    MOE_BF16_TOL * float(np.abs(want).max())
                for rank in ranks:
                    got = rank[j][c]
                    np.testing.assert_array_equal(got["ids"], ids)
                    np.testing.assert_allclose(got["y"], want, rtol=0,
                                               atol=tol)
                    (cap, _, t_loc), = got["loops"]
                    assert {cap} == caps
                    assert t_loc == t // split
                assert sorted(r[j][c]["loops"][0][1] for r in ranks) == \
                    sorted([0, e_loc] * (len(ranks) // 2))
            j += 1


def test_moe_expert_parallel_model2(world2, layers_np):
    """model = 2: each rank runs 2 of the smoke configs' 4 experts; ids,
    capacities and the psum'd output as the reference's shard_map branch,
    float32 and bfloat16, granite-moe and arctic."""
    _check_moe(world2, 0, ("float32", "bfloat16"), layers_np,
               _ref_mesh((2,), ("model",)), 1)


def test_moe_expert_parallel_data2_model2(world2x2, layers_np):
    """data = 2 x model = 2: tokens split over "data" when they divide (18
    and 120; 9 do not), capacity per data shard, as the reference's."""
    _check_moe(world2x2, 1, ("float32",), layers_np,
               _ref_mesh((2, 2), ("data", "model")), 2)


def test_moe_zero3_expert_gathers_match_reference(world2x2, layers_np):
    """ZeRO-3 expert gathers (``moe_fsdp_gather`` at data 2 x model 2): on
    a layer sharded under ``param_pspecs(fsdp=True)`` each rank gathers
    only its 2 of the smoke config's 4 experts; the output and each
    shard's gradient equal the reference's ``shard_map`` branch (its
    ``all_gather`` over ``"data"``, whose transpose is a reduce-scatter)
    and ``jax.grad``, sliced to the rank's shard.  The meshless branch
    ignores the flag, as the reference's does."""
    import repro_torch.configs as TC
    from repro_torch.models import moe as t_moe

    cfg = RC.get("granite-moe-1b-a400m").smoke().scaled(moe_fsdp_gather=True)
    p = layers_np["granite-moe-1b-a400m"]
    x, cot = _zero3_inputs(cfg)
    mesh = _ref_mesh((2, 2), ("data", "model"))

    def f(q):
        return jnp.sum(r_moe.moe_ffn(jnp.asarray(x), q, cfg)
                       * jnp.asarray(cot))

    with r_dctx.use_mesh(mesh):
        y = jax.jit(lambda q: r_moe.moe_ffn(jnp.asarray(x), q, cfg))(
            {k: jnp.asarray(v) for k, v in p.items()})
        g = jax.jit(jax.grad(f))({k: jnp.asarray(v) for k, v in p.items()})
    want_y = np.asarray(y)
    for rank in world2x2:
        got = rank[-1]
        np.testing.assert_allclose(got["y"], want_y, rtol=0, atol=MOE_TOL)
        assert got["gathers"] and {s[0] for s in got["gathers"]} == {2}
        d, m = got["coords"]["data"], got["coords"]["model"]
        idx = {"data": d, "model": m}
        for k, spec in got["specs"].items():
            want = np.asarray(g[k])
            for dim, entry in enumerate(spec[1:]):
                if entry is not None:
                    n = want.shape[dim] // 2
                    want = np.take(want, np.arange(idx[entry] * n,
                                                   (idx[entry] + 1) * n),
                                   axis=dim)
            np.testing.assert_allclose(got["grads"][k], want, rtol=0,
                                       atol=MOE_TOL * max(
                                           1.0, float(np.abs(want).max())),
                                       err_msg=k)
    tcfg = TC.get("granite-moe-1b-a400m").smoke().scaled(moe_fsdp_gather=True)
    q = {k: torch.from_numpy(np.array(v)) for k, v in p.items()}
    xt = torch.from_numpy(x)
    assert torch.equal(t_moe.moe_ffn(xt, q, tcfg),
                       t_moe.moe_ffn(xt, q, tcfg.scaled(
                           moe_fsdp_gather=False)))


def _zero3_inputs(cfg):
    rng = np.random.default_rng(11)
    return (rng.standard_normal((2, 9, cfg.d_model), dtype=np.float32),
            rng.standard_normal((2, 9, cfg.d_model), dtype=np.float32))
