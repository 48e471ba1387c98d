"""The ZeRO-3 trainer against the reference's mesh branch: the sharding-spec
factories (``repro_torch.dist.partitioning``) against
``repro.dist.partitioning``, ``replica_slices``, ``ElasticMesh`` over
gloo worlds of 1–4 CPU processes, and sharded train steps on the qwen and
granite-moe smoke configs against the reference's jitted
``value_and_grad`` + ``apply_updates`` under a mesh of the same shape.

Exact: every spec (compared as tuples), every ``replica_slices`` split and
error, every mesh shape, and each rank's first shards against the
``addressable_shards`` of the reference's ``param_pspecs(fsdp=True)``
params on the device at the same mesh position.  Tolerances (float32
smoke models in ``xla``; the two stacks sum in other orders, and GSPMD
splits the reference's products over the mesh): losses within
``LOSS_TOL`` = 1e-5, gradient norms within ``NORM_TOL`` = 1e-4 relative,
gathered parameters after each step within ``PARAM_TOL`` = 1e-5 of their
largest entry.  The elastic drill (checkpoint at world 2, resume at world
1 and at world 3, where ``--model-parallel 2`` degrades to 1) holds the
resumed losses within ``LOSS_TOL`` of the uninterrupted run's.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist_cases as C
import repro.configs as RC
import repro_torch.configs as TC
from repro.checkpoint import checkpoint as RCK
from repro.dist import context as r_dctx
from repro.dist import partitioning as RP
from repro.models import model_lib as RM
from repro.models.layers import as_shapes
from repro.optim import adamw as RA
from repro.runtime.fault_tolerance import ElasticMesh as RElastic
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.dist import partitioning as TP
from repro_torch.launch import train as t_train
from repro_torch.launch.mesh import spawn
from repro_torch.models import model_lib as TM
from repro_torch.optim import adamw as TA
from repro_torch.tree import leaves

LOSS_TOL = 1e-5
NORM_TOL = 1e-4
PARAM_TOL = 1e-5
SPAWN_TIMEOUT_S = 120.0
MESHES = {"data4_model2": (4, 2), "data2_model2": (2, 2),
          "pod2_data2_model2": (2, 2, 2)}
AXES = {2: ("data", "model"), 3: ("pod", "data", "model")}
STEPS = 2
BATCH, SEQ = 4, 16


def _fake_mesh(shape):
    names = AXES[len(shape)]
    return type("FakeMesh", (), {"axis_names": names,
                                 "shape": dict(zip(names, shape))})()


def _ref_mesh(shape):
    n = int(np.prod(shape))
    return jax.sharding.Mesh(np.array(jax.devices()[:n]).reshape(shape),
                             AXES[len(shape)])


def _ref_flat(tree):
    """path -> leaf of a reference tree (PartitionSpecs are leaves)."""
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    return {"/".join(str(getattr(k, "key", k)) for k in path): leaf
            for path, leaf in flat}


def _port_flat(tree):
    return {"/".join(path): leaf for path, leaf in leaves(tree)}


def _as_tuples(flat):
    return {k: tuple(v) for k, v in flat.items()}


# ---------------------------------------------------------------------------
# the spec factories and replica_slices
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", RC.ARCH_NAMES)
def test_specs_match_reference(arch, mesh_name):
    """``param_pspecs`` (fsdp on and off, tp on and off),
    ``opt_state_pspecs`` (plain and factored moments) and
    ``batch_pspecs`` on the full-width parameter tree equal the
    reference's."""
    shape = MESHES[mesh_name]
    rmesh, tmesh = _ref_mesh(shape), _fake_mesh(shape)
    pshapes = as_shapes(RM.param_specs(RC.get(arch)))
    tspecs = TM.param_specs(TC.get(arch))
    for fsdp in (False, True):
        for tp in (False, True):
            want = _as_tuples(_ref_flat(RP.param_pspecs(pshapes, rmesh,
                                                         fsdp=fsdp, tp=tp)))
            got = _port_flat(TP.param_pspecs(tspecs, tmesh, fsdp=fsdp,
                                             tp=tp))
            assert got == want, (fsdp, tp)
    r_part = RP.param_pspecs(pshapes, rmesh, fsdp=True)
    t_part = TP.param_pspecs(tspecs, tmesh, fsdp=True)
    t_params = _rebuild_meta(tspecs)
    for factored in (False, True):
        rcfg = RA.AdamWConfig(factored=factored)
        r_opt = jax.eval_shape(lambda: RA.init_state(rcfg, pshapes))
        want = _ref_flat(RP.opt_state_pspecs(pshapes, r_part, r_opt, rmesh))
        t_opt = TA.init_state(TA.AdamWConfig(factored=factored), t_params)
        got = _port_flat(TP.opt_state_pspecs(tspecs, t_part, t_opt, tmesh))
        assert got == _as_tuples(want), factored
    for b in (8, 6, 3, 1):
        batch = {"tokens": jax.ShapeDtypeStruct((b, 16), jnp.int32),
                 "labels": jax.ShapeDtypeStruct((b, 16), jnp.int32)}
        want = _as_tuples(_ref_flat(RP.batch_pspecs(batch, rmesh)))
        got = _port_flat(TP.batch_pspecs({k: (b, 16) for k in batch},
                                         tmesh))
        assert got == want, b


def _rebuild_meta(specs):
    from repro_torch.tree import rebuild

    return rebuild(specs, (torch.empty(shape, dtype=dt, device="meta")
                           for _, (shape, dt, _, _) in leaves(specs)))


def test_replica_slices_match_reference():
    for n_dev in (8, 6, 4, 1):
        devs = list(range(n_dev))
        for n in range(0, 10):
            try:
                want = RP.replica_slices(n, devs)
            except ValueError as e:
                with pytest.raises(ValueError, match=str(e)):
                    TP.replica_slices(n, devs)
                continue
            assert TP.replica_slices(n, devs) == want


def test_pspec_for_matches_reference():
    from repro_torch.dist import context as dctx

    rmesh, tmesh = _ref_mesh((2, 2, 2)), _fake_mesh((2, 2, 2))
    cases = [((8, 4), ("pod", "data")), ((6, 4), ("data",), "model"),
             ((4, 6, 8), None, "model", ("data", "model")), ((3,), "pod"),
             ((4,), ("pod", "data", "model"))]
    for shape, *entries in cases:
        want = tuple(r_dctx.pspec_for(rmesh, shape, *entries))
        assert dctx.pspec_for(tmesh, shape, *entries) == want
    with pytest.raises(ValueError, match="spec entries"):
        dctx.pspec_for(tmesh, (4,), "data", "model")


def _rank_mesh(shape, rank):
    """One rank of a ``Mesh`` of ``shape`` without a process group: the
    mesh arithmetic ``shard_leaf`` reads (axis sizes and indices)."""
    from repro_torch.dist.context import Mesh

    m = object.__new__(Mesh)
    m.axis_names = AXES[len(shape)]
    m.shape = dict(zip(m.axis_names, shape))
    m.size = int(np.prod(shape))
    m.rank = rank
    m.coords = dict(zip(m.axis_names, m._unravel(rank)))
    return m


@pytest.mark.parametrize("spec", [("data", None), (None, "model"),
                                  (("data", "model"), None),
                                  ("data", "model"), (None, None)])
def test_shard_leaf_owns_its_storage(spec):
    """A shard is a copy in storage of its own, so freeing the whole leaf
    frees it: a narrow of dim 0 alone is contiguous, and keeping that view
    would keep the whole leaf alive on every rank.  Each rank's shard is
    the block of its mesh coordinates."""
    from repro_torch.dist.zero import shard_leaf

    x = torch.arange(8 * 6, dtype=torch.float32).reshape(8, 6)
    blocks = []
    for rank in range(4):
        mesh = _rank_mesh((2, 2), rank)
        s = shard_leaf(x, spec, mesh)
        assert s.untyped_storage().data_ptr() != \
            x.untyped_storage().data_ptr()
        assert s.untyped_storage().nbytes() == s.numel() * s.element_size()
        assert s.is_contiguous()
        rows, cols = (slice(None),) * 2
        if spec[0] is not None:
            n = mesh.axis_size(spec[0])
            i = mesh.index(spec[0])
            rows = slice(i * 8 // n, (i + 1) * 8 // n)
        if spec[1] is not None:
            n = mesh.axis_size(spec[1])
            i = mesh.index(spec[1])
            cols = slice(i * 6 // n, (i + 1) * 6 // n)
        assert torch.equal(s, x[rows, cols])
        blocks.append(s)
    del x
    assert all(b.untyped_storage().nbytes() == b.numel() * 4 for b in blocks)


# ---------------------------------------------------------------------------
# ElasticMesh over gloo worlds
# ---------------------------------------------------------------------------

COMBOS = [(mp, pods) for mp in (1, 2, 4) for pods in (1, 2)]


@pytest.mark.parametrize("world", [1, 2, 3, 4])
def test_elastic_mesh_matches_reference(world):
    """``ElasticMesh(model_parallel, pods).make()`` over a spawned world
    of ``world`` ranks gives the reference's shape and axis names over as
    many of the host devices."""
    ranks = spawn(C.run_jobs, world, [("elastic_case", (COMBOS,))],
                  timeout_s=SPAWN_TIMEOUT_S)
    want = []
    for mp, pods in COMBOS:
        m = RElastic(mp, pods).make(jax.devices()[:world])
        want.append((dict(m.shape), tuple(m.axis_names)))
    for rank in ranks:
        assert rank[0] == want


# ---------------------------------------------------------------------------
# sharded train steps against the reference's mesh branch
# ---------------------------------------------------------------------------

def _batches(cfg, n=STEPS):
    data = SyntheticLM(cfg.vocab_size, SEQ, BATCH, seed=0)
    return [{k: v.astype(np.int64) for k, v in data.batch_at(s).items()}
            for s in range(n)]


@functools.lru_cache(maxsize=None)
def _reference_run(name, overrides, n, mp, opt_kw=()):
    """The reference's mesh branch as ``launch/train.py`` builds it:
    ``ElasticMesh(mp)`` over ``n`` devices, ZeRO-3 init under
    ``param_pspecs(fsdp=True)`` out-shardings, the AdamW state under
    ``opt_state_pspecs``, and ``STEPS`` jitted steps."""
    cfg = RC.get(name).smoke().scaled(**dict(overrides))
    mesh = RElastic(mp).make(jax.devices()[:n])
    ocfg = RA.AdamWConfig(warmup_steps=1, total_steps=STEPS, **dict(opt_kw))
    pshapes = as_shapes(RM.param_specs(cfg))
    p_part = RP.param_pspecs(pshapes, mesh, fsdp=True)
    params = jax.jit(lambda k: RM.init_params(cfg, k),
                     out_shardings=RP.tree_shardings(p_part, mesh))(
        jax.random.PRNGKey(0))
    o_part = RP.opt_state_pspecs(
        pshapes, p_part, jax.eval_shape(lambda: RA.init_state(ocfg, pshapes)),
        mesh)
    opt = jax.jit(lambda p: RA.init_state(ocfg, p),
                  out_shardings=RP.tree_shardings(o_part, mesh))(params)
    shards = {k: {s.device.id: np.asarray(s.data)
                  for s in leaf.addressable_shards}
              for k, leaf in _ref_flat(params).items()}
    params_np = jax.tree.map(np.asarray, params)

    def step(params, opt, batch):
        loss, grads = jax.value_and_grad(
            lambda p: RM.loss_fn(p, batch, cfg))(params)
        params, opt, metrics = RA.apply_updates(ocfg, params, grads, opt)
        return params, opt, loss, metrics

    out = []
    tcfg = TC.get(name).smoke().scaled(**dict(overrides))
    with r_dctx.use_mesh(mesh):
        fn = jax.jit(step)
        for b in _batches(tcfg):
            params, opt, loss, met = fn(params, opt, {
                k: jnp.asarray(v, jnp.int32) for k, v in b.items()})
            out.append(dict(loss=float(loss),
                            grad_norm=float(met["grad_norm"]),
                            params={k: np.asarray(v) for k, v
                                    in _ref_flat(params).items()}))
    return dict(mesh=dict(mesh.shape), shards=shards, params=params_np,
                steps=out)


def _check_zero3(name, overrides, n, mp, opt_kw=()):
    ref = _reference_run(name, tuple(sorted(overrides.items())), n, mp,
                         opt_kw)
    tcfg = TC.get(name).smoke().scaled(**overrides)
    ranks = spawn(C.run_jobs, n, [("zero3_case", (
        name, overrides, mp, ref["params"], _batches(tcfg), opt_kw))],
        timeout_s=SPAWN_TIMEOUT_S)
    for rank in ranks:
        res = rank[0]
        assert res["mesh"] == ref["mesh"]
        for k, shard in res["first"].items():
            want = ref["shards"][k][res["rank"]]
            assert shard.shape == want.shape, k
            np.testing.assert_array_equal(
                shard.view(np.uint16) if shard.dtype.itemsize == 2
                else shard, np.asarray(want).view(np.uint16)
                if want.dtype.itemsize == 2 else want, err_msg=k)
        for got, want in zip(res["steps"], ref["steps"]):
            assert abs(got["loss"] - want["loss"]) <= LOSS_TOL
            assert abs(got["grad_norm"] - want["grad_norm"]) <= \
                NORM_TOL * abs(want["grad_norm"])
            for k, p in got["params"].items():
                w = want["params"][k].astype(np.float32)
                np.testing.assert_allclose(
                    p.astype(np.float32), w, rtol=0,
                    atol=PARAM_TOL * max(1.0, float(np.abs(w).max())),
                    err_msg=k)
    # every rank reports the same global loss
    assert len({r[0]["steps"][-1]["loss"] for r in ranks}) == 1
    return ranks


def test_qwen_world2_data2_matches_reference():
    ranks = _check_zero3("qwen1.5-0.5b", {}, 2, 1)
    assert ranks[0][0]["mesh"] == {"pod": 1, "data": 2, "model": 1}
    # every leaf the data axis divides is held in halves
    assert any("data" in spec for spec in ranks[0][0]["specs"].values())


def test_qwen_world4_data2_model2_matches_reference():
    ranks = _check_zero3("qwen1.5-0.5b", {}, 4, 2)
    specs = ranks[0][0]["specs"].values()
    assert any("model" in s for s in specs) and any("data" in s
                                                    for s in specs)


def test_qwen_world4_factored_adamw_matches_reference():
    """Factored second moments on a ZeRO-3 tree at (data 2, model 2): each
    row and column mean spans the shards of its dim, averaged over the
    axes that shard it, and the steps equal the reference's."""
    ranks = _check_zero3("qwen1.5-0.5b", {}, 4, 2,
                         (("factored", True), ("factored_min_dim", 16)))
    specs = ranks[0][0]["specs"].values()
    assert any(len(s) >= 2 and s[-1] is not None for s in specs)
    assert any(len(s) >= 2 and s[-2] is not None for s in specs)


def test_granite_moe_fsdp_gather_matches_reference():
    """ZeRO-3 expert gathers at (data 2, model 2): each rank gathers only
    its 2 of the smoke config's 4 experts, and the steps equal the
    reference's shard_map branch (the reference's mesh has the port's
    shape: its capacity reads the local token count)."""
    _check_zero3("granite-moe-1b-a400m", {"moe_fsdp_gather": True}, 4, 2)


# ---------------------------------------------------------------------------
# the elastic drill through the CLI
# ---------------------------------------------------------------------------

DRILL = ["--smoke", "--device", "cpu", "--steps", "4", "--batch", "4",
         "--seq", "16", "--log-every", "1", "--ckpt-every", "2"]


def test_elastic_drill_resumes_at_smaller_and_ragged_worlds(tmp_path):
    """Checkpoint at world 2, then resume from step 2 at world 1 and at
    world 3 (``--model-parallel 2`` degrades to 1 there): both continue
    the uninterrupted run; the reference's ``restore_checkpoint`` reads
    the files."""
    full = str(tmp_path / "full")
    argv = DRILL + ["--ckpt-dir", full, "--model-parallel", "2"]
    ranks = spawn(C.run_jobs, 2, [("cli_case", ("train", argv))],
                  timeout_s=SPAWN_TIMEOUT_S)
    want, out = ranks[0][0]
    assert "[mesh] {'pod': 1, 'data': 1, 'model': 2}" in out
    assert ranks[1][0][0] == want and ranks[1][0][1] == ""
    import shutil

    for name in ("w1", "w3"):
        shutil.copytree(tmp_path / "full" / "step_00000002",
                        tmp_path / name / "step_00000002")
    tail = t_train.main(DRILL + ["--ckpt-dir", str(tmp_path / "w1"),
                                 "--resume"])
    np.testing.assert_allclose(tail, want[2:], rtol=0, atol=LOSS_TOL)
    ranks = spawn(C.run_jobs, 3, [("cli_case", ("train", DRILL + [
        "--ckpt-dir", str(tmp_path / "w3"), "--resume",
        "--model-parallel", "2"]))], timeout_s=SPAWN_TIMEOUT_S)
    tail3, out3 = ranks[0][0]
    assert "[mesh] {'pod': 1, 'data': 3, 'model': 1}" in out3
    assert "[resume] restored step 2" in out3
    np.testing.assert_allclose(tail3, want[2:], rtol=0, atol=LOSS_TOL)
    # the world-2 run's last checkpoint in the reference's reader
    cfg = RC.get("qwen1.5-0.5b").smoke()
    rparams = RM.init_params(cfg, jax.random.PRNGKey(0))
    like = {"p": rparams, "o": RA.init_state(
        RA.AdamWConfig(warmup_steps=5, total_steps=4), rparams)}
    tree, meta = RCK.restore_checkpoint(full, 4, like)
    assert meta == {"arch": cfg.name, "final": True}
    from repro_torch.checkpoint import checkpoint as TCK

    tlike = {"p": TM.init_params(TC.get("qwen1.5-0.5b").smoke(), 0, "cpu")}
    tlike["o"] = TA.init_state(TA.AdamWConfig(), tlike["p"])
    ttree, _ = TCK.restore_checkpoint(full, 4, tlike, device="cpu")
    rflat = _ref_flat(tree)
    for k, v in _port_flat(ttree).items():
        w = np.asarray(rflat[k])
        got = v.numpy() if v.dtype != torch.bfloat16 else \
            v.view(torch.int16).numpy().view(np.uint16)
        np.testing.assert_array_equal(
            got, w.view(np.uint16) if w.dtype.itemsize == 2
            and w.dtype != np.int16 else w, err_msg=k)
