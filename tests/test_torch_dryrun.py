"""``repro_torch.launch.dryrun`` and ``roofline`` against ``repro.launch``'s:
the cell matrix, the spec trees and their shard shapes, the collective
wire model, the model-FLOP arithmetic, and the port's own counts on fake
tensors (FLOPs against an analytic count, argument bytes against the
shards' sum, a full-width cell's run time).

The reference's meshes lie over the 8 forced host devices of
tests/conftest.py; the port's are ``VirtualMesh``es of the same shapes.
"""
import json
import math
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec

import repro.configs as RC
import repro_torch.configs as TC
from repro.dist import partitioning as rpart
from repro.launch import dryrun as rdry
from repro.launch import roofline as rroof
from repro.launch.mesh import make_mesh as r_make_mesh
from repro.models import model_lib as RM
from repro.models.config import SHAPES as R_SHAPES
from repro.models.config import ShapeSpec as RShapeSpec
from repro.models.layers import as_shapes as r_as_shapes
from repro.optim.adamw import init_state as r_init_state
from repro_torch.dist import partitioning as tpart
from repro_torch.dist.context import VirtualMesh
from repro_torch.launch import dryrun as tdry
from repro_torch.launch import roofline as troof
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import model_lib as TM
from repro_torch.models.config import SHAPES, ShapeSpec
from repro_torch.models.layers import as_shapes, materialize
from repro_torch.tree import leaves, rebuild

MESHES = {"4x2": ((4, 2), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
SMOKE = ("qwen1.5-0.5b", "granite-moe-1b-a400m", "jamba-v0.1-52b")


# --------------------------------------------------------------------------
# the cell matrix
# --------------------------------------------------------------------------

def test_assigned_cell_matrix():
    """The mirror of tests/test_arch_smoke.py's: 40 cells, the same 7
    long_500k skips with the same reasons, the same four shapes; the
    port's own configurations (granite-4.0-h-small, recurrent, so all four
    run) come after the reference's."""
    assert [(s.name, s.seq_len, s.global_batch, s.kind) for s in SHAPES] \
        == [(s.name, s.seq_len, s.global_batch, s.kind) for s in R_SHAPES]
    port_only = TC.ARCH_NAMES[len(RC.ARCH_NAMES):]
    assert port_only == ["granite-4.0-h-small"]
    assert all(TC.get(a).runnable(s) == (True, "") for a in port_only
               for s in SHAPES)
    got = [(a, s.name, TC.get(a).runnable(s))
           for a in TC.ARCH_NAMES[:len(RC.ARCH_NAMES)] for s in SHAPES]
    want = [(a, s.name, RC.get(a).runnable(s))
            for a in RC.ARCH_NAMES for s in R_SHAPES]
    assert len(got) == 40 and got == want
    assert sum(not ok for _, _, (ok, _) in got) == 7


def test_production_mesh_is_virtual():
    for mp, shape in ((False, {"data": 16, "model": 16}),
                      (True, {"pod": 2, "data": 16, "model": 16})):
        m = make_production_mesh(multi_pod=mp)
        assert m.shape == shape and m.virtual and m.rank == 0
        assert m.index("model") == 0 and m.axis_size("model") == 16
        assert m.group("model").ranks == tuple(range(16))
        assert m.slice_ranks("data") == list(range(0, 256, 16))


# --------------------------------------------------------------------------
# spec trees and shard shapes
# --------------------------------------------------------------------------

def _as_tuple(spec):
    return tuple(spec)


def _r_leaves(tree):
    return jax.tree.leaves(tree, is_leaf=lambda x: isinstance(
        x, (jax.ShapeDtypeStruct, PartitionSpec)))


def _cell_trees(name, mesh_key, kind):
    """Both packages' layouts of one smoke cell: (reference shapes,
    reference specs, port shapes, port specs) per tree."""
    shape, axes = MESHES[mesh_key]
    rmesh = r_make_mesh(shape, axes)
    vmesh = VirtualMesh(shape, axes)
    cfg_r, cfg_t = RC.get(name).smoke(), TC.get(name).smoke()
    sh = RShapeSpec("cell", 16, 8, kind)
    out = {}
    rp = r_as_shapes(RM.param_specs(cfg_r))
    tp = as_shapes(TM.param_specs(cfg_t))
    for fsdp in (False, True):
        out[f"params fsdp={fsdp}"] = (
            rp, rpart.param_pspecs(rp, rmesh, fsdp=fsdp),
            tp, tpart.param_pspecs(tp, vmesh, fsdp=fsdp))
    rpp = rpart.param_pspecs(rp, rmesh)
    tpp = tpart.param_pspecs(tp, vmesh)
    ocfg_r = rdry._opt_cfg(cfg_r)
    rost = jax.eval_shape(lambda: r_init_state(ocfg_r, rp))
    tost = tdry.init_state(tdry._opt_cfg(cfg_t), rebuild(tp, (
        torch.empty(shp, dtype=dt, device="meta")
        for _, (shp, dt) in leaves(tp))))
    out["opt"] = (rost, rpart.opt_state_pspecs(rp, rpp, rost, rmesh),
                  tdry._shape_tree(tost),
                  tpart.opt_state_pspecs(tp, tpp, tost, vmesh))
    rb = rdry.input_specs(cfg_r, sh)
    tb = tdry.input_specs(cfg_t, ShapeSpec("cell", 16, 8, kind))
    if kind != "decode":
        out["batch"] = (rb, rpart.batch_pspecs(rb, rmesh),
                        tb, tpart.batch_pspecs(tb, vmesh))
    rc = RM.cache_specs(cfg_r, 8, 16)
    tc = TM.cache_specs(cfg_t, 8, 16)
    for over in (True, False):
        out[f"caches batch_over_dp={over}"] = (
            rc, rpart.cache_pspecs(rc, rmesh, batch_over_dp=over),
            tc, tpart.cache_pspecs(tc, vmesh, batch_over_dp=over))
    return rmesh, vmesh, out


@pytest.mark.parametrize("mesh_key", list(MESHES))
@pytest.mark.parametrize("name", SMOKE)
def test_spec_trees_and_shard_shapes_match_reference(name, mesh_key):
    """Every leaf's spec equals the reference's ``PartitionSpec`` as a
    tuple, and its shard shape from ``tree_shardings`` equals
    ``NamedSharding(mesh, spec).shard_shape(shape)``: parameters (with and
    without ZeRO-3), AdamW state, the batch and the decode caches."""
    rmesh, vmesh, trees = _cell_trees(name, mesh_key, "train")
    for what, (rs, rsp, ts, tsp) in trees.items():
        r_sh = [tuple(s.shape) for s in _r_leaves(rs)]
        r_specs = [_as_tuple(p) for p in _r_leaves(rsp)]
        t_sh = [tpart.leaf_shape(s) for _, s in leaves(ts)]
        t_specs = [sp for _, sp in leaves(tsp)]
        assert t_sh == r_sh, what
        assert [tuple(e if not isinstance(e, list) else tuple(e)
                      for e in sp) for sp in t_specs] == r_specs, what
        shard = [s.shard_shape(shp) for shp, (_, s) in zip(
            t_sh, leaves(tpart.tree_shardings(tsp, vmesh)))]
        want = [NamedSharding(rmesh, p).shard_shape(shp)
                for shp, p in zip(r_sh, _r_leaves(rsp))]
        assert shard == want, what


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("name", SMOKE)
def test_argument_bytes_is_the_sum_of_the_shards(name, kind):
    """``lower_cell``'s argument bytes equal the sum, over parameters,
    AdamW state (train), batch and caches (decode), of the reference's
    shard shapes times the itemsize, exactly."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    shape, axes = MESHES["4x2"]
    rmesh, vmesh = r_make_mesh(shape, axes), VirtualMesh(shape, axes)
    cfg_r, cfg_t = RC.get(name).smoke(), TC.get(name).smoke()
    sh_r = RShapeSpec("cell", 16, 8, kind)
    with FakeTensorMode(allow_non_fake_inputs=True):
        _, _, got, _ = tdry.lower_cell(cfg_t, ShapeSpec("cell", 16, 8, kind),
                                       vmesh)

    def nbytes(tree, specs):
        return sum(math.prod(NamedSharding(rmesh, p).shard_shape(s.shape))
                   * jnp.dtype(s.dtype).itemsize
                   for s, p in zip(_r_leaves(tree), _r_leaves(specs)))

    rp = r_as_shapes(RM.param_specs(cfg_r))
    rpp = rpart.param_pspecs(rp, rmesh, fsdp=RM.param_count(cfg_r) > 3e9)
    want = nbytes(rp, rpp)
    if kind == "train":
        rost = jax.eval_shape(lambda: r_init_state(rdry._opt_cfg(cfg_r), rp))
        want += nbytes(rost, rpart.opt_state_pspecs(rp, rpp, rost, rmesh))
    if kind == "decode":
        rc = RM.cache_specs(cfg_r, 8, 16)
        want += nbytes(rc, rpart.cache_pspecs(rc, rmesh))
        tok = jax.ShapeDtypeStruct((8, 1), jnp.int32)
        want += nbytes({"t": tok}, {"t": PartitionSpec("data", None)})
    else:
        rb = rdry.input_specs(cfg_r, sh_r)
        want += nbytes(rb, rpart.batch_pspecs(rb, rmesh))
    assert got == want


# --------------------------------------------------------------------------
# counted FLOPs
# --------------------------------------------------------------------------

def test_prefill_flops_equal_an_analytic_count():
    """A small dense prefill cell on a (data 4, model 2) virtual mesh:
    ``FlopCounterMode``'s count is 2 M K N over every linear's int8 tile
    (M/4 rows, N or K halved), the attention scores and values over the
    whole batch, and the last position's unembed.  The reference's
    ``cost_analysis`` of its cell (GSPMD over 8 host devices) is printed
    beside it, with the ratio."""
    cfg_t = TC.get("qwen1.5-0.5b").smoke().scaled(n_layers=2)
    cfg_r = RC.get("qwen1.5-0.5b").smoke().scaled(n_layers=2)
    b, s = 8, 32
    vmesh = VirtualMesh((4, 2), ("data", "model"))
    r = tdry.run_cell("qwen-smoke", "p", False, cfg=cfg_t,
                      shape=ShapeSpec("p", s, b, "prefill"), mesh=vmesh)
    assert r["status"] == "ok", r.get("error")
    d, h, kv, hd, ff = (cfg_t.d_model, cfg_t.n_heads, cfg_t.n_kv_heads,
                        cfg_t.hd, cfg_t.d_ff)
    m_loc = b * s // 4
    linears = [(d, h * hd), (d, kv * hd), (d, kv * hd), (h * hd, d),
               (d, ff), (d, ff), (ff, d)]
    per_layer = sum(2 * m_loc * k * n // 2 for k, n in linears)
    per_layer += 2 * (2 * b * h * s * s * hd)          # scores and values
    want = cfg_t.n_layers * per_layer + 2 * b * d * cfg_t.padded_vocab
    assert r["flops_per_dev"] == want
    assert r["int_flops_per_dev"] == cfg_t.n_layers * sum(
        2 * m_loc * k * n // 2 for k, n in linears)
    from repro.dist import context as rdctx

    rmesh = r_make_mesh((4, 2), ("data", "model"))
    with rdctx.use_mesh(rmesh):
        fn, args = rdry.lower_cell(cfg_r, RShapeSpec("p", s, b, "prefill"),
                                   rmesh, unroll=True)
        ca = fn.lower(*args).compile().cost_analysis() or {}
    if isinstance(ca, list):
        ca = ca[0] if ca else {}
    ref = float(ca.get("flops", 0.0))
    print(f"[dryrun] prefill flops/dev: port {want:.4g}, reference "
          f"cost_analysis {ref:.4g}, ratio {want / max(ref, 1.0):.3f}")


# --------------------------------------------------------------------------
# the collective wire model
# --------------------------------------------------------------------------

CASES = [("all-reduce", "f32", 1024, 512, 256), ("all-reduce", "f32", 1024,
                                                  512, 512),
         ("all-reduce", "bf16", 4096, 16, None), ("all-gather", "bf16",
                                                  65536, 16, 8),
         ("all-gather", "f32", 4096, 8, 8), ("all-to-all", "bf16", 8192,
                                             32, 8),
         ("reduce-scatter", "f32", 256, 16, 8),
         ("collective-permute", "s32", 512, 2, None),
         ("all-reduce", "f32", 10, 1, 8), ("all-gather", "s8", 4096, 24, 8)]
_ITEM = {"f32": 4, "bf16": 2, "s32": 4, "s8": 1}


def _hlo(op, dt, n, g):
    return (f"  %r = {dt}[{n}]{{0}} {op}({dt}[{n}]{{0}} %p0), "
            f"replica_groups=[1,{g}]<=[{g}], to_apply=%add")


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_collective_mix_equals_parse_collectives(case):
    """The same (op, bytes, group, pod size) as an HLO line for the
    reference's ``parse_collectives`` and as a recorded call for the
    port's ``collective_mix``: equal wire and cross-pod bytes, and equal
    ``collective_time_s`` at equal bandwidths."""
    op, dt, n, g, pod = case
    want = rdry.parse_collectives(_hlo(op, dt, n, g), pod_size=pod)
    got = tdry.collective_mix([(op, n * _ITEM[dt], tuple(range(g)))],
                              pod_size=pod)
    assert set(got) == set(want)
    for k in want:
        assert got[k]["count"] == want[k]["count"]
        assert got[k]["wire_bytes"] == pytest.approx(want[k]["wire_bytes"],
                                                     rel=1e-12)
        assert got[k]["cross_pod_bytes"] == pytest.approx(
            want[k]["cross_pod_bytes"], rel=1e-12, abs=0.0)
    for bw in ((100.0, 25.0), (900.0, 50.0)):
        assert tdry.collective_time_s(got, intra_gbps=bw[0],
                                      inter_gbps=bw[1]) == pytest.approx(
            rdry.collective_time_s(want, intra_gbps=bw[0],
                                   inter_gbps=bw[1]), rel=1e-12)


def test_strided_group_crosses_every_node():
    """A data-axis group of a 16x16 mesh (ranks 0, 16, ..., 240) lies in
    16 nodes of 8: every hop of its ring crosses, where the reference's
    contiguous formula would count none."""
    m = make_production_mesh()
    ranks = m.slice_ranks("data")
    got = tdry.collective_mix([("all-gather", 1600, tuple(ranks))],
                              pod_size=tdry.POD_SIZE)["all-gather"]
    assert got["cross_pod_bytes"] == got["wire_bytes"] == 1500.0


def test_no_tpu_constant_remains():
    """The link and peak figures are the H100's; none of the reference's
    TPU figures (197 TFLOP/s, 819 GB/s, 50 GB/s ICI link, 100 / 25 GB/s
    ICI / DCN) is carried over."""
    assert (tdry.NVLINK_GBPS, tdry.SCALE_OUT_GBPS, tdry.POD_SIZE) == \
        (900.0, 50.0, 8)
    assert (troof.PEAK_FLOPS, troof.PEAK_INT8_OPS, troof.HBM_BW,
            troof.LINK_BW, troof.SCALE_OUT_BW) == (989.4e12, 1979e12,
                                                   3.35e12, 900e9, 50e9)
    for mod in (tdry, troof):
        src = open(mod.__file__).read()
        for tpu in ("197e12", "819e9", "INTRA_POD_GBPS", "INTER_POD_GBPS",
                    "= 100.0", "= 25.0"):
            assert tpu not in src, (mod.__name__, tpu)


# --------------------------------------------------------------------------
# the roofline
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", RC.ARCH_NAMES)
def test_model_flops_match_reference(name):
    cfg_r, cfg_t = RC.get(name), TC.get(name)
    assert troof.active_params(cfg_t) == rroof.active_params(cfg_r)
    for sh_t, sh_r in zip(SHAPES, R_SHAPES):
        tokens = sh_t.global_batch * sh_t.seq_len
        assert troof.recurrence_flops(cfg_t, tokens) == \
            rroof.recurrence_flops(cfg_r, tokens)
        assert troof.model_flops(cfg_t, sh_t) == rroof.model_flops(cfg_r,
                                                                   sh_r)


def test_analyze_and_render_differ_only_by_the_peaks(tmp_path, monkeypatch):
    """On the same result files, with the port's peaks set to the
    reference's, ``analyze``'s rows and ``render``'s table rows are the
    reference's (the advice text and the ratio's header aside)."""
    rng = np.random.default_rng(0)
    for i, arch in enumerate(RC.ARCH_NAMES[:6]):
        for j, sh in enumerate(SHAPES[:3]):
            cell = {"arch": arch, "shape": sh.name, "status": "ok",
                    "n_devices": 256,
                    "flops_per_dev": float(rng.integers(1, 10 ** 14)),
                    "bytes_per_dev": float(rng.integers(1, 10 ** 12)),
                    "wire_bytes_per_dev": float(rng.integers(0, 10 ** 10)),
                    "mem": {"argument_bytes": int(rng.integers(1, 10 ** 11)),
                            "temp_bytes": int(rng.integers(1, 10 ** 11))},
                    "collectives": {"all-gather": {"count": 1,
                                                   "wire_bytes": 1.0}}}
            if (i + j) % 4 == 3:
                cell = {"arch": arch, "shape": sh.name, "status": "error",
                        "error": "boom"}
            with open(tmp_path / f"{arch}__{sh.name}__single.json", "w") as f:
                json.dump(cell, f)
    monkeypatch.setattr(troof, "PEAK_FLOPS", rroof.PEAK_FLOPS)
    monkeypatch.setattr(troof, "HBM_BW", rroof.HBM_BW)
    monkeypatch.setattr(troof, "LINK_BW", rroof.LINK_BW)
    got, want = troof.analyze(str(tmp_path)), rroof.analyze(str(tmp_path))
    assert len(got) == len(want) == 18
    for g, w in zip(got, want):
        assert {k: v for k, v in g.items() if k != "advice"} == \
            {k: v for k, v in w.items() if k != "advice"}
    assert troof.render(got).splitlines()[2:] == \
        rroof.render(want).splitlines()[2:]


# --------------------------------------------------------------------------
# materialize, and a full-width cell
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", SMOKE)
def test_materialize_equals_init_params(name):
    cfg = TC.get(name).smoke()
    a = TM.init_params(cfg, 5, "cpu")
    b = materialize(TM.param_specs(cfg), 5, "cpu")
    assert [p for p, _ in leaves(a)] == [p for p, _ in leaves(b)]
    for (p, x), (_, y) in zip(leaves(a), leaves(b)):
        assert x.dtype == y.dtype and torch.equal(x, y), p
    stacked = TM._stack_specs({"w": TM._spec((3, 4), torch.float32, "ones",
                                             0.5)}, 7)
    assert tuple(stacked["w"]) == ((7, 3, 4), torch.float32, "ones", 0.5)


def test_full_width_decode_cell_within_a_minute():
    """qwen1.5-0.5b x decode_32k on rank 0 of the 16x16 virtual mesh, at
    full width, on fake tensors."""
    t0 = time.perf_counter()
    r = tdry.run_cell("qwen1.5-0.5b", "decode_32k", multi_pod=False)
    took = time.perf_counter() - t0
    assert r["status"] == "ok", r.get("error")
    assert took < 60.0, took
    cfg = TC.get("qwen1.5-0.5b")
    assert r["params"] == TM.param_count(cfg) == RM.param_count(
        RC.get("qwen1.5-0.5b"))
    assert r["mem"]["temp_pass"] == "deployable"
    assert r["flops_per_dev"] > r["int_flops_per_dev"] > 0
    # every linear's int8 tile: 24 layers x 7 linears, 8 rows of 128
    tiles = 24 * 2 * 8 * sum(k * n // 16 for k, n in (
        (1024, 1024), (1024, 1024), (1024, 1024), (1024, 1024),
        (1024, 2816), (1024, 2816), (2816, 1024)))
    assert r["int_flops_per_dev"] == tiles
    assert r["collectives"]["all-gather"]["count"] > 0
    print(f"[dryrun] {json.dumps({k: v for k, v in r.items() if k != 'collectives'})}"
          f" in {took:.1f} s")


def test_train_step_on_a_leaf_the_loss_never_reads():
    """arctic's ``"ar"`` block norms once for its MoE and its dense MLP, so
    its ``norm2`` is never read: the reference's ``jax.grad`` gives it a
    zero gradient, and the port's ``train_step`` must too (it raised in
    ``autograd.grad``; the dry run's arctic x train_4k cell found it).  A
    zero gradient leaves the leaf to weight decay alone."""
    from repro.models import model_lib as RMl
    from repro_torch.launch.train import train_step
    from repro_torch.optim.adamw import AdamWConfig, init_state

    cfg_r = RC.get("arctic-480b").smoke()
    cfg_t = TC.get("arctic-480b").smoke()
    pr = RMl.init_params(cfg_r, jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg_t.vocab_size, (2, 9))
    batch = {"tokens": toks[:, :8].astype(np.int32),
             "labels": toks[:, 1:].astype(np.int32)}
    grads = jax.grad(lambda p: RMl.loss_fn(p, {
        k: jnp.asarray(v) for k, v in batch.items()}, cfg_r))(pr)
    assert not np.asarray(grads["blocks"]["0"]["norm2"]).any()
    params = TM.from_reference(jax.tree.map(np.asarray, pr), cfg_t,
                               device="cpu")
    before = params["blocks"]["0"]["norm2"].clone()
    ocfg = AdamWConfig(warmup_steps=1, total_steps=1)
    params, _, loss, met = train_step(
        params, init_state(ocfg, params),
        {k: torch.from_numpy(v) for k, v in batch.items()}, cfg_t, ocfg)
    assert torch.isfinite(loss) and torch.isfinite(met["grad_norm"])
    lr = float(met["lr"])
    torch.testing.assert_close(params["blocks"]["0"]["norm2"],
                               before * (1 - lr * ocfg.weight_decay),
                               rtol=1e-6, atol=0)
