"""Per-rank cases of the port's multi-rank parity tests.

``tests/test_torch_tp.py`` and ``tests/test_torch_dist.py`` run these
through ``repro_torch.launch.mesh.spawn``: each function runs on every
rank of a gloo group of CPU processes, takes the rank's mesh and numpy
inputs, and returns numpy (or plain Python) for the test process to hold
against the reference.  This module imports torch and the port only, so
a spawned rank never loads jax.
"""
import contextlib
import time
from unittest import mock

import torch

from repro_torch import configs as TC
from repro_torch.dist import context as dctx
from repro_torch.kernels.quant_matmul import ops as q_ops
from repro_torch.kernels.quant_matmul import tp
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import layers
from repro_torch.models import model_lib as TM
from repro_torch.models import moe as t_moe
from repro_torch.pim import engine
from repro_torch.serving import Scheduler, ServingConfig, make_request


def _recording_kernel():
    """``ops.quant_matmul_int`` patched to keep a copy of every output (a
    rank's int32 tile, before any collective touches it)."""
    real = q_ops.quant_matmul_int
    outs = []

    def rec(x, w):
        y = real(x, w)
        outs.append(y.clone().numpy())
        return y

    return mock.patch.object(q_ops, "quant_matmul_int", rec), outs


def _where(mesh):
    """This rank's (model index, data index over the data axes, data
    ranks)."""
    dp = dctx.mesh_axes(mesh)[0]
    return (mesh.index("model"), mesh.index(dp) if dp else 0,
            mesh.axis_size(dp) if dp else 1)


def kernel_cases(mesh, cases):
    """``tp_quant_linear`` under ``mesh`` on each (x, w), beside
    ``tp_quant_linear_ref``'s tiles, ``quant_linear`` and the registry's
    three dispatch routes."""
    out = []
    for x, w in cases:
        xt, wt = torch.from_numpy(x), torch.from_numpy(w)
        patch, accs = _recording_kernel()
        with patch, dctx.use_mesh(mesh):
            y = tp.tp_quant_linear(xt, wt)
        with dctx.use_mesh(mesh):
            reg = engine.get_backend("quant_tp")(xt, wt)
            lin = layers.linear(xt, wt, mode="quant_tp")
            with engine.mode("quant_tp"):
                amb = layers.linear(xt, wt)
        y_ref, ref_accs = tp.tp_quant_linear_ref(xt, wt, mesh.shape["model"])
        out.append(dict(y=y.numpy(), accs=accs, y_ref=y_ref.numpy(),
                        ref_accs=[a.numpy() for a in ref_accs],
                        quant=q_ops.quant_linear(xt, wt).numpy(),
                        routes=[reg.numpy(), lin.numpy(), amb.numpy()],
                        where=_where(mesh)))
    return dict(cases=out, counts=dict(dctx.counts))


def grad_case(mesh, x, w):
    """d/dw sum(tp_quant_linear(x, w) ** 2) under ``mesh``: (grad, y)."""
    xt = torch.from_numpy(x)
    wt = torch.from_numpy(w).requires_grad_(True)
    with dctx.use_mesh(mesh):
        y = tp.tp_quant_linear(xt, wt)
        (y ** 2).sum().backward()
    return wt.grad.numpy(), y.detach().numpy()


def _cfg(name, **kw):
    return TC.get(name).smoke().scaled(**kw)


def _flat(tree, prefix=()):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), v


def loss_case(mesh, params_np, tokens, labels):
    """``loss_fn`` of a 1-layer smoke qwen in ``quant_tp`` under ``mesh``,
    with every gradient leaf."""
    cfg = _cfg("qwen1.5-0.5b", n_layers=1, pattern=("ad",), loss_chunk=8,
               pim_mode="quant_tp")
    params = TM.from_reference(params_np, cfg, device="cpu")
    leaves = [v.requires_grad_(True) for _, v in _flat(params)]
    batch = {"tokens": torch.from_numpy(tokens),
             "labels": torch.from_numpy(labels)}
    with dctx.use_mesh(mesh):
        loss = TM.loss_fn(params, batch, cfg)
        grads = torch.autograd.grad(loss, leaves)
    return float(loss), {k: g.numpy() for (k, _), g in
                         zip(_flat(params), grads)}


def prefill_decode_case(mesh, params_np, tokens, nxt):
    """Prefill logits and one decode step's logits of the smoke qwen in
    ``quant_tp`` under ``mesh`` and in ``quant`` without it; and how many
    GEMMs each ran."""
    cfg_q = _cfg("qwen1.5-0.5b", pim_mode="quant")
    params = TM.from_reference(params_np, cfg_q, device="cpu")
    out = {}
    for mode, ctx in (("quant", None), ("quant_tp", mesh)):
        cfg = cfg_q.scaled(pim_mode=mode)
        patch, accs = _recording_kernel()
        with patch, (dctx.use_mesh(ctx) if ctx
                      else contextlib.nullcontext()):
            lg, cache = TM.prefill(params, {"tokens": torch.from_numpy(
                tokens)}, cfg)
            _, d, _ = TM.decode_step(params, torch.from_numpy(nxt),
                                     tokens.shape[1], cache, cfg)
        out[mode] = (lg.numpy(), d.numpy(), len(accs))
    return out


def serve_case(mesh, params_np, prompts, offsets, skew):
    """The smoke qwen served in ``quant_tp`` under ``mesh``, contiguous
    and paged, requests arriving ``offsets`` seconds after the start on a
    clock that runs ``skew * rank`` seconds ahead on each rank.  Returns
    each pool's tokens in submission order and its decode trace count."""
    cfg = _cfg("qwen1.5-0.5b", pim_mode="quant_tp")
    params = TM.from_reference(params_np, cfg, device="cpu")
    ahead = skew * mesh.rank

    def clock():
        return time.monotonic() + ahead

    out = {}
    for paged in (False, True):
        with dctx.use_mesh(mesh):
            sched = Scheduler(params, cfg, ServingConfig(
                max_batch=2, prompt_bucket=8, paged=paged, block_size=8),
                clock=clock, device="cpu")
            t0 = sched.clock()
            rids = [sched.submit_request(make_request(
                p, n, arrival_time=t0 + off))
                for (p, n), off in zip(prompts, offsets)]
            res = sched.run()
        out[paged] = ([res[r].tolist() for r in rids], sched.decode_traces)
    return out


def moe_case(mesh, name, dtype, layer_np, xs, dp_axes=None):
    """``moe_ffn`` on one smoke layer under ``mesh`` for each input of
    ``xs``: its output, the capacity and first expert each rank's expert
    loop got, and the top-k ids."""
    cfg = _cfg(name, dtype=dtype)
    cdt = cfg.compute_dtype
    p = {k: TM._from_numpy(v) for k, v in layer_np.items()}
    p = {k: (v.to(cdt) if k in ("w1", "w2", "w3") else v)
         for k, v in p.items()}
    real = t_moe._local_moe
    seen = []

    def rec(*a, capacity, e_base=0, **kw):
        seen.append((capacity, e_base, a[0].shape[0]))
        return real(*a, capacity=capacity, e_base=e_base, **kw)

    out = []
    for x in xs:
        seen.clear()
        xt = torch.from_numpy(x).to(cdt)
        with mock.patch.object(t_moe, "_local_moe", rec), \
                dctx.use_mesh(mesh, dp_axes=dp_axes):
            y = t_moe.moe_ffn(xt, p, cfg)
        _, ids = t_moe.router_top_k(xt.reshape(-1, cfg.d_model),
                                    p["router"], cfg.top_k)
        out.append(dict(y=y.float().numpy(), loops=list(seen),
                        ids=ids.numpy()))
    return out


def context_case(mesh):
    """The mesh context on a world of 4: nesting, restore on exception,
    axis resolution, the dp_axes override, dropped entries, foreign
    meshes; the groups' ranks; the collectives."""
    r = {}
    x = torch.ones(4, 4)
    r["no_mesh"] = (dctx.current_mesh() is None, dctx.dp_axes(),
                    dctx.tp_axis(), dctx.shard(x, "data", "model") is x,
                    dctx.shard_batch_dim(x) is x)
    meshes = {
        "data": make_mesh((4,), ("data",)),
        "model": make_mesh((4,), ("model",)),
        "data,model": make_mesh((2, 2), ("data", "model")),
        "pod,data,model": make_mesh((1, 2, 2), ("pod", "data", "model")),
    }
    outer, inner = meshes["data,model"], meshes["data"]
    nest = []
    with dctx.use_mesh(outer):
        nest.append((dctx.current_mesh() is outer, dctx.dp_axes(),
                     dctx.tp_axis()))
        with dctx.use_mesh(inner):
            nest.append((dctx.current_mesh() is inner, dctx.dp_axes(),
                         dctx.tp_axis()))
        nest.append((dctx.current_mesh() is outer, dctx.dp_axes(),
                     dctx.tp_axis()))
    nest.append((dctx.current_mesh() is None,))
    r["nesting"] = nest
    try:
        with dctx.use_mesh(outer):
            raise RuntimeError("boom")
    except RuntimeError:
        pass
    r["restored"] = dctx.current_mesh() is None
    r["axes"] = {}
    for key, m in meshes.items():
        with dctx.use_mesh(m):
            r["axes"][key] = (dctx.dp_axes(), dctx.tp_axis(),
                              dctx.shard(x) is x)
    pdm = meshes["pod,data,model"]
    with dctx.use_mesh(pdm, dp_axes=("pod", "data", "model")):
        r["dp_only"] = (dctx.dp_axes(), dctx.tp_axis())
        r["foreign"] = (dctx.mesh_axes(pdm), dctx.mesh_axes(outer))
    try:
        with dctx.use_mesh(pdm, dp_axes=("nope",)):
            pass
        r["bad_override"] = "no error"
    except ValueError as e:
        r["bad_override"] = str(e)
    nd = dctx._normalize_entry
    r["normalize"] = (nd(meshes["data"], 6, "data"),
                      nd(meshes["data"], 8, "data"),
                      nd(outer, 6, ("data", "model")),
                      nd(outer, 8, ("data", "model")),
                      nd(pdm, 4, ("pod", "data")),
                      nd(outer, 4, "nope"), nd(outer, 4, None))
    # every group of the (data, model) mesh: the ranks of this rank's
    # slice, gathered in the slice's order
    groups = {}
    for axes in (("data",), ("model",), ("data", "model")):
        me = torch.tensor([outer.rank])
        groups[",".join(axes)] = (
            dctx.all_gather(me, axes, mesh=outer).tolist(),
            outer.index(axes), outer.axis_size(axes))
    r["groups"] = groups
    r["coords"] = outer.coords
    s = torch.tensor([outer.rank + 1], dtype=torch.int32)
    m = torch.tensor([float(outer.rank)])
    r["collectives"] = (
        dctx.all_reduce(s, ("data", "model"), "sum", outer).tolist(),
        dctx.all_reduce(m, "model", "max", outer).tolist(),
        dctx.broadcast_float(10.0 + outer.rank, outer))
    return r


def run_jobs(mesh, jobs):
    """Each ``(name, args)`` of ``jobs`` run as ``name(mesh, *args)`` on
    this rank, in order: one spawn serves a whole test file's cases."""
    return [globals()[name](mesh, *args) for name, args in jobs]


# ---------------------------------------------------------------------------
# ElasticMesh, the ZeRO-3 trainer and the CLIs under a world
# (tests/test_torch_zero3.py, tests/test_torch_train_cli.py,
# tests/test_torch_router.py)
# ---------------------------------------------------------------------------

def elastic_case(mesh, combos):
    """``ElasticMesh(model_parallel, pods).make()`` over this world for
    each ``(model_parallel, pods)``: its shape and axis names."""
    from repro_torch.runtime.fault_tolerance import ElasticMesh

    out = []
    for mp, pods in combos:
        m = ElasticMesh(mp, pods).make()
        out.append((dict(m.shape), m.axis_names))
    return out


def zero3_case(mesh, name, overrides, model_parallel, params_np, batches,
               opt_kw=()):
    """The sharded trainer on one smoke config: the mesh of
    ``ElasticMesh(model_parallel)``, the reference's weights sharded under
    ``param_pspecs(..., fsdp=True)``, then one ``train_step`` per global
    batch of ``batches`` (AdamW with ``opt_kw`` besides).  Returns the
    mesh, this rank's first shards, and each step's loss, grad norm and
    gathered parameters."""
    from repro_torch.dist import zero
    from repro_torch.dist.partitioning import opt_state_pspecs, param_pspecs
    from repro_torch.launch.train import Sharding, train_step
    from repro_torch.optim.adamw import AdamWConfig, init_state
    from repro_torch.runtime.fault_tolerance import ElasticMesh

    cfg = _cfg(name, **overrides)
    m = ElasticMesh(model_parallel).make()
    whole = TM.from_reference(params_np, cfg, device="cpu")
    pspecs = param_pspecs(TM.param_specs(cfg), m, fsdp=True)
    params = zero.shard_tree(whole, pspecs, m)
    del whole
    first = {k: v.clone().numpy() for k, v in _flat(params)}
    ocfg = AdamWConfig(warmup_steps=1, total_steps=len(batches),
                       **dict(opt_kw))
    opt = init_state(ocfg, params)
    sharding = Sharding(m, pspecs, opt_state_pspecs(TM.param_specs(cfg),
                                                    pspecs, opt, m))
    steps = []
    with dctx.use_mesh(m):
        for b in batches:
            b = {k: torch.from_numpy(v) for k, v in b.items()}
            params, opt, loss, met = train_step(params, opt, b, cfg, ocfg,
                                                sharding)
            g = zero.gather_tree(params, pspecs, m)
            steps.append(dict(loss=float(loss),
                              grad_norm=float(met["grad_norm"]),
                              params={k: v.numpy() for k, v in _flat(g)}))
    return dict(mesh=dict(m.shape), rank=m.rank, first=first, steps=steps,
                specs={k: v for k, v in _flat(pspecs)})


def cli_case(mesh, module, argv):
    """``repro_torch.launch.<module>.main(argv)`` on this rank as if
    ``torchrun`` had started it (``WORLD_SIZE`` set; the group is the
    spawn's); returns the CLI's result and what it printed."""
    import io
    import os
    from contextlib import redirect_stdout

    import importlib

    import torch.distributed as dist

    os.environ["WORLD_SIZE"] = str(dist.get_world_size())
    os.environ["RANK"] = str(dist.get_rank())
    cli = importlib.import_module(f"repro_torch.launch.{module}")
    buf = io.StringIO()
    with redirect_stdout(buf):
        out = cli.main(argv)
    if isinstance(out, dict):
        out = {k: v.tolist() for k, v in out.items()}
    return out, buf.getvalue()


def moe_zero3_case(mesh, layer_np, x, cot):
    """``moe_ffn`` with ``moe_fsdp_gather`` on a ZeRO-3 sharded smoke
    layer of granite-moe under ``mesh``: the leaves stacked as one layer,
    sharded under ``param_pspecs(fsdp=True)`` and read through a
    ``Gathered`` layer view.  Returns the output, the shards' gradients
    of ``sum(y * cot) / world`` (each rank's contribution), the expert
    gathers' shapes and the specs."""
    from repro_torch.dist import zero
    from repro_torch.dist.partitioning import param_pspecs

    cfg = _cfg("granite-moe-1b-a400m", moe_fsdp_gather=True)
    whole = {k: TM._from_numpy(v)[None] for k, v in layer_np.items()}
    specs = param_pspecs(whole, mesh, fsdp=True)
    shards = zero.shard_tree(whole, specs, mesh)
    for v in shards.values():
        v.requires_grad_(True)
    seen = []
    real = t_moe.gather_experts

    def rec(*a, **k):
        y = real(*a, **k)
        seen.append(tuple(y.shape))
        return y

    with mock.patch.object(t_moe, "gather_experts", rec), \
            dctx.use_mesh(mesh):
        y = t_moe.moe_ffn(torch.from_numpy(x),
                          zero.Gathered(shards, specs, mesh).layer(0), cfg)
        loss = (y * torch.from_numpy(cot)).sum() / mesh.size
        names = sorted(shards)
        grads = torch.autograd.grad(loss, [shards[k] for k in names])
    return dict(y=y.detach().numpy(), gathers=seen, specs=specs,
                grads={k: g[0].numpy() for k, g in zip(names, grads)},
                coords=mesh.coords)


# ---------------------------------------------------------------------------
# the router over ranks (tests/test_torch_router.py)
# ---------------------------------------------------------------------------

class FakeClock:
    """Settable clock: router timing becomes exactly computable."""

    def __init__(self, t: float = 0.0):
        self.t = t

    def __call__(self) -> float:
        return self.t


def fleet_case(mesh, params_np, overrides, trace_kw, scfg_kw, rcfg_kw,
               plan_kw=None, kill_at=None, cli=False):
    """A fleet of the smoke qwen over every rank of this world
    (``Router(devices=range(world))``) on a fake clock, serving
    ``synthetic_requests(**trace_kw)``.  ``plan_kw`` makes a
    ``FailurePlan``; ``kill_at=(step, replica, lose)`` calls ``_kill``
    on every rank after that many rounds instead.  Returns, in submission
    order, each request's tokens, replica and migrations; each replica's
    ranks before and after; the router's counters and summary fields."""
    from repro_torch.serving import (FailurePlan, Router, RouterConfig,
                                     synthetic_requests)
    import torch.distributed as dist

    cfg = _cfg("qwen1.5-0.5b", **overrides)
    params = TM.from_reference(params_np, cfg, device="cpu")
    plan = FailurePlan(**plan_kw) if plan_kw else None
    router = Router(params, cfg, ServingConfig(**scfg_kw),
                    RouterConfig(**rcfg_kw),
                    devices=list(range(dist.get_world_size())),
                    clock=FakeClock(1.0), failure_plan=plan, device="cpu")
    before = [(list(r.ranks), dict(r.mesh.shape)) for r in router.replicas]
    reqs = synthetic_requests(vocab_size=cfg.vocab_size, **trace_kw)
    for r in reqs:
        router.submit_request(r)
    if kill_at is not None:
        step, rep, lose = kill_at
        for _ in range(step):
            router.step()
        router._kill(router.replicas[rep], lose_devices=lose)
    res = router.run()
    s = router.metrics().summary()
    return dict(
        tokens=[res[r.rid].tolist() for r in reqs],
        replica_ids=[r.replica_id for r in reqs],
        migrations=[r.n_migrations for r in reqs],
        before=before,
        after=[(list(r.ranks), dict(r.mesh.shape), r.alive)
               for r in router.replicas],
        member=[r.sched is not None for r in router.replicas],
        restarts=router.replica_restarts,
        rebalanced=router.rebalanced_requests, steps=router.step_count,
        summary={k: s[k] for k in ("router_policy", "rebalanced_requests",
                                   "replica_restarts", "n_finished",
                                   "n_requests", "total_tokens",
                                   "prefix_hit_rate")},
        per_replica=sorted(s["per_replica_tok_s"]),
        exchanges={k: dctx.counts[k]["calls"] for k in
                   ("world_broadcast", "world_gather") if k in dctx.counts})


def skip_group_case(mesh, params_np, skipper):
    """Two replicas of two ranks each; replica 0 is killed and respawned
    over the same ranks, but rank ``skipper`` (not in replica 0) builds
    none of its new groups; then replica 1 is killed and respawned.
    ``dist.new_group`` is collective over the world, so the skipper's
    group count lags and replica 1's respawn waits forever: this case
    must not return."""
    from types import SimpleNamespace

    from repro_torch.serving import Router, RouterConfig, router as rmod
    import torch.distributed as dist

    cfg = _cfg("qwen1.5-0.5b")
    params = TM.from_reference(params_np, cfg, device="cpu")
    router = Router(params, cfg, ServingConfig(max_batch=2, prompt_bucket=8),
                    RouterConfig(n_replicas=2),
                    devices=list(range(dist.get_world_size())),
                    clock=FakeClock(1.0), device="cpu")
    if dist.get_rank() == skipper:
        def no_groups(self, ranks=None):
            return SimpleNamespace(member=False, ranks=tuple(ranks),
                                   shape={})

        with mock.patch.object(rmod.ElasticMesh, "make", no_groups):
            router._kill(router.replicas[0])
    else:
        router._kill(router.replicas[0])
    router._kill(router.replicas[1])
    return "respawned"
