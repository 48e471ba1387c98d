"""Trainer: data -> train step -> checkpoint/resume, on one device or
sharded (ZeRO-3) over a ``torch.distributed`` world.

Runs the registered arch at full width (or ``--smoke`` for the reduced
config, ``--preset tiny|20m|100m`` for small same-family sizes), with
every linear lowered per ``--pim-mode``: ``quant`` on the int8 GEMM
kernel, ``pim_sim`` on the crossbar microcode kernel (on transient state,
with a straight-through backward).  Fault tolerance: periodic atomic
checkpoints in the reference's format, auto-resume (``--resume``), and
stateless data indexing, so the token stream continues exactly where the
failed run left off; ``--fail-at-step`` injects a crash for the restart
drill.  Weights are random, drawn from ``--seed``; an encoder-decoder
or vision config is fed the stubs' frames or patches every step.  Runs on ``--device
cuda`` (the default; it raises without a card) or ``--device cpu`` with
the kernels' plain versions.

    PYTHONPATH=src python -m repro_torch.launch.train --pim-mode quant \\
        --steps 6 --batch 2 --seq 64 --layers 2 \\
        --ckpt-dir ckpt --ckpt-every 3 --fail-at-step 4
    PYTHONPATH=src python -m repro_torch.launch.train --pim-mode quant \\
        --steps 6 --batch 2 --seq 64 --layers 2 \\
        --ckpt-dir ckpt --ckpt-every 3 --resume

**The mesh branch.** Under ``torchrun`` with more than one rank
(``WORLD_SIZE``) the trainer joins the process group over gloo (ranks may
share one card, which NCCL refuses), builds the (pod, data, model) mesh
of ``ElasticMesh(--model-parallel)`` and prints ``[mesh]``; with one rank
``--model-parallel`` is ignored, as in the reference.  Under the mesh the
tree is ZeRO-3 sharded (:func:`init_sharded`): each leaf is drawn on the
device, the rank keeps its shard under ``param_pspecs(..., fsdp=True)``
and frees the whole leaf before the next is drawn, so the peak is the
sharded tree plus the largest leaf; the optimizer state is made on the
shards (its specs are ``opt_state_pspecs``).  Each step's loss takes the
rank's rows of the global batch (``batch_pspecs``; the batch is
replicated when it does not divide) and gathers each leaf where it is
read (``dist.zero.Gathered``).  Rank 0 writes the gathered whole tree
to the same files an unsharded run writes, which the reference's
``restore_checkpoint`` reads, and ``--resume`` reshards a checkpoint at
whatever world it finds, so a restart at a smaller or ragged world
continues the same run.  Rank 0 prints.

    PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.train \\
        --pim-mode quant --steps 3 --batch 4 --seq 64 --model-parallel 1

Differences from the reference's CLI: ``--layers`` also cuts the depth of
the arch config without ``--preset`` (the reference reads it only with
one); ``--device`` picks the device; ``--pim-mode quant_tp`` at one rank
is ``quant`` exactly.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
from typing import Any, Optional

import torch

from repro_torch import configs
from repro_torch.checkpoint.checkpoint import restore_checkpoint
from repro_torch.data.pipeline import AudioStub, SyntheticLM, VisionStub
from repro_torch.device import resolve_device
from repro_torch.dist import context as dctx
from repro_torch.dist import zero
from repro_torch.dist.partitioning import (batch_pspecs, opt_state_pspecs,
                                          param_pspecs)
from repro_torch.models import model_lib as M
from repro_torch.optim.adamw import AdamWConfig, apply_updates, init_state
from repro_torch.pim import engine
from repro_torch.runtime.fault_tolerance import (CheckpointManager,
                                                 ElasticMesh,
                                                 StragglerMonitor)
from repro_torch.tree import leaves, rebuild

__all__ = ["PRESETS", "build_cfg", "train_step", "init_sharded",
           "Sharding", "main"]

PRESETS = {
    # (d_model, n_layers_mult, heads, kv, d_ff) scaled same-family configs
    "tiny": dict(d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
                 vocab_size=512, pad_vocab_multiple=8),
    "20m": dict(d_model=256, n_heads=8, n_kv_heads=4, d_ff=1024,
                vocab_size=4096, pad_vocab_multiple=64),
    "100m": dict(d_model=640, n_heads=10, n_kv_heads=5, d_ff=2560,
                 vocab_size=8192, pad_vocab_multiple=64),
}


def build_cfg(args):
    cfg = configs.get(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    if args.preset:
        kw = dict(PRESETS[args.preset])
        kw.update(n_layers=max(len(cfg.pattern), args.layers or 4),
                  dtype="float32", remat=False, loss_chunk=1 << 30)
        if cfg.n_experts:
            kw.update(n_experts=8, top_k=2, moe_d_ff=kw["d_ff"] // 4)
        if cfg.n_encoder_layers:
            kw.update(n_encoder_layers=2)
        if cfg.vision_dim:
            kw.update(vision_dim=64, n_patches=16)
        if cfg.family == "ssm":
            kw.update(n_kv_heads=kw["n_heads"])
        cfg = cfg.scaled(**kw)
    elif args.layers:
        cfg = cfg.scaled(n_layers=args.layers)
    return cfg


@dataclasses.dataclass(frozen=True)
class Sharding:
    """A ZeRO-3 tree's layout: the mesh, the parameter specs
    (``param_pspecs(..., fsdp=True)``) and the optimizer state's
    (``opt_state_pspecs``)."""
    mesh: Any
    params: Any
    opt: Any


def train_step(params, opt_state, batch, cfg, ocfg: AdamWConfig,
               sharding: Optional[Sharding] = None):
    """One step: the loss and its gradients through ``model.loss_fn``,
    then AdamW in place.  Returns ``(params, opt_state, loss, metrics)``;
    ``loss`` and ``metrics`` (``lr``, ``grad_norm``) are device tensors.

    With ``sharding`` the trees hold this rank's shards and ``batch`` is
    the global batch (run under ``dist.context.use_mesh``): the loss
    gathers each leaf where it is read, the gradients come back as shards
    and AdamW updates the shards."""
    ps = [p.requires_grad_(True) for _, p in leaves(params)]
    loss = (M.loss_fn(params, batch, cfg) if sharding is None
            else _sharded_loss(params, batch, cfg, sharding))
    # a leaf the loss never reads (arctic's norm2: its "ar" block norms
    # once for the MoE and the dense MLP) gets zeros, as jax.grad gives
    grads = rebuild(params, torch.autograd.grad(loss, ps,
                                                materialize_grads=True))
    params, opt_state, metrics = apply_updates(
        ocfg, params, grads, opt_state,
        *(() if sharding is None else (sharding.params, sharding.mesh)))
    return params, opt_state, loss.detach(), metrics


def _sharded_loss(params, batch, cfg, sharding: Sharding):
    """The reference's global mean over the whole ``batch``, from this
    rank's rows (``batch_pspecs``; all of them when the batch does not
    divide) and a shard tree read through ``dist.zero.Gathered``: the
    rank's token-sum is divided by the world's token count (an
    ``all_reduce``), and the ranks' quotients add up to the mean, which is
    the value returned on every rank.  The gradient flows through the
    rank's own quotient; the gathers' backward sums the ranks'."""
    mesh = sharding.mesh
    if dctx.current_mesh() is not mesh:
        raise RuntimeError("a sharded step runs under its own mesh "
                           "(dist.context.use_mesh)")
    specs = batch_pspecs(batch, mesh)
    local = {k: zero.shard_leaf(v, specs[k], mesh) for k, v in batch.items()}
    row = specs["tokens"][0]
    axes = () if row is None else ((row,) if isinstance(row, str)
                                   else tuple(row))
    tree = zero.Gathered(params, sharding.params, mesh, row_axes=axes)
    nll, n_tok = M.nll_sum(tree, local, cfg)
    world = tuple(mesh.axis_names)
    count = dctx.all_reduce(torch.tensor([float(n_tok)], dtype=torch.float64,
                                         device=mesh.comm_device),
                            world, "sum", mesh)
    mine = nll / float(count[0])
    total = dctx.all_reduce(mine.detach().reshape(1).to(mesh.comm_device,
                                                        copy=True),
                            world, "sum", mesh).to(mine.device)[0]
    # the value is the global mean exactly; the gradient is this rank's
    return total.detach() + (mine - mine.detach())


def _whole_like(cfg, ocfg: AdamWConfig):
    """``{"p", "o"}`` of the whole tree as meta tensors: shapes and dtypes
    without storage."""
    p = rebuild(M.param_specs(cfg), (
        torch.empty(shape, dtype=dt, device="meta")
        for _, (shape, dt, _, _) in leaves(M.param_specs(cfg))))
    return {"p": p, "o": init_state(ocfg, p)}


def init_sharded(cfg, ocfg: AdamWConfig, seed: int, mesh, device):
    """ZeRO-3 init over ``mesh``: each leaf is drawn on ``device`` as
    ``init_params`` draws it, this rank keeps its shard under
    ``param_pspecs(..., fsdp=True)`` and the whole leaf is freed before
    the next is drawn; the AdamW state is made on the shards.  Returns
    ``(params, opt_state, Sharding)``."""
    pspecs = param_pspecs(M.param_specs(cfg), mesh, fsdp=True)
    spec_of = dict(leaves(pspecs))
    shards = []
    for path, t in M.draw_leaves(cfg, seed, device):
        shards.append(zero.shard_leaf(t, spec_of[path], mesh))
        del t
    params = rebuild(pspecs, shards)
    opt_state = init_state(ocfg, params)
    ospecs = opt_state_pspecs(M.param_specs(cfg), pspecs, opt_state, mesh)
    return params, opt_state, Sharding(mesh, pspecs, ospecs)


def restore_sharded(directory: str, step: int, cfg, ocfg: AdamWConfig,
                    sharding: Sharding, device):
    """A checkpoint of the whole tree (any world's) resharded onto this
    rank: read on the host, each leaf cut to its shard under
    ``sharding`` and moved to ``device``."""
    tree, meta = restore_checkpoint(directory, step, _whole_like(cfg, ocfg),
                                    device="cpu")
    specs = {"p": sharding.params, "o": sharding.opt}
    flat = [s for _, s in leaves(specs)]
    out = rebuild(tree, (zero.shard_leaf(x, s, sharding.mesh).to(device)
                         for (_, x), s in zip(leaves(tree), flat)))
    return out["p"], out["o"], meta


def _init_world(model_parallel: int):
    """The (pod, data, model) mesh over the process group ``torchrun``
    set up, or None with one rank."""
    if int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        return None
    import torch.distributed as dist

    if not dist.is_initialized():
        # gloo: ranks may share one card, which NCCL refuses
        dist.init_process_group("gloo")
    return ElasticMesh(model_parallel=model_parallel).make()


def _autotune_report(cfg, tokens: int, device) -> None:
    """For every 2-D leaf shape of the parameter tree (the reference's
    walk), what the partition autotuner's cost model would pick and what
    it predicts over the engine default; no timed trial."""
    from repro_torch.pim import autotune

    mode = cfg.pim_mode or "raw"
    found = sorted({tuple(shape) for _, (shape, *_)
                    in leaves(M.param_specs(cfg)) if len(shape) == 2})
    print(f"[autotune] cost-model report, {len(found)} linear shape(s) at "
          f"{tokens} tokens ({mode}):")
    for k_dim, o in found:
        plan = autotune.autotune(k_dim, 8, (tokens, o), mode, trials=0,
                                 device=device)
        dflt = autotune.default_plan(k_dim, 8, (tokens, o), mode,
                                     device=device)
        gain = dflt.predicted_us / max(plan.predicted_us, 1e-9)
        print(f"[autotune]   K={k_dim:5d} O={o:5d} -> model={plan.model} "
              f"n_cols={plan.n_cols} chunk={plan.chunk} ({gain:.2f}x vs "
              f"default predicted)")


def _dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(path, f))
               for f in os.listdir(path))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--preset", choices=list(PRESETS), default=None)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--fail-at-step", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--metrics-out", default=None)
    ap.add_argument("--model-parallel", type=int, default=1,
                    help="tensor-parallel degree on multi-rank runs "
                         "(degraded automatically if ranks don't divide)")
    ap.add_argument("--pim-mode", choices=list(engine.MODES), default=None,
                    help="repro_torch.pim.engine lowering for every linear "
                         "(threaded through ModelConfig.pim_mode): quant on "
                         "the int8 GEMM kernel, pim_sim on the crossbar "
                         "kernel with a straight-through backward; "
                         "quant_tp is quant without a mesh")
    ap.add_argument("--autotune", action="store_true",
                    help="before training, print the partition autotuner's "
                         "cost-model report for every linear shape in the "
                         "model (picked configuration vs the engine "
                         "default; no timed trials)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    # one rank skips the mesh; more get the largest valid (pod, data,
    # model) mesh over the world
    mesh = _init_world(args.model_parallel)
    device = resolve_device(args.device)
    if mesh is not None and device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0))
                              % torch.cuda.device_count())
        torch.cuda.set_device(device)
    with dctx.use_mesh(mesh) if mesh is not None else \
            contextlib.nullcontext():
        return _train(args, mesh, device)


def _train(args, mesh, device):
    rank0 = mesh is None or mesh.rank == 0
    say = print if rank0 else (lambda *a, **k: None)
    if mesh is not None:
        say(f"[mesh] {mesh.shape} over {mesh.size} ranks")
    cfg = build_cfg(args)
    if args.pim_mode:
        cfg = cfg.scaled(pim_mode=args.pim_mode)
    if args.autotune and rank0:
        _autotune_report(cfg, args.batch * args.seq, device)
    ocfg = AdamWConfig(lr_peak=args.lr, warmup_steps=max(args.steps // 20, 5),
                       total_steps=args.steps)
    data = SyntheticLM(cfg.vocab_size, args.seq, args.batch, seed=args.seed)
    # the stubs draw from their own default seed, as the reference's loop
    # calls them
    audio = AudioStub(cfg.d_model, args.seq // cfg.audio_frames_div) \
        if cfg.is_encoder_decoder else None
    vision = VisionStub(cfg.vision_dim, cfg.n_patches) if cfg.vision_dim \
        else None

    sharding = None
    if mesh is None:
        params = M.init_params(cfg, args.seed, device)
        opt_state = init_state(ocfg, params)
    else:
        params, opt_state, sharding = init_sharded(cfg, ocfg, args.seed,
                                                   mesh, device)
    start_step = 0
    manager = None
    if args.ckpt_dir:
        manager = CheckpointManager(args.ckpt_dir, every_steps=args.ckpt_every,
                                    device=device)
        if args.resume:
            if sharding is None:
                step, tree, _ = manager.resume({"p": params, "o": opt_state})
                if step is not None:
                    params, opt_state = tree["p"], tree["o"]
            else:
                from repro_torch.checkpoint.checkpoint import latest_step

                step = latest_step(args.ckpt_dir)
                if step is not None:
                    params, opt_state, _ = restore_sharded(
                        args.ckpt_dir, step, cfg, ocfg, sharding, device)
            if step is not None:
                start_step = step
                say(f"[resume] restored step {step}")

    def save(step, final=False):
        if not final and step % manager.every_steps:
            return
        t0 = time.perf_counter()
        meta = ({"arch": cfg.name, "final": True} if final else
                {"arch": cfg.name, "seq": args.seq, "batch": args.batch})
        tree = {"p": params, "o": opt_state}
        if sharding is not None:
            # every rank gathers (a collective); rank 0 writes the whole
            # tree to the files an unsharded run writes
            tree = zero.gather_tree(tree, {"p": sharding.params,
                                           "o": sharding.opt}, mesh,
                                    device="cpu")
            if not rank0:
                return
        path = manager.save(step, tree, metadata=meta)
        say(f"[ckpt] step {step}: {_dir_bytes(path)} bytes in "
            f"{time.perf_counter() - t0:.3f} s")

    monitor = StragglerMonitor()
    losses = []
    with contextlib.ExitStack() as stack:
        metrics_f = (stack.enter_context(open(args.metrics_out, "a"))
                     if args.metrics_out and rank0 else None)
        for step in range(start_step, args.steps):
            if args.fail_at_step is not None and step == args.fail_at_step:
                raise RuntimeError(f"injected failure at step {step}")
            t0 = time.time()
            batch = {k: torch.from_numpy(v).to(device=device,
                                               dtype=torch.long)
                     for k, v in data.batch_at(step).items()}
            if audio:
                batch["frames"] = torch.from_numpy(
                    audio.batch_at(step, args.batch)).to(device)
            if vision:
                batch["patches"] = torch.from_numpy(
                    vision.batch_at(step, args.batch)).to(device)
            extra = () if sharding is None else (sharding,)
            params, opt_state, loss, metrics = train_step(
                params, opt_state, batch, cfg, ocfg, *extra)
            loss = float(loss)
            losses.append(loss)
            dt = time.time() - t0
            slow = monitor.record(dt)
            if step % args.log_every == 0 or step == args.steps - 1:
                say(f"step {step:5d} loss {loss:.4f} "
                      f"lr {float(metrics['lr']):.2e} "
                      f"gnorm {float(metrics['grad_norm']):.2f} "
                      f"{dt*1e3:.0f}ms" + (" [straggler]" if slow else ""))
            if metrics_f:
                metrics_f.write(json.dumps({"step": step, "loss": loss,
                                            "dt_s": dt}) + "\n")
            if manager:
                save(step + 1)
    if manager:
        save(args.steps, final=True)
    if losses:
        say(f"final loss {losses[-1]:.4f} (first {losses[0]:.4f})")
    else:  # --resume on an already-finished run: nothing left to step
        say(f"nothing to do: resumed at step {start_step} of {args.steps}")
    return losses


if __name__ == "__main__":
    main()
