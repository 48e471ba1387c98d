"""Trainer: data -> train step -> checkpoint/resume, on one device.

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

Differences from the reference's CLI: one device only, so
``--model-parallel`` above 1 raises (the trainer's mesh branch waits for
the sharded trainer, ROADMAP.md item D) and ``--pim-mode quant_tp`` trains
without a mesh, where it is ``quant`` exactly; ``--layers`` also cuts the
depth of the arch config without ``--preset`` (the reference reads it
only with one); ``--device`` picks the device.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import time

import torch

from repro_torch import configs
from repro_torch.data.pipeline import AudioStub, SyntheticLM, VisionStub
from repro_torch.device import resolve_device
from repro_torch.models import model_lib as M
from repro_torch.optim.adamw import AdamWConfig, apply_updates, init_state
from repro_torch.pim import engine
from repro_torch.runtime.fault_tolerance import (CheckpointManager,
                                                 StragglerMonitor)
from repro_torch.tree import leaves, rebuild

__all__ = ["PRESETS", "build_cfg", "train_step", "main"]

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


def train_step(params, opt_state, batch, cfg, ocfg: AdamWConfig):
    """One step: the loss and its gradients through ``model.loss_fn``,
    then AdamW in place.  Returns ``(params, opt_state, loss, metrics)``;
    ``loss`` and ``metrics`` (``lr``, ``grad_norm``) are device tensors."""
    ps = [p.requires_grad_(True) for _, p in leaves(params)]
    loss = M.loss_fn(params, batch, cfg)
    grads = rebuild(params, torch.autograd.grad(loss, ps))
    params, opt_state, metrics = apply_updates(ocfg, params, grads,
                                               opt_state)
    return params, opt_state, loss.detach(), metrics


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
                    help="tensor-parallel degree; only 1 is ported (the "
                         "mesh branch waits for the sharded trainer)")
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

    if args.model_parallel > 1:
        raise NotImplementedError(
            "--model-parallel > 1: the mesh branch of the trainer waits for "
            "the sharded trainer (ROADMAP.md section 1, item D)")
    device = resolve_device(args.device)
    cfg = build_cfg(args)
    if args.pim_mode:
        cfg = cfg.scaled(pim_mode=args.pim_mode)
    if args.autotune:
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

    params = M.init_params(cfg, args.seed, device)
    opt_state = init_state(ocfg, params)
    start_step = 0
    manager = None
    if args.ckpt_dir:
        manager = CheckpointManager(args.ckpt_dir, every_steps=args.ckpt_every,
                                    device=device)
        if args.resume:
            step, tree, _ = manager.resume({"p": params, "o": opt_state})
            if step is not None:
                params, opt_state = tree["p"], tree["o"]
                start_step = step
                print(f"[resume] restored step {step}")

    def save(step, final=False):
        t0 = time.perf_counter()
        meta = ({"arch": cfg.name, "final": True} if final else
                {"arch": cfg.name, "seq": args.seq, "batch": args.batch})
        tree = {"p": params, "o": opt_state}
        path = (manager.save(step, tree, metadata=meta) if final else
                manager.maybe_save(step, tree, metadata=meta))
        if path:
            print(f"[ckpt] step {step}: {_dir_bytes(path)} bytes in "
                  f"{time.perf_counter() - t0:.3f} s")

    monitor = StragglerMonitor()
    losses = []
    with contextlib.ExitStack() as stack:
        metrics_f = (stack.enter_context(open(args.metrics_out, "a"))
                     if args.metrics_out else None)
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
            params, opt_state, loss, metrics = train_step(params, opt_state,
                                                          batch, cfg, ocfg)
            loss = float(loss)
            losses.append(loss)
            dt = time.time() - t0
            slow = monitor.record(dt)
            if step % args.log_every == 0 or step == args.steps - 1:
                print(f"step {step:5d} loss {loss:.4f} "
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
        print(f"final loss {losses[-1]:.4f} (first {losses[0]:.4f})")
    else:  # --resume on an already-finished run: nothing left to step
        print(f"nothing to do: resumed at step {start_step} of {args.steps}")
    return losses


if __name__ == "__main__":
    main()
