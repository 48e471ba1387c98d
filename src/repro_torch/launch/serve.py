"""Serving driver: a thin CLI over the ``repro_torch.serving`` runtime.

Replays a synthetic request trace through the continuous-batching
scheduler: a fixed ``--batch``-slot decode batch whose finished slots are
backfilled from the FIFO admission queue, prefill on admit (bucketed
prompts), a persistent KV-cache pool (``--paged`` for the block-paged
one; sliding-window architectures page unconditionally and serve as rings
over their block lists), and one batched decode step of fixed shape.
``--arch`` names any registered configuration: qwen1.5-0.5b (the
default), gemma-7b, granite-20b or h2o-danube-1.8b (sliding window).  ``--pim-mode`` threads
the linear lowering through the config: ``quant`` runs every linear on the
int8 GEMM kernel, ``pim_sim`` on the crossbar microcode kernel, whose
persistent sessions keep each weight's crossbar state resident on the card.
``--prefix-cache`` (implies paged) attaches the trie prefix index with
copy-on-write block sharing — pair it with ``--shared-prefix N`` to give
every synthetic prompt one N-token system prompt; ``--prefill-chunk N`` +
``--step-token-budget B`` interleave long-prompt prefill with decode
steps, and ``--packed-prefill`` batches short queued prompts into one
segment-masked prefill call; generations stay the tokens of whole
prefill.  ``--queue-policy sjf`` admits the shortest prompt first.
``--speculative`` turns on self-speculative decoding: ``--draft-mode``
(default ``quant``) drafts ``--draft-k - 1`` tokens per round and the
serving mode verifies the whole run in one step; greedy acceptance keeps
the tokens of plain decode, and the ``[spec]`` line echoes the measured
acceptance.
``--pim-mode quant_tp`` runs every linear in per-rank int8 tiles over the
mesh's ``"model"`` axis (``kernels.quant_matmul.tp``): start the CLI under
``torchrun --nproc-per-node R`` and it joins the process group torchrun
set up (over gloo: ranks may share one card, which NCCL refuses) and
builds the (pod, data, model) mesh of ``runtime.ElasticMesh`` with
``--model-parallel`` ranks on ``"model"``, halved until it divides the
world (the reference's rule); every rank serves the same trace, rank 0's
clock decides arrivals, and rank 0 prints.  Without a process group there
is no mesh and ``quant_tp`` is ``quant``.  The ``[tp]`` lines echo the
per-rank tiles.

**Multi-replica router** (``--replicas N``): instead of one scheduler,
``N`` independent engines — each its own KV pool and prefix trie, all on
the one device — behind one ``serving.Router`` that owns the global
admission queue (``--queue-policy``) and dispatches per request with
``--router-policy``: ``round_robin``, ``least_loaded`` or
``prefix_affinity``.  ``--kill-replica R:S`` kills replica ``R`` after
router step ``S``: its in-flight requests drain back to the front of the
global queue and it respawns; migrated requests restart from their
prompt, so the tokens are those of an undisturbed run.  The trace starts
at 0 on the fleet clock (a round costs its slowest replica), and the
``[router]`` line echoes the policy, per-replica tok/s, rebalanced
requests and restarts.  Without a process group a fleet builds no mesh:
every replica runs in this process.  Under ``torchrun`` (``WORLD_SIZE``
above 1) the fleet runs over the world's ranks: each replica takes
``world / N`` contiguous ranks as its own mesh, with ``--model-parallel``
ranks on its ``"model"`` axis (``quant_tp`` tiles over them), and world
rank 0 dispatches.
``--autotune`` switches the ``repro_torch.pim.autotune`` planner on: under
``pim_sim`` the scheduler's warmup plans every linear shape at the decode
batch bucket (partition model x crossbar geometry x chunking, scored by
the cost model, ``--autotune-trials`` timed trials of the top candidates
and the default on the device) and decode runs the picks;
``--autotune-table PATH`` is loaded before the scheduler warms up (if it
exists) and written back after the run, so the next run reloads the picks
instead of re-searching.  The ``[autotune]`` line echoes table size,
hit/miss/trial counters, and an example pick.  Under ``quant`` or
``quant_tp``, ``--autotune`` races the two int8 lowerings after the
serve instead (``autotune.autotune_linear`` at the decode batch and
``(d_model, d_model)``; every rank picks the same) and echoes the pick.
Weights are random, drawn from ``--seed``.  Runs on ``--device cuda``
(the default; it raises without a card) or ``--device cpu`` with the
kernels' plain versions, where ``--smoke`` keeps the model small.

    PYTHONPATH=src python -m repro_torch.launch.serve --pim-mode quant \\
        --batch 4 --requests 8 --prompt-lens 16,32,48,64 \\
        --max-new-tokens 16 --paged

    PYTHONPATH=src python -m repro_torch.launch.serve --pim-mode pim_sim \\
        --batch 2 --requests 2 --prompt-lens 16 --max-new-tokens 8 \\
        --paged --speculative --draft-mode quant --draft-k 3

    PYTHONPATH=src python -m repro_torch.launch.serve --pim-mode pim_sim \\
        --batch 2 --requests 2 --prompt-lens 16 --max-new-tokens 4 \\
        --paged --autotune --autotune-table picks.json

    PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.serve \\
        --pim-mode quant_tp --model-parallel 2 --batch 4 --requests 8 \\
        --prompt-lens 16,32,48,64 --max-new-tokens 16 --paged

    PYTHONPATH=src python -m repro_torch.launch.serve --pim-mode quant \\
        --batch 2 --requests 8 --prompt-lens 16,32 --max-new-tokens 8 \\
        --paged --replicas 2 --router-policy least_loaded --kill-replica 0:2

    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.serve \\
        --pim-mode quant_tp --replicas 2 --model-parallel 2 --batch 4 \\
        --requests 8 --prompt-lens 16,32,48,64 --max-new-tokens 16 \\
        --paged --kill-replica 0:2
"""
from __future__ import annotations

import argparse
import contextlib
import os
import time

import torch

from repro_torch import configs
from repro_torch.device import resolve_device
from repro_torch.dist import context as dctx
from repro_torch.models import model_lib as M
from repro_torch.pim import autotune, engine
from repro_torch.runtime.fault_tolerance import ElasticMesh
from repro_torch.serving import (FailurePlan, Router, RouterConfig, Scheduler,
                                 ServingConfig, synthetic_requests)
from repro_torch.serving.router import ROUTER_POLICIES


def serve_trace(params, cfg, requests, *, max_batch: int, prompt_bucket: int,
                paged: bool = False, block_size: int = 16,
                num_blocks=None, prefix_cache: bool = False,
                queue_policy: str = "fifo", prefill_chunk=None,
                step_token_budget=None, packed_prefill: bool = False,
                speculative: bool = False, draft_mode: str = "quant",
                draft_k: int = 4, autotune: bool = False,
                autotune_trials: int = 1, device="cuda"):
    """Run a request trace through the scheduler; returns (results,
    summary).  The summary adds the step counters ``decode_traces``,
    ``draft_traces``, ``verify_traces`` and ``verify_steps`` (speculative
    rounds; 0 without speculation)."""
    scfg = ServingConfig(max_batch=max_batch, prompt_bucket=prompt_bucket,
                         paged=paged, block_size=block_size,
                         num_blocks=num_blocks, prefix_cache=prefix_cache,
                         queue_policy=queue_policy,
                         prefill_chunk=prefill_chunk,
                         step_token_budget=step_token_budget,
                         packed_prefill=packed_prefill,
                         speculative=speculative, draft_mode=draft_mode,
                         draft_k=draft_k, autotune=autotune,
                         autotune_trials=autotune_trials)
    sched = Scheduler(params, cfg, scfg, device=device)
    for req in requests:
        sched.submit_request(req)
    results = sched.run()
    summary = sched.metrics.summary()
    summary["decode_traces"] = sched.decode_traces
    summary["draft_traces"] = sched.draft_traces
    summary["verify_traces"] = sched.verify_traces
    summary["verify_steps"] = sched.verify_steps
    return results, summary


def serve_fleet(params, cfg, requests, *, scfg: ServingConfig,
                rcfg: RouterConfig, devices=None, failure_plan=None,
                device="cuda"):
    """Run a trace through the multi-replica router on the fleet clock;
    returns (results, summary).  Request arrival times must be on the
    fleet clock (start at 0), not ``time.monotonic``.  ``devices``: None
    (every replica in this process on ``device``) or world ranks (the
    fleet over ranks; every rank calls this).  ``decode_traces`` counts
    this rank's live schedulers."""
    router = Router(params, cfg, scfg, rcfg, devices=devices,
                    failure_plan=failure_plan, device=device)
    for req in requests:
        router.submit_request(req)
    results = router.run()
    summary = router.metrics().summary()
    summary["decode_traces"] = sum(
        r.sched.decode_traces for r in router.replicas
        if r.alive and r.sched is not None)
    return results, summary


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b",
                    choices=configs.ARCH_NAMES)
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced same-family config (CPU runs)")
    ap.add_argument("--pim-mode", choices=list(engine.MODES), default=None,
                    help="linear lowering; quant_tp splits per-rank int8 "
                         "tiles over the mesh 'model' axis (run under "
                         "torchrun with --model-parallel > 1)")
    ap.add_argument("--model-parallel", type=int, default=1,
                    help="ranks on the mesh's 'model' axis (under torchrun)")
    ap.add_argument("--batch", type=int, default=4,
                    help="decode slots (continuous-batching batch size)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-lens", default="16,32,48,64",
                    help="comma-separated prompt lengths, cycled over the "
                         "requests")
    ap.add_argument("--max-new-tokens", type=int, default=16,
                    help="generation budget per request")
    ap.add_argument("--paged", action="store_true",
                    help="block-paged KV pool (admits reserve blocks from "
                         "a free list)")
    ap.add_argument("--block-size", type=int, default=16,
                    help="tokens per KV block (paged pool)")
    ap.add_argument("--num-blocks", type=int, default=None,
                    help="physical KV blocks (default: full parity with "
                         "the contiguous pool; smaller oversubscribes and "
                         "defers admissions under pressure)")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="trie prefix index over the paged pool with "
                         "refcounted copy-on-write block sharing; matched "
                         "prompt blocks skip prefill (implies --paged)")
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    help="split long-prompt prefill into chunks of this "
                         "many tokens interleaved with decode steps (a "
                         "--block-size multiple; implies --paged)")
    ap.add_argument("--step-token-budget", type=int, default=None,
                    help="max prefill tokens one scheduler step may "
                         "process (chunks + admissions)")
    ap.add_argument("--packed-prefill", action="store_true",
                    help="pack bursts of short queued prompts into one "
                         "segment-masked prefill call (implies --paged)")
    ap.add_argument("--speculative", action="store_true",
                    help="self-speculative decode: --draft-mode drafts "
                         "draft_k-1 tokens per round, the serving mode "
                         "verifies the run in one step; greedy acceptance "
                         "keeps the tokens of plain decode")
    ap.add_argument("--draft-mode", choices=list(engine.MODES),
                    default="quant",
                    help="cheap lowering for the draft pass; how many "
                         "drafts the serving mode accepts depends on the "
                         "pair (quant rounds to 8 bits, pim_sim to 7, xla "
                         "not at all) and is reported on the [spec] line")
    ap.add_argument("--draft-k", type=int, default=4,
                    help="verify width: tokens checked per verify step "
                         "(draft_k-1 drafted; 1 is plain decode)")
    ap.add_argument("--autotune", action="store_true",
                    help="plan crossbar GEMM configurations at warmup "
                         "(pim_sim: every linear shape at the decode batch "
                         "bucket) and decode with the tuned picks")
    ap.add_argument("--autotune-table", default=None, metavar="PATH",
                    help="tuning-table JSON: loaded before warmup if it "
                         "exists (warmup then hits instead of "
                         "re-searching) and written back after the run")
    ap.add_argument("--autotune-trials", type=int, default=1,
                    help="timed trials per raced candidate during warmup")
    ap.add_argument("--shared-prefix", type=int, default=0,
                    help="prepend one fixed N-token system prompt to every "
                         "synthetic request (the prefix-cache workload)")
    ap.add_argument("--queue-policy", choices=["fifo", "sjf"],
                    default="fifo",
                    help="admission order (sjf: shortest prompt first)")
    ap.add_argument("--replicas", type=int, default=1,
                    help="serving replicas behind the router, each with its "
                         "own KV pool and prefix trie (1: single scheduler, "
                         "no router)")
    ap.add_argument("--router-policy", choices=list(ROUTER_POLICIES),
                    default="least_loaded",
                    help="per-request dispatch policy (--replicas > 1)")
    ap.add_argument("--kill-replica", default=None, metavar="R:S",
                    help="inject a failure: kill replica R after router "
                         "step S (drain-and-requeue, then respawn)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    fleet_ranks = _fleet_ranks(args)
    mesh = (_mesh_from_env(args) if args.replicas <= 1 else None)
    device = resolve_device(args.device)
    if (mesh is not None or fleet_ranks) and device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0))
                              % torch.cuda.device_count())
        torch.cuda.set_device(device)
    with dctx.use_mesh(mesh) if mesh is not None else \
            contextlib.nullcontext():
        return _serve(args, mesh, device, fleet_ranks)


def _fleet_ranks(args):
    """The world's ranks for a fleet over ranks (``--replicas`` above 1
    under ``torchrun``), or None: a fleet in this process."""
    if args.replicas <= 1:
        return None
    if int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        if args.model_parallel > 1:
            raise ValueError(
                "--model-parallel above 1 with --replicas gives each "
                "replica a model axis over its own ranks: run under "
                "torchrun with --nproc-per-node replicas x model-parallel")
        return None
    import torch.distributed as dist

    if not dist.is_initialized():
        # gloo: ranks may share one card, which NCCL refuses
        dist.init_process_group("gloo")
    return list(range(dist.get_world_size()))


def _mesh_from_env(args):
    """The (pod, data, model) mesh of ``ElasticMesh(--model-parallel)``
    over the process group ``torchrun`` set up (``WORLD_SIZE`` in the
    environment), or None outside one."""
    if int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        return None
    import torch.distributed as dist

    if not dist.is_initialized():
        # gloo: ranks may share one card, which NCCL refuses
        dist.init_process_group("gloo")
    mesh = ElasticMesh(model_parallel=args.model_parallel).make()
    if mesh.rank == 0:
        print(f"[mesh] {mesh.shape} over {mesh.size} ranks "
              f"({dist.get_backend()})")
    return mesh


def _world_rank() -> int:
    import torch.distributed as dist

    return dist.get_rank()


def _start_time(mesh) -> float:
    """The trace's start on the scheduler's clock: rank 0's, under a mesh
    (the scheduler reads rank 0's clock there)."""
    if mesh is None:
        return time.monotonic()
    return dctx.broadcast_float(time.monotonic(), mesh)


def _serve(args, mesh, device, fleet_ranks=None):
    # rank 0 prints; every rank serves
    rank0 = ((mesh is None or mesh.rank == 0) and
             (fleet_ranks is None or _world_rank() == 0))
    say = print if rank0 else (lambda *a: None)
    # reload persisted tuner picks before any scheduler warms up: warmup
    # then *hits* the table (counted in [autotune]) instead of re-searching
    if args.autotune_table and os.path.exists(args.autotune_table):
        n = autotune.load_table(args.autotune_table, device=device)
        say(f"[autotune] loaded {n} plan(s) from {args.autotune_table}")
    if args.autotune:
        autotune.enable(True)
    cfg = configs.get(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    if args.pim_mode:
        cfg = cfg.scaled(pim_mode=args.pim_mode)
    plens = [int(p) for p in args.prompt_lens.split(",") if p]
    # right-size the cache pool: capacity = longest prompt + budget
    cfg = cfg.scaled(max_seq_len=args.shared_prefix + max(plens)
                     + args.max_new_tokens)
    params = M.init_params(cfg, args.seed, device)
    fleet = args.replicas > 1
    requests = synthetic_requests(
        args.requests, vocab_size=cfg.vocab_size, prompt_lens=plens,
        max_new_tokens=args.max_new_tokens, seed=args.seed,
        # the router's FleetClock starts at 0; the plain scheduler runs
        # on time.monotonic
        start_time=0.0 if fleet else _start_time(mesh),
        shared_prefix_len=args.shared_prefix)
    # recurrent blocks fold right-padding into their state: serve those
    # unbucketed (exact)
    bucket = 1 if cfg.has_recurrent_blocks else max(8, max(plens) // 4)
    knobs = dict(
        paged=args.paged, block_size=args.block_size,
        num_blocks=args.num_blocks, prefix_cache=args.prefix_cache,
        queue_policy=args.queue_policy, prefill_chunk=args.prefill_chunk,
        step_token_budget=args.step_token_budget,
        packed_prefill=args.packed_prefill, speculative=args.speculative,
        draft_mode=args.draft_mode, draft_k=args.draft_k,
        autotune=args.autotune, autotune_trials=args.autotune_trials)
    if fleet:
        plan = None
        if args.kill_replica:
            r, s = args.kill_replica.split(":")
            plan = FailurePlan(kill_replica=int(r), at_step=int(s))
        results, summary = serve_fleet(
            params, cfg, requests,
            scfg=ServingConfig(max_batch=args.batch, prompt_bucket=bucket,
                               **knobs),
            rcfg=RouterConfig(n_replicas=args.replicas,
                              policy=args.router_policy,
                              model_parallel=args.model_parallel),
            devices=fleet_ranks, failure_plan=plan, device=device)
    else:
        results, summary = serve_trace(
            params, cfg, requests, max_batch=args.batch,
            prompt_bucket=bucket, device=device, **knobs)
    say(f"served {summary['n_finished']}/{summary['n_requests']} "
        f"requests, {summary['total_tokens']} tokens @ "
        f"{summary['tokens_per_s']:.1f} tok/s "
        f"(batch {args.batch}, {summary['decode_traces']} decode "
        f"shapes, {device})")
    say(f"TTFT {summary['mean_ttft_s'] * 1e3:.0f}ms mean | "
        f"TPOT {summary['mean_tpot_s'] * 1e3:.1f}ms | "
        f"queue wait {summary['mean_queue_wait_s'] * 1e3:.0f}ms | "
        f"active slots {summary['mean_active_slots']:.1f}")
    paged = (args.paged or args.prefix_cache or args.packed_prefill
             or args.prefill_chunk is not None or cfg.sliding_window)
    if paged:
        say(f"[pool] peak KV {summary['peak_kv_bytes'] / 1e6:.2f}MB "
            f"(peak {summary['peak_pool_blocks']:.0f} blocks, "
            f"occupancy {summary['mean_block_occupancy'] * 100:.0f}%, "
            f"internal frag {summary['mean_internal_frag'] * 100:.0f}%, "
            f"{summary['deferred_admits']} deferred admits)")
    if args.prefix_cache:
        say(f"[prefix] hit rate {summary['prefix_hit_rate'] * 100:.0f}% "
            f"| {summary['prefix_tokens_reused']:.0f} prompt tokens "
            f"served from the index | TTFT hit "
            f"{summary['mean_ttft_hit_s'] * 1e3:.0f}ms vs miss "
            f"{summary['mean_ttft_miss_s'] * 1e3:.0f}ms | "
            f"{summary['peak_blocks_shared']:.0f} blocks shared, "
            f"{summary['cow_copies']:.0f} COW copies")
    if (args.prefill_chunk or args.step_token_budget
            or args.packed_prefill):
        say(f"[chunked] p99 TPOT {summary['p99_tpot_s'] * 1e3:.1f}ms | "
            f"{summary['prefill_chunks']} prefill chunks, "
            f"{summary['packed_prefills']} packed prefills (chunk "
            f"{args.prefill_chunk}, budget {args.step_token_budget})")
    if fleet:
        per = ", ".join(f"r{r}: {v:.1f}" for r, v in
                        sorted(summary["per_replica_tok_s"].items()))
        say(f"[router] {summary['router_policy']} over {args.replicas} "
            f"replicas | per-replica tok/s {{{per}}} | "
            f"{summary['rebalanced_requests']} rebalanced, "
            f"{summary['replica_restarts']} restarts | queue "
            f"{args.queue_policy}, p50 wait "
            f"{summary['p50_queue_wait_s'] * 1e3:.0f}ms")
    if args.speculative and summary.get("spec_rounds", 0):
        say(f"[spec] draft {args.draft_mode} k={args.draft_k}: "
            f"{summary['accepted_tokens']}/{summary['verified_tokens']} "
            f"verified tokens accepted ({summary['drafted_tokens']} "
            f"drafted) | mean accept len "
            f"{summary['mean_accept_len']:.2f} | accept len histogram "
            f"{summary['accept_len_hist']} | "
            f"{summary['accepted_per_step']:.2f} tok/verify step | "
            f"{summary.get('verify_steps', 0)} verify steps")
    if args.pim_mode == "pim_sim":
        info = engine.cache_info()
        say(f"[pim] crossbar uploads {info.exec_uploads}, "
            f"weight-stationary session hits {info.exec_hits}, "
            f"transient (prefill) states {info.exec_transient}, "
            f"resident {info.resident_entries} states "
            f"({info.resident_bytes / 2 ** 20:.1f} MiB)")
    if args.autotune and args.pim_mode in ("quant", "quant_tp"):
        # the crossbar tuner has nothing to plan here; race the two int8
        # linear lowerings instead (bit-identical, so a speed pick)
        p = autotune.autotune_linear(args.batch, cfg.d_model, cfg.d_model,
                                     trials=args.autotune_trials,
                                     device=device)
        say(f"[autotune] {p.key}: {p.model} "
            + ", ".join(f"{c.model} {c.trial_us:.1f} us" for c in p.race))
    if args.autotune or args.autotune_table:
        say(f"[autotune] {autotune.summary()}")
    if args.autotune_table and rank0:
        n = autotune.save_table(args.autotune_table)
        say(f"[autotune] saved {n} plan(s) to {args.autotune_table}")
    if args.pim_mode == "quant_tp":
        from repro_torch.kernels.quant_matmul.tp import tile_summary

        r = mesh.shape.get("model", 1) if mesh is not None else 1
        if fleet_ranks:
            r = ElasticMesh(args.model_parallel).shape(
                len(fleet_ranks) // args.replicas)[2]
        if r > 1:
            for line in tile_summary(cfg, r):
                say(f"[tp] {line} x{r} ranks")
        else:
            say("[tp] model axis is 1: quant_tp fell back to single-rank "
                "quant (run under torchrun with --model-parallel > 1)")
    rid0 = min(results)
    say("sample generation:", results[rid0][:16].tolist())
    return results


if __name__ == "__main__":
    main()
