"""Serving driver: a thin CLI over the ``repro_torch.serving`` runtime.

Replays a synthetic request trace through the continuous-batching
scheduler: a fixed ``--batch``-slot decode batch whose finished slots are
backfilled from the FIFO admission queue, prefill on admit (bucketed
prompts), a persistent KV-cache pool (``--paged`` for the block-paged
one), and one batched decode step of fixed shape.  ``--pim-mode`` threads
the linear lowering through the config: ``quant`` runs every linear on the
int8 GEMM kernel, ``pim_sim`` on the crossbar microcode kernel, whose
persistent sessions keep each weight's crossbar state resident on the card.
Weights are random, drawn from ``--seed``.  Runs on ``--device cuda``
(the default; it raises without a card) or ``--device cpu`` with the
kernels' plain versions, where ``--smoke`` keeps the model small.

    PYTHONPATH=src python -m repro_torch.launch.serve --pim-mode quant \\
        --batch 4 --requests 8 --prompt-lens 16,32,48,64 \\
        --max-new-tokens 16 --paged
"""
from __future__ import annotations

import argparse
import time

from repro_torch import configs
from repro_torch.device import resolve_device
from repro_torch.models import model_lib as M
from repro_torch.pim import engine
from repro_torch.serving import Scheduler, ServingConfig, synthetic_requests


def serve_trace(params, cfg, requests, *, max_batch: int, prompt_bucket: int,
                paged: bool = False, device="cuda"):
    """Run a request trace through the scheduler; returns (results, summary)."""
    scfg = ServingConfig(max_batch=max_batch, prompt_bucket=prompt_bucket,
                         paged=paged)
    sched = Scheduler(params, cfg, scfg, device=device)
    for req in requests:
        sched.submit_request(req)
    results = sched.run()
    summary = sched.metrics.summary()
    summary["decode_traces"] = sched.decode_traces
    return results, summary


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b",
                    choices=configs.ARCH_NAMES)
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced same-family config (CPU runs)")
    ap.add_argument("--pim-mode", choices=list(engine.MODES), default=None,
                    help="linear lowering (quant_tp is not ported yet)")
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
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = configs.get(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    if args.pim_mode:
        cfg = cfg.scaled(pim_mode=args.pim_mode)
    plens = [int(p) for p in args.prompt_lens.split(",") if p]
    # right-size the cache pool: capacity = longest prompt + budget
    cfg = cfg.scaled(max_seq_len=max(plens) + args.max_new_tokens)
    params = M.init_params(cfg, args.seed, device)
    requests = synthetic_requests(
        args.requests, vocab_size=cfg.vocab_size, prompt_lens=plens,
        max_new_tokens=args.max_new_tokens, seed=args.seed,
        start_time=time.monotonic())
    bucket = max(8, max(plens) // 4)
    results, summary = serve_trace(params, cfg, requests,
                                   max_batch=args.batch, prompt_bucket=bucket,
                                   paged=args.paged, device=device)
    print(f"served {summary['n_finished']}/{summary['n_requests']} "
          f"requests, {summary['total_tokens']} tokens @ "
          f"{summary['tokens_per_s']:.1f} tok/s "
          f"(batch {args.batch}, {summary['decode_traces']} decode "
          f"shapes, {device})")
    print(f"TTFT {summary['mean_ttft_s'] * 1e3:.0f}ms mean | "
          f"TPOT {summary['mean_tpot_s'] * 1e3:.1f}ms | "
          f"queue wait {summary['mean_queue_wait_s'] * 1e3:.0f}ms | "
          f"active slots {summary['mean_active_slots']:.1f}")
    if args.paged:
        print(f"[pool] peak KV {summary['peak_kv_bytes'] / 1e6:.2f}MB "
              f"(peak {summary['peak_pool_blocks']:.0f} blocks, "
              f"occupancy {summary['mean_block_occupancy'] * 100:.0f}%, "
              f"internal frag {summary['mean_internal_frag'] * 100:.0f}%, "
              f"{summary['deferred_admits']} deferred admits)")
    if args.pim_mode == "pim_sim":
        info = engine.cache_info()
        print(f"[pim] crossbar uploads {info.exec_uploads}, "
              f"weight-stationary session hits {info.exec_hits}")
    rid0 = min(results)
    print("sample generation:", results[rid0][:16].tolist())
    return results


if __name__ == "__main__":
    main()
