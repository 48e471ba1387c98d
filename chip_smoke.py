"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Builds both CUDA kernels from the sources in this checkout, holds each one
against its plain PyTorch version on the card, then serves full-width
qwen1.5-0.5b (24 layers, d_model 1024, random weights from a seed) through
the port's continuous-batching scheduler in the two modes that run the
kernels: ``quant`` (every linear on the int8 GEMM kernel) and ``pim_sim``
(every linear on the crossbar microcode kernel).  Each serve phase zeroes
the kernels' launch counters just before it and reads them just after.

    python3 chip_smoke.py

The int8 GEMM kernel is held against its plain version at the path's
shapes, at ragged shapes, on extreme operands, at K and N off the split and
tile sizes, at unaligned pointers and in back-to-back calls (its split-K
arrival counters must come back to zero); one call must be one device
operation (the nodes of a CUDA graph captured around it; a torch.profiler
trace may show nothing else), and its times sit beside its bound, an empty
launch and torch._int_mm.  The crossbar kernel is also held against its
plain version on schedule edge cases (self-reads, a long RAW chain, a
level wider than a group) and on the packed states of the one launch each
decode-shape linear makes.
The ``pim_sim`` phase serves twice, and its tokens must equal each other
and those of the exact integer product; prefill runs on transient crossbar
state, and the second serve's decode steps must make no cold upload.

Then both modes serve through the prefix cache, chunked and packed
prefill.  ``quant`` serves one trace (four short prompts, then eight
requests sharing a 32-token system prompt) on the plain path and with
``prefix_cache``, ``prefill_chunk=32``, ``step_token_budget=64`` and
``packed_prefill``: the tokens must be equal, prefix hits, chunks and
packed prefills must occur, and one prompt's last-token logits from
whole, prefix-resumed, chunked and packed prefill must agree within
``PREFIX_LOGIT_TOL``; a fork in the paged pool must copy its shared
boundary block on write and leave the index's blocks unchanged.
``pim_sim`` serves three requests sharing a 16-token prefix through the
prefix cache and 16-token chunks, tokens held to the exact integer
product, then one 64-token prompt whose memory high-water mark must stay
below ``PIM_PEAK_BYTES``.

The ``pim_sim`` engine's bit-plane kernels (``check_pim_bits``): the writer
and the reader of ``kernels.pim_bits`` are held state for state to the
engine's plain packing and reading at jamba-v0.1's w_in and w_out decode
shapes and on llama-vision's xwk prefill (one launch piece of whole chunks,
one part of a chunk); four resident w_in decode steps through the engine
on the kernels equal the plain path's results and state; both kernels are
timed beside the plain path and their byte bounds.  ``serve_jamba`` holds
them to one x write and one read per linear a decode step (and one w write
in the step that uploads).

The paper's multipliers run on the crossbar kernel through the engine's
backend registry (``check_multipliers``): serial, serial_fast,
compressor42 (``engine.build_multiplier``) and MultPIM at n = 8, 16 and 32
over ``MULT_CROSSBARS`` crossbars of 1024 x 1024, every product exact and
the state of two crossbars equal to the per-gate plain version; each
program is timed.  Then both kernels serve through self-speculative
decoding: ``quant`` verifying ``xla`` drafts (draft_k 4) on the ``quant``
phase's trace, tokens equal to that phase's, and ``pim_sim`` verifying
``quant`` drafts (draft_k 3, max_batch 2) twice, tokens equal to a plain
``pim_sim`` serve held to the exact integer product, the second serve's
verify steps making no cold upload; each round must make one launch of
the verify mode's kernel per linear and, for a ``quant`` draft, one per
linear per draft step.  Last it profiles one decode step per mode and one
``pim_sim`` speculative round (torch.profiler) and prints its wall and
device-busy time and its costliest kernels; each step must make one
launch of its mode's kernel per linear.

Then the partition autotuner (``serve_pim_autotune``): a
``Scheduler(autotune=True)`` races the cost model's top partition models
and crossbar geometries (1024, 2048 and 4096 columns) and the default on
the crossbar kernel for each of the 5 weight shapes of the parameter tree,
printing each candidate's predicted and trial time; every raced program's
kernel state must equal its grouped plain version; the ``pim_sim`` trace
served on the picks must give the exact integer product's tokens with one
launch per linear per decode step, each a table hit, and after an
untuned serve of the same trace only the non-default picks may upload
decode state; one w_in decode launch is timed at every raced geometry,
beside the per-gate plain version, its state held to the grouped plain
version on its first and last crossbars; and
a saved, reloaded table must make a fresh warmup run no trial.

Then the serving router (``serve_fleet_phase``): two replicas of the same
full-width qwen1.5-0.5b share the card (``Router(devices=None)``), each
its own scheduler and paged pool.  ``quant`` serves the quant phase's
trace with ``round_robin`` and ``least_loaded``, with a kill mid-trace
and respawn and with a kill that retires the replica, and the prefix
phase's shared-prefix trace with ``prefix_affinity`` and the prefix
cache; ``pim_sim`` serves the pim_sim phase's trace least-loaded with a
kill mid-trace.  Every fleet's tokens must equal the single scheduler's
of those phases, a kill must rebalance requests and restart as planned,
the dead pool must be freed (the allocation after a respawn at most half
a pool above the one before the kill, after a retirement at least half a
pool below it), every pim_sim decode step must launch the crossbar
kernel once per linear and none after the first may upload crossbar
state; fleet and per-replica tok/s, TTFT and TPOT on the fleet clock are
printed.

Then it drops the served model's parameters: the engine must report no
derived, chunked or resident bytes, and the card's allocation must fall by
at least the weights and what the engine held for them (``check_released``,
after each model below too).  ``serve_wide`` serves gemma-7b (2 of 28
layers) and granite-20b (2 of 52) at full width on fresh weights: in
``quant`` (4 requests, prompts 16-64, batch 4) the prefill logits and
tokens must equal the plain GEMM's; in ``pim_sim`` (2 requests of 8
tokens, batch 2) the logits and tokens must equal the exact integer
product's, no decode step after the first may upload crossbar state, the
resident state must equal its host arithmetic, and the phase's peak
allocation must stay below ``wide_pim_limit``.  ``serve_window`` serves
full-depth h2o-danube-1.8b (window 4096) in ``quant``, paged: a
4,160-token prompt past the window and a 4,080-token one whose decode
wraps the ring, at batch 1, whose tokens must equal a naive ring decode's
(contiguous prefill and decode steps) and whose last logits must lie
within ``WINDOW_LOGIT_TOL`` of a teacher-forced windowed prefill; then
three short prompts through packing and 64-token chunks, each served
token ranked within ``PREFIX_LOGIT_TOL`` of the best by the naive decode
fed those tokens; one decode step at batch 4 is profiled; then 4 of its
layers in ``pim_sim``, tokens equal to the exact product's.  The GEMM is
also timed at these models' decode shapes and at M = 4160, and one w_in
crossbar launch at gemma's and granite's decode shape; the GEMM and the
crossbar kernel are also timed at granite-moe's and jamba-v0.1's decode
shapes.

``serve_moe`` serves full-depth granite-moe-1b-a400m in ``quant`` and
``pim_sim`` (tokens and prefill logits equal to the plain GEMM's or the
exact product's, one launch per attention projection per decode step) and
holds one layer's dispatch to a host recomputation of the reference's
capacity rule.  ``serve_recurrent`` serves jamba-v0.1-52b at full width,
one period of 8 layers (Mamba, attention and MoE blocks), unpadded
(``prompt_bucket=1``): ``quant`` and ``pim_sim`` as ``serve_moe``, 16
launches per decode step (the Mamba layers' MLPs and the attention
layer's linears), the resident crossbar state equal to its host
arithmetic, a profiled ``quant`` decode step with its Mamba mixers and MoE
blocks under ``record_function`` ranges, and one Mamba layer's state
continuity in float32 within the reference test's tolerance; then
full-depth xlstm-1.3b, whose tokens at max_batch 1 equal a naive prefill
and ``decode_step`` loop's bit for bit, whose pool at max_batch 4 holds
exactly ``cache_specs``' bytes of state, whose evicted slots read back
zero state, and which launches neither kernel.  ``serve_multimodal``
generates with full-width, full-depth seamless-m4t-medium (12 encoder +
12 decoder layers) and llama-3.2-vision-11b (40 layers, 1601 patches a
request) through ``prefill`` and ``decode_step_slots`` (the reference's
scheduler refuses both configs, and so does the port's): seamless in
``quant`` and, twice, in ``pim_sim``, llama-vision in ``quant`` and, at
one period of its pattern (5 layers, full width, 2 requests prefilled
together), in ``pim_sim``; every step's logits and the tokens equal the
plain GEMM's or the exact product's, the prefill and each decode step
launch the mode's kernel once per linear (216 and 108; 312 and 296), or
in ``pim_sim`` once per piece of a linear whose crossbars exceed the
engine's launch budget (``pim_pieces``: llama-vision's xwk and xwv over
3,202 patch rows split into 37 launches each), the ``pim_sim`` runs
upload no crossbar state after the first decode step and hold exactly
their host arithmetic's resident bytes, and llama-vision's ``pim_sim``
peak stays under ``vision_pim_limit``; one xwk piece is timed and held
to the per-gate and the grouped plain versions; then two ``quant`` train
steps of seamless whose step 0 equals its oracle.  Every model's weights
are drawn on the card.

``serve_tp`` runs ``quant_tp`` and the expert-parallel MoE block at model
parallel 2: at world size 1 ``tp_quant_linear`` is ``quant_linear`` bit
for bit; then two processes share the card (``launch.mesh.spawn``,
gloo) and each serves full-width qwen1.5-0.5b in ``quant_tp`` (its int32
tiles equal to ``tp_quant_linear_ref``'s, outputs to single-rank
``quant``'s, the ``quant`` phase's tokens in both pools with 168
launches per decode step per rank; the tile GEMMs, one ``all_gather``
and one ``all_reduce`` timed; a profiled step; one ``autotune_linear``
pick, the same on both ranks), granite-moe-1b-a400m (16 experts per
rank: routes, capacity and each rank's partial exact, the summed block
within ``MOE_TP_TOL`` of the meshless one; ``serve_moe``'s trace served
and its agreement with the ``quant`` tokens printed) and one full-width
arctic-480b layer (64 experts per rank, 28 GB per rank, the ranks drawn
one after the other).

``serve_fleet_ranks`` runs the router over ranks: four gloo processes
share the card, each draws full-width qwen1.5-0.5b from seed 0 and runs
the router (``Router(devices=[0, 1, 2, 3])``): two ``quant_tp``
replicas of model 2, each a sub-mesh of two ranks, serve the ``quant``
phase's trace least-loaded, and replica 0 is killed at round
``FLEET_RANKS_KILL_STEP`` losing rank 0, so it respawns over rank 1 alone
at model 1 (``quant``).  Every rank's tokens must equal the ``quant``
phase's; replica 0 must go from ranks [0, 1] to [1] and restart once;
each decode step must launch the GEMM per weight tile as its replica's
model axis calls for (``tile_counts``; 168 at model 1); the lost rank's
allocation must fall by at least half a pool.  Then a ``pim_sim`` fleet
of two one-rank replicas over ranks 0 and 1 serves the ``pim_sim``
phase's trace with a kill and no rank lost: tokens equal to that
phase's, 168 crossbar launches per decode step, no upload after the
first.  Each rank prints the fleet's tok/s, TTFT and TPOT on the fleet
clock and the world exchanges' calls and host ms per round.
``dryrun_roofline`` runs the dry-run and roofline tools on the host:
qwen1.5-0.5b x decode_32k and x train_4k on rank 0 of the 16x16 virtual
mesh at full width, then the ``quant`` decode step that
``profile_decode`` measured (batch 4) on a one-rank virtual mesh, whose
FLOPs on fake tensors must equal ``FlopCounterMode``'s on the card (the
GEMM is one PyTorch operator with a FLOP formula); its roofline time is
printed against the measured busy and wall time.

Last it trains full-width qwen1.5-0.5b on fresh weights from the same seed.  ``train_quant``: 4 steps of
``launch.train.train_step`` at batch 4, seq 128 (every linear on the GEMM
kernel at M = 512); ``train_pim``: 1 step at batch 2, seq 32 on
``TRAIN_PIM_LAYERS`` of the 24 layers (every linear on the crossbar kernel
at M = 64, on transient state).  In both, every loss
and gradient norm must be finite, step 0's must equal those through the
plain GEMM or the exact integer product, and each step must make one launch
per linear (or per piece, ``launches``) in the forward and one more in
remat's recompute; ``pim_sim`` training must leave the resident crossbar
state as it found it and stay below ``PIM_TRAIN_EXTRA_BYTES`` above its
start.  The GEMM is timed at the
train shapes beside ``torch._int_mm`` and its bound, one w_in crossbar
launch at M = 64 beside its bound.  ``train_restart`` runs the crash and
resume drill through the training CLI in subprocesses (2 layers at full
width): the resumed steps' losses and the last checkpoint must equal an
uninterrupted run's, held bit for bit when two uninterrupted runs agree bit
for bit, else within their difference.

``train_zero3`` trains sharded: two processes share the card over gloo,
``ElasticMesh(1)`` lays (pod 1, data 2, model 1) over them, and each
keeps only its ZeRO-3 shard of full-width, full-depth qwen1.5-0.5b in
``quant`` (batch 4, seq 64, 3 steps; M = 128 rows per rank).  Each rank's
at-rest parameter and AdamW bytes must equal the specs' host arithmetic,
the gathered tree a whole draw of the same seed, layer 0's wq int32
accumulator on the rank's rows the single-rank run's rows, and step 0's
loss the single-rank loss within ``ZERO3_LOSS_TOL``; rank 0 writes the
gathered tree after 2 steps, this process resumes the third step from it
at world 1, and its loss must be within ``ZERO3_LOSS_TOL`` of the world-2
step's.  Per-rank step wall, device busy (one profiled step), collective
time and peak memory are printed.  Then granite-moe-1b-a400m (2 of its 24
layers, full width) with ``moe_fsdp_gather`` at world 4, (data 2, model
2), one step: every expert gather must be the rank's 16 of 32 experts.
The GEMM is timed at the per-rank train shapes (M = 128).

Each phase's seconds are printed on a line of their own (``[phase]``),
and all of them together after the kernels line (``[phases]``).  The
last line of standard output is ``{"ok": true, "device": {...}}``;
the line before it lists the card's name and power limit, the one
before that the phases' seconds, and the one before that the per-kernel
JSON.  Any failure raises and exits
non-zero before those lines.  Without a CUDA device it exits non-zero at
once.
"""
from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import gc
import json
import math
import os
import platform
import subprocess
import sys
import time
from unittest import mock

import numpy as np
import torch

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "src")

# H100 SXM published peaks (NVIDIA data sheet, dense, at 700 W)
HBM_BYTES_PER_S = 3.35e12
INT8_TENSOR_OPS_PER_S = 1979e12
# 32-bit integer logic runs on the INT32 lanes: 64 per SM per clock (NVIDIA
# H100 Tensor Core GPU Architecture white paper) x 132 SMs x 1.98 GHz
INT32_OPS_PER_S = 64 * 132 * 1.98e9

QUANT_SHAPES_KN = ((1024, 1024), (1024, 2816), (2816, 1024))
# the GEMM where the wide and windowed serves take it: decode (M = 4) at
# gemma-7b's and granite-20b's (K, N), and one cold prefill past danube's
# 4096-token window (M = 4160) at its w_in and w_out
WIDE_QUANT_SHAPES = tuple((4, k, n) for k, n in (
    (3072, 4096), (4096, 3072), (3072, 24576), (24576, 3072),
    (6144, 6144), (6144, 128), (6144, 24576), (24576, 6144))) + (
    (4160, 2560, 6912), (4160, 6912, 2560))
# decode (M = 4) at granite-moe's wk/wv and at jamba-v0.1's MLP (w_in and
# w_gate, w_out) and attention (wq/wo, wk/wv) linears
MOE_QUANT_SHAPES = ((4, 1024, 512),)
RECURRENT_QUANT_SHAPES = tuple((4, k, n) for k, n in (
    (4096, 14336), (14336, 4096), (4096, 4096), (4096, 1024)))
# llama-3.2-vision-11b's xwk/xwv prefill on 2 x 1601 patches, and
# seamless-m4t-medium's decode (M = 4) at its MLP's w_in / w_gate (its
# w_out, (4, 4096, 1024), is jamba-v0.1's wk/wv shape above)
MULTIMODAL_QUANT_SHAPES = ((2 * 1601, 4096, 1024), (4, 1024, 4096))
# last-token logits of one prompt from whole, prefix-resumed, chunked and
# packed prefill (bf16 model, |logit| below about 0.5): a few bf16 ulps
PREFIX_LOGIT_TOL = 0.02
# the pim_sim phase that serves a 64-token prompt (prefill states are
# transient; kept resident they would take about 64 GiB)
PIM_PEAK_BYTES = 16 << 30
# the train phases: (batch, seq, steps) of train_quant and train_pim
TRAIN_QUANT = (4, 128, 4)
TRAIN_PIM = (2, 32, 1)
# train_pim's depth: its step is device-bound on packing and the crossbar
# kernel, 13 s at all 24 layers; 8 run every linear shape at full width
TRAIN_PIM_LAYERS = 8
# the pim_sim train phase's peak allocation above its start (PERF.md
# predicts 10-12 GiB: grads, AdamW state and its temporaries, and one
# M = 64 linear's transient crossbar state)
PIM_TRAIN_EXTRA_BYTES = 16 << 30
# ~25 ms at the H100's clock: longer than the host takes to queue any timed
# run of launches below
SLEEP_CYCLES = 50_000_000


def say(*a):
    print(*a, flush=True)


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of ``fn(i)`` over ``reps`` back-to-back calls (CUDA
    events).  A sleep kernel queued first holds the stream while the host
    queues every call, so the events time the device work alone, not the
    rate at which the host launches it."""
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for i in range(reps):
        fn(i)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def max_abs_err(got: torch.Tensor, want: torch.Tensor) -> int:
    """Largest |got - want| over integer tensors of one shape."""
    if got.shape != want.shape:
        raise AssertionError(f"shape {tuple(got.shape)} != "
                             f"{tuple(want.shape)}")
    if got.numel() == 0:
        return 0
    return int((got.to(torch.int64) - want.to(torch.int64)).abs().max())


def exact_matmul(x, w, n_bits=8, **kw):
    """Each pim_sim GEMM as the exact integer product: |sum| < 2**53."""
    return (x.double() @ w.double().T).long()


def crossbar_bound_ms(c, n_cols, w_words, mc):
    """The crossbar kernel's bound for one launch over (c, n_cols,
    w_words) state, in ms, and what bounds it: the state read and written
    once and the microcode read once over HBM, or one 32-bit logic op per
    gate per row-word over the INT32 lanes, whichever is longer."""
    nbytes = 2 * c * n_cols * w_words * 4 + mc.numel() * 4
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = mc.shape[0] * c * w_words / INT32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


# CUgraphNodeType (CUDA driver API)
GRAPH_NODE_TYPES = {0: "kernel", 1: "memcpy", 2: "memset", 3: "host",
                    4: "graph", 5: "empty", 6: "wait_event",
                    7: "event_record"}


def graph_ops(fn) -> list:
    """The device operations one call of ``fn`` enqueues: the node types of
    a CUDA graph captured around the call, read through the driver API.
    Unlike a profiler trace this count cannot lose an operation.  ``fn`` is
    called once on the capture stream first, so that what it allocates
    once per stream is not part of the capture."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()
    stream.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph, stream=stream):
        fn()
    cu = ctypes.CDLL("libcuda.so.1")
    handle = ctypes.c_void_p(graph.raw_cuda_graph())
    count = ctypes.c_size_t(0)
    if cu.cuGraphGetNodes(handle, None, ctypes.byref(count)):
        raise RuntimeError("cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * max(count.value, 1))()
    if count.value and cu.cuGraphGetNodes(handle, nodes, ctypes.byref(count)):
        raise RuntimeError("cuGraphGetNodes failed")
    kinds = []
    for node in nodes[:count.value]:
        kind = ctypes.c_int(-1)
        if cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)):
            raise RuntimeError("cuGraphNodeGetType failed")
        kinds.append(GRAPH_NODE_TYPES.get(kind.value, str(kind.value)))
    del graph
    return kinds


def rotating(make, nbytes: int, budget: int = 200 << 20):
    """Enough copies of an input that cycling through them overruns the
    50 MB L2: each launch finds its weight cold, as in a served step."""
    return [make() for _ in range(max(1, min(64, -(-budget // nbytes))))]


# --------------------------------------------------------------------------
# phase 2: quant_matmul_int
# --------------------------------------------------------------------------

def check_quant_kernel(dev):
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.quant_matmul import (quant_matmul_int,
                                                  quant_matmul_int_ref,
                                                  quantize_sym)
    from repro_torch.kernels.quant_matmul.quant_matmul import (
        _launch, _launch_checked, plan)

    g = torch.Generator(device=dev).manual_seed(0)

    def rand(*shape):
        return torch.randint(-128, 128, shape, dtype=torch.int8, device=dev,
                             generator=g)

    # M up to 512: prefix tails, chunks and packed streams (the packed
    # stream's cap); 23 and 80 are ragged tails; 2, 6, 8 and 12 are the
    # speculative draft and verify steps (B = 2 and 4, k = 3 and 4)
    path = [(m, k, n) for m in (1, 2, 4, 6, 8, 12, 16, 23, 32, 48, 64, 80,
                                128, 512)
            for k, n in QUANT_SHAPES_KN]
    ragged = [(1, 1, 1), (3, 77, 5), (17, 200, 130), (5, 1000, 1001),
              (129, 33, 257), (2, 4097, 3)]
    # K not a multiple of the split or of 32, N not a multiple of 16, and a
    # large M split in two
    edges = [(4, 2815, 1024), (4, 2817, 1024), (4, 4097, 1024),
             (4, 2817, 2816), (4, 1024, 1000), (16, 1024, 1030),
             (64, 2816, 1000), (2100, 2048, 2048)]
    err = 0

    def check(x, w, what):
        nonlocal err
        e = max_abs_err(quant_matmul_int(x, w), quant_matmul_int_ref(x, w))
        if e:
            raise AssertionError(f"quant_matmul_int != plain ({what}): max "
                                 f"abs error {e}")
        err = max(err, e)

    served = (WIDE_QUANT_SHAPES + MOE_QUANT_SHAPES + RECURRENT_QUANT_SHAPES
              + MULTIMODAL_QUANT_SHAPES)
    for m, k, n in path + ragged + edges + list(served):
        check(rand(m, k), rand(k, n), f"M, K, N = {m, k, n}")
    for m, k, n in ((4, 2816, 1024), (64, 1024, 2816)):
        for xv, wv in ((-128, -128), (127, -128), (127, 127), (-128, 127)):
            x = torch.full((m, k), xv, dtype=torch.int8, device=dev)
            w = torch.full((k, n), wv, dtype=torch.int8, device=dev)
            check(x, w, f"all {xv} @ all {wv} at {m, k, n}")
            if int(quant_matmul_int(x, w)[0, 0]) != xv * wv * k:
                raise AssertionError(f"extreme operands {xv}, {wv} at "
                                     f"{m, k, n}")
        x, w = rand(m, k), rand(k, n)
        x[:, ::3] = -128
        w[::5] = 127
        check(x, w, f"mixed extremes at {m, k, n}")
    # operands at pointers off a 16-byte boundary: contiguous slices of a
    # larger buffer
    for m, k, n, xo, wo in ((4, 1024, 2816, 0, 1), (4, 1024, 2816, 3, 8),
                            (16, 2816, 1024, 5, 4), (3, 77, 130, 1, 7)):
        xb, wb = rand(m * k + xo), rand(k * n + wo)
        check(xb[xo:].view(m, k), wb[wo:].view(k, n),
              f"M, K, N = {m, k, n} at byte offsets {xo} (x), {wo} (w)")
    # the arrival counters come back to zero: one shape three times, then
    # two shapes interleaved on one stream, every result exact
    runs = [(4, 1024, 2816)] * 3 + [(4, 1024, 1024), (16, 2816, 1024)] * 3
    ops = [(rand(m, k), rand(k, n)) for m, k, n in runs]
    outs = [quant_matmul_int(x, w) for x, w in ops]
    for (x, w), got, shape in zip(ops, outs, runs):
        e = max_abs_err(got, quant_matmul_int_ref(x, w))
        if e:
            raise AssertionError(f"quant_matmul_int != plain in back-to-back"
                                 f" calls at {shape}: max abs error {e}")
    torch.cuda.synchronize()
    say(f"[quant_matmul_int] == plain (exact int32, max abs error {err}) on "
        f"{len(path)} path shapes, {len(served)} shapes of the wide, "
        f"windowed, MoE, recurrent and multimodal serves, {len(ragged)} "
        f"ragged shapes, "
        f"{len(edges)} split/column edges {edges}, 10 extreme-operand cases, "
        f"4 unaligned-pointer cases and {len(runs)} back-to-back calls (one "
        "shape 3 times, two interleaved)")

    # device operations in one call: the kernel alone (no memset), counted
    # twice.  First the nodes of a CUDA graph captured around one call: an
    # exact count, and it must be 1.  Then a torch.profiler trace of 10
    # calls between two marker kernels.  A trace can lose events (on the
    # H100 some showed fewer calls than were made and no marker, one showed
    # no device operation at all), but it cannot add any, so every trace
    # must show nothing but the kernel, at most once per call; a trace that
    # lost a marker or a call is taken again, up to 3 times.
    def device_ops(fn):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        return [(e.key, e.count) for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA]

    x, w = rand(4, 1024), rand(1024, 2816)
    graph_kinds = graph_ops(lambda: quant_matmul_int(x, w))
    n_ops = len(graph_kinds)
    say(f"[quant_matmul_int] device operations in one call at M, K, N = "
        f"(4, 1024, 2816), from a CUDA graph captured around it: {n_ops} "
        f"{graph_kinds}")
    if graph_kinds != ["kernel"]:
        raise AssertionError(f"one quant_matmul_int call ran {n_ops} device "
                             f"operations, expected 1 kernel: {graph_kinds}")
    calls, traced = 10, None
    for attempt in range(1, 4):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(1000)
            for _ in range(calls):
                quant_matmul_int(x, w)
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
        ops = {e.key: e.count for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA}
        markers = sum(c for key, c in ops.items() if "spin_kernel" in key)
        ours = sum(c for key, c in ops.items()
                   if "quant_matmul_kernel" in key)
        other = {key: c for key, c in ops.items() if "spin_kernel" not in key
                 and "quant_matmul_kernel" not in key}
        if other or ours > calls or markers > 2:
            raise AssertionError(f"{calls} quant_matmul_int calls ran device "
                                 f"operations other than the kernel: {ops}")
        if markers == 2 and ours == calls:
            traced = ours / calls
            break
        say(f"[quant_matmul_int] torch.profiler trace {attempt} lost events "
            f"(markers {markers} of 2, kernels {ours} of {calls}); tracing "
            "again")
    say(f"[quant_matmul_int] device operations per call in a torch.profiler "
        f"trace of {calls} calls: "
        + (f"{traced:g} (trace {attempt})" if traced is not None else
           "not measured (all 3 traces lost events; none showed another "
           "operation)"))
    # the host's cost of a call through the PyTorch operator (the
    # wrapper's checks, the dispatcher, the launch) against the launch
    # called directly, without the dispatcher; each the best of 3 rounds
    # of 500 calls, the two interleaved
    host = {"operator": float("inf"), "direct": float("inf")}
    for _ in range(3):
        for key, fn in (("operator", lambda: quant_matmul_int(x, w)),
                        ("direct", lambda: _launch_checked(x, w))):
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(500):
                fn()
            host[key] = min(host[key], (time.perf_counter() - t) / 500)
    torch.cuda.synchronize()
    say(f"[quant_matmul_int] host time per call at (4, 1024, 2816): "
        f"{host['operator'] * 1e6:.2f} us through the operator, "
        f"{host['direct'] * 1e6:.2f} us launched directly; "
        f"{(host['operator'] - host['direct']) * 168e3:.3f} ms for a qwen "
        f"decode step's 168 calls")
    # the rest of a quant linear: the per-column quantization of a weight
    wf = torch.randn(1024, 2816, device=dev, dtype=torch.bfloat16)
    q_ops = device_ops(lambda: quantize_sym(wf.float(), axis=0))
    say(f"[quant_matmul_int] beside it, quantize_sym of a (1024, 2816) "
        f"weight: {sum(c for _, c in q_ops)} device operations, of them "
        f"{sum(c for k, c in q_ops if 'memset' in k.lower())} memsets")

    floor = cuda_ms(lambda i: torch.cuda._sleep(0), 50)
    say(f"[quant_matmul_int] launch floor (an empty kernel, back to back): "
        f"{floor * 1e3:.2f} us")
    rows = {}
    # M = 128: the ZeRO-3 trainer's per-rank rows
    timed = [s for s in path if s[0] in (1, 4, 16, 64, 128, 512)]
    for m, k, n in timed + list(served):
        x, ws, row = time_quant_gemm(m, k, n, rand, floor)
        ms = row["ms"]
        p = plan(m, k, n)
        if p.splits == 1 and k == 1024:
            # the same call with K split 3 ways across blocks (192 blocks,
            # one per SM and more), for the plan's choice not to split
            p3 = dataclasses.replace(p, splits=3)
            ms3 = cuda_ms(lambda i: _launch(x, ws[i % len(ws)], p3), 50)
            e = max_abs_err(_launch(x, ws[0], p3),
                            quant_matmul_int_ref(x, ws[0]))
            if e:
                raise AssertionError(f"quant_matmul_int with 3 splits != "
                                     f"plain at {m, k, n}: {e}")
            say(f"[quant_matmul_int] M={m:3d} K={k:4d} N={n:4d}: "
                f"{p.col_tiles}x1 blocks {ms * 1e3:6.2f} us | "
                f"{p.col_tiles}x3 blocks {ms3 * 1e3:6.2f} us")
        rows[(m, k, n)] = dict(row, device_ops_per_call=n_ops,
                               device_ops_per_call_traced=traced,
                               max_abs_err=err,
                               host_us_operator=host["operator"] * 1e6,
                               host_us_direct=host["direct"] * 1e6)
        say(f"[quant_matmul_int] M={m:3d} K={k:4d} N={n:4d} "
            f"({p.col_tiles}x{p.splits} blocks): " + gemm_line(row))
    return rows


def time_quant_gemm(m, k, n, rand, floor):
    """The GEMM at (m, k, n) timed on the card: the kernel, its plain
    version and ``torch._int_mm`` (the weights rotated past the L2), beside
    its bound and ``floor`` (an empty launch).  Returns (x, the weights,
    the row)."""
    from repro_torch.kernels.quant_matmul import (quant_matmul_int,
                                                  quant_matmul_int_ref)

    x = rand(m, k)
    ws = rotating(lambda: rand(k, n), k * n)
    ms = cuda_ms(lambda i: quant_matmul_int(x, ws[i % len(ws)]), 50)
    plain = cuda_ms(lambda i: quant_matmul_int_ref(x, ws[i % len(ws)]), 20)
    # torch._int_mm refuses M <= 16: there it runs x zero-padded to 32
    # rows, padded once here
    xl = x if m > 16 else torch.cat([x, x.new_zeros(32 - m, k)]).contiguous()
    lib = cuda_ms(lambda i: torch._int_mm(xl, ws[i % len(ws)]), 50)
    nbytes = m * k + k * n + 4 * m * n
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * m * k * n / INT8_TENSOR_OPS_PER_S * 1e3
    return x, ws, dict(
        ms=ms, plain_ms=plain, library_ms=lib,
        library="torch._int_mm" if m > 16
        else "torch._int_mm, M padded to 32",
        launch_floor_ms=floor, bound_ms=max(t_bytes, t_ops),
        bound_by="bytes" if t_bytes >= t_ops else "operations")


def gemm_line(row):
    return (f"kernel {row['ms'] * 1e3:6.2f} us | plain "
            f"{row['plain_ms'] * 1e3:7.2f} us | {row['library']} "
            f"{row['library_ms'] * 1e3:6.2f} us | launch floor "
            f"{row['launch_floor_ms'] * 1e3:5.2f} us | bound "
            f"{row['bound_ms'] * 1e3:5.2f} us ({row['bound_by']}) | "
            f"{row['bound_ms'] / row['ms'] * 100:5.1f}% of bound")


# --------------------------------------------------------------------------
# phase 3: crossbar_exec
# --------------------------------------------------------------------------

def check_crossbar_kernel(dev):
    from repro_torch.kernels import crossbar_exec as xb
    from repro_torch.kernels.crossbar_exec import (crossbar_exec,
                                                   crossbar_exec_ref, plan)
    from repro_torch.kernels.crossbar_exec.schedule import GROUP_WIDTH
    from repro_torch.pim import engine

    g = torch.Generator(device=dev).manual_seed(1)
    n, w_words = 1024, 8

    def rand_state(c):
        return torch.randint(-2 ** 31, 2 ** 31 - 1, (c, n, w_words),
                             dtype=torch.int32, device=dev, generator=g)

    def rand_cols(k, hi=n):
        return torch.randint(0, hi, (k,), device=dev, generator=g)

    def microcode(*cols):
        return torch.stack(cols, dim=1).to(torch.int32).contiguous()

    n_ops = 6000
    mc = microcode(torch.randint(0, 6, (n_ops,), device=dev, generator=g),
                   *(rand_cols(n_ops) for _ in range(3)))
    err = 0

    def check(st, mc, what):
        nonlocal err
        e = max_abs_err(crossbar_exec(st, mc), crossbar_exec_ref(st, mc))
        if e:
            raise AssertionError(f"crossbar_exec != plain ({what}): max abs "
                                 f"error {e}")
        err = max(err, e)

    check(rand_state(3), mc, "random microcode")
    codes = torch.bincount(mc[:, 0].long(), minlength=6)
    say(f"[crossbar_exec] == plain (exact state) on random microcode "
        f"(C=3, n={n}, W={w_words}, G={n_ops}, all six codes: "
        f"{codes.tolist()})")
    # ragged shapes: W not a multiple of 4 (word-wise state copies), odd
    # row-word counts, tiny n, many crossbars per block
    ragged = ((2, 5, 3, 300), (7, 64, 1, 2000), (3, 300, 2, 2000),
              (1, 17, 5, 500), (200, 40, 1, 800))
    for c, nn, ww, k in ragged:
        st = torch.randint(-2 ** 31, 2 ** 31 - 1, (c, nn, ww),
                           dtype=torch.int32, device=dev, generator=g)
        m = microcode(torch.randint(0, 6, (k,), device=dev, generator=g),
                      *(rand_cols(k, nn) for _ in range(3)))
        check(st, m, f"random microcode at C, n, W = {c, nn, ww}")
    say(f"[crossbar_exec] == plain (exact state) on random microcode at "
        f"ragged (C, n, W, G) = {ragged}")

    # edge cases of the schedule: gates that read their own destination;
    # a 3000-gate RAW chain (each gate reads the one before: groups of 1);
    # 2000 independent gates (one level far wider than the group width)
    k = 3000
    selfread = mc[:k].clone()
    selfread[::2, 1] = selfread[::2, 3]
    dst = rand_cols(k)
    chain = microcode(torch.full((k,), 4, device=dev),
                      torch.cat([dst[-1:], dst[:-1]]), rand_cols(k), dst)
    wide = microcode(torch.randint(0, 6, (2000,), device=dev, generator=g),
                     rand_cols(2000, 512), rand_cols(2000, 512),
                     512 + torch.arange(2000, device=dev) % 512)
    for name, m in (("self-reads (ia == dst)", selfread),
                    ("a 3000-gate RAW chain", chain),
                    ("a 2000-gate level, wider than the group", wide)):
        check(rand_state(3), m, name)
        p = plan(m, n)
        say(f"[crossbar_exec] == plain (exact state) on {name}: {len(m)} "
            f"rows in {p.n_groups} groups of {GROUP_WIDTH}")

    art37 = engine.compile_dot(37, 8)
    mc37 = art37.microcode_on(dev)
    for c, art in ((3, art37), (5, engine.compile_dot(25, 8)),
                   (2, engine.compile_dot(4, 8))):
        mcd = art.microcode_on(dev)
        check(rand_state(c), mcd, f"the {art.n_terms}-term dot program")
        p = plan(mcd, n)
        say(f"[crossbar_exec] == plain (exact state) on the real "
            f"{art.n_terms}-term dot program over {c} crossbars; schedule: "
            f"{mcd.shape[0]} rows in {p.n_groups} groups of {GROUP_WIDTH}, "
            f"{mcd.shape[0] / p.n_groups:.2f} gates per group, padding "
            f"{1 - mcd.shape[0] / (p.n_groups * GROUP_WIDTH):.4f}")

    # the integer GEMM the kernel serves: packing + kernel + unpacking on
    # the card against the exact product, at decode-batch-2 widths.  Each
    # runs all its zero-padded 37-term chunks as one launch over 616
    # crossbars: w_in (K=1024) 28 x 22, w_down (K=2816) 77 x 8; the
    # captured launch input is held against the per-gate plain version.
    gi = np.random.default_rng(2)
    seen = []
    real = xb.crossbar_exec

    def capture(state, m):
        seen.append((state.clone(), m))
        return real(state, m)

    for k, o in ((1024, 2816), (2816, 1024)):
        x = torch.as_tensor(gi.integers(0, 256, (2, k)), device=dev)
        wt = torch.as_tensor(gi.integers(0, 256, (o, k)), device=dev)
        seen.clear()
        with mock.patch.object(xb, "crossbar_exec", capture):
            got = engine.matmul_int(x, wt, 8)
        exact = (x.double() @ wt.double().T).long()
        if not torch.equal(got, exact):
            raise AssertionError(f"matmul_int != exact product at "
                                 f"M=2 K={k} O={o}")
        if len(seen) != 1 or seen[0][0].shape[0] != 616:
            raise AssertionError(f"matmul_int at K={k} made "
                                 f"{[s[0].shape[0] for s in seen]} "
                                 "launches of crossbars, expected one of 616")
        check(*seen[0], f"the packed state of M=2 K={k} O={o}")
    torch.cuda.synchronize()
    say("[crossbar_exec] engine.matmul_int on the card == exact integer "
        "product at M=2, (K, O) = (1024, 2816) and (2816, 1024), one launch "
        "of 616 crossbars each; kernel == plain on both packed states")

    # full-width decode-shape launches: w_in (O=2816, K=1024) at batch 2,
    # 594 crossbars (its 27 full 37-term chunks, the shape timed before the
    # last chunk was padded) and 616 (all 28 chunks, the last zero-padded,
    # as matmul_int runs them)
    rows = {}
    g_rows = mc37.shape[0]
    for c in (27 * math.ceil(2 * 2816 / 256), 28 * math.ceil(2 * 2816 / 256)):
        st = rand_state(c)
        ms = cuda_ms(lambda i: crossbar_exec(st, mc37), 10, warmup=1)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        plain_out = crossbar_exec_ref(st, mc37)
        end.record()
        end.synchronize()
        plain = start.elapsed_time(end)
        e = max_abs_err(crossbar_exec(st, mc37), plain_out)
        if e:
            raise AssertionError(f"crossbar_exec != plain at the w_in decode "
                                 f"shape C={c}: max abs error {e}")
        err = max(err, e)
        bound, by = crossbar_bound_ms(c, n, w_words, mc37)
        rows[c] = dict(ms=ms, plain_ms=plain, library_ms=None,
                       bound_ms=bound, bound_by=by,
                       shape=[c, n, w_words, g_rows])
        say(f"[crossbar_exec] w_in decode shape C={c} n={n} W={w_words} "
            f"G={g_rows}: kernel {ms:.4f} ms | plain {plain:.1f} ms | bound "
            f"{bound * 1e3:.2f} us ({rows[c]['bound_by']}) | "
            f"{bound / ms * 100:.2f}% of bound | "
            f"{g_rows / (ms * 1e-3) / 1e6:.1f} M gates/s per row-word")
    # the fixed cost of a launch: an empty kernel back to back, and this
    # kernel on one crossbar with one gate
    floor = cuda_ms(lambda i: torch.cuda._sleep(0), 50)
    st1 = rand_state(1)
    mc1 = microcode(*(torch.zeros(1, device=dev) for _ in range(4)))
    one_gate = cuda_ms(lambda i: crossbar_exec(st1, mc1), 50)
    check(st1, mc1, "one INIT gate over one crossbar")
    say(f"[crossbar_exec] launch floor (an empty kernel, back to back): "
        f"{floor * 1e3:.2f} us | one gate over one crossbar (n={n}, "
        f"W={w_words}): {one_gate * 1e3:.2f} us")
    # w_in of gemma-7b and of granite-20b at their decode shape (batch 2):
    # 84 x 192 and 167 x 192 crossbars in one launch; granite-moe's wq/wo
    # and wk/wv (28 x 8 and 28 x 4); jamba-v0.1's w_in (111 x 112);
    # seamless-m4t-medium's w_in (28 x 32)
    wide = []
    for name, k, o in (("gemma-7b", 3072, 24576), ("granite-20b", 6144,
                                                    24576),
                       ("granite-moe-1b-a400m wq", 1024, 1024),
                       ("granite-moe-1b-a400m wk", 1024, 512),
                       ("jamba-v0.1-52b", 4096, 14336),
                       ("seamless-m4t-medium", 1024, 4096)):
        r = dict(model=name, **time_crossbar_at(dev, 2, k, o))
        err = max(err, r["max_abs_err"])
        wide.append(r)
        say(f"[crossbar_exec] {name} decode shape (M=2, K={k}, O={o}):"
            f" C={r['shape'][0]} n={n} W={w_words} G={r['shape'][3]}: "
            f"kernel {r['ms']:.4f} ms | plain {r['plain_ms']:.1f} ms | bound"
            f" {r['bound_ms'] * 1e3:.2f} us ({r['bound_by']}) | "
            f"{r['bound_ms'] / r['ms'] * 100:.2f}% of bound; == plain "
            "(exact state)")
    row = dict(rows[594], max_abs_err=err, ms_616=rows[616]["ms"],
               launch_floor_ms=floor, one_gate_ms=one_gate, wide_shapes=wide)
    return row


# --------------------------------------------------------------------------
# phase 3a: the pim_sim engine's bit-plane kernels
# --------------------------------------------------------------------------

# (name, M, K, O) of the crossbar GEMMs held, K in 37-term chunks: jamba-
# v0.1's w_in (the first: its decode steps are run and timed too) and
# w_out at batch 2, llama-3.2-vision-11b's xwk over 2 x 1601 patch rows
PIM_BITS_SHAPES = (("jamba w_in", 2, 4096, 14336),
                   ("jamba w_out", 2, 14336, 4096),
                   ("llama-vision xwk", 3202, 4096, 1024))
PIM_BITS_STEPS = 4          # resident decode steps held to the plain path


def check_pim_bits(dev):
    """The writer and reader of ``kernels.pim_bits`` against the engine's
    plain path (``executor.write_numbers`` over ``engine._operand_rows``,
    and ``executor.read_numbers``), state for state on a random state: at
    jamba-v0.1's w_in and w_out decode shapes (12,432 and 12,416
    crossbars), and at llama-vision's xwk on one launch piece as the
    engine's byte budget cuts it (three whole chunks from the fourth,
    38,424 crossbars) and on a part of one chunk.  Then
    ``PIM_BITS_STEPS`` resident decode steps of w_in through
    ``ExecutionSession.execute`` on the kernels and on the plain path:
    results, resident states and the exact product all equal, one write a
    step (and w's at the upload) and one read.  Last, both kernels timed at
    w_in beside the plain path and their byte bounds.  Returns a row."""
    from repro_torch.kernels import pim_bits
    from repro_torch.pim import engine
    from repro_torch.pim import executor as ex

    art = engine.compile_matmul(37, 8)
    x_cols, w_cols, acc = art.columns_on(dev)
    n, rows, k = art.n_cols, 256, art.n_terms
    gen = torch.Generator(device=dev).manual_seed(7)

    def operand(r, p):
        """(p, r, 37) uint8, a strided view as ``matmul_int`` chunks it."""
        flat = torch.randint(0, 256, (r, p * k), dtype=torch.uint8,
                             device=dev, generator=gen)
        return flat.unflatten(1, (p, k)).transpose(0, 1)

    def rand_state(c):
        return torch.randint(-2 ** 31, 2 ** 31 - 1, (c, n, rows // 32),
                             dtype=torch.int32, device=dev, generator=gen)

    def plain_write(part, v, cols, lo, hi, n_cb, m, o, of_x):
        return ex.write_numbers(part, cols, engine._operand_rows(
            v, lo, hi, n_cb, rows, m, o, of_x))

    held = []
    for name, m, kk, o in PIM_BITS_SHAPES:
        p, n_cb = -(-kk // k), -(-m * o // rows)
        x, w = operand(m, p), operand(o, p)
        pieces = engine.launch_pieces(p, n_cb, engine.launch_bytes(
            n, k, len(acc), rows))
        # one launch; or the second piece and a part of the chunk it starts
        first = pieces[1][0] if len(pieces) > 1 else 0
        ranges = [pieces[0]] if len(pieces) == 1 else [
            pieces[1], (first + n_cb // 10, first + n_cb // 2)]
        for lo, hi in ranges:
            start = rand_state(hi - lo)
            for v, cols, of_x in ((x, x_cols, True), (w, w_cols, False)):
                got = pim_bits.write_operand(start.clone(), v, cols, lo, hi,
                                             n_cb, rows, m, o, of_x)
                want = plain_write(start.clone(), v, cols, lo, hi, n_cb, m,
                                   o, of_x)
                if not torch.equal(got, want):
                    raise AssertionError(
                        f"pim_bits writer != write_numbers at {name} "
                        f"[{lo}, {hi}) ({'x' if of_x else 'w'})")
                del got, want
            if not torch.equal(pim_bits.read_accumulators(start, acc, rows),
                               ex.read_numbers(start, acc, rows)):
                raise AssertionError(f"pim_bits reader != read_numbers at "
                                     f"{name} [{lo}, {hi})")
            held.append((name, lo, hi))
            del start
        torch.cuda.synchronize()
    say(f"[pim_bits] writer (x and w) == write_numbers of the operand rows, "
        f"reader == read_numbers, exact state, at (GEMM, crossbars "
        f"[lo, hi)) {held}")

    # resident decode steps of jamba's w_in: the kernels against the plain
    # path, through the engine
    _, m, kk, o = PIM_BITS_SHAPES[0]
    p, n_cb = -(-kk // k), -(-m * o // rows)

    def chunked(t):
        return torch.nn.functional.pad(t, (0, p * k - kk)).unflatten(
            1, (p, k)).transpose(0, 1)

    wt = torch.randint(0, 256, (o, kk), dtype=torch.uint8, device=dev,
                       generator=gen)
    xs = [torch.randint(0, 256, (m, kk), dtype=torch.uint8, device=dev,
                        generator=gen) for _ in range(PIM_BITS_STEPS)]
    wc = chunked(wt)            # one tensor: the state stays resident
    runs = []
    for on_card in (True, False):
        engine.clear_cache()
        sess = engine.ExecutionSession(art)
        before = dict(pim_bits.launches)
        with contextlib.ExitStack() as stack:
            if not on_card:
                stack.enter_context(mock.patch.object(
                    engine, "_bit_kernels", lambda *a: False))
            outs = [sess.execute(chunked(x), wc).sum(dim=0) for x in xs]
        torch.cuda.synchronize()
        (entry,) = sess._states.values()
        runs.append((outs, entry.value.clone(),
                     {key: pim_bits.launches[key] - before[key]
                      for key in before}))
    engine.clear_cache()
    (k_outs, k_state, k_calls), (p_outs, p_state, p_calls) = runs
    exact = [(x.double() @ wt.double().T).long() for x in xs]
    if not (all(torch.equal(a, b) and torch.equal(a, e)
                for a, b, e in zip(k_outs, p_outs, exact))
            and torch.equal(k_state, p_state)):
        raise AssertionError("pim_bits decode steps differ from the plain "
                             "path's")
    want_calls = {"write": PIM_BITS_STEPS + 1, "read": PIM_BITS_STEPS}
    if k_calls != want_calls or p_calls != {"write": 0, "read": 0}:
        raise AssertionError(f"pim_bits launches {k_calls} / {p_calls}, "
                             f"expected {want_calls} / none")
    say(f"[pim_bits] {PIM_BITS_STEPS} resident decode steps of jamba w_in "
        f"(M={m}, K={kk}, O={o}: {p} x {n_cb} crossbars) on the "
        f"kernels == on the plain path == exact product, resident states "
        f"equal; launches {k_calls}")
    del runs, k_outs, p_outs, k_state, p_state

    # timed at jamba's w_in decode shape
    c = p * n_cb
    x, w = operand(m, p), operand(o, p)
    state = rand_state(c)
    out = torch.empty((c, rows), dtype=torch.int64, device=dev)
    times = dict(
        write_x_ms=cuda_ms(lambda i: pim_bits.write_operand(
            state, x, x_cols, 0, c, n_cb, rows, m, o, True), 20),
        write_w_ms=cuda_ms(lambda i: pim_bits.write_operand(
            state, w, w_cols, 0, c, n_cb, rows, m, o, False), 20),
        read_ms=cuda_ms(lambda i: pim_bits.read_accumulators(
            state, acc, rows, out), 20),
        plain_write_x_ms=cuda_ms(lambda i: plain_write(
            state, x, x_cols, 0, c, n_cb, m, o, True), 3, warmup=1),
        plain_read_ms=cuda_ms(lambda i: ex.read_numbers(state, acc, rows), 3,
                              warmup=1))
    word_bytes = rows // 32 * 4
    write_bytes = c * k * x_cols.shape[1] * word_bytes
    read_bytes = c * (len(acc) * word_bytes + rows * 8)
    row = dict(shape=[c, n, rows // 32, k, x_cols.shape[1], len(acc)],
               held=held, steps=PIM_BITS_STEPS, launches=k_calls,
               write_bound_ms=write_bytes / HBM_BYTES_PER_S * 1e3,
               read_bound_ms=read_bytes / HBM_BYTES_PER_S * 1e3,
               write_bytes=write_bytes, read_bytes=read_bytes, **times)
    say(f"[pim_bits] jamba w_in decode shape C={c} n={n} W={rows // 32} "
        f"K={k} nb={x_cols.shape[1]} A={len(acc)}: writer x "
        f"{times['write_x_ms'] * 1e3:.2f} us, w "
        f"{times['write_w_ms'] * 1e3:.2f} us (bound "
        f"{row['write_bound_ms'] * 1e3:.2f} us: {write_bytes} B written) | "
        f"plain write of x {times['plain_write_x_ms']:.3f} ms | reader "
        f"{times['read_ms'] * 1e3:.2f} us (bound "
        f"{row['read_bound_ms'] * 1e3:.2f} us: {read_bytes} B) | plain read "
        f"{times['plain_read_ms']:.3f} ms")
    return row


# --------------------------------------------------------------------------
# phase 3b: the paper's multipliers on the crossbar kernel
# --------------------------------------------------------------------------

MULT_CROSSBARS = 132          # one per SM: the paper's 1024 x 1024 array
MULT_ROWS = 1024


def check_multipliers(dev):
    """The serial, serial_fast and compressor42 multipliers (the engine's
    mult backends) and MultPIM (minimal model) at n = 8, 16 and 32 on
    ``MULT_CROSSBARS`` crossbars of 1024 x 1024 through
    ``engine.execute_state(backend="cuda")``: every product exact (through
    a uint64 view), the whole state of two crossbars equal to the per-gate
    plain version, then each program timed.  Returns (the launches of the
    checked runs, the table rows)."""
    from repro_torch.kernels.crossbar_exec import crossbar_exec_ref, plan
    from repro_torch.pim import engine
    from repro_torch.pim import executor as ex
    from repro_torch.pim.multpim import build_multpim

    c, rows, n_cols = MULT_CROSSBARS, MULT_ROWS, 1024
    w_words = rows // 32
    rng = np.random.default_rng(13)
    progs = []
    for n in (8, 16, 32):
        for name in ("serial", "serial_fast", "compressor42", "multpim"):
            m = (build_multpim(n, model="minimal") if name == "multpim"
                 else engine.build_multiplier(name, n, n_cols=n_cols))
            progs.append((name, n, m))
    reset_counters()
    runs = []
    for name, n, m in progs:
        a = rng.integers(0, 1 << n, (c, rows), dtype=np.uint64)
        b = rng.integers(0, 1 << n, (c, rows), dtype=np.uint64)
        # the reference's edge pairs (tests/test_multipliers.py::_check)
        a[0, :4] = [0, (1 << n) - 1, 1, (1 << n) - 1]
        b[0, :4] = [0, (1 << n) - 1, (1 << n) - 1, 1]
        state = ex.blank_state(c, n_cols, rows, device=dev)
        for cols, v in ((m.a_cols, a), (m.b_cols, b)):
            ex.write_numbers(state, cols,
                             torch.from_numpy(v.view(np.int64)).to(dev))
        mc = torch.from_numpy(m.program.to_microcode()).to(dev)
        out = engine.execute_state(state, mc, backend="cuda")
        runs.append((name, n, m, a, b, state, mc, out))
    launches = counters()[1]
    torch.cuda.synchronize()
    if launches != len(progs):
        raise AssertionError(f"{len(progs)} multiplier runs made {launches} "
                             "crossbar_exec launches")
    table = []
    for name, n, m, a, b, state, mc, out in runs:
        got = ex.read_numbers(out, m.result_cols, rows).cpu().numpy()
        if not np.array_equal(got.view(np.uint64), a * b):
            bad = np.argwhere(got.view(np.uint64) != a * b)[0]
            raise AssertionError(f"{name} {n}-bit product wrong at "
                                 f"(crossbar, row) {tuple(bad)}")
        e = max_abs_err(out[:2], crossbar_exec_ref(state[:2], mc))
        if e:
            raise AssertionError(f"{name} {n}-bit: crossbar_exec state != "
                                 f"plain on 2 crossbars: max abs error {e}")
        st = m.program.stats()
        g_rows = mc.shape[0]
        groups = plan(mc, n_cols).n_groups
        ms = cuda_ms(lambda i: engine.execute_state(state, mc,
                                                    backend="cuda"), 10)
        bound, by = crossbar_bound_ms(c, n_cols, w_words, mc)
        row = dict(program=name, n=n, gates=g_rows, cycles=st.cycles,
                   groups=groups, gates_per_group=g_rows / groups, ms=ms,
                   bound_ms=bound, bound_by=by,
                   mults_per_s=c * rows / (ms * 1e-3), max_abs_err=e)
        table.append(row)
        say(f"[multipliers] {name:12s} n={n:2d}: {g_rows:6d} gates, "
            f"{st.cycles:6d} cycles, {groups:5d} groups "
            f"({g_rows / groups:5.2f} gates/group) | {ms:8.4f} ms per launch"
            f" of {c} x {rows} rows | bound {bound * 1e3:7.2f} us "
            f"({row['bound_by']}, {bound / ms * 100:5.2f}%) | "
            f"{row['mults_per_s'] / 1e6:8.2f} M mults/s | products exact, "
            "state == plain on 2 crossbars")
    return launches, table


# --------------------------------------------------------------------------
# phases 4 and 5: serve full-width qwen1.5-0.5b
# --------------------------------------------------------------------------

def reset_counters():
    from repro_torch.kernels import pim_bits
    from repro_torch.kernels.crossbar_exec import crossbar_exec
    from repro_torch.kernels.quant_matmul import quant_matmul_int

    quant_matmul_int.launches = 0
    crossbar_exec.launches = 0
    pim_bits.launches.update(write=0, read=0)


def counters():
    from repro_torch.kernels.crossbar_exec import crossbar_exec
    from repro_torch.kernels.quant_matmul import quant_matmul_int

    return quant_matmul_int.launches, crossbar_exec.launches


def serve_requests(params, cfg, dev, trace, arrival=None, **kw):
    """Serve ``trace`` [(prompt, new tokens)] through the scheduler with
    ``ServingConfig(**kw)``, every request arriving at ``arrival`` (on the
    scheduler's clock; default now); returns the tokens in submission
    order, the metrics summary and the wall time."""
    from repro_torch.launch.serve import serve_trace
    from repro_torch.serving import make_request

    at = time.monotonic() if arrival is None else arrival
    reqs = [make_request(p, n, arrival_time=at) for p, n in trace]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results, summary = serve_trace(params, cfg, reqs, device=dev, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    toks = [results[r.rid] for r in reqs]
    if summary["n_finished"] != len(trace):
        raise AssertionError(f"served {summary['n_finished']} of "
                             f"{len(trace)} requests")
    for (_, n), t in zip(trace, toks):
        if len(t) != n or t.min() < 0 or t.max() >= cfg.padded_vocab:
            raise AssertionError(f"bad tokens {t}")
    if summary["decode_traces"] != 1:
        raise AssertionError(f"decode step saw {summary['decode_traces']} "
                             "input shapes, expected 1")
    return [t.tolist() for t in toks], summary, wall


def serve(params, cfg, dev, *, n_requests, prompt_lens, max_new, max_batch,
          seed, paged=True, arrival=None, **kw):
    """A synthetic trace through the scheduler (paged unless ``paged`` is
    False) with ``ServingConfig(**kw)`` besides; returns the tokens in
    submission order, the summary and the wall time
    (``serve_requests``)."""
    from repro_torch.serving import synthetic_requests

    reqs = synthetic_requests(n_requests, vocab_size=cfg.vocab_size,
                              prompt_lens=prompt_lens,
                              max_new_tokens=max_new, seed=seed)
    # a recurrent stack serves unpadded prompts (its state folds padding)
    bucket = 1 if cfg.has_recurrent_blocks else max(8, max(prompt_lens) // 4)
    return serve_requests(params, cfg, dev,
                          [(r.prompt, r.max_new_tokens) for r in reqs],
                          arrival=arrival, max_batch=max_batch, paged=paged,
                          prompt_bucket=bucket, **kw)


def prefill_logits(params, cfg, tokens):
    from repro_torch.models import model_lib as M

    with torch.no_grad():
        logits, _ = M.prefill(params, {"tokens": tokens}, cfg)
    torch.cuda.synchronize()
    return logits


# the quant phases' traces (``serve``'s arguments): qwen1.5-0.5b's and
# granite-moe-1b-a400m's, served again by ``serve_tp``
QUANT_TRACE = dict(n_requests=8, prompt_lens=(16, 32, 48, 64), max_new=16,
                   max_batch=4, seed=4)
# (granite-moe's quant serves are host-bound on its expert loop: 4
# requests, one batch)
MOE_QUANT_TRACE = dict(n_requests=4, prompt_lens=(16, 32, 48, 64), max_new=8,
                       max_batch=4, seed=20)


def trace_len(trace):
    return max(trace["prompt_lens"]) + trace["max_new"]


def serve_quant(params, base_cfg, dev):
    from repro_torch.kernels.quant_matmul import ops, quant_matmul_int_ref

    plens, max_new = QUANT_TRACE["prompt_lens"], QUANT_TRACE["max_new"]
    cfg = base_cfg.scaled(pim_mode="quant",
                          max_seq_len=trace_len(QUANT_TRACE))
    toks = torch.as_tensor(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (1, 64)), device=dev)
    reset_counters()
    got = prefill_logits(params, cfg, toks)
    per_prefill = counters()[0]
    with mock.patch.object(ops, "quant_matmul_int", quant_matmul_int_ref):
        want = prefill_logits(params, cfg, toks)
    if not (torch.isfinite(got).all() and torch.equal(got, want)):
        raise AssertionError("full-width quant prefill logits differ "
                             "between the kernel and the plain GEMM")
    say(f"[quant] full-width 64-token prefill logits {tuple(got.shape)}: "
        f"kernel == plain GEMM (identical); {per_prefill} quant_matmul_int "
        "launches in the prefill")

    reset_counters()
    results, summary, wall = serve(params, cfg, dev, **QUANT_TRACE)
    q_launches, x_launches = counters()
    if q_launches <= 0:
        raise AssertionError("the quant serve never launched "
                             "quant_matmul_int")
    say(f"[quant] served {summary['n_finished']}/{summary['n_requests']} "
        f"requests (prompts {plens}, {max_new} new tokens, max_batch 4, "
        f"paged) in {wall:.2f} s: {summary['total_tokens']} tokens @ "
        f"{summary['tokens_per_s']:.2f} tok/s | mean TTFT "
        f"{summary['mean_ttft_s'] * 1e3:.1f} ms | mean TPOT "
        f"{summary['mean_tpot_s'] * 1e3:.2f} ms | decode_traces "
        f"{summary['decode_traces']} | quant_matmul_int launches "
        f"{q_launches} | crossbar_exec launches {x_launches}")
    say(f"[quant] sample generation: {results[0]}")
    return q_launches, cfg, results


def serve_pim(params, base_cfg, dev):
    from repro_torch.pim import engine

    plen, max_new = 16, 4
    cfg = base_cfg.scaled(pim_mode="pim_sim", max_seq_len=plen + max_new)
    toks = torch.as_tensor(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (1, plen)), device=dev)
    reset_counters()
    info0 = engine.cache_info()
    t0 = time.perf_counter()
    got = prefill_logits(params, cfg, toks)
    t_kernel = time.perf_counter() - t0
    per_prefill = counters()[1]
    info = engine.cache_info()
    if info.resident_entries != info0.resident_entries or \
            info.exec_uploads != info0.exec_uploads:
        raise AssertionError("a pim_sim prefill kept crossbar state "
                             "resident")

    with mock.patch.object(engine, "matmul_int", exact_matmul):
        want = prefill_logits(params, cfg, toks)
    if not (torch.isfinite(got).all() and torch.equal(got, want)):
        raise AssertionError("full-width pim_sim prefill logits differ from "
                             "the exact 7-bit integer product")
    say(f"[pim_sim] full-width {plen}-token prefill logits "
        f"{tuple(got.shape)} on the crossbar kernel == exact 7-bit integer "
        f"product with the same float64 rescale (bit-identical); crossbar "
        f"prefill {t_kernel:.2f} s on transient state "
        f"({info.exec_transient - info0.exec_transient} chunk GEMMs, none "
        f"kept resident), {per_prefill} crossbar_exec launches")

    def serve_once(label):
        info0 = engine.cache_info()
        reset_counters()
        results, summary, wall = serve(params, cfg, dev, n_requests=2,
                                       prompt_lens=(plen,), max_new=max_new,
                                       max_batch=2, seed=6)
        q_launches, x_launches = counters()
        info = engine.cache_info()
        # uploads count resident state only, i.e. the decode steps';
        # prefill runs on transient state, counted apart
        uploads = info.exec_uploads - info0.exec_uploads
        if x_launches <= 0:
            raise AssertionError("the pim_sim serve never launched "
                                 "crossbar_exec")
        say(f"[pim_sim] {label}: served {summary['n_finished']}/"
            f"{summary['n_requests']} requests ({plen}-token prompts, "
            f"{max_new} new tokens, max_batch 2, paged) in {wall:.2f} s: "
            f"{summary['tokens_per_s']:.3f} tok/s | mean TTFT "
            f"{summary['mean_ttft_s'] * 1e3:.1f} ms | mean TPOT "
            f"{summary['mean_tpot_s'] * 1e3:.1f} ms | crossbar_exec launches "
            f"{x_launches} | quant_matmul_int launches {q_launches} | "
            f"decode exec_hits {info.exec_hits - info0.exec_hits} "
            f"exec_uploads {uploads} | prefill (transient) "
            f"{info.exec_transient - info0.exec_transient} | resident "
            f"{info.resident_entries} states, "
            f"{info.resident_bytes / 2 ** 30:.2f} GiB")
        return results, x_launches, uploads

    results, x_launches, _ = serve_once("first serve")
    again, _, uploads = serve_once("second serve, same weights")
    if uploads:
        raise AssertionError(f"the second serve's decode steps made "
                             f"{uploads} cold uploads of the same weights, "
                             "expected 0")
    with mock.patch.object(engine, "matmul_int", exact_matmul):
        want, _, _ = serve(params, cfg, dev, n_requests=2,
                           prompt_lens=(plen,), max_new=max_new, max_batch=2,
                           seed=6)
    if not results == again == want:
        raise AssertionError(f"served tokens differ between serves "
                             f"({results} vs {again}) or from the exact "
                             f"integer product ({want})")
    say(f"[pim_sim] tokens (both serves == exact 7-bit integer product): "
        f"{results}")
    return x_launches, cfg, results


def spec_line(tag, summary, wall):
    say(f"{tag} {summary['n_finished']} requests in {wall:.2f} s: "
        f"{summary['tokens_per_s']:.3f} tok/s | mean TTFT "
        f"{summary['mean_ttft_s'] * 1e3:.1f} ms | mean TPOT "
        f"{summary['mean_tpot_s'] * 1e3:.2f} ms | verify steps "
        f"{summary['verify_steps']} | accept length histogram (per slot and "
        f"round) {summary['accept_len_hist']} | mean accept length "
        f"{summary['mean_accept_len']:.3f} | accepted "
        f"{summary['accepted_tokens']} of {summary['verified_tokens']} "
        f"verified ({summary['drafted_tokens']} drafted), "
        f"{summary['accepted_per_step']:.3f} tokens per slot and round")


def check_spec_counts(label, summary, launches, want):
    for key in ("draft_traces", "verify_traces"):
        if summary[key] != 1:
            raise AssertionError(f"{label}: {key} is {summary[key]}, "
                                 "expected 1")
    if launches != want:
        raise AssertionError(f"{label}: (quant_matmul_int, crossbar_exec) "
                             f"launches {launches}, expected {want}")


def serve_quant_spec(params, qcfg, dev, plain):
    """The quant phase's trace with speculation: verify quant, draft xla,
    draft_k 4.  Tokens equal the plain quant serve's; each round is one
    verify step of 168 GEMM launches at M = 16 (the xla draft launches
    none).  Returns the serve's quant_matmul_int launches."""
    n_layers = qcfg.n_layers
    reset_counters()
    got, summary, wall = serve(params, qcfg, dev, n_requests=8,
                               prompt_lens=(16, 32, 48, 64), max_new=16,
                               max_batch=4, seed=4, speculative=True,
                               draft_mode="xla", draft_k=4)
    launches = counters()
    spec_line("[quant spec]", summary, wall)
    rounds = summary["verify_steps"]
    check_spec_counts("quant spec", summary, launches,
                      (7 * n_layers * (rounds + 8), 0))
    if got != plain:
        bad = [i for i, (a, b) in enumerate(zip(plain, got)) if a != b]
        raise AssertionError(f"quant speculative tokens differ from plain "
                             f"quant at requests {bad}: "
                             f"{[got[i] for i in bad]} vs "
                             f"{[plain[i] for i in bad]}")
    say(f"[quant spec] tokens == plain quant serve for all 8 requests; "
        f"quant_matmul_int launches {launches[0]} = {7 * n_layers} x "
        f"({rounds} verify steps + 8 prefills)")
    return launches[0]


def serve_pim_spec(params, base_cfg, dev):
    """pim_sim verify, quant draft, draft_k 3, max_batch 2: served once
    without speculation (tokens held to the exact integer product), then
    twice with it (tokens equal; the second serve's verify steps make no
    cold upload).  Returns the first speculative serve's launches."""
    from repro_torch.pim import engine

    plen, max_new, k = 16, 8, 3
    n_layers = base_cfg.n_layers
    cfg = base_cfg.scaled(pim_mode="pim_sim", max_seq_len=plen + max_new)
    kw = dict(n_requests=2, prompt_lens=(plen,), max_new=max_new,
              max_batch=2, seed=12)
    plain, s0, w0 = serve(params, cfg, dev, **kw)
    with mock.patch.object(engine, "matmul_int", exact_matmul):
        want, _, _ = serve(params, cfg, dev, **kw)
    say(f"[pim_sim spec] plain serve (2 requests, {plen}-token prompts, "
        f"{max_new} new tokens, max_batch 2) in {w0:.2f} s, mean TPOT "
        f"{s0['mean_tpot_s'] * 1e3:.1f} ms: tokens {plain} (exact product "
        f"{want})")
    if plain != want:
        raise AssertionError("plain pim_sim tokens differ from the exact "
                             "integer product")
    out = []
    for label in ("first speculative serve", "second speculative serve"):
        info0 = engine.cache_info()
        reset_counters()
        got, summary, wall = serve(params, cfg, dev, speculative=True,
                                   draft_mode="quant", draft_k=k, **kw)
        launches = counters()
        info = engine.cache_info()
        uploads = info.exec_uploads - info0.exec_uploads
        spec_line(f"[pim_sim spec] [{label}]", summary, wall)
        rounds = summary["verify_steps"]
        say(f"[pim_sim spec] [{label}] launches (quant_matmul_int, "
            f"crossbar_exec) {launches} | verify uploads {uploads}, hits "
            f"{info.exec_hits - info0.exec_hits} | prefill (transient) "
            f"{info.exec_transient - info0.exec_transient} | resident "
            f"{info.resident_entries} states, "
            f"{info.resident_bytes / 2 ** 30:.2f} GiB")
        check_spec_counts(f"pim_sim {label}", summary, launches,
                          (7 * n_layers * (k - 1) * rounds,
                           7 * n_layers * (rounds + 2)))
        if got != plain:
            raise AssertionError(f"pim_sim speculative tokens {got} != plain "
                                 f"{plain} ({label})")
        out.append((launches, uploads))
    if out[1][1]:
        raise AssertionError(f"the second speculative serve's verify steps "
                             f"made {out[1][1]} cold uploads, expected 0")
    say(f"[pim_sim spec] tokens of both speculative serves == plain == exact "
        f"product; the second made 0 cold uploads")
    return out[0][0]


def prefix_logit_diffs(params, cfg, dev, prompt, other, bucket, chunk):
    """Last-token logits of ``prompt`` from whole prefill, from a resume
    after its first ``chunk`` tokens, from ``chunk``-token chunks, and
    packed behind ``other``, with the scheduler's bucket rule; returns the
    max abs difference of each from whole prefill."""
    from repro_torch.models import model_lib as M

    def rup(n):
        return -(-n // bucket) * bucket

    def run(tokens, prefix=None):
        t = torch.zeros((1, rup(len(tokens))), dtype=torch.long, device=dev)
        t[0, :len(tokens)] = torch.as_tensor(tokens, device=dev)
        return M.prefill(params, {"tokens": t}, cfg, prefix=prefix,
                         last_index=torch.tensor([len(tokens) - 1],
                                                 device=dev))

    def take(cache, n):
        return {i: {k: v[:, :, :n] for k, v in c.items()}
                for i, c in cache.items()}

    def cat(a, b):
        return {i: {k: torch.cat([v, b[i][k]], dim=2) for k, v in c.items()}
                for i, c in a.items()}

    plen = len(prompt)
    with torch.no_grad():
        whole, _ = run(prompt)
        _, head = run(prompt[:chunk])
        resumed, _ = run(prompt[chunk:], take(head, chunk))
        prefix, done = take(head, chunk), chunk
        while True:
            logits, tail = run(prompt[done:done + chunk], prefix)
            if done + chunk >= plen:
                break
            prefix, done = cat(prefix, take(tail, chunk)), done + chunk
        chunked = logits
        widths = [rup(len(other)), rup(plen)]
        toks = torch.zeros((1, sum(widths)), dtype=torch.long, device=dev)
        pos = torch.zeros(sum(widths), dtype=torch.long, device=dev)
        seg = torch.full((sum(widths),), -1, dtype=torch.long, device=dev)
        s0 = 0
        for i, (p, w) in enumerate(zip((other, prompt), widths)):
            toks[0, s0:s0 + len(p)] = torch.as_tensor(p, device=dev)
            pos[s0:s0 + w] = torch.arange(w, device=dev)
            seg[s0:s0 + len(p)] = i
            s0 += w
        last = torch.tensor([len(other) - 1, widths[0] + plen - 1],
                            device=dev)
        packed = M.prefill_packed(params, toks, pos, seg, last, cfg)[0][1:]
    torch.cuda.synchronize()
    if not all(torch.isfinite(x).all() for x in (whole, resumed, chunked,
                                                 packed)):
        raise AssertionError("non-finite prefill logits")
    return {name: float((x - whole).abs().max())
            for name, x in (("prefix-resume", resumed), ("chunked", chunked),
                            ("packed", packed))}, float(whole.abs().max())


def check_fork_cow(params, cfg, dev, prompt):
    """A fork in the paged pool at full width: the boundary block is copied
    on the sibling's first write (once), the index's blocks and the
    original's keep their bits, and the sibling's tokens equal a private
    continuation of the same prompt."""
    from repro_torch.models import model_lib as M
    from repro_torch.serving import PagedCachePool

    plen, steps = len(prompt), 4
    t = torch.as_tensor(prompt, device=dev)[None]
    with torch.no_grad():
        logits, cache = M.prefill(params, {"tokens": t}, cfg)
    first = int(torch.argmax(logits, -1)[0])
    div = (first + 1) % cfg.vocab_size

    def decode(pool, firsts):
        n = len(firsts)
        tokens = torch.tensor(firsts, device=dev)[:, None]
        pos = torch.full((n,), plen, device=dev)
        act = torch.ones(n, dtype=torch.bool, device=dev)
        outs = []
        with torch.no_grad():
            for _ in range(steps):
                for s in range(n):
                    pool.ensure_writable(s, int(pos[s]))
                tokens, _, _ = M.decode_step_slots(
                    params, tokens, pos, act, pool.caches, cfg,
                    block_tables=pool.block_tables)
                outs.append(tokens[:, 0].tolist())
                pos = pos + 1
        return [list(o) for o in zip(*outs)]

    pool = PagedCachePool(cfg, 2, cfg.max_seq_len, device=dev,
                          prefix_cache=True)
    pool.admit(0, cache, plen, plen + steps, prompt=prompt)
    pool.fork(0, 1, plen, plen + steps)
    index = sorted(pool.prefix.blocks())
    before = [leaf[:, index].clone() for _, _, leaf in pool._leaves()]
    a, b = decode(pool, [first, div])
    if pool.cow_copies != 1:
        raise AssertionError(f"fork made {pool.cow_copies} COW copies, "
                             "expected 1 (the shared boundary block)")
    for old, (_, _, leaf) in zip(before, pool._leaves()):
        if not torch.equal(old, leaf[:, index]):
            raise AssertionError("a COW copy wrote into a block the "
                                 "prefix index holds")
    for slot in (0, 1):
        for li, c in pool.read_slot(slot).items():
            for key, leaf in c.items():
                if not torch.equal(leaf[:, :, :plen],
                                   cache[li][key][:, :, :plen]):
                    raise AssertionError(f"slot {slot} lost its prompt's "
                                         f"{key} rows in the COW copy")
    solo = PagedCachePool(cfg, 1, cfg.max_seq_len, device=dev)
    solo.admit(0, cache, plen, plen + steps)
    (private,) = decode(solo, [div])
    if private != b:
        raise AssertionError(f"forked sibling {b} != private continuation "
                             f"{private}")
    pool.evict(0)
    pool.evict(1)
    if pool.blocks_in_use != pool.prefix.n_blocks or pool.has_shared:
        raise AssertionError("fork left blocks referenced after eviction")
    return pool.cow_copies, len(index), a, b


def serve_quant_prefix(params, base_cfg, dev):
    """The quant trace on the plain path and through the prefix cache,
    chunked and packed prefill: equal tokens, and every feature used.
    Returns the feature path's quant_matmul_int launches, the trace and
    its tokens."""
    from repro_torch.serving import synthetic_requests

    max_new = 16
    cfg = base_cfg.scaled(pim_mode="quant", max_seq_len=32 + 48 + max_new)
    short = synthetic_requests(4, vocab_size=cfg.vocab_size,
                               prompt_lens=(8, 16), max_new_tokens=max_new,
                               seed=9)
    shared = synthetic_requests(8, vocab_size=cfg.vocab_size,
                                prompt_lens=(8, 16, 48),
                                max_new_tokens=max_new, shared_prefix_len=32,
                                seed=10)
    trace = [(r.prompt, r.max_new_tokens) for r in short + shared]
    base = dict(max_batch=4, prompt_bucket=16)
    feats = dict(prefix_cache=True, prefill_chunk=32, step_token_budget=64,
                 packed_prefill=True)
    plain, s1, w1 = serve_requests(params, cfg, dev, trace, paged=True,
                                   **base)
    reset_counters()
    got, s2, w2 = serve_requests(params, cfg, dev, trace, **base, **feats)
    q_launches, x_launches = counters()
    for label, s, w in (("plain path", s1, w1),
                        ("prefix cache + chunked + packed", s2, w2)):
        say(f"[quant prefix] {label}: {s['n_finished']} requests in "
            f"{w:.2f} s, {s['tokens_per_s']:.2f} tok/s | mean TTFT "
            f"{s['mean_ttft_s'] * 1e3:.1f} ms | mean TPOT "
            f"{s['mean_tpot_s'] * 1e3:.2f} ms | p99 TPOT "
            f"{s['p99_tpot_s'] * 1e3:.2f} ms")
    say(f"[quant prefix] prefix hit rate {s2['prefix_hit_rate']:.3f} "
        f"({s2['prefix_tokens_reused']:.0f} prompt tokens from the index, "
        f"TTFT hit {s2['mean_ttft_hit_s'] * 1e3:.1f} ms vs miss "
        f"{s2['mean_ttft_miss_s'] * 1e3:.1f} ms) | peak blocks shared "
        f"{s2['peak_blocks_shared']:.0f} | COW copies in the serve "
        f"{s2['cow_copies']:.0f} | prefill chunks {s2['prefill_chunks']} | "
        f"packed prefills {s2['packed_prefills']} | quant_matmul_int "
        f"launches {q_launches} | crossbar_exec launches {x_launches}")
    if plain != got:
        bad = [i for i, (a, b) in enumerate(zip(plain, got)) if a != b]
        raise AssertionError(f"tokens differ between the plain path and the "
                             f"prefix/chunked/packed path at requests {bad}: "
                             f"{[plain[i] for i in bad]} vs "
                             f"{[got[i] for i in bad]}")
    for key in ("prefix_hit_rate", "prefill_chunks", "packed_prefills"):
        if not s2[key] > 0:
            raise AssertionError(f"{key} is {s2[key]}, expected > 0")
    if q_launches <= 0:
        raise AssertionError("the prefix/chunked/packed serve never launched "
                             "quant_matmul_int")
    say(f"[quant prefix] tokens equal on both paths for all {len(trace)} "
        f"requests; sample {got[-1]}")

    diffs, mag = prefix_logit_diffs(params, cfg, dev, shared[2].prompt,
                                    short[1].prompt, 16, 32)
    say(f"[quant prefix] last-token logits of one {len(shared[2].prompt)}-"
        f"token prompt (|logit| <= {mag:.4f}), max abs difference from "
        f"whole prefill: " + ", ".join(f"{k} {v:.6g}"
                                       for k, v in diffs.items())
        + f" (tolerance {PREFIX_LOGIT_TOL})")
    if max(diffs.values()) > PREFIX_LOGIT_TOL:
        raise AssertionError(f"prefill logits differ beyond "
                             f"{PREFIX_LOGIT_TOL}: {diffs}")
    cow, n_index, a, b = check_fork_cow(params, cfg, dev, shared[0].prompt)
    say(f"[quant prefix] fork of a {len(shared[0].prompt)}-token prompt in "
        f"the paged pool: {cow} COW copy of the shared boundary block, the "
        f"index's {n_index} blocks unchanged, sibling {b} == its private "
        f"continuation (original {a})")
    return q_launches, trace, plain


def serve_pim_prefix(params, base_cfg, dev):
    """pim_sim through the prefix cache and chunked prefill, tokens held to
    the exact integer product; then one 64-token prompt under a memory
    high-water mark.  Returns the prefix path's crossbar_exec launches."""
    from repro_torch.pim import engine
    from repro_torch.serving import synthetic_requests

    max_new = 4
    cfg = base_cfg.scaled(pim_mode="pim_sim", max_seq_len=32 + max_new)
    reqs = synthetic_requests(3, vocab_size=cfg.vocab_size,
                              prompt_lens=(16,), max_new_tokens=max_new,
                              shared_prefix_len=16, seed=8)
    trace = [(r.prompt, r.max_new_tokens) for r in reqs]
    kw = dict(max_batch=2, prompt_bucket=16, prefix_cache=True,
              prefill_chunk=16)
    info0 = engine.cache_info()
    reset_counters()
    got, s, wall = serve_requests(params, cfg, dev, trace, **kw)
    x_launches = counters()[1]
    info = engine.cache_info()
    with mock.patch.object(engine, "matmul_int", exact_matmul):
        want, _, _ = serve_requests(params, cfg, dev, trace, **kw)
    say(f"[pim_sim prefix] 3 requests (16-token shared prefix + 16-token "
        f"tails, {max_new} new tokens, max_batch 2, prefix cache, 16-token "
        f"chunks) in {wall:.2f} s: prefix hit rate "
        f"{s['prefix_hit_rate']:.3f}, prefill chunks {s['prefill_chunks']}, "
        f"mean TTFT {s['mean_ttft_s'] * 1e3:.1f} ms, mean TPOT "
        f"{s['mean_tpot_s'] * 1e3:.1f} ms | crossbar_exec launches "
        f"{x_launches} | decode uploads "
        f"{info.exec_uploads - info0.exec_uploads}, prefill (transient) "
        f"{info.exec_transient - info0.exec_transient}")
    if got != want:
        raise AssertionError(f"pim_sim prefix/chunked tokens {got} != exact "
                             f"integer product {want}")
    if not (s["prefix_hit_rate"] > 0 and s["prefill_chunks"] > 0
            and x_launches > 0):
        raise AssertionError("the pim_sim prefix phase used no prefix hit, "
                             "no chunk or no crossbar launch")
    say(f"[pim_sim prefix] tokens == exact 7-bit integer product: {got}")

    plen = 64
    cfg64 = base_cfg.scaled(pim_mode="pim_sim", max_seq_len=plen + max_new)
    prompt = np.random.default_rng(11).integers(0, cfg.vocab_size, plen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_bytes = torch.cuda.memory_allocated()
    got64, _, wall64 = serve_requests(params, cfg64, dev,
                                      [(prompt, max_new)], max_batch=2,
                                      prompt_bucket=16, paged=True)
    peak = torch.cuda.max_memory_allocated()
    info = engine.cache_info()
    with mock.patch.object(engine, "matmul_int", exact_matmul):
        want64, _, _ = serve_requests(params, cfg64, dev,
                                      [(prompt, max_new)], max_batch=2,
                                      prompt_bucket=16, paged=True)
    say(f"[pim_sim 64] one {plen}-token prompt, {max_new} new tokens, in "
        f"{wall64:.2f} s: peak allocated {peak / 2 ** 30:.2f} GiB (limit "
        f"{PIM_PEAK_BYTES / 2 ** 30:.0f} GiB; {base_bytes / 2 ** 30:.2f} GiB "
        f"allocated before it) | resident after it: "
        f"{info.resident_entries} states, "
        f"{info.resident_bytes / 2 ** 30:.2f} GiB | tokens {got64} "
        f"(exact product {want64})")
    if peak >= PIM_PEAK_BYTES:
        raise AssertionError(f"the 64-token pim_sim phase peaked at {peak} "
                             f"bytes, limit {PIM_PEAK_BYTES}")
    if got64 != want64:
        raise AssertionError("64-token pim_sim tokens differ from the exact "
                             "integer product")
    return x_launches


def profile_decode(params, cfg, dev, max_batch, top=6, max_new=4,
                   flops=False, **kw):
    """Profile one decode step of a warm scheduler (``ServingConfig(**kw)``
    besides; a speculative scheduler's step is one round) with
    ``profile_call``; it must make one launch of its mode's kernel per
    linear.  With ``flops`` the next step (the same shapes) runs under
    ``FlopCounterMode``: ``prof["flops"]`` is its count and
    ``prof["decode_args"]`` the ``(shape, dtype)`` tree of its
    ``decode_step_slots`` call (``dryrun_roofline`` runs that call on fake
    tensors)."""
    from repro_torch.serving import (Scheduler, ServingConfig,
                                     synthetic_requests)

    sched = Scheduler(params, cfg, ServingConfig(
        max_batch=max_batch, paged=True,
        prompt_bucket=1 if cfg.has_recurrent_blocks else 16, **kw),
        device=dev)
    for r in synthetic_requests(max_batch, vocab_size=cfg.vocab_size,
                                prompt_lens=(16,), max_new_tokens=max_new,
                                seed=7,
                                start_time=time.monotonic()):
        sched.submit_request(r)
    sched.step()                      # admit + one decode step (warm)
    name = f"{cfg.name} {cfg.pim_mode} decode step, batch {max_batch}"
    if kw.get("speculative"):
        name = (f"{cfg.name} {cfg.pim_mode} speculative round (draft "
                f"{kw['draft_mode']}, k {kw['draft_k']}), batch {max_batch}")
    prof = profile_call(name, sched.step, top)
    check_step_launches(cfg, prof["launches"], len(step_linears(cfg)))
    if flops:
        prof.update(step_flops(sched))
    return prof


def step_flops(sched):
    """One more step of ``sched`` under ``FlopCounterMode``: its count, and
    the ``(shape, dtype)`` tree of the ``decode_step_slots`` call in it."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.models import model_lib as M
    from repro_torch.tree import leaves, rebuild

    real = M.decode_step_slots
    seen = []

    def rec(params, tokens, pos, active, caches, cfg, block_tables=None):
        seen.append(rebuild(
            {"params": params, "caches": caches, "tokens": tokens,
             "pos": pos, "active": active, "block_tables": block_tables},
            ((tuple(t.shape), t.dtype) for _, t in leaves(
                {"params": params, "caches": caches, "tokens": tokens,
                 "pos": pos, "active": active,
                 "block_tables": block_tables}))))
        return real(params, tokens, pos, active, caches, cfg,
                    block_tables=block_tables)

    counter = FlopCounterMode(display=False)
    with mock.patch.object(M, "decode_step_slots", rec), counter:
        sched.step()
    torch.cuda.synchronize()
    if len(seen) != 1:
        raise AssertionError(f"the counted step made {len(seen)} decode "
                             "calls, expected 1")
    return dict(flops=int(counter.get_total_flops()), decode_args=seen[0])


def check_step_launches(cfg, launches, per_step):
    """One launch of the mode's kernel per linear (a speculative round's
    drafts may launch the other kernel too)."""
    which = {"quant": 0, "pim_sim": 1}.get(cfg.pim_mode)
    if which is not None and launches[which] != per_step:
        raise AssertionError(
            f"the {cfg.pim_mode} step made {launches[which]} "
            f"{('quant_matmul_int', 'crossbar_exec')[which]} launches, "
            f"expected one per linear: {per_step}")


def profile_call(name, fn, top=6):
    """``fn()`` under torch.profiler: wall and device-busy time, kernel
    launches (the counters read just before and just after), memset
    nodes, the ``top`` kernels by device time and the port's own kernels,
    printed; returns them with ``fn``'s result."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    before = counters()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = tuple(b - a for a, b in zip(before, counters()))
    events = prof.key_averages()
    # device events but the spans of record_function ranges
    kernels = sorted((e for e in events
                      if e.device_type == torch.autograd.DeviceType.CUDA
                      and not getattr(e, "is_user_annotation", False)),
                     key=lambda e: -e.self_device_time_total)
    dev_us = sum(e.self_device_time_total for e in kernels)
    host_us = sum(e.self_cpu_time_total for e in events)
    memsets = sum(e.count for e in kernels if "memset" in e.key.lower())
    say(f"[profile] {name}: wall {wall * 1e3:.2f} ms, device busy "
        f"{dev_us / 1e3:.2f} ms ({dev_us / 1e3 / (wall * 1e3) * 100:.1f}%), "
        f"host ops {host_us / 1e3:.2f} ms, launches (quant_matmul_int, "
        f"crossbar_exec) {launches}, memset nodes {memsets}")
    ours = [e for e in kernels[top:] if "quant_matmul_kernel" in e.key
            or "crossbar_exec_kernel" in e.key]
    for e in kernels[:top] + ours:
        say(f"[profile] {name}: {e.self_device_time_total / 1e3:9.3f} ms "
            f"{e.count:5d} x {e.self_device_time_total / e.count:9.2f} us  "
            f"{e.key[:70]}")
    return dict(wall_ms=wall * 1e3, busy_ms=dev_us / 1e3,
                host_ops_ms=host_us / 1e3, events=events, launches=launches,
                out=out)


def ranged(module, name):
    """``module.name`` wrapped in a ``record_function`` range of its name
    (a patch for a profiled step)."""
    real = getattr(module, name)

    def call(*a, **kw):
        with torch.profiler.record_function(name):
            return real(*a, **kw)

    return mock.patch.object(module, name, call)


def fmt_ms(v):
    """A time in ms, or "not measured" where a trace lost it."""
    return "not measured" if v is None else f"{v:.2f} ms"


def range_times(prof, name):
    """(host ms, calls, device-span ms) of a ``record_function`` range in
    a profile (None where the trace lost it)."""
    cuda = torch.autograd.DeviceType.CUDA
    host = [e for e in prof["events"]
            if e.key == name and e.device_type != cuda]
    span = [e for e in prof["events"]
            if e.key == name and e.device_type == cuda]
    return (host[0].cpu_time_total / 1e3 if host else None,
            host[0].count if host else 0,
            span[0].device_time_total / 1e3 if span else None)



# --------------------------------------------------------------------------
# phase 6: the partition autotuner on the crossbar kernel
# --------------------------------------------------------------------------

def serve_pim_autotune(params, base_cfg, dev, untuned):
    """``pim_sim`` on the autotuner's picks: warm a
    ``Scheduler(autotune=True, autotune_trials=1)`` (every raced candidate
    printed with its predicted and trial time), hold every raced program's
    kernel state to its grouped plain version, serve the ``pim_sim``
    phase's trace on the picks (tokens equal to ``untuned``, the exact
    integer product's; one launch per linear per decode step, each a table
    hit; after an untuned serve of the same trace, only the non-default
    picks upload decode state), time one decode-shape launch of w_in at
    every raced geometry (its state held to the plain version on its first
    and last crossbars), then save the table, clear the engine, reload
    it, and serve again with no trial.  Returns the tuned serve's crossbar_exec launches, the
    race and the geometry rows."""
    import tempfile

    from repro_torch.kernels.crossbar_exec import (crossbar_exec,
                                                   crossbar_exec_grouped_ref,
                                                   crossbar_exec_ref, plan)
    from repro_torch.pim import autotune, engine
    from repro_torch.pim.matmul import max_dot_terms
    from repro_torch.serving import (Scheduler, ServingConfig,
                                     synthetic_requests)

    plen, max_new, batch, n_bits = 16, 4, 2, 8
    per_step = 7 * base_cfg.n_layers
    cfg = base_cfg.scaled(pim_mode="pim_sim", max_seq_len=plen + max_new)
    scfg = ServingConfig(max_batch=batch, prompt_bucket=max(8, plen // 4),
                         paged=True, autotune=True, autotune_trials=1)

    def trace():
        return synthetic_requests(2, vocab_size=cfg.vocab_size,
                                  prompt_lens=(plen,), max_new_tokens=max_new,
                                  seed=6)

    def groups(p):
        art = engine.compile_matmul(p.chunk, n_bits, model=p.model,
                                    n_cols=p.n_cols)
        mc = art.microcode_on(dev)
        return mc, plan(mc, p.n_cols).n_groups

    reset_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sched = Scheduler(params, cfg, scfg, device=dev)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    warm_launches = counters()[1]
    info = engine.cache_info()
    say(f"[autotune] warmup (plan_for_params over the parameter tree at "
        f"batch {batch}, 1 trial per candidate) in {warm_s:.2f} s: "
        f"{sched.autotuned_shapes} keys, {info.tune_trials} trials, "
        f"{warm_launches} crossbar_exec launches")
    # the picks, read as serving reads them: (K, O) of every 2-D and
    # layer-stacked 3-D leaf, as plan_for_params walks the tree
    shapes = set()
    stack = [params]
    while stack:
        t = stack.pop()
        if isinstance(t, dict):
            stack.extend(t.values())
        elif isinstance(t, (list, tuple)):
            stack.extend(t)
        elif getattr(t, "dim", lambda: 0)() in (2, 3):
            shapes.add((int(t.shape[-2]), int(t.shape[-1])))

    def pick_of(k, o):
        return autotune.lookup(k, n_bits, shape=(batch, o),
                               pim_mode="pim_sim")

    picks = {pick_of(k, o).key: pick_of(k, o) for k, o in sorted(shapes)}
    raced = sum(bool(p.race) for p in picks.values())
    if sched.autotuned_shapes != 5 or len(picks) != 5 or raced != 5:
        raise AssertionError(f"warmup planned {sched.autotuned_shapes} keys, "
                             f"{len(picks)} picks, {raced} raced; expected 5")
    race_rows, configs = [], {}
    for key, pick in sorted(picks.items()):
        if pick.vs_default < 1.0 or not any(
                (p.model, p.n_cols) == ("minimal", 1024) for p in pick.race):
            raise AssertionError(f"{key}: the default did not race, or the "
                                 f"pick {pick} is slower than it")
        for p in pick.race:
            mc, n_groups = groups(p)
            configs[(p.model, p.n_cols, p.chunk)] = mc
            chosen = (p.model, p.n_cols, p.chunk) == \
                (pick.model, pick.n_cols, pick.chunk)
            row = dict(key=key, model=p.model, n_cols=p.n_cols,
                       chunk=p.chunk, rows=int(mc.shape[0]), groups=n_groups,
                       predicted_us=p.predicted_us, trial_us=p.trial_us,
                       default_us=p.default_us,
                       vs_default=p.default_us / p.trial_us, pick=chosen)
            race_rows.append(row)
            say(f"[autotune] {key}: {p.model:9s} n_cols={p.n_cols} "
                f"chunk={p.chunk:3d} groups={n_groups:5d} | predicted "
                f"{p.predicted_us:12.1f} us | trial {p.trial_us:10.1f} us | "
                f"default {p.default_us:10.1f} us | vs_default "
                f"{row['vs_default']:.3f}" + (" | PICK" if chosen else ""))

    # every raced program, and every partition model at every geometry of
    # w_in's candidates (raced or not): one launch over 3 crossbars of
    # random state == its grouped plain version on the host, bit for bit
    for p in autotune.candidates(base_cfg.d_model, n_bits,
                                 (batch, base_cfg.d_ff), "pim_sim",
                                 device=dev):
        if p.chunk > 0:
            configs.setdefault((p.model, p.n_cols, p.chunk), groups(p)[0])
    g = torch.Generator(device=dev).manual_seed(17)
    for (model, n_cols, chunk), mc in sorted(configs.items()):
        st = torch.randint(-2 ** 31, 2 ** 31 - 1, (3, n_cols, 8),
                           dtype=torch.int32, device=dev, generator=g)
        p = plan(mc, n_cols)
        got = crossbar_exec(st, mc).cpu()
        want = crossbar_exec_grouped_ref(st.cpu(), p.rows, p.offsets)
        if not torch.equal(got, want):
            raise AssertionError(f"crossbar_exec != grouped plain version on "
                                 f"the {model} {chunk}-term program at "
                                 f"{n_cols} columns")
        say(f"[autotune] {model:9s} n_cols={n_cols} chunk={chunk:3d}: "
            f"{mc.shape[0]} rows in {p.n_groups} groups, kernel state == "
            "grouped plain version")
    say(f"[autotune] crossbar_exec == grouped plain version (identical "
        f"state, 3 crossbars of random state) on {len(configs)} programs, "
        f"every raced one and every w_in candidate: {sorted(configs)}")

    # the decode step's launches per picked (model, geometry, chunk), and
    # the crossbar states its non-default picks upload: each layer-stacked
    # weight of a block is one linear per layer, of ceil(K / chunk) chunks
    default = ("minimal", 1024, max_dot_terms(n_bits, 1024))
    per_geometry, want_uploads = {}, 0
    for name, wt in params["blocks"]["0"].items():
        if name.startswith("w") and wt.dim() == 3:
            q = pick_of(wt.shape[1], wt.shape[2])
            cfg_key = (q.model, q.n_cols, q.chunk)
            n = wt.shape[0] * len(params["blocks"])
            per_geometry[cfg_key] = per_geometry.get(cfg_key, 0) + n
            if cfg_key != default:
                want_uploads += n * -(-wt.shape[1] // q.chunk)
    if sum(per_geometry.values()) != per_step:
        raise AssertionError(f"picks cover {per_geometry}, expected "
                             f"{per_step} linears")
    say(f"[autotune] decode-step launches per picked (model, n_cols, chunk): "
        f"{per_geometry}")

    # an untuned serve leaves the default's decode states resident; a tuned
    # linear whose pick is the default shares them, so only the other
    # picks upload
    autotune.enable(False)
    plain = Scheduler(params, cfg, dataclasses.replace(scfg, autotune=False),
                      device=dev)
    rids = [plain.submit_request(r) for r in trace()]
    out = plain.run()
    if [out[r].tolist() for r in rids] != untuned:
        raise AssertionError("untuned serve after the warmup: tokens differ "
                             f"from the exact integer product {untuned}")
    autotune.enable(True)

    # the tuned serve, counted from its first submission to its end
    reqs = trace()
    info0 = engine.cache_info()
    reset_counters()
    t0 = time.perf_counter()
    rids = [sched.submit_request(r) for r in reqs]
    steps = []
    while len(sched.queue) or sched.active_slots.any():
        n0, h0 = counters()[1], autotune.table_info().hits
        sched.step()
        steps.append((counters()[1] - n0, autotune.table_info().hits - h0))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counters()[1]
    info = engine.cache_info()
    got = [sched.output(r).tolist() for r in rids]
    say(f"[autotune] tuned serve (2 requests, {plen}-token prompts, "
        f"{max_new} new tokens, max_batch {batch}, paged) in {wall:.2f} s: "
        f"(crossbar_exec launches, table hits) per step {steps} | "
        f"launches {launches} | decode uploads "
        f"{info.exec_uploads - info0.exec_uploads}, hits "
        f"{info.exec_hits - info0.exec_hits}, prefill (transient) "
        f"{info.exec_transient - info0.exec_transient}")
    if got != untuned:
        raise AssertionError(f"tuned pim_sim tokens {got} != untuned (exact "
                             f"integer product) {untuned}")
    uploads = info.exec_uploads - info0.exec_uploads
    if uploads != want_uploads:
        raise AssertionError(f"tuned serve after the untuned one made "
                             f"{uploads} decode uploads, expected "
                             f"{want_uploads} (the non-default picks' "
                             "chunks only)")
    # the first step admits both prompts (one launch per linear each) and
    # decodes; every later step only decodes
    if steps[0][0] != 3 * per_step or any(
            n != per_step or h < per_step for n, h in steps[1:]):
        raise AssertionError(f"tuned decode steps made (launches, hits) "
                             f"{steps}, expected {per_step} launches and "
                             f">= {per_step} table hits per decode step")
    say(f"[autotune] tuned tokens == untuned == exact 7-bit integer product: "
        f"{got}; {per_step} crossbar_exec launches per decode step, each a "
        f"table hit; {uploads} decode uploads, all of non-default picks")

    # one decode-shape launch of w_in (K=1024, O=2816, M=2 at full width)
    # per raced geometry, the default's included
    pick = pick_of(base_cfg.d_model, base_cfg.d_ff)
    geo_rows = []
    for p in pick.race:
        mc = configs[(p.model, p.n_cols, p.chunk)]
        c = (-(-base_cfg.d_model // p.chunk)
             * -(-batch * base_cfg.d_ff // 256))
        st = torch.randint(-2 ** 31, 2 ** 31 - 1, (c, p.n_cols, 8),
                           dtype=torch.int32, device=dev, generator=g)
        ms = cuda_ms(lambda i: crossbar_exec(st, mc), 10, warmup=1)
        bound, by = crossbar_bound_ms(c, p.n_cols, 8, mc)
        # the timed launch's state on crossbars of its first and last
        # block == the grouped plain version on the host, bit for bit
        sched_plan = plan(mc, p.n_cols)
        n_groups = sched_plan.n_groups
        idx = torch.tensor(sorted({i % c for i in (0, 1, -2, -1)}),
                           device=dev)
        got = crossbar_exec(st, mc)[idx].cpu()
        want = crossbar_exec_grouped_ref(st[idx].cpu(), sched_plan.rows,
                                         sched_plan.offsets)
        if not torch.equal(got, want):
            raise AssertionError(f"w_in decode launch ({p.model}, {p.n_cols} "
                                 f"columns, C={c}): kernel state != grouped "
                                 "plain version on crossbars 0, 1, C-2, C-1")
        # the per-gate plain version on the card, once
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        crossbar_exec_ref(st, mc)
        end.record()
        end.synchronize()
        row = dict(model=p.model, n_cols=p.n_cols, chunk=p.chunk, crossbars=c,
                   rows=int(mc.shape[0]), groups=n_groups, ms=ms,
                   plain_ms=start.elapsed_time(end), library_ms=None,
                   bound_ms=bound, bound_by=by,
                   ns_per_group=ms * 1e6 / n_groups,
                   launches_per_decode_step=per_geometry.get(
                       (p.model, p.n_cols, p.chunk), 0),
                   pick=(p.model, p.n_cols, p.chunk) ==
                   (pick.model, pick.n_cols, pick.chunk),
                   default=(p.model, p.n_cols) == ("minimal", 1024))
        geo_rows.append(row)
        say(f"[autotune] w_in decode launch ({p.model}, {p.n_cols} columns, "
            f"{p.chunk} terms): C={c} G={mc.shape[0]} in {n_groups} groups | "
            f"kernel {ms:.4f} ms ({row['ns_per_group']:.1f} ns per group) | "
            f"plain {row['plain_ms']:.1f} ms | bound {bound * 1e3:.2f} us "
            f"({by}) | "
            f"{bound / ms * 100:.2f}% of bound | state == plain on "
            f"crossbars 0, 1, C-2, C-1 | launches per decode step "
            f"{row['launches_per_decode_step']}"
            + (" | PICK" if row["pick"] else "")
            + (" | DEFAULT" if row["default"] else ""))
    torch.cuda.synchronize()

    # persistence: a reloaded table makes a fresh warmup free
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "autotune.json")
        saved = autotune.save_table(path)
        engine.clear_cache()
        loaded = autotune.load_table(path, device=dev)
    t0 = time.perf_counter()
    again = Scheduler(params, cfg, scfg, device=dev)
    warm2 = time.perf_counter() - t0
    info = engine.cache_info()
    if saved != 5 or loaded != 5 or info.tune_trials != 0 or \
            info.tune_hits < 5:
        raise AssertionError(f"reloaded table: saved {saved}, loaded "
                             f"{loaded}, then {info.tune_trials} trials and "
                             f"{info.tune_hits} hits (want 5, 5, 0, >= 5)")
    rids = [again.submit_request(r) for r in trace()]
    out = again.run()
    got2 = [out[r].tolist() for r in rids]
    if got2 != untuned:
        raise AssertionError(f"reloaded-table tokens {got2} != exact integer "
                             f"product {untuned}")
    say(f"[autotune] table saved ({saved} plans), engine cleared, reloaded "
        f"({loaded}): fresh warmup in {warm2:.2f} s with "
        f"{engine.cache_info().tune_trials} trials; tokens == exact product; "
        f"{autotune.summary()}")
    autotune.enable(False)
    return launches, warm_s, race_rows, geo_rows


# --------------------------------------------------------------------------
# phase 7: training full-width qwen1.5-0.5b on both kernels
# --------------------------------------------------------------------------

def _train_batches(cfg, dev, batch, seq, steps):
    from repro_torch.data.pipeline import SyntheticLM

    data = SyntheticLM(cfg.vocab_size, seq, batch, seed=0)
    return [{k: torch.as_tensor(v, device=dev).long()
             for k, v in data.batch_at(step).items()} for step in range(steps)]


def _loss_and_norm(params, batch, cfg):
    """Step 0's loss and gradient norm, with no update (the gradient tree
    summed in ``apply_updates``'s order)."""
    from repro_torch.models import model_lib as M
    from repro_torch.optim.adamw import global_norm
    from repro_torch.tree import leaves, rebuild

    ps = [p.requires_grad_(True) for _, p in leaves(params)]
    loss = M.loss_fn(params, batch, cfg)
    norm = global_norm(rebuild(params, torch.autograd.grad(loss, ps)))
    torch.cuda.synchronize()
    return loss.detach(), norm


def _expected_launches(cfg, rows, memory_rows=1):
    """The launches of each linear (``launches``: one, or its pieces in
    ``pim_sim``) of a forward over ``rows`` token rows and
    ``memory_rows`` memory rows, and with remat those of each decoder
    linear once more in the recompute: the checkpoint recomputes a block
    until the last tensor the block saved, which w_out's linear saves
    after its kernel (quant: the float rescale's operands; pim_sim: the
    autograd Function's inputs, packed when its forward returns).  An
    encoder is not checkpointed, as in the reference."""
    fwd = launches(cfg, prefill_linears(cfg, rows, memory_rows))
    enc = launches(cfg, [(memory_rows, k, n) for k, n in
                         _kind_linears(cfg)["enc"]] * cfg.n_encoder_layers)
    return fwd, fwd - enc if cfg.remat else 0


def _train_steps(params, batches, cfg, ocfg, which):
    """``launch.train.train_step`` over ``batches`` with the launch counters
    zeroed just before and read just after each step, and the forward's
    launches read where ``loss_fn`` returns; the last step under
    torch.profiler.  Returns per-step rows and the profile."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch import train
    from repro_torch.models import model_lib as M
    from repro_torch.optim.adamw import init_state

    fwd_counts = []
    loss_fn = M.loss_fn

    def counted(*a, **kw):
        out = loss_fn(*a, **kw)
        fwd_counts.append(counters()[which])
        return out

    opt_state = init_state(ocfg, params)
    rows, prof = [], None
    with mock.patch.object(M, "loss_fn", counted):
        for step, batch in enumerate(batches):
            last = step == len(batches) - 1
            ctx = (profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA])
                   if last else contextlib.nullcontext())
            torch.cuda.synchronize()
            reset_counters()
            with ctx as p:
                t0 = time.perf_counter()
                params, opt_state, loss, metrics = train.train_step(
                    params, opt_state, batch, cfg, ocfg)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            launches = counters()[which]
            if last:
                prof = p
            rows.append(dict(step=step, loss=float(loss),
                             grad_norm=float(metrics["grad_norm"]),
                             lr=float(metrics["lr"]), wall_s=wall,
                             fwd_launches=fwd_counts[-1],
                             launches=launches))
    return params, opt_state, rows, prof


def _busy(prof, top=6):
    """Device-busy ms of a profiled step and its ``top`` kernels."""
    events = prof.key_averages()
    # device events but the spans of record_function ranges (the port's
    # repro: spans open inside a profiled step)
    kernels = sorted((e for e in events
                      if e.device_type == torch.autograd.DeviceType.CUDA
                      and not getattr(e, "is_user_annotation", False)),
                     key=lambda e: -e.self_device_time_total)
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    ours = [e for e in kernels[top:] if "quant_matmul_kernel" in e.key
            or "crossbar_exec_kernel" in e.key]
    lines = [f"{e.self_device_time_total / 1e3:9.3f} ms {e.count:5d} x "
             f"{e.self_device_time_total / max(e.count, 1):9.2f} us  "
             f"{e.key[:70]}" for e in kernels[:top] + ours]
    return busy, lines


def _check_train_rows(tag, rows, cfg, want_loss, want_norm, shape):
    fwd, rec = _expected_launches(cfg, *shape)
    for r in rows:
        if not (math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"])):
            raise AssertionError(f"{tag} step {r['step']}: loss {r['loss']}, "
                                 f"grad norm {r['grad_norm']}")
        if (r["fwd_launches"], r["launches"]) != (fwd, fwd + rec):
            raise AssertionError(
                f"{tag} step {r['step']}: {r['fwd_launches']} launches in "
                f"the forward and {r['launches']} in the step, expected "
                f"{fwd} and {fwd + rec} ({fwd} + {rec} in remat's "
                "recompute)")
    if rows[0]["loss"] != float(want_loss) or \
            rows[0]["grad_norm"] != float(want_norm):
        raise AssertionError(
            f"{tag} step 0: loss {rows[0]['loss']!r}, grad norm "
            f"{rows[0]['grad_norm']!r}; the oracle gives {float(want_loss)!r},"
            f" {float(want_norm)!r}")


def _train_report(tag, rows, prof, cfg, peak, base, shape):
    fwd, rec = _expected_launches(cfg, *shape)
    for r in rows:
        say(f"[{tag}] step {r['step']}: loss {r['loss']:.6f} | grad norm "
            f"{r['grad_norm']:.4f} | lr {r['lr']:.3e} | wall "
            f"{r['wall_s'] * 1e3:.1f} ms"
            + (" (under torch.profiler)" if r is rows[-1] else "")
            + f" | launches {r['launches']} = {r['fwd_launches']} forward + "
            f"{r['launches'] - r['fwd_launches']} recompute")
    busy, lines = _busy(prof)
    wall = rows[-1]["wall_s"] * 1e3
    say(f"[{tag}] profiled step {rows[-1]['step']}: wall {wall:.2f} ms, "
        f"device busy {busy:.2f} ms ({busy / wall * 100:.1f}%)")
    for ln in lines:
        say(f"[{tag}] profiled step: {ln}")
    say(f"[{tag}] launches per step derived: {fwd} forward (one per linear"
        " or piece)"
        f" + {rec} in remat's recompute (each checkpointed block runs again "
        "up to w_out's linear, whose saved tensors come after its kernel); "
        f"peak allocated {peak / 2 ** 30:.2f} GiB ({base / 2 ** 30:.2f} GiB "
        f"before the phase, {(peak - base) / 2 ** 30:.2f} GiB above it)")
    return busy


def train_quant(base_cfg, dev, quant_rows):
    """Full-width qwen1.5-0.5b in ``quant``, 4 steps of
    ``launch.train.train_step`` at batch 4, seq 128 (the reference's AdamW
    defaults), every linear on ``quant_matmul_int`` at M = 512."""
    from repro_torch.kernels.quant_matmul import ops, quant_matmul_int_ref
    from repro_torch.models import model_lib as M
    from repro_torch.optim.adamw import AdamWConfig

    batch, seq, steps = TRAIN_QUANT
    cfg = base_cfg.scaled(pim_mode="quant")
    ocfg = AdamWConfig()
    batches = _train_batches(cfg, dev, batch, seq, steps)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    params = M.init_params(cfg, seed=0, device=dev)
    with mock.patch.object(ops, "quant_matmul_int", quant_matmul_int_ref):
        want_loss, want_norm = _loss_and_norm(params, batches[0], cfg)
    params, opt_state, rows, prof = _train_steps(params, batches, cfg, ocfg,
                                                 which=0)
    peak = torch.cuda.max_memory_allocated()
    _check_train_rows("train_quant", rows, cfg, want_loss, want_norm,
                      (batch * seq,))
    say(f"[train_quant] full-width {cfg.name} ({cfg.n_layers} layers, "
        f"remat {cfg.remat}), batch {batch}, seq {seq}, {steps} steps of "
        f"launch.train.train_step, AdamW defaults: step 0's loss "
        f"{rows[0]['loss']!r} and grad norm {rows[0]['grad_norm']!r} == "
        "the plain GEMM's (identical)")
    busy = _train_report("train_quant", rows, prof, cfg, peak, base,
                         (batch * seq,))
    for k, n in QUANT_SHAPES_KN:
        r = quant_rows[(batch * seq, k, n)]
        say(f"[train_quant] quant_matmul_int at the train shape M={batch * seq}"
            f" K={k} N={n}: kernel {r['ms'] * 1e3:.2f} us | torch._int_mm "
            f"{r['library_ms'] * 1e3:.2f} us | bound {r['bound_ms'] * 1e3:.2f}"
            f" us ({r['bound_by']}) | {r['bound_ms'] / r['ms'] * 100:.1f}% of "
            f"bound | kernel / _int_mm {r['ms'] / r['library_ms']:.2f}")
    del params, opt_state
    torch.cuda.empty_cache()
    return sum(r["launches"] for r in rows), dict(
        batch=batch, seq=seq, steps=steps, losses=[r["loss"] for r in rows],
        wall_ms=[r["wall_s"] * 1e3 for r in rows], busy_ms_last=busy,
        peak_bytes=peak, launches_per_step=rows[0]["launches"])


def time_crossbar_at(dev, m, k, o, grouped=0):
    """One ``pim_sim`` linear's crossbar launch at (M, K, O): the packed
    state ``engine.matmul_int`` hands the kernel first (its first piece,
    where the linear splits), held against the per-gate plain version and
    timed; with ``grouped``, its first and last ``grouped`` crossbars also
    against the grouped plain version on the host.  The operands are
    uint8, as ``sim_linear`` hands them over, so the linear splits as on
    the path; the row counts its launches."""
    from repro_torch.kernels import crossbar_exec as xb
    from repro_torch.kernels.crossbar_exec import (crossbar_exec_grouped_ref,
                                                   crossbar_exec_ref, plan)
    from repro_torch.pim import engine

    gi = np.random.default_rng(12)
    x, wt = (torch.as_tensor(gi.integers(0, 256, (r, k)), dtype=torch.uint8,
                             device=dev) for r in (m, o))
    seen, sizes = [], []
    real = xb.crossbar_exec

    def capture(state, mc):
        if not seen:
            seen.append((state.clone(), mc))
        sizes.append(state.shape[0])
        return real(state, mc)

    with mock.patch.object(xb, "crossbar_exec", capture), engine.transient():
        got = engine.matmul_int(x, wt, 8)
    if not torch.equal(got, (x.double() @ wt.double().T).long()):
        raise AssertionError(f"matmul_int != exact product at M={m} K={k} "
                             f"O={o}")
    del got
    st, mc = seen[0]
    ms = cuda_ms(lambda i: xb.crossbar_exec(st, mc), 5, warmup=1)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    plain_out = crossbar_exec_ref(st, mc)
    end.record()
    end.synchronize()
    out = xb.crossbar_exec(st, mc)
    e = max_abs_err(out, plain_out)
    c, n, w_words = st.shape
    if grouped:
        sched = plan(mc, n)
        for part in (slice(0, grouped), slice(c - grouped, c)):
            e = max(e, max_abs_err(out[part].cpu(), crossbar_exec_grouped_ref(
                st[part].cpu(), sched.rows, sched.offsets)))
    if e:
        raise AssertionError(f"crossbar_exec != plain on the packed state of "
                             f"M={m} K={k} O={o}: max abs error {e}")
    bound, by = crossbar_bound_ms(c, n, w_words, mc)
    return dict(shape=[c, n, w_words, mc.shape[0]], m=m, k=k, o=o, ms=ms,
                plain_ms=start.elapsed_time(end), bound_ms=bound,
                bound_by=by, library_ms=None, max_abs_err=e,
                launches=len(sizes))


def train_pim(base_cfg, dev):
    """Full-width qwen1.5-0.5b at ``TRAIN_PIM_LAYERS`` layers in
    ``pim_sim``, 1 step at batch 2, seq 32: every linear on
    ``crossbar_exec`` at M = 64, on transient state."""
    from repro_torch.models import model_lib as M
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.pim import engine

    batch, seq, steps = TRAIN_PIM
    cfg = base_cfg.scaled(pim_mode="pim_sim", n_layers=TRAIN_PIM_LAYERS)
    ocfg = AdamWConfig()
    batches = _train_batches(cfg, dev, batch, seq, steps)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    info0 = engine.cache_info()
    params = M.init_params(cfg, seed=0, device=dev)
    with mock.patch.object(engine, "matmul_int", exact_matmul):
        want_loss, want_norm = _loss_and_norm(params, batches[0], cfg)
    params, opt_state, rows, prof = _train_steps(params, batches, cfg, ocfg,
                                                 which=1)
    peak = torch.cuda.max_memory_allocated()
    info = engine.cache_info()
    _check_train_rows("train_pim", rows, cfg, want_loss, want_norm,
                      (batch * seq,))
    if (info.resident_entries, info.resident_bytes, info.exec_uploads) != \
            (info0.resident_entries, info0.resident_bytes,
             info0.exec_uploads):
        raise AssertionError(
            f"the pim_sim train steps changed the resident crossbar state: "
            f"entries {info0.resident_entries} -> {info.resident_entries}, "
            f"bytes {info0.resident_bytes} -> {info.resident_bytes}, uploads "
            f"{info0.exec_uploads} -> {info.exec_uploads}")
    if peak - base >= PIM_TRAIN_EXTRA_BYTES:
        raise AssertionError(f"the pim_sim train phase peaked {peak - base} "
                             f"bytes above its start, limit "
                             f"{PIM_TRAIN_EXTRA_BYTES}")
    say(f"[train_pim] full-width {cfg.name} ({cfg.n_layers} layers, remat "
        f"{cfg.remat}), batch {batch}, seq {seq}, {steps} steps: step 0's "
        f"loss {rows[0]['loss']!r} and grad norm {rows[0]['grad_norm']!r} "
        "== the exact 7-bit integer product's (identical); resident "
        f"crossbar state unchanged ({info.resident_entries} states, "
        f"{info.resident_bytes / 2 ** 30:.2f} GiB; "
        f"{info.exec_transient - info0.exec_transient} transient chunk "
        "GEMMs); peak limit "
        f"{PIM_TRAIN_EXTRA_BYTES / 2 ** 30:.0f} GiB above the start")
    busy = _train_report("train_pim", rows, prof, cfg, peak, base,
                         (batch * seq,))
    del params, opt_state
    torch.cuda.empty_cache()
    xrow = time_crossbar_at(dev, batch * seq, cfg.d_model, cfg.d_ff)
    c, n, w_words, g = xrow["shape"]
    say(f"[train_pim] crossbar_exec, one w_in launch at the train shape "
        f"M={batch * seq} (K={cfg.d_model}, O={cfg.d_ff}): C={c} n={n} "
        f"W={w_words} G={g} | kernel {xrow['ms']:.4f} ms | plain "
        f"{xrow['plain_ms']:.1f} ms | bound {xrow['bound_ms'] * 1e3:.2f} us "
        f"({xrow['bound_by']}) | {xrow['bound_ms'] / xrow['ms'] * 100:.2f}% "
        "of bound | state == plain")
    return sum(r["launches"] for r in rows), dict(
        batch=batch, seq=seq, steps=steps, losses=[r["loss"] for r in rows],
        wall_ms=[r["wall_s"] * 1e3 for r in rows], busy_ms_last=busy,
        peak_bytes=peak, peak_above_start_bytes=peak - base,
        launches_per_step=rows[0]["launches"], w_in=xrow)


def train_restart():
    """The reference's crash-and-resume drill through the port's CLI, in
    subprocesses: full width at 2 layers, ``quant``, batch 2, seq 64, 6
    steps, a checkpoint every 3 steps.  Two uninterrupted runs and one
    that fails at step 4, side by side on the card, then one that resumes
    the failed run; the resumed steps' losses and the last checkpoint must
    equal the uninterrupted run's."""
    import shutil
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    tmp = tempfile.mkdtemp(prefix="train_restart_")
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8",
               PYTHONPATH=os.pathsep.join(
                   p for p in (SRC, os.environ.get("PYTHONPATH")) if p))
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--pim-mode",
           "quant", "--layers", "2", "--batch", "2", "--seq", "64",
           "--steps", "6", "--ckpt-every", "3", "--log-every", "1"]
    saves = []

    def run(name, *extra, fail=False):
        d, m = os.path.join(tmp, name), os.path.join(tmp, name + ".jsonl")
        t0 = time.perf_counter()
        out = subprocess.run(cmd + ["--ckpt-dir", d, "--metrics-out", m]
                             + list(extra), env=env, capture_output=True,
                             text=True, timeout=600,
                             cwd=os.path.dirname(SRC))
        wall = time.perf_counter() - t0
        if (out.returncode != 0) != fail:
            raise AssertionError(
                f"train CLI {name} {extra} exited {out.returncode}:\n"
                f"{out.stdout[-2000:]}\n{out.stderr[-4000:]}")
        if fail and "injected failure at step 4" not in out.stderr:
            raise AssertionError(f"train CLI {name} failed otherwise:\n"
                                 f"{out.stderr[-4000:]}")
        for ln in out.stdout.splitlines():
            if ln.startswith("[ckpt]"):
                saves.append(f"{name}: {ln[7:]}")
        say(f"[train_restart] run {name} {' '.join(extra)}: exit "
            f"{out.returncode} in {wall:.1f} s")
        return [json.loads(ln) for ln in open(m)]

    def leaves(name):
        with np.load(os.path.join(tmp, name, "step_00000006",
                                  "shard_0.npz")) as z:
            return {k: z[k] for k in z.files}

    def diff(a, b):
        """Largest |a - b| per leaf (bfloat16 leaves are stored as their
        uint16 bits: compared as float32)."""
        out = {}
        for k in a:
            x, y = a[k], b[k]
            if x.dtype == np.uint16:
                x, y = (np.asarray(v, np.uint32) << 16 for v in (x, y))
                x, y = x.view(np.float32), y.view(np.float32)
            out[k] = float(np.max(np.abs(x.astype(np.float64)
                                         - y.astype(np.float64))))
        return out

    try:
        # independent runs: each waits for its own process, which
        # subprocess.run kills at its timeout
        with ThreadPoolExecutor(3) as pool:
            first = [pool.submit(run, "a"), pool.submit(run, "b"),
                     pool.submit(run, "c", "--fail-at-step", "4", fail=True)]
        m_a, m_b, _ = (f.result() for f in first)
        m_c = run("c", "--resume")
        la, lb, lc = ([m["loss"] for m in ms] for ms in (m_a, m_b, m_c))
        if [m["step"] for m in m_c] != [0, 1, 2, 3, 3, 4, 5]:
            raise AssertionError(f"the drill ran steps "
                                 f"{[m['step'] for m in m_c]}")
        ca, cb, cc = leaves("a"), leaves("b"), leaves("c")
        if not (ca.keys() == cb.keys() == cc.keys()):
            raise AssertionError("the drill's checkpoints hold other leaves")
        d_ab, d_ac = diff(ca, cb), diff(ca, cc)
        same = la == lb and not any(d_ab.values())
        if same:
            ok = lc[4:] == la[3:] and not any(d_ac.values())
        else:
            ok = all(abs(x - y) <= abs(x - z) for x, y, z in
                     zip(la[3:], lc[4:], lb[3:])) and all(
                d_ac[k] <= d_ab[k] for k in d_ab)
        say(f"[train_restart] uninterrupted losses {la}; second "
            f"uninterrupted run {'identical' if same else lb}; resumed "
            f"steps 3-5 {lc[4:]}")
        say(f"[train_restart] two uninterrupted runs agree bit for bit: "
            f"{same} (largest leaf difference {max(d_ab.values())}); "
            f"resumed vs uninterrupted: largest leaf difference "
            f"{max(d_ac.values())} over {len(ca)} leaves of step 6")
        for s in sorted(saves, key=lambda s: s.split(":")[0]):
            say(f"[train_restart] save {s}")
        if not ok:
            raise AssertionError("the resumed run differs from the "
                                 "uninterrupted one beyond the difference "
                                 "of two uninterrupted runs")
        return dict(bit_identical_runs=same, losses=la, resumed=lc[4:],
                    saves=saves)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# --------------------------------------------------------------------------
# phase 7: the engine keeps nothing of a dropped model; the wide dense
# configs; sliding-window serving
# --------------------------------------------------------------------------

# depths of the full-width wide serves: a pim_sim decode state at batch 2
# takes about 1.8 GiB per gemma-7b layer and 2.45 GiB per granite-20b layer
# (host arithmetic, printed), so these depths keep one model's states under
# the engine's 8 GiB resident bound; two layers each serve every wide
# linear at full width within the run's time
WIDE_LAYERS = {"gemma-7b": 2, "granite-20b": 2}
# h2o-danube-1.8b's windowed serve (window 4096): a cold prompt past the
# window, and one inside it whose decode wraps the ring; then three short
# prompts through packing and chunking
WINDOW_RING_TRACE = ((4160, 16), (4080, 32))
WINDOW_SHORT_TRACE = ((24, 8), (40, 8), (150, 8))
WINDOW_BLOCK = 16
WINDOW_CHUNK = 64
WINDOW_PIM_LAYERS = 4
# last-token logits of the ring decode against a teacher-forced windowed
# prefill of the same tokens: bf16 logits (|logit| up to about 1.3, an ulp
# of 0.0078 there) through two attention paths and int8-quantized
# activations; the full-width model cut to 2 and 4 layers (window 64) gave
# 0.043 and 0.046 on the CPU
WINDOW_LOGIT_TOL = 0.1


def footprint(params):
    """(weight bytes of ``params``, the engine's derived, chunked and
    resident bytes, bytes allocated on the card)."""
    from repro_torch.pim import engine
    from repro_torch.tree import leaves

    info = engine.cache_info()
    return (sum(t.numel() * t.element_size() for _, t in leaves(params)),
            info.derived_bytes + info.chunked_bytes + info.resident_bytes,
            torch.cuda.memory_allocated())


def check_released(label, before):
    """After the caller dropped a model's parameters: the engine reports no
    derived, chunked or resident bytes, and the card's allocation fell by
    at least the weights' bytes plus what the engine held for them."""
    from repro_torch.pim import engine

    weights, held, allocated = before
    gc.collect()
    torch.cuda.synchronize()
    info = engine.cache_info()
    fell = allocated - torch.cuda.memory_allocated()
    say(f"[release] {label}: params dropped; the engine held "
        f"{held / 2 ** 30:.3f} GiB for them, now derived "
        f"{info.derived_bytes} B ({info.derived_entries} entries), chunked "
        f"{info.chunked_bytes} B ({info.chunked_entries}), resident "
        f"{info.resident_bytes} B ({info.resident_entries}); allocated fell "
        f"{fell / 2 ** 30:.3f} GiB (weights {weights / 2 ** 30:.3f} GiB + "
        f"engine {held / 2 ** 30:.3f} GiB)")
    if info.derived_bytes or info.chunked_bytes or info.resident_bytes:
        raise AssertionError(f"the engine kept state of the dropped {label}")
    if fell < weights + held:
        raise AssertionError(f"dropping {label} freed {fell} bytes, less than"
                             f" its weights and engine state ({weights} + "
                             f"{held})")


def decode_records(fn, bits=False):
    """Run ``fn()`` recording, for each plain decode step of the
    scheduler, the engine's cold uploads after it and the launches of
    each kernel in it; returns (fn's result, a list of (uploads,
    quant_matmul_int launches, crossbar_exec launches)), each record
    followed by the step's pim_bits writes and reads with ``bits``."""
    from repro_torch.kernels import pim_bits
    from repro_torch.pim import engine
    from repro_torch.serving import Scheduler

    real = Scheduler._plain_step
    seen = []

    def step(self, active, emitted):
        q0, x0 = counters()
        b0 = dict(pim_bits.launches)
        real(self, active, emitted)
        q1, x1 = counters()
        rec = (engine.cache_info().exec_uploads, q1 - q0, x1 - x0)
        if bits:
            rec += tuple(pim_bits.launches[k] - b0[k]
                         for k in ("write", "read"))
        seen.append(rec)

    with mock.patch.object(Scheduler, "_plain_step", step):
        out = fn()
    return out, seen


def pim_state_bytes(m, k, o):
    """Crossbar state of one pim_sim linear at (M, K, O): 37-term chunks,
    256 rows per crossbar, 1024 columns of 8 words (host arithmetic)."""
    return math.ceil(k / 37) * math.ceil(m * o / 256) * 1024 * 8 * 4


# the bytes one crossbar of a pim_sim launch is reckoned to take at 1024
# columns, 37 uint8 terms, 22 accumulator bits and 256 rows: its state in
# and out (2 x 32 KiB), two operands' rows built and padded, with two int64
# row numbers a row (2 x (2 x 9,472 + 4,096)), and packing's temporaries,
# larger than reading's: two int64 bit planes and four word sums
# (2 x 75,776 + 9,472)
PIM_CROSSBAR_LAUNCH_BYTES = (2 * 32768 + 2 * (2 * 9472 + 4096)
                             + 2 * 75776 + 9472)


def pim_pieces(m, k, o):
    """(launches, crossbars in the largest) of one pim_sim linear at
    (M, K, O), by host arithmetic: its ceil(K / 37) chunks of
    ceil(M * O / 256) crossbars in one launch while they fit
    ``engine.MAX_LAUNCH_BYTES`` at ``PIM_CROSSBAR_LAUNCH_BYTES`` each, else
    in runs of whole chunks, balanced, while one chunk fits, else each
    chunk in balanced parts."""
    from repro_torch.pim import engine

    p, n_cb = math.ceil(k / 37), math.ceil(m * o / 256)
    cap = engine.MAX_LAUNCH_BYTES // PIM_CROSSBAR_LAUNCH_BYTES
    if p * n_cb <= cap:
        return 1, p * n_cb
    if n_cb <= cap:
        n = math.ceil(p / (cap // n_cb))
        return n, math.ceil(p / n) * n_cb
    parts = math.ceil(n_cb / cap)
    return p * parts, math.ceil(n_cb / parts)


def launches(cfg, linears):
    """Kernel launches of ``linears`` [(M, K, N)] in ``cfg``'s mode: one a
    linear, or in ``pim_sim`` its pieces (``pim_pieces``)."""
    if cfg.pim_mode != "pim_sim":
        return len(linears)
    return sum(pim_pieces(*s)[0] for s in linears)


def _kind_linears(cfg):
    """(K, N) of the linears one decode step runs in a layer of each kind:
    the attention projections of the attention kinds, ``"adx"``'s
    ``xwq``/``xwo`` and the dense MLP of ``"ad"``, ``"adx"``, ``"enc"``,
    ``"ar"`` and ``"md"`` (an MoE's experts, Mamba's and xLSTM's
    projections are plain products, outside ``linear``)."""
    d, h, kv, hd, ff = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                        cfg.d_ff)
    attn = [(d, h * hd), (d, kv * hd), (d, kv * hd), (h * hd, d)]
    xattn = [(d, h * hd), (h * hd, d)]
    mlp = [(d, ff), (ff, d)] + ([(d, ff)] if cfg.gated_mlp else [])
    return {"ad": attn + mlp, "ae": attn, "ar": attn + mlp,
            "adx": attn + xattn + mlp, "enc": attn + mlp, "md": mlp,
            "me": [], "xm": [], "xs": []}


def step_linears(cfg):
    """(K, N) of each linear one decode step runs, layer after layer."""
    per_kind = _kind_linears(cfg)
    return [s for kind in cfg.pattern for s in per_kind[kind]] * cfg.n_super


def prefill_linears(cfg, rows=1, memory_rows=1):
    """(M, K, N) of each linear a prefill (or a train forward) runs over
    ``rows`` token rows: the encoder's layers on the ``memory_rows`` rows of
    the frames, the decode step's on the tokens, and each ``"adx"`` layer's
    ``xwk``/``xwv`` on the ``memory_rows`` rows of the memory."""
    xkv = [(memory_rows, cfg.d_model, cfg.n_kv_heads * cfg.hd)] * 2
    return ([(memory_rows, k, n) for k, n in _kind_linears(cfg)["enc"]]
            * cfg.n_encoder_layers
            + [(rows, k, n) for k, n in step_linears(cfg)]
            + xkv * cfg.pattern.count("adx") * cfg.n_super)


def wide_pim_limit(cfg, weights):
    """The wide pim_sim phase's peak allocation bound: the weights, their
    offset and chunked copies (a byte per weight element each), the
    engine's resident bound, and 8 times the largest transient state of an
    8-token prefill linear (the state, the kernel's output, and packing's
    two int64 bit-plane temporaries of about 2.3 times the state each)."""
    from repro_torch.pim import engine

    elems = sum(k * o for k, o in step_linears(cfg))
    largest = max(pim_state_bytes(8, k, o) for k, o in step_linears(cfg))
    return weights + 2 * elems + engine.MAX_RESIDENT_BYTES + 8 * largest


def serve_wide(name, dev):
    """Full-width gemma-7b or granite-20b cut to ``WIDE_LAYERS[name]``
    layers, fresh weights from seed 0: a ``quant`` serve whose prefill
    logits and tokens equal the plain GEMM's, and a ``pim_sim`` serve whose
    logits and tokens equal the exact integer product's, with no cold
    upload after the first decode step.  Drops the weights at the end and
    checks that nothing of them stays.  Returns (quant launches, crossbar
    launches, a summary)."""
    from repro_torch import configs
    from repro_torch.kernels.quant_matmul import ops, quant_matmul_int_ref
    from repro_torch.models import model_lib as M
    from repro_torch.pim import engine

    full = configs.get(name)
    base = full.scaled(n_layers=WIDE_LAYERS[name])
    t0 = time.perf_counter()
    params = M.init_params(base, seed=0, device=dev)
    torch.cuda.synchronize()
    say(f"[{name}] full width, {base.n_layers} of {full.n_layers} layers: "
        f"{M.param_count(base) / 1e6:.1f}M parameters (d_model "
        f"{base.d_model}, {base.n_heads} heads of {base.hd}, "
        f"{base.n_kv_heads} KV heads, d_ff {base.d_ff} "
        f"{'gated' if base.gated_mlp else 'ungated'}, {base.activation}, "
        f"vocab {base.vocab_size}, "
        f"{'tied' if base.tie_embeddings else 'untied'}) drawn on the card "
        f"from seed 0 in {time.perf_counter() - t0:.3f} s")

    # quant: 4 requests, prompts 16-64, 8 new tokens, batch 4, paged
    plens, max_new = (16, 32, 48, 64), 8
    qcfg = base.scaled(pim_mode="quant", max_seq_len=max(plens) + max_new)
    toks = torch.as_tensor(np.random.default_rng(13).integers(
        0, base.vocab_size, (1, 64)), device=dev)
    got = prefill_logits(params, qcfg, toks)
    with mock.patch.object(ops, "quant_matmul_int", quant_matmul_int_ref):
        want = prefill_logits(params, qcfg, toks)
    if not (torch.isfinite(got).all() and torch.equal(got, want)):
        raise AssertionError(f"{name} quant prefill logits differ between "
                             "the kernel and the plain GEMM")
    reset_counters()
    tokens, summary, wall = serve(params, qcfg, dev, n_requests=4,
                                  prompt_lens=plens, max_new=max_new,
                                  max_batch=4, seed=14)
    q_launches = counters()[0]
    with mock.patch.object(ops, "quant_matmul_int", quant_matmul_int_ref):
        plain, _, _ = serve(params, qcfg, dev, n_requests=4,
                            prompt_lens=plens, max_new=max_new, max_batch=4,
                            seed=14)
    if q_launches <= 0 or tokens != plain:
        raise AssertionError(f"{name} quant serve: {q_launches} launches, "
                             f"tokens {tokens} vs the plain GEMM's {plain}")
    say(f"[{name} quant] 64-token prefill logits kernel == plain GEMM "
        f"(identical); served {summary['n_finished']} requests (prompts "
        f"{plens}, {max_new} new tokens, max_batch 4, paged) in {wall:.2f} "
        f"s: {summary['tokens_per_s']:.2f} tok/s | mean TTFT "
        f"{summary['mean_ttft_s'] * 1e3:.1f} ms | mean TPOT "
        f"{summary['mean_tpot_s'] * 1e3:.2f} ms | quant_matmul_int launches "
        f"{q_launches}; tokens == the plain GEMM's: {tokens}")

    # pim_sim: 2 requests of 8 tokens, 4 new tokens, batch 2
    plen, pnew = 8, 4
    pcfg = base.scaled(pim_mode="pim_sim", max_seq_len=plen + pnew)
    toks = torch.as_tensor(np.random.default_rng(15).integers(
        0, base.vocab_size, (1, plen)), device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    t0 = time.perf_counter()
    got = prefill_logits(params, pcfg, toks)
    t_prefill = time.perf_counter() - t0
    pre_launches = counters()[1]
    want_pre = launches(pcfg, prefill_linears(pcfg, plen))
    with mock.patch.object(engine, "matmul_int", exact_matmul):
        want = prefill_logits(params, pcfg, toks)
    if not (torch.isfinite(got).all() and torch.equal(got, want)):
        raise AssertionError(f"{name} pim_sim prefill logits differ from the "
                             "exact 7-bit integer product")
    if pre_launches != want_pre:
        raise AssertionError(f"{name} pim_sim prefill launched the crossbar "
                             f"kernel {pre_launches} times, the pieces of "
                             f"its linears are {want_pre}")
    info0 = engine.cache_info()
    reset_counters()
    (ptokens, psummary, pwall), steps = decode_records(
        lambda: serve(params, pcfg, dev, n_requests=2, prompt_lens=(plen,),
                      max_new=pnew, max_batch=2, seed=16))
    uploads = [u for u, _, _ in steps]
    x_launches = counters()[1]
    info = engine.cache_info()
    peak = torch.cuda.max_memory_allocated()
    with mock.patch.object(engine, "matmul_int", exact_matmul):
        pwant, _, _ = serve(params, pcfg, dev, n_requests=2,
                            prompt_lens=(plen,), max_new=pnew, max_batch=2,
                            seed=16)
    weights = footprint(params)[0]
    limit = wide_pim_limit(base, weights)
    decode_state = sum(pim_state_bytes(2, k, o)
                       for k, o in step_linears(base))
    split = sorted({(k, o, pim_pieces(plen, k, o)[0])
                    for k, o in step_linears(base)
                    if pim_pieces(plen, k, o)[0] > 1})
    say(f"[{name} pim_sim] 8-token prefill logits on the crossbar kernel == "
        f"exact 7-bit integer product (identical), {t_prefill:.2f} s on "
        f"transient state in {pre_launches} launches (linears split under "
        f"the launch budget, (K, O, launches): {split}); served "
        f"{psummary['n_finished']} requests "
        f"({plen}-token prompts, {pnew} new tokens, max_batch 2, paged) in "
        f"{pwall:.2f} s: mean TTFT {psummary['mean_ttft_s'] * 1e3:.0f} ms | "
        f"mean TPOT {psummary['mean_tpot_s'] * 1e3:.0f} ms | crossbar_exec "
        f"launches {x_launches} | cold uploads after each decode step "
        f"{[u - info0.exec_uploads for u in uploads]} | resident "
        f"{info.resident_entries} states, {info.resident_bytes / 2 ** 30:.2f}"
        f" GiB (host arithmetic {decode_state / 2 ** 30:.2f} GiB) | peak "
        f"allocated {peak / 2 ** 30:.2f} GiB, limit {limit / 2 ** 30:.2f} GiB;"
        f" tokens == exact product's: {ptokens}")
    if x_launches <= 0 or ptokens != pwant:
        raise AssertionError(f"{name} pim_sim serve: {x_launches} launches, "
                             f"tokens {ptokens} vs the exact product's "
                             f"{pwant}")
    if len(set(uploads)) != 1:
        raise AssertionError(f"{name} pim_sim decode uploaded crossbar state "
                             f"after its first step: {uploads}")
    if info.resident_bytes != decode_state:
        raise AssertionError(f"{name} pim_sim keeps {info.resident_bytes} "
                             f"resident bytes, expected {decode_state}")
    if peak >= limit:
        raise AssertionError(f"{name} pim_sim peaked at {peak} bytes, limit "
                             f"{limit}")
    before = footprint(params)
    del params
    check_released(name, before)
    return q_launches, x_launches, dict(
        layers=base.n_layers, quant_tokens_per_s=summary["tokens_per_s"],
        quant_tpot_ms=summary["mean_tpot_s"] * 1e3,
        pim_tpot_ms=psummary["mean_tpot_s"] * 1e3,
        pim_prefill_s=t_prefill, resident_bytes=info.resident_bytes,
        peak_bytes=peak, peak_limit_bytes=limit)


def run_scheduler(params, cfg, dev, trace, **kw):
    """Serve ``trace`` [(prompt, new tokens)] through a ``Scheduler`` with
    ``ServingConfig(**kw)``; returns the tokens in submission order, the
    scheduler and the wall time."""
    from repro_torch.serving import Scheduler, ServingConfig, make_request

    sched = Scheduler(params, cfg, ServingConfig(**kw), device=dev)
    reqs = [make_request(p, n, arrival_time=time.monotonic())
            for p, n in trace]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for r in reqs:
        sched.submit_request(r)
    with torch.no_grad():
        out = sched.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if sched.decode_traces != 1:
        raise AssertionError(f"decode step saw {sched.decode_traces} input "
                             "shapes, expected 1")
    return [out[r.rid].tolist() for r in reqs], sched, wall


def ring_oracle(params, cfg, dev, prompt, n, feed=None):
    """The naive ring decode: one request alone, contiguous prefill, then
    scalar decode steps, each fed the token before it — its own greedy
    choice, or ``feed``'s (teacher-forced).  Returns its greedy tokens and
    the (V,) logits of every step."""
    from repro_torch.models import model_lib as M

    with torch.no_grad():
        logits, caches = M.prefill(
            params, {"tokens": torch.as_tensor(prompt, device=dev)[None]},
            cfg)
        steps = [logits[0]]
        for i in range(n - 1):
            tok = (torch.argmax(logits, -1)[:, None] if feed is None
                   else torch.tensor([[feed[i]]], device=dev))
            _, logits, caches = M.decode_step(params, tok, len(prompt) + i,
                                              caches, cfg)
            steps.append(logits[0])
    return [int(torch.argmax(l)) for l in steps], steps


def serve_window(dev):
    """Full-depth h2o-danube-1.8b (window 4096) in ``quant``, paged, block
    16: a cold prompt past the window and a prompt whose decode wraps the
    ring (alone, as the oracle runs), then short prompts through packing
    and chunking; the ring requests' tokens equal the naive ring decode's
    and their last logits lie within ``WINDOW_LOGIT_TOL`` of a
    teacher-forced windowed prefill, and the naive decode fed the short
    ones' tokens ranks each within ``PREFIX_LOGIT_TOL`` of its best.  One
    decode step at batch 4 is profiled.
    Then 4 of its layers in ``pim_sim``, tokens equal to the exact integer
    product's.  Returns (quant launches, crossbar launches, a summary)."""
    from repro_torch import configs
    from repro_torch.models import model_lib as M
    from repro_torch.pim import engine

    base = configs.get("h2o-danube-1.8b")
    t0 = time.perf_counter()
    params = M.init_params(base, seed=0, device=dev)
    torch.cuda.synchronize()
    say(f"[danube] full-width h2o-danube-1.8b: {M.param_count(base) / 1e6:.1f}"
        f"M parameters ({base.n_layers} layers, d_model {base.d_model}, "
        f"{base.n_heads} heads of {base.hd}, {base.n_kv_heads} KV heads, "
        f"d_ff {base.d_ff}, window {base.sliding_window}, vocab "
        f"{base.vocab_size}) drawn on the card from seed 0 in "
        f"{time.perf_counter() - t0:.3f} s")
    cfg = base.scaled(pim_mode="quant", max_seq_len=max(
        p + n for p, n in WINDOW_RING_TRACE + WINDOW_SHORT_TRACE))
    rng = np.random.default_rng(17)
    ring = [(rng.integers(0, base.vocab_size, p), n)
            for p, n in WINDOW_RING_TRACE]
    short = [(rng.integers(0, base.vocab_size, p), n)
             for p, n in WINDOW_SHORT_TRACE]
    failures = []

    reset_counters()
    ring_tokens, sched, wall = run_scheduler(
        params, cfg, dev, ring, max_batch=1, block_size=WINDOW_BLOCK,
        prompt_bucket=WINDOW_BLOCK)
    q_ring = counters()[0]
    bps = sched.pool.blocks_per_slot
    s = sched.metrics.summary()
    ring_tpot = s["mean_tpot_s"] * 1e3
    say(f"[danube quant] served prompts of {[len(p) for p, _ in ring]} tokens"
        f" ({[n for _, n in ring]} new; max_batch 1, paged, block "
        f"{WINDOW_BLOCK}, {bps} blocks per slot, not "
        f"{-(-cfg.max_seq_len // WINDOW_BLOCK)}) in {wall:.2f} "
        f"s: mean TTFT {s['mean_ttft_s'] * 1e3:.0f} ms | mean TPOT "
        f"{s['mean_tpot_s'] * 1e3:.1f} ms | quant_matmul_int launches "
        f"{q_ring}")
    if bps != -(-base.sliding_window // WINDOW_BLOCK) or q_ring <= 0:
        failures.append(f"{bps} blocks per slot, {q_ring} launches")
    diffs = []
    for (prompt, n), got in zip(ring, ring_tokens):
        want, steps = ring_oracle(params, cfg, dev, prompt, n)
        tf = prefill_logits(params, cfg, torch.as_tensor(
            np.concatenate([prompt, want[:-1]]), device=dev)[None])
        diff = float((steps[-1] - tf[0]).abs().max())
        diffs.append(diff)
        same = got == want
        say(f"[danube quant] {len(prompt)}-token prompt, {n} new tokens "
            f"(positions to {len(prompt) + n - 1}): served == naive ring "
            f"decode: {same}; last logits vs a teacher-forced windowed "
            f"prefill of {len(prompt) + n - 1} tokens: max abs diff "
            f"{diff:.5f} (tol {WINDOW_LOGIT_TOL})")
        if not same:
            failures.append(f"{len(prompt)}-token prompt: served {got} vs "
                            f"naive ring decode {want}")
        if not diff <= WINDOW_LOGIT_TOL:
            failures.append(f"{len(prompt)}-token prompt: last logits differ"
                            f" by {diff} from the teacher-forced prefill")

    kw = dict(max_batch=3, block_size=WINDOW_BLOCK, prompt_bucket=WINDOW_BLOCK)
    reset_counters()
    short_tokens, sched, wall = run_scheduler(
        params, cfg, dev, short, prefill_chunk=WINDOW_CHUNK,
        packed_prefill=True, **kw)
    q_short = counters()[0]
    s = sched.metrics.summary()
    # packed and chunked prefill reduce in other orders than the oracle's
    # whole prefill, and the decode batch is 3, not 1: the naive ring
    # decode, fed the served tokens, must rank each one within
    # PREFIX_LOGIT_TOL (the bound two prefill forms keep on the card) of
    # its best logit
    short_gaps, short_exact = [], 0
    for (prompt, n), got in zip(short, short_tokens):
        want, steps = ring_oracle(params, cfg, dev, prompt, n, feed=got)
        gaps = [float(l.max() - l[t]) for l, t in zip(steps, got)]
        short_gaps.append(max(gaps))
        short_exact += sum(g == w for g, w in zip(got, want))
        if max(gaps) > PREFIX_LOGIT_TOL:
            failures.append(f"{len(prompt)}-token prompt: served {got}, the "
                            f"naive ring decode's greedy tokens on them "
                            f"{want}, logit gaps {gaps}")
    say(f"[danube quant] prompts of {[len(p) for p, _ in short]} tokens "
        f"(max_batch 3, chunks of {WINDOW_CHUNK}, packing) in {wall:.2f} s: "
        f"{s['packed_prefills']} packed prefills, {s['prefill_chunks']} "
        f"prefill chunks, quant_matmul_int launches {q_short}; the naive ring"
        f" decode fed the served tokens picks {short_exact} of "
        f"{sum(n for _, n in short)} of them, and ranks each within "
        f"{max(short_gaps):.5f} of its best logit (tol {PREFIX_LOGIT_TOL})")
    if not (s["packed_prefills"] > 0 and s["prefill_chunks"] > 0
            and q_short > 0):
        failures.append(f"short prompts packed {s['packed_prefills']} and "
                        f"chunked {s['prefill_chunks']} times")

    # one windowed decode step at full depth, batch 4, profiled (the paged
    # read gathers every slot's whole ring)
    profile_decode(params, cfg, dev, 4)

    # pim_sim on 4 of the layers (the same weights), inside the window
    p4 = dict(params, blocks={i: {k: v[:WINDOW_PIM_LAYERS] for k, v in
                                  b.items()}
                              for i, b in params["blocks"].items()})
    pcfg = base.scaled(n_layers=WINDOW_PIM_LAYERS, pim_mode="pim_sim",
                       max_seq_len=20)
    info0 = engine.cache_info()
    reset_counters()
    (ptokens, psummary, pwall), steps = decode_records(
        lambda: serve(p4, pcfg, dev, n_requests=2, prompt_lens=(16,),
                      max_new=4, max_batch=2, seed=18))
    uploads = [u for u, _, _ in steps]
    x_launches = counters()[1]
    with mock.patch.object(engine, "matmul_int", exact_matmul):
        pwant, _, _ = serve(p4, pcfg, dev, n_requests=2, prompt_lens=(16,),
                            max_new=4, max_batch=2, seed=18)
    say(f"[danube pim_sim] {WINDOW_PIM_LAYERS} layers, window "
        f"{pcfg.sliding_window}: served {psummary['n_finished']} requests "
        f"(16-token prompts, 4 new tokens, max_batch 2) in {pwall:.2f} s: "
        f"mean TPOT {psummary['mean_tpot_s'] * 1e3:.0f} ms | crossbar_exec "
        f"launches {x_launches} | cold uploads after each decode step "
        f"{[u - info0.exec_uploads for u in uploads]}; tokens == exact "
        f"product's: {ptokens == pwant} ({ptokens})")
    if ptokens != pwant or x_launches <= 0 or len(set(uploads)) != 1:
        failures.append(f"pim_sim: tokens {ptokens} vs exact {pwant}, "
                        f"{x_launches} launches, uploads {uploads}")
    if failures:
        raise AssertionError("serve_window: " + "; ".join(failures))
    del p4, sched          # the scheduler holds the parameters
    before = footprint(params)
    del params
    check_released("h2o-danube-1.8b", before)
    return q_ring + q_short, x_launches, dict(
        blocks_per_slot=bps, logit_diffs=diffs,
        short_max_gap=max(short_gaps),
        ring_tpot_ms=ring_tpot, pim_tpot_ms=psummary["mean_tpot_s"] * 1e3)


# granite-moe-1b-a400m's dispatch at full width: one layer's experts on
# (2, 128) bf16 tokens, a shared vector plus noise of half its scale, so
# that most tokens pick the same experts and overflow the capacity (80 of
# 256 at the default factor)
MOE_DISPATCH_SHAPE = (2, 128)
MOE_DISPATCH_NOISE = 0.5
# the dispatch at capacity factor 32 (no drops) against a per-token sum
# over each token's experts on the card: both round the expert products
# to bf16 (at other row counts, so other cuBLAS kernels may run) and cast
# the float32 sum to bf16; a dropped (token, expert) pair moves an entry
# by about an eighth of the largest, a few bf16 ulps do not
MOE_DISPATCH_TOL = 2.0 ** -6


def moe_routes_on_host(ids, t, cap, n_experts):
    """The served and the dropped (token, expert) pairs of top-k ``ids``
    (T, k) under the reference's rule: each expert serves its hits in
    token order up to ``cap``, and its trash slot holds the largest token
    index that is not among them, served if that token was routed there;
    also how many experts the last token overflowed."""
    served, dropped, last = set(), set(), 0
    for e in range(n_experts):
        hits = [int(i) for i in np.nonzero((ids == e).any(1))[0]]
        ok = set(hits[:cap])
        rest = [i for i in range(t) if i not in ok]
        if rest and rest[-1] in hits[cap:]:
            ok.add(rest[-1])
        if t - 1 in hits[cap:]:
            last += 1
        served |= {(i, e) for i in ok}
        dropped |= {(i, e) for i in hits if i not in ok}
    return served, dropped, last


def served_from_rows(dispatches, ids, t):
    """The (token, expert) pairs that the recorded ``moe._dispatch`` calls
    (each ``(tok_of_slot, rows, order, n_e, e_base)``) read back, and the
    read-backs that are wrong: a slot that holds another token, or an
    expert the token was not routed to."""
    got, wrong = set(), []
    for tok_of_slot, rows, order, n_e, e_base in dispatches:
        slots = tok_of_slot.shape[1]
        flat = tok_of_slot.reshape(-1).tolist()
        for i, (row, col) in enumerate(zip(rows.tolist(), order.tolist())):
            for r, j in zip(row, col):
                if r == n_e * slots:
                    continue
                ex = e_base + r // slots
                if flat[r] != i or ids[i][j] != ex:
                    wrong.append((i, ex, flat[r]))
                got.add((i, ex))
    return got, wrong


def check_moe_dispatch(params, cfg, dev):
    """``moe_ffn`` on one full-width layer: bit-identical over two runs;
    the (token, expert) pairs its slot maps served equal to a host
    recomputation from its own top-k ids, with drops and the last token
    among them; at capacity factor 32 within ``MOE_DISPATCH_TOL`` of a
    per-token sum over each token's experts.  Returns (failures, a
    summary)."""
    from repro_torch.models import moe

    layer = {k: v[0] for k, v in params["blocks"]["0"].items()}
    b, s = MOE_DISPATCH_SHAPE
    t, d, e = b * s, cfg.d_model, cfg.n_experts
    g = torch.Generator(device=dev).manual_seed(23)
    shared = torch.randn(d, generator=g, device=dev)
    x = (shared + MOE_DISPATCH_NOISE * torch.randn(
        (b, s, d), generator=g, device=dev)).to(cfg.compute_dtype)
    cap = moe.expert_capacity(t, cfg.top_k, cfg.capacity_factor, e)
    dispatches, routes = [], []
    real_dispatch, real_top_k = moe._dispatch, moe.router_top_k

    def record_dispatch(top_ids, capacity, n_e, e_base=0):
        out = real_dispatch(top_ids, capacity, n_e, e_base)
        dispatches.append(out + (n_e, e_base))
        return out

    def record_top_k(x2d, router, k):
        w, ids = real_top_k(x2d, router, k)
        routes.append(ids)
        return w, ids

    with torch.no_grad():
        with mock.patch.object(moe, "_dispatch", record_dispatch), \
                mock.patch.object(moe, "router_top_k", record_top_k):
            out1 = moe.moe_ffn(x, layer, cfg)
        out2 = moe.moe_ffn(x, layer, cfg)
    torch.cuda.synchronize()
    identical = torch.equal(out1, out2)
    ids = routes[0].cpu().numpy()
    want, dropped, last = moe_routes_on_host(ids, t, cap, e)
    # the pairs whose outputs the dispatch read back, each from a slot
    # that holds the token itself
    got, wrong = served_from_rows(dispatches, ids.tolist(), t)
    exact = [d[3:] for d in dispatches] == [(e, 0)] and got == want \
        and not wrong

    wide = cfg.scaled(capacity_factor=32.0)
    wide_cap = moe.expert_capacity(t, cfg.top_k, 32.0, e)
    with torch.no_grad():
        nodrop = moe.moe_ffn(x, layer, wide)
        xf = x.reshape(t, d)
        w, top = real_top_k(xf, layer["router"], cfg.top_k)
        acc = torch.zeros((t, d), dtype=torch.float32, device=dev)
        for ex in range(e):
            h = torch.nn.functional.silu(xf @ layer["w1"][ex]) * (
                xf @ layer["w3"][ex])
            y = (h @ layer["w2"][ex]).to(torch.float32)
            acc += y * ((top == ex) * w).sum(-1)[:, None]
        brute = acc.to(x.dtype).reshape(b, s, d)
    scale = float(brute.float().abs().max())
    err = float((nodrop.float() - brute.float()).abs().max())
    say(f"[moe dispatch] one full-width layer ({e} experts, top "
        f"{cfg.top_k}, d_ff {cfg.moe_d_ff}) on {t} bf16 tokens (a shared "
        f"vector + {MOE_DISPATCH_NOISE} x noise), capacity {cap}: two runs "
        f"bit-identical: {identical}; served pairs == host recomputation "
        f"from the card's top-k ids: {exact} ({len(want)} served, "
        f"{len(dropped)} dropped; the last token overflowed {last} experts,"
        f" kept through their trash slots); TF32 "
        f"{torch.backends.cuda.matmul.allow_tf32}; at capacity factor 32 "
        f"(capacity {wide_cap}) max abs diff {err:.6f} from the per-token "
        f"expert sum (tol {MOE_DISPATCH_TOL * scale:.6f} = "
        f"{MOE_DISPATCH_TOL} x max {scale:.4f})")
    failures = []
    if not identical:
        failures.append("two runs of the dispatch differ")
    if not exact:
        failures.append(f"served pairs differ from the host rule: "
                        f"{sorted(got ^ want)[:8]}, read back from "
                        f"another token's slot: {wrong[:8]}")
    if not dropped or not last:
        failures.append(f"the case must drop tokens ({len(dropped)}) and "
                        f"the last token ({last} experts)")
    if wide_cap != t or not err <= MOE_DISPATCH_TOL * scale:
        failures.append(f"no-drop dispatch (capacity {wide_cap}) off the "
                        f"per-token sum by {err}")
    return failures, dict(capacity=cap, served=len(want),
                          dropped=len(dropped), last_overflows=last,
                          nodrop_max_abs_diff=err, nodrop_tol=MOE_DISPATCH_TOL
                          * scale)


def serve_moe(dev):
    """Full-width, full-depth granite-moe-1b-a400m (24 layers of 32
    experts, top 8) on fresh weights from seed 0.  ``quant``: 4 requests
    of 16-64 prompt tokens, 8 new tokens, batch 4, whose prefill logits
    and tokens equal the plain GEMM's, one GEMM per attention projection
    in each decode step.  ``pim_sim``: 2 requests of 8 and 16 tokens, 4
    new tokens, batch 2, served twice, logits and tokens equal to the
    exact integer product's, one crossbar launch per projection per decode
    step, no upload after the first decode step and none in the second
    serve, the resident state equal to its host arithmetic.  Then the
    dispatch check (``check_moe_dispatch``), a profiled ``quant`` decode
    step with the host time and device span of its MoE blocks, and the
    release of the weights.  TF32 must be off.  Returns (quant launches,
    crossbar launches, a summary, the quant tokens)."""
    from repro_torch import configs
    from repro_torch.kernels.quant_matmul import ops, quant_matmul_int_ref
    from repro_torch.models import model as model_mod
    from repro_torch.models import model_lib as M
    from repro_torch.pim import engine

    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 is on: MoE routing needs float32 "
                             "matmuls")
    base = configs.get("granite-moe-1b-a400m")
    t0 = time.perf_counter()
    params = M.init_params(base, seed=0, device=dev)
    torch.cuda.synchronize()
    say(f"[granite-moe] full-width {base.name}: "
        f"{M.param_count(base) / 1e6:.1f}M parameters ({base.n_layers} "
        f"layers, d_model {base.d_model}, {base.n_heads} heads of {base.hd},"
        f" {base.n_kv_heads} KV heads, {base.n_experts} experts top "
        f"{base.top_k} of d_ff {base.moe_d_ff}, vocab {base.vocab_size} "
        f"padded to {base.padded_vocab}, tied) drawn on the card from seed "
        f"0 in {time.perf_counter() - t0:.3f} s")
    per_step = len(step_linears(base))
    failures = []

    # quant: 4 requests, prompts 16-64, 8 new tokens, batch 4, paged
    plens, max_new = MOE_QUANT_TRACE["prompt_lens"], MOE_QUANT_TRACE["max_new"]
    qcfg = base.scaled(pim_mode="quant",
                       max_seq_len=trace_len(MOE_QUANT_TRACE))
    toks = torch.as_tensor(np.random.default_rng(19).integers(
        0, base.vocab_size, (1, 64)), device=dev)
    got = prefill_logits(params, qcfg, toks)
    with mock.patch.object(ops, "quant_matmul_int", quant_matmul_int_ref):
        want = prefill_logits(params, qcfg, toks)
    q_prefill_equal = bool(torch.isfinite(got).all()
                               and torch.equal(got, want))
    if not q_prefill_equal:
        failures.append("quant prefill logits differ between the kernel and "
                        "the plain GEMM")

    def quant_serve():
        return serve(params, qcfg, dev, **MOE_QUANT_TRACE)

    reset_counters()
    (tokens, summary, wall), steps = decode_records(quant_serve)
    q_launches = counters()[0]
    with mock.patch.object(ops, "quant_matmul_int", quant_matmul_int_ref):
        plain, _, _ = quant_serve()
    q_steps = sorted({q for _, q, _ in steps})
    say(f"[granite-moe quant] 64-token prefill logits kernel == plain GEMM: "
        f"{q_prefill_equal}; served {summary['n_finished']} requests "
        f"(prompts {plens}, {max_new} new tokens, max_batch 4, paged) in "
        f"{wall:.2f} s: {summary['tokens_per_s']:.2f} tok/s | mean TTFT "
        f"{summary['mean_ttft_s'] * 1e3:.1f} ms | mean TPOT "
        f"{summary['mean_tpot_s'] * 1e3:.2f} ms | quant_matmul_int launches "
        f"{q_launches}, per decode step {q_steps} over {len(steps)} steps "
        f"(expected {per_step}); tokens == the plain GEMM's: "
        f"{tokens == plain} ({tokens[0]})")
    if tokens != plain:
        failures.append(f"quant tokens {tokens} vs the plain GEMM's {plain}")
    if q_steps != [per_step] or any(x for _, _, x in steps):
        failures.append(f"quant decode steps launched {steps}, expected "
                        f"{per_step} GEMMs each")

    # pim_sim: 2 requests of 8 and 16 tokens, 4 new tokens, batch 2, twice
    plen, pnew = 16, 4
    pcfg = base.scaled(pim_mode="pim_sim", max_seq_len=plen + pnew)
    toks = torch.as_tensor(np.random.default_rng(21).integers(
        0, base.vocab_size, (1, plen)), device=dev)
    t0 = time.perf_counter()
    got = prefill_logits(params, pcfg, toks)
    t_prefill = time.perf_counter() - t0
    with mock.patch.object(engine, "matmul_int", exact_matmul):
        want = prefill_logits(params, pcfg, toks)
    p_prefill_equal = bool(torch.isfinite(got).all()
                               and torch.equal(got, want))
    if not p_prefill_equal:
        failures.append("pim_sim prefill logits differ from the exact 7-bit "
                        "integer product")

    def pim_serve():
        return serve(params, pcfg, dev, n_requests=2, prompt_lens=(8, plen),
                     max_new=pnew, max_batch=2, seed=22)

    info0 = engine.cache_info()
    reset_counters()
    (first, psummary, pwall), rec1 = decode_records(pim_serve, bits=True)
    info1 = engine.cache_info()
    (second, _, _), rec2 = decode_records(pim_serve, bits=True)
    x_launches = counters()[1]
    info2 = engine.cache_info()
    with mock.patch.object(engine, "matmul_int", exact_matmul):
        pwant, _, _ = pim_serve()
    decode_state = sum(pim_state_bytes(2, k, o)
                       for k, o in step_linears(base))
    x_steps = sorted({x for _, _, x, _, _ in rec1 + rec2})
    # pim_bits: one read per linear a step; one write of x per linear, and
    # one of w per linear in the step that uploads its state
    prev_uploads = ([info0.exec_uploads] + [u for u, *_ in rec1][:-1]
                    + [info1.exec_uploads] + [u for u, *_ in rec2][:-1])
    uploaded = [u - v for (u, *_), v in zip(rec1 + rec2, prev_uploads)]
    bits_steps = [(wr, rd) for *_, wr, rd in rec1 + rec2]
    bits_want = [(per_step * (2 if up else 1), per_step) for up in uploaded]
    say(f"[granite-moe pim_sim] 16-token prefill logits on the crossbar "
        f"kernel == exact 7-bit integer product: {p_prefill_equal}, "
        f"{t_prefill:.2f} s on transient state; served 2 requests (8- and "
        f"16-token prompts, {pnew} new tokens, max_batch 2, paged) twice, "
        f"the first in {pwall:.2f} s: mean TTFT "
        f"{psummary['mean_ttft_s'] * 1e3:.0f} ms | mean TPOT "
        f"{psummary['mean_tpot_s'] * 1e3:.0f} ms | crossbar_exec launches "
        f"{x_launches}, per decode step {x_steps} (expected {per_step}) | "
        f"pim_bits (writes, reads) per decode step {bits_steps} (expected "
        f"{bits_want}) | cold uploads after each decode step, first serve "
        f"{[u - info0.exec_uploads for u, *_ in rec1]}, second "
        f"{[u - info1.exec_uploads for u, *_ in rec2]} | resident "
        f"{info2.resident_entries} states, {info2.resident_bytes} B (host "
        f"arithmetic {decode_state} B); tokens (both serves) == exact "
        f"product's: {first == second == pwant} ({first})")
    if not first == second == pwant:
        failures.append(f"pim_sim tokens {first}, {second} vs the exact "
                        f"product's {pwant}")
    if x_steps != [per_step] or any(q for _, q, *_ in rec1 + rec2):
        failures.append(f"pim_sim decode steps launched {rec1 + rec2}, "
                        f"expected {per_step} crossbar launches each")
    if bits_steps != bits_want or uploaded[1:] != [0] * (len(uploaded) - 1):
        failures.append(f"pim_bits launched {bits_steps} a decode step, "
                        f"expected {bits_want}, one upload step first")
    if len({u for u, *_ in rec1}) != 1 or \
            any(u != info1.exec_uploads for u, *_ in rec2):
        failures.append(f"pim_sim decode uploaded after its first step: "
                        f"{rec1}, {rec2}")
    if info2.resident_bytes != decode_state:
        failures.append(f"{info2.resident_bytes} resident bytes, expected "
                        f"{decode_state}")

    dispatch_failures, dispatch = check_moe_dispatch(params, base, dev)
    failures += dispatch_failures

    # one quant decode step at batch 4, profiled, each MoE block under a
    # record_function range
    with ranged(model_mod, "moe_ffn"):
        prof = profile_decode(params, qcfg, dev, 4)
    moe_host_ms, moe_calls, moe_span_ms = range_times(prof, "moe_ffn")
    gemm_ms = sum(e.self_device_time_total for e in prof["events"]
                  if "quant_matmul_kernel" in e.key) / 1e3

    say(f"[profile] granite-moe quant decode step, batch 4: wall "
        f"{prof['wall_ms']:.2f} ms, device busy {prof['busy_ms']:.2f} ms; "
        f"its {base.n_layers} MoE blocks ({base.n_layers * base.n_experts} "
        f"expert iterations): host {fmt_ms(moe_host_ms)} over "
        f"{moe_calls} calls, device span "
        f"{fmt_ms(moe_span_ms)}; its {per_step} GEMMs {gemm_ms:.3f} ms on "
        f"the device")

    before = footprint(params)
    del params
    check_released(base.name, before)
    if failures:
        raise AssertionError("serve_moe: " + "; ".join(failures))
    return q_launches, x_launches, dict(
        params_m=M.param_count(base) / 1e6,
        quant_tokens_per_s=summary["tokens_per_s"],
        quant_tpot_ms=summary["mean_tpot_s"] * 1e3,
        pim_tpot_ms=psummary["mean_tpot_s"] * 1e3,
        pim_prefill_s=t_prefill, resident_bytes=info2.resident_bytes,
        decode_wall_ms=prof["wall_ms"], decode_busy_ms=prof["busy_ms"],
        moe_host_ms=moe_host_ms, moe_span_ms=moe_span_ms, gemm_ms=gemm_ms,
        dispatch=dispatch), tokens


# --------------------------------------------------------------------------
# the recurrent blocks: jamba-v0.1 (Mamba, attention, MoE) and xlstm-1.3b
# --------------------------------------------------------------------------

# jamba-v0.1 cut to one period (8 of 32 layers: md me md me ad me md me,
# every block kind of the model): the whole model is 51.57 G parameters,
# about 103 GB in bf16, beyond one card's 80 GB
JAMBA_LAYERS = 8
# Mamba state continuity at full width, float32: the reference test's
# tolerance (tests/test_lm_correctness.py::test_mamba_state_continuity)
MAMBA_CONT_RTOL, MAMBA_CONT_ATOL = 2e-3, 2e-4
# xlstm-1.3b's requests: (prompt, new tokens) at max_batch 1 against the
# naive decode, then at max_batch 4
XLSTM_TRACE = ((16, 8), (48, 8))
XLSTM_BATCH_TRACE = ((16, 8), (32, 8), (48, 8), (64, 8), (24, 8))


def check_mamba_continuity(params, cfg, dev):
    """One ``md`` layer's weights at full width in float32: the mixer over
    12 tokens, and over the first 8 then the last 4 from the carried
    state, agree within the reference test's tolerance.  Returns the
    largest |diff| and whether it held."""
    from repro_torch.models.ssm import mamba_mixer

    p = {k: v[0].float() for k, v in params["blocks"]["0"].items()}
    cfg32 = cfg.scaled(dtype="float32")
    g = torch.Generator(device=dev).manual_seed(29)
    x = torch.randn((1, 12, cfg.d_model), generator=g, device=dev)
    with torch.no_grad():
        y_full, _ = mamba_mixer(x, p, cfg32, None)
        _, st = mamba_mixer(x[:, :8], p, cfg32, None)
        y_b, _ = mamba_mixer(x[:, 8:], p, cfg32, st)
    want = y_full[:, 8:]
    diff = (y_b - want).abs()
    ok = bool(torch.isfinite(y_b).all()
              and (diff <= MAMBA_CONT_ATOL
                   + MAMBA_CONT_RTOL * want.abs()).all())
    return float(diff.max()), ok


def serve_jamba(dev):
    """jamba-v0.1-52b at full width, one period (``JAMBA_LAYERS``), fresh
    weights drawn on the card from seed 0, served at ``prompt_bucket=1``.
    ``quant``: 8 requests of 16-64 prompt tokens, 8 new, batch 4, prefill
    logits and tokens equal to the plain GEMM's, one GEMM per linear (16)
    in each decode step.  ``pim_sim``: 2 requests of 8 and 16 tokens, 4
    new, batch 2, served twice, logits and tokens equal to the exact
    integer product's, one crossbar launch per linear per step, no upload
    after the first decode step nor in the second serve, the resident
    state equal to its host arithmetic.  Then a profiled ``quant`` decode
    step (``mamba_mixer`` and ``moe_ffn`` under ``record_function``
    ranges), a profiled ``pim_sim`` one, Mamba state continuity and the
    release of the weights.
    Returns (quant launches, crossbar launches, a summary)."""
    from repro_torch import configs
    from repro_torch.kernels.quant_matmul import ops, quant_matmul_int_ref
    from repro_torch.models import model as model_mod
    from repro_torch.models import model_lib as M
    from repro_torch.pim import engine

    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 is on: MoE routing needs float32 "
                             "matmuls")
    full = configs.get("jamba-v0.1-52b")
    base = full.scaled(n_layers=JAMBA_LAYERS)
    t0 = time.perf_counter()
    params = M.init_params(base, seed=0, device=dev)
    torch.cuda.synchronize()
    draw_s = time.perf_counter() - t0
    say(f"[jamba] full width, {base.n_layers} of {full.n_layers} layers "
        f"({'/'.join(base.pattern)}): {M.param_count(base) / 1e9:.2f}G "
        f"parameters (d_model {base.d_model}, {base.n_heads} heads, "
        f"{base.n_kv_heads} KV heads, d_ff {base.d_ff} gated "
        f"{base.activation}, {base.n_experts} experts top {base.top_k}, "
        f"d_inner {base.d_inner}, d_state {base.mamba_d_state}, conv "
        f"{base.mamba_d_conv}, dt_rank {base.dt_rank}, vocab "
        f"{base.vocab_size}, untied) drawn on the card from seed 0 in "
        f"{draw_s:.3f} s")
    per_step = len(step_linears(base))
    failures = []

    # quant: 8 requests, prompts 16-64, 8 new tokens, batch 4, paged
    plens, max_new = MOE_QUANT_TRACE["prompt_lens"], MOE_QUANT_TRACE["max_new"]
    qcfg = base.scaled(pim_mode="quant",
                       max_seq_len=trace_len(MOE_QUANT_TRACE))
    toks = torch.as_tensor(np.random.default_rng(31).integers(
        0, base.vocab_size, (1, 64)), device=dev)
    got = prefill_logits(params, qcfg, toks)
    with mock.patch.object(ops, "quant_matmul_int", quant_matmul_int_ref):
        want = prefill_logits(params, qcfg, toks)
    q_prefill_equal = bool(torch.isfinite(got).all()
                           and torch.equal(got, want))
    if not q_prefill_equal:
        failures.append("quant prefill logits differ between the kernel and "
                        "the plain GEMM")

    def quant_serve():
        return serve(params, qcfg, dev, n_requests=8, prompt_lens=plens,
                     max_new=max_new, max_batch=4, seed=32)

    reset_counters()
    (tokens, summary, wall), steps = decode_records(quant_serve)
    q_launches = counters()[0]
    with mock.patch.object(ops, "quant_matmul_int", quant_matmul_int_ref):
        plain, _, _ = quant_serve()
    q_steps = sorted({q for _, q, _ in steps})
    say(f"[jamba quant] 64-token prefill logits kernel == plain GEMM: "
        f"{q_prefill_equal}; served {summary['n_finished']} requests "
        f"(prompts {plens}, {max_new} new tokens, max_batch 4, paged, "
        f"prompt_bucket 1) in {wall:.2f} s: {summary['tokens_per_s']:.2f} "
        f"tok/s | mean TTFT {summary['mean_ttft_s'] * 1e3:.1f} ms | mean "
        f"TPOT {summary['mean_tpot_s'] * 1e3:.2f} ms | quant_matmul_int "
        f"launches {q_launches}, per decode step {q_steps} over "
        f"{len(steps)} steps (expected {per_step}); tokens == the plain "
        f"GEMM's: {tokens == plain} ({tokens[0]})")
    if tokens != plain:
        failures.append(f"quant tokens {tokens} vs the plain GEMM's {plain}")
    if q_steps != [per_step] or any(x for _, _, x in steps):
        failures.append(f"quant decode steps launched {steps}, expected "
                        f"{per_step} GEMMs each")

    # pim_sim: 2 requests of 8 and 16 tokens, 4 new tokens, batch 2, twice
    plen, pnew = 16, 4
    pcfg = base.scaled(pim_mode="pim_sim", max_seq_len=plen + pnew)
    toks = torch.as_tensor(np.random.default_rng(33).integers(
        0, base.vocab_size, (1, plen)), device=dev)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    got = prefill_logits(params, pcfg, toks)
    t_prefill = time.perf_counter() - t0
    with mock.patch.object(engine, "matmul_int", exact_matmul):
        want = prefill_logits(params, pcfg, toks)
    p_prefill_equal = bool(torch.isfinite(got).all()
                           and torch.equal(got, want))
    if not p_prefill_equal:
        failures.append("pim_sim prefill logits differ from the exact 7-bit "
                        "integer product")

    def pim_serve():
        return serve(params, pcfg, dev, n_requests=2, prompt_lens=(8, plen),
                     max_new=pnew, max_batch=2, seed=34)

    info0 = engine.cache_info()
    reset_counters()
    (first, psummary, pwall), rec1 = decode_records(pim_serve, bits=True)
    info1 = engine.cache_info()
    (second, _, _), rec2 = decode_records(pim_serve, bits=True)
    x_launches = counters()[1]
    info2 = engine.cache_info()
    peak = torch.cuda.max_memory_allocated()
    with mock.patch.object(engine, "matmul_int", exact_matmul):
        pwant, _, _ = pim_serve()
    decode_state = sum(pim_state_bytes(2, k, o)
                       for k, o in step_linears(base))
    x_steps = sorted({x for _, _, x, _, _ in rec1 + rec2})
    # pim_bits: one read per linear a step; one write of x per linear, and
    # one of w per linear in the step that uploads its state
    prev_uploads = ([info0.exec_uploads] + [u for u, *_ in rec1][:-1]
                    + [info1.exec_uploads] + [u for u, *_ in rec2][:-1])
    uploaded = [u - v for (u, *_), v in zip(rec1 + rec2, prev_uploads)]
    bits_steps = [(wr, rd) for *_, wr, rd in rec1 + rec2]
    bits_want = [(per_step * (2 if up else 1), per_step) for up in uploaded]
    say(f"[jamba pim_sim] 16-token prefill logits on the crossbar kernel == "
        f"exact 7-bit integer product: {p_prefill_equal}, {t_prefill:.2f} s "
        f"on transient state; served 2 requests (8- and 16-token prompts, "
        f"{pnew} new tokens, max_batch 2, paged, prompt_bucket 1) twice, "
        f"the first in {pwall:.2f} s: mean TTFT "
        f"{psummary['mean_ttft_s'] * 1e3:.0f} ms | mean TPOT "
        f"{psummary['mean_tpot_s'] * 1e3:.0f} ms | crossbar_exec launches "
        f"{x_launches}, per decode step {x_steps} (expected {per_step}) | "
        f"pim_bits (writes, reads) per decode step {bits_steps} (expected "
        f"{bits_want}) | cold uploads after each decode step, first serve "
        f"{[u - info0.exec_uploads for u, *_ in rec1]}, second "
        f"{[u - info1.exec_uploads for u, *_ in rec2]} | resident "
        f"{info2.resident_entries} states, {info2.resident_bytes} B (host "
        f"arithmetic {decode_state} B, bound {engine.MAX_RESIDENT_BYTES} B) "
        f"| peak allocated {peak / 2 ** 30:.2f} GiB; tokens (both serves) "
        f"== exact product's: {first == second == pwant} ({first})")
    if not first == second == pwant:
        failures.append(f"pim_sim tokens {first}, {second} vs the exact "
                        f"product's {pwant}")
    if x_steps != [per_step] or any(q for _, q, *_ in rec1 + rec2):
        failures.append(f"pim_sim decode steps launched {rec1 + rec2}, "
                        f"expected {per_step} crossbar launches each")
    if bits_steps != bits_want or uploaded[1:] != [0] * (len(uploaded) - 1):
        failures.append(f"pim_bits launched {bits_steps} a decode step, "
                        f"expected {bits_want}, one upload step first")
    if len({u for u, *_ in rec1}) != 1 or \
            any(u != info1.exec_uploads for u, *_ in rec2):
        failures.append(f"pim_sim decode uploaded after its first step: "
                        f"{rec1}, {rec2}")
    if info2.resident_bytes != decode_state \
            or decode_state > engine.MAX_RESIDENT_BYTES:
        failures.append(f"{info2.resident_bytes} resident bytes, expected "
                        f"{decode_state}")

    # one quant decode step at batch 4, profiled, each Mamba mixer and MoE
    # block under a record_function range
    with ranged(model_mod, "mamba_mixer"), ranged(model_mod, "moe_ffn"):
        prof = profile_decode(params, qcfg, dev, 4)
    mamba = range_times(prof, "mamba_mixer")
    moe = range_times(prof, "moe_ffn")
    gemm_ms = sum(e.self_device_time_total for e in prof["events"]
                  if "quant_matmul_kernel" in e.key) / 1e3

    say(f"[profile] jamba quant decode step, batch 4: wall "
        f"{prof['wall_ms']:.2f} ms, device busy {prof['busy_ms']:.2f} ms; "
        f"its Mamba mixers: host {fmt_ms(mamba[0])} over {mamba[1]} calls, "
        f"device span {fmt_ms(mamba[2])}; its MoE blocks: host "
        f"{fmt_ms(moe[0])} over {moe[1]} calls, device span "
        f"{fmt_ms(moe[2])}; its {per_step} "
        f"GEMMs {gemm_ms:.3f} ms on the device")

    # one pim_sim decode step at batch 2, profiled
    pprof = profile_decode(params, pcfg, dev, 2)
    xbar_ms = sum(e.self_device_time_total for e in pprof["events"]
                  if "crossbar_exec_kernel" in e.key) / 1e3
    say(f"[profile] jamba pim_sim decode step, batch 2: wall "
        f"{pprof['wall_ms']:.2f} ms, device busy {pprof['busy_ms']:.2f} ms; "
        f"its {per_step} crossbar launches {xbar_ms:.2f} ms on the device")

    cont_err, cont_ok = check_mamba_continuity(params, base, dev)
    say(f"[jamba] Mamba state continuity, one md layer at full width in "
        f"float32: 8 tokens then 4 from the carried state vs 12 at once, "
        f"max abs diff {cont_err:.3e} (rtol {MAMBA_CONT_RTOL}, atol "
        f"{MAMBA_CONT_ATOL}): {cont_ok}")
    if not cont_ok:
        failures.append(f"Mamba state continuity off by {cont_err}")

    before = footprint(params)
    del params
    check_released(base.name, before)
    if failures:
        raise AssertionError("serve_jamba: " + "; ".join(failures))
    return q_launches, x_launches, dict(
        layers=base.n_layers, params_g=M.param_count(base) / 1e9,
        draw_s=draw_s, quant_tokens_per_s=summary["tokens_per_s"],
        quant_tpot_ms=summary["mean_tpot_s"] * 1e3,
        pim_tpot_ms=psummary["mean_tpot_s"] * 1e3,
        pim_prefill_s=t_prefill, resident_bytes=info2.resident_bytes,
        pim_peak_bytes=peak, decode_wall_ms=prof["wall_ms"],
        decode_busy_ms=prof["busy_ms"], pim_decode_wall_ms=pprof["wall_ms"],
        pim_decode_busy_ms=pprof["busy_ms"], pim_crossbar_ms=xbar_ms,
        pim_bits=bits_steps,
        mamba_host_ms=mamba[0],
        mamba_span_ms=mamba[2], moe_host_ms=moe[0], moe_span_ms=moe[2],
        gemm_ms=gemm_ms, continuity_max_abs_diff=cont_err)


def serve_xlstm(dev):
    """Full-width, full-depth xlstm-1.3b (48 layers) on fresh weights drawn
    on the card from seed 0, in ``quant`` at ``prompt_bucket=1``: at
    max_batch 1 its tokens equal a naive per-request prefill and
    ``decode_step`` loop's bit for bit; at max_batch 4 the pool holds
    exactly ``cache_specs``' bytes of state and every evicted slot reads
    back zero ``c``/``n``/``m``; one decode step at batch 4 is profiled.
    Neither kernel launches: the xLSTM projections are plain products,
    outside ``linear``.  Returns a summary."""
    from repro_torch import configs
    from repro_torch.models import model_lib as M

    base = configs.get("xlstm-1.3b")
    t0 = time.perf_counter()
    params = M.init_params(base, seed=0, device=dev)
    torch.cuda.synchronize()
    draw_s = time.perf_counter() - t0
    say(f"[xlstm] full-width {base.name}: {M.param_count(base) / 1e9:.2f}G "
        f"parameters ({base.n_layers} layers, {'/'.join(base.pattern)}, "
        f"d_model {base.d_model}, {base.n_heads} heads, proj factor "
        f"{base.xlstm_proj_factor}, vocab {base.vocab_size}, tied) drawn on "
        f"the card from seed 0 in {draw_s:.3f} s")
    failures = []
    qcfg = base.scaled(pim_mode="quant",
                       max_seq_len=max(p + n for p, n in XLSTM_BATCH_TRACE))
    rng = np.random.default_rng(35)
    trace = [(rng.integers(1, base.vocab_size, p), n) for p, n in XLSTM_TRACE]
    kw = dict(paged=True, prompt_bucket=1)

    reset_counters()
    tokens, sched, wall = run_scheduler(params, qcfg, dev, trace,
                                        max_batch=1, **kw)
    del sched
    naive = [ring_oracle(params, qcfg, dev, p, n)[0] for p, n in trace]
    launches1 = counters()
    say(f"[xlstm quant] served {len(trace)} requests (prompts "
        f"{[p for p, _ in XLSTM_TRACE]}, 8 new tokens, max_batch 1, paged, "
        f"prompt_bucket 1) in {wall:.2f} s; tokens == naive prefill + "
        f"decode_step loop: {tokens == naive} ({tokens[0]}); kernel "
        f"launches (quant_matmul_int, crossbar_exec) {launches1}")
    if tokens != naive:
        failures.append(f"batch-1 tokens {tokens} vs the naive decode's "
                        f"{naive}")

    from repro_torch.serving import Scheduler, ServingConfig, make_request

    sched = Scheduler(params, qcfg, ServingConfig(max_batch=4, **kw),
                      device=dev)
    real_evict = sched.pool.evict
    evicted = []

    def evict(slot):
        """The pool's evict, recording whether the slot held state before
        and reads back zero c/n/m after."""
        before_evict = sched.pool.read_slot(slot)
        real_evict(slot)
        after = sched.pool.read_slot(slot)
        evicted.append((
            any(bool(c["c"].any()) for c in before_evict.values()),
            not any(bool(c[k].any()) for c in after.values()
                    for k in ("c", "n", "m"))))

    sched.pool.evict = evict
    for p, n in XLSTM_BATCH_TRACE:
        sched.submit_request(make_request(
            rng.integers(1, base.vocab_size, p), n,
            arrival_time=time.monotonic()))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        sched.run()
    torch.cuda.synchronize()
    bwall = time.perf_counter() - t0
    launches = counters()
    held = sum(t.numel() * t.element_size()
               for c in sched.pool.caches.values() for t in c.values())
    want_bytes = sum(math.prod(shape) * torch.empty((), dtype=dt)
                     .element_size() for c in M.cache_specs(
                         qcfg, 4, qcfg.max_seq_len).values()
                     for shape, dt in c.values())
    summary = sched.metrics.summary()
    say(f"[xlstm quant] served {len(XLSTM_BATCH_TRACE)} requests (prompts "
        f"{[p for p, _ in XLSTM_BATCH_TRACE]}, 8 new tokens, max_batch 4) "
        f"in {bwall:.2f} s: {summary['tokens_per_s']:.2f} tok/s | mean TTFT "
        f"{summary['mean_ttft_s'] * 1e3:.1f} ms | mean TPOT "
        f"{summary['mean_tpot_s'] * 1e3:.2f} ms | pool state {held} B "
        f"(cache_specs at batch 4: {want_bytes} B) | evicts {len(evicted)}, "
        f"each held state before and read back zero c/n/m after: "
        f"{all(a and b for a, b in evicted)} | kernel launches "
        f"(quant_matmul_int, crossbar_exec) over both serves {launches}")
    if held != want_bytes:
        failures.append(f"the pool holds {held} B of state, expected "
                        f"{want_bytes}")
    if len(evicted) != len(XLSTM_BATCH_TRACE) \
            or not all(a and b for a, b in evicted):
        failures.append(f"evicted slots {evicted}: each must hold state and "
                        "read back zeros")
    if launches != (0, 0):
        failures.append(f"xLSTM launched the kernels {launches} times")
    del sched
    # one decode step at batch 4, profiled (neither kernel may launch)
    prof = profile_decode(params, qcfg, dev, 4)
    if prof["launches"] != (0, 0):
        failures.append(f"the profiled xLSTM step launched "
                        f"{prof['launches']}")
    before = footprint(params)
    del params
    check_released(base.name, before)
    if failures:
        raise AssertionError("serve_xlstm: " + "; ".join(failures))
    return dict(layers=base.n_layers, params_g=M.param_count(base) / 1e9,
                draw_s=draw_s, tokens_per_s=summary["tokens_per_s"],
                tpot_ms=summary["mean_tpot_s"] * 1e3,
                decode_wall_ms=prof["wall_ms"],
                decode_busy_ms=prof["busy_ms"],
                state_bytes=held, batch1_equal_naive=tokens == naive)


def serve_recurrent(dev):
    """jamba-v0.1-52b (one full-width period) and full xlstm-1.3b on the
    card (``serve_jamba``, ``serve_xlstm``).  Returns (jamba's quant
    launches, its crossbar launches, a summary)."""
    q, x, jamba = serve_jamba(dev)
    return q, x, dict(jamba=jamba, xlstm=serve_xlstm(dev))


# --------------------------------------------------------------------------
# encoder-decoder and cross-attention: seamless-m4t-medium and
# llama-3.2-vision-11b
# --------------------------------------------------------------------------

# (prompt lengths, new tokens) of each greedy generation, one request per
# prompt; a seamless request carries SEAMLESS_FRAMES frames (64 //
# audio_frames_div, as the reference's stub sizes them at the padded
# prompt length) and a llama-vision one all 1601 patches
SEAMLESS_QUANT = ((16, 32, 48, 64), 8)
SEAMLESS_PIM = ((8, 16), 4)
SEAMLESS_FRAMES = 16
VISION_QUANT = ((16, 32), 8)
# llama-3.2-vision-11b in pim_sim: one period of the pattern (``ad ad ad
# adx ad``), the quant phase's 2 requests with 4 new tokens
VISION_PIM_LAYERS = 5
VISION_PIM = ((16, 32), 4)
# the vision pim_sim phase's allowance for the model's float activations,
# beside the linears' int64 chunk partials (vision_pim_limit)
VISION_ACT_BYTES = 2 << 30
# the seamless train phase: (batch, seq, steps), seq // 4 frames a row
TRAIN_SEAMLESS = (2, 128, 2)


def media_batch(cfg, dev, batch, frames=None, step=0):
    """The memory input of ``batch`` requests from the port's stubs,
    float32 on the card: ``{"frames": (B, frames, d)}`` or
    ``{"patches": (B, n_patches, vision_dim)}``."""
    from repro_torch.data.pipeline import AudioStub, VisionStub

    if cfg.is_encoder_decoder:
        a = AudioStub(cfg.d_model, frames).batch_at(step, batch)
        return {"frames": torch.from_numpy(a).to(dev)}
    a = VisionStub(cfg.vision_dim, cfg.n_patches).batch_at(step, batch)
    return {"patches": torch.from_numpy(a).to(dev)}


def generate(params, cfg, dev, prompts, media, new, profile=None):
    """Greedy generation through the model's own entry points, as the
    reference's tests drive these configs (its scheduler refuses them):
    one ``prefill`` of the prompts right-padded to the longest, logits
    read at each one's ``last_index``, with ``media``; then ``new - 1``
    ``decode_step_slots`` at each slot's own position, from the caches
    alone.  With ``profile`` (a label), the prefill and the second decode
    step run under ``profile_call``.  Returns a dict: the tokens per
    request, every step's logits, the launches (quant_matmul_int,
    crossbar_exec) of the prefill and of each decode step, the engine's
    cold uploads after each decode step, the prefill's peak allocation,
    the ``xk``/``xv`` leaves unchanged by decode, the profiles, the rows
    of the prefill's linears (tokens and memory) and the seconds of the
    prefill and of each decode step."""
    from repro_torch.models import model_lib as M
    from repro_torch.pim import engine

    b, plen = len(prompts), max(len(p) for p in prompts)
    toks = np.zeros((b, plen), np.int64)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = p
    tokens = torch.as_tensor(toks, device=dev)
    last = torch.tensor([len(p) - 1 for p in prompts], device=dev)
    active = torch.ones(b, dtype=torch.bool, device=dev)
    profs = {}

    def run(label, fn):
        if profile is None or label is None:
            return fn()
        profs[label] = profile_call(f"{profile} {label}", fn)
        return profs[label]["out"]

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    q0, x0 = counters()
    t0 = time.perf_counter()
    with torch.no_grad():
        logits, caches = run("prefill", lambda: M.prefill(
            params, {"tokens": tokens, **media}, cfg, last_index=last))
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        q1, x1 = counters()
        pre = (q1 - q0, x1 - x0)
        xattn = {(i, k): c[k].clone() for i, c in caches.items()
                 for k in ("xk", "xv") if k in c}
        out, nxt, pos, steps = [logits], logits.argmax(-1)[:, None], \
            last + 1, []
        gen, step_s = [nxt], []
        for i in range(new - 1):
            q0, x0 = counters()
            t0 = time.perf_counter()
            nxt, logits, caches = run(
                "decode step" if i == 1 else None,
                lambda: M.decode_step_slots(params, nxt.to(torch.int32), pos,
                                            active, caches, cfg))
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            q1, x1 = counters()
            steps.append((q1 - q0, x1 - x0,
                          engine.cache_info().exec_uploads))
            out.append(logits)
            gen.append(nxt)
            pos = pos + 1
    torch.cuda.synchronize()
    kept = bool(xattn) and all(torch.equal(v, caches[i][k])
                               for (i, k), v in xattn.items())
    mem = next(iter(media.values()))
    return dict(tokens=torch.cat(gen, dim=1).tolist(), logits=out,
                prefill_launches=pre, steps=steps, prefill_peak=peak,
                xattn_kept=kept, profiles=profs, rows=b * plen,
                memory_rows=mem.shape[0] * mem.shape[1], batch=b,
                prefill_s=prefill_s, step_s=step_s)


def same_generation(a, b):
    """Two ``generate`` results with equal tokens and bitwise-equal,
    finite logits at every step."""
    return (a["tokens"] == b["tokens"]
            and all(torch.isfinite(x).all() and torch.equal(x, y)
                    for x, y in zip(a["logits"], b["logits"])))


def check_generation(tag, res, cfg, failures):
    """Exact launch counts: one of the mode's kernel per linear (or per
    piece, ``launches``) of the prefill and of each decode step, none of
    the other kernel; decode leaves ``xk``/``xv`` as prefill wrote them."""
    which = {"quant": 0, "pim_sim": 1}[cfg.pim_mode]
    want_pre = [0, 0]
    want_pre[which] = launches(cfg, prefill_linears(
        cfg, res["rows"], res["memory_rows"]))
    want_step = [0, 0]
    want_step[which] = launches(cfg, [(res["batch"], k, n)
                                      for k, n in step_linears(cfg)])
    if list(res["prefill_launches"]) != want_pre:
        failures.append(f"{tag} prefill launched {res['prefill_launches']}, "
                        f"expected {tuple(want_pre)}")
    bad = [s[:2] for s in res["steps"] if list(s[:2]) != want_step]
    if bad:
        failures.append(f"{tag} decode steps launched {bad}, expected "
                        f"{tuple(want_step)} each")
    if not res["xattn_kept"]:
        failures.append(f"{tag}: decode changed the xk/xv leaves")


def profile_ranges(prof, names):
    """' | '-joined host and device-span times of the ``record_function``
    ranges ``names`` in a ``profile_call`` result."""
    parts = []
    for name in names:
        host, calls, span = range_times(prof, name)
        parts.append(f"{name}: host {fmt_ms(host)} over {calls} calls, "
                     f"device span {fmt_ms(span)}")
    return "; ".join(parts)


def serve_seamless(dev):
    """Full-width, full-depth seamless-m4t-medium (12 encoder + 12
    decoder layers) on fresh weights drawn on the card from seed 0.
    ``quant``: 4 requests of 16-64 tokens, 16 frames each, 8 new tokens;
    every step's logits and the tokens equal those of the plain GEMM;
    216 launches in the prefill, 108 in every decode step.  ``pim_sim``:
    2 requests of 8 and 16 tokens, 4 new tokens, run twice; logits and
    tokens equal the exact integer product's, one crossbar launch per
    linear per step, no upload after the first decode step nor in the
    second run, the resident state equal to its host arithmetic, the
    prefill's peak below ``PIM_PEAK_BYTES``.  Then a profiled ``quant``
    prefill and decode step (``_encode`` and ``_cross_attention`` under
    ``record_function`` ranges) and the release of the weights.  Returns
    (quant launches, crossbar launches, a summary)."""
    from repro_torch import configs
    from repro_torch.kernels.quant_matmul import ops, quant_matmul_int_ref
    from repro_torch.models import model as model_mod
    from repro_torch.models import model_lib as M
    from repro_torch.pim import engine

    base = configs.get("seamless-m4t-medium")
    t0 = time.perf_counter()
    params = M.init_params(base, seed=0, device=dev)
    torch.cuda.synchronize()
    draw_s = time.perf_counter() - t0
    say(f"[seamless] full-width {base.name}: "
        f"{M.param_count(base) / 1e9:.3f}G parameters ({base.n_encoder_layers}"
        f" encoder + {base.n_layers} decoder layers, d_model {base.d_model}, "
        f"{base.n_heads} heads of {base.hd}, d_ff {base.d_ff} gated "
        f"{base.activation}, vocab {base.vocab_size} padded to "
        f"{base.padded_vocab}, tied) drawn on the card from seed 0 in "
        f"{draw_s:.3f} s; launches per prefill {len(prefill_linears(base))},"
        f" per decode step {len(step_linears(base))}")
    failures = []
    rng = np.random.default_rng(41)

    # quant: 4 requests, prompts 16-64, 16 frames each, 8 new tokens
    plens, new = SEAMLESS_QUANT
    qcfg = base.scaled(pim_mode="quant", max_seq_len=max(plens) + new)
    qprompts = [rng.integers(1, base.vocab_size, p) for p in plens]
    qmedia = media_batch(base, dev, len(plens), frames=SEAMLESS_FRAMES)
    reset_counters()
    t0 = time.perf_counter()
    got = generate(params, qcfg, dev, qprompts, qmedia, new)
    wall = time.perf_counter() - t0
    q_launches = counters()[0]
    with mock.patch.object(ops, "quant_matmul_int", quant_matmul_int_ref):
        plain = generate(params, qcfg, dev, qprompts, qmedia, new)
    check_generation("seamless quant", got, qcfg, failures)
    q_equal = same_generation(got, plain)
    if not q_equal:
        failures.append(f"quant tokens {got['tokens']} vs the plain GEMM's "
                        f"{plain['tokens']} (or their logits differ)")
    say(f"[seamless quant] {len(plens)} requests (prompts {plens} padded to "
        f"{max(plens)}, {SEAMLESS_FRAMES} frames each, {new} new tokens) "
        f"through prefill + decode_step_slots in {wall:.2f} s: launches "
        f"prefill {got['prefill_launches'][0]}, per decode step "
        f"{sorted({s[0] for s in got['steps']})}, total {q_launches}; "
        f"xk/xv unchanged by decode {got['xattn_kept']}; tokens and every "
        f"step's logits == the plain GEMM's: {q_equal} ({got['tokens'][0]})")

    # pim_sim: 2 requests of 8 and 16 tokens, 16 frames, 4 new, twice
    plens, pnew = SEAMLESS_PIM
    pcfg = base.scaled(pim_mode="pim_sim", max_seq_len=max(plens) + pnew)
    prompts = [rng.integers(1, base.vocab_size, p) for p in plens]
    media = media_batch(base, dev, len(plens), frames=SEAMLESS_FRAMES)
    info0 = engine.cache_info()
    reset_counters()
    t0 = time.perf_counter()
    first = generate(params, pcfg, dev, prompts, media, pnew)
    pwall = time.perf_counter() - t0
    info1 = engine.cache_info()
    second = generate(params, pcfg, dev, prompts, media, pnew)
    x_launches = counters()[1]
    info2 = engine.cache_info()
    with mock.patch.object(engine, "matmul_int", exact_matmul):
        exact = generate(params, pcfg, dev, prompts, media, pnew)
    for tag, res in (("first", first), ("second", second)):
        check_generation(f"seamless pim_sim ({tag} run)", res, pcfg,
                         failures)
    p_equal = same_generation(first, exact) and same_generation(second,
                                                                exact)
    decode_state = sum(pim_state_bytes(len(plens), k, o)
                       for k, o in step_linears(base))
    up1 = [u - info0.exec_uploads for _, _, u in first["steps"]]
    up2 = [u - info1.exec_uploads for _, _, u in second["steps"]]
    peak = max(first["prefill_peak"], second["prefill_peak"])
    say(f"[seamless pim_sim] 2 requests (prompts {plens}, "
        f"{SEAMLESS_FRAMES} frames each, {pnew} new tokens) run twice, the "
        f"first in {pwall:.2f} s: crossbar_exec launches prefill "
        f"{first['prefill_launches'][1]}, per decode step "
        f"{sorted({s[1] for s in first['steps'] + second['steps']})}, total "
        f"{x_launches} | cold uploads after each decode step, first run "
        f"{up1}, second {up2} | resident {info2.resident_entries} states, "
        f"{info2.resident_bytes} B (host arithmetic {decode_state} B, bound "
        f"{engine.MAX_RESIDENT_BYTES} B) | prefill peak allocated "
        f"{peak / 2 ** 30:.2f} GiB (limit {PIM_PEAK_BYTES / 2 ** 30:.0f} GiB)"
        f"; tokens and logits (both runs) == exact product's: {p_equal} "
        f"({first['tokens']})")
    if not p_equal:
        failures.append(f"pim_sim tokens {first['tokens']}, "
                        f"{second['tokens']} vs the exact product's "
                        f"{exact['tokens']} (or their logits differ)")
    if len(set(up1)) != 1 or any(up2):
        failures.append(f"pim_sim decode uploaded after its first step: "
                        f"{up1}, {up2}")
    if info2.resident_bytes != decode_state \
            or decode_state > engine.MAX_RESIDENT_BYTES:
        failures.append(f"{info2.resident_bytes} resident bytes, expected "
                        f"{decode_state}")
    if peak >= PIM_PEAK_BYTES:
        failures.append(f"pim_sim prefill peaked at {peak} bytes")

    # a profiled quant prefill and warm decode step at batch 4
    with ranged(model_mod, "_encode"), ranged(model_mod, "_cross_attention"):
        profs = generate(params, qcfg, dev, qprompts, qmedia, 3,
                         profile="seamless-m4t-medium quant, batch 4,")[
                             "profiles"]
    ranges = ("_encode", "_cross_attention")
    for label, prof in profs.items():
        gemm_ms = sum(e.self_device_time_total for e in prof["events"]
                      if "quant_matmul_kernel" in e.key) / 1e3
        say(f"[profile] seamless quant {label}, batch 4: "
            f"{profile_ranges(prof, ranges)}; its {prof['launches'][0]} "
            f"GEMMs {gemm_ms:.3f} ms on the device")

    before = footprint(params)
    del params
    check_released(base.name, before)
    if failures:
        raise AssertionError("serve_seamless: " + "; ".join(failures))
    step, pre = profs["decode step"], profs["prefill"]
    return q_launches, x_launches, dict(
        params_g=M.param_count(base) / 1e9, draw_s=draw_s,
        quant_wall_s=wall, pim_wall_s=pwall,
        prefill_launches=len(prefill_linears(base)),
        step_launches=len(step_linears(base)),
        resident_bytes=info2.resident_bytes, pim_prefill_peak_bytes=peak,
        decode_wall_ms=step["wall_ms"], decode_busy_ms=step["busy_ms"],
        prefill_wall_ms=pre["wall_ms"], prefill_busy_ms=pre["busy_ms"],
        encode_ms=range_times(pre, "_encode")[0],
        encode_span_ms=range_times(pre, "_encode")[2])


def serve_vision(dev):
    """Full-width, full-depth llama-3.2-vision-11b (40 layers, 8 of them
    ``"adx"``) on fresh weights drawn on the card from seed 0, in
    ``quant``: 2 requests of 16 and 32 tokens, all 1601 patches each, 8
    new tokens; every step's logits and the tokens equal those of the
    plain GEMM; 312 launches in the prefill, 296 in every decode step;
    then a profiled prefill and decode step (``_cross_attention`` under a
    ``record_function`` range) and the release of the weights.  Its
    ``pim_sim`` runs at one period of the pattern (``serve_vision_pim``).
    Returns (quant launches, a summary)."""
    from repro_torch import configs
    from repro_torch.kernels.quant_matmul import ops, quant_matmul_int_ref
    from repro_torch.models import model as model_mod
    from repro_torch.models import model_lib as M

    base = configs.get("llama-3.2-vision-11b")
    t0 = time.perf_counter()
    params = M.init_params(base, seed=0, device=dev)
    torch.cuda.synchronize()
    draw_s = time.perf_counter() - t0
    say(f"[vision] full-width {base.name}: "
        f"{M.param_count(base) / 1e9:.2f}G parameters ({base.n_layers} "
        f"layers, {'/'.join(base.pattern)}, d_model {base.d_model}, "
        f"{base.n_heads} heads, {base.n_kv_heads} KV heads, d_ff "
        f"{base.d_ff} gated {base.activation}, vision_dim "
        f"{base.vision_dim}, {base.n_patches} patches, vocab "
        f"{base.vocab_size}, untied) drawn on the card from seed 0 in "
        f"{draw_s:.3f} s; launches per prefill {len(prefill_linears(base))},"
        f" per decode step {len(step_linears(base))}")
    failures = []
    rng = np.random.default_rng(43)
    plens, new = VISION_QUANT
    qcfg = base.scaled(pim_mode="quant", max_seq_len=max(plens) + new)
    prompts = [rng.integers(1, base.vocab_size, p) for p in plens]
    media = media_batch(base, dev, len(plens))
    reset_counters()
    t0 = time.perf_counter()
    got = generate(params, qcfg, dev, prompts, media, new)
    wall = time.perf_counter() - t0
    q_launches = counters()[0]
    with mock.patch.object(ops, "quant_matmul_int", quant_matmul_int_ref):
        plain = generate(params, qcfg, dev, prompts, media, new)
    check_generation("vision quant", got, qcfg, failures)
    q_equal = same_generation(got, plain)
    if not q_equal:
        failures.append(f"quant tokens {got['tokens']} vs the plain GEMM's "
                        f"{plain['tokens']} (or their logits differ)")
    say(f"[vision quant] {len(plens)} requests (prompts {plens} padded to "
        f"{max(plens)}, {base.n_patches} patches each, {new} new tokens) "
        f"through prefill + decode_step_slots in {wall:.2f} s: launches "
        f"prefill {got['prefill_launches'][0]}, per decode step "
        f"{sorted({s[0] for s in got['steps']})}, total {q_launches}; "
        f"peak allocated {got['prefill_peak'] / 2 ** 30:.2f} GiB; xk/xv "
        f"unchanged by decode {got['xattn_kept']}; tokens and every step's "
        f"logits == the plain GEMM's: {q_equal} ({got['tokens']})")
    with ranged(model_mod, "_cross_attention"):
        profs = generate(params, qcfg, dev, prompts, media, 3,
                         profile="llama-3.2-vision-11b quant, batch 2,")[
                             "profiles"]
    for label, prof in profs.items():
        gemm_ms = sum(e.self_device_time_total for e in prof["events"]
                      if "quant_matmul_kernel" in e.key) / 1e3
        say(f"[profile] vision quant {label}, batch 2: "
            f"{profile_ranges(prof, ('_cross_attention',))}; its "
            f"{prof['launches'][0]} GEMMs {gemm_ms:.3f} ms on the device")
    before = footprint(params)
    del params
    check_released(base.name, before)
    if failures:
        raise AssertionError("serve_vision: " + "; ".join(failures))
    step, pre = profs["decode step"], profs["prefill"]
    return q_launches, dict(
        params_g=M.param_count(base) / 1e9, draw_s=draw_s, quant_wall_s=wall,
        prefill_launches=len(prefill_linears(base)),
        step_launches=len(step_linears(base)),
        peak_bytes=got["prefill_peak"], decode_wall_ms=step["wall_ms"],
        decode_busy_ms=step["busy_ms"],
        prefill_wall_ms=pre["wall_ms"], prefill_busy_ms=pre["busy_ms"])


def vision_pim_limit(cfg, batch, rows, memory_rows):
    """The vision pim_sim phase's bound on its peak allocation above its
    weights, and its parts: the decode state kept resident at ``batch``
    (``pim_state_bytes``), one launch's budget
    (``engine.MAX_LAUNCH_BYTES``), the weights' offset and chunked copies
    (a byte per element, the chunks zero-padded to 37 terms, and 12 bytes
    of scales and sums per output), and activations: twice the largest
    linear's int64 chunk partials (P, M, O) (the pieces' accumulators and
    the partials they reshape to) and ``VISION_ACT_BYTES``."""
    from repro_torch.pim import engine

    shapes = prefill_linears(cfg, rows, memory_rows)
    resident = sum(pim_state_bytes(batch, k, o)
                   for k, o in step_linears(cfg))
    weights = step_linears(cfg) + [(cfg.d_model, cfg.n_kv_heads * cfg.hd)] \
        * 2 * cfg.pattern.count("adx") * cfg.n_super
    copies = sum(o * (k + math.ceil(k / 37) * 37 + 12) for k, o in weights)
    partials = max(math.ceil(k / 37) * m * o * 8 for m, k, o in shapes)
    parts = dict(resident=resident, launch=engine.MAX_LAUNCH_BYTES,
                 copies=copies, partials=2 * partials, act=VISION_ACT_BYTES)
    return sum(parts.values()), parts


def serve_vision_pim(dev):
    """llama-3.2-vision-11b at full width, one period of its pattern
    (``VISION_PIM_LAYERS``: ``ad ad ad adx ad``), fresh weights drawn on
    the card from seed 0, in ``pim_sim``: 2 requests of 16 and 32 tokens
    with all 1601 patches each, prefilled together, 4 new tokens.  Every
    step's logits and the tokens equal the exact integer product's; the
    prefill and each decode step launch the crossbar kernel once per piece
    of each linear (``pim_pieces``: the xwk/xwv over 3,202 patch rows and
    the MLP over 64 token rows split under ``engine.MAX_LAUNCH_BYTES``);
    no launch holds more crossbars than the budget allows; no upload after
    the first decode step; resident bytes equal their host arithmetic; the
    peak above the weights stays under ``vision_pim_limit``; the weights
    release.  Then one xwk piece is timed and held to both plain versions.
    Returns (crossbar launches, the timed piece's row, a summary)."""
    from repro_torch import configs
    from repro_torch.models import model_lib as M
    from repro_torch.pim import engine
    from repro_torch.pim import executor as ex

    full = configs.get("llama-3.2-vision-11b")
    base = full.scaled(n_layers=VISION_PIM_LAYERS)
    plens, new = VISION_PIM
    b = len(plens)
    rows, memory_rows = b * max(plens), b * base.n_patches
    xkv = (memory_rows, base.d_model, base.n_kv_heads * base.hd)
    layer_state = sum(pim_state_bytes(b, k, o)
                      for k, o in _kind_linears(base)["ad"])
    per = engine.launch_bytes(1024, 37, 22)
    if per != PIM_CROSSBAR_LAUNCH_BYTES:
        raise AssertionError(f"the engine reckons {per} B a crossbar, this "
                             f"script {PIM_CROSSBAR_LAUNCH_BYTES} B")
    limit, parts = vision_pim_limit(base, b, rows, memory_rows)
    say(f"[vision pim_sim] full width, {base.n_layers} of {full.n_layers} "
        f"layers ({'/'.join(base.pattern)}, one period): at batch {b} an "
        f"\"ad\" layer's decode linears keep {layer_state} B of crossbar "
        f"state resident, so {full.n_layers} layers would keep about "
        f"{full.n_layers * layer_state / 1e9:.1f} GB against "
        f"MAX_RESIDENT_BYTES {engine.MAX_RESIDENT_BYTES} B and re-upload "
        f"every step; launch budget {engine.MAX_LAUNCH_BYTES} B at {per} B "
        f"a crossbar ({engine.MAX_LAUNCH_BYTES // per} crossbars); peak "
        f"limit above the weights {limit} B ({limit / 2 ** 30:.2f} GiB) = "
        + " + ".join(f"{k} {v}" for k, v in parts.items()))
    gc.collect()
    torch.cuda.synchronize()
    start = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    params = M.init_params(base, seed=0, device=dev)
    torch.cuda.synchronize()
    draw_s = time.perf_counter() - t0
    weights = footprint(params)[0]
    pcfg = base.scaled(pim_mode="pim_sim", max_seq_len=max(plens) + new)
    rng = np.random.default_rng(47)
    prompts = [rng.integers(1, base.vocab_size, p) for p in plens]
    media = media_batch(base, dev, b)
    failures = []
    sizes = []
    real_execute = ex.execute

    def sized(state, mc):
        sizes.append(state.shape[0])
        return real_execute(state, mc)

    info0 = engine.cache_info()
    reset_counters()
    t0 = time.perf_counter()
    with mock.patch.object(ex, "execute", sized):
        got = generate(params, pcfg, dev, prompts, media, new)
    wall = time.perf_counter() - t0
    x_launches = counters()[1]
    info = engine.cache_info()
    peak = torch.cuda.max_memory_allocated() - start - weights
    with mock.patch.object(engine, "matmul_int", exact_matmul):
        exact = generate(params, pcfg, dev, prompts, media, new)
    check_generation("vision pim_sim", got, pcfg, failures)
    equal = same_generation(got, exact)
    if not equal:
        failures.append(f"pim_sim tokens {got['tokens']} vs the exact "
                        f"product's {exact['tokens']} (or their logits "
                        "differ)")
    cap = engine.MAX_LAUNCH_BYTES // PIM_CROSSBAR_LAUNCH_BYTES
    if len(sizes) != x_launches or max(sizes) > cap:
        failures.append(f"{len(sizes)} executions for {x_launches} launches,"
                        f" the largest of {max(sizes)} crossbars (cap {cap})")
    up = [u - info0.exec_uploads for _, _, u in got["steps"]]
    if len(set(up)) != 1:
        failures.append(f"pim_sim decode uploaded after its first step: {up}")
    decode_state = sum(pim_state_bytes(b, k, o)
                       for k, o in step_linears(base))
    if info.resident_bytes != decode_state:
        failures.append(f"{info.resident_bytes} resident bytes, expected "
                        f"{decode_state}")
    if peak >= limit:
        failures.append(f"peaked {peak} B above the weights, limit {limit}")
    n_xkv, largest = pim_pieces(*xkv)
    pre = launches(pcfg, prefill_linears(pcfg, rows, memory_rows))
    say(f"[vision pim_sim] {b} requests (prompts {plens} padded to "
        f"{max(plens)}, {base.n_patches} patches each, {new} new tokens) "
        f"through prefill + decode_step_slots in {wall:.2f} s (prefill "
        f"{got['prefill_s']:.2f} s, decode steps "
        f"{[round(t, 3) for t in got['step_s']]} s); weights "
        f"{weights / 2 ** 30:.2f} GiB drawn in {draw_s:.3f} s; xwk and xwv "
        f"on {xkv[0]} patch rows at (K, O) = {xkv[1:]}: "
        f"{math.ceil(xkv[1] / 37)} x {math.ceil(xkv[0] * xkv[2] / 256)} "
        f"crossbars each in {n_xkv} launches of up to {largest} crossbars "
        f"({largest * PIM_CROSSBAR_LAUNCH_BYTES} B reckoned, "
        f"{largest * 32768} B of state); crossbar_exec launches prefill "
        f"{got['prefill_launches'][1]} (expected {pre}), per decode step "
        f"{sorted({s[1] for s in got['steps']})} (expected "
        f"{len(step_linears(base))}), total {x_launches}, the largest "
        f"{max(sizes)} crossbars | cold uploads after each decode step {up} "
        f"| resident {info.resident_entries} states, {info.resident_bytes} B"
        f" (host arithmetic {decode_state} B) | peak {peak} B "
        f"({peak / 2 ** 30:.2f} GiB) above the weights, limit {limit} B | "
        f"tokens and every step's logits == exact product's: {equal} "
        f"({got['tokens']})")
    summary = dict(
        layers=base.n_layers, draw_s=draw_s, wall_s=wall,
        prefill_s=got["prefill_s"], step_s=got["step_s"],
        prefill_launches=got["prefill_launches"][1],
        step_launches=len(step_linears(base)), xkv_launches=n_xkv,
        xkv_piece_crossbars=largest, largest_launch_crossbars=max(sizes),
        resident_bytes=info.resident_bytes, peak_bytes=peak,
        peak_limit_bytes=limit, peak_limit_parts=parts)
    before = footprint(params)
    del params, got, exact
    check_released(f"{base.name} ({base.n_layers} layers)", before)
    if failures:
        raise AssertionError("serve_vision_pim: " + "; ".join(failures))
    row = time_crossbar_at(dev, *xkv, grouped=2)
    c, n, w_words, g = row["shape"]
    row.update(model="llama-3.2-vision-11b xwk prefill",
               launches_per_prefill=2 * row["launches"]
               * base.pattern.count("adx") * base.n_super)
    say(f"[crossbar_exec] llama-3.2-vision-11b xwk piece (M={xkv[0]}, "
        f"K={xkv[1]}, O={xkv[2]}; piece 1 of {row['launches']}): C={c} "
        f"n={n} W={w_words} G={g}: kernel {row['ms']:.4f} ms | plain "
        f"{row['plain_ms']:.1f} ms | bound {row['bound_ms'] * 1e3:.2f} us "
        f"({row['bound_by']}) | {row['bound_ms'] / row['ms'] * 100:.2f}% of "
        f"bound | {row['launches_per_prefill']} such launches per prefill; "
        "== per-gate plain (exact state), its first and last 2 crossbars "
        "== grouped plain")
    return x_launches, row, summary


def train_seamless(dev):
    """Full-width seamless-m4t-medium in ``quant``: ``TRAIN_SEAMLESS``
    steps of ``launch.train.train_step`` at batch 2, seq 128, with 32
    frames a row from the port's audio stub (the reference's AdamW
    defaults).  Step 0's loss and grad norm equal those through the plain
    GEMM; each step launches once per linear in the forward (the encoder
    included) and once more per decoder linear in remat's recompute.
    Returns (launches, a summary)."""
    from repro_torch import configs
    from repro_torch.kernels.quant_matmul import ops, quant_matmul_int_ref
    from repro_torch.models import model_lib as M
    from repro_torch.optim.adamw import AdamWConfig

    batch, seq, steps = TRAIN_SEAMLESS
    cfg = configs.get("seamless-m4t-medium").scaled(pim_mode="quant")
    batches = _train_batches(cfg, dev, batch, seq, steps)
    frames = seq // cfg.audio_frames_div
    for step, b in enumerate(batches):
        b.update(media_batch(cfg, dev, batch, frames=frames, step=step))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    params = M.init_params(cfg, seed=0, device=dev)
    with mock.patch.object(ops, "quant_matmul_int", quant_matmul_int_ref):
        want_loss, want_norm = _loss_and_norm(params, batches[0], cfg)
    params, opt_state, rows, prof = _train_steps(params, batches, cfg,
                                                 AdamWConfig(), which=0)
    peak = torch.cuda.max_memory_allocated()
    _check_train_rows("train_seamless", rows, cfg, want_loss, want_norm,
                      (batch * seq, batch * frames))
    say(f"[train_seamless] full-width {cfg.name} ({cfg.n_encoder_layers} + "
        f"{cfg.n_layers} layers, remat {cfg.remat}), batch {batch}, seq "
        f"{seq}, {frames} frames, {steps} steps of launch.train.train_step: "
        f"step 0's loss {rows[0]['loss']!r} and grad norm "
        f"{rows[0]['grad_norm']!r} == the plain GEMM's (identical)")
    busy = _train_report("train_seamless", rows, prof, cfg, peak, base,
                         (batch * seq, batch * frames))
    del params, opt_state
    torch.cuda.empty_cache()
    return sum(r["launches"] for r in rows), dict(
        batch=batch, seq=seq, frames=frames, steps=steps,
        losses=[r["loss"] for r in rows],
        wall_ms=[r["wall_s"] * 1e3 for r in rows], busy_ms_last=busy,
        peak_bytes=peak, launches_per_step=rows[0]["launches"])


def serve_multimodal(dev):
    """seamless-m4t-medium and llama-3.2-vision-11b at full width and
    depth (``serve_seamless``, ``serve_vision``), llama-3.2-vision-11b in
    ``pim_sim`` at one period (``serve_vision_pim``), then seamless's train
    steps (``train_seamless``).  Returns (quant launches, crossbar
    launches, the timed xwk piece's row, a summary)."""
    q1, x1, seamless = serve_seamless(dev)
    q2, vision = serve_vision(dev)
    x2, xwk_row, vision_pim = serve_vision_pim(dev)
    q3, train = train_seamless(dev)
    return q1 + q2 + q3, x1 + x2, xwk_row, dict(
        seamless=seamless, vision=vision, vision_pim=vision_pim,
        train=train)


# --------------------------------------------------------------------------
# quant_tp and expert parallelism: two ranks sharing the card
# --------------------------------------------------------------------------

# two processes on the one card: NCCL refuses two ranks on one device, so
# the group is gloo, which moves each collective through host memory
TP_WORLD = 2
# the spawned ranks' deadline; gloo's collectives time out after it too
TP_TIMEOUT_S = 600.0
# the decode linears (name, M, K, N) whose per-rank tiles are held to
# tp_quant_linear_ref and timed: qwen1.5-0.5b's wq (as wk, wv and wo),
# w_in (as w_gate) and w_out; arctic-480b's wq, w_in and w_out
TP_QWEN_LINEARS = (("wq", 4, 1024, 1024), ("w_in", 4, 1024, 2816),
                   ("w_out", 4, 2816, 1024))
TP_ARCTIC_LINEARS = (("wq", 4, 7168, 7168), ("w_in", 4, 7168, 4864),
                     ("w_out", 4, 4864, 7168))
TP_COLLECTIVE_REPS = 50
# the expert-parallel MoE block against the meshless branch: the two
# ranks' bf16 partials summed in bf16 vs one float32 sum cast once, a few
# bf16 ulps of the largest entry (MOE_DISPATCH_TOL's reasoning)
MOE_TP_TOL = MOE_DISPATCH_TOL
# arctic's one-layer checks: the MoE block on 2 x 32 tokens, a 16-token
# prefill (logits of quant_tp under the mesh vs quant without it)
ARCTIC_MOE_SHAPE = (2, 32)
ARCTIC_PREFILL = 16
ARCTIC_LOGIT_TOL = 0.05


def check_tp_world1(dev):
    """World size 1: without a mesh ``tp_quant_linear`` is ``quant_linear``
    bit for bit, one kernel launch, at qwen's three decode shapes."""
    from repro_torch.kernels.quant_matmul import quant_linear, tp_quant_linear

    g = torch.Generator(device=dev).manual_seed(31)
    ok = []
    for name, m, k, n in TP_QWEN_LINEARS:
        x = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
        w = (torch.randn((k, n), generator=g, device=dev) / math.sqrt(k)).to(
            torch.bfloat16)
        reset_counters()
        got = tp_quant_linear(x, w.float())
        launches = counters()[0]
        ok.append(torch.equal(got, quant_linear(x, w.float()))
                  and launches == 1)
    say(f"[tp] world size 1, no mesh: tp_quant_linear == quant_linear bit "
        f"for bit with one launch at {[s[1:] for s in TP_QWEN_LINEARS]}: "
        f"{ok}")
    if not all(ok):
        raise AssertionError(f"quant_tp at world size 1 differs from quant: "
                             f"{ok}")


def tp_say(mesh, *a):
    say(f"[tp r{mesh.rank}]", *a)


def tp_tiles(mesh, dev, layer, linears):
    """Each linear of ``linears`` through ``linear(mode="quant_tp")`` under
    ``mesh`` on a seeded (M, K) bf16 input: this rank's kernel output (its
    int32 tile, before any collective) against ``tp_quant_linear_ref``'s
    tile of this rank, the gathered result against the reference's and
    against single-rank ``quant``, bit for bit."""
    from repro_torch.dist import context as dctx
    from repro_torch.kernels.quant_matmul import (ops, quant_linear,
                                                  tp_quant_linear_ref)
    from repro_torch.kernels.quant_matmul.tp import tp_split, tp_tile_shape
    from repro_torch.models import layers

    r, i = mesh.shape["model"], mesh.index("model")
    g = torch.Generator(device=dev).manual_seed(37)
    real = ops.quant_matmul_int
    rows = []
    for name, m, k, n in linears:
        w = layer[name]
        if tuple(w.shape) != (k, n):
            raise AssertionError(f"{name} is {tuple(w.shape)}, not {(k, n)}")
        x = torch.randn((m, k), generator=g, device=dev).to(w.dtype)
        outs = []

        def rec(a, b):
            y = real(a, b)
            outs.append(y.clone())
            return y

        with torch.no_grad():
            with mock.patch.object(ops, "quant_matmul_int", rec), \
                    dctx.use_mesh(mesh):
                y = layers.linear(x, w, mode="quant_tp")
            want, accs = tp_quant_linear_ref(x, w, r)
            single = quant_linear(x, w.float())
        exact = (len(outs) == 1 and torch.equal(outs[0], accs[i])
                 and torch.equal(y, want) and torch.equal(y, single))
        rows.append(dict(name=name, shape=[m, k, n],
                         split=tp_split((k, n), r),
                         tile=[m, *tp_tile_shape((k, n), r)],
                         exact=bool(exact)))
    tp_say(mesh, "tiles == tp_quant_linear_ref's, outputs == single-rank "
           "quant: " + ", ".join(f"{t['name']} {tuple(t['tile'])} "
                                 f"{t['split']} {t['exact']}" for t in rows))
    return rows


def tp_time(mesh, dev, linears):
    """Rank 0 times the GEMM at each linear's tile shape (``time_quant_gemm``)
    while the other ranks wait: the two processes share the card."""
    import torch.distributed as dist

    from repro_torch.kernels.quant_matmul.tp import tp_tile_shape

    rows = []
    if mesh.rank == 0:
        g = torch.Generator(device=dev).manual_seed(0)

        def rand(*shape):
            return torch.randint(-128, 128, shape, dtype=torch.int8,
                                 device=dev, generator=g)

        floor = cuda_ms(lambda i: torch.cuda._sleep(0), 50)
        for name, m, k, n in linears:
            kl, nl = tp_tile_shape((k, n), mesh.shape["model"])
            row = time_quant_gemm(m, kl, nl, rand, floor)[2]
            rows.append(dict(name=name, shape=[m, kl, nl], **row))
            tp_say(mesh, f"quant_matmul_int at {name}'s tile M={m} K={kl} "
                   f"N={nl}: " + gemm_line(row))
    dist.barrier()
    return rows


def tp_collectives(mesh, dev):
    """Host ms of one all_gather of a (4, 512) float32 tile over the model
    group and of one all_reduce of a (4, 1024) int32 accumulator: a column
    and a row split's collective at qwen's decode size (gloo, one card)."""
    from repro_torch.dist import context as dctx

    y = torch.randn(4, 512, device=dev)
    acc = torch.ones(4, 1024, dtype=torch.int32, device=dev)

    def host_ms(fn):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(TP_COLLECTIVE_REPS):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / TP_COLLECTIVE_REPS * 1e3

    out = dict(all_gather_ms=host_ms(
        lambda: dctx.all_gather(y, "model", dim=1, mesh=mesh)),
        all_reduce_ms=host_ms(
        lambda: dctx.all_reduce(acc, "model", "sum", mesh)))
    tp_say(mesh, f"all_gather (4, 512) float32 {out['all_gather_ms']:.3f} "
           f"ms, all_reduce (4, 1024) int32 {out['all_reduce_ms']:.3f} ms "
           f"(host clock, {TP_COLLECTIVE_REPS} reps; gloo, one card)")
    return out


def collective_s():
    from repro_torch.dist import context as dctx

    return sum(c["seconds"] for c in dctx.counts.values()), sum(
        c["calls"] for c in dctx.counts.values())


@contextlib.contextmanager
def launch_shapes(seen):
    """Append the weight tile (K, N) of every ``quant_matmul_int`` launch
    made inside the block to ``seen``: a call is recorded where the
    kernel's launch counter went up, at the call."""
    from repro_torch.kernels.quant_matmul import ops, quant_matmul_int

    real = ops.quant_matmul_int

    def rec(a, b):
        n0 = quant_matmul_int.launches
        y = real(a, b)
        if quant_matmul_int.launches > n0:
            seen.append((int(b.shape[0]), int(b.shape[1])))
        return y

    with mock.patch.object(ops, "quant_matmul_int", rec):
        yield seen


def tile_counts(shapes):
    """[[K, N, launches], ...] of a list of tile shapes, sorted."""
    counts = {}
    for kn in shapes:
        counts[kn] = counts.get(kn, 0) + 1
    return [[k, n, c] for (k, n), c in sorted(counts.items())]


def tp_serve(mesh, dev, params, cfg, trace, paged, want):
    """``trace`` served in ``cfg``'s mode under ``mesh`` (every request
    arriving at rank 0's now) with the launches of each decode step, in
    all and per weight tile shape (``launch_shapes``)."""
    from repro_torch.dist import context as dctx
    from repro_torch.serving import Scheduler

    arrival = dctx.broadcast_float(time.monotonic(), mesh)
    shapes, step_shapes = [], []

    def run():
        counted = Scheduler._plain_step     # decode_records' step

        def step(self, active, emitted):
            n = len(shapes)
            counted(self, active, emitted)
            step_shapes.append(tile_counts(shapes[n:]))

        with mock.patch.object(Scheduler, "_plain_step", step):
            return serve(params, cfg, dev, paged=paged, arrival=arrival,
                         **trace)

    c0, n0 = collective_s()
    reset_counters()
    with launch_shapes(shapes), dctx.use_mesh(mesh):
        (tokens, summary, wall), steps = decode_records(run)
    launches = counters()[0]
    c1, n1 = collective_s()
    out = dict(tokens=tokens, equal=tokens == want,
               agree=sum(a == b for ta, tb in zip(tokens, want)
                         for a, b in zip(ta, tb)),
               total=sum(len(t) for t in want), launches=launches,
               per_step=sorted({q for _, q, _ in steps}), steps=len(steps),
               per_step_shapes=[list(map(list, c)) for c in sorted(
                   {tuple(map(tuple, c)) for c in step_shapes})],
               tokens_per_s=summary["tokens_per_s"],
               tpot_ms=summary["mean_tpot_s"] * 1e3, wall_s=wall,
               collective_s=c1 - c0, collective_calls=n1 - n0)
    pool = "paged" if paged else "contiguous"
    tp_say(mesh, f"{cfg.name} {cfg.pim_mode} served "
           f"{summary['n_finished']} requests ({pool}) in {wall:.2f} s: "
           f"{out['tokens_per_s']:.2f} tok/s | mean TPOT "
           f"{out['tpot_ms']:.2f} ms | quant_matmul_int launches {launches}, "
           f"per decode step {out['per_step']} over {len(steps)} steps "
           f"(tiles [K, N, launches] {out['per_step_shapes']}) | "
           f"{n1 - n0} collectives, {c1 - c0:.2f} s on the host | tokens == "
           f"the single-rank quant serve's: {out['equal']} ({out['agree']} "
           f"of {out['total']})")
    return out


def tp_profile(mesh, dev, params, cfg):
    """One decode step of a warm quant_tp scheduler at batch 4 under
    ``profile_call``, with its collectives' host time."""
    from repro_torch.dist import context as dctx
    from repro_torch.serving import (Scheduler, ServingConfig,
                                     synthetic_requests)

    start = dctx.broadcast_float(time.monotonic(), mesh)
    with dctx.use_mesh(mesh):
        sched = Scheduler(params, cfg, ServingConfig(
            max_batch=4, paged=True, prompt_bucket=16), device=dev)
        for r in synthetic_requests(4, vocab_size=cfg.vocab_size,
                                    prompt_lens=(16,), max_new_tokens=4,
                                    seed=7, start_time=start):
            sched.submit_request(r)
        sched.step()
        c0, n0 = collective_s()
        prof = profile_call(f"{cfg.name} quant_tp decode step, batch 4, "
                            f"rank {mesh.rank}", sched.step)
        c1, n1 = collective_s()
    tp_say(mesh, f"profiled decode step: wall {prof['wall_ms']:.2f} ms, "
           f"device busy {prof['busy_ms']:.2f} ms, {n1 - n0} collectives "
           f"{(c1 - c0) * 1e3:.2f} ms on the host")
    return dict(wall_ms=prof["wall_ms"], busy_ms=prof["busy_ms"],
                collective_ms=(c1 - c0) * 1e3, collectives=n1 - n0,
                launches=prof["launches"][0])


def tp_moe_layer(mesh, dev, cfg, layer, shape):
    """One expert-parallel MoE block under ``mesh`` on seeded bf16 tokens
    (a shared vector + noise, as ``check_moe_dispatch``): the top-k ids,
    this rank's capacity and served (token, expert) pairs against
    ``moe_routes_on_host``, this rank's partial against the expert loop
    over its experts run without a mesh (bit for bit), and the summed
    output against the meshless branch within ``MOE_TP_TOL``."""
    from repro_torch.dist import context as dctx
    from repro_torch.models import moe

    b, s = shape
    t, d, e = b * s, cfg.d_model, cfg.n_experts
    e_loc = e // mesh.shape["model"]
    e0 = mesh.index("model") * e_loc
    g = torch.Generator(device=dev).manual_seed(23)
    shared = torch.randn(d, generator=g, device=dev)
    x = (shared + MOE_DISPATCH_NOISE * torch.randn(
        (b, s, d), generator=g, device=dev)).to(cfg.compute_dtype)
    cap = moe.expert_capacity(t, cfg.top_k, cfg.capacity_factor, e)
    dispatches, routes, parts = [], [], []
    real_dispatch, real_top_k, real_local = (moe._dispatch, moe.router_top_k,
                                             moe._local_moe)

    def record_dispatch(top_ids, capacity, n_e, e_base=0):
        out = real_dispatch(top_ids, capacity, n_e, e_base)
        dispatches.append(out + (n_e, e_base))
        return out

    def record_top_k(x2d, router, k):
        w, ids = real_top_k(x2d, router, k)
        routes.append(ids)
        return w, ids

    def record_local(*a, capacity, e_base=0, **kw):
        y = real_local(*a, capacity=capacity, e_base=e_base, **kw)
        parts.append((capacity, e_base, y.clone()))
        return y

    with torch.no_grad():
        with mock.patch.object(moe, "_dispatch", record_dispatch), \
                mock.patch.object(moe, "router_top_k", record_top_k), \
                mock.patch.object(moe, "_local_moe", record_local), \
                dctx.use_mesh(mesh):
            out = moe.moe_ffn(x, layer, cfg)
        meshless = moe.moe_ffn(x, layer, cfg)
        xf = x.reshape(t, d)
        w, ids = real_top_k(xf, layer["router"], cfg.top_k)
        own = slice(e0, e0 + e_loc)
        plain = real_local(xf, ids, w, layer["w1"][own], layer["w2"][own],
                           layer["w3"][own], capacity=cap,
                           act_name=cfg.activation, e_base=e0)
    torch.cuda.synchronize()
    ids_np = routes[0].cpu().numpy()
    want, dropped, _ = moe_routes_on_host(ids_np, t, cap, e)
    want = {(i, ex) for i, ex in want if e0 <= ex < e0 + e_loc}
    got, wrong = served_from_rows(dispatches, ids_np.tolist(), t)
    scale = float(meshless.float().abs().max())
    err = float((out.float() - meshless.float()).abs().max())
    res = dict(capacity=cap, e_base=e0, experts=e_loc,
               ids_equal=bool(torch.equal(routes[0], ids)),
               routes_equal=[d[3:] for d in dispatches] == [(e_loc, e0)]
               and got == want and not wrong,
               capacity_equal=[(c, b) for c, b, _ in parts] == [(cap, e0)],
               partial_equal=len(parts) == 1 and torch.equal(parts[0][2],
                                                             plain),
               served=len(want), dropped=len(dropped), max_abs_diff=err,
               tol=MOE_TP_TOL * scale)
    tp_say(mesh, f"{cfg.name} MoE block on {t} tokens, experts {e0}-"
           f"{e0 + e_loc - 1}, capacity {cap}: ids == the meshless router's:"
           f" {res['ids_equal']}; served pairs == host rule: "
           f"{res['routes_equal']} ({len(want)} served here, {len(dropped)} "
           f"dropped in all); capacity {res['capacity_equal']}; partial == "
           f"the plain loop over these experts: {res['partial_equal']}; sum "
           f"vs the meshless branch max abs diff {err:.6f} (tol "
           f"{res['tol']:.6f})")
    return res


def tp_qwen(mesh, dev, want):
    """qwen1.5-0.5b at full width and depth in quant_tp: tiles, their
    times, the collectives, the serve_quant trace in both pools, a
    profiled decode step and autotune_linear's pick."""
    from repro_torch import configs
    from repro_torch.dist import context as dctx
    from repro_torch.models import model_lib as M
    from repro_torch.pim import autotune

    base = configs.get("qwen1.5-0.5b")
    params = M.init_params(base, seed=0, device=dev)
    cfg = base.scaled(pim_mode="quant_tp",
                      max_seq_len=trace_len(QUANT_TRACE))
    layer = {k: v[0] for k, v in params["blocks"]["0"].items()}
    out = dict(tiles=tp_tiles(mesh, dev, layer, TP_QWEN_LINEARS),
               times=tp_time(mesh, dev, TP_QWEN_LINEARS),
               collectives=tp_collectives(mesh, dev))
    out["serves"] = {paged: tp_serve(mesh, dev, params, cfg, QUANT_TRACE,
                                     paged, want) for paged in (True, False)}
    out["profile"] = tp_profile(mesh, dev, params, cfg)
    with dctx.use_mesh(mesh):
        plan = autotune.autotune_linear(4, base.d_model, base.d_model,
                                        trials=5, device=dev)
    out["pick"] = (plan.key, plan.model,
                   [(c.model, c.trial_us) for c in plan.race])
    tp_say(mesh, f"autotune_linear {plan.key}: picks {plan.model} ("
           + ", ".join(f"{m} {us:.1f} us" for m, us in out["pick"][2])
           + ", the max over the ranks)")
    return out


def tp_moe(mesh, dev, want):
    """granite-moe-1b-a400m at full width and depth: one expert-parallel
    block held as ``tp_moe_layer`` says, then serve_moe's quant trace in
    quant_tp (attention in per-rank tiles, 16 experts per rank)."""
    from repro_torch import configs
    from repro_torch.models import model_lib as M

    base = configs.get("granite-moe-1b-a400m")
    params = M.init_params(base, seed=0, device=dev)
    layer = {k: v[0] for k, v in params["blocks"]["0"].items()}
    out = dict(layer=tp_moe_layer(mesh, dev, base, layer,
                                  MOE_DISPATCH_SHAPE))
    cfg = base.scaled(pim_mode="quant_tp",
                      max_seq_len=trace_len(MOE_QUANT_TRACE))
    out["serve"] = tp_serve(mesh, dev, params, cfg, MOE_QUANT_TRACE, True,
                            want)
    return out


def tp_arctic(mesh, dev):
    """One full-width arctic-480b layer (128 experts, 64 per rank), drawn
    by ``init_params`` on rank 0, then on rank 1, with a barrier between
    (a rank's draw never overlaps another's): its MoE block as
    ``tp_moe_layer``, its wq (col), w_in (row) and w_out (col) tiles as
    ``tp_tiles`` and timed, and a 16-token prefill in quant_tp under the
    mesh against quant without it."""
    import torch.distributed as dist

    from repro_torch import configs
    from repro_torch.dist import context as dctx
    from repro_torch.models import model_lib as M

    base = configs.get("arctic-480b").scaled(n_layers=1)
    t0 = time.perf_counter()
    params = None
    for r in range(mesh.size):
        if mesh.rank == r:
            params = M.init_params(base, seed=0, device=dev)
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
        dist.barrier()
    draw_s = time.perf_counter() - t0
    free, total = torch.cuda.mem_get_info()
    nbytes = footprint(params)[0]
    tp_say(mesh, f"arctic-480b, 1 of {configs.get('arctic-480b').n_layers} "
           f"layers at full width: {M.param_count(base) / 1e9:.2f} G "
           f"parameters, {nbytes} bytes on this rank "
           f"({torch.cuda.memory_reserved() / 2 ** 30:.2f} GiB reserved); "
           f"both ranks drawn in {draw_s:.2f} s; the card has "
           f"{(total - free) / 2 ** 30:.2f} of {total / 2 ** 30:.2f} GiB in "
           f"use")
    layer = {k: v[0] for k, v in params["blocks"]["0"].items()}
    out = dict(param_bytes=nbytes, draw_s=draw_s,
               card_used_bytes=total - free,
               layer=tp_moe_layer(mesh, dev, base, layer, ARCTIC_MOE_SHAPE),
               tiles=tp_tiles(mesh, dev, layer, TP_ARCTIC_LINEARS),
               times=tp_time(mesh, dev, TP_ARCTIC_LINEARS))
    toks = torch.as_tensor(np.random.default_rng(29).integers(
        0, base.vocab_size, (1, ARCTIC_PREFILL)), device=dev)
    qcfg = base.scaled(pim_mode="quant", max_seq_len=ARCTIC_PREFILL)
    shapes = []
    reset_counters()
    with launch_shapes(shapes), dctx.use_mesh(mesh):
        got = prefill_logits(params, qcfg.scaled(pim_mode="quant_tp"), toks)
    launches = counters()[0]
    want = prefill_logits(params, qcfg, toks)
    scale = float(want.float().abs().max())
    out.update(prefill_launches=launches,
               prefill_shapes=tile_counts(shapes), prefill_finite=bool(
        torch.isfinite(got).all()), prefill_max_abs_diff=float(
        (got.float() - want.float()).abs().max()), prefill_scale=scale)
    tp_say(mesh, f"arctic {ARCTIC_PREFILL}-token prefill, quant_tp under the "
           f"mesh vs quant: max abs logit diff "
           f"{out['prefill_max_abs_diff']:.5f} (largest {scale:.4f}, tol "
           f"{ARCTIC_LOGIT_TOL}), {launches} quant_matmul_int launches "
           f"(tiles [K, N, launches] {out['prefill_shapes']})")
    del params, layer
    gc.collect()
    torch.cuda.empty_cache()
    return out


def tp_rank(mesh, q_tokens, moe_tokens):
    """One rank of ``serve_tp``, in its own process: qwen, granite-moe and
    arctic in turn.  Returns what the parent holds the ranks to."""
    dev = torch.device("cuda", torch.cuda.current_device())
    tp_say(mesh, f"{mesh} on {torch.cuda.get_device_name(dev)}, gloo")
    out = {}
    for name, phase in (("qwen", lambda: tp_qwen(mesh, dev, q_tokens)),
                        ("moe", lambda: tp_moe(mesh, dev, moe_tokens)),
                        ("arctic", lambda: tp_arctic(mesh, dev))):
        out[name] = phase()
        # the phase's weights are dropped: give their blocks back to the
        # card before the next draw (arctic's two ranks need 56 GB)
        gc.collect()
        torch.cuda.empty_cache()
    return out


def tp_failures(ranks, tiles):
    """Every check of the ranks' results that failed.  ``tiles`` holds the
    launches per weight tile shape that the configs call for
    (``tile_counts``): ``"qwen"`` and ``"moe"`` per decode step,
    ``"arctic"`` in the one-layer prefill."""
    per_step = sum(c for _, _, c in tiles["qwen"])
    moe_per_step = sum(c for _, _, c in tiles["moe"])
    fails = []
    for r, res in enumerate(ranks):
        q, m, a = res["qwen"], res["moe"], res["arctic"]
        for t in q["tiles"] + a["tiles"]:
            if not t["exact"]:
                fails.append(f"rank {r}: {t['name']} tile {t['tile']} "
                             "differs")
        for paged, sv in q["serves"].items():
            if not sv["equal"]:
                fails.append(f"rank {r}: qwen quant_tp tokens (paged "
                             f"{paged}) differ from serve_quant's")
            if sv["per_step"] != [per_step]:
                fails.append(f"rank {r}: qwen decode steps launched "
                             f"{sv['per_step']}, expected {per_step}")
            if sv["per_step_shapes"] != [tiles["qwen"]]:
                fails.append(f"rank {r}: qwen decode steps launched tiles "
                             f"{sv['per_step_shapes']}, expected "
                             f"{tiles['qwen']}")
        if q["profile"]["launches"] != per_step:
            fails.append(f"rank {r}: the profiled step launched "
                         f"{q['profile']['launches']}")
        for name, lay in (("granite-moe", m["layer"]),
                          ("arctic", a["layer"])):
            for key in ("ids_equal", "routes_equal", "capacity_equal",
                        "partial_equal"):
                if not lay[key]:
                    fails.append(f"rank {r}: {name} MoE {key} is False")
            if not lay["max_abs_diff"] <= lay["tol"]:
                fails.append(f"rank {r}: {name} MoE sum off the meshless "
                             f"branch by {lay['max_abs_diff']}")
        if m["serve"]["per_step"] != [moe_per_step] or m["serve"][
                "per_step_shapes"] != [tiles["moe"]]:
            fails.append(f"rank {r}: granite-moe decode steps launched "
                         f"{m['serve']['per_step']} "
                         f"({m['serve']['per_step_shapes']}), expected "
                         f"{moe_per_step} ({tiles['moe']})")
        if a["prefill_shapes"] != tiles["arctic"]:
            fails.append(f"rank {r}: arctic's prefill launched tiles "
                         f"{a['prefill_shapes']}, expected "
                         f"{tiles['arctic']}")
        if not (a["prefill_finite"]
                and a["prefill_max_abs_diff"] <= ARCTIC_LOGIT_TOL):
            fails.append(f"rank {r}: arctic prefill off quant's by "
                         f"{a['prefill_max_abs_diff']}")
    picks = {(res["qwen"]["pick"][0], res["qwen"]["pick"][1],
              tuple(res["qwen"]["pick"][2])) for res in ranks}
    if len(picks) != 1:
        fails.append(f"the ranks picked different lowerings: {picks}")
    toks = [[res["qwen"]["serves"][p]["tokens"] for p in (True, False)]
            + [res["moe"]["serve"]["tokens"]] for res in ranks]
    if any(t != toks[0] for t in toks):
        fails.append("the ranks served different tokens")
    return fails


def serve_tp(dev, q_tokens, moe_tokens):
    """quant_tp and the expert-parallel MoE block at model parallel 2.

    At world size 1 (this process, no mesh) ``tp_quant_linear`` is
    ``quant_linear``.  Then ``TP_WORLD`` processes share the card
    (``launch.mesh.spawn``, gloo) and each runs ``tp_rank``: qwen1.5-0.5b
    at full width and depth in quant_tp (each rank's tiles == the plain
    tiles, outputs == single-rank quant, the serve_quant trace's tokens
    in both pools with 168 launches per decode step, a profiled step,
    both ranks picking the same lowering in ``autotune_linear``),
    granite-moe-1b-a400m (16 experts per rank: routes, capacity and
    partials exact, the sum within ``MOE_TP_TOL`` of the meshless branch,
    serve_moe's trace with how many tokens agree) and one arctic-480b
    layer (64 experts per rank).  A rank's exception, a gloo failure or
    the timeout fails the phase.  Returns (the launches of the qwen serve
    per rank, the tile rows, a summary)."""
    from repro_torch import configs
    from repro_torch.kernels.quant_matmul.tp import tp_tile_shape
    from repro_torch.launch.mesh import spawn

    def tiles(linears):
        return tile_counts([tp_tile_shape(kn, TP_WORLD) for kn in linears])

    # the launches per weight tile shape that the configs call for
    want = dict(qwen=tiles(step_linears(configs.get("qwen1.5-0.5b"))),
                moe=tiles(step_linears(configs.get("granite-moe-1b-a400m"))),
                arctic=tiles([(k, n) for _, k, n in prefill_linears(
                    configs.get("arctic-480b").scaled(n_layers=1))]))
    t0 = time.perf_counter()
    check_tp_world1(dev)
    gc.collect()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    say(f"[tp] before the ranks start: this process holds "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB allocated, "
        f"{torch.cuda.memory_reserved() / 2 ** 30:.2f} GiB reserved; the "
        f"card has {(total - free) / 2 ** 30:.2f} of {total / 2 ** 30:.2f} "
        f"GiB in use")
    # the ranks' allocators map memory in expandable segments, so the pages
    # a phase frees go back to the card (a small live tensor cannot pin a
    # freed segment) before arctic's two 26.2 GiB draws
    with mock.patch.dict(os.environ, {
            "PYTORCH_CUDA_ALLOC_CONF": "expandable_segments:True"}):
        ranks = spawn(tp_rank, TP_WORLD, q_tokens, moe_tokens,
                      device="cuda", timeout_s=TP_TIMEOUT_S)
    wall = time.perf_counter() - t0
    fails = tp_failures(ranks, want)
    q0 = ranks[0]["qwen"]
    launches = [res["qwen"]["serves"][True]["launches"] for res in ranks]
    equal = all(sv["equal"] for res in ranks
                for sv in res["qwen"]["serves"].values())
    say(f"[tp] {TP_WORLD} ranks on one card (gloo) in {wall:.1f} s: qwen "
        f"quant_tp tokens == serve_quant's on every rank, both pools: "
        f"{equal}; launches per rank {launches}; granite-moe quant_tp tokens "
        f"agreeing "
        f"with serve_moe's: {[res['moe']['serve']['agree'] for res in ranks]} "
        f"of {ranks[0]['moe']['serve']['total']}; autotune_linear picks "
        f"{[res['qwen']['pick'][1] for res in ranks]}")
    if fails:
        raise AssertionError("serve_tp: " + "; ".join(fails))
    # each timed tile shape with its launches as rank 0 counted them: in
    # one decode step of the qwen serve, in arctic's one-layer prefill
    q_tiles = {(k, n): c for k, n, c in q0["serves"][True][
        "per_step_shapes"][0]}
    a_tiles = {(k, n): c for k, n, c in ranks[0]["arctic"]["prefill_shapes"]}
    rows = [dict(row, model="qwen1.5-0.5b", launches_per_decode_step=q_tiles[
        tuple(row["shape"][1:])]) for row in q0["times"]]
    rows += [dict(row, model="arctic-480b", launches_per_prefill=a_tiles[
        tuple(row["shape"][1:])], prefill_tokens=ARCTIC_PREFILL)
        for row in ranks[0]["arctic"]["times"]]
    summary = dict(
        wall_s=wall, collectives=q0["collectives"],
        qwen=[dict({k: v for k, v in sv.items() if k != "tokens"},
                   pool="paged" if p else "contiguous")
              for p, sv in q0["serves"].items()],
        profile=[res["qwen"]["profile"] for res in ranks],
        pick=q0["pick"],
        moe=dict(layer=ranks[0]["moe"]["layer"],
                 serve={k: v for k, v in ranks[0]["moe"]["serve"].items()
                        if k != "tokens"}),
        arctic={k: v for k, v in ranks[0]["arctic"].items()
                if k not in ("tiles", "times")})
    return launches, rows, summary


# --------------------------------------------------------------------------
# the serving router: a two-replica fleet of full-width qwen1.5-0.5b
# --------------------------------------------------------------------------

FLEET_REPLICAS = 2
# the round at whose start the planned kill fires (after admits and a few
# decode steps of the first round's requests)
FLEET_KILL_STEP = 3
FLEET_PIM_KILL_STEP = 2


def fleet_pool_bytes(cfg, max_batch, block_size=16):
    """One replica's paged pool at full parity (host arithmetic): the
    attention KV of ``max_batch * ceil(max_seq_len / block_size) + 1``
    blocks."""
    from repro_torch.models import model_lib as M
    from repro_torch.serving.cache import _kv_leaf_bytes

    per_slot = -(-cfg.max_seq_len // block_size)
    return _kv_leaf_bytes(M.paged_cache_specs(
        cfg, max_batch, cfg.max_seq_len, max_batch * per_slot + 1,
        block_size))


def fleet_serve(params, cfg, dev, trace, *, policy, plan=None, **kw):
    """``trace`` [(prompt, new tokens)] through ``serve_fleet`` with
    ``FLEET_REPLICAS`` replicas on ``dev``, every request arriving at 0 on
    the fleet clock.  Returns (tokens in submission order, the summary,
    the wall time, the router's kills as (allocated before the drain,
    allocated after the respawn or retirement))."""
    from repro_torch.launch.serve import serve_fleet
    from repro_torch.serving import Router, RouterConfig, ServingConfig
    from repro_torch.serving import make_request

    reqs = [make_request(p, n, arrival_time=0.0) for p, n in trace]
    kills = []
    real = Router._kill

    def kill(self, rep, **k):
        _sync(dev)
        before = _allocated(dev)
        real(self, rep, **k)
        gc.collect()
        _sync(dev)
        kills.append((before, _allocated(dev)))

    _sync(dev)
    t0 = time.perf_counter()
    with mock.patch.object(Router, "_kill", kill):
        results, summary = serve_fleet(
            params, cfg, reqs, scfg=ServingConfig(**kw),
            rcfg=RouterConfig(n_replicas=FLEET_REPLICAS, policy=policy),
            failure_plan=plan, device=dev)
    _sync(dev)
    wall = time.perf_counter() - t0
    if summary["n_finished"] != len(trace):
        raise AssertionError(f"the fleet served {summary['n_finished']} of "
                             f"{len(trace)} requests")
    return [results[r.rid].tolist() for r in reqs], summary, wall, kills


def fleet_line(tag, summary, wall):
    per = ", ".join(f"r{r} {v:.2f}" for r, v in
                    sorted(summary["per_replica_tok_s"].items()))
    say(f"[fleet] {tag}: {summary['n_finished']} requests in {wall:.2f} s "
        f"wall | fleet clock: {summary['tokens_per_s']:.2f} tok/s (per "
        f"replica {per}) | mean TTFT {summary['mean_ttft_s'] * 1e3:.1f} ms |"
        f" mean TPOT {summary['mean_tpot_s'] * 1e3:.2f} ms | "
        f"{summary['rebalanced_requests']} rebalanced, "
        f"{summary['replica_restarts']} restarts")


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def _allocated(dev):
    return torch.cuda.memory_allocated() if dev.type == "cuda" else 0


def serve_fleet_phase(params, base_cfg, dev, q_tokens, prefix_trace,
                      prefix_tokens, pim_tokens):
    """Two replicas of full-width qwen1.5-0.5b share the card
    (``Router(devices=None)``), each its own scheduler and paged pool.
    ``quant`` on the quant phases' trace with ``round_robin``,
    ``least_loaded``, a kill mid-trace with respawn and one without;
    ``prefix_affinity`` on the prefix phase's shared-prefix trace with the
    prefix cache; ``pim_sim`` on the pim_sim phase's trace, least-loaded
    with a kill mid-trace.  Every fleet's tokens must equal the single
    scheduler's of those phases (``q_tokens``, ``prefix_tokens``,
    ``pim_tokens``); a kill must rebalance requests and restart as
    planned, free the dead pool (the allocation after a respawn at most
    half a pool above the one before the kill, after a retirement at
    least half a pool below it); every pim_sim decode step must launch
    the crossbar kernel once per linear and no decode step after the
    first may upload crossbar state.  Returns the phase's launches of
    each kernel and a summary."""
    from repro_torch.pim import engine
    from repro_torch.serving import FailurePlan, synthetic_requests

    t_phase = time.perf_counter()
    out = {}
    qcfg = base_cfg.scaled(pim_mode="quant",
                           max_seq_len=trace_len(QUANT_TRACE))
    reqs = synthetic_requests(
        QUANT_TRACE["n_requests"], vocab_size=qcfg.vocab_size,
        prompt_lens=QUANT_TRACE["prompt_lens"],
        max_new_tokens=QUANT_TRACE["max_new"], seed=QUANT_TRACE["seed"])
    trace = [(r.prompt, r.max_new_tokens) for r in reqs]
    qkw = dict(max_batch=QUANT_TRACE["max_batch"], paged=True,
               prompt_bucket=max(8, max(QUANT_TRACE["prompt_lens"]) // 4))
    pool = fleet_pool_bytes(qcfg, qkw["max_batch"])
    fails = []
    reset_counters()
    runs = (("round_robin", "round_robin", None),
            ("least_loaded", "least_loaded", None),
            ("kill + respawn", "least_loaded",
             FailurePlan(kill_replica=0, at_step=FLEET_KILL_STEP)),
            ("kill, no respawn", "round_robin",
             FailurePlan(kill_replica=0, at_step=FLEET_KILL_STEP,
                         respawn=False)))
    for tag, policy, plan in runs:
        toks, s, wall, kills = fleet_serve(params, qcfg, dev, trace,
                                           policy=policy, plan=plan, **qkw)
        fleet_line(f"quant {tag}", s, wall)
        if toks != q_tokens:
            fails.append(f"quant {tag}: tokens differ from serve_quant's")
        want_restarts = int(plan is not None and plan.respawn)
        if s["replica_restarts"] != want_restarts:
            fails.append(f"quant {tag}: {s['replica_restarts']} restarts, "
                         f"expected {want_restarts}")
        if plan is not None:
            if not s["rebalanced_requests"] > 0:
                fails.append(f"quant {tag}: the kill rebalanced nothing")
            (before, after), = kills
            rise = after - before
            say(f"[fleet] quant {tag}: allocated {before} B before the "
                f"kill, {after} B after ({rise:+d} B; one pool is {pool} B,"
                " host arithmetic)")
            # memory_allocated is the card's; a CPU rehearsal skips these
            if dev.type != "cuda":
                pass
            elif plan.respawn and rise > pool // 2:
                fails.append(f"quant {tag}: the allocation rose {rise} B "
                             f"over the kill (a pool is {pool} B): the dead "
                             "pool was not freed")
            elif not plan.respawn and rise > -(pool // 2):
                fails.append(f"quant {tag}: retiring a replica freed "
                             f"{-rise} B, less than half a pool ({pool} B)")
        out[tag] = dict(policy=policy, wall_s=wall, **{
            k: s[k] for k in ("tokens_per_s", "per_replica_tok_s",
                              "mean_ttft_s", "mean_tpot_s",
                              "rebalanced_requests", "replica_restarts")},
            kill_alloc_delta=(kills[0][1] - kills[0][0]) if kills else None)

    # prefix affinity on the prefix phase's shared-prefix trace
    pcfg = base_cfg.scaled(pim_mode="quant", max_seq_len=32 + 48 + 16)
    toks, s, wall, _ = fleet_serve(params, pcfg, dev, prefix_trace,
                                   policy="prefix_affinity", max_batch=4,
                                   prompt_bucket=16, paged=True,
                                   prefix_cache=True)
    fleet_line("quant prefix_affinity, prefix cache", s, wall)
    say(f"[fleet] quant prefix_affinity: prefix hit rate "
        f"{s['prefix_hit_rate']:.3f}, {s['prefix_tokens_reused']:.0f} "
        "prompt tokens from the replicas' indexes")
    if toks != prefix_tokens:
        fails.append("quant prefix_affinity: tokens differ from the prefix "
                     "phase's")
    if not s["prefix_hit_rate"] > 0:
        fails.append("quant prefix_affinity: no prefix hit")
    out["prefix_affinity"] = dict(wall_s=wall, **{
        k: s[k] for k in ("tokens_per_s", "per_replica_tok_s", "mean_ttft_s",
                          "mean_tpot_s", "prefix_hit_rate")})
    q_launches = counters()[0]

    # pim_sim: least-loaded, a kill mid-trace, the respawned replica on the
    # engine's resident state
    xcfg = base_cfg.scaled(pim_mode="pim_sim", max_seq_len=16 + 4)
    preqs = synthetic_requests(2, vocab_size=xcfg.vocab_size,
                               prompt_lens=(16,), max_new_tokens=4, seed=6)
    ptrace = [(r.prompt, r.max_new_tokens) for r in preqs]
    reset_counters()
    (toks, s, wall, kills), steps = decode_records(lambda: fleet_serve(
        params, xcfg, dev, ptrace, policy="least_loaded",
        plan=FailurePlan(kill_replica=0, at_step=FLEET_PIM_KILL_STEP),
        max_batch=2, paged=True, prompt_bucket=8))
    x_launches = counters()[1]
    fleet_line("pim_sim least_loaded, kill + respawn", s, wall)
    per_step = len(step_linears(xcfg))
    uploads = [u for u, _, _ in steps]
    say(f"[fleet] pim_sim: {len(steps)} decode steps over both replicas, "
        f"crossbar_exec launches per step {sorted({x for _, _, x in steps})}"
        f" ({per_step} linears), engine uploads after each step {uploads}; "
        f"resident {engine.cache_info().resident_entries} states")
    if toks != pim_tokens:
        fails.append(f"pim_sim fleet tokens {toks} differ from serve_pim's "
                     f"{pim_tokens}")
    if any(x != per_step for _, _, x in steps):
        fails.append(f"pim_sim decode steps launched "
                     f"{[x for _, _, x in steps]}, expected {per_step} each")
    if any(u != uploads[0] for u in uploads):
        fails.append(f"pim_sim decode steps uploaded crossbar state after "
                     f"the first: {uploads}")
    if s["replica_restarts"] != 1 or not s["rebalanced_requests"] > 0:
        fails.append(f"pim_sim kill: {s['replica_restarts']} restarts, "
                     f"{s['rebalanced_requests']} rebalanced")
    out["pim_sim"] = dict(wall_s=wall, decode_steps=len(steps), **{
        k: s[k] for k in ("tokens_per_s", "per_replica_tok_s", "mean_ttft_s",
                          "mean_tpot_s", "rebalanced_requests",
                          "replica_restarts")})
    if fails:
        raise AssertionError("serve_fleet: " + "; ".join(fails))
    wall = time.perf_counter() - t_phase
    say(f"[fleet] every fleet's tokens == the single scheduler's; phase "
        f"{wall:.1f} s")
    out["wall_s"] = wall
    return q_launches, x_launches, out


# --------------------------------------------------------------------------
# the ZeRO-3 trainer: two ranks share the card
# --------------------------------------------------------------------------

# (global batch, seq, steps): each of the 2 ranks trains 2 x 64 = 128 rows
ZERO3_TRAIN = (4, 64, 3)
ZERO3_WORLD = 2
# the checkpoint is written after this many steps; the next step is then
# resumed at world 1
ZERO3_CKPT_AFTER = 2
# granite-moe-1b-a400m at world 4, (data 2, model 2): 2 of its 24 layers
ZERO3_MOE_WORLD = 4
ZERO3_MOE_LAYERS = 2
ZERO3_MOE_TRAIN = (4, 64)
ZERO3_TIMEOUT_S = 600.0
# The sharded run against single-rank train_step on the same weights and
# global batch.  Losses: the same products, the token-sums added in
# another order (float32 losses of about 12.0).  Gradients: a ZeRO-3 leaf's
# is the bf16 sum of the two ranks' bf16 partials where one rank's is one
# product over all rows, so an element may differ by about one bf16 step
# (2^-8 relative): the norm's relative error, per leaf or whole, is below
# that.  AdamW's float32 moments inherit the gradients' error; the bf16
# parameters move by lr (3e-6, 6e-6 at steps 1-2) per step, so they may
# differ by one bf16 step where a rounding tie flips, or by twice the
# update where a near-zero gradient's sign does.  A wrong world sum, norm
# grouping or shard gives errors of order 1.
ZERO3_LOSS_TOL = 1e-4
ZERO3_GNORM_RTOL = 1e-3
ZERO3_GRAD_RTOL = 1e-2
ZERO3_STATE_RTOL = 1e-2
# granite-moe's world-1 reference routes each data rank's rows apart (the
# capacity of the local count, as the sharded branch does) but sums the
# experts' partials in float32 where the 4 ranks sum two bf16 partials
# over "model": a near-tie in a top-k may then route a token elsewhere,
# which changes that token's gradient through every layer below it (layer
# 0's attention leaves came out 0.11-0.13 off on the H100, the loss and
# the gradient norm within 6e-4).  A wrong expert block or world sum moves
# them by about 1.
ZERO3_MOE_LOSS_TOL = 2e-3
ZERO3_MOE_GNORM_RTOL = 2e-2
ZERO3_MOE_GRAD_RTOL = 0.25


def _at_rest(params, opt_state, sharding, cfg):
    """(this rank's parameter and optimizer bytes as held: the distinct
    storages under the trees, the same from the specs: host
    arithmetic)."""
    from repro_torch.dist import zero
    from repro_torch.models import model_lib as M
    from repro_torch.tree import leaves, rebuild

    storages = {}
    for tree in (params, opt_state):
        for _, t in leaves(tree):
            st = t.untyped_storage()
            storages[st.data_ptr()] = st.nbytes()
    specs = M.param_specs(cfg)
    psize = rebuild(specs, (torch.empty((), dtype=dt).element_size()
                            for _, (_, dt, _, _) in leaves(specs)))
    want = zero.shard_bytes(specs, sharding.params, sharding.mesh, psize)
    # AdamW: float32 m and v mirror each leaf's spec; the step is an int32
    f32 = rebuild(specs, (4 for _ in leaves(specs)))
    want += 2 * zero.shard_bytes(specs, sharding.params, sharding.mesh, f32)
    return sum(storages.values()), want + 4


def _requested(dev):
    """The caching allocator's live bytes as the callers asked for them
    (``memory_allocated`` counts whole blocks: a block cut from a freed
    one keeps a remainder of up to 1 MiB unsplit)."""
    return torch.cuda.memory_stats(dev)["requested_bytes.all.current"]


def _init_measured(cfg, ocfg, mesh, dev):
    """``init_sharded`` with the memory it leaves behind: (params,
    opt_state, sharding, {"requested", "allocated"} bytes after less
    before); None on the CPU, which does not count them."""
    from repro_torch.launch.train import init_sharded

    _sync(dev)
    cuda = dev.type == "cuda"
    before = (_requested(dev), _allocated(dev)) if cuda else None
    params, opt_state, sharding = init_sharded(cfg, ocfg, 0, mesh, dev)
    _sync(dev)
    delta = dict(requested=_requested(dev) - before[0],
                 allocated=_allocated(dev) - before[1]) if cuda else None
    return params, opt_state, sharding, delta


def _check_at_rest(tag, res, fails):
    """The rank's storages equal the specs' bytes, and so do the bytes
    that init_sharded left requested from the allocator: a shard that kept
    its whole leaf, or any other tensor left alive, would show here."""
    got, want = res["at_rest"]
    delta = res["alloc_delta"]
    if got != want:
        fails.append(f"{tag}: at-rest storages {got} B != {want} B from the "
                     "specs")
    if delta is not None and delta["requested"] != want:
        fails.append(f"{tag}: init_sharded left {delta['requested']} B "
                     f"requested, the specs say {want} B")


def _grad_errors(grads, specs, mesh, ref_path):
    """Per leaf, ``|g - ref| / |ref|`` (2-norms) of this rank's gradient
    shards against the same shards of a whole gradient tree saved at
    ``ref_path``."""
    from repro_torch.dist import zero
    from repro_torch.tree import leaves

    ref = torch.load(ref_path, mmap=True)
    out = {}
    for (path, g), (_, sp) in zip(leaves(grads), leaves(specs)):
        key = "/".join(path)
        want = zero.shard_leaf(ref[key], sp, mesh).to(g.device, torch.float32)
        err = torch.linalg.vector_norm(g.float() - want)
        out[key] = float(err / torch.clamp(torch.linalg.vector_norm(want),
                                           min=1e-30))
    return out


def _capture_grads(errors, specs, mesh, ref_path):
    """A stand-in for ``launch.train.apply_updates`` that fills ``errors``
    from the first call's gradients (against ``ref_path``; with ``specs``
    None, it saves the whole gradient tree there) and then updates."""
    from repro_torch.launch import train as T
    from repro_torch.tree import leaves

    real = T.apply_updates

    def apply(ocfg, params, grads, state, *rest):
        if not errors:
            if specs is None:
                torch.save({"/".join(p): g.detach().cpu()
                            for p, g in leaves(grads)}, ref_path)
                errors["saved"] = 1.0
            else:
                errors.update(_grad_errors(grads, specs, mesh, ref_path))
        return real(ocfg, params, grads, state, *rest)

    return mock.patch.object(T, "apply_updates", apply)


def zero3_rank(_mesh, cfg, ocfg, batches, ckpt_dir, grads0, dev_type):
    """One rank of ``train_zero3``'s qwen run, in its own process: the
    (pod, data, model) mesh of ``ElasticMesh(1)`` over the world, ZeRO-3
    init, the gathered tree against a whole draw of the same seed, then
    ``ZERO3_TRAIN`` steps of ``train_step`` with the first GEMM's int32
    accumulator of step 0 kept and step 0's gradient shards held to the
    single-rank gradients at ``grads0``, a checkpoint of the gathered tree
    after ``ZERO3_CKPT_AFTER`` steps (rank 0 writes it), one step
    profiled."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.checkpoint.checkpoint import save_checkpoint
    from repro_torch.dist import context as dctx
    from repro_torch.dist import zero
    from repro_torch.kernels.quant_matmul import ops
    from repro_torch.launch.train import train_step
    from repro_torch.models import model_lib as M
    from repro_torch.runtime.fault_tolerance import ElasticMesh
    from repro_torch.tree import leaves

    dev = (torch.device("cuda", torch.cuda.current_device())
           if dev_type == "cuda" else torch.device("cpu"))
    mesh = ElasticMesh(1).make()
    out = dict(mesh=dict(mesh.shape), rank=mesh.rank)
    with dctx.use_mesh(mesh):
        t0 = time.perf_counter()
        params, opt_state, sharding, delta = _init_measured(cfg, ocfg,
                                                            mesh, dev)
        out["init_s"] = time.perf_counter() - t0
        out["at_rest"] = _at_rest(params, opt_state, sharding, cfg)
        out["alloc_delta"] = delta
        gathered = zero.gather_tree(params, sharding.params, mesh)
        whole = M.init_params(cfg, 0, dev)
        out["gathered_equal"] = all(
            torch.equal(a, b) for (_, a), (_, b)
            in zip(leaves(gathered), leaves(whole)))
        del gathered, whole
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        accs = []
        real = ops.quant_matmul_int

        def first_acc(x, w):
            y = real(x, w)
            if not accs:
                accs.append(y.cpu().numpy())
            return y

        grad_err: dict = {}
        rows = []
        for step, batch in enumerate(batches):
            batch = {k: v.to(dev) for k, v in batch.items()}
            if step == ZERO3_CKPT_AFTER:
                t0 = time.perf_counter()
                tree = zero.gather_tree(
                    {"p": params, "o": opt_state},
                    {"p": sharding.params, "o": sharding.opt}, mesh,
                    device="cpu")
                if mesh.rank == 0:
                    save_checkpoint(ckpt_dir, step, tree,
                                    metadata={"arch": cfg.name})
                del tree
                out["ckpt_s"] = time.perf_counter() - t0
                torch.distributed.barrier()
            prof_ctx = (profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA])
                        if step == 1 and dev.type == "cuda"
                        else contextlib.nullcontext())
            patches = contextlib.ExitStack()
            if step == 0:
                patches.enter_context(
                    mock.patch.object(ops, "quant_matmul_int", first_acc))
                patches.enter_context(_capture_grads(
                    grad_err, sharding.params, mesh, grads0))
            dctx.counts.clear()
            reset_counters()
            _sync(dev)
            with prof_ctx as prof, patches:
                t0 = time.perf_counter()
                params, opt_state, loss, metrics = train_step(
                    params, opt_state, batch, cfg, ocfg, sharding)
                _sync(dev)
                wall = time.perf_counter() - t0
            row = dict(step=step, loss=float(loss),
                       grad_norm=float(metrics["grad_norm"]), wall_s=wall,
                       launches=counters()[0],
                       collectives={k: dict(v) for k, v
                                    in dctx.counts.items()})
            if prof is not None:
                row["busy_ms"], _ = _busy(prof)
            rows.append(row)
        out["rows"] = rows
        out["acc0"] = accs[0]
        out["grad_err"] = grad_err
        out["peak_bytes"] = (torch.cuda.max_memory_allocated()
                             if dev.type == "cuda" else 0)
    return out


def zero3_moe_rank(_mesh, cfg, ocfg, batch, grads0, dev_type):
    """One rank of ``train_zero3``'s granite-moe run: ``ElasticMesh(2)``
    over a world of 4, (pod 1, data 2, model 2), ZeRO-3 init, one step
    with ``moe_fsdp_gather``, its gradient shards held to the world-1
    gradients at ``grads0``; every expert gather's shape is kept."""
    from repro_torch.dist import context as dctx
    from repro_torch.launch.train import train_step
    from repro_torch.models import moe
    from repro_torch.runtime.fault_tolerance import ElasticMesh

    dev = (torch.device("cuda", torch.cuda.current_device())
           if dev_type == "cuda" else torch.device("cpu"))
    mesh = ElasticMesh(2).make()
    shapes = []
    real = moe.gather_experts

    def rec(*a, **k):
        y = real(*a, **k)
        shapes.append(tuple(y.shape))
        return y

    grad_err: dict = {}
    with dctx.use_mesh(mesh), mock.patch.object(moe, "gather_experts", rec):
        params, opt_state, sharding, delta = _init_measured(cfg, ocfg,
                                                            mesh, dev)
        at_rest = _at_rest(params, opt_state, sharding, cfg)
        reset_counters()
        _sync(dev)
        t0 = time.perf_counter()
        with _capture_grads(grad_err, sharding.params, mesh, grads0):
            params, opt_state, loss, metrics = train_step(
                params, opt_state, {k: v.to(dev) for k, v in batch.items()},
                cfg, ocfg, sharding)
        _sync(dev)
        wall = time.perf_counter() - t0
    return dict(mesh=dict(mesh.shape), loss=float(loss),
                grad_norm=float(metrics["grad_norm"]), wall_s=wall,
                launches=counters()[0], at_rest=at_rest, alloc_delta=delta,
                grad_err=grad_err,
                gather_shapes=sorted(set(shapes)), gathers=len(shapes))


def _left(res):
    """What init_sharded left on the allocator, as printed."""
    d = res["alloc_delta"]
    return ("not counted on the CPU" if d is None else
            f"{d['requested']} B requested ({d['allocated']} B in blocks)")


def _worst(errors):
    """(leaf, error) of the largest of a rank's per-leaf errors."""
    return max(errors.items(), key=lambda kv: kv[1])


@torch.no_grad()
def _state_errors(got, want, ocfg):
    """The world-2 checkpoint's tree (``got``) against single-rank
    ``train_step``'s after as many steps (``want``): relative 2-norm errors
    of the AdamW moments over the whole tree, and the parameters' largest
    excess over one bf16 step plus twice the steps' summed updates."""
    from repro_torch.optim.adamw import cosine_schedule
    from repro_torch.tree import leaves

    step = int(want["o"]["step"])
    lr_sum = sum(float(cosine_schedule(ocfg, s)) for s in range(1, step + 1))
    diff = {"m": 0.0, "v": 0.0}
    norm = {"m": 0.0, "v": 0.0}
    excess, unequal, total = 0.0, 0, 0
    for (path, a), (_, b) in zip(leaves(got["o"]["leaves"]),
                                 leaves(want["o"]["leaves"])):
        a, b = a.float(), b.float().to(a.device)
        diff[path[-1]] += float(torch.sum(torch.square(a - b)))
        norm[path[-1]] += float(torch.sum(torch.square(b)))
    for (_, a), (_, b) in zip(leaves(got["p"]), leaves(want["p"])):
        a, b = a.float(), b.float().to(a.device)
        lim = 2.0 ** -7 * torch.abs(b) + 2 * lr_sum
        excess = max(excess, float(torch.max(torch.abs(a - b) - lim)))
        unequal += int(torch.count_nonzero(a != b))
        total += b.numel()
    return dict(step=step, step_equal=int(got["o"]["step"]) == step,
                m=math.sqrt(diff["m"] / norm["m"]),
                v=math.sqrt(diff["v"] / norm["v"]), param_excess=excess,
                params_unequal=unequal, params=total, lr_sum=lr_sum)


def _single_rank_qwen(cfg, ocfg, batches, dev, grads0):
    """Single-rank ``train_step`` on the whole tree of seed 0 and the
    global batches, for the steps before the checkpoint: layer 0's wq
    accumulator and the gradients (saved at ``grads0``) of step 0, each
    step's loss and gradient norm, and the trees after the last."""
    from repro_torch.kernels.quant_matmul import ops
    from repro_torch.launch.train import train_step
    from repro_torch.models import model_lib as M
    from repro_torch.optim.adamw import init_state

    params = M.init_params(cfg, 0, dev)
    opt = init_state(ocfg, params)
    accs, saved, rows = [], {}, []
    real = ops.quant_matmul_int

    def first_acc(x, w):
        y = real(x, w)
        if not accs:
            accs.append(y.cpu().numpy())
        return y

    for step in range(ZERO3_CKPT_AFTER):
        patches = contextlib.ExitStack()
        if step == 0:
            patches.enter_context(
                mock.patch.object(ops, "quant_matmul_int", first_acc))
            patches.enter_context(_capture_grads(saved, None, None, grads0))
        with patches:
            params, opt, loss, met = train_step(
                params, opt, {k: v.to(dev) for k, v
                              in batches[step].items()}, cfg, ocfg)
        rows.append(dict(loss=float(loss), grad_norm=float(met["grad_norm"])))
    return accs[0], rows, {"p": params, "o": opt}


def _single_rank_moe(cfg, batch, dev, grads0):
    """granite-moe's world-1 reference for the (data 2, model 2) step:
    the whole tree of seed 0, each data rank's rows routed apart (the
    meshless branch at the local count's capacity), the token-sums added
    over the global count.  Saves the gradients at ``grads0``; returns
    (loss, gradient norm)."""
    from repro_torch.models import model_lib as M
    from repro_torch.optim.adamw import global_norm
    from repro_torch.tree import leaves

    params = M.init_params(cfg, 0, dev)
    ps = [p.requires_grad_(True) for _, p in leaves(params)]
    rows = batch["tokens"].shape[0] // 2
    nll, n_tok = 0.0, 0
    for h in range(2):
        part = {k: v[h * rows:(h + 1) * rows].to(dev)
                for k, v in batch.items()}
        s, n = M.nll_sum(params, part, cfg)
        nll, n_tok = nll + s, n_tok + n
    loss = nll / n_tok
    grads = torch.autograd.grad(loss, ps)
    torch.save({"/".join(p): g.detach().cpu() for (p, _), g
                in zip(leaves(params), grads)}, grads0)
    return float(loss.detach()), float(global_norm(
        {"/".join(p): g for (p, _), g in zip(leaves(params), grads)}))


def train_zero3(dev):
    """The ZeRO-3 trainer on the card: ``ZERO3_WORLD`` processes share it
    (``launch.mesh.spawn``, gloo) and train full-width, full-depth
    qwen1.5-0.5b in ``quant`` (``zero3_rank``).  This process first runs
    single-rank ``train_step`` on the same weights and global batches
    (``_single_rank_qwen``); the ranks hold their step-0 gradient shards
    to its gradients, and here each rank's at-rest storage and allocation
    are held to the specs' arithmetic, the gathered tree to a whole draw,
    layer 0's wq accumulator on the rank's rows, the losses and gradient
    norms of the steps before the checkpoint, and the checkpoint's
    parameters and AdamW state to single-rank's, and the step after the
    checkpoint, resumed here at world 1, to the uninterrupted world-2
    step.  Then granite-moe-1b-a400m (2 of 24 layers) with
    ``moe_fsdp_gather`` at world 4, one step, every rank gathering only
    its 16 of 32 experts, held to a world-1 reference
    (``_single_rank_moe``).  Returns the qwen run's quant_matmul_int
    launches on rank 0 and a summary."""
    import tempfile

    from repro_torch import configs
    from repro_torch.launch.mesh import spawn
    from repro_torch.launch.train import _whole_like, train_step
    from repro_torch.checkpoint.checkpoint import restore_checkpoint
    from repro_torch.optim.adamw import AdamWConfig

    t_phase = time.perf_counter()
    batch, seq, steps = ZERO3_TRAIN
    cfg = configs.get("qwen1.5-0.5b").scaled(pim_mode="quant")
    ocfg = AdamWConfig()
    batches = [{k: v.cpu() for k, v in b.items()}
               for b in _train_batches(cfg, torch.device("cpu"), batch, seq,
                                       steps)]
    fails = []
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="zero3_") as tmp:
        ckpt = os.path.join(tmp, "ckpt")
        grads0 = os.path.join(tmp, "grads0.pt")
        t0 = time.perf_counter()
        acc_single, single, single_tree = _single_rank_qwen(
            cfg, ocfg, batches, dev, grads0)
        single_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        ranks = spawn(zero3_rank, ZERO3_WORLD, cfg, ocfg, batches, ckpt,
                      grads0, dev.type, device=dev.type,
                      timeout_s=ZERO3_TIMEOUT_S)
        spawn_wall = time.perf_counter() - t0
        t0 = time.perf_counter()
        tree, _ = restore_checkpoint(ckpt, ZERO3_CKPT_AFTER,
                                     _whole_like(cfg, ocfg), device=dev)
        restore_s = time.perf_counter() - t0
        state = _state_errors(tree, single_tree, ocfg)
        del single_tree
        # the step after the checkpoint, resumed at world 1
        _, _, resumed, _ = train_step(
            tree["p"], tree["o"], {k: v.to(dev) for k, v
                                   in batches[ZERO3_CKPT_AFTER].items()},
            cfg, ocfg)
        resumed = float(resumed)
        del tree
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    rows_per_rank = batch // ZERO3_WORLD * seq
    for r, res in enumerate(ranks):
        got, want = res["at_rest"]
        leaf, gerr = _worst(res["grad_err"])
        say(f"[zero3] rank {r} {res['mesh']}: at-rest parameter + AdamW "
            f"storages {got} B, {want} B from the specs (host arithmetic), "
            f"init_sharded left {_left(res)}; ZeRO-3 "
            f"init {res['init_s']:.3f} s; gathered tree == whole draw of "
            f"seed 0: {res['gathered_equal']}; step-0 gradient shards vs "
            f"single rank: largest |g - g1|/|g1| {gerr:.3g} ({leaf}); "
            f"checkpoint gather{' + write' if r == 0 else ''} "
            f"{res['ckpt_s']:.2f} s; peak allocated "
            f"{res['peak_bytes'] / 2 ** 30:.2f} GiB")
        for row in res["rows"]:
            coll = row["collectives"]
            say(f"[zero3] rank {r} step {row['step']}: loss "
                f"{row['loss']:.6f} | grad norm {row['grad_norm']:.4f} | "
                f"wall {row['wall_s'] * 1e3:.1f} ms"
                + (f" | device busy {row['busy_ms']:.2f} ms (profiled)"
                   if "busy_ms" in row else "")
                + f" | quant_matmul_int launches {row['launches']} | "
                + ", ".join(f"{k} {v['calls']} calls {v['bytes'] / 2 ** 20:.1f}"
                            f" MiB {v['seconds'] * 1e3:.1f} ms"
                            for k, v in sorted(coll.items())))
        _check_at_rest(f"rank {r}", res, fails)
        if not res["gathered_equal"]:
            fails.append(f"rank {r}: the gathered tree differs from a whole "
                         "draw")
        if not gerr <= ZERO3_GRAD_RTOL:
            fails.append(f"rank {r}: step-0 gradient of {leaf} off the "
                         f"single rank's by {gerr} > {ZERO3_GRAD_RTOL}")
        acc = acc_single[r * rows_per_rank:(r + 1) * rows_per_rank]
        if res["acc0"].shape != acc.shape or not np.array_equal(
                res["acc0"], acc):
            fails.append(f"rank {r}: layer 0's wq accumulator "
                         f"{res['acc0'].shape} differs from the single-rank "
                         f"rows {acc.shape}")
        for one, row in zip(single, res["rows"]):
            d = abs(row["loss"] - one["loss"])
            g = abs(row["grad_norm"] - one["grad_norm"]) / one["grad_norm"]
            if not d <= ZERO3_LOSS_TOL:
                fails.append(f"rank {r}: step {row['step']} loss "
                             f"{row['loss']} vs single-rank {one['loss']} "
                             f"({d} > {ZERO3_LOSS_TOL})")
            if not g <= ZERO3_GNORM_RTOL:
                fails.append(f"rank {r}: step {row['step']} grad norm "
                             f"{row['grad_norm']} vs single-rank "
                             f"{one['grad_norm']} ({g} > {ZERO3_GNORM_RTOL})")
        if not all(math.isfinite(x["loss"]) and math.isfinite(x["grad_norm"])
                   for x in res["rows"]):
            fails.append(f"rank {r}: a loss or grad norm is not finite")
    world2 = ranks[0]["rows"][ZERO3_CKPT_AFTER]["loss"]
    d_res = abs(resumed - world2)
    say(f"[zero3] single-rank train_step in this process "
        f"({single_s:.1f} s): losses "
        + ", ".join(f"{one['loss']!r}" for one in single) + "; grad norms "
        + ", ".join(f"{one['grad_norm']!r}" for one in single)
        + f"; sharded rank 0: losses "
        + ", ".join(f"{row['loss']!r}" for row in ranks[0]["rows"]
                    [:ZERO3_CKPT_AFTER]) + "; grad norms "
        + ", ".join(f"{row['grad_norm']!r}" for row in ranks[0]["rows"]
                    [:ZERO3_CKPT_AFTER])
        + f" (tolerances {ZERO3_LOSS_TOL} absolute, {ZERO3_GNORM_RTOL} "
        f"relative)")
    say(f"[zero3] layer 0's wq int32 accumulator on each rank's "
        f"{rows_per_rank} rows == the single-rank run's rows: "
        f"{not any('accumulator' in f for f in fails)}; the world-2 "
        f"checkpoint after {state['step']} steps vs single rank: AdamW m "
        f"{state['m']:.3g}, v {state['v']:.3g} relative (tolerance "
        f"{ZERO3_STATE_RTOL}), parameters {state['params_unequal']} of "
        f"{state['params']} unequal, largest excess over one bf16 step + "
        f"2 x {state['lr_sum']:.3g} {state['param_excess']:.3g} (<= 0); "
        f"step {ZERO3_CKPT_AFTER} resumed at world 1 from the checkpoint "
        f"(restored in {restore_s:.2f} s): {resumed!r} vs {world2!r} "
        f"uninterrupted at world 2 ({d_res:.3g})")
    if not (state["step_equal"] and state["m"] <= ZERO3_STATE_RTOL
            and state["v"] <= ZERO3_STATE_RTOL
            and state["param_excess"] <= 0):
        fails.append(f"the world-2 checkpoint differs from single rank's "
                     f"tree: {state}")
    if not d_res <= ZERO3_LOSS_TOL:
        fails.append(f"the resumed step's loss {resumed} is {d_res} off the "
                     f"world-2 step's {world2}")

    # granite-moe-1b-a400m: 2 layers at full width, world 4
    mcfg = configs.get("granite-moe-1b-a400m").scaled(
        n_layers=ZERO3_MOE_LAYERS, pim_mode="quant", moe_fsdp_gather=True)
    mb = [{k: v.cpu() for k, v in b.items()} for b in _train_batches(
        mcfg, torch.device("cpu"), *ZERO3_MOE_TRAIN, 1)][0]
    with tempfile.TemporaryDirectory(prefix="zero3_moe_") as tmp:
        grads0 = os.path.join(tmp, "grads0.pt")
        m_loss, m_gnorm = _single_rank_moe(mcfg, mb, dev, grads0)
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        t0 = time.perf_counter()
        mranks = spawn(zero3_moe_rank, ZERO3_MOE_WORLD, mcfg, ocfg, mb,
                       grads0, dev.type, device=dev.type,
                       timeout_s=ZERO3_TIMEOUT_S)
        moe_wall = time.perf_counter() - t0
    e_loc = mcfg.n_experts // 2
    say(f"[zero3] granite-moe world-1 reference (each data rank's rows "
        f"routed apart): loss {m_loss!r}, grad norm {m_gnorm!r}")
    for r, res in enumerate(mranks):
        got, want = res["at_rest"]
        leaf, gerr = _worst(res["grad_err"])
        d = abs(res["loss"] - m_loss)
        g = abs(res["grad_norm"] - m_gnorm) / m_gnorm
        say(f"[zero3] granite-moe rank {r} {res['mesh']}: loss "
            f"{res['loss']!r} ({d:.3g} off) | grad norm "
            f"{res['grad_norm']!r} ({g:.3g} relative) | gradient shards: "
            f"largest |g - g1|/|g1| {gerr:.3g} ({leaf}) | wall "
            f"{res['wall_s'] * 1e3:.1f} ms | {res['gathers']} expert gathers"
            f" of shapes {res['gather_shapes']} | at-rest storages {got} B, "
            f"{want} B from the specs, init_sharded left {_left(res)}")
        _check_at_rest(f"granite-moe rank {r}", res, fails)
        if not (res["gathers"] and all(s[0] == e_loc
                                       for s in res["gather_shapes"])):
            fails.append(f"granite-moe rank {r}: expert gathers "
                         f"{res['gather_shapes']}, expected {e_loc} experts "
                         "each")
        if not d <= ZERO3_MOE_LOSS_TOL:
            fails.append(f"granite-moe rank {r}: loss {res['loss']} vs "
                         f"world 1's {m_loss} ({d} > {ZERO3_MOE_LOSS_TOL})")
        if not g <= ZERO3_MOE_GNORM_RTOL:
            fails.append(f"granite-moe rank {r}: grad norm "
                         f"{res['grad_norm']} vs world 1's {m_gnorm} ({g} > "
                         f"{ZERO3_MOE_GNORM_RTOL})")
        if not gerr <= ZERO3_MOE_GRAD_RTOL:
            fails.append(f"granite-moe rank {r}: gradient of {leaf} off "
                         f"world 1's by {gerr} > {ZERO3_MOE_GRAD_RTOL}")
    if len({res["loss"] for res in mranks}) != 1:
        fails.append(f"granite-moe ranks report different losses "
                     f"{[res['loss'] for res in mranks]}")
    if fails:
        raise AssertionError("train_zero3: " + "; ".join(fails))
    wall = time.perf_counter() - t_phase
    say(f"[zero3] qwen world {ZERO3_WORLD} in {spawn_wall:.1f} s, "
        f"granite-moe world {ZERO3_MOE_WORLD} in {moe_wall:.1f} s; phase "
        f"{wall:.1f} s")
    r0 = ranks[0]
    return sum(row["launches"] for row in r0["rows"]), dict(
        batch=batch, seq=seq, steps=steps, world=ZERO3_WORLD,
        losses=[row["loss"] for row in r0["rows"]],
        single_rank=single, resumed_loss=resumed, state_vs_single=state,
        grad_err=[_worst(res["grad_err"]) for res in ranks],
        wall_ms=[[row["wall_s"] * 1e3 for row in res["rows"]]
                 for res in ranks],
        busy_ms=[row.get("busy_ms") for row in r0["rows"]],
        collective_s=[[sum(v["seconds"] for v in row["collectives"].values())
                       for row in res["rows"]] for res in ranks],
        at_rest_bytes=[res["at_rest"][0] for res in ranks],
        alloc_delta=[res["alloc_delta"] for res in ranks],
        peak_bytes=[res["peak_bytes"] for res in ranks],
        launches_per_step=r0["rows"][0]["launches"],
        moe=dict(world=ZERO3_MOE_WORLD, layers=ZERO3_MOE_LAYERS,
                 losses=[res["loss"] for res in mranks],
                 grad_norms=[res["grad_norm"] for res in mranks],
                 world1=dict(loss=m_loss, grad_norm=m_gnorm),
                 grad_err=[_worst(res["grad_err"]) for res in mranks],
                 wall_ms=[res["wall_s"] * 1e3 for res in mranks],
                 gather_shapes=mranks[0]["gather_shapes"]),
        wall_s=wall)


# --------------------------------------------------------------------------

# --------------------------------------------------------------------------
# the router over ranks: a four-rank fleet of two quant_tp replicas
# --------------------------------------------------------------------------

FLEET_RANKS_WORLD = 4
FLEET_RANKS_MODEL = 2
# the round at whose start replica 0 is killed and loses its first rank
FLEET_RANKS_KILL_STEP = 2
FLEET_RANKS_TIMEOUT_S = 600.0


def fleet_rank_serve(dev, params, cfg, trace, devices, plan, model_parallel,
                     policy, **kw):
    """One rank's part of a fleet over the world ranks ``devices``: every
    request arriving at 0 on the fleet clock.  Returns its tokens in
    submission order, the summary, the wall time, each decode step this
    rank ran (its replica's model axis, weight tiles, launches and the
    engine's uploads after it), the allocation around each kill, each
    replica's ranks before and after, the rounds and the world
    exchanges' calls and host seconds."""
    from repro_torch.dist import context as dctx
    from repro_torch.pim import engine
    from repro_torch.serving import (Router, RouterConfig, Scheduler,
                                     ServingConfig, make_request)

    reqs = [make_request(p, n, arrival_time=0.0) for p, n in trace]
    shapes, steps, kills = [], [], []
    real_step, real_kill = Scheduler._plain_step, Router._kill

    def step(self, active, emitted):
        n = len(shapes)
        q0, x0 = counters()
        real_step(self, active, emitted)
        q1, x1 = counters()
        m = dctx.current_mesh()
        steps.append(dict(model=m.shape["model"] if m is not None else 1,
                          tiles=tile_counts(shapes[n:]), quant=q1 - q0,
                          crossbar=x1 - x0,
                          uploads=engine.cache_info().exec_uploads))

    def kill(self, rep, **k):
        _sync(dev)
        before = _allocated(dev)
        real_kill(self, rep, **k)
        gc.collect()
        _sync(dev)
        kills.append((before, _allocated(dev)))

    names = ("world_broadcast", "world_gather")
    c0 = {k: dict(dctx.counts.get(k, {"calls": 0, "seconds": 0.0}))
          for k in names}
    reset_counters()
    _sync(dev)
    t0 = time.perf_counter()
    with launch_shapes(shapes), \
            mock.patch.object(Scheduler, "_plain_step", step), \
            mock.patch.object(Router, "_kill", kill):
        router = Router(params, cfg, ServingConfig(**kw), RouterConfig(
            n_replicas=2, policy=policy, model_parallel=model_parallel),
            devices=devices, failure_plan=plan, device=dev)
        before = [list(r.ranks) for r in router.replicas]
        for r in reqs:
            router.submit_request(r)
        results = router.run()
        summary = router.metrics().summary()
    _sync(dev)
    wall = time.perf_counter() - t0
    exchanges = {k: dict(
        calls=dctx.counts.get(k, {}).get("calls", 0) - c0[k]["calls"],
        seconds=dctx.counts.get(k, {}).get("seconds", 0.0) - c0[k]["seconds"])
        for k in names}
    return dict(
        tokens=[results[r.rid].tolist() for r in reqs], wall_s=wall,
        summary={k: summary[k] for k in (
            "n_finished", "tokens_per_s", "mean_ttft_s", "mean_tpot_s",
            "rebalanced_requests", "replica_restarts", "per_replica_tok_s")},
        steps=steps, kills=kills, before=before,
        after=[(list(r.ranks), r.alive) for r in router.replicas],
        rounds=router.step_count, exchanges=exchanges,
        launches=list(counters()))


def fleet_rank(mesh, base, q_tokens, pim_tokens, dev_type="cuda"):
    """One rank of ``serve_fleet_ranks``, in its own process: ``base``
    (full-width qwen1.5-0.5b) drawn on the card from seed 0, then a
    ``quant_tp`` fleet
    of two replicas of model 2 over the four ranks (replica 0 killed at
    round ``FLEET_RANKS_KILL_STEP``, losing its first rank), then a
    ``pim_sim`` fleet of two one-rank replicas over ranks 0 and 1 (one
    kill, no rank lost)."""
    from repro_torch.models import model_lib as M
    from repro_torch.serving import FailurePlan, synthetic_requests

    dev = (torch.device("cuda", torch.cuda.current_device())
           if dev_type == "cuda" else torch.device("cpu"))
    t0 = time.perf_counter()
    params = M.init_params(base, seed=0, device=dev)
    qcfg = base.scaled(pim_mode="quant_tp",
                       max_seq_len=trace_len(QUANT_TRACE))
    reqs = synthetic_requests(
        QUANT_TRACE["n_requests"], vocab_size=qcfg.vocab_size,
        prompt_lens=QUANT_TRACE["prompt_lens"],
        max_new_tokens=QUANT_TRACE["max_new"], seed=QUANT_TRACE["seed"])
    quant = fleet_rank_serve(
        dev, params, qcfg, [(r.prompt, r.max_new_tokens) for r in reqs],
        list(range(mesh.size)),
        FailurePlan(kill_replica=0, at_step=FLEET_RANKS_KILL_STEP,
                    lose_devices=1), FLEET_RANKS_MODEL, "least_loaded",
        max_batch=QUANT_TRACE["max_batch"], paged=True,
        prompt_bucket=max(8, max(QUANT_TRACE["prompt_lens"]) // 4))
    xcfg = base.scaled(pim_mode="pim_sim", max_seq_len=16 + 4)
    preqs = synthetic_requests(2, vocab_size=xcfg.vocab_size,
                               prompt_lens=(16,), max_new_tokens=4, seed=6)
    pim = fleet_rank_serve(
        dev, params, xcfg, [(r.prompt, r.max_new_tokens) for r in preqs],
        [0, 1], FailurePlan(kill_replica=0, at_step=FLEET_PIM_KILL_STEP),
        1, "least_loaded", max_batch=2, paged=True, prompt_bucket=8)
    return dict(rank=mesh.rank, quant=quant, pim=pim,
                seconds=time.perf_counter() - t0)


def fleet_rank_failures(ranks, want_tp, want_q, per_step, pool, q_tokens,
                        pim_tokens):
    """Every check of ``serve_fleet_ranks``' results that failed."""
    fails = []
    for res in ranks:
        r, q, x = res["rank"], res["quant"], res["pim"]
        if q["tokens"] != q_tokens:
            fails.append(f"rank {r}: quant_tp fleet tokens differ from "
                         "serve_quant's")
        if q["before"][0] != [0, 1] or q["after"][0] != ([1], True):
            fails.append(f"rank {r}: replica 0 over {q['before'][0]} -> "
                         f"{q['after'][0]}, expected [0, 1] -> [1], alive")
        if q["summary"]["replica_restarts"] != 1:
            fails.append(f"rank {r}: {q['summary']['replica_restarts']} "
                         "restarts, expected 1")
        for st in q["steps"]:
            want = want_tp if st["model"] == FLEET_RANKS_MODEL else want_q
            if st["tiles"] != want:
                fails.append(f"rank {r}: a model-{st['model']} decode step "
                             f"launched tiles {st['tiles']}, expected {want}")
        models = [st["model"] for st in q["steps"]]
        if r == 1 and not (FLEET_RANKS_MODEL in models and 1 in models):
            fails.append(f"rank 1 stepped at model {sorted(set(models))}, "
                         f"expected {FLEET_RANKS_MODEL} then 1")
        if r == 0:
            (before, after), = q["kills"]
            if after - before > -(pool // 2):
                fails.append(f"rank 0 (lost) freed {before - after} B at "
                             f"the kill, less than half a pool ({pool} B)")
        if x["tokens"] != pim_tokens:
            fails.append(f"rank {r}: pim_sim fleet tokens {x['tokens']} "
                         f"differ from serve_pim's {pim_tokens}")
        if any(st["crossbar"] != per_step for st in x["steps"]):
            fails.append(f"rank {r}: pim_sim decode steps launched "
                         f"{[st['crossbar'] for st in x['steps']]}, "
                         f"expected {per_step} each")
        ups = [st["uploads"] for st in x["steps"]]
        if any(u != ups[0] for u in ups):
            fails.append(f"rank {r}: pim_sim decode steps uploaded after "
                         f"the first: {ups}")
        if (x["summary"]["replica_restarts"] != 1
                or not x["summary"]["rebalanced_requests"] > 0):
            fails.append(f"rank {r}: pim_sim kill restarted "
                         f"{x['summary']['replica_restarts']}, rebalanced "
                         f"{x['summary']['rebalanced_requests']}")
    if not any(res["pim"]["steps"] for res in ranks[:2]):
        fails.append("the pim_sim fleet's ranks ran no decode step")
    return fails


def serve_fleet_ranks(dev, q_tokens, pim_tokens):
    """The router over ranks: ``FLEET_RANKS_WORLD`` gloo processes share
    the card (``launch.mesh.spawn``) and run ``fleet_rank``.  Every rank's
    tokens must equal ``serve_quant``'s (``quant_tp`` tiles are exact, and
    replica 0 runs ``quant`` at model 1 after losing rank 0) and
    ``serve_pim``'s; replica 0 must go from ranks [0, 1] to [1] and
    restart once; every decode step must launch the GEMM per tile as
    ``tile_counts`` says for its replica's model axis (168 at model 1) and
    the crossbar kernel once per linear, with no upload after the first
    step; the lost rank's allocation must fall by at least half a pool.
    Returns each kernel's launches per rank and a summary."""
    from repro_torch import configs
    from repro_torch.kernels.quant_matmul.tp import tp_tile_shape
    from repro_torch.launch.mesh import spawn

    t0 = time.perf_counter()
    base = configs.get("qwen1.5-0.5b")
    qcfg = base.scaled(pim_mode="quant_tp",
                       max_seq_len=trace_len(QUANT_TRACE))
    lin = step_linears(qcfg)
    want_tp = tile_counts([tp_tile_shape(kn, FLEET_RANKS_MODEL)
                           for kn in lin])
    want_q = tile_counts(lin)
    pool = fleet_pool_bytes(qcfg, QUANT_TRACE["max_batch"])
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    ranks = spawn(fleet_rank, FLEET_RANKS_WORLD, base, q_tokens, pim_tokens,
                  dev.type, device=dev.type,
                  timeout_s=FLEET_RANKS_TIMEOUT_S)
    wall = time.perf_counter() - t0
    for res in ranks:
        for tag in ("quant", "pim"):
            f = res[tag]
            s = f["summary"]
            ex = f["exchanges"]
            calls = sum(e["calls"] for e in ex.values())
            secs = sum(e["seconds"] for e in ex.values())
            say(f"[fleet-ranks] rank {res['rank']} {tag}: "
                f"{s['n_finished']} requests in {f['wall_s']:.2f} s wall, "
                f"{f['rounds']} rounds | fleet clock: "
                f"{s['tokens_per_s']:.2f} tok/s, mean TTFT "
                f"{s['mean_ttft_s'] * 1e3:.1f} ms, mean TPOT "
                f"{s['mean_tpot_s'] * 1e3:.2f} ms | world exchanges "
                f"{calls} ({calls / max(f['rounds'], 1):.2f} a round), "
                f"{secs * 1e3:.1f} ms on the host "
                f"({secs * 1e3 / max(f['rounds'], 1):.2f} ms a round) | "
                f"replicas {f['before']} -> {f['after']} | decode steps "
                f"at model {sorted({st['model'] for st in f['steps']})}, "
                f"launches (quant_matmul_int, crossbar_exec) "
                f"{f['launches']}")
        (before, after), = res["quant"]["kills"]
        say(f"[fleet-ranks] rank {res['rank']}: allocated {before} B before "
            f"the kill, {after} B after ({after - before:+d} B; a pool is "
            f"{pool} B, host arithmetic); rank seconds "
            f"{res['seconds']:.1f}")
    fails = fleet_rank_failures(ranks, want_tp, want_q, len(lin), pool,
                                q_tokens, pim_tokens)
    if fails:
        raise AssertionError("serve_fleet_ranks: " + "; ".join(fails))
    say(f"[fleet-ranks] {FLEET_RANKS_WORLD} ranks, 2 replicas x model "
        f"{FLEET_RANKS_MODEL}: tokens == serve_quant's and serve_pim's on "
        f"every rank; replica 0 [0, 1] -> [1]; phase {wall:.1f} s")
    q_launches = [res["quant"]["launches"][0] for res in ranks]
    x_launches = [res["pim"]["launches"][1] for res in ranks]
    summary = dict(wall_s=wall, **{f"rank{res['rank']}": {
        tag: {k: v for k, v in res[tag].items()
              if k not in ("tokens", "steps")}
        for tag in ("quant", "pim")} for res in ranks},
        tiles_model2=want_tp)
    return q_launches, x_launches, summary


# --------------------------------------------------------------------------
# the dry run and the roofline, on the host
# --------------------------------------------------------------------------

def _fake_like(shapes):
    from repro_torch.tree import leaves, rebuild

    return rebuild(shapes, (torch.zeros(shp, dtype=dt)
                            for _, (shp, dt) in leaves(shapes)))


def dryrun_roofline(qcfg, prof):
    """The dry-run and roofline tools at full width, on the host:
    qwen1.5-0.5b x decode_32k and x train_4k on rank 0 of the 16x16
    virtual mesh (argument and temp bytes, FLOPs, wire bytes, roofline
    terms at the H100's published peaks); then, on a world-1 virtual mesh,
    the decode step ``profile_decode(params, qcfg, dev, 4)`` measured (its
    ``decode_step_slots`` call at the shapes it ran): the FLOPs counted on
    fake tensors must equal ``FlopCounterMode`` on the real step on the
    card, and its roofline time is printed against the measured busy and
    wall time.  Returns a summary."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.dist.context import VirtualMesh
    from repro_torch.launch import dryrun, roofline
    from repro_torch.models import model_lib as M
    from repro_torch.tree import leaves

    t0 = time.perf_counter()
    out = {}
    for shape in ("decode_32k", "train_4k"):
        r = dryrun.run_cell("qwen1.5-0.5b", shape, multi_pod=False)
        if r["status"] != "ok":
            raise AssertionError(f"dry run of qwen x {shape}: {r}")
        t = roofline.terms(r)
        say(f"[dryrun] qwen1.5-0.5b x {shape} on rank 0 of 16x16 "
            f"(virtual, fake tensors; {r['seconds']} s): argument "
            f"{r['mem']['argument_bytes']} B, temp {r['mem']['temp_bytes']} "
            f"B ({r['mem']['temp_pass']} pass), {r['flops_per_dev']:.4g} "
            f"FLOPs ({r['int_flops_per_dev']:.4g} int8), wire "
            f"{r['wire_bytes_per_dev']:.4g} B ({r['cross_pod_bytes_per_dev']:.4g}"
            f" B across nodes) | roofline at H100 SXM published peaks "
            f"(host arithmetic): compute {t['compute'] * 1e3:.3f} ms, memory "
            f"{t['memory'] * 1e3:.3f} ms (lb {t['memory_lb'] * 1e3:.3f}), "
            f"collective {t['collective'] * 1e3:.3f} ms")
        out[shape] = dict({k: v for k, v in r.items()
                           if k not in ("collectives",)}, terms=t)
    args = prof["decode_args"]
    mesh = VirtualMesh((1,), ("data",))
    with FakeTensorMode(allow_non_fake_inputs=True):
        fake = _fake_like(args)
        tables = fake.pop("block_tables")

        def step(params, tokens, pos, active, caches):
            return M.decode_step_slots(params, tokens, pos, active, caches,
                                       qcfg, block_tables=tables)

        m = dryrun.measure_step(step, (fake["params"], fake["tokens"],
                                       fake["pos"], fake["active"],
                                       fake["caches"]), mesh)
    arg_bytes = sum(math.prod(shp) * torch.empty((), dtype=dt).element_size()
                    for _, (shp, dt) in leaves(args))
    cell = dict(flops_per_dev=m["flops_per_dev"],
                int_flops_per_dev=m["int_flops_per_dev"],
                bytes_per_dev=m["bytes_per_dev"], wire_bytes_per_dev=0.0,
                mem=dict(argument_bytes=arg_bytes))
    t = roofline.terms(cell)
    bound = max(t["compute"], t["memory_lb"])
    say(f"[dryrun] the measured qwen quant decode step (batch 4, "
        f"max_seq_len {qcfg.max_seq_len}): FLOPs counted on fake tensors "
        f"{int(m['flops_per_dev'])} ({int(m['int_flops_per_dev'])} int8), "
        f"FlopCounterMode on the card {prof['flops']}: equal "
        f"{int(m['flops_per_dev']) == prof['flops']}")
    say(f"[dryrun] its roofline at H100 SXM published peaks (host "
        f"arithmetic): compute {t['compute'] * 1e6:.2f} us, memory lb "
        f"{t['memory_lb'] * 1e6:.2f} us ({arg_bytes} B read once), bound "
        f"{bound * 1e6:.2f} us; the bound is "
        f"{bound * 1e3 / prof['busy_ms'] * 100:.2f} % of the measured busy "
        f"{prof['busy_ms']:.3f} ms and "
        f"{bound * 1e3 / prof['wall_ms'] * 100:.3f} % of the wall "
        f"{prof['wall_ms']:.3f} ms")
    if int(m["flops_per_dev"]) != prof["flops"]:
        raise AssertionError(f"dry-run FLOPs {m['flops_per_dev']} != the "
                             f"card's FlopCounterMode {prof['flops']}")
    wall = time.perf_counter() - t0
    say(f"[dryrun] phase {wall:.1f} s")
    out["step"] = dict(flops=prof["flops"], int_flops=m["int_flops_per_dev"],
                       argument_bytes=arg_bytes, terms=t, bound_s=bound,
                       busy_ms=prof["busy_ms"], wall_ms=prof["wall_ms"],
                       share_of_busy=bound * 1e3 / prof["busy_ms"])
    out["wall_s"] = wall
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this test "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    from repro_torch import configs
    from repro_torch.kernels import build
    from repro_torch.kernels import pim_bits
    from repro_torch.kernels.crossbar_exec import crossbar_exec
    from repro_torch.kernels.quant_matmul import quant_matmul_int
    from repro_torch.models import model_lib as M

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    card = gpu_line()
    say(card)
    say(f"[device] {torch.cuda.get_device_name(0)} x"
        f"{torch.cuda.device_count()} | torch {torch.__version__} | CUDA "
        f"{torch.version.cuda} | python {platform.python_version()}")

    # phase 1: build the kernels, one nvcc each, started together
    t0 = time.perf_counter()
    infos = build.build()
    say(f"[build] {', '.join(infos)} in {time.perf_counter() - t0:.2f} s "
        f"into {build.BUILD_DIR}")
    for name, info in infos.items():
        for ln in info.ptxas_lines:
            say(f"[ptxas {name}] {ln}")

    phase_s = {}

    def phase(name, fn, *a, **kw):
        """``fn(*a, **kw)``, its seconds printed on a line of their own."""
        t = time.perf_counter()
        res = fn(*a, **kw)
        phase_s[name] = time.perf_counter() - t
        say(f"[phase] {name}: {phase_s[name]:.1f} s")
        return res

    quant_rows = phase("check_quant_kernel", check_quant_kernel, dev)
    xbar_row = phase("check_crossbar_kernel", check_crossbar_kernel, dev)
    bits_row = phase("check_pim_bits", check_pim_bits, dev)
    mult_launches, mult_table = phase("check_multipliers", check_multipliers,
                                      dev)

    base = configs.get("qwen1.5-0.5b")
    t0 = time.perf_counter()
    params = M.init_params(base, seed=0, device=dev)
    torch.cuda.synchronize()
    say(f"[params] full-width {base.name}: {M.param_count(base) / 1e6:.1f}M "
        f"parameters ({base.n_layers} layers, d_model {base.d_model}, "
        f"d_ff {base.d_ff}, vocab {base.vocab_size} padded to "
        f"{base.padded_vocab}, {base.dtype}) drawn on the card from seed 0 "
        f"in {time.perf_counter() - t0:.3f} s")

    q_launches, qcfg, q_tokens = phase("serve_quant", serve_quant, params,
                                       base, dev)
    x_launches, pcfg, pim_tokens = phase("serve_pim", serve_pim, params,
                                         base, dev)
    qp_launches, qp_trace, qp_tokens = phase(
        "serve_quant_prefix", serve_quant_prefix, params, base, dev)
    xp_launches = phase("serve_pim_prefix", serve_pim_prefix, params, base,
                        dev)
    qs_launches = phase("serve_quant_spec", serve_quant_spec, params, qcfg,
                        dev, q_tokens)
    ps_launches = phase("serve_pim_spec", serve_pim_spec, params, base, dev)
    q_prof = phase("profile_decode quant", profile_decode, params, qcfg, dev,
                   4, flops=True)
    phase("profile_decode pim_sim", profile_decode, params, pcfg, dev, 2)
    phase("profile_decode pim_sim speculative", profile_decode, params,
          pcfg.scaled(max_seq_len=24), dev, 2, max_new=8, speculative=True,
          draft_mode="quant", draft_k=3)
    at_launches, at_warm_s, race_rows, geo_rows = phase(
        "serve_pim_autotune", serve_pim_autotune, params, base, dev,
        pim_tokens)
    fl_q, fl_x, fleet = phase("serve_fleet_phase", serve_fleet_phase, params,
                              base, dev, q_tokens, qp_trace, qp_tokens,
                              pim_tokens)
    # the serve phases' model is dropped: the engine may keep nothing of it
    before = footprint(params)
    del params
    check_released(base.name, before)
    wide = {name: phase(f"serve_wide {name}", serve_wide, name, dev)
            for name in WIDE_LAYERS}
    win_q, win_x, win = phase("serve_window", serve_window, dev)
    moe_q, moe_x, moe_run, moe_tokens = phase("serve_moe", serve_moe, dev)
    rec_q, rec_x, rec_run = phase("serve_recurrent", serve_recurrent, dev)
    mm_q, mm_x, xwk_row, mm_run = phase("serve_multimodal",
                                        serve_multimodal, dev)
    mp_launches, mp_rows, mp_run = phase("serve_tp", serve_tp, dev, q_tokens,
                                         moe_tokens)
    fr_q, fr_x, fleet_ranks = phase("serve_fleet_ranks", serve_fleet_ranks,
                                    dev, q_tokens, pim_tokens)
    dry = phase("dryrun_roofline", dryrun_roofline, qcfg, q_prof)
    # training: fresh weights from the same seed; the serve phases' params
    # stay as they are
    tq_launches, tq = phase("train_quant", train_quant, base, dev,
                            quant_rows)
    tp_launches, tp = phase("train_pim", train_pim, base, dev)
    drill = phase("train_restart", train_restart)
    z_launches, zero3 = phase("train_zero3", train_zero3, dev)
    m_train = TRAIN_QUANT[0] * TRAIN_QUANT[1]
    m_zero3 = ZERO3_TRAIN[0] // ZERO3_WORLD * ZERO3_TRAIN[1]

    qrow = quant_rows[(4, 1024, 2816)]
    kernels = [
        dict(name="quant_matmul_int", route="cuda",
             source="src/repro_torch/kernels/csrc/quant_matmul.cu",
             replaces="src/repro/kernels/quant_matmul/quant_matmul.py:53",
             launches=q_launches, launches_prefix_path=qp_launches,
             launches_spec_path=qs_launches + ps_launches[0],
             launches_train_path=tq_launches,
             launches_wide_path={k: v[0] for k, v in wide.items()},
             launches_window_path=win_q, launches_moe_path=moe_q,
             launches_recurrent_path=rec_q, launches_multimodal_path=mm_q,
             launches_tp_path=mp_launches, launches_fleet_path=fl_q,
             launches_fleet_ranks_path=fr_q,
             launches_zero3_path=z_launches,
             max_abs_err=qrow["max_abs_err"],
             exact=qrow["max_abs_err"] == 0,
             shape=[4, 1024, 2816], ms=qrow["ms"], plain_ms=qrow["plain_ms"],
             bound_ms=qrow["bound_ms"], bound_by=qrow["bound_by"],
             library_ms=qrow["library_ms"], library=qrow["library"],
             launch_floor_ms=qrow["launch_floor_ms"],
             device_ops_per_call=qrow["device_ops_per_call"],
             device_ops_per_call_traced=qrow["device_ops_per_call_traced"],
             host_us_operator=qrow["host_us_operator"],
             host_us_direct=qrow["host_us_direct"],
             train_shapes=[dict(shape=[m_train, k, n], **{
                 key: quant_rows[(m_train, k, n)][key]
                 for key in ("ms", "plain_ms", "library_ms", "bound_ms",
                             "bound_by")}) for k, n in QUANT_SHAPES_KN],
             zero3_shapes=[dict(shape=[m_zero3, k, n], **{
                 key: quant_rows[(m_zero3, k, n)][key]
                 for key in ("ms", "plain_ms", "library_ms", "bound_ms",
                             "bound_by")}) for k, n in QUANT_SHAPES_KN],
             wide_shapes=[dict(shape=list(shape), **{
                 key: quant_rows[shape][key]
                 for key in ("ms", "plain_ms", "library_ms", "library",
                             "bound_ms", "bound_by")})
                 for shape in WIDE_QUANT_SHAPES + MOE_QUANT_SHAPES
                 + RECURRENT_QUANT_SHAPES + MULTIMODAL_QUANT_SHAPES],
             tp_shapes=mp_rows,
             wide={k: v[2] for k, v in wide.items()}, window=win,
             moe=moe_run, recurrent=rec_run, multimodal=mm_run, tp=mp_run,
             train=tq, restart_drill=drill, fleet=fleet,
             fleet_ranks=fleet_ranks, dryrun=dry, zero3=zero3),
        dict(name="crossbar_exec", route="cuda",
             source="src/repro_torch/kernels/csrc/crossbar_exec.cu",
             replaces="src/repro/kernels/crossbar_exec/crossbar_exec.py:66",
             launches=x_launches, launches_prefix_path=xp_launches,
             launches_spec_path=ps_launches[1],
             launches_mult_path=mult_launches,
             launches_autotune_path=at_launches,
             launches_train_path=tp_launches,
             launches_wide_path={k: v[1] for k, v in wide.items()},
             launches_window_path=win_x, launches_moe_path=moe_x,
             launches_recurrent_path=rec_x, launches_multimodal_path=mm_x,
             launches_fleet_path=fl_x, launches_fleet_ranks_path=fr_x,
             max_abs_err=xbar_row["max_abs_err"],
             exact=xbar_row["max_abs_err"] == 0,
             shape=xbar_row["shape"], ms=xbar_row["ms"],
             ms_616=xbar_row["ms_616"],
             plain_ms=xbar_row["plain_ms"], bound_ms=xbar_row["bound_ms"],
             bound_by=xbar_row["bound_by"], library_ms=None,
             launch_floor_ms=xbar_row["launch_floor_ms"],
             one_gate_ms=xbar_row["one_gate_ms"],
             wide_shapes=xbar_row["wide_shapes"], vision_xwk_piece=xwk_row,
             multipliers=mult_table, autotune_warmup_s=at_warm_s,
             autotune_race=race_rows, geometries=geo_rows, train=tp),
        dict(name="pim_bits", route="cuda",
             source="src/repro_torch/kernels/csrc/pim_bits.cu",
             replaces=None,
             launches_recurrent_path=rec_run["jamba"]["pim_bits"],
             exact=True, library_ms=None, **bits_row),
    ]
    say(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s;"
        f" launch counters now {quant_matmul_int.launches}, "
        f"{crossbar_exec.launches}, {pim_bits.launches}")
    say(json.dumps({"kernels": kernels}))
    # after the long kernels line, so that a log's last lines keep them
    say(f"[phases] {json.dumps({k: round(v, 1) for k, v in phase_s.items()})}"
        f" main {time.perf_counter() - t_start:.1f} s")
    say(card)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
