"""Dry run: one rank's step of every (arch x shape x mesh) cell, on fake
tensors.

The reference lowers and compiles each cell for 256 or 512 forced host
devices and reads XLA's cost and memory analyses.  The port runs the
cell's own step instead — the same ``launch.train.train_step``,
``model.prefill`` and ``model.decode_step`` code that serves and trains
— for one rank (rank 0) of the production mesh, at full width, with two
things fake:

* the mesh is a ``dist.context.VirtualMesh`` (``launch.mesh.
  make_production_mesh``): no process group; its collectives move
  nothing, return what the rank would receive and are recorded;
* every tensor is a ``FakeTensor`` (``torch._subclasses.fake_tensor``):
  shapes and dtypes, no bytes.

What the rank runs is the port's own parallel path.  A **train** cell is
the ZeRO-3 trainer's step: the rank holds its shards of the parameters
and AdamW state under ``param_pspecs`` / ``opt_state_pspecs`` (ZeRO-3
over ``"data"`` above 3 G parameters, as the reference decides), takes
its rows of the global batch, gathers each leaf where it is read, and the
linears run in the config's own mode (plain products; the ``"model"``
ranks of a data slice compute the same rows).  A **prefill** or
**decode** cell is the served step in ``quant_tp``: every linear is an
int8 tile over ``"model"`` with its rows split over the data axes, and
everything else (attention over the whole cache, norms, the unembed) runs
on the whole batch, as a served rank holds the whole model, batch and
cache.  ``--policy dp_only`` claims every axis as data-parallel, so the
linears run whole (``quant``).

Per cell it records (the reference's fields, counted the port's way):

* ``mem.argument_bytes``: the rank's shards of parameters, optimizer
  state, batch and caches under the reference's spec trees
  (``tree_shardings``; caches by ``cache_pspecs``) — the layout's bytes;
* ``mem.temp_bytes``: the peak of the storages the step allocates beyond
  its arguments, from :class:`StepTracker`, which follows every output
  storage of every operator until it is freed.  Remat is counted as it
  runs: a checkpointed block's activations are freed after its forward
  and allocated again in its recompute, so the peak is the real
  allocator's with remat on, not the sum of every activation.  Like the
  reference, a cell runs two ways: the **cost pass** (the default) runs
  attention with materialized scores (``flash_attention=False``, the
  reference's cost lowering: the same FLOPs and collectives as the
  blockwise loop, and far fewer operators to dispatch), so its peak
  holds each layer's whole score matrix; ``--mem-only`` runs the
  **deployable pass** (the config as it serves and trains, blockwise
  attention) for the memory numbers alone.  ``mem.temp_pass`` says which
  one a result's peak is (a decode step runs the same attention either
  way, so its cost pass is the deployable one);
* ``flops_per_dev`` from ``torch.utils.flop_counter.FlopCounterMode``
  (matmuls, batched matmuls and the int8 GEMM operator, whose formula
  is ``2 M K N``), ``int_flops_per_dev`` its int8 share;
* ``bytes_per_dev``: every non-view operator's input and output bytes,
  unfused (an upper bound, as the reference's HLO bytes-accessed is);
* the collective mix of the recorded calls, its per-rank wire bytes and
  scale-out bytes (:func:`collective_mix`, the reference's ring
  formulas) and ``wire_time_s`` (:func:`collective_time_s`).

Times come from the H100's published figures, never a TPU's.  The link
model is an 8-GPU HGX H100 node (``POD_SIZE``), NVLink 4 inside it and
one 400 Gb/s NDR port per GPU across nodes; the mesh shapes stay the
reference's.  ``--all`` runs each cell in a subprocess and writes JSON
under ``results/dryrun/``; ``launch.roofline`` reads them.

    PYTHONPATH=src python -m repro_torch.launch.dryrun \\
        --arch qwen1.5-0.5b --shape decode_32k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --jobs 4
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import subprocess
import sys
import time
import weakref
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import configs
from repro_torch.dist import context as dctx
from repro_torch.dist import partitioning as part
from repro_torch.kernels.quant_matmul import quant_matmul as _qmm
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import model_lib as M
from repro_torch.models.config import SHAPES, ModelConfig, ShapeSpec
from repro_torch.models.layers import as_shapes
from repro_torch.optim.adamw import AdamWConfig, init_state
from repro_torch.tree import leaves, rebuild

__all__ = ["input_specs", "lower_cell", "run_cell", "collective_mix",
           "collective_time_s", "StepTracker", "POD_SIZE", "NVLINK_GBPS",
           "SCALE_OUT_GBPS"]

RESULTS_DIR = os.path.join(os.path.dirname(__file__),
                           "../../../results/dryrun")

# H100 SXM, 700 W.  NVLink 4: 18 links of 50 GB/s (both directions
# together) per GPU, 900 GB/s (NVIDIA H100 Tensor Core GPU datasheet).
NVLINK_GBPS = 900.0
# H100 SXM, 700 W, in a DGX/HGX H100: one ConnectX-7 400 Gb/s NDR
# InfiniBand port per GPU for scale-out, 50 GB/s (NVIDIA DGX H100 user
# guide, networking).
SCALE_OUT_GBPS = 50.0
# GPUs in one NVLink domain: an HGX H100 8-GPU board.
POD_SIZE = 8


# --------------------------------------------------------------------------
# collectives: the reference's ring formulas over recorded calls
# --------------------------------------------------------------------------

def _boundary_hops(ranks: Sequence[int], pod_size: int) -> int:
    """Hops of a ring over ``ranks`` (in order, then back to the first)
    that cross from one ``pod_size``-rank domain into another."""
    g = len(ranks)
    return sum(ranks[i] // pod_size != ranks[(i + 1) % g] // pod_size
               for i in range(g))


def collective_mix(calls, pod_size: Optional[int] = None
                   ) -> Dict[str, Dict[str, float]]:
    """Per collective kind: count and modelled per-rank wire bytes, from
    ``(op, result_bytes, group_ranks)`` calls (``dist.context.
    record_collectives``).  The reference's ring formulas: an all-gather
    or all-to-all moves ``bytes (g - 1) / g``, an all-reduce twice that, a
    reduce-scatter ``bytes (g - 1)`` (its result is the scattered shard),
    a permute its payload once.  With ``pod_size``, the ring's hops that
    cross a domain boundary carry their share of the wire bytes:
    ``cross_pod_bytes = wire * hops / g``.  For the contiguous groups the
    reference's HLO names (``replica_groups=[n,g]<=[N]``) that share is
    the reference's ``ceil(g / pod_size) / g`` when ``g > pod_size`` and 0
    otherwise; for a strided group (a mesh's data axis) the count is
    exact where the reference's formula would say 0."""
    out: Dict[str, Dict[str, float]] = {}
    for op, nbytes, ranks in calls:
        g = len(ranks)
        if g <= 1:
            wire = 0.0
        elif op == "all-reduce":
            wire = 2.0 * nbytes * (g - 1) / g
        elif op in ("all-gather", "all-to-all"):
            wire = nbytes * (g - 1) / g
        elif op == "reduce-scatter":
            wire = float(nbytes * (g - 1))
        else:  # collective-permute
            wire = float(nbytes)
        cross = 0.0
        if pod_size and g > 1:
            cross = wire * _boundary_hops(list(ranks), pod_size) / g
        d = out.setdefault(op, {"count": 0, "wire_bytes": 0.0,
                                "cross_pod_bytes": 0.0})
        d["count"] += 1
        d["wire_bytes"] += wire
        d["cross_pod_bytes"] += cross
    return out


def collective_time_s(colls: Dict[str, Dict[str, float]], *,
                      intra_gbps: float = NVLINK_GBPS,
                      inter_gbps: float = SCALE_OUT_GBPS) -> float:
    """Modelled per-rank wire time: the bytes inside a domain at
    ``intra_gbps``, the boundary share on the scale-out link at
    ``inter_gbps`` (the reference's formula)."""
    t = 0.0
    for c in colls.values():
        cross = c.get("cross_pod_bytes", 0.0)
        t += ((c["wire_bytes"] - cross) / (intra_gbps * 1e9)
              + cross / (inter_gbps * 1e9))
    return t


# --------------------------------------------------------------------------
# the step tracker: live bytes and bytes accessed
# --------------------------------------------------------------------------

def _tensors(tree) -> List[torch.Tensor]:
    out = []
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, (list, tuple)):
        for t in tree:
            out.extend(_tensors(t))
    elif isinstance(tree, dict):
        for t in tree.values():
            out.extend(_tensors(t))
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class StepTracker(TorchDispatchMode):
    """Follows a step's operators (on fake or real tensors).

    ``temp_bytes``: the peak over the step of the bytes of storages that
    operators allocated and that are still referenced (a storage is freed
    when its last tensor is: every tensor made by an operator holds a
    reference, released by a ``weakref.finalize``); storages that existed
    before the step (its arguments) are not counted, nor are the outputs
    that alias them.  ``bytes_accessed``: every non-view operator's
    tensor inputs and fresh outputs."""

    def __init__(self, known: Sequence[torch.Tensor] = ()):
        super().__init__()
        self._known = {StorageWeakRef(t.untyped_storage()) for t in known}
        self._live: Dict[StorageWeakRef, List[int]] = {}
        self.live_bytes = 0
        self.temp_bytes = 0
        self.bytes_accessed = 0

    def _release(self, key) -> None:
        ent = self._live.get(key)
        if ent is None:
            return
        ent[1] -= 1
        if ent[1] == 0:
            self.live_bytes -= ent[0]
            del self._live[key]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins = _tensors(args) + _tensors(kwargs)
        in_keys = {StorageWeakRef(t.untyped_storage()) for t in ins}
        fresh = 0
        for t in _tensors(out):
            key = StorageWeakRef(t.untyped_storage())
            if key in self._known or key in in_keys:
                continue
            ent = self._live.get(key)
            if ent is None:
                n = t.untyped_storage().nbytes()
                ent = self._live[key] = [n, 0]
                self.live_bytes += n
                fresh += _nbytes(t)
            ent[1] += 1
            weakref.finalize(t, self._release, key)
        self.temp_bytes = max(self.temp_bytes, self.live_bytes)
        if (fresh or func.overloadpacket.__name__.endswith("_")
                or "out" in kwargs):
            self.bytes_accessed += sum(_nbytes(t) for t in ins) + fresh
        return out


# --------------------------------------------------------------------------
# per-cell inputs and step
# --------------------------------------------------------------------------

def _opt_cfg(cfg: ModelConfig) -> AdamWConfig:
    big = M.param_count(cfg) > 10e9
    return AdamWConfig(factored=big,
                       moment_dtype="bfloat16" if big else "float32")


def input_specs(cfg: ModelConfig, shape: ShapeSpec
                ) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """``(shape, dtype)`` of every model input of this cell's batch."""
    b, s = shape.global_batch, shape.seq_len
    sp: Dict[str, Tuple[Tuple[int, ...], torch.dtype]] = {}
    if shape.kind in ("train", "prefill"):
        sp["tokens"] = ((b, s), torch.int32)
        if shape.kind == "train":
            sp["labels"] = ((b, s), torch.int32)
        if cfg.is_encoder_decoder:
            sp["frames"] = ((b, s // cfg.audio_frames_div, cfg.d_model),
                            cfg.compute_dtype)
        if cfg.vision_dim:
            sp["patches"] = ((b, cfg.n_patches, cfg.vision_dim),
                             cfg.compute_dtype)
    else:
        sp["token"] = ((b, 1), torch.int32)
    return sp


def _itemsize(dt: torch.dtype) -> int:
    return torch.empty((), dtype=dt).element_size()


def _shard_bytes(shapes, specs, mesh) -> int:
    """The rank's bytes of a ``(shape, dtype)`` tree under ``specs``."""
    total = 0
    for (_, (shp, dt)), (_, sh) in zip(
            leaves(shapes), leaves(part.tree_shardings(specs, mesh))):
        total += math.prod(sh.shard_shape(shp)) * _itemsize(dt)
    return total


def _fake(shapes, specs=None, mesh=None):
    """Zero tensors of a ``(shape, dtype)`` tree (under a FakeTensorMode:
    fake), whole or as the rank's shards under ``specs``."""
    if specs is None:
        return rebuild(shapes, (torch.zeros(shp, dtype=dt)
                                for _, (shp, dt) in leaves(shapes)))
    shard = leaves(part.tree_shardings(specs, mesh))
    return rebuild(shapes, (torch.zeros(sh.shard_shape(shp), dtype=dt)
                            for (_, (shp, dt)), (_, sh)
                            in zip(leaves(shapes), shard)))


def _shape_tree(tensors):
    return rebuild(tensors, ((tuple(t.shape), t.dtype)
                             for _, t in leaves(tensors)))


def lower_cell(cfg: ModelConfig, shape: ShapeSpec, mesh,
               policy: str = "auto"):
    """The cell's layout and step: ``(step, args, arg_bytes, dp_axes)``.

    ``step(*args)`` runs the rank's step; ``args`` are fake tensors made
    here (call under a ``FakeTensorMode``); ``arg_bytes`` is the rank's
    argument bytes under the reference's spec trees; ``dp_axes`` is the
    ``use_mesh`` override (every axis under ``dp_only``)."""
    if policy == "dp_only" and cfg.n_experts:
        raise ValueError("dp_only policy incompatible with expert parallelism")
    dp_axes = tuple(mesh.axis_names) if policy == "dp_only" else None
    pshapes = as_shapes(M.param_specs(cfg))
    fsdp = M.param_count(cfg) > 3e9
    p_part = part.param_pspecs(pshapes, mesh, fsdp=fsdp,
                               tp=policy != "dp_only")
    batch_shapes = input_specs(cfg, shape)
    b_part = part.batch_pspecs(batch_shapes, mesh)
    arg_bytes = (_shard_bytes(pshapes, p_part, mesh)
                 + _shard_bytes(batch_shapes, b_part, mesh))

    if shape.kind == "train":
        from repro_torch.launch.train import Sharding, train_step

        ocfg = _opt_cfg(cfg)
        params = _fake(pshapes, p_part, mesh)
        opt = init_state(ocfg, params)
        # the optimizer specs are laid out on the whole tree's shapes
        whole_opt = init_state(ocfg, rebuild(pshapes, (
            torch.empty(shp, dtype=dt, device="meta")
            for _, (shp, dt) in leaves(pshapes))))
        o_part = part.opt_state_pspecs(pshapes, p_part, whole_opt, mesh)
        arg_bytes += _shard_bytes(_shape_tree(whole_opt), o_part, mesh)
        batch = _fake(batch_shapes)
        sharding = Sharding(mesh, p_part, o_part)

        def step(params, opt, batch):
            return train_step(params, opt, batch, cfg, ocfg, sharding)

        return step, (params, opt, batch), arg_bytes, dp_axes

    scfg = cfg.scaled(pim_mode="quant_tp")
    params = _fake(pshapes)
    if shape.kind == "prefill":
        batch = _fake(batch_shapes)

        def step(params, batch):
            return M.prefill(params, batch, scfg)

        return step, (params, batch), arg_bytes, dp_axes

    cshapes = M.cache_specs(cfg, shape.global_batch, shape.seq_len)
    c_part = part.cache_pspecs(cshapes, mesh)
    arg_bytes += _shard_bytes(cshapes, c_part, mesh)
    caches = _fake(cshapes)
    token = _fake(batch_shapes)["token"]
    pos = shape.seq_len - 1

    def step(params, token, caches):
        return M.decode_step(params, token, pos, caches, scfg)

    return step, (params, token, caches), arg_bytes, dp_axes


def measure_step(step, args, mesh, dp_axes=None, *, flops: bool = True
                 ) -> Dict:
    """Run ``step(*args)`` under ``mesh`` with the tracker (and
    ``FlopCounterMode``); returns its counts and collective calls."""
    known = [t for a in args for _, t in leaves(a)
             if isinstance(t, torch.Tensor)]
    tracker = StepTracker(known)
    counter = FlopCounterMode(display=False) if flops else None
    with dctx.use_mesh(mesh, dp_axes=dp_axes), \
            dctx.record_collectives() as calls, \
            (counter if counter is not None else contextlib.nullcontext()), \
            tracker:
        out = step(*args)
        del out
    res = dict(temp_bytes=int(tracker.temp_bytes),
               bytes_per_dev=float(tracker.bytes_accessed),
               calls=list(calls))
    if counter is not None:
        res.update(flops_per_dev=float(counter.get_total_flops()),
                   int_flops_per_dev=float(counter.get_flop_counts()[
                       "Global"].get(_qmm._op.overloadpacket, 0)))
    return res


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             policy: str = "auto", kv_dtype: str = "bf16",
             mem_only: bool = False, cfg: Optional[ModelConfig] = None,
             shape: Optional[ShapeSpec] = None, mesh=None) -> Dict:
    """Dry-run one cell on rank 0 of the production mesh (or on ``mesh``,
    with ``cfg`` and ``shape`` given instead of looked up)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    cfg = cfg or configs.get(arch)
    if kv_dtype != "bf16":
        cfg = cfg.scaled(kv_cache_dtype=kv_dtype)
    shape = shape or next(s for s in SHAPES if s.name == shape_name)
    mesh = mesh or make_production_mesh(multi_pod=multi_pod)
    result: Dict = {"arch": arch, "shape": shape.name,
                    "mesh": "x".join(str(mesh.shape[a])
                                     for a in mesh.axis_names)}
    ok, why = cfg.runnable(shape)
    if not ok:
        result.update(status="skipped", reason=why)
        return result
    deployable = mem_only or shape.kind == "decode"
    if not mem_only:
        # the cost pass: materialized scores, the reference's loss chunk
        tokens = shape.global_batch * shape.seq_len
        cfg = cfg.scaled(flash_attention=False,
                         loss_chunk=max(tokens // 8, min(8192, tokens)))
    t0 = time.perf_counter()
    try:
        with FakeTensorMode(allow_non_fake_inputs=True):
            step, args, arg_bytes, dp_axes = lower_cell(cfg, shape, mesh,
                                                        policy)
            m = measure_step(step, args, mesh, dp_axes, flops=not mem_only)
        pod = POD_SIZE if mesh.size > POD_SIZE else None
        colls = collective_mix(m.pop("calls"), pod_size=pod)
        result.update(
            status="ok", seconds=round(time.perf_counter() - t0, 2),
            mem=dict(argument_bytes=int(arg_bytes),
                     temp_bytes=m.pop("temp_bytes"),
                     temp_pass="deployable" if deployable else "cost"),
            n_devices=mesh.size, params=M.param_count(cfg),
            collectives=colls,
            wire_bytes_per_dev=sum(c["wire_bytes"] for c in colls.values()),
            cross_pod_bytes_per_dev=sum(c["cross_pod_bytes"]
                                        for c in colls.values()),
            wire_time_s=collective_time_s(colls), **m)
    except Exception as e:  # noqa: BLE001 — recorded, surfaced by --all
        result.update(status="error", error=f"{type(e).__name__}: {e}"[:2000])
    return result


# --------------------------------------------------------------------------
# CLI
# --------------------------------------------------------------------------

def _result_path(out_dir, arch, shape, multi_pod):
    mesh = "multi" if multi_pod else "single"
    safe = arch.replace("/", "_")
    return os.path.join(out_dir, f"{safe}__{shape}__{mesh}.json")


def _run_one(arch, shape, mp, out, timeout, force):
    path = _result_path(out, arch, shape, mp)
    if os.path.exists(path) and not force:
        return json.load(open(path))
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
           "--shape", shape, "--out", out]
    if mp:
        cmd.append("--multi-pod")
    try:
        subprocess.run(cmd, check=False, timeout=timeout,
                       stdout=subprocess.DEVNULL)
    except subprocess.TimeoutExpired:
        json.dump({"arch": arch, "shape": shape,
                   "mesh": "2x16x16" if mp else "16x16", "status": "error",
                   "error": f"dry run timeout ({timeout} s)"},
                  open(path, "w"))
    return (json.load(open(path)) if os.path.exists(path)
            else {"status": "error", "error": "no output"})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=RESULTS_DIR)
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--policy", default="auto", choices=["auto", "dp_only"])
    ap.add_argument("--kv-dtype", default="bf16", choices=["bf16", "int8"])
    ap.add_argument("--tag", default="")
    ap.add_argument("--mem-only", action="store_true",
                    help="refresh only the memory numbers, merging into an "
                         "existing result JSON")
    ap.add_argument("--timeout", type=int, default=1800,
                    help="seconds per cell under --all")
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells run at once under --all")
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)

    if args.all:
        cells = [(a, s.name, mp) for a in configs.ARCH_NAMES for s in SHAPES
                 for mp in (False, True)]
        with ThreadPoolExecutor(max(1, args.jobs)) as pool:
            rows = list(pool.map(lambda c: _run_one(
                *c, args.out, args.timeout, args.force), cells))
        failures = 0
        for (arch, shape, mp), r in zip(cells, rows):
            tag = r.get("status")
            failures += tag == "error"
            if tag == "ok":
                info = (f"  flops/dev={r.get('flops_per_dev', 0):.3g} "
                        f"wire/dev={r.get('wire_bytes_per_dev', 0):.3g}B "
                        f"temp/dev={r['mem']['temp_bytes'] / 1e9:.1f}GB "
                        f"({r.get('seconds')} s)")
            else:
                info = f"  ({r.get('reason', r.get('error', ''))[:70]})"
            print(f"{arch:24s} {shape:12s} {'multi' if mp else 'single':6s} "
                  f"{tag}{info}", flush=True)
        return 1 if failures else 0

    assert args.arch and args.shape, "--arch and --shape (or --all)"
    r = run_cell(args.arch, args.shape, args.multi_pod, policy=args.policy,
                 kv_dtype=args.kv_dtype, mem_only=args.mem_only)
    path = _result_path(args.out, args.arch, args.shape, args.multi_pod)
    if args.tag:
        path = path.replace(".json", f"__{args.tag}.json")
    if args.mem_only and os.path.exists(path):
        old = json.load(open(path))
        old.update({k: v for k, v in r.items()
                    if k in ("mem", "seconds", "status")})
        r = old
    with open(path, "w") as f:
        json.dump(r, f, indent=1)
    print(json.dumps({k: v for k, v in r.items() if k != "collectives"},
                     indent=1))
    return 0 if r["status"] != "error" else 1


if __name__ == "__main__":
    sys.exit(main())
