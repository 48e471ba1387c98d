"""Meshes over a ``torch.distributed`` world, and a helper that starts one.

:func:`make_mesh` and :func:`make_host_mesh` lay a named grid over the
ranks of the initialised default group, or over listed ranks of it
(importing this module touches no process group).
:func:`make_production_mesh` is the reference's 16x16 / 2x16x16 mesh as
a ``dist.context.VirtualMesh``: one rank of it, with no process, for the
dry run.  :func:`spawn` starts ``world`` processes, each with its
own rank of a gloo group and the mesh over them, runs one function on
every rank and returns each rank's result; the tests and ``chip_smoke.py``
run their multi-rank cases through it.  A served or trained run under
``torchrun`` builds its mesh with :func:`make_mesh` over the group
``torchrun`` started.
"""
from __future__ import annotations

import datetime
import multiprocessing
import os
import queue
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence

import torch

from repro_torch.dist.context import Mesh, VirtualMesh

__all__ = ["make_mesh", "make_host_mesh", "make_local_mesh",
           "make_production_mesh", "spawn"]


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              ranks: Optional[Sequence[int]] = None) -> Mesh:
    """A mesh of ``shape`` named ``axes`` over the initialised world, or
    over the world ranks ``ranks``, rank-major (the last axis varies
    fastest).  Every rank of the world calls it, in the same order as
    every other mesh it makes, whether or not it is in ``ranks``."""
    return Mesh(shape, axes, ranks)


def make_production_mesh(*, multi_pod: bool = False,
                         rank: int = 0) -> VirtualMesh:
    """The reference's production mesh, 16x16 = 256 ranks (2x16x16 = 512
    for the multi-pod pass), as one rank of a virtual mesh: the dry run
    runs that rank's step with no process group."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return VirtualMesh(shape, axes, rank)


def make_local_mesh() -> Mesh:
    """Every rank of the initialised world, as a (data, model=1) mesh."""
    import torch.distributed as dist

    return make_mesh((dist.get_world_size(), 1), ("data", "model"))


def make_host_mesh(model: int = 2) -> Mesh:
    """A (data, model) mesh over the whole world with a real tensor axis
    (the reference's test-suite mesh)."""
    import torch.distributed as dist

    n = dist.get_world_size()
    if n % model:
        raise ValueError(f"{n} ranks not divisible by model={model}")
    return make_mesh((n // model, model), ("data", "model"))


def _rank_main(fn, args, rank: int, world: int, store_path: str,
               mesh_shape, axes, device: str, results, timeout_s: float
               ) -> None:
    import torch.distributed as dist

    try:
        if device == "cuda":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        else:
            # the ranks share the host's cores
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
        store = dist.FileStore(store_path, world)
        dist.init_process_group(
            "gloo", store=store, rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=timeout_s))
        try:
            mesh = make_mesh(mesh_shape, axes)
            out = fn(mesh, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:  # noqa: BLE001 - every failure goes to the parent
        results.put((rank, False, traceback.format_exc()))


def spawn(fn: Callable[..., Any], world: int, *args,
          mesh_shape: Optional[Sequence[int]] = None,
          axes: Sequence[str] = ("data", "model"), device: str = "cpu",
          timeout_s: float = 60.0) -> List[Any]:
    """Run ``fn(mesh, *args)`` on ``world`` new processes; returns each
    rank's result, in rank order.

    The processes start with the spawn method, join one gloo group through
    a ``FileStore`` in a temporary directory (no TCP port, so concurrent
    callers never collide), and build ``make_mesh(mesh_shape, axes)``
    (default: every rank on ``"model"``).  ``fn`` must be importable by
    name and its result picklable (numpy arrays, numbers, lists).  With
    ``device="cuda"`` rank r sets device ``r % device_count()``: on one
    card every rank shares it; on the CPU each rank takes an equal share
    of the host's cores.  Raises if any rank raises, dies, or has
    not answered within ``timeout_s`` seconds of the start (the group's
    own collectives time out after ``timeout_s`` as well); every process
    is ended before it returns or raises."""
    if mesh_shape is None:
        mesh_shape, axes = (world,), ("model",)
    ctx = multiprocessing.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="repro_torch_mesh_")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True, args=(
        fn, args, r, world, os.path.join(tmp, "store"), tuple(mesh_shape),
        tuple(axes), device, results, timeout_s)) for r in range(world)]
    out: dict = {}
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        while len(out) < world:
            try:
                rank, ok, val = results.get(timeout=0.2)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode is not None and r not in out]
                if dead:
                    raise RuntimeError(f"rank(s) {dead} exited with "
                                       f"{[procs[r].exitcode for r in dead]}"
                                       " before answering")
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{world - len(out)} of {world} ranks"
                                       f" did not answer in {timeout_s} s")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {world} failed:\n{val}")
            out[rank] = val
        for p in procs:
            p.join(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
    return [out[r] for r in range(world)]
