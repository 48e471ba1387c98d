"""Fault tolerance and elasticity for long-running jobs.

* :class:`CheckpointManager` — cadence + retention + auto-resume around
  ``repro_torch.checkpoint``; the data pipeline is stateless-indexed, so
  resume is "load params/opt, continue at manifest step".
* :func:`run_with_restarts` — supervisor loop: on worker failure, restore
  the latest checkpoint and continue (bounded retries).  On a real cluster
  the restart comes from the scheduler re-launching the job; the logic is
  the same because all state lives in (checkpoint, step).
* :class:`ElasticMesh` — the largest valid (pod, data, model) mesh over
  the world or a list of its ranks (a replica's slice, or its
  survivors), shrinking the model axis before the data axis (model
  shards must stay intact to reshard checkpoints cheaply).
* :class:`StragglerMonitor` — EWMA step-time outlier detection.
"""
from __future__ import annotations

import dataclasses
import shutil
import time
from typing import Callable, Dict, Optional, Sequence, Tuple

from repro_torch.checkpoint.checkpoint import (available_steps, latest_step,
                                               restore_checkpoint,
                                               save_checkpoint)

__all__ = ["CheckpointManager", "run_with_restarts", "ElasticMesh",
           "StragglerMonitor"]


@dataclasses.dataclass
class CheckpointManager:
    """Saves every ``every_steps`` steps, keeps the newest ``keep``, and
    restores onto ``device``."""
    directory: str
    every_steps: int = 100
    keep: int = 3
    shard_count: int = 1
    device: str = "cuda"

    def maybe_save(self, step: int, tree, metadata: Optional[Dict] = None):
        if step % self.every_steps:
            return None
        return self.save(step, tree, metadata)

    def save(self, step: int, tree, metadata: Optional[Dict] = None):
        path = save_checkpoint(self.directory, step, tree,
                               metadata=metadata, shard_count=self.shard_count)
        self._gc()
        return path

    def _gc(self):
        steps = available_steps(self.directory)
        for s in steps[:-self.keep]:
            shutil.rmtree(f"{self.directory}/step_{s:08d}", ignore_errors=True)

    def resume(self, like) -> Tuple[Optional[int], Optional[object], Dict]:
        step = latest_step(self.directory)
        if step is None:
            return None, None, {}
        tree, meta = restore_checkpoint(self.directory, step, like,
                                        device=self.device)
        return step, tree, meta


def run_with_restarts(worker: Callable[[Optional[int]], int],
                      manager: CheckpointManager,
                      max_restarts: int = 3) -> int:
    """Run ``worker(resume_step)``; on failure restore and retry.

    ``worker`` must checkpoint through ``manager`` and return the final
    step.  The worker raises mid-run, the supervisor resumes from the last
    durable step, and training completes with the same data order
    (stateless pipeline indexing).
    """
    restarts = 0
    while True:
        resume_at = latest_step(manager.directory)
        try:
            return worker(resume_at)
        except Exception:
            restarts += 1
            if restarts > max_restarts:
                raise
            time.sleep(0.01)


class ElasticMesh:
    """Build the largest valid (pod, data, model) mesh over a list of
    ranks.

    The reference lays its mesh over a list of live devices; a port mesh
    (``dist.context.Mesh``) lies over world ranks of the initialised
    ``torch.distributed`` world: all of them (``ranks=None``), or a
    serving replica's slice, which shrinks to its survivors when ranks
    are lost (``serving.router``).  ``model_parallel`` halves until it
    divides the rank count, and ``pods`` falls back to 1 when it does not
    divide the data-parallel count, as the reference's do."""

    def __init__(self, model_parallel: int, pods: int = 1):
        self.model_parallel = model_parallel
        self.pods = pods

    def shape(self, n: int) -> Tuple[int, int, int]:
        """(pods, data, model) over ``n`` ranks."""
        tp = self.model_parallel
        while tp > 1 and n % tp:
            tp //= 2  # degrade model parallelism if ranks don't divide
        dp_total = n // tp
        pods = self.pods if dp_total % self.pods == 0 else 1
        return pods, dp_total // pods, tp

    def make(self, ranks: Optional[Sequence[int]] = None):
        """The mesh over ``ranks`` (default: the whole initialised world).
        Every rank of the world calls it, in the same order."""
        import torch.distributed as dist

        from repro_torch.launch.mesh import make_mesh

        if ranks is None:
            return make_mesh(self.shape(dist.get_world_size()),
                             ("pod", "data", "model"))
        ranks = list(ranks)
        return make_mesh(self.shape(len(ranks)), ("pod", "data", "model"),
                         ranks)


@dataclasses.dataclass
class StragglerMonitor:
    alpha: float = 0.1
    threshold: float = 2.0
    _ewma: float = 0.0
    _n: int = 0
    flagged: int = 0

    def record(self, step_time_s: float) -> bool:
        """Returns True if this step is a straggler outlier."""
        if self._n == 0:
            self._ewma = step_time_s
        slow = self._n > 3 and step_time_s > self.threshold * self._ewma
        self._ewma = (1 - self.alpha) * self._ewma + self.alpha * step_time_s
        self._n += 1
        if slow:
            self.flagged += 1
        return slow

    def reset(self) -> None:
        """Forget history — e.g. after a replica respawn, whose first
        steps re-pay compilation and must not inherit the dead replica's
        EWMA baseline."""
        self._ewma = 0.0
        self._n = 0
        self.flagged = 0
