"""``repro_torch.dist`` — the mesh context, partitioning rules and ZeRO-3
storage.

The axis conventions are the reference's (``repro.dist``): ``"pod"`` and
``"data"`` are data-parallel axes, ``"model"`` is the tensor- and
expert-parallel axis, and ``use_mesh(mesh, dp_axes=...)`` overrides the
split.  The port's mesh is a grid over the ranks of a
``torch.distributed`` world (``context.Mesh``).  Served models keep the
whole parameter tree on every rank and slice a tile at the call; the
sharded trainer keeps each rank's ZeRO-3 shard only (``zero``) and
gathers a leaf where it is read.

``partitioning`` holds the reference's spec factories (``param_pspecs``,
``opt_state_pspecs``, ``batch_pspecs``), its tile rule
(``tp_shard_dim``) and ``replica_slices``; ``cache_pspecs`` and
``tree_shardings`` wait for the dry-run tools (ROADMAP.md, item E).
"""
from repro_torch.dist import context, partitioning, zero

__all__ = ["context", "partitioning", "zero"]
