"""``repro_torch.dist`` — the mesh context and partitioning rules.

The axis conventions are the reference's (``repro.dist``): ``"pod"`` and
``"data"`` are data-parallel axes, ``"model"`` is the tensor- and
expert-parallel axis, and ``use_mesh(mesh, dp_axes=...)`` overrides the
split.  The port's mesh is a grid over the ranks of a
``torch.distributed`` world (``context.Mesh``); every rank holds the
replicated parameters and activations and slices its tile at the call.

``partitioning`` keeps the reference's tile rule (``tp_shard_dim``); the
reference's sharding-spec factories (``param_pspecs``, ``cache_pspecs``,
...) and ``replica_slices`` wait for the sharded trainer and the router
(ROADMAP.md, items D and E).
"""
from repro_torch.dist import context, partitioning

__all__ = ["context", "partitioning"]
