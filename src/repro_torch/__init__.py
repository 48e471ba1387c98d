"""repro_torch — the PyTorch/CUDA port of ``repro`` (PartitionPIM).

A second package beside the JAX reference ``repro``, with the same module
layout: ``core`` (partition models, control codecs, programs), ``pim``
(program builders, the bit-packed crossbar simulator, the compile-once /
execute-many engine), ``kernels`` (hand-written Hopper kernels for the two
Pallas kernels of the reference, each with its plain PyTorch version),
``models`` (the dense LM stack), ``serving`` (continuous batching over a
contiguous or block-paged KV pool) and ``launch`` (the serving CLI).

The port imports ``torch`` and never ``jax`` or ``repro``.  Its entry
points take ``device=`` and run on ``"cuda"`` unless the caller asks for
``"cpu"`` (see :mod:`repro_torch.device`).
"""
