"""Hand-written Hopper kernels: the two Pallas kernels of ``repro``, and the
``pim_sim`` engine's bit-plane packing, which the reference does on the host.

* :mod:`.quant_matmul` — int8 x int8 -> int32 GEMM (``quant`` mode);
* :mod:`.crossbar_exec` — the crossbar microcode executor (``pim_sim``);
* :mod:`.pim_bits` — operands onto crossbar columns and accumulators off
  them (``pim_sim``).

Each kernel's CUDA source lives in ``csrc/`` and is built by
:mod:`.build` with ``nvcc`` for ``sm_90a`` on first use.  Each wrapper
runs the plain PyTorch version for a CPU tensor, and for a CUDA tensor
launches the kernel or raises; its ``launches`` counter counts kernel
launches.
"""
