"""Named spans on the profiler's timeline.

:func:`span` opens a ``torch.profiler.record_function`` range named
``repro:<name>`` while a profiler records, and is one shared null context
otherwise: without a profiler a span costs the check of
``torch.autograd._profiler_enabled()`` (about a quarter of a microsecond;
an unguarded ``record_function`` costs about 15 us).  The profiler holds
the ranges on the clock it stamps device events with, so a kernel can be
put under the span that launched it; nothing is buffered or timed here.

A request id travels in the range's name, ``repro:<name>|rid=3,7``: the
profiler's events do not carry ``record_function``'s argument string.

The spans, by layer (each reader strips the ``|rid=`` part):

* ``sched.admit``, ``sched.prefill|rid=``, ``sched.decode|rid=``
  (``serving/scheduler.py``);
* ``model.prefill``, ``model.decode_step`` (``models/model.py``);
* ``linear`` (``models/layers.py``), and inside it ``linear.quantize``,
  ``linear.rescale`` (``pim/engine.py::_sim_forward``,
  ``kernels/quant_matmul/ops.py::quant_linear``) and ``quant.gemm``;
* ``pim.pack``, ``pim.exec``, ``pim.read`` (``pim/engine.py``);
* ``moe.ffn``, ``moe.route``, ``moe.experts`` (``models/moe.py``) and
  ``moe.shared`` (``models/model.py::_moe``: a shared expert, or arctic's
  dense residual, its linears included);
* ``ssm.mixer`` and ``ssm.mamba2`` (``models/ssm.py``).
"""
from __future__ import annotations

import contextlib
from typing import Iterable, Optional

import torch

__all__ = ["PREFIX", "span"]

PREFIX = "repro:"
_OFF = contextlib.nullcontext()


def span(name: str, rids: Optional[Iterable[int]] = None):
    """A ``repro:<name>`` range while a profiler records (with ``rids``,
    ``|rid=`` and their comma-joined ids appended), else a null context."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    if rids is not None:
        name = f"{name}|rid={','.join(str(int(r)) for r in rids)}"
    return torch.profiler.record_function(PREFIX + name)
