"""Crossbar microcode executor: the CUDA kernel's wrapper and its plain versions.

Replaces the Pallas TPU kernel ``repro/kernels/crossbar_exec/
crossbar_exec.py::crossbar_exec``.  The kernel is ``csrc/crossbar_exec.cu``
(its source note gives the bound and the design).  State is ``(C, n, W)``
int32 holding the bits of the reference's uint32 words; microcode is
``(G, 4)`` int32 rows ``(code, ia, ib, dst)`` with codes 0 INIT, 1 NOT,
2 NOR, 3 OR, 4 NAND, 5 AND.

The kernel runs the microcode as groups of independent gates that
``schedule.py`` builds on the host, once per microcode tensor
(:func:`plan`).  :func:`crossbar_exec` runs :func:`crossbar_exec_grouped_ref`
(the same groups, in the kernel's order) for CPU tensors and launches the
kernel for CUDA tensors; ``crossbar_exec.launches`` counts the launches.
:func:`crossbar_exec_ref`, a per-gate loop, is the oracle both are held
against.
"""
from __future__ import annotations

import collections
import ctypes
import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.kernels.crossbar_exec import schedule as sched

__all__ = ["Plan", "plan", "crossbar_exec", "crossbar_exec_ref",
           "crossbar_exec_grouped_ref", "check_microcode"]


def crossbar_exec_ref(state: torch.Tensor, microcode: torch.Tensor
                      ) -> torch.Tensor:
    """Plain version: a per-gate loop over the microcode rows.

    Works on a ``(n, C, W)`` copy of the state so that every column is one
    contiguous view; each gate is one or two in-place bitwise ops."""
    st = state.permute(1, 0, 2).contiguous()
    cols = st.unbind(0)
    for code, ia, ib, dst in microcode.tolist():
        out = cols[dst]
        if code == 0:                       # INIT
            out.fill_(-1)
        elif code == 1:                     # NOT
            torch.bitwise_not(cols[ia], out=out)
        elif code == 2:                     # NOR
            torch.bitwise_or(cols[ia], cols[ib], out=out)
            out.bitwise_not_()
        elif code == 3:                     # OR
            torch.bitwise_or(cols[ia], cols[ib], out=out)
        elif code == 4:                     # NAND
            torch.bitwise_and(cols[ia], cols[ib], out=out)
            out.bitwise_not_()
        else:                               # AND
            torch.bitwise_and(cols[ia], cols[ib], out=out)
    return st.permute(1, 0, 2).contiguous()


def crossbar_exec_grouped_ref(state: torch.Tensor, rows, offsets
                              ) -> torch.Tensor:
    """Plain version in the kernel's order: ``rows`` and ``offsets`` as
    :func:`schedule.schedule` gives them, each group run as "gather every
    input column, compute, scatter", vectorised over the group, on an extra
    all-zero column ``n`` (see :func:`schedule.decode`).  Runs on the host,
    over a CPU ``state``."""
    if state.device.type != "cpu":
        raise ValueError(f"the grouped plain version runs on the host; got "
                         f"state on {state.device}")
    c, n, w = state.shape
    a, b, dst, orm, inv = sched.decode(np.asarray(rows), n)
    ab = np.stack([a, b]).astype(np.intp)
    dst = dst.astype(np.intp)
    orm, inv = orm[:, None, None], inv[:, None, None]
    st = np.zeros((n + 1, c, w), np.int32)
    st[:n] = state.numpy().transpose(1, 0, 2)
    bounds = np.asarray(offsets).tolist()
    for s, e in zip(bounds[:-1], bounds[1:]):
        x, y = st[ab[0, s:e]], st[ab[1, s:e]]
        out = x & y
        x |= y
        x &= orm[s:e]
        out |= x
        out ^= inv[s:e]
        st[dst[s:e]] = out
    return torch.from_numpy(np.ascontiguousarray(st[:n].transpose(1, 0, 2)))


def check_microcode(microcode: torch.Tensor, n: int) -> None:
    """Raise unless every row has a code in 0..5 and columns in [0, n)."""
    if microcode.dim() != 2 or microcode.shape[1] != 4:
        raise ValueError(f"microcode must be (G, 4), got "
                         f"{tuple(microcode.shape)}")
    if microcode.shape[0] == 0:
        return
    codes, cols = microcode[:, 0], microcode[:, 1:]
    if bool(((codes < 0) | (codes > 5)).any()):
        raise ValueError("microcode holds a gate code outside 0..5")
    if bool(((cols < 0) | (cols >= n)).any()):
        raise ValueError(f"microcode addresses a column outside [0, {n})")


@dataclasses.dataclass(frozen=True, eq=False)
class Plan:
    """A microcode tensor's schedule for ``n`` columns.  ``groups`` is the
    kernel's group records on the microcode's CUDA device (None on the
    CPU)."""

    microcode: torch.Tensor     # held, so its address is not reused
    rows: np.ndarray            # (groups * width, 4) int32
    offsets: np.ndarray         # (groups + 1,) int64
    groups: Optional[torch.Tensor]

    @property
    def n_groups(self) -> int:
        return len(self.offsets) - 1


# schedules per microcode tensor (identity, see plan) -> Plan.  Bounded LRU.
_plans: "collections.OrderedDict" = collections.OrderedDict()
_PLANS_MAX = 64


def plan(microcode: torch.Tensor, n: int) -> Plan:
    """Validate and schedule ``microcode`` for ``n`` columns, once per
    microcode tensor (keyed by its identity: device, address, in-place
    version and shape).  A CUDA microcode is copied to the host once, on
    first use, and its group records are copied back once."""
    key = (microcode.device, microcode.data_ptr(), microcode._version,
           tuple(microcode.shape), n)
    hit = _plans.pop(key, None)
    if hit is None:
        host = microcode.cpu()
        check_microcode(host, n)
        rows, offsets = sched.schedule(host.numpy(), n)
        groups = None
        if microcode.device.type == "cuda":
            groups = torch.from_numpy(sched.pack(rows, n)).to(
                microcode.device)
        hit = Plan(microcode, rows, offsets, groups)
    _plans[key] = hit
    while len(_plans) > _PLANS_MAX:
        _plans.popitem(last=False)
    return hit


def _lib():
    from repro_torch.kernels import build

    lib = build.load("crossbar_exec")
    if not getattr(lib, "_typed", False):
        lib.crossbar_exec_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p]
        lib.crossbar_exec_launch.restype = ctypes.c_int
        lib.crossbar_exec_error_string.argtypes = [ctypes.c_int]
        lib.crossbar_exec_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def crossbar_exec(state: torch.Tensor, microcode: torch.Tensor
                  ) -> torch.Tensor:
    """Run microcode (G, 4) int32 over state (C, n, W) int32 -> new state.

    CPU tensors run the grouped plain version; CUDA tensors launch the
    kernel on the current stream (or raise).  The microcode is checked
    against ``n`` and scheduled once per microcode tensor (:func:`plan`)."""
    if state.dim() != 3:
        raise ValueError(f"state must be (C, n, W), got {tuple(state.shape)}")
    if state.dtype != torch.int32 or microcode.dtype != torch.int32:
        raise TypeError(f"expected int32 state and microcode, got "
                        f"{state.dtype}, {microcode.dtype}")
    if state.device != microcode.device:
        raise ValueError(f"state on {state.device}, microcode on "
                         f"{microcode.device}")
    if state.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {state.device}")
    c, n, w = state.shape
    p = plan(microcode, n)
    if state.device.type == "cpu":
        return crossbar_exec_grouped_ref(state, p.rows, p.offsets)
    if not state.is_contiguous():
        raise ValueError("crossbar_exec needs a contiguous state")
    out = torch.empty_like(state)
    if c == 0:
        return out
    lib = _lib()
    with torch.cuda.device(state.device):
        stream = torch.cuda.current_stream(state.device).cuda_stream
        err = lib.crossbar_exec_launch(p.groups.data_ptr(), p.n_groups,
                                       sched.GROUP_WIDTH, state.data_ptr(),
                                       out.data_ptr(), c, n, w, stream)
    if err:
        raise RuntimeError("crossbar_exec launch failed: "
                           + lib.crossbar_exec_error_string(err).decode())
    crossbar_exec.launches += 1
    return out


crossbar_exec.launches = 0
