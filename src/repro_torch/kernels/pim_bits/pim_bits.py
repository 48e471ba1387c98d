"""Bit-plane transposition of ``pim_sim`` operands and accumulators: the
CUDA kernels' wrappers and their plain versions.

Replaces no TPU kernel: the reference packs and reads crossbar state on the
host (``executor.write_numbers`` / ``read_numbers``).  The kernels are
``csrc/pim_bits.cu`` (its source note gives the bounds and the design):

* :func:`write_operand` writes an operand of a batch of chunk GEMMs, ``x``
  (P, M, K) or ``w`` (P, O, K) uint8, bit-sliced onto the columns
  ``cols`` (K, nb) of crossbars ``[lo, hi)``, straight from the operand:
  row ``j`` of crossbar ``c`` is global row ``g = (c mod n_cb) * rows + j``
  of chunk ``q = c div n_cb``, valued ``v[q, g div o]`` for x and
  ``v[q, g mod o]`` for w, and 0 past ``m * o`` rows.  That is what
  ``executor.write_numbers(part, cols, engine._operand_rows(...))`` writes,
  without building the rows.
* :func:`read_accumulators` reads the accumulator columns ``acc`` (A,),
  A <= 63, of a state (C, n, W) as (C, rows) int64, into the caller's
  buffer if given: ``executor.read_numbers`` for those widths.

Each runs its plain version (:func:`write_operand_ref`,
:func:`read_accumulators_ref`, the kernels' formulas in PyTorch) for CPU
tensors and launches its kernel for CUDA tensors (or raises);
``launches["write"]`` and ``launches["read"]`` count the launches.  A
column table is checked once per tensor: its columns lie in ``[0, n)``,
and a writer's are distinct.
"""
from __future__ import annotations

import collections
import ctypes
from typing import Optional

import torch

from repro_torch.pim.executor import _words_to_int32

__all__ = ["MAX_BITS", "MAX_ACC_BITS", "launches", "write_operand",
           "write_operand_ref", "read_accumulators", "read_accumulators_ref"]

MAX_BITS = 8        # bits per term the writer takes (the kernel's MAX_BITS)
MAX_ACC_BITS = 63   # accumulator bits the reader takes: bit 63 is the sign

#: kernel launches per entry point
launches = {"write": 0, "read": 0}


def write_operand_ref(part: torch.Tensor, v: torch.Tensor, cols: torch.Tensor,
                      lo: int, hi: int, n_cb: int, rows: int, m: int, o: int,
                      of_x: bool) -> torch.Tensor:
    """Plain version of the writer, in its formulas: the value of every row
    of crossbars ``[lo, hi)`` from its chunk and global row, each row-word
    of 32 rows packed per (term, bit), each column's words stored.  Updates
    ``part`` (crossbar ``lo`` first) in place and returns it."""
    dev = part.device
    words = part.shape[2]
    k, nb = cols.shape
    c = torch.arange(lo, hi, device=dev)
    q = c // n_cb
    j = torch.arange(32 * words, device=dev)
    g = (c - q * n_cb)[:, None] * rows + j                  # (C, 32W)
    live = (j < rows) & (g < m * o)
    r = torch.where(live, g // o if of_x else g % o, 0)
    vals = torch.where(live[..., None], v[q[:, None], r], 0)   # (C, 32W, K)
    bits = (vals.to(torch.int64)[..., None]
            >> torch.arange(nb, device=dev)) & 1            # (C, 32W, K, nb)
    bits = bits.reshape(hi - lo, words, 32, k * nb)
    lane = torch.arange(32, device=dev)[:, None]
    packed = (bits << lane).sum(dim=2)                      # (C, W, K*nb)
    part[:, cols.reshape(-1).long(), :] = _words_to_int32(packed).transpose(
        1, 2)
    return part


def read_accumulators_ref(state: torch.Tensor, acc: torch.Tensor, rows: int,
                          out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of the reader: row ``r`` of each crossbar is the sum of
    bit ``r`` of its accumulator columns' words ``r div 32``, shifted by
    the column's place.  Writes into ``out`` when given; returns the
    (C, rows) int64."""
    dev = state.device
    words = state[:, acc.long(), :]                         # (C, A, W)
    r = torch.arange(rows, device=dev)
    bits = (words[:, :, r // 32] >> (r % 32)) & 1           # (C, A, rows)
    place = torch.arange(len(acc), device=dev)[:, None]
    val = (bits.to(torch.int64) << place).sum(dim=1)
    return val if out is None else out.copy_(val)


# column tables already checked, keyed on the tensor's identity and n; each
# entry holds its tensor, so that its address is not reused.  Bounded LRU.
_checked: "collections.OrderedDict" = collections.OrderedDict()
_CHECKED_MAX = 64


def _check_columns(cols: torch.Tensor, n: int, distinct: bool) -> None:
    """Raise unless every column of ``cols`` lies in [0, n) and, for a
    writer's table, each appears once; once per table tensor (the first
    check copies it to the host)."""
    key = (cols.device, cols.data_ptr(), cols._version, tuple(cols.shape), n)
    if key in _checked:
        _checked.move_to_end(key)
        return
    host = cols.cpu().reshape(-1)
    if host.numel() and bool(((host < 0) | (host >= n)).any()):
        raise ValueError(f"a column table addresses a column outside "
                         f"[0, {n})")
    if distinct and torch.unique(host).numel() != host.numel():
        raise ValueError("a writer's column table repeats a column")
    _checked[key] = cols
    while len(_checked) > _CHECKED_MAX:
        _checked.popitem(last=False)


def _lib():
    from repro_torch.kernels import build

    lib = build.load("pim_bits")
    if not getattr(lib, "_typed", False):
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.pim_bits_write_launch.argtypes = [
            ptr, i64, i64, i64, ptr, i32, i32, ptr, i32, i32, i32, i32, i64,
            i64, i32, i32, i32, ptr]
        lib.pim_bits_write_launch.restype = i32
        lib.pim_bits_read_launch.argtypes = [ptr, ptr, i32, i32, i32, i32,
                                             i32, ptr, ptr]
        lib.pim_bits_read_launch.restype = i32
        lib.pim_bits_error_string.argtypes = [i32]
        lib.pim_bits_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _raise_on(lib, err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"pim_bits {what} launch failed: "
                           + lib.pim_bits_error_string(err).decode())


def _check_state(state: torch.Tensor, rows: int) -> None:
    if state.dim() != 3 or state.dtype != torch.int32:
        raise TypeError(f"state must be (C, n, W) int32, got "
                        f"{tuple(state.shape)} {state.dtype}")
    if state.shape[2] != -(-rows // 32):
        raise ValueError(f"state has {state.shape[2]} words a column, "
                         f"{rows} rows need {-(-rows // 32)}")
    if state.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {state.device}")


def write_operand(part: torch.Tensor, v: torch.Tensor, cols: torch.Tensor,
                  lo: int, hi: int, n_cb: int, rows: int, m: int, o: int,
                  of_x: bool) -> torch.Tensor:
    """Write operand ``v`` (P, M, K) (``of_x``) or (P, O, K) uint8 onto
    columns ``cols`` (K, nb) int32 of crossbars ``[lo, hi)``, whose state
    is ``part`` (hi - lo, n, W) int32, in place; returns ``part``.  The
    same bits as ``executor.write_numbers(part, cols, engine._operand_rows(
    v, lo, hi, n_cb, rows, m, o, of_x))``.  CPU tensors run the plain
    version; CUDA tensors launch the kernel on the current stream."""
    _check_state(part, rows)
    if v.dim() != 3 or v.dtype != torch.uint8:
        raise TypeError(f"operand must be (P, R, K) uint8, got "
                        f"{tuple(v.shape)} {v.dtype}")
    if cols.dim() != 2 or cols.dtype != torch.int32 \
            or cols.shape[0] != v.shape[2]:
        raise TypeError(f"columns must be (K={v.shape[2]}, nb) int32, got "
                        f"{tuple(cols.shape)} {cols.dtype}")
    if not 1 <= cols.shape[1] <= MAX_BITS:
        raise ValueError(f"the writer takes 1 to {MAX_BITS} bits a term, "
                         f"got {cols.shape[1]}")
    if part.shape[0] != hi - lo or not 0 <= lo <= hi \
            or hi > v.shape[0] * n_cb:
        raise ValueError(f"crossbars [{lo}, {hi}) of {v.shape[0]} x {n_cb} "
                         f"against a state of {part.shape[0]}")
    if v.shape[1] != (m if of_x else o) or n_cb * rows < m * o:
        raise ValueError(f"operand {tuple(v.shape)} against m={m}, o={o}, "
                         f"{n_cb} crossbars of {rows} rows a chunk")
    if not (part.device == v.device == cols.device):
        raise ValueError(f"state on {part.device}, operand on {v.device}, "
                         f"columns on {cols.device}")
    n = part.shape[1]
    _check_columns(cols, n, distinct=True)
    if part.device.type == "cpu":
        return write_operand_ref(part, v, cols, lo, hi, n_cb, rows, m, o,
                                 of_x)
    if not (part.is_contiguous() and cols.is_contiguous()):
        raise ValueError("write_operand needs a contiguous state and column "
                         "table")
    lib = _lib()
    with torch.cuda.device(part.device):
        stream = torch.cuda.current_stream(part.device).cuda_stream
        err = lib.pim_bits_write_launch(
            v.data_ptr(), *v.stride(), cols.data_ptr(), cols.shape[0],
            cols.shape[1], part.data_ptr(), lo, hi, n_cb, rows, m, o,
            int(of_x), n, part.shape[2], stream)
    _raise_on(lib, err, "write")
    launches["write"] += 1
    return part


def read_accumulators(state: torch.Tensor, acc: torch.Tensor, rows: int,
                      out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Read accumulator columns ``acc`` (A,) int32, A <= 63, of ``state``
    (C, n, W) int32 as (C, rows) int64, into ``out`` (a contiguous
    (C, rows) int64 buffer) when given; returns it.  The same values as
    ``executor.read_numbers(state, acc, rows)``.  CPU tensors run the plain
    version; CUDA tensors launch the kernel on the current stream."""
    _check_state(state, rows)
    if acc.dim() != 1 or acc.dtype != torch.int32:
        raise TypeError(f"accumulator columns must be (A,) int32, got "
                        f"{tuple(acc.shape)} {acc.dtype}")
    if len(acc) > MAX_ACC_BITS:
        raise ValueError(f"the reader takes at most {MAX_ACC_BITS} "
                         f"accumulator bits, got {len(acc)}")
    c = state.shape[0]
    if out is not None and (out.shape != (c, rows)
                            or out.dtype != torch.int64):
        raise TypeError(f"out must be ({c}, {rows}) int64, got "
                        f"{tuple(out.shape)} {out.dtype}")
    if acc.device != state.device or (out is not None
                                      and out.device != state.device):
        raise ValueError("state, columns and out on different devices")
    _check_columns(acc, state.shape[1], distinct=False)
    if state.device.type == "cpu":
        return read_accumulators_ref(state, acc, rows, out)
    if out is None:
        out = torch.empty((c, rows), dtype=torch.int64, device=state.device)
    if not (state.is_contiguous() and acc.is_contiguous()
            and out.is_contiguous()):
        raise ValueError("read_accumulators needs a contiguous state, "
                         "column table and out")
    lib = _lib()
    with torch.cuda.device(state.device):
        stream = torch.cuda.current_stream(state.device).cuda_stream
        err = lib.pim_bits_read_launch(
            state.data_ptr(), acc.data_ptr(), len(acc), c, state.shape[1],
            state.shape[2], rows, out.data_ptr(), stream)
    _raise_on(lib, err, "read")
    launches["read"] += 1
    return out
