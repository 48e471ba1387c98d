"""Vectorized crossbar simulator: execute microcode over bit-packed state.

A stateful-logic gate acts on *whole columns*, identically across rows, so
32 rows are bit-packed into one 32-bit word.  Crossbar state is
``(C, n, W)``: ``C`` independent crossbars, ``n`` columns (bitlines),
``W = ceil(rows/32)`` row-words.  A gate is then a bitwise op on ``(C, W)``
slices.  The port holds the words as ``int32`` tensors with the same bits
as the reference's ``uint32`` (PyTorch lacks the needed ``uint32`` bitwise
ops on the CPU); compare with the reference through
``numpy.view(np.uint32)``.

:func:`execute` runs the microcode on the state's device: the CUDA kernel
``kernels.crossbar_exec`` for a CUDA tensor, its grouped plain version for
a CPU tensor.  The writers update the state in place (it can be large, and
every caller replaces its state anyway) and return it.

The microcode ABI is produced by
:meth:`repro_torch.core.program.Program.to_microcode`: int32 rows
``(gate_code, in_a, in_b, out)``; gate codes from
``repro_torch.core.gates.GATE_CODES`` (INIT=0 sets the output column to
all-ones).  :func:`execute_unrolled` is a per-gate loop with static column
indices, the plain state backend ``"unrolled"`` of
``repro_torch.pim.engine``.
"""
from __future__ import annotations

from typing import Sequence, Union

import numpy as np
import torch

__all__ = [
    "blank_state",
    "pack_rows",
    "unpack_rows",
    "write_bits",
    "read_bits",
    "write_numbers",
    "read_numbers",
    "execute",
    "execute_unrolled",
]


def blank_state(crossbars: int, n: int, rows: int,
                device: Union[str, torch.device] = "cuda") -> torch.Tensor:
    """All-zero crossbar state ``(C, n, W)`` int32 (memristors in RESET)."""
    w = (rows + 31) // 32
    return torch.zeros((crossbars, n, w), dtype=torch.int32, device=device)


def _words_to_int32(words: torch.Tensor) -> torch.Tensor:
    """int64 words in [0, 2**32) -> int32 tensors holding the same bits."""
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words
                       ).to(torch.int32)


def pack_rows(bits: torch.Tensor) -> torch.Tensor:
    """Pack ``(..., rows)`` 0/1 values into int32 words ``(..., W)``
    (LSB = row 0)."""
    bits = torch.as_tensor(bits)
    rows = bits.shape[-1]
    pad = (-rows) % 32
    if pad:
        bits = torch.nn.functional.pad(bits, (0, pad))
    b = bits.reshape(bits.shape[:-1] + (-1, 32)).to(torch.int64)
    shifts = torch.arange(32, dtype=torch.int64, device=b.device)
    return _words_to_int32((b << shifts).sum(dim=-1))


def unpack_rows(words: torch.Tensor, rows: int) -> torch.Tensor:
    """Inverse of :func:`pack_rows` -> boolean ``(..., rows)``."""
    shifts = torch.arange(32, dtype=torch.int32, device=words.device)
    bits = (words.to(torch.int32)[..., None] >> shifts) & 1
    bits = bits.reshape(words.shape[:-1] + (-1,))
    return bits[..., :rows].to(torch.bool)


def write_bits(state: torch.Tensor, col: int, bits) -> torch.Tensor:
    """Write per-row bits (C, rows) into one column, in place; returns
    ``state``."""
    bits = torch.as_tensor(bits, device=state.device)
    state[:, col, :] = pack_rows(bits.to(torch.int64) & 1)
    return state


def read_bits(state: torch.Tensor, col: int, rows: int) -> torch.Tensor:
    """One column's per-row bits -> (C, rows) bool."""
    return unpack_rows(state[:, col, :], rows)


def _pack_bit(values: torch.Tensor, bit: int) -> torch.Tensor:
    """Bit ``bit`` of ``values`` (C, rows, K) packed -> (C, K, W) int32."""
    b = (values >> bit) & 1                               # (C, rows, K)
    c, rows, k = b.shape
    pad = (-rows) % 32
    if pad:
        b = torch.nn.functional.pad(b, (0, 0, 0, pad))
    b = b.reshape(c, -1, 32, k).to(torch.int64)
    shifts = torch.arange(32, dtype=torch.int64, device=b.device)
    words = (b << shifts[:, None]).sum(dim=2)             # (C, W, K)
    return _words_to_int32(words).transpose(1, 2)


def _index(cols, device) -> torch.Tensor:
    """Column numbers as an int64 tensor on ``device``.  Callers on the hot
    path pass a tensor already there: building one from a Python sequence
    is a host-to-device copy, which waits for the stream."""
    if isinstance(cols, torch.Tensor):
        return cols.to(device=device, dtype=torch.long)
    return torch.as_tensor(cols, dtype=torch.long, device=device)


def write_numbers(state: torch.Tensor,
                  cols: Union[Sequence[int], Sequence[Sequence[int]],
                              torch.Tensor],
                  values: torch.Tensor) -> torch.Tensor:
    """Write integers bit-sliced onto columns (LSB first), in place.

    ``cols`` is one number's bit columns with ``values`` (C, rows), or K
    such tuples (one per term, all of one width; or a (K, nb) tensor) with
    ``values`` (C, rows, K).  Returns ``state``."""
    values = torch.as_tensor(values, device=state.device)
    if values.is_floating_point() or values.dtype == torch.bool:
        raise TypeError(f"write_numbers needs integer values, got "
                        f"{values.dtype}")
    cols_t = _index(cols, state.device)
    if values.dim() == 2:
        cols_t, values = cols_t.reshape(1, -1), values[..., None]
    for bit in range(cols_t.shape[1]):                     # cols_t (K, nb)
        state[:, cols_t[:, bit], :] = _pack_bit(values, bit)
    return state


def read_numbers(state: torch.Tensor,
                 cols: Union[Sequence[int], torch.Tensor], rows: int
                 ) -> torch.Tensor:
    """Read integers from bit-sliced columns (LSB first) -> (C, rows).

    The reference returns uint64; the port returns int64 as a container
    of the same 64 bits (PyTorch has no uint64 arithmetic on the CPU), so
    a product with bit 63 set reads back negative here.  Compare with the
    reference through ``.numpy().view(np.uint64)``."""
    idx = _index(cols, state.device)
    bits = unpack_rows(state[:, idx, :], rows).to(torch.int64)  # (C, nb, rows)
    low = min(len(idx), 63)
    weights = torch.ones(low, dtype=torch.int64, device=state.device
                         ) << torch.arange(low, device=state.device)
    out = (bits[:, :low] * weights[None, :, None]).sum(dim=1)
    if len(idx) > 63:
        # bit 63 is the int64 sign bit: set it with an OR, never a sum
        top = torch.tensor(torch.iinfo(torch.int64).min, device=state.device)
        out = torch.where(bits[:, 63].bool(), out | top, out)
    return out


def execute(state: torch.Tensor, microcode: torch.Tensor) -> torch.Tensor:
    """Run flat microcode ``(G, 4)`` int32 over state ``(C, n, W)`` int32 on
    the state's device; returns the new state."""
    from repro_torch.kernels.crossbar_exec import crossbar_exec

    microcode = torch.as_tensor(microcode, dtype=torch.int32,
                                device=state.device)
    return crossbar_exec(state, microcode)


def execute_unrolled(state: torch.Tensor, microcode) -> torch.Tensor:
    """Plain per-gate loop over a host microcode, with static column
    indices; returns a new state on ``state``'s device.  The reference's
    version unrolls the program into one traced function; here each row is
    one or two bitwise ops on a ``(C, W)`` column."""
    words = state.clone()
    for code, ia, ib, out in np.asarray(microcode).tolist():
        a, b = words[:, ia, :], words[:, ib, :]
        if code == 0:                       # INIT
            res = torch.full_like(a, -1)
        elif code == 1:                     # NOT
            res = torch.bitwise_not(a)
        elif code == 2:                     # NOR
            res = torch.bitwise_not(a | b)
        elif code == 3:                     # OR
            res = a | b
        elif code == 4:                     # NAND
            res = torch.bitwise_not(a & b)
        else:                               # AND
            res = a & b
        words[:, out, :] = res
    return words
