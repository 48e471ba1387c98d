"""int8 x int8 -> int32 GEMM: the CUDA kernel's wrapper, its launch plan and
its plain version.

Replaces the Pallas TPU kernel ``repro/kernels/quant_matmul/
quant_matmul.py::quant_matmul_int``.  The kernel is ``csrc/quant_matmul.cu``
(its source note gives the bound and the design).  :func:`quant_matmul_int`
runs :func:`quant_matmul_int_ref` for CPU tensors and launches the kernel
for CUDA tensors; ``quant_matmul_int.launches`` counts the launches.  The
call goes through one PyTorch operator, ``repro_torch::quant_matmul_int``,
with a fake (shape-only) version and a FLOP formula of ``2 M K N``: so
``torch.utils.flop_counter.FlopCounterMode`` counts the kernel's
operations on the card as on fake tensors (the dry run,
``launch.dryrun``).  :func:`plan` is the kernel's tiling arithmetic: the grid, the K split, the
workspace and the arrival counters, all chosen here and passed to the C
entry point.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict, List, Tuple

import torch
from torch.utils.flop_counter import register_flop_formula

__all__ = ["Plan", "plan", "quant_matmul_int", "quant_matmul_int_ref"]

BN = 16             # columns of w per block
KSTEP = 32          # k per mma step
CHUNK = 32          # steps a block stages in shared memory, at most (1024 k)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@dataclasses.dataclass(frozen=True)
class Plan:
    """The launch of one (M, K) @ (K, N) call: a grid of ``col_tiles`` x
    ``splits`` blocks.  Block (c, s) computes columns ``col_ranges()[c]``
    over k ``k_ranges()[s]`` (at most 1024); with ``splits`` > 1 each
    writes its partial sums to the workspace and the last of a column tile
    to arrive sums the partials in split order."""
    m: int
    k: int
    n: int
    col_tiles: int
    steps: int          # 32-deep k steps, at least 1
    splits: int

    @property
    def blocks(self) -> int:
        return self.col_tiles * self.splits

    def k_ranges(self) -> List[Tuple[int, int]]:
        """[lo, hi) of k per split, in split order (the kernel's formula)."""
        return [(min(self.k, s * self.steps // self.splits * KSTEP),
                 min(self.k, (s + 1) * self.steps // self.splits * KSTEP))
                for s in range(self.splits)]

    def col_ranges(self) -> List[Tuple[int, int]]:
        return [(c * BN, min(self.n, (c + 1) * BN))
                for c in range(self.col_tiles)]

    @property
    def workspace_elems(self) -> int:
        """int32 partial sums: one (M, N) slab per split, when K is split."""
        return self.splits * self.m * self.n if self.splits > 1 else 0

    @property
    def n_counters(self) -> int:
        """Arrival counters: one per column tile, when K is split."""
        return self.col_tiles if self.splits > 1 else 0


def plan(m: int, k: int, n: int) -> Plan:
    """Tiling of an (m, k) @ (k, n) call.

    Columns go in tiles of 16, so the path's N of 1024 and 2816 give 64 and
    176 blocks that hold the whole weight in flight at once.  K splits
    across blocks only as far as a block's share must fit the 1024 k it
    stages in shared memory: the split's arrival and last-block sum cost
    more than the bytes in flight they would add (``PERF.md``)."""
    if m < 1 or n < 1 or k < 0:
        raise ValueError(f"no launch plan for M, K, N = {m, k, n}")
    steps = max(1, _cdiv(k, KSTEP))
    splits = _cdiv(steps, CHUNK)
    if splits > 65535:
        raise ValueError(f"K = {k} needs {splits} splits; at most 65535")
    return Plan(m, k, n, _cdiv(n, BN), steps, splits)


def quant_matmul_int_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain version: (M, K) int8 @ (K, N) int8 -> (M, N) int32, exact.

    A float64 product is exact here: every term is below 2**14 and
    |sum| <= 128**2 * K < 2**53 for any K below 5e8."""
    return (x.to(torch.float64) @ w.to(torch.float64)).to(torch.int32)


def _lib():
    from repro_torch.kernels import build

    lib = build.load("quant_matmul")
    if not getattr(lib, "_typed", False):
        lib.quant_matmul_int_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        lib.quant_matmul_int_launch.restype = ctypes.c_int
        lib.quant_matmul_error_string.argtypes = [ctypes.c_int]
        lib.quant_matmul_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


# (device index, stream) -> (workspace, counters).  The kernel leaves the
# counters at zero; two streams never share a pair.
_scratch: Dict[Tuple[int, int], Tuple[torch.Tensor, torch.Tensor]] = {}


def _scratch_for(device: torch.device, stream: int, p: Plan
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    key = (device.index, stream)
    ws, ctr = _scratch.get(key, (None, None))
    if ws is None or ws.numel() < p.workspace_elems:
        ws = torch.empty(max(p.workspace_elems, 1), dtype=torch.int32,
                         device=device)
    if ctr is None or ctr.numel() < p.n_counters:
        ctr = torch.zeros(max(p.n_counters, 64), dtype=torch.int32,
                          device=device)
    _scratch[key] = ws, ctr
    return ws, ctr


def quant_matmul_int(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 @ (K, N) int8 -> (M, N) int32, exact.

    CPU tensors run the plain version; CUDA tensors launch the kernel on
    the current stream (or raise)."""
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"expected (M, K) @ (K, N), got {tuple(x.shape)} "
                         f"@ {tuple(w.shape)}")
    if x.dtype != torch.int8 or w.dtype != torch.int8:
        raise TypeError(f"expected int8 operands, got {x.dtype}, {w.dtype}")
    if x.device != w.device:
        raise ValueError(f"operands on {x.device} and {w.device}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    if x.device.type == "cuda" and not (x.is_contiguous()
                                        and w.is_contiguous()):
        raise ValueError("quant_matmul_int needs contiguous operands")
    return _op(x, w)


def _launch_checked(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    m, k = x.shape
    n = w.shape[1]
    if m == 0 or n == 0:
        return torch.empty((m, n), dtype=torch.int32, device=x.device)
    return _launch(x, w, plan(m, k, n))


# the operator: the plain version on the CPU, the kernel on the card, a
# shape-only version for fake tensors (a Library, not custom_op, whose
# Python layer adds to every call; chip_smoke.py times the operator's
# host cost against a direct launch)
_LIB = torch.library.Library("repro_torch", "DEF")
_LIB.define("quant_matmul_int(Tensor x, Tensor w) -> Tensor")
_LIB.impl("quant_matmul_int", quant_matmul_int_ref, "CPU")
_LIB.impl("quant_matmul_int", _launch_checked, "CUDA")
_op = torch.ops.repro_torch.quant_matmul_int.default


@torch.library.register_fake("repro_torch::quant_matmul_int", lib=_LIB)
def _op_fake(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return x.new_empty((x.shape[0], w.shape[1]), dtype=torch.int32)


@register_flop_formula(torch.ops.repro_torch.quant_matmul_int)
def _op_flops(x_shape, w_shape, *args, out_shape=None, **kwargs) -> int:
    """One multiply and one add per term: ``2 M K N`` integer ops."""
    return 2 * x_shape[0] * x_shape[1] * w_shape[1]


def _launch(x: torch.Tensor, w: torch.Tensor, p: Plan) -> torch.Tensor:
    """Launch the kernel on checked CUDA operands with the tiling ``p``."""
    out = torch.empty((p.m, p.n), dtype=torch.int32, device=x.device)
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        ws, ctr = _scratch_for(x.device, stream, p)
        err = lib.quant_matmul_int_launch(
            x.data_ptr(), w.data_ptr(), out.data_ptr(), ws.data_ptr(),
            ctr.data_ptr(), p.m, p.n, p.k, p.col_tiles, p.splits, stream)
    if err:
        raise RuntimeError("quant_matmul_int launch failed: "
                           + lib.quant_matmul_error_string(err).decode())
    quant_matmul_int.launches += 1
    return out


quant_matmul_int.launches = 0
