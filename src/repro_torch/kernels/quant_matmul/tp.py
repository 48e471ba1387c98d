"""Tensor-parallel int8 quantized linear: per-rank tiles over ``"model"``.

The mesh-level analogue of PartitionPIM's crossbar partitioning: one
logical GEMM is split into per-rank int8 tiles, each rank running
``ops.quant_matmul_int`` (the CUDA kernel on a card) over only its weight
tile.  Replaces the reference's ``repro/kernels/quant_matmul/tp.py``,
which runs the same tiles under ``shard_map``.

The port's mesh is SPMD over processes (``repro_torch.dist.context``):
every rank holds the whole weight and the whole activation, takes its
tile as a slice at the call, and meets the other ranks in explicit
collectives over the model group.  The split follows
``dist.partitioning.tp_shard_dim`` (:func:`tp_split`):

* **column-parallel** (output dim split) — each rank quantizes its own
  ``(K, N/R)`` tile per output column, runs the kernel, rescales in
  float32, and an ``all_gather`` over the model group puts the columns
  back together before the cast to the input's dtype.  Per-column weight
  scales make this bit-identical to single-rank ``quant``: a column's
  scale cannot depend on the split.  An output dim that ``R`` does not
  divide is zero-padded to a multiple of ``R`` and sliced back.
* **row-parallel** (inner dim split) — activation rows and weight
  columns are quantized against the *global* amax (each rank's amax over
  its ``K/R`` slice, then ``all_reduce(MAX)``: max is exact, so the scales
  are bit-identical to the single-rank ones), each rank computes an int32
  partial product over its slice, and ``all_reduce(SUM)`` in int32 adds
  them: integer addition is exact, so the whole row split is bit-identical
  to single-rank ``quant`` too.  Row tiles are chosen only when ``R``
  divides K.

On a mesh with data-parallel axes the token (row) dim is split over them
when it divides (each data rank tiles only its rows) and the rows are
gathered back over the data group; otherwise every data rank computes
every row, as the reference falls back to replication for a tiny decode.

Differentiation is straight-through (:class:`_TpMM`): the forward is the
int8 tiles, the backward the ideal float product, the reference's
``custom_vjp``.  Outside a mesh, without a model axis, or at model 1,
:func:`tp_quant_linear` is ``quant_linear`` exactly, forward and
backward.

:func:`tp_quant_linear_ref` computes all ``R`` tiles and their reduction
in one process with the plain GEMM: the oracle a rank's tiles are held
to (the tests and ``chip_smoke.py``).
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.dist import context as dctx
from repro_torch.dist.partitioning import tp_shard_dim
from repro_torch.kernels.quant_matmul import ops
from repro_torch.kernels.quant_matmul.ops import quantize_sym

__all__ = ["tp_quant_linear", "tp_quant_linear_ref", "tp_split",
           "tp_tile_shape", "tile_summary"]


def tp_split(w_shape: Tuple[int, int], r: int) -> str:
    """``"col"`` | ``"row"``: which dim of ``(K, N)`` the tile splits.

    Follows ``partitioning.tp_shard_dim`` (largest divisible dim, ties to
    the later = column-parallel).  When neither dim divides ``r`` the
    tile goes column-parallel and zero-pads N — always possible."""
    return "row" if tp_shard_dim(w_shape, r) == 0 else "col"


def tp_tile_shape(w_shape: Tuple[int, int], r: int) -> Tuple[int, int]:
    """The per-rank weight tile ``(K_loc, N_loc)`` (after pad) for ``r``
    ranks — what each rank's kernel actually sees."""
    k, n = w_shape
    if tp_split(w_shape, r) == "row":
        return (-(-k // r), n)
    return (k, -(-(n + (-n) % r) // r))


def tile_summary(cfg, r: int) -> List[str]:
    """Per-rank tile lines for a config's core projections (the serving
    CLI's ``[tp]`` lines), rendered from :func:`tp_split` and
    :func:`tp_tile_shape`."""
    d, ff, h = cfg.d_model, cfg.d_ff, cfg.n_heads * cfg.hd
    return [
        f"{nm} {shp}->{tp_split(shp, r)} {tp_tile_shape(shp, r)}"
        for nm, shp in (("wq", (d, h)), ("w_in", (d, ff)),
                        ("w_out", (ff, d)))
    ]


def _dp_split(mesh, m: int) -> Tuple[Optional[Tuple[str, ...]], int]:
    """(data axes the token dim splits over, local token count): the data
    axes when they divide ``m`` (each data rank tiles only its rows), else
    ``None`` and every row on every data rank."""
    dp = tuple(a for a in dctx.dp_axes() if a in mesh.axis_names
               and mesh.shape[a] > 1)
    dp_size = mesh.axis_size(dp) if dp else 1
    if not dp or m % dp_size:
        return None, m
    return dp, m // dp_size


def _col_tile(w: torch.Tensor, r: int, i: int) -> torch.Tensor:
    """Rank ``i``'s (K, N_loc) column tile of ``w``, N zero-padded to a
    multiple of ``r``."""
    n = w.shape[1]
    pn = (-n) % r
    wp = F.pad(w, (0, pn)) if pn else w
    n_loc = (n + pn) // r
    return wp[:, i * n_loc:(i + 1) * n_loc]


def _tp_forward(split: str, bits: int, x2: torch.Tensor, w: torch.Tensor
                ) -> torch.Tensor:
    mesh = dctx.current_mesh()
    ax = dctx.tp_axis()
    r = mesh.shape[ax]
    i = mesh.index(ax)
    m, k = x2.shape
    n = w.shape[1]
    dp, m_loc = _dp_split(mesh, m)
    if dp is not None:
        j = mesh.index(dp)
        x2 = x2[j * m_loc:(j + 1) * m_loc]

    if split == "col":
        # per-column weight scales: a rank's local scales ARE the global
        # ones, and activation rows quantize independently
        xq, xs = quantize_sym(x2, axis=1, bits=bits)
        wq, ws = quantize_sym(_col_tile(w, r, i).to(torch.float32), axis=0,
                              bits=bits)
        acc = ops.quant_matmul_int(xq, wq.contiguous())
        y = acc.to(torch.float32) * xs[:, None] * ws[None, :]
        y = dctx.all_gather(y, ax, dim=1)[:, :n]
    else:
        kl = k // r
        xl = x2[:, i * kl:(i + 1) * kl]
        wl = w[i * kl:(i + 1) * kl].to(torch.float32)
        # global ranges from per-rank amax: max is exact, so the scales
        # are bit-identical to the single-rank reduction
        xa = dctx.all_reduce(torch.amax(torch.abs(xl), dim=1, keepdim=True),
                             ax, "max")
        wa = dctx.all_reduce(torch.amax(torch.abs(wl), dim=0, keepdim=True),
                             ax, "max")
        xq, xs = quantize_sym(xl, axis=1, bits=bits, amax=xa)
        wq, ws = quantize_sym(wl, axis=0, bits=bits, amax=wa)
        # int32 partial tiles; an integer sum is exact in any order
        acc = dctx.all_reduce(ops.quant_matmul_int(xq.contiguous(),
                                                   wq.contiguous()), ax,
                              "sum")
        y = acc.to(torch.float32) * xs[:, None] * ws[None, :]
    if dp is not None:
        y = dctx.all_gather(y, dp, dim=0)
    return y


class _TpMM(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x2, w, split, bits):
        ctx.save_for_backward(x2, w)
        return _tp_forward(split, bits, x2, w)

    @staticmethod
    def backward(ctx, g):
        # straight-through estimator: the forward is the int8 tiles, the
        # backward differentiates the ideal float matmul (the reference's
        # custom_vjp); every rank holds the whole g, x and w
        x2, w = ctx.saved_tensors
        gx = (g @ w.to(g.dtype).T).to(x2.dtype)
        gw = (x2.to(g.dtype).T @ g).to(w.dtype)
        return gx, gw, None, None


def tp_quant_linear(x: torch.Tensor, w: torch.Tensor, bits: int = 8
                    ) -> torch.Tensor:
    """``x @ w`` via per-rank int8 tiles over the active mesh's ``"model"``
    axis.  ``x``: (..., K) float; ``w``: (K, N).

    Outside a mesh, when the mesh has no tensor axis, or when that axis
    has size 1, this is ``ops.quant_linear`` exactly; with one, the result
    is bit-identical to it (see the module docstring)."""
    mesh = dctx.current_mesh()
    ax = dctx.tp_axis()
    if mesh is None or ax is None or mesh.shape[ax] <= 1:
        return ops.quant_linear(x, w.to(torch.float32), bits=bits)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]).to(torch.float32)
    split = tp_split(tuple(w.shape), mesh.shape[ax])
    # the weight keeps its dtype: a rank slices its tile first and casts
    # only that (exact, so the tile is the float32 weight's own)
    y = _TpMM.apply(x2, w, split, bits)
    return y.reshape(*lead, w.shape[-1]).to(x.dtype)


def tp_quant_linear_ref(x: torch.Tensor, w: torch.Tensor, r: int,
                        bits: int = 8):
    """All ``r`` ranks' tiles of ``tp_quant_linear`` in one process, on the
    plain GEMM: returns ``(y, accs)``, ``y`` the (..., N) result in
    ``x.dtype`` and ``accs`` each rank's kernel output in rank order (its
    int32 tile: for the row split the partial product before the int32
    sum).  No data axis: every rank computes every row."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]).to(torch.float32)
    w = w.to(torch.float32)
    k, n = w.shape
    xq, xs = quantize_sym(x2, axis=1, bits=bits)
    if tp_split((k, n), r) == "col":
        accs, ys = [], []
        for i in range(r):
            wq, ws = quantize_sym(_col_tile(w, r, i), axis=0, bits=bits)
            accs.append(ops.quant_matmul_int_ref(xq, wq))
            ys.append(accs[-1].to(torch.float32) * xs[:, None] * ws[None, :])
        y = torch.cat(ys, dim=1)[:, :n]
    else:
        kl = k // r
        wq, ws = quantize_sym(w, axis=0, bits=bits)
        accs = [ops.quant_matmul_int_ref(xq[:, i * kl:(i + 1) * kl],
                                         wq[i * kl:(i + 1) * kl])
                for i in range(r)]
        acc = sum(accs)
        y = acc.to(torch.float32) * xs[:, None] * ws[None, :]
    return y.reshape(*lead, n).to(x.dtype), accs
