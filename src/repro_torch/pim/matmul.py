"""PIM GEMM: lowering integer matrix multiplication onto crossbar rows.

Throughput-oriented mapping (single-row arithmetic, §1 of the paper): each
*simulator row* computes one output element ``y[m, o] = sum_i x[m, i] * w[o, i]``
— the (m, o) grid is flattened across rows and crossbars, so the whole GEMM
runs at ``rows x crossbars`` way parallelism while the per-row program is a
sequence of ``K`` multiply-accumulate steps:

    for i in range(K):
        copy x_i, w_i  ->  multiplier input columns    (parallel copies)
        MultPIM multiply (partitioned, model-specific)
        ripple-add the 2N-bit product into the accumulator

The multiply is the partition-accelerated part (the paper's case study);
copies and the accumulate ride along.  This module is the *synthesis* side
only: it lowers the arithmetic into a validated :class:`Program` through the
shared :class:`~repro_torch.core.program.ProgramBuilder` API.  Compilation
caching and execution live in ``repro_torch.pim.engine`` — call
:func:`repro_torch.pim.engine.compile_dot` (or ``engine.matmul_int``)
rather than rebuilding programs per call.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.core.operation import GateOp, PartitionConfig
from repro_torch.core.program import Program, ProgramBuilder
from repro_torch.pim.multpim import Layout, build_multpim

__all__ = ["PimDot", "build_dot", "max_dot_terms", "pim_matmul_int"]


def _dot_layout(n_terms: int, n_bits: int, k: int):
    """(acc_width, n_acc, need): the intra columns a dot of ``n_terms``
    needs beyond the multiplier layout — THE budget formula, shared by
    :func:`build_dot` (allocation) and :func:`max_dot_terms` (chunking)."""
    acc_width = 2 * n_bits + max(1, (n_terms - 1).bit_length())
    n_acc = (acc_width + k - 1) // k  # intra columns per accumulator plane
    # planes: ACCS/ACCC (current sum/carry) + NACCS/NACCC (next) + result,
    # plus the operand column pairs and the 14-column serial scratch strip
    need = 2 * n_terms + 5 * n_acc + 14
    return acc_width, n_acc, need


def max_dot_terms(n_bits: int = 8, n_cols: int = 1024) -> int:
    """Largest ``n_terms`` whose dot program fits one row's column budget.

    Uses :func:`build_dot`'s own layout arithmetic without building
    anything; the engine uses it to split long inner dimensions into
    chunked GEMMs whose partials are summed exactly on the host.
    """
    k = n_bits
    base = Layout.make(k)["width"]
    m = n_cols // k
    best = 0
    for t in range(1, m):
        if base + _dot_layout(t, n_bits, k)[2] <= m:
            best = t
        else:
            break
    return best


@dataclasses.dataclass
class PimDot:
    program: Program
    n_bits: int
    n_terms: int
    x_cols: Tuple[Tuple[int, ...], ...]  # x_cols[i] = columns of term i of x
    w_cols: Tuple[Tuple[int, ...], ...]
    acc_cols: Tuple[int, ...]            # accumulator (2N + log2(K) bits)


def _ripple_add(b: ProgramBuilder, x_cols, y_cols, out_cols, tmp, width_x,
                width_y, model: str, cfg: PartitionConfig):
    """out = x + y (serial single-gate FA chain; legal in every model).

    ``tmp``: >= 14 scratch columns in ONE partition — tmp[0:7] FA internals
    (re-initialized per position), tmp[7]/tmp[8] alternating carry columns (a
    carry must survive into the next position's adder, so it cannot share the
    re-init strip), tmp[9] constant-one scratch, tmp[10:14] operand
    localization slots.

    *No Split-Input* (paper §3.1, fn. 3) applies to serial gates too: under
    standard/minimal, a NOR's two inputs must share a partition, so operands
    are first copied (double-NOT) into the scratch partition.  The unlimited
    model permits split inputs and skips the copies.
    """
    split_ok = model in ("unlimited", "baseline")
    part = cfg.partition

    def localize(val, slot_a, slot_b):
        """Copy ``val`` into the scratch partition (2 NOTs); returns column."""
        b.init_range(slot_a, slot_a)
        b.gate("NOT", (val,), slot_a)
        b.init_range(slot_b, slot_b)
        b.gate("NOT", (slot_a,), slot_b)
        return slot_b

    carry: Optional[int] = None
    for p, out in enumerate(out_cols):
        x = x_cols[p] if p < width_x else None
        y = y_cols[p] if p < width_y else None
        if not split_ok:
            home = part(tmp[0])
            if x is not None and part(x) != home:
                x = localize(x, tmp[10], tmp[11])
            if y is not None and part(y) != home:
                y = localize(y, tmp[12], tmp[13])
        terms = [t for t in (x, y, carry) if t is not None]
        cout = tmp[7] if p % 2 == 0 else tmp[8]
        b.init_range(out, out)
        if len(terms) == 0:
            b.init_range(tmp[9], tmp[9])
            b.gate("NOT", (tmp[9],), out)  # NOT(1) = 0
            carry = None
            continue
        b.init_range(tmp[0], tmp[6])
        if len(terms) == 1:
            b.gate("NOT", (terms[0],), tmp[0])
            b.gate("NOT", (tmp[0],), out)
            carry = None
            continue
        b.init_range(cout, cout)
        if len(terms) == 2:
            t0, t1 = terms
            b.gate("NOR", (t0, t1), tmp[0])
            b.gate("NOR", (t0, tmp[0]), tmp[1])
            b.gate("NOR", (t1, tmp[0]), tmp[2])
            b.gate("NOR", (tmp[1], tmp[2]), tmp[3])  # XNOR
            b.gate("NOT", (tmp[3],), tmp[4])         # XOR (local copy)
            b.gate("NOT", (tmp[3],), out)            # XOR -> output column
            b.gate("NOR", (tmp[0], tmp[4]), cout)    # AND = NOR(NOR, XOR)
        else:
            t0, t1, t2 = terms
            b.gate("NOR", (t0, t1), tmp[0])
            b.gate("NOR", (t0, tmp[0]), tmp[1])
            b.gate("NOR", (t1, tmp[0]), tmp[2])
            b.gate("NOR", (tmp[1], tmp[2]), tmp[3])  # XNOR(t0,t1)
            b.gate("NOR", (tmp[3], t2), tmp[4])
            b.gate("NOR", (tmp[3], tmp[4]), tmp[5])
            b.gate("NOR", (t2, tmp[4]), tmp[6])
            b.gate("NOR", (tmp[5], tmp[6]), out)     # sum
            b.gate("NOR", (tmp[0], tmp[4]), cout)    # majority
        carry = cout


def build_dot(n_terms: int, n_bits: int = 8, n_cols: int = 1024,
              model: str = "minimal", accumulate: str = "carry_save") -> PimDot:
    """Dot product of ``n_terms`` pairs of N-bit ints in a single row.

    ``accumulate="carry_save"`` (default, beyond-paper optimization): each
    product is folded into a redundant (sum, carry) accumulator with one 3:2
    compression — a handful of *parallel* partition operations per term —
    and a single ripple carry-propagate at the very end.  ``"ripple"`` is
    the naive serial accumulate (kept for the §Perf before/after).
    """
    N = n_bits
    core = build_multpim(N, n_cols, model=model)
    cfg = core.program.cfg
    k = cfg.k
    L = core.layout
    m = cfg.m
    col = cfg.col

    base = L["width"]
    acc_width, n_acc, need = _dot_layout(n_terms, N, k)
    if base + need > m:
        raise ValueError(
            f"layout overflow: {base + need} > {m} intra columns "
            f"(reduce n_terms or n_bits)")
    X = [base + 2 * i for i in range(n_terms)]
    W = [base + 2 * i + 1 for i in range(n_terms)]
    ACCS = base + 2 * n_terms
    ACCC = ACCS + n_acc
    NACCS = ACCC + n_acc
    NACCC = NACCS + n_acc
    RES = NACCC + n_acc
    TMP = RES + n_acc                  # serial scratch strip (14 columns)

    b = ProgramBuilder(cfg, model, name=f"pim-dot-{n_terms}x{N}b")
    prog = b.program

    def plane(intra0):
        # bit p -> (partition p % k, intra intra0 + p // k)
        return tuple(col(p % k, intra0 + p // k) for p in range(acc_width))

    mult_ops = core.program.ops
    prod_cols = core.result_cols
    prod_intra = (L["R"], L["R2"])  # product bit p: (partition p%k, group p//k)
    U, PP, NZ = L["U"], L["PP"], 3  # multiplier scratch reused between runs

    cur_s, cur_c = ACCS, ACCC
    nxt_s, nxt_c = NACCS, NACCC

    def copy_in(i):
        """Copy term operands into the multiplier input columns (parallel)."""
        b.init_periodic(PP, PP, 0, k - 1, label="cp-init")
        b.par([GateOp("NOT", (col(j, X[i]),), col(j, PP)) for j in range(k)],
              "cp-x1")
        b.init_periodic(Layout.IA, Layout.IB, 0, k - 1, label="cp-init2")
        b.par([GateOp("NOT", (col(j, PP),), col(j, Layout.IA))
               for j in range(k)], "cp-x2")
        b.init_periodic(PP, PP, 0, k - 1)
        b.par([GateOp("NOT", (col(j, W[i]),), col(j, PP)) for j in range(k)],
              "cp-w1")
        b.par([GateOp("NOT", (col(j, PP),), col(j, Layout.IB))
               for j in range(k)], "cp-w2")

    def group_positions(g):
        return [j for j in range(k) if g * k + j < acc_width]

    def csa_term():
        """(nxt_s, nxt_c) = 3:2 compress (cur_s, product, cur_c)."""
        b.init_periodic(nxt_s, nxt_c + n_acc - 1, 0, k - 1, label="csa-init")
        # position 0 has no carry-in producer: set nxt_c plane bit 0 to 0
        b.gate("NOT", (col(0, NZ),), col(0, nxt_c), "c0-zero")
        for g in range(n_acc):
            js = group_positions(g)
            b.init_periodic(PP, U + 6, 0, k - 1, label="csa-u-init")
            s_i, c_i = cur_s + g, cur_c + g
            so, co = nxt_s + g, nxt_c + g
            if g < 2:
                y_i = prod_intra[g]
                # u1..u7 of the NOR full adder, parallel across the group
                pg = lambda gate, ins, out: b.par(
                    [GateOp(gate, tuple(col(j, ii) for ii in ins), col(j, out))
                     for j in js])
                pg("NOR", (s_i, y_i), U + 0)
                pg("NOR", (s_i, U + 0), U + 1)
                pg("NOR", (y_i, U + 0), U + 2)
                pg("NOR", (U + 1, U + 2), U + 3)
                pg("NOR", (U + 3, c_i), U + 4)
                pg("NOR", (U + 3, U + 4), U + 5)
                pg("NOR", (c_i, U + 4), U + 6)
                pg("NOR", (U + 5, U + 6), so)          # sum stays in place
                cout_src = (U + 0, U + 4)
            else:
                # no product bits here: half-add (cur_s, cur_c)
                pg = lambda gate, ins, out: b.par(
                    [GateOp(gate, tuple(col(j, ii) for ii in ins), col(j, out))
                     for j in js])
                pg("NOR", (s_i, c_i), U + 0)
                pg("NOR", (s_i, U + 0), U + 1)
                pg("NOR", (c_i, U + 0), U + 2)
                pg("NOR", (U + 1, U + 2), U + 3)       # XNOR
                pg("NOT", (U + 3,), so)                # XOR
                # cout = AND = NOR(NOR(s,c), XOR(s,c)), emitted directly by
                # the cross-partition carry gates below
                cout_src = (U + 0, so)

            # carries go one position left: partition j -> j+1 (even/odd),
            # group boundary j=k-1 -> partition 0 of the next plane
            def cgate(j):
                tgt_p, tgt_i = (j + 1, co) if j + 1 < k else (0, nxt_c + g + 1)
                if g * k + j + 1 >= acc_width:
                    return None
                if len(cout_src) == 2:
                    return GateOp("NOR", (col(j, cout_src[0]),
                                          col(j, cout_src[1])),
                                  col(tgt_p, tgt_i))
                return GateOp("NOT", (col(j, cout_src[0]),), col(tgt_p, tgt_i))

            even = [cgate(j) for j in js if j % 2 == 0 and j + 1 < k]
            odd = [cgate(j) for j in js if j % 2 == 1 and j + 1 < k]
            even = [g_ for g_ in even if g_ is not None]
            odd = [g_ for g_ in odd if g_ is not None]
            if even:
                b.par(even, "csa-cout-even")
            if odd:
                b.par(odd, "csa-cout-odd")
            top = cgate(k - 1)
            if top is not None and k - 1 in js:
                b.par([top], "csa-cout-wrap")

    first = True
    for i in range(n_terms):
        copy_in(i)
        prog.ops.extend(mult_ops)  # the partition-accelerated multiply
        tmp = [col(0, TMP + t) for t in range(14)]
        if accumulate == "ripple":
            cur = plane(cur_s)
            nxt = plane(nxt_s)
            if first:
                for p in range(acc_width):
                    b.init_range(nxt[p], nxt[p])
                    b.init_range(tmp[0], tmp[0])
                    if p < 2 * N:
                        b.gate("NOT", (prod_cols[p],), tmp[0])
                        b.gate("NOT", (tmp[0],), nxt[p])
                    else:
                        b.gate("NOT", (tmp[0],), nxt[p])
                first = False
            else:
                _ripple_add(b, prod_cols, cur, nxt, tmp, 2 * N, acc_width,
                            model, cfg)
            cur_s, nxt_s = nxt_s, cur_s
            continue
        if first:
            # acc := product; carries := 0 (parallel copies per plane)
            b.init_periodic(cur_s, cur_c + n_acc - 1, 0, k - 1,
                            label="acc0-init")
            for g in range(n_acc):
                js = group_positions(g)
                b.init_periodic(PP, PP, 0, k - 1)
                if g < 2:
                    b.par([GateOp("NOT", (col(j, prod_intra[g]),), col(j, PP))
                           for j in js])
                    b.par([GateOp("NOT", (col(j, PP),), col(j, cur_s + g))
                           for j in js])
                else:
                    b.par([GateOp("NOT", (col(j, NZ),), col(j, cur_s + g))
                           for j in js])
                b.par([GateOp("NOT", (col(j, NZ),), col(j, cur_c + g))
                       for j in js])
            first = False
        else:
            csa_term()
            cur_s, nxt_s = nxt_s, cur_s
            cur_c, nxt_c = nxt_c, cur_c

    # final resolution: result = acc_s + acc_c (single ripple pass)
    if accumulate == "carry_save":
        tmp = [col(0, TMP + t) for t in range(14)]
        _ripple_add(b, plane(cur_s), plane(cur_c), plane(RES), tmp,
                    acc_width, acc_width, model, cfg)
        out_cols = plane(RES)
    else:
        out_cols = plane(cur_s)

    prog.name = f"pim-dot-{n_terms}x{N}b-{model}-{accumulate}"
    return PimDot(
        program=prog,
        n_bits=N,
        n_terms=n_terms,
        x_cols=tuple(tuple(col(j, X[i]) for j in range(N))
                     for i in range(n_terms)),
        w_cols=tuple(tuple(col(j, W[i]) for j in range(N))
                     for i in range(n_terms)),
        acc_cols=out_cols,
    )



def pim_matmul_int(x: torch.Tensor, w: torch.Tensor, n_bits: int = 8,
                   model: str = "minimal", rows_per_crossbar: int = 256,
                   backend: Optional[str] = None) -> torch.Tensor:
    """Bit-exact integer GEMM on the simulated crossbars.

    x: (M, K) uint, w: (O, K) uint -> (M, O) int64 on their device.  Each
    (m, o) output is one simulator row; rows are packed 32 per word and
    split across crossbars.

    Compatibility wrapper over ``repro_torch.pim.engine.matmul_int``: the
    gate program is compiled through the engine cache (once per
    ``(K, n_bits, model)``) and executed on the selected state backend
    (``None``: the device's own).
    """
    from repro_torch.pim import engine

    return engine.matmul_int(x, w, n_bits, model=model,
                             rows_per_crossbar=rows_per_crossbar,
                             backend=backend)
