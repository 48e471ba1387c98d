"""Optimized serial single-row multiplier (the paper's baseline, §5).

Schoolbook carry-save multiplication with NOT/NOR stateful logic, one gate
per cycle (a crossbar without partitions).  Optimizations (this is the
*optimized* serial baseline the paper compares against — the partition
speedup must be isolated from algorithmic slack):

* ``NOT a_j`` precomputed once (reused by every partial product);
* partial products written straight into the accumulator on iteration 0;
* double-buffered carry-save accumulator — no in-place updates, so no
  copy-backs; finalized low bits are tracked symbolically and never moved;
* degenerate adders (half-adder / bare XOR) wherever an operand is known
  zero at build time;
* contiguous workspace so each inner step re-initializes with ONE range
  init (the same init policy the partitioned versions use — DESIGN.md §2).

The 9-gate NOR full adder: u1=NOR(x,y), u2=NOR(x,u1), u3=NOR(y,u1),
u4=NOR(u2,u3)=XNOR(x,y), u5=NOR(u4,c), u6=NOR(u4,u5), u7=NOR(c,u5),
sum=NOR(u6,u7), cout=NOR(u1,u5).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from repro_torch.core.operation import PartitionConfig
from repro_torch.core.program import Program, ProgramBuilder

__all__ = ["SerialMultiplier", "build_serial_multiplier"]


@dataclasses.dataclass
class SerialMultiplier:
    program: Program
    n_bits: int
    a_cols: Tuple[int, ...]
    b_cols: Tuple[int, ...]
    result_cols: Tuple[int, ...]


def _full_adder(b: ProgramBuilder, x: int, y: int, c: int, u: List[int],
                sum_out: int, cout_out: Optional[int]):
    """9 NOR gates (8 if cout is dropped); u = 7 fresh (initialized) temps."""
    u1, u2, u3, u4, u5, u6, u7 = u
    b.gate("NOR", (x, y), u1)
    b.gate("NOR", (x, u1), u2)
    b.gate("NOR", (y, u1), u3)
    b.gate("NOR", (u2, u3), u4)  # XNOR(x, y)
    b.gate("NOR", (u4, c), u5)
    b.gate("NOR", (u4, u5), u6)
    b.gate("NOR", (c, u5), u7)
    b.gate("NOR", (u6, u7), sum_out)  # x ^ y ^ c
    if cout_out is not None:
        b.gate("NOR", (u1, u5), cout_out)  # majority(x, y, c)


def _half_adder(b: ProgramBuilder, x: int, y: int, v: List[int], sum_out: int,
                cout_out: Optional[int]):
    """6 NOR/NOT gates (5 without cout); v = 4 fresh temps."""
    v1, v2, v3, v4 = v
    b.gate("NOR", (x, y), v1)
    b.gate("NOR", (x, v1), v2)
    b.gate("NOR", (y, v1), v3)
    b.gate("NOR", (v2, v3), v4)  # XNOR
    b.gate("NOT", (v4,), sum_out)  # x ^ y
    if cout_out is not None:
        b.gate("NOR", (v1, sum_out), cout_out)  # x & y = NOR(NOR(x,y), XOR(x,y))


def build_serial_multiplier(n_bits: int = 32, n_cols: int = 1024,
                            k: int = 32) -> SerialMultiplier:
    """N-bit x N-bit -> 2N-bit product in a single row, one gate per cycle."""
    n = n_bits
    cfg = PartitionConfig(n_cols, k)
    b = ProgramBuilder(cfg, "baseline")

    # -- column layout -------------------------------------------------------
    A = list(range(0, n))
    B = list(range(n, 2 * n))
    NA = list(range(2 * n, 3 * n))
    NB = 3 * n
    # workspace: [PP, U1..U7] contiguous for one-range inits
    PP = 3 * n + 1
    U = list(range(3 * n + 2, 3 * n + 9))
    base = 3 * n + 9
    S = [list(range(base, base + 2 * n)),
         list(range(base + 2 * n, base + 4 * n))]
    C = [list(range(base + 4 * n, base + 6 * n + 1)),
         list(range(base + 6 * n + 1, base + 8 * n + 2))]
    assert C[1][-1] < n_cols, "layout exceeds crossbar width"

    # symbolic accumulator: position -> column (None = known zero)
    s_col: Dict[int, Optional[int]] = {}
    c_col: Dict[int, Optional[int]] = {}

    # -- NOT(a) once ---------------------------------------------------------
    b.init_range(NA[0], NA[-1], "init-na")
    for j in range(n):
        b.gate("NOT", (A[j],), NA[j], "na")

    # -- iteration 0: partial products straight into the accumulator --------
    w = 1  # write parity of iteration i is (i+1) % 2
    b.init_range(NB, NB, "init-nb")
    b.gate("NOT", (B[0],), NB, "nb")
    b.init_range(S[w][0], S[w][n - 1], "init-s0")
    for j in range(n):
        b.gate("NOR", (NA[j], NB), S[w][j], "pp0")  # a_j & b_0
        s_col[j] = S[w][j]

    # -- iterations 1..N-1 ---------------------------------------------------
    for i in range(1, n):
        w = (i + 1) % 2
        b.init_range(NB, NB)
        b.gate("NOT", (B[i],), NB, "nb")
        # fresh window of the write-parity buffers
        b.init_range(S[w][i], S[w][i + n - 1], "init-sw")
        b.init_range(C[w][i + 1], C[w][i + n], "init-cw")
        # carry-save semantics: every adder in this iteration reads the
        # PREVIOUS iteration's carries; new carries become visible next
        # iteration (they live in the other parity's columns anyway).
        new_s: Dict[int, Optional[int]] = {}
        new_c: Dict[int, Optional[int]] = {}
        for j in range(n):
            pos = i + j
            s = s_col.get(pos)
            c = c_col.get(pos)
            sum_out = S[w][pos]
            cout_out = C[w][pos + 1]
            if s is None and c is None:
                # bare partial product (top position, first time touched)
                b.gate("NOR", (NA[j], NB), sum_out, "pp-top")
                new_c[pos + 1] = None
            elif c is None or s is None:
                other = s if c is None else c
                b.init_range(PP, U[3])  # PP + 4 temps
                b.gate("NOR", (NA[j], NB), PP, "pp")
                _half_adder(b, other, PP, U[:4], sum_out, cout_out)
                new_c[pos + 1] = cout_out
            else:
                b.init_range(PP, U[-1])  # PP + 7 temps
                b.gate("NOR", (NA[j], NB), PP, "pp")
                _full_adder(b, s, PP, c, U, sum_out, cout_out)
                new_c[pos + 1] = cout_out
            new_s[pos] = sum_out
        s_col.update(new_s)
        c_col.update(new_c)

    # -- final carry-propagate over positions N..2N-1 ------------------------
    # Iteration N-1 wrote parity n % 2; its S/C entries are the live operands,
    # so the final outputs go to the OTHER parity (stale above position n).
    fin = (n + 1) % 2
    CARRY: Optional[int] = None  # ripple carry column (None = zero)
    for pos in range(n, 2 * n):
        s = s_col.get(pos)
        c = c_col.get(pos)
        sum_out = S[fin][pos]
        cout_out = C[fin][pos + 1] if pos + 1 < 2 * n else None
        terms = [t for t in (s, c, CARRY) if t is not None]
        b.init_range(S[fin][pos], S[fin][pos])
        if cout_out is not None:
            b.init_range(C[fin][pos + 1], C[fin][pos + 1])
        if len(terms) == 3:
            b.init_range(PP, U[-1])
            _full_adder(b, terms[0], terms[1], terms[2], U, sum_out, cout_out)
        elif len(terms) == 2:
            b.init_range(PP, U[3])
            _half_adder(b, terms[0], terms[1], U[:4], sum_out, cout_out)
        elif len(terms) == 1:
            b.init_range(PP, PP)
            b.gate("NOT", (terms[0],), PP)  # copy via double NOT
            b.gate("NOT", (PP,), sum_out)
            cout_out = None
        else:
            cout_out = None  # stays zero; sum bit is zero -> handled by read
        s_col[pos] = sum_out if terms else None
        CARRY = cout_out

    result = tuple(
        s_col[p] if s_col.get(p) is not None else NB  # NB never ends as result
        for p in range(2 * n)
    )
    # positions with no column are structurally zero; map them to a column we
    # force to zero at the end (cheap: one init + one NOT of an init'd col).
    if any(s_col.get(p) is None for p in range(2 * n)):
        zero = PP
        b.init_range(U[0], U[0])
        b.init_range(zero, zero)
        b.gate("NOT", (U[0],), zero)  # NOT(1) = 0
        result = tuple(
            s_col[p] if s_col.get(p) is not None else zero for p in range(2 * n)
        )

    prog = b.program
    prog.name = f"serial-mult-{n}b"
    return SerialMultiplier(
        program=prog,
        n_bits=n,
        a_cols=tuple(A),
        b_cols=tuple(B),
        result_cols=result,
    )
