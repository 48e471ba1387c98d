"""Fast serial single-row multiplier using the extended FELIX gate set.

Same schoolbook carry-save schedule as ``mult_serial`` (the paper's
optimized NOT/NOR baseline), but built on the richer stateful gate set
(AND/NAND/OR) that memristive serial-multiplier follow-up work exploits
(arXiv 2410.09953): a partial product is a single ``AND(a_j, b_i)`` — no
precomputed operand complements at all — and the full adder drops from
9 NOR gates to 7 mixed gates:

    t1 = NAND(x, y)          t4 = NAND(t3, c)
    t2 = OR(x, y)            t5 = OR(t3, c)
    t3 = AND(t1, t2) = x^y   sum  = AND(t4, t5) = x^y^c
                             cout = NAND(t1, t4) = xy + c(x^y)

and the half adder to 4 gates (NAND/OR/AND for the XOR, one AND for the
carry).  Everything else — double-buffered carry-save accumulator,
symbolic known-zero tracking, one-range-init workspace — matches the
reference serial multiplier, so cycle savings are purely the gate-count
win (~25-30% at 32 bits).  Bit-exact N x N -> 2N.
"""
from __future__ import annotations

from typing import Dict, List, Optional

from repro_torch.core.operation import PartitionConfig
from repro_torch.core.program import ProgramBuilder
from repro_torch.pim.mult_serial import SerialMultiplier

__all__ = ["build_fast_serial_multiplier", "fast_full_adder",
           "fast_half_adder"]


def fast_full_adder(b: ProgramBuilder, x: int, y: int, c: int, t: List[int],
                    sum_out: int, cout_out: Optional[int]):
    """7 mixed gates (6 if cout is dropped); t = 5 fresh (initialized) temps."""
    t1, t2, t3, t4, t5 = t
    b.gate("NAND", (x, y), t1)
    b.gate("OR", (x, y), t2)
    b.gate("AND", (t1, t2), t3)  # x ^ y
    b.gate("NAND", (t3, c), t4)
    b.gate("OR", (t3, c), t5)
    b.gate("AND", (t4, t5), sum_out)  # x ^ y ^ c
    if cout_out is not None:
        b.gate("NAND", (t1, t4), cout_out)  # majority(x, y, c)


def fast_half_adder(b: ProgramBuilder, x: int, y: int, t: List[int],
                    sum_out: int, cout_out: Optional[int]):
    """4 mixed gates (3 without cout); t = 2 fresh temps."""
    t1, t2 = t
    b.gate("NAND", (x, y), t1)
    b.gate("OR", (x, y), t2)
    b.gate("AND", (t1, t2), sum_out)  # x ^ y
    if cout_out is not None:
        b.gate("AND", (x, y), cout_out)


def build_fast_serial_multiplier(n_bits: int = 32, n_cols: int = 1024,
                                 k: int = 32) -> SerialMultiplier:
    """N-bit x N-bit -> 2N-bit product in a single row, one gate per cycle."""
    n = n_bits
    cfg = PartitionConfig(n_cols, k)
    b = ProgramBuilder(cfg, "baseline")

    # -- column layout -------------------------------------------------------
    A = list(range(0, n))
    B = list(range(n, 2 * n))
    # workspace: [PP, T1..T5] contiguous for one-range inits
    PP = 2 * n
    T = list(range(2 * n + 1, 2 * n + 6))
    base = 2 * n + 6
    S = [list(range(base, base + 2 * n)),
         list(range(base + 2 * n, base + 4 * n))]
    C = [list(range(base + 4 * n, base + 6 * n + 1)),
         list(range(base + 6 * n + 1, base + 8 * n + 2))]
    assert C[1][-1] < n_cols, "layout exceeds crossbar width"

    # symbolic accumulator: position -> column (None = known zero)
    s_col: Dict[int, Optional[int]] = {}
    c_col: Dict[int, Optional[int]] = {}

    # -- iteration 0: partial products straight into the accumulator --------
    w = 1  # write parity of iteration i is (i+1) % 2
    b.init_range(S[w][0], S[w][n - 1], "init-s0")
    for j in range(n):
        b.gate("AND", (A[j], B[0]), S[w][j], "pp0")  # a_j & b_0
        s_col[j] = S[w][j]

    # -- iterations 1..N-1 ---------------------------------------------------
    for i in range(1, n):
        w = (i + 1) % 2
        # fresh window of the write-parity buffers
        b.init_range(S[w][i], S[w][i + n - 1], "init-sw")
        b.init_range(C[w][i + 1], C[w][i + n], "init-cw")
        # carry-save semantics: adders read the PREVIOUS iteration's carries;
        # new carries become visible next iteration (other parity's columns).
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
                b.gate("AND", (A[j], B[i]), sum_out, "pp-top")
                new_c[pos + 1] = None
            elif c is None or s is None:
                other = s if c is None else c
                b.init_range(PP, T[1])  # PP + 2 temps
                b.gate("AND", (A[j], B[i]), PP, "pp")
                fast_half_adder(b, other, PP, T[:2], sum_out, cout_out)
                new_c[pos + 1] = cout_out
            else:
                b.init_range(PP, T[-1])  # PP + 5 temps
                b.gate("AND", (A[j], B[i]), PP, "pp")
                fast_full_adder(b, s, PP, c, T, sum_out, cout_out)
                new_c[pos + 1] = cout_out
            new_s[pos] = sum_out
        s_col.update(new_s)
        c_col.update(new_c)

    # -- final carry-propagate over positions N..2N-1 ------------------------
    # Iteration N-1 wrote parity n % 2; the final outputs go to the OTHER
    # parity (stale above position n).
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
            b.init_range(PP, T[-1])
            fast_full_adder(b, terms[0], terms[1], terms[2], T, sum_out,
                            cout_out)
        elif len(terms) == 2:
            b.init_range(PP, T[1])
            fast_half_adder(b, terms[0], terms[1], T[:2], sum_out, cout_out)
        elif len(terms) == 1:
            b.gate("AND", (terms[0], terms[0]), sum_out)  # 1-gate copy
            cout_out = None
        else:
            cout_out = None  # stays zero; sum bit is zero -> handled by read
        s_col[pos] = sum_out if terms else None
        CARRY = cout_out

    result = tuple(
        s_col[p] if s_col.get(p) is not None else PP  # placeholder
        for p in range(2 * n)
    )
    # positions with no column are structurally zero; map them to a column we
    # force to zero at the end (one init + one NOT of an init'd col).
    if any(s_col.get(p) is None for p in range(2 * n)):
        zero = PP
        b.init_range(T[0], T[0])
        b.init_range(zero, zero)
        b.gate("NOT", (T[0],), zero)  # NOT(1) = 0
        result = tuple(
            s_col[p] if s_col.get(p) is not None else zero for p in range(2 * n)
        )

    prog = b.program
    prog.name = f"fast-serial-mult-{n}b"
    return SerialMultiplier(
        program=prog,
        n_bits=n,
        a_cols=tuple(A),
        b_cols=tuple(B),
        result_cols=result,
    )
