"""Serial multiplier reducing two partial-product rows per pass (4:2).

IMPLY/MAGIC-style serial multipliers reduce one partial-product row per
iteration (3:2 carry-save).  The serial 4:2-compressor design
(arXiv 2407.09980) instead consumes TWO multiplier bits per pass: at each
product position the compressor folds (s, c, ppA, ppB) plus a
chained carry-in into one sum bit, one saved carry, and a carry-out —
and because the chain carry-out comes from the FIRST of the two stacked
adders it is independent of the carry-in, so positions chain without a
ripple dependency:

    stage 1:  FA(ppA, ppB, s)   -> t,   cout  (the position chain)
    stage 2:  FA(t,   c,   cin) -> sum, carry (saved for the next pass)

Both stages use the 7-gate NAND/OR/AND full adder from
``mult_serial_fast``; stages degrade to half adders / copies wherever an
operand is known zero at build time.  Halving the pass count amortizes
the accumulator bookkeeping: ~35% fewer cycles than the NOR serial
baseline at 32 bits.  Bit-exact N x N -> 2N for any N >= 2 (odd widths
run one final single-row 3:2 pass).

Layout invariants (why the carry routing below is safe):

* a pass over bits (i, i+1) touches positions [i, i+n+1] and writes saved
  carries only at positions >= i+2 — positions i, i+1 finalize during the
  pass (their residual carry rides the chain), so nothing is ever dropped
  when the next pass's window starts at i+2;
* the accumulator is double-buffered by pass parity; every live (s, c)
  entry is rewritten each pass it stays in-window, so reads always hit
  the immediately-previous parity plane.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from repro_torch.core.operation import PartitionConfig
from repro_torch.core.program import ProgramBuilder
from repro_torch.pim.mult_serial import SerialMultiplier
from repro_torch.pim.mult_serial_fast import fast_full_adder, fast_half_adder

__all__ = ["build_compressor42_multiplier"]


def _reduce(b: ProgramBuilder, terms: List[int], t: List[int], sum_out: int,
            cout_out: Optional[int]):
    """Fold 1-3 live terms into sum_out (+ optional carry)."""
    if len(terms) == 3:
        fast_full_adder(b, terms[0], terms[1], terms[2], t, sum_out, cout_out)
    elif len(terms) == 2:
        fast_half_adder(b, terms[0], terms[1], t[:2], sum_out, cout_out)
    else:
        b.gate("AND", (terms[0], terms[0]), sum_out)  # 1-gate copy


def build_compressor42_multiplier(n_bits: int = 32, n_cols: int = 1024,
                                  k: int = 32) -> SerialMultiplier:
    """N-bit x N-bit -> 2N-bit product, two multiplier bits per pass."""
    n = n_bits
    if n < 2:
        raise ValueError("compressor42 multiplier needs n_bits >= 2")
    cfg = PartitionConfig(n_cols, k)
    b = ProgramBuilder(cfg, "baseline")

    # -- column layout -------------------------------------------------------
    A = list(range(0, n))
    B = list(range(n, 2 * n))
    # workspace strip [PPA, PPB, TS, T1..T5, T6..T10]: one-range inits
    PPA = 2 * n
    PPB = 2 * n + 1
    TS = 2 * n + 2              # stage-1 sum
    T1 = list(range(2 * n + 3, 2 * n + 8))   # stage-1 temps
    T2 = list(range(2 * n + 8, 2 * n + 13))  # stage-2 temps
    STRIP_HI = T2[-1]
    CC = [2 * n + 13, 2 * n + 14]  # chain carry, alternating by position
    base = 2 * n + 15
    S = [list(range(base, base + 2 * n)),
         list(range(base + 2 * n, base + 4 * n))]
    C = [list(range(base + 4 * n, base + 6 * n)),
         list(range(base + 6 * n, base + 8 * n))]
    assert C[1][-1] < n_cols, "layout exceeds crossbar width"

    # symbolic accumulator: position -> column (None = known zero)
    s_col: Dict[int, Optional[int]] = {}
    c_col: Dict[int, Optional[int]] = {}

    groups: List[Tuple[int, ...]] = [(i, i + 1) for i in range(0, n - 1, 2)]
    if n % 2:
        groups.append((n - 1,))

    for t_idx, bits in enumerate(groups):
        i = bits[0]
        w = (t_idx + 1) % 2  # write parity; reads hit parity t_idx % 2
        lo, hi = i, min(i + n + len(bits) - 1, 2 * n - 1)
        b.init_range(S[w][lo], S[w][hi], "init-sw")
        clo, chi = i + 2, min(i + n, 2 * n - 1)
        if clo <= chi:
            b.init_range(C[w][clo], C[w][chi], "init-cw")
        new_s: Dict[int, Optional[int]] = {}
        new_c: Dict[int, Optional[int]] = {}
        chain: Optional[int] = None  # carry column riding to pos+1
        for pos in range(lo, hi + 1):
            jA = pos - bits[0]
            jB = pos - bits[1] if len(bits) > 1 else -1
            has_ppA = 0 <= jA < n
            has_ppB = 0 <= jB < n
            s = s_col.get(pos)
            c = c_col.get(pos)
            cin = chain
            total = sum(x is not None for x in (s, c, cin)) + has_ppA + has_ppB
            if total == 0:
                new_s[pos] = None
                chain = None
                continue
            b.init_range(PPA, STRIP_HI)
            ppA = ppB = None
            if has_ppA:
                b.gate("AND", (A[jA], B[bits[0]]), PPA, "ppA")
                ppA = PPA
            if has_ppB:
                b.gate("AND", (A[jB], B[bits[1]]), PPB, "ppB")
                ppB = PPB
            sum_out = S[w][pos]
            cc = CC[pos % 2]  # never the column holding cin = CC[(pos-1)%2]
            if total <= 3:
                # one 3:2 stage; the carry rides the chain so it can never
                # land below the next pass's carry window.
                terms = [x for x in (ppA, ppB, s, c, cin) if x is not None]
                cout = None
                if len(terms) >= 2:
                    b.init_range(cc, cc)
                    cout = cc
                _reduce(b, terms, T1, sum_out, cout)
                chain = cout
            else:
                # full 4:2 compressor: stage 1 on (ppA, ppB, s) chains its
                # cout; stage 2 folds (t, c, cin) and saves its carry.
                g1 = [x for x in (ppA, ppB, s) if x is not None]
                b.init_range(cc, cc)
                _reduce(b, g1, T1, TS, cc)
                g2 = [x for x in (TS, c, cin) if x is not None]
                carry_out = C[w][pos + 1] if pos + 1 <= 2 * n - 1 else None
                _reduce(b, g2, T2, sum_out, carry_out)
                if carry_out is not None:
                    new_c[pos + 1] = carry_out
                chain = cc
            new_s[pos] = sum_out
        assert chain is None, "pass carry chain must terminate in-window"
        for pos in range(lo, hi + 1):
            s_col[pos] = new_s.get(pos)
        # every carry in [lo, chi+1] was either consumed this pass or
        # regenerated into new_c; stale entries below clo must clear too.
        for pos in range(lo, min(chi + 2, 2 * n)):
            c_col[pos] = new_c.get(pos)

    # -- final carry-propagate over positions still in redundant form --------
    # The last pass wrote parity len(groups) % 2; final sums go to the OTHER
    # plane (stale in range), and the ripple carry rides the free CC columns.
    live_c = [p for p in range(2 * n) if c_col.get(p) is not None]
    if live_c:
        fin = (len(groups) + 1) % 2
        CARRY: Optional[int] = None
        for pos in range(min(live_c), 2 * n):
            s = s_col.get(pos)
            c = c_col.get(pos)
            sum_out = S[fin][pos]
            terms = [x for x in (s, c, CARRY) if x is not None]
            if not terms:
                s_col[pos] = None
                CARRY = None
                continue
            b.init_range(S[fin][pos], S[fin][pos])
            b.init_range(PPA, STRIP_HI)
            cout_out = None
            if len(terms) >= 2 and pos + 1 < 2 * n:
                cout_out = CC[pos % 2]
                b.init_range(cout_out, cout_out)
            _reduce(b, terms, T1, sum_out, cout_out)
            s_col[pos] = sum_out
            CARRY = cout_out

    result = tuple(
        s_col[p] if s_col.get(p) is not None else PPA for p in range(2 * n)
    )
    if any(s_col.get(p) is None for p in range(2 * n)):
        zero = PPA
        b.init_range(T1[0], T1[0])
        b.init_range(zero, zero)
        b.gate("NOT", (T1[0],), zero)  # NOT(1) = 0
        result = tuple(
            s_col[p] if s_col.get(p) is not None else zero for p in range(2 * n)
        )

    prog = b.program
    prog.name = f"compressor42-mult-{n}b"
    return SerialMultiplier(
        program=prog,
        n_bits=n,
        a_cols=tuple(A),
        b_cols=tuple(B),
        result_cols=result,
    )
