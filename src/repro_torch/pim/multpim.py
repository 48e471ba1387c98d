"""Partitioned single-row multiplication (MultPIM [14], rebuilt on the
unlimited / standard / minimal models of PartitionPIM).

``k = N`` partitions multiply two N-bit numbers per row with carry-save
accumulation sliced across partitions.  Invariant at the start of iteration
``i``: partition ``j`` holds the accumulator sum/carry of weight ``i + j``.
Each iteration:

1. **broadcast** ``NOT b_i`` from partition ``i`` to all partitions in
   ``log2(k)`` grid-doubling stages (MultPIM's logarithmic broadcast), each
   stage a *periodic* semi-parallel operation (distance ``d``, period
   ``2d``) — legal in every model including minimal;
2. **partial product** ``pp_j = a_j AND b_i`` as one parallel operation;
3. **full adder** across all partitions concurrently (7 parallel ops for the
   NOR-FA internals);
4. **fused shift**: the FA sum of partition ``j`` is written directly into
   partition ``j-1`` (two semi-parallel distance-1 operations, even/odd —
   MultPIM's constant-time shift), the top partition is refilled with a
   constant 0, and partition 0's sum is emitted as result bit ``r_i``.

After N iterations a ripple carry-propagate resolves the high half.  Model
differences are expressed through ``is_legal``-guarded fusions: operations
that mix intra-partition indices (e.g. folding the top-partition zero-fill
into the shift operation) are only fused under *unlimited*; the fallback
decomposition costs extra cycles under standard/minimal — the mechanism of
the paper's §5 evaluation.  Our schedule is deliberately periodic
(co-designed for the minimal model), so the measured unlimited/standard/
minimal spread is *smaller* than the paper's retrofit of the original
MultPIM — see EXPERIMENTS.md.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

from repro_torch.core.operation import GateOp, Operation, PartitionConfig
from repro_torch.core.program import Program, ProgramBuilder

__all__ = ["PartitionedMultiplier", "build_multpim", "Layout"]


@dataclasses.dataclass(frozen=True)
class Layout:
    """Intra-partition column map (identical in every partition)."""

    IA: int = 0      # a_j
    IB: int = 1      # b_j
    INA: int = 2     # NOT a_j
    NZ: int = 3      # constant 1 (freshly initialized, never gated)
    S0: int = 4      # accumulator sum, parity 0
    C0: int = 5      # accumulator carry, parity 0
    BB: int = 6      # broadcast slot (holds NOT b_i)
    TB: int = 7      # broadcast stage temps TB .. TB+n_stages-1
    # PP/U/S1/C1 computed from n_stages so the per-iteration init window is
    # a single contiguous range for either write parity (see _init_window).
    R_OFF: int = 0   # set in __post_init__ equivalents below

    @staticmethod
    def make(k: int):
        n_stages = max(1, (k - 1).bit_length())
        tb = 7
        pp = tb + n_stages
        u = pp + 1
        s1 = u + 7
        c1 = s1 + 1
        r = c1 + 1
        r2 = r + 1
        cc = r2 + 1
        ct = cc + 1
        nz2 = ct + 1
        return dict(n_stages=n_stages, TB=tb, PP=pp, U=u, S1=s1, C1=c1,
                    R=r, R2=r2, CC=cc, CT=ct, NZ2=nz2, width=nz2 + 1)


@dataclasses.dataclass
class PartitionedMultiplier:
    program: Program
    n_bits: int
    a_cols: Tuple[int, ...]       # bit j at (partition j, IA)
    b_cols: Tuple[int, ...]
    result_cols: Tuple[int, ...]  # 2N columns, LSB first
    layout: dict


def build_multpim(n_bits: int = 32, n_cols: int = 1024,
                  model: str = "minimal") -> PartitionedMultiplier:
    """Build the partitioned multiplier program for one of the three models."""
    N = n_bits
    k = N
    if k & (k - 1):
        raise ValueError("bit width (= partition count) must be a power of two")
    cfg = PartitionConfig(n_cols, k)
    L = Layout.make(k)
    m = cfg.m
    if L["width"] > m:
        raise ValueError(f"layout needs {L['width']} intra columns, have {m}")

    IA, IB, INA, NZ = Layout.IA, Layout.IB, Layout.INA, Layout.NZ
    S = [Layout.S0, L["S1"]]
    C = [Layout.C0, L["C1"]]
    BB, TB, PP, U = Layout.BB, L["TB"], L["PP"], L["U"]
    R, R2, CC, CT, NZ2 = L["R"], L["R2"], L["CC"], L["CT"], L["NZ2"]
    n_stages = L["n_stages"]

    b = ProgramBuilder(cfg, model)
    col = cfg.col

    def par_gate(gate, ins_intra, out_intra, label=""):
        """One gate in every partition at identical intra indices."""
        gates = tuple(
            GateOp(gate, tuple(col(p, i) for i in ins_intra), col(p, out_intra))
            for p in range(k)
        )
        b.emit(Operation(gates=gates, label=label))

    # ---------------- setup ----------------
    b.init_periodic(INA, NZ, label="setup-init")          # INA, NZ
    b.init_periodic(R, NZ2, label="setup-init-res")        # R,R2,CC,CT,NZ2
    par_gate("NOT", (IA,), INA, "na")

    # ---------------- broadcast ----------------
    def broadcast(i: int):
        """Spread NOT(b_i) from partition i to all partitions' BB column."""
        b.emit(Operation(gates=(GateOp("NOT", (col(i, IB),), col(i, BB)),),
                         label="nb"))
        for t in range(1, n_stages + 1):
            d = k >> t
            step = 2 * d
            start = i % step
            # T: stage complement staging at every 'have' partition
            b.emit(Operation(init=None, gates=tuple(
                GateOp("NOT", (col(p, BB),), col(p, TB + t - 1))
                for p in range(start, k, step)
            ), label=f"bcast-T{t}"))
            right = [p for p in range(start, k, step) if p + d < k]
            left = [p for p in range(start, k, step) if p - d >= 0]
            if right:
                b.emit(Operation(gates=tuple(
                    GateOp("NOT", (col(p, TB + t - 1),), col(p + d, BB))
                    for p in right), label=f"bcast-R{t}"))
            if left:
                b.emit(Operation(gates=tuple(
                    GateOp("NOT", (col(p, TB + t - 1),), col(p - d, BB))
                    for p in left), label=f"bcast-L{t}"))

    def init_window(w: int, label: str):
        """One contiguous periodic init covering BB, TBs, PP, U and the
        write-parity S/C — the read parity is outside the range either way."""
        if w == 1:
            b.init_periodic(BB, C[1], label=label)      # [BB .. C1]
        else:
            b.init_periodic(S[0], U + 6, label=label)   # [S0 .. U7]

    def shift_writes(w: int, sum_src: Tuple[int, int]):
        """Sum of partition j -> S_w of partition j-1 (even/odd), top zero-fill.

        Under unlimited the top-partition zero-fill — NOR of two constant-one
        columns (= 0) at different intra indices — fuses into the even op
        (Identical Indices forbids it under standard/minimal: paper fn. 4).
        """
        sa, sb = sum_src
        odd = tuple(GateOp("NOR", (col(j, sa), col(j, sb)), col(j - 1, S[w]))
                    for j in range(1, k, 2))
        even = tuple(GateOp("NOR", (col(j, sa), col(j, sb)), col(j - 1, S[w]))
                     for j in range(2, k, 2))
        top = GateOp("NOR", (col(k - 1, NZ), col(k - 1, NZ2)), col(k - 1, S[w]))
        b.emit(Operation(gates=odd, label="shift-odd"))
        b.fuse_or(
            Operation(gates=even + (top,), label="shift-even+top"),
            [Operation(gates=even, label="shift-even"),
             Operation(gates=(top,), label="top-zero")],
        )

    # NZ2 constant: both NZ and NZ2 are init'd (=1) and never gated.
    # ---------------- iteration 0 ----------------
    init_window(1, "iter0-init")
    broadcast(0)
    # partial products, pre-shifted: S1[j] = pp_{j+1}
    odd0 = tuple(GateOp("NOR", (col(j, INA), col(j, BB)), col(j - 1, S[1]))
                 for j in range(1, k, 2))
    even0 = tuple(GateOp("NOR", (col(j, INA), col(j, BB)), col(j - 1, S[1]))
                  for j in range(2, k, 2))
    top0 = GateOp("NOR", (col(k - 1, NZ), col(k - 1, NZ2)), col(k - 1, S[1]))
    b.emit(Operation(gates=odd0, label="pp0-odd"))
    b.fuse_or(
        Operation(gates=even0 + (top0,), label="pp0-even+top"),
        [Operation(gates=even0, label="pp0-even"),
         Operation(gates=(top0,), label="top-zero")],
    )
    par_gate("NOT", (NZ,), C[1], "c0-zero")  # all carries start at 0
    b.emit(Operation(gates=(GateOp("NOR", (col(0, INA), col(0, BB)), col(0, R)),),
                     label="emit-r0"))

    # ---------------- iterations 1 .. N-1 ----------------
    for i in range(1, N):
        w = (i + 1) % 2
        r = i % 2
        init_window(w, f"iter{i}-init")
        broadcast(i)
        par_gate("NOR", (INA, BB), PP, "pp")
        # NOR full adder: x=S_r, y=PP, cin=C_r
        par_gate("NOR", (S[r], PP), U + 0, "u1")
        par_gate("NOR", (S[r], U + 0), U + 1, "u2")
        par_gate("NOR", (PP, U + 0), U + 2, "u3")
        par_gate("NOR", (U + 1, U + 2), U + 3, "u4")   # XNOR(x,y)
        par_gate("NOR", (U + 3, C[r]), U + 4, "u5")
        par_gate("NOR", (U + 3, U + 4), U + 5, "u6")
        par_gate("NOR", (C[r], U + 4), U + 6, "u7")
        shift_writes(w, sum_src=(U + 5, U + 6))
        par_gate("NOR", (U + 0, U + 4), C[w], "cout")
        b.emit(Operation(gates=(GateOp(
            "NOR", (col(0, U + 5), col(0, U + 6)), col(i, R)),), label="emit"))

    # ---------------- final ripple carry-propagate -----------------------
    fin = N % 2  # parity written by iteration N-1
    carry_known_zero = True
    for j in range(k):
        b.init_periodic(PP, U + 6, p_start=j, p_end=j, label="fin-init")
        x, y = col(j, S[fin]), col(j, C[fin])
        cin = col(j, CT)
        sum_out, cout_out = col(j, R2), col(j, CC)
        u = [col(j, U + t) for t in range(7)]
        if carry_known_zero:
            # half adder
            b.emit(Operation(gates=(GateOp("NOR", (x, y), u[0]),)))
            b.emit(Operation(gates=(GateOp("NOR", (x, u[0]), u[1]),)))
            b.emit(Operation(gates=(GateOp("NOR", (y, u[0]), u[2]),)))
            b.emit(Operation(gates=(GateOp("NOR", (u[1], u[2]), u[3]),)))
            b.emit(Operation(gates=(GateOp("NOT", (u[3],), sum_out),)))
            if j < k - 1:
                # x & y = NOR(NOR(x,y), XOR(x,y))
                b.emit(Operation(gates=(GateOp("NOR", (u[0], sum_out), cout_out),)))
            carry_known_zero = False
        else:
            b.emit(Operation(gates=(GateOp("NOR", (x, y), u[0]),)))
            b.emit(Operation(gates=(GateOp("NOR", (x, u[0]), u[1]),)))
            b.emit(Operation(gates=(GateOp("NOR", (y, u[0]), u[2]),)))
            b.emit(Operation(gates=(GateOp("NOR", (u[1], u[2]), u[3]),)))
            b.emit(Operation(gates=(GateOp("NOR", (u[3], cin), u[4]),)))
            b.emit(Operation(gates=(GateOp("NOR", (u[3], u[4]), u[5]),)))
            b.emit(Operation(gates=(GateOp("NOR", (cin, u[4]), u[6]),)))
            b.emit(Operation(gates=(GateOp("NOR", (u[5], u[6]), sum_out),)))
            if j < k - 1:
                b.emit(Operation(gates=(GateOp("NOR", (u[0], u[4]), cout_out),)))
        if j < k - 1:
            # ripple the carry into the next partition (double NOT via PP)
            b.emit(Operation(gates=(GateOp("NOT", (cout_out,), col(j, PP)),)))
            b.emit(Operation(gates=(GateOp("NOT", (col(j, PP),), col(j + 1, CT)),)))

    prog = b.program
    prog.name = f"multpim-{model}-{N}b"
    result = tuple(col(i, R) for i in range(N)) + tuple(col(j, R2) for j in range(k))
    return PartitionedMultiplier(
        program=prog,
        n_bits=N,
        a_cols=tuple(col(j, IA) for j in range(N)),
        b_cols=tuple(col(j, IB) for j in range(N)),
        result_cols=result,
        layout=L,
    )
