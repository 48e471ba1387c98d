"""Combinatorial lower bounds on control-message length (paper §2.3/§3.3/§4.3).

Counts the supported operations of each design with exact integer arithmetic;
``ceil(log2(count))`` lower-bounds any message encoding.  Paper values for
(k=32, n=1024): unlimited >= 443 bits, standard >= 46 bits, minimal >= 25 bits
(vs implemented 607 / 79 / 36).
"""
from __future__ import annotations

import math
from repro_torch.core.operation import PartitionConfig

__all__ = [
    "count_serial",
    "count_parallel",
    "unlimited_lower_bound",
    "standard_lower_bound",
    "minimal_lower_bound",
]


def _comb(n: int, r: int) -> int:
    return math.comb(n, r)


def count_serial(n: int) -> int:
    """C(n,2) * (n-2): unordered input pair x distinct output column."""
    return _comb(n, 2) * (n - 2)


def count_parallel(n: int, k: int) -> int:
    """[C(m,2) * (m-2)]^k: every partition runs an independent gate."""
    m = n // k
    return (_comb(m, 2) * (m - 2)) ** k


def unlimited_lower_bound(cfg: PartitionConfig) -> int:
    """§2.3: serial + parallel operations alone (semi-parallel not counted —
    valid since we seek a lower bound)."""
    total = count_serial(cfg.n) + count_parallel(cfg.n, cfg.k)
    return math.ceil(math.log2(total))


def standard_lower_bound(cfg: PartitionConfig) -> int:
    """§3.3: 2 * sum_m C(k-1, m-1) * C(n/k, 2) * (n/k - 2).

    For each number of sections m there are C(k-1, m-1) section divisions;
    shared intra indices contribute C(m,2)*(m-2) gate choices; the factor 2
    is the global direction.
    """
    m_cols = cfg.m
    per_idx = _comb(m_cols, 2) * (m_cols - 2)
    total = 2 * sum(_comb(cfg.k - 1, s - 1) for s in range(1, cfg.k + 1)) * per_idx
    return math.ceil(math.log2(total))


def minimal_lower_bound(cfg: PartitionConfig) -> int:
    """§4.3: all non-input-split serial operations are supported.

    Input partition (k) x *ordered* intra input pair m*(m-1) (InA and InB
    are distinct message fields) x output column anywhere (n-2); distance
    and direction are implied by the output choice.  Gives 25 bits at
    (k=32, n=1024), matching the paper.
    """
    per = cfg.k * cfg.m * (cfg.m - 1) * (cfg.n - 2)
    return math.ceil(math.log2(per))
