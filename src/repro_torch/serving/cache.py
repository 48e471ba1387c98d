"""Decode-cache pools for continuous batching: slot-contiguous and paged.

Two pool layouts share one scheduler-facing API (``can_admit`` /
``admit`` / ``evict`` / ``read_slot`` / ``stats``):

:class:`CachePool` is the naive layout — the full decode-cache tree of
``models.model.cache_specs`` at ``(max_batch, max_len)``, allocated once;
every slot reserves worst-case ``max_len`` KV whether its request needs 10
tokens or 10k.

:class:`PagedCachePool` is the PartitionPIM move applied to device memory:
just as the paper divides one fixed crossbar into dynamic partitions so
independent work shares the substrate without worst-case reservation, the
paged pool divides each attention-KV leaf into a ``(num_blocks,
block_size, ...)`` physical store shared by all slots.  A per-slot block
table (``(max_batch, blocks_per_slot)`` int32, sentinel ``0`` pointing at
a reserved trash block) maps logical token blocks to physical ones; a
host-side free-list allocator reserves exactly
``ceil((prompt + budget) / block_size)`` blocks per request at admit time
(admission defers when the free list is short — never a mid-decode OOM),
and evict returns the blocks.  The decode step reads through a gather on
the block table, whose shape is fixed.

``stats()`` keys (consumed by ``ServingMetrics.sample_pool``):
``tokens_reserved`` is the per-slot reservation, ``tokens_in_use`` the
physical occupancy (allocated blocks x block_size).

Both pools update their cache tensors in place.  Not ported yet (ROADMAP
queue 1): the prefix index with copy-on-write sharing, chunked and packed
prefill installs, and sliding-window rings.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import model_lib as M
from repro_torch.models.config import ModelConfig

__all__ = ["CachePool", "PagedCachePool"]


def _kv_leaf_bytes(specs) -> int:
    """Bytes of the attention-KV (pageable) leaves of a cache spec tree."""
    total = 0
    for c in specs.values():
        for key in M.PAGED_KV_KEYS:
            if key in c:
                shape, dt = c[key]
                total += int(np.prod(shape)) * torch.empty(
                    (), dtype=dt).element_size()
    return total


class CachePool:
    """Decode caches for ``max_batch`` slots of up to ``max_len`` tokens.

    ``caches`` is the live cache tree the decode step updates in place.
    ``assign`` expects a single-request prefill cache (batch dim 1)
    produced at the pool's ``max_len`` capacity (i.e. with
    ``cfg.max_seq_len == max_len``).
    """

    paged = False
    block_tables = None            # uniform scheduler interface

    def __init__(self, cfg: ModelConfig, max_batch: int,
                 max_len: Optional[int] = None, *, device="cuda"):
        self.max_batch = max_batch
        self.max_len = max_len or cfg.max_seq_len
        self.max_tokens = self.max_len          # per-slot token capacity
        specs = M.cache_specs(cfg, max_batch, self.max_len)
        self.kv_reserved_bytes = _kv_leaf_bytes(specs)
        self.caches: Dict[str, Any] = M.zeros_like_specs(
            specs, resolve_device(device))
        self._assigned: set = set()   # occupied slots (stats only)

    def assign(self, slot: int, request_cache) -> None:
        """Install a (batch-1) prefill cache into ``slot``."""
        for li, c in self.caches.items():
            for key, leaf in c.items():
                leaf[:, slot:slot + 1] = request_cache[li][key].to(leaf.dtype)
        self._assigned.add(int(slot))

    def evict(self, slot: int) -> None:
        """Zero ``slot`` (logical free; keeps stale KV out of the pool)."""
        for c in self.caches.values():
            for leaf in c.values():
                leaf[:, slot] = 0
        self._assigned.discard(int(slot))

    def read_slot(self, slot: int):
        """A copy of the (batch-1) cache of ``slot`` — tests/inspection."""
        return {li: {k: v[:, slot:slot + 1].clone() for k, v in c.items()}
                for li, c in self.caches.items()}

    # ---- uniform pool interface -------------------------------------

    def can_admit(self, n_tokens: int) -> bool:
        """Contiguous slots always fit (capacity was reserved up front)."""
        return True

    @property
    def free_blocks(self) -> int:
        """Free capacity in slot units (the contiguous pool's allocation
        granularity is one slot)."""
        return self.max_batch - len(self._assigned)

    def admit(self, slot: int, request_cache, plen: int, n_tokens: int
              ) -> None:
        self.assign(slot, request_cache)

    def stats(self) -> Dict[str, float]:
        """Occupancy snapshot.  The contiguous pool's KV bytes are its
        static worst-case reservation; ``tokens_in_use`` counts only
        occupied slots (each at full ``max_len`` capacity)."""
        return {
            "kv_bytes_in_use": float(self.kv_reserved_bytes),
            "kv_bytes_reserved": float(self.kv_reserved_bytes),
            "blocks_in_use": float(self.max_batch),
            "blocks_total": float(self.max_batch),
            "tokens_reserved": float(self.max_batch * self.max_len),
            "tokens_in_use": float(len(self._assigned) * self.max_len),
        }


class PagedCachePool:
    """Block-paged decode caches: attention KV in shared physical blocks.

    ``block_size`` tokens per block; ``num_blocks`` physical blocks per KV
    leaf (default: full parity with the contiguous pool — every slot can
    hold ``blocks_per_slot`` blocks — plus the reserved trash block; pass
    something smaller to actually oversubscribe).  Block 0 is never
    allocated: it is the sentinel target of unassigned block-table entries,
    absorbing the garbage writes of inactive decode slots.

    ``admit`` expects a (batch-1) prefill cache and the request's true
    prompt length: the paged leaves are gathered from the dense prefill
    layout into position-ordered logical blocks, invalid positions zeroed,
    and scattered to the slot's physical blocks.
    """

    paged = True

    def __init__(self, cfg: ModelConfig, max_batch: int,
                 max_len: Optional[int] = None, *, block_size: int = 16,
                 num_blocks: Optional[int] = None, device="cuda"):
        if block_size < 1:
            raise ValueError("block_size must be >= 1")
        if cfg.sliding_window:
            raise NotImplementedError(
                f"{cfg.name}: sliding-window rings are not ported yet "
                "(ROADMAP.md queue 1)")
        self.cfg = cfg
        self.max_batch = max_batch
        self.max_len = max_len or cfg.max_seq_len
        self.block_size = block_size
        self.blocks_per_slot = -(-self.max_len // block_size)
        self.lcap = self.blocks_per_slot * block_size   # logical tokens/slot
        # bounded by the configured horizon, NOT the block-rounded lcap —
        # the layout must never admit a request the contiguous pool would
        # reject
        self.max_tokens = self.max_len
        self.num_blocks = (num_blocks if num_blocks is not None
                           else max_batch * self.blocks_per_slot + 1)
        if self.num_blocks < 2:
            raise ValueError("num_blocks must be >= 2 (block 0 is the "
                             "reserved sentinel/trash block)")
        self.device = resolve_device(device)
        specs = M.paged_cache_specs(cfg, max_batch, self.max_len,
                                    self.num_blocks, block_size)
        per_pool = _kv_leaf_bytes(specs)
        self.block_bytes = per_pool // self.num_blocks  # all leaves/layers
        self._has_paged_leaves = per_pool > 0
        self.caches: Dict[str, Any] = M.zeros_like_specs(specs, self.device)

        # host allocator state: free-list (LIFO keeps reuse warm), per-slot
        # block lists, and the sentinel-padded table mirrored to device
        self._free: List[int] = list(range(self.num_blocks - 1, 0, -1))
        self._slot_blocks: List[List[int]] = [[] for _ in range(max_batch)]
        self._table = np.zeros((max_batch, self.blocks_per_slot), np.int32)
        self._table_dev = None
        self.peak_blocks_in_use = 0

    # ---- allocator ---------------------------------------------------

    @property
    def blocks_in_use(self) -> int:
        return self.num_blocks - 1 - len(self._free)

    @property
    def free_blocks(self) -> int:
        """Blocks on the free list."""
        return len(self._free)

    def blocks_needed(self, n_tokens: int) -> int:
        if not self._has_paged_leaves:
            return 0
        return min(self.cfg.kv_blocks_for(n_tokens, self.block_size),
                   self.blocks_per_slot)

    def can_admit(self, n_tokens: int) -> bool:
        """Whether the free list covers a request writing ``n_tokens``
        positions."""
        return self.blocks_needed(n_tokens) <= len(self._free)

    @property
    def block_tables(self) -> torch.Tensor:
        """Device copy of the (max_batch, blocks_per_slot) table."""
        if self._table_dev is None:
            self._table_dev = torch.as_tensor(self._table).to(self.device)
        return self._table_dev

    # ---- pool ops ----------------------------------------------------

    def _install(self, request_cache, table_row: np.ndarray, plen: int
                 ) -> None:
        row = torch.as_tensor(table_row, dtype=torch.long
                              ).to(self.device)
        r = torch.arange(self.lcap, device=self.device)
        valid = r < plen
        for li, c in self.caches.items():
            for key, leaf in c.items():
                rleaf = request_cache[li][key]      # (ns, 1, cap_p, ...)
                src = r % rleaf.shape[2]
                logical = rleaf[:, 0][:, src]        # (ns, lcap, ...)
                vshape = (1, self.lcap) + (1,) * (logical.dim() - 2)
                logical = torch.where(valid.reshape(vshape), logical,
                                      torch.zeros_like(logical))
                blocks = logical.reshape(
                    (logical.shape[0], self.blocks_per_slot,
                     self.block_size) + logical.shape[2:])
                # sentinel-padded rows scatter their tail into trash block 0
                leaf[:, row] = blocks.to(leaf.dtype)

    def admit(self, slot: int, request_cache, plen: int, n_tokens: int
              ) -> None:
        """Reserve blocks for ``n_tokens`` total positions and install the
        (batch-1) prefill cache of a ``plen``-token prompt into ``slot``.
        Callers must check :meth:`can_admit` first; an insufficient free
        list here is a scheduler bug, not back-pressure."""
        if self._slot_blocks[slot]:
            raise RuntimeError(f"slot {slot} already holds blocks")
        need = self.blocks_needed(n_tokens)
        if need > len(self._free):
            raise RuntimeError(
                f"free list underflow: slot {slot} needs {need} blocks, "
                f"{len(self._free)} free — check can_admit() before admit")
        blocks = [self._free.pop() for _ in range(need)]
        self._slot_blocks[slot] = blocks
        self._table[slot] = 0
        self._table[slot, :need] = blocks
        self._table_dev = None
        self.peak_blocks_in_use = max(self.peak_blocks_in_use,
                                      self.blocks_in_use)
        self._install(request_cache, self._table[slot], plen)

    def evict(self, slot: int) -> None:
        """Zero the slot's blocks and return them to the free list."""
        blocks = self._slot_blocks[slot]
        if blocks:
            row = torch.as_tensor(self._table[slot], dtype=torch.long
                                  ).to(self.device)
            for c in self.caches.values():
                for leaf in c.values():
                    leaf[:, row] = 0
            self._free.extend(reversed(blocks))
        self._slot_blocks[slot] = []
        self._table[slot] = 0
        self._table_dev = None

    def read_slot(self, slot: int):
        """The (batch-1) *logical* cache view of ``slot``: paged leaves are
        gathered back to position-ordered ``(ns, 1, lcap, ...)`` tensors
        (sentinel blocks read the trash block — callers mask by length).
        Tests/inspection."""
        row = torch.as_tensor(self._table[slot], dtype=torch.long
                              ).to(self.device)
        out = {}
        for li, c in self.caches.items():
            oc = {}
            for key, leaf in c.items():
                g = leaf[:, row]                     # (ns, bps, bs, ...)
                oc[key] = g.reshape((g.shape[0], 1, self.lcap) + g.shape[3:])
            out[li] = oc
        return out

    def stats(self) -> Dict[str, float]:
        """Occupancy snapshot for ``ServingMetrics.sample_pool``."""
        used = self.blocks_in_use
        reserved = sum(len(b) for b in self._slot_blocks)
        return {
            "kv_bytes_in_use": float(used * self.block_bytes),
            "kv_bytes_reserved": float((self.num_blocks - 1)
                                       * self.block_bytes),
            "blocks_in_use": float(used),
            "blocks_total": float(self.num_blocks - 1),
            "tokens_reserved": float(reserved * self.block_size),
            "tokens_in_use": float(used * self.block_size),
        }
