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

Paging is also what serves **sliding windows**: a windowed slot is a
*ring* over its block list with capacity ``ceil(window / block) * block``
— prefill installs the last ``min(prompt, window)`` positions, decode
wraps, and the reservation stops depending on prompt + generation length.

**Prefix caching** (``prefix_cache=True``) lets *requests* share the
paged substrate the way the paper's partitions share the crossbar: a
:class:`PrefixIndex` — a trie over block-sized token runs — maps fully
matched prompt blocks of a new request straight into its block table
(refcount bump, no prefill, no copy), and only the divergent tail is
prefilled (``models.model.prefill(prefix=...)`` resumes at the
block-aligned offset).  Every physical block carries a refcount; a block
returns to the free list — and is zeroed — only when the last reference
drops.  A block's lifetime is therefore::

    free -> private (ref 1, one slot)
         -> shared  (ref > 1: other slots via trie hits/forks, or the
                     index itself, which holds one reference per entry)
         -> COW     (first write into a shared block copies it into a
                     fresh private block first; see ensure_writable)

The COW path fires on the two writes that can land in a shared block: a
fork's divergent continuation entering the partially filled boundary
block (``fork`` is the parallel-sampling n>1 primitive — siblings share
every content block), and a sliding-window ring wrapping onto mapped
prefix blocks.  Unwindowed trie hits never COW: the divergent tail always
starts on a fresh block (matches are block-aligned and capped at
``plen - 1``).  Admission budgets outstanding COW copies against the free
list (``_cow_debt``) so a copy never finds it empty; under pressure,
``can_admit`` reclaims LRU index-only blocks (ref held solely by the
trie) before deferring.

Chunked and packed prefill install through the same scatter: ``extend``
writes a later chunk's tail cache at its block offset, and ``admit(start=)``
reads one segment's span out of a packed prefill's stream.

``stats()`` keys (consumed by ``ServingMetrics.sample_pool``):
``tokens_reserved`` is the *logical* per-slot reservation (a shared block
counts once per referencing slot), ``tokens_in_use`` the *physical*
occupancy (allocated blocks x block_size, each block once);
``blocks_shared``, ``prefix_blocks`` and ``cow_copies`` report sharing.

**Recurrent state** (Mamba's and Mamba-2's ``ssm``/``conv``, xLSTM's
``c``/``n``/``m``) is fixed-size per slot and stays slot-indexed in both
pools (``models.model.PAGED_KV_KEYS`` names what pages): admit installs it
into the slot, evict zeroes it, ``read_slot`` returns it and ``fork``
copies it.  A pure-recurrent stack pages nothing and reserves no block.

Both pools update their cache tensors in place.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import model_lib as M
from repro_torch.models.config import ModelConfig

__all__ = ["CachePool", "PagedCachePool", "PrefixIndex"]


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


class PrefixIndex:
    """Trie over block-sized token runs -> physical KV blocks.

    Each node is one *full* block of ``block_size`` token ids (the edge
    key) holding the physical block where that run's KV lives; a path
    from the root spells a block-aligned prompt prefix.  The index holds
    its own reference on every registered block (the pool bumps the
    refcount on ``insert``'s adoptions), so shared prefixes survive the
    eviction of the slots that minted them.  ``match`` touches nodes for
    LRU; ``pop_lru_blocks`` releases least-recently-used leaves whose
    block the pool can actually free (index-only references) when the
    free list runs short.
    """

    def __init__(self, block_size: int):
        self.block_size = block_size
        # node: [block_id, children dict keyed by token tuple, lru stamp]
        self._root: Dict[tuple, list] = {}
        self._clock = 0
        self.n_blocks = 0

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    def match(self, tokens) -> List[int]:
        """Blocks covering the longest fully-block-aligned prefix of
        ``tokens`` present in the index (touches matched nodes)."""
        bs = self.block_size
        out: List[int] = []
        children = self._root
        for i in range(len(tokens) // bs):
            key = tuple(int(t) for t in tokens[i * bs:(i + 1) * bs])
            node = children.get(key)
            if node is None:
                break
            node[2] = self._tick()
            out.append(node[0])
            children = node[1]
        return out

    def insert(self, tokens, blocks: Sequence[int]) -> List[int]:
        """Register ``blocks[i]`` as holding ``tokens[i*bs:(i+1)*bs]``.

        Existing nodes keep their canonical block (the new request was
        mapped onto it anyway if it matched); returns the block ids newly
        adopted — the caller owns bumping their refcount.
        """
        bs = self.block_size
        new: List[int] = []
        children = self._root
        for i, b in enumerate(blocks):
            key = tuple(int(t) for t in tokens[i * bs:(i + 1) * bs])
            node = children.get(key)
            if node is None:
                node = [int(b), {}, 0]
                children[key] = node
                new.append(int(b))
                self.n_blocks += 1
            node[2] = self._tick()
            children = node[1]
        return new

    def blocks(self) -> List[int]:
        """Every registered block id (tests / invariant checks)."""
        out: List[int] = []
        stack = [self._root]
        while stack:
            for node in stack.pop().values():
                out.append(node[0])
                stack.append(node[1])
        return out

    def pop_lru_blocks(self, want: int, reclaimable) -> List[int]:
        """Drop least-recently-used *leaf* entries whose block satisfies
        ``reclaimable(block_id)`` until ``want`` blocks were released (or
        none remain); returns the released ids.  Dropping a leaf may
        expose its parent as the next candidate."""
        released: List[int] = []
        while len(released) < want:
            best = None
            stack = [self._root]
            while stack:
                children = stack.pop()
                for key, node in children.items():
                    if node[1]:
                        stack.append(node[1])
                    elif reclaimable(node[0]) and (best is None
                                                   or node[2] < best[0]):
                        best = (node[2], children, key, node)
            if best is None:
                break
            _, children, key, node = best
            del children[key]
            self.n_blocks -= 1
            released.append(node[0])
        return released

    def drop_all(self) -> List[int]:
        """Forget every entry; returns all previously held block ids."""
        out = self.blocks()
        self._root = {}
        self.n_blocks = 0
        return out


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
    prompt length: the paged leaves are gathered from the prefill layout
    (dense, or the windowed ring) into position-ordered logical blocks,
    invalid positions zeroed, and scattered to the slot's physical blocks.
    With ``prefix_blocks``
    (a trie hit from :meth:`prefix_match`) the matched blocks are mapped by
    reference and only the tail cache — emitted by the resumed prefill,
    positions ``m..plen-1`` — is scattered, at block offset ``m``.

    ``prefix_cache=True`` attaches the :class:`PrefixIndex` and enables
    per-block refcounting/COW (see the module docstring for the block
    lifetime).  The caller gates it to stacks whose KV is
    position-separable (no recurrent blocks, no MoE); windowed prompts
    take part only while ``plen <= window``, where the ring layout is the
    dense one.
    """

    paged = True

    def __init__(self, cfg: ModelConfig, max_batch: int,
                 max_len: Optional[int] = None, *, block_size: int = 16,
                 num_blocks: Optional[int] = None, device="cuda",
                 prefix_cache: bool = False):
        if block_size < 1:
            raise ValueError("block_size must be >= 1")
        self.cfg = cfg
        self.max_batch = max_batch
        self.max_len = max_len or cfg.max_seq_len
        self.block_size = block_size
        ring = cfg.window_ring_blocks(block_size)
        self.blocks_per_slot = (ring if ring is not None
                                else -(-self.max_len // block_size))
        self.lcap = self.blocks_per_slot * block_size   # logical tokens/slot
        # windowed slots can generate forever (the ring wraps); unwindowed
        # ones are bounded by the configured horizon, NOT the block-rounded
        # lcap — the layout must never admit a request the contiguous pool
        # would reject
        self.max_tokens = None if cfg.sliding_window else self.max_len
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
        # block lists, per-block refcounts, and the sentinel-padded table
        # mirrored to device
        self._free: List[int] = list(range(self.num_blocks - 1, 0, -1))
        self._slot_blocks: List[List[int]] = [[] for _ in range(max_batch)]
        self._table = np.zeros((max_batch, self.blocks_per_slot), np.int32)
        self._table_dev = None
        self._ref = np.zeros(self.num_blocks, np.int64)
        # blocks each slot may yet overwrite while shared (the boundary
        # block of a fork, mapped prefix under a wrapping ring): the free
        # list keeps this many blocks in reserve so COW never underflows
        self._cow_debt = np.zeros(max_batch, np.int64)
        self.cow_copies = 0
        self.peak_blocks_in_use = 0
        self.prefix = (PrefixIndex(block_size)
                       if prefix_cache and self._has_paged_leaves else None)

    # ---- allocator ---------------------------------------------------

    @property
    def blocks_in_use(self) -> int:
        return self.num_blocks - 1 - len(self._free)

    @property
    def free_blocks(self) -> int:
        """Blocks on the free list (trie-held ref==1 blocks are
        reclaimable but not counted)."""
        return len(self._free)

    @property
    def has_shared(self) -> bool:
        """Any block referenced more than once (COW checks are needed)."""
        return bool((self._ref > 1).any())

    def blocks_needed(self, n_tokens: int) -> int:
        if not self._has_paged_leaves:
            return 0
        return min(self.cfg.kv_blocks_for(n_tokens, self.block_size),
                   self.blocks_per_slot)

    def _will_wrap(self, n_tokens: int) -> bool:
        """Whether a windowed request writing ``n_tokens`` wraps its ring
        (and may therefore overwrite mapped or registered prefix
        blocks)."""
        return bool(self.cfg.sliding_window) and n_tokens > self.lcap

    def _reclaim(self, want: int) -> None:
        """Free up to ``want`` index-only blocks (held solely by the
        prefix trie, LRU first) back to the free list."""
        if self.prefix is None:
            return
        dropped = self.prefix.pop_lru_blocks(
            want, lambda b: self._ref[b] == 1)
        for b in dropped:
            self._ref[b] = 0
        self._zero_blocks(dropped)
        self._free.extend(reversed(dropped))

    def can_admit(self, n_tokens: int, prefix_tokens: int = 0,
                  extra_reserved: int = 0) -> bool:
        """Whether the free list covers a request writing ``n_tokens``
        positions, of which the leading ``prefix_tokens`` arrive mapped
        from the prefix index (no allocation).  Budgets the request's own
        worst-case COW copies plus every outstanding debt, reclaiming LRU
        index-only blocks under pressure before giving up.

        ``extra_reserved``: blocks already spoken for by earlier members
        of the same batch (packed prefill collects several admits before
        allocating any — each check must budget its predecessors)."""
        need = self.blocks_needed(n_tokens)
        mapped = min(prefix_tokens // self.block_size, need)
        fresh = need - mapped
        debt = 0
        if self._will_wrap(n_tokens):
            # the wrapping ring may copy every mapped block and (with the
            # index attached) every own block it registers
            debt = mapped + (fresh if self.prefix is not None else 0)
        want = fresh + debt + int(self._cow_debt.sum()) + extra_reserved
        if want > len(self._free):
            self._reclaim(want - len(self._free))
        return want <= len(self._free)

    @property
    def block_tables(self) -> torch.Tensor:
        """Device copy of the (max_batch, blocks_per_slot) table."""
        if self._table_dev is None:
            self._table_dev = torch.as_tensor(self._table).to(self.device)
        return self._table_dev

    # ---- block ops (index ops on every paged leaf) -------------------

    def _leaves(self):
        for li, c in self.caches.items():
            for key, leaf in c.items():
                if key in M.PAGED_KV_KEYS:
                    yield li, key, leaf

    def _slot_leaves(self):
        """The slot-indexed (recurrent state) leaves, ``(ns, max_batch,
        ...)``."""
        for li, c in self.caches.items():
            for key, leaf in c.items():
                if key not in M.PAGED_KV_KEYS:
                    yield li, key, leaf

    def _index(self, ids) -> torch.Tensor:
        return torch.as_tensor(np.asarray(ids, np.int64)).to(self.device)

    def _zero_blocks(self, blocks: Sequence[int]) -> None:
        if not blocks:
            return
        idx = self._index(list(blocks))
        for _, _, leaf in self._leaves():
            leaf[:, idx] = 0

    def _install(self, slot: int, request_cache, table_row: np.ndarray,
                 plen: int, m: int = 0, start: int = 0) -> None:
        """Install the slot-indexed leaves of ``request_cache`` (ns, 1,
        ...) into ``slot``, and scatter positions ``m..plen-1`` of the
        slot's prompt into its blocks: paged leaves are (ns, 1, cap, ...)
        and hold position ``p`` at index ``start + p - m`` (a whole
        prefill: m = 0, start = 0; a resumed tail or a later chunk: m > 0;
        one segment of a packed stream: start > 0).  Every other logical
        row is written as
        zeros; ``table_row`` routes the rows before ``m`` (sentinel
        entries) into the trash block, so earlier blocks stay untouched.

        A windowed whole prefill (m = 0) holds position ``p`` at ring index
        ``start + p % cap``; logical row ``r`` takes the newest position
        congruent to it in the slot's ring, if inside the window — the
        congruence the paged decode read applies
        (``models.model.ring_slot_positions``).  A windowed tail (m > 0)
        only comes with ``plen <= window``, where the ring is the dense
        layout."""
        for li, key, leaf in self._slot_leaves():
            leaf[:, slot:slot + 1] = request_cache[li][key].to(leaf.dtype)
        row = self._index(table_row)
        r = torch.arange(self.lcap, device=self.device)
        ring = bool(self.cfg.sliding_window) and m == 0
        if ring:
            p_r, valid = M.ring_slot_positions(plen - 1, r, self.lcap,
                                               self.cfg.sliding_window)
        else:
            valid = (r >= m) & (r < plen)
        for li, key, leaf in self._leaves():
            rleaf = request_cache[li][key]           # (ns, 1, cap, ...)
            if ring:
                src = (start + p_r) % rleaf.shape[2]
            else:
                src = torch.clamp(start + r - m, 0, rleaf.shape[2] - 1)
            logical = rleaf[:, 0][:, src]            # (ns, lcap, ...)
            vshape = (1, self.lcap) + (1,) * (logical.dim() - 2)
            logical = torch.where(valid.reshape(vshape), logical,
                                  torch.zeros_like(logical))
            blocks = logical.reshape(
                (logical.shape[0], self.blocks_per_slot,
                 self.block_size) + logical.shape[2:])
            # sentinel-padded rows scatter their tail into trash block 0
            leaf[:, row] = blocks.to(leaf.dtype)

    # ---- prefix index ------------------------------------------------

    def prefix_match(self, prompt) -> Tuple[int, List[int]]:
        """``(m, blocks)``: the longest block-aligned trie prefix of
        ``prompt``, capped at ``plen - 1`` so the divergent tail always
        holds at least one token (the resumed prefill must produce the
        request's first-token logits).  Windowed prompts match only while
        ``plen <= window`` — past it the ring layout diverges from the
        dense one the index describes."""
        if self.prefix is None:
            return 0, []
        plen = len(prompt)
        w = self.cfg.sliding_window
        if w and plen > w:
            return 0, []
        blocks = self.prefix.match(prompt)
        while blocks and len(blocks) * self.block_size > plen - 1:
            blocks.pop()
        return len(blocks) * self.block_size, blocks

    def read_prefix(self, blocks: Sequence[int]):
        """Dense ``(ns, 1, m, ...)`` view of a mapped prefix's paged
        leaves — the ``prefix`` operand of ``models.model.prefill``."""
        idx = self._index(list(blocks))
        nb = len(blocks)
        out: Dict[str, Any] = {}
        for li, key, leaf in self._leaves():
            g = leaf[:, idx]                         # (ns, nb, bs, ...)
            out.setdefault(li, {})[key] = g.reshape(
                (g.shape[0], 1, nb * self.block_size) + g.shape[3:])
        return out

    def _register(self, slot: int, prompt, plen: int, wrap: bool) -> None:
        """Adopt the slot's fully covered prompt blocks into the index
        (the index holds one reference per adopted block)."""
        w = self.cfg.sliding_window
        if w and plen > w:
            return          # ring layout != dense past the window
        nfull = min(plen // self.block_size, len(self._slot_blocks[slot]))
        if nfull <= 0:
            return
        new = self.prefix.insert(prompt, self._slot_blocks[slot][:nfull])
        for b in new:
            self._ref[b] += 1
        if wrap:
            # its own registered blocks are now shared with the index and
            # in the overwrite path of the wrapping ring
            self._cow_debt[slot] += len(new)

    def clear_prefix(self) -> int:
        """Drop every prefix-index reference (a block returns to the free
        list when that was its last one); returns blocks freed."""
        if self.prefix is None:
            return 0
        freed = []
        for b in self.prefix.drop_all():
            self._ref[b] -= 1
            if self._ref[b] <= 0:
                self._ref[b] = 0
                freed.append(int(b))
        self._zero_blocks(freed)
        self._free.extend(freed)
        return len(freed)

    # ---- pool ops ----------------------------------------------------

    def _take(self, slot: int, mapped: List[int], need: int) -> None:
        """Give ``slot`` the blocks ``mapped`` (by reference) followed by
        fresh private ones, ``need`` in all."""
        fresh_n = need - len(mapped)
        if fresh_n > len(self._free):
            raise RuntimeError(
                f"free list underflow: slot {slot} needs {fresh_n} blocks, "
                f"{len(self._free)} free — check can_admit() before admit")
        for b in mapped:
            self._ref[b] += 1
        fresh = [self._free.pop() for _ in range(fresh_n)]
        for b in fresh:
            self._ref[b] = 1
        self._slot_blocks[slot] = mapped + fresh
        self._table[slot] = 0
        self._table[slot, :need] = self._slot_blocks[slot]
        self._table_dev = None
        self.peak_blocks_in_use = max(self.peak_blocks_in_use,
                                      self.blocks_in_use)

    def admit(self, slot: int, request_cache, plen: int, n_tokens: int,
              *, prompt=None, prefix_blocks=None, start: int = 0) -> None:
        """Reserve blocks for ``n_tokens`` total positions and install the
        (batch-1) prefill cache of a ``plen``-token prompt into ``slot``.

        ``prefix_blocks`` (from :meth:`prefix_match`) maps the matched
        blocks by reference — ``request_cache`` is then the *tail* cache
        of the resumed prefill (positions ``m..plen-1``), scattered at
        block offset ``m``.  ``prompt`` (when the prefix index is
        attached) registers the request's fully covered blocks for future
        hits.  ``start`` offsets the source read into ``request_cache`` —
        a packed prefill emits several segments in one stream and each
        segment admits from its own span.  Callers must check
        :meth:`can_admit` first; an insufficient free list here is a
        scheduler bug, not back-pressure.

        A *chunked* admit passes ``plen < plen_total`` with ``n_tokens``
        covering the whole request — the full reservation happens up
        front, later chunks land via :meth:`extend`, and ``prompt=None``
        defers trie registration to :meth:`register_prefix`.
        """
        if self._slot_blocks[slot]:
            raise RuntimeError(f"slot {slot} already holds blocks")
        need = self.blocks_needed(n_tokens)
        mapped = [int(b) for b in (prefix_blocks or [])]
        if len(mapped) > need:
            raise RuntimeError(
                f"slot {slot}: prefix of {len(mapped)} blocks exceeds the "
                f"reservation of {need}")
        self._take(slot, mapped, need)
        row = self._table[slot].copy()
        row[:len(mapped)] = 0        # prefix blocks are never re-written
        self._install(slot, request_cache, row, plen,
                      m=len(mapped) * self.block_size, start=start)
        wrap = self._will_wrap(n_tokens)
        if wrap:
            self._cow_debt[slot] += len(mapped)
        if self.prefix is not None and prompt is not None:
            self._register(slot, prompt, plen, wrap)

    def extend(self, slot: int, request_cache, m: int, new_len: int) -> None:
        """Install a prefill continuation chunk: ``request_cache`` holds
        positions ``m..new_len-1`` of ``slot``'s prompt (the tail cache a
        resumed prefill emits), scattered at block offset ``m`` into the
        slot's *already reserved* blocks.  ``m`` must be block-aligned;
        the first ``m // block_size`` table entries are sentinel'd so the
        chunk's writes never touch blocks earlier chunks filled."""
        if not self._slot_blocks[slot]:
            raise RuntimeError(f"slot {slot} holds no blocks to extend")
        if m % self.block_size:
            raise ValueError(f"extend offset {m} not block-aligned")
        row = self._table[slot].copy()
        row[:m // self.block_size] = 0
        self._install(slot, request_cache, row, new_len, m=m)

    def slot_blocks(self, slot: int) -> List[int]:
        """The slot's physical block ids in logical order (a copy) — the
        chunked scheduler reads back the leading ``done // block_size``
        of these as the prefix operand of the next chunk's resume."""
        return list(self._slot_blocks[slot])

    def register_prefix(self, slot: int, prompt, plen: int,
                        n_tokens: int) -> None:
        """Adopt a completed chunked prefill's prompt blocks into the
        prefix index — the deferred ``prompt=`` leg of :meth:`admit`
        (registering a half-written prompt would serve bogus hits)."""
        if self.prefix is None or prompt is None:
            return
        self._register(slot, prompt, plen, self._will_wrap(n_tokens))

    def fork(self, src: int, dst: int, pos: int, n_tokens: int) -> None:
        """Map ``src``'s content blocks (positions ``< pos``) into ``dst``
        by reference — the parallel-sampling (n>1) primitive: no prefill,
        no copy.  Fresh private blocks cover the rest of ``dst``'s
        reservation.  The first divergent write into the shared boundary
        block — the partially filled one when ``pos % block_size != 0`` —
        copies on write (:meth:`ensure_writable`).  The slot-indexed
        (recurrent) leaves of ``src`` are copied into ``dst``."""
        if self._slot_blocks[dst]:
            raise RuntimeError(f"slot {dst} already holds blocks")
        need = self.blocks_needed(n_tokens)
        content = min(-(-int(pos) // self.block_size), need)
        self._take(dst, [int(b) for b in self._slot_blocks[src][:content]],
                   need)
        for _, _, leaf in self._slot_leaves():
            leaf[:, dst] = leaf[:, src]
        if content:
            if self._will_wrap(n_tokens):
                self._cow_debt[dst] += content   # the ring may reach each
            elif int(pos) % self.block_size:
                self._cow_debt[dst] += 1   # the shared boundary block

    def ensure_writable(self, slot: int, pos: int) -> int:
        """Guarantee the block receiving ``slot``'s write at ``pos`` is
        private: a shared target is copied-on-write into a fresh block
        first (the other referents — sibling slots, the prefix index —
        keep the original bits).  Returns copies made (0 or 1).  The
        scheduler calls this for every decoding slot before each decode
        step; ``has_shared`` short-circuits the common all-private case.
        """
        blocks = self._slot_blocks[slot]
        p = int(pos) % self.lcap if self.cfg.sliding_window else int(pos)
        bi = p // self.block_size
        if bi >= len(blocks):
            return 0
        b = blocks[bi]
        if self._ref[b] <= 1:
            return 0
        if not self._free:
            self._reclaim(1)
        if not self._free:
            raise RuntimeError(
                f"free list underflow on COW for slot {slot} (block {b}) "
                f"— admission under-budgeted its _cow_debt")
        new = self._free.pop()
        self._ref[new] = 1
        self._ref[b] -= 1
        blocks[bi] = new
        self._table[slot, bi] = new
        self._table_dev = None
        for _, _, leaf in self._leaves():
            leaf[:, new] = leaf[:, b]
        self.cow_copies += 1
        if self._cow_debt[slot] > 0:
            self._cow_debt[slot] -= 1
        self.peak_blocks_in_use = max(self.peak_blocks_in_use,
                                      self.blocks_in_use)
        return 1

    def evict(self, slot: int) -> None:
        """Drop the slot's block references: a block is zeroed and
        returned to the free list only when its refcount hits zero —
        blocks still shared with other slots or held by the prefix index
        survive untouched.  The slot's recurrent leaves are zeroed."""
        for _, _, leaf in self._slot_leaves():
            leaf[:, slot] = 0
        freed = []
        for b in self._slot_blocks[slot]:
            self._ref[b] -= 1
            if self._ref[b] <= 0:
                self._ref[b] = 0
                freed.append(b)
        self._zero_blocks(freed)
        self._free.extend(reversed(freed))
        self._slot_blocks[slot] = []
        self._table[slot] = 0
        self._cow_debt[slot] = 0
        self._table_dev = None

    def read_slot(self, slot: int):
        """The (batch-1) *logical* cache view of ``slot``: paged leaves are
        gathered back to position-ordered ``(ns, 1, lcap, ...)`` tensors
        (sentinel blocks read the trash block — callers mask by length),
        and a copy of its slot-indexed leaves, ``(ns, 1, ...)``.
        Tests/inspection."""
        row = self._index(self._table[slot])
        out = {}
        for li, key, leaf in self._leaves():
            g = leaf[:, row]                         # (ns, bps, bs, ...)
            out.setdefault(li, {})[key] = g.reshape(
                (g.shape[0], 1, self.lcap) + g.shape[3:])
        for li, key, leaf in self._slot_leaves():
            out.setdefault(li, {})[key] = leaf[:, slot:slot + 1].clone()
        return out

    def stats(self) -> Dict[str, float]:
        """Occupancy snapshot for ``ServingMetrics.sample_pool`` (see the
        module docstring for the tokens_reserved / tokens_in_use
        contract)."""
        used = self.blocks_in_use
        reserved = sum(len(b) for b in self._slot_blocks)
        return {
            "kv_bytes_in_use": float(used * self.block_bytes),
            "kv_bytes_reserved": float((self.num_blocks - 1)
                                       * self.block_bytes),
            "blocks_in_use": float(used),
            "blocks_total": float(self.num_blocks - 1),
            # logical per-slot reservation: a shared block counts once per
            # referencing slot (what each request would own privately)
            "tokens_reserved": float(reserved * self.block_size),
            # physical occupancy: every allocated block exactly once
            "tokens_in_use": float(used * self.block_size),
            "blocks_shared": float(int((self._ref > 1).sum())),
            "prefix_blocks": float(self.prefix.n_blocks
                                   if self.prefix is not None else 0),
            "cow_copies": float(self.cow_copies),
        }
