"""Paged KV-cache bookkeeping: refcounted blocks, a prefix trie, and
per-slot block tables (the port's own copy of the reference module).

The device side (models.transformer.init_paged_cache / paged_step) sees one
physical pool of `num_blocks` blocks per layer — [L, NB, block_size, KH, dh]
— plus an int32 block table [n_slots, max_blocks] mapping each slot's
logical block index to a physical block id. Everything in THIS module is
host-side numpy/python: allocation decisions are control flow, not compute,
exactly as a production engine keeps its allocator off the accelerator.

Conventions shared with the device step:
  * physical block 0 is the TRASH block — never allocated; masked-out
    (invalid-lane) cache writes are pointed at it, and unallocated block-
    table entries hold 0. Its contents are garbage by design and are never
    read with non-zero attention weight (positions >= slot length are
    masked before the softmax).
  * a slot's window is max_blocks × block_size tokens; block tables are
    dense int32 rows so they ship to the device step as a plain [B, MB]
    operand.

Block lifecycle (PR 7 — the prefix-sharing redesign):

  * every live block carries a REFCOUNT: one ref per slot table that maps
    it, plus one ref if the prefix trie caches it. `acquire(n)` pops fresh
    blocks at refcount 1; `incref`/`decref` move sharers on and off; a
    block returns to the free list only when its last ref drops. There is
    no reservation ledger any more — admission is watermark-based and the
    scheduler preempts under pressure (runtime.server).
  * the PREFIX TRIE maps chains of full-block token prefixes to the block
    chain that already caches them. K/V content is a pure function of the
    absolute-position token prefix, so two requests sharing a prompt
    prefix can map the SAME physical blocks: zero prefill compute and
    zero new HBM for the shared span. Only FULL blocks are cached — a
    partially filled tail block's future contents depend on tokens the
    next request may not share.
  * sharing makes writes dangerous: a lane must never write into a block
    another holder can read. The scheduler copy-on-write-forks any shared
    block it is about to write (runtime.server._ensure_private via
    models.transformer.cow_copy_block) — the allocator's `refcount()` is
    the is-it-shared oracle.

LIFO free list, as before: freshly freed blocks are re-issued first, the
adversarial order for stale-contents bugs.
"""
from __future__ import annotations

import dataclasses

import numpy as np

TRASH_BLOCK = 0  # physical block 0: write sink for masked lanes, never allocated


@dataclasses.dataclass
class AllocatorStats:
    """Pool accounting. `in_use` counts blocks with refcount >= 1 (this
    includes blocks held only by the prefix trie — evictable cache, not
    leaked memory); `shared` counts blocks with refcount >= 2."""
    num_blocks: int           # usable blocks (excludes the trash block)
    in_use: int = 0
    shared: int = 0           # refcount >= 2: mapped by >1 holder
    peak_in_use: int = 0
    total_allocs: int = 0
    total_frees: int = 0

    @property
    def free(self) -> int:
        return self.num_blocks - self.in_use

    @property
    def private(self) -> int:
        """Blocks held by exactly one holder (refcount == 1)."""
        return self.in_use - self.shared


class BlockAllocator:
    """Refcounted free-list allocator over physical KV blocks 1..num_blocks.

    The PR-7 surface: `acquire(n)` pops n blocks at refcount 1,
    `incref(ids)` adds a holder, `decref(ids)` drops one and frees blocks
    whose count reaches 0 (returning them so callers can account). The
    old reservation API (reserve/unreserve/allocate/free) is gone — the
    server's watermark admission + preemption replaced it.
    """

    def __init__(self, num_blocks: int):
        if num_blocks < 1:
            raise ValueError("need at least 1 usable block beyond the trash "
                             f"block, got num_blocks={num_blocks}")
        # physical ids 1..num_blocks; 0 is the trash block
        self._free: list[int] = list(range(num_blocks, 0, -1))
        self._ref = np.zeros(num_blocks + 1, np.int64)
        self.stats = AllocatorStats(num_blocks=num_blocks)

    def refcount(self, block: int) -> int:
        return int(self._ref[block])

    def can_acquire(self, n: int) -> bool:
        return n <= len(self._free)

    def acquire(self, n: int) -> list[int]:
        """Pop n fresh physical block ids, each at refcount 1. The server
        checks capacity (and evicts/preempts) first, so exhaustion here is
        a scheduler logic bug, not an operating condition."""
        if n > len(self._free):
            raise RuntimeError(
                f"KV block pool exhausted: want {n}, free {len(self._free)} "
                "— the scheduler must evict or preempt before acquiring")
        ids = [self._free.pop() for _ in range(n)]
        for b in ids:
            self._ref[b] = 1
        st = self.stats
        st.in_use += n
        st.total_allocs += n
        st.peak_in_use = max(st.peak_in_use, st.in_use)
        return ids

    def incref(self, ids: list[int]) -> None:
        """Add one holder to each block (a slot table mapping it, the
        prefix trie caching it, or a pending fork stash)."""
        for b in ids:
            assert b != TRASH_BLOCK, "refcounting the trash block"
            assert self._ref[b] >= 1, f"incref on unallocated block {b}"
            self._ref[b] += 1
            if self._ref[b] == 2:
                self.stats.shared += 1

    def decref(self, ids: list[int]) -> list[int]:
        """Drop one holder from each block; blocks reaching refcount 0 go
        back on the free list. Returns the freed ids."""
        freed = []
        for b in ids:
            assert b != TRASH_BLOCK, "freeing the trash block"
            assert self._ref[b] >= 1, f"decref on free block {b}"
            self._ref[b] -= 1
            if self._ref[b] == 1:
                self.stats.shared -= 1
            elif self._ref[b] == 0:
                self._free.append(b)
                freed.append(b)
        self.stats.in_use -= len(freed)
        self.stats.total_frees += len(freed)
        return freed


class _TrieNode:
    __slots__ = ("tokens", "block", "parent", "children", "tick")

    def __init__(self, tokens: tuple, block: int, parent):
        self.tokens = tokens          # this block's token chunk (len == bs)
        self.block = block            # physical block id caching it
        self.parent = parent
        self.children: dict[tuple, _TrieNode] = {}
        self.tick = 0                 # LRU clock value of last touch


class PrefixTrie:
    """Token-prefix chain → physical block chain, for prefix-shared
    admission.

    Each node caches ONE full block: the node's path from the root spells
    a token prefix of length depth × block_size, and `node.block` is the
    physical block holding that chunk's K/V (valid because K/V content is
    a pure function of the absolute-position token prefix — RoPE phases
    and projections depend only on the tokens before it).

    The trie holds its OWN reference on every cached block (incref on
    insert), so cached prefixes survive the request that produced them.
    Cached-but-unshared blocks (refcount == 1, the trie's) are the
    evictable pool: `evict()` LRU-frees leaves first, never touching a
    block a live slot still maps. Matching is exact (nested dicts keyed
    by token tuples) — no hash collisions to reason about.
    """

    def __init__(self, block_size: int):
        self.block_size = block_size
        self._root = _TrieNode((), TRASH_BLOCK, None)
        self._by_block: dict[int, _TrieNode] = {}
        self._clock = 0
        self.hits = 0            # match() calls that returned >= 1 block
        self.hit_blocks = 0      # blocks returned across all matches
        self.evictions = 0       # blocks freed by evict()/forget_block()
        self.sweeps = 0          # watermark sweeps that freed something
        self.sweep_freed = 0     # blocks freed by those sweeps

    # -- introspection -----------------------------------------------------
    @property
    def cached_blocks(self) -> int:
        return len(self._by_block)

    def owns(self, block: int) -> bool:
        return block in self._by_block

    def cached_cold(self, alloc: BlockAllocator) -> int:
        """Blocks whose ONLY holder is the trie (refcount == 1): the cold
        prefix cache. Unlike evictable() this ignores subtree structure —
        it answers "how much of the pool is cache, not live state", the
        composition split."""
        return sum(1 for b in self._by_block if alloc.refcount(b) == 1)

    def evictable(self, alloc: BlockAllocator) -> int:
        """Blocks evict() could free right now: nodes whose block has no
        holder besides the trie AND whose whole subtree is likewise free
        (leaf-first eviction cannot reach past an in-use descendant)."""

        def walk(node) -> tuple[int, bool]:
            count, all_ev = 0, True
            for ch in node.children.values():
                c, ev = walk(ch)
                count += c
                all_ev &= ev
            mine = alloc.refcount(node.block) == 1 and all_ev
            return count + (1 if mine else 0), mine

        return sum(walk(ch)[0] for ch in self._root.children.values())

    # -- lookup / registration --------------------------------------------
    def match(self, tokens: list) -> list[int]:
        """Longest chain of cached full blocks prefixing `tokens`.

        Callers that need at least one token left to prefill (the step
        must run SOME token to produce first-emission logits) pass
        tokens[:-1]."""
        bs = self.block_size
        node, out = self._root, []
        self._clock += 1
        for i in range(len(tokens) // bs):
            child = node.children.get(tuple(tokens[i * bs:(i + 1) * bs]))
            if child is None:
                break
            child.tick = self._clock
            out.append(child.block)
            node = child
        if out:
            self.hits += 1
            self.hit_blocks += len(out)
        return out

    def insert(self, tokens: list, blocks: list[int],
               alloc: BlockAllocator) -> int:
        """Register `blocks` as the cache of `tokens` (full blocks only;
        len(tokens) == len(blocks) × block_size). Chunks already cached
        keep their canonical block — the caller's duplicate stays owned by
        the caller alone (content is identical by purity, so either copy
        serves future matches). Newly registered blocks get the trie's
        ref. Returns how many were newly registered."""
        bs = self.block_size
        assert len(tokens) == len(blocks) * bs, (len(tokens), len(blocks))
        node, added = self._root, 0
        self._clock += 1
        for i, block in enumerate(blocks):
            chunk = tuple(tokens[i * bs:(i + 1) * bs])
            child = node.children.get(chunk)
            if child is None:
                assert block not in self._by_block, \
                    f"block {block} cached under two prefixes"
                child = _TrieNode(chunk, block, node)
                node.children[chunk] = child
                self._by_block[block] = child
                alloc.incref([block])
                added += 1
            child.tick = self._clock
            node = child
        return added

    # -- eviction ----------------------------------------------------------
    def _drop_node(self, node: _TrieNode, alloc: BlockAllocator) -> int:
        """Remove one node (must be childless) and release the trie's ref;
        returns 1 if the block actually went back to the free list."""
        assert not node.children
        del node.parent.children[node.tokens]
        del self._by_block[node.block]
        freed = alloc.decref([node.block])
        self.evictions += len(freed)
        return len(freed)

    def evict(self, n: int, alloc: BlockAllocator) -> int:
        """Free up to n blocks, LRU leaves first (a removed leaf may expose
        its parent as the next candidate). Leaves whose block a live slot
        still maps (refcount > 1) are skipped — dropping them would free
        nothing. Returns blocks actually freed."""
        freed = 0
        while freed < n:
            best = None
            stack = list(self._root.children.values())
            while stack:
                node = stack.pop()
                if node.children:
                    stack.extend(node.children.values())
                elif alloc.refcount(node.block) == 1:
                    if best is None or node.tick < best.tick:
                        best = node
            if best is None:
                break
            freed += self._drop_node(best, alloc)
        return freed

    def sweep(self, alloc: BlockAllocator, high: int, low: int) -> int:
        """High/low-watermark capacity sweep: when the trie caches more
        than `high` blocks, LRU-evict down toward `low` (both absolute
        block counts — the server derives them from a pool fraction,
        ServingConfig.trie_watermark). The point: a long-lived server's
        trie otherwise retains every cold prefix it ever saw, pinning the
        whole pool as cache between bursts; the sweep runs from step()
        even on idle steps, so capacity drains back WITHOUT waiting for
        admission pressure. Best-effort: entries whose block a live slot
        still maps are skipped (evicting them would free nothing).
        Returns blocks actually freed; hysteresis (low < high) keeps the
        sweep from thrashing at the threshold."""
        if low > high:
            raise ValueError(f"low watermark {low} > high {high}")
        if self.cached_blocks <= high:
            return 0
        freed = self.evict(self.cached_blocks - low, alloc)
        if freed:
            self.sweeps += 1
            self.sweep_freed += freed
        return freed

    def forget_block(self, block: int, alloc: BlockAllocator) -> None:
        """Drop the cache entry for `block` (and its whole subtree — the
        children's prefixes extend through it). Used by the scheduler's
        write path: when the only other holder of a to-be-written block is
        the trie, un-caching it beats copy-on-write (no copy, no new
        block). Subtree blocks shared with live slots survive the decref;
        only the cache entries go."""
        node = self._by_block.get(block)
        if node is None:
            return
        # post-order: children before parents (children hold no structural
        # refs on the parent, but _drop_node asserts childlessness)
        def drop(nd):
            for ch in list(nd.children.values()):
                drop(ch)
            self._drop_node(nd, alloc)
        drop(node)

    def flush(self, alloc: BlockAllocator) -> int:
        """Evict every entry (in-use blocks merely lose their cache ref).
        Returns blocks freed."""
        freed = 0
        for ch in list(self._root.children.values()):
            before = self.evictions
            self.forget_block(ch.block, alloc)
            freed += self.evictions - before
        return freed


class SlotTables:
    """Host-side block tables + lengths for a pool of serving slots."""

    def __init__(self, n_slots: int, max_blocks: int, block_size: int):
        self.block_size = block_size
        self.max_blocks = max_blocks
        self.tables = np.full((n_slots, max_blocks), TRASH_BLOCK, np.int32)
        self.lens = np.zeros(n_slots, np.int32)      # tokens written per slot
        self.n_alloc = np.zeros(n_slots, np.int32)   # blocks held per slot

    def blocks_for(self, n_tokens: int) -> int:
        return -(-n_tokens // self.block_size)

    def held(self, slot: int) -> list[int]:
        return [int(b) for b in self.tables[slot, :int(self.n_alloc[slot])]]

    def assign(self, slot: int, blocks: list[int], n_tokens: int) -> None:
        """Install an existing block chain (a trie-matched prefix or a fork
        stash) covering the slot's first n_tokens. The caller has already
        incref'd `blocks` on this slot's behalf."""
        assert int(self.n_alloc[slot]) == 0, "assign into a dirty slot"
        assert len(blocks) <= self.max_blocks
        self.tables[slot, :len(blocks)] = blocks
        self.n_alloc[slot] = len(blocks)
        self.lens[slot] = n_tokens

    def grow(self, slot: int, new_len: int, alloc: BlockAllocator) -> None:
        """Extend slot's table so positions [0, new_len) are backed."""
        need = self.blocks_for(new_len)
        have = int(self.n_alloc[slot])
        if need > have:
            ids = alloc.acquire(need - have)
            self.tables[slot, have:need] = ids
            self.n_alloc[slot] = need

    def replace(self, slot: int, idx: int, new_block: int,
                alloc: BlockAllocator) -> None:
        """Point logical block idx at a private copy (CoW fork): the slot
        drops its ref on the shared original and maps `new_block` (already
        acquired at refcount 1 by the caller, contents device-copied)."""
        old = int(self.tables[slot, idx])
        assert old != TRASH_BLOCK and idx < int(self.n_alloc[slot])
        self.tables[slot, idx] = new_block
        alloc.decref([old])

    def release(self, slot: int, alloc: BlockAllocator) -> list[int]:
        """Drop the slot's ref on every held block; blocks shared with the
        trie or other holders survive. Returns the blocks actually freed."""
        freed = alloc.decref(self.held(slot))
        self.tables[slot, :] = TRASH_BLOCK
        self.n_alloc[slot] = 0
        self.lens[slot] = 0
        return freed
