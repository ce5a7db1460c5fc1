"""Cross-request KV prefix cache: a radix tree over committed token pages
(a copy of the reference package's ``serve/prefix_cache.py``: host code
over the port's ``BlockPool``).

At production scale most prompts repeat — system prompts, few-shot
preambles, chat history replayed turn after turn.  Recomputing those
prefixes per request wastes device time (TTFT) and recomputing *and*
double-storing them wastes pool pages (admission concurrency).  This
module is the sharing layer the ``BlockPool`` refcounts were built for,
vLLM/SGLang-style:

* **Nodes are whole pages.**  A node at depth ``d`` keys on the exact
  ``page_size`` token ids occupying logical page ``d`` and owns one
  refcounted physical page whose KV bytes were produced by a *committed*
  computation over exactly that token history.  Page granularity keeps
  sharing trivially bit-exact: a matched page is mapped, never recomputed.
* **One tree per prompt bucket.**  Prefill KV at a position is bitwise
  invariant to the *suffix* tokens only within one compiled prompt shape
  (causal masking contributes exact zeros); across buckets the reduction
  shapes differ, so trees never share pages across buckets.
* **Lookup is longest-prefix match** (``match``), walking child pages
  until the first divergence.  A full-prompt match additionally yields the
  stored greedy continuation (``next_token``) — the engine then admits the
  request with *zero* prefill compute.  A partial match maps the covered
  pages and leaves only the uncovered suffix to compute.
* **Ownership is refcounts in the pool.**  The tree holds one reference
  per node (taken at ``insert``); each lane mapping a node's page takes
  its own (``BlockPool.share``).  Freeing is symmetric: a retiring or
  preempted lane drops its references and the tree's copy survives; an
  evicted node drops the tree's reference and an active lane's copy
  survives.  A page never reaches the free heap (and is therefore never
  scrubbed or reallocated) while any reference remains.
* **Eviction is LRU over evictable leaves** — nodes with no children
  whose page only the tree still references.  The engine calls
  ``evict_pages`` when the reserve-watermark admission gate or an urgent
  decode append would otherwise fail: cold cache is reclaimed before any
  running request is preempted.  Evicting a leaf can cascade: its parent
  may become the next evictable leaf.
* **Compaction-safe.**  ``BlockPool.compact`` moves physical pages; the
  engine applies the returned mapping to lane block tables *and* calls
  ``remap`` here, so every owner of a shared page follows it.

The tree is an index, not an owner of device memory beyond its
refcounts: all device bytes live in the engine's ``kv_pool`` buffer and
all moves/scrubs go through the engine's programs.  Methods take a lock
so router threads can probe ``match_len`` while the engine admits.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.serve.kvcache import BlockPool


class _Node:
    """One cached page: ``key`` is the page's exact token ids."""

    __slots__ = ("key", "page_id", "children", "parent", "next_token",
                 "last_use")

    def __init__(self, key: Tuple[int, ...], page_id: int,
                 parent: "_Node"):
        self.key = key
        self.page_id = page_id
        self.children: Dict[Tuple[int, ...], "_Node"] = {}
        self.parent = parent
        # greedy continuation after this page boundary (the first token a
        # full match can emit with no device work); None until known
        self.next_token: Optional[int] = None
        self.last_use = 0

    def depth_first(self):
        stack = [self]
        while stack:
            n = stack.pop()
            yield n
            stack.extend(n.children.values())


@dataclass
class PrefixMatch:
    """Longest-prefix lookup result (page-granular)."""
    pages: List[int] = field(default_factory=list)   # matched physical ids
    tokens: int = 0                                  # matched token count
    next_token: Optional[int] = None                 # set on a full match


class PrefixCache:
    def __init__(self, pool: BlockPool, page_size: int, *,
                 max_nodes: int = 4096):
        if max_nodes < 1:
            raise ValueError("max_nodes must be >= 1")
        self.pool = pool
        self.page_size = page_size
        self.max_nodes = max_nodes
        self._roots: Dict[int, _Node] = {}      # bucket -> sentinel root
        self._lock = threading.Lock()
        self._tick = 0                          # logical LRU clock
        self._n_nodes = 0
        # counters (engine folds these into its prefix_hit_rate gauge)
        self.lookups = 0
        self.inserts = 0
        self.evicted_nodes = 0
        self.evicted_pages = 0

    # -- lookup ----------------------------------------------------------
    def _keys(self, tokens: Sequence[int]) -> List[Tuple[int, ...]]:
        ps = self.page_size
        toks = [int(t) for t in tokens]
        if len(toks) % ps:
            raise ValueError(
                f"prefix cache is page-granular: {len(toks)} tokens is not "
                f"a multiple of page_size {ps}")
        return [tuple(toks[i:i + ps]) for i in range(0, len(toks), ps)]

    def match(self, bucket: int, tokens: Sequence[int]) -> PrefixMatch:
        """Longest page-aligned prefix of ``tokens`` present in the tree.

        Bumps LRU recency on every matched node.  The caller owns taking
        page references (``pool.share``) *before* mapping the pages — a
        match result is only stable until the next eviction otherwise.
        """
        keys = self._keys(tokens)
        out = PrefixMatch()
        with self._lock:
            self.lookups += 1
            self._tick += 1
            node = self._roots.get(bucket)
            if node is None:
                return out
            node.last_use = self._tick
            for key in keys:
                child = node.children.get(key)
                if child is None:
                    return out
                child.last_use = self._tick
                out.pages.append(child.page_id)
                out.tokens += self.page_size
                node = child
            out.next_token = node.next_token
        return out

    def match_len(self, bucket: int, tokens: Sequence[int]) -> int:
        """Matched-token count only — the router's routing probe.  Does
        *not* bump recency: being considered for routing is not a use."""
        ps = self.page_size
        toks = [int(t) for t in tokens[:len(tokens) - len(tokens) % ps]]
        with self._lock:
            node = self._roots.get(bucket)
            if node is None:
                return 0
            n = 0
            for i in range(0, len(toks), ps):
                child = node.children.get(tuple(toks[i:i + ps]))
                if child is None:
                    break
                n += ps
                node = child
            return n

    # -- insertion -------------------------------------------------------
    def insert(self, bucket: int, tokens: Sequence[int],
               page_ids: Sequence[int],
               next_token: Optional[int] = None) -> int:
        """Donate complete committed pages rooted at position 0.

        ``tokens`` must cover whole pages; ``page_ids[i]`` holds the KV of
        page ``i``.  New nodes take a tree-owned reference on their page
        (the caller keeps its own).  Pages whose token content is already
        cached under a different physical id are deduplicated — the
        existing node wins and the caller's copy is simply not pinned.
        ``next_token`` is the greedy continuation after the final page.
        Returns the number of nodes created.
        """
        keys = self._keys(tokens)
        if len(keys) != len(page_ids):
            raise ValueError(f"{len(keys)} pages of tokens but "
                             f"{len(page_ids)} page ids")
        created = 0
        with self._lock:
            self._tick += 1
            node = self._roots.setdefault(bucket, _Node((), -1, None))
            for i, key in enumerate(keys):
                child = node.children.get(key)
                if child is None:
                    pid = int(page_ids[i])
                    self.pool.share([pid])          # the tree's reference
                    child = _Node(key, pid, node)
                    node.children[key] = child
                    self._n_nodes += 1
                    created += 1
                child.last_use = self._tick
                hint = (int(tokens[(i + 1) * self.page_size])
                        if (i + 1) * self.page_size < len(tokens)
                        else next_token)
                if child.next_token is None and hint is not None:
                    child.next_token = int(hint)
                node = child
            self.inserts += created
            if self._n_nodes > self.max_nodes:
                self._evict_locked(self._n_nodes - self.max_nodes,
                                   count_nodes=True)
        return created

    # -- eviction --------------------------------------------------------
    def _leaves(self) -> List[_Node]:
        out = []
        for root in self._roots.values():
            out.extend(n for n in root.depth_first()
                       if n.parent is not None and not n.children)
        return out

    def _evict_locked(self, need: int, *, count_nodes: bool) -> int:
        """Drop LRU evictable leaves until ``need`` pages free (or, with
        ``count_nodes``, until ``need`` nodes dropped).  A leaf whose page
        a lane still references may be dropped from the *index* (it frees
        no memory, so it only counts under ``count_nodes``) — its page
        survives with the lane."""
        done = 0
        while done < need:
            leaves = self._leaves()
            if not count_nodes:
                leaves = [n for n in leaves
                          if self.pool.refcount(n.page_id) == 1]
            if not leaves:
                break
            victim = min(leaves, key=lambda n: n.last_use)
            del victim.parent.children[victim.key]
            self._n_nodes -= 1
            self.evicted_nodes += 1
            freed = self.pool.free([victim.page_id])
            self.evicted_pages += len(freed)
            done += 1 if count_nodes else len(freed)
        return done

    def evict_pages(self, need: int) -> int:
        """Reclaim up to ``need`` pool pages by dropping cold subtrees
        (LRU leaves first, cascading upward).  Respects refcounts: only
        pages the tree alone references can free.  Returns pages freed."""
        with self._lock:
            return self._evict_locked(need, count_nodes=False)

    # -- maintenance -----------------------------------------------------
    def remap(self, mapping: Dict[int, int]) -> None:
        """Follow a ``BlockPool.compact`` move: every node pointing at a
        moved page follows it to the new physical id."""
        if not mapping:
            return
        with self._lock:
            for root in self._roots.values():
                for n in root.depth_first():
                    if n.parent is not None:
                        n.page_id = mapping.get(n.page_id, n.page_id)

    def reclaimable_pages(self) -> int:
        """Pages that an eviction pass could return to the pool right now
        (tree-only references).  The engine advertises these as free-ish:
        they are one ``evict_pages`` call away from admission headroom."""
        with self._lock:
            count = 0
            for root in self._roots.values():
                for n in root.depth_first():
                    if (n.parent is not None
                            and self.pool.refcount(n.page_id) == 1):
                        count += 1
            return count

    def check_invariants(self) -> None:
        """Every node's page must be live in the pool (the tree holds a
        reference, so it can never be on the free heap)."""
        with self._lock:
            n = 0
            for root in self._roots.values():
                for node in root.depth_first():
                    if node.parent is None:
                        continue
                    n += 1
                    if self.pool.refcount(node.page_id) < 1:
                        raise AssertionError(
                            f"tree node holds freed page {node.page_id}")
                    if len(node.key) != self.page_size:
                        raise AssertionError("non-page-sized node key")
            if n != self._n_nodes:
                raise AssertionError(
                    f"node count drift: walked {n}, tracked {self._n_nodes}")

    def stats(self) -> dict:
        with self._lock:
            return {"nodes": self._n_nodes,
                    "buckets": len(self._roots),
                    "lookups": self.lookups,
                    "inserts": self.inserts,
                    "evicted_nodes": self.evicted_nodes,
                    "evicted_pages": self.evicted_pages}

    @property
    def nodes(self) -> int:
        with self._lock:
            return self._n_nodes
