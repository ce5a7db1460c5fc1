"""Paged device memory for KV caches (paper §3.4): the reference's
``serve/kvcache.py`` on PyTorch.

* ``BlockPool`` — the host-side allocator of fixed-size pages, with
  reference counts, an admission watermark and compaction (a copy of the
  reference's).
* **block table** — per-lane ``(max_blocks,)`` int32 rows mapping logical
  page -> physical page (-1 = unmapped).
* device helpers — tensor functions with no host read of device memory:
  ``gather_lane_cache`` / ``extract_written_page`` / ``scatter_pages`` /
  ``scatter_prefill`` / ``scrub_pages`` / ``compact_pool`` /
  ``extract_pool_pages`` / ``install_pool_pages`` /
  ``apply_block_table_delta``.

Pool layout.  The reference discovers each cache leaf's token axis by
diffing two prefill lengths; here it is the port's own attention cache
layout (``models/attention.py:gqa_cache_spec``), known statically.  A lane
cache holds, per attention block, ``k``/``v`` of shape
``(*lead, 1, S, Hkv, hd)`` and ``kv_pos`` of shape ``(*lead, S)``, where
``lead`` is the stacked layer axis.  Its pool leaf is
``(NP + 1, *lead, ps, Hkv, hd)`` and ``(NP + 1, *lead, ps)``: the page axis
first (the contract with the buffer table's page-granular dirtiness),
then each page's ``ps`` slots contiguous per layer, so one layer's view
``pool[:, i]`` is what K1's paged entry point reads in place.

Page ``NP``, one past the last real page, is a **sink**: a write that the
reference drops (an out-of-range id, an unmapped page, an inactive lane)
is sent there instead, so no helper has to read an index back to the host
to drop it.  Nothing maps the sink, no EXECUTE reports it dirty, and a
gather never returns its contents as a valid slot.

The helpers update the pool in place (it is the EXECUTE's donated buffer)
and return it.
"""

from __future__ import annotations

import heapq
import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.state import tree_bytes
from repro_torch.kernels.decode_attention.ref import gather_pages
from repro_torch.models.attention import _INVALID_POS

# one exported byte-accounting helper (shared with the buffer state machine)
cache_bytes = tree_bytes

_KV = ("k", "v")
_POS = "kv_pos"


def _map_named(fn, tree, *rest):
    """``tree_map`` that also passes each leaf's dict key (its name)."""
    if isinstance(tree, dict):
        return {k: (fn(k, v, *(r[k] for r in rest))
                    if not isinstance(v, (dict, list, tuple))
                    else _map_named(fn, v, *(r[k] for r in rest)))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_named(fn, x, *(r[i] for r in rest))
                          for i, x in enumerate(tree))
    raise ValueError(f"cache leaf outside a named dict: {type(tree)}")


def _check_name(name: str) -> None:
    if name not in _KV and name != _POS:
        raise ValueError(
            f"cannot page cache leaf {name!r}: only attention k/v/kv_pos "
            "leaves have a token axis (SSM, RG-LRU and ring caches do not); "
            "run the engine with paged=False")


def init_caches_from_specs(specs, device):
    """Zeros for k/v leaves; the INVALID sentinel for kv_pos leaves."""
    def mk(name, leaf):
        if name == _POS:
            return torch.full(leaf.shape, _INVALID_POS, dtype=torch.int32,
                              device=device)
        return torch.zeros(leaf.shape, dtype=leaf.dtype, device=device)

    return _map_named(mk, specs)


def pages_for_tokens(n_tokens: int, page_size: int) -> int:
    return max(1, math.ceil(n_tokens / page_size))


# ---------------------------------------------------------------------------
# Host-side page allocator
# ---------------------------------------------------------------------------
class BlockPoolError(RuntimeError):
    pass


class BlockPool:
    """Fixed-size page allocator over the device KV pool.

    Deterministic by construction (lowest free id first) so paged decoding
    replays bit-exactly across evict/resume.  ``reserve_pages`` is the
    admission watermark: normal allocations keep that many pages free for
    in-flight decode appends; ``urgent=True`` (the append path) may dip
    into the reserve — when even that fails the engine preempts a lane.
    """

    def __init__(self, num_pages: int, page_size: int, *,
                 reserve_pages: int = 0):
        if num_pages <= 0 or page_size <= 0:
            raise ValueError("need num_pages > 0 and page_size > 0")
        if reserve_pages >= num_pages:
            raise ValueError("reserve watermark leaves no usable pages")
        self.num_pages = num_pages
        self.page_size = page_size
        self.reserve_pages = reserve_pages
        self._free: List[int] = list(range(num_pages))
        heapq.heapify(self._free)
        self._used: set = set()
        # reference counts: ``free`` drops one reference; a page returns to
        # the free heap only when its last reference drops
        self._rc: Dict[int, int] = {}

    # -- accounting ------------------------------------------------------
    def free_count(self) -> int:
        return len(self._free)

    def used_count(self) -> int:
        return len(self._used)

    def refcount(self, page_id: int) -> int:
        return self._rc.get(page_id, 0)

    def shared_count(self) -> int:
        """Pages currently referenced by more than one owner."""
        return sum(1 for c in self._rc.values() if c > 1)

    def occupancy(self) -> float:
        return len(self._used) / self.num_pages

    def used_span(self) -> int:
        """High-water mark: 1 + the highest physical id in use."""
        return max(self._used) + 1 if self._used else 0

    def pages_for_tokens(self, n_tokens: int) -> int:
        return pages_for_tokens(n_tokens, self.page_size)

    def can_admit(self, n_pages: int) -> bool:
        return self.free_count() - n_pages >= self.reserve_pages

    # -- alloc / free ----------------------------------------------------
    def alloc(self, n_pages: int, *, urgent: bool = False,
              ) -> Optional[List[int]]:
        """Allocate ``n_pages`` (lowest ids first), or None if the request
        would breach the watermark (``urgent`` ignores the watermark)."""
        avail = self.free_count() - (0 if urgent else self.reserve_pages)
        if n_pages > avail:
            return None
        out = [heapq.heappop(self._free) for _ in range(n_pages)]
        self._used.update(out)
        for p in out:
            self._rc[p] = 1
        return out

    def share(self, page_ids: Sequence[int]) -> None:
        """Add one reference to each (already used) page."""
        for p in page_ids:
            if p not in self._used:
                raise BlockPoolError(f"share of free page {p}")
            self._rc[p] += 1

    def free(self, page_ids: Sequence[int]) -> List[int]:
        """Drop one reference per page; returns the pages whose *last*
        reference dropped (those actually returned to the free heap)."""
        out: List[int] = []
        for p in page_ids:
            if p not in self._used:
                raise BlockPoolError(f"double free of page {p}")
            self._rc[p] -= 1
            if self._rc[p] == 0:
                del self._rc[p]
                self._used.discard(p)
                heapq.heappush(self._free, p)
                out.append(p)
        return out

    def free_tail(self, page_ids: Sequence[int], keep: int) -> List[int]:
        """Drop this owner's reference on ``page_ids[keep:]`` and return
        the pages that actually freed (a shared tail page is unshared)."""
        if keep < 0:
            raise ValueError("keep must be >= 0")
        return self.free(list(page_ids[keep:]))

    # -- defragmentation -------------------------------------------------
    def compact(self) -> Dict[int, int]:
        """Pack used pages into the lowest physical ids.  Returns
        {old_id: new_id} for every page that moves (destinations are free
        before the call, so one gather+scatter applies the whole mapping);
        reference counts travel with their pages."""
        k = len(self._used)
        dests = [i for i in range(k) if i not in self._used]
        movers = [p for p in sorted(self._used) if p >= k]
        mapping = dict(zip(movers, dests))
        if mapping:
            self._used = (self._used - set(movers)) | set(mapping.values())
            self._free = [i for i in range(self.num_pages)
                          if i not in self._used]
            heapq.heapify(self._free)
            for old, new in mapping.items():
                self._rc[new] = self._rc.pop(old)
        return mapping

    def check_invariants(self) -> None:
        free = set(self._free)
        if len(free) != len(self._free):
            raise BlockPoolError("duplicate ids in free list")
        if free & self._used:
            raise BlockPoolError("page both free and used")
        if free | self._used != set(range(self.num_pages)):
            raise BlockPoolError("pages leaked from the pool")
        if set(self._rc) != self._used:
            raise BlockPoolError("refcount map out of sync with used set")
        if any(c < 1 for c in self._rc.values()):
            raise BlockPoolError("used page with refcount < 1")


# ---------------------------------------------------------------------------
# Pool construction
# ---------------------------------------------------------------------------
def pool_specs_from_lane_cache(lane_cache_abs, num_pages: int,
                               page_size: int, prompt_len: int):
    """A one-lane prefill cache's specs (``cache_margin=0``, ``prompt_len``
    tokens) -> the pool's specs, ``num_pages`` real pages plus the sink.
    Raises for leaves that have no token axis of the prompt's length
    (SSM/RG-LRU states, window-bounded rings): those need reserved mode."""
    meta = torch.device("meta")

    def mk(name, leaf):
        _check_name(name)
        shp = tuple(leaf.shape)
        if name == _POS:
            lead, S, rest = shp[:-1], shp[-1], ()
        else:
            if len(shp) < 4 or shp[-4] != 1:
                raise ValueError(f"cannot page {name} leaf {shp}: expected "
                                 "(*layers, 1, S, Hkv, hd)")
            lead, S, rest = shp[:-4], shp[-3], shp[-2:]
        if S != prompt_len:
            raise ValueError(
                f"cannot page cache leaf {name} {shp}: its token axis holds "
                f"{S} slots for a {prompt_len}-token prompt (window-bounded "
                "ring cache?); run the engine with paged=False")
        return torch.empty((num_pages + 1,) + lead + (page_size,) + rest,
                           dtype=leaf.dtype, device=meta)

    return _map_named(mk, lane_cache_abs)


def _n_real(leaf: torch.Tensor) -> int:
    return leaf.shape[0] - 1


def _to_sink(ids: torch.Tensor, n_real: int) -> torch.Tensor:
    """Page ids as int64 with every id outside [0, n_real) sent to the
    sink page ``n_real``."""
    ids = ids.to(torch.int64)
    return torch.where((ids >= 0) & (ids < n_real), ids,
                       torch.full_like(ids, n_real))


def _ids(x, device) -> torch.Tensor:
    """Page-id vector on ``device`` (host arrays and tensors alike)."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.as_tensor(np.asarray(x, np.int64), device=device)


def _slot_axis(name: str, leaf: torch.Tensor) -> int:
    """Axis of a pool leaf that holds a page's slots."""
    return leaf.dim() - (1 if name == _POS else 3)


# ---------------------------------------------------------------------------
# Device helpers
# ---------------------------------------------------------------------------
def gather_lane_cache(pool, block_row: torch.Tensor, *, page_size: int):
    """One lane's logical cache from the pool through its block-table row
    ``(max_blocks,)``: k/v ``(*lead, 1, max_blocks * ps, Hkv, hd)``, kv_pos
    ``(*lead, max_blocks * ps)``.  Unmapped pages (id < 0) are clamped for
    the gather and their positions forced to INVALID, so attention masks
    them whatever the clamped page holds (``gather_pages``)."""
    def gk(name, leaf):
        _check_name(name)
        ax = _slot_axis(name, leaf)
        flat = gather_pages(leaf, block_row, slot_axis=ax,
                            page_size=page_size, positions=name == _POS)
        return flat if name == _POS else flat.unsqueeze(ax - 1)

    return _map_named(gk, pool)


def extract_written_page(new_lane_cache, logical_page, *, page_size: int):
    """The page holding logical page ``logical_page`` (a 0-d tensor or an
    int) of a lane cache, in the pool's page layout ``(*lead, ps, *rest)``."""
    def ex(name, leaf):
        _check_name(name)
        lp = torch.as_tensor(logical_page, dtype=torch.int64,
                             device=leaf.device)
        idx = lp * page_size + torch.arange(page_size, device=leaf.device)
        if name == _POS:
            return leaf.index_select(leaf.dim() - 1, idx)
        return leaf.squeeze(-4).index_select(leaf.dim() - 4, idx)

    return _map_named(ex, new_lane_cache)


def scatter_pages(pool, phys_ids, pages):
    """Write per-lane pages ``(lanes, *lead, ps, *rest)`` into the pool at
    ``phys_ids`` ``(lanes,)``; out-of-range ids go to the sink (the
    reference drops them).  Active lanes own disjoint pages."""
    def sc(name, leaf, page):
        ids = _to_sink(_ids(phys_ids, leaf.device), _n_real(leaf))
        return leaf.index_copy_(0, ids, page.to(leaf.dtype))

    return _map_named(sc, pool, pages)


def scatter_prefill(pool, page_ids, pf_cache, *, page_size: int,
                    prompt_len: int):
    """Admission: distribute a one-lane prefill cache over freshly
    allocated pages.  The tail page's unfilled slots get zeros / INVALID
    positions, so decode can write into them later without a scrub."""
    def sc(name, leaf, pf):
        ids = _ids(page_ids, leaf.device).to(torch.int64)
        n_pp = ids.shape[0]
        pad = n_pp * page_size - prompt_len
        if name == _POS:
            vals = pf                              # (*lead, P)
            fill = torch.full(pf.shape[:-1] + (pad,), _INVALID_POS,
                              dtype=torch.int32, device=pf.device)
            ax = pf.dim() - 1
        else:
            vals = pf.squeeze(-4)                  # (*lead, P, Hkv, hd)
            fill = torch.zeros(vals.shape[:-3] + (pad,) + vals.shape[-2:],
                               dtype=vals.dtype, device=vals.device)
            ax = vals.dim() - 3
        if pad:
            vals = torch.cat([vals, fill], dim=ax)
        vals = vals.reshape(vals.shape[:ax] + (n_pp, page_size)
                            + vals.shape[ax + 1:]).movedim(ax, 0)
        return leaf.index_copy_(0, _to_sink(ids, _n_real(leaf)),
                                vals.to(leaf.dtype))

    return _map_named(sc, pool, pf_cache)


def scrub_pages(pool, page_ids):
    """Invalidate the kv_pos rows of (re)allocated pages — freed-memory
    zeroing (§3.4): the previous owner's k/v bytes are unreachable once
    their positions read INVALID.  Out-of-range ids are padding."""
    def f(name, leaf):
        if name == _POS:
            ids = _to_sink(_ids(page_ids, leaf.device), _n_real(leaf))
            leaf.index_fill_(0, ids, _INVALID_POS)
        return leaf

    return _map_named(f, pool)


def extract_pool_pages(pool, page_ids):
    """Whole pages by physical id into a staging tree ``(width, *page)``;
    out-of-range ids are padding (clamped for the gather)."""
    def f(name, leaf):
        ids = _ids(page_ids, leaf.device).to(torch.int64)
        return leaf.index_select(0, ids.clamp(0, _n_real(leaf) - 1))

    return _map_named(f, pool)


def install_pool_pages(pool, staged, page_ids):
    """Scatter a staged page tree into the pool at ``page_ids`` (whole
    pages overwritten, so no scrub); padding ids go to the sink."""
    def f(name, leaf, pg):
        ids = _to_sink(_ids(page_ids, leaf.device), _n_real(leaf))
        return leaf.index_copy_(0, ids, pg.to(leaf.dtype))

    return _map_named(f, pool, staged)


def compact_pool(pool, src_ids, dst_ids):
    """Apply a ``BlockPool.compact`` mapping on the device: page ``src``
    moves to ``dst`` for each pair (gather first, then scatter:
    destinations were free).  Padding entries go to the sink."""
    def f(name, leaf):
        src = _ids(src_ids, leaf.device).to(torch.int64)
        dst = _to_sink(_ids(dst_ids, leaf.device), _n_real(leaf))
        moved = leaf.index_select(0, src.clamp(0, _n_real(leaf) - 1))
        return leaf.index_copy_(0, dst, moved)

    return _map_named(f, pool)


def apply_block_table_delta(block_table: torch.Tensor, delta):
    """Apply ``(width, 3)`` int32 rows of ``(slot, logical_page, phys)`` to
    the device-resident block table, in row order: ``slot < 0`` is padding;
    ``logical_page < 0`` clears the whole row to -1; otherwise one cell is
    set.  ``delta`` is host data (the EXECUTE's const arg), so the rows are
    folded on the host into one row clear and one cell scatter with the
    same result as applying them one by one; the table itself is updated
    in place on its device and never read back."""
    rows = np.asarray(delta.cpu() if isinstance(delta, torch.Tensor)
                      else delta, np.int64).reshape(-1, 3)
    B, max_blocks = block_table.shape
    cleared: set = set()
    cells: Dict[tuple, int] = {}
    for s, lp, v in rows.tolist():
        if s < 0:
            continue
        s = min(s, B - 1)
        if lp < 0:
            cleared.add(s)
            for key in [c for c in cells if c[0] == s]:
                del cells[key]
        else:
            cells[(s, min(lp, max_blocks - 1))] = v
    dev = block_table.device
    if cleared:
        block_table[torch.tensor(sorted(cleared), device=dev)] = -1
    if cells:
        idx = torch.tensor(list(cells), dtype=torch.int64, device=dev)
        block_table[idx[:, 0], idx[:, 1]] = torch.tensor(
            list(cells.values()), dtype=block_table.dtype, device=dev)
    return block_table
