"""The port's paged KV subsystem (``repro_torch/serve/kvcache.py``) against
the reference's (``repro/serve/kvcache.py``) on the same random pools.

Pools are made with numpy from a seed in the reference's layout
``(NP, ps, layers, 1, heads, hd)`` and converted to the port's
``(NP + 1, layers, ps, heads, hd)`` (page NP the sink).  Page and index
moves are compared exactly; values too, since both sides only copy them.
Also: the ``BlockPool`` hypothesis state machine of ``tests/test_kvcache.py``
on the port's allocator, the buffer table's page-granular dirtiness, and
the paged decode's plain version against the reference's
``gather_lane_cache`` + ``sdpa_naive`` (f32 to 1e-5, bf16 to 2e-2: the two
frameworks round scores and probabilities to bf16 at the same points but
sum in different orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.models.attention import sdpa_naive as jax_sdpa  # noqa: E402
from repro.serve import kvcache as jkv  # noqa: E402
from repro_torch.core.state import BufferTable  # noqa: E402
from repro_torch.kernels.decode_attention.ref import (  # noqa: E402
    decode_attention_paged_ref)
from repro_torch.serve import kvcache as tkv  # noqa: E402

try:
    from hypothesis import settings
    from hypothesis import strategies as st
    from hypothesis.stateful import (RuleBasedStateMachine, invariant,
                                     precondition, rule)
    HAS_HYPOTHESIS = True
except ImportError:
    HAS_HYPOTHESIS = False

INVALID = 2 ** 30
PS, NP_, MB, L, H, HD = 4, 7, 3, 2, 2, 3
AXES = {"k": 2, "v": 2, "kv_pos": 1}     # the reference's token axes


def _jax_pool(rng):
    """A random pool in the reference's layout (positions random ints)."""
    return {"k": rng.standard_normal((NP_, PS, L, 1, H, HD),
                                     dtype=np.float32),
            "v": rng.standard_normal((NP_, PS, L, 1, H, HD),
                                     dtype=np.float32),
            "kv_pos": rng.integers(0, 50, (NP_, PS, L)).astype(np.int32)}


def _to_port(jp):
    """Reference layout -> the port's, with a sink page appended."""
    out = {}
    for name, x in jp.items():
        x = np.asarray(x)
        if name == "kv_pos":
            y = x.transpose(0, 2, 1)
            sink = np.full((1,) + y.shape[1:], INVALID, np.int32)
        else:
            y = x[:, :, :, 0].transpose(0, 2, 1, 3, 4)
            sink = np.zeros((1,) + y.shape[1:], np.float32)
        out[name] = torch.from_numpy(np.concatenate([y, sink]).copy())
    return out


def _from_port(tp):
    """The port's pool (sink dropped) in the reference's layout."""
    out = {}
    for name, t in tp.items():
        y = t[:-1].numpy()
        out[name] = (y.transpose(0, 2, 1) if name == "kv_pos"
                     else y.transpose(0, 2, 1, 3, 4)[:, :, :, None])
    return out


def _assert_pools_equal(tp, jp):
    got = _from_port(tp)
    for name in jp:
        np.testing.assert_array_equal(got[name], np.asarray(jp[name]),
                                      err_msg=name)


def _lane(rng, cap):
    return {"k": rng.standard_normal((L, 1, cap, H, HD), dtype=np.float32),
            "v": rng.standard_normal((L, 1, cap, H, HD), dtype=np.float32),
            "kv_pos": rng.integers(0, 50, (L, cap)).astype(np.int32)}


def _t(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def test_pool_specs_from_lane_cache():
    lane = {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
            for k, v in _t(_lane(np.random.default_rng(0), 8)).items()}
    spec = tkv.pool_specs_from_lane_cache(lane, NP_, PS, 8)
    assert spec["k"].shape == (NP_ + 1, L, PS, H, HD)
    assert spec["kv_pos"].shape == (NP_ + 1, L, PS)
    assert tkv.cache_bytes(spec) == sum(
        v.numel() * v.element_size() for v in spec.values())
    with pytest.raises(ValueError):     # a ring that does not track P
        tkv.pool_specs_from_lane_cache(lane, NP_, PS, 9)
    with pytest.raises(ValueError):     # an SSM state has no token axis
        tkv.pool_specs_from_lane_cache({"h": lane["k"]}, NP_, PS, 8)
    pool = tkv.init_caches_from_specs(spec, "cpu")
    assert (pool["kv_pos"] == INVALID).all() and not pool["k"].any()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_gather_and_extract_match_the_reference(seed):
    rng = np.random.default_rng(seed)
    jp = _jax_pool(rng)
    row = np.array([rng.integers(0, NP_), -1, rng.integers(0, NP_)]
                   if seed else [3, 0, -1], np.int32)
    jl = jkv.gather_lane_cache(jax.tree.map(jnp.asarray, jp),
                               jnp.asarray(row), AXES, page_size=PS)
    tl = tkv.gather_lane_cache(_to_port(jp), torch.from_numpy(row),
                               page_size=PS)
    for name in jl:
        np.testing.assert_array_equal(tl[name].numpy(), np.asarray(jl[name]))
    for lp in range(MB):
        jpage = jkv.extract_written_page(jl, jnp.int32(lp), AXES,
                                         page_size=PS)
        tpage = tkv.extract_written_page(tl, torch.tensor(lp), page_size=PS)
        np.testing.assert_array_equal(
            tpage["k"].numpy(), np.asarray(jpage["k"])[:, :, 0].transpose(
                1, 0, 2, 3))
        np.testing.assert_array_equal(tpage["kv_pos"].numpy(),
                                      np.asarray(jpage["kv_pos"]).T)


@pytest.mark.parametrize("seed", [0, 1])
def test_scatter_pages_drops_out_of_range_ids(seed):
    rng = np.random.default_rng(seed)
    jp = _jax_pool(rng)
    ids = np.array([5, NP_, 2, NP_ + 3, 0], np.int32)    # 2 dropped
    jpages = {k: rng.standard_normal((len(ids),) + v.shape[1:],
                                     dtype=np.float32)
              if k != "kv_pos" else rng.integers(
                  0, 50, (len(ids),) + v.shape[1:]).astype(np.int32)
              for k, v in jp.items()}
    want = jkv.scatter_pages(jax.tree.map(jnp.asarray, jp), jnp.asarray(ids),
                             jax.tree.map(jnp.asarray, jpages))
    tpages = {k: torch.from_numpy(
        v.transpose(0, 2, 1) if k == "kv_pos"
        else v[:, :, :, 0].transpose(0, 2, 1, 3, 4).copy())
        for k, v in jpages.items()}
    tp = tkv.scatter_pages(_to_port(jp), torch.from_numpy(ids), tpages)
    _assert_pools_equal(tp, want)


@pytest.mark.parametrize("P,ids", [(5, [4, 1]), (8, [6, 0]), (1, [2])])
def test_scatter_prefill_matches_the_reference(P, ids):
    rng = np.random.default_rng(P)
    jp, lane = _jax_pool(rng), _lane(rng, P)
    want = jkv.scatter_prefill(jax.tree.map(jnp.asarray, jp),
                               jnp.asarray(ids, jnp.int32),
                               jax.tree.map(jnp.asarray, lane), AXES,
                               page_size=PS, prompt_len=P)
    tp = tkv.scatter_prefill(_to_port(jp), np.asarray(ids, np.int32),
                             _t(lane), page_size=PS, prompt_len=P)
    _assert_pools_equal(tp, want)


def test_scrub_extract_install_and_compact_match_the_reference():
    rng = np.random.default_rng(7)
    jp = _jax_pool(rng)
    jpool = jax.tree.map(jnp.asarray, jp)
    ids = np.array([1, 4, NP_, NP_], np.int32)            # padded
    _assert_pools_equal(tkv.scrub_pages(_to_port(jp), ids),
                        jkv.scrub_pages(jpool, jnp.asarray(ids)))
    staged_j = jkv.extract_pool_pages(jpool, jnp.asarray(ids))
    staged_t = tkv.extract_pool_pages(_to_port(jp), ids)
    np.testing.assert_array_equal(
        staged_t["k"].numpy(),
        np.asarray(staged_j["k"])[:, :, :, 0].transpose(0, 2, 1, 3, 4))
    dst = np.array([6, 0, NP_, NP_ + 1], np.int32)
    jp2 = _jax_pool(np.random.default_rng(8))
    _assert_pools_equal(
        tkv.install_pool_pages(_to_port(jp2), staged_t, dst),
        jkv.install_pool_pages(jax.tree.map(jnp.asarray, jp2), staged_j,
                               jnp.asarray(dst)))
    src = np.full((NP_,), NP_, np.int32)
    dstc = np.full((NP_,), NP_, np.int32)
    src[:2], dstc[:2] = [5, 6], [0, 2]
    _assert_pools_equal(
        tkv.compact_pool(_to_port(jp), src, dstc),
        jkv.compact_pool(jpool, jnp.asarray(src), jnp.asarray(dstc)))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_block_table_delta_applies_in_row_order(seed):
    """Random clears, cell sets and padding, including a clear followed by
    a re-map of the same slot and a set followed by a clear."""
    rng = np.random.default_rng(seed)
    B, W = 3, 4
    bt = rng.integers(-1, NP_, (B, W)).astype(np.int32)
    delta = np.full((16, 3), -1, np.int32)
    for i in range(int(rng.integers(4, 16))):
        s = int(rng.integers(-1, B))
        lp = int(rng.integers(-1, W))
        delta[i] = (s, lp, int(rng.integers(-1, NP_)))
    delta[14:] = [(0, 1, 5), (0, -1, -1)] if seed % 2 else \
        [(1, -1, -1), (1, 2, 3)]
    want = jkv.apply_block_table_delta(jnp.asarray(bt), jnp.asarray(delta))
    got = tkv.apply_block_table_delta(torch.from_numpy(bt.copy()), delta)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 2e-2)])
def test_paged_plain_version_matches_reference_gather_and_sdpa(dtype, tol):
    """decode_attention_paged_ref = the reference's gather_lane_cache +
    sdpa_naive per lane (one layer: no layer axis)."""
    rng = np.random.default_rng(3)
    B, Hq, Hkv, hd = 3, 4, 2, 16
    q = rng.standard_normal((B, 1, Hq, hd), dtype=np.float32)
    k = rng.standard_normal((NP_, PS, Hkv, hd), dtype=np.float32)
    v = rng.standard_normal((NP_, PS, Hkv, hd), dtype=np.float32)
    kvp = rng.integers(0, 12, (NP_, PS)).astype(np.int32)
    bt = np.array([[2, 5, -1], [0, -1, 4], [6, 1, 3]], np.int32)
    pos = np.array([7, 3, 11], np.int32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    want = []
    for b in range(B):
        c = jkv.gather_lane_cache(
            {"k": jnp.asarray(k, jdt), "v": jnp.asarray(v, jdt),
             "kv_pos": jnp.asarray(kvp)}, jnp.asarray(bt[b]),
            {"k": 0, "v": 0, "kv_pos": 0}, page_size=PS)
        want.append(np.asarray(jax_sdpa(
            jnp.asarray(q[b:b + 1], jdt), c["k"][None], c["v"][None],
            q_pos=jnp.asarray(pos[b:b + 1]), kv_pos=c["kv_pos"]),
            np.float32))
    tdt = getattr(torch, dtype)
    got = decode_attention_paged_ref(
        torch.from_numpy(q).to(tdt), torch.from_numpy(k).to(tdt),
        torch.from_numpy(v).to(tdt), torch.from_numpy(kvp),
        torch.from_numpy(bt), torch.from_numpy(pos))
    np.testing.assert_allclose(got.float().numpy(), np.concatenate(want),
                               rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# Page-granular dirtiness in the buffer table
# ---------------------------------------------------------------------------

def test_buffer_table_saves_only_dirty_pages():
    bt = BufferTable()
    spec = {"kv_pos": torch.empty((5, 2), dtype=torch.int32, device="meta")}
    bt.register("pool", spec, paged=True)
    dev = {"kv_pos": torch.zeros((5, 2), dtype=torch.int32)}
    bt.on_execute_write("pool", dev)                 # no dirty_pages: all
    s1 = bt.evict_device_state()
    assert s1["paged_saved_pages"] == s1["paged_total_pages"] == 5
    bt.restore_device_state(torch.device("cpu"))
    b = bt.get("pool")
    snap = bt.host_snapshot()["pool"]["kv_pos"]      # shared, not copied
    b.device_value["kv_pos"][3] = 7
    bt.on_execute_write("pool", b.device_value, stable=True,
                        dirty_pages=(3,))
    s2 = bt.evict_device_state()
    assert (s2["paged_saved_pages"], s2["paged_total_pages"]) == (1, 5)
    assert s2["saved_bytes"] == 8 and s2["skipped_bytes"] == 32
    assert b.host_value["kv_pos"][3].tolist() == [7, 7]
    # the checkpoint's host tree was copied on write, not patched
    assert b.host_value["kv_pos"] is not snap and not snap.any()


# ---------------------------------------------------------------------------
# BlockPool: the reference's state machine on the port's allocator
# ---------------------------------------------------------------------------

def test_block_pool_alloc_watermark_and_compact():
    pool = tkv.BlockPool(8, 4, reserve_pages=2)
    assert pool.alloc(3) == [0, 1, 2]
    assert pool.alloc(4) is None and pool.alloc(4, urgent=True) is not None
    pool.free([0, 1, 2])
    assert pool.compact() == {4: 0, 5: 1, 6: 2}
    assert pool.used_span() == pool.used_count() == 4
    pool.check_invariants()
    with pytest.raises(tkv.BlockPoolError):
        pool.free([7])


if HAS_HYPOTHESIS:
    class PoolMachine(RuleBasedStateMachine):
        """Random alloc/share/free/free_tail/compact sequences keep the
        partition invariant, ownership and refcount semantics."""

        def __init__(self):
            super().__init__()
            self.pool = tkv.BlockPool(16, 4, reserve_pages=2)
            self.owned = {}
            self.rc = {}
            self.next_owner = 0

        def _drop_ref(self, p):
            self.rc[p] -= 1
            if self.rc[p] == 0:
                del self.rc[p]
                return True
            return False

        @rule(n=st.integers(1, 5), urgent=st.booleans())
        def alloc(self, n, urgent):
            got = self.pool.alloc(n, urgent=urgent)
            if got is not None:
                assert not (set(got) & set(self.rc)), \
                    "live page re-allocated"
                self.owned[self.next_owner] = list(got)
                for p in got:
                    self.rc[p] = 1
                self.next_owner += 1

        @precondition(lambda self: self.rc)
        @rule(data=st.data())
        def share_one(self, data):
            p = data.draw(st.sampled_from(sorted(self.rc)))
            self.pool.share([p])
            self.rc[p] += 1

        @precondition(lambda self: any(c > 1 for c in self.rc.values()))
        @rule(data=st.data())
        def unshare_one(self, data):
            p = data.draw(st.sampled_from(
                sorted(q for q, c in self.rc.items() if c > 1)))
            assert self.pool.free([p]) == []
            self._drop_ref(p)

        @precondition(lambda self: self.owned)
        @rule(data=st.data())
        def free_owner(self, data):
            owner = data.draw(st.sampled_from(sorted(self.owned)))
            pages = sorted(self.owned.pop(owner))
            freed = self.pool.free(pages)
            assert freed == [p for p in pages if self._drop_ref(p)]

        @precondition(lambda self: self.owned)
        @rule(data=st.data())
        def rollback_tail(self, data):
            owner = data.draw(st.sampled_from(sorted(self.owned)))
            blocks = self.owned[owner]
            keep = data.draw(st.integers(0, len(blocks)))
            freed = self.pool.free_tail(blocks, keep)
            assert freed == [p for p in blocks[keep:]
                             if self._drop_ref(p)]
            self.owned[owner] = blocks[:keep]
            if not self.owned[owner]:
                del self.owned[owner]

        @rule()
        def compact(self):
            mapping = self.pool.compact()
            for owner, pages in self.owned.items():
                self.owned[owner] = [mapping.get(p, p) for p in pages]
            self.rc = {mapping.get(p, p): c for p, c in self.rc.items()}

        @invariant()
        def partition_and_refcounts(self):
            self.pool.check_invariants()
            assert set(self.rc) == self.pool._used
            for p, c in self.rc.items():
                assert self.pool.refcount(p) == c
            assert self.pool.free_count() == 16 - len(self.rc)

    TestPoolMachine = PoolMachine.TestCase
    TestPoolMachine.settings = settings(max_examples=30, deadline=None)
