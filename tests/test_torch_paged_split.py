"""K1's paged entry's split in bf16, on the CPU.

``paged_plan`` (the wrapper's choice of route and pages per CTA) and
``decode_attention_paged_split_ref`` (a plain mirror of
``decode_paged_kernel``'s split: pages per CTA, 16-slot tiles per warp,
the warps' and then the cluster's merge in a fixed order) are held
against the plain version ``decode_attention_paged_ref`` and, on each
lane's gathered cache, the reference's Pallas kernel in interpret mode, as
tests/test_torch_decode_split.py holds the dense split.  The edges are the
paged ones: page sizes 1, 4, 16 and one the kernel does not fix at
compile time, unmapped tails, an inactive lane, a position on a page
boundary, positions past the mapped span, a window.  Tolerances: f32
2e-5, bf16 2e-2 (max abs), as tests/test_kernels.py.
"""

import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.decode_attention.kernel import decode_attention_fwd  # noqa: E402
from repro_torch.kernels.decode_attention.ops import (  # noqa: E402
    BT_STAGE, CHUNK_GRANULE, MAX_CLUSTER, SINGLE_TILES, TILE, paged_plan)
from repro_torch.kernels.decode_attention.ref import (  # noqa: E402
    decode_attention_paged_ref, decode_attention_paged_split_ref,
    gather_lane)

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
H100_SMS = 132
BF16 = torch.bfloat16


def _cta_pages(B, Hkv, mb, ps):
    route, chunk, cluster = paged_plan(B, Hkv, mb, ps, BF16, H100_SMS)
    assert chunk % ps == 0, "a CTA takes whole pages"
    ppc = chunk // ps
    return route, ppc, cluster, [range(r * ppc, min(mb, (r + 1) * ppc))
                                 for r in range(cluster)]


# ---------------------------------------------------------------------------
# paged_plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,Hkv,mb,ps", [
    (8, 4, 36, 16),     # the engine's decode at yi-9b
    (1, 4, 5, 16),      # prefill_chunk at one lane
    (8, 4, 11, 16),     # speculative verify's window
    (4, 2, 12, 4), (2, 2, 100, 4), (2, 4, 64, 1), (2, 4, 300, 1),
    (3, 2, 10, 5), (2, 2, 40, 5), (1, 1, 1, 16), (64, 8, 200, 16),
    (1, 1, 5000, 16), (2, 1, 3000, 1)])
def test_every_mapped_page_belongs_to_exactly_one_cta(B, Hkv, mb, ps):
    route, ppc, cluster, ranges = _cta_pages(B, Hkv, mb, ps)
    assert 1 <= cluster <= MAX_CLUSTER and ppc <= BT_STAGE
    assert (route == "single") == (cluster == 1)
    assert all(len(r) > 0 for r in ranges)          # no CTA without pages
    assert [p for r in ranges for p in r] == list(range(mb))
    if cluster > 1:     # every CTA but the last a whole number of granules
        assert (ppc * ps) % CHUNK_GRANULE == 0


def test_the_paths_routes():
    """The engine's decode takes 5-CTA clusters of 8 pages (two tiles a
    warp), and so do the disaggregated replicas' (2 lanes over 36 pages,
    14 over 37), and the engines of ``DECODE_ROWS`` (64) lanes and of
    twice that; verify's window 3-CTA clusters of 4 pages (one tile a warp);
    prefill_chunk's one lane one CTA."""
    assert paged_plan(8, 4, 36, 16, BF16, H100_SMS) == ("cluster", 128, 5)
    assert paged_plan(2, 4, 36, 16, BF16, H100_SMS) == ("cluster", 128, 5)
    assert paged_plan(14, 4, 37, 16, BF16, H100_SMS) == ("cluster", 128, 5)
    assert paged_plan(1, 4, 5, 16, BF16, H100_SMS) == ("single", 80, 1)
    assert paged_plan(8, 4, 11, 16, BF16, H100_SMS) == ("cluster", 64, 3)
    assert paged_plan(16, 4, 37, 16, BF16, H100_SMS) == ("cluster", 128, 5)
    for rows in (64, 128):
        for mb in (36, 37):
            assert paged_plan(rows, 4, mb, 16, BF16, H100_SMS) == (
                "cluster", 128, 5)
        assert paged_plan(rows, 4, 11, 16, BF16, H100_SMS) == (
            "cluster", 64, 3)
    # f32 keeps the slot split over the table
    assert paged_plan(8, 4, 36, 16, torch.float32, H100_SMS)[0] == "slots"


def test_route_depends_only_on_static_shapes():
    """The plan reads batch, kv heads, table width, page size, dtype and
    the card's SM count: nothing of positions or table contents, so one
    engine program always takes one route.  A table just over
    SINGLE_TILES tiles splits; one at it does not."""
    params = list(inspect.signature(paged_plan).parameters)
    assert params == ["B", "Hkv", "max_blocks", "ps", "dtype", "sm_count"]
    at = SINGLE_TILES * TILE // 16
    assert paged_plan(8, 4, at, 16, BF16, H100_SMS)[0] == "single"
    assert paged_plan(8, 4, at + 1, 16, BF16, H100_SMS)[0] == "cluster"
    # the bf16 split does not depend on the batch, the kv heads or the
    # card: a lane decodes to the same bits in any replica
    for mb in (at + 1, 36, 200, 5000):
        assert len({paged_plan(B, Hkv, mb, 16, BF16, sms)
                    for B in (1, 2, 8, 14, 64) for Hkv in (1, 4, 8)
                    for sms in (78, 132)}) == 1


# ---------------------------------------------------------------------------
# the split-and-merge mirror
# ---------------------------------------------------------------------------

def paged_case(B, ps, mb, NP, Hq, Hkv, hd, pos, inactive=(), seed=0):
    """A random pool and table as tests/test_torch_paged_decode.py makes
    them: lane b maps the pages its positions 0..pos[b] need (capped at
    mb) to distinct random pages; slots past pos[b] in its last page hold
    a stale position pos[b] + 5, unmapped pages position 0."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, 1, Hq, hd), dtype=np.float32)
    k, v = (rng.standard_normal((NP, ps, Hkv, hd), dtype=np.float32)
            for _ in range(2))
    kv_pos = np.zeros((NP, ps), np.int32)
    bt = np.full((B, mb), -1, np.int32)
    perm, nxt = rng.permutation(NP), 0
    for b in range(B):
        if b in inactive:
            continue
        n = min(mb, pos[b] // ps + 1)
        bt[b, :n] = perm[nxt:nxt + n]
        nxt += n
        for lp, phys in enumerate(bt[b, :n]):
            p = lp * ps + np.arange(ps)
            kv_pos[phys] = np.where(p <= pos[b], p, pos[b] + 5)
    assert nxt <= NP, "pool too small for the case"
    return q, k, v, kv_pos, bt, np.asarray(pos, np.int32)


# (B, ps, mb, NP, Hq, Hkv, hd, pos, inactive, window)
CASES = {
    # ps 16, the engine's heads (narrowed): ragged positions, unmapped
    # tails, a position on a page boundary (pos 48: page 3's first slot)
    "ps16_ragged": (4, 16, 20, 60, 16, 2, 16, [300, 48, 17, 159], (), 0),
    # ps 4, an inactive lane, a position on a page boundary (pos 8)
    "ps4_inactive_boundary": (4, 4, 30, 80, 8, 2, 32, [100, 8, 59, 31],
                              (1,), 0),
    "ps1": (2, 1, 72, 150, 4, 4, 16, [71, 40], (), 0),
    # a page size with no instantiation of its own
    "ps5_generic": (3, 5, 24, 60, 8, 1, 16, [99, 33, 4], (), 0),
    # positions past the mapped span (pipelined lanes reach them)
    "past_span": (3, 16, 8, 32, 16, 2, 32, [127, 300, 4000], (), 0),
    "window": (2, 16, 20, 48, 16, 1, 32, [250, 319], (), 100),
    # stablelm-3b's hd 80 (MHA) and starcoder2-15b's group 12, narrowed
    "hd80_g1": (2, 16, 20, 48, 4, 4, 80, [250, 97], (), 0),
    "hd80_g12": (2, 16, 20, 48, 12, 1, 80, [319, 160], (), 0),
}


def _plans(B, Hkv, mb, ps):
    """The wrapper's plan and the other route at the same shape."""
    plan = paged_plan(B, Hkv, mb, ps, BF16, H100_SMS)
    gran = CHUNK_GRANULE // np.gcd(ps, CHUNK_GRANULE)
    other = ("single", mb * ps, 1) if plan[0] == "cluster" else \
        ("cluster", gran * ps, -(-mb // gran))
    return [plan] + ([other] if other[2] <= MAX_CLUSTER else [])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_paged_mirror_matches_plain_and_pallas(case, dtype):
    B, ps, mb, NP, Hq, Hkv, hd, pos, inactive, window = CASES[case]
    q, k, v, kvp, bt, posv = paged_case(B, ps, mb, NP, Hq, Hkv, hd, pos,
                                        inactive)
    tq, tk, tv = (torch.from_numpy(x).to(TDT[dtype]) for x in (q, k, v))
    tkp, tbt, tpos = (torch.from_numpy(x) for x in (kvp, bt, posv))
    plain = decode_attention_paged_ref(tq, tk, tv, tkp, tbt, tpos,
                                       window=window).float()
    routes = set()
    for route, chunk, cluster in _plans(B, Hkv, mb, ps):
        routes.add(route)
        mirror = decode_attention_paged_split_ref(
            tq, tk, tv, tkp, tbt, tpos, chunk=chunk, cluster=cluster,
            window=window)
        assert mirror.dtype == TDT[dtype]
        assert torch.isfinite(mirror.float()).all()
        assert (mirror.float() - plain).abs().max() < TOL[dtype], route
        for b in inactive:
            assert torch.equal(mirror[b], torch.zeros_like(mirror[b]))
        for b in range(B):
            if b in inactive:
                continue
            kd, vd, kp = gather_lane(tk, tv, tkp, tbt[b])
            bk = 8 if (mb * ps) % 64 else 64
            jout = decode_attention_fwd(
                jnp.asarray(q[b:b + 1]).astype(JDT[dtype]),
                jnp.asarray(kd.float().numpy()).astype(JDT[dtype]),
                jnp.asarray(vd.float().numpy()).astype(JDT[dtype]),
                int(posv[b]), jnp.asarray(kp.numpy()), window=window, bk=bk,
                interpret=True)
            err = np.max(np.abs(np.asarray(jout, np.float32)
                                - mirror[b:b + 1].float().numpy()))
            assert err < TOL[dtype], (route, b)
    assert routes == {"single", "cluster"}


def test_lane_output_depends_only_on_its_own_row_and_pages():
    """Lane 0's output keeps its bits when the other lanes' positions,
    pages and page contents change: no work is balanced over the batch."""
    B, ps, mb, NP, Hq, Hkv, hd = 4, 16, 20, 90, 8, 2, 16
    q, k, v, kvp, bt, posv = paged_case(B, ps, mb, NP, Hq, Hkv, hd,
                                        [200, 48, 17, 159])
    args = [torch.from_numpy(x) for x in (q, k, v, kvp, bt, posv)]
    for route, chunk, cluster in _plans(B, Hkv, mb, ps):
        a = decode_attention_paged_split_ref(*args, chunk=chunk,
                                             cluster=cluster)
        q2, k2, v2, kvp2, bt2, pos2 = (x.clone() for x in args)
        used = set(bt[0][bt[0] >= 0].tolist())
        free = [p for p in range(NP) if p not in used]
        rng = np.random.default_rng(7)
        bt2[1:] = -1
        bt2[1, :12] = torch.as_tensor(rng.choice(free, 12, replace=False))
        pos2[1:] = torch.tensor([190, 3, 0], dtype=torch.int32)
        for p in free:
            k2[p] = torch.randn(ps, Hkv, hd)
            v2[p] = torch.randn(ps, Hkv, hd)
        q2[1:] = torch.randn(B - 1, 1, Hq, hd)
        b = decode_attention_paged_split_ref(q2, k2, v2, kvp2, bt2, pos2,
                                             chunk=chunk, cluster=cluster)
        assert torch.equal(a[0], b[0]), route


@pytest.mark.parametrize("mb_other", [36, 37])
def test_lane_output_is_the_same_in_any_replica(mb_other):
    """A lane's mirror output keeps its bits across the batch it decodes
    in (2, 8 or 14 lanes) and the replica's table width (36 pages of 16,
    or 37 with fused decode's headroom): the disaggregated pair hands a
    lane between such replicas and must not change a token."""
    Hq, Hkv, hd, ps, NP = 8, 2, 16, 16, 700
    pos0 = 517
    q, k, v, kvp, bt, posv = paged_case(14, ps, 37, NP, Hq, Hkv, hd,
                                        [pos0] + [int(p) for p in
                                                  np.random.default_rng(3)
                                                  .integers(0, 580, 13)])
    args = [torch.from_numpy(x) for x in (q, k, v, kvp, bt, posv)]
    args[:3] = [a.to(BF16) for a in args[:3]]
    outs = []
    for B, mb in ((8, 36), (2, 36), (14, mb_other)):
        qb, tk, tv, tkp, tbt, tpos = args
        row = tbt[:B, :mb].clone()
        _, chunk, cluster = paged_plan(B, Hkv, mb, ps, BF16, H100_SMS)
        out = decode_attention_paged_split_ref(
            qb[:B], tk, tv, tkp, row, tpos[:B], chunk=chunk,
            cluster=cluster)
        outs.append(out[0])
    assert all(torch.equal(outs[0], o) for o in outs[1:])
