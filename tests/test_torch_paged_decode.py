"""K1's paged entry point (``decode_attention_paged``): every lane reads
its own pages in place through its block-table row.

On the CPU the wrapper runs its plain version (gather through the row +
``sdpa_naive``), checked here against a dense decode over an explicitly
gathered cache.  On the card (``gpu`` cases) the CUDA kernel is held
against the plain version at page sizes 4 and 16, with unmapped tails,
inactive lanes, ragged positions, positions on a page boundary and past
the mapped span, and pools that are one layer's strided view of a stacked
pool.  Tolerances as ``tests/test_torch_kernels.py`` holds the dense
entry: |kernel - plain| <= 2e-2 * |plain| + 1e-4 (f32) or 2e-2 (bf16).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.decode_attention.ops import (  # noqa: E402
    decode_attention_paged)
from repro_torch.kernels.decode_attention.ref import (  # noqa: E402
    decode_attention_paged_ref, decode_attention_ref)

INVALID = 2 ** 30
TOL = {"float32": 1e-4, "bfloat16": 2e-2}


def paged_case(B, ps, max_blocks, NP, Hq, Hkv, hd, pos, dtype="float32",
               inactive=(), layers=1, seed=0):
    """A random pool of NP pages (stacked over ``layers``, each page
    contiguous per layer) plus a block table: lane b maps the pages its
    positions 0..pos[b] need (capped at max_blocks) to distinct random
    physical pages; the rest of its row is -1.  Slots past pos[b] in the
    lane's last page hold a stale position > pos[b]; unmapped pages hold
    positions <= every pos, which a correct kernel never reads.  Returns
    (q, pools (NP, layers, ps, ...), kv_pos pool, block table, pos)."""
    rng = np.random.default_rng(seed)
    dt = getattr(torch, dtype)
    q = torch.from_numpy(rng.standard_normal((B, 1, Hq, hd),
                                             dtype=np.float32)).to(dt)
    k, v = (torch.from_numpy(rng.standard_normal(
        (NP, layers, ps, Hkv, hd), dtype=np.float32)).to(dt)
        for _ in range(2))
    kv_pos = np.zeros((NP, layers, ps), np.int32)     # unmapped: pos 0
    bt = np.full((B, max_blocks), -1, np.int32)
    perm = rng.permutation(NP)
    nxt = 0
    for b in range(B):
        if b in inactive:
            continue
        n = min(max_blocks, pos[b] // ps + 1)
        pages = perm[nxt:nxt + n]
        nxt += n
        bt[b, :n] = pages
        for lp, phys in enumerate(pages):
            p = lp * ps + np.arange(ps)
            kv_pos[phys, :, :] = np.where(p <= pos[b], p, pos[b] + 5)
    assert nxt <= NP, "pool too small for the case"
    return (q, k, v, torch.from_numpy(kv_pos), torch.from_numpy(bt),
            torch.tensor(pos, dtype=torch.int32))


def test_plain_version_is_a_dense_decode_over_the_gathered_cache():
    """On the CPU the wrapper runs the plain version; lane by lane it
    equals the dense decode over the lane's pages laid end to end."""
    B, ps, mb = 3, 4, 5
    q, k, v, kvp, bt, pos = paged_case(B, ps, mb, 16, 8, 2, 16,
                                       [9, 17, 3], inactive=(2,))
    out = decode_attention_paged(q, k[:, 0], v[:, 0], kvp[:, 0], bt, pos)
    assert decode_attention_paged.launches == 0
    for b in range(B):
        row = bt[b].long()
        if row[0] < 0:
            assert torch.equal(out[b], torch.zeros_like(out[b]))
            continue
        safe = row.clamp(min=0)
        kc = k[safe, 0].reshape(1, mb * ps, 2, 16)
        vc = v[safe, 0].reshape(1, mb * ps, 2, 16)
        kp = torch.where((row >= 0).repeat_interleave(ps),
                         kvp[safe, 0].reshape(-1), INVALID).int()
        ref = decode_attention_ref(q[b:b + 1], kc, vc, pos[b:b + 1], kp)
        torch.testing.assert_close(out[b:b + 1], ref, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


# (B, ps, max_blocks, NP, Hq, Hkv, hd, pos, inactive, layers, window)
PAGED_CASES = {
    # yi-9b's heads, full-width page size, ragged positions, unmapped tails
    "ps16_ragged": (8, 16, 36, 288, 32, 4, 128,
                    [100, 575, 16, 300, 47, 511, 200, 433], (), 2, 0),
    # the smoke page size, an inactive lane, a position on a page boundary
    "ps4_inactive_boundary": (4, 4, 12, 48, 8, 2, 64, [20, 7, 31, 12],
                              (1,), 2, 0),
    # positions past the mapped span (pipelined lanes reach them)
    "past_span": (3, 16, 8, 32, 16, 2, 128, [127, 300, 4000], (), 1, 0),
    "ps16_window": (2, 16, 20, 48, 16, 1, 256, [250, 319], (), 1, 100),
    "ps1": (2, 1, 64, 160, 4, 4, 16, [63, 40], (), 1, 0),
}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(PAGED_CASES))
def test_paged_kernel_matches_plain_on_card(cuda, dtype, case):
    B, ps, mb, NP, Hq, Hkv, hd, pos, inactive, layers, window = \
        PAGED_CASES[case]
    q, k, v, kvp, bt, posv = (t.to(cuda) for t in paged_case(
        B, ps, mb, NP, Hq, Hkv, hd, pos, dtype, inactive, layers))
    # the last layer's view: pages lie layers * page apart
    kl, vl, pl = k[:, -1], v[:, -1], kvp[:, -1]
    before = decode_attention_paged.launches
    out = decode_attention_paged(q, kl, vl, pl, bt, posv, window=window)
    ref = decode_attention_paged_ref(q, kl, vl, pl, bt, posv, window=window)
    assert decode_attention_paged.launches == before + 1
    assert torch.isfinite(out.float()).all()
    torch.testing.assert_close(out.float(), ref.float(), rtol=2e-2,
                               atol=TOL[dtype])
    for b in inactive:
        assert torch.equal(out[b], torch.zeros_like(out[b]))
    assert torch.equal(out, decode_attention_paged(q, kl, vl, pl, bt, posv,
                                                   window=window))


@pytest.mark.gpu
def test_paged_kernel_rejects_what_it_does_not_take(cuda):
    q, k, v, kvp, bt, posv = (t.to(cuda) for t in paged_case(
        2, 4, 4, 8, 8, 2, 64, [5, 9]))
    with pytest.raises(ValueError):     # pos must be one int32 per lane
        decode_attention_paged(q, k[:, 0], v[:, 0], kvp[:, 0], bt,
                               posv.long())
    with pytest.raises(ValueError):     # a page must be contiguous
        decode_attention_paged(q, k[:, 0].transpose(1, 2), v[:, 0],
                               kvp[:, 0], bt, posv)
