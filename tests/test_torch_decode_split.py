"""K1's split of the cache across a thread-block cluster, on the CPU.

``split_plan`` (the wrapper's choice of slot range per CTA and cluster
size) and ``decode_attention_split_ref`` (a plain mirror of the kernel's
split-and-merge arithmetic) are held against the plain version
``decode_attention_ref`` and, through it, the reference's Pallas kernel in
interpret mode, as tests/test_torch_kernels.py does.  The edges are the
ones the split creates: ranges whose slots are all unwritten, ranges cut by
the window, a wrapped ring, a cap that is not a multiple of the range.
Tolerances: f32 2e-5, bf16 2e-2 (max abs), as tests/test_kernels.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.decode_attention.kernel import decode_attention_fwd  # noqa: E402
from repro_torch.kernels.decode_attention.ops import (  # noqa: E402
    CHUNK_GRANULE, MAX_CLUSTER, split_plan)
from repro_torch.kernels.decode_attention.ref import (  # noqa: E402
    decode_attention_ref, decode_attention_split_ref)

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
H100_SMS = 132


def _ring_kv_pos(cap, pos):
    kv = np.full((cap,), 2 ** 30, np.int32)
    for p in range(max(0, pos - cap + 1), pos + 1):
        kv[p % cap] = p
    return kv


def _inputs(seed, B, cap, Hq, Hkv, hd):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in
            ((B, 1, Hq, hd), (B, cap, Hkv, hd), (B, cap, Hkv, hd))]


def _diff(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a, np.float32)
                               - np.asarray(b, np.float32))))


# ---------------------------------------------------------------------------
# split_plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,Hkv,cap", [
    (8, 4, 640),      # yi-9b decode
    (8, 1, 2048),     # recurrentgemma-9b decode
    (1, 1, 2048), (1, 4, 640), (2, 4, 136), (1, 1, 1), (3, 2, 200),
    (16, 8, 4096), (1, 1, 100000)])
def test_split_plan_covers_every_slot_once(B, Hkv, cap):
    chunk, cluster = split_plan(B, Hkv, cap, H100_SMS)
    assert 1 <= cluster <= MAX_CLUSTER
    assert chunk % CHUNK_GRANULE == 0
    ranges = [range(r * chunk, min(cap, (r + 1) * chunk))
              for r in range(cluster)]
    assert all(len(r) > 0 for r in ranges)    # no CTA without slots
    slots = [j for r in ranges for j in r]
    assert slots == list(range(cap))          # each slot in exactly one


@pytest.mark.parametrize("B,Hkv,cap,ctas", [
    (8, 4, 640, 160),     # yi-9b: 5 CTAs of 128 slots per (lane, kv head)
    (8, 1, 2048, 128),    # recurrentgemma-9b: 16 of 128
    (1, 1, 2048, 16),     # one lane: the largest cluster
    (1, 4, 640, 40),      # one lane of yi-9b: 10 CTAs of 64 slots
])
def test_split_plan_fills_the_card_as_far_as_one_cluster_can(B, Hkv, cap,
                                                             ctas):
    """B * Hkv * cluster CTAs cover the 132 SMs, unless the cluster is at
    its largest (16) or its ranges at their smallest (64 slots): then no
    single cluster per (lane, kv head) can take more CTAs."""
    chunk, cluster = split_plan(B, Hkv, cap, H100_SMS)
    assert B * Hkv * cluster == ctas
    assert (ctas >= H100_SMS or cluster == MAX_CLUSTER
            or chunk == CHUNK_GRANULE)


def test_split_plan_uses_one_cta_when_the_card_is_full():
    assert split_plan(64, 8, 4096, H100_SMS) == (4096, 1)


# ---------------------------------------------------------------------------
# the split-and-merge mirror
# ---------------------------------------------------------------------------

# (B, cap, Hq, Hkv, hd, pos, window): G = Hq / Hkv in {1, 8, 16}
CASES = {
    # pos 20 of cap 2048: every range but the first is wholly unwritten
    "unwritten_splits": (1, 2048, 16, 1, 32, 20, 0),
    # window 100 ends inside the cache: ranges before it are all masked
    "window_cuts_splits": (2, 512, 8, 1, 16, 450, 100),
    # the ring wrapped: kv_pos is not monotone across ranges
    "wrapped_ring": (2, 256, 8, 1, 32, 700, 0),
    "wrapped_window": (1, 256, 16, 1, 16, 700, 90),
    # cap not a multiple of the range: a short last range
    "ragged_cap": (2, 200, 4, 4, 32, 199, 0),
    "g1": (3, 200, 2, 2, 16, 150, 0),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_split_mirror_matches_plain_and_pallas(case, dtype):
    B, cap, Hq, Hkv, hd, pos, window = CASES[case]
    q, k, v = _inputs(cap + pos, B, cap, Hq, Hkv, hd)
    kv_pos = _ring_kv_pos(cap, pos)
    chunk, cluster = split_plan(B, Hkv, cap, H100_SMS)
    assert cluster > 1
    tq, tk, tv = (torch.from_numpy(x).to(TDT[dtype]) for x in (q, k, v))
    tkp = torch.from_numpy(kv_pos)
    mirror = decode_attention_split_ref(tq, tk, tv, pos, tkp, chunk=chunk,
                                        cluster=cluster, window=window)
    plain = decode_attention_ref(tq, tk, tv, pos, tkp, window=window)
    bk = 8 if cap % 64 else 64
    jout = decode_attention_fwd(
        *(jnp.asarray(x).astype(JDT[dtype]) for x in (q, k, v)), pos,
        jnp.asarray(kv_pos), window=window, bk=bk, interpret=True)
    assert mirror.dtype == TDT[dtype]
    assert torch.isfinite(mirror.float()).all()
    assert _diff(mirror.float(), plain.float()) < TOL[dtype]
    assert _diff(mirror.float(), jout) < TOL[dtype]


@pytest.mark.parametrize("block", [16, 32, 64])
def test_split_mirror_agrees_across_block_sizes(block):
    """The kernel's block is 16-64 slots by dtype and head dim; the result
    does not depend on it beyond f32 rounding."""
    q, k, v = (torch.from_numpy(x) for x in _inputs(5, 2, 640, 32, 4, 16))
    kv_pos = torch.from_numpy(_ring_kv_pos(640, 600))
    chunk, cluster = split_plan(2, 4, 640, H100_SMS)
    out = decode_attention_split_ref(q, k, v, 600, kv_pos, chunk=chunk,
                                     cluster=cluster, block=block)
    ref = decode_attention_ref(q, k, v, 600, kv_pos)
    assert _diff(out, ref) < TOL["float32"]


def test_wholly_masked_ranges_contribute_nothing():
    """A range with no kept slot has m = -inf and l = 0: its weight is 0
    and no NaN reaches the output, whatever its (unread) k/v hold."""
    q, k, v = (torch.from_numpy(x) for x in _inputs(9, 1, 2048, 16, 1, 16))
    kv_pos = torch.from_numpy(_ring_kv_pos(2048, 20))
    k[:, 64:] = float("nan")             # never loaded: every block masked
    v[:, 64:] = float("nan")
    chunk, cluster = split_plan(1, 1, 2048, H100_SMS)
    out = decode_attention_split_ref(q, k, v, 20, kv_pos, chunk=chunk,
                                     cluster=cluster)
    ref = decode_attention_ref(q, k[:, :64], v[:, :64], 20,
                               kv_pos[:64])
    assert torch.isfinite(out).all()
    assert _diff(out, ref) < TOL["float32"]


def test_split_mirror_with_softcap():
    q, k, v = (torch.from_numpy(x) for x in _inputs(4, 2, 384, 8, 1, 32))
    kv_pos = torch.from_numpy(_ring_kv_pos(384, 500))
    chunk, cluster = split_plan(2, 1, 384, H100_SMS)
    out = decode_attention_split_ref(q, k, v, 500, kv_pos, chunk=chunk,
                                     cluster=cluster, window=200,
                                     softcap=7.5)
    ref = decode_attention_ref(q, k, v, 500, kv_pos, window=200, softcap=7.5)
    assert _diff(out, ref) < TOL["float32"]


def test_split_constants_match_the_cuda_source():
    """The wrapper's plan and the kernel agree on the cluster limit, the
    slot granule and the largest range."""
    import re
    from pathlib import Path

    from repro_torch.kernels.decode_attention import ops

    src = (Path(ops.__file__).parents[1] / "csrc"
           / "decode_attention.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src)[1])

    assert const("MAX_CLUSTER") == MAX_CLUSTER
    assert const("CHUNK_GRANULE") == CHUNK_GRANULE
    assert const("GMAX") == ops.MAX_GROUP
    assert const("MAX_CHUNK") == ops.MAX_CHUNK
    with pytest.raises(ValueError):
        split_plan(1, 1, MAX_CLUSTER * ops.MAX_CHUNK + 1, H100_SMS)
