"""A lane decodes to the same bits whatever its replica's lane count.

``tools/batch_invariance.py`` measured it on the H100 (NVIDIA H100 80GB
HBM3): K1's paged entry keeps a lane's bf16 bits from 1 to 32 lanes, but
its f32 split went by the batch (a lane's output moved by 1e-7 between 8
and 14 lanes), and cuBLAS's bf16 GEMMs give row 0 other bits at 16 rows
than at 32 (``wq`` and ``wo`` of yi-9b).  So:

* the f32 split reads the table's width alone, as the bf16 one does;
* ``lm_decode_paged`` runs every row-wise product at ``DECODE_ROWS`` rows
  (blocks of it past that many lanes), so a paged engine of any lane
  count serves: engines of 17, 33 and ``DECODE_ROWS + 1`` lanes give
  their first requests a 2-lane engine's tokens;
* on the card (``gpu``): lane 0's K1 paged output has the same bits in
  batches of 1 to 128 lanes, over tables of 36 and 37 pages, in bf16 and
  f32; and row 0 of a bf16 product run in blocks of ``DECODE_ROWS`` rows
  has the same bits in batches of 1 to 128 rows.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import FunkyCL, Monitor, SliceAllocator  # noqa: E402
from repro_torch.kernels.decode_attention.ops import (  # noqa: E402
    decode_attention_paged, paged_plan)
from repro_torch.models.transformer import DECODE_ROWS  # noqa: E402
from repro_torch.scaling.metrics import MetricsRegistry  # noqa: E402
from repro_torch.serve.engine import (ContinuousBatchingEngine,  # noqa: E402
                                      ServeRequest)
from test_torch_paged_decode import paged_case  # noqa: E402

H100_SMS = 132
BATCHES = (1, 2, 8, 14, 16, 17, 24, 32, 64, 65, 128)


@pytest.mark.parametrize("mb", [5, 11, 36, 37, 200])
@pytest.mark.parametrize("Hkv", [1, 4, 16])
def test_f32_split_does_not_depend_on_the_batch(mb, Hkv):
    plans = {paged_plan(B, Hkv, mb, 16, torch.float32, H100_SMS)
             for B in BATCHES}
    assert len(plans) == 1, plans
    assert next(iter(plans))[0] == "slots"


def _serve(slots, n_requests):
    """The tokens of ``n_requests`` requests (prompts of 8 from seed 4, 4
    new tokens) served by a yi-9b-smoke paged engine of ``slots`` lanes,
    every lane busy at once where there are as many requests."""
    rng = np.random.Generator(np.random.Philox(4))
    reqs = [ServeRequest(rid=f"r{i}", prompt=rng.integers(0, 100, 8),
                         max_new_tokens=4) for i in range(n_requests)]
    mon = Monitor("bi", SliceAllocator("n0", 1, device="cpu"),
                  telemetry=MetricsRegistry())
    try:
        eng = ContinuousBatchingEngine("yi-9b-smoke", FunkyCL(mon),
                                       slots=slots, prompt_len=8,
                                       max_new_tokens=4, page_size=4)
        eng.setup()
        for r in reqs:
            eng.submit(r)
        eng.run_until_drained()
        return eng, {rid: list(c.tokens) for rid, c in eng.completed.items()}
    finally:
        mon.vfpga_exit()


@pytest.mark.parametrize("slots", [17, 33, DECODE_ROWS + 1])
def test_paged_engine_serves_more_lanes_than_decode_rows(slots):
    """An engine of more lanes than ``DECODE_ROWS`` serves a request on
    every lane, and its first requests get the tokens a 2-lane engine
    gives them (past ``DECODE_ROWS`` lanes the decode runs its products
    in blocks of ``DECODE_ROWS`` rows)."""
    eng, got = _serve(slots, slots)
    assert eng.slots == slots and len(got) == slots
    assert all(len(t) == 4 for t in got.values())
    _, want = _serve(2, 4)
    assert {rid: got[rid] for rid in want} == want


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_lane_keeps_its_bits_in_any_batch(cuda, dtype):
    """yi-9b's decode shape (32/4 heads of 128, pages of 16): lane 0 at
    position 517 among 128 lanes; its output in the first B lanes over
    tables of 36 and 37 pages equals its output among 8 over 36."""
    B, mb = max(BATCHES), 37
    pos = [517] + [(97 * b) % 580 for b in range(1, B)]
    q, k, v, kvp, bt, posv = (t.to(cuda) for t in paged_case(
        B, 16, mb, B * mb, 32, 4, 128, pos, dtype))
    k, v, kvp = k[:, 0], v[:, 0], kvp[:, 0]

    def lane0(n, width):
        return decode_attention_paged(q[:n], k, v, kvp,
                                      bt[:n, :width].contiguous(),
                                      posv[:n])[0]

    ref = lane0(8, 36)
    for n in BATCHES:
        for width in (36, 37):
            assert torch.equal(lane0(n, width), ref), (n, width)


@pytest.mark.gpu
def test_blocked_products_keep_row_bits_in_any_batch(cuda):
    """yi-9b's ``wq`` and ``wo`` products in bf16 as ``lm_decode_paged``
    runs them (zero-padded to a multiple of ``DECODE_ROWS``, run
    ``DECODE_ROWS`` rows at a time): row 0 has the same bits in batches
    of 1 to 128 rows as in 8, where a plain ``x @ w`` differs at 14-16
    rows (``tools/batch_invariance.py``)."""
    from repro_torch.models.layers import by_rows

    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn((max(BATCHES), 1, 4096), generator=g,
                    device=cuda).to(torch.bfloat16)
    for _ in range(2):
        w = (torch.randn((4096, 4096), generator=g, device=cuda)
             / 64).to(torch.bfloat16)

        def row0(n):
            xp = torch.cat([x[:n], x.new_zeros((-n % DECODE_ROWS, 1,
                                                4096))])
            return by_rows(DECODE_ROWS, lambda xb: xb @ w, xp)[0]

        ref = row0(8)
        for n in BATCHES:
            assert torch.equal(row0(n), ref), n
