"""A lane decodes to the same bits whatever its replica's lane count.

``tools/batch_invariance.py`` measured it on the H100 (NVIDIA H100 80GB
HBM3): K1's paged entry keeps a lane's bf16 bits from 1 to 32 lanes, but
its f32 split went by the batch (a lane's output moved by 1e-7 between 8
and 14 lanes), and cuBLAS's bf16 GEMMs give row 0 other bits at 16 rows
than at 32 (``wq`` and ``wo`` of yi-9b), the row counts that
``lm_decode_paged`` pads a replica of 1-16 and of 17-32 lanes to.  So:

* the f32 split reads the table's width alone, as the bf16 one does;
* a paged engine refuses more than ``DECODE_ROWS`` (16) lanes, with the
  reason in its error;
* on the card (``gpu``): lane 0's K1 paged output has the same bits in
  batches of 1 to 32 lanes, over tables of 36 and 37 pages, in bf16 and
  f32.
"""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import FunkyCL, Monitor, SliceAllocator  # noqa: E402
from repro_torch.kernels.decode_attention.ops import (  # noqa: E402
    decode_attention_paged, paged_plan)
from repro_torch.models.transformer import DECODE_ROWS  # noqa: E402
from repro_torch.scaling.metrics import MetricsRegistry  # noqa: E402
from repro_torch.serve.engine import ContinuousBatchingEngine  # noqa: E402
from test_torch_paged_decode import paged_case  # noqa: E402

H100_SMS = 132
BATCHES = (1, 2, 8, 14, 16, 17, 24, 32)


@pytest.mark.parametrize("mb", [5, 11, 36, 37, 200])
@pytest.mark.parametrize("Hkv", [1, 4, 16])
def test_f32_split_does_not_depend_on_the_batch(mb, Hkv):
    plans = {paged_plan(B, Hkv, mb, 16, torch.float32, H100_SMS)
             for B in BATCHES}
    assert len(plans) == 1, plans
    assert next(iter(plans))[0] == "slots"


def _engine(slots):
    mon = Monitor("bi", SliceAllocator("n0", 1, device="cpu"),
                  telemetry=MetricsRegistry())
    try:
        return ContinuousBatchingEngine("yi-9b-smoke", FunkyCL(mon),
                                        slots=slots, prompt_len=8,
                                        max_new_tokens=4, page_size=4)
    finally:
        mon.vfpga_exit()


def test_paged_engine_refuses_more_lanes_than_decode_rows():
    assert DECODE_ROWS == 16
    assert _engine(DECODE_ROWS).slots == DECODE_ROWS
    with pytest.raises(ValueError, match="at most 16 lanes.*slots=17"):
        _engine(DECODE_ROWS + 1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_lane_keeps_its_bits_in_any_batch(cuda, dtype):
    """yi-9b's decode shape (32/4 heads of 128, pages of 16): lane 0 at
    position 517 among 32 lanes; its output in the first B lanes over
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
