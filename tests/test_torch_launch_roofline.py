"""The port's roofline (``repro_torch.launch.roofline``) against the
reference's and against itself.

* ``depth_plan``: the reference's probe names, units, solve and base for
  the family smokes and the ten full-width archs, each probe config equal
  to the reference's field by field;
* the probe-and-solve: for five family smokes (dense, moe with MLA, ssm,
  encoder-decoder, vlm) at ``tests/test_launch_small.py``'s ``TINY``
  shapes, the totals rebuilt from the depth probes equal a meta-device run
  of the full-depth model exactly, FLOPs and bytes, in train, prefill and
  decode.  The hybrid is left out: its full plan runs a repetition of
  three blocks as one checkpoint, whose recomputation stops early once a
  repetition, where a probe's stops once a block (``remat="full"``; under
  "none" its FLOPs match and its bytes differ by per-leaf scalars);
* ``analyze_cell`` names its bottleneck from the H100's peaks, its
  compute term from the work the step needs (no recomputation, no masked
  attention pairs) and its op count's time beside it.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.configs.registry import ARCHS as JARCHS  # noqa: E402
from repro_torch.configs import SHAPES, get_arch  # noqa: E402
from repro_torch.launch import roofline  # noqa: E402
from repro_torch.launch.op_stats import count_step  # noqa: E402
from repro_torch.launch.steps import build_cell  # noqa: E402

TINY = {
    "train": dataclasses.replace(SHAPES["train_4k"], seq_len=32,
                                 global_batch=4),
    "prefill": dataclasses.replace(SHAPES["prefill_32k"], seq_len=64,
                                   global_batch=2),
    "decode": dataclasses.replace(SHAPES["decode_32k"], seq_len=64,
                                  global_batch=2),
}
FAMILY_REPS = ["yi-9b-smoke", "deepseek-v3-671b-smoke", "mamba2-1.3b-smoke",
               "recurrentgemma-9b-smoke", "seamless-m4t-large-v2-smoke",
               "llava-next-mistral-7b-smoke"]
EXACT = [a for a in FAMILY_REPS if not a.startswith("recurrentgemma")]


@pytest.mark.parametrize("arch", FAMILY_REPS + ["qwen3-8b-smoke"]
                         + sorted(JARCHS))
def test_depth_plan_matches_the_reference(arch):
    from repro.launch.roofline import depth_plan as jdepth_plan

    got = roofline.depth_plan(get_arch(arch))
    want = jdepth_plan(jget_arch(arch))
    assert got[1:] == want[1:]                  # units, solve, base
    assert list(got[0]) == list(want[0])        # probe names, in order
    for name, cfg in got[0].items():
        assert dataclasses.asdict(cfg) == dataclasses.asdict(want[0][name])


@pytest.mark.parametrize("arch", EXACT)
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_probes_rebuild_the_full_model(arch, kind):
    cfg, shape = get_arch(arch), TINY[kind]
    rec = roofline.analyze_cell(cfg, shape)
    assert rec["status"] == "ok" and rec["n_chips"] == 1
    cell = build_cell(cfg, shape)
    stats, _ = count_step(cell.fn, *cell.abstract_args)
    assert rec["totals"]["flops"] == stats["flops"]
    assert rec["totals"]["bytes"] == stats["bytes"]
    assert rec["collective_s"] == 0.0


def test_analyze_cell_terms_are_the_h100s():
    cfg = get_arch("yi-9b-smoke")
    rec = roofline.analyze_cell(cfg, "train_4k")      # a name in SHAPES
    assert rec["shape"] == "train_4k" and rec["peak_flop_s"] == 989e12
    assert rec["compute_s"] == rec["required_flops"] / 989e12
    assert rec["op_compute_s"] == rec["totals"]["flops"] / 989e12
    assert 0 < rec["required_flops"] < rec["totals"]["flops"]
    assert rec["masked_attention_flops"] > 0
    assert rec["memory_s"] == rec["memory_detail"]["total"] / 3.35e12
    assert rec["step_seconds_lower_bound"] == max(
        rec["compute_s"], rec["memory_s"], rec["collective_s"])
    f32 = roofline.analyze_cell(dataclasses.replace(cfg, dtype="float32"),
                                TINY["prefill"])
    assert f32["peak_flop_s"] == 67e12
    skipped = roofline.analyze_cell("yi-9b-smoke", "long_500k")
    assert skipped["status"] == "skipped"
