"""The launch layer of the port (``repro_torch.launch``) against the
reference's (``repro.launch``), and its drivers on the CPU.

* ``input_specs`` (shapes and dtypes at every applicable shape of
  ``SHAPES``), ``analytic_param_count`` (all and active) and
  ``embedding_param_count`` equal the reference's for the ten full-width
  archs;
* ``roofline.model_flops_total`` and ``analytic_memory_bytes`` equal the
  reference's at the trivial mesh ``compat_make_mesh((1, 1), ("data",
  "model"))`` (one device, ``n_chips`` 1 and ``tp`` 1) for every
  applicable (arch, shape);
* ``op_stats`` counts one yi-9b-smoke layer's matrix products at 2·m·n·k,
  written out here for train, prefill and decode, and the roofline's
  compute term counts the same products without recomputation and with
  attention over the causal pairs only;
* ``dryrun.main`` over the family smokes at ``tests/test_launch_small.py``'s
  ``TINY`` shapes records ``ok`` or ``skipped`` for each cell, runs nothing
  on a second call, and reports a peak of at least the arguments' bytes;
* ``launch.serve.main`` serves a ``ServeTask``'s tokens, and
  ``launch.train.main`` gives the same final loss natively and through
  Funky, bit for bit.

``tests/test_torch_launch_roofline.py`` holds the depth plans and the
probe-and-solve; ``tests/test_torch_launch_cells.py`` ``build_cell``'s
steps against the reference's.
"""

import dataclasses
import functools
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import repro.models.model_zoo as jzoo  # noqa: E402
from repro.configs import SHAPES as JSHAPES  # noqa: E402
from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.configs.registry import ARCHS as JARCHS  # noqa: E402
from repro.launch.mesh import compat_make_mesh  # noqa: E402
from repro_torch.configs import SHAPES, applicable, get_arch  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.launch import dryrun, roofline  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.launch.op_stats import count_step  # noqa: E402
from repro_torch.launch.steps import build_cell  # noqa: E402
from repro_torch.models import model_zoo  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

FULL = sorted(JARCHS)
MESH = compat_make_mesh((1, 1), ("data", "model"))

TINY = {
    "train_4k": dataclasses.replace(SHAPES["train_4k"], seq_len=32,
                                    global_batch=4),
    "prefill_32k": dataclasses.replace(SHAPES["prefill_32k"], seq_len=64,
                                       global_batch=2),
    "decode_32k": dataclasses.replace(SHAPES["decode_32k"], seq_len=64,
                                      global_batch=2),
    "long_500k": dataclasses.replace(SHAPES["long_500k"], seq_len=64,
                                     global_batch=1),
}
FAMILY_REPS = ["yi-9b-smoke", "deepseek-v3-671b-smoke", "mamba2-1.3b-smoke",
               "recurrentgemma-9b-smoke", "seamless-m4t-large-v2-smoke",
               "llava-next-mistral-7b-smoke"]


@functools.lru_cache(maxsize=None)
def _jcount(name: str, active_only: bool) -> int:
    return jzoo.analytic_param_count(jget_arch(name), active_only=active_only)


@pytest.fixture
def jroofline(monkeypatch):
    """The reference's roofline module, its parameter counts cached.  Its
    import sets ``XLA_FLAGS`` (512 host devices) unless set: JAX's backend
    is started first, so it keeps its devices, and the variable is put
    back."""
    jax.devices()
    before = os.environ.get("XLA_FLAGS")
    import repro.launch.roofline as jr
    if before is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = before
    monkeypatch.setattr(jzoo, "analytic_param_count",
                        lambda cfg, active_only=False: _jcount(cfg.name,
                                                               active_only))
    return jr


def _sig(tree):
    """Nesting, shapes and dtype names of a tree of arrays or tensors."""
    if isinstance(tree, dict):
        return {k: _sig(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return [_sig(v) for v in tree]
    dt = (str(tree.dtype).removeprefix("torch.")
          if isinstance(tree, torch.Tensor) else np.dtype(tree.dtype).name)
    return (tuple(tree.shape), dt)


@pytest.mark.parametrize("arch", FULL)
def test_input_specs_and_param_counts_match_the_reference(arch):
    jcfg, tcfg = jget_arch(arch), get_arch(arch)
    for name, shape in SHAPES.items():
        if not applicable(tcfg, shape)[0]:
            continue
        got = model_zoo.input_specs(tcfg, shape)
        for t in tree_leaves(got):
            assert t.device.type == "meta"
        assert _sig(got) == _sig(jzoo.input_specs(jcfg, JSHAPES[name])), name
    for active in (False, True):
        assert model_zoo.analytic_param_count(tcfg, active_only=active) \
            == _jcount(arch, active)
    assert model_zoo.embedding_param_count(tcfg) \
        == jzoo.embedding_param_count(jcfg)


@pytest.mark.parametrize("arch", FULL)
def test_model_flops_and_memory_model_match_the_reference(arch, jroofline):
    jcfg, tcfg = jget_arch(arch), get_arch(arch)
    for name, shape in SHAPES.items():
        if not applicable(tcfg, shape)[0]:
            continue
        jshape = JSHAPES[name]
        assert roofline.model_flops_total(tcfg, shape) \
            == jroofline.model_flops_total(jcfg, jshape)
        for remat in ("none", "full"):
            got = roofline.analytic_memory_bytes(tcfg, shape, n_chips=1,
                                                 tp=1, remat=remat)
            want = jroofline.analytic_memory_bytes(
                jcfg, jshape, MESH, policy="fsdp_tp", remat=remat,
                train_impl="naive")
            assert got == want, (name, remat)


def _layer_flops(cfg, kind, B, S, causal=False):
    """2·m·n·k of every matrix product of a 1-layer yi-9b-smoke step:
    the q/k/v/o projections, attention's scores and values over the S
    (train, prefill) or cap (decode) keys of each query (``causal``: over
    the S (S + 1) / 2 query-key pairs a causal mask keeps), the gated MLP
    and the head (every position in training, the last in prefill, the
    token in decode).  Training runs each product once forward and twice
    backward (both operands' gradients)."""
    D, H, Hkv, hd, F, V = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                           cfg.head_dim_, cfg.d_ff, cfg.vocab_size)
    T = B * (1 if kind == "decode" else S)         # query positions
    pairs = T * S                                   # S keys, or the cap
    if causal and kind != "decode":
        pairs = B * S * (S + 1) // 2
    proj = 2 * T * D * (H * hd) * 2 + 2 * T * D * (Hkv * hd) * 2
    attn = 2 * 2 * H * pairs * hd
    mlp = 3 * 2 * T * D * F
    head = 2 * (T if kind == "train" else B) * D * V
    fwd = proj + attn + mlp + head
    return 3 * fwd if kind == "train" else fwd


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_op_stats_counts_a_layers_products(kind):
    cfg = dataclasses.replace(get_arch("yi-9b-smoke"), num_layers=1)
    B, S = (4, 32) if kind == "train" else (2, 64)
    shape = ShapeConfig("t", kind, S, B)
    cell = build_cell(cfg, shape, remat="none")
    stats, _ = count_step(cell.fn, *cell.abstract_args)
    assert stats["flops"] == _layer_flops(cfg, kind, B, S)
    assert stats["flops"] == sum(stats["flops_by_op"].values())
    assert set(stats["flops_by_op"]) <= {"aten.mm", "aten.addmm",
                                         "aten.bmm"}
    assert stats["bytes"] > 0
    assert stats["collectives"]["total_count"] == 0


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_roofline_compute_term_is_the_work_a_layer_needs(kind):
    """Under ``remat="full"`` the probes' op count holds the recomputed
    forward and the masked half of attention; the compute term holds
    neither."""
    cfg = dataclasses.replace(get_arch("yi-9b-smoke"), num_layers=1)
    B, S = (4, 32) if kind == "train" else (2, 64)
    rec = roofline.analyze_cell(cfg, ShapeConfig("t", kind, S, B),
                                remat="full")
    need = _layer_flops(cfg, kind, B, S, causal=True)
    assert rec["required_flops"] == need
    assert rec["compute_s"] == need / roofline.PEAK_FLOP_S[cfg.dtype]
    if kind == "train":       # the forward again, and the full S x S
        assert rec["op_flops_per_device"] > _layer_flops(cfg, kind, B, S)
    else:
        assert rec["op_flops_per_device"] == _layer_flops(cfg, kind, B, S)


def test_kept_pairs_of_a_causal_window():
    for S, w in ((64, 0), (64, 16), (16, 64), (33, 32)):
        q, k = np.arange(S)[:, None], np.arange(S)[None, :]
        keep = (k <= q) & ((q - k < w) if w else True)
        assert roofline._kept_pairs(S, w) == int(keep.sum())


def test_dryrun_main_over_the_smokes(tmp_path, monkeypatch):
    monkeypatch.setattr(dryrun, "SHAPES", TINY)
    calls = []
    run_cell = dryrun.run_cell
    monkeypatch.setattr(dryrun, "run_cell",
                        lambda *a, **k: calls.append(a) or run_cell(*a, **k))
    out = tmp_path / "dryrun.json"
    argv = ["--arch", ",".join(FAMILY_REPS), "--num-microbatches", "2",
            "--out", str(out)]
    recs = dryrun.main(argv)
    assert len(recs) == len(FAMILY_REPS) * len(TINY) == len(calls)
    by = {(r["arch"], r["shape"]): r for r in recs}
    for arch in FAMILY_REPS:
        sub_quadratic = get_arch(arch).sub_quadratic
        for name in TINY:
            r = by[(arch, name)]
            want = ("skipped" if name == "long_500k" and not sub_quadratic
                    else "ok")
            assert r["status"] == want, r
            if want == "ok":
                assert r["peak_bytes"] >= r["arg_bytes"] > 0
                assert r["fits"] and r["card_bytes"] == dryrun.H100_BYTES
                assert r["flops_per_device"] > 0
    mtime = out.stat().st_mtime_ns
    assert dryrun.main(argv) == recs
    assert len(calls) == len(FAMILY_REPS) * len(TINY)   # nothing ran again
    assert out.stat().st_mtime_ns == mtime


def test_serve_main_gives_a_serve_tasks_tokens():
    from repro_torch.core import (FunkyRuntime, SliceAllocator, TaskStatus)

    argv = ["--arch", "qwen3-8b-smoke", "--batch", "2", "--prompt-len", "8",
            "--tokens", "8", "--tokens-per-step", "4", "--device", "cpu"]
    out = launch_serve.main(argv)
    assert out["new_tokens"] == 8 and out["tokens"] == 16
    rt = FunkyRuntime("n0", SliceAllocator("n0", 1, device="cpu"))
    rt.create("t", launch_serve.image_of(launch_serve.parse_args(argv)))
    rt.start("t")
    assert rt.wait("t", timeout=120) is TaskStatus.DONE
    assert out["last_token"] == rt.tasks["t"].guest_state.user["last_token"]
    rt.delete("t")


def test_train_main_native_and_funky_end_on_the_same_loss():
    argv = ["--arch", "yi-9b-smoke", "--steps", "2", "--batch", "4",
            "--seq", "16", "--chunks", "2", "--device", "cpu"]
    native = launch_train.main(argv + ["--native"])
    funky = launch_train.main(argv)
    assert funky["steps"] == 2
    assert native["final_loss"] == funky["final_loss"]
    assert np.isfinite(native["loss_last"])
