"""Import hygiene and device rules of the PyTorch port.

``repro_torch`` imports with ``jax`` blocked, loads no module of the
reference package and starts no process group; ``chip_smoke.py`` and
``train_memory.py`` import neither.  Nothing picks the CPU on its own: a CUDA request on a host
without a card raises, and a missing ``nvcc`` is an error, never a
fallback.  ``chip_smoke.py``'s ``disagg``, ``dense_archs``, ``moe``, ``mla``,
``families``, ``launch`` and ``mesh`` phases rehearse on the CPU at smoke
size, and so does its ``examples`` phase, which drives the ported
examples and tools (``examples_torch/*.py``, ``tools/*_torch.py``): these
import the port only.
No module sets an environment variable when it is imported (the
reference's ``launch/roofline.py`` and ``launch/dryrun.py`` set
``XLA_FLAGS``; the port's do not).
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]

_HYGIENE = """
import importlib, os, pkgutil, sys
sys.modules["jax"] = None
env = dict(os.environ)
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for n in names:
    importlib.import_module(n)
bad = sorted(m for m in sys.modules if m == "repro" or m.startswith("repro."))
assert not bad, bad
assert "jax" not in sys.modules or sys.modules["jax"] is None
assert dict(os.environ) == env, "a module set an environment variable"
import torch.distributed as dist
assert not dist.is_initialized(), "a module started a process group"
print(" ".join(names))
"""

# modules that must be among the walked ones (the training slice's, the
# tracer's and the prefix cache's too)
_EXPECTED = {"repro_torch.train.data", "repro_torch.train.optimizer",
             "repro_torch.train.train_step", "repro_torch.core.tasks",
             "repro_torch.models.transformer", "repro_torch.testing",
             "repro_torch.obs", "repro_torch.obs.tracer",
             "repro_torch.obs.export", "repro_torch.serve.prefix_cache",
             "repro_torch.serve.disagg", "repro_torch.configs.qwen3_8b",
             "repro_torch.configs.stablelm_3b",
             "repro_torch.configs.starcoder2_15b",
             "repro_torch.configs.deepseek_moe_16b", "repro_torch.models.moe",
             "repro_torch.configs.deepseek_v3_671b",
             "repro_torch.models.attention", "repro_torch.serve.kvcache",
             "repro_torch.models.encdec",
             "repro_torch.configs.seamless_m4t_large_v2",
             "repro_torch.configs.llava_next_mistral_7b",
             "repro_torch.launch", "repro_torch.launch.steps",
             "repro_torch.launch.op_stats", "repro_torch.launch.roofline",
             "repro_torch.launch.dryrun", "repro_torch.launch.serve",
             "repro_torch.launch.train", "repro_torch.launch.mesh",
             "repro_torch.sharding", "repro_torch.sharding.rules",
             "repro_torch.ckpt.resharding"}


def test_port_imports_without_jax_or_the_reference():
    out = subprocess.run([sys.executable, "-c", _HYGIENE],
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    names = set(out.stdout.split())
    assert len(names) >= 30                     # every module was imported
    assert _EXPECTED <= names, _EXPECTED - names


def _imported_modules(path: Path) -> set:
    mods = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            mods.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            mods.add(node.module)
    return mods


# the JAX package's examples and tools, ported: scripts of their own that
# import the port only
PORTED_SCRIPTS = sorted((ROOT / "examples_torch").glob("*.py")) + sorted(
    (ROOT / "tools").glob("*_torch.py"))


def test_port_sources_and_chip_smoke_import_nothing_of_the_reference():
    files = list((ROOT / "src" / "repro_torch").rglob("*.py"))
    files += [ROOT / "chip_smoke.py", ROOT / "train_memory.py"]
    files += PORTED_SCRIPTS
    assert {f.name for f in PORTED_SCRIPTS} == {
        "quickstart.py", "checkpoint_restore.py", "preemptive_cluster.py",
        "elastic_serving.py", "cluster_smoke_torch.py", "smoke_all_torch.py",
        "trace_dump_torch.py"}
    for f in files:
        for m in _imported_modules(f):
            top = m.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro", "flax"), (f, m)


_SCRIPT_HYGIENE = """
import importlib.util, sys
sys.modules["jax"] = None
for i, path in enumerate(sys.argv[1:]):
    spec = importlib.util.spec_from_file_location(f"script{i}", path)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = sorted(m for m in sys.modules if m == "repro" or m.startswith("repro."))
assert not bad, bad
print(len(sys.argv) - 1)
"""


def test_ported_scripts_import_without_jax_or_the_reference(tmp_path):
    """Each ported script loads from another directory with ``jax``
    blocked (its ``src/`` is found from its own path) and loads nothing of
    the reference; loading one runs nothing."""
    out = subprocess.run(
        [sys.executable, "-c", _SCRIPT_HYGIENE,
         *map(str, PORTED_SCRIPTS)], cwd=tmp_path,
        env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"},
        capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == [str(len(PORTED_SCRIPTS))]


def test_chip_smoke_fails_without_the_repo(tmp_path):
    """Alone in a directory (or on a host without a card) it exits non-zero
    and prints no result."""
    script = tmp_path / "chip_smoke.py"
    script.write_text((ROOT / "chip_smoke.py").read_text())
    out = subprocess.run([sys.executable, str(script)], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")


def test_cuda_requests_raise_without_a_card(no_card):
    from repro_torch.core import SliceAllocator
    from repro_torch.configs import get_arch
    from repro_torch.device import resolve_device
    from repro_torch.models import build_model

    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    with pytest.raises(RuntimeError):
        resolve_device(None)                   # the default is the card
    with pytest.raises(RuntimeError):
        SliceAllocator("n0", 1)
    with pytest.raises(RuntimeError):
        build_model(get_arch("yi-9b-smoke")).init(0)
    from repro_torch.train import OptConfig, make_train_state

    with pytest.raises(RuntimeError):           # training too
        make_train_state(build_model(get_arch("yi-9b-smoke")), OptConfig(),
                         0)
    from repro_torch.configs import SHAPES
    from repro_torch.launch import serve, train
    from repro_torch.launch.steps import build_cell

    with pytest.raises(RuntimeError):           # and the launch layer
        build_cell(get_arch("yi-9b-smoke"), SHAPES["train_4k"]).materialize()
    with pytest.raises(RuntimeError):
        serve.main(["--arch", "yi-9b-smoke", "--tokens", "4"])
    with pytest.raises(RuntimeError):
        train.main(["--arch", "yi-9b-smoke", "--steps", "1", "--native"])


def test_explicit_cpu_and_meta_devices():
    from repro_torch.core import SliceAllocator
    from repro_torch.device import resolve_device

    assert SliceAllocator("n0", 2, device="cpu").device.type == "cpu"
    assert resolve_device("meta").type == "meta"
    with pytest.raises(ValueError):
        resolve_device("xla")


def test_missing_nvcc_is_an_error(monkeypatch, tmp_path):
    from repro_torch.kernels import build

    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setattr(build, "DEFAULT_NVCC", str(tmp_path / "nvcc"))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.nvcc_path()


def test_kernel_library_path_tracks_the_sources():
    from repro_torch.kernels import build

    p = build.library_path("flash_attention")
    assert p.parent == build.BUILD_DIR and p.suffix == ".so"
    assert p == build.library_path("flash_attention")
    assert p != build.library_path("decode_attention")
    assert build.BUILD_DIR.parts[-2:] == ("build", "kernels")
    assert (build.CSRC / "flash_attention.cu").exists()
    assert (build.CSRC / "decode_attention.cu").exists()


def test_every_kernel_source_is_built():
    """K1-K4 each build from their own source (one nvcc each)."""
    from repro_torch.kernels import build

    assert build.SOURCES == ("flash_attention", "decode_attention",
                             "ssd_scan", "rglru_scan")
    paths = {build.library_path(n) for n in build.SOURCES}
    assert len(paths) == 4
    for n in build.SOURCES:
        assert (build.CSRC / f"{n}.cu").exists()


def test_chip_smoke_disagg_phase_rehearses_on_the_cpu():
    """The ``disagg`` phase's code path at smoke size on the CPU: the pair
    serves the mixed engine's tokens, two transfers torn and replayed
    (launch counts are gated on the card only)."""
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    state = {}
    chip_smoke.phase_disagg(state, device="cpu", cut=dict(
        arch="yi-9b-smoke", page_size=4, n_requests=6, ref_pool=None,
        prompt_buckets=(8, 16), prompt_len=16, max_new_tokens=4,
        decode_slots=4))
    d = state["disagg"]
    assert d["a"]["handoff_total"] >= 1 and d["b"]["torn"] == 2
    assert d["a"]["requests"] == d["b"]["requests"] == 6


def test_chip_smoke_dense_archs_phase_rehearses_on_the_cpu():
    """The ``dense_archs`` phase's code path on the three smoke archs on
    the CPU: served through the runtime, kernel path against plain path,
    the engine single-step and fused (same tokens) and on a monitor to the
    logit checks' iteration (launch counts and logits only on the card)."""
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    state = {}
    ec = dict(chip_smoke.ENGINE, page_size=4, prompt_buckets=(8, 16),
              prompt_len=16, max_new_tokens=4, pool_pages=64, n_requests=4)
    chip_smoke.phase_dense_archs(state, device="cpu", cut=dict(
        archs=("qwen3-8b-smoke", "stablelm-3b-smoke",
               "starcoder2-15b-smoke"), serve_prompt=16, logit_at=2,
        engine=ec))
    d = state["dense_archs"]
    assert [d[k]["arch"] for k in ("qwen3", "stablelm", "starcoder2")] == [
        "qwen3-8b-smoke", "stablelm-3b-smoke", "starcoder2-15b-smoke"]
    for k in ("qwen3", "stablelm", "starcoder2"):
        assert d[k]["parity"]["logit_rel_err"] == [0.0] * 5
        a = d[k]["engine"]["a_single_step"]
        assert a["prefills"] >= 4 and a["decode_steps"] > 0


def test_chip_smoke_moe_phase_rehearses_on_the_cpu():
    """The ``moe`` phase's code path on deepseek-moe-16b-smoke on the CPU:
    served through the runtime, kernel path against plain path, the engine
    single-step and fused (same tokens) and on a monitor to the logit
    checks' iteration (launch counts, logits, routing and the expert
    path's trace only on the card)."""
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    state = {}
    ec = dict(chip_smoke.ENGINE, page_size=4, prompt_buckets=(8, 16),
              prompt_len=16, max_new_tokens=4, pool_pages=64, n_requests=4)
    chip_smoke.phase_moe(state, device="cpu", cut=dict(
        arch="deepseek-moe-16b-smoke", serve_prompt=16, logit_at=2,
        engine=ec))
    d = state["moe"]["deepseek_moe"]
    assert d["arch"] == "deepseek-moe-16b-smoke"
    assert d["experts"] == [8, 2, 2]
    assert d["parity"]["logit_rel_err"] == [0.0] * 5
    a = d["engine"]["a_single_step"]
    assert a["prefills"] >= 4 and a["decode_steps"] > 0


def test_chip_smoke_mla_phase_rehearses_on_the_cpu():
    """The ``mla`` phase's code path on deepseek-v3-671b-smoke on the CPU:
    served through the runtime, absorbed decode against decompressed on
    the absorbed side's routing (within the card's bound here too), the
    engine single-step and fused over latent pages (same tokens) and on a
    monitor to the logit checks' iteration; no kernel launches (the counts
    and the logit checks are gated only on the card)."""
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    state = {}
    ec = dict(chip_smoke.ENGINE, page_size=4, prompt_buckets=(8, 16),
              prompt_len=16, max_new_tokens=4, pool_pages=64, n_requests=4)
    chip_smoke.phase_mla(state, device="cpu", cut=dict(
        arch="deepseek-v3-671b-smoke", serve_prompt=16, logit_at=2,
        engine=ec))
    d = state["mla"]["deepseek_v3"]
    assert d["arch"] == "deepseek-v3-671b-smoke" and d["layers_of"] == 61
    assert d["mla"] == [32, 32, 16, 8, 16]
    errs = d["parity"]["logit_rel_err"]
    assert 0 < max(errs) < chip_smoke.LOGIT_REL_TOL
    a = d["engine"]["a_single_step"]
    assert a["prefills"] >= 4 and a["decode_steps"] > 0
    assert not any(state["launches"]["mla"].values())


def test_chip_smoke_families_phase_rehearses_on_the_cpu():
    """The ``families`` phase's code path on both smoke archs on the CPU:
    seamless-m4t-large-v2-smoke and llava-next-mistral-7b-smoke served
    through ``generate`` (encdec from source frames and target tokens, the
    vlm decoding after its image), kernel path against plain path within
    the card's bound here too; nothing launches (the counts, the logit
    gate and the trace are checked only on the card)."""
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    state = {}
    chip_smoke.phase_families(state, device="cpu", cut=dict(
        archs=("seamless-m4t-large-v2-smoke", "llava-next-mistral-7b-smoke"),
        seq=32, batch=2, new_tokens=4))
    s, v = state["families"]["seamless"], state["families"]["llava"]
    assert s["prompt"] == {"src_emb": [2, 32, 64], "tgt_tokens": [2, 8]}
    assert s["first_decode_pos"] == 8 and s["layers"] == [2, 4]
    assert v["prompt"] == {"tokens": [2, 24], "img_emb": [2, 8, 64]}
    assert v["first_decode_pos"] == 32
    for rec in (s, v):
        assert 0 < max(rec["parity"]["logit_rel_err"]) \
            < chip_smoke.LOGIT_REL_TOL
        assert not any(rec["served"]["launches"].values())
    assert set(s["served"]["launches_by_case"]["K2"]) == {
        "enc", "dec_prefill", "cross"}


def test_chip_smoke_launch_phase_rehearses_on_the_cpu():
    """The ``launch`` phase's code path on the smoke archs on the CPU:
    ``launch.serve.main`` against a direct ``ServeTask``, the three remat
    runs of ``build_cell`` (equal losses and gradient norms), fig04's pair
    through ``launch.train.main`` (equal final losses), the roofline and
    the dry run beside them (launch counts, peaks and the budget only on
    the card)."""
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    assert chip_smoke.PEAK_BYTES_S == 3.35e12
    assert chip_smoke.PEAK_FLOP_S == {"bfloat16": 989e12, "float32": 67e12}
    state = {}
    chip_smoke.phase_launch(state, device="cpu", cut=dict(
        serve=dict(arch="qwen3-8b-smoke", layers=None, batch=2, prompt=16,
                   tokens=8, tokens_per_step=4),
        train=dict(arch="yi-9b-smoke", layers=None, seq=16, batch=4,
                   chunks=2, steps=2)))
    d = state["launch"]
    assert d["a"]["equal_to_direct"] and d["a"]["new_tokens"] == 8
    assert d["b"]["equal"]
    assert set(d["c"]) == {"none", "full", "dots"}
    assert len({r["loss"][0] for r in d["c"].values()}) == 1
    for cell in ("a_prefill", "a_decode", "c_train"):
        assert d["d"][cell]["bound_s"] > 0
    assert set(d["d"]["remat_peaks"]) == {"none", "full", "dots"}
    assert not any(state["launches"]["launch"].values())


def test_chip_smoke_mesh_phase_rehearses_on_the_cpu():
    """The ``mesh`` phase's code path on the smoke archs on the CPU, on a
    one-rank gloo group: (a) the train steps under the three policies
    equal the mesh-less step to the bit, (b) the snapshot restored onto
    the mesh equals it and the mesh cells' greedy tokens equal the
    mesh-less cells', (c) the MoE block under "local" and "a2a" equals
    the mesh-less dispatch (launch counts, peaks and the budget only on
    the card); the group is closed after the phase."""
    import torch.distributed as dist

    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    if dist.is_initialized():
        pytest.skip("a process group is open in this process")
    state = {}
    chip_smoke.phase_mesh(state, device="cpu", cut=dict(
        train=dict(arch="yi-9b-smoke", layers=None, seq=32, batch=4),
        serve=dict(arch="yi-9b-smoke", layers=None, prompt=16, tokens=4),
        moe=dict(arch="deepseek-moe-16b-smoke", seq=16)))
    d = state["mesh"]
    assert not dist.is_initialized()
    for policy in ("tp", "fsdp_tp", "fsdp"):
        r = d["a"][policy]
        assert r["loss_equal"] and r["params_equal"] and r["placements_kept"]
    assert d["b"]["restored_equal"] and d["b"]["tokens_equal"]
    assert d["b"]["new_tokens"] == 4
    for dispatch in ("local", "a2a"):
        assert d["c"][dispatch]["out_equal"] and d["c"][dispatch]["aux_equal"]
    assert not any(state["launches"]["mesh"].values())


def test_chip_smoke_examples_phase_rehearses_on_the_cpu():
    """The ``examples`` phase's code path at the smoke archs on the CPU,
    each script through its own ``main``: (a) quickstart (cut to 20
    steps) under its first step's loss, (b) an eviction and every job
    done, (c) the recovered job bit-equal to an uninterrupted run, (d)
    every request once, drained to one replica, sampled tokens equal to
    one engine's, (e) both smoke tools, (f) ``trace_dump_torch``'s check
    (launch counts, peaks and the budget only on the card)."""
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    state = {}
    chip_smoke.phase_examples(state, device="cpu", cut=dict(
        quickstart=dict(arch="yi-9b-smoke", layers=None, steps=20,
                        peak_lr=3e-3),
        preemptive=dict(batch_arch="yi-9b-smoke", batch_layers=None,
                        prod_arch="qwen3-8b-smoke", prod_layers=None),
        checkpoint=dict(arch="mamba2-1.3b-smoke", layers=None),
        elastic=dict(arch="yi-9b-smoke", layers=None, rate_s=0.5,
                     request_rate=10.0, duration_s=2.0, sample=4),
        smoke_all=dict(names=("yi-9b", "recurrentgemma-9b"))))
    d = state["examples"]
    a = d["a_quickstart"]
    assert a["step"] == 20 and a["final_loss"] < a["first_step_loss"]
    assert d["b_preemptive_cluster"]["preemptions"] >= 1
    assert d["c_checkpoint_restore"]["params_equal"]
    e = d["d_elastic_serving"]
    assert e["served"] == e["requests"] and e["sampled_equal"]
    assert e["replicas_after_drain"] == 1 and len(e["sampled"]) == 4
    assert d["e_cluster_smoke"]["ok"] and d["e_smoke_all"]["fails"] == 0
    assert d["f_trace_dump"]["rc"] == 0
    assert d["f_trace_dump"]["execute_device_spans"] > 0
    assert d["f_trace_dump"]["trace_of"] == "yi-9b-smoke, 2 requests"
    assert not any(state["launches"]["examples"].values())
