"""Import hygiene and device rules of the PyTorch port.

``repro_torch`` imports with ``jax`` blocked and loads no module of the
reference package; ``chip_smoke.py`` and ``train_memory.py`` import
neither.  Nothing picks the CPU on its own: a CUDA request on a host
without a card raises, and a missing ``nvcc`` is an error, never a
fallback.
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
import importlib, pkgutil, sys
sys.modules["jax"] = None
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for n in names:
    importlib.import_module(n)
bad = sorted(m for m in sys.modules if m == "repro" or m.startswith("repro."))
assert not bad, bad
assert "jax" not in sys.modules or sys.modules["jax"] is None
print(" ".join(names))
"""

# modules that must be among the walked ones (the training slice's too)
_EXPECTED = {"repro_torch.train.data", "repro_torch.train.optimizer",
             "repro_torch.train.train_step", "repro_torch.core.tasks",
             "repro_torch.models.transformer", "repro_torch.testing"}


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


def test_port_sources_and_chip_smoke_import_nothing_of_the_reference():
    files = list((ROOT / "src" / "repro_torch").rglob("*.py"))
    files += [ROOT / "chip_smoke.py", ROOT / "train_memory.py"]
    for f in files:
        for m in _imported_modules(f):
            top = m.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro", "flax"), (f, m)


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
