"""Device meshes (``repro_torch.launch.mesh``) and spec placements.

The factories over a process group and without one (``MeshShape``,
``production_shape``), refusals (no group; a mesh whose size is not the
group's), ``placements`` against the numpy slice a spec names on four
gloo ranks, ``shard_map`` with ``psum`` and ``axis_index``, and that
importing the multi-device modules starts no process group.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch import mesh as M  # noqa: E402
from repro_torch.sharding.rules import P, partial_over, placements  # noqa: E402
from repro_torch.testing import run_ranks, shard_slice  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]

SPECS = [P(("data", "model"), None), P("data", "model"), P("model", "data"),
         P(None, ("data", "model")), P("model", None), P(None, None),
         P("data")]


def _ranks_body(rank, world):
    """Every multi-rank check of this file, on one (2, 2) group."""
    import torch.distributed as dist
    from torch.distributed.tensor import distribute_tensor

    out = {}
    mesh = M.make_local_mesh(model=2, device="cpu")
    out["local_mesh"] = (tuple(mesh.shape), tuple(mesh.mesh_dim_names))
    out["mesh_shape"] = M.MeshShape.of(mesh).shape
    for bad in (lambda: M.make_local_mesh(model=3, device="cpu"),
                lambda: M.make_mesh((2, 4), ("data", "model"), device="cpu"),
                lambda: M.make_production_mesh(device="cpu")):
        try:
            bad()
            out.setdefault("refused", []).append(False)
        except ValueError:
            out.setdefault("refused", []).append(True)
    sizes = M.MeshShape.of(mesh).shape
    coords = {a: mesh.get_local_rank(a) for a in sizes}
    full = torch.arange(8 * 12, dtype=torch.float32).reshape(8, 12)
    ok = []
    for spec in SPECS:
        d = distribute_tensor(full, mesh, placements(spec, mesh))
        want = full.numpy()[shard_slice(spec, full.shape, coords, sizes)]
        ok.append(np.array_equal(d.to_local().numpy(), want))
    out["slices"] = ok
    out["axis_index"] = {a: M.axis_index(mesh, a) for a in sizes}
    out["axis_index_both"] = M.axis_index(mesh, ("data", "model"))

    # a shard_map body: each rank's rows summed over "model" by psum
    x = distribute_tensor(full, mesh, placements(P("data", "model"), mesh))

    def body(t):
        return M.psum(t.sum(dim=1, keepdim=True), M.axis_group(mesh, "model"))

    y = M.shard_map(body, mesh, in_specs=(P("data", "model"),),
                    out_specs=P("data", None))(x)
    out["psum"] = np.array_equal(y.full_tensor().numpy(),
                                 full.sum(dim=1, keepdim=True).numpy())
    grp = M.axis_group(mesh, ("data", "model"))
    out["flat_group"] = dist.get_world_size(grp)
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return run_ranks(_ranks_body, 4, tmp_path_factory.mktemp("mesh"))


def test_local_mesh_over_the_group(ranks):
    for r in ranks:
        assert r["local_mesh"] == ((2, 2), ("data", "model"))
        assert r["mesh_shape"] == {"data": 2, "model": 2}


def test_a_mesh_never_resizes_to_fit(ranks):
    for r in ranks:
        assert r["refused"] == [True, True, True]


def test_placements_lay_out_the_spec_numpy_slices(ranks):
    for r in ranks:
        assert r["slices"] == [True] * len(SPECS)


def test_axis_index_is_data_major(ranks):
    seen = sorted((r["axis_index"]["data"], r["axis_index"]["model"],
                   r["axis_index_both"]) for r in ranks)
    assert seen == [(0, 0, 0), (0, 1, 1), (1, 0, 2), (1, 1, 3)]
    assert all(r["flat_group"] == 4 for r in ranks)


def test_shard_map_with_psum(ranks):
    assert all(r["psum"] for r in ranks)


def test_factories_need_a_group():
    import torch.distributed as dist

    if dist.is_initialized():
        pytest.skip("a process group is open in this process")
    with pytest.raises(RuntimeError):
        M.make_mesh((1, 1), ("data", "model"), device="cpu")
    with pytest.raises(RuntimeError):
        M.make_local_mesh(device="cpu")


def test_production_shapes():
    s, m = M.production_shape(), M.production_shape(multi_pod=True)
    assert s.shape == {"data": 16, "model": 16} and s.size == 256
    assert m.shape == {"pod": 2, "data": 16, "model": 16} and m.size == 512
    assert m.axis_names == ("pod", "data", "model")
    assert M.mesh_size(None) == 1 and M.mesh_size(m) == 512


def test_placements_of_specs():
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh = M.MeshShape({"data": 4, "model": 2})
    assert placements(P(("data", "model"), None), mesh) == (Shard(0),
                                                            Shard(0))
    assert placements(P("model", "data"), mesh) == (Shard(1), Shard(0))
    assert placements(P(None, None), mesh) == (Replicate(), Replicate())
    assert placements(partial_over(P(None), ("model",)), mesh) == (
        Replicate(), Partial())
    # a dimension of size 1 (sharded only where its axes have size 1)
    assert placements(P("model", "data"), mesh, (1, 8)) == (Shard(1),
                                                          Replicate())
    with pytest.raises(ValueError):         # against the mesh's order
        placements(P(("model", "data")), mesh)
    with pytest.raises(ValueError):         # one axis, two dimensions
        placements(P("data", "data"), mesh)


def test_fake_group_is_named_and_closed():
    import torch.distributed as dist

    if dist.is_initialized():
        pytest.skip("a process group is open in this process")
    with M.fake_process_group(16):
        assert dist.get_world_size() == 16 and dist.get_backend() == "fake"
        mesh = M.make_mesh((4, 4), ("data", "model"), device="meta")
        assert M.MeshShape.of(mesh).shape == {"data": 4, "model": 4}
    assert not dist.is_initialized()


def test_importing_the_multi_device_layer_starts_no_group():
    code = (
        "import torch, torch.distributed as dist\n"
        "import repro_torch.launch.mesh, repro_torch.sharding\n"
        "import repro_torch.ckpt.resharding, repro_torch.launch.steps\n"
        "import repro_torch.launch.dryrun, repro_torch.launch.roofline\n"
        "assert not dist.is_initialized()\n"
        "assert not torch.cuda.is_initialized()\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code],
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
