"""Resharding a format-v2 snapshot onto device meshes, on four gloo ranks
(``repro_torch.ckpt.resharding``).

Snapshots of yi-9b-smoke, deepseek-moe-16b-smoke and yi-9b-smoke with 2
kv heads (which a model axis of 4 does not divide), with their AdamW
state, are saved with ``save_snapshot``; every rank loads them and lays
them onto (2, 2), (4, 1) and (1, 4) ``("data", "model")`` meshes with
``reshard_snapshot_buffers``, then back onto the next mesh from the
gathered values.  Each rank's local shard equals the numpy slice the
rules' spec names for it, ``full_tensor()`` equals the snapshot to the
bit, the moments take the parameters' layout, the count and the other
buffers replicate, and a dimension that does not divide its axes is
replicated.
"""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.testing import run_ranks  # noqa: E402

ARCHS = ("yi-9b-smoke", "deepseek-moe-16b-smoke", "yi-9b-smoke-kv2")
MESHES = ((2, 2), (4, 1), (1, 4))


def _cfg(arch):
    import dataclasses

    from repro_torch.configs import get_arch

    if arch.endswith("-kv2"):
        return dataclasses.replace(get_arch(arch[:-4]), name=arch,
                                   num_kv_heads=2)
    return get_arch(arch)


def _state(arch):
    """The snapshot's buffers: parameters from seed 0, random AdamW
    moments (v non-negative) and a count, and a small buffer."""
    from repro_torch.models.model_zoo import build_model
    from repro_torch.train.optimizer import OptConfig, init_opt_state
    from repro_torch.tree import tree_map

    cfg = _cfg(arch)
    params = build_model(cfg).init(0, device="cpu")
    opt = init_opt_state(OptConfig(), params)
    gen = torch.Generator().manual_seed(1)
    opt["m"] = tree_map(lambda p: torch.randn(p.shape, generator=gen), params)
    opt["v"] = tree_map(lambda p: torch.rand(p.shape, generator=gen), params)
    opt["count"] = torch.tensor(3, dtype=torch.int32)
    return {"params": params, "opt_state": opt,
            "rng": torch.arange(4, dtype=torch.int64)}


def _paths(tree):
    from repro_torch.tree import tree_map_with_path

    out = []
    tree_map_with_path(lambda p, t: out.append((p, t)), tree)
    return dict(out)


def _ranks_body(rank, world, snap_dirs):
    """Each snapshot onto each mesh in turn; what every rank checked."""
    from repro_torch.ckpt import load_snapshot, reshard_snapshot_buffers
    from repro_torch.launch.mesh import MeshShape, make_mesh
    from repro_torch.sharding.rules import ShardingRules
    from repro_torch.testing import shard_slice
    from repro_torch.tree import tree_map

    out = {}
    for arch, snap_dir in snap_dirs.items():
        cfg = _cfg(arch)
        snap, _ = load_snapshot(snap_dir)
        want = snap.buffers
        cur = want
        for shape in MESHES + MESHES[:1]:
            mesh = make_mesh(shape, ("data", "model"), device="cpu")
            sizes = MeshShape.of(mesh).shape
            coords = {a: mesh.get_local_rank(a) for a in sizes}
            laid = reshard_snapshot_buffers(cfg, cur, mesh)
            rules = ShardingRules(cfg, mesh)
            specs = _paths(rules.param_specs(want["params"]))
            # where the rules shard a dimension when every axis divides it
            whole = ShardingRules(cfg, MeshShape({"data": 1, "model": 1}))
            intended = _paths(whole.param_specs(want["params"]))
            rec = {"slices": True, "full": True, "moments": True,
                   "replicated": True, "non_dividing": 0}
            for key in ("params", "m", "v"):
                tree = laid["params"] if key == "params" \
                    else laid["opt_state"][key]
                ref = want["params"] if key == "params" \
                    else want["opt_state"][key]
                got, ref = _paths(tree), _paths(ref)
                for path, t in got.items():
                    spec = specs[path]
                    full = ref[path]
                    idx = shard_slice(spec, tuple(full.shape), coords,
                                      sizes)
                    local = t.to_local()
                    rec["slices"] &= torch.equal(local, full[idx])
                    rec["full"] &= torch.equal(t.full_tensor(), full)
                    if key != "params":
                        rec["moments"] &= (t.placements == _paths(
                            laid["params"])[path].placements)
                    for d, e in enumerate(spec):
                        if e is None and intended[path][d] is not None:
                            rec["non_dividing"] += 1
                            rec["replicated"] &= (local.shape[d]
                                                  == full.shape[d])
            for t in (laid["opt_state"]["count"], laid["rng"]):
                rec["replicated"] &= all(p.is_replicate()
                                         for p in t.placements)
            rec["full"] &= torch.equal(laid["rng"].full_tensor(),
                                       want["rng"])
            out[(arch, shape)] = rec
            # back: the gathered values are the next mesh's host tree
            cur = tree_map(lambda t: t.full_tensor(), laid)
        out[(arch, "back")] = all(
            torch.equal(a, b) for a, b in zip(
                _paths(cur).values(), _paths(want).values()))
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    from repro_torch.ckpt import save_snapshot
    from repro_torch.core.state import GuestState, TaskSnapshot

    root = tmp_path_factory.mktemp("reshard")
    dirs = {}
    for arch in ARCHS:
        dirs[arch] = str(root / arch)
        save_snapshot(dirs[arch], TaskSnapshot(
            task_id=arch, guest_state=GuestState(step=3),
            buffers=_state(arch),
            versions={"params": 1, "opt_state": 1, "rng": 1}))
    return run_ranks(_ranks_body, 4, root / "group", dirs)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", MESHES)
def test_local_shards_are_the_specs_numpy_slices(ranks, arch, shape):
    assert all(r[(arch, shape)]["slices"] for r in ranks)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", MESHES)
def test_full_tensor_equals_the_snapshot(ranks, arch, shape):
    assert all(r[(arch, shape)]["full"] for r in ranks)


@pytest.mark.parametrize("arch", ARCHS)
def test_moments_take_the_parameters_layout(ranks, arch):
    assert all(r[(arch, s)]["moments"] for r in ranks for s in MESHES)


@pytest.mark.parametrize("arch", ARCHS)
def test_non_dividing_dimensions_replicate(ranks, arch):
    for r in ranks:
        assert all(r[(arch, s)]["replicated"] for s in MESHES)
    # 2 kv heads do not divide a model axis of 4
    if arch.endswith("-kv2"):
        assert all(r[(arch, (1, 4))]["non_dividing"] > 0 for r in ranks)


@pytest.mark.parametrize("arch", ARCHS)
def test_round_trip_back_to_the_bit(ranks, arch):
    assert all(r[(arch, "back")] for r in ranks)
