"""The launch layer over a mesh (``build_cell(..., mesh)``, ``dryrun``
and ``roofline`` on a fake process group).

* ``build_cell`` on a (1, 1) ``("data", "model")`` mesh of a one-rank
  gloo group for the six family representatives x train / prefill /
  decode (the counterpart of ``tests/test_launch_small.py``'s
  lower-and-compile case): each step's outputs equal the mesh-less
  cell's to the bit (at one rank every op runs on whole tensors), and
  so does a train step of one-row microbatches under each policy;
* ``dryrun.run_cell`` of smoke cells over a fake group of 16 ranks (a
  4 x 4 mesh): the record names the mesh and the fake backend, and its
  per-device argument bytes equal the sum of the local shard sizes the
  sharding rules give each argument;
* ``dryrun.main --mesh single`` over a smoke cell on the 256-rank
  production mesh, and ``roofline.analyze_cell`` on the 4 x 4 mesh;
* ``roofline.analytic_memory_bytes`` at the production meshes, under
  each policy, equal to the reference's for the ten full-width archs.
"""

import dataclasses
import functools
import math
import os

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import repro.models.model_zoo as jzoo  # noqa: E402
from repro.configs import SHAPES as JSHAPES  # noqa: E402
from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.configs.registry import ARCHS as JARCHS  # noqa: E402
from repro_torch.configs import SHAPES, applicable, get_arch  # noqa: E402
from repro_torch.launch import dryrun, roofline  # noqa: E402
from repro_torch.launch.mesh import MeshShape, make_mesh  # noqa: E402
from repro_torch.launch.steps import build_cell  # noqa: E402
from repro_torch.sharding.rules import NamedSharding  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

TINY = {
    "train": dataclasses.replace(SHAPES["train_4k"], seq_len=16,
                                 global_batch=4),
    "prefill": dataclasses.replace(SHAPES["prefill_32k"], seq_len=64,
                                   global_batch=2),
    "decode": dataclasses.replace(SHAPES["decode_32k"], seq_len=64,
                                  global_batch=2),
}
FAMILY_REPS = ["yi-9b-smoke", "deepseek-v3-671b-smoke", "mamba2-1.3b-smoke",
               "recurrentgemma-9b-smoke", "seamless-m4t-large-v2-smoke",
               "llava-next-mistral-7b-smoke"]
FAKE = ((4, 4), ("data", "model"))


@pytest.fixture
def one_rank_mesh():
    """A (1, 1) mesh of a one-rank gloo group, closed after the test."""
    import torch.distributed as dist

    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield make_mesh((1, 1), ("data", "model"), device="cpu")
    finally:
        dist.destroy_process_group()


def _full(t):
    from torch.distributed.tensor import DTensor

    return t.full_tensor() if isinstance(t, DTensor) else t


@pytest.mark.parametrize("arch", FAMILY_REPS)
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_build_cell_on_a_one_rank_mesh(one_rank_mesh, arch, kind):
    cfg = get_arch(arch)
    kw = dict(num_microbatches=2) if kind == "train" else {}
    plain = build_cell(cfg, TINY[kind], **kw)
    cell = build_cell(cfg, TINY[kind], one_rank_mesh, **kw)
    assert cell.mesh is one_rank_mesh and cell.policy == "fsdp_tp"
    assert len(cell.in_placements) == len(cell.abstract_args)
    grad = torch.enable_grad() if kind == "train" else torch.no_grad()
    with grad:
        want = plain.fn(*plain.materialize("cpu", 0))
        got = cell.fn(*cell.materialize("cpu", 0))
    w, g = tree_leaves(want), tree_leaves(got)
    assert len(w) == len(g)
    for a, b in zip(g, w):
        assert torch.equal(_full(a), b)
    if kind != "train":                      # the rules' cache layout
        for t, s in zip(tree_leaves(got[1]), tree_leaves(
                cell.out_placements[1])):
            assert t.placements == s.placements_for(t.shape)


@pytest.mark.parametrize("arch", FAMILY_REPS)
@pytest.mark.parametrize("policy", ["tp", "fsdp_tp", "fsdp"])
def test_one_row_microbatches_on_a_one_rank_mesh(one_rank_mesh, arch,
                                                 policy):
    """A train step whose microbatches hold one row each: the batch
    dimension is replicated, not sharded over the data axis, in the
    forward and in the backward, and the step equals the mesh-less one
    to the bit."""
    cfg = get_arch(arch)
    shape = dataclasses.replace(TINY["train"], global_batch=2)
    plain = build_cell(cfg, shape, num_microbatches=2)
    cell = build_cell(cfg, shape, one_rank_mesh, policy=policy,
                      num_microbatches=2)
    with torch.enable_grad():
        want = plain.fn(*plain.materialize("cpu", 0))
        got = cell.fn(*cell.materialize("cpu", 0))
    w, g = tree_leaves(want), tree_leaves(got)
    assert len(w) == len(g)
    for a, b in zip(g, w):
        assert torch.equal(_full(a), b)


def _local_bytes(tree, shardings) -> int:
    """Bytes of a tree's local shards on one rank, from the specs."""
    total = 0
    for t, s in zip(tree_leaves(tree), tree_leaves(shardings)):
        shape = list(t.shape)
        sizes = MeshShape.of(s.mesh).shape
        for d, e in enumerate(s.spec):
            if e is None or shape[d] == 1:
                continue
            axes = (e,) if isinstance(e, str) else e
            shape[d] //= math.prod(sizes[a] for a in axes)
        total += math.prod(shape) * t.element_size()
    return total


@pytest.mark.parametrize("arch", ["yi-9b-smoke", "deepseek-moe-16b-smoke"])
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_dryrun_over_a_fake_group(arch, kind):
    from repro_torch.launch.mesh import fake_process_group

    shape = dataclasses.replace(TINY[kind], global_batch=8)
    rec = dryrun.run_cell(arch, shape, mesh=FAKE, num_microbatches=2
                          if kind == "train" else 1)
    assert rec["status"] == "ok", rec.get("error")
    assert rec["mesh"] == "4x4" and rec["backend"] == "fake"
    assert rec["mesh_shape"] == {"data": 4, "model": 4}
    with fake_process_group(16):
        mesh = make_mesh(*FAKE, device="meta")
        cell = build_cell(get_arch(arch), shape, mesh,
                          num_microbatches=2 if kind == "train" else 1)
        want = sum(_local_bytes(a, s) for a, s in zip(
            cell.abstract_args, cell.in_placements))
    assert rec["arg_bytes"] == want
    assert rec["peak_bytes"] >= rec["arg_bytes"]
    assert rec["flops_per_device"] > 0
    if kind == "train":                     # the gradients' reductions
        assert rec["collectives"]["total_count"] > 0


def test_dryrun_main_on_the_production_mesh(tmp_path, monkeypatch):
    monkeypatch.setattr(dryrun, "SHAPES", {"decode_32k": TINY["decode"]})
    out = tmp_path / "dryrun.json"
    recs = dryrun.main(["--mesh", "single", "--arch", "yi-9b-smoke",
                        "--out", str(out)])
    assert len(recs) == 1
    r = recs[0]
    assert r["status"] == "ok" and r["mesh"] == "single"
    assert r["backend"] == "fake" and r["mesh_shape"] == {"data": 16,
                                                          "model": 16}
    assert r["arg_bytes"] > 0


def test_roofline_over_a_fake_group():
    shape = dataclasses.replace(TINY["train"], global_batch=8)
    rec = roofline.analyze_cell("yi-9b-smoke", shape, mesh=FAKE,
                                policy="fsdp_tp")
    assert rec["status"] == "ok" and rec["n_chips"] == 16
    assert rec["mesh"] == "4x4" and rec["backend"] == "fake"
    assert rec["link_bw"] == roofline.INTER_NODE_BW        # 16 > 8 cards
    assert rec["collective_s"] > 0
    one = roofline.analyze_cell("yi-9b-smoke", shape)
    assert one["n_chips"] == 1 and one["collective_s"] == 0.0
    assert one["link_bw"] == roofline.NVLINK_BW
    # the mesh divides the work: each device does less than one card
    assert rec["required_flops"] < one["required_flops"]


_JCOUNT = jzoo.analytic_param_count


@functools.lru_cache(maxsize=None)
def _jcount(name: str, active_only: bool) -> int:
    return _JCOUNT(jget_arch(name), active_only=active_only)


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


class MockMesh:
    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)

    @property
    def size(self):
        return math.prod(self.shape.values())


@pytest.mark.parametrize("arch", sorted(JARCHS))
def test_memory_model_at_the_production_meshes(arch, jroofline):
    jcfg, tcfg = jget_arch(arch), get_arch(arch)
    for shape in ({"data": 16, "model": 16},
                  {"pod": 2, "data": 16, "model": 16}):
        for name, shp in SHAPES.items():
            if not applicable(tcfg, shp)[0]:
                continue
            for policy in ("tp", "fsdp_tp", "fsdp"):
                for remat in ("none", "full"):
                    got = roofline.analytic_memory_bytes(
                        tcfg, shp, MeshShape(shape), policy=policy,
                        remat=remat)
                    want = jroofline.analytic_memory_bytes(
                        jcfg, JSHAPES[name], MockMesh(shape), policy=policy,
                        remat=remat, train_impl="naive")
                    assert got == want, (shape, name, policy, remat)


def test_named_sharding_placements():
    mesh = MeshShape({"data": 2, "model": 2})
    from repro_torch.sharding.rules import P

    s = NamedSharding(mesh, P("data", None))
    assert s.spec == P("data", None)
    assert s.placements_for((1, 4)) != s.placements
    assert tree_map(lambda x: x, {"a": s})["a"] is s
