"""The port's sharding rules (``repro_torch.sharding.rules``).

Every case of ``tests/test_sharding_rules.py`` on the port, on a mesh
shape without devices (``MeshShape``, the reference's ``MockMesh``), and
parity with ``repro.sharding.rules.ShardingRules``: the reference's
abstract trees (``jax.eval_shape``) against the port's meta-device trees,
for the ten full-width archs, the three policies, the 16 x 16 and
2 x 16 x 16 meshes and, for the two MoE archs, the ``a2a`` expert
stacks; parameter specs leaf for leaf, and batch and cache specs for
every applicable ``SHAPES`` entry.
"""

import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs import SHAPES as JSHAPES  # noqa: E402
from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.models import build_model as jbuild_model  # noqa: E402
from repro.models import input_specs as jinput_specs  # noqa: E402
from repro.sharding.rules import ShardingRules as JRules  # noqa: E402

from repro_torch.configs import ARCHS, SHAPES, applicable, get_arch  # noqa: E402
from repro_torch.launch.mesh import MeshShape  # noqa: E402
from repro_torch.models.model_zoo import build_model, input_specs  # noqa: E402
from repro_torch.sharding import P, ShardingRules  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map_with_path  # noqa: E402

MESH = MeshShape({"data": 16, "model": 16})
MESH3 = MeshShape({"pod": 2, "data": 16, "model": 16})
MOE_ARCHS = ("deepseek-moe-16b", "deepseek-v3-671b")


def _abstract_params(arch):
    cfg = get_arch(arch)
    return cfg, build_model(cfg).init(0, device="meta")


def _flat(tree):
    """[(path, leaf)] of a port tree in flatten order (dict keys sorted,
    as ``tree_leaves`` and ``jax.tree`` order them)."""
    out = []
    tree_map_with_path(lambda p, s: out.append((p, s)), tree)
    return sorted(out, key=lambda e: tuple(map(str, e[0])))


# --- the reference's cases, on the port ---------------------------------

@pytest.mark.parametrize("arch", list(ARCHS))
def test_every_leaf_gets_a_valid_spec(arch):
    cfg, abstract = _abstract_params(arch)
    specs = ShardingRules(cfg, MESH).param_specs(abstract)
    leaves = dict(_flat(abstract))
    flat = _flat(specs)
    assert len(leaves) == len(flat) == len(tree_leaves(abstract))
    for path, spec in flat:
        leaf = leaves[path]
        assert isinstance(spec, P)
        assert len(spec) <= leaf.dim(), (path, spec, leaf.shape)
        for dim, ax in zip(leaf.shape, tuple(spec) + (None,) * 8):
            if ax is None:
                continue
            axes = ax if isinstance(ax, tuple) else (ax,)
            size = 1
            for a in axes:
                size *= MESH.shape[a]
            assert dim % size == 0, (arch, path, spec, leaf.shape)


def test_gqa_kv_heads_fall_back_to_replication():
    cfg, abstract = _abstract_params("yi-9b")      # kv=4 < model=16
    specs = ShardingRules(cfg, MESH).param_specs(abstract)
    wk = [s for p, s in _flat(specs) if "wk" in p]
    assert wk and all(s[1 if len(s) == 3 else 2] is None for s in wk)


def test_moe_experts_sharded_over_model():
    cfg, abstract = _abstract_params("deepseek-v3-671b")
    specs = ShardingRules(cfg, MESH).param_specs(abstract)
    experts = [s for p, s in _flat(specs) if "w_up" in p and len(s) == 4]
    assert experts                          # stacked (L, E, D, F)
    for s in experts:
        assert s[1] == "model"              # EP over the model axis


def test_cache_specs_seq_fallback():
    cfg = get_arch("qwen3-8b")              # kv=8 not divisible by 16
    specs = input_specs(cfg, SHAPES["decode_32k"])
    cs = ShardingRules(cfg, MESH).cache_specs(specs["caches"])
    k_specs = [s for p, s in _flat(cs) if "k" in p]
    assert k_specs
    for s in k_specs:
        assert s[2] == "model" and s[3] is None    # seq-sharded cache


def test_batch_replicates_when_too_small():
    cfg = get_arch("mamba2-1.3b")
    specs = input_specs(cfg, SHAPES["long_500k"])   # global_batch = 1
    cs = ShardingRules(cfg, MESH).cache_specs(specs["caches"])
    for p, s in _flat(cs):
        if len(s) >= 2 and s[1] is not None:
            raise AssertionError(f"batch=1 must not shard: {p} {s}")


def test_fsdp_policy_shards_more_than_tp():
    cfg, abstract = _abstract_params("qwen3-8b")
    tp = ShardingRules(cfg, MESH, "tp").param_specs(abstract)
    fs = ShardingRules(cfg, MESH, "fsdp_tp").param_specs(abstract)

    def sharded_dims(specs):
        return sum(sum(1 for a in s if a is not None)
                   for _, s in _flat(specs))

    assert sharded_dims(fs) > sharded_dims(tp)


def test_multipod_dp_axes():
    rules = ShardingRules(get_arch("yi-9b"), MESH3)
    assert rules.dp == ("pod", "data")
    assert rules.dp_size == 32


def test_unknown_policy_raises():
    with pytest.raises(ValueError):
        ShardingRules(get_arch("yi-9b"), MESH, "zero")


# --- parity with the reference's rules -----------------------------------

class MockMesh:
    """The reference tests' mesh without devices."""

    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)

    @property
    def size(self):
        n = 1
        for v in self.shape.values():
            n *= v
        return n


def _norm(spec):
    """A spec as a plain tuple of None / axis name / tuple of names; a
    tuple of one name is that name (JAX's ``PartitionSpec`` stores
    ("data",) as "data", the port keeps the rules' tuple: one layout)."""
    def entry(e):
        if e is None or isinstance(e, str):
            return e
        e = tuple(e)
        return e[0] if len(e) == 1 else e
    return tuple(entry(e) for e in spec)


def _jflat(specs):
    from jax.sharding import PartitionSpec as JP

    flat = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, JP))[0]
    out = [(tuple(getattr(k, "key", getattr(k, "idx", None))
                  for k in path), _norm(s)) for path, s in flat]
    return sorted(out, key=lambda e: tuple(map(str, e[0])))


def _pflat(specs):
    return [(p, _norm(s)) for p, s in _flat(specs)]


@functools.lru_cache(maxsize=None)
def _trees(arch):
    """The reference's abstract parameters and the port's meta ones."""
    jcfg = jget_arch(arch)
    jparams = jax.eval_shape(jbuild_model(jcfg).init, jax.random.key(0))
    return jparams, build_model(get_arch(arch)).init(0, device="meta")


CASES = [(a, pol, m, "local") for a in ARCHS
         for pol in ("tp", "fsdp_tp", "fsdp") for m in ("single", "multi")]
CASES += [(a, pol, m, "a2a") for a in MOE_ARCHS
          for pol in ("tp", "fsdp_tp", "fsdp") for m in ("single", "multi")]


@pytest.mark.parametrize("arch,policy,mesh,dispatch", CASES)
def test_specs_equal_the_reference(arch, policy, mesh, dispatch):
    shape = ({"data": 16, "model": 16} if mesh == "single"
             else {"pod": 2, "data": 16, "model": 16})
    jcfg = dataclasses.replace(jget_arch(arch), moe_dispatch=dispatch)
    tcfg = dataclasses.replace(get_arch(arch), moe_dispatch=dispatch)
    jr = JRules(jcfg, MockMesh(shape), policy)
    tr = ShardingRules(tcfg, MeshShape(shape), policy)
    assert tr.batch_axes == jr.batch_axes and tr.dp == jr.dp
    jparams, tparams = _trees(arch)
    assert _pflat(tr.param_specs(tparams)) == _jflat(
        jr.param_specs(jparams))
    n_shapes = 0
    for name, shp in SHAPES.items():
        if not applicable(tcfg, shp)[0]:
            continue
        n_shapes += 1
        jspecs, tspecs = jinput_specs(jcfg, JSHAPES[name]), input_specs(
            tcfg, shp)
        if shp.kind == "decode":
            assert _pflat(tr.cache_specs(tspecs["caches"])) == _jflat(
                jr.cache_specs(jspecs["caches"])), name
            assert _norm(P(tr._batch_dim(shp.global_batch))) == _norm(
                (jr._batch_dim(shp.global_batch),)), name
        else:
            assert _pflat(tr.batch_specs(tspecs["batch"])) == _jflat(
                jr.batch_specs(jspecs["batch"])), name
    assert n_shapes > 0
