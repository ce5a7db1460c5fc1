"""The port's on-disk snapshots (``repro_torch.ckpt``, format v2) against
``tests/test_ckpt.py``'s cases, on torch trees with bfloat16 and float32
leaves: exact roundtrips, incremental reuse, async saves, versions, torn
writes never discoverable, bit flips and truncation naming the buffer, a
missing incremental parent, the chain walk, legacy manifests and numeric
step order.  One more case holds the layout to the reference's: the same
state saved by ``repro.ckpt.save_snapshot`` and by the port gives the same
manifest keys, format, step, versions, buffer ids and leaf dtypes, and
equal ``.npz`` leaves read with plain numpy.  A ``gpu`` case roundtrips
CUDA tensors bit for bit."""

import json
import os
import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.chaos import FaultPlan, FaultSpec, InjectedCrash  # noqa: E402
from repro_torch.ckpt import (AsyncCheckpointer,  # noqa: E402
                              CheckpointCorruptError, load_latest_good,
                              load_snapshot, save_snapshot,
                              snapshot_candidates)
from repro_torch.core.state import GuestState, TaskSnapshot  # noqa: E402


def _snap(step=0, versions=None, val=1.0):
    buffers = {
        "params": {"w": torch.full((4, 4), val, dtype=torch.float32),
                   "b": torch.ones(3, dtype=torch.bfloat16) * val},
        "opt_state": {"m": (torch.zeros(2, dtype=torch.int64),)},
    }
    return TaskSnapshot(task_id="t", guest_state=GuestState(step=step),
                        buffers=buffers, step=step,
                        versions=versions or {"params": 1, "opt_state": 1})


def _flip_middle_byte(f):
    with open(f, "r+b") as fh:
        fh.seek(os.path.getsize(f) // 2)
        b = fh.read(1)
        fh.seek(-1, os.SEEK_CUR)
        fh.write(bytes([b[0] ^ 0xFF]))


def test_roundtrip_exact(tmp_path):
    p = str(tmp_path / "ck")
    save_snapshot(p, _snap(step=5))
    snap, image = load_snapshot(p)
    assert snap.step == 5 and image is None
    assert snap.guest_state.step == 5
    w = snap.buffers["params"]["w"]
    assert isinstance(w, torch.Tensor) and w.dtype == torch.float32
    assert torch.equal(w, torch.full((4, 4), 1.0))
    b = snap.buffers["params"]["b"]
    assert b.dtype == torch.bfloat16                # dtype survives npz
    assert torch.equal(b.float(), torch.ones(3))
    assert isinstance(snap.buffers["opt_state"]["m"], tuple)  # structure
    assert snap.buffers["opt_state"]["m"][0].dtype == torch.int64


def test_incremental_reuses_unchanged_buffers(tmp_path):
    p1 = str(tmp_path / "c1")
    p2 = str(tmp_path / "c2")
    s1 = _snap(step=1, versions={"params": 3, "opt_state": 3})
    stats1 = save_snapshot(p1, s1)
    assert stats1["reused_buffers"] == 0
    # params changed (version bump), opt_state unchanged
    s2 = _snap(step=2, versions={"params": 4, "opt_state": 3}, val=2.0)
    stats2 = save_snapshot(p2, s2, prev_path=p1)
    assert stats2["reused_buffers"] == 1
    assert stats2["written_bytes"] < stats1["written_bytes"]
    snap, _ = load_snapshot(p2)
    assert torch.equal(snap.buffers["params"]["w"], torch.full((4, 4), 2.0))
    # the reused buffer is read from the previous snapshot's directory
    with open(os.path.join(p2, "manifest.json")) as f:
        m = json.load(f)
    assert m["buffers"]["opt_state"] == os.path.join(p1, "opt_state")


def test_async_checkpointer(tmp_path):
    ck = AsyncCheckpointer()
    p = str(tmp_path / "a1")
    ck.save(p, _snap(step=9))
    stats = ck.wait()
    assert stats["written_bytes"] > 0
    snap, _ = load_snapshot(p)
    assert snap.step == 9


def test_async_save_never_sees_a_later_paged_write(tmp_path):
    """Host trees are mutable: a snapshot taken from a buffer table keeps
    the values of its moment while the task's next dirty-page merge
    patches the host copy (copy-on-write, ``Buffer.host_shared``)."""
    from repro_torch.core.state import BufferTable

    table = BufferTable()
    pool = {"k": torch.zeros(4, 2)}
    table.register("kv_pool", {"k": torch.empty(4, 2, device="meta")},
                   paged=True)
    table.on_h2d("kv_pool", pool, {"k": pool["k"].clone()})
    table.on_execute_write("kv_pool", {"k": torch.ones(4, 2)},
                           dirty_pages=[1])
    table.on_d2h("kv_pool")
    snap = TaskSnapshot(task_id="t", guest_state=GuestState(step=1),
                        buffers=table.host_snapshot(), step=1,
                        versions=table.versions(),
                        buffer_specs=table.spec_map(),
                        paged=table.paged_ids())
    held = snap.buffers["kv_pool"]["k"].clone()
    ck = AsyncCheckpointer()
    ck.save(str(tmp_path / "cow"), snap)
    # the task runs on: page 2 is written and merged into the host copy
    table.on_execute_write("kv_pool", {"k": torch.full((4, 2), 7.0)},
                           dirty_pages=[2])
    table.on_d2h("kv_pool")
    ck.wait()
    assert torch.equal(snap.buffers["kv_pool"]["k"], held)
    assert table.get("kv_pool").host_value["k"][2].eq(7.0).all()
    got, _ = load_snapshot(str(tmp_path / "cow"))
    assert torch.equal(got.buffers["kv_pool"]["k"], held)
    assert got.paged == ("kv_pool",)


def test_versions_persisted(tmp_path):
    p = str(tmp_path / "v")
    save_snapshot(p, _snap(versions={"params": 42, "opt_state": 7}))
    snap, _ = load_snapshot(p)
    assert snap.versions == {"params": 42, "opt_state": 7}


# ---------------------------------------------------------------------------
# Crash consistency & integrity (on-disk format v2)
# ---------------------------------------------------------------------------
def test_torn_write_never_discoverable(tmp_path):
    p = str(tmp_path / "t-step3")
    plan = FaultPlan([FaultSpec(site="ckpt.save", kind="torn", at=1)])
    with pytest.raises(InjectedCrash):
        save_snapshot(p, _snap(step=3), chaos=plan)
    assert not os.path.exists(p)
    assert snapshot_candidates(str(tmp_path), "t") == []
    debris = os.listdir(tmp_path)
    assert debris and all(d.startswith(".tmp-") for d in debris)
    with pytest.raises(CheckpointCorruptError, match="manifest.json missing"):
        load_snapshot(p)


def test_torn_manifest_write_never_discoverable(tmp_path):
    p = str(tmp_path / "t-step4")
    plan = FaultPlan([FaultSpec(site="ckpt.save", kind="torn", at=1,
                                match="manifest")])
    with pytest.raises(InjectedCrash):
        save_snapshot(p, _snap(step=4), chaos=plan)
    assert not os.path.exists(p)
    assert snapshot_candidates(str(tmp_path), "t") == []


def test_bitflip_detected_and_names_buffer(tmp_path):
    p = str(tmp_path / "bf")
    save_snapshot(p, _snap(step=1))
    _flip_middle_byte(os.path.join(p, "params.npz"))
    with pytest.raises(CheckpointCorruptError, match="'params'"):
        load_snapshot(p)


def test_corrupt_site_flips_a_published_file(tmp_path):
    """``ckpt.corrupt`` fires after publish: the snapshot is discoverable
    and fails verification."""
    p = str(tmp_path / "x-step1")
    plan = FaultPlan([FaultSpec(site="ckpt.corrupt", kind="corrupt", at=1)],
                     seed=4)
    save_snapshot(p, _snap(step=1), chaos=plan)
    assert snapshot_candidates(str(tmp_path), "x") == [p]
    assert [f[0] for f in plan.fired] == ["ckpt.corrupt"]
    with pytest.raises(CheckpointCorruptError, match="digest mismatch"):
        load_snapshot(p)


def test_truncation_detected(tmp_path):
    p = str(tmp_path / "tr")
    save_snapshot(p, _snap(step=1))
    f = os.path.join(p, "opt_state.npz")
    with open(f, "r+b") as fh:
        fh.truncate(os.path.getsize(f) // 2)
    with pytest.raises(CheckpointCorruptError, match="'opt_state'"):
        load_snapshot(p)


def test_missing_incremental_parent_buffer_named(tmp_path):
    p1, p2 = str(tmp_path / "c1"), str(tmp_path / "c2")
    save_snapshot(p1, _snap(step=1, versions={"params": 3, "opt_state": 3}))
    save_snapshot(p2, _snap(step=2, versions={"params": 4, "opt_state": 3},
                            val=2.0), prev_path=p1)
    os.remove(os.path.join(p1, "opt_state.npz"))
    with pytest.raises(CheckpointCorruptError, match="'opt_state'"):
        load_snapshot(p2)


def test_load_latest_good_walks_chain(tmp_path):
    p1, p2 = str(tmp_path / "c1"), str(tmp_path / "c2")
    save_snapshot(p1, _snap(step=1, versions={"params": 3, "opt_state": 3}))
    save_snapshot(p2, _snap(step=2, versions={"params": 4, "opt_state": 3},
                            val=2.0), prev_path=p1)
    os.remove(os.path.join(p2, "params.npz"))
    stats = {}
    snap, _, used, skipped = load_latest_good(p2, stats)
    assert used == os.path.abspath(p1) and snap.step == 1
    assert len(skipped) == 1 and skipped[0][0] == p2
    assert torch.equal(snap.buffers["params"]["w"], torch.full((4, 4), 1.0))
    assert stats["read_bytes"] > 0 and stats["verify_seconds"] >= 0
    # whole chain rotten -> loud failure listing everything tried
    os.remove(os.path.join(p1, "manifest.json"))
    with pytest.raises(CheckpointCorruptError, match="no restorable"):
        load_latest_good(p2)


def test_legacy_manifest_without_digests_loads(tmp_path):
    p = str(tmp_path / "v1")
    save_snapshot(p, _snap(step=6))
    mpath = os.path.join(p, "manifest.json")
    with open(mpath) as f:
        m = json.load(f)
    for k in ("digests", "file_digests", "prev_path", "format"):
        m.pop(k, None)
    with open(mpath, "w") as f:
        json.dump(m, f)
    snap, _ = load_snapshot(p)
    assert snap.step == 6


def test_snapshot_candidates_numeric_order(tmp_path):
    for step in (2, 9, 10):
        save_snapshot(str(tmp_path / f"c-step{step}"), _snap(step=step))
    os.makedirs(tmp_path / ".tmp-c-step11-x")
    os.makedirs(tmp_path / "c-stepNaN")
    got = snapshot_candidates([str(tmp_path)], "c")
    assert [os.path.basename(p) for p in got] == \
        ["c-step10", "c-step9", "c-step2"]


# ---------------------------------------------------------------------------
# The layout is the reference's
# ---------------------------------------------------------------------------
def _np_state():
    """Nested numpy state with bf16, f32, int32 and bool leaves; dict keys
    deliberately out of order, so the flatten order is what is tested."""
    import ml_dtypes

    rng = np.random.default_rng(0)
    return {
        "params": {
            "zeta": rng.standard_normal((3, 5)).astype(np.float32),
            "emb": rng.standard_normal((6, 4)).astype(ml_dtypes.bfloat16),
            "blocks": [{"w": rng.standard_normal((2, 2)).astype(np.float32),
                        "a": rng.standard_normal(3).astype(
                            ml_dtypes.bfloat16)} for _ in range(2)],
        },
        "kv_pool": ({"v": rng.integers(0, 9, (4, 2)).astype(np.int32),
                     "k": rng.standard_normal((4, 2)).astype(np.float32)},
                    np.array([True, False])),
        "pos": np.int32(7),
    }


def test_layout_matches_the_reference(tmp_path):
    import jax

    from repro.ckpt import save_snapshot as jsave
    from repro.core.state import GuestState as JGuestState
    from repro.core.state import TaskSnapshot as JTaskSnapshot
    from repro_torch.testing import params_from_jax

    state = _np_state()
    versions = {"params": 1, "kv_pool": 5, "pos": 2}
    jp, tp = str(tmp_path / "jax"), str(tmp_path / "port")
    jsave(jp, JTaskSnapshot(task_id="t", guest_state=JGuestState(step=3),
                            buffers=state, step=3, versions=versions))
    save_snapshot(tp, TaskSnapshot(
        task_id="t", guest_state=GuestState(step=3),
        buffers={k: params_from_jax(v) for k, v in state.items()}, step=3,
        versions=versions))
    mj, mt = (json.load(open(os.path.join(p, "manifest.json")))
              for p in (jp, tp))
    assert sorted(mj) == sorted(mt)
    for k in ("format", "task_id", "step", "versions", "program_ids",
              "guest_state", "prev_path"):
        assert mj[k] == mt[k], k
    assert sorted(mj["buffers"]) == sorted(mt["buffers"]) == sorted(state)
    assert sorted(mj["digests"]) == sorted(mt["digests"])
    assert sorted(mj["file_digests"]) == sorted(mt["file_digests"])
    for buff_id in state:
        name = os.path.basename(mt["buffers"][buff_id])
        assert name == os.path.basename(mj["buffers"][buff_id])
        with open(os.path.join(jp, name + ".treedef"), "rb") as f:
            jdef, jdt = pickle.load(f)
        with open(os.path.join(tp, name + ".treedef"), "rb") as f:
            _, tdt = pickle.load(f)
        assert jdt == tdt, buff_id                # per-leaf dtype strings
        assert jdef.num_leaves == len(tdt)
        with np.load(os.path.join(jp, name + ".npz")) as zj, \
                np.load(os.path.join(tp, name + ".npz")) as zt:
            assert sorted(zj.files) == sorted(zt.files)
            for leaf in zj.files:
                assert zj[leaf].dtype == zt[leaf].dtype, (buff_id, leaf)
                np.testing.assert_array_equal(zj[leaf], zt[leaf])
        # and the leaf order is jax.tree.flatten's
        flat = jax.tree.leaves(state[buff_id])
        with np.load(os.path.join(tp, name + ".npz")) as zt:
            for i, want in enumerate(flat):
                got = zt[f"leaf_{i:05d}"]
                want = np.asarray(want)
                if want.dtype.kind == "V":
                    want = want.view(np.uint16)
                np.testing.assert_array_equal(got, want)


def test_port_reads_the_reference_leaves(tmp_path):
    """The port's reader takes a reference-written ``.npz`` (its leaves
    and recorded dtypes) through the port's own sidecar: values and
    dtypes come back exact, bfloat16 included."""
    from repro.ckpt import save_snapshot as jsave
    from repro.core.state import GuestState as JGuestState
    from repro.core.state import TaskSnapshot as JTaskSnapshot
    from repro_torch.ckpt.checkpoint import _read_tree
    from repro_torch.testing import params_from_jax
    from repro_torch.tree import tree_flatten

    state = _np_state()
    jp = str(tmp_path / "jax")
    jsave(jp, JTaskSnapshot(task_id="t", guest_state=JGuestState(),
                            buffers=state, versions={}))
    for buff_id, tree in state.items():
        want = params_from_jax(tree)
        leaves, treedef = tree_flatten(want)
        with open(os.path.join(jp, buff_id + ".treedef"), "rb") as f:
            _, dtypes = pickle.load(f)
        with open(os.path.join(jp, buff_id + ".treedef"), "wb") as f:
            pickle.dump((treedef, dtypes), f)
        got_leaves, got_def = tree_flatten(_read_tree(
            os.path.join(jp, buff_id)))
        assert got_def == treedef
        for g, w in zip(got_leaves, leaves):
            assert g.dtype == w.dtype
            assert torch.equal(g, w)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
def test_cuda_snapshot_roundtrip_bits(tmp_path, cuda):
    """bf16 and f32 CUDA tensors (through the host copy a monitor keeps)
    write and restore to the same bits on the card."""
    from repro_torch.core.state import to_device, to_host

    g = torch.Generator(device=cuda).manual_seed(0)
    dev = {"w": torch.randn(64, 128, device=cuda, generator=g),
           "e": torch.randn(33, 7, device=cuda, generator=g).to(
               torch.bfloat16),
           "pos": torch.arange(5, device=cuda, dtype=torch.int32)}
    p = str(tmp_path / "gpu")
    save_snapshot(p, TaskSnapshot(task_id="t", guest_state=GuestState(),
                                  buffers={"params": to_host(dev)},
                                  versions={"params": 1}))
    snap, _ = load_snapshot(p)
    back = to_device(snap.buffers["params"], cuda)
    for k, v in dev.items():
        assert back[k].device.type == "cuda" and back[k].dtype == v.dtype
        bits = torch.int16 if v.dtype == torch.bfloat16 else None
        assert torch.equal(back[k].view(bits) if bits else back[k],
                           v.view(bits) if bits else v), k
