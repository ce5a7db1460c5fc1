"""Incremental, async-capable, crash-consistent checkpointing.

Layout of one checkpoint directory (on-disk format v2, the reference's)::

    <path>/manifest.json       step, guest state, buffer index, versions,
                               per-file sha256 digests, prev_path chain link
    <path>/image.pkl           TaskImage (how to re-instantiate the guest)
    <path>/guest.pkl           full-fidelity guest (VM) state
    <path>/specs.pkl           buffer spec map (plain shapes and dtypes)
    <path>/<buff>.npz          flattened tree leaves (one file per buffer)
    <path>/<buff>.treedef      tree structure and leaf dtypes

The manifest keys, the file names and the ``.npz`` leaves
(``leaf_{i:05d}`` in flatten order: dict keys sorted, as
``jax.tree.flatten`` orders them) are the reference's, so either package's
snapshot reads with plain numpy.  bfloat16 leaves are stored as a
``uint16`` view with ``"bfloat16"`` recorded as their dtype.  The
``.treedef`` sidecar holds this package's own structure description
(``repro_torch.tree``: plain tuples, strings and the dtype list).

**Crash consistency**: everything is written into a hidden ``.tmp-*``
sibling directory first (invisible to ``snapshot_candidates``), each file
is fsync'd, the manifest is written *last* via temp-file + ``os.replace``,
and only then is the directory atomically renamed into place.  A crash at
any byte leaves either the previous snapshot or debris that is never
discoverable as valid.

**Integrity**: the manifest records a sha256 per payload file.
``load_snapshot`` verifies every file before it reads any, and raises
``CheckpointCorruptError`` naming the offending buffer/file.
``load_latest_good`` walks the incremental ``prev_path`` chain back to the
last snapshot that verifies.

**Incremental**: pass ``prev_path`` — buffers whose write-version is
unchanged since the previous checkpoint are *referenced*, not rewritten
(the on-disk analogue of dirty-only eviction, paper §3.4); their digests
carry over so a rotted ancestor file is still caught.

**Async**: ``AsyncCheckpointer`` runs ``save_snapshot`` on a background
thread while the task keeps running.  Host trees are mutable tensors, so a
snapshot must never see a later write: only a paged buffer's dirty-page
merge patches a host copy in place, and it copies first while the copy is
shared with a snapshot (``Buffer.host_shared``).

Loaded leaves are CPU tensors.
"""

from __future__ import annotations

import glob as _glob
import hashlib
import json
import os
import pickle
import shutil
import tempfile
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.state import GuestState, TaskSnapshot
from repro_torch.tree import tree_flatten, tree_unflatten


class CheckpointCorruptError(RuntimeError):
    """A snapshot failed integrity verification: missing/truncated/
    bit-flipped file or unreadable manifest.  The message names the
    offending buffer and path so operators can see *what* rotted."""


_VIEW_FOR_ITEMSIZE = {1: np.uint8, 2: np.uint16, 4: np.uint32, 8: np.uint64}


def _leaf_array(leaf) -> Tuple[np.ndarray, str]:
    """(array as stored, recorded dtype string) of one leaf."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu").contiguous()
        if t.dtype == torch.bfloat16:
            # numpy has no bfloat16: store the bits, record the type
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        a = t.numpy()
    else:
        a = np.asarray(leaf)
    dt = a.dtype.str if a.dtype.kind != "V" else str(a.dtype)
    if a.dtype.kind == "V" or not a.dtype.isnative:
        a = a.view(_VIEW_FOR_ITEMSIZE[a.dtype.itemsize])
    return a, dt


def _leaf_tensor(a: np.ndarray, dt: str) -> torch.Tensor:
    if dt == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    want = np.dtype(dt)
    if a.dtype != want:
        a = a.view(want)
    return torch.from_numpy(a)


def _write_tree(path_prefix: str, tree: Any) -> int:
    leaves, treedef = tree_flatten(tree)
    arrays = {}
    dtypes = []
    for i, leaf in enumerate(leaves):
        a, dt = _leaf_array(leaf)
        dtypes.append(dt)
        arrays[f"leaf_{i:05d}"] = a
    np.savez(path_prefix + ".npz", **arrays)
    with open(path_prefix + ".treedef", "wb") as f:
        pickle.dump((treedef, dtypes), f)
    return sum(a.nbytes for a in arrays.values())


def _read_tree(path_prefix: str) -> Any:
    with open(path_prefix + ".treedef", "rb") as f:
        treedef, dtypes = pickle.load(f)
    with np.load(path_prefix + ".npz") as z:
        leaves = [_leaf_tensor(z[k], dt)
                  for k, dt in zip(sorted(z.files), dtypes)]
    return tree_unflatten(treedef, leaves)


def _plain_specs(specs: dict, paged) -> dict:
    """Buffer specs (trees of meta tensors) as plain data: structure, then
    (shape, dtype name) per leaf, and the paged flag."""
    out = {}
    for buff_id, spec in specs.items():
        leaves, treedef = tree_flatten(spec)
        out[buff_id] = {
            "structure": treedef,
            "leaves": [(tuple(x.shape), str(x.dtype).replace("torch.", ""))
                       for x in leaves],
            "paged": buff_id in paged}
    return out


def _specs_from_plain(plain: dict) -> Tuple[dict, tuple]:
    specs = {}
    for buff_id, d in plain.items():
        specs[buff_id] = tree_unflatten(d["structure"], [
            torch.empty(shape, dtype=getattr(torch, dt), device="meta")
            for shape, dt in d["leaves"]])
    return specs, tuple(i for i, d in plain.items() if d["paged"])


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _fsync_file(path: str) -> None:
    with open(path, "rb") as f:
        os.fsync(f.fileno())


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _peek_manifest(path: str) -> Optional[dict]:
    """Best-effort manifest read (chain walking); None when unreadable."""
    try:
        with open(os.path.join(path, "manifest.json")) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def snapshot_candidates(roots, cid: str) -> List[str]:
    """Published snapshot dirs for ``cid`` under the given ckpt root(s),
    newest step first.  ``.tmp-*`` write debris never matches; steps sort
    numerically (``step10`` after ``step9``)."""
    if isinstance(roots, str):
        roots = [roots]
    hits = []
    for root in roots:
        for p in _glob.glob(os.path.join(root, f"{cid}-step*")):
            try:
                step = int(p.rsplit("-step", 1)[1])
            except ValueError:
                continue
            hits.append((step, p))
    return [p for _, p in sorted(hits, reverse=True)]


def save_snapshot(path: str, snap: TaskSnapshot, image=None,
                  prev_path: Optional[str] = None, chaos=None) -> dict:
    """Crash-consistently write a snapshot; returns stats
    {written_bytes, reused_buffers, seconds, write_seconds, fsync_seconds,
    sha256_seconds}.

    ``chaos`` (a ``repro_torch.chaos.FaultPlan``) may fire ``ckpt.save``
    (torn write — raises mid-stream with nothing published) or
    ``ckpt.corrupt`` (post-publish bit flip in one buffer file, caught by
    digests)."""
    t0 = time.perf_counter()
    t_write = t_fsync = t_sha = 0.0
    path = os.path.abspath(path)
    if prev_path is not None and os.path.abspath(prev_path) == path:
        prev_path = None                   # re-checkpoint of the same step
    parent = os.path.dirname(path)
    os.makedirs(parent, exist_ok=True)

    prev_index: dict = {}
    prev_versions: dict = {}
    prev_digests: dict = {}
    if prev_path and os.path.exists(os.path.join(prev_path, "manifest.json")):
        with open(os.path.join(prev_path, "manifest.json")) as f:
            prev = json.load(f)
        prev_index = prev.get("buffers", {})
        prev_versions = prev.get("versions", {})
        prev_digests = prev.get("digests", {})

    # hidden tmp dir: the leading dot keeps write debris out of the
    # "<cid>-step*" discovery glob if we crash before the publish rename
    tmp = tempfile.mkdtemp(prefix=".tmp-" + os.path.basename(path) + "-",
                           dir=parent)
    try:
        index = {}
        digests: Dict[str, dict] = {}
        written = 0
        reused = 0
        for buff_id, tree in snap.buffers.items():
            version = snap.versions.get(buff_id, -1)
            if (buff_id in prev_index
                    and prev_versions.get(buff_id) == version
                    and version >= 0):
                index[buff_id] = prev_index[buff_id]  # reference, not rewrite
                if buff_id in prev_digests:
                    digests[buff_id] = prev_digests[buff_id]
                reused += 1
                continue
            if chaos is not None:
                chaos.raise_if("ckpt.save", key=f"{path}:{buff_id}")
            name = buff_id.replace("/", "_")
            t = time.perf_counter()
            written += _write_tree(os.path.join(tmp, name), tree)
            t_write += time.perf_counter() - t
            t = time.perf_counter()
            for ext in (".npz", ".treedef"):
                _fsync_file(os.path.join(tmp, name + ext))
            t_fsync += time.perf_counter() - t
            # the manifest records the *final* location; files move there
            # with the directory rename
            index[buff_id] = os.path.join(path, name)
            t = time.perf_counter()
            digests[buff_id] = {
                ext.lstrip("."): _sha256(os.path.join(tmp, name + ext))
                for ext in (".npz", ".treedef")}
            t_sha += time.perf_counter() - t

        # Full-fidelity guest (VM) state goes to a pickle; the manifest
        # keeps a human-readable summary.
        file_digests = {}
        sidecars = [("guest.pkl", snap.guest_state),
                    ("specs.pkl", _plain_specs(snap.buffer_specs,
                                               snap.paged))]
        if image is not None:
            sidecars.append(("image.pkl", image))
        for fname, obj in sidecars:
            fpath = os.path.join(tmp, fname)
            with open(fpath, "wb") as f:
                pickle.dump(obj, f)
            _fsync_file(fpath)
            file_digests[fname] = _sha256(fpath)
        if chaos is not None:
            chaos.raise_if("ckpt.save", key=f"{path}:manifest")
        manifest = {
            "format": 2,
            "task_id": snap.task_id,
            "step": snap.step,
            "created_at": snap.created_at,
            "program_ids": list(snap.program_ids),
            "guest_state": {
                "step": snap.guest_state.step,
                "seed": snap.guest_state.seed,
                "data_position": snap.guest_state.data_position,
                "user_keys": sorted(snap.guest_state.user),
            },
            "buffers": index,
            "versions": snap.versions,
            "digests": digests,
            "file_digests": file_digests,
            "prev_path": (os.path.abspath(prev_path)
                          if prev_path else None),
        }
        # manifest last, atomically: its existence is what makes the
        # directory a valid snapshot
        mtmp = os.path.join(tmp, "manifest.json.tmp")
        with open(mtmp, "w") as f:
            json.dump(manifest, f, indent=1)
            f.flush()
            os.fsync(f.fileno())
        os.replace(mtmp, os.path.join(tmp, "manifest.json"))
        _fsync_dir(tmp)
    except BaseException:
        # a *real* caller error should not leave debris; an injected torn
        # write keeps it (that is the point — restore must cope)
        if chaos is None:
            shutil.rmtree(tmp, ignore_errors=True)
        raise

    # publish: atomic directory rename (same-step overwrite moves the old
    # dir aside first — nothing newer can reference a same-step path)
    if os.path.exists(path):
        aside = tmp + ".old"
        os.rename(path, aside)
        os.rename(tmp, path)
        shutil.rmtree(aside, ignore_errors=True)
    else:
        os.rename(tmp, path)
    _fsync_dir(parent)

    if chaos is not None and chaos.check("ckpt.corrupt", key=path):
        _corrupt_one_file(path, chaos.rng)
    return {"written_bytes": written, "reused_buffers": reused,
            "seconds": time.perf_counter() - t0, "write_seconds": t_write,
            "fsync_seconds": t_fsync, "sha256_seconds": t_sha}


def _corrupt_one_file(path: str, rng) -> None:
    """Bit-rot simulation: flip one byte mid-file in a (seeded-)random
    buffer file of a published snapshot."""
    files = sorted(_glob.glob(os.path.join(path, "*.npz")))
    if not files:
        return
    victim = files[rng.randrange(len(files))]
    with open(victim, "r+b") as f:
        f.seek(0, os.SEEK_END)
        size = f.tell()
        if size == 0:
            return
        off = size // 2
        f.seek(off)
        b = f.read(1)
        f.seek(off)
        f.write(bytes([b[0] ^ 0xFF]))


def _verify_file(path: str, want: Optional[str], what: str) -> None:
    if not os.path.exists(path):
        raise CheckpointCorruptError(f"{what}: missing file {path}")
    if want is not None and _sha256(path) != want:
        raise CheckpointCorruptError(
            f"{what}: digest mismatch in {path} (truncated or corrupt)")


def _size(path: str) -> int:
    try:
        return os.path.getsize(path)
    except OSError:
        return -1                          # missing: reported first


def load_snapshot(path: str, verify: bool = True,
                  stats: Optional[dict] = None) -> Tuple[TaskSnapshot, Any]:
    """Load and (for format-2 manifests) digest-verify one snapshot.

    Every file is verified before any is read, smallest first, so a
    corrupt snapshot fails before its large buffers are read.  Raises
    ``CheckpointCorruptError`` naming the offending buffer/file on any
    integrity failure — including a missing ``prev_path``-referenced
    incremental buffer.  ``stats``, when given, accumulates
    ``verify_seconds``, ``read_seconds`` and ``read_bytes``."""
    stats = stats if stats is not None else {}
    for k in ("verify_seconds", "read_seconds", "read_bytes"):
        stats.setdefault(k, 0)
    mpath = os.path.join(path, "manifest.json")
    if not os.path.exists(mpath):
        raise CheckpointCorruptError(
            f"{path}: manifest.json missing (torn or unpublished snapshot)")
    try:
        with open(mpath) as f:
            manifest = json.load(f)
    except (OSError, ValueError) as e:
        raise CheckpointCorruptError(
            f"{path}: unreadable manifest.json ({e})") from e

    digests = manifest.get("digests", {}) if verify else {}
    file_digests = manifest.get("file_digests", {}) if verify else {}
    checks = [(prefix + ext, (digests.get(buff_id) or {}).get(
                   ext.lstrip(".")), f"buffer {buff_id!r}")
              for buff_id, prefix in manifest["buffers"].items()
              for ext in (".npz", ".treedef")]
    checks += [(os.path.join(path, fname), file_digests.get(fname), fname)
               for fname in ("guest.pkl", "specs.pkl", "image.pkl")
               if os.path.exists(os.path.join(path, fname))]
    t0 = time.perf_counter()
    for fpath, want, what in sorted(checks, key=lambda c: _size(c[0])):
        _verify_file(fpath, want, what)
    stats["verify_seconds"] += time.perf_counter() - t0

    t0 = time.perf_counter()
    buffers = {}
    for buff_id, prefix in manifest["buffers"].items():
        try:
            buffers[buff_id] = _read_tree(prefix)
        except Exception as e:  # noqa: BLE001 - zip/pickle/shape errors
            raise CheckpointCorruptError(
                f"buffer {buff_id!r}: unreadable at {prefix} ({e!r})") from e
        stats["read_bytes"] += _size(prefix + ".npz")

    def _load_pickle(fname: str):
        fpath = os.path.join(path, fname)
        if not os.path.exists(fpath):
            return None
        try:
            with open(fpath, "rb") as f:
                return pickle.load(f)
        except Exception as e:  # noqa: BLE001
            raise CheckpointCorruptError(
                f"{path}: unreadable {fname} ({e!r})") from e

    guest_state = _load_pickle("guest.pkl")
    if guest_state is None:  # legacy manifests
        gs = manifest["guest_state"]
        guest_state = GuestState(step=gs["step"], seed=gs["seed"],
                                 data_position=gs["data_position"],
                                 user=dict(gs.get("user", {})))
    specs, paged = _specs_from_plain(_load_pickle("specs.pkl") or {})
    snap = TaskSnapshot(
        task_id=manifest["task_id"],
        guest_state=guest_state,
        buffers=buffers,
        buffer_specs=specs,
        program_ids=tuple(manifest["program_ids"]),
        created_at=manifest["created_at"],
        step=manifest["step"],
        versions={k: int(v) for k, v in manifest.get("versions", {}).items()},
        paged=paged,
    )
    image = _load_pickle("image.pkl")
    stats["read_seconds"] += time.perf_counter() - t0
    return snap, image


def load_latest_good(path: str, stats: Optional[dict] = None
                     ) -> Tuple[TaskSnapshot, Any, str, list]:
    """Load ``path`` or, when it fails verification, walk the incremental
    ``prev_path`` chain back to the last-good ancestor.

    Returns ``(snap, image, used_path, skipped)`` where ``skipped`` is a
    list of ``(path, reason)`` for every corrupt snapshot passed over.
    Raises ``CheckpointCorruptError`` (listing everything tried) when no
    ancestor verifies.  ``stats`` accumulates over every attempt."""
    cur: Optional[str] = path
    skipped: list = []
    seen = set()
    while cur is not None and cur not in seen:
        seen.add(cur)
        try:
            snap, image = load_snapshot(cur, stats=stats)
            return snap, image, cur, skipped
        except CheckpointCorruptError as e:
            skipped.append((cur, str(e)))
            m = _peek_manifest(cur)
            cur = m.get("prev_path") if m else None
    tried = "; ".join(f"{p}: {r}" for p, r in skipped)
    raise CheckpointCorruptError(
        f"no restorable snapshot in chain starting at {path} ({tried})")


class AsyncCheckpointer:
    """Overlap checkpoint I/O with compute (one outstanding save)."""

    def __init__(self, chaos=None):
        self._thread: Optional[threading.Thread] = None
        self._last_stats: Optional[dict] = None
        self._error: Optional[BaseException] = None
        self.chaos = chaos

    def save(self, path: str, snap: TaskSnapshot, image=None,
             prev_path: Optional[str] = None):
        self.wait()

        def run():
            try:
                self._last_stats = save_snapshot(path, snap, image,
                                                 prev_path,
                                                 chaos=self.chaos)
            except BaseException as e:  # noqa: BLE001 - re-raised in wait
                self._error = e

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def wait(self) -> Optional[dict]:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            e, self._error = self._error, None
            raise e
        return self._last_stats
