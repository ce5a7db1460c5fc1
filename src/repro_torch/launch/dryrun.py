"""Dry run of every (arch x shape) cell on the meta device, on one card
or over a production mesh.  The port of ``repro.launch.dryrun``.

For every applicable cell this driver:
  1. builds the step and its abstract arguments (``launch.steps``),
  2. runs the step on the meta device at the cell's full shape: nothing
     is computed or allocated, but every op checks its shapes and dtypes
     (the reference's "the partitioner must accept the shardings"),
  3. records the arguments' bytes and an estimate of the peak bytes
     (``LiveBytes``), the matrix-product FLOPs (``op_stats``) and whether
     the peak fits one card,
  4. appends the record to a JSON results file (resumable; ``--force``
     starts over).

The peak is tracked by a dispatch mode of this module, ``LiveBytes``: each
op's outputs register their storage, and a weakref finalizer on each
tensor releases the storage's bytes when its last tensor dies, so the
activations autograd saves count until the backward frees them.  It counts
tensors only: no allocator rounding, no cuBLAS workspace, no
fragmentation, so the card's peak is above it.

The card's memory is ``torch.cuda.get_device_properties`` on a host with a
card, else the H100's 80 GiB (``H100_BYTES``).  Most full-width cells do
not fit one card; that is recorded, not hidden.

``--mesh`` picks where the step runs: ``card`` (the default: one device),
or ``single`` / ``multi`` / ``both``, the reference's production meshes
(16 x 16 ``("data", "model")``, 2 x 16 x 16 ``("pod", "data", "model")``)
over a fake process group (``launch.mesh.fake_process_group``: 256 or 512
ranks in this process, collectives that move nothing).  There the step is
built with ``policy``'s layouts (``build_cell(..., mesh)``), its arguments
are DTensors of meta shards, and the record is rank 0's: per-device
argument bytes (its local shards), the peak over local shards
(``LiveBytes``), its FLOPs and its collectives (``op_stats``), and whether
that fits one H100.  Those records name the mesh and ``"backend":
"fake"``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun \\
        --arch all --shape all --out results/dryrun.json
    PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh multi \\
        --arch yi-9b --shape train_4k --out results/dryrun_mesh.json
"""

from __future__ import annotations

import argparse
import math
import time
import traceback
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import SHAPES, applicable, get_arch
from repro_torch.launch.mesh import (fake_process_group, is_dtensor,
                                     make_mesh, mesh_dims, mesh_name)
from repro_torch.launch.op_stats import count_step, tensors
from repro_torch.launch.steps import build_cell, sweep

H100_BYTES = 80 << 30          # one H100 SXM's HBM3


def card_bytes() -> int:
    """The memory of the card this host has, else one H100's."""
    if torch.cuda.is_available():
        return int(torch.cuda.get_device_properties(0).total_memory)
    return H100_BYTES


def _storage(t: torch.Tensor):
    """The storage of a tensor on this device (a DTensor's local
    shard's)."""
    if is_dtensor(t):
        t = t._local_tensor
    return t.untyped_storage()


class LiveBytes(TorchDispatchMode):
    """Bytes of tensor storage alive under the mode, and their peak.  The
    tensors of ``trees`` (the step's arguments) count from the start, as
    ``arg_bytes``; every tensor an op returns registers its storage, which
    counts until the last registered tensor on it is freed."""

    def __init__(self, *trees):
        super().__init__()
        self._live: dict = {}            # storage -> [tensors, bytes]
        self.now = 0
        self.peak = 0
        for t in tensors(trees):
            self._track(t)
        self.arg_bytes = self.now

    def _track(self, t: torch.Tensor):
        st = _storage(t)
        key = st._cdata
        ent = self._live.get(key)
        if ent is None:
            ent = self._live[key] = [0, st.nbytes()]
            self.now += ent[1]
            self.peak = max(self.peak, self.now)
        ent[0] += 1
        weakref.finalize(t, self._release, key)

    def _release(self, key):
        ent = self._live[key]
        ent[0] -= 1
        if not ent[0]:
            self.now -= ent[1]
            del self._live[key]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tensors(out):
            self._track(t)
        return out


def run_cell(arch, shape, *, remat: str = "full", num_microbatches: int = 1,
             mla_absorb: bool = True, mesh=None,
             policy: str = "fsdp_tp") -> dict:
    """The dry-run record of one cell.  ``arch`` is a name (``get_arch``)
    or a ``ModelConfig``; ``shape`` a name in ``SHAPES`` or a
    ``ShapeConfig``; ``mesh`` None (one card), "single", "multi", or a
    (shape, axis names) pair, the last three over a fake process group
    with ``policy``'s layouts."""
    cfg = get_arch(arch) if isinstance(arch, str) else arch
    shp = SHAPES[shape] if isinstance(shape, str) else shape
    rec: dict = {"arch": cfg.name, "shape": shp.name,
                 "mesh": mesh_name(mesh), "remat": remat,
                 "num_microbatches": num_microbatches}
    if mesh is not None:
        dims = mesh_dims(mesh)
        rec.update(backend="fake", policy=policy,
                   mesh_shape=dict(zip(dims[1], dims[0])))
    ok, why = applicable(cfg, shp)
    if not ok:
        rec.update(status="skipped", reason=why)
        return rec
    try:
        if mesh is None:
            rec.update(_run(cfg, shp, None, remat=remat,
                            num_microbatches=num_microbatches,
                            mla_absorb=mla_absorb))
        else:
            with fake_process_group(math.prod(dims[0])):
                dm = make_mesh(*dims, device="meta")
                rec.update(_run(cfg, shp, dm, remat=remat,
                                num_microbatches=num_microbatches,
                                mla_absorb=mla_absorb, policy=policy))
    except Exception as e:  # noqa: BLE001  (recorded; main exits 1 on it)
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   trace=traceback.format_exc(limit=8))
    return rec


def _run(cfg, shp, mesh, *, remat, num_microbatches, mla_absorb,
         policy="fsdp_tp") -> dict:
    """Builds the cell and runs its step on the meta device (over
    ``mesh``'s DTensors when given)."""
    t0 = time.perf_counter()
    cell = build_cell(cfg, shp, mesh, policy=policy, remat=remat,
                      num_microbatches=num_microbatches,
                      mla_absorb=mla_absorb)
    args = cell.distribute(cell.abstract_args)
    t_build = time.perf_counter() - t0
    t0 = time.perf_counter()
    live = LiveBytes(args)
    with live:
        stats, out = count_step(cell.fn, *args)
        out_b = sum({_storage(t)._cdata: _storage(t).nbytes()
                     for t in tensors(out)}.values())
        del out
    t_run = time.perf_counter() - t0
    cap = card_bytes()
    return dict(status="ok", build_s=round(t_build, 2),
                run_s=round(t_run, 2), arg_bytes=live.arg_bytes,
                out_bytes=out_b, peak_bytes=live.peak, card_bytes=cap,
                fits=bool(live.peak <= cap),
                card_frac=round(live.peak / cap, 3),
                flops_per_device=float(stats["flops"]),
                bytes_per_device=float(stats["bytes"]),
                collectives=stats["collectives"])


def _key(r: dict) -> str:
    return "|".join([r["arch"], r["shape"], r["mesh"],
                     r.get("remat", "full"),
                     str(r.get("num_microbatches", 1))])


def _report(i: int, n: int, rec: dict, secs: float):
    extra = ""
    if rec["status"] == "ok":
        extra = (f"peak={rec['peak_bytes'] / 2**30:.1f}GiB "
                 f"card={rec['card_frac']:.2f} fits={rec['fits']}")
    elif rec["status"] == "error":
        extra = rec["error"][:120]
    print(f"[{i + 1}/{n}] {rec['arch']} x {rec['shape']} "
          f"({rec['mesh']}): {rec['status']} "
          f"({secs:.1f}s) {extra}", flush=True)


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--remat", default="full")
    ap.add_argument("--mesh", default="card",
                    choices=("card", "single", "multi", "both"))
    ap.add_argument("--policy", default="fsdp_tp",
                    choices=("tp", "fsdp_tp", "fsdp"))
    # 8 microbatches, as the reference's default (ignored by serve cells)
    ap.add_argument("--num-microbatches", type=int, default=8)
    ap.add_argument("--out", default="results/dryrun.json")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)

    from repro_torch.configs.registry import ARCHS

    archs = list(ARCHS) if args.arch == "all" else args.arch.split(",")
    shapes = list(SHAPES) if args.shape == "all" else args.shape.split(",")
    meshes = {"card": ["card"], "both": ["single", "multi"]}.get(
        args.mesh, [args.mesh])
    todo = [{"arch": a, "shape": s, "mesh": m, "remat": args.remat,
             "num_microbatches": args.num_microbatches}
            for m in meshes for a in archs for s in shapes]

    print(f"card: {card_bytes() / 2**30:.1f} GiB")
    results = sweep(args.out, _key, todo,
                    lambda p: run_cell(
                        p["arch"], p["shape"], remat=p["remat"],
                        num_microbatches=p["num_microbatches"],
                        mesh=None if p["mesh"] == "card" else p["mesh"],
                        policy=args.policy),
                    _report, force=args.force)

    bad = [r for r in results.values() if r["status"] == "error"]
    print(f"done: {len(results)} cells, {len(bad)} errors")
    if bad:
        for r in bad:
            print("  ERROR:", r["arch"], r["shape"], "-", r["error"])
        raise SystemExit(1)
    return list(results.values())


if __name__ == "__main__":
    main()
