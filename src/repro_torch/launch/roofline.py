"""Roofline analyzer: compute, memory and collective terms of one (arch x
shape) step on one H100 or over a mesh of them.  The port of ``repro.launch.roofline``, re-based
from the TPU v5e to the H100 SXM.

Methodology as the reference's: small **depth probes** of each
architecture (1 vs 2 layers per layer type, full widths) are costed, and

    cost(probe) = base + sum_unit  n_unit(probe) * per_unit

is solved for the per-layer-type and base costs; totals are rebuilt with
the real layer counts.  The reference lowers each probe with its layer
scans unrolled and reads XLA's cost analysis; here each probe's step runs
on the meta device under ``op_stats.count_step`` (nothing is computed or
allocated).  A Python loop has no scan to unroll, but the probe-and-solve
stays, so per-layer costs come out as in the reference.

Terms per card (H100 SXM, NVIDIA's data sheet, dense rates, at its 700 W
limit):

* compute = the FLOPs the step must do / the config dtype's peak (989e12
  bf16; 67e12 f32 outside the tensor cores).  That is the matrix-product
  FLOPs of the probes run without recomputation (``remat="none"``), less
  the attention products over the query-key pairs the mask removes
  (``masked_attention_flops``: the plain step computes the whole S x S and
  masks it; a causal kernel computes about half).  The probes' own count,
  recomputation and masked pairs included, is ``op_compute_s``, as the
  reference's HLO count is.
* memory = the analytic HBM traffic / 3.35e12 B/s (HBM3);
* collective = sum(op_bytes * factor) / link rate (ring all-reduce factor
  2), which is 0 on one card.  The link is NVLink 4's 450e9 B/s a
  direction while the mesh fits one node of 8 cards (an HGX H100 board);
  across nodes every ring crosses the inter-node network, priced at
  ``INTER_NODE_BW`` (an assumption, below).

Over a mesh (``mesh`` "single" or "multi", the reference's 16 x 16 and
2 x 16 x 16, or a (shape, names) pair) each probe runs on rank 0 of a fake
process group (``launch.mesh.fake_process_group``) with the ``policy``'s
layouts: its FLOPs, bytes and collectives are per device, ``n_chips`` is
the mesh's size, and the memory model takes the mesh's ``dp`` and ``tp``.

    PYTHONPATH=src python -m repro_torch.launch.roofline \\
        --arch yi-9b --shape train_4k --out results/roofline.json
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import time

from repro_torch.configs import SHAPES, applicable, get_arch
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.launch.mesh import (MeshShape, fake_process_group,
                                     make_mesh, mesh_dims, mesh_name,
                                     mesh_size)
from repro_torch.launch.op_stats import collective_seconds, count_step
from repro_torch.launch.steps import build_cell, sweep
from repro_torch.models.model_zoo import analytic_param_count, input_specs
from repro_torch.tree import tree_leaves

PEAK_FLOP_S = {"bfloat16": 989e12, "float32": 67e12}  # dense bf16 / f32
HBM_BW = 3.35e12          # bytes/s, HBM3
NVLINK_BW = 450e9         # bytes/s a direction, NVLink 4
NODE_CARDS = 8            # H100s joined all to all by NVLink in one node
# An assumption, not a measurement: one 400 Gb/s InfiniBand NDR adapter per
# card (the DGX H100's layout), 50e9 bytes/s a direction.  A mesh past one
# node prices every collective at this rate: the 16-wide model axis of the
# production meshes spans two nodes, so its rings cross the network.
INTER_NODE_BW = 50e9


def link_bw(n_chips: int) -> float:
    """The bytes/s a direction that a collective over ``n_chips`` cards
    moves at: NVLink within a node, the inter-node network beyond."""
    return NVLINK_BW if n_chips <= NODE_CARDS else INTER_NODE_BW


# ---------------------------------------------------------------------------
# Depth probes per family
# ---------------------------------------------------------------------------

def _with_layers(cfg: ModelConfig, n: int, **extra) -> ModelConfig:
    return dataclasses.replace(cfg, num_layers=n, **extra)


def depth_plan(cfg: ModelConfig):
    """Returns (probes: {name: cfg}, units: {unit: full_count},
    solve: {unit: (probe_hi, probe_lo)}, base_expr: (probe, {unit: n})).

    per_unit = cost[probe_hi] - cost[probe_lo];
    base     = cost[base_probe] - sum n_unit * per_unit.
    """
    if cfg.family in ("dense", "vlm", "ssm"):
        probes = {"L1": _with_layers(cfg, 1), "L2": _with_layers(cfg, 2)}
        return (probes, {"layer": cfg.num_layers},
                {"layer": ("L2", "L1")}, ("L1", {"layer": 1}))
    if cfg.family == "moe":
        moe1 = dataclasses.replace(cfg.moe, n_dense_layers=1)
        moe2 = dataclasses.replace(cfg.moe, n_dense_layers=2)
        probes = {
            "A": _with_layers(cfg, 2, moe=moe1),   # 1 dense + 1 moe
            "B": _with_layers(cfg, 3, moe=moe1),   # 1 dense + 2 moe
            "C": _with_layers(cfg, 3, moe=moe2),   # 2 dense + 1 moe
        }
        nd = cfg.moe.n_dense_layers
        return (probes,
                {"moe_layer": cfg.num_layers - nd, "dense_layer": nd},
                {"moe_layer": ("B", "A"), "dense_layer": ("C", "A")},
                ("A", {"moe_layer": 1, "dense_layer": 1}))
    if cfg.family == "hybrid":
        rec_r = dataclasses.replace(cfg.rec, block_pattern=("r",))
        rec_a = dataclasses.replace(cfg.rec, block_pattern=("a",))
        probes = {
            "R1": _with_layers(cfg, 1, rec=rec_r),
            "R2": _with_layers(cfg, 2, rec=rec_r),
            "A1": _with_layers(cfg, 1, rec=rec_a),
        }
        pat = cfg.rec.block_pattern
        full = [pat[i % len(pat)] for i in range(cfg.num_layers)]
        n_rec = sum(1 for c in full if c == "r")
        n_attn = cfg.num_layers - n_rec
        return (probes, {"rec_layer": n_rec, "attn_layer": n_attn},
                {"rec_layer": ("R2", "R1"), "attn_layer": ("A1", "__base__")},
                ("R1", {"rec_layer": 1}))
    if cfg.family == "encdec":
        probes = {
            "A": _with_layers(cfg, 1, encoder_layers=1),
            "B": _with_layers(cfg, 1, encoder_layers=2),
            "C": _with_layers(cfg, 2, encoder_layers=1),
        }
        return (probes,
                {"enc_layer": cfg.encoder_layers, "dec_layer": cfg.num_layers},
                {"enc_layer": ("B", "A"), "dec_layer": ("C", "A")},
                ("A", {"enc_layer": 1, "dec_layer": 1}))
    raise ValueError(cfg.family)


def _probe_cost(cfg_small: ModelConfig, shape: ShapeConfig, *,
                remat: str, mla_absorb: bool, prefill_impl: str,
                decode_impl: str, mesh=None, policy: str = "fsdp_tp") -> dict:
    """One probe's step run on the meta device (over ``mesh``'s DTensors
    when given): its matrix-product FLOPs, the bytes its ops read and
    write, and its collectives' bytes, per device."""
    cell = build_cell(cfg_small, shape, mesh, policy=policy, remat=remat,
                      mla_absorb=mla_absorb, prefill_impl=prefill_impl,
                      decode_impl=decode_impl, num_microbatches=1)
    st, _ = count_step(cell.fn, *cell.distribute(cell.abstract_args))
    return {"flops": float(st["flops"]), "bytes": float(st["bytes"]),
            "coll_bytes": {k: float(v)
                           for k, v in st["collectives"]["bytes"].items()}}


def _combine(a: dict, b: dict, sign: float = 1.0) -> dict:
    ca, cb = a["coll_bytes"], b["coll_bytes"]
    return {"flops": a["flops"] + sign * b["flops"],
            "bytes": a["bytes"] + sign * b["bytes"],
            "coll_bytes": {k: ca.get(k, 0.0) + sign * cb.get(k, 0.0)
                           for k in set(ca) | set(cb)}}


def _scale(a: dict, s: float) -> dict:
    return {"flops": a["flops"] * s, "bytes": a["bytes"] * s,
            "coll_bytes": {k: v * s for k, v in a["coll_bytes"].items()}}


def _clamp(a: dict) -> dict:
    return {"flops": max(a["flops"], 0.0), "bytes": max(a["bytes"], 0.0),
            "coll_bytes": {k: max(v, 0.0)
                           for k, v in a["coll_bytes"].items()}}


def solve_depth(cfg: ModelConfig, costs: dict) -> tuple:
    """(per_unit, base, total) from the probes' costs, as the reference
    solves them."""
    _, units, solve, (base_probe, base_units) = depth_plan(cfg)
    per_unit: dict = {}
    deferred = []
    for unit, (hi, lo) in solve.items():
        if lo == "__base__":
            deferred.append((unit, hi))
            continue
        per_unit[unit] = _clamp(_combine(costs[hi], costs[lo], -1.0))
    base = costs[base_probe]
    for unit, n in base_units.items():
        if unit in per_unit:
            base = _combine(base, _scale(per_unit[unit], n), -1.0)
    base = _clamp(base)
    for unit, hi in deferred:   # e.g. hybrid attn layer = A1 - base
        per_unit[unit] = _clamp(_combine(costs[hi], base, -1.0))
    total = dict(base)
    for unit, n in units.items():
        total = _combine(total, _scale(per_unit[unit], n))
    return per_unit, base, total


# ---------------------------------------------------------------------------
# Analytic HBM-traffic model (the memory roofline term)
# ---------------------------------------------------------------------------
# The op counter's bytes sum every op's operands with no fusion: an upper
# bound, reported as ``op_bytes_upper``.  The memory term uses the
# reference's transparent structural model instead.

def analytic_memory_bytes(cfg: ModelConfig, shape: ShapeConfig, mesh=None,
                          *, n_chips: int = 1, tp: int = 1,
                          policy: str = "fsdp_tp",
                          remat: str = "full") -> dict:
    """HBM bytes of one step per device, as the reference's model (naive
    training attention) over ``mesh`` (a ``DeviceMesh`` or a
    ``MeshShape``), or over ``n_chips`` devices with ``tp`` of them on the
    model axis (1 and 1: one card), under ``policy``."""
    if mesh is not None:
        shp = MeshShape.of(mesh)
        n_chips, tp = shp.size, shp.shape["model"]
    dp = n_chips // tp
    dt = 2  # bf16
    P_total = analytic_param_count(cfg) * dt
    shards = n_chips if policy == "fsdp_tp" else tp
    # active params actually touched per token (MoE reads only routed experts)
    P_active = analytic_param_count(cfg, active_only=True) * dt / shards

    B_loc = max(shape.global_batch // dp, 1)
    S = shape.seq_len
    D = cfg.d_model
    act_unit = B_loc * S * D * dt             # one activation tensor / chip
    L = cfg.num_layers + cfg.encoder_layers

    detail = {}
    if shape.kind == "train":
        mdt = 2 if P_total / dt > 100e9 else 4
        # fwd read + bwd read of weights; grad write+read; adam m/v r/w;
        # param write.
        detail["weights"] = P_active * 3 + (P_total / shards) * (
            2 * 2 + 2 * (mdt / dt) * 2 / 2)   # grads(acc dtype~f32) + moments
        # ~8 fusion-boundary activation tensors per layer; remat rereads
        # them (x1.5)
        act_factor = 8 * (1.5 if remat != "none" else 1.0)
        detail["activations"] = act_factor * act_unit * L
        if cfg.family not in ("ssm",):
            Hl = max(cfg.num_heads // tp, 1)
            n_attn = _attn_layer_count(cfg)
            detail["attn_scores"] = 4 * B_loc * Hl * S * S * dt * n_attn
        Vl = cfg.vocab_size / tp
        detail["logits"] = 3 * B_loc * S * Vl * 4
    elif shape.kind == "prefill":
        detail["weights"] = P_active
        detail["activations"] = 4 * act_unit * L
        detail["cache_write"] = _cache_bytes(cfg, shape, n_chips)
    else:  # decode
        detail["weights"] = P_active
        detail["cache_read"] = _cache_bytes(cfg, shape, n_chips)
        detail["activations"] = 4 * B_loc * 1 * D * dt * L
    detail["total"] = sum(detail.values())
    return detail


def _attn_layer_count(cfg: ModelConfig) -> int:
    if cfg.family == "hybrid":
        pat = cfg.rec.block_pattern
        full = [pat[i % len(pat)] for i in range(cfg.num_layers)]
        return sum(1 for c in full if c == "a")
    if cfg.family == "ssm":
        return 0
    return cfg.num_layers + 2 * cfg.encoder_layers  # encdec: self+cross approx


def _cache_bytes(cfg: ModelConfig, shape: ShapeConfig, n_chips: int) -> float:
    """Decode-cache bytes / devices (caches shard across the mesh)."""
    specs = input_specs(cfg, dataclasses.replace(shape, kind="decode",
                                                 name="tmp"))
    total = sum(t.numel() * t.element_size()
                for t in tree_leaves(specs["caches"]))
    return total / n_chips


# ---------------------------------------------------------------------------
# MODEL_FLOPS (the 6ND / 2ND usefulness yardstick)
# ---------------------------------------------------------------------------

def model_flops_total(cfg: ModelConfig, shape: ShapeConfig) -> float:
    n_active = analytic_param_count(cfg, active_only=True)
    if not cfg.tie_embeddings:
        n_active -= cfg.vocab_size * cfg.d_model   # input embedding lookup
    mult = 6.0 if shape.kind == "train" else 2.0
    return mult * n_active * shape.tokens


def _kept_pairs(S: int, window: int) -> int:
    """Query-key pairs a causal mask over ``S`` positions keeps (within
    ``window`` of the query, if any)."""
    if window and window < S:
        return window * (window + 1) // 2 + (S - window) * window
    return S * (S + 1) // 2


def masked_attention_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """FLOPs of attention's score and value products over the query-key
    pairs that the causal or sliding-window mask removes: the plain
    training and prefill steps compute the whole S x S and mask it.  Each
    pair of a head costs 2 (qk_dim + v_dim) forward; training runs each
    product once forward and twice backward.  The encoder's and the
    cross attention's pairs are all kept, and a decode step's query
    attends to every slot of its full caches."""
    if shape.kind == "decode" or cfg.family == "ssm":
        return 0.0
    S, B, w = shape.seq_len, shape.global_batch, cfg.sliding_window
    dqk = dv = cfg.head_dim_
    if cfg.mla.enabled:
        dqk = cfg.mla.qk_nope_head_dim + cfg.mla.qk_rope_head_dim
        dv = cfg.mla.v_head_dim
    n_attn = cfg.num_layers
    if cfg.family == "hybrid":
        n_attn = _attn_layer_count(cfg)
    elif cfg.family == "encdec":        # the decoder's self attention
        S = int(S * cfg.tgt_ratio)
    removed = S * S - _kept_pairs(S, w)
    fwd = n_attn * B * cfg.num_heads * removed * 2 * (dqk + dv)
    return float(3 * fwd if shape.kind == "train" else fwd)


# ---------------------------------------------------------------------------
# Cell analysis
# ---------------------------------------------------------------------------

def _resolve(arch, shape) -> tuple:
    cfg = get_arch(arch) if isinstance(arch, str) else arch
    shp = SHAPES[shape] if isinstance(shape, str) else shape
    return cfg, shp


def _solved_totals(cfg, shp, **kw) -> dict:
    probes = depth_plan(cfg)[0]
    costs = {name: _probe_cost(c, shp, **kw) for name, c in probes.items()}
    return solve_depth(cfg, costs)


def analyze_cell(arch, shape, *, remat: str = "full",
                 mla_absorb: bool = True, prefill_impl: str = "blockwise",
                 decode_impl: str = "naive", mesh=None,
                 policy: str = "fsdp_tp") -> dict:
    """The roofline record of one cell on one H100, or per device over
    ``mesh`` ("single", "multi" or a (shape, names) pair, on a fake
    process group) under ``policy``.  ``arch`` is a name (``get_arch``) or
    a ``ModelConfig``; ``shape`` a name in ``SHAPES`` or a
    ``ShapeConfig``."""
    cfg, shp = _resolve(arch, shape)
    ok, why = applicable(cfg, shp)
    rec = {"arch": cfg.name, "shape": shp.name, "kind": shp.kind,
           "seq_len": shp.seq_len, "global_batch": shp.global_batch,
           "mesh": mesh_name(mesh), "remat": remat, "mla_absorb": mla_absorb,
           "prefill_impl": prefill_impl, "decode_impl": decode_impl}
    if mesh is not None:
        dims = mesh_dims(mesh)
        rec.update(backend="fake", policy=policy,
                   mesh_shape=dict(zip(dims[1], dims[0])))
    if not ok:
        rec.update(status="skipped", reason=why)
        return rec
    if mesh is None:
        rec.update(_analyze(cfg, shp, None, remat=remat,
                            mla_absorb=mla_absorb, prefill_impl=prefill_impl,
                            decode_impl=decode_impl))
        return rec
    with fake_process_group(math.prod(dims[0])):
        dm = make_mesh(*dims, device="meta")
        rec.update(_analyze(cfg, shp, dm, remat=remat, mla_absorb=mla_absorb,
                            prefill_impl=prefill_impl,
                            decode_impl=decode_impl, policy=policy))
    return rec


def _analyze(cfg, shp, mesh, *, remat, mla_absorb, prefill_impl,
             decode_impl, policy="fsdp_tp") -> dict:
    rec: dict = {}
    n_chips = mesh_size(mesh)

    kw = dict(mla_absorb=mla_absorb, prefill_impl=prefill_impl,
              decode_impl=decode_impl, mesh=mesh, policy=policy)
    t0 = time.perf_counter()
    per_unit, base, total = _solved_totals(cfg, shp, remat=remat, **kw)
    # the work the step must do: no recomputation, no masked pairs
    flops_none = total["flops"]
    if shp.kind == "train" and remat != "none":
        flops_none = _solved_totals(cfg, shp, remat="none", **kw)[2]["flops"]
    masked = masked_attention_flops(cfg, shp)

    if mesh is None:
        mem_detail = analytic_memory_bytes(cfg, shp, remat=remat)
    else:
        mem_detail = analytic_memory_bytes(cfg, shp, mesh, policy=policy,
                                           remat=remat)
    peak = PEAK_FLOP_S[cfg.dtype]
    # the masked pairs are the whole step's; on a mesh each device skips
    # its share of them
    required = flops_none - masked / n_chips
    compute_s = required / peak
    memory_s = mem_detail["total"] / HBM_BW
    link = link_bw(n_chips)
    collective_s = collective_seconds({"bytes": total["coll_bytes"]}, link)
    terms = {"compute_s": compute_s, "memory_s": memory_s,
             "collective_s": collective_s}
    bottleneck = max(terms, key=terms.get)
    step_s = max(terms.values())
    mf_dev = model_flops_total(cfg, shp) / n_chips
    roofline_frac = ((mf_dev / peak) / step_s) if step_s > 0 else 0.0

    rec.update(
        status="ok",
        analysis_s=round(time.perf_counter() - t0, 1),
        n_chips=n_chips,
        peak_flop_s=peak,
        hbm_bw=HBM_BW,
        link_bw=link,
        per_unit=per_unit,
        base=base,
        totals=total,
        required_flops=required,
        masked_attention_flops=masked,
        compute_s=compute_s,
        op_compute_s=total["flops"] / peak,
        memory_s=memory_s,
        memory_detail=mem_detail,
        op_bytes_upper=total["bytes"],
        collective_s=collective_s,
        bottleneck=bottleneck,
        step_seconds_lower_bound=step_s,
        model_flops_per_device=mf_dev,
        op_flops_per_device=total["flops"],
        useful_flops_ratio=(mf_dev / total["flops"]) if total["flops"] else 0,
        roofline_fraction=roofline_frac,
        tokens_per_second_per_chip=(shp.tokens / n_chips / step_s)
        if step_s else 0.0,
    )
    return rec


def _key(r: dict) -> str:
    return "|".join([r["arch"], r["shape"], r["mesh"], r["remat"],
                     str(r["mla_absorb"]), r["prefill_impl"],
                     r["decode_impl"], r.get("policy", "")])


def _analyze_or_record(probe: dict) -> dict:
    try:
        return analyze_cell(probe["arch"], probe["shape"],
                            remat=probe["remat"],
                            mla_absorb=probe["mla_absorb"],
                            prefill_impl=probe["prefill_impl"],
                            decode_impl=probe["decode_impl"],
                            mesh=(None if probe["mesh"] == "card"
                                  else probe["mesh"]),
                            policy=probe["policy"] or "fsdp_tp")
    except Exception as e:  # noqa: BLE001  (recorded, the sweep goes on)
        import traceback

        return dict(probe, status="error", error=f"{type(e).__name__}: {e}",
                    trace=traceback.format_exc(limit=8))


def _report(i: int, n: int, rec: dict, secs: float):
    if rec["status"] == "ok":
        print(f"[{i+1}/{n}] {rec['arch']} x {rec['shape']}: "
              f"bottleneck={rec['bottleneck']} "
              f"step>={rec['step_seconds_lower_bound']:.4f}s "
              f"roofline={rec['roofline_fraction']:.3f} "
              f"useful={rec['useful_flops_ratio']:.2f}", flush=True)
    else:
        print(f"[{i+1}/{n}] {rec['arch']} x {rec['shape']}: {rec['status']} "
              f"{rec.get('error', rec.get('reason', ''))[:110]}", flush=True)


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--remat", default="full")
    ap.add_argument("--prefill-impl", default="blockwise")
    ap.add_argument("--decode-impl", default="naive")
    ap.add_argument("--no-mla-absorb", action="store_true")
    ap.add_argument("--mesh", default="card",
                    choices=("card", "single", "multi", "both"))
    ap.add_argument("--policy", default="fsdp_tp",
                    choices=("tp", "fsdp_tp", "fsdp"))
    ap.add_argument("--out", default="results/roofline.json")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)

    from repro_torch.configs.registry import ARCHS

    archs = list(ARCHS) if args.arch == "all" else args.arch.split(",")
    shapes = list(SHAPES) if args.shape == "all" else args.shape.split(",")
    meshes = {"card": ["card"], "both": ["single", "multi"]}.get(
        args.mesh, [args.mesh])
    todo = [{"arch": a, "shape": s, "mesh": m, "remat": args.remat,
             "mla_absorb": not args.no_mla_absorb,
             "prefill_impl": args.prefill_impl,
             "decode_impl": args.decode_impl,
             "policy": args.policy if m != "card" else ""}
            for m in meshes for a in archs for s in shapes]
    results = sweep(args.out, _key, todo, _analyze_or_record, _report,
                    force=args.force)
    return list(results.values())


if __name__ == "__main__":
    main()
