#!/usr/bin/env python3
"""Where K3's bf16 route (``ssd_scan_mma_kernel``) spends its time, on one
CUDA card.

    python3 tools/k3_breakdown.py          # needs nvcc and one card

Builds copies of ``src/repro_torch/kernels/csrc/ssd_scan.cu`` with one of
the route's products taken out (C·Bᵀ; M·X, and with it the exp and split
that only feed it; y_off; the state update) and one with all four taken
out (what is left: loads, barriers, the chunk scan, the stores), and
that last copy again without the B and C tile loads.  It
checks the whole kernel against the plain version at mamba2-1.3b's
prefill shape, then times every copy there, in turns (forward, then
backward), as device time from a ``torch.profiler`` trace.  A section
costs about the whole kernel's time less its copy's; the copies compute
wrong values on purpose and only their time is read.  Prints one JSON
line per timing and a summary line with the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "k3_breakdown"
SHAPE = (8, 1024, 64, 64, 128, 256)      # B, S, H, P, N, chunk

# B and C tile loads (one B/C tile of 16 KB is shared by every head of a
# batch row; taking them out of the loads-only copy shows their share)
BC_LOADS = [
    ("load_tile(Cs, LDH, Cm + (crow + Ib * BR) * N, N, len_ - Ib * BR, N);",
     ""),
    ("load_tile(Bs + stage * BR * LDH, LDH, Bm + (crow + Jb * BR) * N, N,\n"
     "                len_ - Jb * BR, N);", ""),
]
# section -> (text in ssd_scan.cu, its replacement)
CUTS = {
    "C.B^T": ("mma_16816(s[q], cf[kk], bb);\n"
              "            mma_16816(s[q + 1], cf[kk], bb + 2);", ""),
    "M.X": ("mma_16816(acc[2 * q], part ? ml : mh, xb[q]);\n"
            "                mma_16816(acc[2 * q + 1], part ? ml : mh, "
            "xb[q] + 2);", ""),
    "y_off": ("if (live && c0 > 0) {", "if (false) {"),
    "state": ("if (I == nI - 1 && owns_p) {", "if (false) {"),
}


def _cut(src: str, cuts) -> str:
    for old, new in cuts:
        if src.count(old) != 1:
            raise RuntimeError(f"no longer in ssd_scan.cu: {old[:60]!r}; "
                               f"update the cuts")
        src = src.replace(old, new)
    return src


def sources() -> dict:
    src = (ROOT / "src/repro_torch/kernels/csrc/ssd_scan.cu").read_text()
    out = {"whole": src}
    for name, cut in CUTS.items():
        out[f"without {name}"] = _cut(src, [cut])
    out["loads and barriers only"] = _cut(src, CUTS.values())
    out["loads and barriers only, no B or C tile"] = _cut(
        out["loads and barriers only"], BC_LOADS)
    return out


def build_all(srcs: dict) -> dict:
    """One nvcc per copy, all started together; name -> ssd_scan_fwd."""
    from repro_torch.kernels import build
    from repro_torch.kernels.ssd_scan import ops

    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, text) in enumerate(srcs.items()):
        cu, so = OUT / f"v{i}.cu", OUT / f"v{i}.so"
        cu.write_text(text)
        procs[name] = (so, subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-I", str(build.CSRC),
             "-o", str(so), str(cu)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    fns = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        fn = ctypes.CDLL(str(so)).ssd_scan_fwd
        fn.argtypes = list(ops._ARGTYPES)
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def main() -> int:
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("k3_breakdown: no CUDA card", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke
    from repro_torch.kernels.build import DTYPE_CODES
    from repro_torch.kernels.common import raise_on_error, stream_of
    from repro_torch.kernels.ssd_scan.ops import ROUTES
    from repro_torch.kernels.ssd_scan.ref import ssd_chunked

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    fns = build_all(sources())
    B, S, H, P, N, cs = SHAPE
    g = torch.Generator(device="cuda").manual_seed(chip_smoke.SEED + 2)

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda")

    x = randn(B, S, H, P).bfloat16()
    dt = F.softplus(randn(B, S, H))
    A = -torch.exp(randn(H) * 0.2)
    Bm, Cm = ((randn(B, S, N) * 0.3).bfloat16() for _ in range(2))
    y = torch.empty_like(x)
    st = torch.empty((B, H, P, N), dtype=torch.float32, device="cuda")

    def call(fn):
        raise_on_error("ssd_scan", fn(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
            Cm.data_ptr(), y.data_ptr(), st.data_ptr(),
            DTYPE_CODES["bfloat16"], ROUTES["mma"], B, S, H, P, N, cs,
            stream_of(x)))

    call(fns["whole"])
    ry, rst = ssd_chunked(x, dt, A, Bm, Cm, chunk=cs)
    y_rel = ((y.float() - ry.float()).abs().max()
             / ry.float().abs().max()).item()
    st_err = (st - rst).abs().max().item()
    y_tol, st_tol = chip_smoke.K3_TOL["bfloat16"]
    if y_rel > y_tol or st_err > st_tol:
        raise AssertionError(f"whole kernel: y {y_rel}, state {st_err}")
    times: dict = {}
    for name in list(fns) + list(fns)[::-1]:
        ms = chip_smoke.device_ms(lambda: call(fns[name]), [()], reps=20)
        times.setdefault(name, []).append(ms)
        print(json.dumps({"copy": name, "device_ms": ms}), flush=True)
    med = {k: statistics.median(v) for k, v in times.items()}
    print(json.dumps({
        "card": card, "shape": list(SHAPE), "y_rel_err": y_rel,
        "state_abs_err": st_err, "device_ms": med,
        "section_ms": {k.removeprefix("without "): med["whole"] - v
                       for k, v in med.items() if k.startswith("without ")},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
