"""Elastic serving end to end on the PyTorch port (paper §3.5 workload
scaling; ``examples/elastic_serving.py`` of the JAX package).

A live serving *service* is driven by a bursty open-loop trace on the
per-request path: arrivals land on the service's ``RequestRouter``; every
replica is an ``EngineServeTask``, a continuous-batching engine that pulls
admissible requests into its decode slots and dispatches each iteration as
an EXECUTE request through its monitor, so every TTFT/TBT/latency sample is
measured where the request ends.  The orchestrator's autoscaler reconcile
thread reads the service signals from the cluster's telemetry registry and
scales the service out (checkpoint-clone replicate onto a node with a free
vSlice) and back in (kill + delete, in-flight sequences requeued) through
node agents -> CRI.

    python examples_torch/elastic_serving.py               # on the CUDA card
    python examples_torch/elastic_serving.py --device cpu
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import threading
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.core import (FunkyCL, FunkyRuntime, Monitor,  # noqa: E402
                              SliceAllocator, TaskImage, TaskStatus,
                              make_cluster)
from repro_torch.scaling import (Autoscaler, LatencySLOPolicy,  # noqa: E402
                                 MetricsRegistry, OrchestratorScaler,
                                 burst_rate, drive_engine_open_loop,
                                 open_loop, reset_router, teardown_service,
                                 wait_for_service)
from repro_torch.serve.engine import (ContinuousBatchingEngine,  # noqa: E402
                                      ServeRequest)
from repro_torch.serve.equivalence import run_transcript  # noqa: E402

SLOTS = 2
TOKENS_RANGE = (3, 9)
IMAGE = TaskImage(name="svc", kind="engine-serve", arch="yi-9b-smoke",
                  prompt_len=8, global_batch=SLOTS, total_steps=10 ** 9,
                  max_new_tokens=TOKENS_RANGE[1])

SLO_S = 1.0
# a 2-slot smoke replica of the JAX package ends roughly 300 req/s of
# (3,9)-token requests; the 6x burst pushes the offered rate near that so
# the latency-SLO policy has something to do.  ``replica_rate`` measures
# one replica of another model or device, to scale this knob by.
REQUEST_RATE = 75.0      # base req/s knob (burst = 3.6x this)
REFERENCE_REPLICA_RATE = 300.0
DURATION_S = 9.0


def _image(image, arch):
    return image if arch is None else dataclasses.replace(image, arch=arch)


def requests(request_rate: float = REQUEST_RATE,
             duration_s: float = DURATION_S, seed: int = 7) -> list:
    """The bursty open-loop trace: the middle third runs at 6x the base
    rate of 0.6 ``request_rate``."""
    return open_loop(
        burst_rate(0.6 * request_rate, 6.0, duration_s / 3, duration_s / 3),
        duration_s, seed=seed, mean_service_s=1.0 / request_rate,
        tokens_range=TOKENS_RANGE)


def _engine_kw(image: TaskImage) -> dict:
    """The engine an ``EngineServeTask`` builds from ``image``."""
    return dict(slots=image.global_batch, prompt_len=image.prompt_len,
                max_new_tokens=image.max_new_tokens, seed=image.seed,
                paged=image.paged_kv, page_size=image.page_size,
                pool_pages=image.kv_pool_pages,
                reserve_pages=image.kv_reserve_pages,
                prompt_buckets=image.prompt_buckets or None,
                fuse_steps=image.fuse_steps, async_depth=image.async_depth)


def engine_alone(prompts: dict, n_tokens: dict, image: TaskImage = IMAGE,
                 arch: str = None, mem_cap_bytes: int = 8 << 30,
                 device=None) -> dict:
    """{rid: tokens} of the requests ``prompts`` (rid -> prompt) with
    ``n_tokens`` (rid -> new tokens) served on one engine of ``image``
    alone, on a monitor of its own."""
    image = _image(image, arch)

    def factory():
        mon = Monitor("alone", SliceAllocator("alone", 1,
                                              mem_cap_bytes=mem_cap_bytes,
                                              device=device),
                      telemetry=MetricsRegistry())
        eng = ContinuousBatchingEngine(image.arch, FunkyCL(mon),
                                       engine_id="alone", **_engine_kw(image))
        eng.setup()
        return mon, eng

    tokens, eng = run_transcript(factory, lambda: [
        ServeRequest(rid=rid, prompt=prompts[rid],
                     max_new_tokens=n_tokens[rid]) for rid in prompts])
    del eng
    return tokens


def replica_rate(image: TaskImage = IMAGE, arch: str = None,
                 seconds: float = 3.0, mem_cap_bytes: int = 8 << 30,
                 device=None, seed: int = 0) -> dict:
    """Requests/s that one replica of ``image`` ends in a closed loop of
    ``seconds`` (one request outstanding a slot, token counts uniform over
    ``TOKENS_RANGE``, prompts as the drive draws them), after one warm-up
    round of a request a slot."""
    image = dataclasses.replace(_image(image, arch), name="rate")
    reg = MetricsRegistry()
    router = reset_router(image.name)
    router.registry = reg
    rt = FunkyRuntime("rate", SliceAllocator("rate", 1,
                                             mem_cap_bytes=mem_cap_bytes,
                                             device=device), telemetry=reg)
    rng = np.random.Generator(np.random.Philox(seed))
    sent = 0

    def top_up():
        nonlocal sent
        while router.outstanding() < image.global_batch:
            router.submit(ServeRequest(
                rid=f"rate-{sent}",
                prompt=rng.integers(0, 512, image.prompt_len),
                max_new_tokens=int(rng.integers(*TOKENS_RANGE))))
            sent += 1

    rt.create("rate", image)
    rec = rt.tasks["rate"]
    rt.start("rate")
    try:
        top_up()
        while len(router.completed) < image.global_batch:
            if rec.status is not TaskStatus.RUNNING and \
                    rec.status is not TaskStatus.CREATED:
                raise RuntimeError(f"replica_rate: the replica ended "
                                   f"{rec.status}: {rec.error!r}")
            time.sleep(0.0005)
        n0, t0 = len(router.completed), time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            top_up()
            time.sleep(0.0005)
        n1, wall = len(router.completed), time.perf_counter() - t0
    finally:
        router.close()
        rt.wait("rate", timeout=600)
        rt.delete("rate")
    return {"requests_per_s": (n1 - n0) / wall, "requests": n1 - n0,
            "seconds": wall}


class _Replicas:
    """Every engine-serve task record any node holds, kept once seen (a
    scale-in deletes the record whose engine's counts the run reports)."""

    def __init__(self, cluster):
        self._cluster = cluster
        self._seen = {}
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._scan, daemon=True,
                                        name="elastic-replicas")
        self._thread.start()

    def _scan(self):
        while True:
            for n in self._cluster.nodes.values():
                for rec in list(n.runtime.tasks.values()):
                    if rec.image.kind == "engine-serve":
                        self._seen.setdefault(id(rec), rec)
            if self._stop.wait(0.01):
                return

    def stop(self) -> dict:
        """Ends the scan; each replica's decode steps and admissions."""
        self._stop.set()
        self._thread.join()
        out = {}
        for i, rec in enumerate(self._seen.values()):
            eng = rec.task.engine
            if eng is None:
                continue
            pe = dict(eng.program_execs)
            out[f"{rec.cid}#{i}"] = {
                "decode_steps": pe.get("decode_step", 0)
                + eng.fuse_steps * pe.get("decode_multi", 0),
                "admissions": sum(n for p, n in pe.items()
                                  if p.startswith("prefill_admit")),
                "completed": len(eng.completed)}
        self._seen.clear()
        return out


def _quantiles(xs):
    if not xs:
        return {"p50": None, "p99": None}
    return {"p50": float(np.percentile(xs, 50)),
            "p99": float(np.percentile(xs, 99))}


def main(image: TaskImage = IMAGE, arch: str = None,
         request_rate: float = REQUEST_RATE, duration_s: float = DURATION_S,
         mem_cap_bytes: int = 8 << 30, device=None, ckpt_root: str = None,
         seed: int = 7) -> dict:
    """The service on 4 nodes of one vSlice each, 1-4 replicas under
    ``LatencySLOPolicy(slo_p95_s=0.6, growth=2.0)``, driven by
    ``requests(request_rate, duration_s, seed)``.  Returns what it prints,
    each request's tokens and prompt, and each replica's decode steps and
    admissions."""
    image = _image(image, arch)
    svc = image.name
    cluster = make_cluster(num_nodes=4, slices_per_node=1,
                           images={svc: image}, mem_cap_bytes=mem_cap_bytes,
                           ckpt_root=ckpt_root, device=device)
    orch = cluster.orchestrator
    router = reset_router(svc)
    router.registry = orch.metrics
    replicas = _Replicas(cluster)
    scaler, torn_down = None, False
    try:
        cid = orch.submit(svc, priority=5)
        orch.start(tick_interval=0.02)
        print("waiting for the service task to boot (weights on the "
              "device)...")
        node = wait_for_service(cluster, orch, cid, timeout_s=600)
        print(f"  {cid} serving on {node} "
              f"({image.global_batch} decode slots, continuous batching)")

        scaler = OrchestratorScaler(orch, cid, service=svc)
        autoscaler = Autoscaler(LatencySLOPolicy(slo_p95_s=0.6, growth=2.0),
                                min_replicas=1, max_replicas=4,
                                scale_down_cooldown_s=2.0)
        orch.attach_autoscaler(autoscaler, scaler, service=svc,
                               interval_s=0.2)
        print("autoscaler attached: latency-SLO policy, 1..4 replicas")

        reqs = requests(request_rate, duration_s, seed)
        print(f"replaying {len(reqs)} requests over {duration_s:.0f}s "
              f"(burst in the middle third)...")
        timeline = []

        def report(now, n_rep, queue_len, p95):
            timeline.append({"t": now, "replicas": n_rep,
                             "queue": queue_len, "p95_s": p95})
            print(f"  t={now:4.1f}s replicas={n_rep} queue={queue_len:4d} "
                  f"p95={p95 if p95 == p95 else 0:.2f}s", flush=True)

        t_drive = time.time()
        res = drive_engine_open_loop(
            orch, scaler, reqs, duration_s=duration_s, slo_s=SLO_S,
            service=svc, prompt_len=image.prompt_len,
            slots_per_replica=image.global_batch, drain_timeout_s=20.0,
            on_tick=report)

        print("burst over; stopping the reconcile loop and draining to 1...")
        teardown_service(orch, scaler)
        torn_down = True
        replicas_ts = [(t - t_drive, v) for t, v in orch.metrics.series(
            "replicas_ts", service=svc).points()]
        print(f"served {res.served} requests on the device, "
              f"SLO attainment {res.attainment:.3f}")
        scaling = [e[1] for e in orch.events
                   if e[1] in ("replicate", "scale_in", "autoscale")]
        print("scaling events:", scaling)
        snap = cluster.metrics.snapshot()
        counters = {k: int(v) for k, v in snap["counters"].items()
                    if f"{{service={svc}}}" in k}
        print("telemetry counters:", counters)
        for name in ("request_ttft_seconds", "request_tbt_seconds",
                     "request_latency_seconds"):
            h = snap["histograms"].get(f"{name}{{service={svc}}}")
            if h and h["window_count"]:
                print(f"  {name}: n={h['count']} p50={h['p50'] * 1e3:.1f}ms "
                      f"p99={h['p99'] * 1e3:.1f}ms")
            elif h:
                print(f"  {name}: n={h['count']} (window drained)")
        for d in autoscaler.decisions[-5:]:
            print(f"  decision {d.current}->{d.desired} ({d.reason})")
        print("flight recorder tail:",
              [e[1] for e in cluster.metrics.flight_record()["events"][-8:]])

        completed = list(router.completed.values())
        out = {
            "arch": image.arch, "request_rate": request_rate,
            "duration_s": duration_s, "requests": len(reqs),
            "served": res.served, "completed": len(completed),
            "duplicates": router.duplicates,
            "attainment": res.attainment, "max_replicas": res.max_replicas,
            "scaling_events": scaling, "replicas_ts": replicas_ts,
            # what the teardown's scale_to(1) left: the base alone
            "replicas_after_drain": (replicas_ts[-1][1] if replicas_ts
                                     else 1),
            "clones_left": list(scaler.replica_cids),
            "timeline": timeline,
            "decisions": [(d.current, d.desired, d.reason)
                          for d in autoscaler.decisions if d.applied],
            "ttft_s": _quantiles([c.ttft_s for c in completed]),
            "tbt_s": _quantiles([t for c in completed for t in c.tbts]),
            "latency_s": _quantiles([c.e2e_s for c in completed]),
            "tokens": {c.rid: list(c.tokens) for c in completed},
            "n_tokens": {r.rid: r.n_tokens for r in reqs},
            "prompts": dict(res.prompts)}
    finally:
        if scaler is not None and not torn_down:
            teardown_service(orch, scaler)
        orch.stop()
        cluster.stop()
        out_replicas = replicas.stop()
    out["replicas"] = out_replicas
    out["decode_steps"] = sum(r["decode_steps"] for r in out_replicas.values())
    out["admissions"] = sum(r["admissions"] for r in out_replicas.values())
    bad = []
    if out["served"] != out["requests"] or out["completed"] != \
            out["requests"] or out["duplicates"]:
        bad.append(f"served {out['served']} ({out['completed']} completed, "
                   f"{out['duplicates']} duplicates) of {out['requests']}")
    if out["replicas_after_drain"] != 1 or out["clones_left"]:
        bad.append(f"drained to {out['replicas_after_drain']} replicas, "
                   f"clones left {out['clones_left']}")
    if any(len(t) != out["n_tokens"][rid]
           for rid, t in out["tokens"].items()):
        bad.append("a request ended with another token count")
    if bad:
        raise RuntimeError("elastic_serving: " + "; ".join(bad))
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=IMAGE.arch)
    ap.add_argument("--request-rate", type=float, default=REQUEST_RATE)
    ap.add_argument("--duration", type=float, default=DURATION_S)
    ap.add_argument("--mem-cap-gib", type=float, default=8.0)
    ap.add_argument("--device", default=None,
                    help="cpu, or a CUDA device (default: the card)")
    a = ap.parse_args()
    main(arch=a.arch, request_rate=a.request_rate, duration_s=a.duration,
         mem_cap_bytes=int(a.mem_cap_gib * (1 << 30)), device=a.device)
