"""The Funky orchestrator (leader node): API server + scheduler + services;
the reference package's ``core/orchestrator.py`` on the port.

Services (paper §3.5, Table 3):
  * preemptive scheduling  — Algorithm 1 actions executed through node agents
  * checkpoint & restore   — periodic/manual snapshots; failure recovery
  * workload scaling       — horizontal (replicate/remove) and vertical
                             (update), driven by an SLO/utilization
                             autoscaler reconcile loop (``scaling``)

The orchestrator never talks to monitors directly: every operation flows
orchestrator -> node agent -> CRI -> container engine -> OCI runtime, as in
the paper's Figure 1.  All services publish telemetry into a
``scaling.metrics`` registry — the same schema the trace simulator emits
under its virtual clock.  With a tracer (``tracer=``) the control actions
are the spans of one long-lived ``cluster`` trace, so an exported run is a
loadable cluster timeline.
"""

from __future__ import annotations

import itertools
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from repro_torch.chaos import (DEFAULT_ACTION_RETRY, RetryPolicy,
                               TransientFault, retry_call)
from repro_torch.core.monitor import NoSliceAvailable
from repro_torch.core.node_agent import NodeAgent, NodeFailed
from repro_torch.core.placement import (M_NODE_UTILIZATION,
                                        MigrationController, PlacementPolicy)
from repro_torch.core.runtime import TaskStatus
from repro_torch.core.scheduler import (Action, FunkyScheduler, Policy,
                                        SchedTask, TaskState)
from repro_torch.scaling.autoscaler import (Autoscaler, ReplicaTarget,
                                            ScalingSignals,
                                            signals_from_registry)
from repro_torch.scaling.metrics import MetricsRegistry


@dataclass
class Deployment:
    cid: str
    image_ref: str
    priority: int = 0
    preemptible: bool = True
    submit_time: float = field(default_factory=time.time)
    start_time: Optional[float] = None
    end_time: Optional[float] = None
    status: str = "pending"
    group: Optional[str] = None         # service group (replica set) id


class Orchestrator:
    def __init__(self, agents: Dict[str, NodeAgent],
                 policy: Policy = Policy.PRE_MG,
                 checkpoint_interval: Optional[float] = None,
                 metrics: Optional[MetricsRegistry] = None,
                 placement: Optional[PlacementPolicy] = None,
                 straggler_interval: Optional[float] = None,
                 tracer=None, retry: Optional[RetryPolicy] = None):
        self.agents = agents
        # orchestration-plane tracing: one long-lived "cluster" trace whose
        # spans are the control actions (deploy/evict/resume/migrate,
        # scale-in drains, failure restores, straggler migrations)
        self.tracer = tracer
        self._cluster_trace = (tracer.start_trace("cluster",
                                                  trace_id="cluster")
                               if tracer is not None else None)
        # straggler migrations in flight: cid -> the pre-migration trace,
        # linked (relation "migrates") from the post-migration trace when
        # the task lands again
        self._pending_migrate_links: Dict[str, object] = {}
        # bounded retry-with-backoff for orchestrator actions (deploy /
        # evict / resume / migrate / restore): a transient agent fault
        # costs a backoff, exhaustion produces a structured failure event
        self.retry = retry if retry is not None else DEFAULT_ACTION_RETRY
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        # one placement engine for every decision (scheduling, scale-out,
        # failure recovery, straggler migration) — scored from this
        # orchestrator's enriched ClusterView + the shared registry
        self.placement = (placement if placement is not None
                          else PlacementPolicy(registry=self.metrics))
        self.scheduler = FunkyScheduler(policy, placement=self.placement)
        self.migration = MigrationController(self.metrics)
        self.deployments: Dict[str, Deployment] = {}
        self._sched_tasks: Dict[str, SchedTask] = {}
        self._image_programs: Dict[str, tuple] = {}   # image_ref -> programs
        self._cid_counter = itertools.count(1)
        self._lock = threading.RLock()
        self.checkpoint_interval = checkpoint_interval
        self.straggler_interval = straggler_interval
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        self.events: List[tuple] = []
        self._started = False
        # (autoscaler, target, signal_fn, interval_s) reconcile loops
        self._autoscalers: List[tuple] = []

    # ------------------------------------------------------------------
    # API server
    # ------------------------------------------------------------------
    def submit(self, image_ref: str, priority: int = 0,
               preemptible: bool = True, cid: Optional[str] = None,
               group: Optional[str] = None) -> str:
        with self._lock:
            cid = cid or f"task-{next(self._cid_counter):04d}"
            dep = Deployment(cid=cid, image_ref=image_ref, priority=priority,
                             preemptible=preemptible, group=group)
            self.deployments[cid] = dep
            st = SchedTask(tid=cid, priority=priority,
                           submit_time=dep.submit_time,
                           preemptible=preemptible, group=group)
            progs = self._image_programs.get(image_ref)
            if progs:
                st.meta["programs"] = progs     # warm-cache affinity hint
            self._sched_tasks[cid] = st
            self.scheduler.submit(st)
            self._log("submit", cid=cid, priority=priority)
            return cid

    def checkpoint(self, cid: str) -> str:
        node = self._sched_tasks[cid].node_id
        path = self.agents[node].checkpoint(cid)
        self._log("checkpoint", cid=cid, path=path)
        return path

    def scale_horizontal(self, cid: str, target_node: str) -> str:
        # Reserve the slot under the scheduler lock so a concurrent tick()
        # cannot double-book it, but run the multi-second checkpoint-clone
        # outside the lock — holding it would freeze scheduling and
        # failure recovery for the whole replicate.
        with self._lock:
            base_st = self._sched_tasks[cid]
            base_dep = self.deployments[cid]
            src = base_st.node_id
            image_ref = base_dep.image_ref
            gid = self._ensure_group(cid)
            new_cid = f"{cid}-r{next(self._cid_counter)}"
            dep = Deployment(cid=new_cid, image_ref=image_ref, group=gid)
            dep.status = "running"
            self.deployments[new_cid] = dep
            st = SchedTask(tid=new_cid, state=TaskState.RUNNING,
                           node_id=target_node, group=gid)
            progs = self._image_programs.get(image_ref)
            if progs:
                st.meta["programs"] = progs
            self._sched_tasks[new_cid] = st
            self.scheduler.run_queue.append(st)
        sp = self._span("orch.replicate", cid=cid, new_cid=new_cid,
                        node=target_node)
        try:
            self.agents[target_node].replicate_in(new_cid, cid, src,
                                                  image_ref)
        except BaseException as e:
            with self._lock:        # roll the reservation back
                self.scheduler.task_done(new_cid)
                self._sched_tasks.pop(new_cid, None)
                self.deployments.pop(new_cid, None)
            if sp is not None:
                sp.annotate(outcome="error", error=repr(e)).end()
            raise
        if sp is not None:
            sp.end()
        self._log("replicate", cid=cid, new_cid=new_cid, node=target_node)
        return new_cid

    def _ensure_group(self, cid: str) -> str:
        """Replicas of ``cid`` share a service group (default: the base
        task's cid), so placement can spread them across failure domains."""
        dep = self.deployments[cid]
        gid = dep.group or cid
        dep.group = gid
        st = self._sched_tasks[cid]
        if st.group is None:
            st.group = gid
        return gid

    def place_replica(self, cid: str) -> Optional[str]:
        """Pick the node for a new replica of ``cid`` through the unified
        placement engine: warm program-cache affinity (the clone reuses the
        base image's compiled programs) and failure-domain anti-affinity
        against the group's running members.  Returns None when no node has
        a free slice."""
        sp = self._span("orch.place", cid=cid)
        with self._lock:
            dep = self.deployments[cid]
            gid = self._ensure_group(cid)
            probe = SchedTask(
                tid=f"{cid}::place", priority=dep.priority, group=gid,
                meta={"programs": self._image_programs.get(dep.image_ref,
                                                           ())})
            target = self.placement.select_node(
                probe, self, {}, running=self.scheduler.run_queue)
        if sp is not None:
            sp.annotate(node=target).end()
        return target

    def scale_vertical(self, cid: str, vfpga_num: int):
        node = self._sched_tasks[cid].node_id
        self.agents[node].update(cid, vfpga_num)
        self._log("update", cid=cid, vfpga_num=vfpga_num)

    def scale_in(self, cid: str, drain_s: float = 0.0):
        """Remove a replica (scale-down): optionally drain first (stop
        admissions, let in-flight lanes finish at their request boundary),
        then kill + delete through the agent.  Draining happens outside the
        lock — it blocks for up to ``drain_s``."""
        sp = self._span("orch.scale_in", cid=cid)
        if drain_s > 0:
            node = self._sched_tasks[cid].node_id
            if node is not None and node in self.agents:
                dsp = (sp.child("orch.drain", cid=cid, node=node)
                       if sp is not None else None)
                try:
                    stats = self.agents[node].drain(cid, timeout_s=drain_s)
                    self._log("drain", cid=cid, node=node, **stats)
                except Exception as e:  # noqa: BLE001 - node may be gone
                    self._log("drain_error", cid=cid, node=node,
                              error=repr(e))
                finally:
                    if dsp is not None:
                        dsp.end()
        with self._lock:
            st = self._sched_tasks[cid]
            node = st.node_id
            if node is not None and node in self.agents:
                self.agents[node].remove(cid)
            self.scheduler.task_done(cid)
            self.scheduler.wait_queue = [
                t for t in self.scheduler.wait_queue if t.tid != cid]
            self.migration.forget(cid)
            st.state = TaskState.DONE
            dep = self.deployments[cid]
            dep.status = "removed"
            dep.end_time = time.time()
            self._log("scale_in", cid=cid, node=node)
        if sp is not None:
            sp.annotate(node=node).end()

    # ------------------------------------------------------------------
    # Workload-scaling service: autoscaler reconcile loop (paper §3.5)
    # ------------------------------------------------------------------
    def attach_autoscaler(self, autoscaler: Autoscaler,
                          target: ReplicaTarget, *, service: str = "svc",
                          signal_fn: Optional[
                              Callable[[], ScalingSignals]] = None,
                          interval_s: float = 0.25):
        """Register a reconcile loop for one service; starts with start().

        ``signal_fn`` defaults to reading the canonical service metrics from
        this orchestrator's registry — whoever terminates requests for the
        service (live serving loop or load generator) publishes them there.
        """
        if signal_fn is None:
            def signal_fn():
                s = signals_from_registry(self.metrics, service)
                s.replicas = target.current_replicas()
                return s
        entry = (autoscaler, target, signal_fn, interval_s)
        self._autoscalers.append(entry)
        if self._started:
            self._spawn_autoscale_loop(entry)

    def _spawn_autoscale_loop(self, entry):
        autoscaler, target, signal_fn, interval_s = entry

        def reconcile_loop():
            while not self._stop.wait(interval_s):
                try:
                    signals = signal_fn()
                    desired = autoscaler.reconcile(signals,
                                                   self.metrics.clock())
                    if desired is not None:
                        target.scale_to(desired)
                        self._log("autoscale", desired=desired,
                                  replicas=signals.replicas)
                except NodeFailed:
                    continue          # next pass sees the updated cluster
                except Exception as e:  # noqa: BLE001 - e.g. replicate race
                    # keep reconciling, but leave a trace: a permanently
                    # broken signal path must not look like a quiet cluster
                    self.metrics.counter("autoscaler_errors_total").inc()
                    self._log("autoscale_error", error=repr(e))
                    continue

        t = threading.Thread(target=reconcile_loop, daemon=True,
                             name="funky-autoscaler")
        t.start()
        self._threads.append(t)

    # ------------------------------------------------------------------
    # ClusterView for the scheduler
    # ------------------------------------------------------------------
    def nodes(self) -> List[str]:
        return [n for n, a in self.agents.items() if not a.failed]

    def free_slices(self, node: str) -> int:
        """Logical occupancy (scheduler's own accounting) — the physical
        allocator lags asynchronous task setup, so consulting it directly
        would double-book slots."""
        agent = self.agents.get(node)
        if agent is None or agent.failed:
            return 0
        return agent.num_slices() - len(self.running_tasks(node))

    def running_tasks(self, node: str) -> List[SchedTask]:
        return [t for t in self.scheduler.run_queue if t.node_id == node]

    # -- enriched view (placement layer) --------------------------------
    def failure_domain(self, node: str) -> str:
        agent = self.agents.get(node)
        return agent.failure_domain if agent is not None else node

    def warm_programs(self, node: str) -> tuple:
        agent = self.agents.get(node)
        if agent is None or agent.failed:
            return ()
        try:
            return agent.warm_programs()
        except NodeFailed:
            return ()

    # ------------------------------------------------------------------
    # Scheduling loop
    # ------------------------------------------------------------------
    def tick(self) -> List[Action]:
        """Reap finished tasks, run one scheduling pass, execute actions."""
        t0 = time.perf_counter()
        with self._lock:
            self._reap()
            self._learn_programs()
            actions = self.scheduler.schedule_once(self)
            for a in actions:
                self._execute(a)
            self._publish_cluster_metrics()
            self.metrics.histogram("sched_tick_seconds").observe(
                time.perf_counter() - t0)
            return actions

    def _learn_programs(self):
        """Cache each running image's program ids (once known) so placement
        can match them against node program caches for warm affinity."""
        for st in self.scheduler.run_queue:
            if "programs" in st.meta:
                continue
            dep = self.deployments.get(st.tid)
            agent = self.agents.get(st.node_id)
            if dep is None or agent is None or agent.failed:
                continue
            known = self._image_programs.get(dep.image_ref)
            if known:
                st.meta["programs"] = known
                continue
            try:
                progs = agent.task_programs(st.tid)
            except NodeFailed:
                continue
            if progs is None:
                continue               # guest still booting: retry next tick
            # cache even an empty result so probing terminates per task
            st.meta["programs"] = tuple(progs)
            if progs:
                self._image_programs[dep.image_ref] = tuple(progs)

    def _publish_cluster_metrics(self):
        """Cluster-level gauges (same names the simulator emits)."""
        self.metrics.gauge("wait_queue_depth").set(
            len(self.scheduler.wait_queue))
        self.metrics.gauge("running_tasks").set(
            len(self.scheduler.run_queue))
        total = used = 0
        for n, agent in self.agents.items():
            if agent.failed:
                continue
            slices = agent.num_slices()
            free = self.free_slices(n)
            self.metrics.gauge("free_slices", node=n).set(free)
            if slices:
                self.metrics.gauge(M_NODE_UTILIZATION, node=n).set(
                    (slices - free) / slices)
            total += slices
            used += slices - free
        if total:
            self.metrics.gauge("cluster_utilization").set(used / total)

    def _reap(self):
        for cid, st in list(self._sched_tasks.items()):
            if st.state is not TaskState.RUNNING:
                continue
            agent = self.agents.get(st.node_id)
            if agent is None or agent.failed:
                continue
            status = agent.task_status(cid)
            dep = self.deployments[cid]
            if status is TaskStatus.DONE:
                st.state = TaskState.DONE
                self.scheduler.task_done(cid)
                self.migration.forget(cid)
                dep.status = "done"
                dep.end_time = time.time()
                self._log("done", cid=cid)
            elif status is TaskStatus.FAILED:
                rec_err = agent.engine.runtime.tasks[cid].error
                if isinstance(rec_err, NoSliceAvailable):
                    # slot race during async setup: requeue, don't kill
                    agent.engine.runtime.delete(cid)
                    st.state = TaskState.WAITING
                    st.node_id = None
                    self.scheduler.task_done(cid)
                    self.scheduler.submit(st)
                    dep.status = "pending"
                    self._log("requeued_no_slice", cid=cid)
                    continue
                st.state = TaskState.DONE
                self.scheduler.task_done(cid)
                self.migration.forget(cid)
                dep.status = "failed"
                dep.end_time = time.time()
                self._log("task_failed", cid=cid)

    def _execute(self, a: Action):
        dep = self.deployments.get(a.tid)
        st = self._sched_tasks[a.tid]

        def dispatch():
            if a.kind == "deploy":
                self.agents[a.node].deploy(
                    a.tid, dep.image_ref, priority=dep.priority,
                    preemptible=dep.preemptible)
                dep.status = "running"
                dep.start_time = dep.start_time or time.time()
            elif a.kind == "evict":
                self.agents[a.node].evict(a.tid)
                self.deployments[a.tid].status = "evicted"
            elif a.kind == "resume":
                self.agents[a.node].resume(a.tid)
                dep.status = "running"
            elif a.kind == "migrate":
                self.agents[a.node].migrate_in(
                    a.tid, dep.image_ref, a.src_node)
                dep.status = "running"

        sp = self._span(f"orch.{a.kind}", cid=a.tid, node=a.node)
        try:
            retry_call(dispatch, self.retry,
                       on_retry=lambda n, b, e: self._on_action_retry(
                           a.kind, a.tid, n, b, e, sp))
            self._log(a.kind, cid=a.tid, node=a.node)
            if a.kind in ("migrate", "resume"):
                # the straggler landed again: link its post-migration trace
                # back to the pre-eviction one (relation "migrates")
                pre = self._pending_migrate_links.pop(a.tid, None)
                if pre is not None and self.tracer is not None:
                    post = self.tracer.event_span(
                        "orch.migrate_in", cid=a.tid, node=a.node,
                        src_node=getattr(a, "src_node", None))
                    post.link(pre, relation="migrates")
                    post.finish()
        except TransientFault as e:
            # attempts exhausted: structured failure + requeue — the
            # scheduling loop must survive an unlucky streak
            self._requeue(st, a, "action_failed", error=repr(e))
            if sp is not None:
                sp.annotate(outcome="action_failed", error=repr(e))
        except NodeFailed:
            # node died under us: requeue the task
            st.state = TaskState.WAITING
            st.node_id = None
            self.scheduler.task_done(a.tid)
            self.scheduler.submit(st)
            self._log("node_failed_during", action=a.kind, cid=a.tid)
            if sp is not None:
                sp.annotate(outcome="node_failed")
        except NoSliceAvailable:
            self._requeue(st, a, "no_slice_retry")
            if sp is not None:
                sp.annotate(outcome="no_slice_retry")
        except BaseException as e:
            if sp is not None:
                sp.annotate(outcome="error", error=repr(e))
            raise
        finally:
            if sp is not None:
                sp.end()

    def _requeue(self, st: SchedTask, a: Action, event: str, **kw):
        if a.kind in ("resume", "migrate"):
            st.state = TaskState.EVICTED      # context survives
        else:
            st.state = TaskState.WAITING
            st.node_id = None
        self.scheduler.task_done(a.tid)
        self.scheduler.submit(st)
        self._log(event, action=a.kind, cid=a.tid, **kw)

    def _on_action_retry(self, action: str, cid: str, attempt: int,
                         backoff_s: float, exc: BaseException, sp=None):
        self.metrics.counter("orchestrator_action_retries_total",
                             action=action).inc()
        self._log("action_retry", action=action, cid=cid,
                  attempt=attempt, backoff_s=backoff_s, error=repr(exc))
        if sp is not None:
            sp.child("orch.retry", attempt=attempt, backoff_s=backoff_s,
                     error=repr(exc)).end()

    # ------------------------------------------------------------------
    # Background services
    # ------------------------------------------------------------------
    def start(self, tick_interval: float = 0.02):
        self._started = True
        for entry in self._autoscalers:
            self._spawn_autoscale_loop(entry)

        def sched_loop():
            while not self._stop.is_set():
                self.tick()
                time.sleep(tick_interval)

        t = threading.Thread(target=sched_loop, daemon=True,
                             name="funky-scheduler")
        t.start()
        self._threads.append(t)

        if self.checkpoint_interval:
            def ckpt_loop():
                while not self._stop.wait(self.checkpoint_interval):
                    with self._lock:
                        running = [t.tid for t in self.scheduler.run_queue]
                    for cid in running:
                        try:
                            self.checkpoint(cid)
                        except Exception as e:  # noqa: BLE001
                            # a task may legitimately finish/evict under us,
                            # but a permanently broken snapshot path must
                            # not look like a healthy checkpoint service
                            self._log("ckpt_error", cid=cid, error=repr(e))

            t2 = threading.Thread(target=ckpt_loop, daemon=True,
                                  name="funky-ckpt")
            t2.start()
            self._threads.append(t2)

        if self.straggler_interval:
            def straggler_loop():
                while not self._stop.wait(self.straggler_interval):
                    try:
                        self.check_stragglers()
                    except Exception as e:  # noqa: BLE001
                        self._log("straggler_probe_error", error=repr(e))

            t3 = threading.Thread(target=straggler_loop, daemon=True,
                                  name="funky-straggler")
            t3.start()
            self._threads.append(t3)

    def stop(self):
        self._stop.set()
        for t in self._threads:
            t.join(timeout=10)

    # ------------------------------------------------------------------
    # Straggler mitigation
    # ------------------------------------------------------------------
    def check_stragglers(self, *, min_relative_rate: float = 0.5,
                         min_window_s: float = 1.0) -> List[str]:
        """Metrics-driven migration: node agents publish each task's guest
        step counter into the shared registry (``task_progress_steps``
        series + per-node ``node_progress_rate`` gauges), and the
        ``MigrationController`` flags tasks progressing below
        ``min_relative_rate`` x the peer median (>= 3 measurable peers
        required).  Flagged tasks are evicted so the scheduler's placement
        migrates their context to a healthier node.  Returns the cids
        acted on."""
        running: Dict[str, Optional[str]] = {}
        with self._lock:
            for st in list(self.scheduler.run_queue):
                agent = self.agents.get(st.node_id)
                if agent is None or agent.failed:
                    continue
                try:
                    step = agent.task_progress(st.tid)
                except NodeFailed:
                    continue
                if step is None:
                    continue
                self.migration.observe(st.tid, step)
                running[st.tid] = st.node_id
        decisions = self.migration.decide(
            running, min_relative_rate=min_relative_rate,
            min_window_s=min_window_s)
        acted = []
        for d in decisions:
            st = self._sched_tasks[d.cid]
            # only worth migrating if somewhere else has room
            if not any(self.free_slices(n) > 0 for n in self.nodes()
                       if n != st.node_id):
                continue
            ssp = self._span("orch.straggler_migrate", cid=d.cid,
                             node=st.node_id)
            try:
                self.agents[st.node_id].evict(d.cid)
            except Exception as e:  # noqa: BLE001 - task may just finish
                self._log("straggler_evict_error", cid=d.cid,
                          error=repr(e))
                if ssp is not None:
                    ssp.annotate(outcome="evict_error").end()
                continue
            with self._lock:
                self.scheduler.task_done(d.cid)
                st.state = TaskState.EVICTED
                # the freed slice would otherwise resume the straggler
                # straight back onto the degraded node — flag it so
                # placement scores the *other* candidates first
                st.meta["migrate_from"] = st.node_id
                self.scheduler.submit(st)
                self.migration.reset(d.cid)
            self._log("straggler_evicted", cid=d.cid, rate=d.rate,
                      median=d.median)
            if ssp is not None:
                ssp.annotate(outcome="evicted", rate=d.rate).end()
            if self.tracer is not None:
                pre = self.tracer.event_span(
                    "orch.migrate_out", cid=d.cid, node=st.node_id,
                    rate=d.rate, median=d.median)
                pre.finish()
                self._pending_migrate_links[d.cid] = pre
            acted.append(d.cid)
        return acted

    # ------------------------------------------------------------------
    # Fault tolerance
    # ------------------------------------------------------------------
    def handle_node_failure(self, node_id: str):
        """Restore tasks of a failed node from their latest snapshots.

        Per victim: (1) the dead node's task is hard-crashed — driver
        stopped with *no* graceful hooks, so its un-checkpointed work is
        genuinely lost; (2) a serve replica's leased in-flight requests
        are replayed back into the router queue (no request lost, none
        double-completed); (3) restore walks the snapshot candidates
        newest-first with bounded retries, falling back past corrupt
        checkpoints (``restore_fallback`` events) before resubmitting
        from scratch as the last resort."""
        fsp = self._span("orch.node_failure", node=node_id)
        agent = self.agents[node_id]
        agent.fail()
        rt = agent.engine.runtime
        with self._lock:
            victims = [t for t in list(self.scheduler.run_queue)
                       if t.node_id == node_id]
            for st in victims:
                self.scheduler.task_done(st.tid)
                # pre-failure progress history measured the dead node
                self.migration.reset(st.tid)
                dep = self.deployments[st.tid]
                rec = rt.tasks.get(st.tid)
                if rec is not None and rec.status in (TaskStatus.CREATED,
                                                      TaskStatus.RUNNING,
                                                      TaskStatus.EVICTED):
                    rt.crash(st.tid)
                if (rec is not None
                        and getattr(rec.image, "kind", "") ==
                        "engine-serve"):
                    self._replay_serve_requests(rec.image.name, st.tid)
                # restore target chosen by the same placement engine (the
                # failed node's domain peers are penalized automatically)
                probe = SchedTask(tid=f"{st.tid}::restore",
                                  priority=st.priority, group=st.group,
                                  meta=dict(st.meta))
                target = self.placement.select_node(
                    probe, self, {}, running=self.scheduler.run_queue)
                rsp = (fsp.child("orch.restore", cid=st.tid)
                       if fsp is not None else None)
                snap = None
                if target is not None:
                    snap = self._restore_from_candidates(st, dep, target,
                                                         rsp)
                if snap is not None:
                    st.state = TaskState.RUNNING
                    st.node_id = target
                    self.scheduler.run_queue.append(st)
                    self._log("restored", cid=st.tid, node=target,
                              snap=snap)
                    if rsp is not None:
                        rsp.annotate(node=target, outcome="restored",
                                     snap=snap).end()
                else:
                    # no (usable) snapshot: restart from scratch
                    st.state = TaskState.WAITING
                    st.node_id = None
                    self.scheduler.submit(st)
                    self._log("resubmitted", cid=st.tid)
                    if rsp is not None:
                        rsp.annotate(outcome="resubmitted").end()
        if fsp is not None:
            fsp.end()

    def _replay_serve_requests(self, service: str, engine_id: str):
        """Re-enqueue a crashed serve replica's leased in-flight requests
        (router-level replay) so another replica picks them up."""
        from repro_torch.scaling.serving import get_router

        try:
            n = get_router(service,
                           registry=self.metrics).fail_engine(engine_id)
        except Exception as e:  # noqa: BLE001 - recovery must not die here
            self._log("router_replay_error", cid=engine_id, error=repr(e))
            return
        if n:
            self._log("router_replay", cid=engine_id, service=service,
                      replayed=n)

    def _restore_from_candidates(self, st: SchedTask, dep: Deployment,
                                 target: str, rsp=None) -> Optional[str]:
        """Try snapshot candidates newest-first; each restore attempt gets
        bounded retries for transient faults and falls back to the next
        older snapshot on corruption.  Returns the path restored from."""
        from repro_torch.ckpt.checkpoint import CheckpointCorruptError

        for snap in self._snapshot_candidates(st.tid):
            try:
                retry_call(
                    lambda: self.agents[target].restore(st.tid, snap,
                                                        dep.image_ref),
                    self.retry,
                    on_retry=lambda n, b, e: self._on_action_retry(
                        "restore", st.tid, n, b, e, rsp))
                return snap
            except (CheckpointCorruptError, TransientFault) as e:
                self.metrics.record_event(
                    "restore_fallback", task=st.tid, snap=snap,
                    error=repr(e))
                self._log("restore_fallback", cid=st.tid, snap=snap,
                          error=repr(e))
                if rsp is not None:
                    rsp.child("orch.restore_fallback", snap=snap,
                              error=repr(e)).end()
            except NodeFailed:
                return None           # restore target died too
        return None

    def _snapshot_candidates(self, cid: str) -> List[str]:
        """All published snapshots for ``cid`` across every node's
        checkpoint root, newest step first (numeric step order)."""
        from repro_torch.ckpt.checkpoint import snapshot_candidates

        roots = [agent.engine.runtime.ckpt_root
                 for agent in self.agents.values()]
        return snapshot_candidates(roots, cid)

    def _latest_snapshot_any(self, cid: str) -> Optional[str]:
        hits = self._snapshot_candidates(cid)
        return hits[0] if hits else None

    # ------------------------------------------------------------------
    def wait_all(self, timeout: float = 600.0) -> bool:
        deadline = time.time() + timeout
        while time.time() < deadline:
            with self._lock:
                pend = [d for d in self.deployments.values()
                        if d.status not in ("done", "failed", "removed")]
            if not pend:
                return True
            time.sleep(0.02)
        return False

    def _span(self, name: str, **labels):
        """A span on the cluster trace (None when tracing is off)."""
        if self._cluster_trace is None:
            return None
        return self._cluster_trace.span(name, **labels)

    def _log(self, event: str, **kw):
        self.events.append((time.time(), event, kw))
        self.metrics.counter("orchestrator_events_total", event=event).inc()
