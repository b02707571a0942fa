"""Discrete-event simulator of one edge base station + cloud FaaS (§3.3),
and the lockstep multi-edge oracle of the fleet tick.

A copy of ``repro.sim.engine``, kept so the port never imports the JAX
package.  :class:`Simulator` models the paper's runtime architecture: a
task scheduler routing each arrival to the edge queue, the cloud queue
or a drop (policy-driven, §5–6); a synchronous single-stream edge
executor with a JIT deadline check; a cloud executor of
``cloud_concurrency`` slots over a trigger-time priority queue; and a
window monitor keeping per-model tumbling QoE windows that drive the
GEMS rescheduler (Alg. 1).  :class:`FleetOracle` steps one simulator
per edge in ``dt`` slices and exchanges tasks between slices like the
fleet's ``peer_offload``.  ``ModelStats`` and ``Results`` are the
per-model counters and run results that the serve engine shares.

Host code (plain Python + numpy): every sampler draws from the
simulator's own ``numpy.random.default_rng(seed)`` in the reference's
order, and events leave the heap in ``(time, seq)`` order, so a run
settles every task exactly as the reference does.  Time unit:
milliseconds.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Optional

import numpy as np

from repro_torch.core.schedulers import AdaptiveEstimator, Policy
from repro_torch.core.task import ModelProfile, Outcome, Task
from repro_torch.sim.network import CloudLatencyModel, EdgeLatencyModel


@dataclasses.dataclass
class Arrival:
    time: float
    model: ModelProfile
    drone: int = 0


@dataclasses.dataclass
class ModelStats:
    generated: int = 0
    edge_success: int = 0
    cloud_success: int = 0
    edge_miss: int = 0
    cloud_miss: int = 0
    dropped: int = 0
    stolen: int = 0
    migrated: int = 0
    gems_rescheduled: int = 0
    qos_utility: float = 0.0
    edge_utility: float = 0.0
    cloud_utility: float = 0.0
    qoe_utility: float = 0.0
    windows_met: int = 0
    windows_total: int = 0

    @property
    def completed(self) -> int:
        return self.edge_success + self.cloud_success


@dataclasses.dataclass
class Results:
    policy: str
    duration: float
    per_model: dict[str, ModelStats]
    edge_busy: float = 0.0

    def _sum(self, attr: str) -> float:
        return sum(getattr(s, attr) for s in self.per_model.values())

    @property
    def generated(self) -> int: return int(self._sum("generated"))
    @property
    def completed(self) -> int: return int(self._sum("completed"))
    @property
    def completion_rate(self) -> float:
        return self.completed / max(self.generated, 1)
    @property
    def qos_utility(self) -> float: return self._sum("qos_utility")
    @property
    def edge_utility(self) -> float: return self._sum("edge_utility")
    @property
    def cloud_utility(self) -> float: return self._sum("cloud_utility")
    @property
    def qoe_utility(self) -> float: return self._sum("qoe_utility")
    @property
    def total_utility(self) -> float:
        return self.qos_utility + self.qoe_utility
    @property
    def stolen(self) -> int: return int(self._sum("stolen"))
    @property
    def migrated(self) -> int: return int(self._sum("migrated"))
    @property
    def gems_rescheduled(self) -> int: return int(self._sum("gems_rescheduled"))
    @property
    def edge_utilization(self) -> float:
        return self.edge_busy / max(self.duration, 1e-9)

    def summary(self) -> str:
        return (f"{self.policy:8s} tasks={self.completed}/{self.generated} "
                f"({100 * self.completion_rate:.1f}%) QoS={self.qos_utility:.0f} "
                f"QoE={self.qoe_utility:.0f} total={self.total_utility:.0f} "
                f"edge_util={100 * self.edge_utilization:.0f}% "
                f"stolen={self.stolen} migrated={self.migrated} "
                f"gems={self.gems_rescheduled}")


class _WindowState:
    """Per-model tumbling-window QoE accounting (Eqn 2 / Alg. 1 state)."""

    __slots__ = ("end", "width", "lam", "lam_hat", "prev_lam")

    def __init__(self, width: float):
        self.end = width
        self.width = width
        self.lam = 0
        self.lam_hat = 0
        self.prev_lam = 0     # arrivals seen in the previous window

    @property
    def rate(self) -> float:
        return self.lam_hat / self.lam if self.lam else 1.0

    def winnable(self, alpha: float, now: float) -> bool:
        """GEMS-B: can α̂ still reach α if every remaining task in this
        window succeeds?  Remaining count is estimated from the previous
        window's arrivals, prorated by the time left."""
        frac_left = max(0.0, (self.end - now) / self.width)
        remaining = max(self.prev_lam, self.lam) * frac_left
        return (self.lam_hat + remaining) >= alpha * (self.lam + remaining) \
            - 1e-9


class Simulator:
    """One edge base station and its share of the cloud FaaS."""

    def __init__(self, policy: Policy, arrivals: list[Arrival],
                 duration: float, *,
                 cloud_concurrency: int = 16,
                 edge_model: Optional[EdgeLatencyModel] = None,
                 cloud_model: Optional[CloudLatencyModel] = None,
                 cloud_outages: tuple[tuple[float, float], ...] = (),
                 outage_cold_ms: float = 0.0,
                 outage_cold_window_ms: float = 3_000.0,
                 edge_down_windows: tuple[tuple[float, float], ...] = (),
                 cloud_give_up_ms: float = float("inf"),
                 seed: int = 0):
        self.policy = policy
        self.arrivals = sorted(arrivals, key=lambda a: a.time)
        self.duration = duration
        self.rng = np.random.default_rng(seed)
        self.edge_model = edge_model or EdgeLatencyModel()
        self.cloud_model = cloud_model or CloudLatencyModel()
        self.cloud_slots = cloud_concurrency
        # cloud FaaS outage windows (scenario events): dispatch stalls
        # during [start, end); dispatches shortly after recovery pay a
        # cold-start penalty (the warm container pool has drained).
        # Entries are (start, end) or (start, end, cold_ms, cold_window_ms);
        # 2-tuples take the Simulator-level defaults.
        self.cloud_outages = tuple(sorted(
            tuple(o) if len(tuple(o)) == 4
            else (*o, outage_cold_ms, outage_cold_window_ms)
            for o in cloud_outages))
        self._recovery_checks: set[float] = set()
        # chaos-engine fault hooks: edge scheduler crash windows (queued
        # work flushed at the start, nothing admitted until the end; the
        # in-flight kernel completes — a scheduler crash, not a power
        # cut) and the bounded cloud-dispatch patience, matching the
        # fleet simulator's ``cloud_give_up_ms`` drop lane
        self.edge_down_windows = tuple(sorted(
            (float(s), float(e)) for s, e in edge_down_windows))
        self.cloud_give_up = cloud_give_up_ms
        self.edge_down = False

        self.profiles: dict[str, ModelProfile] = {}
        for a in self.arrivals:
            self.profiles.setdefault(a.model.name, a.model)
        self.min_edge_t = min((m.t_edge for m in self.profiles.values()),
                              default=0.0)

        # runtime state -------------------------------------------------
        self._heap: list[tuple[float, int, str, object]] = []
        self._seq = 0
        self.now = 0.0
        self.edge_queue: list[Task] = []       # sorted by policy.edge_key
        self.edge_current: Optional[Task] = None
        self.edge_busy_until = 0.0
        self.edge_busy_total = 0.0
        self.cloud_pending: list[Task] = []    # sorted by trigger time
        self.cloud_inflight = 0
        self._triggers: dict[int, float] = {}  # task uid -> trigger time
        self.adaptive: dict[str, AdaptiveEstimator] = {
            n: AdaptiveEstimator(static=m.t_cloud)
            for n, m in self.profiles.items()}
        self.windows: dict[str, _WindowState] = {
            n: _WindowState(m.qoe_window) for n, m in self.profiles.items()
            if m.qoe_alpha > 0}
        self.stats = {n: ModelStats() for n in self.profiles}
        self.tasks: list[Task] = []
        self._uid = 0

    # ------------------------------------------------------------------
    # event plumbing
    # ------------------------------------------------------------------
    def _push(self, time: float, kind: str, data: object = None) -> None:
        self._seq += 1
        heapq.heappush(self._heap, (time, self._seq, kind, data))

    def _t_cloud(self, m: ModelProfile) -> float:
        """Scheduler's current cloud-latency estimate for ``m`` (§5.4)."""
        if self.policy.adaptive:
            return self.adaptive[m.name].current
        return m.t_cloud

    # ------------------------------------------------------------------
    # edge queue helpers
    # ------------------------------------------------------------------
    def _edge_start_time(self) -> float:
        return max(self.edge_busy_until, self.now)

    def _insert_pos(self, task: Task) -> int:
        key = self.policy.edge_key(task)
        lo = 0
        for i, t in enumerate(self.edge_queue):
            if self.policy.edge_key(t) <= key:
                lo = i + 1
        return lo

    def _projected(self, queue: list[Task]) -> list[float]:
        """Projected completion time of each queued task (§5.2)."""
        cur = self._edge_start_time()
        out = []
        for t in queue:
            cur += t.model.t_edge
            out.append(cur)
        return out

    def _feasible_at(self, queue: list[Task], pos: int, task: Task) -> bool:
        wait = self._edge_start_time() + sum(
            t.model.t_edge for t in queue[:pos])
        return wait + task.model.t_edge <= task.sched_deadline

    def _victims_of_insert(self, pos: int, task: Task) -> list[Task]:
        """Existing tasks newly pushed past their deadline by the insert."""
        before = self._projected(self.edge_queue)
        shifted = task.model.t_edge
        victims = []
        for i in range(pos, len(self.edge_queue)):
            t = self.edge_queue[i]
            if before[i] <= t.sched_deadline < before[i] + shifted:
                victims.append(t)
        return victims

    # ------------------------------------------------------------------
    # routing (task scheduler thread, §3.3)
    # ------------------------------------------------------------------
    def _route(self, task: Task) -> None:
        p = self.policy
        if self.edge_down:
            # crashed edge admits nothing: arrivals re-route cloud-ward
            # (mirroring the fleet's ``insert_edge &= edge_up`` gate)
            self._offer_cloud(task) or self._drop(task)
            return
        if not p.use_edge:
            self._offer_cloud(task) or self._drop(task)
            return
        if not p.use_cloud and not p.edge_feasibility_check:
            self._edge_insert(task, self._insert_pos(task))   # edge-only
            return
        if p.sota1:
            self._route_sota1(task)
            return
        if p.sota2:
            self._route_sota2(task)
            return

        pos = self._insert_pos(task)
        if self._feasible_at(self.edge_queue, pos, task):
            if p.migration:
                victims = self._victims_of_insert(pos, task)
                if victims and not p.migration_decision(
                        task, victims, self.now,
                        lambda m: self._t_cloud(m)):
                    self._offer_cloud(task) or self._drop(task)
                    return
                for v in victims:
                    self.edge_queue.remove(v)
                    v.migrated = True
                    self.stats[v.model.name].migrated += 1
                    self._offer_cloud(v) or self._drop(v)
                self._edge_insert(task, self._insert_pos(task))
            else:
                self._edge_insert(task, pos)
        else:
            self._offer_cloud(task) or self._drop(task)

    def _route_sota1(self, task: Task) -> None:
        """Kalmia+D3 adaptation: urgent/non-urgent, 10 % deadline buffer."""
        pos = self._insert_pos(task)
        if self._feasible_at(self.edge_queue, pos, task):
            self._edge_insert(task, pos)
            return
        urgent = task.model.deadline <= self.policy.urgent_deadline
        if not urgent:
            task.deadline_ext = 0.1 * task.model.deadline
            pos = self._insert_pos(task)
            if self._feasible_at(self.edge_queue, pos, task):
                self._edge_insert(task, pos)
                return
        self._offer_cloud(task) or self._drop(task)

    def _route_sota2(self, task: Task) -> None:
        """Dedas adaptation: exec-time priority + average-completion-time.

        Victim count >1 → cloud.  Exactly one violation → keep the schedule
        whose mean completion time (ACT) over all queued tasks is lower;
        inserting nearly always raises ACT, so such tasks go to the cloud —
        matching the paper's observation that SOTA2 leans on the cloud.
        """
        pos = self._insert_pos(task)
        own_ok = self._feasible_at(self.edge_queue, pos, task)
        victims = self._victims_of_insert(pos, task)
        nviol = len(victims) + (0 if own_ok else 1)
        if nviol == 0:
            self._edge_insert(task, pos)
            return
        if nviol > 1:
            self._offer_cloud(task) or self._drop(task)
            return
        before = self._projected(self.edge_queue)
        after_q = self.edge_queue[:pos] + [task] + self.edge_queue[pos:]
        after = self._projected(after_q)
        act_before = sum(before) / len(before) if before else float("inf")
        act_after = sum(after) / len(after)
        if own_ok and act_after <= act_before:
            self._edge_insert(task, pos)
        else:
            self._offer_cloud(task) or self._drop(task)

    # ------------------------------------------------------------------
    # edge executor
    # ------------------------------------------------------------------
    def _edge_insert(self, task: Task, pos: int) -> None:
        self.edge_queue.insert(pos, task)
        self._edge_dispatch()

    def _edge_dispatch(self) -> None:
        if self.edge_current is not None or self.edge_down:
            return
        # JIT check: drop heads that can no longer meet their deadline.
        while self.edge_queue:
            head = self.edge_queue[0]
            if self.now + head.model.t_edge > head.sched_deadline:
                self._drop(self.edge_queue.pop(0))
            else:
                break
        task = self._try_steal() if self.policy.stealing else None
        if task is None:
            if not self.edge_queue:
                return
            task = self.edge_queue.pop(0)
        dur = self.edge_model.sample(self.rng, task.model.t_edge,
                                     now=self.now, model=task.model.name)
        self.edge_current = task
        self.edge_busy_until = self.now + dur
        self.edge_busy_total += dur
        self._push(self.now + dur, "edge_done", task)

    def _try_steal(self) -> Optional[Task]:
        """Work stealing from the cloud queue into edge slack (§5.3)."""
        if self.edge_queue:
            head = self.edge_queue[0]
            slack = head.abs_deadline - (self.now + head.model.t_edge)
            if slack <= self.min_edge_t:
                return None
            proj = self._projected(self.edge_queue)
            max_delay = min(t.sched_deadline - c
                            for t, c in zip(self.edge_queue, proj))
            if max_delay <= 0:
                return None
        else:
            max_delay = float("inf")
        eligible = [c for c in self.cloud_pending
                    if c.model.t_edge <= max_delay
                    and self.now + c.model.t_edge <= c.abs_deadline]
        if not eligible:
            return None
        # negative-cloud-utility (steal-only) tasks first, then rank.
        eligible.sort(key=lambda c: (not c.steal_only,
                                     -c.model.steal_rank()))
        task = eligible[0]
        self.cloud_pending.remove(task)
        task.stolen = True
        self.stats[task.model.name].stolen += 1
        return task

    # ------------------------------------------------------------------
    # cloud executor (FaaS thread pool + trigger-time queue)
    # ------------------------------------------------------------------
    def _offer_cloud(self, task: Task) -> bool:
        acc = self.policy.offer_cloud(task, self.now,
                                      self._t_cloud(task.model))
        if not acc.accept:
            if self.policy.adaptive and self.policy.use_cloud:
                self.adaptive[task.model.name].on_skip(self.now)
            return False
        task.steal_only = acc.steal_only
        self._triggers[task.uid] = acc.trigger
        i = 0
        while i < len(self.cloud_pending) and \
                self._triggers[self.cloud_pending[i].uid] <= acc.trigger:
            i += 1
        self.cloud_pending.insert(i, task)
        if acc.trigger <= self.now:
            self._cloud_dispatch()
        else:
            self._push(acc.trigger, "cloud_check", None)
        if not acc.steal_only and self.cloud_give_up != float("inf"):
            # guarantee a dispatch sweep right past the give-up horizon
            # even if no other event lands there (e.g. mid-outage)
            self._push(acc.trigger + self.cloud_give_up + 1e-6,
                       "cloud_check", None)
        return True

    def _outage_end(self, t: float) -> Optional[float]:
        """End of the outage window containing ``t``, or None if cloud up."""
        for start, end, _, _ in self.cloud_outages:
            if start <= t < end:
                return end
        return None

    def _cold_penalty(self) -> float:
        """Post-outage cold start: warm pool drained while the cloud was
        down, so dispatches within that outage's cold window pay its
        warmup price."""
        for _, end, cold_ms, cold_window_ms in self.cloud_outages:
            if cold_ms and 0.0 <= self.now - end < cold_window_ms:
                return cold_ms
        return 0.0

    def _cloud_dispatch(self) -> None:
        if self.cloud_give_up != float("inf"):
            # bounded patience: parked dispatches past the give-up
            # horizon are abandoned (steal-only parks keep their own
            # expiry path).  Remove before dropping — a drop can trigger
            # a GEMS rescan that re-enters this queue.
            expired = [t for t in self.cloud_pending
                       if not t.steal_only
                       and self.now - self._triggers[t.uid]
                       > self.cloud_give_up]
            for t in expired:
                self.cloud_pending.remove(t)
            for t in expired:
                self._drop(t)
        up_at = self._outage_end(self.now)
        if up_at is not None:
            # cloud down: park everything; re-check the queue on recovery.
            if up_at not in self._recovery_checks:
                self._recovery_checks.add(up_at)
                self._push(up_at, "cloud_check", None)
            return
        while self.cloud_inflight < self.cloud_slots and self.cloud_pending:
            task = self.cloud_pending[0]
            if self._triggers[task.uid] > self.now:
                break
            self.cloud_pending.pop(0)
            if task.steal_only:
                self._drop(task)            # not stolen in time → JIT drop
                continue
            est = self._t_cloud(task.model)
            if self.now + est > task.abs_deadline:
                self._drop(task)            # JIT deadline check
                if self.policy.adaptive:
                    self.adaptive[task.model.name].on_skip(self.now)
                continue
            if self.policy.adaptive:
                self.adaptive[task.model.name].on_sent()
            dur = self.cloud_model.sample(
                self.rng, task.model.t_cloud, self.now,
                model=task.model.name) + self._cold_penalty()
            self.cloud_inflight += 1
            self._push(self.now + dur, "cloud_done", (task, dur))

    # ------------------------------------------------------------------
    # completion, drops, QoE windows (window-monitor thread + Alg. 1)
    # ------------------------------------------------------------------
    def _drop(self, task: Task) -> bool:
        task.outcome = Outcome.DROPPED
        task.finished = self.now
        self.stats[task.model.name].dropped += 1
        self._window_update(task, success=False)
        return True

    def _finish(self, task: Task, where: str) -> None:
        task.finished = self.now
        ok = self.now <= task.abs_deadline
        st = self.stats[task.model.name]
        if where == "edge":
            task.outcome = Outcome.EDGE_SUCCESS if ok else Outcome.EDGE_MISS
            st.edge_success += ok
            st.edge_miss += (not ok)
            st.edge_utility += task.utility()
        else:
            task.outcome = Outcome.CLOUD_SUCCESS if ok else Outcome.CLOUD_MISS
            st.cloud_success += ok
            st.cloud_miss += (not ok)
            st.cloud_utility += task.utility()
        st.qos_utility += task.utility()
        self._window_update(task, success=ok)

    def _window_update(self, task: Task, success: bool) -> None:
        wm = self.windows.get(task.model.name)
        if wm is None:
            return
        self._close_windows(task.model, until=self.now)
        wm.lam += 1
        wm.lam_hat += success
        if self.policy.gems and wm.rate < task.model.qoe_alpha:
            lost = self.policy.gems_budget and not wm.winnable(
                task.model.qoe_alpha, self.now)
            # GEMS-B: once the window is mathematically lost, stop the
            # Alg-1 flood; only salvage tasks already doomed on the edge
            # (pure QoS rescue — no QoE can be recovered this window)
            self._gems_rescan(task.model, only_doomed=lost)

    def _close_windows(self, m: ModelProfile, until: float) -> None:
        wm = self.windows[m.name]
        st = self.stats[m.name]
        while until > wm.end:
            if wm.lam > 0:
                st.windows_total += 1
                if wm.rate >= m.qoe_alpha:
                    st.windows_met += 1
                    st.qoe_utility += m.qoe_beta
            wm.prev_lam = wm.lam
            wm.lam = wm.lam_hat = 0
            wm.end += wm.width

    def _gems_rescan(self, m: ModelProfile,
                     only_doomed: bool = False) -> None:
        """Alg. 1 lines 9–14: push lagging model's edge tasks to the cloud.

        ``only_doomed`` (GEMS-B) restricts the move to tasks whose
        projected *edge* completion already misses their deadline.
        """
        if m.gamma_cloud <= 0:
            return
        est = self._t_cloud(m)
        if only_doomed:
            proj = self._projected(self.edge_queue)
            doomed = {t.uid for t, c in zip(self.edge_queue, proj)
                      if c > t.sched_deadline}
        moved = [t for t in self.edge_queue
                 if t.model.name == m.name
                 and self.now + est <= t.abs_deadline
                 and (not only_doomed or t.uid in doomed)]
        for t in moved:
            self.edge_queue.remove(t)
            t.gems_rescheduled = True
            self.stats[m.name].gems_rescheduled += 1
            self._triggers[t.uid] = self.now
            self.cloud_pending.insert(
                self._bisect_trigger(self.now), t)
        if moved:
            self._cloud_dispatch()

    def _bisect_trigger(self, trig: float) -> int:
        i = 0
        while i < len(self.cloud_pending) and \
                self._triggers[self.cloud_pending[i].uid] <= trig:
            i += 1
        return i

    # ------------------------------------------------------------------
    # main loop
    # ------------------------------------------------------------------
    def prime(self) -> None:
        """Push every arrival onto the event heap (call exactly once)."""
        for a in self.arrivals:
            self._push(a.time, "arrival", a)
        for start, end in self.edge_down_windows:
            self._push(start, "edge_crash", None)
            self._push(end, "edge_restart", None)

    def _handle(self, time: float, kind: str, data: object) -> None:
        self.now = time
        if kind == "arrival":
            a: Arrival = data  # type: ignore[assignment]
            self._uid += 1
            task = Task(uid=self._uid, model=a.model,
                        created=a.time, drone=a.drone)
            self.tasks.append(task)
            self.stats[a.model.name].generated += 1
            self._route(task)
        elif kind == "edge_done":
            task = data  # type: ignore[assignment]
            self.edge_current = None
            self._finish(task, "edge")
            self._edge_dispatch()
        elif kind == "cloud_done":
            task, dur = data  # type: ignore[misc]
            self.cloud_inflight -= 1
            if self.policy.adaptive:
                self.adaptive[task.model.name].observe(dur)
            self._finish(task, "cloud")
            self._cloud_dispatch()
        elif kind == "cloud_check":
            self._cloud_dispatch()
        elif kind == "edge_crash":
            # scheduler crash: every queued task is lost at once (clear
            # first — dropping can fire a GEMS rescan over the queue),
            # the in-flight kernel still completes, nothing is admitted
            # until restart
            self.edge_down = True
            flushed = self.edge_queue
            self.edge_queue = []
            for t in flushed:
                self._drop(t)
        elif kind == "edge_restart":
            self.edge_down = False
            self._edge_dispatch()

    def run_until(self, t: float) -> None:
        """Drain events up to and including time ``t`` (lockstep slices:
        the multi-edge :class:`FleetOracle` interleaves these with
        cross-edge exchanges)."""
        while self._heap and self._heap[0][0] <= t:
            time, _, kind, data = heapq.heappop(self._heap)
            self._handle(time, kind, data)

    def finalize(self) -> Results:
        self.now = self.duration
        for name, wm in self.windows.items():
            self._close_windows(self.profiles[name], until=self.duration + 1)
        return Results(policy=self.policy.name, duration=self.duration,
                       per_model=self.stats, edge_busy=self.edge_busy_total)

    def run(self) -> Results:
        self.prime()
        self.run_until(float("inf"))
        return self.finalize()


def run_policy(policy: Policy, arrivals: list[Arrival], duration: float,
               **kw) -> Results:
    return Simulator(policy, arrivals, duration, **kw).run()


class FleetOracle:
    """Multi-edge oracle: per-edge :class:`Simulator`\\ s in lockstep.

    Runs every edge's event heap in ``dt`` slices and, between slices,
    exchanges tasks across edges exactly like the fleet simulator's
    :func:`repro_torch.sim.fleet.peer_offload` — so ``*-COOP`` policies get
    oracle validation like every silo branch.  Each round picks the
    worst-min-slack edge among those holding an exportable task (queued,
    slack below ``slack_ms``, still feasible appended behind the
    least-loaded other edge), moves that edge's worst-slack feasible task
    to the least-loaded peer, and repeats up to ``max_transfers`` times
    per slice.

    With ``max_transfers == 0`` (or one edge) no exchange ever fires and
    results are identical to running each :class:`Simulator` to
    completion on its own — the existing silo oracle path.
    """

    def __init__(self, sims: list[Simulator], duration: float, *,
                 dt: float = 25.0, slack_ms: float = 0.0,
                 max_transfers: int = 0):
        self.sims = sims
        self.duration = duration
        self.dt = dt
        self.slack_ms = slack_ms
        self.max_transfers = max_transfers
        self.peer_moved = 0

    # -- fleet peer_offload mirrors (oracle-native quantities) ----------
    def _slacks(self, sim: Simulator) -> list[float]:
        proj = sim._projected(sim.edge_queue)
        return [t.sched_deadline - c
                for t, c in zip(sim.edge_queue, proj)]

    def _load(self, sim: Simulator, now: float) -> float:
        busy = max(sim.edge_busy_until - now, 0.0)
        return busy + sum(t.model.t_edge for t in sim.edge_queue)

    def _adopt(self, dst: Simulator, task: Task) -> None:
        """Give the destination edge the state a foreign task needs."""
        m = task.model
        if m.name not in dst.profiles:
            dst.profiles[m.name] = m
            dst.min_edge_t = min(dst.min_edge_t or m.t_edge, m.t_edge)
            dst.adaptive[m.name] = AdaptiveEstimator(static=m.t_cloud)
            dst.stats[m.name] = ModelStats()
            if m.qoe_alpha > 0:
                dst.windows[m.name] = _WindowState(m.qoe_window)

    def _one_transfer(self, now: float) -> bool:
        sims = self.sims
        n = len(sims)
        slacks = [self._slacks(s) for s in sims]
        min_slack = [min(sl, default=float("inf")) for sl in slacks]
        # crashed edges can neither export (their queue was flushed) nor
        # import — infinite load keeps them out of every min() below,
        # mirroring the fleet's ``edge_valid = valid & edge_up`` gate
        load = [float("inf") if s.edge_down else self._load(s, now)
                for s in sims]

        # each edge's best destination load: the global minimum, or the
        # runner-up for the least-loaded edge itself
        lead = min(range(n), key=lambda e: load[e])
        runner_up = min((load[e] for e in range(n) if e != lead),
                        default=float("inf"))
        dst_load = [runner_up if e == lead else load[lead]
                    for e in range(n)]
        exportable = [
            any(sl < self.slack_ms
                and now + dst_load[e] + t.model.t_edge <= t.sched_deadline
                for t, sl in zip(sims[e].edge_queue, slacks[e]))
            for e in range(n)]
        over = [e for e in range(n)
                if min_slack[e] < self.slack_ms and exportable[e]]
        if not over:
            return False
        src = min(over, key=lambda e: min_slack[e])
        dst = min((e for e in range(n) if e != src),
                  key=lambda e: load[e])
        # worst-slack task still feasible behind the destination's load
        cands = [(sl, i) for i, (t, sl) in enumerate(
            zip(sims[src].edge_queue, slacks[src]))
            if sl < self.slack_ms
            and now + load[dst] + t.model.t_edge <= t.sched_deadline]
        if not cands:
            return False
        _, vi = min(cands)
        task = sims[src].edge_queue.pop(vi)
        self._adopt(sims[dst], task)
        sims[dst]._edge_insert(task, sims[dst]._insert_pos(task))
        self.peer_moved += 1
        return True

    def run(self) -> list[Results]:
        for sim in self.sims:
            sim.prime()
        n_slices = max(1, round(self.duration / self.dt))
        coop = self.max_transfers > 0 and len(self.sims) > 1
        for i in range(n_slices):
            t = min((i + 1) * self.dt, self.duration)
            for sim in self.sims:
                sim.run_until(t)
                sim.now = max(sim.now, t)
            if coop:
                for _ in range(self.max_transfers):
                    if not self._one_transfer(t):
                        break
        for sim in self.sims:     # drain in-flight work past the horizon
            sim.run_until(float("inf"))
        return [sim.finalize() for sim in self.sims]
