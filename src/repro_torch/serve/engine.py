"""Real-time serving engine: the paper's scheduler over live PyTorch
inference.

Port of ``repro.serve.engine``, the §8.8 field-validation analogue:
tasks are actual forward passes of zoo models on the card (or, with
``device="cpu"``, on the host).  The runtime mirrors the paper's
architecture (§3.3):

* an **edge executor** — one synchronous worker thread pulling from an
  EDF priority queue;
* a **cloud executor** — a pool of threads whose calls run the same
  model but pay a shaped network delay (``sim/network.py``), i.e. FaaS
  semantics;
* the **task scheduler** applying a ``core.schedulers`` Policy verbatim
  (E+C / DEM / DEMS / DEMS-A / GEMS) — admission, migration scoring, work
  stealing via trigger times, adaptation, window rescheduling.

On the card a payload is one CUDA-graph replay of the model's captured
forward (:class:`GraphForward`), as the reference's is one jitted
dispatch.  All threads replay onto the card's current stream (PyTorch's
default stream, shared by every host thread), as the JAX package's
threads share one device queue: a ``run()`` ends in a stream
synchronize, so it waits for the work the other threads queued before it
as well as its own.

Timestamps are wall-clock milliseconds; results aggregate into the same
per-model stats as the simulator.
"""
from __future__ import annotations

import collections
import dataclasses
import heapq
import threading
import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch import resolve_device, warm_and_capture
from repro_torch.core.schedulers import AdaptiveEstimator, Policy
from repro_torch.core.task import ModelProfile, Outcome, Task
from repro_torch.sim.engine import ModelStats, Results
from repro_torch.sim.network import CloudLatencyModel


def _now_ms() -> float:
    return time.monotonic() * 1e3


class GraphForward:
    """A model's forward on the card, captured once as a CUDA graph: the
    port's counterpart of the reference's one jitted dispatch.

    Built from ``fwd`` (a zero-arg eager forward returning logits): one
    eager forward on a side stream under
    ``torch.cuda.set_sync_debug_mode("error")`` (it warms the kernels and
    fails on any host sync in the path), then the capture, on a side
    stream into its own graph memory pool.  A capture that fails raises:
    there is no eager path on the card.

    ``__call__`` replays the graph on the current stream, copies the
    logits out of the graph's static buffer and synchronizes, all under a
    lock: the serve engine calls one model from its edge thread and its
    cloud threads at once, and the lock keeps one replay from overwriting
    the logits another caller is copying.  ``replays`` counts the calls;
    the kernel wrappers' launch counters saw the warm forward and the
    capture (each counts its Python calls), never a replay.
    """

    eager_forwards = 1          # the sync-checked warm forward
    captures = 1

    def __init__(self, fwd: Callable[[], torch.Tensor], device):
        self.fwd = fwd
        self.device = device
        self.replays = 0
        self._lock = threading.Lock()
        cap = warm_and_capture(fwd, device)
        self.graph, self._logits = cap.graph, cap.out

    def __call__(self) -> torch.Tensor:
        with self._lock:
            self.graph.replay()
            logits = self._logits.clone()
            self.replays += 1
            torch.cuda.current_stream(self.device).synchronize()
        return logits


@dataclasses.dataclass
class ServableModel:
    """A registered DNN: profile + a zero-arg blocking invocation."""

    profile: ModelProfile
    run: Callable[[], object]          # blocking inference call
    graph: Optional[GraphForward] = None   # the captured forward (card)

    @classmethod
    def from_arch(cls, profile: ModelProfile, cfg, batch: int = 1,
                  seq: int = 32, seed: int = 0,
                  device="cuda") -> "ServableModel":
        """Wrap a zoo model's forward pass as the task payload.

        Parameters and tokens come from one ``torch.Generator`` seeded with
        ``seed`` on ``device``.  On the card the forward is captured as a
        :class:`GraphForward` (the payload's tokens are fixed, so its
        inputs are static) and ``run()`` replays it and ends in a
        synchronize of the current stream, the counterpart of ``jax.jit``
        plus ``block_until_ready``.  On the CPU, which the caller asked
        for, ``run()`` is the eager forward, warmed by one call.
        """
        from repro_torch.models.model import Model
        dev = resolve_device(device)
        model = Model(cfg, dev)
        gen = torch.Generator(device=dev).manual_seed(seed)
        params = model.init(gen)
        tokens = torch.randint(0, cfg.vocab, (batch, seq), generator=gen,
                               device=dev)
        b = {"tokens": tokens}
        if cfg.family == "encdec":
            b["frames"] = torch.zeros((batch, cfg.n_frames, cfg.d_model),
                                      device=dev)
        if cfg.family == "vlm":
            b["patches"] = torch.zeros((batch, cfg.n_image_tokens,
                                        cfg.d_model), device=dev)

        def fwd():
            return model.forward(params, b)[0]

        if dev.type == "cuda":
            graph = GraphForward(fwd, dev)
            return cls(profile=profile, run=graph, graph=graph)
        fwd()                                     # warm call
        return cls(profile=profile, run=fwd)


class ServeEngine:
    """Edge+cloud inference service under a paper policy."""

    def __init__(self, policy: Policy, models: dict[str, ServableModel], *,
                 cloud_concurrency: int = 4,
                 cloud_model: Optional[CloudLatencyModel] = None,
                 seed: int = 0):
        self.policy = policy
        self.models = models
        self.cloud_net = cloud_model or CloudLatencyModel()
        self.rng = np.random.default_rng(seed)
        self.adaptive = {n: AdaptiveEstimator(static=m.profile.t_cloud)
                         for n, m in models.items()}
        self.stats = {n: ModelStats() for n in models}
        # flight-recorder samples for metrics_snapshot(): bounded ring
        # buffers of per-task completion latency and deadline slack (ms)
        self._lat_samples = collections.deque(maxlen=4096)
        self._slack_samples = collections.deque(maxlen=4096)
        self._lock = threading.RLock()
        self._edge_q: list[tuple[float, int, Task]] = []
        self._cloud_q: list[tuple[float, int, Task]] = []
        self._seq = 0
        self._uid = 0
        self._stop = threading.Event()
        self._edge_kick = threading.Condition(self._lock)
        self._t0 = _now_ms()
        self.min_edge_t = min(m.profile.t_edge for m in models.values())
        self._edge_thread = threading.Thread(target=self._edge_loop,
                                             daemon=True)
        self._cloud_threads = [
            threading.Thread(target=self._cloud_loop, daemon=True)
            for _ in range(cloud_concurrency)]

    # ------------------------------------------------------------------
    def start(self):
        self._edge_thread.start()
        for t in self._cloud_threads:
            t.start()

    def stop(self):
        """Stop the executors and wait for them to return: a task in
        flight finishes first.  (A thread left inside a PyTorch call when
        the interpreter exits aborts the process.)"""
        self._stop.set()
        with self._edge_kick:
            self._edge_kick.notify_all()
        for t in (self._edge_thread, *self._cloud_threads):
            if t.is_alive():
                t.join()

    def now(self) -> float:
        return _now_ms() - self._t0

    def _t_cloud(self, name: str) -> float:
        if self.policy.adaptive:
            return self.adaptive[name].current
        return self.models[name].profile.t_cloud

    # ------------------------------------------------------------------
    # submission (task scheduler thread, §3.3/§5)
    # ------------------------------------------------------------------
    def submit(self, model_name: str, created: Optional[float] = None
               ) -> Task:
        m = self.models[model_name].profile
        with self._lock:
            self._uid += 1
            task = Task(uid=self._uid, model=m,
                        created=self.now() if created is None else created)
            self.stats[model_name].generated += 1
            self._route(task)
        return task

    def _route(self, task: Task) -> None:
        now = self.now()
        pos, feasible = self._edge_feasible(task, now)
        if feasible:
            if self.policy.migration:
                victims = self._victims(pos, task, now)
                if victims and not self.policy.migration_decision(
                        task, victims, now, lambda m: self._t_cloud(m.name)):
                    self._offer_cloud(task) or self._drop(task)
                    return
                for v in victims:
                    self._edge_remove(v)
                    v.migrated = True
                    self.stats[v.model.name].migrated += 1
                    self._offer_cloud(v) or self._drop(v)
            self._edge_insert(task)
        else:
            self._offer_cloud(task) or self._drop(task)

    def _edge_items(self) -> list[Task]:
        return [t for _, _, t in sorted(self._edge_q)]

    def _edge_feasible(self, task: Task, now: float):
        key = self.policy.edge_key(task)
        items = self._edge_items()
        ahead = [t for t in items if self.policy.edge_key(t) <= key]
        wait = sum(t.model.t_edge for t in ahead)
        pos = len(ahead)
        return pos, now + wait + task.model.t_edge <= task.sched_deadline

    def _victims(self, pos: int, task: Task, now: float) -> list[Task]:
        items = self._edge_items()
        cur = now
        proj = []
        for t in items:
            cur += t.model.t_edge
            proj.append(cur)
        out = []
        for i in range(pos, len(items)):
            t = items[i]
            if proj[i] <= t.sched_deadline < proj[i] + task.model.t_edge:
                out.append(t)
        return out

    def _edge_insert(self, task: Task) -> None:
        self._seq += 1
        heapq.heappush(self._edge_q,
                       (self.policy.edge_key(task), self._seq, task))
        with self._edge_kick:
            self._edge_kick.notify()

    def _edge_remove(self, task: Task) -> None:
        self._edge_q = [(k, s, t) for k, s, t in self._edge_q
                        if t.uid != task.uid]
        heapq.heapify(self._edge_q)

    def _offer_cloud(self, task: Task) -> bool:
        acc = self.policy.offer_cloud(task, self.now(),
                                      self._t_cloud(task.model.name))
        if not acc.accept:
            if self.policy.adaptive:
                self.adaptive[task.model.name].on_skip(self.now())
            return False
        task.steal_only = acc.steal_only
        self._seq += 1
        heapq.heappush(self._cloud_q, (acc.trigger, self._seq, task))
        return True

    def _drop(self, task: Task) -> bool:
        task.outcome = Outcome.DROPPED
        task.finished = self.now()
        self.stats[task.model.name].dropped += 1
        self._after_completion(task, success=False)
        return True

    # ------------------------------------------------------------------
    # executors
    # ------------------------------------------------------------------
    def _edge_loop(self) -> None:
        while not self._stop.is_set():
            task = None
            with self._lock:
                now = self.now()
                while self._edge_q:
                    head = self._edge_q[0][2]
                    if now + head.model.t_edge > head.sched_deadline:
                        heapq.heappop(self._edge_q)
                        self._drop(head)
                    else:
                        break
                if self.policy.stealing:
                    task = self._try_steal(now)
                if task is None and self._edge_q:
                    task = heapq.heappop(self._edge_q)[2]
            if task is None:
                with self._edge_kick:
                    self._edge_kick.wait(timeout=0.005)
                continue
            self.models[task.model.name].run()        # synchronous inference
            self._finish(task, "edge")

    def _try_steal(self, now: float) -> Optional[Task]:
        if self._edge_q:
            head = self._edge_q[0][2]
            slack = head.abs_deadline - (now + head.model.t_edge)
            if slack <= self.min_edge_t:
                return None
            items = self._edge_items()
            cur = now
            margins = []
            for t in items:
                cur += t.model.t_edge
                margins.append(t.sched_deadline - cur)
            max_delay = min(margins)
            if max_delay <= 0:
                return None
        else:
            max_delay = float("inf")
        best, best_key = None, None
        for trig, s, c in self._cloud_q:
            if c.model.t_edge <= max_delay and \
                    now + c.model.t_edge <= c.abs_deadline:
                key = (not c.steal_only, -c.model.steal_rank())
                if best is None or key < best_key:
                    best, best_key = (trig, s, c), key
        if best is None:
            return None
        self._cloud_q.remove(best)
        heapq.heapify(self._cloud_q)
        best[2].stolen = True
        self.stats[best[2].model.name].stolen += 1
        return best[2]

    def _cloud_loop(self) -> None:
        while not self._stop.is_set():
            task = None
            with self._lock:
                now = self.now()
                if self._cloud_q and self._cloud_q[0][0] <= now:
                    task = heapq.heappop(self._cloud_q)[2]
                    if task.steal_only:
                        self._drop(task)
                        task = None
                    else:
                        est = self._t_cloud(task.model.name)
                        if now + est > task.abs_deadline:
                            self._drop(task)
                            if self.policy.adaptive:
                                self.adaptive[task.model.name].on_skip(now)
                            task = None
                        elif self.policy.adaptive:
                            self.adaptive[task.model.name].on_sent()
            if task is None:
                time.sleep(0.002)
                continue
            t_start = self.now()
            delay = self.cloud_net.shaped_delta(t_start) + \
                max(0.0, float(self.rng.normal(30.0, 10.0)))  # RTT jitter
            # shaped_delta is signed (above-nominal bandwidth speeds the
            # transfer up), so the sum can go below zero — sleep() can't
            time.sleep(max(delay, 0.0) / 1e3)
            self.models[task.model.name].run()
            if self.policy.adaptive:
                self.adaptive[task.model.name].observe(
                    self.now() - t_start)
            self._finish(task, "cloud")

    # ------------------------------------------------------------------
    def _finish(self, task: Task, where: str) -> None:
        with self._lock:
            task.finished = self.now()
            ok = task.finished <= task.abs_deadline
            st = self.stats[task.model.name]
            if where == "edge":
                task.outcome = Outcome.EDGE_SUCCESS if ok else \
                    Outcome.EDGE_MISS
                st.edge_success += ok
                st.edge_miss += (not ok)
                st.edge_utility += task.utility()
            else:
                task.outcome = Outcome.CLOUD_SUCCESS if ok else \
                    Outcome.CLOUD_MISS
                st.cloud_success += ok
                st.cloud_miss += (not ok)
                st.cloud_utility += task.utility()
            st.qos_utility += task.utility()
            if ok:
                self._lat_samples.append(task.finished - task.created)
                self._slack_samples.append(task.abs_deadline - task.finished)
            self._after_completion(task, success=ok)

    def _after_completion(self, task: Task, success: bool) -> None:
        """GEMS window accounting (Alg. 1) on each completion/drop."""
        if not self.policy.gems or task.model.qoe_alpha <= 0:
            return
        # window state piggybacks on ModelStats via simple counters
        st = self.stats[task.model.name]
        if not hasattr(st, "_win"):
            st._win = [task.model.qoe_window, 0, 0]   # end, lam, lam_hat
        win = st._win
        now = self.now()
        while now > win[0]:
            if win[1] > 0:
                st.windows_total += 1
                if win[2] / win[1] >= task.model.qoe_alpha:
                    st.windows_met += 1
                    st.qoe_utility += task.model.qoe_beta
            win[0] += task.model.qoe_window
            win[1] = win[2] = 0
        win[1] += 1
        win[2] += success
        if win[2] / win[1] < task.model.qoe_alpha and \
                task.model.gamma_cloud > 0:
            est = self._t_cloud(task.model.name)
            moved = [(k, s, t) for k, s, t in self._edge_q
                     if t.model.name == task.model.name
                     and now + est <= t.abs_deadline]
            for item in moved:
                self._edge_q.remove(item)
                t = item[2]
                t.gems_rescheduled = True
                st.gems_rescheduled += 1
                self._seq += 1
                heapq.heappush(self._cloud_q, (now, self._seq, t))
            if moved:
                heapq.heapify(self._edge_q)

    # ------------------------------------------------------------------
    def metrics_snapshot(self) -> dict:
        """Live observability endpoint: the flight recorder's serve twin.

        One lock-protected read returning the scoreboard the reference's
        flight recorder computes for the simulator — per-model outcome counts and QoE success
        frequencies, queue depths, and p50/p95/p99 completion-latency /
        deadline-slack percentiles over a bounded window of recent
        completions.  Cheap enough to poll from a control plane.
        """
        with self._lock:
            per_model = {}
            hit = miss = drop = 0
            for n, st in self.stats.items():
                ok = st.edge_success + st.cloud_success
                bad = st.edge_miss + st.cloud_miss
                settled = ok + bad + st.dropped
                per_model[n] = dict(
                    generated=st.generated, hit=ok, miss=bad,
                    dropped=st.dropped, stolen=st.stolen,
                    migrated=st.migrated,
                    qoe_frequency=ok / settled if settled else None)
                hit, miss, drop = hit + ok, miss + bad, drop + st.dropped
            lat = np.asarray(self._lat_samples, dtype=np.float64)
            slack = np.asarray(self._slack_samples, dtype=np.float64)

            def pcts(a):
                if a.size == 0:
                    return {f"p{q:g}": None for q in (50, 95, 99)}
                return {f"p{q:g}": float(np.percentile(a, q))
                        for q in (50, 95, 99)}

            settled = max(hit + miss + drop, 1)
            return dict(
                now_ms=self.now(), policy=self.policy.name,
                hit=hit, miss=miss, dropped=drop,
                hit_rate=hit / settled,
                edge_queue_depth=len(self._edge_q),
                cloud_queue_depth=len(self._cloud_q),
                latency_ms=pcts(lat), slack_ms=pcts(slack),
                window=dict(latency_samples=int(lat.size),
                            slack_samples=int(slack.size)),
                per_model=per_model,
                qos_utility=sum(st.qos_utility
                                for st in self.stats.values()),
                qoe_utility=sum(st.qoe_utility
                                for st in self.stats.values()))

    def results(self, duration_ms: float) -> Results:
        busy = sum((st.edge_success + st.edge_miss) *
                   self.models[n].profile.t_edge
                   for n, st in self.stats.items())
        return Results(policy=self.policy.name, duration=duration_ms,
                       per_model=self.stats, edge_busy=busy)


def run_stream(engine: ServeEngine, fps: dict[str, float],
               duration_ms: float) -> Results:
    """Drive a frame stream: submit each model at its FPS for the duration."""
    engine.start()
    t_end = duration_ms
    next_at = {n: 0.0 for n in fps}
    while engine.now() < t_end:
        now = engine.now()
        for n, f in fps.items():
            if now >= next_at[n]:
                engine.submit(n)
                next_at[n] += 1000.0 / f
        time.sleep(0.002)
    # drain
    time.sleep(0.3)
    engine.stop()
    return engine.results(duration_ms)
