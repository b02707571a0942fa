"""Fleet-scale scheduler simulation (paper §8.6) as one batched PyTorch
tick program.

Port of ``repro.sim.fleet_jax``.  The JAX tick is written for
one edge and vmapped over the fleet and, in a batch, over replicas; here
every :class:`EdgeState` leaf carries explicit leading axes — ``[E]`` for
one fleet, ``[R, E]`` for R replicas of it — and each tick is one pass of
batched tensor operations over all of them, so every launch covers every
edge of every replica.  There is one tick function for both: it reduces
over trailing axes only, and the per-replica values it meets (``now``,
``cloud_up``, the :class:`PolicyParams` flags, ``min(t_edge)``) are
per-edge values, 0-d for one fleet and ``[R, 1]`` with a replica axis;
model tables are ``[M]``, or ``[R, 1, M]`` per replica (a padded,
heterogeneous batch).  The replicas of a batch never exchange work:
peer offload selects per replica.

Modeling (identical to the reference, documented there): a fixed time
step ``dt``; deterministic execution fractions (edge ``edge_frac·t``,
cloud ``cloud_frac·t̂ + θ(t) + bw-penalty``) scaled by the sampled
``exec_jit`` lane; a finite per-edge cloud pool with a depth-aware
queue-wait estimate; estimator and offer events batched per tick.

Policy flags are runtime tensors (:class:`PolicyParams`) read only
through ``torch.where``: one tick program serves every policy.  Nothing
inside a tick synchronises with the host (no ``.item()``, no boolean-mask
indexing, no branch on a tensor), so on the card a window of ticks runs
as a CUDA graph: :func:`_fleet_program` keeps one program per set of
statics in a bounded LRU (the reference's jit cache), and each program a
graph per shape key, captured on the key's first window and replayed on
every later one (:class:`TickProgram`).  The only kernel on the path is
the masked arg-extremum of :mod:`repro_torch.kernels.sched_ops`
(stealing, export and peer-offload selection), which runs the
hand-written CUDA kernel on the card, inside the graphs.

Every entry point takes ``trace=`` (:class:`repro_torch.obs.trace.
TraceSpec`), the flight recorder: read-only taps of the tick emit the
per-tick decision counters and/or the adapted-t̂ stream beside the final
state (:class:`FleetResult`).  With it off the tick launches exactly what
it launched before the recorder existed; with it on the final state is
bit-identical.  Host aggregation lives in :mod:`repro_torch.obs.metrics`.
The batch entry points (:func:`run_fleet_batch`, :func:`build_fleet_batch`
/ :func:`plan_buckets` / :func:`run_batch`) run many scenarios, policies
and seeds under one set of launches a tick.

``mesh=`` (a :class:`~torch.distributed.device_mesh.DeviceMesh`, one
process a rank) splits a run over ranks as the reference's ``_put``
places it: ``run_fleet`` its edges over the first mesh axis, a batch its
replicas over the first and, on a 2-D mesh, its edges over the second;
an axis that does not divide its dimension leaves it whole.  Each rank
runs its block with the same tick; the one step that reads across edges,
peer offload, all-gathers what it reads (:func:`_offload_across`), and the
result is gathered whole on every rank, bitwise the unsharded run's.  A
mesh axis of 1 splits nothing and launches nothing more.
"""
from __future__ import annotations

import collections
import dataclasses
import weakref
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch import graph_nodes, resolve_device
from repro_torch.core import sched as js
from repro_torch.core import schedulers as _sched
from repro_torch.kernels import sched_ops
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.prof import count, span
from repro_torch.obs.trace import (TickCounters, TraceSpec, hist_counts,
                                   resolve_spec, zero_counters)
from repro_torch.sim import network

EDGE_CAP = 32
CLOUD_CAP = 64
SUBSTEPS = 6      # max edge executor actions (drops/starts) per tick
CLOUD_SLOTS = 16  # default per-edge FaaS share (engine's cloud_concurrency)

_FLEET_POLICY_NAMES = tuple(_sched._POLICIES)
_FLEET_FLAGS = ("migration", "stealing", "gems", "adaptive", "use_cloud",
                "use_edge", "edge_feasibility_check", "edge_priority",
                "cloud_accepts_negative", "sota1", "sota2", "gems_budget")
_FLEET_POLICIES = {
    name: {k: v for k, v in _sched._POLICIES[name].items()
           if k in _FLEET_FLAGS}
    for name in _FLEET_POLICY_NAMES
}

_col = js._col
_I32 = torch.int32


class PolicyParams(NamedTuple):
    """Policy flags as 0-d device tensors (read through ``torch.where``),
    ``[R]`` for a heterogeneous batch."""

    migration: torch.Tensor        # bool[]
    stealing: torch.Tensor         # bool[]
    gems: torch.Tensor             # bool[]
    use_cloud: torch.Tensor        # bool[]
    use_edge: torch.Tensor         # bool[]  False → CLD (cloud-only routing)
    feas_check: torch.Tensor       # bool[]  False → EDF/HPF unconditional
    edge_prio: torch.Tensor        # i32[]   sched.PRIO_{EDF,HPF,SJF}
    cloud_neg_ok: torch.Tensor     # bool[]  SJF-E+C sends γ^C≤0 tasks anyway
    sota1: torch.Tensor            # bool[]  Kalmia/D3 urgency routing (§8.2)
    sota2: torch.Tensor            # bool[]  Dedas ACT routing (§8.2)
    gems_budget: torch.Tensor      # bool[]  GEMS-B winnability gate
    urgent_deadline: torch.Tensor  # f32[]   SOTA1 urgency threshold [ms]
    adaptive: torch.Tensor         # bool[]
    cooperation: torch.Tensor      # bool[]
    cloud_margin: torch.Tensor     # f32[]
    adapt_eps: torch.Tensor        # f32[]
    adapt_cooling_ms: torch.Tensor  # f32[]
    coop_slack_ms: torch.Tensor    # f32[]
    coop_transfer_cap: torch.Tensor  # i32[] (≤ the program's static rounds)
    cloud_give_up_ms: torch.Tensor  # f32[] parked-dispatch timeout


@dataclasses.dataclass(frozen=True)
class FleetPolicy:
    """Policy flags; lowered to :class:`PolicyParams` by :meth:`params`.
    ``adapt_window`` (a buffer shape) and ``coop_max_transfers`` (a loop
    bound) stay host-side static."""

    migration: bool = False
    stealing: bool = False
    gems: bool = False
    use_cloud: bool = True
    use_edge: bool = True
    edge_feasibility_check: bool = True
    edge_priority: str = "edf"            # "edf" | "hpf" | "sjf"
    cloud_accepts_negative: bool = False
    sota1: bool = False
    sota2: bool = False
    gems_budget: bool = False
    urgent_deadline: float = 700.0
    cloud_margin: float = 50.0
    adaptive: bool = False
    adapt_window: int = 10
    adapt_eps: float = 10.0
    adapt_cooling_ms: float = 10_000.0
    cooperation: bool = False
    coop_slack_ms: float = 0.0
    coop_max_transfers: int = 2
    cloud_give_up_ms: float = float("inf")

    @classmethod
    def from_name(cls, name: str) -> "FleetPolicy":
        coop = name.endswith("-COOP")
        base_name = name[: -len("-COOP")] if coop else name
        if base_name not in _FLEET_POLICIES:
            supported = sorted(_FLEET_POLICIES) + sorted(
                n + "-COOP" for n in _FLEET_POLICIES)
            raise ValueError(f"unknown fleet policy {name!r}; choose from "
                             f"{supported}")
        base = cls(**_FLEET_POLICIES[base_name])
        return dataclasses.replace(base, cooperation=True) if coop else base

    def params(self, device="cuda") -> PolicyParams:
        dev = resolve_device(device)
        prio = {"edf": js.PRIO_EDF, "hpf": js.PRIO_HPF,
                "sjf": js.PRIO_SJF}[self.edge_priority]

        def b(v):
            return torch.tensor(bool(v), device=dev)

        def f(v):
            return torch.tensor(v, dtype=torch.float32, device=dev)

        def i(v):
            return torch.tensor(v, dtype=torch.int32, device=dev)

        return PolicyParams(
            migration=b(self.migration), stealing=b(self.stealing),
            gems=b(self.gems), use_cloud=b(self.use_cloud),
            use_edge=b(self.use_edge),
            feas_check=b(self.edge_feasibility_check), edge_prio=i(prio),
            cloud_neg_ok=b(self.cloud_accepts_negative),
            sota1=b(self.sota1), sota2=b(self.sota2),
            gems_budget=b(self.gems_budget),
            urgent_deadline=f(self.urgent_deadline),
            adaptive=b(self.adaptive), cooperation=b(self.cooperation),
            cloud_margin=f(self.cloud_margin), adapt_eps=f(self.adapt_eps),
            adapt_cooling_ms=f(self.adapt_cooling_ms),
            coop_slack_ms=f(self.coop_slack_ms),
            coop_transfer_cap=i(self.coop_max_transfers),
            cloud_give_up_ms=f(self.cloud_give_up_ms))


class Profiles(NamedTuple):
    """Array-of-struct model table (M models), shared by every edge;
    ``[R, M]`` leaves for a heterogeneous batch."""

    t_edge: torch.Tensor
    t_cloud: torch.Tensor
    deadline: torch.Tensor
    gamma_e: torch.Tensor
    gamma_c: torch.Tensor
    cost_e: torch.Tensor
    cost_c: torch.Tensor
    steal_rank: torch.Tensor
    qoe_alpha: torch.Tensor
    qoe_beta: torch.Tensor
    qoe_window: torch.Tensor

    @classmethod
    def build(cls, models, device="cuda",
              pad_to: Optional[int] = None) -> "Profiles":
        """The table of ``models`` (any objects with the
        :class:`~repro_torch.core.task.ModelProfile` attributes).
        ``pad_to`` appends inert models for a padded batch: huge
        latencies, deadline and window keep ``min(t_edge)`` (the stealing
        gate) and window expiry untouched, zero utilities keep every
        masked sum exact."""
        dev = resolve_device(device)
        cols = dict(
            t_edge=[m.t_edge for m in models],
            t_cloud=[m.t_cloud for m in models],
            deadline=[m.deadline for m in models],
            gamma_e=[m.gamma_edge for m in models],
            gamma_c=[m.gamma_cloud for m in models],
            cost_e=[m.cost_edge for m in models],
            cost_c=[m.cost_cloud for m in models],
            steal_rank=[m.steal_rank() for m in models],
            qoe_alpha=[m.qoe_alpha for m in models],
            qoe_beta=[m.qoe_beta for m in models],
            qoe_window=[m.qoe_window for m in models])
        width = 0 if pad_to is None else max(pad_to - len(models), 0)
        pad_val = dict(t_edge=js.POS, t_cloud=js.POS, deadline=js.POS,
                       qoe_window=js.POS)
        return cls(**{k: torch.as_tensor(np.asarray(
            v + [pad_val.get(k, 0.0)] * width, np.float32)).to(dev)
            for k, v in cols.items()})


class EdgeState(NamedTuple):
    """Per-edge scheduler state; every leaf leads with the edge axis E
    (``[R, E]`` with a replica axis)."""

    eq: js.EdgeQueue
    cq: js.CloudQueue
    cq_model: torch.Tensor       # i32[E, Qc] model ids of cloud-queued tasks
    busy_rem: torch.Tensor       # f32[E] remaining edge execution time
    # finite FaaS pool: busy-until time per cloud slot (free iff <= now)
    cloud_busy_until: torch.Tensor  # f32[E, S]
    n_slots: torch.Tensor        # i32[E] real pool depth
    # cloud-queue entries that have waited for a saturated pool at least
    # once re-run the dispatch-time JIT check when their slot frees
    cq_blocked: torch.Tensor     # bool[E, Qc]
    seq: torch.Tensor            # i32[E] insertion counter
    n_success: torch.Tensor      # i32[E, M]
    n_miss: torch.Tensor         # i32[E, M]
    n_drop: torch.Tensor         # i32[E, M]
    n_stolen: torch.Tensor       # i32[E, M]
    n_edge_exec: torch.Tensor    # i32[E, M] tasks executed on the edge
    qos_utility: torch.Tensor    # f32[E]
    lam: torch.Tensor            # i32[E, M] GEMS window events
    lam_hat: torch.Tensor        # i32[E, M] GEMS window successes
    prev_lam: torch.Tensor       # i32[E, M] previous window's events
    win_end: torch.Tensor        # f32[E, M]
    qoe_utility: torch.Tensor    # f32[E]
    windows_met: torch.Tensor    # i32[E, M]
    n_peer_out: torch.Tensor     # i32[E] tasks exported to a peer edge
    n_peer_in: torch.Tensor      # i32[E] tasks imported from a peer edge
    adapt: js.AdaptState         # DEMS-A per-model sliding-window t̂


class FleetResult(NamedTuple):
    """A fleet run with flight-recorder telemetry (``trace=TraceSpec``).

    ``t_hat`` carries ``adapt.current`` out of every tick, ``[T, E, M]``
    from :func:`run_fleet` and ``[R, T, E, M]`` from the batch entry
    points; ``counters`` the per-tick :class:`~repro_torch.obs.trace.
    TickCounters` (leaves ``[T, E, …]`` / ``[R, T, E, …]``).  Streams the
    :class:`~repro_torch.obs.trace.TraceSpec` did not ask for are
    ``None``.
    """

    final: EdgeState
    t_hat: Optional[torch.Tensor] = None          # f32[(R,) T, E, M]
    counters: Optional[TickCounters] = None       # [(R,) T, E, …] leaves


def _tr_add(tr: TickCounters, **deltas) -> TickCounters:
    """Accumulate this tick's trace contributions.  Callers tap only
    when the flight recorder is on, so the untraced tick launches
    nothing extra."""
    return tr._replace(**{k: getattr(tr, k) + v for k, v in deltas.items()})


def _count(mask: torch.Tensor) -> torch.Tensor:
    """True entries over the last axis, as the counters' int32."""
    return mask.sum(-1, dtype=_I32)


def init_state(prof: Profiles, n_edges: int, adapt_window: int = 10,
               cloud_slots: int = CLOUD_SLOTS,
               total_slots: Optional[int] = None) -> EdgeState:
    """Fresh stacked fleet state on ``prof``'s device (one replica's
    ``[M]`` table).  ``total_slots`` oversizes the busy-until array;
    slots beyond ``cloud_slots`` stay at +inf so they are never free."""
    dev = prof.t_edge.device
    m = prof.t_edge.shape[0]
    total = cloud_slots if total_slots is None else total_slots
    lead = (n_edges,)

    def zi(shape=(m,)):
        return torch.zeros(lead + shape, dtype=torch.int32, device=dev)

    busy = torch.where(torch.arange(total, device=dev) < cloud_slots, 0.0,
                       js.POS)
    return EdgeState(
        eq=js.empty_edge_queue(EDGE_CAP, lead, device=dev),
        cq=js.empty_cloud_queue(CLOUD_CAP, lead, device=dev),
        cq_model=zi((CLOUD_CAP,)),
        busy_rem=torch.zeros(lead, device=dev),
        cloud_busy_until=busy.expand(lead + (total,)).clone(),
        n_slots=torch.full(lead, cloud_slots, dtype=torch.int32, device=dev),
        cq_blocked=torch.zeros(lead + (CLOUD_CAP,), dtype=torch.bool,
                               device=dev),
        seq=zi(()),
        n_success=zi(), n_miss=zi(), n_drop=zi(), n_stolen=zi(),
        n_edge_exec=zi(), qos_utility=torch.zeros(lead, device=dev),
        lam=zi(), lam_hat=zi(), prev_lam=zi(),
        win_end=prof.qoe_window.expand(lead + (m,)).clone(),
        qoe_utility=torch.zeros(lead, device=dev), windows_met=zi(),
        n_peer_out=zi(()), n_peer_in=zi(()),
        adapt=js.adapt_init(prof.t_cloud, adapt_window, lead))


def _add_at(x: torch.Tensor, ids: torch.Tensor, vals) -> torch.Tensor:
    """Per-edge ``x.at[ids].add(vals)`` for one index per edge."""
    return x.scatter_add(-1, ids.long().unsqueeze(-1),
                         vals.to(x.dtype).unsqueeze(-1))


def _per_edge(pred: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """``pred`` (``a``'s leading axes) viewed to broadcast over ``a``'s
    trailing axes."""
    return pred.view(pred.shape + (1,) * (a.dim() - pred.dim()))


def _tree_where(pred: torch.Tensor, a, b):
    """Per-edge select between two state trees (``pred``: bool[E] or
    bool[R, E])."""
    if isinstance(a, tuple):
        return type(a)(*(_tree_where(pred, x, y) for x, y in zip(a, b)))
    return torch.where(_per_edge(pred, a), a, b)


def _pool_wait(st: EdgeState, now, busy_sorted=None) -> torch.Tensor:
    """Depth-aware queue wait for the next dispatch-bound task: the k-th
    order statistic of the busy-until times, k its cloud-queue position
    (identically zero while the pool has headroom).  ``busy_sorted`` may
    pass in the sorted busy-until times of the current pool."""
    if busy_sorted is None:
        busy_sorted = torch.sort(st.cloud_busy_until, dim=-1).values
    pending = (st.cq.valid & ~st.cq.steal_only).sum(-1)
    k = torch.minimum(pending, (st.n_slots - 1).long()).clamp(min=0)
    kth = busy_sorted.gather(-1, k.unsqueeze(-1)).squeeze(-1)
    return (kth - now).clamp(min=0.0)


def _free_slot_gate(busy_until, now, want) -> torch.Tensor:
    """Admit the first ``n_free`` wanting tasks, in slot order."""
    taken_before = torch.cumsum(want, -1) - want.long()
    return taken_before < (busy_until <= _col(now)).sum(-1, keepdim=True)


def _occupy_slots(busy_until, now, dispatch, end_time) -> torch.Tensor:
    """Dispatched task k (in queue order) fills the k-th free slot with its
    completion time; ``dispatch`` is already gated by
    :func:`_free_slot_gate`.  The reference's ``mode="drop"`` scatter
    becomes a scatter into one extra slot that is sliced off."""
    s = busy_until.shape[-1]
    drank = torch.cumsum(dispatch, -1) - dispatch.long()
    tgt = torch.where(dispatch & (drank < s), drank, s)
    end_by_rank = torch.zeros(busy_until.shape[:-1] + (s + 1,),
                              device=busy_until.device).scatter(
        -1, tgt, end_time)[..., :s]
    free = busy_until <= _col(now)
    frank = torch.cumsum(free, -1) - free.long()
    fill = free & (frank < dispatch.sum(-1, keepdim=True))
    return torch.where(fill, end_by_rank.gather(-1, frank), busy_until)


def _t_cloud_cur(st: EdgeState, prof: Profiles, pp: PolicyParams, now,
                 busy_sorted=None) -> torch.Tensor:
    """Current cloud-latency estimate t̂ per (edge, model) (§5.4) plus the
    finite-pool queue-wait estimate."""
    base = torch.where(_col(pp.adaptive), st.adapt.current, prof.t_cloud)
    return base + _pool_wait(st, now, busy_sorted).unsqueeze(-1)


class FleetSignals(NamedTuple):
    """Dense per-tick scenario signals driving the fleet simulator (a
    leading replica axis ``R`` on every field in a batch)."""

    times: torch.Tensor       # f32[T]      tick start times [ms]
    theta: torch.Tensor       # f32[T,E]    per-edge added WAN latency θ(t)
    bw: torch.Tensor          # f32[T,E]    per-edge cellular bandwidth
    arrive: torch.Tensor      # bool[T,E,M] model m arrives at edge e
    order: torch.Tensor       # i32[T,E,M]  randomized insertion order
    load_mult: torch.Tensor   # f32[T,E]    edge execution-time multiplier
    cloud_up: torch.Tensor    # bool[T]     cloud FaaS availability
    valid: torch.Tensor       # bool[T,E]   live cells (False ⇒ no-op)
    exec_jit: torch.Tensor    # f32[T,E,M,2] (edge, cloud) multipliers
    edge_up: torch.Tensor     # bool[T,E]   False ⇒ edge crashed
    link_up: torch.Tensor     # bool[T,E]   False ⇒ link partitioned


# ---------------------------------------------------------------------------
# per-tick logic, batched over the edge (and replica) axes
# ---------------------------------------------------------------------------

def _resolve_cloud(st: EdgeState, tr: Optional[TickCounters],
                   tspec: TraceSpec, prof: Profiles, pp: PolicyParams, now,
                   theta, bw_pen, cloud_frac, cloud_up, link_up, jit_c):
    """Dispatch matured cloud tasks into the finite FaaS pool.

    Outage- or partition-parked tasks stay on the trigger-time queue;
    with a saturated pool matured tasks stay parked (still stealable) and
    retry once a slot frees.  DEMS-A adds the JIT check against the
    adapted t̂ and feeds the dispatched tasks' durations to the estimator.
    """
    cq, cqm = st.cq, st.cq_model
    now_q = _col(now)
    mature = (cq.valid & (cq.trigger <= now_q) & _col(cloud_up)
              & link_up.unsqueeze(-1))
    timed_out = cq.valid & ~cq.steal_only & (now_q - cq.trigger
                                             > _col(pp.cloud_give_up_ms))
    run = mature & ~cq.steal_only & ~timed_out
    t_cloud_q = js.take(prof.t_cloud, cqm)
    fits_a = now_q + js.take(st.adapt.current, cqm) <= cq.deadline
    fits_s = ~st.cq_blocked | (now_q + t_cloud_q <= cq.deadline)
    fits = torch.where(_col(pp.adaptive), fits_a, fits_s)
    avail = _free_slot_gate(st.cloud_busy_until, now, run & fits)
    dispatch = run & fits & avail
    skipped = run & ~fits & avail     # popped + JIT-dropped, slot stays free
    act = (cloud_frac * t_cloud_q * js.take(jit_c, cqm)
           + theta.unsqueeze(-1) + bw_pen.unsqueeze(-1))
    success = dispatch & (now_q + act <= cq.deadline)
    util = torch.where(success, js.take(prof.gamma_c, cqm),
                       torch.where(dispatch, -js.take(prof.cost_c, cqm),
                                   0.0)).sum(-1)
    dropped = mature & cq.steal_only         # not stolen in time (§5.3)
    if tr is not None:
        # drops by cause, pool pressure, and the settled tasks' slack and
        # latency
        done = now_q + act
        tr = _tr_add(
            tr, cloud_dispatch=_count(dispatch),
            pool_blocked=_count(run & ~avail),
            drop_infeasible=_count(skipped), drop_unstolen=_count(dropped),
            drop_timeout=_count(timed_out),
            slack_hist=hist_counts(cq.deadline - done, success, tspec),
            latency_hist=hist_counts(
                done - (cq.deadline - js.take(prof.deadline, cqm)), success,
                tspec))
    settled = dispatch | skipped | dropped | timed_out
    new_valid = cq.valid & ~settled
    st = st._replace(
        cq=cq._replace(valid=new_valid),
        cloud_busy_until=_occupy_slots(st.cloud_busy_until, now, dispatch,
                                       now_q + act),
        cq_blocked=(st.cq_blocked | (run & ~avail)) & new_valid,
        n_success=js.segment_add(st.n_success, cqm, success),
        n_miss=js.segment_add(st.n_miss, cqm, dispatch & ~success),
        n_drop=js.segment_add(st.n_drop, cqm,
                              dropped | skipped | timed_out),
        qos_utility=st.qos_utility + util)
    sent = dispatch & _col(pp.adaptive)
    st = st._replace(adapt=js.adapt_feed_batch(
        st.adapt, cqm, sent, sent, act, skipped & _col(pp.adaptive), now,
        prof.t_cloud, pp.adapt_eps, pp.adapt_cooling_ms,
        max_obs=st.cloud_busy_until.shape[-1]))
    gems = _col(pp.gems)
    return _gems_bulk(st, prof, success & gems, settled & gems, cqm), tr


def _gems_bulk(st: EdgeState, prof: Profiles, success_mask, done_mask,
               model_ids) -> EdgeState:
    """Window counters for a batch of task completions/drops."""
    return st._replace(
        lam=js.segment_add(st.lam, model_ids, done_mask),
        lam_hat=js.segment_add(st.lam_hat, model_ids, success_mask))


def _gems_act(st: EdgeState, tr: Optional[TickCounters], tspec: TraceSpec,
              prof: Profiles, pp: PolicyParams, now, theta, bw_pen,
              cloud_frac, link_up, jit_c, busy_sorted=None):
    """Alg. 1: reschedule lagging models' edge tasks into the finite
    cloud pool, close expired windows (GEMS-B adds the winnability gate;
    GEMS-A resolves moves at the actual-duration model)."""
    eq = st.eq
    em = eq.model
    now_q = _col(now)
    gems = _col(pp.gems)
    adaptive = _col(pp.adaptive)
    lag_rate = st.lam_hat / st.lam.clamp(min=1)
    lagging = (st.lam > 0) & (lag_rate < prof.qoe_alpha)
    lost = _col(pp.gems_budget) & ~js.gems_winnable(
        st.lam, st.lam_hat, st.prev_lam, prof.qoe_alpha, now, st.win_end,
        prof.qoe_window)
    proj = js.projected_completions(eq, now, st.busy_rem.clamp(min=0.0))
    doomed = proj > eq.deadline

    t_hat = _t_cloud_cur(st, prof, pp, now, busy_sorted)
    feas = now_q + js.take(t_hat, em) <= eq.abs_dl
    gamma_c_q = js.take(prof.gamma_c, em)
    cand = (eq.valid & js.take(lagging, em) & (gamma_c_q > 0) & feas
            & gems & link_up.unsqueeze(-1))
    want = cand & (~js.take(lost, em) | doomed)
    move = want & _free_slot_gate(st.cloud_busy_until, now, want)
    t_cloud_q = js.take(prof.t_cloud, em)
    hold = (cloud_frac * t_cloud_q * js.take(jit_c, em)
            + theta.unsqueeze(-1) + bw_pen.unsqueeze(-1))
    act = torch.where(adaptive, hold, t_cloud_q)
    success = move & (now_q + act <= eq.abs_dl)
    if tr is not None:
        done = now_q + act
        tr = _tr_add(
            tr, gems_moved=_count(move),
            gems_withheld=_count(cand & js.take(lost, em) & ~doomed),
            slack_hist=hist_counts(eq.abs_dl - done, success, tspec),
            latency_hist=hist_counts(
                done - (eq.abs_dl - js.take(prof.deadline, em)), success,
                tspec))
    util = torch.where(success, gamma_c_q,
                       torch.where(move, -js.take(prof.cost_c, em),
                                   0.0)).sum(-1)
    fed = move & adaptive
    st = st._replace(adapt=js.adapt_feed_batch(
        st.adapt, em, fed, fed, act, torch.zeros_like(fed), now,
        prof.t_cloud, pp.adapt_eps, pp.adapt_cooling_ms,
        max_obs=st.cloud_busy_until.shape[-1]))
    st = st._replace(
        eq=js.edge_remove(eq, move),
        cloud_busy_until=_occupy_slots(st.cloud_busy_until, now, move,
                                       now_q + hold),
        n_success=js.segment_add(st.n_success, em, success),
        n_miss=js.segment_add(st.n_miss, em, move & ~success),
        qos_utility=st.qos_utility + util)
    st = _gems_bulk(st, prof, success, move, em)

    # tumbling-window close (Eqn 2)
    expired = (now_q > st.win_end) & gems
    met = expired & (st.lam > 0) & (st.lam_hat / st.lam.clamp(min=1)
                                    >= prof.qoe_alpha)
    qoe = torch.where(met, prof.qoe_beta, 0.0).sum(-1)
    return st._replace(
        lam=torch.where(expired, 0, st.lam),
        lam_hat=torch.where(expired, 0, st.lam_hat),
        prev_lam=torch.where(expired, st.lam, st.prev_lam),
        win_end=torch.where(expired, st.win_end + prof.qoe_window,
                            st.win_end),
        qoe_utility=st.qoe_utility + qoe,
        windows_met=st.windows_met + met), tr


def _offer_cloud_many(st: EdgeState, prof: Profiles, pp: PolicyParams, now,
                      models, deadlines, t_edges, enable, t_cur=None):
    """Vectorized cloud admission for a ``[..., K]`` batch of offers.

    Accepted offers fill each edge's free cloud-queue slots in ascending
    order — the slots a sequential push loop would pick; every check reads
    the tick's pre-offer state.  Returns ``(state, pushed, accepted)``.
    """
    if t_cur is None:
        t_cur = _t_cloud_cur(st, prof, pp, now)
    now_q = _col(now)
    stealing = _col(pp.stealing)
    use_cloud = _col(pp.use_cloud)
    t_hat = js.take(t_cur, models)
    feasible = now_q + t_hat <= deadlines
    negative = (js.take(prof.gamma_c, models) <= 0) & ~_col(pp.cloud_neg_ok)
    trig_steal = torch.where(negative, deadlines - t_edges,
                             torch.maximum(now_q, deadlines - t_hat
                                           - _col(pp.cloud_margin)))
    accept_steal = enable & feasible & torch.where(negative,
                                                   trig_steal >= now_q, True)
    accept_plain = enable & feasible & ~negative
    accept = use_cloud & torch.where(stealing, accept_steal, accept_plain)
    trigger = torch.where(stealing, trig_steal, now_q)
    steal_only = stealing & negative

    free = ~st.cq.valid
    qc = free.shape[-1]
    arank = torch.cumsum(accept, -1) - accept.long()
    pushed = accept & (arank < free.sum(-1, keepdim=True))
    tgt = torch.where(pushed, arank, qc)
    # offer index of each rank (one extra slot absorbs the unpushed)
    k = models.shape[-1]
    src_of_rank = torch.zeros(tgt.shape[:-1] + (qc + 1,), dtype=torch.int64,
                              device=tgt.device).scatter(
        -1, tgt, torch.arange(k, device=tgt.device).expand(tgt.shape))
    frank = torch.cumsum(free, -1) - free.long()
    fill = free & (frank < pushed.sum(-1, keepdim=True))
    src = src_of_rank[..., :qc].gather(-1, frank)

    def put(old, vals):
        return torch.where(fill, vals.gather(-1, src), old)

    st = st._replace(
        cq=js.CloudQueue(
            valid=st.cq.valid | fill,
            trigger=put(st.cq.trigger, trigger),
            t_edge=put(st.cq.t_edge, t_edges),
            deadline=put(st.cq.deadline, deadlines),
            steal_only=put(st.cq.steal_only, steal_only),
            rank=put(st.cq.rank, js.take(prof.steal_rank, models))),
        cq_model=put(st.cq_model, models),
        cq_blocked=st.cq_blocked & ~fill)
    skip = enable & ~accept & use_cloud & _col(pp.adaptive)
    st = st._replace(adapt=js.adapt_feed_batch(
        st.adapt, models, None, None, None, skip, now, prof.t_cloud,
        pp.adapt_eps, pp.adapt_cooling_ms, with_obs=False))
    return st, pushed, accept


def _route_arrival(st: EdgeState, tr: Optional[TickCounters],
                   prof: Profiles, pp: PolicyParams, now, model, arrive,
                   load_mult, edge_up, busy_sorted=None):
    """Task-scheduler routing for one arriving task per edge (§5.1–5.2,
    §8.2): edge insert by the policy's priority key and feasibility rule
    (EDF/HPF/SJF, SOTA1 deadline buffer, SOTA2 ACT rule, DEM migration),
    else — together with any migration victims — one vectorized cloud
    offer.  ``model``/``arrive``/``load_mult``/``edge_up`` are per edge;
    ``busy_sorted`` may pass in the pool's sorted busy-until times."""
    eq, busy = st.eq, st.busy_rem
    dl_m = js.take(prof.deadline, model)
    abs_dl = now + dl_m
    te = js.take(prof.t_edge, model) * load_mult
    key0 = js.edge_priority_key(pp.edge_prio, abs_dl, te,
                                js.take(prof.gamma_e, model))
    feas0 = js.insert_feasible(eq, now, busy, key0, te, abs_dl)
    proj = js.projected_completions(eq, now, busy)
    victims = js.victim_mask(eq, now, busy, key0, te, proj=proj)

    # SOTA1 (Kalmia+D3): an infeasible non-urgent task retries with a
    # 10 % scheduling-only deadline buffer (success still at abs_dl)
    sched1 = abs_dl + 0.1 * dl_m
    feas1 = js.insert_feasible(eq, now, busy, sched1, te, sched1)
    take_ext = pp.sota1 & ~feas0 & feas1 & (dl_m > pp.urgent_deadline)

    # SOTA2 (Dedas): no violation — insert; several — cloud; exactly one
    # — keep the schedule with the lower mean completion time
    nviol = victims.sum(-1) + (~feas0).long()
    act_ok = js.act_improves(eq, now, busy, key0, te, proj=proj)
    sota2_ok = (nviol == 0) | ((nviol == 1) & feas0 & act_ok)

    t_cur = _t_cloud_cur(st, prof, pp, now, busy_sorted)
    migrate_ok = js.migration_decision(eq, victims, now, model, abs_dl,
                                       prof.gamma_e, prof.gamma_c, t_cur)
    plain_ok = feas0 & torch.where(pp.migration,
                                   ~victims.any(-1) | migrate_ok, True)
    edge_ok = torch.where(pp.sota1, feas0 | take_ext,
                          torch.where(pp.sota2, sota2_ok,
                                      torch.where(pp.feas_check, plain_ok,
                                                  True)))
    # a crashed edge admits nothing: arrivals re-route cloudward
    insert_edge = arrive & pp.use_edge & edge_ok & edge_up
    vic = victims & (insert_edge & pp.migration).unsqueeze(-1)
    to_cloud = arrive & ~insert_edge
    key = torch.where(take_ext, sched1, key0)
    sched_dl = torch.where(take_ext, sched1, abs_dl)

    models = torch.cat([eq.model, model.unsqueeze(-1)], -1)
    dls = torch.cat([eq.abs_dl, abs_dl.unsqueeze(-1)], -1)
    tes = torch.cat([eq.t_edge, te.unsqueeze(-1)], -1)
    offer = torch.cat([vic, to_cloud.unsqueeze(-1)], -1)
    st, pushed, accepted = _offer_cloud_many(st, prof, pp, now, models, dls,
                                             tes, offer, t_cur=t_cur)
    eq = js.edge_remove(st.eq, vic)
    eq, ok = js.edge_push(eq, key, st.seq, te, sched_dl, model,
                          enable=insert_edge, abs_dl=abs_dl)
    # a full edge queue loses the task: account it as a drop
    lost = insert_edge & ~ok
    if tr is not None:
        tr = _tr_add(
            tr, arrivals=arrive, admit_edge=insert_edge & ok,
            admit_cloud=_count(pushed), migrated=_count(vic),
            drop_infeasible=_count(offer & ~accepted),
            drop_qfull=lost + _count(offer & accepted & ~pushed))
    n_drop = js.segment_add(_add_at(st.n_drop, model, lost), models,
                            offer & ~pushed)
    return st._replace(eq=eq, seq=st.seq + arrive, n_drop=n_drop), tr


def _edge_execute(st: EdgeState, tr: Optional[TickCounters],
                  tspec: TraceSpec, prof: Profiles, pp: PolicyParams, now,
                  dt, edge_frac, min_edge_t, jit_e, edge_up):
    """Edge executor: JIT drops, stealing, starting the next task, for
    ``SUBSTEPS`` actions a tick.  A crashed edge flushes its queue as
    drops and suspends stealing/starts; the task in flight completes."""
    m = prof.t_edge.shape[-1]
    m_ids = torch.arange(m, dtype=torch.int32, device=st.seq.device)
    gems = _col(pp.gems)

    flush = st.eq.valid & ~edge_up.unsqueeze(-1)
    st = st._replace(
        eq=js.edge_remove(st.eq, flush),
        n_drop=js.segment_add(st.n_drop, st.eq.model, flush))
    st = _gems_bulk(st, prof, torch.zeros_like(flush), flush & gems,
                    st.eq.model)
    if tr is not None:
        tr = _tr_add(tr, drop_crash=_count(flush))
    # the executor only clears valid bits: queue order stays fixed
    earlier = js.earlier_matrix(st.eq)

    for _ in range(SUBSTEPS):
        s = st
        idle = s.busy_rem <= 0.0

        # JIT check on the head
        eq_after, head_idx, found = js.edge_pop_head(
            s.eq, js.ahead_from(earlier, s.eq.valid))
        head_model = js.take(s.eq.model, head_idx)
        head_infeasible = found & (now + js.take(s.eq.t_edge, head_idx)
                                   > js.take(s.eq.deadline, head_idx))
        do_drop = idle & head_infeasible
        drop_hit = (m_ids == head_model.unsqueeze(-1)) & do_drop.unsqueeze(
            -1)
        s = s._replace(
            eq=s.eq._replace(valid=torch.where(do_drop.unsqueeze(-1),
                                               eq_after.valid, s.eq.valid)),
            n_drop=s.n_drop + drop_hit,
            lam=s.lam + (drop_hit & gems))

        idle = idle & ~head_infeasible
        # stealing (§5.3)
        ahead = js.ahead_from(earlier, s.eq.valid)
        is_head = js.head_mask(s.eq, ahead)
        sidx = js.steal_select(s.cq, s.eq, now, s.busy_rem.clamp(min=0.0),
                               min_edge_t, ahead=ahead, is_head=is_head)
        can_steal = idle & (sidx >= 0) & pp.stealing & edge_up
        si = sidx.clamp(min=0).long()
        smodel = js.take(s.cq_model, si)
        sdl = js.take(s.cq.deadline, si)
        ste = js.take(s.cq.t_edge, si)
        stolen = js._onehot(si, s.cq.valid.shape[-1]) & can_steal.unsqueeze(
            -1)
        s = s._replace(cq=s.cq._replace(valid=s.cq.valid & ~stolen),
                       n_stolen=_add_at(s.n_stolen, smodel, can_steal))

        # start next task: stolen task first, else the queue head
        # (stealing leaves the edge queue, so its head, unchanged)
        eq_after, head_idx, found = js.edge_pop_head(s.eq, is_head=is_head)
        start_head = idle & ~can_steal & found
        run_model = torch.where(can_steal, smodel,
                                js.take(s.eq.model, head_idx))
        # success is judged at the absolute deadline
        run_dl = torch.where(can_steal, sdl, js.take(s.eq.abs_dl, head_idx))
        run_te = torch.where(can_steal, ste, js.take(s.eq.t_edge, head_idx))
        start = can_steal | start_head
        act = edge_frac * run_te * js.take(jit_e, run_model)
        success = start & (now + act <= run_dl)
        util = torch.where(success, js.take(prof.gamma_e, run_model),
                           torch.where(start,
                                       -js.take(prof.cost_e, run_model),
                                       0.0))
        if tr is not None:
            done = now + act
            ok = success.unsqueeze(-1)
            tr = _tr_add(
                tr, drop_infeasible=do_drop, edge_exec=start,
                slack_hist=hist_counts((run_dl - done).unsqueeze(-1), ok,
                                       tspec),
                latency_hist=hist_counts(
                    (done - (run_dl - js.take(prof.deadline, run_model)))
                    .unsqueeze(-1), ok, tspec))
        run_hit = (m_ids == run_model.unsqueeze(-1)) & start.unsqueeze(-1)
        ok_hit = run_hit & success.unsqueeze(-1)
        gems_hit = run_hit & gems
        st = s._replace(
            eq=s.eq._replace(valid=torch.where(start_head.unsqueeze(-1),
                                               eq_after.valid, s.eq.valid)),
            # carry sub-tick execution debt (finish mid-tick → the next
            # task starts from the leftover, like the continuous oracle)
            busy_rem=torch.where(start, s.busy_rem + act, s.busy_rem),
            n_success=s.n_success + ok_hit,
            n_edge_exec=s.n_edge_exec + run_hit,
            n_miss=s.n_miss + (run_hit & ~ok_hit),
            qos_utility=s.qos_utility + util,
            lam=s.lam + gems_hit,
            lam_hat=s.lam_hat + (gems_hit & ok_hit))

    # at most one tick of banked debt; idle edges do not accumulate credit
    return st._replace(busy_rem=(st.busy_rem - dt).clamp(min=-dt)), tr


def make_step(dt: float, edge_frac: float, cloud_frac: float,
              tspec: TraceSpec = TraceSpec()):
    """The policy-generic fleet tick: ``step(prof, pp, state, inputs)``
    with ``inputs`` one tick's row of :class:`FleetSignals` (``now`` and
    ``cloud_up`` per-edge values: 0-d, or ``[R, 1]`` with a replica
    axis; the rest per edge).  Returns ``(state, counters)``: with
    ``tspec.counters`` the second value is this tick's
    :class:`~repro_torch.obs.trace.TickCounters`, else ``None`` and the
    tick launches nothing for the recorder."""

    def step(prof: Profiles, pp: PolicyParams, st: EdgeState, inputs):
        (now, theta, bw, arrive, order, load_mult, cloud_up, valid,
         exec_jit, edge_up, link_up) = inputs
        bw_pen = network.bandwidth_penalty_ms(bw)
        jit_e, jit_c = exec_jit[..., 0], exec_jit[..., 1]
        m = prof.t_edge.shape[-1]
        min_edge_t = prof.t_edge.amin(-1)     # padded models sit at +inf
        st0 = st
        tr = zero_counters(m, tspec, valid.shape, device=valid.device) \
            if tspec.counters else None
        st, tr = _resolve_cloud(st, tr, tspec, prof, pp, now, theta, bw_pen,
                                cloud_frac, cloud_up, link_up, jit_c)
        # the pool's busy-until times stay fixed until _gems_act moves
        # tasks, so routing and GEMS share one sort
        busy_sorted = torch.sort(st.cloud_busy_until, dim=-1).values
        # §3.3: tasks of a segment are inserted in randomized order; each
        # insertion's feasibility depends on the earlier ones
        for i in range(m):
            mdl = order[..., i]
            st, tr = _route_arrival(st, tr, prof, pp, now, mdl,
                                    js.take(arrive, mdl), load_mult, edge_up,
                                    busy_sorted)
        st, tr = _edge_execute(st, tr, tspec, prof, pp, now, dt, edge_frac,
                               min_edge_t, jit_e, edge_up)
        st, tr = _gems_act(st, tr, tspec, prof, pp, now, theta, bw_pen,
                           cloud_frac, link_up, jit_c, busy_sorted)
        # padded (tick, edge) cells are exact no-ops
        st = _tree_where(valid, st, st0)
        if tr is not None:
            # event counters zero out on padded cells; outcome counters
            # are post-revert state deltas (they sum to the final summary
            # exactly), and the gauges read the (possibly reverted)
            # end-of-tick state, so the conservation ledger stays exact
            # through a padded tail
            tr = tr._replace(**{
                f: torch.where(_per_edge(valid, getattr(tr, f)),
                               getattr(tr, f), 0)
                for f in obs_trace.EVENT_FIELDS})
            n_slots = st.cloud_busy_until.shape[-1]
            tr = tr._replace(
                hit=st.n_success - st0.n_success,
                miss=st.n_miss - st0.n_miss,
                drop=st.n_drop - st0.n_drop,
                stolen=st.n_stolen - st0.n_stolen,
                qos=st.qos_utility - st0.qos_utility,
                qoe=st.qoe_utility - st0.qoe_utility,
                eq_depth=_count(st.eq.valid), cq_depth=_count(st.cq.valid),
                slots_busy=_count(
                    (st.cloud_busy_until > _col(now + dt))
                    & (torch.arange(n_slots, device=valid.device)
                       < _col(st.n_slots))),
                valid=valid)
        return st, tr

    return step


# ---------------------------------------------------------------------------
# cross-edge peer offload (fleet-level exchange between ticks)
# ---------------------------------------------------------------------------

def peer_offload(fs: EdgeState, now, slack_ms, max_transfers: int, *,
                 enable=True, transfer_cap=None,
                 edge_valid=None) -> EdgeState:
    """Move doomed tasks from overloaded edges to the least-loaded peer.

    Each of the ``max_transfers`` rounds picks the worst-min-slack edge
    among those with an exportable task, selects its worst-slack task
    that is still feasible behind the least-loaded other edge's queue,
    and re-homes it.  ``enable`` / ``transfer_cap`` (runtime) mask rounds
    off; ``edge_valid`` excludes edges from export and import.  With a
    replica axis (leaves ``[R, E, …]``; ``now``, ``slack_ms``, ``enable``
    and ``transfer_cap`` per-edge values ``[R, 1]``) every selection is
    one row per replica, so replicas never exchange tasks.
    """
    n_edges = fs.busy_rem.shape[-1]
    if n_edges < 2 or max_transfers == 0:
        return fs
    dev = fs.busy_rem.device
    lead = tuple(fs.busy_rem.shape[:-1])      # () or (R,)
    ev = torch.ones(n_edges, dtype=torch.bool, device=dev) \
        if edge_valid is None else edge_valid
    cap = max_transfers if transfer_cap is None else transfer_cap
    edges = torch.arange(n_edges, device=dev)
    n_slots = fs.eq.valid.shape[-1]
    slots = torch.arange(n_slots, device=dev)
    # each replica's first row in the flattened (replica, edge) and
    # (replica, slot) axes
    base_e = torch.arange(0, lead[0] * n_edges, n_edges, device=dev) \
        if lead else None
    base_q = torch.arange(0, lead[0] * n_slots, n_slots, device=dev) \
        if lead else None

    def flat(idx, base):
        """One index per replica into the flattened replica axis."""
        return idx.view(1) if base is None else idx + base

    def at(a, rows):
        """Rows ``rows`` (flat, one per replica) of ``a [..., E, *rest]``
        as ``[..., 1, *rest]``."""
        if not lead:
            return a.index_select(0, rows)
        rest = a.shape[len(lead) + 1:]
        return a.reshape((-1,) + rest).index_select(0, rows).view(
            lead + (1,) + rest)

    for k in range(max_transfers):
        eq = fs.eq
        busy = fs.busy_rem.clamp(min=0.0)
        slacks = js.queue_slacks(eq, now, busy)                 # [..., E, Q]
        min_slack = torch.where(ev, slacks.amin(-1), js.POS)    # [..., E]
        load = torch.where(ev, js.queue_load(eq, fs.busy_rem), js.POS)

        # each edge's best destination load: the minimum over its
        # replica's edges, or the runner-up for that edge itself
        lead_e, best = sched_ops.masked_argmin(load, ev)
        is_lead = edges == _col(lead_e)
        runner_up = torch.where(is_lead, js.POS, load).amin(-1)
        dst_load = torch.where(is_lead, _col(runner_up), _col(best))
        exportable = (eq.valid & (slacks < _col(slack_ms))
                      & ((now + dst_load).unsqueeze(-1) + eq.t_edge
                         <= eq.deadline)).any(-1)
        over = (min_slack < slack_ms) & exportable & ev
        sidx, _ = sched_ops.masked_argmin(min_slack, over)
        src = sidx.clamp(min=0).long()
        didx, _ = sched_ops.masked_argmin(load, ev & (edges != _col(src)))
        dst = didx.clamp(min=0).long()

        src_rows, dst_rows = flat(src, base_e), flat(dst, base_e)
        src_eq = js.EdgeQueue(*(at(a, src_rows) for a in eq))
        vidx = js.export_select(src_eq, now, at(busy, src_rows),
                                at(load, dst_rows), slack_ms).squeeze(-1)
        free = ~at(eq.valid, dst_rows).squeeze(-2)
        # ok: per replica, as a per-edge value ([1] or [R, 1])
        ok = (over.any(-1, keepdim=True) & (_col(sidx) >= 0)
              & (_col(didx) >= 0) & (_col(vidx) >= 0) & enable & (k < cap)
              & free.any(-1, keepdim=True))
        vi = vidx.clamp(min=0).long()
        vi_rows = flat(vi, base_q)
        slot = torch.argmax(free.int(), dim=-1)
        ok_q = ok.unsqueeze(-1)

        out_hit = ((edges == _col(src)).unsqueeze(-1)
                   & (slots == vi.view(lead + (1, 1)))) & ok_q
        in_hit = ((edges == _col(dst)).unsqueeze(-1)
                  & (slots == slot.view(lead + (1, 1)))) & ok_q

        def moved(a, v):
            return torch.where(in_hit, v, a)

        def pick(a):
            return at(a, src_rows).reshape(-1).index_select(
                0, vi_rows).view(lead + (1, 1))

        fs = fs._replace(
            eq=js.EdgeQueue(
                valid=(eq.valid & ~out_hit) | in_hit,
                key=moved(eq.key, pick(eq.key)),
                seq=moved(eq.seq, at(fs.seq, dst_rows).unsqueeze(-1)),
                t_edge=moved(eq.t_edge, pick(eq.t_edge)),
                deadline=moved(eq.deadline, pick(eq.deadline)),
                abs_dl=moved(eq.abs_dl, pick(eq.abs_dl)),
                model=moved(eq.model, pick(eq.model))),
            seq=fs.seq + ((edges == _col(dst)) & ok),
            n_peer_out=fs.n_peer_out + ((edges == _col(src)) & ok),
            n_peer_in=fs.n_peer_in + ((edges == _col(dst)) & ok))
    return fs


def default_signals(n_models: int, *, n_edges: int, drones_per_edge: int = 3,
                    duration_ms: float = 300_000.0, dt: float = 25.0,
                    theta_fn=None, bw_fn=None, seed: int = 0,
                    device="cuda") -> FleetSignals:
    """The paper's steady workload as dense tick signals (§8.1/§8.6),
    drawn from ``numpy.random.default_rng(seed)`` in the reference's
    order, so they equal ``repro.sim.fleet_jax.default_signals`` bitwise.
    """
    dev = resolve_device(device)
    m = n_models
    n_ticks = int(duration_ms / dt)
    rng = np.random.default_rng(seed)

    times = np.arange(n_ticks, dtype=np.float32) * dt
    arrive = np.zeros((n_ticks, n_edges, m), dtype=bool)
    for e in range(n_edges):
        for _ in range(drones_per_edge):
            phase = rng.uniform(0, 1000.0)
            seg_t = np.arange(phase, duration_ms, 1000.0)
            ticks = np.minimum((seg_t / dt).astype(int), n_ticks - 1)
            arrive[ticks, e, :] = True
    theta_t = network.sample_trace(theta_fn, times) if theta_fn \
        else np.zeros(n_ticks, np.float32)
    bw_t = network.sample_trace(bw_fn, times) if bw_fn \
        else np.full(n_ticks, network.NOMINAL_BW_MBPS, np.float32)
    order = rng.permuted(np.tile(np.arange(m), (n_ticks, n_edges, 1)),
                         axis=2).astype(np.int32)
    te = (n_ticks, n_edges)
    host = FleetSignals(
        times=times, theta=np.broadcast_to(theta_t[:, None], te),
        bw=np.broadcast_to(bw_t[:, None], te), arrive=arrive, order=order,
        load_mult=np.ones(te, np.float32), cloud_up=np.ones(n_ticks, bool),
        valid=np.ones(te, bool),
        exec_jit=np.ones((n_ticks, n_edges, m, 2), np.float32),
        edge_up=np.ones(te, bool), link_up=np.ones(te, bool))
    return FleetSignals(*(torch.as_tensor(np.ascontiguousarray(a)).to(dev)
                          for a in host))


def _resolve_policy(policy) -> FleetPolicy:
    return policy if isinstance(policy, FleetPolicy) \
        else FleetPolicy.from_name(policy)


def _tick_axis(sig: FleetSignals) -> int:
    """The tick axis of a signal tree: 0, or 1 under a replica axis
    (``times`` is ``[T]`` or ``[R, T]``)."""
    return sig.times.dim() - 1


def slice_signals(sig: FleetSignals, lo: int, hi: int) -> FleetSignals:
    """Ticks ``[lo, hi)`` of a signal tree (batched or not) as a window."""
    idx = (slice(None),) * _tick_axis(sig) + (slice(lo, hi),)
    return FleetSignals(*(a[idx] for a in sig))


def _cat_results(parts: list, axis: int) -> FleetResult:
    """Chunk results joined on the tick axis (the last chunk's state)."""
    if len(parts) == 1:
        return parts[0]

    def cat(xs):
        return torch.cat(xs, axis)

    first = parts[0]
    return FleetResult(
        parts[-1].final,
        None if first.t_hat is None else cat([p.t_hat for p in parts]),
        None if first.counters is None else TickCounters(
            *(cat(xs) for xs in zip(*(p.counters for p in parts)))))


# ---------------------------------------------------------------------------
# mesh sharding: one process a rank, each rank runs its block
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MeshSplit:
    """One tensor dimension split over one mesh axis: ``size`` blocks, this
    rank's the ``index``-th, the axis's process ``group`` between them."""

    group: object
    size: int
    index: int

    def block(self, n: int) -> tuple:
        per = n // self.size
        return self.index * per, (self.index + 1) * per


def _mesh_split(mesh, axis: int, n: int) -> Optional[MeshSplit]:
    """The split of a dimension of ``n`` over the mesh's ``axis``-th axis,
    or None where nothing splits: no mesh or no such axis, an axis of 1,
    an axis that does not divide ``n`` (it stays whole on every rank, as
    the reference's ``_put`` leaves it replicated), or a rank outside the
    mesh (it runs the whole)."""
    if mesh is None or axis >= mesh.ndim:
        return None
    size = mesh.size(axis)
    coord = mesh.get_coordinate()
    if size == 1 or n % size or coord is None:
        return None
    return MeshSplit(mesh.get_group(axis), size, coord[axis])


def _take(a: torch.Tensor, dim: int, split: Optional[MeshSplit]):
    """This rank's block of ``a`` along ``dim`` (its own contiguous copy)."""
    if split is None:
        return a
    lo, hi = split.block(a.shape[dim])
    return a.narrow(dim, lo, hi - lo).contiguous()


def _gather(a: torch.Tensor, dim: int, split: Optional[MeshSplit]):
    """The blocks of every rank of ``split`` joined along ``dim``."""
    if split is None:
        return a
    import torch.distributed as dist
    src = a.contiguous()
    wire = src.view(torch.uint8) if src.dtype == torch.bool else src
    parts = [torch.empty_like(wire) for _ in range(split.size)]
    dist.all_gather(parts, wire, group=split.group)
    out = torch.cat(parts, dim)
    return out.view(torch.bool) if src.dtype == torch.bool else out


# the edge axis of each signal field of one run ([T, E, …]; None = none);
# a batch's fields lead with the replica axis, one further in
_SIGNAL_EDGE_AXIS = dict(times=None, theta=1, bw=1, arrive=1, order=1,
                         load_mult=1, cloud_up=None, valid=1, exec_jit=1,
                         edge_up=1, link_up=1)


def _take_signals(sig: FleetSignals, rep: Optional[MeshSplit],
                  edge: Optional[MeshSplit]) -> FleetSignals:
    """A rank's block of signals: replicas (a batch's leading axis) over
    ``rep``, the edge axis over ``edge``."""
    lead = sig.times.dim() - 1
    out = {}
    for f in FleetSignals._fields:
        a = getattr(sig, f)
        if lead:
            a = _take(a, 0, rep)
        ax = _SIGNAL_EDGE_AXIS[f]
        out[f] = a if ax is None else _take(a, ax + lead, edge)
    return FleetSignals(**out)


def _gather_result(res, lead: int, rep: Optional[MeshSplit],
                   edge: Optional[MeshSplit]):
    """Every rank's blocks of a run's result joined back: the edge axis
    (state ``[(R,) E, …]``, streams ``[(R,) T, E, …]``) over ``edge``,
    then replicas over ``rep``; every rank returns the whole."""
    def whole(tree, edge_dim):
        tree = _map(lambda a: _gather(a, edge_dim, edge), tree)
        return _map(lambda a: _gather(a, 0, rep), tree) if lead else tree

    if not isinstance(res, FleetResult):
        return whole(res, lead)
    return FleetResult(whole(res.final, lead), whole(res.t_hat, lead + 1),
                       whole(res.counters, lead + 1))


# the EdgeState fields peer_offload reads or writes across edges
_OFFLOAD_FIELDS = ("eq", "busy_rem", "seq", "n_peer_out", "n_peer_in")


def _offload_across(split: MeshSplit, fs: EdgeState,
                    edge_valid: torch.Tensor, offload) -> EdgeState:
    """``offload(fs, edge_valid)`` — peer offload — on an edge axis split
    over the ranks of ``split``.

    The exchange is the only step of a tick that reads other edges.  Each
    rank packs the fields it reads (:data:`_OFFLOAD_FIELDS` and the edges'
    validity) as bytes an edge, all-gathers them over the edge group in
    one collective, runs the exchange on the whole fleet — every rank the
    same selections on the same bytes, so the result is the unsharded one
    bitwise — and keeps its own block."""
    dim = edge_valid.dim() - 1
    parts = [edge_valid] + [a for f in _OFFLOAD_FIELDS
                            for a in _leaves(getattr(fs, f))]
    rows = [a.contiguous().reshape(a.shape[:dim + 1] + (-1,)).view(
        torch.uint8) for a in parts]
    packed = _gather(torch.cat(rows, -1), dim, split)
    full, at = [], 0
    for a, b in zip(parts, rows):
        width = b.shape[-1]
        full.append(packed[..., at:at + width].contiguous().view(
            a.dtype).reshape(packed.shape[:dim + 1] + a.shape[dim + 1:]))
        at += width
    rest = iter(full[1:])
    whole = fs._replace(**{f: _map(lambda _a: next(rest), getattr(fs, f))
                           for f in _OFFLOAD_FIELDS})
    out = offload(whole, full[0])
    n_loc = edge_valid.shape[dim]
    lo = split.index * n_loc
    return fs._replace(**{
        f: _map(lambda a: a.narrow(dim, lo, n_loc).contiguous(),
                getattr(out, f))
        for f in ("eq", "seq", "n_peer_out", "n_peer_in")})


# ---------------------------------------------------------------------------
# tick programs: a bounded cache over the statics, a CUDA graph a shape key
# ---------------------------------------------------------------------------

# every live program, for the capture accounting of
# repro_torch.obs.prof.fleet_compile_stats: a program records one shape
# key per distinct input shape, and policies are runtime data, so running
# more policies through it adds none
_PROGRAM_REGISTRY: list = []

# The program cache is bounded: the shape-bucketed sweep planner keys one
# program layout per bucket, and a long-lived process must not keep
# programs (and their graphs' memory pools) without bound.  LRU order;
# an evicted program drops its graphs and leaves _PROGRAM_REGISTRY.
FLEET_PROGRAM_CACHE_CAPACITY = 32
_PROGRAM_CACHE: collections.OrderedDict = collections.OrderedDict()
_PROGRAM_EVICTIONS = 0

# the window FleetProgram.run replays when no chunk_ticks is given.  A
# graph records every launch of its window (about 3,400 nodes a 28-edge
# DEMS-COOP tick), so a 12,000-tick horizon cannot be one graph; and a
# new shape key pays an eager window, a capture and an instantiation
# that grow with the window, while the replayed rate did not grow from
# 40 ticks to 100 (PERF.md §6).  20 ticks divide the horizons the
# repository runs (8, 10, 15, 30 s).
RUN_WINDOW_TICKS = 20


def _leaves(tree) -> list:
    """The tensor leaves of a NamedTuple tree, in field order (``None``
    streams have none)."""
    if tree is None:
        return []
    if isinstance(tree, tuple):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _map(fn, tree):
    """``fn`` on every leaf of a NamedTuple tree (``None`` stays)."""
    if tree is None:
        return None
    if isinstance(tree, tuple):
        return type(tree)(*(_map(fn, v) for v in tree))
    return fn(tree)


def _shape_key(*trees) -> tuple:
    """Shape, dtype and device of every leaf: what a jit traces anew on."""
    return tuple((tuple(a.shape), a.dtype, a.device)
                 for t in trees for a in _leaves(t))


def _version(a: torch.Tensor):
    """``a``'s version counter, ``None`` for an inference tensor (which
    keeps none)."""
    try:
        return a._version
    except RuntimeError:
        return None


@dataclasses.dataclass
class _Graph:
    """One captured window: the graph, the static buffers it reads
    (``inputs``: profiles, params, state, signals) and writes
    (``outputs``: state, t̂ stream, counters), the ``masked_argext``
    launches a replay makes (all, KEY) and what the capture cost.

    ``held`` are weak references to the state leaves the last donated
    replay handed out (aliases of the state buffers, so a stream that
    passes them back in is known by identity); ``last`` the profiles and
    params leaves the last replay copied in, with their version counters
    (held strongly, so an identity cannot be reused)."""

    graph: object
    inputs: tuple
    outputs: tuple
    launches: tuple
    nodes: int
    capture_s: float
    instantiate_s: float
    held: list = dataclasses.field(default_factory=list)
    last: list = dataclasses.field(default_factory=list)


class TickProgram:
    """An entry of the program cache: the window body of one set of
    statics (``dt``, the execution fractions, ``coop_rounds``, the trace
    spec, ``donate``) and, on the card, a CUDA graph of it per shape key,
    as a jit wrapper keeps a trace per input shape.

    A shape key's first window runs eagerly on a side stream: that is
    the warm-up capture needs (the kernels built, every lazy
    initialisation done), and its result is the window's.  The window is
    then captured, and every later window of that key is a replay: each
    input leaf copied into the graph's static buffer (one ``copy_`` a
    leaf), the graph replayed, the outputs cloned out of its memory (the
    state only without ``donate``; with it the graph has written the new
    carry back into its own state buffers).  Leaves a replay need not
    copy are skipped: a profiles or params leaf that is the tensor the
    last replay copied, unchanged since (its version counter), and,
    donated, the state that replay handed out.  A donated replay hands
    out aliases of the state buffers; when another stream's state
    arrives while a caller still holds them, they first become that
    caller's own copy, so donated streams of one shape stay apart.  A
    replay adds the launches its capture recorded to the kernel's
    counts.  A capture or replay that fails raises.  CPU tensors run the
    body eagerly and record their shape key alike.

    A call is the span ``fleet.window``; under it a new key's
    ``fleet.first`` (the eager window), ``fleet.capture`` and
    ``fleet.instantiate``, or a replay's ``fleet.copy_in``,
    ``fleet.launch`` and ``fleet.clone_out``.  A replay counts
    ``fleet.replays``, and the leaves it copied and skipped in
    ``fleet.copies`` and ``fleet.copies_skipped``."""

    def __init__(self, dt: float, edge_frac: float, cloud_frac: float,
                 coop_rounds: int, tspec: TraceSpec, donate: bool,
                 exchange: Optional[MeshSplit] = None):
        self.dt, self.coop_rounds = dt, coop_rounds
        self.tspec, self.donate = tspec, donate
        self.exchange = exchange
        self.step = make_step(dt, edge_frac, cloud_frac, tspec)
        self.shape_keys: set = set()
        self.graphs: dict = {}

    def window(self, prof: Profiles, pp: PolicyParams, state: EdgeState,
               signals: FleetSignals):
        """The body: ``state`` advanced over ``signals``.  Returns
        ``(state, t_hat, counters)``, the streams stacked on the tick
        axis or ``None``."""
        step = self.step
        ax = _tick_axis(signals)
        if ax:
            # per-replica tables and flags as per-edge values ([R, 1, M],
            # [R, 1]); shared ones broadcast as they are
            if prof.t_edge.dim() == 2:
                prof = Profiles(*(a.unsqueeze(-2) for a in prof))
            if pp.migration.dim() == 1:
                pp = PolicyParams(*(a.unsqueeze(-1) for a in pp))
        t_hats, ticks = [], []
        for t in range(signals.times.shape[ax]):
            row = tuple(a.select(ax, t) for a in signals)
            if ax:
                row = (row[0].unsqueeze(-1),) + row[1:6] \
                    + (row[6].unsqueeze(-1),) + row[7:]
            state, tick = step(prof, pp, state, row)
            if self.coop_rounds:
                pre_out, pre_in = state.n_peer_out, state.n_peer_in

                def offload(fs, ev, now=row[0] + self.dt):
                    return peer_offload(
                        fs, now, pp.coop_slack_ms, self.coop_rounds,
                        enable=pp.cooperation,
                        transfer_cap=pp.coop_transfer_cap, edge_valid=ev)
                # crashed edges neither export nor import peer work
                ev = row[7] & row[9]
                state = offload(state, ev) if self.exchange is None \
                    else _offload_across(self.exchange, state, ev, offload)
                if tick is not None:
                    # the exchange runs between ticks; fold its per-edge
                    # deltas into the tick row
                    tick = tick._replace(
                        peer_out=tick.peer_out + state.n_peer_out - pre_out,
                        peer_in=tick.peer_in + state.n_peer_in - pre_in)
            if self.tspec.t_hat:
                t_hats.append(state.adapt.current)
            if tick is not None:
                ticks.append(tick)
        return (state,
                torch.stack(t_hats, ax) if self.tspec.t_hat else None,
                TickCounters(*(torch.stack(xs, ax) for xs in zip(*ticks)))
                if self.tspec.counters else None)

    def record(self, inputs: tuple):
        """What a graph records: the body on the static ``inputs`` and,
        with ``donate``, the new carry written back into the static
        state buffers (a new leaf sharing memory with an input is cloned
        before any write-back, so no write reads an overwritten leaf).
        Returns the outputs."""
        state, t_hat, counters = self.window(*inputs)
        if self.donate:
            held = {a.untyped_storage().data_ptr()
                    for a in _leaves(inputs[2])}
            new = [b.clone() if b.untyped_storage().data_ptr() in held
                   else b for b in _leaves(state)]
            for a, b in zip(_leaves(inputs[2]), new):
                a.copy_(b)
            state = inputs[2]
        return state, t_hat, counters

    def note(self, *trees) -> None:
        """Record the shape key of ``trees`` (what a jit traces anew on)."""
        self.shape_keys.add(_shape_key(*trees))

    def __call__(self, prof, pp, state, signals, capture: bool = True,
                 note: bool = True):
        with span("fleet.window"):
            key = _shape_key(prof, pp, state, signals)
            if note:
                self.shape_keys.add(key)
            # a window that exchanges across ranks runs eagerly: its
            # collectives are not captured
            if state.busy_rem.device.type != "cuda" or not capture \
                    or self.exchange is not None:
                return self.window(prof, pp, state, signals)
            g = self.graphs.get(key)
            if g is None:
                return self._first(key, prof, pp, state, signals)
            return self._replay(g, prof, pp, state, signals)

    def _first(self, key, prof, pp, state, signals):
        with span("fleet.first"):
            dev = state.busy_rem.device
            main = torch.cuda.current_stream(dev)
            side = torch.cuda.Stream(dev)
            side.wait_stream(main)
            with torch.cuda.stream(side):
                out = self.window(prof, pp, state, signals)
            main.wait_stream(side)
            for a in _leaves(out):
                a.record_stream(main)
        self.graphs[key] = self._capture(prof, pp, state, signals)
        return out

    def _capture(self, prof, pp, state, signals) -> _Graph:
        inputs = tuple(_map(torch.clone, t)
                       for t in (prof, pp, state, signals))
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        before = sched_ops.launch_counts()
        with span("fleet.capture") as cap:
            try:
                with torch.cuda.graph(graph):
                    outputs = self.record(inputs)
            finally:
                # the capture launched nothing: its counts come back once
                # per replay
                launches = tuple(a - b for a, b in zip(
                    sched_ops.launch_counts(), before))
                sched_ops.add_launches(*(-n for n in launches))
        nodes = graph_nodes(graph)
        with span("fleet.instantiate") as inst:
            graph.instantiate()
        return _Graph(graph, inputs, outputs, launches, nodes, cap.seconds,
                      inst.seconds)

    def _replay(self, g: _Graph, prof, pp, state, signals):
        with span("fleet.copy_in"):
            s_prof, s_pp, s_state, s_sig = g.inputs
            fixed = [(b, _version(b)) for b in _leaves((prof, pp))]
            last = g.last or [(None, None)] * len(fixed)
            copies = [(a, b) for a, (b, v), (b0, v0) in zip(
                _leaves((s_prof, s_pp)), fixed, last)
                if not (b is b0 and v is not None and v == v0)]
            skipped = len(fixed) - len(copies)
            copies += zip(_leaves(s_sig), _leaves(signals))
            held = [r() for r in g.held]
            if not (self.donate and held and all(
                    a is b for a, b in zip(held, _leaves(state)))):
                # another stream's state: the carry the buffers hold
                # becomes its holder's own copy before it is overwritten
                for a in held:
                    if a is not None:
                        a.set_(a.clone())
                copies += zip(_leaves(s_state), _leaves(state))
            else:
                skipped += len(held)
            for a, b in copies:
                a.copy_(b)
            g.last = fixed
        with span("fleet.launch"):
            g.graph.replay()
        sched_ops.add_launches(*g.launches)
        count("fleet.replays")
        count("fleet.copies", len(copies))
        count("fleet.copies_skipped", skipped)
        with span("fleet.clone_out"):
            out_state, t_hat, counters = g.outputs
            if self.donate:
                out_state = _map(lambda a: a.new_empty(0).set_(a),
                                 out_state)
                g.held = [weakref.ref(a) for a in _leaves(out_state)]
            else:
                out_state = _map(torch.clone, out_state)
            return out_state, _map(torch.clone, t_hat), _map(torch.clone,
                                                             counters)


def _fleet_program(dt: float, edge_frac: float, cloud_frac: float,
                   coop_rounds: int, tspec: TraceSpec,
                   donate: bool = False,
                   exchange: Optional[MeshSplit] = None) -> TickProgram:
    """The cached :class:`TickProgram` of these statics.

    ``coop_rounds`` is the static peer-offload round bound (0 leaves
    cooperation out of the window); per-replica runtime caps mask rounds
    within it.  ``tspec`` selects the flight-recorder streams and is part
    of the key, so the trace-off program records exactly the untraced
    launches.  ``donate`` keeps the carry in the graph's own state
    buffers: a donated window consumes the state passed in
    (:class:`FleetProgram`).  ``exchange`` is the split of the edge axis
    over ranks that peer offload crosses (:func:`_offload_across`)."""
    global _PROGRAM_EVICTIONS
    key = (dt, edge_frac, cloud_frac, coop_rounds, tspec, donate,
           exchange)
    prog = _PROGRAM_CACHE.get(key)
    if prog is not None:
        _PROGRAM_CACHE.move_to_end(key)
        return prog
    prog = TickProgram(*key)
    _PROGRAM_CACHE[key] = prog
    _PROGRAM_REGISTRY.append(prog)
    while len(_PROGRAM_CACHE) > FLEET_PROGRAM_CACHE_CAPACITY:
        _, evicted = _PROGRAM_CACHE.popitem(last=False)
        _PROGRAM_EVICTIONS += 1
        evicted.graphs.clear()
        try:
            _PROGRAM_REGISTRY.remove(evicted)
        except ValueError:  # already dropped by reset_fleet_programs
            pass
    return prog


def _program_cache_clear() -> None:
    for prog in _PROGRAM_CACHE.values():
        prog.graphs.clear()
    _PROGRAM_CACHE.clear()


# the reference's management surface: callers clear the cache through
# the function object
_fleet_program.cache_clear = _program_cache_clear


@dataclasses.dataclass(frozen=True)
class FleetProgram:
    """The tick program as a step-wise API: :meth:`init` builds the
    stacked state, :meth:`step_chunk` advances it over one signal window,
    :meth:`run` replays a horizon window by window (bitwise identical for
    any ``chunk_ticks``, since each tick reads only the carried state and
    its own signal row).

    ``trace`` selects the flight-recorder streams.  Signals with a
    leading replica axis (``[R, T, …]``, state ``[R, E, …]``) run as a
    batch; profiles and policy flags are then either shared (``[M]`` and
    0-d) or per replica (``[R, M]`` and ``[R]``, a :class:`FleetBatch`).

    The window runs through the :func:`_fleet_program` cache: programs
    with equal statics share one :class:`TickProgram`, and on the card a
    window is a CUDA-graph replay, one graph a shape key.

    ``donate=True`` keeps the carry in the graph's own state buffers,
    updated in place: a donated :meth:`step_chunk` returns aliases of
    those buffers, and the next donated window that is given them back
    copies no state in.  Another stream's window of the same shape first
    turns the aliases still held into their holder's own copy, so
    donated streams stay apart as in the reference.  :meth:`run` hands
    the caller its own copy of the final state, so the caller's initial
    state and the result both survive."""

    dt: float = 25.0
    edge_frac: float = 0.62
    cloud_frac: float = 0.80
    coop_rounds: int = 0
    trace: TraceSpec = TraceSpec()
    donate: bool = False
    exchange: Optional[MeshSplit] = None

    @classmethod
    def for_policy(cls, policy, *, trace: TraceSpec = TraceSpec(),
                   dt: float = 25.0, edge_frac: float = 0.62,
                   cloud_frac: float = 0.80,
                   donate: bool = False) -> "FleetProgram":
        """A program whose peer-offload round bound matches ``policy``."""
        pol = _resolve_policy(policy)
        return cls(dt=dt, edge_frac=edge_frac, cloud_frac=cloud_frac,
                   coop_rounds=pol.coop_max_transfers if pol.cooperation
                   else 0, trace=trace, donate=donate)

    def init(self, prof: Profiles, policy, n_edges: int,
             cloud_slots: int = CLOUD_SLOTS,
             total_slots: Optional[int] = None) -> EdgeState:
        """Fresh stacked fleet state on ``prof``'s device."""
        pol = _resolve_policy(policy)
        return init_state(prof, n_edges, pol.adapt_window, cloud_slots,
                          total_slots=total_slots)

    @property
    def _program(self) -> TickProgram:
        return _fleet_program(self.dt, self.edge_frac, self.cloud_frac,
                              self.coop_rounds, self.trace, self.donate,
                              self.exchange)

    @torch.inference_mode()
    def step_chunk(self, prof: Profiles, pp: PolicyParams, state: EdgeState,
                   signals: FleetSignals, *, _capture: bool = True):
        """Advance ``state`` over one window.  Returns ``(state, result)``:
        ``result`` is the window's :class:`FleetResult` (streams over this
        window's ticks) when the program's trace is enabled, else
        ``None``.  On the card the window is a CUDA-graph replay; the
        launches are enqueued without any wait on the card.
        ``_capture=False`` runs the body eagerly on the card as well
        (only ``chip_smoke.py`` and ``tools/tick_ab.py`` pass it, to time
        the eager path beside the replayed one)."""
        return self._step(prof, pp, state, signals, _capture)

    def _step(self, prof, pp, state, signals, capture=True, note=True):
        state, t_hat, counters = self._program(prof, pp, state, signals,
                                               capture, note)
        if not self.trace.enabled:
            return state, None
        return state, FleetResult(state, t_hat, counters)

    def run(self, prof: Profiles, pp: PolicyParams, state: EdgeState,
            signals: FleetSignals, chunk_ticks: Optional[int] = None):
        """Replay the whole horizon, ``chunk_ticks`` ticks per window
        (``RUN_WINDOW_TICKS`` when not given).  Returns the final state,
        or with the trace enabled a :class:`FleetResult` whose streams
        join the windows on the tick axis."""
        ax = _tick_axis(signals)
        n_ticks = signals.times.shape[ax]
        whole = chunk_ticks is None
        if whole:
            # the reference traces the whole horizon once: its shape key
            # is the run's, whatever windows replay it
            self._program.note(prof, pp, state, signals)
        chunk = RUN_WINDOW_TICKS if whole else max(1, chunk_ticks)
        parts = []
        with torch.inference_mode():
            for lo in range(0, n_ticks, chunk):
                state, res = self._step(
                    prof, pp, state,
                    slice_signals(signals, lo, min(lo + chunk, n_ticks)),
                    note=not whole)
                parts.append(res)
            if self.donate:
                # the carry lives in the program's buffers: the caller
                # gets its own copy
                state = _map(torch.clone, state)
        if not self.trace.enabled:
            return state
        return _cat_results(parts, ax)._replace(final=state)


def run_fleet(models, policy, signals: FleetSignals, *, dt: float = 25.0,
              edge_frac: float = 0.62, cloud_frac: float = 0.80,
              cloud_slots: int = CLOUD_SLOTS, record_trace: bool = False,
              trace: Optional[TraceSpec] = None,
              chunk_ticks: Optional[int] = None, donate: bool = False,
              mesh=None, device="cuda"):
    """Run the fleet simulator over scenario signals; returns the final
    stacked :class:`EdgeState` on ``device``.

    ``trace`` turns on the flight recorder and returns a
    :class:`FleetResult` (``t_hat`` ``[T, E, M]``, counters ``[T, E, …]``;
    the final state is bit-identical to the untraced run's);
    ``record_trace=True`` is the older alias for
    ``TraceSpec(t_hat=True)``.  ``chunk_ticks`` sets the window (bitwise
    alike for any value); ``donate=True`` updates the carry in place
    (:class:`FleetProgram`), same results bitwise.

    ``mesh`` (a :class:`~torch.distributed.device_mesh.DeviceMesh`, one
    process a rank) splits the edges over its first axis: each rank
    runs its block of edges, peer offload exchanges across ranks
    (:func:`_offload_across`), and every rank returns the whole, gathered
    result, bitwise the unsharded one.  An axis that does not divide the
    edges leaves them whole on every rank.

    A call is the span ``fleet.run`` (a request of its own when no span
    is open), with ``fleet.setup`` (profiles, signals to the device, the
    initial state) its first child."""
    with span("fleet.run"):
        with span("fleet.setup"):
            dev = resolve_device(device)
            tspec = resolve_spec(trace, record_trace)
            pol = _resolve_policy(policy)
            prof = Profiles.build(models, dev)
            signals = FleetSignals(*(a.to(dev) for a in signals))
            n_edges = signals.arrive.shape[1]
            prog = FleetProgram.for_policy(pol, trace=tspec, dt=dt,
                                           edge_frac=edge_frac,
                                           cloud_frac=cloud_frac,
                                           donate=donate)
            state = prog.init(prof, pol, n_edges, cloud_slots)
            edge = _mesh_split(mesh, 0, n_edges)
        if edge is None:
            return prog.run(prof, pol.params(dev), state, signals,
                            chunk_ticks)
        prog = dataclasses.replace(
            prog, exchange=edge if prog.coop_rounds else None)
        res = prog.run(prof, pol.params(dev),
                       _map(lambda a: _take(a, 0, edge), state),
                       _take_signals(signals, None, edge), chunk_ticks)
        return _gather_result(res, 0, None, edge)


# ---------------------------------------------------------------------------
# batches: many replicas under one set of launches a tick
# ---------------------------------------------------------------------------

def _host_signals(sig: FleetSignals) -> FleetSignals:
    return FleetSignals(*(a.detach().cpu().numpy()
                          if isinstance(a, torch.Tensor) else np.asarray(a)
                          for a in sig))


def stack_signals(signals: list) -> FleetSignals:
    """Stack per-run signals over a new leading replica axis.

    All runs must share (n_ticks, n_edges, n_models) — seeds or event
    variants of one scenario shape, the unit :func:`run_fleet_batch`
    runs as one batch.  Heterogeneous shapes raise a :class:`ValueError`
    naming the offending field; use :func:`pad_signals` for a
    cross-scenario batch.  The stack stays on the runs' device.
    """
    for f in FleetSignals._fields:
        shapes = [tuple(getattr(s, f).shape) for s in signals]
        if any(sh != shapes[0] for sh in shapes):
            raise ValueError(
                f"stack_signals: replica signals disagree on field {f!r} "
                f"(shapes {shapes}); stack only same-shape replicas "
                f"(seeds / event variants of one scenario) or use "
                f"pad_signals for a heterogeneous cross-scenario batch")
    return FleetSignals(*(torch.stack([torch.as_tensor(x) for x in xs])
                          for xs in zip(*signals)))


def pad_signals(signals: list, dt: float = 25.0, *,
                device="cuda") -> FleetSignals:
    """Mask heterogeneous per-run signals to the max shape and stack, on
    the host, then move the batch to ``device`` once.

    Every replica is padded to the batch's max (ticks, edges, models):
    padded ticks/edges carry ``valid=False`` (the tick reverts them to
    exact no-ops), padded models never arrive and their ids are appended
    to the insertion ``order`` so it stays a permutation; the times run
    on past a replica's horizon at its own step.
    """
    dev = resolve_device(device)
    sigs = [_host_signals(s) for s in signals]
    tmax = max(s.arrive.shape[0] for s in sigs)
    emax = max(s.arrive.shape[1] for s in sigs)
    mmax = max(s.arrive.shape[2] for s in sigs)
    padded = []
    for s in sigs:
        t, e, m = s.arrive.shape
        pt, pe = tmax - t, emax - e
        step = float(s.times[1] - s.times[0]) if t > 1 else dt
        times = np.concatenate(
            [s.times, s.times[-1] + step * np.arange(1, pt + 1,
                                                     dtype=np.float32)])
        order = np.broadcast_to(np.arange(mmax, dtype=np.int32),
                                (tmax, emax, mmax)).copy()
        order[:t, :e, :m] = s.order
        valid = np.zeros((tmax, emax), dtype=bool)
        valid[:t, :e] = s.valid
        padded.append(FleetSignals(
            times=times.astype(np.float32),
            theta=np.pad(s.theta, ((0, pt), (0, pe))),
            bw=np.pad(s.bw, ((0, pt), (0, pe)),
                      constant_values=network.NOMINAL_BW_MBPS),
            arrive=np.pad(s.arrive, ((0, pt), (0, pe), (0, mmax - m))),
            order=order,
            load_mult=np.pad(s.load_mult, ((0, pt), (0, pe)),
                             constant_values=1.0),
            cloud_up=np.pad(s.cloud_up, (0, pt), constant_values=True),
            valid=valid,
            # padded cells keep the deterministic ×1.0 multiplier
            exec_jit=np.pad(s.exec_jit,
                            ((0, pt), (0, pe), (0, mmax - m), (0, 0)),
                            constant_values=1.0),
            # padded cells are healthy (valid=False already no-ops them)
            edge_up=np.pad(s.edge_up, ((0, pt), (0, pe)),
                           constant_values=True),
            link_up=np.pad(s.link_up, ((0, pt), (0, pe)),
                           constant_values=True)))
    return FleetSignals(*(torch.from_numpy(np.stack(xs)).to(dev)
                          for xs in zip(*padded)))


def run_fleet_batch(models, policy, signals: FleetSignals, *,
                    dt: float = 25.0, edge_frac: float = 0.62,
                    cloud_frac: float = 0.80, cloud_slots: int = CLOUD_SLOTS,
                    record_trace: bool = False,
                    trace: Optional[TraceSpec] = None, donate: bool = False,
                    mesh=None, device="cuda"):
    """One batch: ``signals`` carry a leading replica axis ``[R, …]``
    (from :func:`stack_signals`), and every replica's mission runs under
    one set of launches a tick, with the model table and policy flags
    shared.

    Returns the stacked final :class:`EdgeState` with leading ``[R, E]``
    axes; replica ``r`` equals ``run_fleet`` on that run's signals
    exactly.  ``trace`` (or ``record_trace``) returns a
    :class:`FleetResult` with replica-leading streams (``t_hat``
    ``[R, T, E, M]``).  For heterogeneous replicas see
    :func:`build_fleet_batch` / :func:`run_batch`.  ``donate`` as in
    :func:`run_fleet`.  ``mesh`` splits the replicas over its first axis
    and, on a 2-D mesh, the edges over its second (:func:`run_batch`).
    """
    dev = resolve_device(device)
    tspec = resolve_spec(trace, record_trace)
    pol = _resolve_policy(policy)
    prof = Profiles.build(models, dev)
    signals = FleetSignals(*(a.to(dev) for a in signals))
    n_rep, n_edges = signals.arrive.shape[0], signals.arrive.shape[2]
    prog = FleetProgram.for_policy(pol, trace=tspec, dt=dt,
                                   edge_frac=edge_frac,
                                   cloud_frac=cloud_frac, donate=donate)
    state = _stack_tree([prog.init(prof, pol, n_edges, cloud_slots)]
                        * n_rep)
    return _run_split(prog, prof, pol.params(dev), state, signals, None,
                      mesh, shared=True)


def _run_split(prog: FleetProgram, prof: Profiles, pp: PolicyParams,
               state: EdgeState, signals: FleetSignals, chunk_ticks,
               mesh, shared: bool):
    """``prog.run`` of a batch (state ``[R, E, …]``) on this rank's block
    of the mesh's (replica, edge) grid: replicas over the first mesh axis,
    edges over the second where there is one; profiles and params split
    with the replicas unless ``shared``.  The result is gathered whole on
    every rank."""
    n_rep, n_edges = state.busy_rem.shape
    rep = _mesh_split(mesh, 0, n_rep)
    edge = _mesh_split(mesh, 1, n_edges)
    if rep is None and edge is None:
        return prog.run(prof, pp, state, signals, chunk_ticks)
    if not shared:
        prof = _map(lambda a: _take(a, 0, rep), prof)
        pp = _map(lambda a: _take(a, 0, rep), pp)
    state = _map(lambda a: _take(_take(a, 0, rep), 1, edge), state)
    prog = dataclasses.replace(prog,
                               exchange=edge if prog.coop_rounds else None)
    res = prog.run(prof, pp, state, _take_signals(signals, rep, edge),
                   chunk_ticks)
    return _gather_result(res, 1, rep, edge)


def _stack_tree(trees: list):
    """Leaf-wise ``torch.stack`` of equal-structure trees."""
    if isinstance(trees[0], tuple):
        return type(trees[0])(*(_stack_tree(list(xs))
                                for xs in zip(*trees)))
    return torch.stack(trees)


class FleetBatch(NamedTuple):
    """A heterogeneous sweep as one program's inputs.

    ``profiles``/``params``/``state`` carry a leading replica axis
    matching ``signals``; ``coop_rounds`` is the static peer-offload
    bound (max across the batch's policies).
    """

    profiles: Profiles      # [R, Mp]
    params: PolicyParams    # [R]
    state: EdgeState        # [R, E, …]
    signals: FleetSignals   # [R, T, …]
    coop_rounds: int


def build_fleet_batch(runs, *, dt: float = 25.0,
                      device="cuda") -> FleetBatch:
    """Assemble heterogeneous runs into one padded, stackable batch on
    ``device``.

    ``runs`` is a list of ``(models, policy, signals, cloud_slots)``
    tuples — one per replica (scenario × policy × seed).  Model tables
    are padded to the max model count, pool arrays to the max slot
    count, signals to the max (ticks, edges) shape; policies become
    per-replica :class:`PolicyParams`.  Policies must agree on
    ``adapt_window`` (an estimator buffer shape).
    """
    dev = resolve_device(device)
    pols = [_resolve_policy(p) for _, p, _, _ in runs]
    windows = {p.adapt_window for p in pols}
    if len(windows) > 1:
        raise ValueError(
            f"build_fleet_batch: policies disagree on adapt_window "
            f"{sorted(windows)} — the estimator buffer is a compiled "
            f"shape, so one batch must share it")
    mmax = max(len(models) for models, _, _, _ in runs)
    smax = max(slots for _, _, _, slots in runs)
    emax = max(sig.arrive.shape[1] for _, _, sig, _ in runs)
    profs, states, cache = [], [], {}
    for (models, _, _, slots), pol in zip(runs, pols):
        # lanes of the same (pool, window, model table) share one init
        key = (slots, pol.adapt_window, tuple(models))
        if key not in cache:
            prof = Profiles.build(models, dev, pad_to=mmax)
            cache[key] = (prof, init_state(prof, emax, pol.adapt_window,
                                           slots, total_slots=smax))
        prof, state = cache[key]
        profs.append(prof)
        states.append(state)
    return FleetBatch(
        profiles=_stack_tree(profs),
        params=_stack_tree([p.params(dev) for p in pols]),
        state=_stack_tree(states),
        signals=pad_signals([sig for _, _, sig, _ in runs], dt, device=dev),
        coop_rounds=max((p.coop_max_transfers for p in pols
                         if p.cooperation), default=0))


def plan_buckets(runs, *, dt: float = 25.0, device="cuda"
                 ) -> list[tuple[FleetBatch, tuple[int, ...]]]:
    """Shape-bucketed planner: exact-shape batches, one per bucket.

    Takes the same ``(models, policy, signals, cloud_slots)`` run list
    as :func:`build_fleet_batch`, but partitions the runs by exact
    ``(ticks, edges, models, coop_rounds, adapt_window)``: within a
    bucket stacking is exact, so no replica pays max-shape padding and
    peer-offload rounds run only in the buckets that need them.

    Returns ``(batch, idxs)`` per bucket, where ``idxs`` maps the
    bucket's replica lanes back to positions in ``runs``.  Bucket results
    equal the padded :func:`build_fleet_batch` / :func:`run_batch` run
    and the per-run :func:`run_fleet` loop bitwise.
    """
    buckets: dict = {}
    for i, run in enumerate(runs):
        models, policy, sig, _slots = run
        pol = _resolve_policy(policy)
        t, e, _m = sig.arrive.shape
        key = (t, e, len(models),
               pol.coop_max_transfers if pol.cooperation else 0,
               pol.adapt_window)
        bucket = buckets.setdefault(key, ([], []))
        bucket[0].append(run)
        bucket[1].append(i)
    return [(build_fleet_batch(rs, dt=dt, device=device), tuple(idxs))
            for rs, idxs in buckets.values()]


def run_batch(batch: FleetBatch, *, dt: float = 25.0,
              edge_frac: float = 0.62, cloud_frac: float = 0.80,
              record_trace: bool = False, trace: Optional[TraceSpec] = None,
              donate: bool = False, chunk_ticks: Optional[int] = None,
              mesh=None):
    """Run a heterogeneous :class:`FleetBatch` under one set of launches
    a tick, on the batch's device.

    Every replica — its own scenario shape, policy flags, model table and
    pool depth — runs in the same tick; per-replica slices of the
    returned ``[R, E, …]`` state equal the corresponding :func:`run_fleet`
    call exactly (padding is a no-op by construction).  ``trace`` (or
    ``record_trace``) returns a :class:`FleetResult` whose streams lead
    with the replica axis; padded (tick, edge) cells record zero events.
    ``chunk_ticks`` replays the horizon in windows and ``donate=True``
    updates the carry in place (``batch.state`` itself survives), both
    bitwise alike.

    ``mesh`` (a DeviceMesh, one process a rank) splits the (replica,
    edge) grid: replicas over its first axis, and on a 2-D mesh the edges
    over its second, with peer offload exchanged across the edge ranks.
    An axis that does not divide its dimension leaves it whole.  Every
    rank returns the whole, gathered result, bitwise the unsharded one.
    """
    tspec = resolve_spec(trace, record_trace)
    prog = FleetProgram(dt=dt, edge_frac=edge_frac, cloud_frac=cloud_frac,
                        coop_rounds=batch.coop_rounds, trace=tspec,
                        donate=donate)
    return _run_split(prog, batch.profiles, batch.params, batch.state,
                      batch.signals, chunk_ticks, mesh, shared=False)


def simulate_fleet(models, policy: str, *, n_edges: int,
                   drones_per_edge: int = 3, duration_ms: float = 300_000.0,
                   dt: float = 25.0, edge_frac: float = 0.62,
                   cloud_frac: float = 0.80, cloud_slots: int = CLOUD_SLOTS,
                   theta_fn=None, bw_fn=None, seed: int = 0,
                   mesh=None, device="cuda") -> EdgeState:
    """Simulate ``n_edges`` base stations under the paper's steady
    workload; returns the final stacked state (``mesh`` as in
    :func:`run_fleet`)."""
    signals = default_signals(len(models), n_edges=n_edges,
                              drones_per_edge=drones_per_edge,
                              duration_ms=duration_ms, dt=dt,
                              theta_fn=theta_fn, bw_fn=bw_fn, seed=seed,
                              device=device)
    return run_fleet(models, policy, signals, dt=dt, edge_frac=edge_frac,
                     cloud_frac=cloud_frac, cloud_slots=cloud_slots,
                     mesh=mesh, device=device)
