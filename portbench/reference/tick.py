"""The fleet tick in plain PyTorch: the benchmark's reference.

A frozen copy of the port's tick (``repro_torch/sim/fleet.py`` at the
commit that defined the benchmark: ``make_step``, ``peer_offload`` and
what they call), cut to one fleet on one device and run eagerly, tick by
tick, with the selection kernel's plain version.  No CUDA graph, program
cache, mesh or replica axis.  The policy table is the port's
``core/schedulers.py`` one, copied.  It imports nothing of the program,
so a later change to the program cannot move it.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from portbench.reference import argext as sched_ops
from portbench.reference import sched as js
from portbench.reference import trace as obs_trace
from portbench.reference.trace import (TickCounters, TraceSpec, hist_counts,
                                       zero_counters)

SEGMENT_KB = 38.0          # 1 s video segment size (§8.1)
NOMINAL_BW_MBPS = 20.0     # bandwidth assumed by the t̂ benchmarks


class network:
    """The one latency helper the tick reads (the port's
    ``sim/network.py``)."""

    @staticmethod
    def bandwidth_penalty_ms(bw_mbps: torch.Tensor,
                             segment_kb: float = SEGMENT_KB) -> torch.Tensor:
        clipped = bw_mbps.clamp(min=1e-3)
        return (torch.full_like(clipped, segment_kb * 8.0) / clipped
                - segment_kb * 8.0 / NOMINAL_BW_MBPS)


def resolve_device(device) -> torch.device:
    return torch.device(device)


class _sched:
    """The policy table of ``repro_torch/core/schedulers.py``."""

    _POLICIES = {
        "EDF":     dict(use_cloud=False, edge_feasibility_check=False),
        "HPF":     dict(use_cloud=False, edge_feasibility_check=False,
                        edge_priority="hpf"),
        "CLD":     dict(use_edge=False),
        "EDF-E+C": dict(),
        "SJF-E+C": dict(edge_priority="sjf", cloud_accepts_negative=True),
        "SOTA1":   dict(sota1=True),
        "SOTA2":   dict(edge_priority="sjf", sota2=True),
        "DEM":     dict(migration=True),
        "DEMS":    dict(migration=True, stealing=True),
        "DEMS-A":  dict(migration=True, stealing=True, adaptive=True),
        "GEMS":    dict(migration=True, stealing=True, gems=True),
        "GEMS-A":  dict(migration=True, stealing=True, gems=True,
                        adaptive=True),
        "GEMS-B":  dict(migration=True, stealing=True, gems=True,
                        gems_budget=True),
    }

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


def run_mission(models, policy: str, signals: FleetSignals, *, dt: float,
                edge_frac: float, cloud_frac: float, cloud_slots: int,
                counters: bool = False, quantize=None):
    """One mission, tick by tick, on the signals' device.  Returns the
    final :class:`EdgeState` and, with ``counters``, the per-tick
    :class:`TickCounters` stacked on the tick axis.  ``quantize`` (a
    function of a float tensor) is applied to every float leaf of the
    state after each tick and to the float inputs: the lower-precision
    control (the program never takes it)."""
    pol = FleetPolicy.from_name(policy)
    dev = signals.times.device
    prof = Profiles.build(models, dev)
    pp = pol.params(dev)
    q = (lambda a: a) if quantize is None else (
        lambda a: quantize(a) if a.is_floating_point() else a)
    if quantize is not None:
        prof = Profiles(*(q(a) for a in prof))
        signals = FleetSignals(*(q(a) for a in signals))
    state = init_state(prof, signals.arrive.shape[1], pol.adapt_window,
                       cloud_slots)
    step = make_step(dt, edge_frac, cloud_frac,
                     TraceSpec(counters=counters))
    rounds = pol.coop_max_transfers if pol.cooperation else 0
    ticks = []
    with torch.inference_mode():
        for t in range(signals.times.shape[0]):
            row = tuple(a[t] for a in signals)
            state, tick = step(prof, pp, state, row)
            if rounds:
                pre_out, pre_in = state.n_peer_out, state.n_peer_in
                state = peer_offload(
                    state, row[0] + dt, pp.coop_slack_ms, rounds,
                    enable=pp.cooperation,
                    transfer_cap=pp.coop_transfer_cap,
                    edge_valid=row[7] & row[9])
                if tick is not None:
                    tick = tick._replace(
                        peer_out=tick.peer_out + state.n_peer_out - pre_out,
                        peer_in=tick.peer_in + state.n_peer_in - pre_in)
            if quantize is not None:
                state = _map_tree(q, state)
            if tick is not None:
                ticks.append(tick)
    stacked = TickCounters(*(torch.stack(xs) for xs in zip(*ticks))) \
        if counters else None
    return state, stacked


def _map_tree(fn, tree):
    if isinstance(tree, tuple):
        return type(tree)(*(_map_tree(fn, v) for v in tree))
    return fn(tree)


def fleet_summary(final) -> dict:
    """Scalar fleet-level metrics of a final state (the port's
    ``scenarios/runner.py::fleet_summary``, copied)."""
    def host(a):
        return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
            else np.asarray(a)
    success = int(host(final.n_success).sum())
    miss = int(host(final.n_miss).sum())
    drop = int(host(final.n_drop).sum())
    settled = max(success + miss + drop, 1)
    return dict(
        completed=success, missed=miss, dropped=drop,
        completion_rate=success / settled,
        qos_utility=float(host(final.qos_utility).sum()),
        qoe_utility=float(host(final.qoe_utility).sum()),
        stolen=int(host(final.n_stolen).sum()),
        peer_offloaded=int(host(final.n_peer_out).sum()))
