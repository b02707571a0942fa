"""Frozen copy of the port's array-encoded scheduling decisions
(``repro_torch/core/sched.py``), with the selection kernel replaced by
its plain version (:mod:`portbench.reference.argext`).  Part of the
benchmark's plain reference: it imports nothing of the program.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from portbench.reference import argext as sched_ops

NEG = -1e30
POS = 1e30


def _col(x):
    """Per-edge value → broadcastable against ``[..., Q]`` leaves (a
    number or a 0-d tensor broadcasts as it is)."""
    return x.unsqueeze(-1) if isinstance(x, torch.Tensor) and x.dim() \
        else x


def take(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]`` per edge: a shared ``[M]`` table is indexed
    directly, a per-edge ``[..., M]`` table (or a per-replica one whose
    edge axis is 1, broadcast over the edges as a view) is gathered along
    its last axis with ``ids`` of shape ``[..., K]`` or ``[...]``.
    Gather and scatter indices are int64 (``.long()`` is free on int64
    ids), the dtype every PyTorch release takes."""
    if table.dim() == 1:
        return table[ids]
    one = ids.dim() == table.dim() - 1
    lead = ids.shape if one else ids.shape[:-1]
    if table.shape[:-1] != lead:
        table = table.expand(lead + table.shape[-1:])
    if one:
        return table.gather(-1, ids.long().unsqueeze(-1)).squeeze(-1)
    return table.gather(-1, ids.long())


def segment_add(acc: torch.Tensor, ids: torch.Tensor,
                vals: torch.Tensor) -> torch.Tensor:
    """``acc + jax.ops.segment_sum(vals, ids)`` per edge, along the last
    axis, for integer counters (``scatter_add`` is exact and
    deterministic on integers)."""
    return acc.scatter_add(-1, ids.long(), vals.to(acc.dtype))


def segment_sum(vals: torch.Tensor, ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """Per-edge ``jax.ops.segment_sum`` along the last axis (integers)."""
    out = torch.zeros(vals.shape[:-1] + (num_segments,), dtype=torch.int32,
                      device=vals.device)
    return segment_add(out, ids, vals)


def seq_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis, left to right: the reference's reduction
    order for f32 rows, identical on the host and the card."""
    acc = x[..., 0]
    for i in range(1, x.shape[-1]):
        acc = acc + x[..., i]
    return acc


class EdgeQueue(NamedTuple):
    """Array-encoded edge priority queue (capacity = last axis length)."""

    valid: torch.Tensor     # bool[..., Q]
    key: torch.Tensor       # f32[..., Q]  policy priority
    seq: torch.Tensor       # i32[..., Q]  insertion counter (tie-break)
    t_edge: torch.Tensor    # f32[..., Q]  expected edge latency t_i
    deadline: torch.Tensor  # f32[..., Q]  scheduling deadline
    abs_dl: torch.Tensor    # f32[..., Q]  absolute deadline (success)
    model: torch.Tensor     # i32[..., Q]


class CloudQueue(NamedTuple):
    """Array-encoded trigger-time cloud queue (§5.3)."""

    valid: torch.Tensor       # bool[..., Qc]
    trigger: torch.Tensor     # f32[..., Qc]
    t_edge: torch.Tensor      # f32[..., Qc] expected *edge* latency
    deadline: torch.Tensor    # f32[..., Qc] absolute deadline
    steal_only: torch.Tensor  # bool[..., Qc] negative-cloud-utility parkees
    rank: torch.Tensor        # f32[..., Qc] (γ^E−γ^C)/t_i steal rank


def empty_edge_queue(capacity: int, lead: tuple = (), *,
                     device) -> EdgeQueue:
    shape = tuple(lead) + (capacity,)

    def z(dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=device)

    return EdgeQueue(valid=z(torch.bool), key=z(), seq=z(torch.int32),
                     t_edge=z(), deadline=z(), abs_dl=z(),
                     model=z(torch.int32))


def empty_cloud_queue(capacity: int, lead: tuple = (), *,
                      device) -> CloudQueue:
    shape = tuple(lead) + (capacity,)

    def z(dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=device)

    return CloudQueue(valid=z(torch.bool), trigger=z(), t_edge=z(),
                      deadline=z(), steal_only=z(torch.bool), rank=z())


# ---------------------------------------------------------------------------
# ordering helpers
# ---------------------------------------------------------------------------

def earlier_matrix(q: EdgeQueue) -> torch.Tensor:
    """``earlier[..., i, j]`` — slot j precedes slot i in (key, seq)
    lexicographic order (the oracle's stable insertion).  It depends on
    keys only, so callers that change just ``valid`` can keep it and
    re-mask with :func:`ahead_from`."""
    ki, kj = q.key.unsqueeze(-1), q.key.unsqueeze(-2)
    si, sj = q.seq.unsqueeze(-1), q.seq.unsqueeze(-2)
    return (kj < ki) | ((kj == ki) & (sj < si))


def ahead_from(earlier: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """``ahead[..., i, j]`` — valid task j sits ahead of task i."""
    return earlier & valid.unsqueeze(-2)


def _ahead_matrix(q: EdgeQueue) -> torch.Tensor:
    return ahead_from(earlier_matrix(q), q.valid)


def ahead_of_new(q: EdgeQueue, new_key) -> torch.Tensor:
    """Queued tasks ahead of a to-be-inserted task (inserted after equal
    keys, so everything with ``key <= new_key``)."""
    return q.valid & (q.key <= _col(new_key))


def _completions(q: EdgeQueue, ahead: torch.Tensor, now,
                 busy_rem) -> torch.Tensor:
    wait = (ahead * q.t_edge.unsqueeze(-2)).sum(-1)
    return _col(now + busy_rem) + wait + q.t_edge


def projected_completions(q: EdgeQueue, now, busy_rem,
                          ahead=None) -> torch.Tensor:
    """Projected completion time of every queued task (§5.2)."""
    ahead = _ahead_matrix(q) if ahead is None else ahead
    return _completions(q, ahead, now, busy_rem)


# ---------------------------------------------------------------------------
# §5.1 / §8.2 — edge-queue priority keys
# ---------------------------------------------------------------------------

PRIO_EDF = 0   # absolute scheduling deadline t'_j + δ_i (§5.1)
PRIO_HPF = 1   # highest utility-per-edge-second first (§8.2)
PRIO_SJF = 2   # shortest job first (SJF-E+C / Dedas ordering)


def edge_priority_key(prio, sched_deadline, t_edge_eff,
                      gamma_e) -> torch.Tensor:
    """The oracle's ``Policy.edge_key`` selected by the runtime code
    ``prio``; lower key = higher priority."""
    hpf = -gamma_e / t_edge_eff
    return torch.where(prio == PRIO_HPF, hpf,
                       torch.where(prio == PRIO_SJF, t_edge_eff,
                                   sched_deadline))


# ---------------------------------------------------------------------------
# §5.1 — insertion feasibility; §8.2 — SOTA2 mean completion time
# ---------------------------------------------------------------------------

def insert_feasible(q: EdgeQueue, now, busy_rem, new_key, new_t_edge,
                    new_deadline) -> torch.Tensor:
    """Sum of execution times ahead + own ≤ deadline (paper §5.1)."""
    wait = torch.where(ahead_of_new(q, new_key), q.t_edge, 0.0).sum(-1)
    return now + busy_rem + wait + new_t_edge <= new_deadline


def act_improves(q: EdgeQueue, now, busy_rem, new_key, new_t_edge,
                 proj=None) -> torch.Tensor:
    """Dedas tie-break: inserting keeps the mean projected completion
    time of the queue (with the new task) at or below the mean without
    it; an empty queue compares against +inf.  ``proj`` may pass in the
    queue's :func:`projected_completions`.

    The queue's completion-time sum is taken in PyTorch's reduction
    order, not the reference's left-to-right one (a sequential sum would
    cost ``Q`` launches per arrival); the two can differ in the last
    bits, which can flip this comparison only at an exact tie of means.
    """
    proj = projected_completions(q, now, busy_rem) if proj is None else proj
    ahead = ahead_of_new(q, new_key)
    behind = q.valid & ~ahead
    n = q.valid.sum(-1)
    proj_sum = torch.where(q.valid, proj, 0.0).sum(-1)
    act_before = torch.where(n > 0, proj_sum / n.clamp(min=1), POS)
    new_proj = (now + busy_rem + torch.where(ahead, q.t_edge, 0.0).sum(-1)
                + new_t_edge)
    after_sum = (proj_sum + torch.where(behind, _col(new_t_edge), 0.0).sum(-1)
                 + new_proj)
    return after_sum / (n + 1) <= act_before


# ---------------------------------------------------------------------------
# §5.2 — migration: victims and Eqn-3 scoring
# ---------------------------------------------------------------------------

def victim_mask(q: EdgeQueue, now, busy_rem, new_key, new_t_edge,
                proj=None) -> torch.Tensor:
    """Tasks *newly* pushed past their deadline by inserting the new task
    (``proj`` may pass in the queue's :func:`projected_completions`)."""
    proj = projected_completions(q, now, busy_rem) if proj is None else proj
    behind = q.valid & (q.key > _col(new_key))
    return behind & (proj <= q.deadline) & (q.deadline
                                             < proj + _col(new_t_edge))


def eqn3_scores(model_ids, now, deadlines, gamma_e, gamma_c,
                t_cloud_cur) -> torch.Tensor:
    """Eqn 3: S = γ^E−γ^C if cloud-feasible ∧ γ^C>0 else γ^E."""
    ge = take(gamma_e, model_ids)
    gc = take(gamma_c, model_ids)
    feasible = _col(now) + take(t_cloud_cur, model_ids) <= deadlines
    return torch.where(feasible & (gc > 0), ge - gc, ge)


def migration_decision(q: EdgeQueue, victims, now, new_model, new_deadline,
                       gamma_e, gamma_c, t_cloud_cur) -> torch.Tensor:
    """True → insert new task, migrate victims; False → redirect new (§5.2)."""
    s_victims = torch.where(
        victims, eqn3_scores(q.model, now, q.deadline, gamma_e, gamma_c,
                             t_cloud_cur), 0.0).sum(-1)
    s_new = eqn3_scores(new_model.unsqueeze(-1), now,
                        _col(new_deadline), gamma_e, gamma_c,
                        t_cloud_cur).squeeze(-1)
    return s_victims < s_new


# ---------------------------------------------------------------------------
# §5.3 — work stealing
# ---------------------------------------------------------------------------

def max_front_delay(q: EdgeQueue, now, busy_rem, ahead=None) -> torch.Tensor:
    """Largest execution time insertable at the queue head without
    pushing any queued task past its deadline; +inf when empty."""
    proj = projected_completions(q, now, busy_rem, ahead)
    return torch.where(q.valid, q.deadline - proj, POS).amin(-1)


def head_mask(q: EdgeQueue, ahead: torch.Tensor) -> torch.Tensor:
    """The valid task with nothing ahead of it (all False when empty)."""
    return q.valid & ~ahead.any(-1)


def head_slack(q: EdgeQueue, now, is_head=None) -> torch.Tensor:
    """σ of the head task: (t'_j+δ_i) − (now + t_i); +inf if empty."""
    is_head = head_mask(q, _ahead_matrix(q)) if is_head is None else is_head
    return torch.where(is_head, q.deadline - (_col(now) + q.t_edge),
                       POS).amin(-1)


def steal_select(cq: CloudQueue, q: EdgeQueue, now, busy_rem,
                 min_edge_t, ahead=None, is_head=None) -> torch.Tensor:
    """Index of the cloud-queue task to steal, or −1 (§5.3).

    Eligibility: fits in the front-insertion margin, still edge-feasible.
    Preference: steal-only (negative cloud utility) tasks first, then by
    descending rank (γ^E−γ^C)/t_i — one masked arg-max over the queue.
    ``ahead`` / ``is_head`` may pass in the queue's ahead matrix and
    head mask.
    """
    ahead = _ahead_matrix(q) if ahead is None else ahead
    is_head = head_mask(q, ahead) if is_head is None else is_head
    any_queued = q.valid.any(-1)
    slack = head_slack(q, now, is_head)
    delay_cap = torch.where(any_queued,
                            max_front_delay(q, now, busy_rem, ahead), POS)
    gate = torch.where(any_queued, slack > min_edge_t, True)
    eligible = (cq.valid & (cq.t_edge <= _col(delay_cap))
                & (_col(now) + cq.t_edge <= cq.deadline) & _col(gate))
    # lexicographic (steal_only desc, rank desc) via one f32 score
    score = torch.where(cq.steal_only, 1e12, 0.0) + cq.rank
    idx, _ = sched_ops.masked_argmax(score, eligible)
    return idx


# ---------------------------------------------------------------------------
# cross-edge peer offload (fleet-scope work stealing, beyond-paper)
# ---------------------------------------------------------------------------

def queue_load(q: EdgeQueue, busy_rem) -> torch.Tensor:
    """Total pending edge work: banked execution time + queued t_edge."""
    return busy_rem.clamp(min=0.0) + torch.where(q.valid, q.t_edge,
                                                 0.0).sum(-1)


def queue_slacks(q: EdgeQueue, now, busy_rem) -> torch.Tensor:
    """Per-slot slack (deadline − projected completion); +inf for empties."""
    proj = projected_completions(q, now, busy_rem)
    return torch.where(q.valid, q.deadline - proj, POS)


def export_select(q: EdgeQueue, now, busy_rem, dst_load,
                  slack_thresh) -> torch.Tensor:
    """Index of the worst-slack queued task that is below
    ``slack_thresh`` yet still feasible behind the destination's load,
    or −1."""
    slacks = queue_slacks(q, now, busy_rem)
    feasible_dst = _col(now + dst_load) + q.t_edge <= q.deadline
    cand = q.valid & feasible_dst & (slacks < _col(slack_thresh))
    idx, _ = sched_ops.masked_argmin(slacks, cand)
    return idx


# ---------------------------------------------------------------------------
# §6 — GEMS window helpers (Alg. 1)
# ---------------------------------------------------------------------------

def gems_reschedule_mask(q: EdgeQueue, now, lag_model, t_cloud_cur,
                         gamma_c) -> torch.Tensor:
    """Pending edge tasks of the lagging model to push to the cloud."""
    positive = take(gamma_c, lag_model) > 0
    feasible = _col(now + take(t_cloud_cur, lag_model)) <= q.deadline
    return (q.valid & (q.model == _col(lag_model)) & feasible
            & _col(positive))


def window_update(lam, lam_hat, success):
    """Alg. 1 lines 3–7: increment counts, return the incremental rate."""
    lam = lam + 1
    lam_hat = lam_hat + success.to(lam_hat.dtype)
    return lam, lam_hat, lam_hat / lam


def gems_winnable(lam, lam_hat, prev_lam, alpha, now, win_end,
                  window) -> torch.Tensor:
    """GEMS-B: can α̂ still reach α this window?  Remaining arrivals are
    forecast from the previous window's count, prorated by the fraction
    of the window left."""
    frac_left = ((win_end - _col(now)) / window).clamp(min=0.0)
    remaining = torch.maximum(prev_lam, lam) * frac_left
    return lam_hat + remaining >= alpha * (lam + remaining) - 1e-9


# ---------------------------------------------------------------------------
# §5.4 — DEMS-A adaptation
# ---------------------------------------------------------------------------

class AdaptState(NamedTuple):
    buf: torch.Tensor            # f32[..., M, w] circular buffers
    count: torch.Tensor          # i32[..., M] observations so far (≤ w)
    idx: torch.Tensor            # i32[..., M] next write slot
    current: torch.Tensor        # f32[..., M] current estimates t̂
    cooling_start: torch.Tensor  # f32[..., M]; −1 = not cooling


def adapt_init(static: torch.Tensor, w: int, lead: tuple = ()) -> AdaptState:
    m = static.shape[-1]
    shape = tuple(lead) + (m,)
    dev = static.device
    return AdaptState(
        buf=torch.zeros(shape + (w,), device=dev),
        count=torch.zeros(shape, dtype=torch.int32, device=dev),
        idx=torch.zeros(shape, dtype=torch.int32, device=dev),
        current=static.expand(shape).clone(),
        cooling_start=torch.full(shape, -1.0, device=dev))


def adapt_observe(st: AdaptState, model, obs, eps: float) -> AdaptState:
    """One observation of ``model`` (the reference's ``adapt_observe``, a
    state without a leading axis): append until the buffer fills (write
    position = count), then overwrite circularly; t̂ rises to the
    window's average when that clears it by more than ``eps``."""
    w = st.buf.shape[-1]
    cnt, at = st.count[model], st.idx[model]
    filling = cnt < w
    buf = st.buf.clone()
    buf[model, torch.where(filling, cnt, at)] = obs
    count, idx, cur = st.count.clone(), st.idx.clone(), st.current.clone()
    count[model] = torch.clamp(cnt + 1, max=w)
    idx[model] = torch.where(filling, at, (at + 1) % w)
    avg = buf[model].sum() / count[model]
    cur[model] = torch.where(avg - st.current[model] > eps, avg,
                             st.current[model])
    return AdaptState(buf, count, idx, cur, st.cooling_start)


def adapt_on_sent(st: AdaptState, model) -> AdaptState:
    """A task of ``model`` went to the cloud: its cooling period ends."""
    cs = st.cooling_start.clone()
    cs[model] = -1.0
    return st._replace(cooling_start=cs)


def adapt_select(pred, a: AdaptState, b: AdaptState) -> AdaptState:
    """Elementwise ``where`` over whole estimator states (masked
    updates)."""
    return AdaptState(*(torch.where(pred, x, y) for x, y in zip(a, b)))


def adapt_on_skip(st: AdaptState, model, now, static, t_cp) -> AdaptState:
    """A task of ``model`` stayed on the edge at ``now``: an inflated t̂
    starts cooling, and falls back to ``static`` once ``t_cp`` has
    passed since the cooling began."""
    inflated = st.current[model] > static[model]
    cs = st.cooling_start[model]
    expired = (cs >= 0) & (now - cs >= t_cp)
    cur, new_cs = st.current.clone(), st.cooling_start.clone()
    cur[model] = torch.where(inflated & expired, static[model],
                             st.current[model])
    new_cs[model] = torch.where(~inflated, cs, torch.where(
        expired, -1.0, torch.where(cs < 0, now, cs)))
    return st._replace(current=cur, cooling_start=new_cs)


def adapt_feed_batch(st: AdaptState, model_ids, sent, obs, obs_val, skip,
                     now, static, eps, t_cp, *, with_obs: bool = True,
                     max_obs: int | None = None) -> AdaptState:
    """One batched estimator update for a whole tick's events.

    Per model: every ``sent`` cooling reset applies, then all ``obs``
    observations land in slot order (their values are equal within one
    call), then at most one ``skip``.  Same semantics, caveats and
    ``max_obs`` bound as ``repro.core.jax_sched.adapt_feed_batch``; with
    all masks False the state comes back bit-identical; ``sent=None``
    (with ``with_obs=False``) stands for a call with no sends and no
    observations, the skip-only offer path.
    """
    m, w = st.buf.shape[-2:]
    k = model_ids.shape[-1]
    dev = st.buf.device
    model_ids = model_ids.long()
    cs = st.cooling_start if sent is None else torch.where(
        segment_sum(sent, model_ids, m) > 0, -1.0, st.cooling_start)
    cur, buf, count, idx = st.current, st.buf, st.count, st.idx
    if with_obs:
        cnt = segment_sum(obs, model_ids, m)                     # [..., M]
        jmax = k if max_obs is None else min(k, max_obs)
        v = torch.full(cnt.shape, NEG, device=dev).scatter_reduce_(
            -1, model_ids, torch.where(obs, obs_val, NEG), "amax")
        jr = torch.arange(jmax, dtype=torch.int32, device=dev)
        j = jr.view(1, -1)                                       # [1, J]
        fill = (w - count).clamp(min=0).unsqueeze(-1)            # [..., M, 1]
        # the j-th observation of a model writes slot count+j while the
        # buffer fills, then wraps circularly from idx
        pos = torch.where(j < fill, count.unsqueeze(-1) + j,
                          (idx.unsqueeze(-1) + j - fill) % w)    # [..., M, J]
        active = j < cnt.unsqueeze(-1)
        onehot = active.unsqueeze(-1) & (
            pos.unsqueeze(-1) == torch.arange(w, device=dev))    # [..,M,J,w]
        written_upto = torch.cumsum(onehot.int(), dim=-2) > 0
        buf = torch.where(written_upto[..., -1, :], v.unsqueeze(-1), buf)
        # the ratchet is path dependent (an average only sticks when it
        # clears cur+eps): replay the per-observation averages
        sums = seq_sum(st.buf).unsqueeze(-1) + seq_sum(torch.where(
            written_upto, v[..., None, None] - st.buf.unsqueeze(-2), 0.0))
        nobs = (count.unsqueeze(-1) + 1 + jr).clamp(max=w)
        # inactive steps read -inf, which never clears cur + eps
        avgs = torch.where(active, sums / nobs, float("-inf"))
        for jj in range(jmax):
            a = avgs[..., jj]
            cur = torch.where(a - cur > _col(eps), a, cur)
        count = (st.count + cnt).clamp(max=w)
        idx = (st.idx + (cnt - torch.minimum((w - st.count).clamp(min=0),
                                             cnt))) % w
    any_skip = segment_sum(skip, model_ids, m) > 0
    inflated = cur > static
    expired = (cs >= 0) & (_col(now) - cs >= _col(t_cp))
    new_cur = torch.where(any_skip & inflated & expired, static, cur)
    new_cs = torch.where(
        any_skip,
        torch.where(~inflated, cs,
                    torch.where(expired, -1.0,
                                torch.where(cs < 0, _col(now), cs))),
        cs)
    return AdaptState(buf, count, idx, new_cur, new_cs)


# ---------------------------------------------------------------------------
# queue mutation helpers (used by the fleet simulator)
# ---------------------------------------------------------------------------

def _onehot(idx: torch.Tensor, n: int) -> torch.Tensor:
    return torch.arange(n, device=idx.device) == idx.unsqueeze(-1)


def edge_push(q: EdgeQueue, key, seq, t_edge, deadline, model,
              enable=True, abs_dl=None) -> tuple[EdgeQueue, torch.Tensor]:
    """Insert into each edge's first free slot; returns (queue, ok)."""
    abs_dl = deadline if abs_dl is None else abs_dl
    free = ~q.valid
    slot = torch.argmax(free.int(), dim=-1)
    ok = free.any(-1) & enable
    hit = _onehot(slot, free.shape[-1]) & ok.unsqueeze(-1)

    def set_at(arr, v):
        return torch.where(hit, _col(v), arr)

    return EdgeQueue(
        valid=q.valid | hit, key=set_at(q.key, key), seq=set_at(q.seq, seq),
        t_edge=set_at(q.t_edge, t_edge), deadline=set_at(q.deadline,
                                                         deadline),
        abs_dl=set_at(q.abs_dl, abs_dl), model=set_at(q.model, model)), ok


def cloud_push(cq: CloudQueue, trigger, t_edge, deadline, steal_only,
               rank, enable=True) -> tuple[CloudQueue, torch.Tensor]:
    """Insert into each cloud queue's first free slot; returns (queue,
    ok)."""
    free = ~cq.valid
    slot = torch.argmax(free.int(), dim=-1)
    ok = free.any(-1) & enable
    hit = _onehot(slot, free.shape[-1]) & ok.unsqueeze(-1)

    def set_at(arr, v):
        return torch.where(hit, _col(torch.as_tensor(v, dtype=arr.dtype,
                                                     device=arr.device)),
                           arr)

    return CloudQueue(
        valid=cq.valid | hit, trigger=set_at(cq.trigger, trigger),
        t_edge=set_at(cq.t_edge, t_edge),
        deadline=set_at(cq.deadline, deadline),
        steal_only=set_at(cq.steal_only, steal_only),
        rank=set_at(cq.rank, rank)), ok


def cloud_remove(cq: CloudQueue, idx) -> CloudQueue:
    """Drop slot ``idx`` of each cloud queue."""
    idx = torch.as_tensor(idx, device=cq.valid.device)
    return cq._replace(valid=cq.valid & ~_onehot(idx, cq.valid.shape[-1]))


def edge_pop_head(q: EdgeQueue, ahead=None, is_head=None):
    """Remove and return the head (index, found) by (key, seq) order
    (``ahead`` / ``is_head`` may pass in the queue's ahead matrix and
    head mask)."""
    if is_head is None:
        ahead = _ahead_matrix(q) if ahead is None else ahead
        is_head = head_mask(q, ahead)
    idx = torch.argmax(is_head.int(), dim=-1)
    found = is_head.any(-1)
    drop = _onehot(idx, is_head.shape[-1]) & found.unsqueeze(-1)
    return q._replace(valid=q.valid & ~drop), idx, found


def edge_remove(q: EdgeQueue, mask: torch.Tensor) -> EdgeQueue:
    return q._replace(valid=q.valid & ~mask)
