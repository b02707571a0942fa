"""Drive a scenario through either simulator and merge results (a copy
of ``repro.scenarios.runner``).

``run_scenario_oracle`` runs one discrete-event :class:`Simulator` per
edge site (each with its own θ trace, outage windows and speed-scaled
model table; ``*-COOP`` policies in the lockstep :class:`FleetOracle`)
and merges the per-edge :class:`Results` on the host.
``run_scenario_fleet`` lowers the same spec to dense tick signals on a
device and runs the port's fleet tick program, optionally with the
flight recorder; ``fleet_summary`` reads its final stacked state.
``stream_scenario_fleet`` feeds the same signals window by window
through the online :class:`~repro_torch.serve.controller.FleetController`,
and ``assert_streaming_equivalence`` holds the two bitwise.
``run_scenario_fleet_batch`` runs one scenario over many seeds as one
batch, and ``run_registry_sweep`` scenarios × policies × seeds as
exact-shape buckets or one padded batch.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.schedulers import make_policy
from repro_torch.scenarios.compile import (compile_exec_jitter,
                                           compile_fleet,
                                           compile_fleet_batch,
                                           compile_oracle,
                                           compile_registry_batch,
                                           compile_registry_groups)
from repro_torch.scenarios.spec import ScenarioSpec
from repro_torch.sim import fleet as F
from repro_torch.sim.engine import FleetOracle, ModelStats, Results, Simulator
from repro_torch.sim.network import (CloudLatencyModel, EdgeLatencyModel,
                                     TableCloudLatencyModel,
                                     TableEdgeLatencyModel)


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def fleet_summary(final) -> dict[str, float]:
    """Scalar fleet-level metrics from a stacked final ``EdgeState``
    (tensors on any device, or numpy arrays)."""
    success = int(_host(final.n_success).sum())
    miss = int(_host(final.n_miss).sum())
    drop = int(_host(final.n_drop).sum())
    settled = max(success + miss + drop, 1)
    return dict(
        completed=success, missed=miss, dropped=drop,
        completion_rate=success / settled,
        qos_utility=float(_host(final.qos_utility).sum()),
        qoe_utility=float(_host(final.qoe_utility).sum()),
        stolen=int(_host(final.n_stolen).sum()),
        peer_offloaded=int(_host(final.n_peer_out).sum()))


def merge_results(results: list[Results]) -> Results:
    """Fleet-wide totals: per-model stats summed across edge sites."""
    per_model: dict[str, ModelStats] = {}
    for r in results:
        for name, st in r.per_model.items():
            agg = per_model.setdefault(name, ModelStats())
            for f in dataclasses.fields(ModelStats):
                setattr(agg, f.name,
                        getattr(agg, f.name) + getattr(st, f.name))
    # duration = total edge-time so edge_utilization reads as fleet average
    return Results(policy=results[0].policy if results else "?",
                   duration=sum(r.duration for r in results),
                   per_model=per_model,
                   edge_busy=sum(r.edge_busy for r in results))


@dataclasses.dataclass
class OracleScenarioRun:
    spec: ScenarioSpec
    per_edge: list[Results]
    merged: Results


def run_scenario_oracle(spec: ScenarioSpec, policy: str, *,
                        edge_model: EdgeLatencyModel | None = None,
                        cloud_concurrency: int | None = None,
                        cloud_model_overrides: dict | None = None,
                        cloud_give_up_ms: float = float("inf"),
                        dt: float = 25.0,
                        **policy_overrides) -> OracleScenarioRun:
    """One event-driven Simulator per edge site.

    ``cloud_concurrency`` defaults to ``spec.cloud_concurrency`` (each
    edge's share of the bounded FaaS pool); ``cloud_model_overrides``
    replaces :class:`CloudLatencyModel` fields (e.g. ``sigma=1e-6`` for
    deterministic fleet-agreement comparisons) while the compiled θ and
    bandwidth traces stay attached.

    With ``spec.jitter`` set, both latency models become table-backed
    (:class:`~repro_torch.sim.network.TableEdgeLatencyModel` /
    :class:`~repro_torch.sim.network.TableCloudLatencyModel`) over the *same*
    per-(tick, model) sample tables the fleet simulator consumes as its
    ``exec_jit`` lane — same-sample fleet-vs-oracle comparisons.

    With ``spec.faults`` set, the compiled chaos lowering rides along:
    flood arrivals are already merged into each edge's stream, θ/bw
    traces carry the jamming and brownout overlays, partitions surface
    as per-edge zero-cold outage windows and edge crashes as
    ``edge_down_windows``.  ``cloud_give_up_ms`` bounds how long a
    parked cloud dispatch waits before being abandoned — pass the same
    value as the fleet side's ``FleetPolicy.cloud_give_up_ms`` for
    agreement runs.

    A ``*-COOP`` policy runs the per-edge simulators through the
    :class:`~repro_torch.sim.engine.FleetOracle` lockstep wrapper (base policy
    on each edge + cross-edge peer offload between ``dt`` slices,
    mirroring the fleet's exchange); silo policies keep the independent
    per-edge loop.
    """
    coop = policy.endswith("-COOP")
    base_policy = policy[:-5] if coop else policy
    compiled = compile_oracle(spec)
    jit_tables = None
    if spec.jitter is not None:
        jit_tables = compile_exec_jitter(spec, dt)
        if edge_model is None:
            edge_model = TableEdgeLatencyModel(
                table=jit_tables[0], names=spec.model_names, dt=dt)
    sims: list[Simulator] = []
    for e, arrivals in enumerate(compiled.edge_arrivals):
        shaping = dict(latency_at=compiled.theta_fns[e],
                       bandwidth_at=compiled.bw_fns[e])
        if jit_tables is not None:
            cloud_model = TableCloudLatencyModel(
                table=jit_tables[1], names=spec.model_names, dt=dt,
                **shaping, **(cloud_model_overrides or {}))
        else:
            cloud_model = CloudLatencyModel(
                **shaping, **(cloud_model_overrides or {}))
        sims.append(Simulator(
            make_policy(base_policy, **policy_overrides), arrivals,
            spec.duration_ms,
            cloud_concurrency=spec.cloud_concurrency
            if cloud_concurrency is None else cloud_concurrency,
            edge_model=edge_model, cloud_model=cloud_model,
            cloud_outages=compiled.edge_outages[e]
            if compiled.edge_outages is not None else compiled.outages,
            edge_down_windows=compiled.crashes[e]
            if compiled.crashes is not None else (),
            cloud_give_up_ms=cloud_give_up_ms,
            seed=spec.seed + e))
    if coop:
        fp = F.FleetPolicy.from_name(policy)
        per_edge = FleetOracle(
            sims, spec.duration_ms, dt=dt, slack_ms=fp.coop_slack_ms,
            max_transfers=fp.coop_max_transfers).run()
    else:
        per_edge = [sim.run() for sim in sims]
    return OracleScenarioRun(spec=spec, per_edge=per_edge,
                             merged=merge_results(per_edge))


def run_scenario_fleet(spec: ScenarioSpec, policy, *, dt: float = 25.0,
                       edge_frac: float = 0.62, cloud_frac: float = 0.80,
                       mesh=None, record_trace: bool = False, trace=None,
                       device="cuda"):
    """The scenario through the port's fleet tick program; returns the
    final stacked ``EdgeState`` on ``device`` (``mesh`` splits the edges,
    as in :func:`repro_torch.sim.fleet.run_fleet`).

    The signals are compiled on ``device`` by :func:`compile_fleet`, and
    the spec's ``cloud_concurrency`` becomes each edge's finite
    ``cloud_slots`` pool, matching the oracle path slot for slot.
    ``trace`` (a :class:`repro_torch.obs.trace.TraceSpec`;
    ``record_trace`` is the ``TraceSpec(t_hat=True)`` alias) returns a
    ``FleetResult`` carrying the requested flight-recorder streams —
    per-tick adapted t̂ (``[T, E, M]``) and/or decision counters.
    """
    signals = compile_fleet(spec, dt, device=device)
    return F.run_fleet(spec.models, policy, signals, dt=dt,
                       edge_frac=edge_frac, cloud_frac=cloud_frac,
                       cloud_slots=spec.cloud_concurrency, mesh=mesh,
                       record_trace=record_trace, trace=trace, device=device)


def stream_scenario_fleet(spec: ScenarioSpec, policy, *, dt: float = 25.0,
                          window_ticks: int = 16, edge_frac: float = 0.62,
                          cloud_frac: float = 0.80, trace=None,
                          device="cuda"):
    """The scenario through the *online* control plane, window by window.

    Compiles the same dense signals as :func:`run_scenario_fleet`, then
    feeds them through a
    :class:`repro_torch.serve.controller.FleetController` on ``device``
    in ``window_ticks`` chunks via its replay bridge
    (:meth:`~repro_torch.serve.controller.FleetController.step_signals`).
    Returns the controller; its ``state`` is the streamed final
    ``EdgeState``.
    """
    from repro_torch.obs.trace import TraceSpec
    from repro_torch.serve.controller import FleetController

    sig = compile_fleet(spec, dt, device=device)
    ctl = FleetController(
        spec.models, policy, n_edges=spec.n_edges, dt=dt,
        window_ticks=window_ticks, cloud_slots=spec.cloud_concurrency,
        edge_frac=edge_frac, cloud_frac=cloud_frac,
        trace=TraceSpec() if trace is None else trace, device=device)
    n_ticks = int(sig.times.shape[0])
    for lo in range(0, n_ticks, window_ticks):
        ctl.step_signals(F.slice_signals(sig, lo, min(lo + window_ticks,
                                                      n_ticks)))
    return ctl


def assert_streaming_equivalence(spec: ScenarioSpec, policy, *,
                                 dt: float = 25.0, window_ticks: int = 16,
                                 device="cuda") -> dict[str, float]:
    """Replay-vs-streaming bitwise check (the equivalence test hook).

    Runs the scenario both ways — one :func:`run_scenario_fleet` replay
    call and a :class:`~repro_torch.serve.controller.FleetController`
    stepping the identical signals window by window — and raises
    ``AssertionError`` naming the diverging ``EdgeState`` fields unless
    every leaf is bit for bit equal.  Returns the (shared) summary.
    """
    ref = run_scenario_fleet(spec, policy, dt=dt, device=device)
    ctl = stream_scenario_fleet(spec, policy, dt=dt,
                                window_ticks=window_ticks, device=device)
    bad = [name for name, a, b in zip(F.EdgeState._fields, ref, ctl.state)
           if not all(torch.equal(x, y)
                      for x, y in zip(F._leaves(a), F._leaves(b)))]
    if bad:
        raise AssertionError(
            f"streaming EdgeState diverged from replay in fields {bad} "
            f"({spec.name!r}, policy {policy!r}, "
            f"window_ticks={window_ticks})")
    return fleet_summary(ctl.state)


def run_scenario_fleet_batch(spec: ScenarioSpec, policy,
                             seeds: tuple[int, ...], *, dt: float = 25.0,
                             edge_frac: float = 0.62,
                             cloud_frac: float = 0.80, mesh=None,
                             record_trace: bool = False, trace=None,
                             device="cuda"):
    """One scenario × many seeds as one batch on ``device`` (``mesh`` as in
    :func:`repro_torch.sim.fleet.run_fleet_batch`).

    Returns a stacked final ``EdgeState`` with leading ``[R, E]`` axes;
    use :func:`fleet_summary_batch` for per-seed metrics.  ``trace`` /
    ``record_trace`` switch to a ``FleetResult`` with replica-leading
    streams (``t_hat`` ``[R, T, E, M]``).
    """
    signals = compile_fleet_batch(spec, tuple(seeds), dt, device=device)
    return F.run_fleet_batch(spec.models, policy, signals, dt=dt,
                             edge_frac=edge_frac, cloud_frac=cloud_frac,
                             cloud_slots=spec.cloud_concurrency, mesh=mesh,
                             record_trace=record_trace, trace=trace,
                             device=device)


def _to_host(tree):
    """A result tree with every tensor leaf as a host numpy array (one
    copy a leaf; ``None`` streams stay ``None``)."""
    if tree is None:
        return None
    if isinstance(tree, tuple):
        return type(tree)(*(_to_host(v) for v in tree))
    return _host(tree)


def run_registry_sweep(scenarios=None, policies=("DEMS",), seeds=(0,), *,
                       dt: float = 25.0, duration_ms: float | None = None,
                       mesh=None, trace=None, planner: str = "padded",
                       donate: bool = False, device="cuda") -> list[dict]:
    """Scenarios × policies × seeds as batches on ``device``.

    ``planner`` picks the lowering; both give bitwise-identical rows:

    * ``"padded"`` (default) — one max-shape padded batch
      (:func:`repro_torch.scenarios.compile.compile_registry_batch` and
      one :func:`repro_torch.sim.fleet.run_batch`).  The eager tick costs
      the host the same launches whatever its width, so one wide batch
      beats several narrow ones: on an H100 the registry sweep ran about
      six times faster padded than bucketed;
    * ``"bucketed"`` —
      :func:`repro_torch.scenarios.compile.compile_registry_groups`
      partitions the sweep into exact-shape buckets
      (:func:`repro_torch.sim.fleet.plan_buckets`), one batch each, no
      padding.

    ``scenarios`` accepts registry names and/or ad-hoc
    :class:`~repro_torch.scenarios.spec.ScenarioSpec` instances.  Returns
    one summary dict per run, tagged with its (scenario, policy, seed),
    in sweep order.  Each batch's result is copied to the host once,
    after its run.

    ``trace`` (a :class:`repro_torch.obs.trace.TraceSpec`) threads the
    flight recorder through the sweep: each row then also carries a
    ``"trace"`` ``FleetResult`` of host arrays whose streams are
    re-stacked to that run's own ``[T, E, …]`` layout (lanes of the
    edge-flattened lowering concatenated back along the edge axis; under
    the padded planner the model axis stays padded to the batch maximum,
    and padded models never count).  ``donate=True`` updates each
    batch's carry in place (:class:`repro_torch.sim.fleet.FleetProgram`),
    bitwise alike.

    ``mesh`` (a DeviceMesh, one process a rank) splits each batch's
    (replica, edge) grid as :func:`repro_torch.sim.fleet.run_batch` does;
    ``mesh="auto"`` fans each batch's replicas over the largest divisor
    of R up to the world size (a 1-D ``("replica",)`` mesh of the first
    ranks; the others run the batch whole), and none at 1.  Every rank
    returns every row, bitwise the unsharded sweep's.
    """
    traced = trace is not None and trace.enabled
    auto = isinstance(mesh, str) and mesh == "auto"

    def mesh_of(batch):
        return _auto_mesh(int(batch.signals.arrive.shape[0]),
                          batch.state.busy_rem.device) if auto else mesh

    def summarize(res, rows):
        final = res.final if traced else res
        out = []
        for row in rows:
            # a run's lanes are its replicas: one for a multi-edge run,
            # one per edge under the edge-flattened lowering — re-stack
            # them into the run's [E, …] state so fleet_summary reduces
            # the per-edge values as the run_fleet path does
            def restack(tree, axis=0):
                if tree is None:
                    return None
                if isinstance(tree, tuple):
                    return type(tree)(*(restack(v, axis) for v in tree))
                parts = [tree[i] for i in row.lanes]
                return parts[0] if len(parts) == 1 \
                    else np.concatenate(parts, axis=axis)
            state = restack(final)
            d = dict(scenario=row.scenario, policy=row.policy,
                     seed=row.seed, **fleet_summary(state))
            if traced:
                # trace streams are [T, E, …]: lanes rejoin on the edge
                # axis
                d["trace"] = F.FleetResult(
                    final=state, t_hat=restack(res.t_hat, axis=1),
                    counters=restack(res.counters, axis=1))
            out.append(d)
        return out

    if planner == "bucketed":
        by_key = {}
        for batch, rows in compile_registry_groups(
                scenarios, policies, seeds, dt=dt, duration_ms=duration_ms,
                device=device):
            res = _to_host(F.run_batch(batch, dt=dt, trace=trace,
                                       donate=donate, mesh=mesh_of(batch)))
            for d in summarize(res, rows):
                by_key[d["scenario"], d["policy"], d["seed"]] = d
        from repro_torch.scenarios.registry import names
        order = tuple(sc if isinstance(sc, str) else sc.name
                      for sc in scenarios) if scenarios is not None \
            else names()
        return [by_key[sc, pol, seed]
                for sc in order for pol in policies for seed in seeds]
    if planner != "padded":
        raise ValueError(f"unknown planner {planner!r}; "
                         f"choose 'bucketed' or 'padded'")

    batch, rows = compile_registry_batch(scenarios, policies, seeds, dt=dt,
                                         duration_ms=duration_ms,
                                         device=device)
    return summarize(_to_host(F.run_batch(batch, dt=dt, trace=trace,
                                          donate=donate,
                                          mesh=mesh_of(batch))), rows)


# the "auto" meshes built so far, one a (device type, size): each is a
# set of process groups, made once by every rank in the same order
_AUTO_MESHES: dict = {}


def _auto_mesh(n_rep: int, device):
    """The ``mesh="auto"`` mesh of a batch of ``n_rep`` replicas: 1-D
    ``("replica",)`` over the first n ranks, n the largest divisor of
    ``n_rep`` up to the world size; None at 1 (or with no group)."""
    import torch.distributed as dist
    world = dist.get_world_size() if dist.is_initialized() else 1
    n = max(d for d in range(1, world + 1) if n_rep % d == 0)
    if n == 1:
        return None
    key = (device.type, n)
    if key not in _AUTO_MESHES:
        from torch.distributed.device_mesh import DeviceMesh
        _AUTO_MESHES[key] = DeviceMesh(device.type, list(range(n)),
                                       mesh_dim_names=("replica",))
    return _AUTO_MESHES[key]


def fleet_summary_batch(final) -> list[dict[str, float]]:
    """Per-replica summaries from a ``run_fleet_batch`` final state."""
    final = _to_host(final)
    return [fleet_summary(_index(final, r))
            for r in range(final.qos_utility.shape[0])]


def _index(tree, r: int):
    """Replica ``r`` of a host tree."""
    if isinstance(tree, tuple):
        return type(tree)(*(_index(v, r) for v in tree))
    return tree[r]
