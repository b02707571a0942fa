"""Multi-rank cases of the port's mesh paths on ``gloo`` CPU ranks.

Run by ``tests/test_torch_dist.py`` as one subprocess: ``python
tests/torch_dist_worker.py 2 4`` spawns a group of 2 ranks and one of 4
side by side, each rank a process of its own in a ``gloo`` group on
localhost.  Every rank runs
every case sharded and unsharded and holds the two equal: the fleet
cases bitwise (the unsharded port is held to the JAX package by the
other tests), the sharded flash-decode within the JAX test's
tolerances at every step of :data:`DECODE_CASES`.  A rank prints ``CASE-OK <name>`` a case; any mismatch
raises, and the parent exits non-zero.

Missions are shortened to keep the run cheap: 2 s of simulated time
(80 ticks of 25 ms) in place of the JAX test's 8 s.
"""
from __future__ import annotations

import dataclasses
import os
import sys

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

DURATION_MS = 2_000.0


def _equal(a, b, where: str) -> None:
    if a is None or b is None:
        assert a is None and b is None, where
        return
    if isinstance(a, tuple):
        for x, y, f in zip(a, b, getattr(a, "_fields", range(len(a)))):
            _equal(x, y, f"{where}.{f}")
        return
    assert a.shape == b.shape and a.dtype == b.dtype, where
    assert torch.equal(a, b), where


def _fleet_cases(world: int, say) -> None:
    """``run_fleet`` with its edges split over every rank; at 2 ranks
    also ``simulate_fleet`` and ``run_registry_sweep(mesh="auto")``, at 4
    the (replica, edge) grid of ``run_fleet_batch`` and ``run_batch``."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.core.task import PASSIVE, TABLE1
    from repro_torch.obs.trace import TraceSpec
    from repro_torch.scenarios.compile import compile_registry_batch
    from repro_torch.scenarios.runner import run_registry_sweep
    from repro_torch.sim import fleet as F

    models = [TABLE1[n] for n in PASSIVE]
    edges = init_device_mesh("cpu", (world,), mesh_dim_names=("fleet",))

    # overloaded edges, so that DEMS-COOP exchanges tasks across ranks
    def signals(seed):
        return F.default_signals(len(models), n_edges=4, drones_per_edge=8,
                                 duration_ms=DURATION_MS, seed=seed,
                                 device="cpu")

    for pol in ("DEMS", "DEMS-COOP") if world == 2 else ("DEMS-COOP",):
        kw = dict(trace=TraceSpec.full(), device="cpu")
        ref = F.run_fleet(models, pol, signals(3), **kw)
        got = F.run_fleet(models, pol, signals(3), mesh=edges, **kw)
        _equal(ref, got, f"run_fleet {pol}")
        if pol == "DEMS-COOP":
            assert int(ref.final.n_peer_out.sum()) > 0, "no peer offload"
        say(f"run_fleet-{pol}")
    if world == 2:
        kw = dict(n_edges=4, duration_ms=DURATION_MS, device="cpu")
        _equal(F.simulate_fleet(models, "DEMS-COOP", **kw),
               F.simulate_fleet(models, "DEMS-COOP", mesh=edges, **kw),
               "simulate_fleet")
        say("simulate_fleet")
        args = (("baseline", "rush-hour"), ("DEMS", "DEMS-COOP"), (0, 1))
        ref = run_registry_sweep(*args, duration_ms=DURATION_MS,
                                 device="cpu")
        got = run_registry_sweep(*args, duration_ms=DURATION_MS,
                                 mesh="auto", device="cpu")
        assert ref == got, "run_registry_sweep"
        say("run_registry_sweep-auto")
        return

    # the (replica, edge) grid: both axes split, the exchange across the
    # edge ranks of each replica block
    grid = init_device_mesh("cpu", (2, 2), mesh_dim_names=("replica", "edge"))
    sigs = F.stack_signals([signals(s) for s in range(4)])
    ref = F.run_fleet_batch(models, "DEMS-COOP", sigs, device="cpu")
    got = F.run_fleet_batch(models, "DEMS-COOP", sigs, mesh=grid,
                            device="cpu")
    _equal(ref, got, "run_fleet_batch")
    say("run_fleet_batch")
    # the JAX test's heterogeneous batch (2 scenarios x 2 policies x
    # seeds 0, 1), traced
    batch, _ = compile_registry_batch(
        ("baseline", "rush-hour"), ("DEMS", "DEMS-COOP"), (0, 1),
        duration_ms=DURATION_MS, device="cpu")
    _equal(F.run_batch(batch, trace=TraceSpec.full()),
           F.run_batch(batch, trace=TraceSpec.full(), mesh=grid),
           "run_batch")
    say("run_batch")


# (sliding window, prompt, cache max_seq, steps) of the opt_decode cases:
# a 32-slot cache split 16/16 whose 14-token prompt leaves the second
# half empty (the first two steps write on model rank 0 while rank 1's
# partial softmax is all masked; from position 16 on rank 1 owns the
# write and both halves hold valid keys), and a 16-slot ring split 8/8
# that the steps wrap from rank 1 back to rank 0
DECODE_CASES = ((0, 14, 32, 6), (16, 6, 32, 14))


def _decode_case(world: int, say) -> None:
    """opt_decode with the cache's sequence split over 2 model ranks (at 4
    ranks the batch over 2 data ranks too), step by step against the
    unsharded decode on the same tokens, the sharded step's position a
    0-d tensor at every other step; a ``DecodeProgram`` refuses the
    mesh."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs.base import reduced
    from repro_torch.configs.registry import ARCHS
    from repro_torch.launch.sharding import sharding_rules
    from repro_torch.models import layers as L
    from repro_torch.models.model import DecodeProgram, Model

    mesh = init_device_mesh("cpu", (world // 2, 2),
                            mesh_dim_names=("data", "model"))
    for window, prompt, max_seq, steps in DECODE_CASES:
        cfg = dataclasses.replace(reduced(ARCHS["qwen2-72b"]),
                                  sliding_window=window)
        base = Model(cfg, "cpu")
        opt = Model(dataclasses.replace(cfg, opt_decode=True), "cpu")
        params = base.init(torch.Generator().manual_seed(0))
        tokens = torch.randint(0, cfg.vocab, (2, prompt),
                               generator=torch.Generator().manual_seed(1))
        with torch.no_grad():
            _, cache = base.prefill(params, {"tokens": tokens}, max_seq)
            sharded = L.shard_decode_cache(
                {k: v.clone() for k, v in cache.items()}, mesh)
            tok = tokens[:, -1:]
            for pos in range(prompt, prompt + steps):
                want, cache = base.decode_step(params, cache, tok, pos)
                at = torch.tensor(pos, dtype=torch.int32) if pos % 2 else pos
                with sharding_rules(mesh):
                    got, sharded = opt.decode_step(params, sharded, tok, at)
                where = f"window {window} pos {pos}"
                torch.testing.assert_close(got, want, rtol=2e-3, atol=2e-3,
                                           msg=where)
                for key in ("k", "v"):
                    torch.testing.assert_close(
                        sharded[key].full_tensor(), cache[key], rtol=1e-5,
                        atol=1e-5, msg=f"{where} cache {key}")
                tok = want[:, -1, :cfg.vocab].argmax(-1, keepdim=True)
        with sharding_rules(mesh):
            try:
                DecodeProgram(opt, params, sharded)
            except RuntimeError as e:
                assert "mesh" in str(e), e
            else:
                raise AssertionError("DecodeProgram took a mesh")
    say("opt_decode")


def _loss_grad_case(arch: str, seed: int, mesh, placed, full) -> None:
    """Reduced ``arch``'s loss and every gradient with the parameters
    placed by ``param_specs`` and the tokens split ``("batch", "seq")``
    (at 4 ranks the batch over the data axis that also splits the
    embedding table's width), against the same on plain tensors."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs.base import reduced
    from repro_torch.configs.registry import ARCHS
    from repro_torch.launch.sharding import sharding_rules
    from repro_torch.models.model import Model
    from repro_torch.train.optimizer import tree_leaves, tree_map

    cfg = reduced(ARCHS[arch])
    model = Model(cfg, "cpu")
    params = model.init(torch.Generator().manual_seed(seed))
    tokens = torch.randint(0, cfg.vocab, (4, 16),
                           generator=torch.Generator().manual_seed(seed + 1))
    batch = {"tokens": tokens, "labels": tokens.roll(-1, 1)}
    leaves = [t.requires_grad_(True) for t in tree_leaves(params)]
    loss = model.loss(params, batch)
    want = torch.autograd.grad(loss, leaves)
    dparams = tree_map(lambda t, lg: placed(t.detach(), lg).requires_grad_(
        True), params, model.param_specs())
    with sharding_rules(mesh), implicit_replication():
        dbatch = {k: placed(v, ("batch", "seq")) for k, v in batch.items()}
        dloss = model.loss(dparams, dbatch)
        got = torch.autograd.grad(dloss, tree_leaves(dparams))
    torch.testing.assert_close(full(dloss), loss.detach(), rtol=1e-5,
                               atol=1e-5)
    for g, w in zip(got, want):
        torch.testing.assert_close(full(g), w, rtol=1e-5, atol=1e-5)


def _sharded_model_case(world: int, say) -> None:
    """The DTensor-only branches that the dry run's traces take, here on
    values: the MoE layer's sharded dispatch, experts and combine
    (reduced qwen3-moe, one dispatch group a data rank), reduced xLSTM's
    and reduced granite's loss and gradients with the tokens split over
    the batch (:func:`_loss_grad_case`: xLSTM's log-sigmoid gates on each
    rank's shards, the embedding's table gathered off its width split)
    and an AdamW step of leaves split along dimension 0, each against the
    same work on plain tensors (f32; 1e-5, AdamW bitwise)."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs.base import reduced
    from repro_torch.configs.registry import ARCHS
    from repro_torch.launch.sharding import named_sharding, sharding_rules
    from repro_torch.models import moe as MOE
    from repro_torch.models.model import Model
    from repro_torch.train.optimizer import AdamW, AdamWState, tree_map

    mesh = init_device_mesh("cpu", (world // 2, 2),
                            mesh_dim_names=("data", "model"))

    def placed(t, logical):
        return distribute_tensor(t, mesh, named_sharding(t.shape, logical,
                                                         mesh))

    def full(t):
        return t.full_tensor()

    cfg = dataclasses.replace(reduced(ARCHS["qwen3-moe-30b-a3b"]),
                              moe_groups=world // 2)
    model = Model(cfg, "cpu")
    params = model.init(torch.Generator().manual_seed(2))
    p = {k: v[0] for k, v in params["blocks"].items()}
    specs = {k: v[1:] for k, v in model.param_specs()["blocks"].items()}
    x = torch.randn(4, 16, cfg.d_model,
                    generator=torch.Generator().manual_seed(3))
    want, want_aux = MOE.moe_mlp(p, cfg, x)
    # as the dry run traces: plain constants replicate
    with sharding_rules(mesh), implicit_replication():
        got, aux = MOE.moe_mlp({k: placed(v, specs[k]) for k, v in p.items()},
                               cfg, placed(x, ("batch", None, None)))
    torch.testing.assert_close(full(got), want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(full(aux), want_aux, rtol=1e-5, atol=1e-5)
    say("moe_sharded")

    for arch, name, seed in (("xlstm-1.3b", "xlstm_sharded", 4),
                             ("granite-3-2b", "dense_sharded", 7)):
        _loss_grad_case(arch, seed, mesh, placed, full)
        say(name)

    gen = torch.Generator().manual_seed(6)
    leaves = {"w": torch.randn(4, 6, 8, generator=gen),
              "b": torch.randn(4, 6, 8, generator=gen)}
    grads = tree_map(lambda t: torch.randn(t.shape, generator=gen), leaves)
    opt = AdamW(lr=1e-2)
    plain = tree_map(torch.clone, leaves)
    state = opt.init(plain)
    opt.update(grads, state, plain)       # a leaf a slice of dimension 0
    split = {k: placed(v.clone(), ("embed_fsdp", None, None))
             for k, v in leaves.items()}
    dgrads = {k: placed(v, ("embed_fsdp", None, None))
              for k, v in grads.items()}
    dstate = AdamWState(
        step=placed(state.step.new_zeros(()), ()),
        mu=tree_map(lambda t: placed(torch.zeros_like(t),
                                     ("embed_fsdp", None, None)), leaves),
        nu=tree_map(lambda t: placed(torch.zeros_like(t),
                                     ("embed_fsdp", None, None)), leaves))
    with implicit_replication():
        opt.update(dgrads, dstate, split)
    for k in leaves:
        assert torch.equal(full(split[k]), plain[k]), k
        assert torch.equal(full(dstate.mu[k]), state.mu[k]), k
    say("adamw_sharded")


def _rank(rank: int, world: int, port: int) -> None:
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)

    def say(name: str) -> None:
        print(f"CASE-OK {name} world={world} rank={rank}", flush=True)

    try:
        _fleet_cases(world, say)
        _decode_case(world, say)
        _sharded_model_case(world, say)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def main(worlds) -> None:
    """The groups of every world size at once, each on a port of its own;
    raises if a rank of any of them fails."""
    from repro_torch.launch.mesh import free_port
    runs = [mp.start_processes(_rank, args=(world, free_port()),
                               nprocs=world, join=False,
                               start_method="spawn") for world in worlds]
    for ctx in runs:
        while not ctx.join():
            pass


if __name__ == "__main__":
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))
    main([int(w) for w in sys.argv[1:]] or [2, 4])
