"""The port's mesh paths on several ranks: ``gloo`` CPU groups of 2 and 4
ranks, side by side in one subprocess (``tests/torch_dist_worker.py``).

The fleet entry points under ``mesh=`` (``run_fleet`` and
``simulate_fleet`` with the edges split, DEMS and DEMS-COOP;
``run_fleet_batch`` and the JAX test's ``run_batch`` batch on a (2, 2)
(replica, edge) grid, traced; ``run_registry_sweep(mesh="auto")``) are
bitwise equal to the unsharded port on every rank, and ``opt_decode``
with the cache's sequence split over 2 model ranks (at 4 ranks the batch
over 2 data ranks too) matches the unsharded decode at every step within
the JAX test's tolerances (cache 1e-5, logits 2e-3): steps in which model
rank 0 writes while rank 1 holds no valid key, then rank 1 writes with
both halves valid, and a sliding window's ring wrapping back to rank 0.
The DTensor-only branches the dry run traces run on values too, against
plain tensors: reduced qwen3-moe's MoE layer (dispatch and combine on
each rank's groups), reduced xLSTM's and reduced granite's loss and
every gradient with the tokens split ``("batch", "seq")`` (at 4 ranks the
batch over the data axis that also splits the embedding table's width;
xLSTM's log-sigmoid gates on each rank's shards), within 1e-5, and an
AdamW step of leaves split along dimension 0, bitwise.
"""
import os
import re
import subprocess
import sys

import pytest

pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHARDED = ("moe_sharded", "xlstm_sharded", "dense_sharded",
           "adamw_sharded")
CASES = {2: ("run_fleet-DEMS", "run_fleet-DEMS-COOP", "simulate_fleet",
             "run_registry_sweep-auto", "opt_decode", *SHARDED),
         4: ("run_fleet-DEMS-COOP", "run_fleet_batch", "run_batch",
             "opt_decode", *SHARDED)}


def test_mesh_paths_on_gloo_ranks_match_unsharded():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")
               + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tests", "torch_dist_worker.py"),
         "2", "4"], env=env, capture_output=True, text=True, timeout=600,
        cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-4000:]
    seen = set(re.findall(r"CASE-OK (\S+) world=(\d) rank=(\d)",
                          proc.stdout))
    want = {(case, str(world), str(rank)) for world, cases in CASES.items()
            for case in cases for rank in range(world)}
    assert seen == want, sorted(want - seen)
