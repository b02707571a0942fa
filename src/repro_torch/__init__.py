"""PyTorch/CUDA port of the fleet scheduler (the ``repro`` JAX package's
tick program, held against it on the same inputs).

Layout mirrors ``repro``: ``core`` (task profiles, policy flags, the
array-encoded decision functions), ``kernels`` (the hand-written
``sm_90a`` CUDA kernels and their plain PyTorch versions), ``sim`` (the
fleet tick program and its drivers, the discrete-event simulator and
its lockstep oracle, workloads and latency models), ``faults`` and
``scenarios`` (scenario specs, the registry, compilation to both
simulators, runners and summaries), the model zoo and serve engine
(``configs``, ``models``, ``serve``, ``launch``) and ``convert`` (numpy
↔ port NamedTuples).

The package imports ``torch`` and ``numpy`` only.  Entry points run on
the card by default (``device="cuda"``) and raise when no card is
present; pass ``device="cpu"`` to run the plain-PyTorch path on the host.
"""
from __future__ import annotations

import ctypes

import torch


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on; a CUDA request without a card
    raises instead of quietly running on the host."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch: CUDA device requested but torch.cuda.is_available()"
            " is False; pass device='cpu' to run the plain PyTorch path")
    return dev


def graph_nodes(graph) -> int:
    """The node count of a captured CUDA graph kept for it
    (``torch.cuda.CUDAGraph(keep_graph=True)``; ``cuGraphGetNodes`` of
    ``libcuda``)."""
    n = ctypes.c_size_t(0)
    err = ctypes.CDLL("libcuda.so.1").cuGraphGetNodes(
        ctypes.c_void_p(graph.raw_cuda_graph()), None, ctypes.byref(n))
    if err:
        raise RuntimeError(f"cuGraphGetNodes failed: CUresult {err}")
    return n.value
