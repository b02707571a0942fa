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
from typing import Callable, NamedTuple

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


class Capture(NamedTuple):
    """What :func:`warm_and_capture` made: the warm call's result, the
    instantiated graph, the captured call's result (in the graph's
    pool: a replay writes it again), the seconds the capture and the
    instantiation took, and the graph's node count."""
    warm: torch.Tensor
    graph: "torch.cuda.CUDAGraph"
    out: torch.Tensor
    capture_s: float
    instantiate_s: float
    nodes: int


def warm_and_capture(body: Callable[[], torch.Tensor], device) -> Capture:
    """``body()`` as one CUDA graph, the way the port's captured programs
    (the served forward, the train step, the decode step) are made: one
    warm call on a side stream under ``torch.cuda.set_sync_debug_mode(
    "error")`` (it builds what is built lazily, fails on any host sync in
    ``body``, and is a real call: its result is kept), then the capture
    into the graph's own memory pool, kept for :func:`graph_nodes`, and
    the instantiation, timed as the spans ``graph.capture`` and
    ``graph.instantiate`` (:mod:`repro_torch.obs.prof`).  A capture that
    fails raises."""
    from repro_torch.obs.prof import span
    main = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    side.wait_stream(main)
    with torch.cuda.stream(side):
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
        try:
            warm = body()
        finally:
            torch.cuda.set_sync_debug_mode(mode)
    main.wait_stream(side)
    warm.record_stream(main)
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with span("graph.capture") as cap:
        with torch.cuda.graph(graph, pool=torch.cuda.graph_pool_handle()):
            out = body()
    nodes = graph_nodes(graph)
    with span("graph.instantiate") as inst:
        graph.instantiate()
    return Capture(warm, graph, out, cap.seconds, inst.seconds, nodes)
