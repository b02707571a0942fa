"""The card's slow mode, and the wait for it to pass before the window.

On the H100 the benchmark runs on, a capture of the tick program's graph
sometimes leaves the card, for some time from under a second to tens of
seconds, in a state in which every node of every CUDA graph takes about
0.18 us longer (a one-element add 1.17-1.21 us a node against 0.99-1.05;
the 28-edge tick 6.39-6.44 ms against 5.21-5.27), while a copy of 1 GiB
runs at the same bandwidth.  Neither the process nor the graph matters:
a graph captured earlier slows alike, and the state ends by itself.

So that a run measures the program and not that state, the run captures
a probe graph of ``PROBE_NODES`` one-element adds before the program's
set-up, and the window opens only once the probe replays under ``FAST_US`` a
node ``CONFIRM`` times in a row, or after ``CAP_S`` seconds.  The wait
comes after ``setup_s`` is read: it loads, warms and compiles nothing,
and its length is the card's, not the program's.  The run reports it
under ``settle``.
"""
from __future__ import annotations

import time

import torch

PROBE_NODES = 2000
FAST_US = 1.10
CONFIRM = 3
CAP_S = 120.0
PAUSE_S = 0.02


def wait(read, cap_s: float = CAP_S, clock=time.perf_counter,
         pause=time.sleep) -> dict:
    """Call ``read()`` (us a node) until it reads under ``FAST_US``
    ``CONFIRM`` times in a row or ``cap_s`` seconds have passed.  Returns
    the seconds waited, whether the card settled, and the first and last
    readings."""
    t0 = clock()
    reads, fast = [], 0
    while True:
        reads.append(read())
        fast = fast + 1 if reads[-1] < FAST_US else 0
        if fast >= CONFIRM or clock() - t0 >= cap_s:
            break
        pause(PAUSE_S)
    return dict(settle_s=clock() - t0, settled=fast >= CONFIRM,
                probe_us_first=reads[0], probe_us_last=reads[-1],
                probe_reads=len(reads))


class Probe:
    """A CUDA graph of ``PROBE_NODES`` one-element adds on ``device``,
    captured when made (make it before anything else is on the card)."""

    def __init__(self, device):
        self.x = torch.zeros(1, device=device)
        for _ in range(3):
            self.x.add_(1)
        torch.cuda.synchronize(device)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            for _ in range(PROBE_NODES):
                self.x.add_(1)

    def us_per_node(self) -> float:
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        self.graph.replay()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) * 1e3 / PROBE_NODES

    def wait_fast(self) -> dict:
        return wait(self.us_per_node)
