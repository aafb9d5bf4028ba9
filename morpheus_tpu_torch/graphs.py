"""CUDA graphs of the port's captured bodies: one capture() for every graph
(the trainer's real step, the Zero123 UNet's forward).

    out, graph = graphs.capture(body, device, generators=(gen,))
    out = graph.replay()        # the captured output buffer, overwritten

capture() runs body() once, eagerly, on a side stream (the warm-up: it
loads the kernels and the cuDNN and cuBLAS handles, picks the algorithms
and fills every cached constant, since a copy from host memory cannot be
captured), then captures body() into a torch.cuda.CUDAGraph, which runs
nothing. A graph reads and writes the addresses it saw at capture: its
caller writes what changes into them in place, never rebinds them.

A capture measures itself: warmup_s and capture_s (host seconds, each up
to a synchronize), pool_mb (the card memory its private pool took), and
the map of its spans onto its device nodes (trace.capture_phases: phases,
nested, device_nodes; None where the map was lost). A body with no spans
gets an empty map.

Host counters (trace.count) count the calls the run made. The capture
runs nothing, so the counts its body made are taken back off as it ends
and kept (counts); each replay adds them again, as the eager body would
have. The warm-up's counts stay: it ran. A failed capture raises.

capturing() says whether the current stream is capturing: a body that
calls a function with a graph of its own (the SDS step calls the UNet's)
runs that function's body in its place, so its kernels join the capture.
"""
from __future__ import annotations

import time

import torch

from . import trace


class Graph:
    """One capture (see the module docstring): the CUDA graph, its output
    buffer, the host counts of one run of its body and what the capture
    measured."""

    def __init__(self, graph=None):
        self.graph = graph          # the torch.cuda.CUDAGraph
        self.out = None
        self.counts: dict = {}
        self.warmup_s = self.capture_s = self.pool_mb = 0.0
        self.phases = self.nested = self.device_nodes = None

    def replay(self):
        """Run the captured kernels again and add the capture's counts;
        returns the output buffer, which the next replay overwrites."""
        self.graph.replay()
        for name, n in self.counts.items():
            trace.count(name, n)
        return self.out


def capturing() -> bool:
    """Whether the current CUDA stream is capturing a graph (False where
    there is no CUDA)."""
    return (torch.cuda.is_available()
            and torch.cuda.is_current_stream_capturing())


def capture(body, device, generators=()) -> tuple:
    """(body()'s eager output, its Graph): the warm-up, then the capture,
    with each generator in `generators` registered so that a replay
    advances it as the eager body would."""
    device = torch.device(device)
    main = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    side.wait_stream(main)
    t0 = time.perf_counter()
    with torch.cuda.stream(side):
        out = body()
    main.wait_stream(side)
    torch.cuda.synchronize(device)
    warmup_s = time.perf_counter() - t0
    g = Graph(torch.cuda.CUDAGraph())
    g.warmup_s = warmup_s
    for gen in generators:
        g.graph.register_generator_state(gen)
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved(device)
    before = trace.counts()
    nodes = trace.NodeMap()
    t0 = time.perf_counter()
    with torch.cuda.graph(g.graph), trace.capture_phases(nodes):
        g.out = body()
    torch.cuda.synchronize(device)
    g.capture_s = time.perf_counter() - t0
    g.pool_mb = (torch.cuda.memory_reserved(device) - reserved) / 2**20
    g.phases, g.nested = nodes.phases, nodes.nested
    g.device_nodes = nodes.device_nodes
    for name, n in trace.counts().items():
        if n != before.get(name, 0.0):
            g.counts[name] = n - before.get(name, 0.0)
            trace.count(name, -g.counts[name])
    return out, g
