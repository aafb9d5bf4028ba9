"""Spans and counters of the program's own phases.

    with trace.span("sds.render"):           # a phase of a step
        ...
    trace.fill("real", mask)    # a fixed-size stream's fill counters
    trace.count("unet.calls")   # a host counter
    trace.counts()      # {name: float}: the host counters, no synchronize
    trace.read()        # {name: float}: all counters, one synchronize a device
    trace.reset()       # every counter to 0, in place

A span is torch.profiler.record_function(name) while a torch.profiler
session records: it then lands in the profiler's trace beside the device's
records, on the same clock, inside the spans open around it. Otherwise it
is one check and a shared no-op context. There is no switch of its own:
spans are on exactly while a profiler is.

A record_function inside the body of a CUDA graph runs at the capture
alone, and a replay's kernels reach the profiler under one cudaGraphLaunch.
So while a stream capture runs under capture_phases(), each span also
notes how many device nodes (kernels, memsets, memcopies: the nodes the
profiler records as device work) the graph under capture holds at its
entry and at its exit; the NodeMap given to capture_phases then says
which of a replay's device records, in the graph's order, each span made.

Fill counters are float64 scalars on the device. allocate() puts them in
place before any capture, so that a captured fill() adds into tensors that
live as long as the graph, and a replay adds as the eager step does. fill()
never reads to the host. Host counters (count()) are floats that add on
the host, as a call is made: the port's one kind of host counter (the
kernel wrappers' "<kernel>.launches", the reducer's "dp.all_reduces" and
"dp.all_reduce_bytes", the UNet's "unet.calls" and "unet.replays"). A host
counter counts the calls the run made: a replay of a CUDA graph adds what
its capture counted (graphs.capture, where that rule lives).
"""
from __future__ import annotations

import contextlib
import ctypes
import warnings

import torch

_NULL = contextlib.nullcontext()
_capture: "NodeMap | None" = None
_device: dict = {}          # (name, device) -> float64 scalar tensor
_host: dict = {}            # name -> float
# a stream's counters: its entries that hold real samples (its `valid` mask
# summed) and its fixed size
FILL = ("samples_valid", "samples_slots")


# whether a torch.profiler session records (one call into torch's C++)
_profiling = torch.autograd._profiler_enabled


def span(name: str):
    """A context manager around one phase (see the module docstring)."""
    if _capture is not None:
        return _phase(name, _capture)
    if _profiling():
        return torch.profiler.record_function(name)
    return _NULL


@contextlib.contextmanager
def _phase(name: str, nodes: "NodeMap"):
    nodes.enter(name)
    try:
        with torch.profiler.record_function(name) if _profiling() else _NULL:
            yield
    finally:
        # a span left by an exception closes too: a checkpoint's
        # recomputation stops early by raising inside its spans
        nodes.exit()


# ---- counters ----

def allocate(prefixes, device) -> None:
    """The fill counters of streams `prefixes` on `device`, made now if
    missing (before a capture that adds into them)."""
    for prefix in prefixes:
        for k in FILL:
            t = torch.zeros((), dtype=torch.float64, device=device)
            _device.setdefault((f"{prefix}.{k}", t.device), t)


def fill(prefix: str, mask: torch.Tensor) -> None:
    """Add a fixed-size stream's `valid` mask into its counters (allocate()d
    on the mask's device), without a read to the host."""
    valid, slots = (_device[(f"{prefix}.{k}", mask.device)] for k in FILL)
    valid.add_(mask.sum())
    slots.add_(mask.numel())


def count(name: str, n: float = 1.0) -> None:
    """Add n to host counter `name`."""
    _host[name] = _host.get(name, 0.0) + n


def counts() -> dict:
    """{name: float}: the host counters, read without touching a device
    (between timed calls)."""
    return dict(_host)


def read() -> dict:
    """{name: float}: the host counters and the fill counters, summed over
    devices; one synchronize for each device that holds counters."""
    out = counts()
    by_device = {}
    for (name, dev), t in _device.items():
        by_device.setdefault(dev, []).append((name, t))
    for items in by_device.values():
        values = torch.stack([t for _, t in items]).tolist()
        for (name, _), v in zip(items, values):
            out[name] = out.get(name, 0.0) + v
    return out


def reset() -> None:
    """Every counter to 0, in place (a graph adds into them where it found
    them)."""
    for name in _host:
        _host[name] = 0.0
    for t in _device.values():
        t.zero_()


# ---- the phases of a captured graph ----

# CUgraphNodeType: CU_GRAPH_NODE_TYPE_KERNEL, _MEMCPY, _MEMSET
_DEVICE_NODE_TYPES = (0, 1, 2)


class _DriverNodes:
    """The device nodes of the graph that the current stream is capturing
    into, counted through the CUDA driver (libcuda, which torch has
    loaded): cuStreamGetCaptureInfo_v2, cuGraphGetNodes,
    cuGraphNodeGetType. Node types are kept by handle, so each node is
    asked once."""

    def __init__(self):
        lib = ctypes.CDLL("libcuda.so.1")
        vp, sz = ctypes.c_void_p, ctypes.c_size_t
        self.info = lib.cuStreamGetCaptureInfo_v2
        self.info.argtypes = [vp, ctypes.POINTER(ctypes.c_int),
                              ctypes.POINTER(ctypes.c_uint64),
                              ctypes.POINTER(vp), ctypes.POINTER(vp),
                              ctypes.POINTER(sz)]
        self.get_nodes = lib.cuGraphGetNodes
        self.get_nodes.argtypes = [vp, ctypes.POINTER(vp), ctypes.POINTER(sz)]
        self.node_type = lib.cuGraphNodeGetType
        self.node_type.argtypes = [vp, ctypes.POINTER(ctypes.c_int)]
        for f in (self.info, self.get_nodes, self.node_type):
            f.restype = ctypes.c_int
        self.types: dict = {}

    @staticmethod
    def _check(rc: int, what: str) -> None:
        if rc != 0:
            raise RuntimeError(f"{what} failed: CUresult {rc}")

    def __call__(self) -> int:
        vp, sz = ctypes.c_void_p, ctypes.c_size_t
        stream = torch.cuda.current_stream().cuda_stream
        status, ident, graph = ctypes.c_int(), ctypes.c_uint64(), vp()
        deps, n_deps = vp(), sz()
        self._check(self.info(stream, ctypes.byref(status),
                              ctypes.byref(ident), ctypes.byref(graph),
                              ctypes.byref(deps), ctypes.byref(n_deps)),
                    "cuStreamGetCaptureInfo")
        if status.value != 1:               # CU_STREAM_CAPTURE_STATUS_ACTIVE
            raise RuntimeError("a node count outside a stream capture")
        n = sz()
        self._check(self.get_nodes(graph, None, ctypes.byref(n)),
                    "cuGraphGetNodes")
        if not n.value:             # (CUDA refuses an empty array)
            return 0
        nodes = (vp * n.value)()
        self._check(self.get_nodes(graph, nodes, ctypes.byref(n)),
                    "cuGraphGetNodes")
        kind = ctypes.c_int()
        total = 0
        for h in nodes[:n.value]:
            t = self.types.get(h)
            if t is None:
                self._check(self.node_type(h, ctypes.byref(kind)),
                            "cuGraphNodeGetType")
                t = self.types[h] = kind.value
            total += t in _DEVICE_NODE_TYPES
        return total


class NodeMap:
    """Where each span of a stream capture lies among the captured graph's
    device nodes: phases, [[name, first, end], ...] of the spans opened
    with no other span open, in the order they opened (node `first` up
    to, not including, `end`); nested, the same of the spans opened inside
    another, which lie within its range; and device_nodes, the graph's
    count at the capture's end; all set as the capture's block ends.
    count() gives the graph's device nodes so far (by default CUDA's own
    count of the graph that the current stream captures into). A count
    that fails loses the map, never the capture: phases, nested and
    device_nodes stay None, and a warning says why (lost)."""

    def __init__(self, count=None):
        self.count = count
        self.phases: list | None = None
        self.nested: list | None = None
        self.device_nodes: int | None = None
        self.lost: str | None = None
        self._spans: list = []          # [name, first, end, depth]
        self._open: list = []

    def _count(self) -> int | None:
        if self.lost is not None:
            return None
        try:
            if self.count is None:
                self.count = _DriverNodes()
            return self.count()
        except Exception as e:  # noqa: BLE001  (a lost map, not a lost step)
            self.lost = f"{type(e).__name__}: {e}"
            warnings.warn(f"the capture's node map is lost: {self.lost}")
            return None

    def enter(self, name: str) -> None:
        depth = len(self._open)
        self._open.append(len(self._spans))
        self._spans.append([name, self._count(), None, depth])

    def exit(self) -> None:
        self._spans[self._open.pop()][2] = self._count()

    def finish(self) -> None:
        n = self._count()
        if self.lost is None:
            self.phases = [s[:3] for s in self._spans if not s[3]]
            self.nested = [s[:3] for s in self._spans if s[3]]
            self.device_nodes = n


@contextlib.contextmanager
def capture_phases(nodes: NodeMap):
    """Inside a stream capture: spans note their node ranges in `nodes`,
    which this yields; its device_nodes is counted as the block ends,
    before the capture does."""
    global _capture
    _capture = nodes
    try:
        yield nodes
        nodes.finish()
    finally:
        _capture = None
