"""Reading a torch.profiler trace of the window: device busy time, the
device time of the benchmark's spans, kernel times by name, and what the
host was doing while the device idled.

A span's device time is the union of the device records whose launch call
(the runtime's cudaLaunchKernel, cudaGraphLaunch, a copy or a fill) lies
inside one of the span's host intervals, on any thread: autograd's thread
launches the backward inside the span, and a graph replay's kernels
belong to its cudaGraphLaunch. busy_us and MARGIN_S are the arithmetic of
the port's scripts/trace_step.py, frozen here.
"""
from __future__ import annotations

import bisect
import time
from contextlib import contextmanager

# idle seconds on the card at each end of a traced window: the profiler
# drops a device record whose time, mapped onto the host's clock, falls
# outside the window, and in a process that has run for minutes that
# mapping can place the window's last kernels after its end
MARGIN_S = 0.05
TOP = 10


def busy_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def merged(intervals) -> list:
    """The union of (start, end) intervals as disjoint sorted intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


@contextmanager
def traced(cuda: bool):
    """A torch.profiler window of the host and, on a card, the device, with
    MARGIN_S of idle time at each end; yields a dict that holds the
    profiler once the window has closed."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    box = {}
    with profile(activities=acts) as prof:
        time.sleep(MARGIN_S)
        yield box
        if cuda:
            torch.cuda.synchronize()
        time.sleep(MARGIN_S)
    box["prof"] = prof


class Trace:
    """The records of one traced window: device records (start, end, name,
    launch time), the host's spans by name and the window's bounds, all in
    microseconds of the host's clock."""

    LAUNCH_PREFIXES = ("cuda", "cu")

    def __init__(self, prof, window_span: str, span_names=()):
        from torch.autograd import DeviceType
        events = list(prof.profiler.kineto_results.events())
        # the device's copies of the spans (gpu_user_annotation) are no work
        names = set(span_names) | {window_span}
        launches, self.spans, cpu_ops = {}, {}, []
        dev = []
        for e in events:
            s_us = e.start_ns() / 1e3
            d_us = e.duration_ns() / 1e3
            if e.device_type() == DeviceType.CPU:
                name = e.name()
                if name.startswith(self.LAUNCH_PREFIXES):
                    launches[e.correlation_id()] = s_us
                else:
                    cpu_ops.append((s_us, s_us + d_us, name,
                                    e.start_thread_id()))
                if e.is_user_annotation() or name == window_span:
                    self.spans.setdefault(name, []).append((s_us, s_us + d_us))
            elif not (e.is_user_annotation() or e.name() in names):
                dev.append((s_us, s_us + d_us, e.name(), e.correlation_id()))
        self.device = [(s, e, n, launches.get(c)) for s, e, n, c in dev]
        self.launch_coverage = (sum(d[3] is not None for d in self.device)
                                / max(1, len(self.device)))
        if window_span not in self.spans:
            raise AssertionError(f"the trace holds no {window_span!r} span")
        self.window = self.spans[window_span][0]
        self.cpu_ops = sorted(cpu_ops)
        self.busy = merged((s, e) for s, e, _, _ in self.device)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy) / 1e6

    def in_span(self, name: str) -> list:
        """The device records launched inside one of span `name`'s
        intervals."""
        iv = sorted(self.spans.get(name, []))
        starts = [s for s, _ in iv]
        out = []
        for d in self.device:
            t = d[3]
            if t is None:
                continue
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and t <= iv[i][1]:
                out.append(d)
        return out

    def span_calls(self, name: str) -> int:
        return len(self.spans.get(name, []))

    def span_device_ms(self, name: str) -> float | None:
        """Device busy ms per call of span `name` (None without calls)."""
        n = self.span_calls(name)
        recs = self.in_span(name) if n else []
        if not recs:
            return None
        return busy_us((s, e) for s, e, _, _ in recs) / 1e3 / n

    def kernel_us(self, substring: str, span: str | None = None) -> tuple:
        """(launches, summed device us) of the records whose name holds
        `substring`, within `span` when given."""
        recs = self.device if span is None else self.in_span(span)
        hits = [e - s for s, e, n, _ in recs if substring in n]
        return len(hits), sum(hits)

    def device_ops(self, top: int = TOP) -> list:
        by = {}
        for s, e, n, _ in self.device:
            by[n[:96]] = by.get(n[:96], 0.0) + (e - s) / 1e6
        return sorted(([k, v] for k, v in by.items()),
                      key=lambda kv: -kv[1])[:top]

    def _host_at(self, t: float) -> str:
        """The innermost host op (the benchmark's spans included) running at
        time t on the window's thread."""
        i = bisect.bisect_right(self.cpu_ops, (t, float("inf"))) - 1
        best, seen = None, 0
        while i >= 0 and seen < 4000:
            s, e, n, _ = self.cpu_ops[i]
            if s <= t <= e and (best is None or e - s < best[1] - best[0]):
                best = (s, e, n)
            i -= 1
            seen += 1
        return best[2] if best else "(no host op)"

    def _span_at(self, t: float, order) -> str:
        for name in order:
            iv = self.spans.get(name, [])
            i = bisect.bisect_right(iv, (t, float("inf"))) - 1
            if i >= 0 and iv[i][0] <= t <= iv[i][1]:
                return name
        return "between steps"

    def idle_gaps(self, span_order=(), top: int = TOP,
                  longest: int = 300) -> list:
        """The device's idle seconds inside the window: all of them summed
        by the innermost of the spans `span_order` (innermost first) open at
        each gap's start ("span <name>"), then the `longest` gaps summed by
        the innermost host op running at each one's start; the `top`
        entries, the spans' first."""
        w0, w1 = self.window
        gaps, last = [], w0
        for s, e in self.busy:
            if s > last:
                gaps.append((min(s, w1) - last, last))
            last = max(last, e)
            if last >= w1:
                break
        if last < w1:
            gaps.append((w1 - last, last))
        gaps = [(g, t) for g, t in gaps if g > 0]
        for name in span_order:
            self.spans[name] = sorted(self.spans.get(name, []))
        by_span = {}
        for g, t in gaps:
            k = "span " + self._span_at(t, span_order)
            by_span[k] = by_span.get(k, 0.0) + g / 1e6
        by_op = {}
        for g, t in sorted(gaps, reverse=True)[:longest]:
            k = self._host_at(t)[:96]
            by_op[k] = by_op.get(k, 0.0) + g / 1e6
        first = sorted(([k, v] for k, v in by_span.items()),
                       key=lambda kv: -kv[1])
        rest = sorted(([k, v] for k, v in by_op.items()),
                      key=lambda kv: -kv[1])
        return (first + rest)[:top]
