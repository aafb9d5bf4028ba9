"""Device busy ms per replay of the band term inside the real step's CUDA
graph (renderer.py render_rays, span render.band, nested in real.render's
node range): the exact two-ladder band or its reuse form, whichever the
config runs. The trainer's captures line lists the spans opened inside a
phase under "nested" (a program without it gives None); their records are
split as program_spans.graph_phase_ms splits a phase's."""
from benchmark import program_spans
from benchmark.trace import busy_us

SPAN = "render.band"


def read(run):
    got = program_spans.graph_replays(run)
    if got is None:
        return None
    cap, kept = got
    for name, first, end in cap.get("nested") or []:
        if name == SPAN:
            return sum(busy_us((s, e) for s, e, _, _ in g[first:end])
                       for g in kept) / len(kept) / 1e3
    return None
