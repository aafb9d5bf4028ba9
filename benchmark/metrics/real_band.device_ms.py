"""Device busy ms per replay of the band term inside the real step's CUDA
graph (renderer.py render_rays, span render.band, nested in real.render's
node range): the exact two-ladder band or its reuse form, whichever the
config runs. The trainer's captures line lists the spans opened inside a
phase under "nested" (a program without it gives None); their records are
split as a phase's (benchmark/program_spans.py graph_ms)."""
from benchmark import program_spans


def read(run):
    return program_spans.graph_ms(run, "real", "render.band")
