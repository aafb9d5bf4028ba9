"""Device busy ms per replay of the band term inside the SDS step's CUDA
graph (renderer.py render_rays, span render.band, nested in sds.render's
node range; its first range, the forward's): each replay's records in the
span virtual_step, split by the node map of the trainer's sds_captures
line (benchmark/program_spans.py graph_ms)."""
from benchmark import program_spans


def read(run):
    return program_spans.graph_ms(run, "sds", "render.band")
