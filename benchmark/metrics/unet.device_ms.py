"""Device busy ms per replay of the SDS step graph's guidance.unet phase
(guidance/zero123.py sds_loss: the UNet forward at CFG batch 2, its body
captured into the SDS step's graph): each replay's records in the span
virtual_step, split by the node map of the trainer's sds_captures line
(benchmark/program_spans.py graph_ms)."""
from benchmark import program_spans


def read(run):
    return program_spans.graph_ms(run, "sds", "guidance.unet")
