"""Device busy ms per replay of the SDS step graph's sds.update phase
(train/trainer.py _virtual_body: the division, the non-finite check, the
freeze's optimizer update or the carry): each replay's records in the span
virtual_step, split by the node map of the trainer's sds_captures line
(benchmark/program_spans.py graph_ms)."""
from benchmark import program_spans


def read(run):
    return program_spans.graph_ms(run, "sds", "sds.update")
