"""Device busy ms per replay of the real step graph's real.update phase
(train/trainer.py _real_update): each replay's records in the span
chained_real_step, split by the node map of the trainer's captures line
(benchmark/program_spans.py graph_ms)."""
from benchmark import program_spans


def read(run):
    return program_spans.graph_ms(run, "real", "real.update")
