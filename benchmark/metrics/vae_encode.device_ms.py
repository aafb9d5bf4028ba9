"""Device busy ms per replay of the SDS step graph's guidance.vae_encode
phase (guidance/zero123.py sds_loss: the VAE encoder's forward; its
backward lies in sds.grads): each replay's records in the span
virtual_step, split by the node map of the trainer's sds_captures line
(benchmark/program_spans.py graph_ms)."""
from benchmark import program_spans


def read(run):
    return program_spans.graph_ms(run, "sds", "guidance.vae_encode")
