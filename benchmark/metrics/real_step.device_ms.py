"""Device busy ms per call of the chained real step (the span around
Trainer.chained_real_step: the eager occupancy refresh and the graph's
replay)."""


def read(run):
    tr = run.trace
    return None if tr is None else tr.span_device_ms("chained_real_step")
